"""Tests: CLI driver + eigenbasis checkpoint replay + timing utils."""

import json

import numpy as np
import pytest

from graphlap import make_test_image, psnr, save_image
from graphlap.cli import main as cli_main
from graphlap.config import PipelineConfig
from graphlap.models.pipeline import compute_basis, filter_image, make_plan
from graphlap.utils.checkpoint import filter_with_basis, load_basis, save_basis
from graphlap.utils.timing import StageTimer, log_run


@pytest.fixture(scope="module")
def img_file(tmp_path_factory):
    d = tmp_path_factory.mktemp("imgs")
    path = d / "in.png"
    save_image(str(path), make_test_image(64, 64))
    return str(path)


def test_cli_denoise_run(img_file, tmp_path, capsys):
    out = str(tmp_path / "out.png")
    log = str(tmp_path / "runs.jsonl")
    rc = cli_main(["-f", img_file, "-o", out, "-grayscale", "-cpu",
                   "-kernel", "nlm", "-sample", "0.03", "-eigvals", "24",
                   "-noise", "0.1", "-log_view", "-json_log", log])
    assert rc == 0
    captured = capsys.readouterr().out
    assert "PSNR noisy" in captured
    assert "eigensolve" in captured
    assert "wrote" in captured
    rec = json.loads(open(log).read().strip().splitlines()[-1])
    assert rec["p"] > 0 and rec["mp_per_s"] > 0
    assert "psnr_filtered_db" in rec
    from graphlap.io import load_image
    result = load_image(out, grayscale=True)
    assert result.shape == (64, 64)


def test_cli_opts_file(img_file, tmp_path, capsys):
    """PETSc-rc-style defaults file: file sets flags, CLI overrides."""
    rc_path = tmp_path / "rc"
    rc_path.write_text("# defaults\n-kernel nlm\n-sample 0.03\n"
                       "-eigvals 24\n-noise 0.1\n")
    out = str(tmp_path / "o.png")
    rc = cli_main(["-f", img_file, "-o", out, "-grayscale", "-cpu",
                   "-opts_file", str(rc_path), "-eigvals", "16"])
    assert rc == 0
    captured = capsys.readouterr().out
    assert "kernel=nlm" in captured        # from the rc file
    assert "m=16" in captured              # CLI override wins
    assert "PSNR noisy" in captured        # -noise from the rc file

    # '=' form resolves the same file; trailing -opts_file is a clean error
    rc = cli_main(["-f", img_file, "-grayscale", "-cpu",
                   f"-opts_file={rc_path}", "-eigvals", "16"])
    assert rc == 0
    assert "kernel=nlm" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="opts_file"):
        cli_main(["-f", img_file, "-opts_file"])
    with pytest.raises(SystemExit, match="opts_file"):
        cli_main(["-f", img_file, "-opts_file="])


def test_cli_bad_flag(img_file):
    with pytest.raises(SystemExit):
        cli_main(["-f", img_file, "-kernel", "nope"])


def test_cli_save_then_load_basis(img_file, tmp_path, capsys):
    """CLI -save_basis then -load_basis: replay skips the solve and matches
    the direct pipeline output on the same filter."""
    bpath = str(tmp_path / "basis.npz")
    out1 = str(tmp_path / "direct.png")
    common = ["-f", img_file, "-grayscale", "-cpu", "-kernel", "nlm",
              "-sample", "0.03", "-eigvals", "16"]
    assert cli_main(common + ["-o", out1, "-save_basis", bpath]) == 0
    out2 = str(tmp_path / "replayed.png")
    assert cli_main(common + ["-o", out2, "-load_basis", bpath]) == 0
    assert "replayed filter=identity" in capsys.readouterr().out
    from graphlap.io import load_image
    a = load_image(out1, grayscale=True)
    b = load_image(out2, grayscale=True)
    assert a.shape == b.shape == (64, 64)
    # same filter through the saved basis: identical up to png quantization
    assert np.abs(a - b).max() <= 1.5 / 255.0
    # a second filter replays through the same basis without re-solving
    out3 = str(tmp_path / "sharp.png")
    assert cli_main(common + ["-o", out3, "-load_basis", bpath,
                              "-filter", "sharpen", "-filter_param", "0.8"]) == 0
    c = load_image(out3, grayscale=True)
    assert np.abs(c - b).max() > 2.0 / 255.0


def test_basis_checkpoint_roundtrip(tmp_path):
    img = make_test_image(48, 48)
    cfg = PipelineConfig(kernel="nlm", h=0.25, sample_rho=0.03, num_eigvecs=20)
    plan = make_plan(img, cfg)
    vals, vecs = compute_basis(img, cfg, plan)
    path = tmp_path / "basis.npz"
    save_basis(path, vals, vecs, plan, cfg)
    basis = load_basis(path)
    assert basis.config_hash == cfg.config_hash()
    # replaying the identity filter through the saved basis == pipeline output
    replay = filter_with_basis(img, basis, "identity", 0.0)
    direct = filter_image(img, cfg, plan=plan)
    np.testing.assert_allclose(replay, direct.image, atol=1e-5)
    # sweeping a second filter needs no re-solve and changes the output
    sharp = filter_with_basis(img, basis, "sharpen", 0.8)
    assert np.abs(sharp - replay).max() > 1e-3


def test_basis_checkpoint_shape_mismatch(tmp_path):
    img = make_test_image(32, 32)
    cfg = PipelineConfig(sample_rho=0.05, num_eigvecs=10)
    plan = make_plan(img, cfg)
    vals, vecs = compute_basis(img, cfg, plan)
    path = tmp_path / "b.npz"
    save_basis(path, vals, vecs, plan, cfg)
    basis = load_basis(path)
    with pytest.raises(ValueError):
        filter_with_basis(make_test_image(16, 16), basis, "identity", 0.0)


def test_stage_timer_and_log(tmp_path):
    t = StageTimer()
    with t.stage("a"):
        pass
    with t.stage("b"):
        pass
    with t.stage("a"):
        pass
    assert set(t.walls) == {"a", "b"}
    rep = t.report()
    assert "total" in rep and "a" in rep
    log = tmp_path / "l.jsonl"
    log_run({"x": 1}, log)
    log_run({"x": 2}, log)
    recs = [json.loads(s) for s in log.read_text().splitlines()]
    assert [r["x"] for r in recs] == [1, 2]
    assert all("ts" in r for r in recs)
