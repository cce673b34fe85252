"""Real multi-process (DCN-analogue) smoke: 2 jax.distributed processes on
localhost CPU, each with 4 virtual devices, driving the config-5 batched
pipeline through scripts/multihost_launch.py (SURVEY.md §4.3: simulate the
cluster you don't have). Asserts the multi-process pixels match the
single-process filter_video output."""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).parent.parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("streaming", [True, False])
def test_two_process_launch_matches_single(tmp_path, streaming):
    from graphlap import add_gaussian_noise, make_test_image
    from graphlap.config import PipelineConfig
    from graphlap.models.pipeline import make_plan
    from graphlap.models.video import filter_video
    from graphlap.parallel.mesh import make_mesh

    frames = np.stack([
        np.clip(add_gaussian_noise(make_test_image(32, 32, seed=s), 0.1,
                                   seed=s), 0, 1)
        for s in range(4)
    ]).astype(np.float32)
    fpath = tmp_path / "frames.npy"
    np.save(fpath, frames)

    port = _free_port()
    procs = []
    env_base = {k: v for k, v in os.environ.items()
                if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env_base.setdefault("JAX_COMPILATION_CACHE_DIR", str(ROOT / ".jax_cache"))
    # subprocesses must resolve graphlap from the checkout, installed or not
    env_base["PYTHONPATH"] = str(ROOT) + (
        os.pathsep + env_base["PYTHONPATH"] if env_base.get("PYTHONPATH") else "")
    for pid in range(2):
        out = tmp_path / f"out{pid}.npy"
        cmd = [sys.executable, str(ROOT / "scripts" / "multihost_launch.py"),
               "--frames", str(fpath), "--out", str(out),
               "--coordinator", f"127.0.0.1:{port}",
               "--num_processes", "2", "--process_id", str(pid),
               "--cpu_devices", "4", "--sample", "0.03", "--eigvals", "8",
               "--sinkhorn_iters", "8", "--dtype", "float32",
               "--block_cols", "128",
               "--streaming" if streaming else "--no-streaming"]
        procs.append(subprocess.Popen(cmd, cwd=str(ROOT), env=env_base,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    logs = []
    for p in procs:
        out_text, _ = p.communicate(timeout=600)
        logs.append(out_text)
    assert all(p.returncode == 0 for p in procs), \
        "\n---\n".join(t[-3000:] for t in logs)

    got = np.load(tmp_path / "out0.npy")
    cfg = PipelineConfig(kernel="nlm", sample_rho=0.03, num_eigvecs=8,
                         sinkhorn_iters=8, affinity_dtype="float32",
                         streaming=streaming, block_cols=128)
    plan = make_plan(frames[0], cfg)
    want, _ = filter_video(frames, cfg, mesh=make_mesh(n_rows=4, n_data=2),
                           plan=plan, frames_per_step=4)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=3e-4)


def test_two_process_production_recipe_128(tmp_path):
    """the PRODUCTION recipe (bf16 tiles + Pallas
    [interpret on CPU] + coarse Sinkhorn + one full-res polish + coarse
    gram) crossing a REAL process boundary at 128^2 — the headline compile
    path, not a toy f32 variant. Pixels must match the single-process
    streaming filter with the same recipe."""
    from graphlap import add_gaussian_noise, filter_image, make_test_image
    from graphlap.config import PipelineConfig

    img = np.clip(add_gaussian_noise(make_test_image(128, 128, seed=2), 0.1,
                                     seed=2), 0, 1).astype(np.float32)
    fpath = tmp_path / "img.npy"
    np.save(fpath, img)

    recipe = ["--sample", "0.01", "--eigvals", "16",
              "--sinkhorn_iters", "6", "--dtype", "bfloat16",
              "--block_cols", "512", "--use_pallas",
              "--sinkhorn_coarse", "4", "--sinkhorn_polish", "1",
              "--gram_coarse", "4"]
    port = _free_port()
    procs = []
    env_base = {k: v for k, v in os.environ.items()
                if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env_base.setdefault("JAX_COMPILATION_CACHE_DIR", str(ROOT / ".jax_cache"))
    env_base["PYTHONPATH"] = str(ROOT) + (
        os.pathsep + env_base["PYTHONPATH"] if env_base.get("PYTHONPATH") else "")
    for pid in range(2):
        cmd = [sys.executable, str(ROOT / "scripts" / "multihost_launch.py"),
               "--image", str(fpath), "--out", str(tmp_path / f"out{pid}.npy"),
               "--coordinator", f"127.0.0.1:{port}",
               "--num_processes", "2", "--process_id", str(pid),
               "--cpu_devices", "4"] + recipe
        procs.append(subprocess.Popen(cmd, cwd=str(ROOT), env=env_base,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    logs = []
    for p in procs:
        out_text, _ = p.communicate(timeout=600)
        logs.append(out_text)
    assert all(p.returncode == 0 for p in procs), \
        "\n---\n".join(t[-3000:] for t in logs)

    got = np.load(tmp_path / "out0.npy")
    cfg = PipelineConfig(kernel="nlm", sample_rho=0.01, num_eigvecs=16,
                         sinkhorn_iters=6, affinity_dtype="bfloat16",
                         streaming=True, block_cols=512, use_pallas=True,
                         sinkhorn_coarse=4, sinkhorn_polish=1, gram_coarse=4)
    want = filter_image(img, cfg).image
    assert got.shape == want.shape
    # bf16 tiles re-round under the different cross-process partitioning
    # (bf16 eps = 2^-8 ~ 4e-3) and the Sinkhorn fixed point + eigensolve
    # amplify it — pixel atol is the wrong assertion here; require
    # PSNR-class agreement (measured ~50 dB) and that the delta would not
    # move the graded PSNR-vs-clean metric
    from graphlap import psnr
    clean = make_test_image(128, 128, seed=2)
    assert psnr(want, got) > 45.0
    assert abs(psnr(clean, got) - psnr(clean, want)) < 0.02


def test_two_process_dense_production_recipe(tmp_path):
    """Round-3 DENSE production recipe (bfloat16_store strip + sketch
    eigensolver + coarse Sinkhorn + polish — what '-preset fast' selects
    at cfg2 scale) crossing a REAL 2-process jax.distributed boundary in
    the dense sharded pipeline. Pixels must match the single-process
    filter_video with the same recipe."""
    from graphlap import add_gaussian_noise, make_test_image, psnr
    from graphlap.config import PipelineConfig
    from graphlap.models.pipeline import make_plan
    from graphlap.models.video import filter_video
    from graphlap.parallel.mesh import make_mesh

    frames = np.stack([
        np.clip(add_gaussian_noise(make_test_image(64, 64, seed=s), 0.1,
                                   seed=s), 0, 1)
        for s in range(2)
    ]).astype(np.float32)
    fpath = tmp_path / "frames.npy"
    np.save(fpath, frames)

    recipe = ["--sample", "0.05", "--eigvals", "16",
              "--sinkhorn_iters", "8", "--dtype", "bfloat16_store",
              "--solver", "sketch", "--no-streaming",
              "--sinkhorn_coarse", "4", "--sinkhorn_polish", "1"]
    port = _free_port()
    procs = []
    env_base = {k: v for k, v in os.environ.items()
                if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env_base.setdefault("JAX_COMPILATION_CACHE_DIR", str(ROOT / ".jax_cache"))
    env_base["PYTHONPATH"] = str(ROOT) + (
        os.pathsep + env_base["PYTHONPATH"] if env_base.get("PYTHONPATH") else "")
    for pid in range(2):
        cmd = [sys.executable, str(ROOT / "scripts" / "multihost_launch.py"),
               "--frames", str(fpath), "--out", str(tmp_path / f"out{pid}.npy"),
               "--coordinator", f"127.0.0.1:{port}",
               "--num_processes", "2", "--process_id", str(pid),
               "--cpu_devices", "4"] + recipe
        procs.append(subprocess.Popen(cmd, cwd=str(ROOT), env=env_base,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    logs = []
    for p in procs:
        out_text, _ = p.communicate(timeout=600)
        logs.append(out_text)
    assert all(p.returncode == 0 for p in procs), \
        "\n---\n".join(t[-3000:] for t in logs)

    got = np.load(tmp_path / "out0.npy")
    cfg = PipelineConfig(kernel="nlm", sample_rho=0.05, num_eigvecs=16,
                         sinkhorn_iters=8, affinity_dtype="bfloat16_store",
                         solver="sketch", sinkhorn_coarse=4,
                         sinkhorn_polish=1)
    plan = make_plan(frames[0], cfg)
    want, _ = filter_video(frames, cfg, mesh=make_mesh(n_rows=4, n_data=2),
                           plan=plan, frames_per_step=2)
    assert got.shape == want.shape
    # the bf16-stored strip re-rounds under the cross-process partitioning
    # (same tolerance rationale as the streaming production test above)
    assert psnr(want, got) > 45.0


def test_two_process_single_image_rows_sharded(tmp_path):
    """Config-4 DCN analogue: ONE image's pixel blocks sharded over 'rows'
    spanning two real jax.distributed processes; pixels must match the
    single-process streaming filter."""
    from graphlap import add_gaussian_noise, filter_image, make_test_image
    from graphlap.config import PipelineConfig

    img = np.clip(add_gaussian_noise(make_test_image(32, 32, seed=0), 0.1,
                                     seed=0), 0, 1).astype(np.float32)
    fpath = tmp_path / "img.npy"
    np.save(fpath, img)

    port = _free_port()
    procs = []
    env_base = {k: v for k, v in os.environ.items()
                if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env_base.setdefault("JAX_COMPILATION_CACHE_DIR", str(ROOT / ".jax_cache"))
    env_base["PYTHONPATH"] = str(ROOT) + (
        os.pathsep + env_base["PYTHONPATH"] if env_base.get("PYTHONPATH") else "")
    for pid in range(2):
        cmd = [sys.executable, str(ROOT / "scripts" / "multihost_launch.py"),
               "--image", str(fpath), "--out", str(tmp_path / f"out{pid}.npy"),
               "--coordinator", f"127.0.0.1:{port}",
               "--num_processes", "2", "--process_id", str(pid),
               "--cpu_devices", "4", "--sample", "0.03", "--eigvals", "8",
               "--sinkhorn_iters", "8", "--dtype", "float32",
               "--block_cols", "128"]
        procs.append(subprocess.Popen(cmd, cwd=str(ROOT), env=env_base,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    logs = []
    for p in procs:
        out_text, _ = p.communicate(timeout=600)
        logs.append(out_text)
    assert all(p.returncode == 0 for p in procs), \
        "\n---\n".join(t[-3000:] for t in logs)

    got = np.load(tmp_path / "out0.npy")
    cfg = PipelineConfig(kernel="nlm", sample_rho=0.03, num_eigvecs=8,
                         sinkhorn_iters=8, affinity_dtype="float32",
                         streaming=True, block_cols=128)
    want = filter_image(img, cfg).image
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=3e-4)


def test_two_process_matvec_sharpen_recipe(tmp_path):
    """The cfg3 PRODUCTION sharpen recipe (filter_mode='matvec': exact
    polynomial f(W) y, bf16 tiles + Pallas-interpret + coarse Sinkhorn +
    polish, no eigensolve) across a REAL 2-process jax.distributed group —
    the no-eigensolve code path's psum chain crossing a process boundary.
    Pixels must match the single-process matvec filter."""
    from graphlap import add_gaussian_noise, filter_image, make_test_image
    from graphlap.config import PipelineConfig

    img = np.clip(add_gaussian_noise(make_test_image(128, 128, seed=5), 0.03,
                                     seed=5), 0, 1).astype(np.float32)
    fpath = tmp_path / "img.npy"
    np.save(fpath, img)

    recipe = ["--sample", "0.01", "--eigvals", "16",
              "--sinkhorn_iters", "6", "--dtype", "bfloat16",
              "--block_cols", "512", "--use_pallas",
              "--sinkhorn_coarse", "4", "--sinkhorn_polish", "1",
              "--filter", "sharpen", "--filter_param", "0.15",
              "--filter_mode", "matvec"]
    port = _free_port()
    procs = []
    env_base = {k: v for k, v in os.environ.items()
                if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env_base.setdefault("JAX_COMPILATION_CACHE_DIR", str(ROOT / ".jax_cache"))
    env_base["PYTHONPATH"] = str(ROOT) + (
        os.pathsep + env_base["PYTHONPATH"] if env_base.get("PYTHONPATH") else "")
    for pid in range(2):
        cmd = [sys.executable, str(ROOT / "scripts" / "multihost_launch.py"),
               "--image", str(fpath), "--out", str(tmp_path / f"out{pid}.npy"),
               "--coordinator", f"127.0.0.1:{port}",
               "--num_processes", "2", "--process_id", str(pid),
               "--cpu_devices", "4"] + recipe
        procs.append(subprocess.Popen(cmd, cwd=str(ROOT), env=env_base,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    logs = []
    for p in procs:
        out_text, _ = p.communicate(timeout=600)
        logs.append(out_text)
    assert all(p.returncode == 0 for p in procs), \
        "\n---\n".join(t[-3000:] for t in logs)

    got = np.load(tmp_path / "out0.npy")
    cfg = PipelineConfig(kernel="nlm", sample_rho=0.01, num_eigvecs=16,
                         sinkhorn_iters=6, affinity_dtype="bfloat16",
                         streaming=True, block_cols=512, use_pallas=True,
                         sinkhorn_coarse=4, sinkhorn_polish=1,
                         filter_name="sharpen", filter_param=0.15,
                         filter_mode="matvec")
    want = filter_image(img, cfg).image
    assert got.shape == want.shape
    # same bf16-repartition tolerance rationale as the spectral
    # production-recipe test above
    from graphlap import psnr
    clean = make_test_image(128, 128, seed=5)
    assert psnr(want, got) > 45.0
    assert abs(psnr(clean, got) - psnr(clean, want)) < 0.02


def test_two_process_temporal_guide_matches_single(tmp_path):
    """Temporal basis reuse ACROSS PROCESSES: groups of 3 frames — the
    first group spans the 2-process shard boundary (shards are 2+2) —
    share one guide-built basis with pixel rows sharded over both
    processes' devices; pixels must match the single-process guided
    path."""
    from graphlap import add_gaussian_noise, make_test_image
    from graphlap.config import PipelineConfig
    from graphlap.models.video import filter_video

    frames = np.stack([
        np.clip(add_gaussian_noise(make_test_image(32, 32, seed=s), 0.1,
                                   seed=s), 0, 1)
        for s in range(4)
    ]).astype(np.float32)
    fpath = tmp_path / "frames.npy"
    np.save(fpath, frames)

    port = _free_port()
    procs = []
    env_base = {k: v for k, v in os.environ.items()
                if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env_base["PYTHONPATH"] = str(ROOT) + (
        os.pathsep + env_base["PYTHONPATH"] if env_base.get("PYTHONPATH") else "")
    for pid in range(2):
        out = tmp_path / f"out{pid}.npy"
        cmd = [sys.executable, str(ROOT / "scripts" / "multihost_launch.py"),
               "--frames", str(fpath), "--out", str(out),
               "--coordinator", f"127.0.0.1:{port}",
               "--num_processes", "2", "--process_id", str(pid),
               "--cpu_devices", "4", "--sample", "0.03", "--eigvals", "8",
               "--sinkhorn_iters", "8", "--dtype", "float32",
               "--block_cols", "128", "--streaming",
               "--temporal_guide", "3", "--n_data", "1"]
        procs.append(subprocess.Popen(cmd, cwd=str(ROOT), env=env_base,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    logs = []
    for p in procs:
        out_text, _ = p.communicate(timeout=600)
        logs.append(out_text)
    assert all(p.returncode == 0 for p in procs), \
        "\n---\n".join(t[-3000:] for t in logs)

    got = np.load(tmp_path / "out0.npy")
    cfg = PipelineConfig(kernel="nlm", sample_rho=0.03, num_eigvecs=8,
                         sinkhorn_iters=8, affinity_dtype="float32",
                         streaming=True, block_cols=128)
    want, _ = filter_video(frames, cfg, temporal_guide=3)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=3e-4)


def test_launcher_explicit_keep():
    """--preset must not override flags the caller typed (the launcher
    twin of the CLI's _explicit_fields contract): an explicit
    --filter_mode spectral was silently routed to matvec before."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "multihost_launch", ROOT / "scripts" / "multihost_launch.py")
    ml = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ml)
    keep = ml.explicit_keep(["--image", "i.npy", "--filter_mode",
                             "spectral", "--preset", "fast"])
    assert "filter_mode" in keep
    assert "affinity_dtype" not in keep
    keep = ml.explicit_keep(["--frames", "f.npy", "--dtype=float32",
                             "--solver", "chol"])
    assert {"affinity_dtype", "solver"} <= keep
    assert "filter_mode" not in keep
    # argparse prefix abbreviations must pin too (--filter_mo resolves to
    # --filter_mode): the exact-spelling-only version missed them
    keep = ml.explicit_keep(["--filter_mo", "spectral", "--preset", "fast"])
    assert "filter_mode" in keep
    keep = ml.explicit_keep(["--filter_mo=spectral"])
    assert "filter_mode" in keep
    # ambiguous prefixes (argparse would reject the argv) pin nothing
    assert ml.explicit_keep(["--sinkhorn_", "4"]) == frozenset()
    assert ml.explicit_keep(["--", "x"]) == frozenset()
