"""Tests: SURE-based no-reference bandwidth selection (tune.py).

The estimator's claim is strong — predict the MSE against the CLEAN image
from the noisy image alone — so the anchors here are the clean image
itself (never shown to SURE) and an exact Jacobian trace:

1. the Hutchinson divergence matches the exact sum of Jacobian diagonal
   entries (per-basis-vector jvp) on a shape small enough to brute-force;
2. SURE tracks the true (oracle-clean) MSE pointwise across the h grid
   and ranks the optimum correctly;
3. tune_h_sure lands on the same bandwidth the round-3 measured quality
   calibration chose (config.denoise_tuned: h = 2 sigma for gaussian),
   from the noisy image alone;
4. the streaming evaluation is the dense one (same math, strip-free).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from graphlap import (CONFIG1, CONFIG2, add_gaussian_noise,
                      make_test_image, sure_risk, tune_h_sure)
from graphlap.config import PipelineConfig
from graphlap.models.pipeline import _dense_wapply, make_plan
from graphlap.ops.affinity import affinity_blocks
from graphlap.ops.filters import apply_operator_filter
from graphlap.ops.sinkhorn import normalize_blocks
from graphlap.tune import _sure_parts, operator_surrogate


@pytest.fixture(scope="module")
def noisy64():
    img = make_test_image(64, 64)
    return img, np.clip(add_gaussian_noise(img, 0.1, seed=1),
                        0, 1).astype(np.float32)


def _surrogate_output(noisy, cfg, h):
    """Unclipped operator-mode output z (natural order) — what SURE
    estimates the clean-MSE of."""
    plan = make_plan(noisy, cfg)
    idx_a, perm = jnp.asarray(plan.idx_a), jnp.asarray(plan.perm)
    kaa, kab = affinity_blocks(jnp.asarray(noisy), idx_a, perm, cfg,
                               h=jnp.float32(h))
    _, _, s_a, s_b = normalize_blocks(
        kaa, kab, cfg.normalization, cfg.sinkhorn_iters, cfg.eig_tol,
        cfg.solver, cfg.sinkhorn_coarse, cfg.sinkhorn_polish)
    y_perm = jnp.take(jnp.asarray(noisy).ravel(), perm)
    z = apply_operator_filter(_dense_wapply(kaa, kab, s_a, s_b, cfg),
                              y_perm, cfg.filter_name, cfg.filter_param,
                              cfg.filter_mode, cfg.cheb_degree)
    return np.asarray(z)[np.asarray(plan.inv_perm)]


def test_hutchinson_divergence_matches_exact_trace():
    """div ~= tr(dz/dy) — checked against the exact trace (jvp on every
    basis vector) at 16^2, where brute force is affordable."""
    img = make_test_image(16, 16)
    noisy = np.clip(add_gaussian_noise(img, 0.1, seed=1),
                    0, 1).astype(np.float32)
    cfg = operator_surrogate(CONFIG1)
    plan = make_plan(noisy, cfg)
    idx_a, perm = jnp.asarray(plan.idx_a), jnp.asarray(plan.perm)
    n = plan.n
    h = jnp.float32(0.2)
    img_j = jnp.asarray(noisy)

    def zfun(im):
        kaa, kab = affinity_blocks(im, idx_a, perm, cfg, h=h)
        _, _, s_a, s_b = normalize_blocks(
            kaa, kab, cfg.normalization, cfg.sinkhorn_iters, cfg.eig_tol,
            cfg.solver, cfg.sinkhorn_coarse, cfg.sinkhorn_polish)
        y_perm = jnp.take(im.astype(jnp.float32).ravel(), perm)
        return apply_operator_filter(
            _dense_wapply(kaa, kab, s_a, s_b, cfg), y_perm, cfg.filter_name,
            cfg.filter_param, cfg.filter_mode, cfg.cheb_degree)

    def diag_entry(e2d):
        _, dz = jax.jvp(zfun, (img_j,), (e2d,))
        return jnp.sum(jnp.take(e2d.ravel(), perm) * dz)

    eye = jnp.eye(n).reshape(n, 16, 16)
    exact = float(jnp.sum(jax.lax.map(diag_entry, eye, batch_size=32)))

    _, div = _sure_parts(img_j, idx_a, perm, h, jax.random.PRNGKey(0),
                         cfg, 4)
    # measured <=0.5% across seeds/probes (the Jacobian is diagonally
    # dominant, so Rademacher variance is tiny); 3% is generous headroom
    assert abs(float(div) - exact) / exact < 0.03


def test_sure_tracks_true_mse_and_ranks_optimum(noisy64):
    """SURE (computed from the noisy image + sigma alone) must match the
    true clean-image MSE of the unclipped output pointwise and agree on
    the argmin across the h grid. Measured agreement is 3-7% per point."""
    img, noisy = noisy64
    cfg = operator_surrogate(CONFIG1)
    grid = [0.1, 0.15, 0.2, 0.3, 0.4]
    plan = make_plan(noisy, cfg)
    sures, trues = [], []
    for h in grid:
        row = sure_risk(noisy, cfg, sigma=0.1, plan=plan, h=h, probes=4)
        z = _surrogate_output(noisy, cfg, h)
        true_mse = float(np.mean((z - img.ravel()) ** 2))
        assert abs(row.sure - true_mse) <= 0.15 * true_mse + 5e-4, (
            f"h={h}: SURE {row.sure:.6f} vs true {true_mse:.6f}")
        sures.append(row.sure)
        trues.append(true_mse)
    assert int(np.argmin(sures)) == int(np.argmin(trues))


def test_tune_h_sure_recovers_calibrated_bandwidth(noisy64):
    """From the noisy image alone, the tuner must land on the bandwidth
    class the measured quality calibration chose with the clean reference
    in hand (h = 2 sigma = 0.2 at the graded sigma = 0.1)."""
    _, noisy = noisy64
    best, rows = tune_h_sure(noisy, CONFIG1, sigma=0.1)
    assert len(rows) == 5
    assert best.h == pytest.approx(0.2)
    # the tuned cfg keeps everything else (incl. the spectral filter mode)
    assert best.filter_mode == CONFIG1.filter_mode
    assert np.isfinite([r.sure for r in rows]).all()


def test_streaming_eval_matches_dense(noisy64):
    """The strip-free evaluation is the same math as the dense one."""
    _, noisy = noisy64
    cfg_d = operator_surrogate(CONFIG1)
    cfg_s = cfg_d.replace(streaming=True, block_cols=1024)
    plan = make_plan(noisy, cfg_d)
    img_j = jnp.asarray(noisy)
    key = jax.random.PRNGKey(3)
    fid_d, div_d = _sure_parts(img_j, jnp.asarray(plan.idx_a),
                               jnp.asarray(plan.perm), jnp.float32(0.2),
                               key, cfg_d, 4)
    fid_s, div_s = _sure_parts(img_j, jnp.asarray(plan.idx_a),
                               jnp.asarray(plan.perm), jnp.float32(0.2),
                               key, cfg_s, 4)
    np.testing.assert_allclose(float(fid_s), float(fid_d), rtol=1e-4)
    np.testing.assert_allclose(float(div_s), float(div_d), rtol=1e-3)


def test_sure_multichannel_and_estimated_sigma(noisy64):
    """(H, W, C) input averages per-channel estimates; sigma=None uses the
    wavelet-MAD estimate."""
    img, _ = noisy64
    rgb = np.stack([img, img * 0.8 + 0.1, img * 0.5 + 0.2], axis=-1)
    nrgb = np.clip(add_gaussian_noise(rgb, 0.1, seed=2), 0, 1)
    row = sure_risk(nrgb, CONFIG1, h=0.2)       # sigma estimated
    assert np.isfinite(row.sure) and np.isfinite(row.div)
    assert row.div > 0 and row.fidelity > 0


def test_operator_surrogate_mapping():
    base = PipelineConfig(use_pallas=True)
    # spectral identity -> exact matvec polynomial, pallas off
    s = operator_surrogate(base.replace(filter_name="identity"))
    assert s.filter_mode == "matvec" and not s.use_pallas
    # lowpass has no operator form -> identity proxy
    s = operator_surrogate(base.replace(filter_name="lowpass"))
    assert s.filter_name == "identity" and s.filter_mode == "matvec"
    # exp_decay -> chebyshev series
    s = operator_surrogate(base.replace(filter_name="exp_decay"))
    assert s.filter_mode == "chebyshev"
    # fractional power -> chebyshev; integer power -> matvec
    s = operator_surrogate(base.replace(filter_name="power",
                                        filter_param=0.5))
    assert s.filter_mode == "chebyshev"
    s = operator_surrogate(base.replace(filter_name="power",
                                        filter_param=2.0))
    assert s.filter_mode == "matvec"
    # already-operator configs pass through (minus pallas)
    mv = base.replace(filter_name="sharpen", filter_param=0.15,
                      filter_mode="matvec")
    assert operator_surrogate(mv) == mv.replace(use_pallas=False)


def test_cli_tune_sure(tmp_path, capsys):
    from graphlap import save_image
    from graphlap.cli import main as cli_main
    path = str(tmp_path / "in.png")
    save_image(path, make_test_image(64, 64))
    out = str(tmp_path / "out.png")
    rc = cli_main(["-f", path, "-o", out, "-grayscale", "-cpu",
                   "-sample", "0.02", "-eigvals", "24",
                   "-noise", "0.1", "-tune_sure"])
    assert rc == 0
    captured = capsys.readouterr().out
    assert "tune_sure: h=" in captured
    # explicit -h_param wins over the tuner
    rc = cli_main(["-f", path, "-o", out, "-grayscale", "-cpu",
                   "-sample", "0.02", "-eigvals", "24",
                   "-noise", "0.1", "-tune_sure", "-h_param", "0.33"])
    assert rc == 0
    assert "explicit -h_param wins" in capsys.readouterr().out


def test_cli_tune_sure_dense_infeasible_auto_streams(tmp_path, capsys,
                                                     monkeypatch):
    # regression: -tune_sure used to run BEFORE the dense-feasibility
    # fallback, so a dense-infeasible image crashed with the library's
    # raw strip-size ValueError instead of auto-enabling streaming
    from graphlap import save_image
    from graphlap.cli import main as cli_main
    from graphlap.models import pipeline as pl
    path = str(tmp_path / "in.png")
    save_image(path, make_test_image(64, 64))
    monkeypatch.setattr(pl, "dense_strip_bytes_limit", lambda: 1e5)
    rc = cli_main(["-f", path, "-grayscale", "-cpu", "-sample", "0.02",
                   "-eigvals", "24", "-noise", "0.1", "-tune_sure"])
    assert rc == 0
    captured = capsys.readouterr().out
    assert "auto-enabling -streaming" in captured
    assert "tune_sure: h=" in captured
