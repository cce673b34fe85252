"""Cholesky/ridge eigensolver (the fast default) — exactness and parity.

The key property over the classical one-shot: V is EXACTLY orthonormal by
construction and the whole path is backward-stable (no eigenbasis-rotation
ambiguity), giving ~1e-6 f32-vs-f64 agreement even on projection/affine
filters (measured 100+ dB; the one-shot managed 60-99 dB).
"""

import numpy as np
import pytest

from graphlap import add_gaussian_noise, filter_image, make_test_image, psnr
from graphlap.config import CONFIG2, PipelineConfig
from graphlap.ops.nystrom import nystrom_eigh_chol_np, nystrom_eigh_np

from .oracle import oracle_filter_image

TOL = 3e-3


@pytest.fixture(scope="module")
def img96():
    img = make_test_image(96, 96)
    noisy = np.clip(add_gaussian_noise(img, 0.1, seed=2), 0, 1)
    return img, noisy


def _blocks():
    from graphlap.ops.affinity import affinity_strip_np, extract_features_np
    from graphlap.ops.sinkhorn import normalize_blocks_np
    from graphlap.utils.sampling import uniform_grid_sample
    img = make_test_image(32, 32, seed=5)
    cfg = PipelineConfig(kernel="nlm", h=0.25)
    plan = uniform_grid_sample(32, 32, 48)
    feats = extract_features_np(img, cfg)
    fp = feats[plan.perm]
    strip = affinity_strip_np(fp[: plan.p], fp)
    return normalize_blocks_np(strip[:, : plan.p], strip[:, plan.p:],
                               "sinkhorn", 20, TOL, "chol")[:2]


def test_exactly_orthogonal_columns():
    """Columns are exactly mutually orthogonal; norms equal the soft gate
    (1 for clearly-live eigenvalues, ramping to 0 below the cutoff)."""
    waa, wab = _blocks()
    vals, v = nystrom_eigh_chol_np(waa, wab, 24, TOL)
    g = v.T @ v
    off = g - np.diag(np.diag(g))
    assert np.abs(off).max() < 1e-10
    norms = np.linalg.norm(v, axis=0)
    assert np.all(norms <= 1.0 + 1e-10)
    # well-above-cutoff columns are exactly unit norm
    clear = vals > 4 * TOL * vals[0]
    np.testing.assert_allclose(norms[clear], 1.0, atol=1e-10)


def test_matches_oneshot_spectrum_top():
    """Both solvers approximate the same operator: top eigenvalues agree
    (ridge vs truncation legitimately shift the small ones)."""
    waa, wab = _blocks()
    v1, _ = nystrom_eigh_chol_np(waa, wab, 24, TOL)
    v2, _ = nystrom_eigh_np(waa, wab, 24, TOL)
    np.testing.assert_allclose(v1[:5], v2[:5], rtol=5e-2)


def test_chol_default_and_gate(img96):
    img, noisy = img96
    # default is lobpcg, which IS the chol math (dense-eigh fallback at
    # small p, top-m LOBPCG above)
    assert CONFIG2.solver == "lobpcg"
    res = filter_image(noisy, CONFIG2)
    orc, _ = oracle_filter_image(noisy, CONFIG2)
    delta = abs(psnr(img, res.image) - psnr(img, orc))
    assert delta <= 0.05, delta
    assert np.abs(res.image - orc).max() < 1e-4


@pytest.mark.parametrize("name,param", [("sharpen", 0.6), ("lowpass", 0.0)])
def test_chol_projection_filters_tight(img96, name, param):
    img, noisy = img96
    cfg = CONFIG2.replace(filter_name=name, filter_param=param)
    res = filter_image(noisy, cfg)
    orc, _ = oracle_filter_image(noisy, cfg)
    assert psnr(orc, res.image) >= 90.0


def test_lobpcg_iterative_branch_matches_chol():
    """Exercise the ACTUAL LOBPCG iteration (p > 5m), not the dense-eigh
    fallback every small config hits — the production default at
    p ~ 5k / m = 50 runs this branch (it had zero coverage).
    64x64 @ rho=0.5 -> p = 2048 >> 5*8."""
    img = make_test_image(64, 64, seed=7)
    noisy = np.clip(add_gaussian_noise(img, 0.1, seed=7), 0, 1)
    base = PipelineConfig(kernel="nlm", h=0.25, sample_rho=0.5,
                          num_eigvecs=8, sinkhorn_iters=10)
    plan_p = base.num_samples(64 * 64)
    assert 5 * base.num_eigvecs < plan_p, plan_p   # iterative branch live
    res_lob = filter_image(noisy, base.replace(solver="lobpcg"))
    res_chol = filter_image(noisy, base.replace(solver="chol"))
    np.testing.assert_allclose(res_lob.eigvals, res_chol.eigvals,
                               rtol=1e-4, atol=1e-5)
    assert np.abs(res_lob.image - res_chol.image).max() < 1e-3


def test_oneshot_still_available(img96):
    img, noisy = img96
    cfg = CONFIG2.replace(solver="oneshot")
    res = filter_image(noisy, cfg)
    orc, _ = oracle_filter_image(noisy, cfg)
    assert abs(psnr(img, res.image) - psnr(img, orc)) <= 0.1


def test_bf16_store_close(img96):
    """bfloat16_store: f32 distance math (no GEMM-trick cancellation), bf16
    strip STORAGE — must land far closer to f32 than full-bf16 does."""
    img, noisy = img96
    f32 = filter_image(noisy, CONFIG2)
    store = filter_image(noisy, CONFIG2.replace(affinity_dtype="bfloat16_store"))
    full = filter_image(noisy, CONFIG2.replace(affinity_dtype="bfloat16"))
    d_store = abs(psnr(img, store.image) - psnr(img, f32.image))
    d_full = abs(psnr(img, full.image) - psnr(img, f32.image))
    assert d_store < 0.05
    assert psnr(f32.image, store.image) > 50.0
    assert d_store <= d_full + 1e-6


def test_gram_dtype_bf16_close(img96):
    """bf16 on ONLY the one-shot cross GEMM (gram_dtype) stays near the f32
    result — the input rounding perturbs just the p x p spectrum."""
    img, noisy = img96
    f32 = filter_image(noisy, CONFIG2)
    bf = filter_image(noisy, CONFIG2.replace(gram_dtype="bfloat16"))
    assert abs(psnr(img, bf.image) - psnr(img, f32.image)) < 0.05
    assert psnr(f32.image, bf.image) > 55.0


def test_solver_validation():
    with pytest.raises(ValueError):
        PipelineConfig(solver="qr")
    with pytest.raises(ValueError):
        PipelineConfig(gram_dtype="fp8")
