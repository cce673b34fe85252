"""Randomized sketch eigensolver — subspace-iteration accelerator for the
chol/ridge path (ops/nystrom.py nystrom_sketch_factor).

Key property: it never materializes the O(p^2 N) gram — M-applies run as
thin strip passes — yet must land inside the same parity gate as chol,
because its float64 oracle twin IS the chol twin (tests/oracle.py).
"""

import numpy as np
import pytest

from graphlap import add_gaussian_noise, filter_image, make_test_image, psnr
from graphlap.config import CONFIG2, PipelineConfig

from .oracle import oracle_filter_image

TOL = 3e-3


@pytest.fixture(scope="module")
def img96():
    img = make_test_image(96, 96)
    noisy = np.clip(add_gaussian_noise(img, 0.1, seed=2), 0, 1)
    return img, noisy


def test_sketch_factor_matches_chol():
    """Top-m Ritz pairs from the sketch agree with the dense chol solve:
    eigenvalues to rtol 1e-3 and the spanned subspace to ~1e-3 principal
    angle (kernel spectra decay fast; 2 power iterations suffice)."""
    import jax.numpy as jnp

    from graphlap.ops.nystrom import (
        nystrom_chol_factor,
        nystrom_sketch_factor,
    )

    rng = np.random.default_rng(3)
    p, nb, m = 256, 1500, 16
    fa = rng.standard_normal((p, 5)).astype(np.float32)
    fb = rng.standard_normal((nb, 5)).astype(np.float32)

    def kern(a, b):
        d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
        return np.exp(-d2 / 5.0)

    waa = jnp.asarray(kern(fa, fa))
    wab = jnp.asarray(kern(fa, fb))
    cross = wab @ wab.T
    v1, x1 = nystrom_chol_factor(waa, cross, m, TOL)
    v2, x2 = nystrom_sketch_factor(waa, wab, m, TOL)
    np.testing.assert_allclose(np.asarray(v2), np.asarray(v1), rtol=1e-3)
    # subspace agreement, rotation/sign invariant
    q1, _ = np.linalg.qr(np.asarray(x1))
    q2, _ = np.linalg.qr(np.asarray(x2))
    s = np.linalg.svd(q1.T @ q2, compute_uv=False)
    assert s.min() > 1 - 1e-3


def test_sketch_e2e_gate(img96):
    """Full pipeline with solver='sketch' passes the graded 0.1 dB gate vs
    the float64 oracle AND stays pixel-close to the chol solve."""
    img, noisy = img96
    cfg = CONFIG2.replace(solver="sketch")
    res = filter_image(noisy, cfg)
    orc, _ = oracle_filter_image(noisy, cfg)
    delta = abs(psnr(img, res.image) - psnr(img, orc))
    assert delta <= 0.1, delta
    chol = filter_image(noisy, CONFIG2.replace(solver="chol"))
    assert abs(psnr(img, res.image) - psnr(img, chol.image)) <= 0.05


def test_sketch_small_p_saturates():
    """k = m + oversample >= p degenerates to a full-rank Rayleigh–Ritz —
    must still work (and then agrees with chol essentially exactly)."""
    img = make_test_image(32, 32, seed=5)
    noisy = np.clip(add_gaussian_noise(img, 0.1, seed=5), 0, 1)
    cfg = PipelineConfig(kernel="nlm", h=0.25, num_eigvecs=8,
                         sinkhorn_iters=10)
    res_s = filter_image(noisy, cfg.replace(solver="sketch"))
    res_c = filter_image(noisy, cfg.replace(solver="chol"))
    np.testing.assert_allclose(res_s.eigvals, res_c.eigvals,
                               rtol=1e-4, atol=1e-5)
    assert np.abs(res_s.image - res_c.image).max() < 1e-3


def test_sketch_survives_fast_decay_spectrum():
    """Regression: the gaussian kernel's spectrum hits ~1e-5 by index 50,
    so after a power step cond(Gram) overflows f32 — plain CholeskyQR2
    NaN'd here (caught by a preset drive at 256^2: output PSNR 4.9 dB).
    The eigh-whitened orthonormalizer must keep sketch == lobpcg."""
    img = make_test_image(128, 128, seed=3)
    noisy = np.clip(add_gaussian_noise(img, 0.1, seed=3), 0, 1)
    # gaussian kernel, enough samples that the sketch block is thin
    cfg = PipelineConfig(sample_rho=0.05, num_eigvecs=50, h=0.15,
                         sinkhorn_iters=8, affinity_dtype="bfloat16_store")
    assert cfg.num_samples(128 * 128) > 4 * (50 + 110) // 2   # p=819, k=160
    res_s = filter_image(noisy, cfg.replace(solver="sketch",
                                            sketch_oversample=110,
                                            sketch_power=1))
    res_l = filter_image(noisy, cfg.replace(solver="lobpcg"))
    assert np.isfinite(res_s.image).all()
    d = abs(psnr(img, res_s.image) - psnr(img, res_l.image))
    assert d < 0.05, d


def test_sketch_config_validation():
    with pytest.raises(ValueError):
        PipelineConfig(sketch_oversample=-1)
    with pytest.raises(ValueError):
        PipelineConfig(sketch_power=-1)
