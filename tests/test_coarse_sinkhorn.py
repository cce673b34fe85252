"""Coarse (decimated) Sinkhorn mode — streaming AND dense accelerator.

The alternating fixed point iterated through p-sized state against every
k-th column (PAPERS.md scalable-Sinkhorn idea). Exactness at k=1 was
verified against the symmetric fixed point analytically (s agreement to
1e-10 in the dense model); at k>1 the decimation adds a Monte-Carlo error
that SHRINKS with the coarse-set size — these tests pin the behavior at
test scale, where the error is visible but bounded. The dense twin
(ops/sinkhorn.sinkhorn_scaling_coarse) shares the fixed-point structure
against a strided slice of the materialized strip; its tests mirror the
streaming ones below.
"""

import numpy as np
import pytest

from graphlap import add_gaussian_noise, filter_image, make_test_image, psnr
from graphlap.config import PipelineConfig


@pytest.fixture(scope="module")
def img96():
    img = make_test_image(96, 96)
    noisy = np.clip(add_gaussian_noise(img, 0.1, seed=2), 0, 1)
    return img, noisy


def _cfg(**kw):
    return PipelineConfig(kernel="nlm", h=0.25, sample_rho=0.02,
                          num_eigvecs=50, streaming=True, block_cols=1024,
                          sinkhorn_iters=10, **kw)


def test_coarse_close_to_full(img96):
    img, noisy = img96
    full = filter_image(noisy, _cfg())
    coarse = filter_image(noisy, _cfg(sinkhorn_coarse=2))
    # still denoises, and stays close to the exact-Sinkhorn result
    assert psnr(img, coarse.image) > psnr(img, noisy) + 0.5
    assert abs(psnr(img, coarse.image) - psnr(img, full.image)) < 1.0
    assert np.abs(coarse.image - full.image).max() < 0.05


def test_coarse_error_shrinks_with_finer_decimation(img96):
    img, noisy = img96
    full = filter_image(noisy, _cfg())
    d2 = np.abs(filter_image(noisy, _cfg(sinkhorn_coarse=2)).image
                - full.image).max()
    d8 = np.abs(filter_image(noisy, _cfg(sinkhorn_coarse=8)).image
                - full.image).max()
    assert d2 < d8  # coarser decimation -> larger deviation


def test_polish_recovers_exactness(img96):
    """Full-resolution polish iterations contract the decimation bias:
    coarse+polish must land strictly closer to the exact-Sinkhorn result
    than coarse alone, monotonically in the polish count."""
    img, noisy = img96
    full = filter_image(noisy, _cfg())
    base = _cfg(sinkhorn_coarse=8)
    d0 = np.abs(filter_image(noisy, base).image - full.image).max()
    d2 = np.abs(filter_image(noisy, base.replace(sinkhorn_polish=2)).image
                - full.image).max()
    d4 = np.abs(filter_image(noisy, base.replace(sinkhorn_polish=4)).image
                - full.image).max()
    assert d2 < d0
    assert d4 < d2
    assert d4 < 0.2 * d0


def test_polish_batched_matches_single():
    from graphlap.models.pipeline import make_plan
    from graphlap.models.video import filter_video
    from graphlap.parallel.mesh import make_mesh
    from graphlap import add_gaussian_noise, make_test_image

    cfg = PipelineConfig(kernel="nlm", h=0.25, sample_rho=0.03,
                         num_eigvecs=16, sinkhorn_iters=8, streaming=True,
                         block_cols=128, sinkhorn_coarse=4,
                         sinkhorn_polish=2)
    frames = np.stack([
        np.clip(add_gaussian_noise(make_test_image(32, 32, seed=s), 0.1,
                                   seed=s), 0, 1)
        for s in range(2)
    ])
    plan = make_plan(frames[0], cfg)
    out, _ = filter_video(frames, cfg, mesh=make_mesh(n_rows=4, n_data=2),
                          plan=plan, frames_per_step=2)
    for i in range(2):
        ref = filter_image(frames[i], cfg, plan=plan)
        np.testing.assert_allclose(out[i], ref.image, atol=3e-4)


def _dcfg(**kw):
    return PipelineConfig(kernel="nlm", h=0.25, sample_rho=0.02,
                          num_eigvecs=50, sinkhorn_iters=10, **kw)


def test_dense_coarse_close_and_polish_contracts(img96):
    """Dense-path coarse Sinkhorn: close to the exact fixed point, and the
    polish contracts the decimation bias monotonically (the same contract
    the streaming twin pins above)."""
    img, noisy = img96
    full = filter_image(noisy, _dcfg())
    d0 = np.abs(filter_image(noisy, _dcfg(sinkhorn_coarse=8)).image
                - full.image).max()
    d2 = np.abs(filter_image(noisy, _dcfg(sinkhorn_coarse=8,
                                          sinkhorn_polish=2)).image
                - full.image).max()
    d4 = np.abs(filter_image(noisy, _dcfg(sinkhorn_coarse=8,
                                          sinkhorn_polish=4)).image
                - full.image).max()
    assert d2 < d0
    assert d4 < d2
    assert d4 < 0.2 * d0
    coarse = filter_image(noisy, _dcfg(sinkhorn_coarse=8, sinkhorn_polish=1))
    assert psnr(img, coarse.image) > psnr(img, noisy) + 0.5
    assert abs(psnr(img, coarse.image) - psnr(img, full.image)) < 0.5


def test_dense_coarse_any_factor():
    """No divisibility constraint on the dense path (strided slicing works
    for any k, unlike the streaming block layout)."""
    img = make_test_image(48, 48, seed=5)
    noisy = np.clip(add_gaussian_noise(img, 0.1, seed=5), 0, 1)
    res = filter_image(noisy, _dcfg(sinkhorn_coarse=3, sinkhorn_polish=1))
    assert np.isfinite(res.image).all()


def test_coarse_validation():
    with pytest.raises(ValueError):
        PipelineConfig(sinkhorn_coarse=0)
    # k must divide the streaming block
    cfg = _cfg(sinkhorn_coarse=3)
    img = make_test_image(32, 32)
    with pytest.raises(ValueError):
        filter_image(img, cfg)
