"""Coarse (decimated) gram mode — streaming-only accelerator for the
O(Np^2) one-shot cross, the full-resolution cost king at 8 MP.

Same Monte-Carlo structure as coarse Sinkhorn: the cross is an N-term sum
of outer products of spatially near-duplicate kernel columns, so uniform
decimation with energy-ratio rescaling estimates it with an error that
shrinks as the coarse set grows. Full-resolution colstats keeps column
norms / V^T y exact; only the p x p spectrum is estimated.
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


def test_coarse_gram_close_to_full(img96):
    img, noisy = img96
    full = filter_image(noisy, _cfg())
    coarse = filter_image(noisy, _cfg(gram_coarse=2))
    assert psnr(img, coarse.image) > psnr(img, noisy) + 0.5
    assert abs(psnr(img, coarse.image) - psnr(img, full.image)) < 0.5
    assert np.abs(coarse.image - full.image).max() < 0.05
    # leading eigenvalues barely move (spectrum is what the estimate feeds)
    np.testing.assert_allclose(coarse.eigvals[:5], full.eigvals[:5],
                               rtol=5e-2)


def test_coarse_gram_error_shrinks_with_finer_decimation(img96):
    img, noisy = img96
    full = filter_image(noisy, _cfg())
    d2 = np.abs(filter_image(noisy, _cfg(gram_coarse=2)).image
                - full.image).max()
    d8 = np.abs(filter_image(noisy, _cfg(gram_coarse=8)).image
                - full.image).max()
    assert d2 < d8


def test_coarse_gram_stacks_with_coarse_sinkhorn(img96):
    """The cfg4/cfg5 production recipe: both decimations at once."""
    img, noisy = img96
    full = filter_image(noisy, _cfg())
    fast = filter_image(noisy, _cfg(sinkhorn_coarse=2, gram_coarse=2))
    assert psnr(img, fast.image) > psnr(img, noisy) + 0.5
    assert abs(psnr(img, fast.image) - psnr(img, full.image)) < 1.0


def test_coarse_gram_sharded_batch_matches_single():
    from graphlap.models.pipeline import make_plan
    from graphlap.models.video import filter_video
    from graphlap.parallel.mesh import make_mesh

    cfg = PipelineConfig(kernel="nlm", h=0.25, sample_rho=0.03,
                         num_eigvecs=16, sinkhorn_iters=8, streaming=True,
                         block_cols=128, sinkhorn_coarse=4, gram_coarse=4)
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


def test_coarse_gram_validation():
    with pytest.raises(ValueError):
        PipelineConfig(gram_coarse=0)
    cfg = _cfg(gram_coarse=3)          # must divide block_cols=1024
    img = make_test_image(32, 32)
    with pytest.raises(ValueError):
        filter_image(img, cfg)


def test_gram_sample_idx_regimes():
    """Sampler contract: strided below the k=16 jitter crossover, jittered
    at/above it; one in-slot index per k columns; deterministic."""
    from graphlap.models.streaming import GRAM_JITTER_MIN, gram_sample_idx

    n_pad = 4096
    idx8 = gram_sample_idx(n_pad, 8)
    assert np.array_equal(idx8, np.arange(0, n_pad, 8))     # plain stride
    for k in (16, 32, 64):
        idx = gram_sample_idx(n_pad, k)
        assert idx.shape == (n_pad // k,)
        slots = np.arange(0, n_pad, k)
        assert np.all(idx >= slots) and np.all(idx < slots + k)  # in-slot
        assert not np.array_equal(idx, slots)               # actually jittered
        assert np.array_equal(idx, gram_sample_idx(n_pad, k))  # deterministic
    assert GRAM_JITTER_MIN == 16


def test_sinkhorn_sample_idx_diagonal():
    """Coarse-Sinkhorn sampler contract (sinkhorn_sample_idx): exactly one
    in-slot index per k columns, deterministic, and the offset ROTATES by a
    k-coprime step per image row so every column phase is covered within k
    rows — the natural-order raster anti-alias (a plain ::k stride sampled
    only the vertical stripes x = 0 mod k and measured up to 0.094 dB of
    fixed-point bias at cfg2 vs 0.005 dB for the diagonal sample)."""
    from graphlap.models.streaming import sinkhorn_sample_idx

    for n_pad, k, w in ((512 * 512, 16, 512), (8192, 8, 64), (4096, 64, 64)):
        idx = sinkhorn_sample_idx(n_pad, k, w)
        assert idx.shape == (n_pad // k,)
        slots = np.arange(0, n_pad, k)
        assert np.all(idx >= slots) and np.all(idx < slots + k)   # in-slot
        assert np.array_equal(idx, sinkhorn_sample_idx(n_pad, k, w))
        # column-phase coverage: across image rows the sampled x mod k
        # must hit every residue class (the stride hits exactly one)
        phases = np.unique(idx % k)
        assert phases.size == k
        # offsets constant within a row, rotated between rows
        rows = idx // w
        off = idx % k
        first_rows = rows[: 2 * (w // k)]
        if w // k >= 1 and np.unique(first_rows).size > 1:
            assert np.unique(off[: w // k]).size == 1   # constant in row 0
