"""Unit tests: Nystrom sampling + permutation (SURVEY.md §2.2 #3, §4.2)."""

import numpy as np
import pytest

from graphlap.utils.sampling import random_sample, uniform_grid_sample


@pytest.mark.parametrize("h,w,p", [(128, 128, 164), (96, 64, 61), (32, 32, 1024),
                                   (17, 31, 7), (8, 8, 64), (100, 40, 1)])
def test_exact_count_and_permutation_roundtrip(h, w, p):
    plan = uniform_grid_sample(h, w, p)
    n = h * w
    assert plan.p == p
    assert plan.perm.shape == (n,)
    assert plan.inv_perm.shape == (n,)
    # perm is a permutation and [A; B] ordered
    assert np.array_equal(np.sort(plan.perm), np.arange(n))
    assert np.array_equal(plan.perm[:p], plan.idx_a)
    # round trip
    x = np.random.default_rng(0).standard_normal(n)
    assert np.array_equal(x[plan.perm][plan.inv_perm], x)


def test_indices_sorted_unique_in_range():
    plan = uniform_grid_sample(64, 48, 31)
    assert np.all(np.diff(plan.idx_a) > 0)
    assert plan.idx_a.min() >= 0 and plan.idx_a.max() < 64 * 48


def test_spatial_uniformity():
    # samples should cover the image, not bunch up: every quadrant gets some
    h = w = 64
    plan = uniform_grid_sample(h, w, 64)
    rows, cols = plan.idx_a // w, plan.idx_a % w
    for rlo, rhi in [(0, h // 2), (h // 2, h)]:
        for clo, chi in [(0, w // 2), (w // 2, w)]:
            inq = ((rows >= rlo) & (rows < rhi) & (cols >= clo) & (cols < chi)).sum()
            assert inq >= 64 // 8


def test_oversample_clamps_to_n():
    plan = uniform_grid_sample(8, 8, 1000)
    assert plan.p == 64


@pytest.mark.parametrize("h,w,p", [(64, 64, 123), (17, 31, 7), (8, 8, 64)])
def test_random_sample_exact_count_and_roundtrip(h, w, p):
    plan = random_sample(h, w, p, seed=3)
    n = h * w
    assert plan.p == p
    assert np.array_equal(np.sort(plan.perm), np.arange(n))
    assert np.array_equal(plan.perm[:p], plan.idx_a)
    assert np.all(np.diff(plan.idx_a) > 0)        # sorted, distinct
    x = np.random.default_rng(0).standard_normal(n)
    assert np.array_equal(x[plan.perm][plan.inv_perm], x)


def test_random_sample_seeded_and_distinct_across_seeds():
    a = random_sample(64, 64, 100, seed=1)
    b = random_sample(64, 64, 100, seed=1)
    c = random_sample(64, 64, 100, seed=2)
    assert np.array_equal(a.idx_a, b.idx_a)
    assert not np.array_equal(a.idx_a, c.idx_a)


def test_random_mode_pipeline_matches_oracle_and_grid_quality():
    """End-to-end with sample_mode='random': same plan feeds both the JAX
    pipeline and the float64 oracle, so the 0.1 dB gate applies unchanged;
    and random sampling lands within a fraction of a dB of the grid plan
    (at 48^2 this config smooths more than it denoises for BOTH modes —
    the quality claim here is mode-equivalence, not absolute PSNR)."""
    import graphlap as gl
    from graphlap.models.pipeline import make_plan

    from .oracle import oracle_filter_image

    img = gl.make_test_image(48, 48)
    noisy = np.clip(gl.add_gaussian_noise(img, 0.1, seed=1), 0, 1)
    cfg = gl.PipelineConfig(kernel="nlm", h=0.25, sample_rho=0.05,
                            num_eigvecs=16, sample_mode="random",
                            sample_seed=7)
    plan = make_plan(noisy, cfg)
    res = gl.filter_image(noisy, cfg, plan=plan)
    p_out = gl.psnr(img, res.image)
    oz, _ = oracle_filter_image(noisy, cfg, plan=plan)
    assert abs(gl.psnr(img, np.clip(oz, 0, 1)) - p_out) <= 0.1
    gcfg = cfg.replace(sample_mode="grid")
    grid = gl.filter_image(noisy, gcfg, plan=make_plan(noisy, gcfg))
    assert abs(gl.psnr(img, grid.image) - p_out) < 0.5
