"""Property-based tests (hypothesis) for the HOST-side logic.

Deliberately jit-free: these cover the numpy bookkeeping whose edge
cases are shape arithmetic (sampling permutations, tile grids, the
netpbm codec, preset calibration), where randomized inputs find the
off-by-ones example-based tests miss. Compute-path properties
(doubly-stochastic sums, orthonormality) live next to their ops tests —
jit per example would be too slow here (SURVEY.md §4.2).
"""

import numpy as np
from hypothesis import given, settings, strategies as st

from graphlap.utils.sampling import SamplePlan, random_sample, \
    uniform_grid_sample


@settings(max_examples=60, deadline=None)
@given(st.integers(4, 97), st.integers(4, 97), st.integers(1, 200))
def test_grid_sample_plan_invariants(h, w, p_target):
    plan = uniform_grid_sample(h, w, min(p_target, h * w))
    n = h * w
    p = plan.p
    assert p == min(p_target, n)                     # EXACT count
    # idx_a: sorted unique valid flat indices, and perm starts with them
    assert np.all(np.diff(plan.idx_a) > 0)
    assert 0 <= plan.idx_a[0] and plan.idx_a[-1] < n
    np.testing.assert_array_equal(plan.perm[:p], plan.idx_a)
    # perm is a permutation and inv_perm inverts it
    assert np.array_equal(np.sort(plan.perm), np.arange(n))
    np.testing.assert_array_equal(plan.perm[plan.inv_perm], np.arange(n))
    np.testing.assert_array_equal(plan.inv_perm[plan.perm], np.arange(n))


@settings(max_examples=40, deadline=None)
@given(st.integers(4, 80), st.integers(4, 80), st.integers(1, 150),
       st.integers(0, 5))
def test_random_sample_plan_invariants(h, w, p_target, seed):
    plan = random_sample(h, w, min(p_target, h * w), seed=seed)
    n = h * w
    assert plan.p == min(p_target, n)
    assert len(np.unique(plan.idx_a)) == plan.p
    assert np.array_equal(np.sort(plan.perm), np.arange(n))
    np.testing.assert_array_equal(plan.perm[plan.inv_perm], np.arange(n))
    # determinism in the seed
    plan2 = random_sample(h, w, min(p_target, h * w), seed=seed)
    np.testing.assert_array_equal(plan.idx_a, plan2.idx_a)


@settings(max_examples=60, deadline=None)
@given(st.integers(1, 400), st.integers(2, 64), st.integers(0, 40))
def test_tile_starts_cover_without_gaps(size, tile, overlap):
    from graphlap.models.tiled import _tile_starts
    overlap = min(overlap, tile - 1)
    starts = _tile_starts(size, tile, tile - overlap)
    if size <= tile:
        assert starts == [0]
        return
    # uniform tile shape, full coverage, monotone starts
    assert all(0 <= s <= size - tile for s in starts)
    assert starts[0] == 0 and starts[-1] == size - tile
    covered = np.zeros(size, bool)
    for s in starts:
        covered[s:s + tile] = True
    assert covered.all()
    # consecutive tiles overlap by at least ``overlap`` (blend support)
    for a, b in zip(starts, starts[1:]):
        assert b - a <= tile - overlap


@settings(max_examples=25, deadline=None)
@given(st.integers(1, 31), st.integers(1, 31), st.sampled_from([1, 3]))
def test_netpbm_roundtrip(h, w, c):
    # write_netpbm's contract is FLOAT [0,1] (8-bit quantization on
    # write; 16-bit is read-side support) — the roundtrip must be exact
    # on the 8-bit grid for every shape incl. 1x1 and 1-wide images
    import os
    import tempfile

    from graphlap.native import read_netpbm, write_netpbm
    rng = np.random.default_rng(h * 131 + w)
    img = rng.uniform(0, 1, size=(h, w) if c == 1 else (h, w, c))
    img = img.astype(np.float32)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "t.ppm" if c == 3 else "t.pgm")
        write_netpbm(path, img)
        back = read_netpbm(path)
    assert back.shape == img.shape
    # quantization model: the native writer rounds HALF-UP, numpy's
    # round() half-even — at exact .5 grid points they differ by 1/255
    # (hypothesis found one), so bound against the ORIGINAL values with
    # half-step slack instead of re-modeling the rounding mode
    np.testing.assert_allclose(back, img, atol=0.51 / 255)


def test_netpbm_rejects_integer_input():
    # the footgun the property test surfaced: a 0-255 uint8 image would
    # silently write all-white (every value >= 1.0 clips)
    import pytest

    from graphlap.native import write_netpbm
    with pytest.raises(TypeError, match="float"):
        write_netpbm("/tmp/never.pgm", np.zeros((4, 4), np.uint8))


@settings(max_examples=60, deadline=None)
@given(st.integers(64, 1 << 24), st.integers(50, 8192),
       st.sampled_from([65536, 131072, 100_000, 4096, 99_999]),
       st.sampled_from(["fast", "turbo"]))
def test_preset_configs_always_construct(n, cap, block_cols, level):
    # any (N, p-cap, block width) must yield a VALID config whose
    # decimations divide the active block — the whole-space form of the
    # example-based divisibility regression tests
    from graphlap.config import PipelineConfig, tuned_config
    base = PipelineConfig(kernel="nlm", sample_cap=cap, streaming=True,
                          block_cols=block_cols)
    cfg = tuned_config(base, n, level)
    block = min(cfg.block_cols, n)
    assert block % cfg.sinkhorn_coarse == 0
    assert block % cfg.gram_coarse == 0
