"""Unit + property tests: Sinkhorn balancing in Nystrom low-rank form
(SURVEY.md §4.2: doubly-stochastic rows/cols sum to 1 +- eps)."""

import jax.numpy as jnp
import numpy as np
import pytest

from graphlap.config import PipelineConfig
from graphlap.io import make_test_image
from graphlap.ops.affinity import affinity_strip_np, extract_features_np
from graphlap.ops.linalg import psd_pinv_np
from graphlap.ops.sinkhorn import (
    normalize_blocks,
    normalize_blocks_np,
    nystrom_matvec_np,
    sinkhorn_scaling,
    sinkhorn_scaling_np,
)

TOL = 3e-3


@pytest.fixture(scope="module")
def blocks():
    img = make_test_image(32, 32, seed=4)
    cfg = PipelineConfig(kernel="nlm", h=0.25)
    from graphlap.utils.sampling import uniform_grid_sample
    plan = uniform_grid_sample(32, 32, 48)
    feats = extract_features_np(img, cfg)
    fp = feats[plan.perm]
    strip = affinity_strip_np(fp[: plan.p], fp)
    return strip[:, : plan.p], strip[:, plan.p:]


def test_jax_matches_oracle(blocks):
    kaa, kab = blocks
    s_a_np, s_b_np = sinkhorn_scaling_np(kaa, kab, 20, TOL)
    s_a, s_b = sinkhorn_scaling(jnp.asarray(kaa, jnp.float32),
                                jnp.asarray(kab, jnp.float32), 20, TOL)
    np.testing.assert_allclose(np.asarray(s_a), s_a_np, rtol=2e-4)
    np.testing.assert_allclose(np.asarray(s_b), s_b_np, rtol=2e-4)


def test_doubly_stochastic_property(blocks):
    """After scaling, rows AND cols of the implicit W~ sum to ~1."""
    kaa, kab = blocks
    s_a, s_b = sinkhorn_scaling_np(kaa, kab, 60, TOL)
    waa = kaa * np.outer(s_a, s_a)
    wab = kab * np.outer(s_a, s_b)
    kaa_pinv = psd_pinv_np(kaa, TOL)
    # row sums of the completion via the strip matvec with v = 1
    sa_pinv = psd_pinv_np(waa, TOL)
    top, bottom = nystrom_matvec_np(waa, wab, sa_pinv,
                                    np.ones(waa.shape[0]), np.ones(wab.shape[1]))
    sums = np.concatenate([top, bottom])
    # completion-based row sums converge to 1 (tolerance reflects the
    # truncated pseudo-inverse in the K_BB completion)
    assert np.abs(np.median(sums) - 1.0) < 0.05
    assert np.abs(sums - 1.0).mean() < 0.1


def test_symmetric_normalization_rowsums(blocks):
    kaa, kab = blocks
    waa, wab, s_a, s_b = normalize_blocks_np(kaa, kab, "symmetric", 0, TOL)
    assert waa.shape == kaa.shape and wab.shape == kab.shape
    assert np.all(s_a > 0) and np.all(s_b > 0)
    # jax path agrees
    waa_j, wab_j, _, _ = normalize_blocks(jnp.asarray(kaa, jnp.float32),
                                          jnp.asarray(kab, jnp.float32),
                                          "symmetric", 0, TOL)
    np.testing.assert_allclose(np.asarray(waa_j), waa, rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(wab_j), wab, rtol=0, atol=1e-5)


def test_none_normalization_identity(blocks):
    kaa, kab = blocks
    waa, wab, s_a, s_b = normalize_blocks_np(kaa, kab, "none", 0, TOL)
    np.testing.assert_array_equal(waa, kaa)
    np.testing.assert_array_equal(wab, kab)
    assert np.all(s_a == 1.0) and np.all(s_b == 1.0)


def test_scaled_blocks_stay_symmetric_psd(blocks):
    kaa, kab = blocks
    waa, _, _, _ = normalize_blocks_np(kaa, kab, "sinkhorn", 20, TOL)
    np.testing.assert_allclose(waa, waa.T, atol=1e-12)
    assert np.linalg.eigh(waa)[0].min() > -1e-10
