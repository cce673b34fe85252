"""Unit + property tests: Nystrom eigendecomposition (SURVEY.md §4.1-4.2:
eigenvalues in [-1, 1], V orthonormality, exactness at p = N)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from graphlap.config import PipelineConfig
from graphlap.io import make_test_image
from graphlap.ops.affinity import affinity_strip_np, extract_features_np
from graphlap.ops.nystrom import nystrom_eigh, nystrom_eigh_np
from graphlap.ops.sinkhorn import normalize_blocks_np
from graphlap.utils.sampling import uniform_grid_sample

TOL = 3e-3


@pytest.fixture(scope="module")
def w_blocks():
    img = make_test_image(32, 32, seed=5)
    cfg = PipelineConfig(kernel="nlm", h=0.25)
    plan = uniform_grid_sample(32, 32, 48)
    feats = extract_features_np(img, cfg)
    fp = feats[plan.perm]
    strip = affinity_strip_np(fp[: plan.p], fp)
    waa, wab, _, _ = normalize_blocks_np(strip[:, : plan.p], strip[:, plan.p:],
                                         "sinkhorn", 20, TOL)
    return waa, wab


def test_eigenvalues_sorted_in_range(w_blocks):
    waa, wab = w_blocks
    vals, _ = nystrom_eigh_np(waa, wab, 24, TOL)
    assert np.all(np.diff(vals) <= 1e-12)           # descending
    assert vals[0] <= 1.0 + 5e-3                    # lam_1 ~ 1 (doubly stoch.)
    assert vals[0] > 0.9
    assert vals.min() >= -1.0 - 1e-6


def test_live_columns_orthonormal(w_blocks):
    waa, wab = w_blocks
    vals, v = nystrom_eigh_np(waa, wab, 24, TOL)
    norms = np.linalg.norm(v, axis=0)
    live = norms > 0.5
    g = v[:, live].T @ v[:, live]
    np.testing.assert_allclose(g, np.eye(live.sum()), atol=5e-3)
    # dead columns are exactly zero
    assert np.all(norms[~live] == 0.0)


def test_jax_matches_oracle_top_spectrum(w_blocks):
    waa, wab = w_blocks
    vals_np, v_np = nystrom_eigh_np(waa, wab, 24, TOL)
    basis = jax.jit(nystrom_eigh, static_argnums=(2, 3))(
        jnp.asarray(waa, jnp.float32), jnp.asarray(wab, jnp.float32), 24, TOL)
    vals_j = np.asarray(basis.vals, np.float64)
    # top (well-separated) eigenvalues agree tightly
    np.testing.assert_allclose(vals_j[:5], vals_np[:5], atol=2e-3)
    # filter action f(l)=l agrees (the denoise-gate property)
    y = np.random.default_rng(0).standard_normal(v_np.shape[0])
    z_np = v_np @ (vals_np * (v_np.T @ y))
    v_j = np.asarray(basis.vecs, np.float64)
    z_j = v_j @ (vals_j * (v_j.T @ y))
    assert np.abs(z_j - z_np).max() < 5e-3 * np.abs(z_np).max() + 5e-3


def test_exact_at_p_equals_n():
    """p = N: Nystrom reproduces the dense eigendecomposition exactly."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((60, 3))
    k = np.exp(-((x[:, None, :] - x[None, :, :]) ** 2).sum(-1))
    s = 1.0 / np.sqrt(k.sum(1))
    w = k * np.outer(s, s)
    m = 12
    vals, v = nystrom_eigh_np(w, np.zeros((60, 0)), m, TOL)
    dense_vals, dense_vecs = np.linalg.eigh(w)
    np.testing.assert_allclose(vals, dense_vals[::-1][:m], atol=1e-10)
    y = rng.standard_normal(60)
    z = v @ (vals * (v.T @ y))
    dv = dense_vecs[:, ::-1][:, :m]
    z_dense = dv @ (dense_vals[::-1][:m] * (dv.T @ y))
    np.testing.assert_allclose(z, z_dense, atol=1e-10)


def test_approximates_dense_filter():
    """Moderate sampling approximates the dense W action on smooth signals."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((120, 2))
    k = np.exp(-((x[:, None, :] - x[None, :, :]) ** 2).sum(-1) / 2)
    s = 1.0 / np.sqrt(k.sum(1))
    w = k * np.outer(s, s)
    p, m = 60, 30
    vals, v = nystrom_eigh_np(w[:p, :p], w[:p, p:], m, TOL)
    y = np.ones(120) + 0.1 * rng.standard_normal(120)
    z = v @ (vals * (v.T @ y))
    z_dense = w @ y
    # relative error on the smooth dominant part
    assert np.linalg.norm(z - z_dense) / np.linalg.norm(z_dense) < 0.15
