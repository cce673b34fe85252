"""Unit tests: spectral filter registry + application modes."""

import jax.numpy as jnp
import numpy as np
import pytest

from graphlap.ops.filters import (
    FILTER_REGISTRY,
    apply_spectral_filter,
    apply_spectral_filter_np,
)


@pytest.fixture()
def basis():
    rng = np.random.default_rng(0)
    q, _ = np.linalg.qr(rng.standard_normal((40, 8)))
    vals = np.linspace(1.0, 0.05, 8)
    y = rng.standard_normal(40)
    return vals, q, y


def test_registry_complete():
    assert set(FILTER_REGISTRY) == {"identity", "power", "lowpass", "sharpen",
                                    "exp_decay", "twicing"}
    assert FILTER_REGISTRY["sharpen"].affine
    assert FILTER_REGISTRY["twicing"].affine
    assert not FILTER_REGISTRY["identity"].affine


def test_twicing_residual_addback(basis):
    """z = y - V (1-L)^k V^T y: equals one residual-iteration of the
    identity filter on the basis subspace at k=1, and converges to the
    UNFILTERED input (residual included) as k grows — the defining
    property of twicing/boosting (Milanfar 2013)."""
    vals, q, y = basis
    z1 = apply_spectral_filter_np(y, vals, q, "twicing", 1.0)
    np.testing.assert_allclose(z1, y - q @ ((1.0 - vals) * (q.T @ y)),
                               atol=1e-12)
    # on the basis subspace, twicing k=1 == one application of W
    np.testing.assert_allclose(
        q.T @ z1, q.T @ apply_spectral_filter_np(y, vals, q, "identity", 0.0),
        atol=1e-12)
    # out-of-basis residual passes through at every k
    resid = y - q @ (q.T @ y)
    z5 = apply_spectral_filter_np(y, vals, q, "twicing", 5.0)
    np.testing.assert_allclose(z5 - q @ (q.T @ z5), resid, atol=1e-12)
    # monotone convergence toward y: higher k, smaller ||z - y||
    gap = [np.linalg.norm(apply_spectral_filter_np(y, vals, q, "twicing", k) - y)
           for k in (1.0, 3.0, 9.0, 27.0)]
    assert gap[0] > gap[1] > gap[2] > gap[3]
    # jnp path agrees with numpy
    zj = apply_spectral_filter(jnp.asarray(y, jnp.float32),
                               jnp.asarray(vals, jnp.float32),
                               jnp.asarray(q, jnp.float32), "twicing", 3.0)
    np.testing.assert_allclose(
        np.asarray(zj),
        apply_spectral_filter_np(y, vals, q, "twicing", 3.0), atol=1e-5)


def test_identity_equals_weighted_projection(basis):
    vals, q, y = basis
    z = apply_spectral_filter_np(y, vals, q, "identity", 0.0)
    np.testing.assert_allclose(z, q @ (vals * (q.T @ y)), atol=1e-12)


def test_power_one_equals_identity(basis):
    vals, q, y = basis
    z1 = apply_spectral_filter_np(y, vals, q, "identity", 0.0)
    zk = apply_spectral_filter_np(y, vals, q, "power", 1.0)
    np.testing.assert_allclose(z1, zk, atol=1e-12)


def test_power_k_is_k_step_diffusion(basis):
    vals, q, y = basis
    z3 = apply_spectral_filter_np(y, vals, q, "power", 3.0)
    np.testing.assert_allclose(z3, q @ (vals**3 * (q.T @ y)), atol=1e-12)


def test_lowpass_is_projection(basis):
    vals, q, y = basis
    z = apply_spectral_filter_np(y, vals, q, "lowpass", 0.0)
    np.testing.assert_allclose(z, q @ (q.T @ y), atol=1e-12)
    # projection idempotent
    z2 = apply_spectral_filter_np(z, vals, q, "lowpass", 0.0)
    np.testing.assert_allclose(z2, z, atol=1e-10)


def test_sharpen_affine_preserves_residual(basis):
    """Affine filters act as identity outside span(V)."""
    vals, q, y = basis
    resid = y - q @ (q.T @ y)
    z = apply_spectral_filter_np(y, vals, q, "sharpen", 0.7)
    z_resid = z - q @ (q.T @ z)
    np.testing.assert_allclose(z_resid, resid, atol=1e-10)
    # DC direction (lambda=1) untouched: f(1) = 1
    np.testing.assert_allclose(q[:, 0].T @ z, q[:, 0].T @ y, atol=1e-10)


def test_sharpen_boosts_detail(basis):
    vals, q, y = basis
    z = apply_spectral_filter_np(y, vals, q, "sharpen", 0.8)
    # high-frequency (small-lambda) coefficients grow by 1 + b(1-l)
    c_in = q.T @ y
    c_out = q.T @ z
    np.testing.assert_allclose(c_out, (1 + 0.8 * (1 - vals)) * c_in, atol=1e-10)


def test_jax_matches_numpy(basis):
    vals, q, y = basis
    for name, par in [("identity", 0.0), ("power", 2.0), ("lowpass", 0.0),
                      ("sharpen", 0.6), ("exp_decay", 2.0)]:
        z_np = apply_spectral_filter_np(y, vals, q, name, par)
        z_j = np.asarray(apply_spectral_filter(
            jnp.asarray(y, jnp.float32), jnp.asarray(vals, jnp.float32),
            jnp.asarray(q, jnp.float32), name, par))
        np.testing.assert_allclose(z_j, z_np, atol=1e-5)


def test_config_and_ops_validation_agree():
    """config.__post_init__ re-implements ops/filters' operator-mode
    checkers (config cannot import jax-bearing modules) — this pin keeps
    the two validations accepting EXACTLY the same (name, param, mode)
    space, so config-time and apply-time never disagree (review finding:
    the chebyshev param>=0 rule had drifted out of config)."""
    import numpy as np
    import pytest

    from graphlap.config import FILTERS, PipelineConfig
    from graphlap.ops.filters import (check_chebyshev_filter,
                                      check_matvec_filter)

    def accepts(fn, *a):
        try:
            fn(*a)
            return True
        except ValueError:
            return False

    for name in FILTERS:
        for param in (-1.0, 0.0, 0.5, 1.0, 2.0, 2.5, 3.0):
            cfg_ok = accepts(lambda: PipelineConfig(
                filter_name=name, filter_param=param,
                filter_mode="matvec"))
            ops_ok = accepts(check_matvec_filter, name, param)
            assert cfg_ok == ops_ok, ("matvec", name, param, cfg_ok, ops_ok)
            cfg_ok = accepts(lambda: PipelineConfig(
                filter_name=name, filter_param=param,
                filter_mode="chebyshev"))
            ops_ok = accepts(check_chebyshev_filter, name, param)
            assert cfg_ok == ops_ok, ("cheb", name, param, cfg_ok, ops_ok)
