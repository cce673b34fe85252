"""Sinkhorn fixed-iteration validation (SURVEY.md §7 hard part 5).

The reference iterates to a convergence test; we use a shape-static fixed
count. These tests pin down that the default count is in the converged
regime across the config matrix's kernel types.
"""

import numpy as np
import pytest

from graphlap.config import PipelineConfig
from graphlap.io import make_test_image
from graphlap.ops.affinity import affinity_strip_np, extract_features_np
from graphlap.ops.linalg import psd_pinv_np
from graphlap.ops.sinkhorn import nystrom_matvec_np, sinkhorn_scaling_np
from graphlap.utils.sampling import uniform_grid_sample

TOL = 3e-3


def _blocks(kernel):
    img = make_test_image(48, 48, seed=6)
    cfg = PipelineConfig(kernel=kernel, h=0.25 if kernel == "nlm" else 0.3)
    plan = uniform_grid_sample(48, 48, 70)
    feats = extract_features_np(img, cfg)
    fp = feats[plan.perm]
    strip = affinity_strip_np(fp[: plan.p], fp)
    return strip[:, : plan.p], strip[:, plan.p:]


@pytest.mark.parametrize("kernel", ["gaussian", "nlm"])
def test_default_iterations_converged(kernel):
    """20 iterations lands within 0.5% of the 200-iteration fixed point."""
    kaa, kab = _blocks(kernel)
    sa20, sb20 = sinkhorn_scaling_np(kaa, kab, 20, TOL)
    sa200, sb200 = sinkhorn_scaling_np(kaa, kab, 200, TOL)
    assert np.abs(sa20 / sa200 - 1).max() < 5e-3
    assert np.abs(sb20 / sb200 - 1).max() < 5e-3


@pytest.mark.parametrize("kernel", ["gaussian", "nlm"])
def test_ds_residual_pins_calibrated_iteration_counts(kernel):
    """The opt-in DS-residual diagnostic (ops/sinkhorn.ds_residual — the
    runtime check on the fixed iteration counts) agrees
    with its f64 twin, shrinks with depth, and certifies the calibrated
    counts: converged (20 it) lands well under the documented ~1e-2
    advisory threshold, and the production 8-iteration recipe stays
    within it."""
    import jax.numpy as jnp

    from graphlap.ops.sinkhorn import (ds_residual, ds_residual_np,
                                       sinkhorn_scaling)

    kaa, kab = _blocks(kernel)
    resid = {}
    for iters in (4, 8, 20):
        s_a, s_b = sinkhorn_scaling_np(kaa, kab, iters, TOL)
        resid[iters] = ds_residual_np(kaa, kab, s_a, s_b, TOL)
    assert resid[20] <= resid[8] <= resid[4] * 1.001
    assert resid[20] < 2e-3           # converged regime
    assert resid[8] < 1e-2            # the production count clears the
                                      # documented advisory threshold
    # f32 JAX twin agrees with the f64 reference at the f32 noise floor
    kaa32, kab32 = jnp.asarray(kaa, jnp.float32), jnp.asarray(kab, jnp.float32)
    s_a32, s_b32 = sinkhorn_scaling(kaa32, kab32, 8, TOL)
    r32 = float(ds_residual(kaa32, kab32, s_a32, s_b32, TOL))
    assert abs(r32 - resid[8]) < 1e-3


def test_ds_residual_pipeline_api():
    """sinkhorn_ds_residual routes dense and streaming configs and both
    certify the calibrated default (20 iters) on a real image."""
    from graphlap.models.pipeline import sinkhorn_ds_residual

    img = make_test_image(64, 64, seed=3)
    cfg = PipelineConfig(kernel="gaussian", h=0.3, sample_rho=0.02)
    r_dense = sinkhorn_ds_residual(img, cfg)
    r_stream = sinkhorn_ds_residual(img, cfg.replace(streaming=True,
                                                     block_cols=4096))
    assert r_dense < 1e-2
    assert r_stream < 1e-2
    # the two paths measure the same fixed point (both f32)
    assert abs(r_dense - r_stream) < 2e-3


@pytest.mark.parametrize("kernel", ["gaussian", "nlm"])
def test_converged_scaling_is_doubly_stochastic(kernel):
    """At the fixed point, diag(s) K~ diag(s) row sums ~ 1 (on the
    well-conditioned bulk; the truncated K_BB completion biases a tail)."""
    kaa, kab = _blocks(kernel)
    s_a, s_b = sinkhorn_scaling_np(kaa, kab, 200, TOL)
    pinv = psd_pinv_np(kaa, TOL)
    top, bottom = nystrom_matvec_np(kaa * np.outer(s_a, s_a),
                                    kab * np.outer(s_a, s_b),
                                    psd_pinv_np(kaa * np.outer(s_a, s_a), TOL),
                                    np.ones_like(s_a), np.ones_like(s_b))
    sums = np.concatenate([top, bottom])
    assert np.abs(np.median(sums) - 1) < 0.02
