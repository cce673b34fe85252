"""Collective-volume invariants of the rows-sharded streaming builders.

Pins the design claim quantified by benchmarks/collective_volume.py
: every collective that executes PER SINKHORN ITERATION
carries p-class payloads (p-vectors / (p, p) grams — never anything
N-sized), so communication volume is independent of image size while
per-device work scales as N/R. GSPMD's generic lowering of jnp.take /
.at[].set on rows-sharded vectors violated this (N-class s32 index
all-gathers inside the loop) until the explicit p-class index prims
(parallel/streaming_sharded._gather_p_prim et al.) replaced them.
"""

import numpy as np
import pytest

import jax


def _hlo(batch: bool, side: int = 256):
    import graphlap as gl
    from graphlap.models.pipeline import make_plan
    from graphlap.parallel.mesh import make_mesh
    from graphlap.parallel.streaming_sharded import (
        build_streaming_sharded, build_streaming_sharded_batch)

    n_dev = len(jax.devices())
    cfg = gl.PipelineConfig(
        kernel="nlm", h=0.15, sample_rho=0.01, num_eigvecs=20,
        sinkhorn_iters=4, sinkhorn_coarse=4, sinkhorn_polish=1,
        gram_coarse=4, filter_name="identity", streaming=True,
        block_cols=side * side // (2 * n_dev))
    img = gl.make_test_image(side, side).astype(np.float32)
    plan = make_plan(img, cfg)
    if batch:
        mesh = make_mesh(n_rows=n_dev // 2, n_data=2)
        run = build_streaming_sharded_batch(mesh, cfg)
        args = (np.stack([img, img]), plan.idx_a)
    else:
        mesh = make_mesh(n_rows=n_dev)
        run = build_streaming_sharded(mesh, cfg)
        args = (img, plan.idx_a)
    return jax.jit(run).lower(*args).compile().as_text(), plan


@pytest.mark.parametrize("batch", [False, True],
                         ids=["single", "batched"])
def test_loop_collectives_are_p_class(batch):
    from benchmarks.collective_volume import collective_stats

    hlo, plan = _hlo(batch)
    stats = collective_stats(hlo)
    # the loop bodies DO communicate (the psum contraction)...
    assert stats["loop_body_bytes"] > 0
    # ...but never anything N-sized: every per-iteration payload is
    # p-class (p = samples; N/p = 100x here)
    assert stats["loop_body_max_dim"] <= 2 * plan.p + 256, stats["loop_body"]


def test_single_builder_all_collectives_p_class():
    """The single-image builder is p-class THROUGHOUT (setup included) —
    the stronger property benchmarks/collective_volume.py records; the
    batched builder keeps a documented one-time O(Nd/R) setup reshard."""
    from benchmarks.collective_volume import collective_stats

    hlo, plan = _hlo(batch=False)
    stats = collective_stats(hlo)
    assert stats["max_single_dim"] <= 2 * plan.p + 256
