"""Device-memory budgets and accounting.

``memory_budget`` sizes every capacity bound of the pipeline (dense strip,
strip_cache strip, materialized V, parallel RGB channels) as a fraction
of the device's memory limit, read from ``memory_stats()["bytes_limit"]``.

``peak_hbm_gib`` reports the runtime ``peak_bytes_in_use`` where the
backend keeps memory stats (GPUs do), else XLA's compile-time
``memory_analysis()``: the buffer-assignment sizes (arguments, outputs,
temporaries) of the lowered executable.

The analytic memory table in docs/ARCHITECTURE.md §6 is pinned against
this by tests/test_meminfo.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# The CPU backend keeps no memory stats. There the bounds resolve against
# this fixed test budget, so the CPU test suite keeps its routes.
CPU_TEST_BUDGET_BYTES = 16e9

# Fractions of the device memory limit, one per capacity bound.
DENSE_STRIP_FRACTION = 0.5     # one (p, N) strip, dense or strip_cache
V_FRACTION = 0.375             # the materialized (N, m) f32 eigenbasis V
CHANNEL_STRIPS_FRACTION = 0.25  # C per-channel strips vmapped at once


def device_memory_bytes() -> float:
    """Memory limit of the default device in bytes. A non-CPU device
    without ``memory_stats()['bytes_limit']`` is an error, not a guess."""
    dev = jax.devices()[0]
    if dev.platform == "cpu":
        return CPU_TEST_BUDGET_BYTES
    stats = dev.memory_stats()
    if not stats or "bytes_limit" not in stats:
        raise RuntimeError(
            f"{dev.device_kind}: memory_stats() reports no bytes_limit to "
            f"size the capacity bounds from")
    return float(stats["bytes_limit"])


def memory_budget(fraction: float) -> float:
    """``fraction`` of the default device's memory limit, in bytes."""
    return fraction * device_memory_bytes()


def executable_hbm_bytes(lowered_or_compiled) -> dict | None:
    """{args, outputs, temps, total} bytes of a lowered/compiled jit.

    ``total`` = arguments + outputs + temporaries - aliased: the HBM the
    executable needs live at once (XLA CompiledMemoryStats semantics).
    Returns None where the backend doesn't implement the analysis."""
    obj = lowered_or_compiled
    if hasattr(obj, "compile"):
        obj = obj.compile()
    try:
        ma = obj.memory_analysis()
    except Exception:
        return None
    if ma is None:
        return None

    def _get(*names):
        for n in names:
            v = getattr(ma, n, None)
            if v is not None:
                return float(v)
        return 0.0

    args = _get("argument_size_in_bytes")
    outs = _get("output_size_in_bytes")
    temps = _get("temp_size_in_bytes")
    alias = _get("alias_size_in_bytes")
    return {"args": args, "outputs": outs, "temps": temps, "alias": alias,
            "total": args + outs + temps - alias}


def pipeline_hbm_analysis(image_shape: tuple, cfg, plan) -> dict | None:
    """Compile-time HBM footprint of the single-channel pipeline executable
    at this (shape, config, plan) — the fill for matrix rows' peak_hbm
    column when runtime memory_stats is unavailable. Lowering hits the jit
    trace cache; compiling hits the persistent compilation cache, so after
    the row's own warm run this is cheap."""
    from ..models.pipeline import _filter_channel

    h, w = image_shape[:2]
    img = jax.ShapeDtypeStruct((h, w), jnp.float32)
    idx_a = jax.ShapeDtypeStruct(plan.idx_a.shape, jnp.int32)
    if cfg.streaming:
        perm = inv_perm = idx_a          # contract: never read (streaming.py)
    else:
        perm = jax.ShapeDtypeStruct(plan.perm.shape, jnp.int32)
        inv_perm = perm
    try:
        lowered = _filter_channel.lower(img, idx_a, perm, inv_perm, cfg=cfg)
    except Exception:
        return None
    return executable_hbm_bytes(lowered)


def video_hbm_analysis(chunk_shape: tuple, cfg, plan, mesh) -> dict | None:
    """Compile-time HBM footprint of the batched streaming VIDEO step —
    the executable `run_video_row` actually times (one frames_per_step
    chunk through build_streaming_sharded_batch). Fills the matrix rows'
    peak_hbm column for the cfg5 shapes, where the per-channel pipeline
    analysis (pipeline_hbm_analysis) is the wrong executable."""
    import jax

    from ..parallel.streaming_sharded import build_streaming_sharded_batch

    run = build_streaming_sharded_batch(mesh, cfg)   # already a jit
    chunk = jax.ShapeDtypeStruct(chunk_shape, jnp.float32)
    idx_a = jax.ShapeDtypeStruct(plan.idx_a.shape, jnp.int32)
    try:
        lowered = run.lower(chunk, idx_a)
    except Exception:
        return None
    return executable_hbm_bytes(lowered)


def peak_hbm_gib(image_shape: tuple, cfg, plan) -> tuple[float | None, str]:
    """(peak GiB, source) — runtime memory_stats when the backend has it,
    else the compile-time analysis, else (None, 'unavailable')."""
    try:
        stats = jax.devices()[0].memory_stats()
        if stats and "peak_bytes_in_use" in stats:
            return round(stats["peak_bytes_in_use"] / 2**30, 3), "runtime"
    except Exception:
        pass
    ma = pipeline_hbm_analysis(image_shape, cfg, plan)
    if ma is not None and ma["total"] > 0:
        return round(ma["total"] / 2**30, 3), "memory_analysis"
    return None, "unavailable"
