"""Fused Pallas affinity emitter: patch-distance GEMM + exp epilogue.

The XLA version of ops.affinity.affinity_strip runs the (p, N) distance
GEMM as one kernel and the ``exp`` (plus the bf16 store cast) as another,
so the f32 cross product makes a full device-memory round trip. Here each
(TILE_P, TILE_N) tile does

    cross = a_tile @ b_tile            (tensor cores, f32 accumulate)
    d2    = |a|^2 + |b|^2 - 2 cross    (norms recomputed in-tile)
    out   = exp(-d2)                   (f32, rounded to the store dtype)

and the tile is written exactly once, through Pallas' Triton route.

Layout: features are zero-padded to (p, dp) and (dp, n) with dp the
feature dim padded to 32 (ops.pallas_streaming.d_pad_of). Zero feature
columns are exact no-ops. Edge tiles are masked on both axes, so the
output has the exact (p, N) shape with no slicing copy.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from .pallas_streaming import (d_pad_of, interpret_mode, kernel_tile,
                               triton_params)

# Emitter tiles: of seven tilings swept on an H100 at the cfg2 strip
# (p = 5243, N = 262144, f32 math, bf16 store), (128, 128) at 4 warps was
# the fastest: 4.20 ms vs 4.35 for (64, 128), 4.66 for (128, 256) at 8
# warps and 6.36 for (64, 256) — wider rows reuse each feature column
# tile across more samples.
TILE_P = 128
TILE_N = 128


def _affinity_kernel(a_ref, b_ref, out_ref, *, p, n):
    i, j = pl.program_id(1), pl.program_id(0)
    rows = i * TILE_P + jnp.arange(TILE_P) < p
    cols = j * TILE_N + jnp.arange(TILE_N) < n
    a = pltriton.load(a_ref, mask=rows[:, None], other=0.0)
    b = pltriton.load(b_ref, mask=cols[None, :], other=0.0)
    kb = kernel_tile(a, b)
    pltriton.store(out_ref, kb.astype(out_ref.dtype),
                   mask=rows[:, None] & cols[None, :])


@functools.partial(jax.jit, static_argnames=("dtype", "store_dtype",
                                             "interpret"))
def affinity_strip_pallas(feats_a: jnp.ndarray, feats_all: jnp.ndarray,
                          dtype=jnp.float32, store_dtype=None,
                          interpret: bool | None = None):
    """K strip (p, N) = exp(-|f_Ai - f_j|^2), fused tile emitter.

    Drop-in for ops.affinity.affinity_strip at f32/bfloat16_store. In
    plain bf16 mode the norms here come from the bf16-ROUNDED features
    (in-tile recompute) where the XLA twin uses the f32 ones — the
    consistent choice for the GEMM trick's cancellation. ``dtype`` sets
    the GEMM input precision; ``store_dtype`` narrows only the EMITTED
    tile (bfloat16_store policy)."""
    if interpret is None:
        interpret = interpret_mode()
    out_dtype = np.dtype(store_dtype if store_dtype is not None
                         else jnp.float32)
    p, d = feats_a.shape
    n = feats_all.shape[0]
    dp = d_pad_of(d)
    a = jnp.zeros((p, dp), dtype).at[:, :d].set(feats_a.astype(dtype))
    bt = jnp.zeros((dp, n), dtype).at[:d].set(feats_all.astype(dtype).T)
    return pl.pallas_call(
        functools.partial(_affinity_kernel, p=p, n=n),
        grid=(pl.cdiv(n, TILE_N), pl.cdiv(p, TILE_P)),
        in_specs=[
            pl.BlockSpec((TILE_P, dp), lambda j, i: (i, 0)),
            pl.BlockSpec((dp, TILE_N), lambda j, i: (0, j)),
        ],
        out_specs=pl.BlockSpec((TILE_P, TILE_N), lambda j, i: (i, j)),
        out_shape=jax.ShapeDtypeStruct((p, n), out_dtype),
        cost_estimate=pl.CostEstimate(
            flops=2 * p * n * dp,
            bytes_accessed=(p + n) * dp * a.dtype.itemsize
            + p * n * out_dtype.itemsize,
            transcendentals=p * n,
        ),
        backend="triton",
        compiler_params=triton_params(),
        interpret=interpret,
        name="graph_affinity_emit",
    )(a, bt)
