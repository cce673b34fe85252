"""Fused Pallas streaming matvecs: kernel tiles never touch device memory.

The XLA streaming operators (ops/streaming.py) materialize each recomputed
(p, block) K tile in device memory between the exp and the consuming dot:
XLA does not fuse a dot into a dot, so a distance GEMM -> exp -> dot chain
becomes two kernels with the tile round-tripping through HBM. These
kernels fuse the chain inside one block — the flash-attention pattern for
this workload:

    matvec   out(p)   = sum_j exp(-d2(F_A, F_j)) v_j      (K v)
    rmatvec  out_j(n) = sum_i exp(-d2(F_Ai, F_j)) t_i     (K^T t)

Written for GPUs through Pallas' Triton route (``backend="triton"``);
on the CPU backend the same kernels run in interpret mode (tests).

Hopper plan. Blocks run unordered on the SMs, so neither kernel carries
state across grid steps:

* matvec: grid (p tiles, n splits). Each block keeps its (TILE_P, dp)
  sample tile in registers and loops over its share of the n axis in
  TILE_N-wide steps; the n splits write partial sums that one tiny XLA
  reduction adds. The split exists because p/TILE_P alone (64 blocks at
  p = 4096) would leave half of a 132-SM card idle.
* rmatvec: grid (n tiles,). Each block keeps its (dp, TILE_N) feature
  tile and loops over all of p in TILE_P steps — no cross-block reduction.

The distance GEMM contracts over dp = 32 (``d_pad_of``), a legal
tensor-core depth. Norms are recomputed in-tile from the (possibly
bf16-rounded) operands, so the GEMM-trick cancellation sees consistent
values; exp runs in f32 and the consuming products accumulate in f32.

Caller contract: features zero-padded to dp columns (``feature_pads``),
sample rows padded to a TILE_P multiple (``p_tiling``) and pixel columns
to a TILE_N multiple (``n_pad_for``); padded entries of the vector
operands are zero, which makes the padding an exact no-op.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

D_PAD = 128      # max supported feature width (NLM 7x7 + bilateral fits)

# Hopper tiles. A (64, 128) f32 tile is 64 registers a thread at 4 warps,
# which leaves room for the pipelined feature loads; 64 rows is also the
# tensor cores' native M. Powers of two, as Triton requires. Of eight
# tilings swept on an H100 at the cfg4 shape (p = 4096, N = 8 MP, bf16:
# tp 32-128, tn 64-256, 4-8 warps, 2-3 stages) this one is within 4% of
# the best for both kernels; wider tiles spill and lose 15-60%.
TILE_P = 64
TILE_N = 128
NUM_WARPS = 4
NUM_STAGES = 2
# matvec: aim for a few blocks per SM so the n splits balance the card
MATVEC_TARGET_BLOCKS = 1024


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def interpret_mode() -> bool:
    """How Pallas kernels run on the current backend: the CPU backend runs
    them in interpret mode (tests); a GPU compiles them through Triton.
    Any other backend has no route for these kernels and is refused."""
    backend = jax.default_backend()
    if backend == "cpu":
        return True
    if backend == "gpu":
        return False
    raise NotImplementedError(
        f"Pallas kernels here compile through Triton for GPUs or run in "
        f"interpret mode on the CPU; backend {backend!r} has neither route")


def triton_params():
    return pltriton.CompilerParams(num_warps=NUM_WARPS,
                                   num_stages=NUM_STAGES)


def d_pad_of(d: int) -> int:
    """Feature width padded to a 32 multiple: the transposed feature copy
    is the only O(N)-resident buffer the fused path adds, and 32 keeps it
    at 1.28x the NLM 5x5 data while staying a legal tensor-core depth."""
    if d > D_PAD:
        raise ValueError(f"feature dim {d} > {D_PAD}; add a k-loop")
    return max(32, _cdiv(d, 32) * 32)


def p_tiling(p: int) -> tuple[int, int]:
    """(tile, p_pad): sample rows padded to the TILE_P multiple."""
    return TILE_P, _cdiv(p, TILE_P) * TILE_P


def n_pad_for(n: int) -> int:
    """Pixel-column pad of the transposed feature layout: a TILE_N multiple
    with at least 16 tiles' granularity, so the matvec n-splits divide it
    for any image larger than a few thousand pixels."""
    q = 16 * TILE_N
    return _cdiv(n, q) * q


def feature_pads(feats_a, feats_n, n_pad_k: int, dtype):
    """((p, d), (n, d), n_pad_k) -> (fa (p_pad, dp), f_t (dp, n_pad_k)),
    zero-padded, in the tile dtype."""
    p, d = feats_a.shape
    n = feats_n.shape[0]
    dp = d_pad_of(d)
    _, p_pad = p_tiling(p)
    fa = jnp.zeros((p_pad, dp), dtype).at[:p, :d].set(feats_a.astype(dtype))
    f_t = jnp.zeros((dp, n_pad_k), dtype).at[:d, :n].set(
        feats_n.astype(dtype).T)
    return fa, f_t


def _check_pads(fa, f_t) -> int:
    """Validate the caller-built pads agree and return the width."""
    dp = fa.shape[1]
    if f_t.shape[0] != dp:
        raise ValueError(
            f"feature pads disagree: fa_pad width {dp} vs f_t height "
            f"{f_t.shape[0]} — build both with d_pad_of")
    if dp % 32 != 0 or dp > D_PAD:
        raise ValueError(f"padded feature width {dp} must be a multiple "
                         f"of 32 and <= {D_PAD} (d_pad_of)")
    if fa.shape[0] % TILE_P:
        raise ValueError(f"p_pad={fa.shape[0]} must be a multiple of "
                         f"{TILE_P} (p_tiling)")
    if f_t.shape[1] % TILE_N:
        raise ValueError(f"n_pad={f_t.shape[1]} must be a multiple of "
                         f"{TILE_N} (n_pad_for)")
    return dp


def dot_precision(dtype):
    """bf16 operands take the tensor cores' native pass; f32 operands ask
    for IEEE f32 — an unset precision lowers to TF32 inside a Triton
    kernel (the package-wide matmul-precision pin does not reach it)."""
    return (lax.Precision.DEFAULT if dtype == jnp.bfloat16
            else lax.Precision.HIGHEST)


def kernel_tile(a, b):
    """(tp, dp) x (dp, tn) feature tiles -> exp(-d2) (tp, tn) f32, norms
    recomputed from the operands as they are (rounded or not)."""
    cross = jnp.dot(a, b, preferred_element_type=jnp.float32,
                    precision=dot_precision(a.dtype))
    af = a.astype(jnp.float32)
    bf = b.astype(jnp.float32)
    na = jnp.sum(af * af, axis=1)
    nb = jnp.sum(bf * bf, axis=0)
    d2 = jnp.maximum(na[:, None] + nb[None, :] - 2.0 * cross, 0.0)
    return jnp.exp(-d2)


def _matvec_kernel(a_ref, ft_ref, v_ref, o_ref, *, tn, steps):
    s = pl.program_id(1)
    a = a_ref[...]

    def body(k, acc):
        cols = pl.ds(pl.multiple_of((s * steps + k) * tn, tn), tn)
        kb = kernel_tile(a, ft_ref[:, cols])
        return acc + jnp.sum(kb * v_ref[cols][None, :], axis=1)

    o_ref[...] = lax.fori_loop(0, steps, body,
                               jnp.zeros((a.shape[0],), jnp.float32))


def _rmatvec_kernel(a_ref, b_ref, t_ref, o_ref, *, tp, steps):
    b = b_ref[...]

    def body(k, acc):
        rows = pl.ds(pl.multiple_of(k * tp, tp), tp)
        kb = kernel_tile(a_ref[rows, :], b)
        return acc + jnp.sum(kb * t_ref[rows][:, None], axis=0)

    o_ref[...] = lax.fori_loop(0, steps, body,
                               jnp.zeros((b.shape[1],), jnp.float32))


def _matvec_splits(p_pad: int, n_tiles: int, tp: int) -> int:
    """Power-of-two n-split count: enough blocks to fill the card, and a
    divisor of the n tile count."""
    want = max(1, _cdiv(MATVEC_TARGET_BLOCKS, p_pad // tp))
    s = 1
    while s * 2 <= want and n_tiles % (s * 2) == 0:
        s *= 2
    return s


def _out_struct(shape, vma):
    if vma:
        return jax.ShapeDtypeStruct(shape, jnp.float32, vma=frozenset(vma))
    return jax.ShapeDtypeStruct(shape, jnp.float32)


@functools.partial(jax.jit, static_argnames=("interpret", "vma"))
def matvec_pallas(feats_a_pad, feats_t, v, interpret: bool | None = None,
                  vma: tuple | None = None):
    """K @ v: ((p_pad, dp), (dp, n_pad), (n_pad,)) -> (p_pad,) f32.

    ``vma``: mesh axes the output varies over — required when called
    inside a ``shard_map`` with ``check_vma=True`` (pallas_call cannot
    infer it)."""
    tp, tn = TILE_P, TILE_N
    if interpret is None:
        interpret = interpret_mode()
    p_pad = feats_a_pad.shape[0]
    n_pad = feats_t.shape[1]
    dp = _check_pads(feats_a_pad, feats_t)
    n_tiles = n_pad // tn
    splits = _matvec_splits(p_pad, n_tiles, tp)
    steps = n_tiles // splits
    dtype = feats_a_pad.dtype
    out = pl.pallas_call(
        functools.partial(_matvec_kernel, tn=tn, steps=steps),
        grid=(p_pad // tp, splits),
        in_specs=[
            pl.BlockSpec((tp, dp), lambda i, s: (i, 0)),
            pl.BlockSpec((dp, n_pad), lambda i, s: (0, 0)),
            pl.BlockSpec((n_pad,), lambda i, s: (0,)),
        ],
        out_specs=pl.BlockSpec((None, tp), lambda i, s: (s, i)),
        out_shape=_out_struct((splits, p_pad), vma),
        cost_estimate=pl.CostEstimate(
            flops=2 * p_pad * n_pad * (dp + 1),
            bytes_accessed=(p_pad + n_pad) * dp * dtype.itemsize
            + 4 * (p_pad * splits + n_pad),
            transcendentals=p_pad * n_pad,
        ),
        backend="triton",
        compiler_params=triton_params(),
        interpret=interpret,
        name="graph_matvec",
    )(feats_a_pad, feats_t, v.astype(jnp.float32))
    return jnp.sum(out, axis=0)


@functools.partial(jax.jit, static_argnames=("interpret", "vma"))
def rmatvec_pallas(feats_a_pad, feats_t, t, interpret: bool | None = None,
                   vma: tuple | None = None):
    """K^T @ t: ((p_pad, dp), (dp, n_pad), (p_pad,)) -> (n_pad,) f32.

    ``vma``: see matvec_pallas."""
    tp, tn = TILE_P, TILE_N
    if interpret is None:
        interpret = interpret_mode()
    p_pad = feats_a_pad.shape[0]
    n_pad = feats_t.shape[1]
    dp = _check_pads(feats_a_pad, feats_t)
    dtype = feats_a_pad.dtype
    return pl.pallas_call(
        functools.partial(_rmatvec_kernel, tp=tp, steps=p_pad // tp),
        grid=(n_pad // tn,),
        in_specs=[
            pl.BlockSpec((p_pad, dp), lambda j: (0, 0)),
            pl.BlockSpec((dp, tn), lambda j: (0, j)),
            pl.BlockSpec((p_pad,), lambda j: (0,)),
        ],
        out_specs=pl.BlockSpec((tn,), lambda j: (j,)),
        out_shape=_out_struct((n_pad,), vma),
        cost_estimate=pl.CostEstimate(
            flops=2 * p_pad * n_pad * (dp + 1),
            bytes_accessed=(p_pad + n_pad) * dp * dtype.itemsize
            + 4 * (p_pad + n_pad),
            transcendentals=p_pad * n_pad,
        ),
        backend="triton",
        compiler_params=triton_params(),
        interpret=interpret,
        name="graph_rmatvec",
    )(feats_a_pad, feats_t, t.astype(jnp.float32))
