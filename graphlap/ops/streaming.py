"""Blockwise streaming operators: the K strip is recomputed, never stored.

The answer to SURVEY.md §5 "long-context" row and §7 step 5 — the
ring-attention/flash-attention analogue for this workload. At 8 MP the
(p, N) strip is ~250 GB: instead, every strip product is a ``lax.scan``
over column blocks that recomputes K tiles from the (N, d) feature tensor
(O(Npd) extra FLOPs) and accumulates the product online. Peak memory drops
to O(N d + p^2).

Performance note: XLA does not fuse the consuming dot into the tile's
distance GEMM + exp, so every scan step writes its (p, block) tile to
device memory and reads it back; the fused Pallas kernels
(ops/pallas_streaming.py) keep the tile on chip — measured 3.9x faster
per bf16 sweep on an H100 at 8 MP (see PERF.md). In bf16 mode the
features are rounded to bf16 first and the norms come from the rounded
values (the kernels' numeric class), the tile STORAGE and every
consuming dot input are bf16 (the small vectors/factors entering the
dots are cast at the call site so XLA never materializes an f32 upcast of
a tile); distances, the exp and all accumulation stay f32.

Conventions:
* Features arrive permuted [A; B] and zero-padded to a multiple of the
  block size. Vectors passed in/out are full length (n_pad,); the A prefix
  and the padding are handled by the caller via masking/slicing. Column
  scale vectors must be 0 on padding (and on the A prefix when the product
  is meant to touch K_AB only) — zero columns vanish exactly from sums.
* All operators share one block kernel: K_blk = exp(-|f_Ai - f_j|^2)
  (bandwidths folded into features, ops/affinity.py).

Operators (C = virtual (p, n_pad) strip, D_r = diag(row_scale),
D_c = diag(col_scale)):

    matvec      (D_r C D_c) v          -> (p,)
    rmatvec     (D_r C D_c)^T t        -> (n_pad,)
    gram        (D_r C D_c)(D_r C D_c)^T -> (p, p)      [the one-shot cross]
    rmatmat + colstats: V^T y and column sq-norms of V in one pass
    rmat_apply  (D_r C D_c)^T G w      -> (n_pad,)       [extension apply]
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .affinity import affinity_strip


def _blocks(feats_pad: jnp.ndarray, block: int):
    n_pad, d = feats_pad.shape
    return feats_pad.reshape(n_pad // block, block, d)


def _acc(shape, vary):
    """f32 zero accumulator for a scan carry. Under shard_map with
    check_vma=True the carry must be marked varying over the mesh axes the
    scanned tiles vary over (the sharded callers pass vary=('rows',) etc.);
    plain single-device callers leave vary=() and get an ordinary zeros."""
    z = jnp.zeros(shape, jnp.float32)
    return jax.lax.pcast(z, vary, to="varying") if vary else z


def _kernel_blk(feats_a, fb, dtype):
    """(p, block) kernel tile from the features rounded to ``dtype``: the
    norms come from the same rounded values the cross GEMM multiplies (the
    Pallas kernels' class, ops/pallas_streaming.kernel_tile), so the GEMM
    trick cancels consistently; f32 distances/exp, result rounded to
    ``dtype``."""
    k = affinity_strip(feats_a.astype(dtype), fb.astype(dtype), dtype)
    return k.astype(dtype)


def _dot(a, b, dtype):
    """MXU dot with inputs in the tile dtype, f32 accumulate."""
    prec = "default" if dtype == jnp.bfloat16 else "highest"
    return jnp.dot(a.astype(dtype), b.astype(dtype),
                   preferred_element_type=jnp.float32, precision=prec)


def matvec(feats_a, feats_pad, v, row_scale, col_scale, block, dtype,
           vary=()):
    """(D_r C D_c) v, scanning column blocks."""
    fb = _blocks(feats_pad, block)
    vb = (v * col_scale).reshape(fb.shape[0], block)

    def body(acc, xs):
        f, w = xs
        kb = _kernel_blk(feats_a, f, dtype)
        return acc + _dot(kb, w, dtype), None

    acc, _ = jax.lax.scan(body, _acc(feats_a.shape[0], vary), (fb, vb))
    return acc * row_scale


def rmatvec(feats_a, feats_pad, t, row_scale, col_scale, block, dtype):
    """(D_r C D_c)^T t -> (n_pad,)."""
    fb = _blocks(feats_pad, block)
    tr = t * row_scale

    def body(_, f):
        kb = _kernel_blk(feats_a, f, dtype)
        return None, _dot(kb.T, tr, dtype)

    _, out = jax.lax.scan(body, None, fb)
    return out.reshape(-1) * col_scale


def gram(feats_a, feats_pad, row_scale, col_scale, block, dtype, vary=()):
    """(D_r C D_c)(D_r C D_c)^T -> (p, p): the O(N p^2) one-shot cross."""
    fb = _blocks(feats_pad, block)
    cs = col_scale.astype(dtype).reshape(fb.shape[0], block)

    def body(acc, xs):
        f, c = xs
        kb = _kernel_blk(feats_a, f, dtype) * c[None, :]
        return acc + _dot(kb, kb.T, dtype), None

    p = feats_a.shape[0]
    acc, _ = jax.lax.scan(body, _acc((p, p), vary), (fb, cs))
    return acc * (row_scale[:, None] * row_scale[None, :])


def rmatmat_colstats(feats_a, feats_pad, g, y, row_scale, col_scale, block,
                     dtype, vary=()):
    """One pass over V_blk = (D_c C^T D_r) G (n_pad, m), returning
    (column sq-norms (m,), V^T y (m,)) without materializing V."""
    fb = _blocks(feats_pad, block)
    cs = col_scale.astype(dtype).reshape(fb.shape[0], block)
    yb = y.reshape(fb.shape[0], block)
    gr = g * row_scale[:, None]                    # fold row scale into G

    def body(carry, xs):
        norms, coeffs = carry
        f, c, yv = xs
        kb = _kernel_blk(feats_a, f, dtype) * c[:, None].T  # (p, blk)
        vb = _dot(kb.T, gr, dtype)                          # (blk, m) f32
        return (norms + jnp.sum(vb * vb, axis=0),
                coeffs + vb.T @ yv), None

    m = g.shape[1]
    carry0 = (_acc(m, vary), _acc(m, vary))
    (norms, coeffs), _ = jax.lax.scan(body, carry0, (fb, cs, yb))
    return norms, coeffs


def rmatmat_colstats_v(feats_a, feats_pad, g, y, row_scale, col_scale,
                       block, dtype, vary=()):
    """rmatmat_colstats that ALSO emits V (n_pad, m) f32 — the pass
    already computes every V block, so writing it out costs one O(Nm)
    store, and the later filter apply becomes a single skinny GEMM on V
    instead of a full kernel-recompute pass. Only used when the O(Nm)
    buffer comfortably fits device memory (caller gates)."""
    fb = _blocks(feats_pad, block)
    cs = col_scale.astype(dtype).reshape(fb.shape[0], block)
    yb = y.reshape(fb.shape[0], block)
    gr = g * row_scale[:, None]

    def body(carry, xs):
        norms, coeffs = carry
        f, c, yv = xs
        kb = _kernel_blk(feats_a, f, dtype) * c[:, None].T
        vb = _dot(kb.T, gr, dtype)                          # (blk, m) f32
        return (norms + jnp.sum(vb * vb, axis=0),
                coeffs + vb.T @ yv), vb

    m = g.shape[1]
    carry0 = (_acc(m, vary), _acc(m, vary))
    (norms, coeffs), v = jax.lax.scan(body, carry0, (fb, cs, yb))
    return norms, coeffs, v.reshape(-1, m)


def rmatmat(feats_a, feats_pad, g, row_scale, col_scale, block, dtype):
    """(D_c C^T D_r) G -> (n_pad, m), MATERIALIZED blockwise.

    Only used when the caller explicitly wants the (N, m) eigenbasis in HBM
    (checkpoint/-save_basis path) — the filter itself never materializes V
    (rmat_apply / rmatmat_colstats above). O(N m) output; fine even at 8 MP
    (m=50 -> 1.6 GB f32), unlike the O(N p) strip."""
    fb = _blocks(feats_pad, block)
    cs = col_scale.astype(dtype).reshape(fb.shape[0], block)
    gr = g * row_scale[:, None]

    def body(_, xs):
        f, c = xs
        kb = _kernel_blk(feats_a, f, dtype) * c[:, None].T
        return None, _dot(kb.T, gr, dtype)

    _, out = jax.lax.scan(body, None, (fb, cs))
    return out.reshape(-1, g.shape[1])


def sinkhorn_coarse_step(feats_a, feats_c, t, mask_c, ratio, block, dtype,
                         vary=()):
    """One coarse Sinkhorn contraction: u = ratio * K_c @ (mask_c / (K_c^T t)).

    The Sinkhorn fixed point only touches the B columns through the p-vector
    u = K_AB s_B, and s_B itself is 1/(K_BA t) — so the whole iteration can
    run against a DECIMATED column subset (PAPERS.md: massively scalable
    Sinkhorn via Nystrom): each fused block computes the kernel tile once,
    forms the implicit s at the coarse columns, and contracts back to p.
    ``ratio`` rescales the decimated sum to estimate the full-column sum.
    """
    fb = _blocks(feats_c, block)
    mb = mask_c.reshape(fb.shape[0], block)
    tt = t

    def body(acc, xs):
        f, mk = xs
        kb = _kernel_blk(feats_a, f, dtype)               # (p, blk)
        y = _dot(kb.T, tt, dtype)                         # K_c^T t  (blk,)
        r = mk / jnp.maximum(y, 1e-30)                    # coarse s_B
        return acc + _dot(kb, r, dtype), None

    acc, _ = jax.lax.scan(body, _acc(feats_a.shape[0], vary), (fb, mb))
    return acc * ratio


def rmatvec2(feats_a, feats_pad, t2, col_scale, block, dtype):
    """K^T [t1 t2] -> (n_pad, 2) in ONE pass (shared kernel tiles): the
    final full-resolution Sinkhorn extension needs K_BA t for two vectors."""
    fb = _blocks(feats_pad, block)

    def body(_, f):
        kb = _kernel_blk(feats_a, f, dtype)
        return None, _dot(kb.T, t2, dtype)                # (blk, 2)

    _, out = jax.lax.scan(body, None, fb)
    return out.reshape(-1, 2) * col_scale[:, None]


def rmat_apply(feats_a, feats_pad, g, w, row_scale, col_scale, block, dtype):
    """(D_r C D_c)^T (G w) -> (n_pad,): the streaming extension apply."""
    gw = (g @ w) * row_scale                       # (p,)

    def body(_, xs):
        f, c = xs
        kb = _kernel_blk(feats_a, f, dtype)
        return None, _dot(kb.T, gw, dtype) * c

    fb = _blocks(feats_pad, block)
    cs = col_scale.reshape(fb.shape[0], block)
    _, out = jax.lax.scan(body, None, (fb, cs))
    return out.reshape(-1)
