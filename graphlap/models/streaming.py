"""Streaming (recompute) pipeline: big images without the (p, N) strip.

The equivalent of how the reference would have to page K_AB through
cluster memory at scale — redesigned for device-memory economics
(SURVEY.md §5 long-context row, §7 step 5): every strip product recomputes
K tiles from the (N, d) features (ops/streaming.py scans, or the fused
Pallas kernels of ops/pallas_streaming.py), trading O(Npd) recompute FLOPs
for O(Np) memory traffic — the profitable direction whenever d << p.
Peak memory: O(N d + p^2 + N) — an 8 MP NLM image needs ~1 GB instead of
~250 GB.

Produces the same math as models/pipeline.py (same eigensolve on the same
scaled blocks); tests assert allclose between the two paths.

Permutation-free: unlike the dense path, pixels stay in NATURAL order.
The [A; B] reordering the reference uses is only bookkeeping, and an N-row
random gather is pure memory traffic at 8 MP. Here the only index ops are
p-sized: gather the sample rows, scatter the p-sized results back —
everything N-sized is a contiguous mask.

CROSS-MODULE CONTRACT: because nothing here reads
perm/inv_perm, models/pipeline.py passes ``idx_a`` (shape (p,)) in their
place so the N-sized permutations are never staged to the device. Any
future streaming entry point that wants a real permutation must take it
as a NEW parameter — do not start reading the perm/inv_perm slots, they
carry p-sized aliases at every existing call site.
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import PipelineConfig
from ..ops import streaming as st
from ..ops.affinity import affinity_strip, extract_features_padded
from ..ops.filters import FILTER_REGISTRY
from ..ops.linalg import psd_pinv_sqrt, trunc_inv_sqrt_vals
from ..ops.nystrom import _LIVE_NORM2, nystrom_chol_factor
from ..ops.sinkhorn import _make_kaa_solve
from ..utils.meminfo import DENSE_STRIP_FRACTION, V_FRACTION, memory_budget

_EPS = 1e-30


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


# strided decimation is alias-limited but measured BEST at shallow k
# (0.007-0.053 dB at gc8, 8 MP, seed-swept); jitter has a flat ~0.05-0.065
# dB noise floor independent of k, so it loses at k<=8 and wins decisively
# past the alias collapse (strided gc16: 0.096-0.107 dB; jittered gc16/32:
# <=0.066 dB). Crossover at 16.
GRAM_JITTER_MIN = 16


def gram_sample_idx(n_pad: int, k: int, seed: int = 0) -> np.ndarray:
    """Static column-sample indices for the coarse gram (one per k-slot).

    k < 16: plain stride (best measured parity at shallow decimation).
    k >= 16: JITTERED — slot i picks one uniform column in [i*k, (i+1)*k).
    A stride aliases with the raster (when the image width divides k, it
    samples only the vertical stripes x ≡ 0 mod k and misses everything
    between them — measured ~10x worse top-m eigenvalue error at k=16,
    max relerr 0.30 vs 0.026 at 512², seed-swept) while the jittered
    sample's error stays flat through k=32 on the real 8 MP benchmark.
    Offsets are a seeded draw
    (cfg.gram_jitter_seed, default 0) so the plan is deterministic and
    compile-time static; indices land in the zero padding at worst, where
    the column scales are zero too (exact no-op). Low-discrepancy and
    antithetic offset schemes measured indistinguishable from plain
    random; across 5 JITTER-SEED draws at 8 MP parity stays flat
    (0.011-0.068 dB).
    """
    slots = np.arange(0, n_pad, k)[: n_pad // k]
    if k < GRAM_JITTER_MIN:
        return slots.astype(np.int32)
    off = np.random.default_rng(seed).integers(0, k, n_pad // k)
    return (slots + off).astype(np.int32)


def sinkhorn_sample_idx(n_pad: int, k: int, w: int,
                        mode: str = "diag") -> np.ndarray:
    """Static column sample for the coarse Sinkhorn (one per k-slot):
    stride with a DIAGONAL per-image-row offset, (q * row) mod k.

    The streaming paths run in natural pixel order, where a plain ::k
    stride samples the vertical stripes x ≡ 0 (mod k) of every image row
    and misses the columns between them — the same raster alias the gram
    sampler hit, and measured up to 0.094 dB of fixed-point bias at cfg2
    (noise seed 3). Rotating the offset by a
    k-coprime step per image row keeps the sample exactly one-per-slot
    and deterministic (compile-time static, like the gram sample) while
    covering every column phase within q rows: the same seed-3 instance
    measures 0.0051 dB — the full-resolution fixed point's own 0.0041.
    A RANDOM jitter is NOT safe here: the alternating fixed point is
    sensitive to sample clumping (0.104 dB on one 8 MP instance); the
    diagonal is
    exactly anti-clumped. The dense path's coarse sampler keeps its plain
    stride: it strides PERMUTED [A; B] columns, which are already
    raster-decorrelated (ops/sinkhorn.sinkhorn_scaling_coarse).

    The win does NOT transfer to the RECOMPUTE streaming path: the same
    diagonal measures a consistent 0.064-0.077 dB at cfg4 (8 MP, k=64)
    where the plain stride holds 0.0007-0.0063 across the same 4 seeds
    — so ``mode`` is caller-selected and
    cfg.resolved_sinkhorn_sample() ("auto") routes diag iff strip_cache,
    exactly the measured split."""
    slots = np.arange(0, n_pad, k)[: n_pad // k]
    if mode == "stride":
        return slots.astype(np.int32)
    q = 7 if k % 7 else 5
    off = (q * (slots // w)) % k
    return (slots + off).astype(np.int32)


class StreamFactor(NamedTuple):
    """Everything the streaming eigensolve produces, pre-filter: the p-sized
    factor (V = [scaled extension] @ basis0), column scales, and the V^T y
    coefficients. Shared by the filter path and the basis/checkpoint path."""

    vals: jnp.ndarray        # (m,) eigenvalues, descending
    basis0: jnp.ndarray      # (p, m) chol/one-shot factor
    v_a: jnp.ndarray         # (p, m) A-rows of V (pre column-rescale)
    scale: jnp.ndarray       # (m,) unit-norm column rescale (0 = dead col)
    coeffs: jnp.ndarray      # (m,) scale * V^T y
    s_a: jnp.ndarray         # (p,) Sinkhorn scale at samples
    s_b_cols: jnp.ndarray    # (n_pad,) column scales (0 on A cols + padding)
    feats_a: jnp.ndarray     # (p, d)
    feats_pad: jnp.ndarray   # (n_pad, d)
    y_pad: jnp.ndarray       # (n_pad,) input pixels, zero-padded
    v_b: jnp.ndarray | None  # (n_pad, m) pre-rescale V, materialized by the
                             # colstats pass when O(Nm) fits HBM (the apply
                             # then skips a full kernel-recompute pass);
                             # None above v_bytes_cap()
    n: int                   # true pixel count (static)
    block: int               # column-block width (static)


def v_bytes_cap() -> float:
    """Materialize V (n_pad, m) f32 when it stays under this budget (1.7 GB
    at 8 MP / m=50; the strip-free pipeline itself uses ~2 GB)."""
    return memory_budget(V_FRACTION)


def _strip_dot(strip: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """strip @ x with the strip's own precision policy: a bf16-STORED
    strip runs native bf16 GEMM passes (f32 accumulate — the same numeric
    class as the dense path's bfloat16_store consumers); f32 strips keep
    the package-wide HIGHEST contract."""
    if strip.dtype == jnp.bfloat16:
        return jnp.dot(strip, x.astype(jnp.bfloat16),
                       preferred_element_type=jnp.float32,
                       precision="default")
    return jnp.dot(strip, x.astype(jnp.float32),
                   preferred_element_type=jnp.float32, precision="highest")


def _strip_dot_t(strip: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """strip.T @ x (dot_general — no transposed copy materializes)."""
    if strip.dtype == jnp.bfloat16:
        return jnp.dot(strip.T, x.astype(jnp.bfloat16),
                       preferred_element_type=jnp.float32,
                       precision="default")
    return jnp.dot(strip.T, x.astype(jnp.float32),
                   preferred_element_type=jnp.float32, precision="highest")


class _StripCtx(NamedTuple):
    """Trace-time context shared by the normalization and eigensolve halves
    of the streaming factor: features, masks, the exact (p, p) block, and
    the strip-product closures (Pallas or XLA-scan). Built by _strip_ctx at
    Python level — cheap to rebuild per jit (the setup ops are O(Nd) pads
    the compiler fuses), which is what lets the staged benchmarking path
    wall-clock normalize/eigensolve separately without duplicating any of
    the factor logic."""

    n: int
    p: int
    n_pad: int
    block: int
    w: int                         # image width (raster period — the
                                   # coarse-sample diagonal needs it)
    dtype: object
    idx_a: jnp.ndarray
    feats_a: jnp.ndarray
    feats_pad: jnp.ndarray
    valid: jnp.ndarray
    b_mask: jnp.ndarray
    ones_p: jnp.ndarray
    kaa: jnp.ndarray
    kaa_solve: object
    strip_matvec: object
    strip_rmatvec: object
    ktilde_apply: object
    strip: jnp.ndarray | None      # cfg.strip_cache: the materialized
                                   # (p, n_pad) strip, natural order,
                                   # padding columns exactly zero


def _strip_ctx(img2d: jnp.ndarray, idx_a: jnp.ndarray,
               cfg: PipelineConfig, bandwidth=None) -> _StripCtx:
    h, w = img2d.shape
    n = h * w
    p = idx_a.shape[0]
    dtype = jnp.bfloat16 if cfg.affinity_dtype == "bfloat16" else jnp.float32
    block = min(cfg.block_cols, _cdiv(n, 1))
    n_pad = _cdiv(n, block) * block

    # ``bandwidth``: optional TRACED h override (tune.py SURE sweeps run a
    # whole h-grid through one compiled executable — see extract_features)
    # NATURAL pixel order; chunked write straight into the padded buffer
    # (one resident O(N d) copy instead of unfold + cast + pad — the
    # 64 MP OOM fix, ops/affinity.extract_features_padded)
    feats_pad = extract_features_padded(img2d, cfg, n_pad, h=bandwidth)
    feats_a = jnp.take(feats_pad, idx_a, axis=0)      # p-row gather only

    idx = jnp.arange(n_pad)
    valid = (idx < n).astype(jnp.float32)
    a_mask = jnp.zeros(n_pad, jnp.float32).at[idx_a].set(1.0)
    b_mask = valid * (1.0 - a_mask)                   # 1 on B columns only
    ones_p = jnp.ones(p, jnp.float32)

    kaa = affinity_strip(feats_a, feats_a, dtype)     # exact (p, p)
    kaa_solve = _make_kaa_solve(kaa, cfg.eig_tol, cfg.solver)

    strip = None
    if cfg.strip_cache:
        # dense-capacity mode: materialize the (p, n_pad) strip ONCE in
        # NATURAL order (no [A; B] feature permute — the classic dense
        # path's N-row gather) and serve every strip product as a GEMM against it. Same masks
        # and estimators as the recompute path; only the tile source
        # changes. bf16 modes STORE the strip bf16 (the bandwidth lever);
        # bfloat16_store keeps f32 distances/exp like the dense path.
        itemsize = 2 if cfg.affinity_dtype in ("bfloat16",
                                               "bfloat16_store") else 4
        limit = memory_budget(DENSE_STRIP_FRACTION)
        if p * n_pad * itemsize > limit:
            raise ValueError(
                f"strip_cache strip would be {p * n_pad * itemsize / 1e9:.1f}"
                f" GB (p={p}, n_pad={n_pad}) — past the single-device "
                f"bound of {limit / 1e9:.1f} GB; use the recompute "
                f"streaming path (strip_cache=False)")
        store = (jnp.bfloat16 if cfg.affinity_dtype in
                 ("bfloat16", "bfloat16_store") else None)
        # poison the padding FEATURE rows (not a post-emit mask pass):
        # d2 >= (1e3 - |f|)^2 >> 88 there, so exp underflows to exactly 0
        # and the padded strip columns vanish from every product for free
        feats_strip = (feats_pad if n_pad == n
                       else feats_pad.at[n:].set(1e3))
        if cfg.use_pallas:
            # Pallas emitter: the XLA emit materializes the f32
            # distance-GEMM output before the exp and the bf16 cast
            from ..ops.pallas_affinity import affinity_strip_pallas
            strip = affinity_strip_pallas(feats_a, feats_strip,
                                          dtype=dtype, store_dtype=store)
        else:
            strip = affinity_strip(feats_a, feats_strip, dtype,
                                   store_dtype=store)

        def strip_matvec(v_scaled):
            return _strip_dot(strip, v_scaled)

        def strip_rmatvec(t_scaled):
            return _strip_dot_t(strip, t_scaled)
    elif cfg.use_pallas:
        # fused Pallas matvecs: K tiles never reach device memory; the
        # padded transposed features are built once and reused by every
        # pass (pad widths are the kernels' own, ops/pallas_streaming)
        from ..ops import pallas_streaming as pst
        _, p_pad = pst.p_tiling(p)
        n_pad_k = pst.n_pad_for(n_pad)
        fa_pad, f_t = pst.feature_pads(feats_a, feats_pad, n_pad_k, dtype)

        def strip_matvec(v_scaled):
            vv = jnp.zeros(n_pad_k, jnp.float32).at[:n_pad].set(v_scaled)
            return pst.matvec_pallas(fa_pad, f_t, vv)[:p]

        def strip_rmatvec(t_scaled):
            tt = jnp.zeros(p_pad, jnp.float32).at[:p].set(t_scaled)
            return pst.rmatvec_pallas(fa_pad, f_t, tt)[:n_pad]
    else:
        def strip_matvec(v_scaled):
            return st.matvec(feats_a, feats_pad, v_scaled, ones_p,
                             jnp.ones_like(v_scaled), block, dtype)

        def strip_rmatvec(t_scaled):
            return st.rmatvec(feats_a, feats_pad, t_scaled, ones_p,
                              jnp.ones_like(feats_pad[:, 0]), block, dtype)

    def ktilde_apply(s):
        """K~ s in natural order via streaming strip products."""
        s_a = jnp.take(s, idx_a)                      # p gather
        u = strip_matvec(s * b_mask)
        top = kaa @ s_a + u
        t = s_a + kaa_solve(u)
        bottom = strip_rmatvec(t) * b_mask
        return bottom.at[idx_a].set(top)              # p scatter

    return _StripCtx(n=n, p=p, n_pad=n_pad, block=block, w=w, dtype=dtype,
                     idx_a=idx_a, feats_a=feats_a, feats_pad=feats_pad,
                     valid=valid, b_mask=b_mask, ones_p=ones_p, kaa=kaa,
                     kaa_solve=kaa_solve, strip_matvec=strip_matvec,
                     strip_rmatvec=strip_rmatvec, ktilde_apply=ktilde_apply,
                     strip=strip)


def _coarse_sinkhorn_state(ctx: _StripCtx, cfg: PipelineConfig):
    """Decimated alternating Sinkhorn fixed point, iterated entirely
    through p-sized state against every k-th column (ops/streaming.py
    sinkhorn_coarse_step) — everything BEFORE the full-resolution
    extension. Returns (s_a_coarse (p,), t_r (p,), t_c (p,)): the A
    scales and the two extension vectors the full-res passes consume.
    Shared by the unfused path (_normalize_streaming) and the fused
    finish (_factor_streaming_fused)."""
    feats_a, feats_pad = ctx.feats_a, ctx.feats_pad
    p, block, dtype = ctx.p, ctx.block, ctx.dtype
    b_mask, ones_p = ctx.b_mask, ctx.ones_p
    kaa, kaa_solve = ctx.kaa, ctx.kaa_solve

    k = cfg.sinkhorn_coarse
    if block % k != 0:
        raise ValueError(
            f"sinkhorn_coarse={k} must divide the active "
            f"block width min(block_cols, N)={block}")
    # KEEP IN SYNC with ops/sinkhorn.sinkhorn_scaling_coarse — the
    # same alternating fixed point against the materialized strip
    # (deliberate twin, not shared code: this one runs through
    # streaming closures; a fix to either body applies to both).
    # Sample: DIAGONAL-offset stride (sinkhorn_sample_idx) — one column
    # per k-slot like a plain stride (the anti-clumping a RANDOM jitter
    # loses: 0.104 dB on one 8 MP instance, jitsc_* rows), but rotated
    # per image row to kill the natural-order raster alias (0.094 ->
    # 0.0051 dB on the worst cfg2 seed; the dense path's permuted-order
    # stride never had the alias and keeps its plain ::k).
    jidx = jnp.asarray(sinkhorn_sample_idx(ctx.n_pad, k, ctx.w,
                                           cfg.resolved_sinkhorn_sample()))
    mask_c = jnp.take(b_mask, jidx)
    block_c = block // k
    ratio = jnp.sum(b_mask) / jnp.maximum(jnp.sum(mask_c), 1.0)

    if ctx.strip is not None:
        # strip_cache: one (p, n_pad/k) gather of the materialized strip,
        # reused by every iteration's two dots
        strip_c = jnp.take(ctx.strip, jidx, axis=1)
        u0 = ratio * _strip_dot(strip_c, mask_c)

        def coarse_step(t):
            y = _strip_dot_t(strip_c, t)
            return ratio * _strip_dot(strip_c,
                                      mask_c / jnp.maximum(y, _EPS))
    else:
        feats_c = jnp.take(feats_pad, jidx, axis=0)
        u0 = ratio * st.matvec(feats_a, feats_c, mask_c, ones_p,
                               jnp.ones_like(mask_c), block_c, dtype)

        def coarse_step(t):
            return st.sinkhorn_coarse_step(feats_a, feats_c, t, mask_c,
                                           ratio, block_c, dtype)

    r0 = jnp.ones(p, jnp.float32)

    def body(_, carry):
        r_a, u_r, *_ = carry
        c_a = 1.0 / jnp.maximum(kaa @ r_a + u_r, _EPS)
        t_r = r_a + kaa_solve(u_r)
        u_c = coarse_step(t_r)
        r_a2 = 1.0 / jnp.maximum(kaa @ c_a + u_c, _EPS)
        t_c = c_a + kaa_solve(u_c)
        u_r2 = coarse_step(t_c)
        return (r_a2, u_r2, c_a, t_r, t_c)

    zero_p = jnp.zeros(p, jnp.float32)
    r_a, u_r, c_a, t_r, t_c = jax.lax.fori_loop(
        0, cfg.sinkhorn_iters, body, (r0, u0, r0, zero_p, zero_p))
    s_a_coarse = jnp.sqrt(jnp.maximum(r_a * c_a, 0.0))
    return s_a_coarse, t_r, t_c


def _normalize_streaming(ctx: _StripCtx, cfg: PipelineConfig) -> jnp.ndarray:
    """Streaming Sinkhorn / symmetric normalization -> column scales s
    (n_pad,), zero on padding."""
    idx_a, feats_a, feats_pad = ctx.idx_a, ctx.feats_a, ctx.feats_pad
    block, dtype = ctx.block, ctx.dtype
    valid, b_mask = ctx.valid, ctx.b_mask
    ktilde_apply = ctx.ktilde_apply
    n_pad = ctx.n_pad

    if cfg.normalization == "sinkhorn" and cfg.sinkhorn_coarse > 1:
        s_a_coarse, t_r, t_c = _coarse_sinkhorn_state(ctx, cfg)
        t2 = jnp.stack([t_r, t_c], axis=1)
        if ctx.strip is not None:
            kbt = _strip_dot_t(ctx.strip, t2) * b_mask[:, None]
        else:
            kbt = st.rmatvec2(feats_a, feats_pad, t2, b_mask, block, dtype)
        prod = jnp.maximum(kbt[:, 0] * kbt[:, 1], _EPS)
        s = (b_mask / jnp.sqrt(prod))
        s = s.at[idx_a].set(s_a_coarse)
        if cfg.sinkhorn_polish > 0:
            # full-resolution polish: contracts the decimation bias toward
            # the exact fixed point (config.py sinkhorn_polish note).
            # Unfused: one kernel recompute per consumer (a shared kb
            # tile with two consumers gets materialized by XLA).
            def pbody(_, sp):
                ks = jnp.maximum(ktilde_apply(sp), _EPS)
                return jnp.sqrt(sp / ks) * valid
            s = jax.lax.fori_loop(0, cfg.sinkhorn_polish, pbody, s * valid)
    elif cfg.normalization == "sinkhorn":
        def body(_, s):
            ks = jnp.maximum(ktilde_apply(s), _EPS)
            return jnp.sqrt(s / ks) * valid
        s = jax.lax.fori_loop(0, cfg.sinkhorn_iters, body,
                              jnp.ones(n_pad, jnp.float32) * valid)
    elif cfg.normalization == "symmetric":
        ks = jnp.maximum(ktilde_apply(valid), _EPS)
        s = jax.lax.rsqrt(ks) * valid
    else:
        s = valid
    return s


def _stream_cross(ctx: _StripCtx, cfg: PipelineConfig, s_a: jnp.ndarray,
                  s_b_cols: jnp.ndarray) -> jnp.ndarray:
    """The (p, p) cross (D C D)(D C D)^T from the streaming strip — full
    or decimated-column estimate (gram_coarse).

    The decimated estimator is G ~= (sum c^2 / sum_S c^2) *
    sum_S (c_j k_j)(c_j k_j)^T over the gram sample columns S."""
    feats_a, feats_pad = ctx.feats_a, ctx.feats_pad
    n_pad, block, dtype = ctx.n_pad, ctx.block, ctx.dtype

    def stream_gram(cols, blk, jidx):
        """sum_j (c_j k_j)(c_j k_j)^T over the columns in ``jidx`` (None =
        all): GEMMs against the cached strip, else the XLA scan (whose
        p x block GEMMs go to the vendor BLAS)."""
        if ctx.strip is not None:
            sp = (jnp.take(ctx.strip, jidx, axis=1) if jidx is not None
                  else ctx.strip)
            ws = (sp.astype(jnp.float32) * cols[None, :]).astype(sp.dtype)
            prec = "default" if sp.dtype == jnp.bfloat16 else "highest"
            g = jnp.dot(ws, ws.T, preferred_element_type=jnp.float32,
                        precision=prec)
            return g * (s_a[:, None] * s_a[None, :])
        fp = (jnp.take(feats_pad, jidx, axis=0) if jidx is not None
              else feats_pad)
        return st.gram(feats_a, fp, s_a, cols, blk, dtype)

    if cfg.gram_coarse > 1:
        # decimated-column estimate of the O(Np^2) cross (the
        # full-resolution cost king): G ~= ratio * sum_{j in S} (c_j k_j)(...)^T
        # with the energy ratio sum c^2 / sum_S c^2 — exact for spatially
        # smooth column mass, and kernel columns of adjacent pixels are
        # near-duplicates. Full-resolution colstats keeps the column
        # norms / coefficients exact; only the p x p spectrum is estimated.
        kg = cfg.gram_coarse
        if block % kg != 0:
            raise ValueError(
            f"gram_coarse={kg} must divide the active block "
            f"width min(block_cols, N)={block}")
        jidx = jnp.asarray(gram_sample_idx(n_pad, kg, cfg.gram_jitter_seed))
        pre_g = jnp.take(s_b_cols, jidx)
        ratio_g = (jnp.sum(s_b_cols * s_b_cols)
                   / jnp.maximum(jnp.sum(pre_g * pre_g), _EPS))
        return ratio_g * stream_gram(pre_g, block // kg, jidx)
    return stream_gram(s_b_cols, block, None)


def _solve_pxp(cfg: PipelineConfig, waa: jnp.ndarray, cross: jnp.ndarray):
    """The p x p Nystrom factor solve -> (vals_m (m,), basis0 (p, m))."""
    m = cfg.num_eigvecs
    if cfg.solver in ("chol", "lobpcg"):
        method = "lobpcg" if cfg.solver == "lobpcg" else "eigh"
        return nystrom_chol_factor(waa, cross, m, cfg.eig_tol,
                                   method, cfg.lobpcg_iters)
    whalf = psd_pinv_sqrt(waa, cfg.eig_tol)
    s_mat = waa + whalf @ cross @ whalf
    s_mat = 0.5 * (s_mat + s_mat.T)
    vals, vecs = jnp.linalg.eigh(s_mat)
    vals_m = vals[::-1][:m]
    basis0 = whalf @ (vecs[:, ::-1][:, :m]
                      * trunc_inv_sqrt_vals(vals_m, cfg.eig_tol)[None, :])
    return vals_m, basis0


def _eigensolve_streaming(img2d: jnp.ndarray, ctx: _StripCtx, s: jnp.ndarray,
                          cfg: PipelineConfig) -> StreamFactor:
    """Nystrom eigensolve (streaming cross) + colstats from the scales."""
    idx_a, feats_a, feats_pad = ctx.idx_a, ctx.feats_a, ctx.feats_pad
    n, p, n_pad, block, dtype = ctx.n, ctx.p, ctx.n_pad, ctx.block, ctx.dtype
    b_mask, kaa = ctx.b_mask, ctx.kaa

    s_a = jnp.take(s, idx_a)
    s_b_cols = s * b_mask                             # 0 on A columns + pads

    waa = kaa * (s_a[:, None] * s_a[None, :])
    m = cfg.num_eigvecs
    if cfg.solver == "sketch" and ctx.strip is not None:
        # strip_cache enables the dense path's randomized-sketch solver on
        # the streaming entry points: thin (p, k) passes against the
        # materialized strip — never the O(p^2 N) cross (the profiled
        # cost king). The Sinkhorn scales fold into the thin passes (the
        # sandwich closure) instead of materializing a scaled strip copy:
        # a full O(pN) write+read round trip for zero numeric benefit
        # (rounding lands on the thin operands either way). Padding/A columns carry zero scale,
        # so they vanish from the sandwich exactly.
        from ..ops.nystrom import nystrom_sketch_factor
        s_b2 = s_b_cols * s_b_cols

        def sandwich(t):
            u = _strip_dot_t(ctx.strip, t * s_a[:, None]) * s_b2[:, None]
            return _strip_dot(ctx.strip, u) * s_a[:, None]

        vals_m, basis0 = nystrom_sketch_factor(
            waa, None, m, cfg.eig_tol, cfg.sketch_oversample,
            cfg.sketch_power, sandwich=sandwich)
    else:
        cross = _stream_cross(ctx, cfg, s_a, s_b_cols)
        vals_m, basis0 = _solve_pxp(cfg, waa, cross)

    v_a = waa @ basis0                                # (p, m)
    y = img2d.astype(jnp.float32).ravel()
    y_pad = jnp.zeros(n_pad, jnp.float32).at[:n].set(y)
    y_a = jnp.take(y_pad, idx_a)

    if ctx.strip is not None:
        # strip-backed colstats: ONE thin GEMM materializes V (the strip
        # already bounds N, so the O(Nm) buffer always fits)
        v_b = _strip_dot_t(ctx.strip, basis0 * s_a[:, None]) \
            * s_b_cols[:, None]
        norms_b = jnp.sum(v_b * v_b, axis=0)
        coeffs_b = v_b.T @ y_pad
    elif n_pad * m * 4 <= v_bytes_cap():
        # the XLA scan on both paths: its m-wide consumer is a real GEMM
        norms_b, coeffs_b, v_b = st.rmatmat_colstats_v(
            feats_a, feats_pad, basis0, y_pad, s_a, s_b_cols, block, dtype)
    else:
        norms_b, coeffs_b = st.rmatmat_colstats(
            feats_a, feats_pad, basis0, y_pad, s_a, s_b_cols, block, dtype)
        v_b = None
    dnorm = jnp.sum(v_a * v_a, axis=0) + norms_b
    live = dnorm > _LIVE_NORM2
    scale = jnp.where(live, 1.0 / jnp.sqrt(jnp.where(live, dnorm, 1.0)), 0.0)

    coeffs = scale * (v_a.T @ y_a + coeffs_b)         # vecs^T y, (m,)
    return StreamFactor(vals=vals_m, basis0=basis0, v_a=v_a, scale=scale,
                        coeffs=coeffs, s_a=s_a, s_b_cols=s_b_cols,
                        feats_a=feats_a, feats_pad=feats_pad, y_pad=y_pad,
                        v_b=v_b, n=n, block=block)


def _factor_streaming(img2d: jnp.ndarray, idx_a: jnp.ndarray,
                      cfg: PipelineConfig) -> StreamFactor:
    """Affinity -> normalization -> Nystrom eigensolve, strip-free."""
    ctx = _strip_ctx(img2d, idx_a, cfg)
    s = _normalize_streaming(ctx, cfg)
    return _eigensolve_streaming(img2d, ctx, s, cfg)


def _apply_factor(fac: StreamFactor, idx_a: jnp.ndarray,
                  cfg: PipelineConfig, h: int, w: int):
    """Spectral filter applied through the factor (no N x m array unless
    the colstats pass already materialized fac.v_b). Returns (z2d, vals)."""
    dtype = jnp.bfloat16 if cfg.affinity_dtype == "bfloat16" else jnp.float32
    filt = FILTER_REGISTRY[cfg.filter_name]
    fvals = filt.fn(fac.vals, cfg.filter_param)
    g = (fvals - 1.0) if filt.affine else fvals
    wvec = fac.scale * g * fac.coeffs                 # (m,)

    z_a = fac.v_a @ wvec
    if fac.v_b is not None:
        z_full = fac.v_b @ wvec                       # one skinny GEMM
    else:
        z_full = st.rmat_apply(fac.feats_a, fac.feats_pad, fac.basis0, wvec,
                               fac.s_a, fac.s_b_cols, fac.block, dtype)
    z_full = z_full.at[idx_a].set(z_a)                # p scatter
    if filt.affine:
        z_full = z_full + fac.y_pad
    z = z_full[:fac.n].reshape(h, w)                  # natural order: no
    return jnp.clip(z, 0.0, 1.0), fac.vals            # un-permute gather


def _apply_matvec_streaming(img2d: jnp.ndarray, ctx: _StripCtx,
                            s: jnp.ndarray, cfg: PipelineConfig,
                            h: int, w: int):
    """Exact polynomial filter f(W) y by streaming strip matvecs
    (cfg.filter_mode="matvec"): W x = s * K~(s * x) through ktilde_apply —
    the same completion matvec Sinkhorn iterates on. No gram, no
    eigensolve, no rank-m truncation (ops/filters.py MATVEC_FILTERS note).
    Returns (z2d, empty eigvals)."""
    from ..ops.filters import apply_operator_filter

    n, n_pad = ctx.n, ctx.n_pad
    y_pad = jnp.zeros(n_pad, jnp.float32).at[:n].set(
        img2d.astype(jnp.float32).ravel())

    def wapply(x):
        return s * ctx.ktilde_apply(s * x)

    z_full = apply_operator_filter(wapply, y_pad, cfg.filter_name,
                                   cfg.filter_param, cfg.filter_mode,
                                   cfg.cheb_degree)
    z = jnp.clip(z_full[:n].reshape(h, w), 0.0, 1.0)
    return z, jnp.zeros((0,), jnp.float32)


@partial(jax.jit, static_argnames=("cfg",))
def filter_channel_streaming(img2d: jnp.ndarray, idx_a: jnp.ndarray,
                             perm: jnp.ndarray, inv_perm: jnp.ndarray,
                             cfg: PipelineConfig):
    """One grayscale channel, strip-free. Returns (z2d, vals).

    CONTRACT: ``perm`` / ``inv_perm`` are NEVER READ — streaming kernels
    run in natural pixel order (module header); the parameters exist only
    so this jit shares the dense ``_filter_channel`` call signature.
    Callers may (and models/pipeline.filter_image does) pass ``idx_a`` in
    their place so the N-sized permutations are never staged — jit prunes
    unused args. A future fallback that wants the permutation must take it
    explicitly, not through these slots."""
    h, w = img2d.shape
    if cfg.operator_filter():
        ctx = _strip_ctx(img2d, idx_a, cfg)
        s = _normalize_streaming(ctx, cfg)
        return _apply_matvec_streaming(img2d, ctx, s, cfg, h, w)
    fac = _factor_streaming(img2d, idx_a, cfg)
    return _apply_factor(fac, idx_a, cfg, h, w)


# ---------------------------------------------------------------------------
# staged variants: separate jits so the graded eigensolve wall can be
# recorded for STREAMING configs too (the fused path collapses all stages
# into one program). The context (features, kaa, Pallas tilings) is rebuilt
# per stage — cheap O(Nd)/O(p^2 d) setup — so sum(stage walls) runs a hair
# over the fused wall; the fused wall stays the headline number. Affinity
# has no separate stage here BY DESIGN: tiles are recomputed inside every
# pass (that is the streaming trade), so its cost is spread across the
# normalize/eigensolve walls.
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("cfg",))
def stage_scales_streaming(img2d, idx_a, cfg: PipelineConfig):
    """Stage 1: normalization scales s (n_pad,) — the Sinkhorn wall."""
    return _normalize_streaming(_strip_ctx(img2d, idx_a, cfg), cfg)


@partial(jax.jit, static_argnames=("cfg",))
def stage_matvec_streaming(img2d, idx_a, s, cfg: PipelineConfig):
    """Staged twin of the matvec-mode filter apply (filter_mode="matvec"):
    everything after the normalization scales in one jit — there is no
    eigensolve stage to time in this mode."""
    h, w = img2d.shape
    return _apply_matvec_streaming(img2d, _strip_ctx(img2d, idx_a, cfg), s,
                                   cfg, h, w)


@partial(jax.jit, static_argnames=("cfg",))
def stage_factor_streaming(img2d, idx_a, s, cfg: PipelineConfig):
    """Stage 2: Nystrom eigensolve (gram + p x p factor + colstats)."""
    return _eigensolve_streaming(img2d, _strip_ctx(img2d, idx_a, cfg), s, cfg)


def stage_apply_streaming(fac: StreamFactor, idx_a, cfg: PipelineConfig,
                          h: int, w: int):
    """Stage 3: the O(N m) filter apply. ``fac`` may come from the
    stage_factor_streaming jit boundary, where its static int fields
    (n, block) arrive as 0-d arrays — they are re-pinned here so the
    reshape/slice shapes stay compile-time static."""
    n = h * w
    fac = fac._replace(n=n, block=min(cfg.block_cols, n))
    n_arrays = len(StreamFactor._fields) - 2   # all but n, block
    fn = _stage_apply_jit(cfg, fac.n, fac.block, h, w)
    return fn(tuple(fac[:n_arrays]), idx_a)


@lru_cache(maxsize=32)
def _stage_apply_jit(cfg: PipelineConfig, n: int, block: int, h: int, w: int):
    @jax.jit
    def run(fac_arrays, idx_a):
        fac = StreamFactor(*fac_arrays, n=n, block=block)
        return _apply_factor(fac, idx_a, cfg, h, w)
    return run


@partial(jax.jit, static_argnames=("cfg",))
def ds_residual_streaming(img2d: jnp.ndarray, idx_a: jnp.ndarray,
                          cfg: PipelineConfig):
    """||diag(s) K~ s - 1||_inf over the true pixels — the strip-free twin
    of ops/sinkhorn.ds_residual (same opt-in convergence diagnostic, one
    extra O(Np) kernel-recompute pass). Padding columns carry s = 0 and are
    masked out of the max."""
    ctx = _strip_ctx(img2d, idx_a, cfg)
    s = _normalize_streaming(ctx, cfg)
    r = (s * ctx.ktilde_apply(s) - 1.0) * ctx.valid
    return jnp.max(jnp.abs(r))


@partial(jax.jit, static_argnames=("cfg",))
def basis_channel_streaming(img2d: jnp.ndarray, idx_a: jnp.ndarray,
                            cfg: PipelineConfig):
    """Eigenbasis (vals (m,), vecs (N, m)) via the strip-free path, for
    -save_basis on streaming-sized images (O(N m) output, never O(N p)).
    vecs rows are in NATURAL pixel order — the caller permutes to the
    checkpoint's [A; B] convention."""
    fac = _factor_streaming(img2d, idx_a, cfg)
    dtype = jnp.bfloat16 if cfg.affinity_dtype == "bfloat16" else jnp.float32
    if fac.v_b is not None:
        v = fac.v_b
    else:
        v = st.rmatmat(fac.feats_a, fac.feats_pad, fac.basis0,
                       fac.s_a, fac.s_b_cols, fac.block, dtype)
    v = v.at[idx_a].set(fac.v_a)                      # p scatter of A rows
    return fac.vals, v[:fac.n] * fac.scale[None, :]
