"""Row-sharded streaming pipeline: 8 MP-class images across a mesh.

BASELINE config 4's contract — "affinity row-blocks sharded across v4-8;
distributed K_AB extension matmuls" — for the strip-free path. Each device
owns a contiguous slice of the (natural-order, padded) pixel axis and runs
the streaming block-scan over ITS blocks only; the p-sized accumulators
(Sinkhorn contractions, the O(Np^2) gram, column stats) are combined with
one ``psum`` over the ``rows`` axis — the MPI_Allreduce of the reference's
PETSc MatMult (SURVEY.md §2.3). The p x p eigensolve is replicated
(communication-free), and the extension/apply outputs stay device-local.

Built as ``shard_map`` wrappers around the SAME ops/streaming.py operators
the single-device model uses; tests assert sharded == single-device on the
8-fake-device CPU mesh.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P
from jax import shard_map

from ..config import PipelineConfig
from ..ops import streaming as st
from ..models.streaming import (gram_sample_idx, sinkhorn_sample_idx,
                                v_bytes_cap)
from ..ops.affinity import affinity_strip, extract_features_padded
from ..ops.filters import FILTER_REGISTRY
from ..ops.linalg import psd_pinv_sqrt, trunc_inv_sqrt_vals
from ..ops.nystrom import _LIVE_NORM2, nystrom_chol_factor
from ..ops.sinkhorn import _make_kaa_solve
from ..utils.meminfo import DENSE_STRIP_FRACTION, memory_budget
from .mesh import shard

_EPS = 1e-30


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _pallas_pads(a, f, dtype):
    """Padded (fa (p_pad, dp), f_t (dp, nl_pad), p, nl, nl_pad) layouts
    for the fused Pallas matvec kernels, shared by both sharded builders;
    pad widths are the kernels' own (ops/pallas_streaming). ``a`` is pcast
    rows-varying: it arrives replicated (single-frame builder) or
    data-varying (batched), and the kernel dots it against rows-sharded
    feature tiles, which the vma checker requires to match."""
    from ..ops import pallas_streaming as pst

    a = jax.lax.pcast(a, "rows", to="varying")
    nl = f.shape[0]
    nl_pad = pst.n_pad_for(nl)
    fa_pad, f_t = pst.feature_pads(a, f, nl_pad, dtype)
    return fa_pad, f_t, a.shape[0], nl, nl_pad


# --- p-class index primitives over the 'rows'-sharded pixel axis -----------
# GSPMD's generic lowering of jnp.take / .at[].set on a rows-sharded
# N-vector builds N-class collectives (s32 index all-gathers + masked
# (N/k, d) all-reduces — measured in benchmarks/collective_volume.py), and
# two of them sat INSIDE the Sinkhorn fori_loop. These shard_map bodies do
# the same ops with local index arithmetic instead: the only communication
# is a p-sized psum (gather) or none at all (scatter — each device keeps
# the updates that land in its shard). With these, every collective in the
# sharded streaming programs carries p-class payloads (p-vectors, (p, m),
# (p, p)) — communication volume independent of N, the design claim
# tests/test_collectives.py pins.

def _gather_p_prim(s_loc, idx):
    """(..., p) gather from a rows-sharded (..., n) vector: local masked
    take + p-sized psum. Leading batch dims ride along."""
    r = jax.lax.axis_index("rows")
    ln = s_loc.shape[-1]
    loc = idx - r * ln
    ok = (loc >= 0) & (loc < ln)
    v = jnp.where(ok, jnp.take(s_loc, jnp.clip(loc, 0, ln - 1), axis=-1), 0.0)
    return jax.lax.psum(v, "rows")


def _gather_rows_prim(f_loc, idx, axis):
    """(p, d)-class row gather from a rows-sharded (..., n, d) matrix
    (the feats_a extraction): local masked take + (p, d) psum."""
    r = jax.lax.axis_index("rows")
    ln = f_loc.shape[axis]
    loc = idx - r * ln
    ok = (loc >= 0) & (loc < ln)
    rows = jnp.take(f_loc, jnp.clip(loc, 0, ln - 1), axis=axis)
    mask_shape = [1] * f_loc.ndim
    mask_shape[axis] = ok.shape[0]
    return jax.lax.psum(
        jnp.where(ok.reshape(mask_shape), rows, 0.0), "rows")


def _scatter_p_prim(x_loc, idx, vals):
    """Scatter p replicated-index values into a rows-sharded (..., n)
    vector — communication-free: out-of-shard updates are dropped."""
    r = jax.lax.axis_index("rows")
    ln = x_loc.shape[-1]
    loc = idx - r * ln
    ok = (loc >= 0) & (loc < ln)
    loc = jnp.where(ok, loc, ln)          # force OOB so mode='drop' skips
    return x_loc.at[..., loc].set(vals, mode="drop")


def _rows_prims(cfg: PipelineConfig, dtype, VARY):
    """The sharded streaming primitives over a LOCAL row-slice, shared by
    the single-frame and guided builders (identical bodies were
    copy-pasted before — review finding; the batched builder keeps its
    own set because every op there is vmapped over the frame axis).
    Returned functions are meant to be shard_map-wrapped by the caller;
    each accumulating op psums over 'rows' itself."""
    if cfg.use_pallas:
        from ..ops import pallas_streaming as pst

    def _mv(fa, f_loc, v_loc, block):
        if cfg.use_pallas:
            fa_pad, f_t, p, nl, nl_pad = _pallas_pads(fa, f_loc, dtype)
            vv = jnp.zeros(nl_pad, jnp.float32).at[:nl].set(v_loc)
            u = pst.matvec_pallas(fa_pad, f_t, vv, vma=VARY)[:p]
        else:
            u = st.matvec(fa, f_loc, v_loc,
                          jnp.ones(fa.shape[0], jnp.float32),
                          jnp.ones_like(v_loc), block, dtype, vary=VARY)
        return jax.lax.psum(u, "rows")

    def _rmv(fa, f_loc, t, block):
        if cfg.use_pallas:
            fa_pad, f_t, p, nl, _ = _pallas_pads(fa, f_loc, dtype)
            tt = jnp.zeros(fa_pad.shape[0], jnp.float32).at[:p].set(t)
            return pst.rmatvec_pallas(fa_pad, f_t, tt, vma=VARY)[:nl]
        return st.rmatvec(fa, f_loc, t, jnp.ones(fa.shape[0], jnp.float32),
                          jnp.ones_like(f_loc[:, 0]), block, dtype)

    def _gram(fa, f_loc, s_a, cols_loc, block):
        g = st.gram(fa, f_loc, s_a, cols_loc, block, dtype, vary=VARY)
        return jax.lax.psum(g, "rows")

    def _colstats(fa, f_loc, basis, y_loc, s_a, cols_loc, block):
        norms, coeffs, v_loc = st.rmatmat_colstats_v(
            fa, f_loc, basis, y_loc, s_a, cols_loc, block, dtype, vary=VARY)
        return (jax.lax.psum(norms, "rows"), jax.lax.psum(coeffs, "rows"),
                v_loc)

    def _colstats_nov(fa, f_loc, basis, y_loc, s_a, cols_loc, block):
        norms, coeffs = st.rmatmat_colstats(fa, f_loc, basis, y_loc, s_a,
                                            cols_loc, block, dtype,
                                            vary=VARY)
        return jax.lax.psum(norms, "rows"), jax.lax.psum(coeffs, "rows")

    def _apply(fa, f_loc, basis, w, s_a, cols_loc, block):
        return st.rmat_apply(fa, f_loc, basis, w, s_a, cols_loc, block, dtype)

    def _coarse(fa, fc_loc, t, mc_loc, block):
        u = st.sinkhorn_coarse_step(fa, fc_loc, t, mc_loc, 1.0, block,
                                    dtype, vary=VARY)
        return jax.lax.psum(u, "rows")

    def _rmv2(fa, f_loc, t2, block):
        return st.rmatvec2(fa, f_loc, t2, jnp.ones_like(f_loc[:, 0]),
                           block, dtype)

    def _gram_dec(fa, f_loc, s_a, s_loc, jidx_loc, block):
        """Decimated-column cross (gram_coarse) with LOCAL sample takes:
        jidx is ascending and uniform per k-slot, so the contiguous
        'rows'-shard of the index vector lands exactly in this device's
        row range — the gathers are local, and the only communication is
        the (p, p) psum (plus the scalar sample-energy psum for the
        ratio). Replaces the outside-shard_map jnp.take pair that GSPMD
        lowered to (N/k, d)-class all-reduces."""
        r = jax.lax.axis_index("rows")
        loc = jidx_loc - r * f_loc.shape[0]
        fg = jnp.take(f_loc, loc, axis=0)
        cg = jnp.take(s_loc, loc)
        g = st.gram(fa, fg, s_a, cg, block, dtype, vary=VARY)
        return (jax.lax.psum(g, "rows"),
                jax.lax.psum(jnp.sum(cg * cg), "rows"))

    return (_mv, _rmv, _gram, _colstats, _colstats_nov, _apply, _coarse,
            _rmv2, _gram_dec)



@lru_cache(maxsize=None)
def build_streaming_sharded(mesh, cfg: PipelineConfig):
    """Returns a jitted fn (img2d (H,W) f32, idx_a (p,)) -> (z2d, vals)
    with the pixel axis sharded over mesh axis 'rows'. Memoized on
    (mesh, cfg) — see build_sharded_pipeline."""

    if cfg.solver == "sketch":
        # this builder runs the RECOMPUTE operators only; the materialized
        # strip the sketch's thin passes want lives in the batched builder
        # (filter_image_streaming_sharded routes strip_cache configs there)
        raise ValueError(
            "solver='sketch' is strip_cache-only on the sharded streaming "
            "path — route through build_streaming_sharded_batch (the "
            "filter_image entry does this), or use 'chol'/'lobpcg'")
    dtype = jnp.bfloat16 if cfg.affinity_dtype == "bfloat16" else jnp.float32
    n_rows = int(mesh.shape["rows"])   # KeyError on a rows-less mesh is
                                       # clearer than a late spec failure

    def smap(fn, in_specs, out_specs):
        # check_vma ON: shard_map's varying-axis type checker actively
        # validates every psum placement (a missing/extra psum is a compile
        # error, not silently-wrong pixels). The streaming operators take
        # vary=("rows",) so their scan-carry accumulators are typed as
        # rows-varying like the kernel tiles they accumulate. Pallas mode
        # must run unchecked (see the batched builder's note); the psum
        # placement is identical and the equivalence tests pin the outputs.
        return shard_map(fn, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=not cfg.use_pallas)

    VARY = ("rows",)
    (_mv, _rmv, _gram, _colstats, _colstats_nov, _apply, _, _,
     _gram_dec) = _rows_prims(cfg, dtype, VARY)

    @jax.jit
    def run(img2d, idx_a):
        h, w = img2d.shape
        n = h * w
        p = idx_a.shape[0]
        block = min(cfg.block_cols, n)   # the single-device twin's
                                         # ACTIVE width (preset contract)
        chunk = block * n_rows
        n_pad = _cdiv(n, chunk) * chunk

        # replicated, natural order; chunked write into the padded buffer
        # (one O(N d) resident copy, not three — the 64 MP OOM fix)
        feats_pad = extract_features_padded(img2d, cfg, n_pad)
        d = feats_pad.shape[1]

        idx = jnp.arange(n_pad)
        valid = (idx < n).astype(jnp.float32)
        a_mask = jnp.zeros(n_pad, jnp.float32).at[idx_a].set(1.0)
        b_mask = valid * (1.0 - a_mask)

        pN, pNd = P("rows"), P("rows", None)
        rep, rep2 = P(), P(None, None)
        # p-class index prims (module note): the generic GSPMD lowering of
        # these takes/scatters on rows-sharded vectors built N-class
        # collectives, two of them inside the Sinkhorn loop
        gather_p = smap(_gather_p_prim, (pN, rep), rep)
        gather_rows = smap(partial(_gather_rows_prim, axis=0),
                           (pNd, rep), rep2)
        scatter_p = smap(_scatter_p_prim, (pN, rep, rep), pN)

        feats_a = gather_rows(feats_pad, idx_a)
        kaa = affinity_strip(feats_a, feats_a, dtype)
        kaa_solve = _make_kaa_solve(kaa, cfg.eig_tol, cfg.solver)

        mv = smap(partial(_mv, block=block), (rep2, pNd, pN), rep)
        rmv = smap(partial(_rmv, block=block), (rep2, pNd, rep), pN)
        gramf = smap(partial(_gram, block=block), (rep2, pNd, rep, pN), rep2)
        # materialize V (n_pad/n_rows x m per device) when it fits HBM:
        # the filter apply becomes one skinny GEMM instead of a full
        # kernel-recompute pass (models/streaming.py v_bytes_cap note)
        mat_v = n_pad * cfg.num_eigvecs * 4 <= v_bytes_cap() * n_rows
        if mat_v:
            colstats = smap(partial(_colstats, block=block),
                            (rep2, pNd, rep2, pN, rep, pN), (rep, rep, pNd))
        else:
            colstats = smap(partial(_colstats_nov, block=block),
                            (rep2, pNd, rep2, pN, rep, pN), (rep, rep))
            applyf = smap(partial(_apply, block=block),
                          (rep2, pNd, rep2, rep, rep, pN), pN)

        def ktilde_apply(s):
            s_a = gather_p(s, idx_a)
            u = mv(feats_a, feats_pad, s * b_mask)
            top = kaa @ s_a + u
            t = s_a + kaa_solve(u)
            bottom = rmv(feats_a, feats_pad, t) * b_mask
            return scatter_p(bottom, idx_a, top)

        if cfg.normalization == "sinkhorn":
            def body(_, s):
                ks = jnp.maximum(ktilde_apply(s), _EPS)
                return jnp.sqrt(s / ks) * valid
            s = jax.lax.fori_loop(0, cfg.sinkhorn_iters, body,
                                  jnp.ones(n_pad, jnp.float32) * valid)
        elif cfg.normalization == "symmetric":
            s = jax.lax.rsqrt(jnp.maximum(ktilde_apply(valid), _EPS)) * valid
        else:
            s = valid
        if cfg.operator_filter():
            # exact polynomial f(W) y by the SAME sharded completion matvec
            # Sinkhorn iterates on (psums over 'rows' inside mv/rmv) — no
            # gram, no eigensolve (ops/filters.py MATVEC_FILTERS note)
            from ..ops.filters import apply_operator_filter
            y_pad = jnp.zeros(n_pad, jnp.float32).at[:n].set(
                img2d.astype(jnp.float32).ravel())
            z_full = apply_operator_filter(
                lambda x: s * ktilde_apply(s * x), y_pad,
                cfg.filter_name, cfg.filter_param, cfg.filter_mode,
                cfg.cheb_degree)
            z = z_full[:n].reshape(h, w)
            return jnp.clip(z, 0.0, 1.0), jnp.zeros((0,), jnp.float32)

        s_a = gather_p(s, idx_a)
        s_b_cols = s * b_mask

        waa = kaa * (s_a[:, None] * s_a[None, :])
        if cfg.gram_coarse > 1:
            # jittered decimated cross estimate (models/streaming.py
            # gram_coarse + gram_sample_idx anti-aliasing note); local
            # sample takes + (p, p) psum (_gram_dec)
            kg = cfg.gram_coarse
            if block % kg != 0:
                raise ValueError(
                f"gram_coarse={kg} must divide the active block "
                f"width min(block_cols, N)={block}")
            jidx = jnp.asarray(gram_sample_idx(n_pad, kg,
                                               cfg.gram_jitter_seed))
            gramd = smap(partial(_gram_dec, block=block // kg),
                         (rep2, pNd, rep, pN, pN), (rep2, rep))
            g_est, sum_cg2 = gramd(feats_a, feats_pad, s_a, s_b_cols, jidx)
            ratio_g = (jnp.sum(s_b_cols * s_b_cols)
                       / jnp.maximum(sum_cg2, _EPS))
            cross = ratio_g * g_est
        else:
            cross = gramf(feats_a, feats_pad, s_a, s_b_cols)
        m = cfg.num_eigvecs
        if cfg.solver in ("chol", "lobpcg"):
            method = "lobpcg" if cfg.solver == "lobpcg" else "eigh"
            vals_m, basis0 = nystrom_chol_factor(waa, cross, m, cfg.eig_tol,
                                                 method, cfg.lobpcg_iters)
        else:
            whalf = psd_pinv_sqrt(waa, cfg.eig_tol)
            s_mat = waa + whalf @ cross @ whalf
            s_mat = 0.5 * (s_mat + s_mat.T)
            vals, vecs = jnp.linalg.eigh(s_mat)
            vals_m = vals[::-1][:m]
            basis0 = whalf @ (vecs[:, ::-1][:, :m]
                              * trunc_inv_sqrt_vals(vals_m,
                                                    cfg.eig_tol)[None, :])

        v_a = waa @ basis0
        y = img2d.astype(jnp.float32).ravel()
        y_pad = jnp.zeros(n_pad, jnp.float32).at[:n].set(y)
        y_a = gather_p(y_pad, idx_a)

        if mat_v:
            norms_b, coeffs_b, v_b = colstats(feats_a, feats_pad, basis0,
                                              y_pad, s_a, s_b_cols)
        else:
            norms_b, coeffs_b = colstats(feats_a, feats_pad, basis0, y_pad,
                                         s_a, s_b_cols)
        dnorm = jnp.sum(v_a * v_a, axis=0) + norms_b
        live = dnorm > _LIVE_NORM2
        scale = jnp.where(live, 1.0 / jnp.sqrt(jnp.where(live, dnorm, 1.0)),
                          0.0)
        coeffs = scale * (v_a.T @ y_a + coeffs_b)

        filt = FILTER_REGISTRY[cfg.filter_name]
        fvals = filt.fn(vals_m, cfg.filter_param)
        g = (fvals - 1.0) if filt.affine else fvals
        wvec = scale * g * coeffs

        z_a = v_a @ wvec
        if mat_v:
            z_full = v_b @ wvec      # V materialized by the colstats pass
        else:
            z_full = applyf(feats_a, feats_pad, basis0, wvec, s_a, s_b_cols)
        z_full = scatter_p(z_full, idx_a, z_a)
        if filt.affine:
            z_full = z_full + y_pad
        z = z_full[:n].reshape(h, w)
        return jnp.clip(z, 0.0, 1.0), vals_m

    return run


@lru_cache(maxsize=None)
def build_streaming_sharded_batch(mesh, cfg: PipelineConfig):
    """Batched variant: frames on mesh axis ``data``, pixel blocks on
    ``rows`` — BASELINE config 5's real shape ("16x 4K frames ... multi-host
    v4-32"). A 4K frame is streaming-only territory (the dense strip at
    p=4096 is ~136 GB f32 per frame), so this is strip-free like the
    single-frame path above, with a leading batch axis on every operator:
    each scan step now computes a (B_local, p, block) kernel-tile batch —
    bigger MXU work per dispatch — and the p-sized eigensolves run as one
    batched (B_local, p, p) solve per rows-group.

    Returns a jitted fn (frames (B, H, W) f32, idx_a (p,)) -> (z, vals)."""

    dtype = jnp.bfloat16 if cfg.affinity_dtype == "bfloat16" else jnp.float32
    n_rows = int(mesh.shape["rows"])   # KeyError on a rows-less mesh is
                                       # clearer than a late spec failure

    def smap(fn, in_specs, out_specs):
        # check_vma ON — see the single-frame wrapper; here the kernel
        # tiles vary over BOTH mesh axes (frames on 'data', blocks on
        # 'rows'), so the scan carries are typed ("data", "rows")-varying.
        # Exception: the Pallas variant must run unchecked — interpret-mode
        # pallas_call bodies create constants with empty vma that the
        # checker rejects against varying operands (a JAX limitation its
        # own error message acknowledges); the psum placement is identical
        # to the checked XLA variant, and the pallas==xla equivalence test
        # (tests/test_sharded.py) pins the outputs equal
        return shard_map(fn, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=not cfg.use_pallas)

    VARY = ("data", "rows")

    ones_p = lambda fa: jnp.ones(fa.shape[0], jnp.float32)

    # Fused Pallas matvecs per frame (same kernels as the single-image
    # path, vmapped over the local frame batch): K tiles never reach
    # device memory. The padded (d_pad, n_local) transposed features are
    # rebuilt per call — a bandwidth op small next to the pass it feeds.
    if cfg.use_pallas:
        from ..ops import pallas_streaming as pst

        def _one_mv(a, f, v):
            fa_pad, f_t, p, nl, nl_pad = _pallas_pads(a, f, dtype)
            vv = jnp.zeros(nl_pad, jnp.float32).at[:nl].set(v)
            return pst.matvec_pallas(fa_pad, f_t, vv, vma=VARY)[:p]

        def _one_rmv(a, f, t):
            fa_pad, f_t, p, nl, _ = _pallas_pads(a, f, dtype)
            tt = jnp.zeros(fa_pad.shape[0], jnp.float32).at[:p].set(t)
            return pst.rmatvec_pallas(fa_pad, f_t, tt, vma=VARY)[:nl]

    def _mv(fa, f_loc, v_loc, block):
        if cfg.use_pallas:
            u = jax.vmap(_one_mv)(fa, f_loc, v_loc)   # block-independent
        else:
            u = jax.vmap(lambda a, f, v: st.matvec(
                a, f, v, ones_p(a), jnp.ones_like(v), block, dtype,
                vary=VARY))(fa, f_loc, v_loc)
        return jax.lax.psum(u, "rows")

    def _rmv(fa, f_loc, t, block):
        if cfg.use_pallas:
            return jax.vmap(_one_rmv)(fa, f_loc, t)
        return jax.vmap(lambda a, f, tt: st.rmatvec(
            a, f, tt, ones_p(a), jnp.ones_like(f[:, 0]), block, dtype)
        )(fa, f_loc, t)

    def _gram(fa, f_loc, s_a, cols_loc, block):
        g = jax.vmap(lambda a, f, sa, c: st.gram(a, f, sa, c, block, dtype,
                                                 vary=VARY)
                     )(fa, f_loc, s_a, cols_loc)
        return jax.lax.psum(g, "rows")

    def _colstats(fa, f_loc, basis, y_loc, s_a, cols_loc, block):
        norms, coeffs, v_loc = jax.vmap(
            lambda a, f, g, y, sa, c: st.rmatmat_colstats_v(
                a, f, g, y, sa, c, block, dtype, vary=VARY)
        )(fa, f_loc, basis, y_loc, s_a, cols_loc)
        return (jax.lax.psum(norms, "rows"), jax.lax.psum(coeffs, "rows"),
                v_loc)

    def _colstats_nov(fa, f_loc, basis, y_loc, s_a, cols_loc, block):
        norms, coeffs = jax.vmap(
            lambda a, f, g, y, sa, c: st.rmatmat_colstats(
                a, f, g, y, sa, c, block, dtype, vary=VARY)
        )(fa, f_loc, basis, y_loc, s_a, cols_loc)
        return jax.lax.psum(norms, "rows"), jax.lax.psum(coeffs, "rows")

    def _apply(fa, f_loc, basis, w, s_a, cols_loc, block):
        return jax.vmap(lambda a, f, g, wv, sa, c: st.rmat_apply(
            a, f, g, wv, sa, c, block, dtype)
        )(fa, f_loc, basis, w, s_a, cols_loc)

    def _coarse(fa, fc_loc, t, mc_loc, block):
        u = jax.vmap(lambda a, f, tt, mk: st.sinkhorn_coarse_step(
            a, f, tt, mk, 1.0, block, dtype, vary=VARY))(fa, fc_loc, t,
                                                         mc_loc)
        return jax.lax.psum(u, "rows")

    def _rmv2(fa, f_loc, t2, block):
        return jax.vmap(lambda a, f, tt: st.rmatvec2(
            a, f, tt, jnp.ones_like(f[:, 0]), block, dtype)
        )(fa, f_loc, t2)

    def _gram_dec_b(fa, f_loc, s_a, s_loc, jidx_loc, block):
        """Batched _gram_dec (see _rows_prims): local sample takes +
        (B, p, p) psum."""
        loc = jidx_loc - jax.lax.axis_index("rows") * f_loc.shape[1]
        fg = jnp.take(f_loc, loc, axis=1)
        cg = jnp.take(s_loc, loc, axis=1)
        g = jax.vmap(lambda a, f, sa, c: st.gram(a, f, sa, c, block, dtype,
                                                 vary=VARY))(fa, fg, s_a, cg)
        return (jax.lax.psum(g, "rows"),
                jax.lax.psum(jnp.sum(cg * cg, axis=1), "rows"))

    @jax.jit
    def run(frames, idx_a):
        bsz, h, w = frames.shape
        n = h * w
        p = idx_a.shape[0]
        block = min(cfg.block_cols, n)   # the single-device twin's
                                         # ACTIVE width (preset contract)
        chunk = block * n_rows
        n_pad = _cdiv(n, chunk) * chunk

        frames = shard(frames.astype(jnp.float32), mesh, "data", None, None)
        # explicit rows-sharded layout: every shard_map consumer wants
        # P('data','rows',None), and pinning it here keeps GSPMD from
        # inventing masked all-reduce reshards for the coarse [::k] slice
        # (stride divides the shard boundary, so the slice is local)
        feats_pad = shard(jax.vmap(
            lambda im: extract_features_padded(im, cfg, n_pad))(frames),
            mesh, "data", "rows", None)
        d = feats_pad.shape[2]

        idx = jnp.arange(n_pad)
        valid = (idx < n).astype(jnp.float32)
        # replicated, like the single-device math: the masks are O(N)
        # setup consumed elementwise by sharded vectors (local slices)
        a_mask = shard(jnp.zeros(n_pad, jnp.float32).at[idx_a].set(1.0),
                       mesh)
        b_mask = valid * (1.0 - a_mask)

        dB, dB2, dB3 = P("data"), P("data", None, None), P("data", None)
        pB, pBd = P("data", "rows"), P("data", "rows", None)
        rep = P(None)
        # p-class index prims (module note before _gather_p_prim)
        gather_p = smap(_gather_p_prim, (pB, rep), dB3)
        gather_rows = smap(partial(_gather_rows_prim, axis=1),
                           (pBd, rep), dB2)
        scatter_p = smap(_scatter_p_prim, (pB, rep, dB3), pB)

        feats_a = gather_rows(feats_pad, idx_a)               # (B, p, d)
        kaa = jax.vmap(lambda a: affinity_strip(a, a, dtype))(feats_a)
        # KEEP the solver tuple in sync with ops/sinkhorn._make_kaa_solve
        # ("sketch" uses the same ridge-chol solve for normalization;
        # streaming+sketch is config-rejected today, but a drift here
        # would silently change the fixed point if that ever relaxes)
        if cfg.solver in ("chol", "lobpcg", "sketch"):
            import jax.scipy.linalg as jsl
            eps = cfg.eig_tol * jnp.max(jnp.sum(jnp.abs(kaa), axis=2), axis=1)
            lchol = jnp.linalg.cholesky(
                kaa + eps[:, None, None] * jnp.eye(p, dtype=kaa.dtype))
            kaa_solve = jax.vmap(lambda lf, uf: jsl.cho_solve((lf, True), uf))
            solve = lambda u: kaa_solve(lchol, u)
        else:
            from ..ops.linalg import psd_pinv
            pinv = jax.vmap(lambda k: psd_pinv(k, cfg.eig_tol))(kaa)
            solve = lambda u: jnp.einsum("bij,bj->bi", pinv, u)

        mv = smap(partial(_mv, block=block), (dB2, pBd, pB), dB3)
        rmv = smap(partial(_rmv, block=block), (dB2, pBd, dB3), pB)
        gramf = smap(partial(_gram, block=block), (dB2, pBd, dB3, pB), dB2)

        # strip_cache on the mesh: each device materializes the LOCAL
        # (B_loc, p, n_loc) slice of every frame's strip — the mode's
        # single-device bound becomes per-device (rows-sharding divides
        # the strip), and the sketch eigensolver's sandwich runs as local
        # GEMMs + one (p, k) psum. Same estimators as the single-device
        # strip_cache path (models/streaming._strip_ctx); equivalence
        # pinned in tests/test_sharded.py.
        strip = None
        sB = P("data", None, "rows")
        if cfg.strip_cache:
            from ..models.streaming import _strip_dot, _strip_dot_t
            n_data = int(mesh.shape["data"])
            itemsize = 2 if cfg.affinity_dtype in ("bfloat16",
                                                   "bfloat16_store") else 4
            per_dev = _cdiv(bsz, n_data) * p * (n_pad // n_rows) * itemsize
            if per_dev > memory_budget(DENSE_STRIP_FRACTION):
                raise ValueError(
                    f"strip_cache per-device strip slice would be "
                    f"{per_dev / 1e9:.1f} GB (B_loc={_cdiv(bsz, n_data)}, "
                    f"p={p}, n_loc={n_pad // n_rows}) — past the "
                    f"per-device bound; use the recompute path "
                    f"(strip_cache=False)")
            store = (jnp.bfloat16 if cfg.affinity_dtype in
                     ("bfloat16", "bfloat16_store") else None)

            def _emit(fa, f_loc, valid_loc):
                # padding columns are zeroed by the mask (the single-device
                # path poisons the feature rows instead — same exact
                # result: exp underflow there, multiply-by-0 here)
                def one(a, f):
                    sl = affinity_strip(a, f, dtype) * valid_loc[None, :]
                    return sl if store is None else sl.astype(store)
                return jax.vmap(one)(fa, f_loc)

            strip = smap(_emit, (dB2, pBd, P("rows")), sB)(
                feats_a, feats_pad, valid)

            def _mv_s(s_loc, v_loc):
                return jax.lax.psum(jax.vmap(_strip_dot)(s_loc, v_loc),
                                    "rows")

            def _rmv_s(s_loc, t):
                return jax.vmap(_strip_dot_t)(s_loc, t)

            mv_s = smap(_mv_s, (sB, pB), dB3)
            rmv_s = smap(_rmv_s, (sB, dB3), pB)
            rmv2_s = smap(_rmv_s, (sB, P("data", None, None)), pBd)
            mv_k = lambda v: mv_s(strip, v)
            rmv_k = lambda t: rmv_s(strip, t)
        else:
            mv_k = lambda v: mv(feats_a, feats_pad, v)
            rmv_k = lambda t: rmv(feats_a, feats_pad, t)

        # V materialization gate — see build_streaming_sharded
        # v_b is sharded over BOTH axes (out spec P('data','rows',None)):
        # gate on per-DEVICE bytes, not per-rows-group (review finding —
        # /n_rows alone forced the slow recompute apply at config-5 scale).
        # A materialized strip always bounds N, so strip_cache keeps V.
        mat_v = (strip is not None
                 or bsz * n_pad * cfg.num_eigvecs * 4
                 <= v_bytes_cap() * mesh.devices.size)
        if strip is not None:
            def _colstats_s(s_loc, basis, y_loc, sa_b, sb_loc):
                from ..models.streaming import _strip_dot_t as sdt

                def one(sl, b0, y, sa, sb):
                    vb = sdt(sl, b0 * sa[:, None]) * sb[:, None]
                    return jnp.sum(vb * vb, axis=0), vb.T @ y, vb

                norms, coeffs, vb = jax.vmap(one)(s_loc, basis, y_loc,
                                                  sa_b, sb_loc)
                return (jax.lax.psum(norms, "rows"),
                        jax.lax.psum(coeffs, "rows"), vb)

            colstats_s = smap(_colstats_s, (sB, dB2, pB, dB3, pB),
                              (dB3, dB3, pBd))
        elif mat_v:
            colstats = smap(partial(_colstats, block=block),
                            (dB2, pBd, dB2, pB, dB3, pB), (dB3, dB3, pBd))
        else:
            colstats = smap(partial(_colstats_nov, block=block),
                            (dB2, pBd, dB2, pB, dB3, pB), (dB3, dB3))
            applyf = smap(partial(_apply, block=block),
                          (dB2, pBd, dB2, dB3, dB3, pB), pB)

        def ktilde_apply(s):                                  # (B, n_pad)
            s_a = gather_p(s, idx_a)
            u = mv_k(s * b_mask[None, :])
            top = jnp.einsum("bij,bj->bi", kaa, s_a) + u
            t = s_a + solve(u)
            bottom = rmv_k(t) * b_mask[None, :]
            return scatter_p(bottom, idx_a, top)

        if cfg.normalization == "sinkhorn" and cfg.sinkhorn_coarse > 1:
            # decimated-column Sinkhorn fixed point (models/streaming.py
            # coarse branch, batched + rows-sharded): p-sized state against
            # every k-th column, then ONE full-res extension pass
            k = cfg.sinkhorn_coarse
            if block % k != 0:
                raise ValueError(
                    f"sinkhorn_coarse={k} must divide the active "
                    f"block width min(block_cols, N)={block}")
            # diagonal-offset sample — models/streaming.sinkhorn_sample_idx
            # (natural-order raster anti-alias). Each sampled index stays
            # inside its k-slot and the rows-shard width is a multiple of
            # block (>= k), so the take is SHARD-LOCAL: done inside
            # shard_map with per-shard static indices — GSPMD sees a local
            # gather, never an all-to-all.
            jidx_np = sinkhorn_sample_idx(n_pad, k, w,
                                          cfg.resolved_sinkhorn_sample())
            shard_w = n_pad // n_rows
            jloc = jnp.asarray(jidx_np.reshape(n_rows, -1)
                               - (np.arange(n_rows)[:, None] * shard_w),
                               jnp.int32)
            mask_c = jnp.take(b_mask, jnp.asarray(jidx_np))
            block_c = block // k
            ratio = jnp.sum(b_mask) / jnp.maximum(jnp.sum(mask_c), 1.0)
            mask_cb = jnp.broadcast_to(mask_c, (bsz, mask_c.shape[0]))
            if strip is not None:
                from ..models.streaming import _strip_dot, _strip_dot_t

                # decimated slice of the LOCAL strip (shard-local take)
                strip_c = smap(
                    lambda s_loc, jl: jnp.take(s_loc, jl[0], axis=2),
                    (sB, P("rows", None)), sB)(strip, jloc)

                def _coarse_s(sc_loc, t, mc_loc):
                    def one(sl, tt, mk):
                        y = _strip_dot_t(sl, tt)
                        return _strip_dot(sl, mk / jnp.maximum(y, _EPS))
                    return jax.lax.psum(jax.vmap(one)(sc_loc, t, mc_loc),
                                        "rows")

                coarse_s = smap(_coarse_s, (sB, dB3, pB), dB3)
                coarse_k = lambda t: coarse_s(strip_c, t, mask_cb)
                u0 = ratio * mv_s(strip_c, mask_cb)
            else:
                take_c = smap(
                    lambda f_loc, jl: jnp.take(f_loc, jl[0], axis=1),
                    (pBd, P("rows", None)), pBd)
                feats_c = take_c(feats_pad, jloc)
                coarse = smap(partial(_coarse, block=block_c),
                              (dB2, pBd, dB3, pB), dB3)
                coarse_k = lambda t: coarse(feats_a, feats_c, t, mask_cb)
                mvc = smap(partial(_mv, block=block_c), (dB2, pBd, pB), dB3)
                u0 = ratio * mvc(feats_a, feats_c, mask_cb)
            r0 = jnp.ones((bsz, p), jnp.float32)

            def cbody(_, carry):
                r_a, u_r, *_ = carry
                kaa_r = jnp.einsum("bij,bj->bi", kaa.astype(jnp.float32), r_a)
                c_a = 1.0 / jnp.maximum(kaa_r + u_r, _EPS)
                t_r = r_a + solve(u_r)
                u_c = ratio * coarse_k(t_r)
                kaa_c = jnp.einsum("bij,bj->bi", kaa.astype(jnp.float32), c_a)
                r_a2 = 1.0 / jnp.maximum(kaa_c + u_c, _EPS)
                t_c = c_a + solve(u_c)
                u_r2 = ratio * coarse_k(t_c)
                return (r_a2, u_r2, c_a, t_r, t_c)

            zero_p = jnp.zeros((bsz, p), jnp.float32)
            r_a, u_r, c_a, t_r, t_c = jax.lax.fori_loop(
                0, cfg.sinkhorn_iters, cbody, (r0, u0, r0, zero_p, zero_p))
            s_a_coarse = jnp.sqrt(jnp.maximum(r_a * c_a, 0.0))
            t2 = jnp.stack([t_r, t_c], axis=2)
            if strip is not None:
                kbt = rmv2_s(strip, t2) * b_mask[None, :, None]
            else:
                rmv2 = smap(partial(_rmv2, block=block),
                            (dB2, pBd, P("data", None, None)),
                            P("data", "rows", None))
                kbt = rmv2(feats_a, feats_pad, t2) * b_mask[None, :, None]
            prod = jnp.maximum(kbt[..., 0] * kbt[..., 1], _EPS)
            s = jnp.where(b_mask[None, :] > 0,
                          b_mask[None, :] / jnp.sqrt(prod), 0.0)
            s = scatter_p(s, idx_a, s_a_coarse)
            if cfg.sinkhorn_polish > 0:
                # full-res polish of the decimated fixed point
                def pbody(_, sp):
                    ks = jnp.maximum(ktilde_apply(sp), _EPS)
                    return jnp.sqrt(sp / ks) * valid[None, :]
                s = jax.lax.fori_loop(0, cfg.sinkhorn_polish, pbody,
                                      s * valid[None, :])
        elif cfg.normalization == "sinkhorn":
            def body(_, s):
                ks = jnp.maximum(ktilde_apply(s), _EPS)
                return jnp.sqrt(s / ks) * valid[None, :]
            s = jax.lax.fori_loop(
                0, cfg.sinkhorn_iters, body,
                jnp.broadcast_to(valid, (bsz, n_pad)).astype(jnp.float32))
        elif cfg.normalization == "symmetric":
            s = jax.lax.rsqrt(jnp.maximum(
                ktilde_apply(jnp.broadcast_to(valid, (bsz, n_pad))), _EPS)
            ) * valid[None, :]
        else:
            s = jnp.broadcast_to(valid, (bsz, n_pad)).astype(jnp.float32)
        if cfg.operator_filter():
            # batched twin of the single-frame matvec branch above
            from ..ops.filters import apply_operator_filter
            y_pad = jnp.zeros((bsz, n_pad), jnp.float32).at[:, :n].set(
                frames.reshape(bsz, n))
            z_full = apply_operator_filter(
                lambda x: s * ktilde_apply(s * x), y_pad,
                cfg.filter_name, cfg.filter_param, cfg.filter_mode,
                cfg.cheb_degree)
            z = z_full[:, :n].reshape(bsz, h, w)
            return jnp.clip(z, 0.0, 1.0), jnp.zeros((bsz, 0), jnp.float32)

        s_a = gather_p(s, idx_a)
        s_b_cols = s * b_mask[None, :]

        waa = kaa * (s_a[:, :, None] * s_a[:, None, :])
        m = cfg.num_eigvecs
        if cfg.solver == "sketch" and strip is not None:
            # sharded twin of the single-device strip_cache sketch
            # (models/streaming._eigensolve_streaming): the sandwich's two
            # strip passes run as LOCAL GEMMs + one (p, k) psum per apply;
            # the p-class triangular solves replicate per device (cheap).
            # Same scale-folded closure, same PRNGKey — identical estimator.
            from ..models.streaming import _strip_dot, _strip_dot_t
            from ..ops.nystrom import nystrom_sketch_factor

            def _sketch(waa_b, s_loc, sa_b, sb_loc):
                def one(wa, sl, sa, sb):
                    sb2 = sb * sb

                    def sandwich(t):
                        u = _strip_dot_t(sl, t * sa[:, None]) * sb2[:, None]
                        return jax.lax.psum(_strip_dot(sl, u),
                                            "rows") * sa[:, None]

                    return nystrom_sketch_factor(
                        wa, None, m, cfg.eig_tol, cfg.sketch_oversample,
                        cfg.sketch_power, sandwich=sandwich)

                return jax.vmap(one)(waa_b, s_loc, sa_b, sb_loc)

            vals_m, basis0 = smap(_sketch, (dB2, sB, dB3, pB),
                                  (dB3, dB2))(waa, strip, s_a, s_b_cols)
        else:
            if cfg.solver == "sketch":
                raise ValueError(
                    "solver='sketch' on the sharded streaming path needs "
                    "strip_cache=True (thin passes want a materialized "
                    "strip); use solver='chol'/'lobpcg' for the recompute "
                    "builders")
            if cfg.gram_coarse > 1:
                # jittered decimated cross estimate (models/streaming.py
                # gram_coarse + gram_sample_idx anti-aliasing note); local
                # sample takes + (B, p, p) psum (_gram_dec_b)
                kg = cfg.gram_coarse
                if block % kg != 0:
                    raise ValueError(
                        f"gram_coarse={kg} must divide the active block "
                        f"width min(block_cols, N)={block}")
                jidx = jnp.asarray(gram_sample_idx(n_pad, kg,
                                                   cfg.gram_jitter_seed))
                gramd = smap(partial(_gram_dec_b, block=block // kg),
                             (dB2, pBd, dB3, pB, P("rows")), (dB2, dB))
                g_est, sum_cg2 = gramd(feats_a, feats_pad, s_a, s_b_cols,
                                       jidx)
                ratio_g = (jnp.sum(s_b_cols * s_b_cols, axis=1)
                           / jnp.maximum(sum_cg2, _EPS))
                cross = ratio_g[:, None, None] * g_est
            else:
                cross = gramf(feats_a, feats_pad, s_a, s_b_cols)
        if cfg.solver == "sketch" and strip is not None:
            pass                       # vals_m/basis0 above
        elif cfg.solver in ("chol", "lobpcg"):
            method = "lobpcg" if cfg.solver == "lobpcg" else "eigh"
            vals_m, basis0 = jax.vmap(
                lambda a, c: nystrom_chol_factor(a, c, m, cfg.eig_tol,
                                                 method, cfg.lobpcg_iters)
            )(waa, cross)
        else:
            def oneshot(a, c):
                whalf = psd_pinv_sqrt(a, cfg.eig_tol)
                s_mat = a + whalf @ c @ whalf
                s_mat = 0.5 * (s_mat + s_mat.T)
                vals, vecs = jnp.linalg.eigh(s_mat)
                vm = vals[::-1][:m]
                b0 = whalf @ (vecs[:, ::-1][:, :m]
                              * trunc_inv_sqrt_vals(vm, cfg.eig_tol)[None, :])
                return vm, b0
            vals_m, basis0 = jax.vmap(oneshot)(waa, cross)

        v_a = jnp.matmul(waa, basis0)                         # (B, p, m)
        y = frames.reshape(bsz, n)
        y_pad = jnp.zeros((bsz, n_pad), jnp.float32).at[:, :n].set(y)
        y_a = gather_p(y_pad, idx_a)

        if strip is not None:
            norms_b, coeffs_b, v_b = colstats_s(strip, basis0, y_pad,
                                                s_a, s_b_cols)
        elif mat_v:
            norms_b, coeffs_b, v_b = colstats(feats_a, feats_pad, basis0,
                                              y_pad, s_a, s_b_cols)
        else:
            norms_b, coeffs_b = colstats(feats_a, feats_pad, basis0, y_pad,
                                         s_a, s_b_cols)
        dnorm = jnp.sum(v_a * v_a, axis=1) + norms_b          # (B, m)
        live = dnorm > _LIVE_NORM2
        scale = jnp.where(live, 1.0 / jnp.sqrt(jnp.where(live, dnorm, 1.0)),
                          0.0)
        coeffs = scale * (jnp.einsum("bpm,bp->bm", v_a, y_a) + coeffs_b)

        filt = FILTER_REGISTRY[cfg.filter_name]
        fvals = filt.fn(vals_m, cfg.filter_param)
        g = (fvals - 1.0) if filt.affine else fvals
        wvec = scale * g * coeffs                             # (B, m)

        z_a = jnp.einsum("bpm,bm->bp", v_a, wvec)
        if mat_v:
            z_full = jnp.einsum("bnm,bm->bn", v_b, wvec)
        else:
            z_full = applyf(feats_a, feats_pad, basis0, wvec, s_a, s_b_cols)
        z_full = scatter_p(z_full, idx_a, z_a)
        if filt.affine:
            z_full = z_full + y_pad
        z = z_full[:, :n].reshape(bsz, h, w)
        return jnp.clip(z, 0.0, 1.0), vals_m

    return run


@lru_cache(maxsize=None)
def build_streaming_sharded_guided(mesh, cfg: PipelineConfig, n_stack: int):
    """ONE factor from a GUIDE image, applied to an ``n_stack``-frame
    stack — the rows-sharded twin of the temporal-guide / luma_basis
    machinery (models/video._filter_video_guided, pipeline.
    _filter_channels_luma): the affinity/Sinkhorn/eigensolve stages run
    once on the guide, and the per-frame cost is the O(N m) spectral
    apply (or the operator-mode strip matvecs). The factor section
    mirrors build_streaming_sharded / the batched builder's coarse
    branch — same operators, same psum placement; only the y-tail is
    per-frame. Tests pin guided-sharded == guided-single-device
    (tests/test_sharded.py).

    Returns a jitted fn (guide2d (H, W) f32, stack (n_stack, H, W) f32,
    idx_a (p,)) -> (z (n_stack, H, W), vals (m,) — empty in operator
    modes)."""

    if cfg.solver == "sketch":
        # recompute-only builder (see build_streaming_sharded note);
        # silently running the oneshot ladder here would diverge from the
        # single-device strip_cache sketch without any signal
        raise ValueError(
            "solver='sketch' is not supported on the guided sharded "
            "builder (recompute operators, no materialized strip); use "
            "'chol'/'lobpcg', or drop strip_cache from the config")
    dtype = jnp.bfloat16 if cfg.affinity_dtype == "bfloat16" else jnp.float32
    n_rows = int(mesh.shape["rows"])   # KeyError on a rows-less mesh is
                                       # clearer than a late spec failure

    def smap(fn, in_specs, out_specs):
        # check_vma policy: see build_streaming_sharded
        return shard_map(fn, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=not cfg.use_pallas)

    VARY = ("rows",)
    (_mv, _rmv, _gram, _colstats, _colstats_nov, _apply, _coarse,
     _rmv2, _gram_dec) = _rows_prims(cfg, dtype, VARY)

    def _vt_dot(v_loc, ys_loc):
        # (nl, m) local V rows x (n_stack, nl) local frame slices ->
        # replicated (n_stack, m) coefficients: the per-frame vecs^T y
        return jax.lax.psum(ys_loc @ v_loc, "rows")

    def _v_apply(v_loc, wvs):
        # (nl, m), (n_stack, m) -> (n_stack, nl) local output rows
        return wvs @ v_loc.T

    @jax.jit
    def run(guide2d, stack, idx_a):
        h, w = guide2d.shape
        n = h * w
        p = idx_a.shape[0]
        block = min(cfg.block_cols, n)   # the single-device twin's
                                         # ACTIVE width (preset contract)
        chunk = block * n_rows
        n_pad = _cdiv(n, chunk) * chunk
        ns = n_stack

        # replicated, natural order; chunked write into the padded buffer
        feats_pad = extract_features_padded(guide2d, cfg, n_pad)
        d = feats_pad.shape[1]

        idx = jnp.arange(n_pad)
        valid = (idx < n).astype(jnp.float32)
        a_mask = jnp.zeros(n_pad, jnp.float32).at[idx_a].set(1.0)
        b_mask = valid * (1.0 - a_mask)

        pN, pNd = P("rows"), P("rows", None)
        rep, rep2 = P(), P(None, None)
        sN = P(None, "rows")                          # stack: frames x rows
        # p-class index prims (module note before _gather_p_prim)
        gather_p = smap(_gather_p_prim, (pN, rep), rep)
        gather_p_s = smap(_gather_p_prim, (sN, rep), rep2)
        gather_rows = smap(partial(_gather_rows_prim, axis=0),
                           (pNd, rep), rep2)
        scatter_p = smap(_scatter_p_prim, (pN, rep, rep), pN)
        scatter_p_s = smap(_scatter_p_prim, (sN, rep, rep2), sN)

        feats_a = gather_rows(feats_pad, idx_a)
        kaa = affinity_strip(feats_a, feats_a, dtype)
        kaa_solve = _make_kaa_solve(kaa, cfg.eig_tol, cfg.solver)

        mv = smap(partial(_mv, block=block), (rep2, pNd, pN), rep)
        rmv = smap(partial(_rmv, block=block), (rep2, pNd, rep), pN)
        gramf = smap(partial(_gram, block=block), (rep2, pNd, rep, pN), rep2)
        mat_v = n_pad * cfg.num_eigvecs * 4 <= v_bytes_cap() * n_rows
        if mat_v:
            colstats = smap(partial(_colstats, block=block),
                            (rep2, pNd, rep2, pN, rep, pN), (rep, rep, pNd))
            vtdot = smap(_vt_dot, (pNd, sN), rep2)
            vapply = smap(_v_apply, (pNd, rep2), sN)
        else:
            colstats_nov = smap(partial(_colstats_nov, block=block),
                                (rep2, pNd, rep2, pN, rep, pN), (rep, rep))
            applyf = smap(partial(_apply, block=block),
                          (rep2, pNd, rep2, rep, rep, pN), pN)

        def ktilde_apply(s):
            s_a = gather_p(s, idx_a)
            u = mv(feats_a, feats_pad, s * b_mask)
            top = kaa @ s_a + u
            t = s_a + kaa_solve(u)
            bottom = rmv(feats_a, feats_pad, t) * b_mask
            return scatter_p(bottom, idx_a, top)

        if cfg.normalization == "sinkhorn" and cfg.sinkhorn_coarse > 1:
            # unbatched twin of the batched builder's decimated fixed
            # point (models/streaming.py coarse branch for the rationale)
            k = cfg.sinkhorn_coarse
            if block % k != 0:
                raise ValueError(
                    f"sinkhorn_coarse={k} must divide the active "
                    f"block width min(block_cols, N)={block}")
            # diagonal-offset sample, shard-local take — see the batched
            # builder's coarse branch for the locality argument
            jidx_np = sinkhorn_sample_idx(n_pad, k, w,
                                          cfg.resolved_sinkhorn_sample())
            shard_w = n_pad // n_rows
            jloc = jnp.asarray(jidx_np.reshape(n_rows, -1)
                               - (np.arange(n_rows)[:, None] * shard_w),
                               jnp.int32)
            take_c = smap(lambda f_loc, jl: jnp.take(f_loc, jl[0], axis=0),
                          (pNd, P("rows", None)), pNd)
            feats_c = take_c(feats_pad, jloc)
            mask_c = jnp.take(b_mask, jnp.asarray(jidx_np))
            block_c = block // k
            ratio = jnp.sum(b_mask) / jnp.maximum(jnp.sum(mask_c), 1.0)
            coarse = smap(partial(_coarse, block=block_c),
                          (rep2, pNd, rep, pN), rep)
            mvc = smap(partial(_mv, block=block_c), (rep2, pNd, pN), rep)
            u0 = ratio * mvc(feats_a, feats_c, mask_c)
            r0 = jnp.ones(p, jnp.float32)

            def cbody(_, carry):
                r_a, u_r, *_ = carry
                c_a = 1.0 / jnp.maximum(kaa @ r_a + u_r, _EPS)
                t_r = r_a + kaa_solve(u_r)
                u_c = ratio * coarse(feats_a, feats_c, t_r, mask_c)
                r_a2 = 1.0 / jnp.maximum(kaa @ c_a + u_c, _EPS)
                t_c = c_a + kaa_solve(u_c)
                u_r2 = ratio * coarse(feats_a, feats_c, t_c, mask_c)
                return (r_a2, u_r2, c_a, t_r, t_c)

            zero_p = jnp.zeros(p, jnp.float32)
            r_a, u_r, c_a, t_r, t_c = jax.lax.fori_loop(
                0, cfg.sinkhorn_iters, cbody, (r0, u0, r0, zero_p, zero_p))
            s_a_coarse = jnp.sqrt(jnp.maximum(r_a * c_a, 0.0))
            rmv2 = smap(partial(_rmv2, block=block), (rep2, pNd, rep2),
                        pNd)
            kbt = rmv2(feats_a, feats_pad,
                       jnp.stack([t_r, t_c], axis=1)) * b_mask[:, None]
            prod = jnp.maximum(kbt[:, 0] * kbt[:, 1], _EPS)
            s = jnp.where(b_mask > 0, b_mask / jnp.sqrt(prod), 0.0)
            s = scatter_p(s, idx_a, s_a_coarse)
            if cfg.sinkhorn_polish > 0:
                def pbody(_, sp):
                    ks = jnp.maximum(ktilde_apply(sp), _EPS)
                    return jnp.sqrt(sp / ks) * valid
                s = jax.lax.fori_loop(0, cfg.sinkhorn_polish, pbody,
                                      s * valid)
        elif cfg.normalization == "sinkhorn":
            def body(_, s):
                ks = jnp.maximum(ktilde_apply(s), _EPS)
                return jnp.sqrt(s / ks) * valid
            s = jax.lax.fori_loop(0, cfg.sinkhorn_iters, body,
                                  jnp.ones(n_pad, jnp.float32) * valid)
        elif cfg.normalization == "symmetric":
            s = jax.lax.rsqrt(jnp.maximum(ktilde_apply(valid), _EPS)) * valid
        else:
            s = valid

        ys_pad = jnp.zeros((ns, n_pad), jnp.float32).at[:, :n].set(
            stack.astype(jnp.float32).reshape(ns, n))

        if cfg.operator_filter():
            # per-frame operator apply through the ONE guide-derived
            # operator (the stack is small and static, so the unrolled
            # loop stays a handful of strip-pass programs)
            from ..ops.filters import apply_operator_filter
            wapply = lambda x: s * ktilde_apply(s * x)
            z_full = jnp.stack([
                apply_operator_filter(wapply, ys_pad[f], cfg.filter_name,
                                      cfg.filter_param, cfg.filter_mode,
                                      cfg.cheb_degree)
                for f in range(ns)])
            z = z_full[:, :n].reshape(ns, h, w)
            return jnp.clip(z, 0.0, 1.0), jnp.zeros((0,), jnp.float32)

        s_a = gather_p(s, idx_a)
        s_b_cols = s * b_mask

        waa = kaa * (s_a[:, None] * s_a[None, :])
        if cfg.gram_coarse > 1:
            kg = cfg.gram_coarse
            if block % kg != 0:
                raise ValueError(
                f"gram_coarse={kg} must divide the active block "
                f"width min(block_cols, N)={block}")
            jidx = jnp.asarray(gram_sample_idx(n_pad, kg,
                                               cfg.gram_jitter_seed))
            gramd = smap(partial(_gram_dec, block=block // kg),
                         (rep2, pNd, rep, pN, pN), (rep2, rep))
            g_est, sum_cg2 = gramd(feats_a, feats_pad, s_a, s_b_cols, jidx)
            ratio_g = (jnp.sum(s_b_cols * s_b_cols)
                       / jnp.maximum(sum_cg2, _EPS))
            cross = ratio_g * g_est
        else:
            cross = gramf(feats_a, feats_pad, s_a, s_b_cols)
        m = cfg.num_eigvecs
        if cfg.solver in ("chol", "lobpcg"):
            method = "lobpcg" if cfg.solver == "lobpcg" else "eigh"
            vals_m, basis0 = nystrom_chol_factor(waa, cross, m, cfg.eig_tol,
                                                 method, cfg.lobpcg_iters)
        else:
            whalf = psd_pinv_sqrt(waa, cfg.eig_tol)
            s_mat = waa + whalf @ cross @ whalf
            s_mat = 0.5 * (s_mat + s_mat.T)
            vals, vecs = jnp.linalg.eigh(s_mat)
            vals_m = vals[::-1][:m]
            basis0 = whalf @ (vecs[:, ::-1][:, :m]
                              * trunc_inv_sqrt_vals(vals_m,
                                                    cfg.eig_tol)[None, :])

        v_a = waa @ basis0
        ys_a = gather_p_s(ys_pad, idx_a)              # (ns, p)

        if mat_v:
            # one colstats pass for the y-independent pieces (norms + the
            # materialized V rows; the zero-y coeffs output is discarded),
            # then per-frame coefficients as ONE skinny sharded GEMM —
            # the same vecs^T y the single-device guided path computes
            # (models/streaming.basis_channel_streaming + ops/filters.
            # apply_spectral_filter)
            norms_b, _, v_b = colstats(feats_a, feats_pad, basis0,
                                       jnp.zeros(n_pad, jnp.float32),
                                       s_a, s_b_cols)
            dnorm = jnp.sum(v_a * v_a, axis=0) + norms_b
            live = dnorm > _LIVE_NORM2
            scale = jnp.where(live,
                              1.0 / jnp.sqrt(jnp.where(live, dnorm, 1.0)),
                              0.0)
            coeffs = scale * (ys_a @ v_a + vtdot(v_b, ys_pad))   # (ns, m)
        else:
            norms_b = None
            coeffs_rows = []
            for f in range(ns):
                nb_f, cb_f = colstats_nov(feats_a, feats_pad, basis0,
                                          ys_pad[f], s_a, s_b_cols)
                norms_b = nb_f if norms_b is None else norms_b
                coeffs_rows.append(cb_f)
            dnorm = jnp.sum(v_a * v_a, axis=0) + norms_b
            live = dnorm > _LIVE_NORM2
            scale = jnp.where(live,
                              1.0 / jnp.sqrt(jnp.where(live, dnorm, 1.0)),
                              0.0)
            coeffs = scale * (ys_a @ v_a + jnp.stack(coeffs_rows))

        filt = FILTER_REGISTRY[cfg.filter_name]
        fvals = filt.fn(vals_m, cfg.filter_param)
        g = (fvals - 1.0) if filt.affine else fvals
        wvecs = scale[None, :] * g[None, :] * coeffs  # (ns, m)

        z_a = wvecs @ v_a.T                           # (ns, p)
        if mat_v:
            z_full = vapply(v_b, wvecs)
        else:
            z_full = jnp.stack([
                applyf(feats_a, feats_pad, basis0, wvecs[f], s_a, s_b_cols)
                for f in range(ns)])
        z_full = scatter_p_s(z_full, idx_a, z_a)
        if filt.affine:
            z_full = z_full + ys_pad
        z = z_full[:, :n].reshape(ns, h, w)
        return jnp.clip(z, 0.0, 1.0), vals_m

    return run


def filter_image_streaming_sharded(image: np.ndarray, cfg: PipelineConfig,
                                   plan, mesh):
    """Host entry: one grayscale image through the rows-sharded streaming
    pipeline. Coarse-SINKHORN and strip_cache configs route through the
    batched builder (B=1) — the single-frame builder implements only
    full-res Sinkhorn over the recompute operators."""
    if ((cfg.sinkhorn_coarse > 1 and cfg.normalization == "sinkhorn")
            or cfg.strip_cache):
        if "data" in mesh.shape and mesh.shape["data"] > 1:
            # the batched builder shards frames over 'data'; B=1 cannot
            # split over data>1 (shard_map divisibility error — review
            # finding, reproduced). Re-mesh the SAME devices rows-only:
            # strictly more parallelism for one image anyway.
            from .mesh import make_mesh
            mesh = make_mesh(n_rows=mesh.devices.size, n_data=1,
                             devices=mesh.devices.reshape(-1))
        run = build_streaming_sharded_batch(mesh, cfg)
        z, vals = run(jnp.asarray(image, jnp.float32)[None],
                      jnp.asarray(plan.idx_a))
        z = jax.block_until_ready(z)
        return np.asarray(z)[0], np.asarray(vals)[0]
    run = build_streaming_sharded(mesh, cfg)
    z, vals = run(jnp.asarray(image, jnp.float32), jnp.asarray(plan.idx_a))
    z = jax.block_until_ready(z)
    return np.asarray(z), np.asarray(vals)


def filter_image_multihost(image: np.ndarray, cfg: PipelineConfig,
                           mesh, plan=None):
    """Multi-process single-image entry: ONE image's pixel blocks sharded
    over the ``rows`` axis of a mesh spanning ALL processes' devices — the
    DCN-analogue of the reference running one big image across MPI ranks
    (BASELINE config 4 "v4-8"; SURVEY.md §2.3 TP row).

    Every process passes the SAME full (H, W) image (they all loaded the
    same file); it is placed replicated on the global mesh, the rows-sharded
    streaming jit runs once across all processes (GSPMD inserts the psums
    over ICI/DCN), and the output is allgathered back to every process.
    Requires ``jax.distributed.initialize()`` (scripts/multihost_launch.py)
    and cfg.streaming=True (the only sensible mode at multi-host scale).
    """
    from jax.experimental import multihost_utils
    from jax.sharding import NamedSharding

    if not cfg.streaming:
        raise ValueError("filter_image_multihost requires cfg.streaming=True "
                         "(the dense strip cannot span hosts)")
    image = np.asarray(image, np.float32)
    if image.ndim != 2:
        raise ValueError(f"expected one (H, W) channel, got {image.shape}")
    if plan is None:
        from ..models.pipeline import make_plan
        plan = make_plan(image, cfg)

    replicated = NamedSharding(mesh, P())
    idx_a = jnp.asarray(plan.idx_a)
    # NB: eager reshape/indexing on a non-fully-addressable global array is
    # illegal in multi-controller JAX — build the batch axis host-side and
    # strip it after the allgather instead.
    batched = cfg.sinkhorn_coarse > 1
    if batched:
        gimg = jax.make_array_from_process_local_data(
            replicated, image[None], (1, *image.shape))
        run = build_streaming_sharded_batch(mesh, cfg)
    else:
        gimg = jax.make_array_from_process_local_data(replicated, image,
                                                      image.shape)
        run = build_streaming_sharded(mesh, cfg)
    z, vals = run(gimg, idx_a)
    z = np.asarray(multihost_utils.process_allgather(z, tiled=True))
    vals = np.asarray(multihost_utils.process_allgather(vals, tiled=True))
    return (z[0], vals[0]) if batched else (z, vals)
