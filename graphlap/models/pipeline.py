"""End-to-end global graph-Laplacian filter pipeline.

JAX equivalent of the reference's C ``main`` stage orchestration
(SURVEY.md §2.2 component #1, §3.1). Where the reference crosses a PETSc/MPI
process boundary at every stage, here the WHOLE chain

    affinity -> sinkhorn -> nystrom eigh -> spectral filter -> reconstruct

is ONE jitted function: XLA fuses the elementwise work into the GEMMs and the
only host<->device transfers are the image in and the filtered image out
(SURVEY.md §3.1 device-boundary note). RGB runs per channel via ``vmap``
(BASELINE.json config 3) — the batched eigh and GEMMs keep the MXU fed.

A staged variant jits each stage separately for per-stage wall-clock timing
(the graded eigensolve wall-time metric; SURVEY.md §5 tracing row).
"""

from __future__ import annotations

import time
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import PipelineConfig
from ..utils.sampling import SamplePlan, random_sample, uniform_grid_sample
from ..ops.affinity import affinity_blocks
from ..ops.sinkhorn import _make_kaa_solve, normalize_blocks, nystrom_matvec
from ..ops.nystrom import nystrom_eigh, nystrom_eigh_chol
from ..ops.filters import apply_operator_filter, apply_spectral_filter
from ..utils.meminfo import (CHANNEL_STRIPS_FRACTION, DENSE_STRIP_FRACTION,
                             memory_budget)


class FilterResult(NamedTuple):
    image: np.ndarray          # filtered image, clipped to [0, 1]
    eigvals: np.ndarray        # (C?, m) eigenvalues of the filter matrix
    timings: dict              # per-stage seconds (staged mode only)


# ---------------------------------------------------------------------------
# fused single-jit path
# ---------------------------------------------------------------------------

def _solve_basis(waa, wab, cfg: PipelineConfig):
    """Nystrom eigensolve on the scaled blocks — the ONE place the solver
    selection / gram-dtype policy lives (fused, luma, and staged paths all
    route here so a stability-rule change cannot diverge them)."""
    if cfg.solver == "sketch":
        from ..ops.nystrom import nystrom_eigh_sketch
        return nystrom_eigh_sketch(waa, wab, cfg.num_eigvecs, cfg.eig_tol,
                                   cfg.sketch_oversample, cfg.sketch_power)
    if cfg.solver in ("chol", "lobpcg"):
        method = "lobpcg" if cfg.solver == "lobpcg" else "eigh"
        gdt = (jnp.bfloat16 if cfg.gram_gemm_dtype() == "bfloat16"
               else jnp.float32)
        return nystrom_eigh_chol(waa, wab, cfg.num_eigvecs, cfg.eig_tol,
                                 method, gdt, cfg.lobpcg_iters)
    return nystrom_eigh(waa, wab, cfg.num_eigvecs, cfg.eig_tol)


def _filter_channel_impl(img2d: jnp.ndarray, idx_a: jnp.ndarray,
                         perm: jnp.ndarray, inv_perm: jnp.ndarray,
                         cfg: PipelineConfig):
    """One grayscale channel through the full pipeline. Returns (z2d, vals).

    Unjitted — the library calls the jitted ``_filter_channel`` below;
    ``__graft_entry__.entry`` closes over this impl so the driver can jit
    the flagship graph itself."""
    if cfg.streaming:
        from .streaming import filter_channel_streaming
        return filter_channel_streaming(img2d, idx_a, perm, inv_perm, cfg)
    kaa, kab = affinity_blocks(img2d, idx_a, perm, cfg)
    waa, wab, s_a, s_b = normalize_blocks(
        kaa, kab, cfg.normalization, cfg.sinkhorn_iters, cfg.eig_tol,
        cfg.solver, cfg.sinkhorn_coarse, cfg.sinkhorn_polish)
    y_perm = jnp.take(img2d.astype(jnp.float32).ravel(), perm)
    if cfg.operator_filter():
        # eigensolve-free f(W) y via completion matvecs: exact polynomial
        # (matvec) or Chebyshev series (ops/filters.py notes)
        z_perm = apply_operator_filter(_dense_wapply(kaa, kab, s_a, s_b, cfg),
                                       y_perm, cfg.filter_name,
                                       cfg.filter_param, cfg.filter_mode,
                                       cfg.cheb_degree)
        vals = jnp.zeros((0,), jnp.float32)
    else:
        basis = _solve_basis(waa, wab, cfg)
        z_perm = apply_spectral_filter(
            y_perm, basis.vals, basis.vecs, cfg.filter_name, cfg.filter_param)
        vals = basis.vals
    z = jnp.take(z_perm, inv_perm).reshape(img2d.shape)
    return jnp.clip(z, 0.0, 1.0), vals


def _dense_wapply(kaa, kab, s_a, s_b, cfg: PipelineConfig):
    """x -> W x = s * K~(s * x): the scaled completion, with the SAME
    K_AA-ridge solve Sinkhorn iterates on — one completion operator
    everywhere (the streaming twin is ktilde_apply; building the solve from
    the scaled W_AA instead shifts the ridge and measurably diverges the
    two paths). bf16-stored strips ride jnp's mixed-dtype promotion
    (converted per-op, never re-materialized at f32)."""
    solve = _make_kaa_solve(kaa, cfg.eig_tol, cfg.solver)
    p = kaa.shape[0]

    def wapply(x):
        top, bottom = nystrom_matvec(kaa, kab, solve, s_a * x[:p],
                                     s_b * x[p:])
        return jnp.concatenate([s_a * top, s_b * bottom])

    return wapply


_filter_channel = partial(jax.jit, static_argnames=("cfg",))(
    _filter_channel_impl)


@partial(jax.jit, static_argnames=("cfg",))
def _filter_channels(img_chw: jnp.ndarray, idx_a, perm, inv_perm,
                     cfg: PipelineConfig):
    """(C, H, W) -> per-channel independent pipelines, vmapped."""
    return jax.vmap(
        lambda ch: _filter_channel(ch, idx_a, perm, inv_perm, cfg)
    )(img_chw)


@partial(jax.jit, static_argnames=("cfg",))
def _filter_channels_luma(y2d: jnp.ndarray, img_chw: jnp.ndarray, idx_a,
                          perm, inv_perm, cfg: PipelineConfig):
    """rgb_mode='luma_basis': ONE eigenbasis from the luminance graph, the
    spectral filter applied to every channel through it (guided global
    filtering — the affinity/Sinkhorn/eigensolve stages run once instead of
    C times; per-channel cost drops to the O(N m) apply)."""
    if cfg.operator_filter():
        # ONE graph + Sinkhorn from the luma guide, then an operator-mode
        # (matvec/chebyshev) apply per channel — guided filtering without ever
        # forming a basis (cheapest possible luma mode: the per-channel
        # cost is the strip passes of f(W) ch alone)
        if cfg.streaming:
            from .streaming import _normalize_streaming, _strip_ctx
            ctx = _strip_ctx(y2d, idx_a, cfg)
            s = _normalize_streaming(ctx, cfg)
            n, n_pad = ctx.n, ctx.n_pad

            def wapply(x):
                return s * ctx.ktilde_apply(s * x)

            def apply(ch):
                y_pad = jnp.zeros(n_pad, jnp.float32).at[:n].set(
                    ch.astype(jnp.float32).ravel())
                z = apply_operator_filter(wapply, y_pad,
                                          cfg.filter_name, cfg.filter_param,
                                          cfg.filter_mode, cfg.cheb_degree)
                return jnp.clip(z[:n].reshape(ch.shape), 0.0, 1.0)
        else:
            kaa, kab = affinity_blocks(y2d, idx_a, perm, cfg)
            _, _, s_a, s_b = normalize_blocks(
                kaa, kab, cfg.normalization, cfg.sinkhorn_iters, cfg.eig_tol,
                cfg.solver, cfg.sinkhorn_coarse, cfg.sinkhorn_polish)
            wapply = _dense_wapply(kaa, kab, s_a, s_b, cfg)

            def apply(ch):
                y_perm = jnp.take(ch.astype(jnp.float32).ravel(), perm)
                z_perm = apply_operator_filter(
                    wapply, y_perm, cfg.filter_name, cfg.filter_param,
                    cfg.filter_mode, cfg.cheb_degree)
                return jnp.clip(jnp.take(z_perm, inv_perm).reshape(ch.shape),
                                0.0, 1.0)

        return jax.vmap(apply)(img_chw), jnp.zeros((0,), jnp.float32)

    if cfg.streaming:
        from .streaming import basis_channel_streaming
        vals, vecs = basis_channel_streaming(y2d, idx_a, cfg)   # natural order

        def apply(ch):
            z = apply_spectral_filter(ch.astype(jnp.float32).ravel(), vals,
                                      vecs, cfg.filter_name, cfg.filter_param)
            return jnp.clip(z.reshape(ch.shape), 0.0, 1.0)
    else:
        kaa, kab = affinity_blocks(y2d, idx_a, perm, cfg)
        waa, wab, _, _ = normalize_blocks(
            kaa, kab, cfg.normalization, cfg.sinkhorn_iters, cfg.eig_tol,
            cfg.solver, cfg.sinkhorn_coarse, cfg.sinkhorn_polish)
        basis = _solve_basis(waa, wab, cfg)
        vals, vecs = basis.vals, basis.vecs                      # [A; B] order

        def apply(ch):
            y_perm = jnp.take(ch.astype(jnp.float32).ravel(), perm)
            z_perm = apply_spectral_filter(y_perm, vals, vecs,
                                           cfg.filter_name, cfg.filter_param)
            return jnp.clip(jnp.take(z_perm, inv_perm).reshape(ch.shape),
                            0.0, 1.0)

    return jax.vmap(apply)(img_chw), vals


# BT.601 luminance weights for 3-channel input (the luma_basis guide signal)
_LUMA_601 = np.array([0.299, 0.587, 0.114], np.float32)


def _luma(image: np.ndarray) -> np.ndarray:
    """(H, W, C) -> (H, W) guide channel: BT.601 luma for RGB, channel mean
    otherwise."""
    if image.shape[-1] == 3:
        return np.tensordot(image, _LUMA_601, axes=([-1], [0]))
    return image.mean(axis=-1)


def make_plan(image: np.ndarray, cfg: PipelineConfig) -> SamplePlan:
    h, w = image.shape[:2]
    p = cfg.num_samples(h * w)
    if cfg.sample_mode == "random":
        return random_sample(h, w, p, seed=cfg.sample_seed)
    return uniform_grid_sample(h, w, p)


def _plan_device_arrays(plan: SamplePlan):
    """Device-staged (idx_a, perm, inv_perm) for a plan, cached per plan.

    The index arrays are static per plan, but ``jnp.asarray`` re-uploads
    them on every call — 2 x N int32 (64 MB at 8 MP) plus per-transfer
    latency. Deployments reuse one plan across many frames, so staging is
    one-time setup like compilation."""
    return _plan_device(plan, "idx_a", "perm", "inv_perm")


# Module-level cache of staged plan arrays, keyed on id(plan) with a
# weakref finalizer for cleanup. NOT stored on the (frozen) plan itself:
# live jax.Array buffers riding a pickle/deepcopy of the plan — or the
# mutation silently breaking if SamplePlan ever gains slots=True — were
# advisor findings. Entries are additionally keyed on the
# resolved target placement (backend + the jax.default_device override if
# any), so a process that pins jax_platforms after planning (tests, CPU
# baselines) or stages under a default_device context never replays
# buffers from the wrong device.
_PLAN_DEVICE_CACHE: dict = {}


def _device_key() -> tuple:
    dev = jax.config.jax_default_device
    return (jax.default_backend(), None if dev is None else str(dev))


def _plan_device(plan: SamplePlan, *names: str):
    """Lazy per-array flavor of _plan_device_arrays: streaming paths never
    touch perm/inv_perm (natural pixel order), so they stage idx_a alone."""
    import weakref

    key = _device_key()
    cache = _PLAN_DEVICE_CACHE.get(id(plan))
    if cache is None or cache.get("device") != key:
        if cache is None:
            weakref.finalize(plan, _PLAN_DEVICE_CACHE.pop, id(plan), None)
        cache = {"device": key}
        _PLAN_DEVICE_CACHE[id(plan)] = cache
    out = []
    for name in names:
        if name not in cache:
            cache[name] = jnp.asarray(getattr(plan, name))
        out.append(cache[name])
    return out[0] if len(out) == 1 else tuple(out)


def dense_strip_bytes_limit() -> float:
    """Dense-path guard: past this the (p, N) strip cannot fit the device
    and XLA dies with an opaque allocation error mid-compile. Raise an
    actionable error instead (the CLI auto-switches to streaming at the
    same bound)."""
    return memory_budget(DENSE_STRIP_FRACTION)


def check_dense_feasible(cfg: PipelineConfig, plan: SamplePlan) -> None:
    """Raise if the dense (non-streaming) path would materialize a K strip
    beyond dense_strip_bytes_limit(). No-op for streaming configs."""
    if cfg.streaming:
        return
    itemsize = 2 if cfg.affinity_dtype == "bfloat16_store" else 4
    strip = plan.p * plan.n * itemsize
    limit = dense_strip_bytes_limit()
    if strip > limit:
        raise ValueError(
            f"dense K strip would be {strip / 1e9:.1f} GB "
            f"(p={plan.p}, N={plan.n}) — past the "
            f"{limit / 1e9:.1f} GB single-device bound. "
            f"Use cfg.replace(streaming=True) (CLI: -streaming), which "
            f"recomputes K tiles blockwise and needs only O(N*d) memory.")


def filter_image(image: np.ndarray, cfg: PipelineConfig,
                 plan: SamplePlan | None = None,
                 mesh=None) -> FilterResult:
    """Filter a (H, W) or (H, W, C) float [0,1] image. Fused jit path.

    ``mesh`` (streaming configs): pixel rows shard over the mesh's
    ``rows`` axis — grayscale and per-channel RGB route through the
    rows-sharded streaming builders, luma_basis RGB through the guided
    builder (ONE sharded factor from the luma graph, channels applied
    through it). Equivalence-tested vs the single-device paths."""
    image = np.asarray(image)
    if plan is None:
        plan = make_plan(image, cfg)
    check_dense_feasible(cfg, plan)
    if mesh is not None:
        return _filter_image_sharded(image, cfg, plan, mesh)
    if cfg.streaming:
        # streaming kernels run in NATURAL pixel order and never read
        # perm/inv_perm (models/streaming.py header); pass idx_a in their
        # place so the N-sized permutations (2 x 32 MB at 8 MP) are never
        # staged — jit prunes unused args, so only the trace sees them
        idx_a = _plan_device(plan, "idx_a")
        perm = inv_perm = idx_a
    else:
        idx_a, perm, inv_perm = _plan_device_arrays(plan)

    if image.ndim == 2:
        z, vals = _filter_channel(jnp.asarray(image, jnp.float32),
                                  idx_a, perm, inv_perm, cfg)
        # one batched fetch (device_get async-copies all leaves before
        # blocking) — separate np.asarray calls pay transfer latency twice
        out, vals = jax.device_get((z, vals))
        return FilterResult(image=out, eigvals=vals, timings={})

    channels = image.shape[-1]
    if cfg.rgb_mode == "luma_basis":
        # one strip/basis total (not per channel) — the dense guard above
        # already covers it
        chw = jnp.asarray(np.moveaxis(image, -1, 0), jnp.float32)
        y2d = jnp.asarray(_luma(image), jnp.float32)
        z, vals = _filter_channels_luma(y2d, chw, idx_a, perm, inv_perm, cfg)
        z, vals = jax.device_get((z, vals))
        return FilterResult(image=np.moveaxis(z, 0, -1), eigvals=vals,
                            timings={})

    # Channels vmap in parallel only while the per-channel strip fits:
    # C strips of p x N floats must stay under a quarter of the device.
    # Past that, loop channels sequentially (same compiled executable).
    bytes_per_strip = 0 if cfg.streaming else plan.p * plan.n * 4
    if channels * bytes_per_strip <= memory_budget(CHANNEL_STRIPS_FRACTION):
        chw = jnp.asarray(np.moveaxis(image, -1, 0), jnp.float32)
        z, vals = _filter_channels(chw, idx_a, perm, inv_perm, cfg)
        z, vals = jax.device_get((z, vals))
        return FilterResult(image=np.moveaxis(z, 0, -1), eigvals=vals,
                            timings={})

    outs, all_vals = [], []
    for c in range(channels):
        z, vals = _filter_channel(jnp.asarray(image[..., c], jnp.float32),
                                  idx_a, perm, inv_perm, cfg)
        z, vals = jax.device_get((z, vals))
        outs.append(z)
        all_vals.append(vals)
    return FilterResult(image=np.stack(outs, axis=-1),
                        eigvals=np.stack(all_vals), timings={})


def _filter_image_sharded(image: np.ndarray, cfg: PipelineConfig,
                          plan: SamplePlan, mesh) -> FilterResult:
    """filter_image's mesh route (single-controller; for multi-process
    use filter_image_multihost)."""
    from ..parallel.streaming_sharded import (
        build_streaming_sharded_guided,
        filter_image_streaming_sharded,
    )

    if not cfg.streaming:
        raise ValueError(
            "filter_image(mesh=...) requires cfg.streaming=True — the "
            "rows-sharded single-image builders are strip-free (dense "
            "multi-image DP lives in parallel.sharded.filter_frames_"
            "sharded)")
    if image.ndim == 2:
        z, vals = filter_image_streaming_sharded(image, cfg, plan, mesh)
        return FilterResult(image=z, eigvals=vals, timings={})
    channels = image.shape[-1]
    if cfg.rgb_mode == "luma_basis":
        grun = build_streaming_sharded_guided(mesh, cfg, channels)
        chw = jnp.asarray(np.moveaxis(image, -1, 0), jnp.float32)
        y2d = jnp.asarray(_luma(image), jnp.float32)
        z, vals = grun(y2d, chw, jnp.asarray(plan.idx_a))
        out = np.moveaxis(np.asarray(jax.block_until_ready(z)), 0, -1)
        return FilterResult(image=out, eigvals=np.asarray(vals), timings={})
    outs, all_vals = [], []
    for c in range(channels):          # same compiled executable each time
        z, vals = filter_image_streaming_sharded(image[..., c], cfg, plan,
                                                 mesh)
        outs.append(z)
        all_vals.append(vals)
    return FilterResult(image=np.stack(outs, axis=-1),
                        eigvals=np.stack(all_vals), timings={})


# ---------------------------------------------------------------------------
# staged path: separate jits so each stage can be wall-clocked
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("cfg",))
def _stage_affinity(img2d, idx_a, perm, cfg: PipelineConfig):
    return affinity_blocks(img2d, idx_a, perm, cfg)


@partial(jax.jit, static_argnames=("cfg",))
def _stage_normalize(kaa, kab, cfg: PipelineConfig):
    waa, wab, _, _ = normalize_blocks(
        kaa, kab, cfg.normalization, cfg.sinkhorn_iters, cfg.eig_tol,
        cfg.solver, cfg.sinkhorn_coarse, cfg.sinkhorn_polish)
    return waa, wab


@partial(jax.jit, static_argnames=("cfg",))
def _stage_eigh(waa, wab, cfg: PipelineConfig):
    return _solve_basis(waa, wab, cfg)


@partial(jax.jit, static_argnames=("cfg",))
def _stage_normalize_scales(kaa, kab, cfg: PipelineConfig):
    """Staged normalize for matvec mode: the SCALES (not scaled blocks) —
    the matvec apply wants (kaa, kab, s) to share Sinkhorn's K_AA-ridge
    completion (see _dense_wapply)."""
    _, _, s_a, s_b = normalize_blocks(
        kaa, kab, cfg.normalization, cfg.sinkhorn_iters, cfg.eig_tol,
        cfg.solver, cfg.sinkhorn_coarse, cfg.sinkhorn_polish)
    return s_a, s_b


@partial(jax.jit, static_argnames=("cfg",))
def _stage_matvec_filter(img2d, kaa, kab, s_a, s_b, perm, inv_perm,
                         cfg: PipelineConfig):
    """Staged twin of the dense operator-mode apply (no eigensolve stage)."""
    y_perm = jnp.take(img2d.astype(jnp.float32).ravel(), perm)
    z_perm = apply_operator_filter(_dense_wapply(kaa, kab, s_a, s_b, cfg),
                                   y_perm, cfg.filter_name, cfg.filter_param,
                                   cfg.filter_mode, cfg.cheb_degree)
    return jnp.clip(jnp.take(z_perm, inv_perm).reshape(img2d.shape), 0.0, 1.0)


@partial(jax.jit, static_argnames=("cfg",))
def _stage_matvec_filter_multi(img_chw, kaa, kab, s_a, s_b, perm, inv_perm,
                               cfg: PipelineConfig):
    """All channels in ONE jit for the staged luma operator path: the
    shared K_AA factorization inside _dense_wapply is built once and CSE'd
    across the vmapped channels (separate per-channel calls re-ran the
    O(p^3) Cholesky per channel)."""
    wapply = _dense_wapply(kaa, kab, s_a, s_b, cfg)

    def one(ch):
        y_perm = jnp.take(ch.astype(jnp.float32).ravel(), perm)
        z_perm = apply_operator_filter(wapply, y_perm, cfg.filter_name,
                                       cfg.filter_param, cfg.filter_mode,
                                       cfg.cheb_degree)
        return jnp.clip(jnp.take(z_perm, inv_perm).reshape(ch.shape),
                        0.0, 1.0)

    return jax.vmap(one)(img_chw)


@partial(jax.jit, static_argnames=("cfg",))
def _stage_filter(img2d, vals, vecs, perm, inv_perm, cfg: PipelineConfig):
    y_perm = jnp.take(img2d.astype(jnp.float32).ravel(), perm)
    z_perm = apply_spectral_filter(y_perm, vals, vecs,
                                   cfg.filter_name, cfg.filter_param)
    return jnp.clip(jnp.take(z_perm, inv_perm).reshape(img2d.shape), 0.0, 1.0)


def compute_basis(image: np.ndarray, cfg: PipelineConfig,
                  plan: SamplePlan | None = None):
    """Eigenbasis only (no filter): (vals, vecs) as numpy, for checkpointing.

    Shapes: gray -> ((m,), (N, m)); multi-channel -> ((C, m), (C, N, m)).
    Rows of vecs are in permuted [A; B] order (utils/checkpoint.py replays).
    """
    if cfg.operator_filter():
        raise ValueError(
            "compute_basis requires filter_mode='spectral' — matvec mode "
            "never forms an eigenbasis (that is its point); use "
            "cfg.replace(filter_mode='spectral') to checkpoint a basis")
    image = np.asarray(image)
    if plan is None:
        plan = make_plan(image, cfg)
    check_dense_feasible(cfg, plan)
    idx_a = _plan_device(plan, "idx_a")
    if not cfg.streaming:
        perm = _plan_device(plan, "perm")

    if cfg.streaming:
        # strip-free basis (O(N m), never the (p, N) strip the streaming
        # config was chosen to avoid); rows come back in natural order and
        # are permuted here to the checkpoint's [A; B] convention
        from .streaming import basis_channel_streaming

        def one(ch):
            img2d = jnp.asarray(ch, jnp.float32)
            vals, vecs = basis_channel_streaming(img2d, idx_a, cfg)
            return np.asarray(vals), np.asarray(vecs)[np.asarray(plan.perm)]
    else:
        def one(ch):
            img2d = jnp.asarray(ch, jnp.float32)
            kaa, kab = _stage_affinity(img2d, idx_a, perm, cfg)
            waa, wab = _stage_normalize(kaa, kab, cfg)
            basis = _stage_eigh(waa, wab, cfg)
            return np.asarray(basis.vals), np.asarray(basis.vecs)

    if image.ndim == 2:
        return one(image)
    if cfg.rgb_mode == "luma_basis":
        # shared basis from the luminance guide: ((m,), (N, m)) — matches
        # what filter_image applies, and filter_with_basis replays it on
        # every channel
        return one(_luma(image).astype(np.float32))
    vals, vecs = zip(*(one(image[..., c]) for c in range(image.shape[-1])))
    return np.stack(vals), np.stack(vecs)


@partial(jax.jit, static_argnames=("cfg",))
def _ds_residual_dense(img2d, idx_a, perm, cfg: PipelineConfig):
    from ..ops.sinkhorn import ds_residual

    kaa, kab = affinity_blocks(img2d, idx_a, perm, cfg)
    _, _, s_a, s_b = normalize_blocks(
        kaa, kab, cfg.normalization, cfg.sinkhorn_iters, cfg.eig_tol,
        cfg.solver, cfg.sinkhorn_coarse, cfg.sinkhorn_polish)
    return ds_residual(kaa, kab, s_a, s_b, cfg.eig_tol, cfg.solver)


def sinkhorn_ds_residual(image: np.ndarray, cfg: PipelineConfig,
                         plan: SamplePlan | None = None) -> float:
    """Doubly-stochastic residual ||diag(s) K~ s - 1||_inf of the
    normalization this config would run — the OPT-IN convergence
    diagnostic (ops/sinkhorn.ds_residual note: the reference's while-loop
    convergence test, surfaced as a check on this framework's fixed,
    sweep-calibrated iteration counts). Cost: one full pipeline front half
    (affinity + normalization) plus ONE extra strip matvec; off the hot
    path by construction — CLI ``-ds_check``.

    RGB: the max over the channels the pipeline would actually balance
    (the luma guide under rgb_mode='luma_basis'). For non-sinkhorn
    normalizations the number is still the DS residual of the scaled
    operator (symmetric scaling is NOT doubly stochastic; expect O(1))."""
    image = np.asarray(image)
    if plan is None:
        plan = make_plan(image, cfg)
    check_dense_feasible(cfg, plan)
    if image.ndim == 3:
        if cfg.rgb_mode == "luma_basis":
            channels = [_luma(image).astype(np.float32)]
        else:
            channels = [image[..., c] for c in range(image.shape[-1])]
    else:
        channels = [image]
    out = 0.0
    for ch in channels:
        img2d = jnp.asarray(ch, jnp.float32)
        if cfg.streaming:
            from .streaming import ds_residual_streaming
            idx_a = _plan_device(plan, "idx_a")
            out = max(out, float(ds_residual_streaming(img2d, idx_a, cfg)))
        else:
            idx_a, perm, _ = _plan_device_arrays(plan)
            out = max(out, float(_ds_residual_dense(img2d, idx_a, perm, cfg)))
    return out


def _filter_streaming_staged(image: np.ndarray, cfg: PipelineConfig,
                             plan: SamplePlan) -> FilterResult:
    """Streaming path with per-stage walls (the graded eigensolve wall for
    cfg3/4/5-class rows). Three jits per channel: normalization scales
    ("normalize" — the Sinkhorn wall, affinity tiles recomputed inside),
    Nystrom factor ("eigensolve" — gram + p x p solve + colstats), and the
    O(N m) apply ("filter"). The staged split rebuilds the strip context
    per stage, so the FUSED filter_image wall stays the headline; these
    walls are for attribution."""
    from .streaming import (stage_apply_streaming, stage_factor_streaming,
                            stage_matvec_streaming, stage_scales_streaming)

    idx_a = _plan_device(plan, "idx_a")
    h, w = image.shape[:2]
    timings = {k: 0.0 for k in ("normalize", "eigensolve", "filter")}
    channels = [image] if image.ndim == 2 else [
        image[..., c] for c in range(image.shape[-1])]
    outs, all_vals = [], []
    for ch in channels:
        img2d = jnp.asarray(ch, jnp.float32)
        t0 = time.perf_counter()
        s = jax.block_until_ready(stage_scales_streaming(img2d, idx_a, cfg))
        t1 = time.perf_counter()
        if cfg.operator_filter():
            # no eigensolve stage in matvec mode — the filter IS the
            # remaining strip passes
            z, vals = jax.block_until_ready(
                stage_matvec_streaming(img2d, idx_a, s, cfg))
            t2 = t1
            t3 = time.perf_counter()
        else:
            fac = jax.block_until_ready(
                stage_factor_streaming(img2d, idx_a, s, cfg))
            t2 = time.perf_counter()
            z, vals = jax.block_until_ready(
                stage_apply_streaming(fac, idx_a, cfg, h, w))
            t3 = time.perf_counter()
        timings["normalize"] += t1 - t0
        timings["eigensolve"] += t2 - t1
        timings["filter"] += t3 - t2
        outs.append(np.asarray(z))
        all_vals.append(np.asarray(vals))
    out = outs[0] if image.ndim == 2 else np.stack(outs, axis=-1)
    vals = all_vals[0] if image.ndim == 2 else np.stack(all_vals)
    return FilterResult(image=out, eigvals=vals, timings=timings)


def filter_image_staged(image: np.ndarray, cfg: PipelineConfig,
                        plan: SamplePlan | None = None) -> FilterResult:
    """Like filter_image but per-stage timed (one channel at a time).

    Timings use block_until_ready walls (SURVEY.md §5 tracing row); the
    first call per shape includes compile — callers should warm up first
    for steady-state numbers.
    """
    image = np.asarray(image)
    if plan is None:
        plan = make_plan(image, cfg)
    check_dense_feasible(cfg, plan)

    if cfg.streaming:
        if image.ndim == 2 or cfg.rgb_mode == "per_channel":
            return _filter_streaming_staged(image, cfg, plan)
        # luma_basis fuses the shared-basis + per-channel applies into one
        # program; report the end-to-end wall as one entry
        t0 = time.perf_counter()
        res = filter_image(image, cfg, plan=plan)
        wall = time.perf_counter() - t0
        return FilterResult(image=res.image, eigvals=res.eigvals,
                            timings={"pipeline": wall})

    idx_a, perm, inv_perm = _plan_device_arrays(plan)
    timings = {k: 0.0 for k in ("affinity", "normalize", "eigensolve", "filter")}

    if image.ndim == 3 and cfg.rgb_mode == "luma_basis":
        # mirror _filter_channels_luma: stages 1-3 run ONCE on the
        # luminance guide, the filter applies per channel through the
        # shared basis (same output as filter_image, just stage-timed)
        y2d = jnp.asarray(_luma(image), jnp.float32)
        t0 = time.perf_counter()
        kaa, kab = jax.block_until_ready(
            _stage_affinity(y2d, idx_a, perm, cfg))
        t1 = time.perf_counter()
        if cfg.operator_filter():
            s_a, s_b = jax.block_until_ready(
                _stage_normalize_scales(kaa, kab, cfg))
            t2 = time.perf_counter()
            t3 = t2                          # no eigensolve stage
            chw = jnp.asarray(np.moveaxis(image, -1, 0), jnp.float32)
            z = jax.block_until_ready(_stage_matvec_filter_multi(
                chw, kaa, kab, s_a, s_b, perm, inv_perm, cfg))
            outs = [np.asarray(z[c]) for c in range(image.shape[-1])]
            t4 = time.perf_counter()
            vals = np.zeros((0,), np.float32)
        else:
            waa, wab = jax.block_until_ready(_stage_normalize(kaa, kab, cfg))
            t2 = time.perf_counter()
            basis = jax.block_until_ready(_stage_eigh(waa, wab, cfg))
            t3 = time.perf_counter()
            outs = []
            for c in range(image.shape[-1]):
                img2d = jnp.asarray(image[..., c], jnp.float32)
                z = jax.block_until_ready(_stage_filter(
                    img2d, basis.vals, basis.vecs, perm, inv_perm, cfg))
                outs.append(np.asarray(z))
            t4 = time.perf_counter()
            vals = np.asarray(basis.vals)
        timings.update(affinity=t1 - t0, normalize=t2 - t1,
                       eigensolve=t3 - t2, filter=t4 - t3)
        return FilterResult(image=np.stack(outs, axis=-1),
                            eigvals=vals, timings=timings)

    channels = [image] if image.ndim == 2 else [
        image[..., c] for c in range(image.shape[-1])]
    outs, all_vals = [], []

    for ch in channels:
        img2d = jnp.asarray(ch, jnp.float32)
        t0 = time.perf_counter()
        kaa, kab = jax.block_until_ready(_stage_affinity(img2d, idx_a, perm, cfg))
        t1 = time.perf_counter()
        if cfg.operator_filter():
            s_a, s_b = jax.block_until_ready(
                _stage_normalize_scales(kaa, kab, cfg))
            t2 = time.perf_counter()
            t3 = t2                          # no eigensolve stage
            z = jax.block_until_ready(_stage_matvec_filter(
                img2d, kaa, kab, s_a, s_b, perm, inv_perm, cfg))
            vals = np.zeros((0,), np.float32)
        else:
            waa, wab = jax.block_until_ready(_stage_normalize(kaa, kab, cfg))
            t2 = time.perf_counter()
            basis = jax.block_until_ready(_stage_eigh(waa, wab, cfg))
            t3 = time.perf_counter()
            z = jax.block_until_ready(_stage_filter(
                img2d, basis.vals, basis.vecs, perm, inv_perm, cfg))
            vals = np.asarray(basis.vals)
        t4 = time.perf_counter()
        timings["affinity"] += t1 - t0
        timings["normalize"] += t2 - t1
        timings["eigensolve"] += t3 - t2
        timings["filter"] += t4 - t3
        outs.append(np.asarray(z))
        all_vals.append(vals)

    out = outs[0] if image.ndim == 2 else np.stack(outs, axis=-1)
    vals = all_vals[0] if image.ndim == 2 else np.stack(all_vals)
    return FilterResult(image=out, eigvals=vals, timings=timings)
