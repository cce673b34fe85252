"""Batch / video denoising: frames streamed through the pipeline.

BASELINE config 5 ("16x 4K frames streamed through the pipeline on a
multi-host v4-32 mesh"). The reference is a single-image tool
(SURVEY.md §3.5); this is pure data parallelism over the mesh's ``data``
axis with per-frame independent eigenbases — DCN only at input
distribution, everything else local to each frame's shard group.

Single-process: frames are chunked over the local mesh. Multi-host: call
``jax.distributed.initialize()`` first (scripts/multihost_launch.py), build
the mesh over all devices, and feed each host its local frame shard.
"""

from __future__ import annotations

import warnings

import numpy as np

from ..config import PipelineConfig
from ..utils.sampling import SamplePlan
from ..parallel.mesh import make_mesh
from ..parallel.sharded import build_sharded_pipeline
from .pipeline import make_plan


def estimate_motion(frames: np.ndarray, max_pairs: int = 3) -> float:
    """Median per-frame global displacement (px, full-res units) across up
    to ``max_pairs`` consecutive luma pairs — the routing input for
    ``route_temporal_guide``. Phase correlation (utils/register
    .estimate_shift) on 2x-decimated luma for >=2K frames (the routing
    boundaries are coarse enough that the halved sub-pixel resolution
    doesn't matter; the full-res FFT at 4K is host-side seconds per pair)."""
    from ..utils.register import estimate_shift
    from .pipeline import _luma

    frames = np.asarray(frames, np.float32)
    if frames.ndim == 4:
        frames = np.stack([_luma(f) for f in frames])
    if frames.ndim != 3 or frames.shape[0] < 2:
        return 0.0
    dec = 2 if min(frames.shape[1:3]) >= 1024 else 1
    lum = frames[:, ::dec, ::dec]
    vs = []
    for i in range(min(max_pairs, frames.shape[0] - 1)):
        dy, dx = estimate_shift(lum[i], lum[i + 1])
        vs.append(float(np.hypot(dy, dx)) * dec)
    return float(np.median(vs))


# Measured temporal-guide routing table (benchmarks/motion_guide.py ->
# results/motion_guide.jsonl, 8-frame groups, sigma=0.1): per-frame
# displacement v -> largest group size k that still beats per-frame
# bases. Registered groups hold much longer (the guide is built from the
# aligned stack): by-PSNR optima were 8r at v<=0.25, 4r at 0.5, 2r at
# 1-2, per-frame at 4. The v=1 boundary is deliberately CONSERVATIVE for
# 4r: the production-scale 8x4K pan row measured 4r at -0.075 dB vs
# per-frame even
# though the 64^2 study had it winning — sharper content and sub-pixel
# registration residue eat the margin, so v ~ 1 routes to 2r.
# Unregistered: the k <= 1 + 0.75/v rule (filter_video docstring).
_REGISTERED_K_BY_V = ((0.3, 8), (0.6, 4), (2.0, 2))


def route_temporal_guide(frames: np.ndarray, register: bool = True,
                         k_max: int = 8) -> tuple[int, bool]:
    """(k, register) for ``filter_video(temporal_guide='auto')``: estimate
    the per-frame motion and apply the measured boundaries above. k = 1
    means guided basis reuse LOSES to per-frame bases in this motion
    regime — the caller falls back (with a warning)."""
    b = np.asarray(frames).shape[0]
    v = estimate_motion(frames)
    if register:
        k = 1
        for bound, kk in _REGISTERED_K_BY_V:
            if v <= bound:
                k = kk
                break
    else:
        k = int(1.0 + 0.75 / max(v, 1e-6)) if v > 0 else k_max
    k = max(1, min(k, k_max, b))
    while k > 1 and b % k:      # static group shape: k must tile the batch
        k -= 1
    if k == 1:
        warnings.warn(
            f"temporal_guide='auto': estimated motion {v:.2f} px/frame is "
            f"past the measured guided-reuse boundary "
            f"({'registered' if register else 'unregistered'} groups lose "
            f"to per-frame bases there — benchmarks/results/motion_guide"
            f".jsonl); using per-frame bases", stacklevel=3)
    return k, register and k > 1


def filter_video(frames: np.ndarray, cfg: PipelineConfig,
                 mesh=None, plan: SamplePlan | None = None,
                 frames_per_step: int | None = None,
                 temporal_guide: int | str = 1,
                 register_guide: bool = False):
    """Filter (B, H, W) grayscale frames. Returns (filtered, eigvals).

    All frames share one sampling plan (same geometry); each frame gets its
    own affinity graph and eigenbasis. ``frames_per_step`` bounds per-step
    memory: the batch is processed in chunks of that many frames (each chunk
    one sharded jit step; same compiled executable reused across chunks).

    ``temporal_guide="auto"`` estimates the per-frame motion and routes
    through the measured boundaries (route_temporal_guide): group size
    shrinks as motion grows, and past the regime where basis reuse loses
    to per-frame bases it falls back with a warning.

    ``temporal_guide`` > 1 switches to TEMPORAL BASIS REUSE: frames are
    grouped in runs of that many, each group filtered through ONE shared
    eigenbasis built from the group's MEAN frame (the time-axis analogue
    of rgb_mode='luma_basis' — the same guided-filter machinery). Two
    effects, both in the right direction for near-static scenes: the
    affinity/Sinkhorn/eigensolve stages (the per-frame cost king) run
    once per group instead of once per frame, and the mean guide carries
    sigma/sqrt(k) of the per-frame noise, so the graph is BUILT FROM A
    CLEANER IMAGE than any single frame sees (measured: +0.3-0.5 dB over
    per-frame bases on static scenes, tests/test_video.py). Motion blurs
    the guide — the measured boundary (benchmarks/motion_guide.py) is a
    per-group displacement of ~0.5-1 px: pick k <= 1 + 0.75/v px/frame
    — or set ``register_guide=True``, which phase-correlates each frame
    against the group's first (utils/register.py), builds the guide from
    the REGISTERED mean, filters in registered coordinates, and shifts
    outputs back: pure camera pan then behaves like a static scene
    (the v=1 px/frame case flips from a 3 dB loss to a win; tested).
    """
    frames = np.asarray(frames, np.float32)
    if temporal_guide == "auto":
        # measured motion-regime routing (route_temporal_guide): guided
        # reuse is declined (with a warning) where it loses both axes —
        # the r4 pan row shipped a both-lose configuration by hand
        temporal_guide, register_guide = route_temporal_guide(
            frames, register=register_guide)
    if temporal_guide > 1:
        # the guided path's per-step unit IS the k-frame group (shrink
        # temporal_guide to bound memory) — refuse frames_per_step rather
        # than silently ignoring it. A mesh is honored on the streaming
        # path via the rows-sharded guided builder; dense guided has no
        # sharded builder (small-image territory), so that combination
        # refuses too.
        if frames_per_step is not None:
            raise ValueError(
                "temporal_guide > 1 processes one group per step: "
                "frames_per_step is not supported (shrink temporal_guide "
                "to bound memory, or use per-frame bases)")
        if mesh is not None and not cfg.streaming:
            raise ValueError(
                "temporal_guide with a mesh requires cfg.streaming=True "
                "(the rows-sharded guided builder is strip-free; the "
                "dense guided path runs single-device)")
        return _filter_video_guided(frames, cfg, plan, temporal_guide,
                                    mesh=mesh, register=register_guide)
    if frames.ndim == 4:
        # (B, H, W, C) color video: channels are independent pipelines that
        # share the sampling plan (same geometry), so fold them into the
        # batch axis (B*C gray frames) and unfold after — pure DP, every
        # existing chunking/sharding path reused unchanged
        if cfg.rgb_mode != "per_channel":
            raise ValueError(
                "filter_video supports rgb_mode='per_channel' only (each "
                "channel is an independent frame in the batch); use "
                "filter_image for luma_basis on single images")
        b, h, w, c = frames.shape
        flat = np.moveaxis(frames, -1, 1).reshape(b * c, h, w)
        z, vals = filter_video(flat, cfg, mesh=mesh, plan=plan,
                               frames_per_step=frames_per_step)
        return (np.moveaxis(z.reshape(b, c, h, w), 1, -1),
                vals.reshape(b, c, *vals.shape[1:]))
    if frames.ndim != 3:
        raise ValueError(f"expected (B, H, W) frames, got {frames.shape}")
    b = frames.shape[0]
    if plan is None:
        plan = make_plan(frames[0], cfg)
    if mesh is None:
        mesh = make_mesh()          # all local devices on the rows axis
    n_data = mesh.devices.shape[0]

    if frames_per_step is None:
        frames_per_step = max(n_data, 1)
    step = max((frames_per_step // n_data) * n_data, n_data)

    if not cfg.streaming:
        # same guard as the single-image entries (pipeline.py
        # check_dense_feasible): a 4K frame's dense strip is ~136 GB f32,
        # which dies in an opaque XLA allocation error mid-compile
        from . import pipeline
        limit = pipeline.dense_strip_bytes_limit()
        # the sharded dense builder materializes its strip in f32 always
        # (parallel/sharded.py doesn't thread a storage dtype), so count 4
        # bytes regardless of affinity_dtype — undercounting here brings
        # back the opaque mid-compile XLA allocation death this guard
        # exists to prevent
        per_device = (plan.p * plan.n * 4 * step) / mesh.devices.size
        if per_device > limit:
            raise ValueError(
                f"dense K strips would need {per_device / 1e9:.1f} GB per "
                f"device (p={plan.p}, N={plan.n}, {step} frames/step over "
                f"{mesh.devices.size} devices) — past the "
                f"{limit / 1e9:.1f} GB bound. Use "
                f"cfg.replace(streaming=True) or a smaller frames_per_step.")

    import jax.numpy as jnp
    idx_a = jnp.asarray(plan.idx_a)
    if cfg.streaming:
        # strip-free batched path: frames on 'data', pixel blocks on 'rows'
        # (config 5's real shape — a 4K frame's dense strip is ~136 GB f32,
        # so the dense path below cannot run it at all)
        from ..parallel.streaming_sharded import build_streaming_sharded_batch
        srun = build_streaming_sharded_batch(mesh, cfg)
        run = lambda ch: srun(ch, idx_a)
    else:
        drun = build_sharded_pipeline(mesh, cfg)
        perm = jnp.asarray(plan.perm)
        inv_perm = jnp.asarray(plan.inv_perm)
        run = lambda ch: drun(ch, idx_a, perm, inv_perm)

    # Pipelined chunks: JAX dispatch is async, so keeping a small window
    # of chunks in flight lets chunk i+1's host prep + upload overlap
    # chunk i's device compute instead of serializing
    # upload -> compute -> download per chunk. The window is BOUNDED so peak device memory stays O(window x chunk),
    # not O(total video): each chunk holds its padded input + output live
    # until materialized.
    window = 4
    pending, outs, vals = [], [], []

    def _drain(slot):
        z, v, keep = slot
        outs.append(np.asarray(z)[:keep])
        vals.append(np.asarray(v)[:keep])

    for lo in range(0, b, step):
        chunk = frames[lo:lo + step]
        keep = len(chunk)
        pad = (-keep) % step
        if pad:                      # keep the compiled shape static
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad, 0)])
        z, v = run(jnp.asarray(chunk))
        pending.append((z, v, keep))
        if len(pending) >= window:
            _drain(pending.pop(0))
    for slot in pending:
        _drain(slot)
    return np.concatenate(outs), np.concatenate(vals)


def _filter_video_guided(frames: np.ndarray, cfg: PipelineConfig,
                         plan: SamplePlan | None, k: int, mesh=None,
                         register: bool = False):
    """Temporal basis reuse: groups of ``k`` frames share one eigenbasis
    built from the group-mean frame (filter_video docstring). Rides the
    luma_basis machinery — _filter_channels_luma already implements
    'one basis from a guide, applied to a stack'; here the stack is the
    group's frames (x channels) instead of one frame's channels. Groups
    run sequentially through ONE compiled executable (the last group is
    padded by repeating its final frame, then sliced). With a ``mesh``
    (streaming configs), each group runs through the rows-sharded guided
    builder instead — same factor-once/apply-stack structure, pixel
    blocks sharded over 'rows'."""
    import jax.numpy as jnp

    from .pipeline import (_filter_channels_luma, _luma,
                           check_dense_feasible, make_plan)

    color = frames.ndim == 4
    if not color and frames.ndim != 3:
        raise ValueError(f"expected (B, H, W[, C]) frames, got {frames.shape}")
    if color and cfg.rgb_mode != "per_channel":
        raise ValueError("filter_video supports rgb_mode='per_channel' only "
                         "(temporal_guide already shares the basis across "
                         "the group's channels)")
    b = frames.shape[0]
    h, w = frames.shape[1:3]
    if plan is None:
        plan = make_plan(frames[0], cfg)
    check_dense_feasible(cfg, plan)
    idx_a = jnp.asarray(plan.idx_a)
    perm = jnp.asarray(plan.perm)
    inv_perm = jnp.asarray(plan.inv_perm)
    grun = None
    if mesh is not None:
        from ..parallel.streaming_sharded import build_streaming_sharded_guided
        n_stack = k * (frames.shape[-1] if color else 1)
        grun = build_streaming_sharded_guided(mesh, cfg, n_stack)

    # Pipelined groups with a BOUNDED in-flight window — the same async
    # chunk-dispatch structure as the batched path above:
    # JAX dispatch is async, so group i+1's host prep + upload (and the
    # on-device registration/finish programs) overlap group i's factor +
    # apply compute instead of serializing
    # upload -> compute -> download per group; only the window-evicting
    # np.asarray blocks. Peak device memory stays O(window x group),
    # matching the batched path's policy.
    window = 4
    pending, outs, vals = [], [], []

    def _drain(slot):
        z, v, registered, keep, nch = slot
        z = np.asarray(z)
        if not registered and color:
            z = np.moveaxis(z.reshape(k, nch, h, w), 1, -1)
        outs.append(z[:keep])
        gv = np.asarray(v)           # (m,) spectral / (0,) operator modes
        vals.append(np.broadcast_to(gv, (keep,) + gv.shape))

    for lo in range(0, b, k):
        grp = frames[lo:lo + k]
        keep = len(grp)
        if keep < k:                 # keep the compiled shape static
            grp = np.concatenate([grp, np.repeat(grp[-1:], k - keep, 0)])
        nch = grp.shape[-1] if color else 1
        shifts = None
        if register:
            # align every frame to the group's FIRST (phase correlation
            # on luma): the mean guide is then built from a registered
            # stack, the filter runs in registered coordinates, and each
            # output is shifted back below — camera pan becomes a static
            # scene. Entirely ON DEVICE as one jitted program (traced
            # shifts keep shapes static) — host f64 FFTs + scipy splines
            # here cost far more than the filter itself
            # (utils/register.py module docstring; filter_video docstring)
            from ..utils.register import prepare_registered_group
            y2d, chw, shifts = prepare_registered_group(grp, color)
        else:
            guide = grp.mean(axis=0)  # sigma/sqrt(k) of per-frame noise
            y2d = _luma(guide) if color else guide
            chw = (np.moveaxis(grp, -1, 1).reshape(k * nch, h, w)
                   if color else grp)
            y2d = jnp.asarray(y2d, jnp.float32)
            chw = jnp.asarray(chw, jnp.float32)
        if grun is not None:
            z, v = grun(y2d, chw, idx_a)
        else:
            z, v = _filter_channels_luma(y2d, chw, idx_a, perm, inv_perm,
                                         cfg)
        if shifts is not None:
            # dispatched NOW (async device program) so the un-shift runs
            # back-to-back with the group's apply; the download waits in
            # the window like every other group
            from ..utils.register import finish_registered_group
            z = finish_registered_group(z, shifts, color, nch)
        pending.append((z, v, shifts is not None, keep, nch))
        if len(pending) >= window:
            _drain(pending.pop(0))
    for slot in pending:
        _drain(slot)
    return np.concatenate(outs), np.concatenate(vals)


def _filter_video_guided_multihost(local_frames: np.ndarray,
                                   cfg: PipelineConfig, mesh,
                                   plan: SamplePlan | None, k: int,
                                   register: bool = False):
    """Temporal basis reuse ACROSS PROCESSES: the global batch is
    reassembled on every process (groups span process shard boundaries),
    each group's guide + stack are placed replicated on the global mesh,
    and the rows-sharded guided builder runs once across all processes
    (one factor from the group-mean guide; per-frame sharded apply).
    Returns the GLOBAL (B_global, H, W[, C]) result on every process."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import multihost_utils
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..parallel.streaming_sharded import build_streaming_sharded_guided
    from .pipeline import _luma, make_plan

    if not cfg.streaming:
        raise ValueError("temporal_guide across processes requires "
                         "cfg.streaming=True (the guided builder is "
                         "strip-free)")
    color = local_frames.ndim == 4
    if not color and local_frames.ndim != 3:
        raise ValueError(f"expected (B_local, H, W[, C]) frames, "
                         f"got {local_frames.shape}")
    if color and cfg.rgb_mode != "per_channel":
        raise ValueError("filter_video_multihost supports "
                         "rgb_mode='per_channel' only")
    nproc = jax.process_count()
    b_local = local_frames.shape[0]
    b = b_local * nproc
    lo0 = jax.process_index() * b_local
    h, w = local_frames.shape[1:3]
    if plan is None:
        plan = make_plan(local_frames[0], cfg)
    c = local_frames.shape[-1] if color else 1
    grun = build_streaming_sharded_guided(mesh, cfg, k * c)
    idx_a = jnp.asarray(plan.idx_a)
    rep = NamedSharding(mesh, P())

    def _rep(x):
        x = np.ascontiguousarray(x, np.float32)
        return jax.make_array_from_process_local_data(rep, x, x.shape)

    def _gather_group(g0: int) -> tuple[np.ndarray, int]:
        """Assemble frames [g0, g0+k) from the owning process shards —
        ONE k-frame allgather per group (transient O(nproc * k) frames
        per host), never the full batch: the module's no-replicated-
        copies contract (a group may span shard boundaries, so each
        process contributes its padded intersection and exactly one
        process owns each position)."""
        g1 = min(g0 + k, b)
        sel = np.zeros((k,) + local_frames.shape[1:], np.float32)
        msk = np.zeros((k,), np.float32)
        i0, i1 = max(g0, lo0), min(g1, lo0 + b_local)
        if i1 > i0:
            sel[i0 - g0:i1 - g0] = local_frames[i0 - lo0:i1 - lo0]
            msk[i0 - g0:i1 - g0] = 1.0
        all_sel = np.asarray(multihost_utils.process_allgather(
            sel[None], tiled=True))                    # (nproc, k, ...)
        all_msk = np.asarray(multihost_utils.process_allgather(
            msk[None], tiled=True))
        shape = (nproc, k) + (1,) * (sel.ndim - 1)
        return (all_sel * all_msk.reshape(shape)).sum(0), g1 - g0

    outs, vals = [], []
    for lo in range(0, b, k):
        grp, keep = _gather_group(lo)
        if keep < k:                 # keep the compiled shape static
            grp[keep:] = grp[keep - 1]
        shifts = None
        if register:
            # identical on every process (same gathered group, same
            # deterministic jitted estimator on identical device types)
            # — no extra collective needed. Runs on each process's local
            # devices; outputs come back host-side because _rep feeds
            # make_array_from_process_local_data with per-process numpy
            from ..utils.register import prepare_registered_group
            y2d, chw, shifts = prepare_registered_group(grp, color)
            y2d, chw = np.asarray(y2d), np.asarray(chw)
        else:
            guide = grp.mean(axis=0)
            y2d = _luma(guide) if color else guide
            chw = (np.moveaxis(grp, -1, 1).reshape(k * c, h, w)
                   if color else grp)
        z, v = grun(_rep(y2d), _rep(chw), idx_a)
        z = np.asarray(multihost_utils.process_allgather(z, tiled=True))
        gv = np.asarray(multihost_utils.process_allgather(v, tiled=True))
        if shifts is not None:
            from ..utils.register import finish_registered_group
            z = np.asarray(finish_registered_group(z, shifts, color, c))
        elif color:
            z = np.moveaxis(z.reshape(k, c, h, w), 1, -1)
        outs.append(z[:keep])
        vals.append(np.broadcast_to(gv, (keep,) + gv.shape))
    return np.concatenate(outs), np.concatenate(vals)


def filter_video_multihost(local_frames: np.ndarray, cfg: PipelineConfig,
                           mesh, plan: SamplePlan | None = None,
                           temporal_guide: int = 1,
                           register_guide: bool = False):
    """Multi-process entry (DCN analogue of the reference's MPI launch,
    SURVEY.md §5 comm-backend row): every process passes its LOCAL
    (B_local, H, W) frame shard; the shards are assembled into one global
    jax.Array over the mesh's ``data`` axis
    (``jax.make_array_from_process_local_data`` — never a replicated copy),
    the sharded jit runs once across all processes, and the full output is
    allgathered back to every process.

    Requires ``jax.distributed.initialize()`` to have run (see
    scripts/multihost_launch.py) and the mesh to span all processes'
    devices. B_global = B_local * process_count must be divisible by the
    mesh's data-axis size. Returns (frames (B_global, H, W), vals).

    ``temporal_guide=k`` (streaming configs) switches to temporal basis
    reuse with the group's pixel rows sharded across ALL processes'
    devices (_filter_video_guided_multihost) — groups may span process
    shard boundaries; use a rows-dominant mesh (n_data=1)."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import multihost_utils
    from jax.sharding import NamedSharding, PartitionSpec as P

    local_frames = np.asarray(local_frames, np.float32)
    if temporal_guide > 1:
        return _filter_video_guided_multihost(local_frames, cfg, mesh,
                                              plan, temporal_guide,
                                              register=register_guide)
    if local_frames.ndim == 4:
        # color video: fold channels into the local batch (see filter_video)
        if cfg.rgb_mode != "per_channel":
            raise ValueError("filter_video_multihost supports "
                             "rgb_mode='per_channel' only")
        b, h, w, c = local_frames.shape
        flat = np.moveaxis(local_frames, -1, 1).reshape(b * c, h, w)
        z, vals = filter_video_multihost(flat, cfg, mesh, plan=plan)
        bg = z.shape[0] // c
        return (np.moveaxis(z.reshape(bg, c, h, w), 1, -1),
                vals.reshape(bg, c, *vals.shape[1:]))
    if local_frames.ndim != 3:
        raise ValueError(f"expected (B_local, H, W), got {local_frames.shape}")
    nproc = jax.process_count()
    b_global = local_frames.shape[0] * nproc
    n_data = mesh.devices.shape[0]
    if b_global % n_data != 0:
        raise ValueError(f"B_global={b_global} not divisible by mesh "
                         f"data axis {n_data}")
    if plan is None:
        plan = make_plan(local_frames[0], cfg)   # shape-only: identical on
                                                 # every process by design
    sharding = NamedSharding(mesh, P("data", None, None))
    global_frames = jax.make_array_from_process_local_data(
        sharding, local_frames, (b_global, *local_frames.shape[1:]))

    idx_a = jnp.asarray(plan.idx_a)
    if cfg.streaming:
        from ..parallel.streaming_sharded import build_streaming_sharded_batch
        run = build_streaming_sharded_batch(mesh, cfg)
        z, vals = run(global_frames, idx_a)
    else:
        run = build_sharded_pipeline(mesh, cfg)
        z, vals = run(global_frames, idx_a, jnp.asarray(plan.perm),
                      jnp.asarray(plan.inv_perm))
    z = multihost_utils.process_allgather(z, tiled=True)
    vals = multihost_utils.process_allgather(vals, tiled=True)
    return np.asarray(z), np.asarray(vals)
