"""Multi-host launch wrapper (BASELINE config 5; SURVEY.md §2.2 #11).

The replacement for the reference's mpiexec/SLURM cluster scripts:
instead of ``mpiexec -n P ./main``, every process runs this script with the
coordinator address, the process count and its own id;
``jax.distributed.initialize`` wires the processes into one JAX process
group, and the (data, rows) mesh spans all their devices.

    # on every process (one per host, or one per GPU of a host):
    python scripts/multihost_launch.py --frames frames.npy --out out.npy \
        --coordinator host0:1234 --num_processes 4 --process_id $ID \
        [--local_device_ids $LOCAL_RANK]

Several processes on ONE host must each own their own card: pass
``--local_device_ids`` (a JAX process reserves most of a card's memory
when it first touches it, so two processes on one card starve each other).

``--frames`` holds the GLOBAL batch; each process slices out and feeds its
own contiguous frame shard, and the shards are stitched into one global
jax.Array (models/video.py::filter_video_multihost) — no replicated copies
cross the DCN. Validated by tests/test_multihost.py as a real 2-process
group on localhost CPU (the cluster-simulation strategy of SURVEY.md §4.3).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


# fields pinned by flags the caller actually typed, so --preset never
# overrides an explicit choice (same contract as the CLI's
# _explicit_fields; without this, --filter_mode spectral --preset fast
# silently became matvec — the single-host CLI honors the pin)
_FLAG_FIELDS = {
    "--dtype": ("affinity_dtype",), "--use_pallas": ("use_pallas",),
    "--sinkhorn_iters": ("sinkhorn_iters",),
    "--sinkhorn_coarse": ("sinkhorn_coarse",),
    "--sinkhorn_polish": ("sinkhorn_polish",),
    "--gram_coarse": ("gram_coarse",),
    "--solver": ("solver", "sketch_oversample", "sketch_power"),
    "--filter_mode": ("filter_mode",),
}


def explicit_keep(argv) -> frozenset:
    typed = {t.split("=", 1)[0] for t in argv if t.startswith("--")}
    fields = set()
    for name in typed:
        if name in _FLAG_FIELDS:
            fields.update(_FLAG_FIELDS[name])
        elif name != "--":
            # argparse resolves unambiguous PREFIXES to the full flag
            # (--filter_mo -> --filter_mode); pin those too, or the
            # abbreviation would silently lose to --preset — the exact
            # bug class the CLI's _explicit_fields abbreviation branch
            # guards against. If argparse accepted the prefix, exactly
            # one parser flag matches it, so a single guarded hit IS
            # that flag.
            hits = [f for f in _FLAG_FIELDS if f.startswith(name)]
            if len(hits) == 1:
                fields.update(_FLAG_FIELDS[hits[0]])
    return frozenset(fields)


def main(argv=None):
    ap = argparse.ArgumentParser()
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--frames", help=".npy of (B, H, W) frames "
                                      "(config 5: frames over 'data')")
    src.add_argument("--image", help=".npy of ONE (H, W) image — its pixel "
                                     "blocks shard over 'rows' across ALL "
                                     "processes (config 4: one big image "
                                     "across the slice)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--coordinator", required=True,
                    help="host:port of process 0")
    ap.add_argument("--num_processes", type=int, required=True)
    ap.add_argument("--process_id", type=int, required=True)
    ap.add_argument("--local_device_ids", default=None,
                    help="comma-separated local device ids this process "
                         "owns (several processes on one host: one card "
                         "each); default: every visible device")
    ap.add_argument("--kernel", default="nlm")
    ap.add_argument("--sample", type=float, default=0.01)
    ap.add_argument("--eigvals", type=int, default=50)
    ap.add_argument("--sinkhorn_iters", type=int, default=20)
    ap.add_argument("--streaming", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="strip-free path (required for 4K-class frames; "
                         "--no-streaming uses the dense sharded pipeline)")
    ap.add_argument("--block_cols", type=int, default=65536)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("float32", "bfloat16", "bfloat16_store"))
    ap.add_argument("--use_pallas", action="store_true",
                    help="fused Pallas matvec kernels (interpret mode on "
                         "the CPU)")
    ap.add_argument("--solver", default="lobpcg",
                    choices=("lobpcg", "chol", "oneshot", "sketch"))
    ap.add_argument("--sinkhorn_coarse", type=int, default=1)
    ap.add_argument("--sinkhorn_polish", type=int, default=0)
    ap.add_argument("--gram_coarse", type=int, default=1)
    ap.add_argument("--filter", dest="filter_name", default="identity",
                    choices=("identity", "power", "lowpass", "sharpen",
                             "exp_decay", "twicing"))
    ap.add_argument("--filter_param", type=float, default=1.0)
    ap.add_argument("--filter_mode", default="spectral",
                    choices=("spectral", "matvec", "chebyshev"),
                    help="'matvec' = exact polynomial f(W) by strip "
                         "matvecs, no eigensolve (the production sharpen "
                         "path; presets pick it for sharpen); 'chebyshev' "
                         "= degree-cheb_degree series for non-polynomial "
                         "f, also eigensolve-free")
    ap.add_argument("--cheb_degree", type=int, default=12,
                    help="chebyshev series degree (0 = auto-pick the "
                         "smallest certified degree)")
    ap.add_argument("--preset", default=None,
                    choices=("exact", "fast", "turbo"),
                    help="derive the measured production recipe from (N, p) "
                         "(config.tuned_config); explicit flags above are "
                         "overridden by it — pass either, not both")
    ap.add_argument("--temporal_guide", type=int, default=1,
                    help="frames mode: groups of k frames share one "
                         "eigenbasis from the group-mean guide, rows "
                         "sharded across ALL processes (streaming only; "
                         "pair with --n_data 1)")
    ap.add_argument("--register_guide", action="store_true",
                    help="phase-align each guided group to its first "
                         "frame (extends reuse ~8x under camera pan)")
    ap.add_argument("--n_data", type=int, default=None,
                    help="mesh data-axis size (default: #processes)")
    ap.add_argument("--cpu_devices", type=int, default=0,
                    help="force N virtual CPU devices per process "
                         "(cluster simulation on localhost)")
    args = ap.parse_args(argv)
    keep = explicit_keep(argv if argv is not None else sys.argv[1:])

    if args.cpu_devices:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.cpu_devices}"
        ).strip()
    import jax
    if args.cpu_devices:
        jax.config.update("jax_platforms", "cpu")
        # cross-process CPU collectives need an explicit implementation
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    local_ids = (None if args.local_device_ids is None else
                 [int(i) for i in args.local_device_ids.split(",")])
    jax.distributed.initialize(
        coordinator_address=args.coordinator,
        num_processes=args.num_processes,
        process_id=args.process_id,
        local_device_ids=local_ids)

    import graphlap as gl
    from graphlap.models.video import filter_video_multihost
    from graphlap.parallel.mesh import make_mesh

    if args.image:
        # config-4 mode: ONE image, rows sharded across every device of
        # every process (n_data=1); all processes load the same file
        cfg = gl.PipelineConfig(kernel=args.kernel, sample_rho=args.sample,
                                num_eigvecs=args.eigvals,
                                sinkhorn_iters=args.sinkhorn_iters,
                                affinity_dtype=args.dtype,
                                streaming=True, block_cols=args.block_cols,
                                use_pallas=args.use_pallas,
                                solver=args.solver,
                                sinkhorn_coarse=args.sinkhorn_coarse,
                                sinkhorn_polish=args.sinkhorn_polish,
                                gram_coarse=args.gram_coarse,
                                filter_name=args.filter_name,
                                filter_param=args.filter_param,
                                filter_mode=args.filter_mode,
                                cheb_degree=args.cheb_degree)
        from graphlap.parallel.streaming_sharded import (
            filter_image_multihost)
        image = np.load(args.image)
        if args.preset:
            cfg = gl.tuned_config(cfg, image.size, args.preset, keep=keep)
        mesh = make_mesh(n_data=1, n_rows=len(jax.devices()))
        out, _ = filter_image_multihost(image, cfg, mesh)
        if jax.process_index() == 0:
            np.save(args.out, out)
            print(f"wrote {args.out} {out.shape}")
        return

    frames = np.load(args.frames)
    nproc = jax.process_count()
    if frames.shape[0] % nproc != 0:
        raise SystemExit(f"frame count {frames.shape[0]} not divisible by "
                         f"{nproc} processes")
    b_local = frames.shape[0] // nproc
    local = frames[jax.process_index() * b_local:
                   (jax.process_index() + 1) * b_local]

    cfg = gl.PipelineConfig(kernel=args.kernel, sample_rho=args.sample,
                            num_eigvecs=args.eigvals,
                            sinkhorn_iters=args.sinkhorn_iters,
                            affinity_dtype=args.dtype,
                            streaming=args.streaming,
                            block_cols=args.block_cols,
                            use_pallas=args.use_pallas,
                            solver=args.solver,
                            sinkhorn_coarse=args.sinkhorn_coarse,
                            sinkhorn_polish=args.sinkhorn_polish,
                            gram_coarse=args.gram_coarse,
                            filter_name=args.filter_name,
                            filter_param=args.filter_param,
                            filter_mode=args.filter_mode,
                            cheb_degree=args.cheb_degree)
    if args.preset:
        cfg = gl.tuned_config(cfg, frames[0].size, args.preset, keep=keep)
    n_data = args.n_data or (1 if args.temporal_guide > 1 else nproc)
    mesh = make_mesh(n_data=n_data,
                     n_rows=len(jax.devices()) // n_data)
    out, _ = filter_video_multihost(local, cfg, mesh,
                                    temporal_guide=args.temporal_guide,
                                    register_guide=args.register_guide)
    if jax.process_index() == 0:
        np.save(args.out, out)
        print(f"wrote {args.out} {out.shape}")


if __name__ == "__main__":
    main()
