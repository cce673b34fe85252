"""Command-line driver mirroring the reference's option style.

JAX equivalent of the reference's C ``main`` + PETSc options database
(SURVEY.md §2.2 #1, §3.1): single-dash long flags (``-f``, ``-sample``,
``-eigvals``, ``-kernel``, ``-filter``), optional synthetic-noise
experiment mode with PSNR reporting, and ``-log_view`` stage timings.

    python -m graphlap.cli -f in.png -o out.png -kernel nlm -sample 0.02 \
        -eigvals 50 -filter identity -noise 0.1 -log_view

Like PETSc's ``~/.petscrc``, default options are read from ``~/.graphlaprc``
(or the file named by ``-opts_file``): one ``-flag value`` pair per line,
``#`` comments allowed; command-line flags override file defaults.

Flag-name caveat: argparse reserves ``-h`` for help, so the reference's
kernel-bandwidth flag is spelled ``-h_param`` here — the one option name
that cannot be mirrored exactly.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys

import numpy as np

RC_FILE = os.path.expanduser("~/.graphlaprc")


def _read_opts_file(path: str) -> list[str]:
    """PETSc-rc-style option file -> argv prefix (CLI args win: argparse
    takes the LAST occurrence of a flag)."""
    args: list[str] = []
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if line:
                args.extend(line.split())
    return args


def _with_rc_defaults(argv: list[str]) -> list[str]:
    argv = list(argv)
    path = None
    for i, tok in enumerate(argv):
        if tok == "-opts_file":
            if i + 1 >= len(argv):
                raise SystemExit("error: -opts_file expects a path argument")
            path = argv[i + 1]
            del argv[i:i + 2]
            break
        if tok.startswith("-opts_file="):
            path = tok.split("=", 1)[1]
            if not path:
                raise SystemExit("error: -opts_file expects a path argument")
            del argv[i]
            break
    if path is None and os.path.exists(RC_FILE):
        path = RC_FILE
    return (_read_opts_file(path) + argv) if path else argv


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="graphlap",
        description="Global image filtering via the graph Laplacian",
    )
    p.add_argument("-f", dest="input", required=True, help="input image path")
    p.add_argument("-o", dest="output", default=None, help="output image path")
    p.add_argument("-kernel", choices=["gaussian", "nlm"], default="gaussian")
    p.add_argument("-h_param", type=float, default=0.15,
                   help="photometric bandwidth h (image range [0,1])")
    p.add_argument("-spatial_h", type=float, default=0.0,
                   help="bilateral spatial bandwidth in px (0 = off)")
    p.add_argument("-patch", type=int, default=5, help="NLM patch side")
    p.add_argument("-sample", type=float, default=0.01,
                   help="Nystrom sample fraction of pixels")
    p.add_argument("-sample_cap", type=int, default=8192,
                   help="hard cap on sample count p")
    p.add_argument("-sample_mode", choices=["grid", "random"], default="grid",
                   help="'grid' = reference-style spatially uniform; "
                        "'random' = seeded uniform random subset (GLIDE)")
    p.add_argument("-sample_seed", type=int, default=0,
                   help="seed for -sample_mode random")
    p.add_argument("-eigvals", type=int, default=50,
                   help="number of eigenpairs m")
    p.add_argument("-filter", dest="filter_name", default="identity",
                   choices=["identity", "power", "lowpass", "sharpen",
                            "exp_decay", "twicing"])
    p.add_argument("-filter_param", type=float, default=1.0,
                   help="k for power, beta for sharpen, tau for exp_decay")
    p.add_argument("-filter_mode", default="spectral",
                   choices=["spectral", "matvec", "chebyshev"],
                   help="'spectral' = f(lambda) through the rank-m Nystrom "
                        "eigenbasis (reference form); 'matvec' = EXACT f(W) "
                        "by strip matvecs for polynomial filters (identity/"
                        "power/sharpen/twicing with integer k) — skips the "
                        "eigensolve and sidesteps the rank-m subspace "
                        "instability of affine filters (presets auto-pick "
                        "it for sharpen); 'chebyshev' = degree-cheb_degree "
                        "series of f by the matvec recurrence — the "
                        "eigensolve-free path for exp_decay and fractional "
                        "power (NOT recommended for twicing: any operator "
                        "mode kills the residual its add-back needs)")
    p.add_argument("-cheb_degree", type=int, default=12,
                   help="chebyshev mode: series degree = number of strip "
                        "matvecs; 0 = auto (smallest degree with series "
                        "tail bound <= 1e-6)")
    p.add_argument("-rgb_mode", choices=["per_channel", "luma_basis"],
                   default="per_channel",
                   help="'per_channel' = C independent pipelines (reference "
                        "behavior); 'luma_basis' = one eigenbasis from the "
                        "BT.601 luminance graph applied to every channel "
                        "(~C x cheaper guided filtering)")
    p.add_argument("-normalization", default="sinkhorn",
                   choices=["sinkhorn", "symmetric", "none"])
    p.add_argument("-sinkhorn_iters", type=int, default=20)
    p.add_argument("-sinkhorn_coarse", type=int, default=1,
                   help="streaming only: iterate Sinkhorn against every "
                        "k-th column (8 MP-scale accelerator)")
    p.add_argument("-sinkhorn_polish", type=int, default=0,
                   help="full-resolution polish iterations after coarse "
                        "Sinkhorn (contracts decimation bias under the "
                        "parity gate)")
    p.add_argument("-sinkhorn_sample", default="auto",
                   choices=["auto", "diag", "stride"],
                   help="coarse-Sinkhorn column sample on streaming paths: "
                        "auto (measured split: diagonal anti-alias on "
                        "strip_cache, plain stride on recompute), diag, "
                        "or stride")
    p.add_argument("-gram_coarse", type=int, default=1,
                   help="streaming only: estimate the O(Np^2) cross from "
                        "every k-th column (8 MP-scale accelerator)")
    p.add_argument("-preset", default=None,
                   choices=["exact", "fast", "turbo"],
                   help="apply a measured-recipe preset (config.tuned_config)"
                        ": 'exact' = all-f32 parity baseline; 'fast' = "
                        "gate-compliant production recipe (bf16 storage/"
                        "tiles + Pallas + calibrated decimations, <=0.01 dB "
                        "measured); 'turbo' = max single-device speed (~0.3 dB"
                        " documented). Explicit precision/decimation flags "
                        "override the preset")
    p.add_argument("-tune_denoise", action="store_true",
                   help="set the kernel bandwidths from the noise level "
                        "(h = 2 sigma + bilateral for gaussian, 1.5 sigma "
                        "for nlm — the measured quality calibration, "
                        "config.denoise_tuned). sigma = -noise when given, "
                        "else estimated from the image (wavelet-MAD, "
                        "metrics.estimate_noise_sigma). Explicit -h_param/"
                        "-spatial_h flags win")
    p.add_argument("-tune_sure", action="store_true",
                   help="pick the bandwidth h by minimizing Stein's "
                        "unbiased risk estimate over a small grid — no "
                        "clean reference needed (GLIDE's own selection "
                        "rule; divergence computed EXACTLY through the "
                        "whole pipeline by jax.jvp, tune.py). sigma = "
                        "-noise when given, else estimated. Explicit "
                        "-h_param wins; composes with -tune_denoise "
                        "(which also sets spatial_h)")
    p.add_argument("-noise", type=float, default=0.0,
                   help="experiment mode: add Gaussian noise of this std "
                        "before filtering and report PSNR vs the clean input")
    p.add_argument("-seed", type=int, default=0, help="noise seed")
    p.add_argument("-grayscale", action="store_true",
                   help="convert input to grayscale")
    p.add_argument("-bf16", action="store_true",
                   help="bfloat16 affinity GEMMs (faster, small PSNR cost)")
    p.add_argument("-bf16_store", action="store_true",
                   help="f32 affinity math, bf16 strip STORAGE (halves "
                        "Sinkhorn bandwidth at near-zero PSNR cost; dense "
                        "path)")
    p.add_argument("-gram_dtype", default="auto",
                   choices=["auto", "float32", "bfloat16"],
                   help="dense path: dtype of the one-shot cross GEMM only "
                        "(bf16 = large eigensolve speedup, near-zero PSNR "
                        "cost)")
    p.add_argument("-feature_dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="storage dtype of the (N, d) feature tensor — the "
                        "streaming path's capacity ceiling; bf16 halves it "
                        "(~2x larger single-device images) at a measured "
                        "~0.005 dB on bf16 tile recipes. Incompatible with "
                        "-spatial_h")
    p.add_argument("-solver", default="lobpcg",
                   choices=["lobpcg", "chol", "oneshot", "sketch"],
                   help="eigensolver (see docs/ARCHITECTURE.md section 4)")
    p.add_argument("-streaming", action="store_true",
                   help="blockwise recompute path (big images, no K strip)")
    p.add_argument("-block_cols", type=int, default=65536,
                   help="streaming column-block width")
    p.add_argument("-strip_cache", action="store_true",
                   help="streaming: materialize the kernel strip once "
                        "(natural order) instead of recomputing tiles — "
                        "the dense-capacity mode; enables -solver sketch "
                        "on streaming runs")
    p.add_argument("-pallas", action="store_true",
                   help="fused Pallas kernels for the affinity/matvec path")
    p.add_argument("-save_basis", default=None,
                   help="write the eigenbasis to this .npz for filter replay")
    p.add_argument("-load_basis", default=None,
                   help="replay -filter/-filter_param through a saved basis "
                        "(skips sampling/affinity/Sinkhorn/eigensolve; "
                        "O(N m) apply)")
    p.add_argument("-tile", type=int, default=0,
                   help="out-of-core mode: filter in overlapping square "
                        "tiles of this side, Hann-blended — unbounded "
                        "image size (0 = whole image; models/tiled.py)")
    p.add_argument("-tile_overlap", type=int, default=256,
                   help="inter-tile overlap / blend-ramp width in px")
    p.add_argument("-log_view", action="store_true",
                   help="print per-stage wall-clock timings (PETSc-style)")
    p.add_argument("-ds_check", action="store_true",
                   help="print the Sinkhorn doubly-stochastic residual "
                        "||diag(s) K~ s - 1||_inf — the convergence check "
                        "on this run's fixed iteration count (costs one "
                        "extra normalization pass + strip matvec; "
                        "expect <~1e-2 for converged sinkhorn runs)")
    p.add_argument("-trace_dir", default=None,
                   help="write a jax.profiler trace to this directory")
    p.add_argument("-json_log", default=None,
                   help="append a structured JSON run record to this file")
    p.add_argument("-cpu", action="store_true",
                   help="force the CPU backend")
    p.add_argument("-opts_file", default=None,
                   help="option defaults file (PETSc-rc style: one '-flag "
                        "value' per line, # comments); ~/.graphlaprc is "
                        "read automatically; CLI flags override")
    return p


# flag name -> PipelineConfig fields it pins; a preset never overrides a
# field whose flag the user (or the rc file) spelled out
_PRESET_GUARDED_FLAGS = {
    "bf16": ("affinity_dtype",), "bf16_store": ("affinity_dtype",),
    "gram_dtype": ("gram_dtype",), "feature_dtype": ("feature_dtype",),
    "pallas": ("use_pallas",),
    "sinkhorn_iters": ("sinkhorn_iters",),
    "sinkhorn_coarse": ("sinkhorn_coarse",),
    "sinkhorn_polish": ("sinkhorn_polish",), "gram_coarse": ("gram_coarse",),
    "sinkhorn_sample": ("sinkhorn_sample",),
    "strip_cache": ("strip_cache",),
    "solver": ("solver", "sketch_oversample", "sketch_power"),
    "filter_mode": ("filter_mode",),
    # asking for a basis checkpoint IS choosing the spectral form — the
    # preset must not route an affine filter to matvec out from under it
    "save_basis": ("filter_mode",),
    # guarded against -tune_denoise (not presets, which leave them alone)
    "h_param": ("h",), "spatial_h": ("spatial_h",),
}


@functools.lru_cache(maxsize=1)
def _parser_flag_names() -> frozenset:
    """Every option string build_parser defines, bare of dashes — the
    ground truth for how argparse resolves a token (exact match wins over
    abbreviation)."""
    return frozenset(opt.lstrip("-")
                     for action in build_parser()._actions
                     for opt in action.option_strings)


def _explicit_fields(argv: list[str]) -> frozenset:
    """Config fields pinned by flags the user actually typed, so a preset
    never overrides an explicit choice. Tokens are resolved the way
    argparse resolves them: an EXACT flag name pins only its own guarded
    fields (``-filter sharpen`` / ``-f img.png`` must not pin
    filter_mode — that silently disabled the preset's sharpen->matvec
    routing for every real invocation until an end-to-end CLI drive
    caught the eigensolve stage coming back nonzero); a non-exact token
    is an abbreviation and pins every guarded flag it prefixes
    (over-approximating on ambiguity only defers MORE to the user, and
    argparse itself errors on truly ambiguous abbreviations)."""
    fields = set()
    known = _parser_flag_names()
    for tok in argv:
        if not tok.startswith("-"):
            continue
        name = tok.lstrip("-").split("=", 1)[0]
        if not name:
            continue
        if name in known:
            fields.update(_PRESET_GUARDED_FLAGS.get(name, ()))
        else:
            for flag, flds in _PRESET_GUARDED_FLAGS.items():
                if flag.startswith(name):
                    fields.update(flds)
    return frozenset(fields)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    argv = _with_rc_defaults(argv)
    args = build_parser().parse_args(argv)

    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")

    import graphlap as gl
    from graphlap.models.pipeline import make_plan
    from graphlap.utils.timing import log_run, maybe_profile

    cfg = gl.PipelineConfig(
        kernel=args.kernel, h=args.h_param, spatial_h=args.spatial_h,
        patch_size=args.patch, sample_rho=args.sample,
        sample_cap=args.sample_cap, sample_mode=args.sample_mode,
        sample_seed=args.sample_seed, num_eigvecs=args.eigvals,
        normalization=args.normalization, sinkhorn_iters=args.sinkhorn_iters,
        sinkhorn_coarse=args.sinkhorn_coarse,
        sinkhorn_polish=args.sinkhorn_polish,
        sinkhorn_sample=args.sinkhorn_sample, gram_coarse=args.gram_coarse,
        filter_name=args.filter_name, filter_param=args.filter_param,
        filter_mode=args.filter_mode, cheb_degree=args.cheb_degree,
        rgb_mode=args.rgb_mode,
        affinity_dtype=("bfloat16" if args.bf16
                        else "bfloat16_store" if args.bf16_store
                        else "float32"),
        gram_dtype=args.gram_dtype, feature_dtype=args.feature_dtype,
        solver=args.solver, streaming=args.streaming,
        strip_cache=args.strip_cache,
        block_cols=args.block_cols, use_pallas=args.pallas,
    )

    clean = gl.load_image(args.input, grayscale=args.grayscale)
    image = clean
    if args.noise > 0:
        image = np.clip(gl.add_gaussian_noise(clean, args.noise, args.seed), 0, 1)

    if args.tune_denoise:
        from graphlap.config import denoise_tuned
        from graphlap.metrics import estimate_noise_sigma
        sigma = args.noise if args.noise > 0 else estimate_noise_sigma(image)
        cfg = denoise_tuned(cfg, sigma, keep=_explicit_fields(argv))
        print(f"tune_denoise: sigma={sigma:.4f} -> h={cfg.h:.3f} "
              f"spatial_h={cfg.spatial_h:.1f}")

    if args.load_basis:
        from graphlap.utils.checkpoint import filter_with_basis, load_basis
        import time as _time
        basis = load_basis(args.load_basis)
        t0 = _time.perf_counter()
        out = filter_with_basis(image, basis, cfg.filter_name, cfg.filter_param)
        wall = _time.perf_counter() - t0
        print(f"replayed filter={cfg.filter_name}(param={cfg.filter_param}) "
              f"through {args.load_basis} (basis config "
              f"{basis.config_hash}) in {wall:.4f} s")
        if args.noise > 0:
            print(f"PSNR noisy {gl.psnr(clean, image):.3f} dB -> "
                  f"filtered {gl.psnr(clean, out):.3f} dB")
        if args.output:
            gl.save_image(args.output, out)
            print(f"wrote {args.output}")
        return 0

    # -tile: every decision below (preset recipe calibration, the
    # dense-feasibility auto-switch, SURE tuning) must see the PER-TILE
    # problem size, not the full image's — the (N, p) calibration rules
    # behind the parity gate are per-executable, and in tiled mode the
    # executable runs on tile-shaped inputs. A full-image plan here once
    # picked 8 MP-calibrated decimations for 0.26 MP tiles and forced
    # streaming on tile-dense-feasible runs (review finding).
    tiled = args.tile > 0
    if tiled:
        plan_img = image[:min(args.tile, image.shape[0]),
                         :min(args.tile, image.shape[1])]
    else:
        plan_img = image
    plan = make_plan(plan_img, cfg)
    base_cfg = cfg

    def _tuned(c):
        if not args.preset:
            return c
        from graphlap.config import tuned_config
        return tuned_config(c, plan.n, args.preset, keep=_explicit_fields(argv))

    # apply the preset BEFORE the dense-feasibility check, so the check
    # sizes the strip with the dtype the run will actually materialize
    # (e.g. '-preset fast' selects a bfloat16_store strip at HALF the f32
    # footprint — an image that only fits in bf16 must not be pushed onto
    # the slower streaming path by a stale f32 estimate)
    cfg = _tuned(cfg)
    if not cfg.streaming:
        # end-user friendliness: past the single-chip strip bound, switch to
        # the streaming path instead of surfacing the library's ValueError
        from graphlap.models.pipeline import check_dense_feasible
        try:
            check_dense_feasible(cfg, plan)
        except ValueError:
            print(f"note: dense K strip (p={plan.p} x N={plan.n}) exceeds "
                  f"single-chip memory — auto-enabling -streaming")
            # re-derive the preset for the streaming path: its recipe
            # (bf16 tiles + calibrated decimations) differs from the dense one
            cfg = _tuned(base_cfg.replace(streaming=True))
    if args.preset:
        print(f"preset {args.preset}: dtype={cfg.affinity_dtype} "
              f"pallas={cfg.use_pallas} sinkhorn={cfg.sinkhorn_iters}"
              f"x{cfg.sinkhorn_coarse}+p{cfg.sinkhorn_polish} "
              f"gram_coarse={cfg.gram_coarse}")

    # AFTER the preset + dense-feasibility fallback, deliberately: the
    # SURE evaluation runs the pipeline itself, so (a) a dense-infeasible
    # image must have switched to streaming first (tune.sure_risk
    # re-raises the library's strip-size ValueError otherwise), and (b)
    # tuning through the preset's recipe scores the executable the run
    # will actually use. Only cfg.h changes here — nothing above depends
    # on the bandwidth.
    if args.tune_sure:
        if "h" in _explicit_fields(argv):
            print("tune_sure: explicit -h_param wins; skipping")
        else:
            from graphlap.tune import tune_h_sure
            sigma = args.noise if args.noise > 0 else None
            # tiled mode: tune on ONE tile-sized crop (the executable's
            # real shape; the full image may be past the single-chip
            # ceiling — exactly what -tile exists for)
            cfg, rows = tune_h_sure(plan_img, cfg, sigma=sigma)
            best = min(rows, key=lambda r: r.sure)
            where = " (on a tile-sized crop)" if tiled else ""
            print(f"tune_sure: h={cfg.h:.4f}{where} (SURE {best.sure:.6f}, "
                  f"predicted PSNR {best.psnr_pred:.2f} dB) over "
                  f"{[r.h for r in rows]}")
    from graphlap.config import AFFINE_FILTERS
    if (cfg.filter_name in AFFINE_FILTERS and cfg.filter_mode == "spectral"
            and (cfg.affinity_dtype != "float32" or cfg.use_pallas
                 or cfg.gram_coarse > 1 or cfg.sinkhorn_coarse > 1
                 # same failure class: anything that perturbs the p x p
                 # spectrum rotates the ill-posed top-m slice — the bf16
                 # cross GEMM and the randomized (seed-dependent) sketch
                 # solver included
                 or cfg.gram_gemm_dtype() == "bfloat16"
                 or cfg.solver == "sketch")):
        # measured failure class, not a style preference: every accelerated
        # spectral-affine recipe landed 1.8-4.6 dB off the exact trajectory
        # at cfg3 (collapsed-spectrum subspace instability — ARCHITECTURE
        # §5.6); the user asked for this combination explicitly, so run it,
        # but say what the measurements say
        print(f"warning: accelerated recipes with the rank-m SPECTRAL "
              f"{cfg.filter_name} filter are documented-unstable on "
              f"collapsed kernel spectra (whole-dB deviations measured); "
              f"-filter_mode matvec applies the filter exactly without an "
              f"eigensolve", file=sys.stderr)
    n = image.shape[0] * image.shape[1]
    tile_note = (f"  tile={args.tile}+{args.tile_overlap} "
                 f"(p, recipe per tile)" if tiled else "")
    print(f"image {image.shape}  N={n}  p={plan.p}  m={cfg.num_eigvecs}  "
          f"kernel={cfg.kernel}  filter={cfg.filter_name}  "
          f"config={cfg.config_hash()}{tile_note}")

    with maybe_profile(args.trace_dir):
        if args.tile > 0:
            import time as _time
            t0 = _time.perf_counter()
            res = gl.filter_image_tiled(image, cfg, tile=args.tile,
                                        overlap=args.tile_overlap)
            res = res._replace(
                timings={"tiled_total": _time.perf_counter() - t0})
        else:
            res = gl.filter_image_staged(image, cfg, plan=plan)

    record = {
        "input": args.input, "shape": list(image.shape),
        "p": plan.p, "config": cfg.to_dict(),
        "config_hash": cfg.config_hash(),
        "timings_s": res.timings,
        "mp_per_s": (n / 1e6) / max(sum(res.timings.values()), 1e-9),
    }

    if args.noise > 0:
        record["psnr_noisy_db"] = gl.psnr(clean, image)
        record["psnr_filtered_db"] = gl.psnr(clean, res.image)
        record["ssim_filtered"] = gl.ssim(clean, res.image)
        print(f"PSNR noisy {record['psnr_noisy_db']:.3f} dB -> "
              f"filtered {record['psnr_filtered_db']:.3f} dB  "
              f"(SSIM {record['ssim_filtered']:.4f})")

    if args.ds_check:
        if tiled:
            print("note: -ds_check is per-executable and -tile runs one "
                  "per tile — skipping (run a single tile-sized image "
                  "with -ds_check to audit the per-tile recipe)")
        elif cfg.normalization != "sinkhorn":
            print(f"note: -ds_check measures Sinkhorn convergence; "
                  f"normalization={cfg.normalization} is not doubly "
                  f"stochastic — skipping")
        else:
            from graphlap.models.pipeline import sinkhorn_ds_residual
            resid = sinkhorn_ds_residual(image, cfg, plan=plan)
            record["ds_residual_inf"] = resid
            print(f"sinkhorn ds_residual_inf {resid:.3e}  "
                  f"(iters={cfg.sinkhorn_iters} coarse="
                  f"{cfg.sinkhorn_coarse} polish={cfg.sinkhorn_polish})")

    if args.log_view:
        total = sum(res.timings.values())
        print(f"{'stage':<12}{'seconds':>10}{'share':>8}")
        for k, v in res.timings.items():
            print(f"{k:<12}{v:10.4f}{v / max(total, 1e-12):8.1%}")
        print(f"{'total':<12}{total:10.4f}  ({record['mp_per_s']:.3f} MP/s, "
              f"first call includes compile)")

    if args.save_basis:
        from graphlap.utils.checkpoint import save_basis
        from graphlap.models.pipeline import compute_basis
        if tiled:
            # every tile has its OWN basis; there is no single replayable
            # global basis, and computing one would run the full untiled
            # image through the pipeline — the regime -tile exists to avoid
            print("error: -save_basis is per-image, -tile is per-tile — "
                  "run without -tile (or filter tiles via the API and "
                  "save per-tile bases)", file=sys.stderr)
            return 2
        if cfg.operator_filter():
            print("error: -save_basis needs an eigenbasis, but "
                  f"-filter_mode {cfg.filter_mode} never forms one — rerun with "
                  "-filter_mode spectral", file=sys.stderr)
            return 2
        vals, vecs = compute_basis(image, cfg, plan)
        save_basis(args.save_basis, vals, vecs, plan, cfg)
        print(f"eigenbasis saved to {args.save_basis}")

    if args.output:
        gl.save_image(args.output, res.image)
        print(f"wrote {args.output}")

    if args.json_log:
        log_run(record, args.json_log)
    return 0


if __name__ == "__main__":
    sys.exit(main())
