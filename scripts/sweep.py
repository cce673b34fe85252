"""Parameter-sweep driver (the reference's experiment shell scripts,
SURVEY.md §2.2 #11): sweep bandwidth/rank/filter over an image and log one
JSONL row per run — the data behind thesis-style quality curves.

    python scripts/sweep.py --image in.png --noise 0.1 \
        --h 0.15 0.25 0.4 --eigvals 20 50 100 --out sweep.jsonl
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import time
from pathlib import Path

import jax

from graphlap.utils.cache import setup_compilation_cache
setup_compilation_cache(Path(__file__).parent.parent)

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--image", default=None, help="input (default: synthetic 256^2)")
    ap.add_argument("--noise", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernel", nargs="+", default=["nlm"])
    ap.add_argument("--h", nargs="+", type=float, default=[0.25])
    ap.add_argument("--sample", nargs="+", type=float, default=[0.02])
    ap.add_argument("--eigvals", nargs="+", type=int, default=[50])
    ap.add_argument("--filter", dest="filters", nargs="+", default=["identity"])
    ap.add_argument("--filter_param", nargs="+", type=float, default=[1.0])
    ap.add_argument("--out", default="benchmarks/results/sweep.jsonl")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
        setup_compilation_cache(Path(__file__).parent.parent, cpu=True)

    import graphlap as gl
    from graphlap.models.pipeline import make_plan
    from graphlap.utils.timing import log_run

    if args.image:
        clean = gl.load_image(args.image, grayscale=True)
    else:
        clean = gl.make_test_image(256, 256, seed=args.seed)
    noisy = np.clip(gl.add_gaussian_noise(clean, args.noise, args.seed), 0, 1)

    grid = itertools.product(args.kernel, args.h, args.sample, args.eigvals,
                             args.filters, args.filter_param)
    for kernel, h, rho, m, filt, fp in grid:
        cfg = gl.PipelineConfig(kernel=kernel, h=h, sample_rho=rho,
                                num_eigvecs=m, filter_name=filt,
                                filter_param=fp)
        plan = make_plan(noisy, cfg)
        gl.filter_image(noisy, cfg, plan=plan)          # warm
        t0 = time.perf_counter()
        res = gl.filter_image(noisy, cfg, plan=plan)
        wall = time.perf_counter() - t0
        rec = {
            "kernel": kernel, "h": h, "sample_rho": rho, "m": m,
            "filter": filt, "filter_param": fp, "p": plan.p,
            "wall_s": round(wall, 4),
            "psnr_noisy_db": round(gl.psnr(clean, noisy), 3),
            "psnr_out_db": round(gl.psnr(clean, res.image), 3),
            "ssim_out": round(gl.ssim(clean, res.image), 4),
        }
        log_run(rec, args.out)
        print(json.dumps(rec))


if __name__ == "__main__":
    main()
