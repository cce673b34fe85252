"""Oracle parity anchor at the largest CPU-feasible size.

The graded gate (PSNR delta vs the float64 CPU oracle <= 0.1 dB) is proven
in tests at 96-128 px. This script extends the anchor to the largest size
the single-core f64 oracle can run (the oracle gram is O(N p^2) f64 on one
core), comparing against:

  * the f32 streaming path (the parity REFERENCE of the 8 MP recipes) —
    oracle -> f32-streaming at 192^2 plus f32-streaming -> recipe at 8 MP
    (chip_smoke.py's cfg4 phase) is the parity chain;
  * the accelerated recipes (bf16, gram_coarse) at the same size.

    JAX_PLATFORMS=cpu is forced; run anywhere. Appends to
    benchmarks/results/parity_anchor.jsonl.
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))   # tests.oracle
import jax

from graphlap.utils.cache import setup_compilation_cache
setup_compilation_cache(Path(__file__).parent.parent)

import numpy as np

RESULTS = Path(__file__).parent / "results" / "parity_anchor.jsonl"


def main():
    import jax
    jax.config.update("jax_platforms", "cpu")
    setup_compilation_cache(Path(__file__).parent.parent, cpu=True)

    import graphlap as gl
    from graphlap.models.pipeline import make_plan
    from tests.oracle import oracle_filter_image

    side = int(sys.argv[1]) if len(sys.argv) > 1 else 192
    # --operators-only: skip the O(N p^2) f64 identity oracle (15+ min at
    # 384^2) and run just the cheap operator-mode anchors
    ops_only = "--operators-only" in sys.argv
    img = gl.make_test_image(side, side)
    noisy = np.clip(gl.add_gaussian_noise(img, 0.1, seed=1), 0, 1)
    base = gl.PipelineConfig(
        kernel="nlm", h=0.25, sample_rho=0.01, sample_cap=4096,
        num_eigvecs=50, sinkhorn_iters=10, filter_name="identity",
        streaming=True, block_cols=4608 if side % 3 == 0 else 4096)
    plan = make_plan(noisy, base)

    recs = []
    if not ops_only:
        t0 = time.perf_counter()
        orc, _ = oracle_filter_image(noisy, base.replace(streaming=False))
        oracle_wall = time.perf_counter() - t0
        psnr_oracle = gl.psnr(img, orc)

    RESULTS.parent.mkdir(parents=True, exist_ok=True)
    if not ops_only:
        recipes = [
            ("f32_streaming", base),
            ("bf16_streaming", base.replace(affinity_dtype="bfloat16")),
            ("bf16_gc4", base.replace(affinity_dtype="bfloat16",
                                      gram_coarse=4)),
            ("bf16_sc16_gc4", base.replace(affinity_dtype="bfloat16",
                                           sinkhorn_coarse=16, gram_coarse=4)),
            ("bf16_feat_bf16", base.replace(affinity_dtype="bfloat16",
                                            feature_dtype="bfloat16")),
            ("bf16_store_dense", base.replace(streaming=False,
                                              affinity_dtype="bfloat16_store")),
        ]
        recs.append({"recipe": "oracle_f64", "side": side, "p": plan.p,
                     "psnr_out_db": round(psnr_oracle, 4),
                     "wall_s": round(oracle_wall, 1), "ts": time.time()})
        for name, cfg in recipes:
            res = gl.filter_image(noisy, cfg, plan=plan)
            recs.append({
                "recipe": name, "side": side, "p": plan.p,
                "psnr_out_db": round(gl.psnr(img, res.image), 4),
                "dpsnr_vs_oracle_db": round(
                    abs(gl.psnr(img, res.image) - psnr_oracle), 4),
                "psnr_vs_oracle_db": round(gl.psnr(orc, res.image), 2),
                "ts": time.time(),
            })
    # Operator-mode anchors (round 3): the matvec sharpen semantics (cfg3
    # production) and the chebyshev series — each recipe vs ITS OWN f64
    # oracle (different filter modes are different reference outputs).
    # These oracles are CHEAP relative to the identity one (no p x p
    # eigensolve; ~20 dense f64 strip matvecs), so they run at the same
    # ``side`` for free.
    op_cfgs = [
        ("mv_sharpen_f32", base.replace(
            filter_name="sharpen", filter_param=0.15, filter_mode="matvec")),
        ("mv_sharpen_bf16_sc4_p1", base.replace(
            filter_name="sharpen", filter_param=0.15, filter_mode="matvec",
            affinity_dtype="bfloat16", sinkhorn_coarse=4, sinkhorn_iters=6,
            sinkhorn_polish=1)),
        ("cheb_expdecay_f32_d12", base.replace(
            filter_name="exp_decay", filter_param=2.0,
            filter_mode="chebyshev")),
    ]
    for name, cfg in op_cfgs:
        ocfg = cfg.replace(streaming=False, affinity_dtype="float32",
                           sinkhorn_coarse=1, sinkhorn_polish=0,
                           sinkhorn_iters=base.sinkhorn_iters)
        orc2, _ = oracle_filter_image(noisy, ocfg, plan=plan)
        po = gl.psnr(img, orc2)
        res = gl.filter_image(noisy, cfg, plan=plan)
        recs.append({
            "recipe": name, "side": side, "p": plan.p, "anchor": "operator",
            "psnr_out_db": round(gl.psnr(img, res.image), 4),
            "dpsnr_vs_oracle_db": round(
                abs(gl.psnr(img, res.image) - po), 4),
            "psnr_vs_oracle_db": round(gl.psnr(orc2, res.image), 2),
            "ts": time.time(),
        })

    with RESULTS.open("a") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")
            print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()
