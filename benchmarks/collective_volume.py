"""Collective-volume accounting for the sharded streaming paths
(SURVEY.md §2.3 TP row, §5 comm backend).

Design claim to quantify: the rows-sharded streaming pipeline's
collectives carry only p-CLASS payloads (p-vectors, (p, m) factors,
(p, p) grams — never anything N-sized), so communication volume is
INDEPENDENT of image size while per-device work scales as N/R. That is
why rows-sharding should multiply the single-device rate on a real mesh.

Method: lower + compile `build_streaming_sharded` (and the batched
builder) on a virtual 8-device CPU mesh, parse the optimized post-GSPMD
HLO for collective ops (all-reduce / all-gather / reduce-scatter /
collective-permute), sum payload bytes, and emit:

  * per-collective-kind counts and byte volumes (per executed iteration,
    loop bodies counted once — a conservative static view; the dynamic
    volume multiplies loop collectives by trip count);
  * total collective bytes vs per-device FLOPs (from the roofline cost
    model) => bytes/FLOP, and the predicted scaling efficiency
    eta = T_compute(N/R) / (T_compute(N/R) + T_comm) over NVLink-class
    bandwidth (100 GB/s usable per device assumed);
  * the max single collective payload — asserted p-class (no dimension
    beyond ~2 p_pad), the invariant tests/test_collectives.py pins.

Appends a row to benchmarks/results/collective_volume.jsonl.
"""

from __future__ import annotations

import json
import re
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

RESULTS = Path(__file__).parent / "results" / "collective_volume.jsonl"

_DTYPE_BYTES = {"f32": 4, "bf16": 2, "f16": 2, "f64": 8, "s32": 4,
                "u32": 4, "pred": 1, "s8": 1, "u8": 1}

# matches e.g. "f32[4096]{0} all-reduce(" or "(f32[50]{0}, f32[50]{0}) all-reduce("
_COLL_RE = re.compile(
    r"=\s*(\(?[a-z0-9]+\[[^=]*?)\s*(all-reduce|all-gather|reduce-scatter|"
    r"collective-permute)\(")
_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")


def _shape_bytes(shapes_txt: str):
    """Total bytes and max single-dim size across the result shapes."""
    total = 0
    max_dim = 0
    for dt, dims in _SHAPE_RE.findall(shapes_txt):
        nb = _DTYPE_BYTES.get(dt, 4)
        n = 1
        for d in dims.split(","):
            if d.strip():
                n *= int(d)
                max_dim = max(max_dim, int(d))
        total += n * nb
    return total, max_dim


def _loop_computations(hlo_text: str) -> set:
    """Names of computations used as while-loop bodies/conditions."""
    names = set()
    for m in re.finditer(r"(?:body|condition)=%?([\w.\-]+)", hlo_text):
        names.add(m.group(1))
    return names


def collective_stats(hlo_text: str) -> dict:
    """Parse optimized HLO: per-kind {count, bytes}, the max payload, and
    the LOOP-BODY subset (the collectives that execute once per Sinkhorn
    iteration — the ones whose size class actually matters for scaling;
    setup reshards run once)."""
    loops = _loop_computations(hlo_text)
    # map text offset -> enclosing computation name
    comp_spans = []
    for m in re.finditer(
            r"^\s*(?:ENTRY\s+)?%?([\w.\-]+)\s*\(.*\)\s*->\s*.+\{\s*$",
            hlo_text, re.MULTILINE):
        comp_spans.append((m.start(), m.group(1)))
    comp_spans.sort()

    def enclosing(pos):
        name = None
        for s, n in comp_spans:
            if s <= pos:
                name = n
            else:
                break
        return name

    out: dict = {}
    loop_out: dict = {}
    max_payload = 0
    max_dim = 0
    loop_max_dim = 0
    dims = []
    for m in _COLL_RE.finditer(hlo_text):
        shapes, kind = m.group(1), m.group(2)
        b, md = _shape_bytes(shapes)
        rec = out.setdefault(kind, {"count": 0, "bytes": 0})
        rec["count"] += 1
        rec["bytes"] += b
        max_payload = max(max_payload, b)
        max_dim = max(max_dim, md)
        dims.append((b, md))
        if enclosing(m.start()) in loops:
            lrec = loop_out.setdefault(kind, {"count": 0, "bytes": 0})
            lrec["count"] += 1
            lrec["bytes"] += b
            loop_max_dim = max(loop_max_dim, md)
    out["per_op_dims"] = dims          # (bytes, max_dim) per collective
    out["max_single_payload_bytes"] = max_payload
    out["max_single_dim"] = max_dim
    out["total_bytes"] = sum(v["bytes"] for k, v in out.items()
                             if isinstance(v, dict))
    out["loop_body"] = loop_out
    out["loop_body_bytes"] = sum(v["bytes"] for v in loop_out.values())
    out["loop_body_max_dim"] = loop_max_dim
    return out


def sharded_hlo(side=512, n_dev=8, batch=False):
    """Optimized HLO of the rows-sharded streaming step on a virtual mesh."""
    import graphlap as gl
    from graphlap.models.pipeline import make_plan
    from graphlap.parallel.mesh import make_mesh
    from graphlap.parallel.streaming_sharded import (
        build_streaming_sharded, build_streaming_sharded_batch)

    cfg = gl.PipelineConfig(
        kernel="nlm", h=0.15, sample_rho=0.01, sample_cap=4096,
        num_eigvecs=50, sinkhorn_iters=6, sinkhorn_coarse=4,
        sinkhorn_polish=1, gram_coarse=4, filter_name="identity",
        streaming=True, block_cols=side * side // (4 * n_dev))
    img = gl.make_test_image(side, side)
    plan = make_plan(img, cfg)
    if batch:
        mesh = make_mesh(n_rows=n_dev // 2, n_data=2)
        run = build_streaming_sharded_batch(mesh, cfg)
        args = (np.stack([img, img]).astype(np.float32),
                plan.idx_a)
    else:
        mesh = make_mesh(n_rows=n_dev)
        run = build_streaming_sharded(mesh, cfg)
        args = (img.astype(np.float32), plan.idx_a)
    lowered = jax.jit(run).lower(*args)
    compiled = lowered.compile()
    return compiled.as_text(), cfg, plan


def main():
    import graphlap as gl  # noqa: F401  (forces matmul precision pin)
    from graphlap.utils.roofline import streaming_stage_costs

    n_dev = 8
    rows = []
    for batch, side in ((False, 512), (True, 512)):
        hlo, cfg, plan = sharded_hlo(side=side, n_dev=n_dev, batch=batch)
        stats = collective_stats(hlo)
        n, p, d = plan.n, plan.p, 25

        costs = streaming_stage_costs(cfg, n, p, d)
        flops_total = sum(c["mxu_flops"] for c in costs.values())
        flops_dev = flops_total / n_dev

        # dynamic volume: one-time setup/output collectives + loop-body
        # collectives times the iteration count (Sinkhorn + polish — the
        # only loops with collectives inside)
        dyn_mult = cfg.sinkhorn_iters + cfg.sinkhorn_polish
        dyn_bytes = (stats["total_bytes"] - stats["loop_body_bytes"]
                     + stats["loop_body_bytes"] * dyn_mult)

        # NVLink: 450 GB/s each way per H100 (NVIDIA data sheet); the
        # ring all-reduce sees a fraction, so assume 100 GB/s usable
        ici_gbs = 100e9
        # compute: assume a ~100 TFLOP/s effective rate class — the
        # prediction is a RATIO so the exact constant matters little;
        # exp-bound passes scale the same way
        t_comm = dyn_bytes / ici_gbs
        t_comp = flops_dev / 100e12
        eta = t_comp / (t_comp + t_comm)

        # analytic extrapolation to the graded 8 MP shape (p = 4096):
        # p-class payloads scale with (p8/p)^power (vectors ~1, the (p,p)
        # gram dominates at ~2 — use 2, conservative), N-class setup
        # reshards scale with N; per-device compute scales with N/R, so
        # eta climbs toward 1 as N grows
        n8, p8 = 8 * 1024 * 1024, 4096
        costs8 = streaming_stage_costs(cfg, n8, p8, 25)
        flops8 = sum(c["mxu_flops"] for c in costs8.values()) / n_dev
        p_cut = 2 * plan.p + 256
        p_bytes = sum(b for b, md in stats["per_op_dims"] if md <= p_cut)
        n_bytes = stats["total_bytes"] - p_bytes
        dyn8 = (p_bytes * (p8 / plan.p) ** 2 + n_bytes * (n8 / n)
                + stats["loop_body_bytes"] * (p8 / plan.p) * dyn_mult)
        eta8 = (flops8 / 100e12) / (flops8 / 100e12 + dyn8 / ici_gbs
                                    ) if flops8 else None

        row = {
            "builder": "batched" if batch else "single",
            "side": side, "n_dev": n_dev, "p": plan.p,
            "collectives": {k: v for k, v in stats.items()
                            if isinstance(v, dict)},
            "total_static_bytes": stats["total_bytes"],
            "dynamic_bytes_bound": dyn_bytes,
            "max_single_payload_bytes": stats["max_single_payload_bytes"],
            "max_single_dim": stats["max_single_dim"],
            "loop_body": stats["loop_body"],
            "loop_body_bytes": stats["loop_body_bytes"],
            "loop_body_max_dim": stats["loop_body_max_dim"],
            # the scaling-relevant invariant: every PER-ITERATION
            # collective is p-class (one-time setup reshards excluded)
            "p_class_invariant": stats["max_single_dim"] <= 2 * plan.p + 256,
            "loop_p_class_invariant":
                stats["loop_body_max_dim"] <= 2 * plan.p + 256,
            "per_device_mxu_flops": flops_dev,
            "comm_bytes_per_device_flop": dyn_bytes / max(flops_dev, 1),
            "predicted_scaling_eta": round(eta, 4),
            "predicted_eta_at_8mp": round(eta8, 4) if eta8 else None,
            "ts": __import__("time").time(),
        }
        rows.append(row)
        print(json.dumps(row), flush=True)

    RESULTS.parent.mkdir(parents=True, exist_ok=True)
    with RESULTS.open("a") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")


if __name__ == "__main__":
    main()
