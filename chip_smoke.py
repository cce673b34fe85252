"""On-card smoke test: the main path end to end on one GPU.

    python chip_smoke.py           # one card: every phase below
    python chip_smoke.py --four    # only the four-card sharded phase

Phases (one process owns the card; any failure exits non-zero and no
result line is printed):

1. cfg2 — 512^2 gray NLM 5x5 + Sinkhorn (p = 5243): ``gl.filter_image``
   with ``tuned_config(CONFIG2, N, "fast")`` (the strip_cache recipe
   bench.py and __graft_entry__.entry() run) against the "exact" twin of
   the same image: |dPSNR| <= 0.1 dB, denoised PSNR > noisy PSNR, finite.
2. cfg4 — 8 MP (2048x4096, p = 4096) streaming recompute, same procedure.
3. Each hand-written kernel against its plain XLA twin at the widths of
   phases 1-2 (tolerances and precision in utils/kernel_checks.py).
4. ``__graft_entry__.entry()``, jitted and run once.

``--four`` runs, over 4 local cards in this one process, the cfg4 "fast"
recipe rows-sharded on ``make_mesh(n_rows=4)`` and a 4-frame batch through
``build_streaming_sharded_batch`` with ``n_data=4``, each against the same
config on one card: max pixel difference <= 1e-2 and |dPSNR| <= 0.01 dB
(reasons at FOUR_TOL_PX).

The last stdout line is one JSON object:
{"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

GATE_DB = 0.1            # the repo's parity gate vs the exact recipe
# Sharded vs one card. The sharded builders are a second implementation
# of the same estimator (pixel axis padded to the mesh chunk, operators
# vmapped over the local frame batch, psum partial sums): with bf16 tiles
# a single pixel can move by a few 1e-3 while the image-level PSNR agrees
# to ~1e-3 dB — a 1-device mesh against the plain model measured 4.9e-3
# max / 0.0009 dB at cfg4 on an H100.
FOUR_TOL_PX = 1e-2       # max pixel difference
FOUR_TOL_DB = 0.01       # |dPSNR|


def log(phase: str, **kv) -> None:
    print(json.dumps({"phase": phase, **kv}), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def peak_gib() -> float:
    import jax
    return jax.devices()[0].memory_stats()["peak_bytes_in_use"] / 2**30


def noisy_test_image(h: int, w: int, seed: int = 1):
    import numpy as np

    import graphlap as gl
    img = gl.make_test_image(h, w)
    noisy = np.clip(gl.add_gaussian_noise(img, 0.1, seed=seed), 0, 1)
    return img, noisy.astype(np.float32)


def recipe_parity(name: str, base, h: int, w: int) -> dict:
    """"fast" vs "exact" presets of ``base`` through gl.filter_image."""
    import numpy as np

    import graphlap as gl

    img, noisy = noisy_test_image(h, w)
    psnr_noisy = gl.psnr(img, noisy)
    row = {"psnr_noisy_db": psnr_noisy}
    for level in ("fast", "exact"):
        cfg = gl.tuned_config(base, h * w, level)
        plan = gl.make_plan(noisy, cfg)
        t0 = time.perf_counter()
        gl.filter_image(noisy, cfg, plan=plan)           # compile + run
        t1 = time.perf_counter()
        res = gl.filter_image(noisy, cfg, plan=plan)
        t2 = time.perf_counter()
        assert res.image.shape == noisy.shape, res.image.shape
        assert np.isfinite(res.image).all(), f"{name} {level}: NaN/inf"
        row[level] = {"first_call_s": t1 - t0, "wall_s": t2 - t1,
                      "psnr_db": gl.psnr(img, res.image),
                      "config_hash": cfg.config_hash()}
    row["dpsnr_db"] = abs(row["fast"]["psnr_db"] - row["exact"]["psnr_db"])
    row["peak_gib"] = peak_gib()
    log(name, **row)
    assert row["dpsnr_db"] <= GATE_DB, f"{name}: parity {row['dpsnr_db']}"
    for level in ("fast", "exact"):
        assert row[level]["psnr_db"] > psnr_noisy, f"{name} {level}: no gain"
    return row


def kernel_phase() -> None:
    from graphlap.utils import kernel_checks as kc

    rows = kc.cfg4_kernel_checks() + [kc.cfg2_emitter_check()]
    for r in rows:
        log("kernel", **r)
    bad = [r["kernel"] for r in rows if not r["ok"]]
    assert not bad, f"kernels outside tolerance: {bad}"


def entry_phase() -> None:
    import jax
    import numpy as np

    import __graft_entry__ as ge

    t0 = time.perf_counter()
    fwd, args = ge.entry()
    out = jax.block_until_ready(jax.jit(fwd)(*args))
    assert out.shape == args[0].shape, out.shape
    assert np.isfinite(np.asarray(out)).all(), "entry(): NaN/inf"
    log("entry", shape=list(out.shape), wall_s=time.perf_counter() - t0,
        peak_gib=peak_gib())


def four_card_phase(devices, base, h: int, w: int, n_frames: int = 4) -> dict:
    """Rows-sharded image and data-sharded frame batch on ``devices`` (4),
    each against the same "fast" config on the default single device."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import graphlap as gl
    from graphlap.parallel.mesh import make_mesh
    from graphlap.parallel.streaming_sharded import (
        build_streaming_sharded_batch, filter_image_streaming_sharded)

    cfg = gl.tuned_config(base, h * w, "fast")
    img, noisy = noisy_test_image(h, w)
    plan = gl.make_plan(noisy, cfg)
    out = {"config_hash": cfg.config_hash()}

    rows_mesh = make_mesh(n_rows=len(devices), n_data=1, devices=devices)
    z4, _ = filter_image_streaming_sharded(noisy, cfg, plan, rows_mesh)
    t0 = time.perf_counter()
    z4, _ = filter_image_streaming_sharded(noisy, cfg, plan, rows_mesh)
    t_rows = time.perf_counter() - t0
    gl.filter_image(noisy, cfg, plan=plan)
    t0 = time.perf_counter()
    z1 = gl.filter_image(noisy, cfg, plan=plan).image
    t_one = time.perf_counter() - t0
    out["rows"] = {"max_px_diff": float(np.abs(z4 - z1).max()),
                   "dpsnr_db": abs(gl.psnr(img, z4) - gl.psnr(img, z1)),
                   "sharded_wall_s": t_rows, "one_card_wall_s": t_one}

    frames = np.stack([noisy_test_image(h, w, seed=s)[1]
                       for s in range(1, n_frames + 1)])
    data_mesh = make_mesh(n_rows=1, n_data=len(devices), devices=devices)
    run = build_streaming_sharded_batch(data_mesh, cfg)
    idx_a = jnp.asarray(plan.idx_a)
    jax.block_until_ready(run(jnp.asarray(frames), idx_a))
    t0 = time.perf_counter()
    zb = np.asarray(jax.block_until_ready(run(jnp.asarray(frames), idx_a)[0]))
    t_batch = time.perf_counter() - t0
    t0 = time.perf_counter()
    singles = [gl.filter_image(f, cfg, plan=plan).image for f in frames]
    t_seq = time.perf_counter() - t0
    clean = [noisy_test_image(h, w, seed=s)[0]
             for s in range(1, n_frames + 1)]
    out["frames"] = {
        "max_px_diff": float(max(np.abs(zb[i] - singles[i]).max()
                                 for i in range(n_frames))),
        "dpsnr_db": float(max(abs(gl.psnr(clean[i], zb[i])
                                  - gl.psnr(clean[i], singles[i]))
                              for i in range(n_frames))),
        "sharded_wall_s": t_batch, "one_card_sequential_wall_s": t_seq}
    for part in ("rows", "frames"):
        r = out[part]
        assert np.isfinite(r["max_px_diff"]), part
        assert r["max_px_diff"] <= FOUR_TOL_PX, (part, r)
        assert r["dpsnr_db"] <= FOUR_TOL_DB, (part, r)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded phase")
    args = ap.parse_args(argv)

    import jax
    if jax.default_backend() != "gpu":
        sys.exit(f"chip_smoke.py: needs a GPU, JAX found "
                 f"{jax.default_backend()!r}")
    print(card_line(), flush=True)

    import graphlap as gl
    from graphlap.utils.cache import setup_compilation_cache
    setup_compilation_cache(Path(__file__).parent)

    devices = jax.devices()
    t0 = time.perf_counter()
    if args.four:
        assert len(devices) >= 4, f"--four needs 4 cards, found {devices}"
        log("four", **four_card_phase(devices[:4], gl.CONFIG4, 2048, 4096),
            peak_gib=peak_gib())
        count = 4
    else:
        recipe_parity("cfg2", gl.CONFIG2, 512, 512)
        recipe_parity("cfg4", gl.CONFIG4, 2048, 4096)
        kernel_phase()
        entry_phase()
        count = len(devices)
    log("done", total_s=time.perf_counter() - t0, peak_gib=peak_gib())
    dev = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count}}))


if __name__ == "__main__":
    main()
