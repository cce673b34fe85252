"""Motion sensitivity of temporal basis reuse (temporal_guide).

The guided-video mode builds each group's graph from the group-MEAN
frame. On a static scene the mean has sigma/sqrt(k) of the per-frame
noise (+1.4 dB measured at k=4, tests/test_video.py); under motion the
mean blurs along the trajectory, so the guide's affinities are built
from smeared patches and reuse should start LOSING past some per-group
displacement. This sweep maps that boundary: a synthetic scene
translated v px/frame, filtered at temporal_guide k, PSNR vs the
per-frame-basis baseline (k=1) after registering nothing — the filter
sees the raw moving frames, as a deployment would.

    python benchmarks/motion_guide.py [side] [n_frames]
CPU (persistent cache off — utils/cache.py policy). Appends rows to
benchmarks/results/motion_guide.jsonl.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")

from graphlap.utils.cache import setup_compilation_cache

setup_compilation_cache(Path(__file__).parent.parent, cpu=True)

import numpy as np
from scipy.ndimage import shift as nd_shift

RESULTS = Path(__file__).parent / "results" / "motion_guide.jsonl"

SPEEDS = (0.0, 0.25, 0.5, 1.0, 2.0, 4.0)   # px / frame, diagonal
GUIDES = (1, 2, 4, 8)
SIGMA = 0.1


def moving_scene(side: int, b: int, v: float, seed: int):
    """(clean, noisy) stacks of a scene translating v px/frame along the
    diagonal (sub-pixel via spline interpolation, wrap-free reflect)."""
    import graphlap as gl

    base = gl.make_test_image(side + 2 * int(np.ceil(v * b)) + 8,
                              side + 2 * int(np.ceil(v * b)) + 8)
    rng = np.random.default_rng(seed)
    off = (base.shape[0] - side) // 2
    clean = np.stack([
        nd_shift(base, (-v * t, -v * t), order=3,
                 mode="reflect")[off:off + side, off:off + side]
        for t in range(b)
    ]).astype(np.float32)
    noisy = np.clip(clean + SIGMA * rng.standard_normal(clean.shape),
                    0, 1).astype(np.float32)
    return np.clip(clean, 0, 1), noisy


def main():
    side = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    b = int(sys.argv[2]) if len(sys.argv) > 2 else 8

    import graphlap as gl
    from graphlap.models.video import filter_video

    cfg = gl.PipelineConfig(kernel="gaussian", h=0.2, spatial_h=8.0,
                            sample_rho=0.03, num_eigvecs=24,
                            sinkhorn_iters=10)
    RESULTS.parent.mkdir(parents=True, exist_ok=True)
    print(f"{side}^2, {b} frames, sigma={SIGMA}")
    for v in SPEEDS:
        clean, noisy = moving_scene(side, b, v, seed=3)
        base_psnr = gl.psnr(clean, noisy)
        row = {"kind": "motion_guide", "side": side, "frames": b,
               "sigma": SIGMA, "v_px_per_frame": v,
               "psnr_noisy": round(float(base_psnr), 3), "by_k": {}}
        for k in GUIDES:
            t0 = time.perf_counter()
            z, _ = filter_video(noisy, cfg, temporal_guide=k) \
                if k > 1 else filter_video(noisy, cfg)
            wall = time.perf_counter() - t0
            p = float(gl.psnr(clean, z))
            row["by_k"][str(k)] = round(p, 3)
            print(f"  v={v:4.2f} k={k}: PSNR {p:6.3f} "
                  f"({p - base_psnr:+.2f} dB vs noisy, {wall:.1f} s)")
            if k > 1:
                # registered variant: phase-align the group first —
                # pure pan should recover the static-scene win
                zr, _ = filter_video(noisy, cfg, temporal_guide=k,
                                     register_guide=True)
                pr = float(gl.psnr(clean, zr))
                row["by_k"][f"{k}r"] = round(pr, 3)
                print(f"  v={v:4.2f} k={k} registered: PSNR {pr:6.3f} "
                      f"({pr - base_psnr:+.2f} dB vs noisy)")
        with RESULTS.open("a") as f:
            f.write(json.dumps(row) + "\n")


if __name__ == "__main__":
    main()
