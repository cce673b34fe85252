"""Spectrum structure at the rank-m truncation boundary vs (h, N).

Quantifies the collapsed-spectrum phenomenon behind the spectral-affine
instability (docs/ARCHITECTURE.md §5.6): for each (h, side) the float64
oracle pipeline's scaled completion is eigendecomposed around the m=50
boundary, recording the eigenvalue magnitudes, the absolute gap at the
boundary, and the relative gap (gap / λ_50) — the quantity that governs
how far a perturbation rotates the kept subspace (Davis–Kahan). CPU-only.
Appends to benchmarks/results/spectrum_probe.jsonl.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))
import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

RESULTS = Path(__file__).parent / "results" / "spectrum_probe.jsonl"


def main():
    import graphlap as gl
    from graphlap.ops.nystrom import nystrom_eigh_chol_np
    from graphlap.ops.sinkhorn import normalize_blocks_np
    from graphlap.utils.sampling import uniform_grid_sample
    from tests.oracle import oracle_affinity

    m = 50
    RESULTS.parent.mkdir(parents=True, exist_ok=True)
    for side in (128, 256):
        img = gl.make_test_image(side, side)
        noisy = np.clip(gl.add_gaussian_noise(img, 0.03, seed=3), 0, 1)
        for h in (0.15, 0.25, 0.4, 0.8):
            cfg = gl.CONFIG3.replace(h=h, sample_rho=0.01,
                                     filter_mode="spectral")
            plan = uniform_grid_sample(side, side,
                                       cfg.num_samples(side * side))
            kaa, kab = oracle_affinity(noisy.astype(np.float64), plan, cfg)
            waa, wab, _, _ = normalize_blocks_np(
                kaa, kab, "sinkhorn", 20, cfg.eig_tol, cfg.solver)
            vals, _ = nystrom_eigh_chol_np(waa, wab, 2 * m, cfg.eig_tol)
            lam = np.sort(vals)[::-1]
            gap = float(lam[m - 1] - lam[m])
            rec = {
                "side": side, "h": h, "p": plan.p, "m": m,
                "lam1": round(float(lam[0]), 6),
                "lam_m": round(float(lam[m - 1]), 6),
                "lam_m1": round(float(lam[m]), 6),
                "gap_at_m": float(f"{gap:.3e}"),
                "relgap_at_m": float(f"{gap / max(lam[m - 1], 1e-30):.3e}"),
                "lam10": round(float(lam[9]), 5),
                "ts": time.time(),
            }
            with RESULTS.open("a") as f:
                f.write(json.dumps(rec) + "\n")
            print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
