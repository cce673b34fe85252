"""Output-QUALITY tuning sweep: pick kernel/filter parameters that make the
filter a good denoiser, not just a parity-exact one.

The graded configs fix the pipeline *shape* (kernel family, sample budget,
m) but not the bandwidths or the spectral filter parameters — those the
reference thesis tunes by experiment, and so do we (cfg1's stock recipe
gained +0.09 dB).

Design: the eigenbasis depends only on (kernel, h, spatial_h, sampling) —
NOT on the spectral filter — so each (h, spatial_h) point computes ONE
basis and replays every filter family through it at O(N m)
(utils/checkpoint.filter_with_basis). Appends one JSON row per
(basis, filter) pair to benchmarks/results/quality_sweep.jsonl.

Usage:
    python benchmarks/tune_quality.py cfg1          # 128^2 Gaussian family
    python benchmarks/tune_quality.py cfg1_nlm      # 128^2 NLM comparison
    python benchmarks/tune_quality.py cfg2_small    # 256^2 NLM (CPU-fast h trend)
    python benchmarks/tune_quality.py cfg2 --gpu    # 512^2 NLM validation
    python benchmarks/tune_quality.py sigma         # sigma-sweep at tuned recipes

CPU by default (128^2/256^2 compile+run in seconds there). --gpu for the
real-shape rows on the default GPU backend.
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

RESULTS = Path(__file__).parent / "results" / "quality_sweep.jsonl"

# filter families worth replaying per basis (name, param)
FILTERS = [
    ("identity", 1.0),
    ("power", 2.0), ("power", 3.0), ("power", 5.0),
    ("exp_decay", 1.0), ("exp_decay", 2.0), ("exp_decay", 4.0),
    ("lowpass", 1.0),
    ("twicing", 2.0),
]


def sweep_point(tag, clean, noisy, cfg, m_values=(50,), filters=FILTERS):
    """One (kernel, h, spatial_h) basis; replay every filter through it."""
    import graphlap as gl
    from graphlap.models.pipeline import compute_basis, make_plan
    from graphlap.utils.checkpoint import SavedBasis, filter_with_basis

    plan = make_plan(noisy, cfg)
    t0 = time.perf_counter()
    vals, vecs = compute_basis(noisy, cfg, plan)
    basis_wall = time.perf_counter() - t0
    rows = []
    for m in m_values:
        basis = SavedBasis(vals=vals[..., :m], vecs=vecs[..., :m],
                           perm=plan.perm, inv_perm=plan.inv_perm,
                           height=plan.height, width=plan.width,
                           config_hash=cfg.config_hash())
        for fname, fparam in filters:
            out = filter_with_basis(noisy, basis, fname, fparam)
            rec = {
                "tag": tag, "kernel": cfg.kernel, "h": cfg.h,
                "spatial_h": cfg.spatial_h, "sample_mode": cfg.sample_mode,
                "p": plan.p, "m": m, "filter": fname, "param": fparam,
                "psnr_in": round(gl.psnr(clean, noisy), 3),
                "psnr_out": round(gl.psnr(clean, out), 3),
                "ssim_out": round(gl.ssim(clean, out), 4),
                "basis_wall_s": round(basis_wall, 2),
                "ts": time.time(),
            }
            rec["gain_db"] = round(rec["psnr_out"] - rec["psnr_in"], 3)
            rows.append(rec)
            with RESULTS.open("a") as f:
                f.write(json.dumps(rec) + "\n")
            print(json.dumps(rec))
    return rows


def sweep_cfg1():
    """128^2 Gaussian-kernel family (BASELINE config 1 shape, sigma=0.1)."""
    import graphlap as gl
    clean = gl.make_test_image(128, 128)
    noisy = np.clip(gl.add_gaussian_noise(clean, 0.1, seed=1), 0, 1)
    base = gl.CONFIG1
    for h, sh in itertools.product((0.08, 0.12, 0.18, 0.25, 0.3, 0.45),
                                   (0.0, 4.0, 8.0, 16.0, 32.0)):
        sweep_point("cfg1", clean, noisy, base.replace(h=h, spatial_h=sh))


def sweep_cfg1_nlm():
    """Same 128^2 image through the NLM kernel (config-2 family) — the
    cross-kernel comparison that motivates kernel advice in the docs."""
    import graphlap as gl
    clean = gl.make_test_image(128, 128)
    noisy = np.clip(gl.add_gaussian_noise(clean, 0.1, seed=1), 0, 1)
    base = gl.CONFIG1.replace(kernel="nlm", patch_size=5)
    for h, sh in itertools.product((0.08, 0.12, 0.15, 0.2, 0.3),
                                   (0.0, 8.0, 16.0)):
        sweep_point("cfg1_nlm", clean, noisy, base.replace(h=h, spatial_h=sh))


def sweep_cfg2_small():
    """256^2 NLM h/spatial trend (CPU-feasible stand-in for cfg2)."""
    import graphlap as gl
    clean = gl.make_test_image(256, 256)
    noisy = np.clip(gl.add_gaussian_noise(clean, 0.1, seed=1), 0, 1)
    base = gl.CONFIG2
    for h, sh in itertools.product((0.1, 0.15, 0.2, 0.25, 0.35),
                                   (0.0, 8.0, 16.0, 32.0)):
        sweep_point("cfg2_256", clean, noisy, base.replace(h=h, spatial_h=sh))


def sweep_cfg2():
    """512^2 NLM validation at the real cfg2 shape (run with --gpu)."""
    import graphlap as gl
    clean = gl.make_test_image(512, 512)
    noisy = np.clip(gl.add_gaussian_noise(clean, 0.1, seed=1), 0, 1)
    base = gl.CONFIG2.replace(use_pallas=True, affinity_dtype="bfloat16_store",
                              sinkhorn_iters=10)
    # h grid from the 256^2 CPU trend (small-h lowpass won there) plus the
    # 128^2 sigma-rule candidates (large-h lowpass won THERE) — the
    # lowpass/h interplay is size-dependent, so both ends run at the real
    # cfg2 shape
    for h, sh in [(0.1, 0.0), (0.15, 0.0), (0.2, 0.0), (0.25, 0.0),
                  (0.5, 0.0), (0.15, 32.0)]:
        sweep_point("cfg2_512", clean, noisy, base.replace(h=h, spatial_h=sh))


def sweep_cfg3():
    """Sharpening/enhancement quality (BASELINE config 3 family) at a
    512^2 RGB stand-in: one luma basis, every sharpen/twicing parameter
    replayed through it. 'Quality' for enhancement = faithful detail
    boost: SSIM vs clean, PSNR vs clean, and the gradient-energy ratio vs
    the CLEAN image (>1 = sharper than the original; the noisy input's
    own gradient energy is noise-inflated, so it is a bad yardstick)."""
    import graphlap as gl
    from graphlap.models.pipeline import compute_basis, make_plan
    from graphlap.utils.checkpoint import SavedBasis, filter_with_basis

    clean = gl.make_test_image(512, 512, channels=3)
    noisy = np.clip(gl.add_gaussian_noise(clean, 0.03, seed=3), 0, 1)

    def grad_e(img):
        gx = np.diff(img, axis=0)
        gy = np.diff(img, axis=1)
        return float((gx * gx).sum() + (gy * gy).sum())

    ge_clean = grad_e(clean)
    # basis replay is inherently SPECTRAL mode (CONFIG3 defaults to matvec
    # since round 3 — compute_basis would refuse it)
    base = gl.CONFIG3.replace(rgb_mode="luma_basis", sample_cap=4096,
                              filter_mode="spectral")
    for h in (0.15, 0.25):
        cfg = base.replace(h=h)
        plan = make_plan(noisy, cfg)
        vals, vecs = compute_basis(noisy, cfg, plan)
        basis = SavedBasis(vals=vals, vecs=vecs, perm=plan.perm,
                           inv_perm=plan.inv_perm, height=plan.height,
                           width=plan.width, config_hash=cfg.config_hash())
        for fname, params in (("sharpen", (0.3, 0.6, 1.0, 1.5, 2.5)),
                              ("twicing", (2.0, 3.0, 5.0)),
                              ("identity", (1.0,))):
            for fp in params:
                out = filter_with_basis(noisy, basis, fname, fp)
                rec = {
                    "tag": "cfg3_512_sharpen", "kernel": cfg.kernel,
                    "h": h, "filter": fname, "param": fp, "p": plan.p,
                    "psnr_in": round(gl.psnr(clean, noisy), 3),
                    "psnr_out": round(gl.psnr(clean, out), 3),
                    "ssim_in": round(gl.ssim(clean, noisy), 4),
                    "ssim_out": round(gl.ssim(clean, out), 4),
                    "grad_ratio_vs_clean": round(grad_e(out) / ge_clean, 4),
                    "ts": time.time(),
                }
                with RESULTS.open("a") as f:
                    f.write(json.dumps(rec) + "\n")
                print(json.dumps(rec))


def sweep_sigma():
    """Noise-level sweep at the tuned recipes: calibrates the h(sigma) rule
    (config.denoise_tuned). Images at sigma in {0.05, 0.1, 0.2}."""
    import graphlap as gl
    clean = gl.make_test_image(128, 128)
    for sigma in (0.05, 0.1, 0.15, 0.2):
        noisy = np.clip(gl.add_gaussian_noise(clean, sigma, seed=1), 0, 1)
        for kernel in ("gaussian", "nlm"):
            base = (gl.CONFIG1 if kernel == "gaussian"
                    else gl.CONFIG1.replace(kernel="nlm", patch_size=5))
            for hmul in (1.0, 1.5, 2.0, 2.6, 3.5, 5.0):
                for sh in ((8.0, 16.0) if kernel == "gaussian" else (0.0,)):
                    sweep_point(f"sigma_{sigma}", clean, noisy,
                                base.replace(h=hmul * sigma, spatial_h=sh))


def sweep_cfg3_matvec():
    """Sharpen/twicing calibration for filter_mode="matvec" (the round-3
    production cfg3 path): the EXACT polynomial operator boosts the full
    spectrum, not a rank-50 slice, so the spectral-mode beta=0.6 over-
    sharpens (grad ratio 2.43 vs the 1.38 target at 1024^2 —
    matrix.jsonl). Since every candidate is a polynomial in W, one run
    each of W y, W^2 y, W^3 y per (h) point lets every (filter, param)
    compose HOST-side exactly: sharpen beta = (1+b) y - b W y; twicing
    k=2: 2 W y - W^2 y; k=3: 3 W y - 3 W^2 y + W^3 y. 512^2 RGB with the
    production streaming recipe; validate the winner at 1024^2 via
    benchmarks/run.py 3."""
    import graphlap as gl

    clean = gl.make_test_image(512, 512, channels=3)
    noisy = np.clip(gl.add_gaussian_noise(clean, 0.03, seed=3), 0, 1)

    def grad_e(img):
        gx = np.diff(img, axis=0)
        gy = np.diff(img, axis=1)
        return float((gx * gx).sum() + (gy * gy).sum())

    ge_clean = grad_e(clean)
    base = gl.CONFIG3.replace(rgb_mode="luma_basis", sample_cap=4096,
                              streaming=True, block_cols=65536,
                              affinity_dtype="bfloat16", sinkhorn_iters=10)

    def emit(h, fname, fp, out):
        rec = {
            "tag": "cfg3_matvec_sharpen", "kernel": base.kernel,
            "h": h, "filter": fname, "param": fp, "mode": "matvec",
            "psnr_in": round(gl.psnr(clean, noisy), 3),
            "psnr_out": round(gl.psnr(clean, out), 3),
            "ssim_in": round(gl.ssim(clean, noisy), 4),
            "ssim_out": round(gl.ssim(clean, out), 4),
            "grad_ratio_vs_clean": round(grad_e(out) / ge_clean, 4),
            "ts": time.time(),
        }
        with RESULTS.open("a") as f:
            f.write(json.dumps(rec) + "\n")
        print(json.dumps(rec), flush=True)

    for h in (0.15, 0.25, 0.4):
        cfg = base.replace(h=h)
        wy = {k: gl.filter_image(noisy, cfg.replace(
            filter_name="power", filter_param=float(k))).image
            for k in (1, 2, 3)}
        emit(h, "identity", 1.0, wy[1])
        for beta in (0.15, 0.25, 0.4, 0.6, 1.0):
            emit(h, "sharpen", beta,
                 np.clip((1 + beta) * noisy - beta * wy[1], 0, 1))
        emit(h, "twicing", 2.0, np.clip(2 * wy[1] - wy[2], 0, 1))
        emit(h, "twicing", 3.0,
             np.clip(3 * wy[1] - 3 * wy[2] + wy[3], 0, 1))


def sweep_expdecay_modes():
    """exp_decay SPECTRAL vs CHEBYSHEV as denoisers (mode semantics A/B):
    the rank-m spectral form truncates to the top-m eigvecs (discards the
    noisy residual — the denoise behavior); the chebyshev series applies
    the FULL low-rank operator, whose f(0)=e^-tau floor passes a residual
    fraction. Documents which mode to reach for per task."""
    import graphlap as gl

    clean = gl.make_test_image(128, 128)
    noisy = np.clip(gl.add_gaussian_noise(clean, 0.1, seed=1), 0, 1)
    base = gl.CONFIG2.replace(h=0.15)
    for tau in (1.0, 2.0, 4.0):
        for mode in ("spectral", "chebyshev"):
            cfg = base.replace(filter_name="exp_decay", filter_param=tau,
                               filter_mode=mode)
            out = gl.filter_image(noisy, cfg).image
            rec = {
                "tag": "expdecay_mode_ab", "mode": mode, "param": tau,
                "h": cfg.h, "filter": "exp_decay",
                "psnr_in": round(gl.psnr(clean, noisy), 3),
                "psnr_out": round(gl.psnr(clean, out), 3),
                "ssim_out": round(gl.ssim(clean, out), 4),
                "ts": time.time(),
            }
            with RESULTS.open("a") as f:
                f.write(json.dumps(rec) + "\n")
            print(json.dumps(rec), flush=True)


SWEEPS = {"cfg1": sweep_cfg1, "cfg1_nlm": sweep_cfg1_nlm,
          "cfg2_small": sweep_cfg2_small, "cfg2": sweep_cfg2,
          "cfg3": sweep_cfg3, "cfg3_matvec": sweep_cfg3_matvec,
          "expdecay_modes": sweep_expdecay_modes, "sigma": sweep_sigma}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("sweeps", nargs="+", choices=list(SWEEPS))
    ap.add_argument("--gpu", action="store_true",
                    help="run on the GPU backend (default: force CPU)")
    args = ap.parse_args()
    if not args.gpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
        setup_compilation_cache(Path(__file__).parent.parent, cpu=True)
    RESULTS.parent.mkdir(parents=True, exist_ok=True)
    for s in args.sweeps:
        SWEEPS[s]()


if __name__ == "__main__":
    main()
