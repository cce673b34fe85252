"""Generate the docs/examples/ before/after gallery (CPU, deterministic).

Three panels, each saved as clean / degraded / filtered PNGs:
  1. denoise_gaussian — CONFIG1-class bilateral denoise at 256^2, sigma 0.1
  2. denoise_nlm      — NLM 5x5 + Sinkhorn (config-2 recipe class) at 256^2
  3. sharpen_rgb      — config-3-class RGB enhancement (matvec sharpen)

Everything is synthetic (io.make_test_image) so the gallery regenerates
bit-identically from a clean checkout: `python scripts/make_examples.py`.
Runs CPU-side by design — the outputs are documentation, not benchmarks
(speed numbers live in BASELINE.md; this shows WHAT the filters do).
"""

import pathlib
import sys

import jax

jax.config.update("jax_platforms", "cpu")
from graphlap.utils.cache import setup_compilation_cache
setup_compilation_cache("/root/repo", cpu=True)  # CPU run: cache off (utils/cache.py)

import numpy as np  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import graphlap as gl  # noqa: E402
from graphlap.config import PipelineConfig, denoise_tuned  # noqa: E402
from graphlap.metrics import ssim  # noqa: E402

OUT = pathlib.Path(__file__).resolve().parent.parent / "docs" / "examples"


def _save(name: str, img: np.ndarray) -> None:
    OUT.mkdir(parents=True, exist_ok=True)
    gl.save_image(str(OUT / name), np.clip(img, 0.0, 1.0))


def denoise_gaussian() -> str:
    side, sigma = 256, 0.1
    clean = gl.make_test_image(side, side)
    noisy = np.clip(gl.add_gaussian_noise(clean, sigma, seed=1), 0, 1)
    cfg = denoise_tuned(gl.CONFIG1, sigma)
    res = gl.filter_image(noisy, cfg)
    _save("denoise_gaussian_clean.png", clean)
    _save("denoise_gaussian_noisy.png", noisy)
    _save("denoise_gaussian_out.png", res.image)
    return (f"| bilateral denoise (σ={sigma}) | "
            f"{gl.psnr(clean, noisy):.2f} → **{gl.psnr(clean, res.image):.2f} dB** | "
            f"{ssim(clean, noisy):.3f} → **{ssim(clean, res.image):.3f}** |")


def denoise_nlm() -> str:
    # same scene + noise draw as denoise_gaussian so the README can show
    # one noisy column against both filters honestly
    side, sigma = 256, 0.1
    clean = gl.make_test_image(side, side)
    noisy = np.clip(gl.add_gaussian_noise(clean, sigma, seed=1), 0, 1)
    cfg = denoise_tuned(
        PipelineConfig(kernel="nlm", patch_size=5, h=0.15, sample_rho=0.02,
                       num_eigvecs=50, normalization="sinkhorn",
                       sinkhorn_iters=20), sigma)
    res = gl.filter_image(noisy, cfg)
    _save("denoise_nlm_clean.png", clean)
    _save("denoise_nlm_noisy.png", noisy)
    _save("denoise_nlm_out.png", res.image)
    return (f"| NLM 5×5 + Sinkhorn denoise (σ={sigma}) | "
            f"{gl.psnr(clean, noisy):.2f} → **{gl.psnr(clean, res.image):.2f} dB** | "
            f"{ssim(clean, noisy):.3f} → **{ssim(clean, res.image):.3f}** |")


def sharpen_rgb() -> str:
    side, sigma = 256, 0.03
    clean = gl.make_test_image(side, side, channels=3)
    noisy = np.clip(gl.add_gaussian_noise(clean, sigma, seed=4), 0, 1)
    # config-3 class: exact-operator sharpen (matvec mode), luma-guided RGB
    cfg = PipelineConfig(kernel="nlm", patch_size=5, h=0.15, sample_rho=0.01,
                         num_eigvecs=50, normalization="sinkhorn",
                         sinkhorn_iters=20, filter_name="sharpen",
                         filter_param=0.15, filter_mode="matvec",
                         rgb_mode="luma_basis")
    res = gl.filter_image(noisy, cfg)

    def grad_energy(a):
        gy, gx = np.gradient(a.mean(axis=-1) if a.ndim == 3 else a)
        return float(np.mean(gy ** 2 + gx ** 2))

    ratio = grad_energy(res.image) / grad_energy(clean)
    _save("sharpen_rgb_clean.png", clean)
    _save("sharpen_rgb_in.png", noisy)
    _save("sharpen_rgb_out.png", res.image)
    return (f"| RGB enhancement f(λ)>1 (β=0.15) | "
            f"PSNR {gl.psnr(clean, res.image):.2f} dB | "
            f"gradient energy **{ratio:.2f}×** the clean image |")


def video_pan_registered() -> str:
    """Panning-video frame: per-frame bases vs the REGISTERED temporal
    guide at 1 px/frame (the regime where unregistered reuse loses —
    docs/plots/motion_guide.png). Saves the middle frame of each run."""
    side, b, v, sigma = 160, 8, 1.0, 0.1
    base = gl.make_test_image(side + 2 * b, side + 2 * b)
    clean = np.stack([base[t:t + side, t:t + side] for t in range(b)])
    rng = np.random.default_rng(7)
    noisy = np.clip(clean + sigma * rng.standard_normal(clean.shape),
                    0, 1).astype(np.float32)
    cfg = denoise_tuned(gl.CONFIG1, sigma)
    z1, _ = gl.filter_video(noisy, cfg)
    zr, _ = gl.filter_video(noisy, cfg, temporal_guide=4,
                            register_guide=True)
    mid = b // 2
    _save("video_pan_clean.png", clean[mid])
    _save("video_pan_noisy.png", noisy[mid])
    _save("video_pan_perframe.png", z1[mid])
    _save("video_pan_registered.png", zr[mid])
    p1 = np.mean([gl.psnr(clean[t], z1[t]) for t in range(b)])
    pr = np.mean([gl.psnr(clean[t], zr[t]) for t in range(b)])
    return (f"| video pan 1 px/frame, registered guide k=4 | "
            f"per-frame {p1:.2f} → **registered {pr:.2f} dB** | "
            f"factor stage runs 4× less often |")


if __name__ == "__main__":
    rows = [denoise_gaussian(), denoise_nlm(), sharpen_rgb(),
            video_pan_registered()]
    print("| example | PSNR | detail |")
    print("|---|---|---|")
    for r in rows:
        print(r)
