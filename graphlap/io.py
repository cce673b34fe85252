"""Image I/O and synthetic-noise injection.

JAX equivalent of the reference's C image loader + Python helper
converters (SURVEY.md §2.2 component #2). Images are float arrays in
[0, 1]: grayscale (H, W) or RGB (H, W, 3).
"""

from __future__ import annotations

import numpy as np


def load_image(path: str, grayscale: bool = False) -> np.ndarray:
    """Load an image file to float64 in [0, 1]; (H, W) gray or (H, W, 3) RGB.

    .pgm/.ppm go through the native C codec (graphlap.native, the
    reference's raw-format-converter role); everything else through Pillow.
    """
    if str(path).lower().endswith((".pgm", ".ppm")):
        from .native import read_netpbm

        arr = read_netpbm(path)
        if grayscale and arr.ndim == 3:
            arr = arr @ np.array([0.299, 0.587, 0.114])
        return arr
    img = _pil_image().open(path)
    if grayscale:
        img = img.convert("L")
    elif img.mode not in ("L", "RGB"):
        img = img.convert("RGB")
    arr = np.asarray(img, dtype=np.float64) / 255.0
    return arr


def save_image(path: str, img: np.ndarray) -> None:
    """Save a float [0,1] array as an 8-bit image (.pgm/.ppm via C codec)."""
    if str(path).lower().endswith((".pgm", ".ppm")):
        from .native import write_netpbm

        write_netpbm(path, img)
        return
    arr = np.clip(np.asarray(img), 0.0, 1.0)
    _pil_image().fromarray((arr * 255.0 + 0.5).astype(np.uint8)).save(path)


def _pil_image():
    """Pillow, imported lazily: only PNG/JPEG/other formats need it."""
    try:
        from PIL import Image
    except ImportError as exc:
        raise ImportError(
            "PNG/JPEG image I/O needs Pillow, which is not installed; "
            "binary .pgm/.ppm files load and save without it (native "
            "netpbm codec)") from exc
    return Image


def add_gaussian_noise(img: np.ndarray, sigma: float, seed: int = 0) -> np.ndarray:
    """Add i.i.d. Gaussian noise of std ``sigma`` (image range [0,1]).

    Host-side numpy so the CPU oracle and the device pipeline denoise the
    *identical* noisy image (SURVEY.md §4.1 parity protocol).
    """
    rng = np.random.default_rng(seed)
    return img + rng.normal(0.0, sigma, size=img.shape)


def make_test_image(h: int = 128, w: int = 128, channels: int = 0,
                    seed: int = 0) -> np.ndarray:
    """Deterministic synthetic test image: smooth gradients + shapes + texture.

    Structured content (edges, flat regions, texture) exercises the filter the
    way natural photos do, without shipping binary fixtures.
    """
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    yy /= max(h - 1, 1)
    xx /= max(w - 1, 1)

    img = 0.35 + 0.3 * xx + 0.15 * np.sin(6.0 * np.pi * yy)
    # a bright disk and a dark square (edges)
    disk = (yy - 0.35) ** 2 + (xx - 0.3) ** 2 < 0.04
    img[disk] = 0.9
    sq = (np.abs(yy - 0.7) < 0.12) & (np.abs(xx - 0.65) < 0.15)
    img[sq] = 0.12
    # mild texture
    img += 0.03 * rng.standard_normal((h, w))
    img = np.clip(img, 0.0, 1.0)

    if channels:
        chans = [np.clip(img * (0.8 + 0.2 * c / max(channels - 1, 1))
                         + 0.05 * rng.standard_normal((h, w)), 0, 1)
                 for c in range(channels)]
        img = np.stack(chans, axis=-1)
    return img
