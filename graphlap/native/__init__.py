"""Native host-runtime layer: netpbm codec, noise injection, fast PSNR.

C extension (codec.c) mirroring the reference's C image-I/O utilities
(SURVEY.md §2.2 #2); every entry point has a numpy fallback so the package
works without the compiled module. ``HAVE_NATIVE`` reports which path is
active; tests exercise both.
"""

from __future__ import annotations

import numpy as np

try:
    from . import _native  # type: ignore[attr-defined]
    HAVE_NATIVE = True
except ImportError:      # pragma: no cover - build-environment dependent
    _native = None
    HAVE_NATIVE = False


def read_netpbm(path_or_bytes) -> np.ndarray:
    """Binary PGM (P5) / PPM (P6) -> float64 [0,1], (H, W) or (H, W, 3)."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        blob = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            blob = f.read()
    if _native is not None:
        w, h, c, payload = _native.read_netpbm(blob)
        arr = np.frombuffer(payload, np.float64).reshape(h, w, c)
        return arr[..., 0] if c == 1 else arr
    return _read_netpbm_py(blob)


def write_netpbm(path, img: np.ndarray) -> None:
    """float [0,1] (H, W) or (H, W, 3) -> binary PGM/PPM file.

    Integer arrays are rejected rather than silently saturating: a
    uint8 image scaled 0-255 would write as all-white (every value
    >= 1.0 clips) — found by a property test passing quantized ints."""
    img = np.asarray(img)
    if np.issubdtype(img.dtype, np.integer):
        raise TypeError(
            f"write_netpbm expects float values in [0, 1], got dtype "
            f"{img.dtype} — divide by 255 (or 65535) first")
    img = np.asarray(img, np.float64)
    c = 1 if img.ndim == 2 else img.shape[2]
    if c not in (1, 3):
        raise ValueError(f"channels must be 1 or 3, got {c}")
    h, w = img.shape[:2]
    if _native is not None:
        blob = _native.write_netpbm(w, h, c, np.ascontiguousarray(img).tobytes())
    else:
        blob = _write_netpbm_py(w, h, c, img)
    with open(path, "wb") as f:
        f.write(blob)


def add_noise_native(img: np.ndarray, sigma: float, seed: int = 0) -> np.ndarray:
    """Gaussian noise via the native xorshift128+/Box-Muller generator.

    Deterministic for a given seed, but a DIFFERENT stream than numpy's
    (graphlap.io.add_gaussian_noise) — don't mix in parity tests.
    """
    img = np.ascontiguousarray(img, np.float64)
    if _native is not None:
        out = _native.add_noise(img.tobytes(), float(sigma), int(seed))
        return np.frombuffer(out, np.float64).reshape(img.shape)
    rng = np.random.default_rng(seed)
    return img + rng.normal(0.0, sigma, img.shape)


def psnr_native(ref: np.ndarray, test: np.ndarray,
                data_range: float = 1.0) -> float:
    ref = np.ascontiguousarray(ref, np.float64)
    test = np.ascontiguousarray(test, np.float64)
    if _native is not None:
        return _native.psnr(ref.tobytes(), test.tobytes(), float(data_range))
    from ..metrics import psnr
    return psnr(ref, test, data_range)


def ssim_native(ref: np.ndarray, test: np.ndarray, data_range: float = 1.0,
                sigma: float = 1.5) -> float:
    """Mean SSIM via the C kernel (metrics.ssim twin: Gaussian 11x11,
    reflect padding); per-channel averaged for (H, W, C). Needs a build
    with the `ssim` symbol — older in-place .so builds fall back."""
    ref = np.ascontiguousarray(ref, np.float64)
    test = np.ascontiguousarray(test, np.float64)
    if _native is not None and hasattr(_native, "ssim"):
        if ref.ndim == 3:
            return float(np.mean([
                _native.ssim(np.ascontiguousarray(ref[..., c]).tobytes(),
                             np.ascontiguousarray(test[..., c]).tobytes(),
                             ref.shape[0], ref.shape[1], float(data_range),
                             float(sigma))
                for c in range(ref.shape[-1])]))
        return _native.ssim(ref.tobytes(), test.tobytes(), ref.shape[0],
                            ref.shape[1], float(data_range), float(sigma))
    from ..metrics import ssim
    return ssim(ref, test, data_range, sigma)


# ---- pure-python fallbacks -------------------------------------------------

def _read_netpbm_py(blob: bytes) -> np.ndarray:
    if blob[:2] not in (b"P5", b"P6"):
        raise ValueError("not a binary PGM (P5) / PPM (P6)")
    c = 1 if blob[:2] == b"P5" else 3
    pos, fields = 2, []
    while len(fields) < 3:
        while pos < len(blob) and blob[pos:pos + 1].isspace():
            pos += 1
        if blob[pos:pos + 1] == b"#":
            while pos < len(blob) and blob[pos] != 0x0A:
                pos += 1
            continue
        start = pos
        while pos < len(blob) and blob[pos:pos + 1].isdigit():
            pos += 1
        fields.append(int(blob[start:pos]))
    pos += 1
    w, h, maxval = fields
    dt = np.dtype(">u2") if maxval > 255 else np.uint8
    arr = np.frombuffer(blob, dt, count=w * h * c, offset=pos)
    arr = arr.astype(np.float64).reshape(h, w, c) / maxval
    return arr[..., 0] if c == 1 else arr


def _write_netpbm_py(w: int, h: int, c: int, img: np.ndarray) -> bytes:
    header = f"P{'5' if c == 1 else '6'}\n{w} {h}\n255\n".encode()
    data = (np.clip(img, 0, 1) * 255.0 + 0.5).astype(np.uint8)
    return header + data.tobytes()
