"""Native C layer: netpbm codec, noise, PSNR — native and fallback paths."""

import numpy as np
import pytest

from graphlap import native
from graphlap.io import load_image, save_image
from graphlap.metrics import psnr
from graphlap.native import (
    _read_netpbm_py,
    _write_netpbm_py,
    add_noise_native,
    psnr_native,
    read_netpbm,
    write_netpbm,
)


def test_native_extension_built():
    assert native.HAVE_NATIVE, "C extension failed to build on this host"


@pytest.mark.parametrize("shape", [(20, 30), (8, 9, 3)])
def test_roundtrip(tmp_path, shape):
    img = np.random.default_rng(0).random(shape)
    ext = ".pgm" if len(shape) == 2 else ".ppm"
    path = str(tmp_path / f"x{ext}")
    write_netpbm(path, img)
    back = read_netpbm(path)
    assert back.shape == img.shape
    assert np.abs(back - img).max() <= 0.5 / 255 + 1e-12


def test_native_matches_python_fallback(tmp_path):
    img = np.random.default_rng(1).random((16, 12))
    blob_native_path = str(tmp_path / "n.pgm")
    write_netpbm(blob_native_path, img)
    blob = open(blob_native_path, "rb").read()
    assert blob == _write_netpbm_py(12, 16, 1, img)
    np.testing.assert_array_equal(read_netpbm(blob), _read_netpbm_py(blob))


def test_read_comments_and_16bit():
    # hand-built P5 with comments and a 16-bit maxval
    payload = np.array([[0, 32768], [65535, 12345]], dtype=">u2")
    blob = b"P5\n# a comment\n2 2\n# another\n65535\n" + payload.tobytes()
    arr = read_netpbm(blob)
    np.testing.assert_allclose(arr, payload.astype(np.float64) / 65535)
    np.testing.assert_array_equal(arr, _read_netpbm_py(blob))


def test_rejects_garbage():
    with pytest.raises(ValueError):
        read_netpbm(b"P3\n1 1\n255\n0 0 0")  # ascii netpbm unsupported
    with pytest.raises(ValueError):
        read_netpbm(b"P5\n10 10\n255\n\x00\x01")  # truncated


def test_rejects_adversarial_dims():
    """Overflow-bait headers must raise cleanly (no UB/crash): huge single
    dims, and dims whose PRODUCT overflows before the payload check."""
    for header in (b"P5\n99999999999999999999 1\n255\n",       # > long
                   b"P5\n1073741824 1\n255\n",                  # == 2^30 cap
                   b"P5\n1073741825 1\n255\n",                  # > 2^30 cap
                   b"P5\n2073741824 1\n255\n",                  # cap < v < 10*cap
                   b"P6\n1000000000 1000000000\n255\n",         # w*h*3 ovfl
                   b"P5\n1 1\n99999999999\n"):                  # maxval ovfl
        with pytest.raises(ValueError):
            read_netpbm(header + b"\x00" * 16)


def test_noise_deterministic_unbiased():
    img = np.full((64, 64), 0.5)
    n1 = add_noise_native(img, 0.1, seed=9)
    n2 = add_noise_native(img, 0.1, seed=9)
    np.testing.assert_array_equal(n1, n2)
    d = n1 - img
    assert abs(d.mean()) < 0.01 and abs(d.std() - 0.1) < 0.01
    assert not np.array_equal(n1, add_noise_native(img, 0.1, seed=10))


def test_psnr_native_matches_numpy():
    rng = np.random.default_rng(2)
    a, b = rng.random((32, 32)), rng.random((32, 32))
    assert psnr_native(a, b) == pytest.approx(psnr(a, b), abs=1e-9)
    assert psnr_native(a, a) == float("inf")


def test_io_routes_netpbm(tmp_path):
    from graphlap.io import make_test_image
    img = make_test_image(24, 24)
    p = str(tmp_path / "img.pgm")
    save_image(p, img)
    back = load_image(p)
    assert np.abs(back - img).max() <= 0.5 / 255 + 1e-12
    rgb = make_test_image(12, 12, channels=3)
    p3 = str(tmp_path / "img.ppm")
    save_image(p3, rgb)
    assert load_image(p3).shape == (12, 12, 3)
    gray = load_image(p3, grayscale=True)
    assert gray.shape == (12, 12)


def test_ssim_native_matches_numpy():
    from graphlap.metrics import ssim
    from graphlap.native import ssim_native

    rng = np.random.default_rng(3)
    a = rng.uniform(0, 1, (48, 40))
    b = np.clip(a + rng.normal(0, 0.08, a.shape), 0, 1)
    assert abs(ssim_native(a, b) - ssim(a, b)) < 1e-12
    assert ssim_native(a, a) == pytest.approx(1.0)
    # per-channel averaging
    rgb_a = np.stack([a, np.roll(a, 3, 0), a], axis=-1)
    rgb_b = np.stack([b, np.roll(b, 3, 0), b], axis=-1)
    assert abs(ssim_native(rgb_a, rgb_b) - ssim(rgb_a, rgb_b)) < 1e-12
    # window larger than the image -> actionable error, not UB
    from graphlap.native import HAVE_NATIVE, _native
    if HAVE_NATIVE and hasattr(_native, "ssim"):
        with pytest.raises(ValueError):
            _native.ssim(a[:4, :4].tobytes(), a[:4, :4].tobytes(),
                         4, 4, 1.0, 1.5)
