"""Unit tests: image I/O, noise, PSNR/SSIM."""

import numpy as np
import pytest

from graphlap.io import (
    add_gaussian_noise,
    load_image,
    make_test_image,
    save_image,
)
from graphlap.metrics import psnr, ssim


def test_save_load_roundtrip(tmp_path):
    img = make_test_image(32, 48)
    path = str(tmp_path / "x.png")
    save_image(path, img)
    back = load_image(path, grayscale=True)
    assert back.shape == (32, 48)
    assert np.abs(back - img).max() <= 1.0 / 255.0 + 1e-9


def test_save_load_rgb(tmp_path):
    img = make_test_image(16, 16, channels=3)
    path = str(tmp_path / "x.png")
    save_image(path, img)
    back = load_image(path)
    assert back.shape == (16, 16, 3)
    assert np.abs(back - img).max() <= 1.0 / 255.0 + 1e-9


def test_pillow_is_only_needed_for_png(tmp_path, monkeypatch):
    """Without Pillow, .pgm still round-trips and PNG names the route."""
    import sys

    monkeypatch.setitem(sys.modules, "PIL", None)
    img = make_test_image(16, 24)
    save_image(str(tmp_path / "x.pgm"), img)
    assert load_image(str(tmp_path / "x.pgm")).shape == (16, 24)
    with pytest.raises(ImportError, match="pgm/.ppm"):
        save_image(str(tmp_path / "x.png"), img)


def test_noise_deterministic_and_unbiased():
    img = make_test_image(64, 64)
    n1 = add_gaussian_noise(img, 0.1, seed=3)
    n2 = add_gaussian_noise(img, 0.1, seed=3)
    np.testing.assert_array_equal(n1, n2)
    assert abs((n1 - img).mean()) < 0.01
    assert abs((n1 - img).std() - 0.1) < 0.01


def test_psnr_basics():
    img = make_test_image(32, 32)
    assert psnr(img, img) == float("inf")
    noisy = add_gaussian_noise(img, 0.1, seed=0)
    val = psnr(img, noisy)
    assert 19.0 < val < 21.0  # sigma 0.1 -> ~20 dB
    assert psnr(img, add_gaussian_noise(img, 0.05, seed=0)) > val


def test_ssim_basics():
    img = make_test_image(64, 64)
    assert ssim(img, img) == pytest.approx(1.0, abs=1e-9)
    noisy = np.clip(add_gaussian_noise(img, 0.2, seed=1), 0, 1)
    assert ssim(img, noisy) < 0.7
    mild = np.clip(add_gaussian_noise(img, 0.02, seed=1), 0, 1)
    assert ssim(img, mild) > ssim(img, noisy)


def test_make_test_image_properties():
    img = make_test_image(40, 56)
    assert img.shape == (40, 56)
    assert img.min() >= 0 and img.max() <= 1
    rgb = make_test_image(20, 20, channels=3)
    assert rgb.shape == (20, 20, 3)
    np.testing.assert_array_equal(make_test_image(20, 20, seed=5),
                                  make_test_image(20, 20, seed=5))


def test_config_validation():
    from graphlap.config import PipelineConfig
    with pytest.raises(ValueError):
        PipelineConfig(kernel="nope")
    with pytest.raises(ValueError):
        PipelineConfig(filter_name="nope")
    with pytest.raises(ValueError):
        PipelineConfig(patch_size=4)
    with pytest.raises(ValueError):
        PipelineConfig(sample_rho=0.0)
    c = PipelineConfig()
    assert c.config_hash() == PipelineConfig().config_hash()
    assert c.replace(h=0.5).config_hash() != c.config_hash()
    assert c.num_samples(16384) == 164
    assert c.num_samples(10**9) == c.sample_cap
