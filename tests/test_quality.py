"""Denoising QUALITY tests: the graded configs must be
good denoisers, not just parity-exact ones.

The round-2 CONFIG1 (pure photometric gaussian, h=0.3) gained +0.09 dB at
the graded noise level — a no-op filter. Round 3 calibrated the bandwidths
from a measured sweep (benchmarks/tune_quality.py, results in
benchmarks/results/quality_sweep.jsonl); these tests pin the outcome so a
config regression cannot silently return to the no-op regime.
"""

import numpy as np
import pytest

from graphlap import (
    CONFIG1,
    CONFIG2,
    CONFIG3,
    add_gaussian_noise,
    denoise_tuned,
    estimate_noise_sigma,
    filter_image,
    make_test_image,
    psnr,
    ssim,
)


@pytest.fixture(scope="module")
def noisy128():
    img = make_test_image(128, 128)
    return img, np.clip(add_gaussian_noise(img, 0.1, seed=1), 0, 1)


def test_config1_denoises_at_least_2db(noisy128):
    """The graded cfg1 shape: tuned bilateral-gaussian defaults must gain
    >= +2 dB (measured +5.1 dB; the old defaults managed +0.09)."""
    img, noisy = noisy128
    res = filter_image(noisy, CONFIG1)
    gain = psnr(img, res.image) - psnr(img, noisy)
    assert gain >= 2.0, f"cfg1 denoise gain {gain:.2f} dB below the bar"


def test_config2_recipe_denoises_at_128(noisy128):
    """CONFIG2's tuned NLM bandwidth on a 128^2 stand-in (the 512^2 graded
    row is exercised by bench.py / chip_smoke.py on the GPU; this pins
    the same recipe class CPU-side). Measured +4.5 dB at h=0.15."""
    img, noisy = noisy128
    res = filter_image(noisy, CONFIG2)
    gain = psnr(img, res.image) - psnr(img, noisy)
    assert gain >= 2.0, f"cfg2-class denoise gain {gain:.2f} dB below the bar"


def test_config3_sharpen_enhances_faithfully():
    """CONFIG3 (matvec sharpen, beta recalibrated for the exact operator):
    the output must be a REAL detail boost — gradient energy above the
    noisy input's own — without wrecking structure (SSIM floor) or
    collapsing PSNR. Measured at 1024^2: ratio 1.31, SSIM 0.867,
    PSNR 29.07 vs input 30.49."""
    img = make_test_image(128, 128)
    noisy = np.clip(add_gaussian_noise(img, 0.03, seed=3), 0, 1)
    res = filter_image(noisy, CONFIG3.replace(sample_rho=0.02))

    def ge(a):
        return float((np.diff(a, axis=0) ** 2).sum()
                     + (np.diff(a, axis=1) ** 2).sum())

    ratio_out = ge(res.image) / ge(img)
    ratio_in = ge(noisy) / ge(img)
    assert ratio_out > ratio_in + 0.05, \
        f"sharpen is net-smoothing: {ratio_out:.3f} <= input {ratio_in:.3f}"
    assert ssim(img, res.image) > 0.75
    assert psnr(img, res.image) > psnr(img, noisy) - 3.0


def test_noise_sigma_estimator(noisy128):
    img, _ = noisy128
    for sigma in (0.05, 0.1, 0.2):
        noisy = np.clip(add_gaussian_noise(img, sigma, seed=3), 0, 1)
        est = estimate_noise_sigma(noisy)
        # clipping at [0,1] biases high sigma slightly low; texture floors
        # the clean estimate — 25% relative is the useful accuracy class
        assert abs(est - sigma) <= 0.25 * sigma + 0.005
    # multi-channel averages per-channel estimates
    rgb = np.stack([img, img, img], axis=-1)
    noisy_rgb = np.clip(add_gaussian_noise(rgb, 0.1, seed=4), 0, 1)
    assert abs(estimate_noise_sigma(noisy_rgb) - 0.1) <= 0.03


def test_denoise_tuned_rules():
    g = denoise_tuned(CONFIG1, 0.1)
    assert g.h == pytest.approx(0.2) and g.spatial_h == 8.0
    # nlm identity routes to the EXACT full-rank operator at h = 1.0 sigma
    # (round-4 rank study: +2.1-3.4 dB over the best rank-m spectral at
    # every tested size, BASELINE.md "Quality vs rank")
    n = denoise_tuned(CONFIG2, 0.1)
    assert n.filter_mode == "matvec"
    assert n.h == pytest.approx(0.1) and n.spatial_h == CONFIG2.spatial_h
    # explicit spectral choice keeps the rank-m rule h = 1.5 sigma
    ns = denoise_tuned(CONFIG2, 0.1, keep={"filter_mode"})
    assert ns.filter_mode == "spectral" and ns.h == pytest.approx(0.15)
    # non-identity spectral filters keep the rank-m rule too
    lp = denoise_tuned(CONFIG2.replace(filter_name="lowpass"), 0.1)
    assert lp.filter_mode == "spectral" and lp.h == pytest.approx(0.15)
    # floors on near-clean images
    assert denoise_tuned(CONFIG1, 0.0).h >= 0.08
    assert denoise_tuned(CONFIG2, 0.0).h >= 0.05
    # keep pins explicit user choices
    k = denoise_tuned(CONFIG1.replace(h=0.42), 0.1, keep={"h"})
    assert k.h == 0.42 and k.spatial_h == 8.0


def test_cli_tune_denoise(tmp_path, capsys):
    from graphlap import save_image
    from graphlap.cli import main as cli_main

    path = str(tmp_path / "in.png")
    save_image(path, make_test_image(64, 64))
    rc = cli_main(["-f", path, "-grayscale", "-cpu", "-noise", "0.1",
                   "-tune_denoise", "-eigvals", "16"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "tune_denoise: sigma=0.1000 -> h=0.200 spatial_h=8.0" in out

    # no -noise: sigma comes from the wavelet-MAD estimator
    rc = cli_main(["-f", path, "-grayscale", "-cpu",
                   "-tune_denoise", "-eigvals", "16"])
    assert rc == 0
    assert "tune_denoise: sigma=" in capsys.readouterr().out

    # explicit -h_param wins over the tuner
    rc = cli_main(["-f", path, "-grayscale", "-cpu", "-noise", "0.1",
                   "-tune_denoise", "-h_param", "0.33", "-eigvals", "16"])
    assert rc == 0
    assert "h=0.330" in capsys.readouterr().out
