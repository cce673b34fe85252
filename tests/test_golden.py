"""Golden-image regression (SURVEY.md §4.5): checked-in 32x32 fixtures.

The golden output was produced by the float64 oracle (implementation-
independent truth); the JAX pipeline must reproduce it pixel-for-pixel at
8-bit quantization. Catches silent regressions as pixel diffs.
"""

from pathlib import Path

import numpy as np

from graphlap import filter_image
from graphlap.config import PipelineConfig
from graphlap.native import read_netpbm

GOLDEN = Path(__file__).parent / "golden"
CFG = PipelineConfig(kernel="nlm", h=0.25, sample_rho=0.05, num_eigvecs=20)


def test_golden_denoise_pixels():
    noisy = read_netpbm(GOLDEN / "input_32.pgm")
    expected = read_netpbm(GOLDEN / "denoised_32.pgm")
    res = filter_image(noisy, CFG)
    # quantize to 8 bits like the fixture and compare: at most one gray
    # level of disagreement anywhere, and >=99% exact
    got = np.round(np.clip(res.image, 0, 1) * 255)
    want = np.round(expected * 255)
    diff = np.abs(got - want)
    assert diff.max() <= 1.0, diff.max()
    assert (diff == 0).mean() >= 0.99


def test_golden_streaming_same_pixels():
    noisy = read_netpbm(GOLDEN / "input_32.pgm")
    expected = read_netpbm(GOLDEN / "denoised_32.pgm")
    res = filter_image(noisy, CFG.replace(streaming=True, block_cols=256))
    got = np.round(np.clip(res.image, 0, 1) * 255)
    diff = np.abs(got - np.round(expected * 255))
    assert diff.max() <= 1.0


def test_golden_matvec_sharpen_pixels():
    """filter_mode='matvec' golden (fixture from the float64 oracle's
    polynomial branch): the exact-polynomial sharpen must reproduce the
    oracle pixels at 8-bit quantization through the JAX pipeline."""
    noisy = read_netpbm(GOLDEN / "input_32.pgm")
    expected = read_netpbm(GOLDEN / "sharpen_matvec_32.pgm")
    mcfg = CFG.replace(filter_name="sharpen", filter_param=0.15,
                       filter_mode="matvec")
    for cfg in (mcfg, mcfg.replace(streaming=True, block_cols=256)):
        res = filter_image(noisy, cfg)
        got = np.round(np.clip(res.image, 0, 1) * 255)
        diff = np.abs(got - np.round(expected * 255))
        assert diff.max() <= 1.0, diff.max()
        assert (diff == 0).mean() >= 0.99


def test_golden_chebyshev_expdecay_pixels():
    """Chebyshev-mode golden (fixture from the float64 oracle): the
    degree-12 heat-kernel series must reproduce the oracle pixels at
    8-bit quantization through dense AND streaming JAX pipelines."""
    noisy = read_netpbm(GOLDEN / "input_32.pgm")
    expected = read_netpbm(GOLDEN / "expdecay_cheb_32.pgm")
    ccfg = CFG.replace(filter_name="exp_decay", filter_param=2.0,
                       filter_mode="chebyshev")
    for cfg in (ccfg, ccfg.replace(streaming=True, block_cols=256)):
        res = filter_image(noisy, cfg)
        got = np.round(np.clip(res.image, 0, 1) * 255)
        diff = np.abs(got - np.round(expected * 255))
        assert diff.max() <= 1.0, diff.max()
        assert (diff == 0).mean() >= 0.99
