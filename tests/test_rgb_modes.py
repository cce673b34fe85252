"""Tests: rgb_mode='luma_basis' (shared luminance eigenbasis).

Correctness anchor: on an image whose channels are IDENTICAL, the luminance
guide equals every channel, so luma_basis must reproduce per_channel
exactly (same graph, same apply) — this pins both the dense and the
streaming variants without needing a separate oracle implementation.
"""

import numpy as np
import pytest

import graphlap as gl
from graphlap.models.pipeline import make_plan


def _rgb_image(h=64, w=64, seed=0):
    base = gl.make_test_image(h, w, seed=seed)
    rng = np.random.default_rng(seed + 1)
    tint = 0.1 * rng.standard_normal((1, 1, 3))
    return np.clip(base[..., None] + tint, 0, 1).astype(np.float32)


@pytest.mark.parametrize("streaming", [False, True])
def test_luma_basis_equals_per_channel_on_gray_rgb(streaming):
    img = gl.make_test_image(48, 48)
    rgb = np.repeat(img[..., None], 3, axis=-1)
    cfg = gl.PipelineConfig(kernel="nlm", h=0.25, sample_rho=0.05,
                            num_eigvecs=16, streaming=streaming,
                            block_cols=256)
    plan = make_plan(rgb, cfg)
    per = gl.filter_image(rgb, cfg, plan=plan)
    luma = gl.filter_image(rgb, cfg.replace(rgb_mode="luma_basis"), plan=plan)
    np.testing.assert_allclose(luma.image, per.image, atol=2e-5)
    # all three channels identical (one basis, same input channel)
    np.testing.assert_allclose(luma.image[..., 0], luma.image[..., 2],
                               atol=1e-6)


def test_luma_basis_rgb_quality_tracks_per_channel():
    img = _rgb_image(64, 64)
    noisy = np.clip(gl.add_gaussian_noise(img, 0.1, seed=1), 0, 1)
    cfg = gl.PipelineConfig(kernel="gaussian", h=0.3, sample_rho=0.03,
                            num_eigvecs=24)
    plan = make_plan(noisy, cfg)
    per = gl.filter_image(noisy, cfg, plan=plan)
    luma = gl.filter_image(noisy, cfg.replace(rgb_mode="luma_basis"),
                           plan=plan)
    p_per = gl.psnr(img, per.image)
    p_luma = gl.psnr(img, luma.image)
    assert np.isfinite(luma.image).all()
    # one shared basis should be in the same quality class as 3 independent
    # ones (the guide graph is built from the luma of the SAME pixels)
    assert abs(p_per - p_luma) < 1.0
    # eigvals come back as a single (m,) spectrum, not (C, m)
    assert luma.eigvals.shape == (cfg.num_eigvecs,)


def test_luma_basis_sharpen_runs():
    img = _rgb_image(48, 48, seed=3)
    cfg = gl.PipelineConfig(kernel="nlm", h=0.25, sample_rho=0.05,
                            num_eigvecs=16, filter_name="sharpen",
                            filter_param=0.6, rgb_mode="luma_basis")
    res = gl.filter_image(img, cfg)
    assert res.image.shape == img.shape
    assert np.isfinite(res.image).all()


def test_rgb_mode_validation():
    with pytest.raises(ValueError, match="rgb_mode"):
        gl.PipelineConfig(rgb_mode="yuv")


def test_luma_basis_staged_matches_fused():
    """The staged (CLI) path must honor luma mode like the fused path: one
    shared spectrum, same pixels (regression: it silently ran per_channel
    while -save_basis stored a luma basis)."""
    img = _rgb_image(48, 48, seed=4)
    cfg = gl.PipelineConfig(kernel="nlm", h=0.25, sample_rho=0.05,
                            num_eigvecs=16, rgb_mode="luma_basis")
    plan = gl.make_plan(img, cfg)
    staged = gl.filter_image_staged(img, cfg, plan=plan)
    fused = gl.filter_image(img, cfg, plan=plan)
    assert staged.eigvals.shape == (16,)          # ONE shared spectrum
    np.testing.assert_allclose(staged.image, fused.image, atol=2e-5)
    assert staged.timings["eigensolve"] >= 0.0


def test_luma_basis_checkpoint_roundtrip(tmp_path):
    """-save_basis under luma mode stores ONE shared basis; replaying it on
    the RGB image matches the direct luma pipeline."""
    img = _rgb_image(48, 48, seed=2)
    cfg = gl.PipelineConfig(kernel="nlm", h=0.25, sample_rho=0.05,
                            num_eigvecs=16, rgb_mode="luma_basis")
    plan = gl.make_plan(img, cfg)
    vals, vecs = gl.compute_basis(img, cfg, plan)
    assert vals.shape == (16,) and vecs.shape == (img.size // 3, 16)
    path = tmp_path / "luma_basis.npz"
    gl.save_basis(path, vals, vecs, plan, cfg)
    replay = gl.filter_with_basis(img, gl.load_basis(path), "identity", 0.0)
    direct = gl.filter_image(img, cfg, plan=plan)
    np.testing.assert_allclose(replay, direct.image, atol=1e-5)
