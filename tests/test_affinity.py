"""Unit tests: affinity features + K strip vs the float64 oracle twins
(SURVEY.md §4.1)."""

import jax.numpy as jnp
import numpy as np
import pytest

from graphlap.config import PipelineConfig
from graphlap.io import make_test_image
from graphlap.ops.affinity import (
    affinity_blocks,
    affinity_strip,
    affinity_strip_np,
    extract_features,
    extract_features_np,
    feature_dim,
)
from graphlap.utils.sampling import uniform_grid_sample


@pytest.fixture(scope="module")
def img():
    return make_test_image(32, 32, seed=3)


@pytest.mark.parametrize("cfg", [
    PipelineConfig(kernel="gaussian", h=0.2),
    PipelineConfig(kernel="gaussian", h=0.3, spatial_h=16.0),
    PipelineConfig(kernel="nlm", h=0.25, patch_size=5),
    PipelineConfig(kernel="nlm", h=0.4, patch_size=3, spatial_h=8.0),
])
def test_features_match_oracle(img, cfg):
    f_jax = np.asarray(extract_features(jnp.asarray(img, jnp.float32), cfg))
    f_np = extract_features_np(img, cfg)
    assert f_jax.shape == (32 * 32, feature_dim(cfg))
    np.testing.assert_allclose(f_jax, f_np, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kernel", ["gaussian", "nlm"])
def test_strip_matches_oracle_and_kernel_properties(img, kernel):
    cfg = PipelineConfig(kernel=kernel, h=0.25)
    plan = uniform_grid_sample(32, 32, 40)
    feats = extract_features_np(img, cfg)
    fp = feats[plan.perm]
    k_np = affinity_strip_np(fp[: plan.p], fp)
    k_jax = np.asarray(affinity_strip(jnp.asarray(fp[: plan.p], jnp.float32),
                                      jnp.asarray(fp, jnp.float32)))
    np.testing.assert_allclose(k_jax, k_np, rtol=0, atol=5e-5)
    # kernel values in (0, 1]; diagonal of K_AA is exactly 1
    assert k_jax.max() <= 1.0 + 1e-6 and k_jax.min() > 0.0
    kaa = k_jax[:, : plan.p]
    np.testing.assert_allclose(np.diag(kaa), 1.0, atol=1e-5)
    np.testing.assert_allclose(kaa, kaa.T, atol=1e-6)


def test_affinity_blocks_split(img):
    cfg = PipelineConfig(kernel="nlm", h=0.25)
    plan = uniform_grid_sample(32, 32, 40)
    kaa, kab = affinity_blocks(jnp.asarray(img, jnp.float32),
                               jnp.asarray(plan.idx_a), jnp.asarray(plan.perm), cfg)
    assert kaa.shape == (40, 40)
    assert kab.shape == (40, 32 * 32 - 40)
    feats = extract_features_np(img, cfg)
    fp = feats[plan.perm]
    strip = affinity_strip_np(fp[: plan.p], fp)
    np.testing.assert_allclose(np.asarray(kaa), strip[:, :40], atol=5e-5)
    np.testing.assert_allclose(np.asarray(kab), strip[:, 40:], atol=5e-5)


def test_bf16_strip_close_to_f32(img):
    cfg = PipelineConfig(kernel="nlm", h=0.25)
    plan = uniform_grid_sample(32, 32, 40)
    feats = extract_features_np(img, cfg)
    fp = feats[plan.perm]
    f32 = np.asarray(affinity_strip(jnp.asarray(fp[:40], jnp.float32),
                                    jnp.asarray(fp, jnp.float32), jnp.float32))
    bf16 = np.asarray(affinity_strip(jnp.asarray(fp[:40], jnp.float32),
                                     jnp.asarray(fp, jnp.float32), jnp.bfloat16))
    # bf16 GEMM with f32 accumulate: kernel values still close
    assert np.abs(f32 - bf16).max() < 3e-2


def test_feature_dtype_bf16_validation_and_rounding(img):
    # spatial coordinates cannot survive bf16 (8 mantissa bits lose the
    # neighbor-distance cancellation at large absolute coords)
    with pytest.raises(ValueError, match="feature_dtype"):
        PipelineConfig(kernel="nlm", feature_dtype="bfloat16", spatial_h=8.0)
    with pytest.raises(ValueError, match="feature_dtype"):
        PipelineConfig(feature_dtype="float16")
    cfg = PipelineConfig(kernel="nlm", h=0.25, feature_dtype="bfloat16")
    feats = extract_features(jnp.asarray(img, jnp.float32), cfg)
    assert feats.dtype == jnp.bfloat16
    ref = extract_features_np(img, cfg)
    # bf16 rounding only: < 0.5% relative on O(1) patch features
    assert np.abs(np.asarray(feats, np.float64) - ref).max() < 5e-3 * ref.max()


def test_feature_dtype_bf16_streaming_parity():
    """The capacity lever's gate test: a bf16 feature store through the
    full streaming pipeline stays within the 0.1 dB gate of the exact
    f32 run, and adds ~nothing on top of the bf16 tile mode it is meant
    to pair with (measured 0.0045/0.0099 dB at 256^2/96^2 build-time)."""
    import graphlap as gl
    side = 64
    clean = make_test_image(side, side)
    noisy = np.clip(gl.add_gaussian_noise(clean, 0.1, seed=1), 0, 1)
    base = PipelineConfig(kernel="nlm", patch_size=5, h=0.15,
                          sample_rho=0.03, num_eigvecs=30,
                          normalization="sinkhorn", sinkhorn_iters=20,
                          streaming=True, block_cols=1024)
    p_exact = gl.psnr(clean, gl.filter_image(noisy, base).image)
    for kw in (dict(affinity_dtype="bfloat16", feature_dtype="bfloat16"),
               dict(feature_dtype="bfloat16")):
        r = gl.filter_image(noisy, base.replace(**kw))
        assert np.isfinite(r.image).all()
        assert abs(gl.psnr(clean, r.image) - p_exact) <= 0.1, kw


@pytest.mark.parametrize("cfg", [
    PipelineConfig(kernel="nlm", h=0.25, patch_size=5),
    PipelineConfig(kernel="nlm", h=0.25, patch_size=5,
                   feature_dtype="bfloat16"),
    PipelineConfig(kernel="nlm", h=0.4, patch_size=3, spatial_h=8.0),
    PipelineConfig(kernel="gaussian", h=0.3, spatial_h=16.0),
])
@pytest.mark.parametrize("row_chunk", [None, 5, 7, 37])
def test_extract_features_padded_bit_identical(cfg, row_chunk):
    """The chunked padded extractor (the 64 MP OOM fix) is BIT-identical
    to extract_features + zero-pad — including non-dividing chunk sizes
    (the clamped-overlap tail) and an odd image shape. Both sides run
    under jit, as they do in the pipeline: XLA rewrites the constant
    bandwidth division to a reciprocal multiply (1 ulp), so an eager
    reference would differ for a reason that never occurs in practice."""
    import jax
    from graphlap.ops.affinity import extract_features_padded
    img = jnp.asarray(make_test_image(37, 29, seed=5), jnp.float32)
    n = 37 * 29
    n_pad = 1152                      # non-trivial zero tail
    ref = jax.jit(lambda im: extract_features(im, cfg))(img)
    want = np.zeros((n_pad, ref.shape[1]), np.asarray(ref).dtype)
    want[:n] = np.asarray(ref)
    got = np.asarray(jax.jit(
        lambda im: extract_features_padded(im, cfg, n_pad,
                                           row_chunk=row_chunk))(img))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_extract_features_padded_traced_h():
    """h stays traceable through the chunked path (tune.py SURE grids
    jit one executable over a traced bandwidth)."""
    import jax
    from graphlap.ops.affinity import extract_features_padded
    cfg = PipelineConfig(kernel="nlm", h=0.25, patch_size=3)
    img = jnp.asarray(make_test_image(16, 16, seed=2), jnp.float32)
    f = jax.jit(lambda hh: extract_features_padded(img, cfg, 272, h=hh,
                                                   row_chunk=5))
    a = np.asarray(f(0.25))
    b = np.asarray(jax.jit(
        lambda im: extract_features_padded(im, cfg, 272, h=0.25))(img))
    # traced-h: true division by the runtime scalar vs the constant
    # divisor's reciprocal rewrite — 1 ulp class, as in tune.py sweeps
    np.testing.assert_allclose(a, b, rtol=3e-7, atol=0)
    assert not np.allclose(np.asarray(f(0.5))[:16 * 16], a[:16 * 16])
