"""Streaming (recompute) path == materialized path (SURVEY.md §7 step 5)."""

import numpy as np
import pytest

from graphlap import add_gaussian_noise, filter_image, make_test_image
from graphlap.config import PipelineConfig
from graphlap.models.pipeline import make_plan


@pytest.fixture(scope="module")
def noisy():
    img = make_test_image(64, 64, seed=11)
    return np.clip(add_gaussian_noise(img, 0.1, seed=11), 0, 1)


@pytest.mark.parametrize("filter_name,param,norm", [
    ("identity", 0.0, "sinkhorn"),
    ("sharpen", 0.6, "sinkhorn"),
    ("power", 2.0, "symmetric"),
    ("identity", 0.0, "none"),
    ("twicing", 3.0, "sinkhorn"),
    ("exp_decay", 2.0, "symmetric"),
    ("lowpass", 0.0, "sinkhorn"),
])
def test_streaming_matches_materialized(noisy, filter_name, param, norm):
    base = PipelineConfig(kernel="nlm", h=0.25, sample_rho=0.03,
                          num_eigvecs=24, filter_name=filter_name,
                          filter_param=param, normalization=norm,
                          sinkhorn_iters=10)
    plan = make_plan(noisy, base)
    dense = filter_image(noisy, base, plan=plan)
    # block smaller than N and NOT dividing it (4096 pixels, block 640)
    stream = filter_image(noisy, base.replace(streaming=True, block_cols=640),
                          plan=plan)
    # 5e-4: f32 accumulation-order differences (one GEMM vs block scan)
    # scale with filter gain — twicing/lowpass rows peak at ~3.6e-4 on one
    # pixel in 4096 while identity stays under 3e-4
    np.testing.assert_allclose(stream.image, dense.image, atol=5e-4)
    # rtol matters: unnormalized spectra have eigenvalues O(1000)
    np.testing.assert_allclose(stream.eigvals, dense.eigvals,
                               rtol=1e-4, atol=3e-4)


def test_streaming_single_block(noisy):
    """block >= N degenerates to one scan step, still identical."""
    cfg = PipelineConfig(kernel="gaussian", h=0.3, sample_rho=0.03,
                         num_eigvecs=16)
    plan = make_plan(noisy, cfg)
    dense = filter_image(noisy, cfg, plan=plan)
    stream = filter_image(noisy, cfg.replace(streaming=True, block_cols=8192),
                          plan=plan)
    np.testing.assert_allclose(stream.image, dense.image, atol=3e-4)


def test_streaming_pallas_matvecs_match(noisy):
    """Fused Pallas K-matvec kernels == XLA scan operators (interpret)."""
    cfg = PipelineConfig(kernel="nlm", h=0.25, sample_rho=0.03,
                         num_eigvecs=24, streaming=True, block_cols=1024)
    plan = make_plan(noisy, cfg)
    xla = filter_image(noisy, cfg, plan=plan)
    pal = filter_image(noisy, cfg.replace(use_pallas=True), plan=plan)
    np.testing.assert_allclose(pal.image, xla.image, atol=3e-4)
    np.testing.assert_allclose(pal.eigvals, xla.eigvals, atol=3e-4)


def test_streaming_pallas_coarse_gram_matches(noisy):
    """Pallas matvec path under gram_coarse decimation == XLA path."""
    cfg = PipelineConfig(kernel="nlm", h=0.25, sample_rho=0.03,
                         num_eigvecs=24, streaming=True, block_cols=1024,
                         sinkhorn_coarse=2, gram_coarse=2)
    plan = make_plan(noisy, cfg)
    xla = filter_image(noisy, cfg, plan=plan)
    pal = filter_image(noisy, cfg.replace(use_pallas=True), plan=plan)
    np.testing.assert_allclose(pal.image, xla.image, atol=3e-4)
    np.testing.assert_allclose(pal.eigvals, xla.eigvals, atol=3e-4)


def test_streaming_compute_basis_matches_dense(noisy):
    """-save_basis on a streaming config must go through the strip-free
    path (it silently materialized the dense strip) and
    produce a basis whose filter replays match the dense basis."""
    from graphlap.models.pipeline import compute_basis
    from graphlap.utils.checkpoint import SavedBasis, filter_with_basis

    cfg = PipelineConfig(kernel="nlm", h=0.25, sample_rho=0.03,
                         num_eigvecs=16, sinkhorn_iters=10)
    plan = make_plan(noisy, cfg)
    vals_d, vecs_d = compute_basis(noisy, cfg, plan=plan)
    vals_s, vecs_s = compute_basis(
        noisy, cfg.replace(streaming=True, block_cols=640), plan=plan)
    np.testing.assert_allclose(vals_s, vals_d, rtol=1e-4, atol=3e-4)

    def replay(vals, vecs, name, param):
        b = SavedBasis(vals=vals, vecs=vecs, perm=plan.perm,
                       inv_perm=plan.inv_perm, height=64, width=64,
                       config_hash="x")
        return filter_with_basis(noisy, b, name, param)

    for name, param in (("identity", 0.0), ("sharpen", 0.6)):
        zd = replay(vals_d, vecs_d, name, param)
        zs = replay(vals_s, vecs_s, name, param)
        np.testing.assert_allclose(zs, zd, atol=1e-3)


def test_streaming_rgb(noisy):
    img = make_test_image(32, 32, channels=3, seed=12)
    cfg = PipelineConfig(kernel="nlm", h=0.25, sample_rho=0.05,
                         num_eigvecs=16, streaming=True, block_cols=256)
    res = filter_image(img, cfg)
    dense = filter_image(img, cfg.replace(streaming=False))
    np.testing.assert_allclose(res.image, dense.image, atol=3e-4)


def test_streaming_pallas_odd_size():
    """Odd, non-tile-aligned image (37x53) through streaming + Pallas:
    padding must be exact (zero-column no-ops), matching the XLA path."""
    img = make_test_image(37, 53, seed=5)
    noisy37 = np.clip(add_gaussian_noise(img, 0.1, seed=5), 0, 1)
    cfg = PipelineConfig(kernel="nlm", h=0.25, sample_rho=0.05,
                         num_eigvecs=16, streaming=True, block_cols=512)
    plan = make_plan(noisy37, cfg)
    xla = filter_image(noisy37, cfg, plan=plan)
    pal = filter_image(noisy37, cfg.replace(use_pallas=True), plan=plan)
    assert pal.image.shape == (37, 53)
    np.testing.assert_allclose(pal.image, xla.image, atol=5e-4)


def test_streaming_staged_matches_fused(noisy):
    """The staged (normalize/eigensolve/filter) split produces the SAME
    pixels as the fused streaming jit, and records the graded eigensolve
    wall (streaming rows must carry per-stage walls)."""
    from graphlap import filter_image_staged

    cfg = PipelineConfig(kernel="nlm", h=0.25, sample_rho=0.03,
                         num_eigvecs=24, sinkhorn_iters=8,
                         streaming=True, block_cols=640)
    plan = make_plan(noisy, cfg)
    fused = filter_image(noisy, cfg, plan=plan)
    staged = filter_image_staged(noisy, cfg, plan=plan)
    np.testing.assert_allclose(staged.image, fused.image, atol=1e-5)
    np.testing.assert_allclose(staged.eigvals, fused.eigvals,
                               rtol=1e-5, atol=1e-5)
    assert set(staged.timings) == {"normalize", "eigensolve", "filter"}
    assert all(v > 0 for v in staged.timings.values())


def test_streaming_staged_coarse_pallas(noisy):
    """Staged split under the production recipe operators (bf16 tiles +
    Pallas interpret + coarse Sinkhorn/gram + polish)."""
    from graphlap import filter_image_staged

    cfg = PipelineConfig(kernel="nlm", h=0.25, sample_rho=0.03,
                         num_eigvecs=16, sinkhorn_iters=4,
                         streaming=True, block_cols=1024, use_pallas=True,
                         affinity_dtype="bfloat16", sinkhorn_coarse=4,
                         sinkhorn_polish=1, gram_coarse=4)
    plan = make_plan(noisy, cfg)
    fused = filter_image(noisy, cfg, plan=plan)
    staged = filter_image_staged(noisy, cfg, plan=plan)
    np.testing.assert_allclose(staged.image, fused.image, atol=2e-4)


def test_streaming_staged_rgb(noisy):
    """Per-channel RGB through the staged streaming split (the cfg3 row)."""
    from graphlap import filter_image_staged

    rgb = np.stack([noisy, 1 - noisy, noisy ** 2], axis=-1)
    cfg = PipelineConfig(kernel="nlm", h=0.25, sample_rho=0.02,
                         num_eigvecs=12, sinkhorn_iters=6,
                         streaming=True, block_cols=1024)
    plan = make_plan(rgb, cfg)
    fused = filter_image(rgb, cfg, plan=plan)
    staged = filter_image_staged(rgb, cfg, plan=plan)
    # 5e-5: the stage boundaries change XLA's fusion/reassociation (one
    # pixel in 12k measured 1.8e-5 off at f32)
    np.testing.assert_allclose(staged.image, fused.image, atol=5e-5)


# ---------------------------------------------------------------------------
# strip_cache: the dense-capacity mode (materialized natural-order strip)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("filter_name,param,mode", [
    ("identity", 0.0, "spectral"),
    ("identity", 1.0, "matvec"),
    ("sharpen", 0.15, "matvec"),
])
def test_strip_cache_matches_recompute(noisy, filter_name, param, mode):
    """cfg.strip_cache reproduces the recompute streaming path: same
    masks, same estimators — only the tile source changes (one stored
    strip vs per-block recompute), so outputs agree to f32
    accumulation-order tolerance."""
    base = PipelineConfig(kernel="nlm", h=0.25, sample_rho=0.03,
                          num_eigvecs=24, filter_name=filter_name,
                          filter_param=param, filter_mode=mode,
                          sinkhorn_iters=10, streaming=True, block_cols=640)
    plan = make_plan(noisy, base)
    rec = filter_image(noisy, base, plan=plan)
    cache = filter_image(noisy, base.replace(strip_cache=True), plan=plan)
    np.testing.assert_allclose(cache.image, rec.image, atol=5e-4)


def test_strip_cache_coarse_recipe_matches(noisy):
    """The accelerated knobs (coarse Sinkhorn + polish + coarse gram) run
    the SAME estimator on both tile sources. The coarse sample is pinned
    ('auto' resolves diag-iff-strip_cache since the r4 split — the two
    paths would deliberately pick DIFFERENT column samples and this
    equivalence would compare different estimators)."""
    base = PipelineConfig(kernel="nlm", h=0.25, sample_rho=0.03,
                          num_eigvecs=24, sinkhorn_iters=6,
                          sinkhorn_coarse=4, sinkhorn_polish=1,
                          sinkhorn_sample="stride",
                          gram_coarse=4, streaming=True, block_cols=1024)
    plan = make_plan(noisy, base)
    rec = filter_image(noisy, base, plan=plan)
    cache = filter_image(noisy, base.replace(strip_cache=True), plan=plan)
    np.testing.assert_allclose(cache.image, rec.image, atol=5e-4)


def test_strip_cache_sketch_matches_dense_sketch(noisy):
    """solver='sketch' is allowed WITH strip_cache (thin passes against
    the materialized strip) and matches the classic dense path's sketch
    output at the same fixed seed."""
    base = PipelineConfig(kernel="nlm", h=0.25, sample_rho=0.03,
                          num_eigvecs=24, sinkhorn_iters=10,
                          solver="sketch", sketch_oversample=40,
                          sketch_power=1)
    plan = make_plan(noisy, base)
    dense = filter_image(noisy, base, plan=plan)
    cache = filter_image(noisy, base.replace(streaming=True,
                                             strip_cache=True,
                                             block_cols=640), plan=plan)
    np.testing.assert_allclose(cache.image, dense.image, atol=7e-4)


def test_strip_cache_validation():
    with pytest.raises(ValueError, match="strip_cache"):
        PipelineConfig(strip_cache=True)                   # needs streaming
    with pytest.raises(ValueError, match="sketch"):
        PipelineConfig(streaming=True, solver="sketch")    # needs the cache


def test_strip_cache_bf16_store(noisy):
    """bfloat16_store semantics carry over: f32 distances/exp, strip
    STORED bf16 — output stays within the measured store-rounding class
    of the f32 run."""
    import graphlap as gl
    base = PipelineConfig(kernel="nlm", h=0.25, sample_rho=0.03,
                          num_eigvecs=24, sinkhorn_iters=10,
                          streaming=True, strip_cache=True, block_cols=640)
    f32 = filter_image(noisy, base)
    b16 = filter_image(noisy, base.replace(affinity_dtype="bfloat16_store"))
    assert abs(gl.psnr(noisy, f32.image) - gl.psnr(noisy, b16.image)) < 0.05
