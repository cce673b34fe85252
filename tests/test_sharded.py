"""Multi-device tests on 8 fake CPU devices (SURVEY.md §4.3).

Asserts sharded output == single-device output (allclose at f32) — the
fake-backend answer to testing multi-node behavior without a cluster.
"""

import jax
import numpy as np
import pytest

from graphlap import add_gaussian_noise, filter_image, make_test_image
from graphlap.config import PipelineConfig
from graphlap.models.pipeline import make_plan
from graphlap.parallel.mesh import make_mesh
from graphlap.parallel.sharded import filter_frames_sharded

CFG = PipelineConfig(kernel="nlm", h=0.25, sample_rho=0.02, num_eigvecs=24)


@pytest.fixture(scope="module")
def frames():
    imgs = [make_test_image(32, 32, seed=s) for s in range(2)]
    noisy = [np.clip(add_gaussian_noise(im, 0.1, seed=s), 0, 1)
             for s, im in enumerate(imgs)]
    return np.stack(noisy)


def test_eight_fake_devices_present():
    assert len(jax.devices()) == 8


def test_rows_sharded_matches_single_device(frames):
    plan = make_plan(frames[0], CFG)
    mesh = make_mesh(n_rows=4, n_data=2)
    z, vals = filter_frames_sharded(frames, CFG, plan, mesh)
    assert z.shape == frames.shape
    for i in range(frames.shape[0]):
        ref = filter_image(frames[i], CFG, plan=plan)
        np.testing.assert_allclose(z[i], ref.image, atol=2e-4)
        np.testing.assert_allclose(vals[i], ref.eigvals, atol=2e-4)


def test_pure_row_mesh(frames):
    plan = make_plan(frames[0], CFG)
    mesh = make_mesh(n_rows=8, n_data=1)
    z, _ = filter_frames_sharded(frames, CFG, plan, mesh)
    ref = filter_image(frames[0], CFG, plan=plan)
    np.testing.assert_allclose(z[0], ref.image, atol=2e-4)


def test_output_is_committed_across_meshes(frames):
    """Same math on two different mesh shapes -> same pixels."""
    plan = make_plan(frames[0], CFG)
    z1, _ = filter_frames_sharded(frames, CFG, plan, make_mesh(8, 1))
    z2, _ = filter_frames_sharded(frames, CFG, plan, make_mesh(4, 2))
    np.testing.assert_allclose(z1, z2, atol=2e-4)


def test_dense_production_recipe_sharded_matches_single(frames):
    """The DENSE production recipe (bfloat16_store strip + sketch
    eigensolver + coarse Sinkhorn + polish — what '-preset fast' selects
    at headline sizes) through the rows-sharded builder: the sharded run
    must match the single-device path pixel-for-pixel. Guards the solver
    dispatch and the coarse/polish plumbing added to build_sharded_pipeline
    (they were silently ignored there before round 3)."""
    cfg = CFG.replace(affinity_dtype="bfloat16_store", solver="sketch",
                      sketch_oversample=110, sketch_power=1,
                      sinkhorn_coarse=4, sinkhorn_polish=1,
                      sinkhorn_iters=8)
    plan = make_plan(frames[0], cfg)
    mesh = make_mesh(n_rows=4, n_data=2)
    z, vals = filter_frames_sharded(frames, cfg, plan, mesh)
    for i in range(frames.shape[0]):
        ref = filter_image(frames[i], cfg, plan=plan)
        np.testing.assert_allclose(z[i], ref.image, atol=2e-4)
        np.testing.assert_allclose(vals[i], ref.eigvals, rtol=1e-3,
                                   atol=2e-4)


def test_streaming_sharded_matches_single(frames):
    """Rows-sharded STREAMING pipeline (config 4's 'row-blocks sharded'
    contract) == single-device streaming/dense output."""
    from graphlap.parallel.streaming_sharded import (
        filter_image_streaming_sharded,
    )
    cfg = CFG.replace(streaming=True, block_cols=128, sinkhorn_iters=10)
    plan = make_plan(frames[0], cfg)
    ref = filter_image(frames[0], cfg, plan=plan)
    for mesh in (make_mesh(8, 1), make_mesh(4, 2)):
        z, vals = filter_image_streaming_sharded(frames[0], cfg, plan, mesh)
        np.testing.assert_allclose(z, ref.image, atol=2e-4)
        np.testing.assert_allclose(vals, ref.eigvals, atol=2e-4)


def test_streaming_batch_pallas_matches_xla(frames):
    """use_pallas=True routes the batched builder's strip matvecs through
    the vmapped Pallas kernels (interpret mode on CPU) — must match the
    XLA-scan variant and the single-image path."""
    from graphlap.parallel.streaming_sharded import (
        build_streaming_sharded_batch,
    )
    import jax.numpy as jnp

    scfg = CFG.replace(streaming=True, block_cols=256, sinkhorn_iters=6,
                       sinkhorn_coarse=2, sinkhorn_polish=1)
    plan = make_plan(frames[0], scfg)
    mesh = make_mesh(n_rows=4, n_data=2)
    idx_a = jnp.asarray(plan.idx_a)
    z_x, _ = build_streaming_sharded_batch(mesh, scfg)(
        jnp.asarray(frames), idx_a)
    z_p, _ = build_streaming_sharded_batch(
        mesh, scfg.replace(use_pallas=True))(jnp.asarray(frames), idx_a)
    np.testing.assert_allclose(np.asarray(z_p), np.asarray(z_x), atol=2e-4)


def test_streaming_sharded_pallas_matches_xla(frames):
    """Single-frame rows-sharded builder: Pallas matvecs == XLA scan."""
    from graphlap.parallel.streaming_sharded import (
        filter_image_streaming_sharded,
    )

    scfg = CFG.replace(streaming=True, block_cols=256)
    plan = make_plan(frames[0], scfg)
    mesh = make_mesh(n_rows=4, n_data=2)
    z_x, _ = filter_image_streaming_sharded(frames[0], scfg, plan, mesh)
    z_p, _ = filter_image_streaming_sharded(
        frames[0], scfg.replace(use_pallas=True), plan, mesh)
    np.testing.assert_allclose(z_p, z_x, atol=2e-4)


def test_matvec_mode_sharded_matches_single(frames):
    """filter_mode='matvec' (exact polynomial sharpen) through BOTH sharded
    builders == the single-device matvec path. The sharded matvec reuses
    ktilde_apply / the per-frame completion, so this pins the psum
    placement of the no-eigensolve production cfg3 recipe."""
    from graphlap.parallel.sharded import filter_frames_sharded
    from graphlap.parallel.streaming_sharded import (
        filter_image_streaming_sharded,
    )

    mcfg = CFG.replace(filter_name="sharpen", filter_param=0.6,
                       filter_mode="matvec")
    plan = make_plan(frames[0], mcfg)
    mesh = make_mesh(n_rows=4, n_data=2)

    # dense rows-sharded builder
    z, vals = filter_frames_sharded(frames, mcfg, plan, mesh)
    assert vals.shape == (frames.shape[0], 0)
    for i in range(frames.shape[0]):
        ref = filter_image(frames[i], mcfg, plan=plan)
        np.testing.assert_allclose(z[i], ref.image, atol=2e-4)

    # streaming single-frame + batched (coarse-Sinkhorn) builders
    scfg = mcfg.replace(streaming=True, block_cols=128, sinkhorn_iters=10)
    sref = filter_image(frames[0], scfg, plan=plan)
    z_s, _ = filter_image_streaming_sharded(frames[0], scfg, plan, mesh)
    np.testing.assert_allclose(z_s, sref.image, atol=2e-4)
    ccfg = scfg.replace(block_cols=256, sinkhorn_coarse=2,
                        sinkhorn_polish=1, sinkhorn_iters=6)
    cref = filter_image(frames[0], ccfg, plan=plan)
    # coarse-Sinkhorn routes through the BATCHED builder with B=1, whose
    # frame axis shards over 'data' — needs a pure-rows mesh here
    z_c, _ = filter_image_streaming_sharded(frames[0], ccfg, plan,
                                            make_mesh(8, 1))
    np.testing.assert_allclose(z_c, cref.image, atol=2e-4)


def test_chebyshev_mode_sharded_matches_single(frames):
    """filter_mode='chebyshev' (series f(W) y for non-polynomial filters —
    exp_decay here) through BOTH sharded builders == the single-device
    chebyshev path. The three-term recurrence runs a DISTINCT psum chain
    per iteration (one completion matvec per term), so this pins a
    collective pattern none of the other mode tests cover."""
    from graphlap.parallel.sharded import filter_frames_sharded
    from graphlap.parallel.streaming_sharded import (
        filter_image_streaming_sharded,
    )

    ccfg = CFG.replace(filter_name="exp_decay", filter_param=2.0,
                       filter_mode="chebyshev", cheb_degree=8)
    plan = make_plan(frames[0], ccfg)
    mesh = make_mesh(n_rows=4, n_data=2)

    # dense rows-sharded builder
    z, vals = filter_frames_sharded(frames, ccfg, plan, mesh)
    assert vals.shape == (frames.shape[0], 0)    # no eigensolve ran
    for i in range(frames.shape[0]):
        ref = filter_image(frames[i], ccfg, plan=plan)
        np.testing.assert_allclose(z[i], ref.image, atol=2e-4)

    # streaming single-frame + batched (coarse-Sinkhorn) builders
    scfg = ccfg.replace(streaming=True, block_cols=128, sinkhorn_iters=10)
    sref = filter_image(frames[0], scfg, plan=plan)
    z_s, _ = filter_image_streaming_sharded(frames[0], scfg, plan, mesh)
    np.testing.assert_allclose(z_s, sref.image, atol=2e-4)
    bcfg = scfg.replace(block_cols=256, sinkhorn_coarse=2,
                        sinkhorn_polish=1, sinkhorn_iters=6)
    bref = filter_image(frames[0], bcfg, plan=plan)
    z_b, _ = filter_image_streaming_sharded(frames[0], bcfg, plan,
                                            make_mesh(8, 1))
    np.testing.assert_allclose(z_b, bref.image, atol=2e-4)


def test_streaming_sharded_bf16_features_matches_single(frames):
    """feature_dtype='bfloat16' (the capacity lever) through the
    rows-sharded streaming builder == the single-device output of the
    SAME recipe — the sharding must be invariant to the feature store
    dtype (features are replicated/sliced identically either way)."""
    from graphlap.parallel.streaming_sharded import (
        filter_image_streaming_sharded,
    )
    cfg = CFG.replace(streaming=True, block_cols=128, sinkhorn_iters=10,
                      affinity_dtype="bfloat16", feature_dtype="bfloat16")
    plan = make_plan(frames[0], cfg)
    ref = filter_image(frames[0], cfg, plan=plan)
    z, vals = filter_image_streaming_sharded(frames[0], cfg, plan,
                                             make_mesh(4, 2))
    # looser than the f32 case: sharding changes the scan's block
    # partition, and bf16 TILE values make the f32 accumulation-order
    # difference visible (measured max |diff| 3.6e-4; f32 tiles stay
    # under 2e-4). Same-class, not a sharding defect.
    np.testing.assert_allclose(z, ref.image, atol=1e-3)
    np.testing.assert_allclose(vals, ref.eigvals, atol=1e-3)


def test_filter_image_mesh_route(frames):
    """filter_image(mesh=...) — the unified single-image multi-chip
    entry: grayscale, per-channel RGB, and luma_basis RGB (the guided
    builder with the channel stack) all match their single-device
    twins; dense + mesh refuses with guidance."""
    scfg = CFG.replace(streaming=True, block_cols=128, sinkhorn_iters=10)
    img = np.asarray(frames[0])
    rgb = np.stack([img, img * 0.8 + 0.1, img * 0.6 + 0.2], axis=-1)
    mesh = make_mesh(8, 1)

    ref = filter_image(img, scfg)
    got = filter_image(img, scfg, mesh=mesh)
    np.testing.assert_allclose(got.image, ref.image, atol=2e-4)

    ref3 = filter_image(rgb, scfg)
    got3 = filter_image(rgb, scfg, mesh=mesh)
    assert got3.image.shape == rgb.shape
    np.testing.assert_allclose(got3.image, ref3.image, atol=2e-4)
    assert got3.eigvals.shape == ref3.eigvals.shape

    lcfg = scfg.replace(rgb_mode="luma_basis")
    refl = filter_image(rgb, lcfg)
    gotl = filter_image(rgb, lcfg, mesh=mesh)
    np.testing.assert_allclose(gotl.image, refl.image, atol=2e-4)

    with pytest.raises(ValueError, match="streaming"):
        filter_image(img, CFG, mesh=mesh)


def test_coarse_single_image_on_data_mesh(frames):
    """Regression (review finding, reproduced): the coarse-Sinkhorn
    single-image route goes through the BATCHED builder with B=1, whose
    'data'-axis specs cannot split one frame over n_data>1 — the entry
    now re-meshes the same devices rows-only instead of crashing."""
    from graphlap.parallel.streaming_sharded import (
        filter_image_streaming_sharded,
    )
    ccfg = CFG.replace(streaming=True, block_cols=256, sinkhorn_coarse=2,
                       sinkhorn_polish=1, sinkhorn_iters=6)
    plan = make_plan(frames[0], ccfg)
    ref = filter_image(frames[0], ccfg, plan=plan)
    z, _ = filter_image_streaming_sharded(frames[0], ccfg, plan,
                                          make_mesh(4, 2))   # data=2
    np.testing.assert_allclose(z, ref.image, atol=2e-4)


def test_strip_cache_sketch_sharded_matches_single(frames):
    """The r4 cfg2-class headline recipe (strip_cache + coarse diag
    Sinkhorn + polish + scale-folded sketch) through the mesh: the batched
    builder materializes LOCAL strip slices, the sketch sandwich runs as
    local GEMMs + one (p, k) psum. Must match the single-device
    strip_cache path — this is what 'filter_image(..., preset_cfg, mesh)'
    executes after the preset adoption."""
    from graphlap.parallel.streaming_sharded import (
        filter_image_streaming_sharded,
    )
    cfg = CFG.replace(streaming=True, strip_cache=True, block_cols=32 * 32,
                      sinkhorn_iters=4, sinkhorn_coarse=4, sinkhorn_polish=1,
                      solver="sketch", sketch_oversample=8, sketch_power=0,
                      num_eigvecs=8)
    plan = make_plan(frames[0], cfg)
    ref = filter_image(frames[0], cfg, plan=plan)
    for mesh in (make_mesh(8, 1), make_mesh(4, 2)):
        z, vals = filter_image_streaming_sharded(frames[0], cfg, plan, mesh)
        np.testing.assert_allclose(z, ref.image, atol=2e-4)
        np.testing.assert_allclose(vals, ref.eigvals, atol=2e-4)


def test_strip_cache_batched_sharded_matches_single(frames):
    """Batched (B=2) strip_cache through (data=2, rows=4): per-frame equal
    to the single-device strip_cache outputs (chol solver — pins the
    strip-backed ktilde/coarse/colstats independent of the sketch)."""
    from graphlap.parallel.streaming_sharded import (
        build_streaming_sharded_batch,
    )
    import jax.numpy as jnp

    cfg = CFG.replace(streaming=True, strip_cache=True, block_cols=32 * 32,
                      sinkhorn_iters=4, sinkhorn_coarse=4, sinkhorn_polish=1,
                      solver="chol", num_eigvecs=8)
    plan = make_plan(frames[0], cfg)
    mesh = make_mesh(n_rows=4, n_data=2)
    z, vals = build_streaming_sharded_batch(mesh, cfg)(
        jnp.asarray(frames, jnp.float32), jnp.asarray(plan.idx_a))
    for i in range(frames.shape[0]):
        ref = filter_image(frames[i], cfg, plan=plan)
        np.testing.assert_allclose(np.asarray(z)[i], ref.image, atol=2e-4)


def test_sketch_without_strip_cache_rejected_on_mesh(frames):
    """The recompute-only sharded builders refuse solver='sketch' loudly
    instead of silently running a different estimator."""
    from graphlap.parallel.streaming_sharded import (
        build_streaming_sharded,
        build_streaming_sharded_guided,
    )
    cfg = CFG.replace(streaming=True, strip_cache=True, block_cols=32 * 32,
                      solver="sketch", num_eigvecs=8)
    mesh = make_mesh(8, 1)
    with pytest.raises(ValueError, match="sketch"):
        build_streaming_sharded(mesh, cfg)
    with pytest.raises(ValueError, match="sketch"):
        build_streaming_sharded_guided(mesh, cfg, 2)
