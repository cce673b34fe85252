"""Batch/video path tests (BASELINE config 5 shape, local mesh)."""

import numpy as np
import pytest

from graphlap import add_gaussian_noise, filter_image, make_test_image
from graphlap.config import PipelineConfig
from graphlap.models.pipeline import make_plan
from graphlap.models.video import filter_video
from graphlap.parallel.mesh import make_mesh

CFG = PipelineConfig(kernel="nlm", h=0.25, sample_rho=0.03, num_eigvecs=16,
                     sinkhorn_iters=10)


def test_video_batch_matches_per_frame():
    frames = np.stack([
        np.clip(add_gaussian_noise(make_test_image(32, 32, seed=s), 0.1, seed=s), 0, 1)
        for s in range(5)
    ])
    plan = make_plan(frames[0], CFG)
    mesh = make_mesh(n_rows=4, n_data=2)
    out, vals = filter_video(frames, CFG, mesh=mesh, plan=plan,
                             frames_per_step=4)   # forces 2 chunks + padding
    assert out.shape == frames.shape
    assert vals.shape == (5, CFG.num_eigvecs)
    for i in range(5):
        ref = filter_image(frames[i], CFG, plan=plan)
        np.testing.assert_allclose(out[i], ref.image, atol=2e-4)


def test_video_rejects_bad_shape():
    with pytest.raises(ValueError):
        filter_video(np.zeros((8, 8)), CFG)


def test_video_rgb_frames_fold_into_batch():
    """(B, H, W, C) color video == each channel filtered as its own frame
    (channels share the plan, so folding them into the batch axis is
    exact)."""
    rng = np.random.default_rng(0)
    frames = np.clip(np.stack([
        make_test_image(32, 32, seed=s)[..., None]
        + 0.1 * rng.standard_normal((1, 1, 3))
        for s in range(2)
    ]), 0, 1).astype(np.float32)                   # (2, 32, 32, 3)
    plan = make_plan(frames[0, ..., 0], CFG)
    mesh = make_mesh(n_rows=4, n_data=2)
    out, vals = filter_video(frames, CFG, mesh=mesh, plan=plan)
    assert out.shape == frames.shape
    assert vals.shape == (2, 3, CFG.num_eigvecs)
    for b in range(2):
        for c in range(3):
            ref = filter_image(frames[b, ..., c], CFG, plan=plan)
            np.testing.assert_allclose(out[b, ..., c], ref.image, atol=2e-4)
    with pytest.raises(ValueError, match="per_channel"):
        filter_video(frames, CFG.replace(rgb_mode="luma_basis"), mesh=mesh,
                     plan=plan)


def test_video_streaming_batch_matches_per_frame():
    """Config 5's real path: frames on 'data', pixel blocks on 'rows',
    strip-free. Must equal the single-image streaming path per frame."""
    scfg = CFG.replace(streaming=True, block_cols=128)
    frames = np.stack([
        np.clip(add_gaussian_noise(make_test_image(32, 32, seed=s), 0.1,
                                   seed=s), 0, 1)
        for s in range(5)
    ])
    plan = make_plan(frames[0], scfg)
    mesh = make_mesh(n_rows=4, n_data=2)
    out, vals = filter_video(frames, scfg, mesh=mesh, plan=plan,
                             frames_per_step=4)   # 2 chunks + padding
    assert out.shape == frames.shape
    assert vals.shape == (5, scfg.num_eigvecs)
    for i in range(5):
        ref = filter_image(frames[i], scfg, plan=plan)
        np.testing.assert_allclose(out[i], ref.image, atol=3e-4)


def test_video_streaming_batch_coarse_sinkhorn():
    """Batched + rows-sharded coarse (decimated) Sinkhorn == the
    single-image streaming coarse path (cfg5's 4K recipe)."""
    scfg = CFG.replace(streaming=True, block_cols=128, sinkhorn_coarse=4)
    frames = np.stack([
        np.clip(add_gaussian_noise(make_test_image(32, 32, seed=s), 0.1,
                                   seed=s), 0, 1)
        for s in range(2)
    ])
    plan = make_plan(frames[0], scfg)
    out, vals = filter_video(frames, scfg, mesh=make_mesh(n_rows=4, n_data=2),
                             plan=plan, frames_per_step=2)
    for i in range(2):
        ref = filter_image(frames[i], scfg, plan=plan)
        np.testing.assert_allclose(out[i], ref.image, atol=3e-4)
        np.testing.assert_allclose(vals[i], ref.eigvals, rtol=1e-4, atol=3e-4)


@pytest.mark.parametrize("filter_name,param", [("identity", 0.0),
                                               ("sharpen", 0.6)])
def test_video_streaming_batch_filters(filter_name, param):
    """Projection AND affine filters through the batched streaming path,
    rows-only mesh (the 1-real-chip bench shape class)."""
    scfg = CFG.replace(streaming=True, block_cols=256,
                       filter_name=filter_name, filter_param=param)
    frames = np.stack([
        np.clip(add_gaussian_noise(make_test_image(32, 32, seed=s), 0.1,
                                   seed=s), 0, 1)
        for s in range(3)
    ])
    plan = make_plan(frames[0], scfg)
    out, _ = filter_video(frames, scfg, mesh=make_mesh(n_rows=8, n_data=1),
                          plan=plan, frames_per_step=3)
    for i in range(3):
        ref = filter_image(frames[i], scfg, plan=plan)
        np.testing.assert_allclose(out[i], ref.image, atol=3e-4)


# ---------------------------------------------------------------------------
# temporal basis reuse (temporal_guide > 1): groups of k frames share one
# eigenbasis built from the group-MEAN frame — the time-axis analogue of
# rgb_mode='luma_basis'. On a static scene the mean guide carries
# sigma/sqrt(k) of the per-frame noise, so quality must IMPROVE over
# per-frame bases while the factor stage runs k x less often.
# ---------------------------------------------------------------------------

from graphlap import CONFIG1, psnr


def _static_scene(b=8, side=64, sigma=0.1, seed=7):
    img = make_test_image(side, side)
    rng = np.random.default_rng(seed)
    frames = np.clip(img[None] + sigma * rng.standard_normal((b, side, side)),
                     0, 1).astype(np.float32)
    return np.broadcast_to(img, frames.shape), frames


def test_temporal_guide_beats_per_frame_bases_on_static_scene():
    clean, frames = _static_scene()
    z1, v1 = filter_video(frames, CONFIG1)
    z4, v4 = filter_video(frames, CONFIG1, temporal_guide=4)
    gain = psnr(clean, z4) - psnr(clean, z1)
    # measured +1.44 dB (the cleaner mean guide builds a better graph);
    # require a solid improvement, not just parity
    assert gain >= 0.5, f"temporal_guide gained only {gain:.2f} dB"
    assert v4.shape == v1.shape == (8, CONFIG1.num_eigvecs)
    assert np.isfinite(z4).all()


def test_temporal_guide_nondivisible_group_and_modes():
    clean, frames = _static_scene(b=7)
    z3, v3 = filter_video(frames, CONFIG1, temporal_guide=3)   # 3+3+1
    assert z3.shape == frames.shape and v3.shape == (7, CONFIG1.num_eigvecs)
    assert psnr(clean, z3) > psnr(clean, frames) + 2.0
    # streaming path must be the dense path's math
    scfg = CONFIG1.replace(streaming=True, block_cols=1024)
    zs, _ = filter_video(frames, scfg, temporal_guide=3)
    zd, _ = filter_video(frames, CONFIG1, temporal_guide=3)
    np.testing.assert_allclose(zs, zd, atol=3e-4)
    # operator (matvec) mode: empty eigvals, same quality class
    mcfg = CONFIG1.replace(filter_mode="matvec")
    zm, vm = filter_video(frames, mcfg, temporal_guide=3)
    assert vm.shape == (7, 0)
    assert psnr(clean, zm) > psnr(clean, frames) + 2.0


def test_temporal_guide_color_video():
    clean, frames = _static_scene(b=4)
    rgb = np.stack([frames, frames * 0.8 + 0.1, frames * 0.6 + 0.2], axis=-1)
    crgb = np.stack([clean, clean * 0.8 + 0.1, clean * 0.6 + 0.2], axis=-1)
    zc, vc = filter_video(rgb, CONFIG1, temporal_guide=4)
    assert zc.shape == rgb.shape and vc.shape == (4, CONFIG1.num_eigvecs)
    assert psnr(crgb, zc) > psnr(crgb, rgb) + 2.0
    # luma_basis would double-share; the guided path owns the channel fold
    with pytest.raises(ValueError, match="per_channel"):
        filter_video(rgb, CONFIG1.replace(rgb_mode="luma_basis"),
                     temporal_guide=4)


def test_temporal_guide_rejects_mesh_and_chunking():
    # regression: mesh / frames_per_step used to be SILENTLY dropped on
    # the guided path — a multi-chip request ran single-device instead.
    # A mesh is supported on the STREAMING guided path (test below);
    # dense-guided + mesh and frames_per_step still refuse loudly.
    from graphlap.parallel.mesh import make_mesh
    _, frames = _static_scene(b=4)
    with pytest.raises(ValueError, match="streaming"):
        filter_video(frames, CONFIG1, mesh=make_mesh(), temporal_guide=4)
    with pytest.raises(ValueError, match="temporal_guide"):
        filter_video(frames, CONFIG1, frames_per_step=2, temporal_guide=4)


def test_temporal_guide_sharded_matches_single_device():
    """The rows-sharded guided builder == the single-device guided path
    (one factor from the group mean, per-frame apply), for the spectral,
    operator-matvec, and coarse+polish recipes, incl. a non-divisible
    group count and color frames."""
    from graphlap.parallel.mesh import make_mesh
    mesh = make_mesh(n_rows=4, n_data=2)
    scfg = CONFIG1.replace(streaming=True, block_cols=1024)
    clean, frames = _static_scene(b=7)
    z1, v1 = filter_video(frames, scfg, temporal_guide=3)
    z2, v2 = filter_video(frames, scfg, mesh=mesh, temporal_guide=3)
    np.testing.assert_allclose(z2, z1, atol=3e-4)
    np.testing.assert_allclose(v2, v1, atol=1e-4)
    # operator mode (no eigensolve) through the sharded guided matvecs
    mcfg = scfg.replace(filter_name="sharpen", filter_param=0.15,
                        filter_mode="matvec")
    zm1, vm1 = filter_video(frames, mcfg, temporal_guide=3)
    zm2, vm2 = filter_video(frames, mcfg, mesh=mesh, temporal_guide=3)
    np.testing.assert_allclose(zm2, zm1, atol=3e-4)
    assert vm2.shape == vm1.shape == (7, 0)
    # the production accelerator stack compiles + matches
    ccfg = scfg.replace(sinkhorn_coarse=2, sinkhorn_polish=1, gram_coarse=2)
    zc1, _ = filter_video(frames[:3], ccfg, temporal_guide=3)
    zc2, _ = filter_video(frames[:3], ccfg, mesh=mesh, temporal_guide=3)
    np.testing.assert_allclose(zc2, zc1, atol=3e-4)
    # Pallas mode (interpret on CPU): the unchecked-vma shard_map path —
    # this equivalence is its psum-placement guard (see the check_vma
    # note in parallel/streaming_sharded.py)
    pcfg = scfg.replace(use_pallas=True)
    zp1, _ = filter_video(frames[:3], pcfg, temporal_guide=3)
    zp2, _ = filter_video(frames[:3], pcfg, mesh=mesh, temporal_guide=3)
    np.testing.assert_allclose(zp2, zp1, atol=3e-4)


def test_temporal_guide_motion_boundary():
    """Pins the measured motion rule (benchmarks/motion_guide.py): on a
    static scene grouped reuse beats per-frame bases, and at 1 px/frame
    of motion it must NOT (the group-mean guide smears) — the basis for
    the documented k <= 1 + 0.75/v guidance."""
    from scipy.ndimage import shift as nd_shift
    side, b, v = 64, 8, 1.0
    base = make_test_image(side + 24, side + 24)
    rng = np.random.default_rng(3)
    clean = np.stack([
        nd_shift(base, (-v * t, -v * t), order=3,
                 mode="reflect")[12:12 + side, 12:12 + side]
        for t in range(b)
    ]).astype(np.float32)
    clean = np.clip(clean, 0, 1)
    noisy = np.clip(clean + 0.1 * rng.standard_normal(clean.shape),
                    0, 1).astype(np.float32)
    z1, _ = filter_video(noisy, CONFIG1)
    z4, _ = filter_video(noisy, CONFIG1, temporal_guide=4)
    # measured: k=4 at v=1 px/frame loses ~3 dB to per-frame bases
    assert psnr(clean, z4) < psnr(clean, z1) - 1.0


def test_temporal_guide_sharded_color():
    from graphlap.parallel.mesh import make_mesh
    mesh = make_mesh(n_rows=4, n_data=2)
    scfg = CONFIG1.replace(streaming=True, block_cols=1024)
    _, frames = _static_scene(b=4)
    rgb = np.stack([frames, frames * 0.8 + 0.1, frames * 0.6 + 0.2], axis=-1)
    z1, v1 = filter_video(rgb, scfg, temporal_guide=4)
    z2, v2 = filter_video(rgb, scfg, mesh=mesh, temporal_guide=4)
    np.testing.assert_allclose(z2, z1, atol=3e-4)
    assert v2.shape == v1.shape


def test_register_guide_recovers_motion_loss():
    """register_guide=True phase-aligns each group to its first frame:
    pure camera pan behaves like a static scene — at v=1 px/frame (where
    unregistered k=4 loses ~3 dB to per-frame bases, the motion-boundary
    test above) the registered guide must WIN instead."""
    from scipy.ndimage import shift as nd_shift
    side, b, v = 64, 8, 1.0
    base = make_test_image(side + 24, side + 24)
    rng = np.random.default_rng(3)
    clean = np.clip(np.stack([
        nd_shift(base, (-v * t, -v * t), order=3,
                 mode="reflect")[12:12 + side, 12:12 + side]
        for t in range(b)
    ]), 0, 1).astype(np.float32)
    noisy = np.clip(clean + 0.1 * rng.standard_normal(clean.shape),
                    0, 1).astype(np.float32)
    z1, _ = filter_video(noisy, CONFIG1)
    zr, _ = filter_video(noisy, CONFIG1, temporal_guide=4,
                         register_guide=True)
    p1, pr = psnr(clean, z1), psnr(clean, zr)
    assert pr > p1 + 0.3, f"registered guide {pr:.2f} vs per-frame {p1:.2f}"


def test_register_guide_estimator_and_static_noop():
    from graphlap.utils.register import estimate_shift, shift_image
    base = np.asarray(make_test_image(96, 96), np.float64)
    moved = np.roll(np.roll(base, -4, axis=0), 7, axis=1)
    dy, dx = estimate_shift(base, moved)
    assert abs(dy + 4) < 0.05 and abs(dx - 7) < 0.05
    # aligning undoes the motion
    rec = shift_image(np.asarray(moved, np.float32), -dy, -dx)
    assert np.abs(rec[8:-8, 8:-8] - base[8:-8, 8:-8]).max() < 0.02
    # on a truly static scene registration must not hurt the guide win
    clean, frames = _static_scene(b=4)
    z, _ = filter_video(frames, CONFIG1, temporal_guide=4)
    zr, _ = filter_video(frames, CONFIG1, temporal_guide=4,
                         register_guide=True)
    assert abs(psnr(clean, zr) - psnr(clean, z)) < 0.3


def test_register_device_estimator_matches_host():
    """The jitted phase-correlation estimator (the production path; f32,
    batched FFT) agrees with the float64 host twin to a few hundredths
    of a pixel on a rolled image — the same bound the host estimator is
    held to against ground truth."""
    import jax.numpy as jnp
    from graphlap.utils.register import (_estimate_shifts_dev,
                                         estimate_shift)
    base = np.asarray(make_test_image(96, 96), np.float32)
    moved = np.roll(np.roll(base, -4, axis=0), 7, axis=1)
    dev = np.asarray(_estimate_shifts_dev(jnp.stack([base, moved])))
    assert np.abs(dev[0]).max() == 0.0           # frame 0 row is exact 0
    dy_h, dx_h = estimate_shift(base, moved)
    assert abs(dev[1, 0] - dy_h) < 0.03 and abs(dev[1, 1] - dx_h) < 0.03
    assert abs(dev[1, 0] + 4) < 0.05 and abs(dev[1, 1] - 7) < 0.05


def test_shift_image_dev_matches_host_twin():
    """Device Catmull-Rom warp vs the scipy order-3 host twin: exact at
    integer shifts (both interpolants reproduce samples; reflect
    boundary matches), ~1e-2 on smooth content at fractional shifts,
    and a true no-op at zero shift."""
    import jax
    from graphlap.utils.register import shift_image, shift_image_dev
    img = np.asarray(make_test_image(48, 40), np.float32)
    jsh = jax.jit(shift_image_dev)
    # zero shift: bit-exact passthrough (taps collapse to (0,1,0,0))
    np.testing.assert_array_equal(np.asarray(jsh(img, 0.0, 0.0)), img)
    # integer shifts incl. boundary-crossing ones
    for dy, dx in [(3.0, -5.0), (-7.0, 2.0)]:
        got = np.asarray(jsh(img, dy, dx))
        want = shift_image(img, dy, dx)
        np.testing.assert_allclose(got, want, atol=2e-5)
    # fractional: different cubics (Catmull-Rom vs prefiltered B-spline)
    # — compare BOTH against the analytic translate of a band-limited
    # image, where any good cubic is ~1e-3 (on edges they legitimately
    # disagree by up to ~0.05, which is why the host twin is not the
    # fractional reference)
    yy, xx = np.meshgrid(np.arange(48.0), np.arange(40.0), indexing="ij")

    def smooth(y, x):
        return (0.5 + 0.25 * np.sin(2 * np.pi * y / 16)
                * np.cos(2 * np.pi * x / 16)).astype(np.float32)

    dy, dx = 1.4, -2.6
    truth = smooth(yy - dy, xx - dx)
    got = np.asarray(jsh(smooth(yy, xx), dy, dx))
    want = shift_image(smooth(yy, xx), dy, dx)
    assert np.abs(got[4:-4, 4:-4] - truth[4:-4, 4:-4]).max() < 2e-3
    assert np.abs(want[4:-4, 4:-4] - truth[4:-4, 4:-4]).max() < 2e-3
    # color frames shift both spatial axes, never the channel axis
    rgb = np.stack([img, img * 0.5, img * 0.25], axis=-1)
    got3 = np.asarray(jsh(rgb, 3.0, -5.0))
    np.testing.assert_allclose(got3[..., 0],
                               np.asarray(jsh(img, 3.0, -5.0)), atol=1e-6)


def test_register_guide_composes_with_mesh():
    # registration is host-side preprocessing, so it must compose with
    # the rows-sharded guided builder unchanged
    from graphlap.parallel.mesh import make_mesh
    scfg = CONFIG1.replace(streaming=True, block_cols=1024)
    _, frames = _static_scene(b=4)
    z1, _ = filter_video(frames, scfg, temporal_guide=4, register_guide=True)
    z2, _ = filter_video(frames, scfg, mesh=make_mesh(8, 1),
                         temporal_guide=4, register_guide=True)
    np.testing.assert_allclose(z2, z1, atol=3e-4)


def _pan_scene(v=1.0, b=8, side=64, sigma=0.02, seed=3):
    """Camera pan at ``v`` px/frame: integer/subpixel crops of one
    oversized scene."""
    pad = int(np.ceil(v * b)) + 2
    base = make_test_image(side + pad, side + pad, seed=1)
    rng = np.random.default_rng(seed)
    clean = np.stack([base[int(round(t * v)):int(round(t * v)) + side,
                           int(round(t * v)):int(round(t * v)) + side]
                      for t in range(b)])
    frames = np.clip(clean + sigma * rng.standard_normal(clean.shape),
                     0, 1).astype(np.float32)
    return clean, frames


def test_route_temporal_guide_measured_boundaries():
    """The auto-router applies the measured motion table: static scenes
    get the largest registered groups, ~1 px/frame pans route to k=2
    registered (the 64^2 study optimum AND the conservative call at the
    4K pan row), and fast motion declines guided reuse entirely."""
    from graphlap.models.video import (estimate_motion,
                                       route_temporal_guide)

    _, static = _static_scene(b=8)
    assert estimate_motion(static) < 0.2
    assert route_temporal_guide(static, register=True) == (8, True)

    _, pan1 = _pan_scene(v=1.0)
    v_est = estimate_motion(pan1)
    assert 0.7 < v_est < 1.7, f"pan estimate {v_est}"
    assert route_temporal_guide(pan1, register=True) == (2, True)
    # unregistered groups lose at 1 px/frame (k <= 1 + 0.75/v < 2)
    k, reg = route_temporal_guide(pan1, register=False)
    assert (k, reg) == (1, False)

    _, pan4 = _pan_scene(v=4.0)
    with pytest.warns(UserWarning, match="boundary"):
        k, reg = route_temporal_guide(pan4, register=True)
    assert (k, reg) == (1, False)


def test_filter_video_temporal_guide_auto():
    """temporal_guide='auto' end-to-end: a static scene routes to guided
    groups (same output class as explicit k), a fast pan falls back to
    per-frame bases with the boundary warning."""
    clean, frames = _static_scene(b=4)
    za, _ = filter_video(frames, CONFIG1, temporal_guide="auto",
                         register_guide=True)
    z4, _ = filter_video(frames, CONFIG1, temporal_guide=4,
                         register_guide=True)
    np.testing.assert_allclose(za, z4, atol=3e-4)

    _, pan = _pan_scene(v=4.0, b=4)
    with pytest.warns(UserWarning, match="boundary"):
        zp, _ = filter_video(pan, CONFIG1, temporal_guide="auto",
                             register_guide=True)
    zi, _ = filter_video(pan, CONFIG1)
    np.testing.assert_allclose(zp, zi, atol=3e-4)
