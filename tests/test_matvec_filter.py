"""filter_mode="matvec": exact polynomial f(W) y by strip matvecs.

Why this mode exists (ops/filters.py MATVEC_FILTERS note, measured at
cfg3): kernel spectra collapse into
near-degenerate clusters past the first few eigenvalues, so rank-m AFFINE
filters — which weight the kept basis by f(lambda)-1 ~ beta instead of
damping it by lambda ~ 0 — ride an ill-posed m-dim subspace selection; at
cfg3 every accelerated recipe (and even a lone gram_coarse=4 at full f32)
measured 1.8-4.6 dB off the exact trajectory. The polynomial form skips the
eigensolve entirely and is exact over the FULL Nystrom spectrum.

Parity reference: the float64 oracle's matvec branch (tests/oracle.py),
which composes the independent numpy twins.
"""

import numpy as np
import pytest

from graphlap import add_gaussian_noise, filter_image, make_test_image
from graphlap.config import CONFIG3, PipelineConfig
from graphlap.models.pipeline import (compute_basis, filter_image_staged,
                                      make_plan)

from .oracle import oracle_filter_image


@pytest.fixture(scope="module")
def img64():
    img = make_test_image(64, 64)
    noisy = np.clip(add_gaussian_noise(img, 0.05, seed=7), 0, 1)
    return noisy


def _cfg(**kw):
    base = dict(kernel="nlm", patch_size=5, h=0.15, sample_rho=0.02,
                num_eigvecs=30, normalization="sinkhorn", sinkhorn_iters=20,
                filter_name="sharpen", filter_param=0.6,
                filter_mode="matvec")
    base.update(kw)
    return PipelineConfig(**base)


@pytest.mark.parametrize("name,param", [("sharpen", 0.6), ("identity", 1.0),
                                        ("power", 2.0), ("twicing", 2.0)])
def test_dense_matvec_matches_oracle(img64, name, param):
    cfg = _cfg(filter_name=name, filter_param=param)
    res = filter_image(img64, cfg)
    orc, _ = oracle_filter_image(img64, cfg)
    assert np.max(np.abs(res.image - orc)) < 2e-5
    assert res.eigvals.shape == (0,)          # no eigensolve ran


def test_streaming_matvec_matches_dense(img64):
    cfg = _cfg()
    dense = filter_image(img64, cfg)
    stream = filter_image(img64, cfg.replace(streaming=True,
                                             block_cols=1024))
    assert np.max(np.abs(dense.image - stream.image)) < 1e-5


def test_streaming_matvec_coarse_sinkhorn_close(img64):
    """Coarse Sinkhorn + polish perturbs the scales smoothly — matvec-mode
    output must stay near the full-res trajectory (no subspace cliff)."""
    exact = filter_image(img64, _cfg(streaming=True, block_cols=1024))
    coarse = filter_image(img64, _cfg(streaming=True, block_cols=1024,
                                      sinkhorn_coarse=4, sinkhorn_iters=6,
                                      sinkhorn_polish=1))
    d = exact.image - coarse.image
    agree = -10 * np.log10(max(1e-30, float((d ** 2).mean())))
    assert agree > 40.0, f"coarse-Sinkhorn matvec output only {agree:.1f} dB"


def test_matvec_sharpen_is_unsharp_mask(img64):
    """sharpen in matvec mode is exactly (1+b) y - b W y: the identity
    filter gives W y, so the two runs must combine to the sharpen output
    (before clipping — compare away from the clip rails)."""
    beta = 0.6
    wy = filter_image(img64, _cfg(filter_name="identity")).image
    sh = filter_image(img64, _cfg(filter_name="sharpen",
                                  filter_param=beta)).image
    expect = (1 + beta) * img64 - beta * wy
    interior = (expect > 0.02) & (expect < 0.98)
    assert np.max(np.abs((sh - expect)[interior])) < 1e-4


def test_matvec_matches_exact_dense_operator():
    """INDEPENDENT anchor (the oracle's matvec branch shares
    apply_matvec_filter with the pipeline — pure backend-generic
    arithmetic, but a coefficient/sign bug there would cancel in
    oracle-parity tests): materialize the completion operator densely,
    eigendecompose it fully in float64, and compare f(M) y computed
    SPECTRALLY against the pipeline's recurrence for every matvec-capable
    filter."""
    from graphlap.ops.affinity import affinity_strip_np, extract_features_np
    from graphlap.ops.filters import FILTER_REGISTRY, apply_matvec_filter
    from graphlap.ops.sinkhorn import (_make_kaa_solve_np,
                                       normalize_blocks_np,
                                       nystrom_matvec_np)
    from graphlap.utils.sampling import uniform_grid_sample

    side = 24
    img = make_test_image(side, side).astype(np.float64)
    cfg = _cfg(h=0.25, sample_rho=0.05)
    plan = uniform_grid_sample(side, side, cfg.num_samples(side * side))
    feats = extract_features_np(img, cfg)[plan.perm]
    strip = affinity_strip_np(feats[: plan.p], feats)
    kaa, kab = strip[:, : plan.p], strip[:, plan.p:]
    _, _, s_a, s_b = normalize_blocks_np(kaa, kab, "sinkhorn", 20,
                                         cfg.eig_tol, cfg.solver)
    solve = _make_kaa_solve_np(kaa, cfg.eig_tol, cfg.solver)
    p = plan.p

    def wapply(x):
        top, bottom = nystrom_matvec_np(kaa, kab, solve, s_a * x[:p],
                                        s_b * x[p:])
        return np.concatenate([s_a * top, s_b * bottom])

    n = side * side
    m_op = np.stack([wapply(np.eye(n)[:, i]) for i in range(n)], axis=1)
    vals, vecs = np.linalg.eigh(0.5 * (m_op + m_op.T))
    y = img.ravel()[plan.perm]
    # power=2.0 is the EVEN-k regression: the sign-safe registry form
    # used to return -lam^2 on the completion's negative tail
    # eigenvalues while the matvec mode applied true W^2 (review
    # finding) — integer powers now use the true power in both
    for name, param in (("identity", 1.0), ("power", 3.0), ("power", 2.0),
                        ("sharpen", 0.6), ("twicing", 2.0)):
        exact = vecs @ (FILTER_REGISTRY[name].fn(vals, param)
                        * (vecs.T @ y))
        got = apply_matvec_filter(wapply, y, name, param)
        rel = np.linalg.norm(got - exact) / np.linalg.norm(exact)
        assert rel < 1e-10, (name, rel)


def test_matvec_preserves_constant_image():
    """W is doubly stochastic after Sinkhorn (W 1 = 1), so every polynomial
    filter with f(1) = 1 leaves a constant image unchanged."""
    flat = np.full((48, 48), 0.5, np.float32)
    for name, param in (("sharpen", 0.8), ("twicing", 2.0)):
        res = filter_image(flat, _cfg(filter_name=name, filter_param=param,
                                      h=0.3))
        assert np.max(np.abs(res.image - 0.5)) < 5e-3


def test_matvec_rgb_luma_basis(img64):
    rgb = np.stack([img64, np.roll(img64, 3, axis=0),
                    np.roll(img64, -2, axis=1)], axis=-1)
    cfg = _cfg(rgb_mode="luma_basis")
    res = filter_image(rgb, cfg)
    assert res.image.shape == rgb.shape
    assert res.eigvals.shape == (0,)
    # the luma graph is shared, but each channel is filtered independently
    assert not np.allclose(res.image[..., 0], res.image[..., 1])


def test_matvec_staged_matches_fused(img64):
    for cfg in (_cfg(), _cfg(streaming=True, block_cols=1024)):
        fused = filter_image(img64, cfg)
        staged = filter_image_staged(img64, cfg)
        assert np.max(np.abs(fused.image - staged.image)) < 1e-6
        assert staged.timings["eigensolve"] == 0.0
    # dense LUMA staged path (the one-jit all-channels apply that shares a
    # single K_AA factorization) == fused luma
    rgb = np.stack([img64, np.roll(img64, 3, axis=0),
                    np.roll(img64, -2, axis=1)], axis=-1)
    lcfg = _cfg(rgb_mode="luma_basis")
    fused = filter_image(rgb, lcfg)
    staged = filter_image_staged(rgb, lcfg)
    assert np.max(np.abs(fused.image - staged.image)) < 1e-6
    assert staged.timings["eigensolve"] == 0.0


def test_matvec_config_validation():
    with pytest.raises(ValueError, match="polynomial"):
        _cfg(filter_name="lowpass")
    with pytest.raises(ValueError, match="integer"):
        _cfg(filter_name="power", filter_param=1.5)
    with pytest.raises(ValueError, match="integer"):
        _cfg(filter_name="twicing", filter_param=0.0)
    # sharpen takes any float beta
    _cfg(filter_name="sharpen", filter_param=0.37)


def test_matvec_compute_basis_raises(img64):
    with pytest.raises(ValueError, match="matvec"):
        compute_basis(img64, _cfg())


def test_config3_defaults_to_matvec():
    assert CONFIG3.filter_mode == "matvec"
    # and its plan/feasibility path works at a small stand-in size
    img = make_test_image(96, 96)
    res = filter_image(img, CONFIG3.replace(sample_rho=0.02))
    assert res.image.shape == img.shape


def test_cli_filter_flag_does_not_pin_filter_mode():
    """-filter <name> must NOT prefix-pin filter_mode (argparse resolves the
    exact match to its own flag) or every '-filter sharpen -preset fast'
    run would silently lose the affine->matvec routing; -filter_mode (and
    unambiguous prefixes of it) still pin."""
    from graphlap.cli import _explicit_fields
    assert "filter_mode" not in _explicit_fields(["-filter", "sharpen"])
    # ... -f (the INPUT FILE flag) must not pin it either — caught live by
    # a CLI drive: every real invocation passes -f, which prefix-matched
    # filter_mode and silently disabled the routing (eigensolve came back)
    assert "filter_mode" not in _explicit_fields(["-f", "in.png"])
    assert "filter_mode" in _explicit_fields(["-filter_mode", "spectral"])
    assert "filter_mode" in _explicit_fields(["-filter_m", "spectral"])
    # -save_basis IS a spectral-workflow choice: it pins filter_mode so a
    # preset cannot route the filter to matvec out from under the basis
    assert "filter_mode" in _explicit_fields(["-save_basis", "b.npz"])


def test_matvec_symmetric_normalization(img64):
    """Operator modes compose with every normalization that yields a
    bounded spectrum: symmetric D^-1/2 K D^-1/2 through matvec == oracle."""
    cfg = _cfg(normalization="symmetric")
    res = filter_image(img64, cfg)
    orc, _ = oracle_filter_image(img64, cfg)
    assert np.max(np.abs(res.image - orc)) < 2e-5
    stream = filter_image(img64, cfg.replace(streaming=True,
                                             block_cols=1024))
    assert np.max(np.abs(res.image - stream.image)) < 1e-5


def test_matvec_video_batch(img64):
    """filter_video routes through the batched sharded builder — its
    matvec branch must match per-frame filter_image."""
    from graphlap.models.video import filter_video
    from graphlap.models.pipeline import make_plan
    from graphlap.parallel.mesh import make_mesh

    frames = np.stack([img64, np.roll(img64, 5, axis=0)])
    cfg = _cfg(sample_rho=0.03)
    plan = make_plan(frames[0], cfg)
    out, vals = filter_video(frames, cfg, mesh=make_mesh(n_rows=4, n_data=2),
                             plan=plan, frames_per_step=2)
    assert vals.shape[-1] == 0
    for i in range(2):
        ref = filter_image(frames[i], cfg, plan=plan)
        np.testing.assert_allclose(out[i], ref.image, atol=2e-4)
