"""Pallas kernels (Triton route) vs the float64 oracle and their XLA
twins, in interpret mode on the CPU; the compiled kernels are checked on
the GPU by tests/test_gpu.py and chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest

from graphlap.config import PipelineConfig
from graphlap.io import make_test_image
from graphlap.ops.affinity import affinity_strip_np, extract_features_np
from graphlap.ops.pallas_affinity import affinity_strip_pallas
from graphlap.utils.sampling import uniform_grid_sample


@pytest.fixture(scope="module")
def feats():
    img = make_test_image(48, 48, seed=3)
    cfg = PipelineConfig(kernel="nlm", h=0.25, spatial_h=24.0)
    plan = uniform_grid_sample(48, 48, 100)
    return extract_features_np(img, cfg)[plan.perm]


def test_pallas_matches_oracle_f32(feats):
    truth = affinity_strip_np(feats[:100], feats)
    out = np.asarray(affinity_strip_pallas(
        jnp.asarray(feats[:100], jnp.float32), jnp.asarray(feats, jnp.float32)))
    assert out.shape == truth.shape
    np.testing.assert_allclose(out, truth, atol=5e-5)


def test_pallas_bf16_reasonable(feats):
    truth = affinity_strip_np(feats[:100], feats)
    out = np.asarray(affinity_strip_pallas(
        jnp.asarray(feats[:100], jnp.float32), jnp.asarray(feats, jnp.float32),
        dtype=jnp.bfloat16))
    assert np.abs(out - truth).max() < 2e-2


def test_pallas_unaligned_shapes(feats):
    """p and N not multiples of the tile sizes -> padding is exact."""
    sub = feats[:77]
    truth = affinity_strip_np(sub, feats[:1000])
    out = np.asarray(affinity_strip_pallas(
        jnp.asarray(sub, jnp.float32), jnp.asarray(feats[:1000], jnp.float32)))
    assert out.shape == (77, 1000)
    np.testing.assert_allclose(out, truth, atol=5e-5)


def test_pallas_feature_dim_guard():
    big = jnp.zeros((8, 200), jnp.float32)
    with pytest.raises(ValueError):
        affinity_strip_pallas(big, big)


def test_pipeline_with_pallas_flag(feats):
    """cfg.use_pallas routes the fused kernel through the full pipeline."""
    from graphlap import filter_image
    img = make_test_image(48, 48, seed=3)
    cfg = PipelineConfig(kernel="nlm", h=0.25, sample_rho=0.04, num_eigvecs=16)
    a = filter_image(img, cfg)
    b = filter_image(img, cfg.replace(use_pallas=True))
    np.testing.assert_allclose(a.image, b.image, atol=1e-4)


def test_streaming_kernels_narrow_d_pad():
    """The kernels accept the production (d_pad_of = 32)-wide feature
    layout — the capacity-enabling one: the 128-wide transposed copy is
    5.1x the NLM data (17 GB at 64 MP bf16), the 32-wide one 1.28x —
    and match the legacy 128-wide pads to reduction-order noise (zero
    feature columns are exact no-ops in the dots; the norm reductions
    re-associate with the padded width, so last-ulp, not bitwise)."""
    import jax.numpy as jnp

    from graphlap.ops import pallas_streaming as pst

    rng = np.random.default_rng(7)
    p, n_pad, d = 512, 1024, 25
    assert pst.d_pad_of(d) == 32
    # realistic feature scale (unit-scale features drive exp(-d2) to 0)
    feats_a = rng.normal(0, 0.1, size=(p, d)).astype(np.float32)
    feats = rng.normal(0, 0.1, size=(n_pad, d)).astype(np.float32)
    v = rng.normal(size=(n_pad,)).astype(np.float32)
    t = rng.normal(size=(p,)).astype(np.float32)
    _, p_pad = pst.p_tiling(p)

    def pads(dp, dtype):
        fa = (jnp.zeros((p_pad, dp), dtype)
              .at[:p, :d].set(jnp.asarray(feats_a, dtype)))
        ft = (jnp.zeros((dp, n_pad), dtype)
              .at[:d, :].set(jnp.asarray(feats, dtype).T))
        return fa, ft

    for dtype, rtol in ((jnp.float32, 1e-5), (jnp.bfloat16, 1e-2)):
        fa32, ft32 = pads(32, dtype)
        fa128, ft128 = pads(128, dtype)
        np.testing.assert_allclose(
            np.asarray(pst.matvec_pallas(fa32, ft32, jnp.asarray(v))),
            np.asarray(pst.matvec_pallas(fa128, ft128, jnp.asarray(v))),
            rtol=rtol, atol=rtol)
        np.testing.assert_allclose(
            np.asarray(pst.rmatvec_pallas(fa32, ft32, jnp.asarray(t))),
            np.asarray(pst.rmatvec_pallas(fa128, ft128, jnp.asarray(t))),
            rtol=rtol, atol=rtol)

    # mismatched / unaligned pads must refuse loudly, not compute garbage
    fa32, ft32 = pads(32, jnp.float32)
    _, ft128 = pads(128, jnp.float32)
    with pytest.raises(ValueError, match="d_pad_of"):
        pst.matvec_pallas(fa32, ft128, jnp.asarray(v))
    with pytest.raises(ValueError, match="multiple"):
        pst.rmatvec_pallas(fa32[:, :24], ft32[:24], jnp.asarray(t))


# ---------------------------------------------------------------------------
# Triton-route streaming matvecs (interpret mode) vs the float64 oracle
# strip and the XLA scan twin
# ---------------------------------------------------------------------------

def _streaming_operands(p, n, dtype, seed=0):
    """Real NLM features of a noisy test image (the oracle's numpy feature
    twin), padded to the kernels' own tiling, plus positive vectors."""
    from graphlap.ops import pallas_streaming as pst

    side = int(np.ceil(np.sqrt(n)))
    img = make_test_image(side, side, seed=seed)
    cfg = PipelineConfig(kernel="nlm", h=0.25)
    feats = extract_features_np(img, cfg)[:n]
    rng = np.random.default_rng(seed)
    idx = np.sort(rng.choice(n, p, replace=False))
    fa, fn = feats[idx], feats
    n_pad = pst.n_pad_for(n)
    fa_pad, f_t = pst.feature_pads(jnp.asarray(fa, jnp.float32),
                                   jnp.asarray(fn, jnp.float32), n_pad, dtype)
    v = rng.uniform(0.5, 1.5, n)
    t = rng.uniform(0.5, 1.5, p)
    return fa, fn, fa_pad, f_t, v, t


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("p,n", [(64, 2048),      # whole tiles
                                 (100, 3001),     # p, N off the tiles, odd N
                                 (37, 1961)])     # p under one tile
@pytest.mark.parametrize("kernel", ["matvec", "rmatvec"])
def test_triton_matvecs_match_oracle_and_xla(kernel, p, n, dtype):
    from graphlap.ops import pallas_streaming as pst
    from graphlap.ops import streaming as st

    fa, fn, fa_pad, f_t, v, t = _streaming_operands(p, n, dtype)
    # the oracle strip on the operands the kernel sees (bf16-rounded
    # features when the tiles are bf16), in float64
    fa_r = np.asarray(jnp.asarray(fa, jnp.float32).astype(dtype), np.float64)
    fn_r = np.asarray(jnp.asarray(fn, jnp.float32).astype(dtype), np.float64)
    k_oracle = affinity_strip_np(fa_r, fn_r)
    ones_p, ones_n = jnp.ones(p, jnp.float32), jnp.ones(n, jnp.float32)
    if kernel == "matvec":
        vk = jnp.zeros(f_t.shape[1], jnp.float32).at[:n].set(v)
        out = np.asarray(pst.matvec_pallas(fa_pad, f_t, vk))
        ref = k_oracle @ v
        xla = np.asarray(st.matvec(jnp.asarray(fa_r, jnp.float32),
                                   jnp.asarray(fn_r, jnp.float32),
                                   jnp.asarray(v, jnp.float32), ones_p,
                                   ones_n, n, jnp.float32))
        body, pad = out[:p], out[p:]
    else:
        tk = jnp.zeros(fa_pad.shape[0], jnp.float32).at[:p].set(t)
        out = np.asarray(pst.rmatvec_pallas(fa_pad, f_t, tk))
        ref = k_oracle.T @ t
        xla = np.asarray(st.rmatvec(jnp.asarray(fa_r, jnp.float32),
                                    jnp.asarray(fn_r, jnp.float32),
                                    jnp.asarray(t, jnp.float32), ones_p,
                                    ones_n, n, jnp.float32))
        body, pad = out[:n], out[n:]
    scale = np.abs(ref).max()
    assert np.abs(body - ref).max() <= 1e-5 * scale
    assert np.abs(body - xla).max() <= 1e-5 * scale
    assert np.isfinite(pad).all()


@pytest.mark.parametrize("kernel", ["matvec", "rmatvec"])
def test_triton_matvecs_padding_is_exact(kernel):
    """Zero vector entries make the padded rows/columns exact no-ops, even
    when the padded FEATURES hold garbage (the contract callers rely on)."""
    from graphlap.ops import pallas_streaming as pst

    p, n = 100, 3001
    _, _, fa_pad, f_t, v, t = _streaming_operands(p, n, jnp.float32, seed=3)
    junk_fa = fa_pad.at[p:].set(7.0)
    junk_ft = f_t.at[:, n:].set(-3.0)
    if kernel == "matvec":
        vk = jnp.zeros(f_t.shape[1], jnp.float32).at[:n].set(v)
        clean = pst.matvec_pallas(fa_pad, f_t, vk)[:p]
        dirty = pst.matvec_pallas(junk_fa, junk_ft, vk)[:p]
    else:
        tk = jnp.zeros(fa_pad.shape[0], jnp.float32).at[:p].set(t)
        clean = pst.rmatvec_pallas(fa_pad, f_t, tk)[:n]
        dirty = pst.rmatvec_pallas(junk_fa, junk_ft, tk)[:n]
    np.testing.assert_array_equal(np.asarray(clean), np.asarray(dirty))


def test_triton_matvec_tiling_helpers():
    """Pads follow the kernels' own tiles; the matvec n-split is a
    power-of-two divisor of the n tile count; off-tile pads refuse."""
    from graphlap.ops import pallas_streaming as pst

    assert pst.p_tiling(4096) == (pst.TILE_P, 4096)
    assert pst.p_tiling(5243)[1] % pst.TILE_P == 0
    for n in (1, 1961, 2048, 8 * 2**20 + 5):
        q = pst.n_pad_for(n)
        assert q >= n and q % (16 * pst.TILE_N) == 0
    for p_pad, n_tiles in ((4096, 65536), (64, 16), (640, 24), (64, 1)):
        s = pst._matvec_splits(p_pad, n_tiles, pst.TILE_P)
        assert s & (s - 1) == 0 and n_tiles % s == 0
        assert (p_pad // pst.TILE_P) * s <= 2 * pst.MATVEC_TARGET_BLOCKS
    fa = jnp.zeros((100, 32), jnp.float32)            # p not tile-padded
    with pytest.raises(ValueError, match="p_tiling"):
        pst.matvec_pallas(fa, jnp.zeros((32, 2048)), jnp.zeros(2048))
    fa = jnp.zeros((64, 32), jnp.float32)             # n not tile-padded
    with pytest.raises(ValueError, match="n_pad_for"):
        pst.rmatvec_pallas(fa, jnp.zeros((32, 2000)), jnp.zeros(64))


@pytest.mark.parametrize("backend,expect", [("cpu", True), ("gpu", False),
                                            ("metal", None)])
def test_interpret_mode_follows_backend(backend, expect, monkeypatch):
    """ONE helper picks how every Pallas kernel runs: interpret on the CPU
    backend, compiled through Triton on a GPU, refused elsewhere."""
    import jax

    from graphlap.ops import pallas_streaming as pst

    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    if expect is None:
        with pytest.raises(NotImplementedError, match="Triton"):
            pst.interpret_mode()
    else:
        assert pst.interpret_mode() is expect


def test_every_pallas_call_names_its_route():
    """No pallas_call without backend="triton" (an unnamed route defaults
    to Mosaic GPU in this JAX), and no import of another chip's Pallas
    dialect."""
    import ast
    import pathlib

    root = pathlib.Path(__file__).resolve().parent.parent / "graphlap"
    calls = 0
    for path in root.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.ImportFrom) and node.module
                    and node.module.startswith("jax.experimental.pallas")):
                names = {a.name for a in node.names}
                assert (node.module == "jax.experimental.pallas.triton"
                        or names <= {"triton"}), f"{path}:{node.lineno}"
            if (isinstance(node, ast.Call)
                    and getattr(node.func, "attr", None) == "pallas_call"):
                calls += 1
                kw = {k.arg: k.value for k in node.keywords}
                assert "backend" in kw, f"{path}:{node.lineno}"
                assert kw["backend"].value == "triton", f"{path}:{node.lineno}"
    assert calls == 3     # matvec, rmatvec, affinity emitter


def test_affinity_emitter_bf16_store_matches_xla(feats):
    """bfloat16_store: f32 distances/exp, bf16 strip — within one bf16 ulp
    of the XLA twin, exact (p, N) shape off the tiles."""
    from graphlap.ops.affinity import affinity_strip

    a = jnp.asarray(feats[:77], jnp.float32)
    b = jnp.asarray(feats[:1500], jnp.float32)
    out = affinity_strip_pallas(a, b, store_dtype=jnp.bfloat16)
    ref = affinity_strip(a, b, jnp.float32, store_dtype=jnp.bfloat16)
    assert out.shape == (77, 1500) and out.dtype == jnp.bfloat16
    diff = jnp.abs(out.astype(jnp.float32) - ref.astype(jnp.float32))
    assert float(diff.max()) <= 2.0 ** -8


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_kernel_checks_report_ok_at_toy_width(dtype):
    """The on-card check bodies (utils/kernel_checks.py) run end to end in
    interpret mode and hold their stated tolerances at a toy width."""
    from graphlap.utils import kernel_checks as kc

    fa, fn, *_ = _streaming_operands(64, 2048, dtype, seed=5)
    rows = kc.check_streaming_kernels(jnp.asarray(fa, jnp.float32),
                                      jnp.asarray(fn, jnp.float32), dtype,
                                      block=1024, runs=1)
    assert [r["kernel"].split("_")[0] for r in rows] == ["matvec", "rmatvec"]
    assert all(r["ok"] for r in rows), rows
