"""filter_mode="chebyshev": f(W) y by Chebyshev series + matvec recurrence.

The eigensolve-free path for NON-polynomial lambda-functions (exp_decay,
fractional power/twicing) — Hammond, Vandergheynst & Gribonval 2011 §6.
Correctness anchor: the exact dense f(M) y computed from the explicitly
materialized completion operator (small N, float64 eigendecomposition).
"""

import numpy as np
import pytest

from graphlap import add_gaussian_noise, filter_image, make_test_image
from graphlap.config import PipelineConfig
from graphlap.ops.filters import (FILTER_REGISTRY, apply_chebyshev_filter,
                                  chebyshev_coeffs)

from .oracle import oracle_filter_image


def _cfg(**kw):
    base = dict(kernel="nlm", patch_size=5, h=0.2, sample_rho=0.03,
                num_eigvecs=20, normalization="sinkhorn", sinkhorn_iters=20,
                filter_name="exp_decay", filter_param=2.0,
                filter_mode="chebyshev", cheb_degree=12)
    base.update(kw)
    return PipelineConfig(**base)


def test_coeffs_reproduce_f_on_nodes():
    # the degree-K series interpolates f at the K+1 Chebyshev nodes, and
    # for an analytic f the max error on [-1,1] decays geometrically
    # fractional 'power' is only C^2 at lambda=0 (sign-safe |l|^k), so its
    # series converges algebraically, not geometrically — the looser bound
    # is intrinsic, not a bug (analytic filters hit ~1e-15 at degree 16)
    for name, param, tol in (("exp_decay", 2.0, 5e-4), ("power", 2.5, 2e-3),
                             ("sharpen", 0.6, 5e-4), ("twicing", 2.5, 5e-4)):
        c = chebyshev_coeffs(name, param, 16)
        x = np.linspace(-1, 1, 401)
        tk = np.cos(np.outer(np.arange(17), np.arccos(x)))
        approx = c @ tk
        exact = FILTER_REGISTRY[name].fn(x, param)
        assert np.max(np.abs(approx - exact)) < tol, name


def test_chebyshev_matches_exact_dense_operator():
    """Materialize the completion operator column-by-column via the same
    wapply the pipeline uses (float64 oracle machinery), eigendecompose it
    fully, and compare f(M) y exact vs the Chebyshev recurrence."""
    from graphlap.ops.affinity import extract_features_np
    from graphlap.ops.sinkhorn import (_make_kaa_solve_np,
                                       normalize_blocks_np,
                                       nystrom_matvec_np)
    from graphlap.utils.sampling import uniform_grid_sample

    side = 24
    img = make_test_image(side, side).astype(np.float64)
    cfg = _cfg()
    plan = uniform_grid_sample(side, side, cfg.num_samples(side * side))
    feats = extract_features_np(img, cfg)[plan.perm]
    from graphlap.ops.affinity import affinity_strip_np
    strip = affinity_strip_np(feats[: plan.p], feats)
    kaa, kab = strip[:, : plan.p], strip[:, plan.p:]
    waa, wab, s_a, s_b = normalize_blocks_np(kaa, kab, "sinkhorn", 20,
                                             cfg.eig_tol, cfg.solver)
    solve = _make_kaa_solve_np(kaa, cfg.eig_tol, cfg.solver)
    p = plan.p

    def wapply(x):
        top, bottom = nystrom_matvec_np(kaa, kab, solve, s_a * x[:p],
                                        s_b * x[p:])
        return np.concatenate([s_a * top, s_b * bottom])

    n = side * side
    m_op = np.stack([wapply(np.eye(n)[:, i]) for i in range(n)], axis=1)
    m_op = 0.5 * (m_op + m_op.T)          # symmetric by construction
    vals, vecs = np.linalg.eigh(m_op)
    assert vals.min() > -1.0001 and vals.max() < 1.0001
    y = img.ravel()[plan.perm]

    for name, param in (("exp_decay", 2.0), ("power", 2.5),
                        ("twicing", 2.5)):
        f = FILTER_REGISTRY[name]
        # full-rank ground truth: direct f(M) y (for affine filters the
        # identity part is exact here since the basis is complete)
        exact = vecs @ (f.fn(vals, param) * (vecs.T @ y))
        got = apply_chebyshev_filter(wapply, y, name, param, 16)
        rel = np.linalg.norm(got - exact) / np.linalg.norm(exact)
        assert rel < 1e-3, (name, rel)


def test_degree_convergence():
    """Error vs the high-degree reference shrinks monotonically in class."""
    rng = np.random.default_rng(0)
    lam = np.sort(rng.uniform(-0.2, 1.0, 64))
    q, _ = np.linalg.qr(rng.standard_normal((64, 64)))
    m_op = q @ np.diag(lam) @ q.T
    y = rng.standard_normal(64)
    wapply = lambda x: m_op @ x
    exact = q @ (np.exp(-2.0 * (1 - lam)) * (q.T @ y))
    errs = [np.linalg.norm(
        apply_chebyshev_filter(wapply, y, "exp_decay", 2.0, d) - exact)
        for d in (4, 8, 12, 16)]
    assert errs[1] < errs[0] and errs[2] < errs[1] / 2
    assert errs[3] < 1e-8


def test_pipeline_chebyshev_matches_oracle():
    img = make_test_image(64, 64)
    noisy = np.clip(add_gaussian_noise(img, 0.05, seed=7), 0, 1)
    for cfg in (_cfg(), _cfg(filter_name="power", filter_param=2.5),
                _cfg(streaming=True, block_cols=1024)):
        res = filter_image(noisy, cfg)
        orc, _ = oracle_filter_image(noisy, cfg)
        assert np.max(np.abs(res.image - orc)) < 2e-5
        assert res.eigvals.shape == (0,)


def test_chebyshev_matches_matvec_on_exact_polynomials():
    """For an exactly representable polynomial (sharpen: degree 1) the
    degree-12 series IS the polynomial — chebyshev must agree with the
    exact matvec mode to float tolerance through the full pipeline."""
    img = make_test_image(64, 64)
    noisy = np.clip(add_gaussian_noise(img, 0.05, seed=3), 0, 1)
    mv = filter_image(noisy, _cfg(filter_name="sharpen", filter_param=0.6,
                                  filter_mode="matvec"))
    ch = filter_image(noisy, _cfg(filter_name="sharpen", filter_param=0.6))
    assert np.max(np.abs(mv.image - ch.image)) < 1e-4


def test_auto_degree_resolves_polynomials_exactly():
    """cheb_degree=0 picks the TRUE degree for exact polynomials: the
    64-node quadrature is exact there, so coefficients past the true
    degree are ~1e-16 and the tail bound collapses immediately."""
    from graphlap.ops.filters import chebyshev_auto_degree
    assert chebyshev_auto_degree("sharpen", 0.6) == 1
    assert chebyshev_auto_degree("identity", 0.0) == 1
    assert chebyshev_auto_degree("power", 3.0) == 3
    assert chebyshev_auto_degree("twicing", 2.0) == 2


def test_auto_degree_bound_holds_on_smooth_filters():
    """The tail bound the auto pick certifies is a real sup-norm bound:
    check |f - S_K|_inf on a dense grid at the resolved degree."""
    from graphlap.ops.filters import (chebyshev_auto_degree,
                                      chebyshev_tail_bound)
    x = np.linspace(-1, 1, 2001)
    for name, param in (("exp_decay", 2.0), ("exp_decay", 4.0),
                        ("sharpen", 1.5)):
        k = chebyshev_auto_degree(name, param, tol=1e-6)
        assert 1 <= k <= 32, (name, k)
        c = chebyshev_coeffs(name, param, k)
        tk = np.cos(np.outer(np.arange(k + 1), np.arccos(x)))
        err = np.max(np.abs(c @ tk - FILTER_REGISTRY[name].fn(x, param)))
        # grid error <= certified bound + the fit's own aliasing slack
        assert err < 2e-6, (name, k, err)
        assert chebyshev_tail_bound(name, param, k) <= 1e-6


def test_auto_degree_clamps_on_nonsmooth_filters():
    # fractional power has a |lambda|^p kink at 0: algebraic convergence,
    # the 1e-6 tail is unreachable by 64 — auto clamps rather than loops
    from graphlap.ops.filters import chebyshev_auto_degree
    assert chebyshev_auto_degree("power", 2.5) == 64


def test_pipeline_auto_degree_matches_explicit():
    """cheb_degree=0 through the full pipeline == the explicitly resolved
    degree, bit-for-bit (same static unroll)."""
    from graphlap.ops.filters import chebyshev_auto_degree
    img = make_test_image(48, 48)
    noisy = np.clip(add_gaussian_noise(img, 0.05, seed=5), 0, 1)
    k = chebyshev_auto_degree("exp_decay", 2.0)
    auto = filter_image(noisy, _cfg(cheb_degree=0))
    expl = filter_image(noisy, _cfg(cheb_degree=k))
    assert np.array_equal(auto.image, expl.image)


def test_chebyshev_config_validation():
    with pytest.raises(ValueError, match="lambda-function"):
        _cfg(filter_name="lowpass")
    with pytest.raises(ValueError, match="cheb_degree"):
        _cfg(cheb_degree=-1)
    _cfg(cheb_degree=0)                 # 0 = auto (resolved at apply time)
    # the raw (unnormalized) completion's spectral radius is the max row
    # sum (~1e3+): T_k diverges off [-1,1] and the recurrence returns NaNs
    # by degree ~12 — rejected at config time, not discovered as NaN pixels
    with pytest.raises(ValueError, match="normalized"):
        _cfg(normalization="none")
    # fractional exponents are the POINT of this mode
    _cfg(filter_name="power", filter_param=1.7)
    _cfg(filter_name="twicing", filter_param=2.5)
