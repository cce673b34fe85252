"""Nystrom eigendecomposition with one-shot orthogonalization.

JAX equivalent of the reference's SLEPc EPS solves + extension
MatMatMult (SURVEY.md §2.2 component #6, §1.2 Stage 4, §3.4; Fowlkes et al.
2004). Direct ``jnp.linalg.eigh`` on the replicated p x p blocks replaces the
distributed Krylov solver — p is capped at O(thousands) by design, so direct
is both faster on the MXU and communication-free. The (N, p) x (p, m)
extension GEMMs are embarrassingly row-parallel.

Algorithm (all inverses truncated pseudo-inverses, ops/linalg.py):

1. Whalf = W_AA^{-1/2};  S = W_AA + Whalf (W_AB W_AB^T) Whalf;
   eigh(S) -> top-m (L_S, U_m).
2. basis0 = Whalf U_m L_S^{-1/2}  (p, m);
   extension GEMMs V0 = [W_AA; W_AB^T] basis0  (N, m).
3. Column-norm correction: d_j = |V0_j|^2 (assembled from the two extension
   blocks, no extra N-sized pass); columns with d_j above a live-threshold
   are rescaled to exactly unit norm, the rest are zeroed.

Step 3 is the f32 safety net: with a truncated pseudo-inverse on
rank-deficient kernel blocks, f32 rounding can push spurious directions into
the top-m of S; their defining property is a tiny TRUE column norm (the
f64 oracle's live columns come out at ~1). Pure projection filters are
insensitive (the weight f(lambda)~lambda is tiny there), but affine filters
(sharpening) weight every unit of spurious column mass by ~beta, so the
norms must be policed. A diagonal-only correction is used deliberately: a
full Gram-matrix orthogonalization re-amplifies the garbage columns to unit
norm (measured 0.87 dB parity loss), while the diagonal form kills them.

Exact for p = N (modulo the harmless unit-norm rescale).

This classical one-shot path is kept for reference/compatibility
(``solver="oneshot"``); the DEFAULT is the Cholesky/ridge formulation below
(``solver="chol"``), which is both cheaper (one eigh instead of three) and
tighter on f32-vs-f64 parity (~1e-6 max pixel diff, 100+ dB
agreement even on projection/affine filters, vs 60-99 dB here — the
one-shot's truncated pseudo-inverses carry an eigenbasis-rotation ambiguity
in near-degenerate clusters that Cholesky simply doesn't have).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from .linalg import (
    psd_pinv_sqrt,
    psd_pinv_sqrt_np,
    trunc_inv_sqrt_vals,
    trunc_inv_sqrt_vals_np,
)

# columns whose true squared norm falls below this are spurious (live
# one-shot columns sit at ~1, truncation-killed at 0)
_LIVE_NORM2 = 0.25


class EigenBasis(NamedTuple):
    """Top-m approximate eigenpairs of the scaled filter matrix W~.

    ``vecs`` rows are in permuted [A; B] pixel order; live columns unit-norm,
    truncation-killed/spurious columns exactly zero; descending eigenvalue
    order.
    """

    vals: jnp.ndarray    # (m,)
    vecs: jnp.ndarray    # (N, m)


def nystrom_eigh(waa: jnp.ndarray, wab: jnp.ndarray, m: int,
                 eig_tol: float) -> EigenBasis:
    whalf = psd_pinv_sqrt(waa, eig_tol)
    cross = wab @ wab.T                               # (p, p), one strip GEMM
    s_mat = waa + whalf @ cross @ whalf
    s_mat = 0.5 * (s_mat + s_mat.T)
    vals, vecs = jnp.linalg.eigh(s_mat)               # ascending
    vals_m = vals[::-1][:m]                           # descending top-m
    vecs_m = vecs[:, ::-1][:, :m]

    inv_sqrt_vals = trunc_inv_sqrt_vals(vals_m, eig_tol)
    basis0 = whalf @ (vecs_m * inv_sqrt_vals[None, :])    # (p, m)
    v_a = waa @ basis0                                    # (p, m)
    v_b = wab.T @ basis0                                  # (N-p, m) extension

    d = jnp.sum(v_a * v_a, axis=0) + jnp.sum(v_b * v_b, axis=0)   # (m,)
    live = d > _LIVE_NORM2
    scale = jnp.where(live, 1.0 / jnp.sqrt(jnp.where(live, d, 1.0)), 0.0)
    v = jnp.concatenate([v_a, v_b], axis=0) * scale[None, :]
    return EigenBasis(vals=vals_m, vecs=v)


# ---------------------------------------------------------------------------
# Cholesky/ridge formulation: one eigh total (the fast path)
# ---------------------------------------------------------------------------
#
# XLA's eigh at p ~ 5k is latency-bound while Cholesky/GEMM/triangular-
# solve are not; the one-shot path above needs
# THREE p x p eighs per run (Sinkhorn pinv, Whalf, S). The ridge-regularized
# completion W~ = C (W_AA + eps I)^{-1} C^T admits an exact eigensolve with
# ONE eigh:
#
#   A = W_AA + eps I = L L^T ;  G = C^T C = W_AA^2 + W_AB W_AB^T
#   M = L^{-1} G L^{-T} ;  eigh(M) -> (lambda_i, y_i)
#   V = C L^{-T} Y_m diag(lambda^{-1/2})
#
# because W~ (C x) = C A^{-1} G x, and v_i^T v_j = y_i^T M y_j / sqrt(..)
# = delta_ij — V is EXACTLY orthonormal by construction. Unlike the
# eigh-built ridge inverse (see ops/linalg.py docstring), Cholesky +
# triangular solves are backward-stable with no basis-rotation ambiguity,
# so this is f32-safe. eps is relative to an upper bound on lambda_max
# (max row sum — cheap and precision-stable).


def _ridge_eps(mat: jnp.ndarray, rel: float) -> jnp.ndarray:
    return rel * jnp.max(jnp.sum(jnp.abs(mat), axis=1))


def nystrom_chol_factor(waa: jnp.ndarray, cross: jnp.ndarray, m: int,
                        eig_tol: float, method: str = "eigh",
                        lobpcg_iters: int = 60):
    """Shared chol/ridge core: (vals (m,), factor X (p, m)) with V = C X.

    ``cross`` is W_AB W_AB^T however the caller produced it (dense GEMM or
    streaming accumulation). ``method``:

    * "eigh":   full dense eigh of M, slice top-m (exact).
    * "lobpcg": top-m only via jax's LOBPCG — O(p^2 m) per iteration
      instead of O(p^3); a dense eigh at p ~ 5k is latency-bound while
      LOBPCG's work is GEMMs. Deterministic fixed-seed start block.
    """
    import jax.scipy.linalg as jsl

    p = waa.shape[0]
    eps = _ridge_eps(waa, eig_tol)
    l = jnp.linalg.cholesky(waa + eps * jnp.eye(p, dtype=waa.dtype))
    g = waa @ waa + cross
    t1 = jsl.solve_triangular(l, g, lower=True)            # L^{-1} G
    m_mat = jsl.solve_triangular(l, t1.T, lower=True)      # L^{-1} G^T L^{-T}
    m_mat = 0.5 * (m_mat + m_mat.T)

    if method == "lobpcg" and 5 * m >= p:
        method = "eigh"          # LOBPCG needs search dim * 5 < p; small p
                                 # is cheap for dense eigh anyway
    if method == "lobpcg":
        import jax
        from jax.experimental.sparse.linalg import lobpcg_standard

        x0 = jax.random.normal(jax.random.PRNGKey(0), (p, m), m_mat.dtype)
        vals_m, y_m, _ = lobpcg_standard(lambda v: m_mat @ v, x0,
                                         m=lobpcg_iters)
        order = jnp.argsort(vals_m)[::-1]
        vals_m = vals_m[order]
        y_m = y_m[:, order]
    else:
        vals, y = jnp.linalg.eigh(m_mat)                   # the ONE eigh
        vals_m = vals[::-1][:m]
        y_m = y[:, ::-1][:, :m]

    inv_sqrt = trunc_inv_sqrt_vals(vals_m, eig_tol)
    x = jsl.solve_triangular(l, y_m * inv_sqrt[None, :],
                             lower=True, trans="T")        # (p, m) factor
    return vals_m, x


# ---------------------------------------------------------------------------
# Randomized sketch solver: top-m of M without forming G
# ---------------------------------------------------------------------------
#
# The chol path above must materialize G = W_AA^2 + W_AB W_AB^T; its cross
# GEMM is O(p^2 N) and runs near the matrix units' peak — at roofline,
# only avoidable ALGORITHMICALLY. Randomized subspace iteration (Halko,
# Martinsson & Tropp 2011) needs only M-applies on a (p, k) block with
# k = m + oversample: each apply touches the strip twice as THIN passes,
# O(p N k) — ~20x fewer FLOPs than the cross GEMM at cfg2's k=128 vs
# p=5243. Kernel spectra decay fast, so 1-2 power iterations with a
# 1.5-2.5x oversampled block capture the top-m subspace to parity-gate
# accuracy (measured: see BASELINE.md cfg2 sketch row).
#
# Orthonormalization is two-round, not Householder QR (jnp.linalg.qr's
# panel factorization is latency-bound on accelerators). Round 1 is RANK-SAFE
# eigh-based whitening: after power steps on a fast-decaying kernel
# spectrum, cond(Y) can exceed 1e7, so the Gram's condition (cond(Y)^2)
# overflows f32 and a Cholesky NaNs — hit in production by the gaussian
# kernel at 256^2 (lambda_50 ~ 1.6e-5 already), where CholeskyQR2
# (Yamamoto et al. 2015, cond <= ~1e7) silently destroyed the output. The
# k x k eigh floors collapsed directions instead: they surface as
# near-zero Ritz values and fall outside the kept top-m. Round 2 is one
# CholQR polish — its Gram is ~I, so the Cholesky is unconditionally safe
# and restores orthonormality to machine precision (pure MXU work).


def _orthonormalize(y: jnp.ndarray, rel: float = 1e-6) -> jnp.ndarray:
    import jax.scipy.linalg as jsl

    k = y.shape[1]
    g = y.T @ y
    g = 0.5 * (g + g.T)
    w, s = jnp.linalg.eigh(g)                           # ascending
    w = jnp.maximum(w, rel * w[-1])
    y = y @ (s * (w ** -0.5)[None, :]) @ s.T            # Y G^{-1/2}, sym
    g = y.T @ y
    g = 0.5 * (g + g.T)
    r = jnp.linalg.cholesky(g + 1e-7 * jnp.eye(k, dtype=g.dtype))
    return jsl.solve_triangular(r, y.T, lower=True).T   # Y L^{-T}


def _strip_sandwich(wab: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """W_AB (W_AB^T t) — two thin strip passes, never a p x p product.

    A bfloat16-stored strip runs native single-pass MXU GEMMs (f32
    accumulate; rounding the thin f32 operands to bf16 is the same numeric
    class as the bf16 cross GEMM, measured 1e-4 dB at cfg2). f32 strips
    keep the package-wide HIGHEST contract."""
    if wab.dtype == jnp.bfloat16:
        u = jnp.dot(wab.T, t.astype(jnp.bfloat16),
                    preferred_element_type=jnp.float32, precision="default")
        return jnp.dot(wab, u.astype(jnp.bfloat16),
                       preferred_element_type=jnp.float32, precision="default")
    return wab @ (wab.T @ t)


def nystrom_sketch_factor(waa: jnp.ndarray, wab: jnp.ndarray, m: int,
                          eig_tol: float, oversample: int = 78,
                          power: int = 2, sandwich=None):
    """(vals (m,), factor X (p, m)) with V = C X — drop-in for
    nystrom_chol_factor's output contract, via randomized subspace
    iteration on M = L^{-1} (W_AA^2 + W_AB W_AB^T) L^{-T}.

    ``sandwich``: optional callable t (p, k) -> W_AB W_AB^T t replacing
    the materialized ``wab`` (which may then be None). Callers with a
    large UNSCALED strip (models/streaming strip_cache) fold the Sinkhorn
    scales into the thin passes here instead of materializing a second
    scaled (p, N) strip — same two strip reads per apply, minus the full
    O(pN) write+read round trip. Rounding moves from the strip entries to
    the thin operands: the same bf16-GEMM-input class, measured at
    parity."""
    import jax
    import jax.scipy.linalg as jsl

    p = waa.shape[0]
    k = min(m + oversample, p)
    eps = _ridge_eps(waa, eig_tol)
    l = jnp.linalg.cholesky(waa + eps * jnp.eye(p, dtype=waa.dtype))
    if sandwich is None:
        sandwich = lambda t: _strip_sandwich(wab, t)

    def m_apply(v):                                    # (p, k) -> M v
        t = jsl.solve_triangular(l, v, lower=True, trans="T")
        u = waa @ (waa @ t) + sandwich(t)
        return jsl.solve_triangular(l, u, lower=True)

    y = m_apply(jax.random.normal(jax.random.PRNGKey(0), (p, k), waa.dtype))
    for _ in range(power):
        y = m_apply(_orthonormalize(y))
    q = _orthonormalize(y)
    b = q.T @ m_apply(q)                               # Rayleigh–Ritz (k, k)
    b = 0.5 * (b + b.T)
    vals, s = jnp.linalg.eigh(b)                       # ascending, k x k
    vals_m = vals[::-1][:m]
    y_m = q @ s[:, ::-1][:, :m]                        # Ritz vectors of M
    inv_sqrt = trunc_inv_sqrt_vals(vals_m, eig_tol)
    x = jsl.solve_triangular(l, y_m * inv_sqrt[None, :],
                             lower=True, trans="T")
    return vals_m, x


def nystrom_eigh_sketch(waa: jnp.ndarray, wab: jnp.ndarray, m: int,
                        eig_tol: float, oversample: int = 78,
                        power: int = 2) -> EigenBasis:
    vals_m, x = nystrom_sketch_factor(waa, wab, m, eig_tol, oversample,
                                      power)
    v_a = waa @ x
    v_b = wab.T @ x
    return EigenBasis(vals=vals_m, vecs=jnp.concatenate([v_a, v_b], axis=0))


def _cross_gemm(wab: jnp.ndarray, gemm_dtype) -> jnp.ndarray:
    """W_AB W_AB^T with optional bf16 inputs (f32 accumulate, 1 MXU pass;
    ~6x the f32-HIGHEST rate). The ~4e-3 relative input rounding perturbs
    G and shifts tail eigenvalues by <1%; quality impact is measured in
    the bf16 benchmark row."""
    if gemm_dtype == jnp.bfloat16:
        wb = wab.astype(jnp.bfloat16)
        return jnp.dot(wb, wb.T, preferred_element_type=jnp.float32,
                       precision="default")
    return wab @ wab.T


def nystrom_eigh_chol(waa: jnp.ndarray, wab: jnp.ndarray, m: int,
                      eig_tol: float, method: str = "eigh",
                      gemm_dtype=jnp.float32,
                      lobpcg_iters: int = 60) -> EigenBasis:
    vals_m, x = nystrom_chol_factor(waa, _cross_gemm(wab, gemm_dtype), m,
                                    eig_tol, method, lobpcg_iters)
    v_a = waa @ x
    v_b = wab.T @ x
    return EigenBasis(vals=vals_m, vecs=jnp.concatenate([v_a, v_b], axis=0))


def nystrom_eigh_chol_np(waa: np.ndarray, wab: np.ndarray, m: int,
                         eig_tol: float):
    import scipy.linalg as sl

    p = waa.shape[0]
    eps = eig_tol * np.max(np.sum(np.abs(waa), axis=1))
    l = np.linalg.cholesky(waa + eps * np.eye(p))
    g = waa @ waa + wab @ wab.T
    t1 = sl.solve_triangular(l, g, lower=True)
    m_mat = sl.solve_triangular(l, t1.T, lower=True)
    m_mat = 0.5 * (m_mat + m_mat.T)
    vals, y = np.linalg.eigh(m_mat)
    vals_m = vals[::-1][:m].copy()
    y_m = y[:, ::-1][:, :m]
    inv_sqrt = trunc_inv_sqrt_vals_np(vals_m, eig_tol)
    x = sl.solve_triangular(l, y_m * inv_sqrt[None, :], lower=True, trans="T")
    v = np.concatenate([waa @ x, wab.T @ x], axis=0)
    return vals_m, v


# --- numpy float64 twin for the CPU oracle ----------------------------------

def nystrom_eigh_np(waa: np.ndarray, wab: np.ndarray, m: int,
                    eig_tol: float):
    whalf = psd_pinv_sqrt_np(waa, eig_tol)
    cross = wab @ wab.T
    s_mat = waa + whalf @ cross @ whalf
    s_mat = 0.5 * (s_mat + s_mat.T)
    vals, vecs = np.linalg.eigh(s_mat)
    vals_m = vals[::-1][:m].copy()
    vecs_m = vecs[:, ::-1][:, :m]

    inv_sqrt_vals = trunc_inv_sqrt_vals_np(vals_m, eig_tol)
    basis0 = whalf @ (vecs_m * inv_sqrt_vals[None, :])
    v_a = waa @ basis0
    v_b = wab.T @ basis0

    d = np.sum(v_a * v_a, axis=0) + np.sum(v_b * v_b, axis=0)
    live = d > _LIVE_NORM2
    scale = np.where(live, 1.0 / np.sqrt(np.where(live, d, 1.0)), 0.0)
    v = np.concatenate([v_a, v_b], axis=0) * scale[None, :]
    return vals_m, v
