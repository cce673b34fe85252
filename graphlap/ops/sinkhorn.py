"""Sinkhorn doubly-stochastic balancing in Nystrom low-rank form.

JAX equivalent of the reference's PETSc MatMult iteration loop
(SURVEY.md §2.2 component #5, §1.2 Stage 3, §3.3; GLIDE Alg. 1). The N x N
filter matrix is never materialized: each iteration does two strip matvecs
against the implicit completion

    K~ = [ K_AA                K_AB              ]
         [ K_BA   K_BA K_AA^+ K_AB               ]

using only the stored (p, N) strip plus one truncated p x p pseudo-inverse — O(Np) per
iteration.

Accelerator-first control flow (SURVEY.md §3.3 note): a fixed-iteration
``lax.fori_loop`` (shape-static, pipelineable) instead of the reference's
convergence-tested while loop; ``sinkhorn_iters`` is config. The symmetric
update ``s <- sqrt(s / (K~ s))`` (Knight 2008) is used instead of r/c
alternation: K~ is symmetric, the geometric-mean step damps the odd/even
oscillation of plain Sinkhorn-Knopp, and the single scaling vector keeps the
scaled matrix exactly symmetric for the eigensolve.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .linalg import psd_pinv, psd_pinv_np

_EPS = 1e-30


def _make_kaa_solve(kaa, eig_tol: float, solver: str):
    """u -> K_AA^+ u (truncated pinv) or (K_AA + eps I)^{-1} u (ridge chol).

    The chol form skips one O(p^3) eigh — the dominant p x p cost at p ~ 5k
    (see ops/nystrom.py chol notes). eps is relative to the max row sum.
    """
    if solver in ("chol", "lobpcg", "sketch"):
        import jax.scipy.linalg as jsl
        eps = eig_tol * jnp.max(jnp.sum(jnp.abs(kaa), axis=1))
        l = jnp.linalg.cholesky(kaa + eps * jnp.eye(kaa.shape[0], dtype=kaa.dtype))
        return lambda u: jsl.cho_solve((l, True), u)
    pinv = psd_pinv(kaa, eig_tol)
    return lambda u: pinv @ u


def _make_kaa_solve_np(kaa, eig_tol: float, solver: str):
    if solver in ("chol", "lobpcg", "sketch"):
        import scipy.linalg as sl
        eps = eig_tol * np.max(np.sum(np.abs(kaa), axis=1))
        cf = sl.cho_factor(kaa + eps * np.eye(kaa.shape[0]), lower=True)
        return lambda u: sl.cho_solve(cf, u)
    pinv = psd_pinv_np(kaa, eig_tol)
    return lambda u: pinv @ u


def nystrom_matvec(kaa, kab, kaa_solve, v_a, v_b):
    """(K~ v) for v = [v_a; v_b], via the strip only. O(Np).

    ``kaa_solve`` applies the (regularized) inverse of K_AA — a callable.
    """
    u = kab @ v_b                      # (p,)
    top = kaa @ v_a + u
    t = v_a + kaa_solve(u)
    bottom = kab.T @ t                 # (N-p,)
    return top, bottom


def sinkhorn_scaling(kaa, kab, iters: int, eig_tol: float,
                     solver: str = "oneshot"):
    """Scaling vector s with diag(s) K~ diag(s) ~ doubly stochastic.

    Returns (s_a (p,), s_b (N-p,)).
    """
    p = kaa.shape[0]
    nb = kab.shape[1]
    kaa_solve = _make_kaa_solve(kaa, eig_tol, solver)

    def body(_, s):
        s_a, s_b = s[:p], s[p:]
        top, bottom = nystrom_matvec(kaa, kab, kaa_solve, s_a, s_b)
        ks = jnp.concatenate([top, bottom])
        ks = jnp.maximum(ks, _EPS)     # K_BB completion can dip negative
        return jnp.sqrt(s / ks)

    s0 = jnp.ones(p + nb, dtype=kaa.dtype)
    s = jax.lax.fori_loop(0, iters, body, s0)
    return s[:p], s[p:]


def sinkhorn_scaling_coarse(kaa, kab, iters: int, coarse: int, polish: int,
                            eig_tol: float, solver: str = "oneshot"):
    """KEEP IN SYNC with models/streaming._normalize_streaming's
    coarse branch (the streaming twin of this fixed point).

    Decimated-column Sinkhorn on the dense strip + full-res polish.

    Same fixed-point structure as the streaming coarse loop
    (models/streaming._normalize_streaming, PAPERS.md "massively scalable
    Sinkhorn via Nystrom"): the iteration only touches the B columns
    through the p-vector u = K_AB s_B with s_B = 1/(K_BA t), so the
    alternating r/c loop can run against a STRIDED 1/k column sample of
    the materialized strip — O(Np/k) per iteration instead of O(Np), with
    ``ratio`` rescaling the decimated sum. One two-vector full-resolution
    extension recovers s_B everywhere (a single strip pass), and
    ``polish`` symmetric full-res iterations contract the decimation bias
    toward the exact fixed point (measured parity: 0.0006-0.044 dB across
    4 seeds at cfg2). Strided, not jittered, for the same measured reason as
    streaming (the coarse fixed point is clumping-sensitive).
    """
    p, nb = kaa.shape[0], kab.shape[1]
    kaa_solve = _make_kaa_solve(kaa, eig_tol, solver)
    kab_c = kab[:, ::coarse]
    ratio = jnp.float32(nb) / jnp.float32(kab_c.shape[1])

    def coarse_u(t):
        y = kab_c.T @ t                                # (nc,) coarse K_BA t
        return ratio * (kab_c @ (1.0 / jnp.maximum(y, _EPS)))

    r0 = jnp.ones(p, jnp.float32)
    u0 = ratio * (kab_c @ jnp.ones(kab_c.shape[1], jnp.float32))
    zero_p = jnp.zeros(p, jnp.float32)

    def body(_, carry):
        r_a, u_r, *_ = carry
        c_a = 1.0 / jnp.maximum(kaa @ r_a + u_r, _EPS)
        t_r = r_a + kaa_solve(u_r)
        u_c = coarse_u(t_r)
        r_a2 = 1.0 / jnp.maximum(kaa @ c_a + u_c, _EPS)
        t_c = c_a + kaa_solve(u_c)
        return (r_a2, coarse_u(t_c), c_a, t_r, t_c)

    r_a, u_r, c_a, t_r, t_c = jax.lax.fori_loop(
        0, iters, body, (r0, u0, r0, zero_p, zero_p))
    s_a = jnp.sqrt(jnp.maximum(r_a * c_a, 0.0))
    kbt = kab.T @ jnp.stack([t_r, t_c], axis=1)        # ONE full strip pass
    s_b = 1.0 / jnp.sqrt(jnp.maximum(kbt[:, 0] * kbt[:, 1], _EPS))

    if polish > 0:
        def pbody(_, s):
            top, bottom = nystrom_matvec(kaa, kab, kaa_solve, s[:p], s[p:])
            ks = jnp.maximum(jnp.concatenate([top, bottom]), _EPS)
            return jnp.sqrt(s / ks)
        s = jax.lax.fori_loop(0, polish, pbody, jnp.concatenate([s_a, s_b]))
        s_a, s_b = s[:p], s[p:]
    return s_a, s_b


def ds_residual(kaa, kab, s_a, s_b, eig_tol: float, solver: str = "oneshot"):
    """Doubly-stochastic residual ||diag(s) K~ s - 1||_inf of a scaling.

    The convergence diagnostic the reference gets for free from its
    while-loop stopping test (SURVEY.md §1.2 stage 3 "to convergence");
    this framework iterates a FIXED, sweep-calibrated count for
    shape-static jit (§3.3 note), so the residual is surfaced as an
    OPT-IN check instead: one extra strip matvec — O(Np), the cost of a
    single Sinkhorn iteration. CLI: ``-ds_check`` (prints it and records
    it in the run JSONL); a user on a new image class reads it to verify
    the calibrated iteration count converged there too
    (tests/test_convergence.py pins the calibrated counts against it).
    """
    kaa_solve = _make_kaa_solve(kaa, eig_tol, solver)
    top, bottom = nystrom_matvec(kaa, kab, kaa_solve, s_a, s_b)
    r = jnp.concatenate([s_a * top, s_b * bottom]) - 1.0
    return jnp.max(jnp.abs(r))


def ds_residual_np(kaa, kab, s_a, s_b, eig_tol: float,
                   solver: str = "oneshot"):
    """float64 twin of ds_residual (oracle-side convergence checks)."""
    kaa_solve = _make_kaa_solve_np(kaa, eig_tol, solver)
    top, bottom = nystrom_matvec_np(kaa, kab, kaa_solve, s_a, s_b)
    r = np.concatenate([s_a * top, s_b * bottom]) - 1.0
    return float(np.max(np.abs(r)))


def normalize_blocks(kaa, kab, normalization: str, iters: int, eig_tol: float,
                     solver: str = "oneshot", coarse: int = 1,
                     polish: int = 0):
    """Scaled blocks (W_AA, W_AB) per the configured normalization.

    sinkhorn:  s from Sinkhorn balancing           (doubly stochastic)
    symmetric: s = 1/sqrt(K~ 1)                    (D^{-1/2} K D^{-1/2})
    none:      s = 1                               (raw kernel)

    ``coarse > 1`` runs the Sinkhorn loop against a 1/coarse column sample
    (``sinkhorn_scaling_coarse``) with ``polish`` full-res iterations.
    """
    p = kaa.shape[0]
    if normalization == "sinkhorn" and coarse > 1:
        s_a, s_b = sinkhorn_scaling_coarse(kaa, kab, iters, coarse, polish,
                                           eig_tol, solver)
    elif normalization == "sinkhorn":
        s_a, s_b = sinkhorn_scaling(kaa, kab, iters, eig_tol, solver)
    elif normalization == "symmetric":
        kaa_solve = _make_kaa_solve(kaa, eig_tol, solver)
        ones_a = jnp.ones(p, dtype=kaa.dtype)
        ones_b = jnp.ones(kab.shape[1], dtype=kaa.dtype)
        top, bottom = nystrom_matvec(kaa, kab, kaa_solve, ones_a, ones_b)
        s_a = jax.lax.rsqrt(jnp.maximum(top, _EPS))
        s_b = jax.lax.rsqrt(jnp.maximum(bottom, _EPS))
    else:
        s_a = jnp.ones(p, dtype=kaa.dtype)
        s_b = jnp.ones(kab.shape[1], dtype=kaa.dtype)

    waa = kaa * (s_a[:, None] * s_a[None, :])
    # preserve the strip's STORAGE dtype (bfloat16_store policy): the f32
    # scaling outer product would otherwise silently re-materialize the
    # (p, N) strip at f32, forfeiting the bandwidth the narrow store buys
    wab = (kab * (s_a[:, None] * s_b[None, :])).astype(kab.dtype)
    return waa, wab, s_a, s_b


# --- numpy float64 twins for the CPU oracle ---------------------------------

def nystrom_matvec_np(kaa, kab, kaa_solve, v_a, v_b):
    if not callable(kaa_solve):
        pinv = kaa_solve
        kaa_solve = lambda u: pinv @ u
    u = kab @ v_b
    top = kaa @ v_a + u
    t = v_a + kaa_solve(u)
    bottom = kab.T @ t
    return top, bottom


def sinkhorn_scaling_np(kaa, kab, iters: int, eig_tol: float,
                        solver: str = "oneshot"):
    p = kaa.shape[0]
    kaa_solve = _make_kaa_solve_np(kaa, eig_tol, solver)
    s = np.ones(p + kab.shape[1], dtype=np.float64)
    for _ in range(iters):
        top, bottom = nystrom_matvec_np(kaa, kab, kaa_solve, s[:p], s[p:])
        ks = np.maximum(np.concatenate([top, bottom]), _EPS)
        s = np.sqrt(s / ks)
    return s[:p], s[p:]


def normalize_blocks_np(kaa, kab, normalization: str, iters: int,
                        eig_tol: float, solver: str = "oneshot"):
    p = kaa.shape[0]
    if normalization == "sinkhorn":
        s_a, s_b = sinkhorn_scaling_np(kaa, kab, iters, eig_tol, solver)
    elif normalization == "symmetric":
        kaa_solve = _make_kaa_solve_np(kaa, eig_tol, solver)
        top, bottom = nystrom_matvec_np(kaa, kab, kaa_solve,
                                        np.ones(p), np.ones(kab.shape[1]))
        s_a = 1.0 / np.sqrt(np.maximum(top, _EPS))
        s_b = 1.0 / np.sqrt(np.maximum(bottom, _EPS))
    else:
        s_a = np.ones(p)
        s_b = np.ones(kab.shape[1])
    waa = kaa * (s_a[:, None] * s_a[None, :])
    wab = kab * (s_a[:, None] * s_b[None, :])
    return waa, wab, s_a, s_b
