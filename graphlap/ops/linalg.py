"""Small shared dense-linalg helpers (p x p scale).

JAX replacement for the reference's SLEPc/LAPACK layer
(SURVEY.md §2.2 N2/N4): p is capped at O(thousands) by design, so direct
``eigh`` on the MXU beats a distributed Krylov solver — no communication,
one fused kernel (SURVEY.md §3.4).

Numerical-stability design (SURVEY.md §7 hard part 1; PAPERS.md Nystrom
stability, arXiv:2511.15583). Kernel matrices decay fast and are nearly
rank-deficient; W_AA^{-1/2} is the #1 hazard. Two facts drive the design,
both measured on this codebase (f32 XLA vs f64 LAPACK, config 1):

* SOFT spectral truncation (a linear ramp over [tol, 2*tol] * lambda_max,
  see ``_soft_gate``) at a RELATIVE cutoff is the stable scheme: eigenvalues
  agree across precisions to ~1e-8 * lambda_max (far finer than the ramp),
  while a hard step mask lets near-degenerate clusters straddling the cutoff
  rotate kept mass into killed mass between precisions — an O(1) operator
  change (the dominant f32 parity failure measured on this pipeline).
* Ridge (Tikhonov) shifts are NOT stable in the Nystrom sandwich
  S = W_AA + Whalf (W_AB W_AB^T) Whalf: they weight the near-null subspace by
  1/sqrt(eps * lambda_max) instead of killing it, and that subspace carries
  O(1) mass of the cross term, so the harmless basis rotation of a degenerate
  f32 eigh turns into an O(100%) error in S. Measured: eigenvalue garbage at
  0.28 absolute.

The cutoff must also sit above the amplified f32 noise floor of S
(error_S ~ eps_f32 / tol), which needs tol^2 >> eps_f32 ~ 6e-8; the default
tol = 3e-3 satisfies this with margin.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

_TINY = 1e-30


def _eigh_sym(mat: jnp.ndarray):
    return jnp.linalg.eigh(0.5 * (mat + mat.T))


def _soft_gate(vals, cutoff):
    """Linear ramp 0 -> 1 over [cutoff, 2 * cutoff].

    A HARD spectral cutoff is precision-unstable when an eigenvalue cluster
    straddles it: f32-vs-f64 eigh rotate freely inside a near-degenerate
    cluster, and with a step weight that rotation mixes kept and killed
    directions — an O(1) change in the resulting operator (the dominant
    f32 parity failure measured on this pipeline). With a ramp wider than
    the cross-precision eigenvalue disagreement (~1e-8 * lambda_max, vs
    ramp width ~ rel_tol * lambda_max), cluster members get nearly equal
    weights and the operator function is stable in both precisions.
    """
    return jnp.clip(vals / cutoff - 1.0, 0.0, 1.0)


def trunc_inv_sqrt_vals(vals: jnp.ndarray, rel_tol: float) -> jnp.ndarray:
    """Elementwise lambda^{-1/2}, softly gated to 0 below the relative cutoff."""
    cutoff = rel_tol * jnp.maximum(jnp.max(vals), _TINY)
    gate = _soft_gate(vals, cutoff)
    safe = jnp.maximum(vals, cutoff)
    return gate * safe**-0.5


def trunc_inv_vals(vals: jnp.ndarray, rel_tol: float) -> jnp.ndarray:
    """Elementwise 1/lambda, softly gated to 0 below the relative cutoff."""
    cutoff = rel_tol * jnp.maximum(jnp.max(vals), _TINY)
    gate = _soft_gate(vals, cutoff)
    safe = jnp.maximum(vals, cutoff)
    return gate / safe


def psd_pinv(mat: jnp.ndarray, rel_tol: float) -> jnp.ndarray:
    """Truncated pseudo-inverse of a symmetric PSD matrix."""
    vals, vecs = _eigh_sym(mat)
    return (vecs * trunc_inv_vals(vals, rel_tol)[None, :]) @ vecs.T


def psd_pinv_sqrt(mat: jnp.ndarray, rel_tol: float) -> jnp.ndarray:
    """Truncated pseudo inverse square root M^{-1/2}."""
    vals, vecs = _eigh_sym(mat)
    return (vecs * trunc_inv_sqrt_vals(vals, rel_tol)[None, :]) @ vecs.T


# --- numpy float64 twins for the CPU oracle ---------------------------------

def trunc_inv_sqrt_vals_np(vals: np.ndarray, rel_tol: float) -> np.ndarray:
    cutoff = rel_tol * max(np.max(vals), _TINY)
    gate = np.clip(vals / cutoff - 1.0, 0.0, 1.0)
    safe = np.maximum(vals, cutoff)
    return gate * safe**-0.5


def trunc_inv_vals_np(vals: np.ndarray, rel_tol: float) -> np.ndarray:
    cutoff = rel_tol * max(np.max(vals), _TINY)
    gate = np.clip(vals / cutoff - 1.0, 0.0, 1.0)
    safe = np.maximum(vals, cutoff)
    return gate / safe


def psd_pinv_np(mat: np.ndarray, rel_tol: float) -> np.ndarray:
    vals, vecs = np.linalg.eigh(0.5 * (mat + mat.T))
    return (vecs * trunc_inv_vals_np(vals, rel_tol)[None, :]) @ vecs.T


def psd_pinv_sqrt_np(mat: np.ndarray, rel_tol: float) -> np.ndarray:
    vals, vecs = np.linalg.eigh(0.5 * (mat + mat.T))
    return (vecs * trunc_inv_sqrt_vals_np(vals, rel_tol)[None, :]) @ vecs.T
