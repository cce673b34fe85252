"""Spectral filter functions f(lambda) and their application.

JAX equivalent of the reference's filter module (SURVEY.md §2.2
component #7, §1.2 Stage 5). Pure functions on the eigenvalue vector,
registered by name so the CLI mirrors the reference's ``-filter`` flag.

Two application modes (the distinction matters because Nystrom truncates to
rank m — the residual y - V V^T y lives outside the basis):

* projection (``affine=False``): z = V f(L) V^T y — the filtered signal is
  fully represented in the basis (denoising/low-pass: the residual is noise
  and is meant to be discarded).
* affine (``affine=True``): z = y + V (f(L) - 1) V^T y — the identity part
  acts on the FULL signal and only the correction lives in the basis
  (sharpening: f(1)=1 keeps DC, f(lambda)>1 boosts detail; dropping the
  residual here would blur instead of sharpen).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax.numpy as jnp
import numpy as np


class SpectralFilter(NamedTuple):
    fn: Callable          # (vals, param) -> filtered vals   (jnp or np alike)
    affine: bool
    doc: str


def _identity(lam, param):
    return lam


def _power(lam, param):
    # k-step diffusion W^k. INTEGER k uses the true power so every
    # application mode agrees (matvec applies true W^k by repeated
    # matvecs; the sign-safe form sign(l)|l|^k equals -l^k for EVEN k on
    # the slightly-negative tail eigenvalues the Nystrom completion can
    # produce — review finding). Non-integer k keeps the sign-safe
    # branch (a real power of a negative value is undefined; param is a
    # static config field, so the branch resolves at trace time).
    if float(param) == int(param):
        return lam ** int(param)
    return jnp.sign(lam) * jnp.abs(lam) ** param if isinstance(
        lam, jnp.ndarray) else np.sign(lam) * np.abs(lam) ** param


def _lowpass(lam, param):
    # pure rank-m projection: f = 1 on the kept eigenpairs
    return jnp.ones_like(lam) if isinstance(lam, jnp.ndarray) else np.ones_like(lam)


def _sharpen(lam, param):
    # f(lambda) = 1 + beta (1 - lambda): >1 on low-eigenvalue (detail)
    # components, =1 at lambda=1 (DC) — BASELINE.json config 3.
    return 1.0 + param * (1.0 - lam)


def _exp_decay(lam, param):
    # f(lambda) = exp(-tau (1 - lambda)): heat-kernel style smoothing
    mod = jnp if isinstance(lam, jnp.ndarray) else np
    return mod.exp(-param * (1.0 - lam))


def _twicing(lam, param):
    # f(lambda) = 1 - (1 - lambda)^k: the twicing/boosting family from the
    # GLIDE papers (Talebi & Milanfar 2014 §; Milanfar, "A Tour of Modern
    # Image Filtering" 2013) — the spectral form of iterating
    # z <- z + (y - W z): each round adds back the residual the filter
    # removed, so k interpolates identity-filter output (k=1 on the basis
    # subspace) toward the unfiltered input (k -> inf). Affine application:
    # the out-of-basis residual must pass through untouched (that is the
    # point of twicing), hence z = y - V (1-L)^k V^T y.
    r = 1.0 - lam                      # in [0, 2]; r<0 only for lam ~ 1+eps
    if float(param) == int(param):
        # true power for integer k (matvec-mode agreement — _power note)
        return 1.0 - r ** int(param)
    mod = jnp if isinstance(lam, jnp.ndarray) else np
    return 1.0 - mod.sign(r) * mod.abs(r) ** param


FILTER_REGISTRY: dict[str, SpectralFilter] = {
    "identity": SpectralFilter(_identity, False, "f(l)=l: one application of W (GLIDE denoise)"),
    "power": SpectralFilter(_power, False, "f(l)=l^k: k-step diffusion"),
    "lowpass": SpectralFilter(_lowpass, False, "f(l)=1: rank-m projection"),
    "sharpen": SpectralFilter(_sharpen, True, "f(l)=1+b(1-l): detail boost, f>1 on low l"),
    "exp_decay": SpectralFilter(_exp_decay, False, "f(l)=exp(-t(1-l)): heat kernel"),
    "twicing": SpectralFilter(_twicing, True, "f(l)=1-(1-l)^k: residual add-back (boosting)"),
}


# Filters that are POLYNOMIALS in W and can therefore be applied EXACTLY by
# repeated strip matvecs against the Nystrom completion — no eigensolve, no
# rank-m truncation (config filter_mode="matvec"). This matters beyond speed:
# kernel spectra collapse into near-degenerate clusters past the first few
# eigenvalues (measured gaps ~1e-5 at the m=50 boundary on the graded
# configs), so a rank-m AFFINE filter — which weights the kept basis by
# f(lambda)-1 ~ beta instead of damping it by lambda ~ 0 — boosts an
# essentially arbitrary m-dim slice of the cluster: any perturbation
# (bf16 tiles, coarse-gram estimate, even seed choice) rotates the slice and
# moves the output by whole dB (1.8-4.6 dB measured at cfg3). The
# polynomial form sidesteps the whole failure class: the output is a smooth
# function of the operator, not of an ill-posed subspace selection.
MATVEC_FILTERS = ("identity", "power", "sharpen", "twicing")


def check_matvec_filter(name: str, param: float) -> None:
    """Raise unless (name, param) admits exact polynomial application."""
    if name not in MATVEC_FILTERS:
        raise ValueError(
            f"filter_mode='matvec' supports polynomial filters "
            f"{MATVEC_FILTERS}, got {name!r} (use filter_mode='spectral')")
    if name in ("power", "twicing") and (param != int(param) or param < 1):
        raise ValueError(
            f"filter_mode='matvec' needs an integer filter_param >= 1 for "
            f"{name!r} (W^k by k matvecs), got {param!r}")


def apply_matvec_filter(wapply, y, name: str, param: float):
    """z = f(W) y via repeated applications of ``wapply`` (x -> W x).

    Works on jnp and np arrays alike — ``wapply`` sets the backend; the
    float64 oracle passes a numpy completion matvec. The Python loops are
    static (param is config), so under jit this unrolls into a fixed chain
    of strip passes.
    """
    check_matvec_filter(name, param)
    if name == "identity":
        return wapply(y)                       # z = W y (GLIDE denoise)
    if name == "power":
        z = y
        for _ in range(int(param)):
            z = wapply(z)                      # z = W^k y
        return z
    if name == "sharpen":
        # f(l) = 1 + b(1-l)  =>  z = (1+b) y - b W y  (unsharp mask with the
        # doubly-stochastic W as the smoother; exact over the FULL spectrum)
        return (1.0 + param) * y - param * wapply(y)
    # twicing: f(l) = 1 - (1-l)^k  =>  z = y - (I-W)^k y
    r = y
    for _ in range(int(param)):
        r = r - wapply(r)
    return y - r


# Chebyshev operator filtering (Hammond, Vandergheynst & Gribonval 2011,
# "Wavelets on graphs via spectral graph theory" §6 — the standard GSP
# technique): any f(lambda) on [-1, 1] is approximated by a degree-K
# Chebyshev series and applied through the three-term recurrence
# T_{k+1}(W) y = 2 W T_k(W) y - T_{k-1}(W) y — K strip matvecs, no
# eigensolve. Extends the eigensolve-free path beyond exact polynomials
# to exp_decay (heat kernel) and FRACTIONAL power/twicing. Kernel spectra
# here live in [0, 1] (PSD kernel, doubly-stochastic scaling) but the
# completion can dip slightly negative, so the series is fit on the full
# [-1, 1] — for smooth f the cost of the wider interval is tiny and it
# keeps the recurrence bounded.
CHEBYSHEV_FILTERS = ("identity", "power", "sharpen", "exp_decay", "twicing")


def check_chebyshev_filter(name: str, param: float) -> None:
    """Raise unless f(lambda) is a genuine scalar function Chebyshev can
    fit — 'lowpass' (f=1 on the KEPT INDEX SET, not a lambda-function) has
    no operator form."""
    if name not in CHEBYSHEV_FILTERS:
        raise ValueError(
            f"filter_mode='chebyshev' needs a lambda-function filter "
            f"{CHEBYSHEV_FILTERS}, got {name!r} (lowpass is an index-set "
            f"projection; use filter_mode='spectral')")
    if name in ("power", "twicing") and param < 0:
        raise ValueError(f"{name!r} needs filter_param >= 0, got {param!r}")


def chebyshev_coeffs(name: str, param: float, degree: int) -> np.ndarray:
    """(degree+1,) float64 Chebyshev coefficients of f on [-1, 1], via
    Chebyshev-Gauss quadrature at the degree+1 Chebyshev nodes (exact for
    polynomials of degree <= degree). Host-side numpy: (name, param,
    degree) are static config, so the coefficients are trace-time
    constants under jit."""
    check_chebyshev_filter(name, param)
    n = degree + 1
    theta = np.pi * (np.arange(n) + 0.5) / n
    x = np.cos(theta)                       # Chebyshev nodes in (-1, 1)
    fx = np.asarray(FILTER_REGISTRY[name].fn(x, param), np.float64)
    k = np.arange(n)
    t = np.cos(np.outer(k, theta))          # T_k(x_i)
    c = (2.0 / n) * t @ fx
    c[0] *= 0.5
    return c


# Tail estimates must be fit well PAST the degree they certify: quadrature
# coefficients near the fit end alias (measured: the 64-node fit read the
# power-2.5 tail at k=59 as 8.9e-7 when the true value is 2.1e-5). 64 extra
# terms keep the dominant part of every algebraically-decaying tail in view;
# for smooth f the extra terms are machine zeros and cost nothing.
_TAIL_FIT_MARGIN = 64


def chebyshev_tail_bound(name: str, param: float, degree: int) -> float:
    """Sup-norm error bound of the degree-``degree`` series on [-1, 1]:
    |f - S_K|_inf <= sum_{k>K} |c_k| (since |T_k| <= 1), with the tail
    taken from a fit extending _TAIL_FIT_MARGIN terms past ``degree``.
    Validated against dense f(M)y in tests/test_chebyshev.py."""
    c = chebyshev_coeffs(name, param, degree + _TAIL_FIT_MARGIN)
    return float(np.sum(np.abs(c[degree + 1:])))


def chebyshev_auto_degree(name: str, param: float, tol: float = 1e-6,
                          max_degree: int = 64) -> int:
    """Smallest series degree whose tail bound (chebyshev_tail_bound) is
    <= tol — the cheb_degree=0 ("auto") resolution rule. Host-side numpy
    on static config, so the pick is a trace-time constant shared by the
    device paths and the float64 oracle (they resolve through the same
    dispatch). Exact polynomials resolve to their true degree (the
    quadrature is exact for degree <= the fit degree, so higher
    coefficients are ~1e-16); non-smooth f (fractional power's
    |lambda|^p kink at 0) converges only algebraically and clamps to
    max_degree — an explicit cheb_degree is the escape hatch for cost
    control there."""
    c = chebyshev_coeffs(name, param, max_degree + _TAIL_FIT_MARGIN)
    tails = np.cumsum(np.abs(c[::-1]))[::-1]      # tails[k] = sum_{j>=k} |c_j|
    ok = np.nonzero(tails[1:max_degree + 1] <= tol)[0]   # degree k <-> tail k+1
    return max(1, int(ok[0])) if ok.size else max_degree


def apply_chebyshev_filter(wapply, y, name: str, param: float, degree: int):
    """z ~= f(W) y by the Chebyshev three-term recurrence — degree strip
    matvecs. Works on jnp and np arrays alike (``wapply`` sets the
    backend); the loop is static (degree is config) so under jit it
    unrolls into a fixed matvec chain. degree=0 means AUTO: the smallest
    degree whose tail bound is <= 1e-6 (chebyshev_auto_degree)."""
    if degree == 0:
        degree = chebyshev_auto_degree(name, param)
    c = [float(v) for v in chebyshev_coeffs(name, param, degree)]
    t_prev = y
    z = c[0] * y
    t_cur = wapply(y)
    z = z + c[1] * t_cur
    for j in range(2, degree + 1):
        t_prev, t_cur = t_cur, 2.0 * wapply(t_cur) - t_prev
        z = z + c[j] * t_cur
    return z


def apply_operator_filter(wapply, y, name: str, param: float, mode: str,
                          degree: int = 12):
    """Dispatch for the eigensolve-free application modes: 'matvec'
    (exact polynomial) or 'chebyshev' (series approximation)."""
    if mode == "chebyshev":
        return apply_chebyshev_filter(wapply, y, name, param, degree)
    return apply_matvec_filter(wapply, y, name, param)


def apply_spectral_filter(y_perm: jnp.ndarray, vals: jnp.ndarray,
                          vecs: jnp.ndarray, name: str, param: float) -> jnp.ndarray:
    """z_perm = filter(y_perm) in the eigenbasis. All O(N m)."""
    filt = FILTER_REGISTRY[name]
    fvals = filt.fn(vals, param)
    coeffs = vecs.T @ y_perm                     # (m,)
    if filt.affine:
        return y_perm + vecs @ ((fvals - 1.0) * coeffs)
    return vecs @ (fvals * coeffs)


def apply_spectral_filter_np(y_perm: np.ndarray, vals: np.ndarray,
                             vecs: np.ndarray, name: str, param: float) -> np.ndarray:
    filt = FILTER_REGISTRY[name]
    fvals = filt.fn(vals, param)
    coeffs = vecs.T @ y_perm
    if filt.affine:
        return y_perm + vecs @ ((fvals - 1.0) * coeffs)
    return vecs @ (fvals * coeffs)
