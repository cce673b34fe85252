"""Global-shift registration for the temporal guide.

The measured temporal-guide boundary (benchmarks/motion_guide.py) is a
per-group displacement of ~0.5-1 px — camera pan kills basis reuse long
before scene change does. Phase correlation recovers a global
translation to sub-pixel accuracy in O(N log N) (Kuglin & Hines 1975 +
parabolic peak refinement), so the guided path can align each group to
its first frame, build the mean guide from REGISTERED frames, filter in
the registered coordinates, and shift each output back. Pure-translation
motion then behaves like a static scene (tests/test_video.py pins the
v=1 px/frame case flipping from -3 dB to a win).

Two implementations:

- ``estimate_shift`` / ``shift_image``: float64 numpy — the oracle
  twins and the standalone host API.
- ``prepare_registered_group`` / ``finish_registered_group``: the
  PRODUCTION path, fully jitted jnp. The whole register → mean-guide →
  stack layout (and the inverse unshift) runs as ONE compiled program
  per group, so no O(N) frame ever makes an extra host round trip. A
  traced shift is still a static-shape program: the estimate feeds the
  warp as traced f32 scalars, and the warp is a separable 4-tap
  Catmull-Rom gather whose indices/weights are computed from those
  scalars (gathers + FMAs — elementwise device work, small next to
  host-side f64 FFTs + scipy splines, which dominated the first 4K pan
  runs).

The two warps are different cubic interpolants (scipy's prefiltered
interpolating B-spline vs Catmull-Rom): both are exact at integer
shifts (tested) and agree to ~1e-2 on smooth content at fractional
shifts; the pipeline-level guarantees are pinned by quality tests, not
bitwise ones (tests/test_video.py).
"""

from __future__ import annotations

import numpy as np


def _parabolic(vm1: float, v0: float, vp1: float) -> float:
    """Sub-sample offset of a peak from its two neighbors (|off| <= 0.5)."""
    denom = vm1 - 2.0 * v0 + vp1
    if abs(denom) < 1e-12:
        return 0.0
    return float(np.clip(0.5 * (vm1 - vp1) / denom, -0.5, 0.5))


def estimate_shift(ref: np.ndarray, moved: np.ndarray) -> tuple[float, float]:
    """(dy, dx) such that ``moved`` ~= ``ref`` translated by (dy, dx);
    aligning: shift ``moved`` by (-dy, -dx). Sub-pixel via parabolic
    refinement of the phase-correlation peak."""
    a = np.asarray(ref, np.float64)
    b = np.asarray(moved, np.float64)
    if a.shape != b.shape or a.ndim != 2:
        raise ValueError(f"need matching 2D frames, got {a.shape}/{b.shape}")
    fa = np.fft.rfft2(a - a.mean())
    fb = np.fft.rfft2(b - b.mean())
    cross = fb * np.conj(fa)
    cross /= np.maximum(np.abs(cross), 1e-12)
    corr = np.fft.irfft2(cross, s=a.shape)
    py, px = np.unravel_index(int(np.argmax(corr)), corr.shape)
    h, w = a.shape
    v0 = float(corr[py, px])
    dy = py + _parabolic(float(corr[(py - 1) % h, px]), v0,
                         float(corr[(py + 1) % h, px]))
    dx = px + _parabolic(float(corr[py, (px - 1) % w]), v0,
                         float(corr[py, (px + 1) % w]))
    if dy > h / 2:
        dy -= h                                   # wrap to signed
    if dx > w / 2:
        dx -= w
    return float(dy), float(dx)


def shift_image(img: np.ndarray, dy: float, dx: float) -> np.ndarray:
    """Translate (H, W[, C]) by (dy, dx) px, spline interp, reflect
    edges. No-op fast path for |d| < 1e-3."""
    if abs(dy) < 1e-3 and abs(dx) < 1e-3:
        return np.asarray(img, np.float32)
    from scipy.ndimage import shift as nd_shift

    img = np.asarray(img, np.float32)
    vec = (dy, dx) if img.ndim == 2 else (dy, dx, 0.0)
    return nd_shift(img, vec, order=3, mode="reflect").astype(np.float32)


# ---------------------------------------------------------------------------
# Device path (jnp, traced shifts) — see module docstring
# ---------------------------------------------------------------------------

_LUMA_601_DEV = (0.299, 0.587, 0.114)


def _luma_dev(stack):
    """(…, H, W, C) -> (…, H, W): BT.601 for C=3, channel mean otherwise
    (the jnp twin of models.pipeline._luma)."""
    import jax.numpy as jnp
    if stack.shape[-1] == 3:
        w = jnp.asarray(_LUMA_601_DEV, stack.dtype)
        return jnp.tensordot(stack, w, axes=([-1], [0]))
    return stack.mean(axis=-1)


def _peak_subpixel(corr):
    """(H, W) correlation surface -> traced (dy, dx) f32: argmax with
    wraparound neighbors, parabolic sub-pixel refinement, wrap-to-signed.
    Mirrors estimate_shift's host logic exactly."""
    import jax.numpy as jnp
    h, w = corr.shape
    flat = jnp.argmax(corr)
    py = (flat // w).astype(jnp.int32)
    px = (flat % w).astype(jnp.int32)

    def at(y, x):
        return corr[jnp.mod(y, h), jnp.mod(x, w)]

    def parab(vm1, v0, vp1):
        den = vm1 - 2.0 * v0 + vp1
        safe = jnp.where(jnp.abs(den) < 1e-12, 1.0, den)
        off = jnp.where(jnp.abs(den) < 1e-12, 0.0, 0.5 * (vm1 - vp1) / safe)
        return jnp.clip(off, -0.5, 0.5)

    v0 = at(py, px)
    dy = py.astype(jnp.float32) + parab(at(py - 1, px), v0, at(py + 1, px))
    dx = px.astype(jnp.float32) + parab(at(py, px - 1), v0, at(py, px + 1))
    dy = jnp.where(dy > h / 2, dy - h, dy)
    dx = jnp.where(dx > w / 2, dx - w, dx)
    return jnp.stack([dy, dx])


def _estimate_shifts_dev(lum):
    """(k, H, W) luma stack -> (k, 2) shifts of each frame vs frame 0
    (row 0 is exactly zero). One batched FFT over the group."""
    import jax
    import jax.numpy as jnp
    ref = lum[0]
    fa = jnp.fft.rfft2(ref - ref.mean())
    mv = lum[1:] - lum[1:].mean(axis=(1, 2), keepdims=True)
    fb = jnp.fft.rfft2(mv)
    cross = fb * jnp.conj(fa)[None]
    cross = cross / jnp.maximum(jnp.abs(cross), 1e-12)
    corr = jnp.fft.irfft2(cross, s=ref.shape)
    shifts = jax.vmap(_peak_subpixel)(corr)              # (k-1, 2)
    return jnp.concatenate([jnp.zeros((1, 2), jnp.float32), shifts])


def _reflect_idx(i, n: int):
    """Symmetric reflection (d c b a | a b c d | d c b a) — matches
    scipy mode='reflect' used by the host twin."""
    import jax.numpy as jnp
    j = jnp.mod(i, 2 * n)
    return jnp.where(j >= n, 2 * n - 1 - j, j)


def _shift_axis_dev(img, d, axis: int):
    """Translate along one axis by traced scalar ``d`` px: out[i] =
    img[i - d] via a 4-tap Catmull-Rom gather (exact at integer d,
    where the taps collapse to (0, 1, 0, 0))."""
    import jax.numpy as jnp
    n = img.shape[axis]
    pos = jnp.arange(n, dtype=jnp.float32) - d           # source coords
    i0 = jnp.floor(pos).astype(jnp.int32)
    t = pos - i0.astype(jnp.float32)
    t2, t3 = t * t, t * t * t
    taps = ((-1, -0.5 * t3 + t2 - 0.5 * t),
            (0, 1.5 * t3 - 2.5 * t2 + 1.0),
            (1, -1.5 * t3 + 2.0 * t2 + 0.5 * t),
            (2, 0.5 * t3 - 0.5 * t2))
    bshape = [1] * img.ndim
    bshape[axis] = n
    out = jnp.zeros_like(img)
    for off, wgt in taps:
        idx = _reflect_idx(i0 + off, n)
        out = out + wgt.reshape(bshape) * jnp.take(img, idx, axis=axis)
    return out


def shift_image_dev(img, dy, dx):
    """jnp twin of ``shift_image``: (H, W[, C]) by traced (dy, dx),
    separable Catmull-Rom, symmetric-reflect edges."""
    return _shift_axis_dev(_shift_axis_dev(img, dy, 0), dx, 1)


def _prepare_impl(grp, color: bool):
    import jax
    import jax.numpy as jnp
    grp = grp.astype(jnp.float32)
    lum = _luma_dev(grp) if color else grp
    shifts = _estimate_shifts_dev(lum)
    reg = jax.vmap(lambda im, s: shift_image_dev(im, -s[0], -s[1]))(
        grp, shifts)
    guide = reg.mean(axis=0)
    y2d = _luma_dev(guide) if color else guide
    if color:
        k, h, w, c = reg.shape
        chw = jnp.moveaxis(reg, -1, 1).reshape(k * c, h, w)
    else:
        chw = reg
    return y2d, chw, shifts


def _finish_impl(z, shifts, color: bool, c: int):
    import jax
    import jax.numpy as jnp
    k = shifts.shape[0]
    if color:
        h, w = z.shape[-2:]
        z = jnp.moveaxis(z.reshape(k, c, h, w), 1, -1)
    z = jax.vmap(lambda im, s: shift_image_dev(im, s[0], s[1]))(z, shifts)
    # the cubic unshift can overshoot [0,1] by interpolation
    return jnp.clip(z, 0.0, 1.0)


# one jit wrapper per function for the life of the process — jax.jit's
# executable cache lives on the wrapper, so a per-call wrapper would
# recompile every group
_JITTED: dict = {}


def prepare_registered_group(grp, color: bool):
    """Register a (k, H, W[, C]) group to its first frame, ON DEVICE, as
    one jitted program: estimate per-frame shifts (batched phase
    correlation), warp, and lay out the guided pipeline's inputs.

    Returns ``(y2d (H, W) mean-guide luma, chw (k*c, H, W) registered
    stack, shifts (k, 2))`` — all device arrays, ready to feed the
    guided builders with no host round trip. Host twins:
    estimate_shift/shift_image + models.pipeline._luma."""
    import jax
    import jax.numpy as jnp
    if "prepare" not in _JITTED:
        _JITTED["prepare"] = jax.jit(_prepare_impl,
                                     static_argnames=("color",))
    return _JITTED["prepare"](jnp.asarray(grp, jnp.float32), color)


def finish_registered_group(z, shifts, color: bool, c: int = 1):
    """Inverse of prepare_registered_group for the filtered stack ``z``
    ((k*c, H, W) as the guided builders emit it): unfold channels when
    ``color``, shift each frame back by +shifts, clip to [0, 1]. One
    jitted program; returns a (k, H, W[, C]) device array."""
    import jax
    if "finish" not in _JITTED:
        _JITTED["finish"] = jax.jit(_finish_impl,
                                    static_argnames=("color", "c"))
    return _JITTED["finish"](z, shifts, color, c)
