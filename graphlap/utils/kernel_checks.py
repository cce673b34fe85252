"""Hand-written kernels against their plain XLA twins, at a given width.

Each check builds the kernel's operands from real image features, runs
the Pallas kernel and the XLA operator it replaces, and returns one dict:
the relative max error against the plain reference, the tolerance it is
held to, and both wall times (min of ``runs``, synced by
``block_until_ready``). Used by the card-only tests (tests/test_gpu.py)
and by chip_smoke.py; on the CPU backend the kernels run in interpret
mode, so call them there only at toy widths.

Tolerances and precision, per kernel:

* matvec / rmatvec, f32 operands: the kernel's distance GEMM runs at IEEE
  f32 (never TF32), so it differs from the XLA scan only in summation
  order — relative max error <= 1e-5.
* matvec / rmatvec, bf16 operands: products of bf16 values are exact in
  f32, so the reference is the XLA scan at f32 on the SAME rounded
  features; the sums over up to millions of columns accumulate in f32 in
  another order — <= 1e-4.
* affinity emitter, bf16 store: one bf16 ulp of a value <= 1 (2^-8 abs),
  since an f32 ordering difference can flip one rounding.
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np

TOL_F32 = 1e-5
TOL_BF16_OPERANDS = 1e-4
TOL_BF16_STORE = 2.0 ** -8


def timed(fn, *args, runs: int = 5) -> float:
    """Min wall of ``fn(*args)`` after one warm-up call."""
    jax.block_until_ready(fn(*args))
    walls = []
    for _ in range(runs):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        walls.append(time.perf_counter() - t0)
    return min(walls)


def _rel_err(out, ref) -> float:
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30))


def check_streaming_kernels(feats_a, feats_pad, dtype, block: int,
                            runs: int = 3, seed: int = 0) -> list[dict]:
    """matvec_pallas / rmatvec_pallas vs ops/streaming.matvec / rmatvec.

    ``feats_a`` (p, d) and ``feats_pad`` (n, d) are the model's features
    (n a multiple of ``block``, the XLA scan's column block). Vectors are
    positive, like the Sinkhorn scales the kernels carry in production."""
    from ..ops import pallas_streaming as pst
    from ..ops import streaming as st

    p = feats_a.shape[0]
    n = feats_pad.shape[0]
    n_pad_k = pst.n_pad_for(n)
    rng = np.random.default_rng(seed)
    v = jnp.asarray(rng.uniform(0.5, 1.5, n), jnp.float32)
    t = jnp.asarray(rng.uniform(0.5, 1.5, p), jnp.float32)
    ones_p = jnp.ones(p, jnp.float32)
    ones_n = jnp.ones(n, jnp.float32)

    fa_pad, f_t = jax.jit(pst.feature_pads, static_argnums=(2, 3))(
        feats_a, feats_pad, n_pad_k, dtype)
    _, p_pad = pst.p_tiling(p)
    v_k = jnp.zeros(n_pad_k, jnp.float32).at[:n].set(v)
    t_k = jnp.zeros(p_pad, jnp.float32).at[:p].set(t)

    mv_k = jax.jit(lambda a, f, x: pst.matvec_pallas(a, f, x)[:p])
    rmv_k = jax.jit(lambda a, f, x: pst.rmatvec_pallas(a, f, x)[:n])
    # the XLA twin in the tile dtype is what would run without the kernel
    mv_x = jax.jit(lambda a, f, x: st.matvec(a, f, x, ones_p, ones_n,
                                             block, dtype))
    rmv_x = jax.jit(lambda a, f, x: st.rmatvec(a, f, x, ones_p, ones_n,
                                               block, dtype))
    # the plain reference: the XLA scan at f32 on the operands the kernel
    # actually sees (bf16-rounded when dtype is bf16)
    fa_r = feats_a.astype(dtype).astype(jnp.float32)
    fp_r = feats_pad.astype(dtype).astype(jnp.float32)
    mv_ref = jax.jit(lambda a, f, x: st.matvec(a, f, x, ones_p, ones_n,
                                               block, jnp.float32))
    rmv_ref = jax.jit(lambda a, f, x: st.rmatvec(a, f, x, ones_p, ones_n,
                                                 block, jnp.float32))
    tol = TOL_F32 if dtype == jnp.float32 else TOL_BF16_OPERANDS
    name = jnp.dtype(dtype).name
    out = []
    for kname, kfn, kargs, xfn, xargs, rfn, rargs in (
            ("matvec", mv_k, (fa_pad, f_t, v_k), mv_x, (feats_a, feats_pad, v),
             mv_ref, (fa_r, fp_r, v)),
            ("rmatvec", rmv_k, (fa_pad, f_t, t_k), rmv_x,
             (feats_a, feats_pad, t), rmv_ref, (fa_r, fp_r, t))):
        err = _rel_err(kfn(*kargs), rfn(*rargs))
        out.append({
            "kernel": f"{kname}_{name}", "p": p, "n": n,
            "rel_max_err": err, "tol": tol, "ok": err <= tol,
            "kernel_s": timed(kfn, *kargs, runs=runs),
            "xla_s": timed(xfn, *xargs, runs=runs),
        })
    return out


def recipe_features(cfg, h: int, w: int, seed: int = 1):
    """(feats_a (p, d), feats_pad (n_pad, d)) of the noisy test image at
    ``cfg``'s sample plan and column block — the operands the pipeline
    feeds its strip products."""
    from ..io import add_gaussian_noise, make_test_image
    from ..models.pipeline import make_plan
    from ..ops.affinity import extract_features_padded

    noisy = np.clip(add_gaussian_noise(make_test_image(h, w), 0.1,
                                       seed=seed), 0, 1).astype(np.float32)
    plan = make_plan(noisy, cfg)
    n = h * w
    block = min(cfg.block_cols, n)
    n_pad = -(-n // block) * block
    feats_pad = jax.jit(lambda x: extract_features_padded(x, cfg, n_pad))(
        jnp.asarray(noisy))
    return feats_pad[jnp.asarray(plan.idx_a)], feats_pad


def cfg4_kernel_checks(runs: int = 3) -> list[dict]:
    """Both streaming kernels at the cfg4 width (2048x4096, p = 4096), in
    the bf16 tiles of the "fast" recipe and in f32."""
    from ..config import CONFIG4

    feats_a, feats_pad = recipe_features(CONFIG4, 2048, 4096)
    out = []
    for dtype in (jnp.bfloat16, jnp.float32):
        out += check_streaming_kernels(feats_a, feats_pad, dtype,
                                       CONFIG4.block_cols, runs=runs)
    return out


def cfg2_emitter_check(runs: int = 3) -> dict:
    """The strip emitter at the cfg2 width (512^2, p = 5243)."""
    from ..config import CONFIG2

    feats_a, feats_pad = recipe_features(CONFIG2, 512, 512)
    return check_affinity_emitter(feats_a, feats_pad, runs=runs)


def check_affinity_emitter(feats_a, feats_all, runs: int = 3) -> dict:
    """affinity_strip_pallas vs ops/affinity.affinity_strip at the
    bfloat16_store policy (f32 distances and exp, bf16 strip), with the
    compile-time temp memory of both executables."""
    from ..ops.affinity import affinity_strip
    from ..ops.pallas_affinity import affinity_strip_pallas

    emit_k = jax.jit(lambda a, b: affinity_strip_pallas(
        a, b, dtype=jnp.float32, store_dtype=jnp.bfloat16))
    emit_x = jax.jit(lambda a, b: affinity_strip(
        a, b, jnp.float32, store_dtype=jnp.bfloat16))
    k = emit_k(feats_a, feats_all)
    x = emit_x(feats_a, feats_all)
    err = float(jnp.max(jnp.abs(k.astype(jnp.float32)
                                - x.astype(jnp.float32))))
    del k, x

    def temp_bytes(fn):
        ma = fn.lower(feats_a, feats_all).compile().memory_analysis()
        return int(ma.temp_size_in_bytes) if ma is not None else None

    return {
        "kernel": "affinity_emit_bf16_store",
        "p": int(feats_a.shape[0]), "n": int(feats_all.shape[0]),
        "max_abs_err": err, "tol": TOL_BF16_STORE,
        "ok": err <= TOL_BF16_STORE,
        "kernel_s": timed(emit_k, feats_a, feats_all, runs=runs),
        "xla_s": timed(emit_x, feats_a, feats_all, runs=runs),
        "kernel_temp_bytes": temp_bytes(emit_k),
        "xla_temp_bytes": temp_bytes(emit_x),
    }
