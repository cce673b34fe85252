"""Pixel-affinity construction: features + the K_AA / K_AB strip.

JAX equivalent of the reference's per-row kernel-evaluation loop
filling PETSc MATMPIDENSE blocks (SURVEY.md §2.2 component #4, §3.2).
Design is accelerator-first (SURVEY.md §7 hard part 3): per-pixel dynamic
gathers are poison on wide SIMD hardware, so the image is pre-unfolded once
into an (N, d) feature tensor and every kernel evaluation becomes one big
GEMM via ``|a-b|^2 = |a|^2 + |b|^2 - 2 a.b`` — the FLOPs land on the
matrix units.

Bandwidths are folded into the features (feats = raw / h), so the kernel is
uniformly ``K = exp(-|f_i - f_j|^2)``; one code path serves Gaussian,
bilateral, and NLM.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np

from ..config import PipelineConfig


def feature_dim(cfg: PipelineConfig) -> int:
    if cfg.kernel == "nlm":
        d = cfg.patch_size * cfg.patch_size
    else:
        d = 1
    if cfg.spatial_h > 0.0:
        d += 2
    return d


def _unfold_patches(img: jnp.ndarray, patch: int) -> jnp.ndarray:
    """(H, W) -> (H*W, patch*patch) of reflect-padded neighborhoods.

    One pad + static shifted slices: compiles to cheap strided copies, no
    per-pixel dynamic_slice (SURVEY.md §7 hard part 3).
    """
    r = patch // 2
    h, w = img.shape
    padded = jnp.pad(img, r, mode="reflect")
    views = [
        padded[dy:dy + h, dx:dx + w]
        for dy in range(patch)
        for dx in range(patch)
    ]
    return jnp.stack(views, axis=-1).reshape(h * w, patch * patch)


def extract_features(img: jnp.ndarray, cfg: PipelineConfig,
                     h=None) -> jnp.ndarray:
    """(H, W) image -> (N, d) float32 feature rows with bandwidths folded in.

    gaussian: f_i = y_i / h                      (photometric; SURVEY.md §1.2)
    nlm:      f_i = P_i / (h * patch)            (5x5 patch, per-pixel RMS h)
    spatial_h > 0 appends (row, col) / spatial_h (bilateral form).

    ``h`` overrides cfg.h and may be a TRACED scalar: since the bandwidth
    only enters as this feature scaling, a bandwidth sweep (tune.py SURE
    grid) can run every candidate through ONE compiled executable instead
    of recompiling per h (cfg fields are static jit args).

    cfg.feature_dtype="bfloat16" rounds the RETURNED tensor to bf16 — the
    streaming path's capacity lever (the (N, d) features are its only
    O(N)-by-d resident buffer; tiles are recomputed). Every consumer
    upcasts or casts to its own compute dtype, so under a bf16 tile mode
    the GEMM inputs are bit-identical and only the f32 norms see the
    rounding. spatial_h > 0 is rejected at config time (coordinate
    cancellation).
    """
    h_img, w_img = img.shape
    img = img.astype(jnp.float32)
    h = cfg.h if h is None else h

    if cfg.kernel == "nlm":
        d = cfg.patch_size * cfg.patch_size
        feats = _unfold_patches(img, cfg.patch_size) / (h * math.sqrt(d))
    else:
        feats = (img / h).reshape(-1, 1)

    if cfg.spatial_h > 0.0:
        yy, xx = jnp.meshgrid(
            jnp.arange(h_img, dtype=jnp.float32),
            jnp.arange(w_img, dtype=jnp.float32),
            indexing="ij",
        )
        coords = jnp.stack([yy.ravel(), xx.ravel()], axis=-1) / cfg.spatial_h
        feats = jnp.concatenate([feats, coords], axis=-1)
    if cfg.feature_dtype == "bfloat16":
        feats = feats.astype(jnp.bfloat16)
    return feats


def extract_features_padded(img: jnp.ndarray, cfg: PipelineConfig,
                            n_pad: int, h=None,
                            row_chunk: int | None = None) -> jnp.ndarray:
    """Features written straight into the zero-padded (n_pad, d) buffer.

    Memory-lean twin of ``extract_features`` + ``zeros.at[:n].set(...)``
    for the streaming paths. That composition keeps three O(N d) buffers
    live at once on the NLM path — the f32 unfold, its (possibly bf16)
    cast, and the padded copy — which is what ran 64 MP out of HBM
    (18.33 G needed vs 15.75 G: 6.4 + 3.2 + 3.2 G of features alone).
    Here the unfold runs in row chunks inside a ``fori_loop`` whose carry
    IS the padded buffer (donated in place by XLA), so peak extra memory
    is one chunk's f32 intermediate (~256 MB).

    Bit-identical to the unchunked path: the same per-element divide and
    dtype round, only the materialization order differs. Padding rows
    stay exactly zero (the streaming operators' masking convention).
    ``h`` may be traced, as in ``extract_features``.
    """
    import jax

    h_img, w_img = img.shape
    n = h_img * w_img
    assert n_pad >= n
    d = feature_dim(cfg)
    out_dtype = jnp.bfloat16 if cfg.feature_dtype == "bfloat16" else jnp.float32

    # small-d kernels (gaussian/bilateral): one copy is cheap — reuse the
    # plain path and pay the single pad copy (O(N) to O(3N) bytes)
    if cfg.kernel != "nlm":
        feats = extract_features(img, cfg, h=h)
        return jnp.zeros((n_pad, d), feats.dtype).at[:n].set(feats)

    img = img.astype(jnp.float32)
    hh = cfg.h if h is None else h
    patch = cfg.patch_size
    dp = patch * patch
    r = patch // 2
    padded = jnp.pad(img, r, mode="reflect")

    # chunk rows so one f32 chunk intermediate stays ~<=256 MB
    # (row_chunk override: tests force multi-chunk + tail-overlap paths)
    target_elems = (256 << 20) // 4
    cr = row_chunk or max(1, min(h_img, target_elems // max(w_img * dp, 1)))
    cr = min(cr, h_img)
    n_chunks = -(-h_img // cr)

    def body(i, buf):
        # clamp the last chunk's start so the slice shape stays static;
        # overlapped rows recompute the same values and the overlapping
        # dynamic_update_slice rewrites them identically
        s = jnp.minimum(i * cr, h_img - cr)
        sl = jax.lax.dynamic_slice(padded, (s, 0), (cr + 2 * r, w_img + 2 * r))
        views = [sl[dy:dy + cr, dx:dx + w_img]
                 for dy in range(patch) for dx in range(patch)]
        # divide (not multiply-by-reciprocal): bit-identical to the
        # unchunked path's `unfold / (h * sqrt(d))`
        chunk = jnp.stack(views, axis=-1).reshape(cr * w_img, dp) / (
            hh * math.sqrt(dp))
        if cfg.spatial_h > 0.0:
            yy = (s + jnp.arange(cr, dtype=jnp.float32)[:, None]
                  ) * jnp.ones((1, w_img), jnp.float32)
            xx = jnp.ones((cr, 1), jnp.float32) * jnp.arange(
                w_img, dtype=jnp.float32)[None, :]
            coords = jnp.stack([yy.ravel(), xx.ravel()],
                               axis=-1) / cfg.spatial_h
            chunk = jnp.concatenate([chunk, coords], axis=-1)
        return jax.lax.dynamic_update_slice(
            buf, chunk.astype(out_dtype), (s * w_img, 0))

    buf = jnp.zeros((n_pad, d), out_dtype)
    return jax.lax.fori_loop(0, n_chunks, body, buf)


def affinity_strip(
    feats_a: jnp.ndarray,
    feats_all: jnp.ndarray,
    dtype: jnp.dtype = jnp.float32,
    store_dtype: jnp.dtype | None = None,
) -> jnp.ndarray:
    """K strip (p, N): K[i, j] = exp(-|f_Ai - f_j|^2) via the GEMM trick.

    ``feats_all`` is in permuted [A; B] order, so columns [:p] are K_AA and
    [p:] are K_AB (SURVEY.md §1.2 Stage 2). The GEMM runs in ``dtype``
    (bf16 allowed, accumulating f32 on the MXU); distances are clamped at 0
    to kill negative round-off. Output is float32 unless ``store_dtype``
    narrows the STORED strip (distances/exp stay in the compute dtype —
    the bfloat16_store policy: exact math, half the downstream bandwidth).
    """
    a = feats_a.astype(dtype)
    b = feats_all.astype(dtype)
    prec = "default" if dtype == jnp.bfloat16 else "highest"
    cross = jnp.dot(a, b.T, preferred_element_type=jnp.float32, precision=prec)
    na = jnp.sum(feats_a.astype(jnp.float32) ** 2, axis=1)
    nb = jnp.sum(feats_all.astype(jnp.float32) ** 2, axis=1)
    d2 = jnp.maximum(na[:, None] + nb[None, :] - 2.0 * cross, 0.0)
    out = jnp.exp(-d2)
    return out if store_dtype is None else out.astype(store_dtype)


def affinity_blocks(img: jnp.ndarray, idx_a: jnp.ndarray, perm: jnp.ndarray,
                    cfg: PipelineConfig, h=None):
    """Full materialized path: (K_AA (p,p), K_AB (p,N-p)) for one channel.

    K_AA and K_AB are built as separate GEMMs rather than slicing one
    (p, N) strip: slices copy, and at config-2 scale (5.4 GB strip) a
    strip + two slice copies exhausts a 16 GB device. This way exactly one
    big buffer lives.

    ``h``: optional traced bandwidth override (see extract_features).
    """
    feats = extract_features(img, cfg, h=h)
    feats_perm = jnp.take(feats, perm, axis=0)
    p = idx_a.shape[0]
    feats_a = feats_perm[:p]
    dtype = jnp.bfloat16 if cfg.affinity_dtype == "bfloat16" else jnp.float32
    store = (jnp.bfloat16 if cfg.affinity_dtype == "bfloat16_store" else None)
    # K_AA stays f32 regardless: it feeds the p x p Cholesky/ridge solves
    # and is tiny; only the (p, N-p) strip pays the bandwidth bill
    kaa = affinity_strip(feats_a, feats_a, dtype)
    if cfg.use_pallas:
        from .pallas_affinity import affinity_strip_pallas
        kab = affinity_strip_pallas(feats_a, feats_perm[p:], dtype=dtype,
                                    store_dtype=store)
    else:
        kab = affinity_strip(feats_a, feats_perm[p:], dtype=dtype,
                             store_dtype=store)
    return kaa, kab


# ---------------------------------------------------------------------------
# numpy twin used by the float64 oracle (tests/oracle.py): kept adjacent so
# the two implementations stay in lock-step.
# ---------------------------------------------------------------------------

def extract_features_np(img: np.ndarray, cfg: PipelineConfig,
                        h=None) -> np.ndarray:
    h_img, w_img = img.shape
    img = np.asarray(img, dtype=np.float64)
    h = cfg.h if h is None else h
    if cfg.kernel == "nlm":
        r = cfg.patch_size // 2
        d = cfg.patch_size * cfg.patch_size
        padded = np.pad(img, r, mode="reflect")
        views = [
            padded[dy:dy + h_img, dx:dx + w_img]
            for dy in range(cfg.patch_size)
            for dx in range(cfg.patch_size)
        ]
        feats = np.stack(views, axis=-1).reshape(h_img * w_img, d)
        feats = feats / (h * math.sqrt(d))
    else:
        feats = (img / h).reshape(-1, 1)
    if cfg.spatial_h > 0.0:
        yy, xx = np.meshgrid(np.arange(h_img, dtype=np.float64),
                             np.arange(w_img, dtype=np.float64), indexing="ij")
        coords = np.stack([yy.ravel(), xx.ravel()], axis=-1) / cfg.spatial_h
        feats = np.concatenate([feats, coords], axis=-1)
    return feats


def affinity_strip_np(feats_a: np.ndarray, feats_all: np.ndarray) -> np.ndarray:
    na = np.sum(feats_a**2, axis=1)
    nb = np.sum(feats_all**2, axis=1)
    d2 = np.maximum(na[:, None] + nb[None, :] - 2.0 * feats_a @ feats_all.T, 0.0)
    return np.exp(-d2)
