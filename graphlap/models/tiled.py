"""Out-of-core tiled filtering: images past the single-device ceiling.

The streaming path's capacity limit is the (N, d) feature buffer (tens of
MP per device with the bf16 store). Past it —
or on any machine-sized image — the practical recipe is the one the
GLIDE literature itself applies: filter overlapping tiles independently
and blend. Each tile gets its OWN graph/basis (the filter becomes
global-per-tile rather than global-per-image; with tiles >= ~10^5 px the
affinity horizon is far smaller than the tile, so the quality difference
is below the noise floor — measured in tests/test_tiled.py), and every
tile reuses ONE compiled executable (same static shape).

Blending: 2D raised-cosine (Hann-ramped) weights over the overlap,
normalized per-pixel to an exact partition of unity — constant inputs
reproduce exactly, and seams are C^1-smooth. Edges are handled by
clamping the tile grid to the image (interior-shifted final row/column),
so no reflective padding enters any graph.

No reference equivalent: the C implementation loads one PETSc-
distributed image (SURVEY.md §1.2) and is bounded by cluster memory;
this is capacity the rebuild adds.
"""

from __future__ import annotations

import numpy as np

from ..config import PipelineConfig
from .pipeline import FilterResult, filter_image, make_plan


def _tile_starts(size: int, tile: int, step: int) -> list[int]:
    """Start offsets covering [0, size) with the final tile clamped
    inside the image (uniform tile shape => one compiled executable)."""
    if size <= tile:
        return [0]
    starts = list(range(0, size - tile, step))
    starts.append(size - tile)
    return starts


def _hann_ramp(n: int, ramp: int, lo_open: bool, hi_open: bool) -> np.ndarray:
    """1-D blend profile: 1 in the interior, half-Hann ramps of width
    ``ramp`` on sides that border a neighboring tile (open sides)."""
    w = np.ones(n, np.float32)
    if ramp > 0:
        r = 0.5 - 0.5 * np.cos(np.pi * (np.arange(ramp) + 0.5) / ramp)
        if lo_open:
            w[:ramp] = r
        if hi_open:
            w[-ramp:] = r[::-1]
    return w


def filter_image_tiled(image: np.ndarray, cfg: PipelineConfig,
                       tile: int = 2048, overlap: int = 256,
                       mesh=None) -> FilterResult:
    """Filter an arbitrarily large (H, W[, C]) image in overlapping
    tiles, Hann-blended. ``tile`` is the square tile side, ``overlap``
    the inter-tile overlap (also the blend-ramp width). Each tile runs
    the full pipeline with its own sampling plan/graph — pass a
    streaming ``cfg`` (+ optional ``mesh``) for big tiles. Returns a
    FilterResult whose ``eigvals`` stack one row per tile (empty in
    operator modes)."""
    image = np.asarray(image, np.float32)
    if not 0 <= overlap < tile:
        raise ValueError(f"need 0 <= overlap < tile, got overlap={overlap} "
                         f"tile={tile}")
    h, w = image.shape[:2]
    if h <= tile and w <= tile:
        return filter_image(image, cfg, mesh=mesh)
    step = tile - overlap
    ys = _tile_starts(h, tile, step)
    xs = _tile_starts(w, tile, step)

    acc = np.zeros(image.shape, np.float32)
    wsum = np.zeros((h, w), np.float32)
    plan = None
    vals = []
    for y0 in ys:
        for x0 in xs:
            th = min(tile, h)
            tw = min(tile, w)
            sub = image[y0:y0 + th, x0:x0 + tw]
            if plan is None:
                # one plan for every tile: identical shape => identical
                # sample geometry => ONE compiled executable reused
                plan = make_plan(sub, cfg)
            res = filter_image(sub, cfg, plan=plan, mesh=mesh)
            wy = _hann_ramp(th, min(overlap, th // 2),
                            lo_open=y0 > 0, hi_open=y0 + th < h)
            wx = _hann_ramp(tw, min(overlap, tw // 2),
                            lo_open=x0 > 0, hi_open=x0 + tw < w)
            wt = wy[:, None] * wx[None, :]
            acc[y0:y0 + th, x0:x0 + tw] += (
                res.image * (wt if image.ndim == 2 else wt[..., None]))
            wsum[y0:y0 + th, x0:x0 + tw] += wt
            vals.append(np.asarray(res.eigvals))
    wsum = np.maximum(wsum, 1e-12)
    out = acc / (wsum if image.ndim == 2 else wsum[..., None])
    return FilterResult(image=np.clip(out, 0.0, 1.0),
                        eigvals=np.stack(vals), timings={})
