"""Float64 numpy CPU oracle for the full pipeline (SURVEY.md §4.1).

This IS the "CPU reference" that BASELINE.json's metrics name: a straight
numpy/scipy implementation of SURVEY.md §1.2 in float64. Every JAX stage is
unit-tested against it, and the end-to-end gate is PSNR delta <= 0.1 dB on
config 1. It deliberately reuses the numpy twins that live next to each JAX
op so the two implementations cannot drift silently.
"""

from __future__ import annotations

import numpy as np

from graphlap.config import PipelineConfig
from graphlap.utils.sampling import SamplePlan, uniform_grid_sample
from graphlap.ops.affinity import extract_features_np, affinity_strip_np
from graphlap.ops.sinkhorn import (_make_kaa_solve_np,
                                   normalize_blocks_np,
                                   nystrom_matvec_np)
from graphlap.ops.nystrom import nystrom_eigh_chol_np, nystrom_eigh_np
from graphlap.ops.filters import (apply_operator_filter,
                                  apply_spectral_filter_np)


def oracle_affinity(img2d: np.ndarray, plan: SamplePlan, cfg: PipelineConfig):
    feats = extract_features_np(img2d, cfg)
    feats_perm = feats[plan.perm]
    strip = affinity_strip_np(feats_perm[: plan.p], feats_perm)
    return strip[:, : plan.p], strip[:, plan.p:]


def oracle_filter_channel(img2d: np.ndarray, plan: SamplePlan,
                          cfg: PipelineConfig):
    """One grayscale channel through the float64 pipeline.

    Returns (filtered 2-D image clipped to [0,1], eigenvalues (m,)).
    """
    kaa, kab = oracle_affinity(img2d, plan, cfg)
    waa, wab, s_a, s_b = normalize_blocks_np(
        kaa, kab, cfg.normalization, cfg.sinkhorn_iters, cfg.eig_tol,
        cfg.solver)
    y_perm = np.asarray(img2d, np.float64).ravel()[plan.perm]
    if cfg.operator_filter():
        # exact polynomial f(W) y on the float64 completion — the twin of
        # models/pipeline._dense_wapply / streaming._apply_matvec_streaming:
        # W x = s * K~(s x), with the SAME K_AA-ridge solve Sinkhorn uses.
        # NB apply_operator_filter is deliberately SHARED with the
        # pipeline (pure backend-generic arithmetic, numpy in = numpy
        # out); its independence anchor is the dense-eigh crosscheck
        # (test_matvec_filter.test_matvec_matches_exact_dense_operator /
        # test_chebyshev.test_chebyshev_matches_exact_dense_operator),
        # which computes f(M) y SPECTRALLY from the materialized operator
        solve = _make_kaa_solve_np(kaa, cfg.eig_tol, cfg.solver)
        p = plan.p

        def wapply(x):
            top, bottom = nystrom_matvec_np(kaa, kab, solve, s_a * x[:p],
                                            s_b * x[p:])
            return np.concatenate([s_a * top, s_b * bottom])

        z_perm = apply_operator_filter(wapply, y_perm, cfg.filter_name,
                                       cfg.filter_param, cfg.filter_mode,
                                       cfg.cheb_degree)
        z = z_perm[plan.inv_perm].reshape(img2d.shape)
        return np.clip(z, 0.0, 1.0), np.zeros((0,), np.float64)
    # "sketch" is an accelerator for the chol/ridge solve — its float64
    # reference is the exact chol twin (same as lobpcg's)
    eig_fn = (nystrom_eigh_chol_np if cfg.solver in ("chol", "lobpcg",
                                                     "sketch")
              else nystrom_eigh_np)
    vals, vecs = eig_fn(waa, wab, cfg.num_eigvecs, cfg.eig_tol)
    z_perm = apply_spectral_filter_np(y_perm, vals, vecs,
                                      cfg.filter_name, cfg.filter_param)
    z = z_perm[plan.inv_perm].reshape(img2d.shape)
    return np.clip(z, 0.0, 1.0), vals


def oracle_filter_image(image: np.ndarray, cfg: PipelineConfig,
                        plan: SamplePlan | None = None):
    """(H, W) or (H, W, C) image through the oracle; returns (image, vals)."""
    image = np.asarray(image, np.float64)
    if plan is None:
        h, w = image.shape[:2]
        plan = uniform_grid_sample(h, w, cfg.num_samples(h * w))
    if image.ndim == 2:
        return oracle_filter_channel(image, plan, cfg)
    outs, vals = zip(*(oracle_filter_channel(image[..., c], plan, cfg)
                       for c in range(image.shape[-1])))
    return np.stack(outs, axis=-1), np.stack(vals)
