"""Compile-time HBM accounting vs the analytic memory model.

Pins utils/meminfo's XLA memory_analysis numbers against the regime table
in docs/ARCHITECTURE.md §6: the dense path's peak is the
(p, N) strip; the streaming path materializes NO O(Np) buffer — its peak
is O(Nd + Nm + p^2).
"""

import numpy as np
import pytest

import graphlap as gl
from graphlap.models.pipeline import make_plan
from graphlap.utils.meminfo import peak_hbm_gib, pipeline_hbm_analysis

SIDE = 256


@pytest.fixture(scope="module")
def shapes():
    img = gl.make_test_image(SIDE, SIDE)
    cfg = gl.PipelineConfig(kernel="nlm", h=0.2, sample_rho=0.02,
                            num_eigvecs=50, sinkhorn_iters=8)
    plan = make_plan(img, cfg)
    return img, cfg, plan


def test_dense_peak_is_the_strip(shapes):
    img, cfg, plan = shapes
    ma = pipeline_hbm_analysis(img.shape, cfg, plan)
    assert ma is not None
    strip = plan.p * plan.n * 4.0
    # the strip must be resident (plus the scaled copy the normalize
    # produces and working buffers) but bounded by a few strip-multiples
    assert ma["temps"] >= strip
    assert ma["total"] <= 6.0 * strip


def test_streaming_is_strip_free(shapes):
    img, cfg, plan = shapes
    scfg = cfg.replace(streaming=True, block_cols=16384)
    ma = pipeline_hbm_analysis(img.shape, scfg, plan)
    dense = pipeline_hbm_analysis(img.shape, cfg, plan)
    assert ma is not None and dense is not None
    strip = plan.p * plan.n * 4.0
    n, p, d, m = plan.n, plan.p, 25, cfg.num_eigvecs
    # ARCHITECTURE §6 streaming regime: O(Nd + Nm + p^2 + N) — no O(Np)
    # buffer. The p^2 constant is ~20: the eigensolve chain (kaa, gram,
    # cholesky, LOBPCG block, eigh workspace) each hold a few p^2 f32
    # temporaries in XLA's buffer assignment (measured 136 MB at 256^2,
    # p=1311, of which the p^2 class is ~120 MB).
    analytic = 4.0 * (n * d + 2 * n * m + 24 * p * p + 12 * n)
    assert ma["temps"] < analytic
    assert ma["total"] < 0.5 * strip          # strictly below the strip
    assert ma["total"] < dense["total"]


def test_peak_hbm_gib_reports_a_source(shapes):
    img, cfg, plan = shapes
    gib, source = peak_hbm_gib(img.shape, cfg, plan)
    assert source in ("runtime", "memory_analysis")
    assert gib is not None and gib > 0
