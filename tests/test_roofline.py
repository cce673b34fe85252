"""Roofline accounting (utils/roofline): XLA-derived stage costs.

The analytic cost models are estimates and may drift from the code (they
did in round 3 — committed rows showed frac_of_roofline > 1); the
XLA-derived counts are read from the optimized HLO of the SAME stage jits
the staged pipeline times, so these tests pin the contract that matters:
every timed stage gets a cost entry, counts are positive where the stage
does real work, and the dominant count matches the stage's known
character (the affinity/normalize sweeps are exp-carrying, the filter
apply is not).
"""

import numpy as np
import pytest

import graphlap as gl
from graphlap.models.pipeline import make_plan
from graphlap.utils.roofline import (dense_stage_costs, roofline_report,
                                     select_stage_costs,
                                     streaming_stage_costs,
                                     strip_cache_stage_costs,
                                     xla_stage_costs)

PEAKS = {"bf16_matmul_tflops": 175.5, "f32_matmul_tflops": 30.6,
         "exp_f32_g_per_s": 84.4, "exp_bf16_g_per_s": 174.4,
         "hbm_stream_gbs": 796.6}


@pytest.fixture(scope="module")
def img():
    return gl.make_test_image(64, 64)


def _costs(img2d, cfg):
    plan = make_plan(img2d, cfg)
    costs = xla_stage_costs(img2d.shape, cfg, plan)
    assert costs is not None
    return plan, costs


def test_dense_spectral_stages(img):
    cfg = gl.PipelineConfig(kernel="nlm", h=0.15, sample_rho=0.02,
                            num_eigvecs=10)
    plan, costs = _costs(img, cfg)
    assert set(costs) == {"affinity", "normalize", "eigensolve", "filter"}
    # the affinity stage evaluates exp once per strip entry (p*N up to
    # padding/fusion slack); XLA counts the same program we run
    assert costs["affinity"]["trans"] >= plan.p * plan.n * 0.9
    assert costs["affinity"]["mxu_flops"] > 0
    # the spectral apply does no kernel evaluations
    assert costs["filter"]["trans"] == 0
    assert all(c["hbm_bytes"] > 0 for c in costs.values())


def test_dense_matvec_has_no_eigensolve_stage(img):
    cfg = gl.PipelineConfig(kernel="nlm", h=0.15, sample_rho=0.02,
                            num_eigvecs=10, filter_mode="matvec",
                            filter_name="identity")
    _, costs = _costs(img, cfg)
    assert set(costs) == {"affinity", "normalize", "filter"}


def test_streaming_spectral_stages(img):
    cfg = gl.PipelineConfig(kernel="nlm", h=0.15, sample_rho=0.02,
                            num_eigvecs=10, streaming=True, block_cols=2048)
    plan, costs = _costs(img, cfg)
    assert set(costs) == {"normalize", "eigensolve", "filter"}
    # recompute model: both the Sinkhorn and gram/colstats stages re-emit
    # kernel tiles, so each carries >= one p*N exp sweep's transcendentals
    assert costs["normalize"]["trans"] >= plan.p * plan.n * 0.9
    assert costs["eigensolve"]["trans"] >= plan.p * plan.n * 0.9


def test_streaming_matvec_filter_recomputes(img):
    cfg = gl.PipelineConfig(kernel="nlm", h=0.15, sample_rho=0.02,
                            num_eigvecs=10, streaming=True, block_cols=2048,
                            filter_mode="matvec", filter_name="identity")
    plan, costs = _costs(img, cfg)
    assert set(costs) == {"normalize", "filter"}
    # matvec mode's apply IS strip passes — it carries the exp sweeps
    assert costs["filter"]["trans"] >= plan.p * plan.n * 0.9


def test_report_shape_and_bounds(img):
    cfg = gl.PipelineConfig(kernel="nlm", h=0.15, sample_rho=0.02,
                            num_eigvecs=10)
    _, costs = _costs(img, cfg)
    walls = {k: 1.0 for k in costs}      # fixed walls: fractions = count/peak
    rep = roofline_report(costs, walls, PEAKS, "float32")
    for stage, row in rep.items():
        assert row["bound"] in ("exp", "mxu", "hbm")
        assert row["frac_of_roofline"] == max(
            row["frac_exp_peak"], row["frac_mxu_peak"], row["frac_hbm_peak"])
        assert np.isfinite(row["tflops"])
    # a stage absent from walls is skipped, not crashed
    rep2 = roofline_report(costs, {"affinity": 1.0}, PEAKS, "float32")
    assert set(rep2) == {"affinity"}


def test_select_prefers_xla_unless_scan_opaque():
    analytic = {"normalize": {"trans": 100.0, "mxu_flops": 10.0,
                              "hbm_bytes": 0.0},
                "filter": {"trans": 100.0, "mxu_flops": 10.0,
                           "hbm_bytes": 0.0}}
    xla = {"normalize": {"trans": 90.0, "mxu_flops": 9.0, "hbm_bytes": 1.0},
           # body-counted-once: far below the model -> scan-opaque
           "filter": {"trans": 2.0, "mxu_flops": 0.2, "hbm_bytes": 1.0},
           # a stage the model doesn't cover passes through
           "extra": {"trans": 1.0, "mxu_flops": 1.0, "hbm_bytes": 1.0}}
    costs, src = select_stage_costs(xla, analytic)
    assert costs["normalize"] is xla["normalize"] and src["normalize"] == "xla"
    assert costs["filter"] is analytic["filter"]
    assert src["filter"] == "analytic(scan-opaque-hlo)"
    assert costs["extra"] is xla["extra"] and src["extra"] == "xla"
    # no XLA counts at all -> pure analytic
    costs2, src2 = select_stage_costs(None, analytic)
    assert costs2 is analytic and set(src2.values()) == {"analytic"}


def test_analytic_models_cover_matvec_mode():
    """matvec-mode configs must not KeyError the analytic fallbacks and
    must book the apply sweeps under 'filter' with no eigensolve stage."""
    for extra in ({}, {"streaming": True, "block_cols": 2048},
                  {"streaming": True, "block_cols": 2048,
                   "strip_cache": True}):
        cfg = gl.PipelineConfig(kernel="nlm", h=0.15, sample_rho=0.02,
                                num_eigvecs=10, filter_mode="matvec",
                                filter_name="identity", **extra)
        fn = (strip_cache_stage_costs if extra.get("strip_cache")
              else streaming_stage_costs if extra.get("streaming")
              else dense_stage_costs)
        costs = fn(cfg, 64 * 64, 82, 25)
        assert "eigensolve" not in costs
        assert costs["filter"]["mxu_flops"] > 0
        if extra.get("streaming") and not extra.get("strip_cache"):
            assert costs["filter"]["trans"] >= 2 * 82 * 64 * 64  # 2 sweeps
