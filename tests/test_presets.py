"""Tests: measured-recipe presets + decimation auto-calibration.

The preset layer (config.tuned_config, CLI -preset) encodes the
benchmark-tuned recipes from BASELINE.md so the calibration rules in
docs/ARCHITECTURE.md §5 are enforced by code, not by the user reading
sweeps: N/k_g >= 256p for the gram decimation (gate), N/k_s >= 32p for
the polished Sinkhorn decimation.
"""

import numpy as np
import pytest

from graphlap.cli import main as cli_main
from graphlap.config import (
    CONFIG2,
    PipelineConfig,
    calibrated_gram_coarse,
    calibrated_sinkhorn_coarse,
    tuned_config,
)

MP8 = 8_388_608            # the cfg4 benchmark shape (2048 x 4096)


def test_gram_calibration_matches_sweep():
    # cfg4: jittered regime, N/32p = 64 -> gc64 (0.031-0.054 dB seed-swept)
    assert calibrated_gram_coarse(MP8, 4096) == 64
    # turbo relaxes the jittered floor to 16p; same measured cap of 64
    assert calibrated_gram_coarse(MP8, 4096, gate=False) == 64
    assert calibrated_gram_coarse(64 * MP8, 4096, gate=False) == 64
    # cfg2-scale problems have too few columns per sample: no decimation
    assert calibrated_gram_coarse(262_144, 5243) == 1
    # mid-size problems that cannot reach the k>=16 jittered regime fall
    # back to the shallow strided rule (N/k >= 256p)
    assert calibrated_gram_coarse(255 * 4096, 4096) == 1
    assert calibrated_gram_coarse(513 * 4096, 4096) == 16    # jittered edge
    # below the jittered regime the strided 256p rule is conservative: the
    # window [256p, 512p) floors to k=1 (no decimation)
    assert calibrated_gram_coarse(300 * 4096, 4096) == 1


def test_sinkhorn_calibration_matches_sweep():
    assert calibrated_sinkhorn_coarse(MP8, 4096) == 64   # the headline sc64
    assert calibrated_sinkhorn_coarse(262_144, 5243) == 1
    assert calibrated_sinkhorn_coarse(64 * MP8, 4096) == 64  # capped


def test_tuned_config_dense_fast():
    cfg = tuned_config(CONFIG2, 512 * 512, "fast")
    assert cfg.affinity_dtype == "bfloat16_store"
    # strip_cache routing (r4): the dense-class recipe runs through the
    # streaming model with a materialized natural-order strip — no [A; B]
    # feature permute, diagonal-offset anti-alias coarse sample, iters=6:
    # 0.011-0.028 dB across 4 seeds
    assert cfg.streaming and cfg.strip_cache
    # the Triton strip emitter keeps XLA's f32 distance temp on chip
    assert cfg.block_cols == 512 * 512 and cfg.use_pallas
    assert cfg.sinkhorn_iters == 6
    # coarse Sinkhorn + polish; gram decimation stays spectral-streaming-only
    assert cfg.sinkhorn_coarse == 16 and cfg.sinkhorn_polish == 1
    assert cfg.gram_coarse == 1
    # the sketch eigensolver is the fast default at headline p
    assert cfg.solver == "sketch"
    # turbo lands on the same strip_cache recipe (iters already 6)
    turbo = tuned_config(CONFIG2, 512 * 512, "turbo")
    assert turbo == cfg


def test_tuned_config_dense_small_image_stays_exact():
    """Below the measured strip-width floors the dense presets must NOT
    decimate (thin-margin regime, dsc_calib CPU rows) and must keep the
    default solver (sketch gated on p >= 4(m + oversample))."""
    cfg = tuned_config(CONFIG2, 128 * 128, "fast")
    assert cfg.sinkhorn_coarse == 1 and cfg.sinkhorn_polish == 0
    assert cfg.solver == CONFIG2.solver


def test_tuned_config_streaming_fast_is_the_headline_recipe():
    base = PipelineConfig(kernel="nlm", h=0.25, sample_rho=0.01,
                          sample_cap=4096, streaming=True)
    cfg = tuned_config(base, MP8, "fast")
    assert cfg.affinity_dtype == "bfloat16" and cfg.use_pallas
    assert cfg.sinkhorn_coarse == 64 and cfg.sinkhorn_polish == 1
    assert cfg.sinkhorn_iters == 6 and cfg.gram_coarse == 64


def test_tuned_config_streaming_turbo_drops_polish():
    base = PipelineConfig(streaming=True, sample_cap=4096)
    cfg = tuned_config(base, MP8, "turbo")
    assert cfg.sinkhorn_polish == 0 and cfg.gram_coarse == 64


def test_tuned_config_feature_store_at_capacity_scale():
    # >= 16 MP: the (N, d) feature tensor is the streaming HBM ceiling —
    # fast/turbo pick the bf16 store (oracle-anchored at 0.0005 dB,
    # parity_anchor.jsonl bf16_feat_bf16). Below 16 MP, or with a spatial
    # term (bf16 coordinates are invalid), or at level="exact", f32 stays.
    base = PipelineConfig(kernel="nlm", streaming=True, sample_cap=4096)
    mp16 = 1 << 24
    assert tuned_config(base, mp16, "fast").feature_dtype == "bfloat16"
    assert tuned_config(base, mp16, "turbo").feature_dtype == "bfloat16"
    assert tuned_config(base, MP8, "fast").feature_dtype == "float32"
    assert tuned_config(base, mp16, "exact").feature_dtype == "float32"
    spatial = base.replace(kernel="gaussian", spatial_h=8.0)
    assert tuned_config(spatial, mp16, "fast").feature_dtype == "float32"
    kept = tuned_config(base, mp16, "fast", keep={"feature_dtype"})
    assert kept.feature_dtype == "float32"


def test_affine_filter_set_matches_registry():
    # config.AFFINE_FILTERS / MATVEC_FILTERS are dependency-free copies of
    # ops.filters' registry flags (config.py cannot import ops.filters:
    # no jax there) — these pins keep them from drifting
    from graphlap.config import AFFINE_FILTERS, MATVEC_FILTERS
    from graphlap.ops.filters import FILTER_REGISTRY as REGISTRY
    from graphlap.ops.filters import MATVEC_FILTERS as OPS_MATVEC
    assert set(AFFINE_FILTERS) == {
        name for name, f in REGISTRY.items() if f.affine}
    assert MATVEC_FILTERS == OPS_MATVEC


def test_tuned_config_routes_affine_filters_to_matvec():
    """Rank-m AFFINE filters are ill-posed on collapsed kernel spectra
    (every accelerated cfg3 recipe measured 1.8-4.6 dB off the exact
    trajectory, polish/coarse depth irrelevant, and even a lone gram_coarse=4
    at full f32 measured 2.5 dB): presets route them to
    the exact polynomial matvec form at EVERY level, so parity twins compare
    like-to-like."""
    base = PipelineConfig(kernel="nlm", h=0.15, sample_cap=4096,
                          streaming=True, block_cols=131072,
                          filter_name="sharpen", filter_param=0.6)
    for level in ("exact", "fast", "turbo"):
        assert tuned_config(base, 1024 * 1024, level).filter_mode == "matvec"
    # dense branch too
    dense = tuned_config(CONFIG2.replace(filter_name="sharpen"),
                         512 * 512, "fast")
    assert dense.filter_mode == "matvec"
    # denoise (projection) filters keep the spectral rank-m form
    assert tuned_config(CONFIG2, 512 * 512, "fast").filter_mode == "spectral"
    # an explicit user choice wins
    kept = tuned_config(base, 1024 * 1024, "fast",
                        keep=frozenset({"filter_mode"}))
    assert kept.filter_mode == "spectral"
    # TWICING stays spectral by design: its f(0)=0 makes the true low-rank
    # polynomial KILL the out-of-rank residual whose add-back is twicing's
    # whole point — measured SSIM 0.26 (matvec) vs 0.87 (spectral) at
    # 512^2 (quality_sweep.jsonl cfg3_matvec_sharpen vs cfg3_512_sharpen)
    tw = tuned_config(base.replace(filter_name="twicing", filter_param=2.0),
                      1024 * 1024, "fast")
    assert tw.filter_mode == "spectral"


def test_tuned_config_small_streaming_degrades_to_no_decimation():
    base = PipelineConfig(kernel="nlm", sample_rho=0.02, streaming=True)
    cfg = tuned_config(base, 262_144, "fast")
    assert cfg.sinkhorn_coarse == 1 and cfg.gram_coarse == 1
    assert cfg.sinkhorn_polish == 0 and cfg.sinkhorn_iters == 10


def test_tuned_config_exact_clears_accelerators():
    fast = tuned_config(PipelineConfig(streaming=True, sample_cap=4096),
                        MP8, "fast")
    exact = tuned_config(fast, MP8, "exact")
    assert exact.affinity_dtype == "float32" and not exact.use_pallas
    assert exact.sinkhorn_coarse == 1 and exact.sinkhorn_polish == 0
    assert exact.gram_coarse == 1


def test_tuned_config_keep_respects_user_fields():
    cfg = tuned_config(CONFIG2, 512 * 512, "fast",
                       keep={"affinity_dtype", "sinkhorn_iters"})
    assert cfg.affinity_dtype == "float32"        # untouched
    assert cfg.sinkhorn_iters == CONFIG2.sinkhorn_iters
    assert cfg.strip_cache                         # still applied


def test_tuned_config_bad_level():
    with pytest.raises(ValueError, match="preset"):
        tuned_config(CONFIG2, 512 * 512, "warp")


def test_cli_preset_fast(tmp_path, capsys):
    from graphlap import make_test_image, save_image
    path = str(tmp_path / "in.png")
    save_image(path, make_test_image(64, 64))
    rc = cli_main(["-f", path, "-grayscale", "-cpu", "-kernel", "nlm",
                   "-sample", "0.03", "-eigvals", "16",
                   "-preset", "fast", "-noise", "0.1"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "preset fast: dtype=bfloat16_store" in out
    assert "PSNR noisy" in out

    # an explicit flag wins over the preset — including argparse prefix
    # abbreviations (regression: '-sinkhorn_it' used to be invisible to
    # the preset's explicit-flag detection)
    rc = cli_main(["-f", path, "-grayscale", "-cpu", "-kernel", "nlm",
                   "-sample", "0.03", "-eigvals", "16",
                   "-preset", "fast", "-sinkhorn_it", "4"])
    assert rc == 0
    assert "sinkhorn=4x1" in capsys.readouterr().out


def test_tuned_config_clamps_decimation_to_block_cols():
    # regression: a valid non-power-of-two block width used to
    # inherit 8 MP-calibrated factors (sc64/gc64) that fail the streaming
    # path's divisibility check. 100000 = 2^5 * 3125 -> factors cap at 32.
    base = PipelineConfig(kernel="nlm", sample_cap=4096, streaming=True,
                          block_cols=100_000)
    cfg = tuned_config(base, MP8, "fast")
    assert cfg.block_cols % cfg.sinkhorn_coarse == 0
    assert cfg.block_cols % cfg.gram_coarse == 0
    assert cfg.sinkhorn_coarse == 32 and cfg.gram_coarse == 32
    # turbo takes the same cap
    cfg = tuned_config(base, MP8, "turbo")
    assert cfg.block_cols % cfg.gram_coarse == 0

    # a cap below the jittered floor (pow2 divisor 8) falls back to the
    # strided estimator, which IS measured-safe at gc8 (the old headline)
    cfg = tuned_config(base.replace(block_cols=131_064), MP8, "fast")
    assert cfg.gram_coarse == 8 and cfg.sinkhorn_coarse == 8

    # an odd block width disables decimation entirely rather than erroring
    cfg = tuned_config(base.replace(block_cols=99_999), MP8, "fast")
    assert cfg.sinkhorn_coarse == 1 and cfg.gram_coarse == 1


def test_cli_feasibility_uses_preset_dtype(tmp_path, capsys, monkeypatch):
    # regression: the dense-feasibility auto-switch used to run
    # BEFORE the preset, sizing the strip at f32 — an image that fits only
    # in the preset's bfloat16_store strip was forced onto streaming.
    from graphlap import make_test_image, save_image
    from graphlap.models import pipeline as pl
    path = str(tmp_path / "in.png")
    save_image(path, make_test_image(64, 64))
    # p=123, N=4096: f32 strip 2.0 MB, bf16_store strip 1.0 MB — pin the
    # limit between the two so only the preset's dtype fits
    monkeypatch.setattr(pl, "dense_strip_bytes_limit", lambda: 1.5e6)
    rc = cli_main(["-f", path, "-grayscale", "-cpu", "-kernel", "nlm",
                   "-sample", "0.03", "-eigvals", "16",
                   "-preset", "fast", "-noise", "0.1"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "auto-enabling -streaming" not in out
    assert "preset fast: dtype=bfloat16_store" in out

    # without a preset the f32 strip is over the limit -> streaming switch
    rc = cli_main(["-f", path, "-grayscale", "-cpu", "-kernel", "nlm",
                   "-sample", "0.03", "-eigvals", "16", "-noise", "0.1"])
    assert rc == 0
    assert "auto-enabling -streaming" in capsys.readouterr().out


def test_tuned_config_divisibility_property():
    # property form of the block-width clamp: for ANY block width and image
    # size, the preset must hand back a config that passes the streaming
    # path's divisibility checks and its own __post_init__ validation.
    rng = np.random.default_rng(7)
    widths = np.concatenate([
        rng.integers(1, 300_000, size=60),       # arbitrary
        np.array([1, 2, 3, 7, 64, 65_536, 99_991,            # primes/pow2
                  2 ** 17, 2 ** 17 - 1, 2 ** 17 + 1]),
    ])
    # the streaming path validates against the ACTIVE block width,
    # min(block_cols, N) — an image smaller than block_cols runs as one
    # N-wide block, so include sizes below/at/above the widths (the
    # N=58,081=241^2 odd case crashed the preset before the min() fix)
    sizes = [4_096, 58_081, 262_144, MP8, 4 * MP8]
    base = PipelineConfig(kernel="nlm", sample_cap=4096, streaming=True)
    for bc in widths:
        for n in sizes:
            for level in ("fast", "turbo", "exact"):
                cfg = tuned_config(base.replace(block_cols=int(bc)), n, level)
                block = min(cfg.block_cols, n)
                assert block % cfg.sinkhorn_coarse == 0, (bc, n, level)
                assert block % cfg.gram_coarse == 0, (bc, n, level)


def test_tuned_config_exact_restores_converged_sinkhorn():
    fast = tuned_config(PipelineConfig(streaming=True, sample_cap=4096),
                        MP8, "fast")
    assert fast.sinkhorn_iters == 6               # tuned for the coarse loop
    exact = tuned_config(fast, MP8, "exact")
    assert exact.sinkhorn_iters >= 10             # converged full-res


def test_config_rejects_streaming_sketch_and_zero_iters():
    # review findings: streaming + solver='sketch' silently fell back to
    # the slow one-shot eigensolve with a mismatched K_AA ridge, and
    # sinkhorn_iters=0 under the COARSE fixed point emitted ~3e14 scales
    import pytest
    with pytest.raises(ValueError, match="materialized strip"):
        PipelineConfig(streaming=True, solver="sketch")
    with pytest.raises(ValueError, match="sinkhorn_iters"):
        PipelineConfig(sinkhorn_iters=0)
    # dense sketch and normalization='none' remain valid
    PipelineConfig(solver="sketch")
    PipelineConfig(normalization="none")


def test_bf16_tiles_rejected_with_spatial_features():
    # review finding (verified numerically): the bf16 GEMM-trick cross
    # against f32 norms cancels catastrophically on image-scale
    # coordinates (adjacent 8 MP pixels: true d2=0.026 -> bf16 d2=87.6,
    # K 0.975 -> 1e-38). Plain 'bfloat16' is rejected with spatial_h>0;
    # 'bfloat16_store' (f32 math, rounded storage) stays valid, and the
    # streaming presets keep f32 tiles on bilateral configs.
    with pytest.raises(ValueError, match="spatial"):
        PipelineConfig(kernel="gaussian", spatial_h=8.0,
                       affinity_dtype="bfloat16")
    PipelineConfig(kernel="gaussian", spatial_h=8.0,
                   affinity_dtype="bfloat16_store")
    bilateral = PipelineConfig(kernel="gaussian", spatial_h=8.0,
                               sample_cap=4096, streaming=True)
    cfg = tuned_config(bilateral, MP8, "fast")
    assert cfg.affinity_dtype == "float32" and cfg.use_pallas
    nospatial = tuned_config(bilateral.replace(spatial_h=0.0), MP8, "fast")
    assert nospatial.affinity_dtype == "bfloat16"
