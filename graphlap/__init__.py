"""graphlap — global image filtering via the graph Laplacian, in JAX.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of
``David-Wobrock/image-processing-graph-laplacian`` (C + PETSc/SLEPc/MPI
implementation of the Milanfar/GLIDE global filter; see SURVEY.md).

Public API mirrors the reference pipeline stages:
load image -> sample -> affinity -> eigensolve -> filter -> reconstruct.
"""

import jax as _jax

# Precision policy (SURVEY.md §7 hard part 4): JAX's *default* matmul
# precision lowers f32 GEMM inputs to bf16 (measured 1e-2 relative error —
# fatal both for the GEMM-trick distance cancellation and for the Nystrom
# S-matrix; on GPUs an unpinned f32 GEMM may run in TF32). We pin full-f32
# GEMMs globally and express mixed precision explicitly instead: deliberate
# bf16 INPUT dtypes (cfg.affinity_dtype) with f32 accumulation. The pin
# does not reach dots inside Pallas kernels; those name their precision
# (ops/pallas_streaming.dot_precision).
_jax.config.update("jax_default_matmul_precision", "highest")

from .config import (PipelineConfig, CONFIG1, CONFIG2, CONFIG3, CONFIG4,
                     denoise_tuned, tuned_config)
from .io import load_image, save_image, add_gaussian_noise, make_test_image
from .metrics import estimate_noise_sigma, psnr, ssim
from .models.pipeline import (
    FilterResult,
    compute_basis,
    filter_image,
    filter_image_staged,
    make_plan,
    sinkhorn_ds_residual,
)
from .models.tiled import filter_image_tiled
from .models.video import filter_video, filter_video_multihost
from .tune import SureRow, sure_risk, tune_h_sure
from .parallel.streaming_sharded import filter_image_multihost
from .utils.checkpoint import filter_with_basis, load_basis, save_basis
from .utils.sampling import SamplePlan, random_sample, uniform_grid_sample

__version__ = "0.1.0"

__all__ = [
    "PipelineConfig", "CONFIG1", "CONFIG2", "CONFIG3", "CONFIG4",
    "tuned_config",
    "denoise_tuned", "estimate_noise_sigma",
    "load_image", "save_image", "add_gaussian_noise", "make_test_image",
    "psnr", "ssim",
    "FilterResult", "filter_image", "filter_image_staged",
    "filter_image_tiled", "make_plan", "sinkhorn_ds_residual",
    "compute_basis", "filter_video", "filter_video_multihost",
    "filter_image_multihost",
    "save_basis", "load_basis", "filter_with_basis",
    "SamplePlan", "uniform_grid_sample", "random_sample",
    "SureRow", "sure_risk", "tune_h_sure",
]
