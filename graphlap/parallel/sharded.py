"""Row-sharded batched pipeline over a (data, rows) device mesh.

JAX equivalent of the reference's MPI-distributed run
(``mpiexec -n P ./main ...``, SURVEY.md §3.1): PETSc's contiguous row
partition of K_AB / V becomes a named-sharding layout, and every collective
the reference does through MPI_Allreduce/VecScatter becomes an XLA
psum/all-gather chosen by GSPMD (SURVEY.md §2.3 mapping table).

Layouts (B = frames/channels on ``data``, N pixels on ``rows``):

    frames   (B, H, W)        P('data', None, None)
    K strip  (B, p, N)        P('data', None, 'rows')   <- the memory wall
    p x p    (B, p, p)        P('data')                 <- replicated per row group
    V_B      (B, N-p, m)      P('data', 'rows', None)   <- extension output
    output   (B, H, W)        P('data', None, None)

The per-stage math reuses the single-device ops via vmap; sharding
constraints are placed on the big N-axis tensors at stage boundaries and
GSPMD propagates layouts through the vmapped interiors. Batched eigh on the
replicated (B, p, p) blocks runs identically on every rows-shard — the
communication-free direct eigensolve that replaces SLEPc's distributed
Krylov iteration (SURVEY.md §3.4).
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from ..config import PipelineConfig
from ..ops.affinity import affinity_strip, extract_features
from ..ops.filters import apply_spectral_filter
from ..ops.sinkhorn import normalize_blocks
from ..utils.sampling import SamplePlan
from .mesh import shard


@lru_cache(maxsize=None)
def build_sharded_pipeline(mesh, cfg: PipelineConfig):
    """Returns a jitted fn (frames (B,H,W) f32, idx_a, perm, inv_perm) ->
    (filtered (B,H,W), eigvals (B,m)) sharded over ``mesh``.

    Memoized on (mesh, cfg): rebuilding per call creates a fresh jit whose
    re-trace + lowering cost rivals the run itself (measured ~2x wall on
    the video rows before memoization)."""

    dtype = jnp.bfloat16 if cfg.affinity_dtype == "bfloat16" else jnp.float32
    # bfloat16_store: exact f32 distance math, bf16 STORED strip — the
    # sharded strip is one (B, p, N) buffer, so the narrow store halves
    # every rows-sharded read downstream (same policy as affinity_blocks)
    store = jnp.bfloat16 if cfg.affinity_dtype == "bfloat16_store" else None

    @jax.jit
    def run(frames, idx_a, perm, inv_perm):
        b, h, w = frames.shape
        p = idx_a.shape[0]
        frames = shard(frames.astype(jnp.float32), mesh, "data")

        feats = jax.vmap(lambda im: extract_features(im, cfg))(frames)
        feats = shard(feats, mesh, "data", "rows")            # (B, N, d)
        feats_perm = jnp.take(feats, perm, axis=1)
        feats_a = feats_perm[:, :p]

        # K_AA is its own f32 GEMM (matching affinity_blocks): slicing it
        # out of a bfloat16-stored strip would round the block that feeds
        # every p x p Cholesky/ridge solve (measured 1e-3-class pixel
        # divergence vs the single-device path)
        kaa = jax.vmap(lambda fa: affinity_strip(fa, fa, dtype))(feats_a)
        kaa = shard(kaa, mesh, "data")
        kab = jax.vmap(
            lambda fa, f: affinity_strip(fa, f, dtype, store_dtype=store))(
            feats_a, feats_perm[:, p:])
        kab = shard(kab, mesh, "data", None, "rows")

        waa, wab, s_a, s_b = jax.vmap(
            lambda a, b_: normalize_blocks(a, b_, cfg.normalization,
                                           cfg.sinkhorn_iters, cfg.eig_tol,
                                           cfg.solver, cfg.sinkhorn_coarse,
                                           cfg.sinkhorn_polish)
        )(kaa, kab)
        waa = shard(waa, mesh, "data")
        wab = shard(wab, mesh, "data", None, "rows")

        if cfg.operator_filter():
            # exact polynomial f(W) y per frame — the strip matvec reduces
            # over the rows-sharded N axis (GSPMD inserts the psum), the
            # p-sized state is replicated per row group; no eigensolve
            # (models/pipeline._dense_wapply is the single-device twin)
            from ..ops.filters import apply_operator_filter
            from ..ops.sinkhorn import _make_kaa_solve, nystrom_matvec

            y_perm = jnp.take(frames.reshape(b, h * w), perm, axis=1)
            y_perm = shard(y_perm, mesh, "data", "rows")

            def one(kaa1, kab1, sa1, sb1, y1):
                solve = _make_kaa_solve(kaa1, cfg.eig_tol, cfg.solver)

                def wapply(x):
                    top, bottom = nystrom_matvec(kaa1, kab1, solve,
                                                 sa1 * x[:p], sb1 * x[p:])
                    return jnp.concatenate([sa1 * top, sb1 * bottom])

                return apply_operator_filter(
                    wapply, y1, cfg.filter_name, cfg.filter_param,
                    cfg.filter_mode, cfg.cheb_degree)

            z_perm = jax.vmap(one)(kaa, kab, s_a, s_b, y_perm)
            z = jnp.take(z_perm, inv_perm, axis=1).reshape(b, h, w)
            z = shard(jnp.clip(z, 0.0, 1.0), mesh, "data")
            return z, jnp.zeros((b, 0), jnp.float32)

        # _solve_basis is the ONE home of the solver/gram-dtype policy
        # (models/pipeline.py docstring); this batch path vmaps it rather
        # than re-implementing the dispatch (review finding: the inline
        # copy here had already started to drift)
        from ..models.pipeline import _solve_basis
        basis = jax.vmap(lambda a, b_: _solve_basis(a, b_, cfg))(waa, wab)
        vecs = shard(basis.vecs, mesh, "data", "rows", None)  # (B, N, m)

        y_perm = jnp.take(frames.reshape(b, h * w), perm, axis=1)
        y_perm = shard(y_perm, mesh, "data", "rows")
        z_perm = jax.vmap(
            lambda y, v, vc: apply_spectral_filter(
                y, v, vc, cfg.filter_name, cfg.filter_param)
        )(y_perm, basis.vals, vecs)

        z = jnp.take(z_perm, inv_perm, axis=1).reshape(b, h, w)
        z = shard(jnp.clip(z, 0.0, 1.0), mesh, "data")
        return z, basis.vals

    return run


def filter_frames_sharded(frames: np.ndarray, cfg: PipelineConfig,
                          plan: SamplePlan, mesh):
    """Host entry: (B, H, W) float frames -> (filtered, eigvals)."""
    run = build_sharded_pipeline(mesh, cfg)
    z, vals = run(jnp.asarray(frames, jnp.float32),
                  jnp.asarray(plan.idx_a), jnp.asarray(plan.perm),
                  jnp.asarray(plan.inv_perm))
    z = jax.block_until_ready(z)
    return np.asarray(z), np.asarray(vals)
