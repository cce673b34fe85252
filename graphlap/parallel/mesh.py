"""Device-mesh construction helpers.

JAX replacement for the reference's MPI communicator / PETSc row
partition (SURVEY.md §2.2 N1/N3, §2.3): a 2-D ``(data, rows)`` mesh where

* ``rows`` shards the N-pixel axis — the strip columns, extension rows and
  reconstruction (the PETSc MATMPIDENSE row-distribution analogue, and this
  workload's sequence/context parallelism);
* ``data`` is pure data parallelism over frames/channels
  (BASELINE config 5's batch axis; DCN-friendly).

XLA inserts the collectives (psum for column sums and V^T y, all-gathers for
the replicated p x p factors) — the ``MPI_Allreduce``/``VecScatter``
equivalents ride ICI inside a slice (SURVEY.md §5 comm-backend row).
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_rows: int | None = None, n_data: int = 1,
              devices=None) -> Mesh:
    """Build a (data, rows) mesh over the available devices.

    Defaults to all devices on the rows axis (pure row-sharding, the
    reference's only strategy).
    """
    devices = list(devices if devices is not None else jax.devices())
    if n_data < 1:
        raise ValueError(f"n_data must be >= 1, got {n_data}")
    if n_rows is None:
        if len(devices) % n_data != 0:
            raise ValueError(
                f"n_data={n_data} does not divide the {len(devices)} available "
                f"device(s) ({devices[0].platform}); pass n_rows explicitly or "
                f"choose a divisor of the device count")
        n_rows = len(devices) // n_data
    if n_rows * n_data != len(devices):
        raise ValueError(
            f"mesh shape (data={n_data}, rows={n_rows}) needs "
            f"{n_rows * n_data} devices but {len(devices)} "
            f"{devices[0].platform} device(s) are available; on a short "
            f"platform force virtual CPU devices first "
            f"(XLA_FLAGS=--xla_force_host_platform_device_count=K plus "
            f'jax.config.update("jax_platforms", "cpu") before first JAX use)')
    import numpy as np
    arr = np.array(devices).reshape(n_data, n_rows)
    return Mesh(arr, ("data", "rows"))


def shard(x, mesh: Mesh, *spec):
    """Constrain an intermediate to a named layout; XLA inserts collectives."""
    return jax.lax.with_sharding_constraint(x, NamedSharding(mesh, P(*spec)))
