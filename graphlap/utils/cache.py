"""Persistent-compile-cache location.

One rule for every entry point that enables the cache (bench.py,
__graft_entry__.py, chip_smoke.py, benchmarks/*, scripts/*):

* ``JAX_COMPILATION_CACHE_DIR`` set: JAX already reads it, so this module
  sets nothing and the cache lives exactly there.
* unset: ``<repo>/.jax_cache`` — a fixed path, because the path is part
  of the cache key and a directory that moves never hits.

``cpu=True`` (callers that force the CPU backend: tests/conftest.py,
CPU-side scripts) turns the persistent cache OFF instead: jaxlib's
XLA:CPU ahead-of-time executable (de)serialization has segfaulted long
test processes deep into a full run, while the suite runs just as fast
without the cache.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def cache_dir(repo_root: str | os.PathLike) -> str:
    """Where the persistent cache lives: the env var if set, else the
    repo's fixed ``.jax_cache``."""
    return os.environ.get(ENV_VAR) or os.path.join(str(repo_root),
                                                   ".jax_cache")


def setup_compilation_cache(repo_root: str | os.PathLike,
                            cpu: bool = False) -> str | None:
    """Apply the cache rule above; returns the directory in use (None when
    the cache is off)."""
    import jax

    if cpu:
        jax.config.update("jax_compilation_cache_dir", None)
        return None
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", cache_dir(repo_root))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.1)
    return cache_dir(repo_root)
