"""Test env: force the CPU backend with 8 fake devices.

SURVEY.md §4.3 — ``xla_force_host_platform_device_count=8`` gives 8 virtual
CPU devices so shard_map/pjit tests validate the multi-device path without
a real mesh. Must run before the first ``import jax`` anywhere, hence the
env mutation at conftest import time. Pallas kernels run in interpret mode
here; card-only checks carry the ``gpu`` marker and skip (run them on a
GPU with ``python -m pytest -m gpu tests/test_gpu.py``).
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

# NO persistent compile cache for the CPU suite (graphlap/utils/cache.py
# cpu=True rationale).
import sys  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from graphlap.utils.cache import setup_compilation_cache  # noqa: E402

setup_compilation_cache(os.path.join(os.path.dirname(__file__), ".."),
                        cpu=True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

# Self-sufficient on a fresh checkout: the native codec extension is built
# from source (no committed binaries), so build it in-place once
# if it is missing. tests/test_native.py asserts it imports afterwards.
def _ensure_native_built():
    import glob
    import subprocess
    import sys

    # Decide from the filesystem, NOT by importing the package: a failed
    # ``from . import _native`` leaves a stale ``_native = None`` attribute
    # that a later reload would silently return instead of the fresh .so.
    root = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
    if glob.glob(os.path.join(root, "graphlap", "native", "_native*.so")):
        return
    proc = subprocess.run(
        [sys.executable, "setup.py", "build_ext", "--inplace"],
        cwd=root, check=False, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        # don't abort the session (numpy fallbacks keep most tests valid),
        # but leave the compiler error visible instead of a bare import
        # assertion in test_native
        sys.stderr.write("WARNING: native extension in-place build failed "
                         f"(rc={proc.returncode}):\n{proc.stderr[-2000:]}\n")


_ensure_native_built()


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture(autouse=True, scope="module")
def _release_executables_per_module():
    """XLA:CPU has segfaulted once ~200 compiled executables were live in
    one process (reproduced 4x at the ~90% mark of a full run, in
    backend_compile_and_load with the persistent cache disabled and in the
    cache's AOT serialize/deserialize with it enabled — the same programs
    compile fine in a fresh process, and RAM is not the limit).
    Dropping JAX's in-memory jit caches at each module boundary frees
    the loaded executables and keeps one pytest process — the driver's
    invocation — under the threshold. Costs only cross-module compile
    reuse, which is near zero here (modules use distinct configs)."""
    yield
    import gc

    jax.clear_caches()
    gc.collect()
