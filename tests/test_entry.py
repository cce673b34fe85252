"""Driver-contract smoke tests: __graft_entry__ and bench plumbing."""

import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent.parent))


def test_entry_compiles():
    """entry() is the REAL 512^2 flagship — on the suite's CPU backend,
    EXECUTING it would cost minutes, so this validates the driver contract
    compile-only; chip_smoke.py executes it on the GPU (same graph, same
    recipe)."""
    import __graft_entry__ as ge
    fwd, args = ge.entry()
    lowered = jax.jit(fwd).lower(*args)
    out_shapes = jax.tree_util.tree_leaves(lowered.out_info)
    assert out_shapes[0].shape == args[0].shape
    lowered.compile()                                 # XLA accepts the graph
    assert args[0].shape == (512, 512)                # the flagship shape


def test_dryrun_multichip_eight():
    import __graft_entry__ as ge
    ge.dryrun_multichip(8)


def test_dryrun_multichip_two():
    import __graft_entry__ as ge
    ge.dryrun_multichip(2)


def test_dryrun_multichip_bare_subprocess():
    """The driver's invocation mode: a clean interpreter with NO conftest
    env (no XLA_FLAGS, no JAX_PLATFORMS). Round 1 shipped a dryrun that
    only worked under pytest and went red in MULTICHIP_r01.json; this test
    reproduces the driver's call exactly."""
    import os
    import subprocess
    root = Path(__file__).parent.parent
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS",
                        "_GRAPHLAP_DRYRUN_SUBPROC")}
    env.setdefault("JAX_COMPILATION_CACHE_DIR", str(root / ".jax_cache"))
    code = "import __graft_entry__ as g; g.dryrun_multichip(8)"
    r = subprocess.run([sys.executable, "-c", code], cwd=str(root), env=env,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, f"stderr:\n{r.stderr[-3000:]}"
    assert "dryrun_multichip OK" in r.stdout


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compile_cache_policy(env_dir, tmp_path, monkeypatch):
    """Cache rule (graphlap/utils/cache.py): JAX_COMPILATION_CACHE_DIR
    is honoured exactly as given and nothing is set in code; without it
    the cache is the fixed <repo>/.jax_cache; CPU runs turn it off."""
    from graphlap.utils.cache import cache_dir, setup_compilation_cache

    root = Path(__file__).parent.parent
    sentinel = str(tmp_path / "set-by-jax")
    jax.config.update("jax_compilation_cache_dir", sentinel)
    try:
        if env_dir is None:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            expect = str(root / ".jax_cache")
            assert cache_dir(root) == expect
            assert setup_compilation_cache(root) == expect
            assert jax.config.jax_compilation_cache_dir == expect
        else:
            given = str(tmp_path / env_dir)
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", given)
            assert cache_dir(root) == given
            assert setup_compilation_cache(root) == given
            # JAX reads the variable itself: the code set nothing
            assert jax.config.jax_compilation_cache_dir == sentinel
        assert setup_compilation_cache(root, cpu=True) is None
        assert jax.config.jax_compilation_cache_dir is None
    finally:
        jax.config.update("jax_compilation_cache_dir", None)


def test_make_mesh_validates_device_count():
    from graphlap.parallel.mesh import make_mesh
    with pytest.raises(ValueError, match="devices"):
        make_mesh(n_rows=3, n_data=2)      # 6 != 8 fake devices
    with pytest.raises(ValueError, match="divide"):
        make_mesh(n_data=3)                # 3 does not divide 8
    with pytest.raises(ValueError, match="devices"):
        make_mesh(n_rows=2, n_data=1, devices=jax.devices()[:1])


def test_bench_contract_keys():
    """bench.py main() must print one JSON object with the driver keys."""
    import bench
    assert bench.RUNS >= 1
    assert bench.MEGAPIXELS > 0
    # workload builds without device work
    gl, cfg, img, noisy = bench.make_workload()
    # the headline: the strip_cache streaming recipe of the "fast" preset
    assert cfg.streaming and cfg.strip_cache and cfg.use_pallas
    assert img.shape == (bench.H, bench.W)


def test_bench_cpu_baseline_cache_is_fresh():
    """The checked-in CPU baseline cache must validate against the pinned
    reference contract, and the driver path must read it WITHOUT spawning
    the ~9-minute re-measure subprocess (a schema-stale cache at driver
    time would silently eat the bench budget)."""
    import json
    import subprocess
    from unittest import mock

    import bench

    assert bench.BASELINE_CACHE.exists(), "cpu_baseline.json missing"
    cached = json.loads(bench.BASELINE_CACHE.read_text())
    assert cached["config"] == bench.reference_cpu_cfg().to_dict(), (
        "cpu_baseline.json config is stale vs reference_cpu_cfg() — "
        "re-measure with BENCH_CPU_BASELINE=1 python bench.py (new "
        "PipelineConfig fields must be added to the cache with their "
        "defaults if the measured workload is unchanged)")
    with mock.patch.object(subprocess, "run",
                           side_effect=AssertionError("subprocess spawned")):
        assert bench.cpu_baseline_for_main() == cached["mp_per_s"]
