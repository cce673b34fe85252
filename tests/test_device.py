"""Device plumbing that stays testable on the CPU: the memory budget the
capacity bounds derive from, the on-card smoke script's refusal to run
without a GPU, and its four-card phase on virtual CPU devices."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import pytest

from graphlap.utils import meminfo

ROOT = Path(__file__).resolve().parent.parent


class _FakeDevice:
    def __init__(self, platform, stats):
        self.platform = platform
        self.device_kind = "fake " + platform
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.mark.parametrize("fraction", [meminfo.DENSE_STRIP_FRACTION,
                                      meminfo.V_FRACTION,
                                      meminfo.CHANNEL_STRIPS_FRACTION])
def test_memory_budget_reads_bytes_limit(fraction, monkeypatch):
    dev = _FakeDevice("gpu", {"bytes_limit": 60e9, "bytes_in_use": 1.0})
    monkeypatch.setattr(jax, "devices", lambda *a: [dev])
    assert meminfo.device_memory_bytes() == 60e9
    assert meminfo.memory_budget(fraction) == fraction * 60e9


@pytest.mark.parametrize("stats", [None, {}, {"bytes_in_use": 5.0}])
def test_memory_budget_refuses_device_without_limit(stats, monkeypatch):
    """No guessed default for an accelerator that reports no limit."""
    monkeypatch.setattr(jax, "devices",
                        lambda *a: [_FakeDevice("gpu", stats)])
    with pytest.raises(RuntimeError, match="bytes_limit"):
        meminfo.device_memory_bytes()


def test_cpu_budget_keeps_the_test_routes():
    """On the CPU backend the bounds resolve against the fixed test
    budget, so every capacity route keeps its CPU-suite behaviour."""
    from graphlap.models import pipeline, streaming

    assert jax.default_backend() == "cpu"
    assert meminfo.device_memory_bytes() == meminfo.CPU_TEST_BUDGET_BYTES
    assert pipeline.dense_strip_bytes_limit() == 8e9
    assert streaming.v_bytes_cap() == 6e9
    assert meminfo.memory_budget(meminfo.CHANNEL_STRIPS_FRACTION) == 4e9


def _run_smoke(cwd, env_extra=None):
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "PYTHONPATH")}
    env.update({"JAX_PLATFORMS": "cpu", **(env_extra or {})})
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=str(cwd),
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_refuses_a_cpu_only_process():
    r = _run_smoke(ROOT)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "needs a GPU" in r.stderr


def test_chip_smoke_fails_without_the_repo(tmp_path):
    """Alone in a directory, the script cannot pass for the program."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run_smoke(tmp_path)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_four_card_phase_on_virtual_cpu_devices():
    """The --four phase's body (rows-sharded image + data-sharded frame
    batch, each vs one device) on 4 of the suite's virtual CPU devices at
    a toy size — the rehearsal of the four-card run."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    import graphlap as gl

    base = gl.CONFIG4.replace(sample_rho=0.03, num_eigvecs=16,
                              block_cols=1024)
    out = chip_smoke.four_card_phase(jax.devices()[:4], base, 64, 64)
    json.dumps(out)                                  # log-serializable
    assert out["rows"]["dpsnr_db"] <= chip_smoke.FOUR_TOL_DB
    assert out["frames"]["dpsnr_db"] <= chip_smoke.FOUR_TOL_DB
