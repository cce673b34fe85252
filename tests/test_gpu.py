"""Card-only checks: the compiled Triton kernels against their plain XLA
twins at the real cfg2/cfg4 widths (bodies in utils/kernel_checks.py,
which chip_smoke.py also runs). They skip on the CPU backend; on a GPU:

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu.py
"""

import jax
import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: the Triton kernels compile only there "
                    "(their interpret-mode twins run in test_pallas.py)")


def test_streaming_kernels_match_xla_at_cfg4(card):
    from graphlap.utils import kernel_checks as kc

    rows = kc.cfg4_kernel_checks(runs=1)
    assert rows and all(r["ok"] for r in rows), rows


def test_affinity_emitter_matches_xla_at_cfg2(card):
    from graphlap.utils import kernel_checks as kc

    row = kc.cfg2_emitter_check(runs=1)
    assert row["ok"], row
