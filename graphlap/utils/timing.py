"""Stage timing, structured run logging, and profiler hooks.

JAX equivalent of the reference's PETSc ``-log_view`` stage/event
timers and rank-0 printing (SURVEY.md §2.2 #9, §5 tracing row):
``block_until_ready``-bounded wall clocks per stage, structured JSONL run
records, and an optional ``jax.profiler`` trace for xprof/TensorBoard.
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path

DEFAULT_LOG = Path("benchmarks/results/runs.jsonl")


class StageTimer:
    """Accumulates named wall-clock spans (PetscLogStagePush/Pop analogue)."""

    def __init__(self):
        self.walls: dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.walls[name] = self.walls.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> str:
        total = sum(self.walls.values())
        lines = [f"{'stage':<12} {'seconds':>9}  {'share':>6}"]
        for k, v in sorted(self.walls.items(), key=lambda kv: -kv[1]):
            share = v / total if total else 0.0
            lines.append(f"{k:<12} {v:9.4f}  {share:5.1%}")
        lines.append(f"{'total':<12} {total:9.4f}")
        return "\n".join(lines)


def log_run(record: dict, path: Path | str = DEFAULT_LOG) -> None:
    """Append one structured JSON record per run (SURVEY.md §5 observability)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    record = dict(record)
    record.setdefault("ts", time.time())
    with path.open("a") as f:
        f.write(json.dumps(record) + "\n")


@contextlib.contextmanager
def maybe_profile(trace_dir: str | None):
    """Wrap a block in jax.profiler.trace when a directory is given."""
    if not trace_dir:
        yield
        return
    import jax

    with jax.profiler.trace(trace_dir):
        yield
