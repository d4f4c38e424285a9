"""Stage timing and trace capture.

Counterpart of ``revisit_anything_tpu/utils/profiling.py``:
``StageTimer`` (the same totals, counts and report table),
``stage_timer`` (the process-wide timer the pipeline's stages record
into: ``sam.*``, ``dino.*``, ``agg.*``, ``retrieval.*``, as in the JAX
package) and ``trace``, on ``torch.profiler`` in place of
``jax.profiler``.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import torch


class StageTimer:
    """Accumulates wall-clock seconds per named stage; prints a summary
    table.

    Host wall time only: CUDA work returns before the device finishes, so
    a stage that times device work must end in a readback or a
    ``torch.cuda.synchronize()``, or it records the launches."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "total_s": self.totals[name],
                "count": self.counts[name],
                "mean_s": self.totals[name] / max(1, self.counts[name]),
            }
            for name in self.totals
        }

    def report(self) -> str:
        lines = [f"{'stage':<40} {'total_s':>10} {'count':>8} {'mean_ms':>10}"]
        for name, s in sorted(self.summary().items(),
                              key=lambda kv: -kv[1]["total_s"]):
            lines.append(
                f"{name:<40} {s['total_s']:>10.3f} {s['count']:>8d} "
                f"{1e3 * s['mean_s']:>10.3f}")
        return "\n".join(lines)

    def dump_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2)


_GLOBAL_TIMER = StageTimer()


def stage_timer() -> StageTimer:
    """Process-global stage timer."""
    return _GLOBAL_TIMER


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the block into ``log_dir``
    (a Chrome trace, ``<worker>.<time>.pt.trace.json``): host activity,
    and the device's where CUDA is present. No-op when ``log_dir`` is
    None."""
    if log_dir is None:
        yield
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
