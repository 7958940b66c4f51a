"""Tracing and phase profiling.

Port of mlx_vlm_tpu/utils/profiling.py (PhaseTimer :33, global_phases :74,
annotate :80, trace_if_enabled :93).  The reference stamps its regions
into an XLA trace through `jax.profiler`; here `annotate` is a
`torch.profiler.record_function` region (it shows up, with the kernels it
launched, in any torch.profiler trace taken around it) and
`trace_if_enabled` runs `torch.profiler.profile` over its block and
writes a Chrome trace.

Usage:
- env `MLX_VLM_TPU_PROFILE_DIR=/tmp/trace` — every `trace_if_enabled()`
  region writes a trace there (`<dir>/<suffix>/trace.json`, or
  `<dir>/trace.json` without a suffix).
- `annotate("prefill")` — context manager naming a region in the trace AND
  recording host wall time.
- `PhaseTimer` — accumulates per-phase host durations; `.snapshot()` feeds
  /metrics.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

__all__ = ["PhaseTimer", "annotate", "trace_if_enabled", "phase_timer",
           "global_phases"]


class PhaseTimer:
    """Thread-safe accumulator of named phase durations (seconds)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._total: Dict[str, float] = defaultdict(float)
        self._count: Dict[str, int] = defaultdict(int)

    def add(self, name: str, seconds: float):
        with self._lock:
            self._total[name] += seconds
            self._count[name] += 1

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                name: {"total_s": round(self._total[name], 6),
                       "count": self._count[name],
                       "mean_ms": round(
                           1e3 * self._total[name] / self._count[name], 3)}
                for name in self._total
            }

    def reset(self):
        with self._lock:
            self._total.clear()
            self._count.clear()


_GLOBAL = PhaseTimer()


def global_phases() -> PhaseTimer:
    """Process-wide phase timer (served at /metrics)."""
    return _GLOBAL


@contextlib.contextmanager
def annotate(name: str, timer: Optional[PhaseTimer] = None) -> Iterator[None]:
    """Named region: shows up in a torch.profiler trace AND accumulates host
    wall time in `timer` (default: the global timer)."""
    from torch.profiler import record_function

    timer = timer or _GLOBAL
    t0 = time.perf_counter()
    try:
        with record_function(name):
            yield
    finally:
        timer.add(name, time.perf_counter() - t0)


@contextlib.contextmanager
def trace_if_enabled(suffix: str = "") -> Iterator[bool]:
    """Capture a torch.profiler trace (host and, where there is a card, its
    kernels) when MLX_VLM_TPU_PROFILE_DIR is set.

    Yields True when tracing is active.  Each context writes its own
    `trace.json` into the directory.
    """
    out = os.environ.get("MLX_VLM_TPU_PROFILE_DIR")
    if not out:
        yield False
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    path = os.path.join(out, suffix) if suffix else out
    os.makedirs(path, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield True
    prof.export_chrome_trace(os.path.join(path, "trace.json"))


def phase_timer() -> PhaseTimer:
    """A fresh per-request timer."""
    return PhaseTimer()
