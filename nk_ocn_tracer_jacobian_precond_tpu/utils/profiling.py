"""Profiling and observability.

The reference's only perf visibility was SuperLU's PStatPrint and an
external memory profiler (SURVEY.md §5). Here: cumulative per-phase
wall-clock stats collectable from any timed() block, and a context manager
around jax.profiler for full device traces.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict


class PhaseStats:
    """Cumulative named-phase timing; thread-unsafe by design (host driver)."""

    def __init__(self):
        self.seconds = defaultdict(float)
        self.calls = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] += time.perf_counter() - t0
            self.calls[name] += 1

    def report(self) -> str:
        rows = sorted(self.seconds.items(), key=lambda kv: -kv[1])
        return "\n".join(f"{name:32s} {sec:9.3f}s  x{self.calls[name]}"
                         for name, sec in rows)

    def to_json(self) -> str:
        return json.dumps({k: round(v, 4) for k, v in self.seconds.items()})


GLOBAL_STATS = PhaseStats()


@contextlib.contextmanager
def jax_trace(trace_dir: str):
    """Capture a full jax.profiler trace (TensorBoard-compatible)."""
    import jax
    jax.profiler.start_trace(trace_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
