"""Observability: throughput counters and profiler helpers.

The reference's only instrumentation is a compile-time debug printf
(SEQ_ALIGN_VERBOSE, alignment.c:9-10).  Production batch alignment needs
real metrics: cell-updates/second (GCUPS), pairs/second, and device traces.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Optional


@dataclasses.dataclass
class RunStats:
    """Accumulates alignment workload counters across batches."""

    pairs: int = 0
    cells: int = 0
    seconds: float = 0.0

    def add(self, lens_a, lens_b, seconds: float):
        self.pairs += len(lens_a)
        self.cells += int(sum(int(a) * int(b) for a, b in zip(lens_a, lens_b)))
        self.seconds += seconds

    @property
    def gcups(self) -> float:
        return self.cells / self.seconds / 1e9 if self.seconds else 0.0

    @property
    def pairs_per_s(self) -> float:
        return self.pairs / self.seconds if self.seconds else 0.0

    def summary(self) -> str:
        return (
            f"pairs={self.pairs} cells={self.cells} "
            f"wall={self.seconds:.3f}s gcups={self.gcups:.3f} "
            f"pairs/s={self.pairs_per_s:.1f}"
        )


@contextlib.contextmanager
def timed(stats: RunStats, lens_a, lens_b):
    """Time one batch and record it: ``with timed(stats, na, nb): run()``."""
    t0 = time.perf_counter()
    yield
    stats.add(lens_a, lens_b, time.perf_counter() - t0)


@contextlib.contextmanager
def device_trace(logdir: Optional[str] = None):
    """torch.profiler trace context, host and CUDA activity, written to
    ``logdir`` as a Chrome trace (``trace.json``) when the block ends;
    no-op when logdir is None so callers can thread a flag straight
    through."""
    if logdir is None:
        yield
        return
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """Named profiler span for host-side phases (padding, traceback, IO)."""
    from torch.profiler import record_function

    return record_function(name)
