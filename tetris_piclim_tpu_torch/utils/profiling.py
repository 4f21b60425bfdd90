"""Profiling hooks.

Counterpart of ``tetris_piclim_tpu/utils/profiling.py``: a device trace
(here ``torch.profiler``, whose trace TensorBoard's profiler plugin and
Chrome's ``chrome://tracing`` / Perfetto read) and a wall-clock section
timer for host-side stages.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def device_trace(logdir: Optional[str]) -> Iterator[None]:
    """``torch.profiler`` trace of the enclosed work into ``logdir`` if one
    is given, else a no-op.

    It records CPU activity, and CUDA activity (kernels, copies) when a card
    is present. When the block ends the trace is written as one
    ``<worker>.<time>.pt.trace.json`` file in ``logdir``
    (``tensorboard_trace_handler``; the ``tensorboard`` package is not
    needed to write it)."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        yield


class SectionTimer:
    """Accumulating wall-clock timer for host-side stages (bank refresh,
    generation, upload)."""

    def __init__(self) -> None:
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def section(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> dict[str, dict]:
        return {
            k: {"total_s": round(v, 4), "count": self.counts[k]}
            for k, v in self.totals.items()
        }
