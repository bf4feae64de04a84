"""Segment timing and profiler traces.

Port of :mod:`eryn_tpu.utils.profiling`.  :class:`SegmentTimer` is the
sampler's ``timing``: ``(nsteps, seconds)`` per segment.  On a CUDA device
a segment is timed by two CUDA events recorded at its start and its end on
the sampler's stream, which nothing waits for: the seconds are read when
the timer is first read after the segment, so timing adds no wait to a run.
On the CPU, where every op has finished when it returns, it is the host
clock.  :func:`trace_profile` writes a Chrome trace of what runs inside it
with ``torch.profiler``.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

import numpy as np
import torch

__all__ = ["SegmentTimer", "trace_profile"]


class SegmentTimer:
    """Accumulates per-segment wall time and step counts (``segments``,
    ``total_steps``, ``total_time``, ``steps_per_second``, ``summary()``)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._durations = []
        self._pending = []  # (nsteps, start event, end event)

    def start(self, device):
        """A mark at the start of a segment on ``device``: a recorded CUDA
        event, or the host clock."""
        if torch.device(device).type == "cuda":
            mark = torch.cuda.Event(enable_timing=True)
            mark.record()
            return mark
        return time.perf_counter()

    def stop(self, mark, nsteps):
        """Close the segment ``mark`` opened, of ``nsteps`` steps."""
        if isinstance(mark, torch.cuda.Event):
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self._pending.append((nsteps, mark, end))
        else:
            self.record(nsteps, time.perf_counter() - mark)

    def record(self, nsteps, seconds):
        self._durations.append((int(nsteps), float(seconds)))

    def _resolve(self):
        """The seconds of the closed device segments (waits for the last)."""
        for nsteps, start, end in self._pending:
            end.synchronize()
            self.record(nsteps, start.elapsed_time(end) / 1e3)
        self._pending = []

    @property
    def durations(self):
        """``[(nsteps, seconds), ...]`` per segment, in order."""
        self._resolve()
        return list(self._durations)

    @property
    def segments(self):
        return len(self.durations)

    @property
    def total_steps(self):
        return sum(n for n, _ in self.durations)

    @property
    def total_time(self):
        return sum(t for _, t in self.durations)

    @property
    def steps_per_second(self):
        total = self.total_time
        return float("nan") if total == 0 else self.total_steps / total

    def summary(self):
        rates = np.array([n / max(t, 1e-12) for n, t in self.durations])
        return {
            "segments": self.segments,
            "total_steps": self.total_steps,
            "total_time_s": self.total_time,
            "steps_per_second": self.steps_per_second,
            "steps_per_second_max": float(rates.max()) if rates.size else None,
        }

    def __repr__(self):
        return f"SegmentTimer({self.summary()})"


@contextlib.contextmanager
def trace_profile(log_dir, name="trace.json"):
    """Profile everything inside the context with ``torch.profiler`` (the
    host, and the device where CUDA is available) and write a Chrome trace
    to ``log_dir/name`` (view it in ``chrome://tracing`` or Perfetto).
    Yields the profiler, whose ``key_averages()`` sum the time by op::

        with trace_profile("eryn_trace") as prof:
            sampler.run_mcmc(coords, 1000)
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    path = Path(log_dir)
    path.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(path / name))
