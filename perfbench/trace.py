"""``torch.profiler`` over whole segments of the window, and its reduction
to counts, device time and idle gaps.

Each traced segment (the stored steps between two calls of the stopping
hook) is a profiler session of its own, started in one hook call and
stopped in the next, after that call's read of the newest sample, so that
the device has finished the segment.  The profiler can lose device
records (one session over ten steps of about 15,700 records lost about a
thousand of them on the H100), so each segment's trace is held against the
port's kernel launch counters over the same segment: a segment whose trace
shows fewer launches of one of the port's kernels than were counted is left
out, and the harness prints how many.
"""

from __future__ import annotations

import bisect
import re
import time

# the port's hand-written kernels: (key, the device function's name, the
# names of the wrappers whose ``launches`` count it)
KERNELS = (
    ("stretch_propose", r"\bstretch_propose_kernel", ("stretch_propose",)),
    ("stretch_accept_propose", r"\bstretch_accept_propose_kernel",
     ("stretch_accept_propose",)),
    ("stretch_accept", r"\bstretch_accept_kernel", ("stretch_accept",)),
    ("pt_swap_cascade", r"\bpt_swap_cascade_kernel",
     ("pt_swap_cascade_multi", "_cascade_multi_rolled")),
    ("group_stretch_propose", r"\bgroup_stretch_propose_kernel",
     ("group_stretch_propose",)),
    ("onehot_select", r"\bonehot_select_kernel", ("onehot_select",)),
)
HOST_LAUNCHES = ("cudaGraphLaunch", "cudaLaunch", "cuLaunch", "cudaMemcpy",
                 "cudaMemset")


def _short(name, n=120):
    return name.replace("void ", "").replace("(anonymous namespace)::", "")[:n]


def reduce_session(events, want, window_s, steps):
    """One session's figures.  ``events``: the profiler's events; ``want``:
    ``{kernel key: launches counted}``; ``window_s``: the host's seconds
    from the session's start to the read that ended the segment."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in events:
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            dev.append((tr.start, tr.end, e.name))
        else:
            host.append((tr.start, tr.end, e.name))
    dev.sort()
    host.sort()
    seen = {k: 0 for k, _, _ in KERNELS}
    ktime = {k: 0.0 for k, _, _ in KERNELS}
    pats = [(k, re.compile(p)) for k, p, _ in KERNELS]
    by_name, busy, end, gaps = {}, 0.0, None, []
    for s, e, name in dev:
        for k, pat in pats:
            if pat.search(name):
                seen[k] += 1
                ktime[k] += (e - s) * 1e-6
                break
        short = _short(name)
        by_name[short] = by_name.get(short, 0.0) + (e - s) * 1e-6
        if end is not None and s > end:
            gaps.append((end, s))
        lo = s if end is None else max(s, end)
        busy += max(e - lo, 0.0)
        end = e if end is None else max(end, e)
    starts = [h[0] for h in host]
    idle = {}
    for a, b in gaps:
        mid = 0.5 * (a + b)
        label = "no host op"
        i = bisect.bisect_right(starts, mid) - 1
        # the innermost host op covering the gap: the latest one started
        for j in range(i, max(i - 400, -1), -1):
            if host[j][1] >= mid:
                label = _short(host[j][2], 80)
                break
        idle[label] = idle.get(label, 0.0) + (b - a) * 1e-6
    lost = {k: (seen[k], w) for k, w in want.items() if seen[k] < w}
    return {
        "steps": steps, "lost": lost, "window_s": window_s,
        "busy_s": busy * 1e-6, "device_ops": len(dev),
        "host_launches": sum(n.startswith(HOST_LAUNCHES) for _, _, n in host),
        "kernel_s": ktime, "kernel_launches": dict(want), "by_name": by_name,
        "idle": idle,
    }


class Tracer:
    """Traces ``segments`` consecutive segments of ``steps`` stored steps
    each, from the first hook call at or after ``start_after_s`` seconds
    into the window.  ``counters()`` gives ``{wrapper name: launches}``."""

    def __init__(self, segments, steps, start_after_s, counters):
        self.segments, self.steps = int(segments), int(steps)
        self.start_after_s = start_after_s
        self.counters = counters
        self.sessions = []  # reduced
        self._prof = None

    def _want(self, before, after):
        return {k: sum(after[w] - before[w] for w in wrappers)
                for k, _, wrappers in KERNELS}

    def on_hook(self, elapsed_s):
        """Call in each hook, after its read of the device."""
        from torch.profiler import ProfilerActivity, profile

        if self._prof is not None:
            window = time.perf_counter() - self._t0
            after = self.counters()
            self._prof.stop()
            self.sessions.append(reduce_session(
                self._prof.events(), self._want(self._before, after), window,
                self.steps))
            self._prof = None
        if (len(self.sessions) < self.segments
                and elapsed_s >= self.start_after_s):
            import torch

            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
            self._prof = profile(activities=acts)
            self._prof.start()
            self._before = self.counters()
            self._t0 = time.perf_counter()

    def close(self):
        """Stop a session the window's end left open (it is not kept)."""
        if self._prof is not None:
            self._prof.stop()
            self._prof = None

    def summary(self):
        """Sums over the segments whose traces hold every counted launch,
        or None when none does (or nothing was traced)."""
        kept = [s for s in self.sessions if not s["lost"] and s["device_ops"]]
        if not kept:
            return None
        out = {"segments": len(self.sessions), "kept": len(kept),
               "lost": [s["lost"] for s in self.sessions if s["lost"]]}
        for key in ("steps", "window_s", "busy_s", "device_ops",
                    "host_launches"):
            out[key] = sum(s[key] for s in kept)
        for key in ("kernel_s", "kernel_launches", "by_name", "idle"):
            acc = {}
            for s in kept:
                for k, v in s[key].items():
                    acc[k] = acc.get(k, 0) + v
            out[key] = acc
        return out
