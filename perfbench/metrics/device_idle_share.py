"""The share of the untraced window in which the device is idle, in
percent: one less the device's busy time a stored step in the trace (the
union of its kernels, copies and memsets) over the wall time a stored step
of the same run's untraced segments before the trace.  The profiler slows
the launches of captured graphs by the nodes it records, so the traced
segments' own idle share (``device.busy_s`` against ``device.window_s``)
reads the instrument's cost; this one does not.  Where the card is busy
throughout, the two readings' noise can take it a little below 0."""

import math


def read(ctx):
    t, wall = ctx.trace, ctx.untraced_s_per_step
    if t is None or not t["steps"] or not math.isfinite(wall) or wall <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["steps"] / wall)
