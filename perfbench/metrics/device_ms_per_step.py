"""Device busy time a stored step (the union of the device's kernels,
copies and memsets over the traced segments), in milliseconds."""


def read(ctx):
    t = ctx.trace
    return None if t is None else 1e3 * t["busy_s"] / t["steps"]
