"""Device kernels, copies and memsets a stored step, from the traced
segments (a replayed graph's nodes are recorded one by one)."""


def read(ctx):
    t = ctx.trace
    return None if t is None else t["device_ops"] / t["steps"]
