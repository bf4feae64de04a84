"""Host-side runtime calls a stored step: graph launches, kernel launches,
copies and memsets the host made, from the traced segments."""


def read(ctx):
    t = ctx.trace
    return None if t is None else t["host_launches"] / t["steps"]
