"""One whole-ensemble ``compute_log_like`` (the evaluator the step calls)
on the window's last state against its roofline: the least time of the
configuration's likelihood (its family's ``likelihood_cost``: ops and
bytes from the template's shapes) over the device time of one call,
timed with CUDA events over repeated calls, in percent."""

import torch

from perfbench import roofline

REPS = 20


def read(ctx):
    smp, state = ctx.sampler, ctx.state
    if smp.device.type != "cuda":
        return None
    cost = getattr(ctx.family, "likelihood_cost", None)
    if cost is None:
        return None
    branch = state.branches["model_0"]
    coords, inds = branch.coords, branch.inds
    logp = state.log_prior
    ops, nbytes = cost(ctx.cell.config, ctx.cell.traffic,
                       smp.ntemps * smp.nwalkers)
    smp.compute_log_like({"model_0": coords}, {"model_0": inds}, logp=logp)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        smp.compute_log_like({"model_0": coords}, {"model_0": inds}, logp=logp)
    stop.record()
    stop.synchronize()
    per_call_s = start.elapsed_time(stop) * 1e-3 / REPS
    return 100.0 * roofline.least_s(ops, nbytes) / per_call_s
