"""The port's hand-written kernels against their roofline: the sum over the
traced segments of each kernel's least time (its launches there times the
least time of one launch at the cell's shapes, ``perfbench/roofline.py``)
over the sum of their device times by name in the trace, in percent.  The
card's power limit is printed beside it."""

import subprocess

from perfbench import roofline


def _least_per_launch(ctx):
    smp = ctx.sampler
    nt, nw = smp.ntemps, smp.nwalkers
    nl, nd = smp.nleaves_max["model_0"], smp.ndims["model_0"]
    out = {}
    for key, (ops, nbytes) in roofline.stretch(nt, nw, nd).items():
        out[key] = roofline.least_s(ops, nbytes)
    rj = nl > 1
    leaf = nl * nd * 4 + 4 + (nl if rj else 0)
    out["pt_swap_cascade"] = roofline.least_s(*roofline.cascade(nt, nw, leaf))
    if rj:
        inds = ctx.state.branches["model_0"].inds
        share = float(inds.float().mean())
        out["group_stretch_propose"] = roofline.least_s(
            *roofline.group_stretch(nt, nw, nl, nd, share))
    return out


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    least = _least_per_launch(ctx)
    bound = spent = 0.0
    for key, n in t["kernel_launches"].items():
        if n and key in least and t["kernel_s"].get(key, 0.0) > 0:
            bound += n * least[key]
            spent += t["kernel_s"][key]
    if spent <= 0:
        return None
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as err:
        limit = f"not read ({err})"
    print(f"kernels_roofline: {100 * bound / spent:.6f} % "
          f"({bound:.9f} s least of {spent:.9f} s on the device; card "
          f"{limit})", file=ctx.log)
    return 100.0 * bound / spent
