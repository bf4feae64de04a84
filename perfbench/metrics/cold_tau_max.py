"""The largest integrated autocorrelation time of the cold chain's series
(the benchmark's frozen estimator, averaged over walkers), in stored
steps, from the traced run's stored chain."""

import math


def read(ctx):
    tau = ctx.tau_max
    return tau if tau is not None and math.isfinite(tau) else None
