"""The frozen autocorrelation time against chains of known tau."""

import math

import pytest
import torch

from perfbench import iact


def ar1(phi, nsteps, nwalkers, k, seed):
    g = torch.Generator().manual_seed(seed)
    e = torch.randn((nsteps, nwalkers, k), generator=g, dtype=torch.float64)
    x = torch.empty_like(e)
    x[0] = e[0] / math.sqrt(1 - phi**2)
    for t in range(1, nsteps):
        x[t] = phi * x[t - 1] + e[t]
    return x


@pytest.mark.parametrize("phi", [0.0, 0.5, 0.8])
def test_ar1_tau(phi):
    """An AR(1) chain has tau = (1 + phi) / (1 - phi); the window of 50
    lags cuts the sum at phi^50, nothing at these phi."""
    x = ar1(phi, 4000, 64, 2, seed=int(phi * 10))
    tau = iact.integrated_time(x)
    want = (1 + phi) / (1 - phi)
    assert tau.shape == (2,)
    assert torch.allclose(tau, torch.full_like(tau, want), rtol=0.08), (tau, want)


def test_constant_series_are_left_out():
    x = ar1(0.5, 2000, 16, 1, seed=3)
    series = {"moving": x, "fixed": torch.ones_like(x)}
    assert math.isnan(float(iact.integrated_time(series["fixed"])[0]))
    assert iact.tau_max(series) == pytest.approx(
        float(iact.integrated_time(x)[0]))
    assert math.isnan(iact.tau_max({"fixed": torch.ones(10, 3, 1)}))
