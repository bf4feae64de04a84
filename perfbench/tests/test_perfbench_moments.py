"""The reference's moments of the targets, and the batch-means gap that
``moment_z`` reads, against sums and chains of known answers."""

import math

import pytest
import torch

from perfbench.reference import checks, gaussian, pulses


@pytest.mark.parametrize("sd", [0.3, 1.0, 2.5, 30.0])
def test_truncated_normal_var_against_a_sum(sd):
    x = torch.linspace(-5.0, 5.0, 400_001, dtype=torch.float64)
    dens = torch.exp(-0.5 * (x / sd) ** 2)
    dens[[0, -1]] *= 0.5  # the trapezoid rule
    want = float((x * x * dens).sum() / dens.sum())
    got = float(gaussian.truncated_normal_var(sd, 5.0))
    assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("shift", [0.0, 0.1])
def test_batch_z_reads_a_shift_and_only_a_shift(shift):
    g = torch.Generator().manual_seed(3)
    dev = torch.randn((20_000, 4), generator=g, dtype=torch.float64) + shift
    z = checks.batch_z(dev)
    assert (z > 8.0) if shift else (z < 4.5)


def test_batch_z_leaves_out_empty_steps_and_reads_a_frozen_chain_as_inf():
    dev = torch.zeros((400, 2), dtype=torch.float64)
    dev[::7] = math.nan
    assert checks.batch_z(dev + 1.0) == math.inf
    assert checks.batch_z(dev[:30]) == math.inf  # under two batches


def test_one_pulse_posterior_against_a_grid():
    """The importance-sampled moments against a sum over a grid of the same
    posterior, at a size where the grid is cheap."""
    g = torch.Generator().manual_seed(7)
    t = torch.linspace(0.0, 10.0, 96, dtype=torch.float64)
    truth = (3.0, 4.0, 0.6)
    clean = truth[0] * torch.exp(-((t - truth[1]) ** 2) / (2 * truth[2] ** 2))
    data = clean + 0.3 * torch.randn(96, generator=g, dtype=torch.float64)
    inputs = {"t": t, "data": data, "sigma": 0.3}
    bounds = torch.tensor([[0.5, 5.0], [0.0, 10.0], [0.1, 2.0]],
                          dtype=torch.float64)
    mean, var, mean_v, var_v = pulses.one_pulse_posterior(
        {"truth": [list(truth)]}, inputs, bounds, 11, "cpu")
    sd = var.sqrt()
    axes = [torch.linspace(float(m - 7 * s), float(m + 7 * s), 81,
                           dtype=torch.float64) for m, s in zip(mean, sd)]
    grid = torch.stack(torch.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    p, _ = pulses._pulse(grid, t)
    logw = -0.5 * (((p - data) / 0.3) ** 2).sum(-1)
    w = torch.softmax(logw, 0)[:, None]
    g_mean = (w * grid).sum(0)
    g_var = (w * (grid - g_mean) ** 2).sum(0)
    assert torch.all((mean - g_mean).abs() < 5 * mean_v.sqrt() + 1e-4 * sd)
    assert torch.all((var - g_var).abs() < 5 * var_v.sqrt() + 1e-3 * g_var)
