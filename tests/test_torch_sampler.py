"""The port's sampler on the CPU against eryn_tpu's, statistically; and its
segments and the graph path's buffers against one eager run, digit for digit.

Both samplers start from the same numpy ensemble and ladder (carried through
:mod:`eryn_tpu_torch.interop`) on a 3-D unit Gaussian with 4 temperatures,
and run 2000 stored steps after 200 of burn-in.  torch's generator cannot
replay JAX's keys, so the chains differ draw by draw and are compared by
their statistics.  Tolerances, each several standard errors of the
difference at this chain length (about 2000 x 32 cold samples with an IACT
near 2.5):

* cold-chain mean within 0.06 of eryn_tpu's and of 0, variance within 0.1;
* cold-rung acceptance fraction within 0.02;
* per-rung swap acceptance within 0.03;
* adapted betas within 3 % (relative);
* integrated autocorrelation times within 25 % (relative).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import eryn_tpu
import eryn_tpu_torch
from eryn_tpu_torch.interop import (
    state_from_numpy,
    state_to_numpy,
    tempering_from_numpy,
    tempering_to_numpy,
)

torch.set_num_threads(1)

NT, NDIM, NSTEPS, BURN = 4, 3, 2000, 200


def _summary(sampler):
    cold = np.asarray(sampler.get_chain(temp_index=0)["model_0"]).reshape(-1, NDIM)
    return dict(
        mean=cold.mean(axis=0),
        var=cold.var(axis=0),
        acc=float(np.mean(sampler.acceptance_fraction[0])),
        swaps=np.asarray(sampler.swap_acceptance_fraction),
        betas=np.asarray(sampler.get_betas()[-1]),
        tau=np.asarray(sampler.get_autocorr_time()["model_0"]).ravel(),
    )


@pytest.fixture(scope="module")
def reference():
    """eryn_tpu's run per walker count, with the numpy ensemble and ladder
    it started from."""
    cache = {}

    def run(nw):
        if nw not in cache:
            priors = eryn_tpu.ProbDistContainer(
                {i: eryn_tpu.uniform_dist(-5.0, 5.0) for i in range(NDIM)}
            )
            sampler = eryn_tpu.EnsembleSampler(
                nw, NDIM, lambda x: -0.5 * jnp.sum(x * x), priors,
                tempering_kwargs=dict(ntemps=NT), seed=11,
            )
            rng = np.random.default_rng(nw)
            start = eryn_tpu.State(
                {"model_0": rng.uniform(-3, 3, (NT, nw, 1, NDIM)).astype(np.float32)}
            )
            start_np = state_to_numpy(start)
            ladder_np = tempering_to_numpy(sampler.temperature_control)
            sampler.run_mcmc(start, NSTEPS, burn=BURN)
            cache[nw] = (_summary(sampler), start_np, ladder_np)
        return cache[nw]

    return run


@pytest.mark.parametrize(
    "nw,backend,use_kernels",
    [
        (32, "Backend", None),        # the CPU default: general paths
        (33, "DeviceBackend", None),  # odd halves, chain kept as tensors
        (32, "Backend", True),        # the kernel path's plain versions
        (33, "DeviceBackend", True),
    ],
)
def test_port_sampler_matches_eryn_tpu(reference, nw, backend, use_kernels):
    ref, start_np, ladder_np = reference(nw)
    priors = eryn_tpu_torch.ProbDistContainer(
        {i: eryn_tpu_torch.uniform_dist(-5.0, 5.0) for i in range(NDIM)}
    )
    sampler = eryn_tpu_torch.EnsembleSampler(
        nw, NDIM, lambda x: -0.5 * torch.sum(x * x), priors,
        tempering_kwargs=dict(ntemps=NT, use_kernels=use_kernels),
        moves=[eryn_tpu_torch.StretchMove(use_kernels=use_kernels)],
        backend=getattr(eryn_tpu_torch, backend)(), seed=5, device="cpu",
    )
    tempering_from_numpy(sampler.temperature_control, ladder_np)
    sampler.run_mcmc(state_from_numpy(start_np, device="cpu"), NSTEPS,
                     burn=BURN)
    out = _summary(sampler)

    assert np.all(np.abs(out["mean"]) < 0.06), out["mean"]
    np.testing.assert_allclose(out["mean"], ref["mean"], atol=0.06)
    np.testing.assert_allclose(out["var"], ref["var"], atol=0.1)
    assert abs(out["acc"] - ref["acc"]) < 0.02, (out["acc"], ref["acc"])
    np.testing.assert_allclose(out["swaps"], ref["swaps"], atol=0.03)
    np.testing.assert_allclose(out["betas"], ref["betas"], rtol=0.03)
    assert not np.allclose(out["betas"], ladder_np["betas"])  # it adapted
    assert np.all(np.isfinite(out["tau"]))
    np.testing.assert_allclose(out["tau"], ref["tau"], rtol=0.25)


# ----------------------------------------------------------------------
# segments and the graph path, digit for digit
# ----------------------------------------------------------------------
def _small_sampler(kind, moves=None, **kw):
    """A 4 x 32 x 3 tempered Gaussian, or a small RJ configuration (3 x 16
    walkers, up to 3 leaves of 2 parameters, group stretch and
    birth/death), and its start."""
    g = torch.Generator().manual_seed(1)
    if kind == "gaussian":
        priors = eryn_tpu_torch.ProbDistContainer(
            {i: eryn_tpu_torch.uniform_dist(-5.0, 5.0) for i in range(NDIM)})
        sampler = eryn_tpu_torch.EnsembleSampler(
            32, NDIM, lambda x: -0.5 * torch.sum(x * x), priors,
            tempering_kwargs=dict(ntemps=NT), moves=moves, seed=7,
            device="cpu", **kw)
        return sampler, priors.rvs(size=(NT, 32), generator=g)
    priors = eryn_tpu_torch.ProbDistContainer(
        {i: eryn_tpu_torch.uniform_dist(-1.0, 1.0) for i in range(2)})
    sampler = eryn_tpu_torch.EnsembleSampler(
        16, 2,
        lambda c, i: -0.5 * torch.sum(torch.where(i[:, None], c, 0.0) ** 2),
        priors, nleaves_max=3, rj_moves=True,
        moves=moves or eryn_tpu_torch.moves.RedBlueGroupStretchMove(
            live_dangerously=True),
        tempering_kwargs=dict(ntemps=3), fill_zero_leaves_val=0.0, seed=7,
        device="cpu", **kw)
    coords = priors.rvs(size=(3, 16, 3), generator=g)
    inds = torch.rand((3, 16, 3), generator=g) < 0.5
    return sampler, eryn_tpu_torch.State(coords, inds=inds)


def _record(sampler):
    """Everything a run leaves: the stored chain and its counters, the
    ladder, the clock, the last state and the move counters."""
    b = sampler.backend
    last = sampler._previous_state
    out = dict(
        chain=sampler.get_chain()["model_0"], inds=sampler.get_inds()["model_0"],
        log_like=sampler.get_log_like(), log_prior=sampler.get_log_prior(),
        betas=sampler.get_betas(), accepted=b.accepted,
        swaps=b.swaps_accepted,
        time=np.asarray(int(sampler.temperature_control.time)),
        last=last.branches["model_0"].coords.numpy(),
        last_ll=last.log_like.numpy(),
        m_acc=np.stack([m.accepted for m in sampler._all_move_list]),
    )
    if sampler.has_reversible_jump:
        out["rj_accepted"] = b.rj_accepted
    return out


def _assert_same_run(a, b):
    assert a.keys() == b.keys()
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


@pytest.mark.parametrize("kind", ["gaussian", "rj"])
def test_segments_leave_the_chain_unchanged(kind):
    """One ``run_mcmc`` of 64 stored steps against eight of 8: the state,
    the clock and the ladder cross each segment boundary unchanged."""
    one, start = _small_sampler(kind)
    one.run_mcmc(start, 64)
    eight, start = _small_sampler(kind)
    eight.run_mcmc(start, 8)
    for _ in range(7):
        eight.run_mcmc(None, 8)
    a, b = _record(one), _record(eight)
    assert int(a["time"]) == 64
    _assert_same_run(a, b)


class _EagerReplay:
    """Stands in for a captured graph on the CPU: a replay runs the body."""

    def __init__(self, graphs, key, ctx):
        self.replay = lambda: graphs._body(key, ctx)


@pytest.mark.parametrize("kind", ["gaussian", "rj"])
def test_graph_path_buffers_match_the_eager_loop(kind, monkeypatch):
    """The graph path's static buffers, copies and accept accumulation with
    each replay run as the captured body would run: the same run as the
    eager loop, across segments, ``thin_by``, burn-in, two weighted moves
    and two in-model repeats (graphs for a move's first and later entries
    in a step)."""
    from eryn_tpu_torch.ensemble import EnsembleSampler
    from eryn_tpu_torch.graphs import StepGraphs

    def moves():
        if kind == "gaussian":
            return [(eryn_tpu_torch.StretchMove(), 0.5),
                    (eryn_tpu_torch.StretchMove(a=1.7), 0.5)]
        return [(eryn_tpu_torch.moves.RedBlueGroupStretchMove(
            live_dangerously=True), 0.5), (eryn_tpu_torch.moves.
            RedBlueGroupStretchMove(a=1.5, live_dangerously=True), 0.5)]

    def run(graphed):
        sampler, start = _small_sampler(kind, moves=moves(),
                                        num_repeats_in_model=2)
        if graphed:
            monkeypatch.setattr(EnsembleSampler, "_graphed", True)
            monkeypatch.setattr(
                StepGraphs, "_capture",
                lambda self, key, ctx: (_EagerReplay(self, key, ctx), ()))
        sampler.run_mcmc(start, 12, burn=5)
        sampler.run_mcmc(None, 6, thin_by=2)
        monkeypatch.undo()
        return sampler

    eager, graphed = run(False), run(True)
    _assert_same_run(_record(eager), _record(graphed))
    entries = (2 + (kind == "rj")) * (5 + 12 + 12)
    keys = graphed._graphs.warm
    assert len(keys) == 4 + (kind == "rj")  # the RJ move is one entry a step
    assert graphed.graph_replays == entries - len(keys)
    assert eager.graph_replays == 0 and eager._graphs is None
