"""The port's communication-pattern audit
(``eryn_tpu_torch.parallel.comm_audit``) held to ``eryn_tpu``'s own bounds
(``tests/test_comm_pattern.py``), at its sizes (8-D, 64 walkers).

One spawn of 8 ranks on the CPU (gloo) audits one sharded step of each
configuration; every rank's audit must meet the bound (the ranks at the
ends of the ladder receive less).  The bounds are ``eryn_tpu``'s: on the
fully temperature-sharded ``(8, 1)`` mesh the cascade moves at most 2.5
times one swap phase's payload and DEO at most 1.0 times (its all-reduce at
most 0.05 times); on the default ``(2, 4)`` mesh with 4 temperatures the
step moves at most 4.0 times; reversible jump under DEO (two proposal
phases, the leaf masks in the swap payload; 3-D leaves, at most 2 a walker)
moves at most 3.0 times; no all-gather or all-reduce carries the whole
coordinates tensor anywhere.  The ranks import this module, so it imports
``jax`` only inside the tests.
"""

import numpy as np
import pytest
import torch

import eryn_tpu_torch as et
from eryn_tpu_torch.parallel import audit_sampler_comm, make_mesh, shard_state
from eryn_tpu_torch.parallel._spawn import launch

NDIM = 8
NWALKERS = 64
CASES = {"cascade_8x1": (8, 8, {}), "deo_8x1": (8, 8, {"swap_scheme": "deo"}),
         "standard_2x4": (4, 2, {})}


def _sampler(ntemps, **tk_extra):
    priors = et.ProbDistContainer({i: et.uniform_dist(-5, 5)
                                   for i in range(NDIM)})
    # the kernels' forms (their plain versions here): the sharded step's
    # draws, so that a one-process run is the comparison
    return et.EnsembleSampler(
        NWALKERS, NDIM, lambda x: -0.5 * torch.sum(x ** 2), priors,
        moves=et.StretchMove(use_kernels=True),
        tempering_kwargs=dict(ntemps=ntemps, use_kernels=True, **tk_extra),
        seed=7, device="cpu")


def _rj_deo_audit(world):
    """``tests/test_comm_pattern.py::test_rj_deo_mesh_traffic_bounded``'s
    configuration (8 temperatures, 64 walkers, 3-D leaves, at most 2 a
    walker, birth and death, DEO) on the ``(8, 1)`` mesh: one audited
    step."""
    ndim, nlmax, ntemps = 3, 2, 8
    pr = et.ProbDistContainer({i: et.uniform_dist(-5, 5)
                               for i in range(ndim)})

    def ll(coords, inds):
        contrib = -0.5 * torch.sum(coords ** 2, dim=-1)
        return torch.sum(torch.where(inds, contrib, 0.0))

    s = et.EnsembleSampler(
        NWALKERS, ndim, ll, pr, nleaves_max=nlmax, nleaves_min=0,
        moves=et.StretchMove(use_kernels=True), rj_moves=True,
        tempering_kwargs=dict(ntemps=ntemps, swap_scheme="deo",
                              use_kernels=True),
        fill_zero_leaves_val=-1e4, seed=9, device="cpu")
    rng = np.random.default_rng(2)
    coords = rng.uniform(-5, 5, (ntemps, NWALKERS, nlmax, ndim)).astype(
        np.float32)
    inds = rng.random((ntemps, NWALKERS, nlmax)) < 0.5
    state = shard_state(et.State({"model_0": torch.from_numpy(coords)},
                                 inds={"model_0": torch.from_numpy(inds)}),
                        make_mesh(world, temp_parallel=8))
    return audit_sampler_comm(s, state)


def _rank_main(rank, world):
    out = {"rj_deo_8x1": _rj_deo_audit(world)}
    for name, (ntemps, temp_parallel, extra) in CASES.items():
        mesh = make_mesh(world, temp_parallel=temp_parallel)
        s = _sampler(ntemps, **extra)
        coords = np.random.default_rng(3).uniform(
            -5, 5, (ntemps, NWALKERS, 1, NDIM)).astype(np.float32)
        state = shard_state(et.State({"model_0": torch.from_numpy(coords)}),
                            mesh)
        audit = audit_sampler_comm(s, state)
        # the audit leaves the chain as it was: the run continues alike
        s.run_mcmc(state, 2)
        audit["after"] = s.get_log_like()
        out[name] = audit
    return out


@pytest.fixture(scope="module")
def audits():
    ranks = launch(_rank_main, 8, timeout=240)
    return {name: [r[name] for r in ranks]
            for name in list(CASES) + ["rj_deo_8x1"]}


def test_cascade_swap_traffic_is_boundary_local(audits):
    """Fully temperature-sharded mesh: the stretch moves never leave a rank,
    so the step's traffic is the cascade's: the gathered log-likelihood
    (an all-gather of ``(8, 64)``) and the rows whose origin lies on
    another rank (one all-to-all), within 2.5 payloads."""
    for audit in audits["cascade_8x1"]:
        assert audit["big_gathers"] == [], audit
        assert set(audit["per_op"]) == {"all-gather", "all-to-all"}, audit
        assert audit["total_bytes"] <= 2.5 * audit["payload_bytes"], audit


def test_deo_swap_traffic_is_one_parity_phase(audits):
    """DEO on the same mesh: the neighbouring shards' edge rungs ride
    point-to-point exchanges, and the swap counts one small all-reduce:
    within one payload, the all-reduce within 0.05 of one."""
    for audit in audits["deo_8x1"]:
        assert audit["big_gathers"] == [], audit
        assert "collective-permute" in audit["per_op"], audit
        assert audit["total_bytes"] <= 1.0 * audit["payload_bytes"], audit
        ar = audit["per_op"].get("all-reduce", {"bytes": 0})
        assert ar["bytes"] <= 0.05 * audit["payload_bytes"], audit


def test_standard_mesh_never_allgathers_full_ensemble(audits):
    """The default (2, 4) mesh: each half's complement crosses the walker
    shards (all-to-alls within the temperature shard), the cascade adds its
    gather and its rows; within 4 payloads, and no single gather of the
    whole coordinates."""
    for audit in audits["standard_2x4"]:
        assert audit["big_gathers"] == [], audit
        assert audit["per_op"]["all-to-all"]["count"] == 3, audit
        assert audit["total_bytes"] <= 4.0 * audit["payload_bytes"], audit


def test_rj_deo_mesh_traffic_bounded(audits):
    """Reversible jump under DEO on the ``(8, 1)`` mesh, as ``eryn_tpu``'s
    test of that name: the step has two proposal phases (the stretch and
    the birth/death move, neither of which leaves a rank on this mesh),
    each with a DEO phase whose edge rungs carry the leaf masks beside the
    coordinates (point-to-point exchanges with each neighbouring shard)
    and one small all-reduce of the swap counts: within 3.0 payloads, and
    no big gather."""
    for audit in audits["rj_deo_8x1"]:
        assert audit["big_gathers"] == [], audit
        assert set(audit["per_op"]) == {"collective-permute",
                                        "all-reduce"}, audit
        assert audit["per_op"]["all-reduce"]["count"] == 2, audit
        assert audit["total_bytes"] <= 3.0 * audit["payload_bytes"], audit


@pytest.mark.parametrize("name", sorted(CASES))
def test_audit_sizes_and_restores_the_chain(audits, name):
    """``full_coords_bytes`` and ``payload_bytes`` are ``eryn_tpu``'s (the
    whole ensemble's), every rank reports them alike, and the audited step
    left the chain untouched: the run after it is the same on every rank
    as a run of a fresh sampler."""
    ntemps = CASES[name][0]
    full = ntemps * NWALKERS * NDIM * 4
    for audit in audits[name]:
        assert audit["full_coords_bytes"] == full
        assert audit["payload_bytes"] == full + 2 * ntemps * NWALKERS * 4
        np.testing.assert_array_equal(audit["after"],
                                      audits[name][0]["after"])
    s = _sampler(ntemps, **CASES[name][2])
    s.run_mcmc(et.State({"model_0": torch.from_numpy(
        np.random.default_rng(3).uniform(-5, 5, (ntemps, NWALKERS, 1, NDIM))
        .astype(np.float32))}), 2)
    np.testing.assert_array_equal(audits[name][0]["after"], s.get_log_like())


def test_collective_stats_names_each_call():
    """``collective_stats`` turns recorded calls into ``(op, dtype, shape,
    bytes)`` in ``eryn_tpu``'s op names, with the received tensors' sizes;
    a lone send receives nothing."""
    from eryn_tpu_torch.parallel.comm_audit import (
        COLLECTIVE_OPS,
        collective_stats,
    )

    import eryn_tpu.parallel.comm_audit as jaudit

    assert COLLECTIVE_OPS == jaudit.COLLECTIVE_OPS
    calls = [("all-gather", [torch.zeros(8, 64)]),
             ("collective-permute", []),
             ("all-to-all", [torch.zeros(5, 3, dtype=torch.uint8)])]
    assert collective_stats(calls) == [
        ("all-gather", "f32", (8, 64), 2048),
        ("collective-permute", None, (), 0),
        ("all-to-all", "u8", (5, 3), 15)]
