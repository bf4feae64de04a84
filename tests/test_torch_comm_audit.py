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

The rest of the move zoo is audited on the default ``(2, 4)`` mesh under
DEO, whose swap phase moves the same bytes whatever the state (the edge
rungs and one all-reduce of the swap counts): a step of a move that
proposes nothing is the swap phase alone, and a step of a per-walker move
(MH, Gaussian, distribution-draw, multiple-try, delayed rejection, HMC with
a given step size and no tuning) receives exactly its bytes.  A move that
reads an ensemble statistic receives at most the rows it reads more: AIMH
and the slice move the walkers of the rank's temperatures (and slice its
loops' one all-reduce a block), MALA's dual averaging the cold rung's
acceptance, ChEES the cold rung's rows of its criterion.  Past their
tuning AIMH, MALA and ChEES read no statistic: a step of each receives
exactly the swap phase's bytes.
"""

import numpy as np
import pytest
import torch

import eryn_tpu_torch as et
from eryn_tpu_torch import moves as tm
from eryn_tpu_torch.parallel import audit_sampler_comm, make_mesh, shard_state
from eryn_tpu_torch.parallel._spawn import launch

NDIM = 8
NWALKERS = 64
CASES = {"cascade_8x1": (8, 8, {}), "deo_8x1": (8, 8, {"swap_scheme": "deo"}),
         "standard_2x4": (4, 2, {}),
         "general_cascade_8x1": (8, 8, {"permute": False})}


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


class Stay(tm.Move):
    """A move that proposes nothing: its step is the swap phase alone."""

    _mesh_sharded = True

    def _propose_impl(self, generator, state, ctx, kernel_state=()):
        return (state, torch.zeros(state.log_like.shape, dtype=torch.bool),
                kernel_state)


class WalkMH(tm.MHMove):
    """A user's per-walker MH move, sharded by its own declaration."""

    _mesh_sharded = True

    def get_proposal_kernel(self, generator, branch_coords, branch_inds,
                            kernel_state, param_masks=None):
        q = {n: c + 0.2 * self.rank_draw(
                lambda sh, c=c: torch.randn(sh, generator=generator,
                                            dtype=c.dtype),
                c.shape, per_walker=True)
             for n, c in branch_coords.items()}
        c = next(iter(q.values()))
        return q, c.new_zeros(c.shape[:2]), kernel_state


def _zoo_moves():
    """The audited moves of the zoo: the per-walker ones, then the ones
    that read an ensemble statistic."""
    pr = et.ProbDistContainer({i: et.uniform_dist(-5, 5)
                               for i in range(NDIM)})
    return {
        "stay": Stay(),
        "mh": WalkMH(),
        "gaussian": tm.GaussianMove({"model_0": 0.3}),
        "distgen": tm.DistributionGenerate({"model_0": pr}),
        "multipletry": tm.MTDistGenMove({"model_0": pr}, num_try=3),
        "delayedrejection": tm.DelayedRejection(
            tm.GaussianMove({"model_0": 0.3}), max_iter=2),
        "hmc": tm.HMCMove(eps=0.3, tune_steps=0),
        "aimh": tm.AIMHMove(),
        "slice": tm.SliceMove(),
        "mala": tm.MALAMove(),
        "chees": tm.ChEESHMCMove(max_leapfrog=8),
        # their kernel states set past the tuning before the step
        "aimh[tuned]": tm.AIMHMove(tune_steps=5),
        "mala[tuned]": tm.MALAMove(tune_steps=5),
        "chees[tuned]": tm.ChEESHMCMove(max_leapfrog=8, tune_steps=5),
    }


PER_WALKER = ("mh", "gaussian", "distgen", "multipletry", "delayedrejection",
              "hmc")
TUNED = ("aimh[tuned]", "mala[tuned]", "chees[tuned]")
ZOO_TEMPS = 4


def _zoo_audits(world):
    """One audited step of each zoo move on the default ``(2, 4)`` mesh
    under DEO (4 temperatures, 64 walkers, 8-D), its kernel state made
    before the step."""
    out = {}
    for name, move in _zoo_moves().items():
        s = et.EnsembleSampler(
            NWALKERS, NDIM, lambda x: -0.5 * torch.sum(x ** 2),
            et.ProbDistContainer({i: et.uniform_dist(-5, 5)
                                  for i in range(NDIM)}),
            moves=move, tempering_kwargs=dict(ntemps=ZOO_TEMPS,
                                              swap_scheme="deo"),
            seed=7, device="cpu")
        coords = np.random.default_rng(3).uniform(
            -5, 5, (ZOO_TEMPS, NWALKERS, 1, NDIM)).astype(np.float32)
        state = shard_state(et.State({"model_0": torch.from_numpy(coords)}),
                            make_mesh(world))
        s._ensure_kernel_states(s._setup_state(state))
        if name in TUNED:
            ks = s._kernel_states[0]
            s._kernel_states[0] = {
                **ks, "t": torch.full_like(ks["t"], move.tune_steps)}
        out[name] = audit_sampler_comm(s, state)
    return out


class HostWalk(tm.MHMove):
    """A legacy host move: Eryn's NumPy ``get_proposal``."""

    def get_proposal(self, branches_coords, random, branches_inds=None,
                     **kwargs):
        q = {n: np.asarray(c) + 0.2 * random.randn(*np.shape(c))
             for n, c in branches_coords.items()}
        return q, np.zeros(next(iter(q.values())).shape[:2])


def _host_move_audit(world):
    """One audited step of a legacy host move on the default ``(2, 4)``
    mesh (4 temperatures, 64 walkers, 8-D), its swap phase the kernel
    cascade's."""
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the host move's warning
        s = et.EnsembleSampler(
            NWALKERS, NDIM, lambda x: -0.5 * torch.sum(x ** 2),
            et.ProbDistContainer({i: et.uniform_dist(-5, 5)
                                  for i in range(NDIM)}),
            moves=HostWalk(), tempering_kwargs=dict(ntemps=ZOO_TEMPS,
                                                    use_kernels=True),
            seed=7, device="cpu")
    coords = np.random.default_rng(3).uniform(
        -5, 5, (ZOO_TEMPS, NWALKERS, 1, NDIM)).astype(np.float32)
    state = shard_state(et.State({"model_0": torch.from_numpy(coords)}),
                        make_mesh(world))
    before = s._np_random.get_state()[1].copy()
    audit = audit_sampler_comm(s, state)
    audit["numpy_restored"] = bool(np.array_equal(
        before, s._np_random.get_state()[1]))
    return audit


def _rank_main(rank, world):
    out = {"rj_deo_8x1": _rj_deo_audit(world), "zoo": _zoo_audits(world),
           "host_move_2x4": _host_move_audit(world)}
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
            for name in list(CASES) + ["rj_deo_8x1", "zoo", "host_move_2x4"]}


def test_cascade_swap_traffic_is_boundary_local(audits):
    """Fully temperature-sharded mesh: the stretch moves never leave a rank,
    so the step's traffic is the cascade's: the gathered log-likelihood
    (an all-gather of ``(8, 64)``) and the rows whose origin lies on
    another rank (one all-to-all), within 2.5 payloads."""
    for audit in audits["cascade_8x1"]:
        assert audit["big_gathers"] == [], audit
        assert set(audit["per_op"]) == {"all-gather", "all-to-all"}, audit
        assert audit["total_bytes"] <= 2.5 * audit["payload_bytes"], audit


def test_general_cascade_traffic_is_boundary_local(audits):
    """The general cascade (``permute=False``) on the same mesh, sharded as
    the kernel cascade is: the gathered log-likelihood, the decisions made
    alike on every rank, and the rows whose origin lies on another rank in
    one all-to-all, within 2.5 payloads."""
    for audit in audits["general_cascade_8x1"]:
        assert audit["big_gathers"] == [], audit
        assert set(audit["per_op"]) == {"all-gather", "all-to-all"}, audit
        assert audit["per_op"]["all-gather"]["bytes"] == 8 * NWALKERS * 4
        assert audit["total_bytes"] <= 2.5 * audit["payload_bytes"], audit


def test_host_move_step_gathers_the_state_once(audits):
    """A legacy host move runs on the whole ensemble in every rank: its
    step receives each per-walker leaf once (coordinates, leaf masks,
    log-likelihood, log-prior: four all-gathers, one payload and the masks'
    bytes) and nothing more (its swap phase runs on the gathered state),
    and the audit restores the NumPy generator the move drew from."""
    for audit in audits["host_move_2x4"]:
        masks = ZOO_TEMPS * NWALKERS
        assert audit["per_op"] == {"all-gather": {
            "count": 4, "bytes": audit["payload_bytes"] + masks}}, audit
        assert audit["numpy_restored"]


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


@pytest.mark.parametrize("move", PER_WALKER + TUNED)
def test_per_walker_moves_add_no_collective(audits, move):
    """A step of a per-walker move (every draw at its global shape, the
    rank's rows kept), or of AIMH, MALA and ChEES past their tuning,
    receives exactly the bytes of the swap phase alone (a step of a move
    that proposes nothing), in the same calls: the move exchanges
    nothing."""
    for zoo in audits["zoo"]:
        stay, got = zoo["stay"], zoo[move]
        assert stay["per_op"] == got["per_op"], (move, got, stay)
        assert got["total_bytes"] == stay["total_bytes"], (move, got, stay)
        assert set(stay["per_op"]) == {"collective-permute",
                                       "all-reduce"}, stay


def _statistic_bound(move):
    """The bytes a step of ``move`` may receive beyond the swap phase's on a
    rank of the ``(2, 4)`` mesh: the rows its statistics read."""
    f4 = 4
    nt = ZOO_TEMPS // 2
    rows = nt * NWALKERS * NDIM * f4  # the rank's temperatures' walkers
    cold = NWALKERS  # the cold rung's walkers
    return {
        "aimh": rows,
        # the blocks' complement fill (coordinates and the leaf mask byte)
        # and one all-reduce a block of the loops' flags and counts
        "slice": nt * NWALKERS * (NDIM * f4 + 1) + 2 * (5 + 16 + 2) * f4,
        "mala": cold * f4,
        # the criterion's alpha, masks, start, end point and momenta, and
        # the dual averaging's acceptance
        "chees": cold * (2 * f4 + NDIM * (1 + 3 * f4)),
    }[move]


@pytest.mark.parametrize("move", ["aimh", "slice", "mala", "chees"])
def test_statistic_moves_receive_only_the_rows_they_read(audits, move):
    """AIMH (its moments over the walkers of the rank's temperatures), the
    slice move (each block's complement within the temperature shard, its
    loops' counts), MALA with tuning (the cold rung's acceptance) and ChEES
    (the cold rung's rows of its criterion) receive at most those rows
    beyond the swap phase's bytes, and none of them gathers a whole
    ensemble's coordinates."""
    for zoo in audits["zoo"]:
        got, stay = zoo[move], zoo["stay"]
        extra = got["total_bytes"] - stay["total_bytes"]
        assert got["big_gathers"] == [], got
        assert 0 < extra <= _statistic_bound(move), (move, extra, got)
        assert extra < got["full_coords_bytes"], (move, extra)


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
