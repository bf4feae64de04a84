"""The sharded step planned on the device (``eryn_tpu_torch.parallel.mesh``):
what a CUDA graph needs of it, checked on the CPU.

Under a mesh whose process group is NCCL the sampler captures each move's
sharded step in a CUDA graph, collectives included, when the move declares
it planned on the device (``Move.mesh_device_planned``): every native move
(a host move never) and users' subclasses on the gathered routes, each with
its swap phase (the kernel cascade, the general cascade or DEO).  A graph
holds no host read and no exchange whose sizes the data decides.  A move
whose sharded step has a host phase (``Move.mesh_clocks``: the tuning
moves, tuning or tuned; ``GroupMove``, a refresh due or not) gets a graph
per phase from a host shadow of its clock.  Here each world size (2, 4 and
8 ranks) is spawned once (gloo, the CPU) and, on the meshes (1, 2), (2, 1),
(2, 2) and (2, 4):

* one step of each declared move (and of each member of a composite) runs
  with ``Tensor.cpu``, ``.item``, ``.tolist``, ``.numpy``, ``__bool__``,
  ``__int__`` and ``__float__`` patched to raise (the comm layer stages
  nothing on CPU tensors), in each of its phases;
* the north-star (stretch and the kernel cascade), DEO, the general
  cascade, a LISA-style reversible-jump configuration (the red/blue group
  stretch, births and deaths, kernel 3 in both phases), the tuning moves
  (slice, MALA plain and preconditioned, HMC, ChEES-HMC and AIMH, their
  chains past ``tune_steps``), the general-path moves (the periodic stretch
  in four splits, the Gibbs stretch, DE, DE-snooker, walk, KDE, the MH
  family, multiple-try, the group stretch past refreshes, a bare stretch
  subclass and an ``MHMove`` subclass on the two gathered routes, delayed
  rejection around each), multiple-try reversible jump and the model swap
  equal the one-rank chain digit for digit through every getter.

On (1, 2) the graph path's static buffers run with each replay emulated by
the captured body (``tests/test_torch_sampler.py``'s stand-in), host reads
refused in every replayed body: the chain equals the eager mesh chain, and
each phase key is the device clock's.  On one rank (gloo, world size 1) the
sharded route of a one-rank mesh, which ``chip_smoke.py`` captures over
NCCL on one card, equals the one-rank chain too.  The ranks import this
module; it imports no ``jax``.

Run: ``JAX_PLATFORMS=cpu python -m pytest tests/test_torch_mesh_graph.py
-q`` (about 60-90 s: 1, 2, 4 and 8 ranks in turn).
"""

import contextlib

import numpy as np
import pytest
import torch

import eryn_tpu_torch as et
from eryn_tpu_torch.graphs import fixed_phases
from eryn_tpu_torch.moves import (
    AIMHMove,
    BasicSymmetricModelSwapRJMove,
    ChEESHMCMove,
    CombineMove,
    DelayedRejection,
    DEMove,
    DESnookerMove,
    DistributionGenerate,
    GaussianMove,
    GroupStretchMove,
    HMCMove,
    KDEMove,
    MALAMove,
    MHMove,
    ModelSwapRJMove,
    Move,
    MTDistGenMove,
    MTDistGenMoveRJ,
    RedBlueGroupStretchMove,
    SliceMove,
    WalkMove,
)
from eryn_tpu_torch.parallel import make_mesh, shard_state
from eryn_tpu_torch.parallel._spawn import launch

NT, NW, NDIM, NLMAX = 4, 16, 2, 3
STEPS, BURN = 8, 2
MESHES = {2: [(1, 2), (2, 1)], 4: [(2, 2)], 8: [(2, 4)]}
CONFIGS = ("north-star", "deo", "general-cascade", "lisa-rj", "tuning",
           "general-zoo", "mt-rj", "model-swap")
HOST_READS = ("cpu", "item", "tolist", "numpy", "__bool__", "__int__",
              "__float__")
# the tuning moves' tune_steps and the group stretch's refresh period: a
# chain of STEPS + BURN steps passes both
TUNE, REFRESH = 3, 3
PERIOD = 2 * np.pi
# each configuration's declared moves, composites' members after them
EXPECTED = {
    "north-star": ["StretchMove"], "deo": ["StretchMove"],
    "general-cascade": ["StretchMove"],
    "lisa-rj": ["RedBlueGroupStretchMove", "DistributionGenerateRJ"],
    "tuning": ["CombineMove", "SliceMove", "MALAMove", "MALAMove", "HMCMove",
               "ChEESHMCMove", "AIMHMove"],
    "general-zoo": ["CombineMove", "StretchMove", "StretchMove", "DEMove",
                    "DESnookerMove", "WalkMove", "KDEMove", "GaussianMove",
                    "DistributionGenerate", "MTDistGenMove", "MTDistGenMove",
                    "GroupStretchMove", "BareStretch", "Jump",
                    "DelayedRejection", "GaussianMove", "DelayedRejection",
                    "Jump"],
    "mt-rj": ["GaussianMove", "MTDistGenMoveRJ"],
    "model-swap": ["GaussianMove", "ModelSwapRJMove",
                   "BasicSymmetricModelSwapRJMove"],
}


class BareStretch(et.StretchMove):
    """A bare subclass of a sharded move: the ``"gathered"`` route."""


class Jump(MHMove):
    """A user's ``MHMove`` that writes only its proposal, a symmetric
    Gaussian step: the ``"gathered proposal"`` route."""

    symmetric_proposal = True

    def get_proposal_kernel(self, generator, branch_coords, branch_inds,
                            kernel_state, param_masks=None):
        q = {n: c + 0.4 * torch.randn(c.shape, generator=generator,
                                      dtype=c.dtype, device=c.device)
             for n, c in branch_coords.items()}
        c = next(iter(q.values()))
        return q, c.new_zeros(c.shape[:2]), kernel_state


def _ll(x):
    return -0.5 * torch.sum(x * x)


def _ll_rj(c, i):
    """A unit Gaussian on every active leaf, centred at 0.5."""
    r = c - 0.5
    return torch.sum(torch.where(i, -0.5 * torch.sum(r * r, dim=-1), 0.0))


def _swap_problem():
    """``tests/test_modelswap.py``'s pulse against a constant, in torch."""
    rng = np.random.default_rng(4)
    t = np.linspace(0, 1, 64)
    g = np.exp(-((t - 0.5) ** 2) / (2 * 0.1 ** 2))
    data = torch.as_tensor(1.1 * g + rng.standard_normal(64))
    g = torch.as_tensor(g)

    def log_like(coords, inds):
        amp = torch.sum(torch.where(inds["pulse"][:, None], coords["pulse"],
                                    0.0))
        off = torch.sum(torch.where(inds["const"][:, None], coords["const"],
                                    0.0))
        return -0.5 * torch.sum((data - amp * g - off) ** 2)

    priors = {"pulse": et.ProbDistContainer({0: et.uniform_dist(0.0, 3.0)}),
              "const": et.ProbDistContainer({0: et.uniform_dist(-1.0, 1.0)})}
    return log_like, priors


def _tuning_moves():
    return CombineMove([
        SliceMove(tune_steps=TUNE), MALAMove(tune_steps=TUNE),
        MALAMove(ensemble_precondition=True, tune_steps=TUNE),
        HMCMove(num_leapfrog=(2, 4), tune_steps=TUNE),
        ChEESHMCMove(max_leapfrog=4, init_num_leapfrog=2, tune_steps=TUNE),
        AIMHMove(tune_steps=TUNE)])


def _gibbs():
    return [("model_0", np.array([[True, False]])),
            ("model_0", np.array([[False, True]]))]


def _general_moves(pr):
    return CombineMove([
        et.StretchMove(periodic={"model_0": {0: PERIOD}}, nsplits=4),
        et.StretchMove(gibbs_sampling_setup=_gibbs()), DEMove(),
        DESnookerMove(), WalkMove(), KDEMove(),
        GaussianMove({"model_0": 0.3}), DistributionGenerate({"model_0": pr}),
        MTDistGenMove({"model_0": pr}, num_try=3, independent=False),
        MTDistGenMove({"model_0": pr}, num_try=3, independent=True),
        GroupStretchMove(n_iter_update=REFRESH), BareStretch(), Jump(),
        DelayedRejection(GaussianMove({"model_0": 0.6}), max_iter=2),
        DelayedRejection(Jump(), max_iter=1)])


def _sampler(config, seed=5):
    """``config``'s sampler on the CPU, on the kernels' forms (their plain
    versions here), into ``DeviceBackend``."""
    tk = dict(ntemps=NT, use_kernels=config != "general-cascade")
    if config == "deo":
        tk.update(swap_scheme="deo", adaptation_scheme="syed")
    if config == "general-cascade":
        tk.update(permute=False)
    kw = dict(tempering_kwargs=tk, seed=seed, device="cpu",
              backend=et.DeviceBackend())
    rj = dict(nleaves_max=NLMAX, nleaves_min=0, fill_zero_leaves_val=-5.0)
    if config in ("lisa-rj", "mt-rj"):
        priors = et.ProbDistContainer({i: et.uniform_dist(-2.0, 2.0)
                                       for i in range(NDIM)})
        if config == "mt-rj":
            return et.EnsembleSampler(
                NW, NDIM, _ll_rj, priors, moves=GaussianMove({"model_0": 0.3}),
                rj_moves=[MTDistGenMoveRJ(
                    priors, nleaves_max={"model_0": NLMAX},
                    nleaves_min={"model_0": 0}, num_try=3)], **rj, **kw)
        return et.EnsembleSampler(
            NW, NDIM, _ll_rj, priors, moves=RedBlueGroupStretchMove(),
            rj_moves=True, **rj, **kw)
    if config == "model-swap":
        log_like, priors = _swap_problem()
        return et.EnsembleSampler(
            NW, {"pulse": 1, "const": 1}, log_like, priors,
            branch_names=["pulse", "const"],
            nleaves_max={"pulse": 1, "const": 1},
            nleaves_min={"pulse": 0, "const": 0},
            moves=[GaussianMove({"pulse": 0.05, "const": 0.05})],
            rj_moves=[ModelSwapRJMove(priors),
                      BasicSymmetricModelSwapRJMove([1, 1], [0, 0])],
            fill_zero_leaves_val=-1e8, **kw)
    if config == "general-zoo":
        priors = et.ProbDistContainer({0: et.uniform_dist(0.0, PERIOD),
                                       1: et.uniform_dist(-3.0, 3.0)})
        return et.EnsembleSampler(NW, NDIM, _ll, priors,
                                  moves=_general_moves(priors), **kw)
    priors = et.ProbDistContainer({i: et.uniform_dist(-5.0, 5.0)
                                   for i in range(NDIM)})
    moves = (_tuning_moves() if config == "tuning"
             else et.StretchMove(use_kernels=True))
    return et.EnsembleSampler(NW, NDIM, _ll, priors, moves=moves, **kw)


def _start(config, seed=1):
    rng = np.random.default_rng(seed)
    if config == "model-swap":
        pick = rng.random((NT, NW)) < 0.5
        coords = {"pulse": rng.uniform(0.0, 3.0, (NT, NW, 1, 1)),
                  "const": rng.uniform(-1.0, 1.0, (NT, NW, 1, 1))}
        inds = {"pulse": pick[..., None], "const": ~pick[..., None]}
        return et.State({n: torch.from_numpy(c.astype(np.float32))
                         for n, c in coords.items()},
                        inds={n: torch.from_numpy(m)
                              for n, m in inds.items()})
    nl = NLMAX if config in ("lisa-rj", "mt-rj") else 1
    coords = rng.uniform(-1.5, 1.5, (NT, NW, nl, NDIM)).astype(np.float32)
    if config == "general-zoo":
        coords[..., 0] = rng.uniform(0.1, PERIOD - 0.1, (NT, NW, nl))
    inds = (rng.random((NT, NW, nl)) < 0.6) if nl > 1 else np.ones(
        (NT, NW, nl), dtype=bool)
    return et.State({"model_0": torch.from_numpy(coords)},
                    inds={"model_0": torch.from_numpy(inds)})


def _members(move):
    """``move`` and, depth first, the moves it runs."""
    yield move
    for m in getattr(move, "moves_list", ()):
        yield from _members(m)
    if isinstance(move, DelayedRejection):
        yield from _members(move.proposal)


def _clocks(moves, states):
    """``(name, value)`` of every host-phase clock of ``moves`` (their
    kernel states ``states``), composites' members included."""
    out = []
    for m, ks in zip(moves, states):
        if isinstance(m, CombineMove):
            out += _clocks(m.moves_list, ks[0])
        elif isinstance(m, DelayedRejection):
            out += _clocks([m.proposal], [ks])
        elif (isinstance(ks, dict) and m.clock_key in ks
              and m.phase_of(0) is not None):
            out.append((type(m).__name__, int(ks[m.clock_key])))
    return out


def _record(s):
    """Every getter a run is compared on, and the host-phase clocks."""
    out = {"log_like": s.get_log_like(), "log_prior": s.get_log_prior(),
           "betas": s.get_betas(), "acc": s.acceptance_fraction,
           "swaps": s.swap_acceptance_fraction}
    for n in s.branch_names:
        out[f"chain/{n}"] = s.get_chain()[n]
        if s.has_reversible_jump:
            out[f"inds/{n}"] = s.get_inds()[n]
            out[f"nleaves/{n}"] = s.get_nleaves()[n]
    if s.has_reversible_jump:
        out["rj_acc"] = s.rj_acceptance_fraction
    clocks = _clocks(s._all_move_list, s._kernel_states)
    if clocks:
        out["clocks"] = np.array([v for _, v in clocks])
        out["clock_names"] = np.array([n for n, _ in clocks])
    return out


@contextlib.contextmanager
def _no_host_reads():
    """Every way a tensor's value reaches the host raises within it."""
    saved = {name: getattr(torch.Tensor, name) for name in HOST_READS}

    def refuse(name):
        def fn(self, *args, **kwargs):
            raise AssertionError(f"host read in a sharded step: Tensor.{name}")
        return fn

    for name in HOST_READS:
        setattr(torch.Tensor, name, refuse(name))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(torch.Tensor, name, fn)


def _one_step_without_host_reads(config, mesh):
    """One step of each of ``config``'s moves on its shard, host reads
    refused, in the phase the sampler's host shadow gives it and, for a
    move with a host phase, in the other one too; returns the names of the
    moves and their members, each declared planned."""
    s = _sampler(config)
    state = s._setup_state(shard_state(_start(config), mesh))
    s._ensure_kernel_states(state)
    ctx = s.get_eval_context()
    names = []
    for j, move in enumerate(s._all_move_list):
        for m in _members(move):
            assert m.mesh_device_planned(state), type(m).__name__
            names.append(type(m).__name__)
        ks = s._kernel_states[j]
        clocks = move.mesh_clocks(ks)
        phase = tuple(m.phase_of(int(t)) for m, t in clocks)
        time = s._start_clock(s.temperature_control)
        for ph in [phase] + [tuple(not p for p in phase)] * bool(clocks):
            with fixed_phases(clocks, ph), _no_host_reads():
                new, *_ = move.step_kernel(s._gen, state, time, ctx, ks)
        state = new
    return names


# the phase mechanism on the graph path: separate moves with host phases,
# one of them a combination of two
def _phase_sampler():
    priors = et.ProbDistContainer({i: et.uniform_dist(-5.0, 5.0)
                                   for i in range(NDIM)})
    moves = [MALAMove(tune_steps=TUNE), AIMHMove(tune_steps=TUNE),
             GroupStretchMove(n_iter_update=REFRESH),
             CombineMove([ChEESHMCMove(max_leapfrog=4, init_num_leapfrog=2,
                                       tune_steps=TUNE),
                          HMCMove(num_leapfrog=(2, 3), tune_steps=TUNE - 1)])]
    return et.EnsembleSampler(
        NW, NDIM, _ll, priors, moves=moves,
        tempering_kwargs=dict(ntemps=NT, use_kernels=True), seed=3,
        device="cpu", backend=et.DeviceBackend())


class _EagerReplay:
    """Stands in for a captured graph on the CPU: a replay runs the body."""

    def __init__(self, graphs, key, ctx):
        self.replay = lambda: graphs._body(key, ctx)


def _phase_run(mesh, graphed):
    """``_phase_sampler``'s chain on ``mesh`` (12 stored after 4 of
    burn-in, then 6 more), eagerly or through the graph path's static
    buffers with each replay emulated by the captured body, host reads
    refused in every replayed body.  Each body's phase key is logged beside
    the device clock's phase."""
    from eryn_tpu_torch.ensemble import EnsembleSampler
    from eryn_tpu_torch.graphs import StepGraphs

    body = StepGraphs._body
    log = []

    def checked(self, key, ctx):
        smp = self.sampler
        move = smp._all_move_list[key[0]]
        clocks = move.mesh_clocks(smp._kernel_states[key[0]])
        log.append([(type(m).__name__, p, m.phase_of(int(t)))
                    for (m, t), p in zip(clocks, key[2:])])
        if key in self.graphs:
            with _no_host_reads():
                return body(self, key, ctx)
        return body(self, key, ctx)

    saved = (EnsembleSampler.__dict__["_graphed"], StepGraphs._body,
             StepGraphs._capture)
    if graphed:
        EnsembleSampler._graphed = True
        StepGraphs._body = checked
        StepGraphs._capture = lambda self, key, ctx: (
            _EagerReplay(self, key, ctx), ())
    try:
        s = _phase_sampler()
        s.run_mcmc(shard_state(_start("north-star"), mesh), 12, burn=4)
        s.run_mcmc(None, 6)
    finally:
        (EnsembleSampler._graphed, StepGraphs._body,
         StepGraphs._capture) = saved
    return {"record": _record(s), "log": log, "replays": s.graph_replays,
            "warm": sorted(s._graphs.warm) if graphed else []}


def _rank_main(rank, world):
    out = {}
    for tp, wp in MESHES[world]:
        mesh = make_mesh(world, temp_parallel=tp)
        for config in CONFIGS:
            moves = _one_step_without_host_reads(config, mesh)
            s = _sampler(config)
            s.run_mcmc(shard_state(_start(config), mesh), STEPS, burn=BURN)
            out[(tp, wp, config)] = {"moves": moves, "record": _record(s)}
        if (tp, wp) == (1, 2):
            out["phases"] = {form: _phase_run(mesh, form == "graphed")
                             for form in ("graphed", "eager")}
    return out


def _one_rank_route(rank, world):
    """The sharded route on a one-rank mesh (``_one_rank_layout``), which
    ``chip_smoke.py`` captures over NCCL: every collective on a group of
    one."""
    from eryn_tpu_torch.parallel import _comm

    out = {}
    mesh = make_mesh(1)
    for config in CONFIGS:
        s = _sampler(config)
        state = shard_state(_start(config), mesh)
        s._one_rank_layout = state.sharding.layout
        before = dict(_comm.CALLS)
        s.run_mcmc(state, STEPS, burn=BURN)
        out[config] = {"record": _record(s),
                       "sharded": s._mesh_layout is not None,
                       "calls": sum(_comm.CALLS.values())
                       - sum(before.values())}
    return out


@pytest.fixture(scope="module")
def runs():
    out = {}
    for world in MESHES:
        for r, got in enumerate(launch(_rank_main, world, timeout=240)):
            for key, value in got.items():
                out.setdefault(key, []).append(value)
    out["one-rank"] = launch(_one_rank_route, 1, timeout=120)[0]
    return out


@pytest.fixture(scope="module")
def refs():
    out = {}
    for config in CONFIGS:
        s = _sampler(config)
        s.run_mcmc(_start(config), STEPS, burn=BURN)
        out[config] = _record(s)
    return out


def _assert_same(got, ref, where):
    assert set(got) == set(ref), where
    for key in ref:
        np.testing.assert_array_equal(got[key], ref[key],
                                      err_msg=f"{where}: {key}")


MESH_CASES = [(tp, wp, config) for shapes in MESHES.values()
              for tp, wp in shapes for config in CONFIGS]


@pytest.mark.parametrize("tp,wp,config", MESH_CASES)
def test_declared_moves_step_without_host_reads(runs, tp, wp, config):
    """Each declared move's sharded step (a composite's members' too), its
    swap phase included, reads nothing on the host on every rank, in each
    of its host phases."""
    for got in runs[(tp, wp, config)]:
        assert got["moves"] == EXPECTED[config]


@pytest.mark.parametrize("tp,wp,config", MESH_CASES)
def test_device_planned_chain_equals_one_rank(runs, refs, tp, wp, config):
    """The device-planned sharded chain equals the one-rank chain digit for
    digit on every rank, through every getter."""
    for r, got in enumerate(runs[(tp, wp, config)]):
        _assert_same(got["record"], refs[config],
                     f"({tp}, {wp}) {config}, rank {r}")


@pytest.mark.parametrize("config", CONFIGS)
def test_one_rank_sharded_route_equals_one_rank(runs, refs, config):
    """The sharded route on a one-rank mesh runs its collectives (a group
    of one) and equals the one-rank step's chain digit for digit."""
    got = runs["one-rank"][config]
    assert got["sharded"]
    assert got["calls"] > 0
    _assert_same(got["record"], refs[config], f"(1, 1) {config}")


@pytest.mark.parametrize("config", ["tuning", "general-zoo"])
def test_chains_cross_the_host_phases(refs, config):
    """The chains above pass each tuning move's ``tune_steps`` and the group
    stretch's refresh period: both phases of every move run in them."""
    names, clocks = refs[config]["clock_names"], refs[config]["clocks"]
    assert len(names) == (5 if config == "tuning" else 1)
    assert all(c > (REFRESH if n == "GroupStretchMove" else TUNE)
               for n, c in zip(names, clocks)), dict(zip(names, clocks))


def test_phase_keys_follow_the_device_clock(runs):
    """On the graph path (each replay the captured body, host reads refused
    in it) every phase key is the device clock's: a tuned key is never
    taken while ``t < tune_steps``, nor a not-due key at a refresh; each
    phased move ran in both phases, and each phase's graph was captured at
    its second due step."""
    for got in runs["phases"]:
        run = got["graphed"]
        seen = {}
        for body in run["log"]:
            for name, key, device in body:
                assert key == device, (name, key, device)
                seen.setdefault(name, set()).add(key)
        assert set(seen) == {"MALAMove", "AIMHMove", "GroupStretchMove",
                             "ChEESHMCMove", "HMCMove"}
        assert all(v == {True, False} for v in seen.values()), seen
        # per move index: its phase keys (the combination's are pairs)
        phases = {}
        for key in run["warm"]:
            phases.setdefault(key[0], set()).add(key[2:])
        assert all(len(v) >= 2 for v in phases.values()), phases
        assert run["replays"] > 0


def test_graph_path_with_phases_equals_the_eager_mesh_chain(runs):
    """The graph path's chain with a graph per host phase equals the eager
    mesh chain digit for digit, through every getter and the clocks."""
    for r, got in enumerate(runs["phases"]):
        _assert_same(got["graphed"]["record"], got["eager"]["record"],
                     f"(1, 2) rank {r}")
        assert got["eager"]["replays"] == 0


def test_undeclared_moves_stay_eager():
    """The declaration: every native move's sharded step is planned on the
    device, and so are users' subclasses on the two gathered routes (a
    bare subclass, an ``MHMove`` that writes only its proposal) and a
    user's own ``Move`` that declares itself sharded; a host move (Eryn's
    host hooks) is not; a composite is planned exactly when its members
    are."""
    class HostWalk(MHMove):
        symmetric_proposal = True

        def get_proposal(self, branches_coords, random, branches_inds=None,
                         **kwargs):
            return branches_coords, np.zeros((1, 1))

    class HostGroup(GroupStretchMove):
        def setup_friends(self, branches):
            pass

    class OwnSharded(Move):
        _mesh_sharded = True

    pr = et.ProbDistContainer({i: et.uniform_dist(-5.0, 5.0)
                               for i in range(NDIM)})
    state = _sampler("north-star")._setup_state(_start("north-star"))
    planned = [et.StretchMove(use_kernels=True),
               et.StretchMove(use_kernels=False),
               BareStretch(use_kernels=True), Jump(), _tuning_moves(),
               _general_moves(pr), RedBlueGroupStretchMove(),
               DelayedRejection(Jump()),
               MTDistGenMoveRJ(pr, nleaves_max={"model_0": NLMAX},
                               nleaves_min={"model_0": 0}),
               et.moves.DistributionGenerateRJ(
                   pr, nleaves_max={"model_0": NLMAX},
                   nleaves_min={"model_0": 0}),
               BasicSymmetricModelSwapRJMove([1, 1], [0, 0]), OwnSharded()]
    for move in planned:
        for m in _members(move):
            assert m.mesh_device_planned(state), type(m).__name__
    for move in (HostWalk(), HostGroup(), DelayedRejection(HostWalk()),
                 CombineMove([Jump(), HostWalk()])):
        assert not move.mesh_device_planned(state), type(move).__name__
