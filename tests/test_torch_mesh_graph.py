"""The sharded step planned on the device (``eryn_tpu_torch.parallel.mesh``):
what a CUDA graph needs of it, checked on the CPU.

Under a mesh whose process group is NCCL the sampler captures each move's
sharded step in a CUDA graph, collectives included, when the move declares
it planned on the device (``Move.mesh_device_planned``): the fused
``StretchMove``, ``RedBlueGroupStretchMove`` and the birth/death move, each
with its swap phase (the kernel cascade, the general cascade or DEO).  A
graph holds no host read and no exchange whose sizes the data decides.
Here each world size (2, 4 and 8 ranks) is spawned once (gloo, the CPU)
and, on the meshes (1, 2), (2, 1), (2, 2) and (2, 4):

* one step of each declared move runs with ``Tensor.cpu``, ``.item``,
  ``.tolist``, ``.numpy``, ``__bool__``, ``__int__`` and ``__float__``
  patched to raise (the comm layer stages nothing on CPU tensors);
* the north-star (stretch and the kernel cascade), DEO and a LISA-style
  reversible-jump configuration (the red/blue group stretch, births and
  deaths, kernel 3 in both phases) equal the one-rank chain digit for
  digit through every getter.

On one rank (gloo, world size 1) the sharded route of a one-rank mesh, which
``chip_smoke.py`` captures over NCCL on one card, equals the one-rank chain
too.  The ranks import this module; it imports no ``jax``.

Run: ``JAX_PLATFORMS=cpu python -m pytest tests/test_torch_mesh_graph.py
-q`` (about 30-60 s: 1, 2, 4 and 8 ranks in turn).
"""

import contextlib

import numpy as np
import pytest
import torch

import eryn_tpu_torch as et
from eryn_tpu_torch.moves import RedBlueGroupStretchMove
from eryn_tpu_torch.parallel import make_mesh, shard_state
from eryn_tpu_torch.parallel._spawn import launch

NT, NW, NDIM, NLMAX = 4, 16, 2, 3
STEPS, BURN = 8, 2
MESHES = {2: [(1, 2), (2, 1)], 4: [(2, 2)], 8: [(2, 4)]}
CONFIGS = ("north-star", "deo", "general-cascade", "lisa-rj")
HOST_READS = ("cpu", "item", "tolist", "numpy", "__bool__", "__int__",
              "__float__")


def _ll(x):
    return -0.5 * torch.sum(x * x)


def _ll_rj(c, i):
    """A unit Gaussian on every active leaf, centred at 0.5."""
    r = c - 0.5
    return torch.sum(torch.where(i, -0.5 * torch.sum(r * r, dim=-1), 0.0))


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
    if config == "lisa-rj":
        priors = et.ProbDistContainer({i: et.uniform_dist(-2.0, 2.0)
                                       for i in range(NDIM)})
        return et.EnsembleSampler(
            NW, NDIM, _ll_rj, priors, nleaves_max=NLMAX, nleaves_min=0,
            moves=RedBlueGroupStretchMove(), rj_moves=True,
            fill_zero_leaves_val=-5.0, **kw)
    priors = et.ProbDistContainer({i: et.uniform_dist(-5.0, 5.0)
                                   for i in range(NDIM)})
    return et.EnsembleSampler(NW, NDIM, _ll, priors,
                              moves=et.StretchMove(use_kernels=True), **kw)


def _start(config, seed=1):
    rng = np.random.default_rng(seed)
    nl = NLMAX if config == "lisa-rj" else 1
    coords = rng.uniform(-1.5, 1.5, (NT, NW, nl, NDIM)).astype(np.float32)
    inds = (rng.random((NT, NW, nl)) < 0.6) if nl > 1 else np.ones(
        (NT, NW, nl), dtype=bool)
    return et.State({"model_0": torch.from_numpy(coords)},
                    inds={"model_0": torch.from_numpy(inds)})


def _record(s):
    """Every getter a run is compared on."""
    out = {"chain": s.get_chain()["model_0"], "log_like": s.get_log_like(),
           "log_prior": s.get_log_prior(), "betas": s.get_betas(),
           "acc": s.acceptance_fraction, "swaps": s.swap_acceptance_fraction}
    if s.has_reversible_jump:
        out.update(inds=s.get_inds()["model_0"],
                   nleaves=s.get_nleaves()["model_0"],
                   rj_acc=s.rj_acceptance_fraction)
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
    refused; returns the moves' names, each declared planned."""
    s = _sampler(config)
    state = s._setup_state(shard_state(_start(config), mesh))
    s._ensure_kernel_states(state)
    ctx = s.get_eval_context()
    names = []
    for j, move in enumerate(s._all_move_list):
        assert move.mesh_device_planned(state), type(move).__name__
        time = s._start_clock(s.temperature_control)
        with _no_host_reads():
            state, *_ = move.step_kernel(s._gen, state, time, ctx,
                                         s._kernel_states[j])
        names.append(type(move).__name__)
    return names


def _rank_main(rank, world):
    out = {}
    for tp, wp in MESHES[world]:
        mesh = make_mesh(world, temp_parallel=tp)
        for config in CONFIGS:
            moves = _one_step_without_host_reads(config, mesh)
            s = _sampler(config)
            s.run_mcmc(shard_state(_start(config), mesh), STEPS, burn=BURN)
            out[(tp, wp, config)] = {"moves": moves, "record": _record(s)}
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
    """Each declared move's sharded step, its swap phase included, reads
    nothing on the host on every rank."""
    want = (["RedBlueGroupStretchMove", "DistributionGenerateRJ"]
            if config == "lisa-rj" else ["StretchMove"])
    for got in runs[(tp, wp, config)]:
        assert got["moves"] == want


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


def test_undeclared_moves_stay_eager():
    """The declaration is the class's: a tuning move, a bare subclass (the
    gathered route) and the general-path stretch are not planned on the
    device, so a graphed mesh run keeps them eager; the fused stretch on a
    state of the kernels' path is."""
    class Bare(et.StretchMove):
        pass

    state = _sampler("north-star")._setup_state(_start("north-star"))
    assert et.StretchMove(use_kernels=True).mesh_device_planned(state)
    assert not et.StretchMove(use_kernels=False).mesh_device_planned(state)
    assert not Bare(use_kernels=True).mesh_device_planned(state)
    from eryn_tpu_torch.moves import AIMHMove, SliceMove

    assert not SliceMove().mesh_device_planned(state)
    assert not AIMHMove().mesh_device_planned(state)
