"""Reversible jump and the red/blue move family on the port's device mesh
(``eryn_tpu_torch.parallel.mesh``), against one-rank chains and against
``eryn_tpu``'s sharded runs.

The port's mesh is explicit SPMD: one process per device over
``torch.distributed``.  Here each world size (2, 4 and 8 ranks) is spawned
once on the CPU (gloo, ``file://`` rendezvous, a time limit on the whole
spawn) and runs every check of that size in its ranks; the tests read the
ranks' results.  The ranks import this module, so it imports ``jax`` and
``eryn_tpu`` only inside the tests.

Tolerances: a sharded chain draws every random array at its global shape
from the same generator as one process and keeps its rows, so on every
mesh it equals the one-rank chain digit for digit (bitwise), through every
getter of ``Backend`` and ``DeviceBackend``.  Against ``eryn_tpu``, which
draws from another generator, the checks are ``tests/test_sharding.py``'s
own invariants at its sizes, held in both packages on the same starts
(made with numpy): the flat-likelihood RJ run of
``test_sharded_rbgroupstretch_rj`` has active coordinates uniform on
``[-1, 1]`` (``|mean| < 0.05``, ``|var - 1/3| < 0.04``), and the pulse of
``test_sharded_rj_group_run`` is found (cold mean leaf count above 0.8).
"""

import numpy as np
import pytest
import torch

import eryn_tpu_torch as et
from eryn_tpu_torch.moves import (
    DEMove,
    DESnookerMove,
    GroupStretchMove,
    KDEMove,
    RedBlueGroupStretchMove,
    WalkMove,
)
from eryn_tpu_torch.parallel import make_mesh, shard_state
from eryn_tpu_torch.parallel._spawn import launch

NDIM, NLMAX, NW, NT = 2, 3, 16, 4
STEPS, BURN = 10, 2
MESHES = {2: [(1, 2), (2, 1)], 4: [(2, 2)], 8: [(2, 4)]}
CONFIGS = ("rbgs_cascade", "rbgs_deo", "group", "zoo")
BACKENDS = ("host", "device")
# the odd widths: halves of 9 walkers on shards of 9, and 3 leaves a walker,
# so that a walker's packed mask bytes (6 or 12) follow its coordinates
# at no word boundary of the wider rows; the group stretch there wraps its
# first parameter (period 6, kernel 5's periodic form)
NW_ODD, NDIM_ODD, PERIOD = 18, 3, 6.0
# tests/test_sharding.py::test_sharded_rbgroupstretch_rj's sizes
FLAT = dict(ndim=2, nlmax=2, nw=32, nt=4, steps=400, burn=100, seed=33)
# tests/test_sharding.py::test_sharded_rj_group_run's sizes
PULSE = dict(nw=64, nt=4, nlmax=2, steps=150, burn=100, seed=41,
             n_iter_update=20)


def _ll(c, i):
    """A unit Gaussian on every active leaf."""
    return torch.sum(torch.where(i, -0.5 * torch.sum(c * c, dim=-1), 0.0))


def _ll_1(x):
    return -0.5 * torch.sum(x * x)


def _priors(ndim, lo=-3.0, hi=3.0, periodic=False):
    """Uniform on ``[lo, hi]``; with ``periodic`` the first parameter on
    ``[0, PERIOD]``."""
    return et.ProbDistContainer({
        i: et.uniform_dist(0.0, PERIOD) if periodic and i == 0
        else et.uniform_dist(lo, hi) for i in range(ndim)})


def _sampler(config, backend, nw=NW, ndim=NDIM, seed=7):
    tk = dict(ntemps=NT, use_kernels=True)
    if config == "rbgs_deo":
        tk.update(swap_scheme="deo", adaptation_scheme="syed")
    kw = dict(tempering_kwargs=tk, seed=seed, device="cpu",
              backend=et.DeviceBackend() if backend == "device"
              else et.Backend())
    if config == "zoo":
        # the splits the one-rank path runs: three blocks, a fixed split,
        # and two Gibbs splits of one parameter each
        gibbs = [("model_0", np.array([[True, False]])),
                 ("model_0", np.array([[False, True]]))]
        return et.EnsembleSampler(
            nw, ndim, _ll_1, _priors(ndim),
            moves=[(DEMove(nsplits=3), 0.25),
                   (DESnookerMove(gibbs_sampling_setup=gibbs), 0.25),
                   (WalkMove(randomize_split=False), 0.25),
                   (KDEMove(), 0.25)], **kw)
    if config == "group":
        move = GroupStretchMove(n_iter_update=4)
    elif config == "odd":
        move = RedBlueGroupStretchMove(periodic={"model_0": {0: PERIOD}})
    else:
        move = RedBlueGroupStretchMove()
    return et.EnsembleSampler(
        nw, ndim, _ll, _priors(ndim, periodic=config == "odd"),
        nleaves_max=NLMAX, nleaves_min=0, moves=move, rj_moves=True,
        fill_zero_leaves_val=-5.0, **kw)


def _start(config, nw=NW, ndim=NDIM, seed=1):
    rng = np.random.default_rng(seed)
    nl = 1 if config == "zoo" else NLMAX
    coords = rng.uniform(-2, 2, (NT, nw, nl, ndim)).astype(np.float32)
    if config == "odd":  # inside the period
        coords[..., 0] += 3.0
    inds = (rng.random((NT, nw, nl)) < 0.6) if nl > 1 else np.ones(
        (NT, nw, nl), dtype=bool)
    return et.State({"model_0": torch.from_numpy(coords)},
                    inds={"model_0": torch.from_numpy(inds)})


def _record(s):
    """Every getter a run is compared on."""
    return {"chain": s.get_chain()["model_0"], "inds": s.get_inds()["model_0"],
            "nleaves": s.get_nleaves()["model_0"],
            "log_like": s.get_log_like(), "log_prior": s.get_log_prior(),
            "betas": s.get_betas(), "acc": s.acceptance_fraction,
            "rj_acc": s.rj_acceptance_fraction,
            "swaps": s.swap_acceptance_fraction,
            "cold": s.get_chain(temp_index=0)["model_0"],
            "step4": s.get_inds(slice_vals=4)["model_0"],
            "last": s.get_last_sample().log_like.numpy()}


def _chain(config, backend, state, nw=NW, ndim=NDIM):
    s = _sampler(config, backend, nw=nw, ndim=ndim)
    s.run_mcmc(state, STEPS, burn=BURN)
    return _record(s)


def _flat_run(mesh=None):
    """``test_sharded_rbgroupstretch_rj``'s configuration in the port: a
    flat likelihood over the prior ``[-1, 1]``; returns the active
    coordinates."""
    f = FLAT
    s = et.EnsembleSampler(
        f["nw"], f["ndim"], lambda c, i: torch.zeros(()),
        _priors(f["ndim"], -1.0, 1.0), nleaves_max=f["nlmax"],
        nleaves_min=0, moves=RedBlueGroupStretchMove(live_dangerously=True),
        rj_moves=True, fill_zero_leaves_val=0.0,
        tempering_kwargs=dict(ntemps=f["nt"], use_kernels=True),
        seed=f["seed"], device="cpu", backend=et.DeviceBackend())
    coords, inds = _flat_start()
    state = et.State({"model_0": torch.from_numpy(coords)},
                     inds={"model_0": torch.from_numpy(inds)})
    if mesh is not None:
        state = shard_state(state, mesh)
    s.run_mcmc(state, f["steps"], burn=f["burn"])
    return s.get_chain()["model_0"][s.get_inds()["model_0"]]


def _flat_start():
    f = FLAT
    rng = np.random.default_rng(f["seed"])
    coords = rng.uniform(-1.0, 1.0, (f["nt"], f["nw"], f["nlmax"],
                                     f["ndim"])).astype(np.float32)
    return coords, rng.random((f["nt"], f["nw"], f["nlmax"])) < 0.5


def _pulse_data():
    rng = np.random.default_rng(5)
    t = np.linspace(0, 10, 64)
    sigma = 0.4
    data = 3.0 * np.exp(-((t - 5.0) ** 2) / (2 * 0.7 ** 2))
    return t, data + sigma * rng.standard_normal(len(t)), sigma


def _pulse_start():
    p = PULSE
    rng = np.random.default_rng(p["seed"])
    lo, hi = np.array([0.5, 0.0, 0.2]), np.array([5.0, 10.0, 2.0])
    coords = lo + (hi - lo) * rng.random((p["nt"], p["nw"], p["nlmax"], 3))
    return coords.astype(np.float32), rng.random((p["nt"], p["nw"],
                                                   p["nlmax"])) < 0.5


def _pulse_run(mesh):
    """``test_sharded_rj_group_run``'s configuration in the port, sharded;
    returns the cold chain's leaf counts and the log-likelihoods."""
    p = PULSE
    t_np, data_np, sigma = _pulse_data()
    t, data = torch.tensor(t_np), torch.tensor(data_np)

    def ll(coords, inds):
        a, b, c = coords[:, 0], coords[:, 1], coords[:, 2]
        pk = a[:, None] * torch.exp(-((t[None] - b[:, None]) ** 2)
                                    / (2 * c[:, None] ** 2))
        tmpl = torch.sum(torch.where(inds[:, None], pk, 0.0), dim=0)
        return -0.5 * torch.sum(((tmpl - data) / sigma) ** 2)

    pr = et.ProbDistContainer({0: et.uniform_dist(0.5, 5.0),
                               1: et.uniform_dist(0.0, 10.0),
                               2: et.uniform_dist(0.2, 2.0)})
    s = et.EnsembleSampler(
        p["nw"], 3, ll, pr, nleaves_max=p["nlmax"], nleaves_min=0,
        moves=[GroupStretchMove(n_iter_update=p["n_iter_update"])],
        rj_moves=True, tempering_kwargs=dict(ntemps=p["nt"], use_kernels=True),
        fill_zero_leaves_val=float(-0.5 * np.sum((data_np / sigma) ** 2)),
        seed=p["seed"], device="cpu", backend=et.DeviceBackend())
    coords, inds = _pulse_start()
    state = shard_state(et.State({"model_0": torch.from_numpy(coords)},
                                 inds={"model_0": torch.from_numpy(inds)}),
                        mesh)
    s.run_mcmc(state, p["steps"], burn=p["burn"])
    return s.get_nleaves()["model_0"][:, 0], s.get_log_like()


def _rank_main(rank, world):
    """Every check of one world size, in each rank."""
    out = {"chains": {}}
    for tp, wp in MESHES[world]:
        mesh = make_mesh(world, temp_parallel=tp)
        for config in CONFIGS:
            for backend in BACKENDS:
                out["chains"][(tp, wp), config, backend] = _chain(
                    config, backend, shard_state(_start(config), mesh))
        if world == 2:
            odd = shard_state(_start("odd", nw=NW_ODD, ndim=NDIM_ODD), mesh)
            out["chains"][(tp, wp), "odd", "host"] = _chain(
                "odd", "host", odd, nw=NW_ODD, ndim=NDIM_ODD)
    if world == 8:
        mesh = make_mesh(8)
        out["flat"] = _flat_run(mesh)
        out["pulse"] = _pulse_run(mesh)
    return out


class _Spawns:
    """Each world size spawned once, the three at the same time, in the
    background; ``spawns[world]`` waits for that size's ranks' results."""

    def __init__(self, worlds=(2, 4, 8)):
        from concurrent.futures import ThreadPoolExecutor

        self.pool = ThreadPoolExecutor(len(worlds))
        self.runs = {w: self.pool.submit(launch, _rank_main, w, timeout=240)
                     for w in worlds}

    def __getitem__(self, world):
        return self.runs[world].result()


@pytest.fixture(scope="module")
def ranks():
    spawns = _Spawns()
    yield spawns
    spawns.pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def one_rank():
    """The one-process chains the sharded ones must equal."""
    out = {(config, backend): _chain(config, backend, _start(config))
           for config in CONFIGS for backend in BACKENDS}
    out["odd", "host"] = _chain("odd", "host",
                                _start("odd", nw=NW_ODD, ndim=NDIM_ODD),
                                nw=NW_ODD, ndim=NDIM_ODD)
    return out


def _assert_same(got, ref, label):
    assert set(got) == set(ref)
    for key in ref:
        if ref[key] is None:
            assert got[key] is None, (label, key)
            continue
        np.testing.assert_array_equal(got[key], ref[key],
                                      err_msg=f"{label} {key}")


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("mesh", [(1, 2), (2, 1), (2, 2), (2, 4)])
def test_sharded_chain_equals_one_rank(ranks, one_rank, mesh, config):
    """RJ with ``RedBlueGroupStretchMove`` (kernel 5's path, under the
    kernel cascade and under DEO with the Syed ladder), RJ with
    ``GroupStretchMove(n_iter_update=4)`` (its table refreshed inside the
    run) and DE / DE-snooker / walk / KDE at 0.25 each (with three blocks,
    two Gibbs splits and a fixed split among them), on a sharded state,
    equal the one-rank run digit for digit: chain, masks, leaf counts,
    log-likelihood and log-prior, ladder, acceptance, RJ acceptance and
    swap fractions, a step's masks, the cold chain and the last sample,
    through ``Backend`` and ``DeviceBackend``, on every rank."""
    world = mesh[0] * mesh[1]
    for backend in BACKENDS:
        ref = one_rank[config, backend]
        for rank in ranks[world]:
            _assert_same(rank["chains"][mesh, config, backend], ref,
                         f"{mesh} {config} {backend}")


@pytest.mark.parametrize("mesh", [(1, 2), (2, 1)])
def test_sharded_rj_chain_equals_one_rank_at_odd_widths(ranks, one_rank,
                                                        mesh):
    """RJ with the group stretch at 18 walkers and 3-D leaves (halves and
    shards of 9 walkers, whose packed rows carry 6 or 12 mask bytes after
    the coordinates), its first parameter periodic (kernel 5's wrap):
    every exchange unpacks into each dtype, and the chain equals the
    one-rank chain digit for digit."""
    for rank in ranks[2]:
        _assert_same(rank["chains"][mesh, "odd", "host"],
                     one_rank["odd", "host"], f"{mesh} odd")


def test_sharded_rbgroupstretch_rj_flat_invariant_matches_eryn_tpu(ranks):
    """``tests/test_sharding.py::test_sharded_rbgroupstretch_rj`` in both
    packages on the same numpy start: the group stretch with birth and
    death under a flat likelihood over ``[-1, 1]``, 32 walkers, 4
    temperatures, 400 stored steps after 100, sharded over ``make_mesh(8)``
    (the port's (2, 4) mesh of 8 ranks): the active coordinates are uniform
    (``|mean| < 0.05``, ``|var - 1/3| < 0.04``) in each."""
    import jax
    import jax.numpy as jnp

    import eryn_tpu
    from eryn_tpu.moves import RedBlueGroupStretchMove as JRBGS
    from eryn_tpu.parallel.mesh import make_mesh as jmake_mesh
    from eryn_tpu.parallel.mesh import shard_state as jshard_state

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    f = FLAT
    pr = eryn_tpu.ProbDistContainer({i: eryn_tpu.uniform_dist(-1.0, 1.0)
                                     for i in range(f["ndim"])})
    ens = eryn_tpu.EnsembleSampler(
        f["nw"], f["ndim"], lambda c, i: jnp.zeros(()), pr,
        nleaves_max=f["nlmax"], nleaves_min=0,
        moves=JRBGS(live_dangerously=True), rj_moves=True,
        fill_zero_leaves_val=0.0, tempering_kwargs=dict(ntemps=f["nt"]),
        seed=f["seed"])
    coords, inds = _flat_start()
    state = ens._setup_state(eryn_tpu.State({"model_0": coords},
                                            inds={"model_0": inds}))
    ens.run_mcmc(jshard_state(state, jmake_mesh(8)), f["steps"],
                 burn=f["burn"])
    jact = ens.get_chain()["model_0"][ens.get_inds()["model_0"]]
    for label, act in (("eryn_tpu", jact), ("port", ranks[8][0]["flat"])):
        assert abs(act.mean()) < 0.05, (label, act.mean())
        assert abs(act.var() - 1.0 / 3.0) < 0.04, (label, act.var())
    for rank in ranks[8]:
        np.testing.assert_array_equal(rank["flat"], ranks[8][0]["flat"])


def test_sharded_rj_group_run_finds_the_pulse_as_eryn_tpu(ranks):
    """``tests/test_sharding.py::test_sharded_rj_group_run`` in both
    packages on the same numpy start: birth and death with
    ``GroupStretchMove(n_iter_update=20)`` on the 64-point pulse, 64
    walkers, 4 temperatures, 150 stored steps after 100, over
    ``make_mesh(8)``: the cold mean leaf count is above 0.8 and every
    log-likelihood finite in each."""
    import jax
    import jax.numpy as jnp

    import eryn_tpu
    from eryn_tpu.moves import GroupStretchMove as JGroupStretch
    from eryn_tpu.parallel.mesh import make_mesh as jmake_mesh
    from eryn_tpu.parallel.mesh import shard_state as jshard_state

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    p = PULSE
    t_np, data_np, sigma = _pulse_data()
    t, data = jnp.asarray(t_np), jnp.asarray(data_np)

    def ll(coords, inds):
        a, b, c = coords[:, 0], coords[:, 1], coords[:, 2]
        pk = a[:, None] * jnp.exp(-((t[None] - b[:, None]) ** 2)
                                  / (2 * c[:, None] ** 2))
        tmpl = jnp.sum(jnp.where(inds[:, None], pk, 0.0), axis=0)
        return -0.5 * jnp.sum(((tmpl - data) / sigma) ** 2)

    pr = eryn_tpu.ProbDistContainer({0: eryn_tpu.uniform_dist(0.5, 5.0),
                                     1: eryn_tpu.uniform_dist(0.0, 10.0),
                                     2: eryn_tpu.uniform_dist(0.2, 2.0)})
    ens = eryn_tpu.EnsembleSampler(
        p["nw"], 3, ll, pr, nleaves_max=p["nlmax"], nleaves_min=0,
        moves=[JGroupStretch(n_iter_update=p["n_iter_update"])],
        rj_moves=True, tempering_kwargs=dict(ntemps=p["nt"]),
        fill_zero_leaves_val=float(-0.5 * np.sum((data_np / sigma) ** 2)),
        seed=p["seed"])
    coords, inds = _pulse_start()
    state = ens._setup_state(eryn_tpu.State({"model_0": coords},
                                            inds={"model_0": inds}))
    ens.run_mcmc(jshard_state(state, jmake_mesh(8)), p["steps"],
                 burn=p["burn"])
    results = [("eryn_tpu", ens.get_nleaves()["model_0"][:, 0],
                ens.get_log_like()),
               ("port",) + tuple(ranks[8][0]["pulse"])]
    for label, nleaves, logl in results:
        assert nleaves.mean() > 0.8, (label, nleaves.mean())
        assert np.isfinite(logl).all(), label
