"""The port's device mesh (``eryn_tpu_torch.parallel.mesh``) against
``eryn_tpu``'s, and sharded chains against one-rank chains.

The port's mesh is explicit SPMD: one process per device over
``torch.distributed``.  Here each world size (1, 2, 4 and 8 ranks) is
spawned once on the CPU (gloo, ``file://`` rendezvous, a time limit on the
whole spawn) and runs every check of that size in its ranks; the tests read
the ranks' results.  The ranks import this module, so it imports ``jax``
and ``eryn_tpu`` only inside the tests.

Tolerances: the mesh shapes, the partition specs and the errors equal
``eryn_tpu``'s.  A sharded chain draws every random array at its global
shape from the same generator as one process and keeps its slice, so on
every mesh it equals the one-rank chain digit for digit (bitwise), as do
the backends' getters and the group mesh's groups.  Against ``eryn_tpu``'s
sharded run, which draws from another generator, the comparison is
``tests/test_sharding.py::test_sharded_statistical_equivalence``'s, at its
sizes: moments, cold log-likelihood, acceptance and swap rates within 4
standard errors.
"""

import os
import tempfile

import numpy as np
import pytest
import torch

import eryn_tpu_torch as et
from eryn_tpu_torch.parallel import (
    ParaEnsembleSampler,
    constrain_state,
    make_group_mesh,
    make_mesh,
    mesh_of_state,
    shard_state,
    sharding_for_state,
)
from eryn_tpu_torch.parallel._spawn import launch

NDIM, NW, NT = 3, 16, 4
STEPS, BURN = 12, 3
MESHES = {2: [(1, 2), (2, 1)], 4: [(2, 2)], 8: [(2, 4)]}
# a walker count whose shards' bool rows are not whole 4-byte words
NW_ODD = 18
SCHEMES = ("cascade", "deo")
# tests/test_sharding.py::test_sharded_statistical_equivalence's sizes
STAT_NW, STAT_NT, STAT_STEPS, STAT_BURN, STAT_SEED = 64, 4, 1000, 200, 77
GROUPS = {2: 4, 4: 8}


def _ll(x):
    return -0.5 * torch.sum(x * x)


def _priors(ndim=NDIM):
    return et.ProbDistContainer({i: et.uniform_dist(-5, 5)
                                 for i in range(ndim)})


def _sampler(scheme, backend, nw=NW, nt=NT, seed=7):
    tk = dict(ntemps=nt, use_kernels=True)
    if scheme == "deo":
        tk.update(swap_scheme="deo", adaptation_scheme="syed")
    return et.EnsembleSampler(
        nw, NDIM, _ll, _priors(), moves=et.StretchMove(use_kernels=True),
        tempering_kwargs=tk, seed=seed, device="cpu",
        backend=et.DeviceBackend() if backend == "device" else et.Backend())


def _start(nt=NT, nw=NW, seed=1):
    return torch.from_numpy(np.random.default_rng(seed).uniform(
        -2, 2, (nt, nw, 1, NDIM)).astype(np.float32))


def _record(s):
    """Every getter a run is compared on."""
    out = {"chain": s.get_chain()["model_0"], "inds": s.get_inds()["model_0"],
           "log_like": s.get_log_like(), "log_prior": s.get_log_prior(),
           "betas": s.get_betas(), "acc": s.acceptance_fraction,
           "swaps": s.swap_acceptance_fraction,
           "cold": s.get_chain(temp_index=0)["model_0"],
           "step5": s.get_chain(slice_vals=5)["model_0"],
           "last": s.get_last_sample().log_like.numpy(),
           "tau": s.get_autocorr_time()["model_0"]}
    return out


def _chain(scheme, backend, state, nw=NW):
    s = _sampler(scheme, backend, nw=nw)
    s.run_mcmc(state, STEPS, burn=BURN)
    return _record(s)


def _para(ngroups, mesh=None, two_moves=False):
    kw = {}
    if two_moves:
        kw["moves"] = [(et.StretchMove(), 0.5), (et.StretchMove(a=1.5), 0.5)]
    return ParaEnsembleSampler(ngroups, NW, NDIM, _ll, _priors(), seed=11,
                               tempering_kwargs=dict(ntemps=2), device="cpu",
                               mesh=mesh, **kw)


def _para_start(ngroups):
    return np.random.default_rng(3).uniform(
        -2, 2, (ngroups, 2, NW, NDIM)).astype(np.float32)


def _para_record(p):
    return {"chain": p.get_chain()["model_0"], "log_like": p.get_log_like(),
            "betas": p.get_betas(), "acc": p.acceptance_fraction,
            "swaps": p.swap_acceptance_fraction,
            "moves": p.move_proposals}


def _refusals(mesh):
    """The named error of each configuration at set-up, None where it
    runs: a subclass of a sharded move that does not declare itself sharded
    is refused; the host move, the periodic stretch, the general cascade,
    blobs, a host likelihood, ``HDFBackend`` (one file, rank 0's path on
    every rank) and the hooks run sharded."""

    from eryn_tpu_torch.moves import MHMove

    class KernelWalk(MHMove):
        """A subclass of a sharded move that does not declare itself
        sharded (``_mesh_sharded``)."""

        def get_proposal_kernel(self, generator, branch_coords, branch_inds,
                                kernel_state, param_masks=None):
            c = next(iter(branch_coords.values()))
            return branch_coords, c.new_zeros(c.shape[:2]), kernel_state

    class HostWalk(MHMove):
        """A host move: Eryn's NumPy ``get_proposal``
        (``moves/legacy.py``)."""

        def get_proposal(self, branches_coords, random, branches_inds=None,
                         **kwargs):
            c = next(iter(branches_coords.values()))
            return branches_coords, np.zeros(np.shape(c)[:2])

    def ll_blobs(x):
        return -0.5 * torch.sum(x * x), torch.sum(x)

    def np_ll(x):
        return -0.5 * float(np.sum(np.asarray(x) ** 2))

    cases = {
        "MHMove subclass": dict(moves=KernelWalk()),
        "host move": dict(moves=HostWalk()),
        "StretchMove(periodic)": dict(moves=et.StretchMove(
            periodic={"model_0": {0: 1.0}})),
        "general cascade": dict(tempering_kwargs=dict(ntemps=NT,
                                                      permute=False)),
        "blobs": dict(log_like=ll_blobs),
        "host likelihood": dict(log_like=np_ll),
        "HDFBackend": dict(backend=_shared_path("chain.h5")),
        "hooks": dict(update_fn=lambda *args: None, update_iterations=1),
    }
    out = {}
    for name, kw in cases.items():
        kw = dict(kw)
        ll = kw.pop("log_like", _ll)
        kw.setdefault("tempering_kwargs", dict(ntemps=NT))
        nl = kw.get("nleaves_max", 1)
        try:
            import warnings

            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                s = et.EnsembleSampler(NW, NDIM, ll, _priors(), seed=1,
                                       device="cpu", **kw)
                state = et.State({"model_0": _start()[:, :, :1].expand(
                    NT, NW, nl, NDIM).contiguous()},
                    inds={"model_0": torch.ones((NT, NW, nl), dtype=bool)})
                s.run_mcmc(shard_state(state, mesh), 2)
            out[name] = None
        except NotImplementedError as err:
            out[name] = str(err)
    return out


def _shared_path(name):
    """A path in a fresh temporary directory of rank 0's, on every rank."""
    import torch.distributed as dist

    box = [os.path.join(tempfile.mkdtemp(), name)]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _rank_main(rank, world):
    """Every check of one world size, in each rank."""
    out = {"errors": {}}
    base = make_mesh()
    out["shapes"] = {
        "default": dict(zip(base.mesh_dim_names, base.shape)),
        "temp1": dict(zip(*(lambda m: (m.mesh_dim_names, m.shape))(
            make_mesh(world, temp_parallel=1)))),
        "group": dict(zip(*(lambda m: (m.mesh_dim_names, m.shape))(
            make_group_mesh(world)))),
    }
    for label, call in (("too_many", lambda: make_mesh(world + 1)),
                        ("indivisible",
                         lambda: make_mesh(world, temp_parallel=3))):
        try:
            call()
            out["errors"][label] = None
        except ValueError as err:
            out["errors"][label] = str(err)
    state = _start()
    if world == 1:
        shard = shard_state(et.State({"model_0": state}), base)
        out["one_rank_mesh"] = mesh_of_state(shard)
        return out
    out["chains"] = {}
    for tp, wp in MESHES[world]:
        mesh = make_mesh(world, temp_parallel=tp)
        for scheme in SCHEMES:
            for backend in ("host", "device"):
                shard = shard_state(et.State({"model_0": state}), mesh)
                out["chains"][(tp, wp), scheme, backend] = _chain(
                    scheme, backend, shard)
    mesh = make_mesh(world, temp_parallel=MESHES[world][0][0])
    shard = shard_state(et.State({"model_0": state}), mesh)
    out["mesh_of_state"] = mesh_of_state(shard) is mesh
    out["plain_mesh_of_state"] = mesh_of_state(et.State({"model_0": state}))
    constrain_state(shard, mesh)
    try:
        constrain_state(shard.replace(
            coords={"model_0": torch.zeros(NT, NW, 1, NDIM)},
            inds={"model_0": torch.ones(NT, NW, 1, dtype=torch.bool)}), mesh)
        out["constrain_bad"] = None
    except ValueError as err:
        out["constrain_bad"] = str(err)
    out["local_shapes"] = (tuple(shard.branches["model_0"].coords.shape),
                           shard.sharding.layout.t0, shard.sharding.layout.w0)
    # a state that has not been evaluated: the dims come from the coords
    pre = shard_state(et.State({"model_0": state}), mesh)
    out["pre_shape"] = tuple(pre.branches["model_0"].coords.shape)
    if world == 2:
        out["refusals"] = _refusals(mesh)
        for tp in (1, 2):
            odd = shard_state(et.State({"model_0": _start(nw=NW_ODD)}),
                              make_mesh(2, temp_parallel=tp))
            for scheme in SCHEMES:
                out["chains"][(tp, 2 // tp), scheme, "odd"] = _chain(
                    scheme, "host", odd, nw=NW_ODD)
    if world in GROUPS:
        gmesh = make_group_mesh(world)
        out["para"] = {}
        for two in (False, True):
            p = _para(GROUPS[world], gmesh, two)
            p.run_mcmc(_para_start(GROUPS[world]), 10, burn=2)
            out["para"][two] = _para_record(p)
        try:
            _para(3, gmesh)
            out["para_indivisible"] = None
        except ValueError as err:
            out["para_indivisible"] = str(err)
    if world == 4:
        s = _sampler("cascade", "device", nw=STAT_NW, seed=STAT_SEED)
        start = _start(STAT_NT, STAT_NW, seed=4)
        s.run_mcmc(shard_state(et.State({"model_0": start}), make_mesh(4)),
                   STAT_STEPS, burn=STAT_BURN)
        out["stat"] = _stat_summary(s)
    return out


def _stat_summary(s):
    chain = np.asarray(s.get_chain()["model_0"][:, 0]).reshape(-1, NDIM)
    tau = float(np.nanmax(np.asarray(
        s.backend.get_autocorr_time()["model_0"])))
    return dict(acc=float(np.mean(s.acceptance_fraction)),
                swap=np.asarray(s.swap_acceptance_fraction, dtype=float),
                mean=chain.mean(axis=0), std=chain.std(axis=0),
                logl=float(np.asarray(s.get_log_like()[:, 0]).mean()),
                n_eff=chain.shape[0] / max(2.0 * tau, 1.0))


class _Spawns:
    """Each world size spawned once, the four at the same time, in the
    background; ``spawns[world]`` waits for that size's ranks' results."""

    def __init__(self, worlds=(1, 2, 4, 8)):
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
    out = {(scheme, backend): _chain(scheme, backend,
                                     et.State({"model_0": _start()}))
           for scheme in SCHEMES for backend in ("host", "device")}
    for scheme in SCHEMES:
        out[scheme, "odd"] = _chain(
            scheme, "host", et.State({"model_0": _start(nw=NW_ODD)}),
            nw=NW_ODD)
    return out


def test_sharded_run_matches_eryn_tpu_statistically(ranks):
    """A (2, 2)-sharded port run against ``eryn_tpu``'s sharded run
    (``make_mesh(8)``) at ``tests/test_sharding.py``'s sizes (64 walkers, 4
    temperatures, 3-D, 1,000 stored steps after 200): posterior moments and
    the cold log-likelihood within 4 IACT-corrected standard errors, the
    acceptance and each rung's swap rate within 4 binomial standard errors
    inflated by 2, as that test holds its two runs."""
    import jax
    import jax.numpy as jnp

    import eryn_tpu
    from eryn_tpu.parallel.mesh import make_mesh as jmake_mesh
    from eryn_tpu.parallel.mesh import shard_state as jshard_state

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    pr = eryn_tpu.ProbDistContainer({i: eryn_tpu.uniform_dist(-5, 5)
                                     for i in range(NDIM)})
    ens = eryn_tpu.EnsembleSampler(
        STAT_NW, NDIM, lambda x: -0.5 * jnp.sum(x ** 2), pr,
        tempering_kwargs=dict(ntemps=STAT_NT), seed=STAT_SEED)
    state = ens._setup_state(pr.rvs(size=(STAT_NT, STAT_NW)))
    ens.run_mcmc(jshard_state(state, jmake_mesh(8)), STAT_STEPS,
                 burn=STAT_BURN)
    a = _stat_summary(ens)
    b = ranks[4][0]["stat"]  # the ranks ran while eryn_tpu did
    se_mean = np.sqrt(1.0 / a["n_eff"] + 1.0 / b["n_eff"])
    assert (np.abs(a["mean"] - b["mean"]) / se_mean).max() < 4.0, (a, b)
    se_std = np.sqrt(0.5 / a["n_eff"] + 0.5 / b["n_eff"])
    assert (np.abs(a["std"] - b["std"]) / se_std).max() < 4.0, (a, b)
    se_logl = np.sqrt(1.5 * (1.0 / a["n_eff"] + 1.0 / b["n_eff"]))
    assert abs(a["logl"] - b["logl"]) / se_logl < 4.0, (a, b)
    n_trials = STAT_STEPS * STAT_NW
    p = 0.5 * (a["acc"] + b["acc"])
    assert abs(a["acc"] - b["acc"]) / (
        2.0 * np.sqrt(2.0 * p * (1.0 - p) / n_trials)) < 4.0, (a, b)
    ps = 0.5 * (a["swap"] + b["swap"])
    se_swap = 2.0 * np.sqrt(2.0 * np.clip(ps * (1.0 - ps), 1e-4, None)
                            / n_trials)
    assert (np.abs(a["swap"] - b["swap"]) / se_swap).max() < 4.0, (a, b)


@pytest.mark.parametrize("world", [1, 2, 4, 8])
def test_mesh_shapes_and_errors_match_eryn_tpu(ranks, world):
    """``make_mesh`` and ``make_group_mesh`` at 1, 2, 4 and 8 ranks have the
    shapes and dimension names of ``eryn_tpu``'s over as many of
    conftest's 8 virtual devices, and raise its errors."""
    import jax

    from eryn_tpu.parallel import mesh as jmesh

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    got = ranks[world][0]
    assert got["shapes"] == {
        "default": dict(jmesh.make_mesh(world).shape),
        "temp1": dict(jmesh.make_mesh(world, temp_parallel=1).shape),
        "group": dict(jmesh.make_group_mesh(world).shape),
    }
    for rank in ranks[world]:
        assert rank["shapes"] == got["shapes"]
    assert "Requested mesh over" in got["errors"]["too_many"]
    if world % 3:
        with pytest.raises(ValueError) as jerr:
            jmesh.make_mesh(world, temp_parallel=3)
        assert got["errors"]["indivisible"] == str(jerr.value)


def test_placement_matches_spec_for_leaf():
    """Each leaf's partition spec is ``eryn_tpu``'s ``_spec_for_leaf`` on
    the same state: evaluated (with blobs and a supplemental) and before
    evaluation."""
    from eryn_tpu.parallel.mesh import _spec_for_leaf

    rng = np.random.default_rng(0)
    evaluated = et.State(
        {"a": torch.zeros(NT, NW, 2, NDIM), "b": torch.zeros(NT, NW, 1, 2)},
        log_like=torch.zeros(NT, NW), log_prior=torch.zeros(NT, NW),
        betas=torch.ones(NT), blobs=torch.zeros(NT, NW, 3),
        supplemental={"s": torch.from_numpy(rng.random((NT, NW)))})
    pre = et.State({"a": torch.zeros(NT, NW, 2, NDIM)})
    for state in (evaluated, pre):
        sharding = sharding_for_state(state, mesh=None)
        assert (sharding.ntemps, sharding.nwalkers) == (NT, NW)
        leaves = state.tensor_leaves()
        assert set(sharding.specs) == {p for p, _ in leaves}
        for path, x in leaves:
            want = tuple(_spec_for_leaf(np.zeros(tuple(x.shape)), NT, NW))
            assert sharding.specs[path] == want, path


@pytest.mark.parametrize("world", [2, 4, 8])
def test_shard_state_keeps_the_ranks_shard(ranks, world):
    """``shard_state`` keeps each rank's block on its device, evaluated or
    not; ``mesh_of_state`` finds the mesh (None for a plain state and on
    one rank); ``constrain_state`` accepts the shard and refuses a leaf of
    the wrong shape."""
    tp, wp = MESHES[world][0]
    for rank, got in enumerate(ranks[world]):
        shape, t0, w0 = got["local_shapes"]
        assert shape == (NT // tp, NW // wp, 1, NDIM)
        assert (t0, w0) == ((rank // wp) * (NT // tp), (rank % wp) * (NW // wp))
        assert got["pre_shape"] == shape
        assert got["mesh_of_state"] is True
        assert got["plain_mesh_of_state"] is None
        assert "leading dims" in got["constrain_bad"]
    assert ranks[1][0]["one_rank_mesh"] is None


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("mesh", [(1, 2), (2, 1), (2, 2), (2, 4)])
def test_sharded_chain_equals_one_rank(ranks, one_rank, mesh, scheme):
    """Stretch with the kernel cascade, and DEO with the Syed ladder, on a
    sharded state equal the one-rank run digit for digit: chain, masks,
    log-likelihood and log-prior, ladder, acceptance and swap fractions,
    through ``Backend`` and ``DeviceBackend`` getters (a step's slice, a
    temperature, the last sample, the device IACT), on every rank."""
    world = mesh[0] * mesh[1]
    for backend in ("host", "device"):
        ref = one_rank[scheme, backend]
        for rank in ranks[world]:
            got = rank["chains"][mesh, scheme, backend]
            assert set(got) == set(ref)
            for key in ref:
                np.testing.assert_array_equal(got[key], ref[key],
                                              err_msg=f"{backend} {key}")


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("mesh", [(1, 2), (2, 1)])
def test_sharded_chain_equals_one_rank_at_odd_widths(ranks, one_rank, mesh,
                                                     scheme):
    """The same at 18 walkers (shards of 9 and 18 walkers, whose rows of
    leaf masks are not whole words): the packed rows of the exchanges
    unpack into every dtype."""
    for rank in ranks[2]:
        got = rank["chains"][mesh, scheme, "odd"]
        for key, ref in one_rank[scheme, "odd"].items():
            np.testing.assert_array_equal(got[key], ref, err_msg=key)


@pytest.mark.parametrize("world", [2, 4])
def test_group_mesh_equals_one_rank(ranks, world):
    """``ParaEnsembleSampler(mesh=make_group_mesh(n))``: each rank runs its
    groups, and the getters return every group in global order, equal to
    the one-process runner's digit for digit, with one move and with two
    moves that each group draws; ``ngroups`` must divide by the mesh."""
    for two in (False, True):
        p = _para(GROUPS[world], two_moves=two)
        p.run_mcmc(_para_start(GROUPS[world]), 10, burn=2)
        ref = _para_record(p)
        for rank in ranks[world]:
            got = rank["para"][two]
            for key in ref:
                np.testing.assert_array_equal(got[key], ref[key],
                                              err_msg=f"{two} {key}")
    assert "must be divisible by the group-mesh size" in (
        ranks[world][0]["para_indivisible"])


def test_unsupported_configurations_raise_under_a_mesh(ranks):
    """What has no sharded form raises a ``NotImplementedError`` that names
    it at set-up: a subclass of a sharded move (``MHMove``) that does not
    declare itself sharded (its draws may not go through ``rank_draw``).
    A host move (Eryn's NumPy ``get_proposal``), a periodic stretch, the
    general cascade, blobs, a host likelihood, ``HDFBackend`` and the
    ``run_mcmc`` hooks run sharded (``tests/test_torch_mesh_surface.py``
    holds each to its one-rank chain).  Reversible jump, the
    red/blue family (``tests/test_torch_mesh_rj.py``: the port matches
    ``eryn_tpu``'s ``test_sharded_rbgroupstretch_rj``,
    ``test_sharded_rj_group_run``, ``test_sharded_new_move_family`` and
    ``test_rj_deo_mesh_traffic_bounded``) and the rest of the zoo
    (``tests/test_torch_mesh_zoo.py``: ``eryn_tpu``'s
    ``test_sharded_slice_move`` among them) run sharded."""
    for rank in ranks[2]:
        got = rank["refusals"]
        assert got["MHMove subclass"] is not None
        assert ("KernelWalk" in got["MHMove subclass"]
                and "device mesh" in got["MHMove subclass"]), got
        for case in ("host move", "StretchMove(periodic)", "general cascade",
                     "blobs", "host likelihood", "HDFBackend", "hooks"):
            assert got[case] is None, (case, got[case])
