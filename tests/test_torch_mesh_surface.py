"""The rest of the sampler's surface on the port's device mesh
(``eryn_tpu_torch.parallel.mesh``): the general swap cascade, the general
path of ``StretchMove``, blobs and supplementals, host likelihoods, priors
and moves, ``HDFBackend`` with resume, a chain continued across a change of
placement, and the ``run_mcmc`` hooks, against one-rank chains and against
``eryn_tpu``.

The port's mesh is explicit SPMD: one process per device over
``torch.distributed``.  Here each world size (2 and 4 ranks) is spawned
once on the CPU (gloo, ``file://`` rendezvous, a time limit on the whole
spawn) and runs every configuration of that size in its ranks, on the
``(1, 2)`` and ``(2, 1)`` meshes of two ranks and the ``(2, 2)`` mesh of
four; the tests read the ranks' results.  The ranks import this module, so
it imports ``jax`` and ``eryn_tpu`` only inside the tests.

Tolerances: a sharded chain draws every random array at its global shape
from the same generators as one process (the host moves' NumPy generator
too) and keeps its rows, and computes every ensemble statistic from the
gathered rows with the same calls on the same shapes, so on every mesh it
equals the one-rank eager chain digit for digit (bitwise), through every
getter of ``Backend``, ``DeviceBackend`` and ``HDFBackend``, the move
counters, the blobs, the supplementals and the kernel states (a rank holds
a kernel state's rows of its temperatures).  Against ``eryn_tpu``, which
draws from another generator, the checks are invariants held in both
packages on the same numpy starts: the getters' shapes and finite
log-likelihoods, and for the general cascade the cold chain's moments of
the 2-D unit Gaussian (mean within 0.15 of 0, variance within 0.25 of 1)
after the same number of steps; HDF5 files cross both ways.
"""

import os
import tempfile
from multiprocessing.pool import ThreadPool

import numpy as np
import pytest
import scipy.stats
import torch

import eryn_tpu_torch as et
from eryn_tpu_torch.moves import (
    AIMHMove,
    CombineMove,
    GaussianMove,
    MALAMove,
    MHMove,
    SliceMove,
    StretchMove,
)
from eryn_tpu_torch.moves.legacy import stretch_get_proposal
from eryn_tpu_torch.parallel import make_mesh, shard_state
from eryn_tpu_torch.parallel._spawn import launch
from eryn_tpu_torch.utils import AdjustStretchProposalScale
from eryn_tpu_torch.utils.stopping import AutoCorrelationStop

NT, NW, NDIM = 4, 16, 2
STEPS, BURN = 6, 2
MESHES = {2: [(1, 2), (2, 1)], 4: [(2, 2)]}
PERIOD = 2 * np.pi
# the general cascade's moments: 2-D unit Gaussian, 32 walkers, 2
# temperatures
MOMENTS = dict(nw=32, nt=2, steps=300, burn=100, seed=12)
# the files that cross between the packages: 3 + 3 stored steps
FILE_STEPS = 3


def _ll(x):
    return -0.5 * torch.sum(x * x)


def _ll2(coords, inds):
    return -0.5 * (torch.sum(coords["a"] ** 2) + torch.sum(coords["b"] ** 2))


def _ll_blobs(x, supps):
    y = x / supps["sigma"]
    ll = -0.5 * torch.sum(y * y)
    return ll, torch.stack([-2.0 * ll, x[0]])


def _np_ll(x):
    return -0.5 * float(np.sum(np.asarray(x) ** 2))


def _np_ll_rows(x):
    return -0.5 * np.sum(np.asarray(x) ** 2, axis=-1)


class _HostWalk(MHMove):
    """A legacy host move: Eryn's NumPy ``get_proposal`` (the MH family)."""

    def get_proposal(self, branches_coords, random, branches_inds=None,
                     **kwargs):
        q = {n: np.asarray(c) + 0.5 * random.randn(*np.shape(c))
             for n, c in branches_coords.items()}
        return q, np.zeros(next(iter(q.values())).shape[:2])


class _HostStretch(StretchMove):
    """A legacy host move of the red/blue family."""

    def get_proposal(self, s_all, c_all, random, gibbs_ndim=None, **kwargs):
        return stretch_get_proposal(self, s_all, c_all, random,
                                    gibbs_ndim=gibbs_ndim)


class _Stop:
    """``AutoCorrelationStop`` or six stored steps, whichever comes first;
    it reads the getters at every call."""

    def __init__(self):
        self.auto = AutoCorrelationStop()
        self.calls = []

    def __call__(self, i, state, sampler):
        auto = self.auto(i, state, sampler)
        n = sampler.get_chain()["model_0"].shape[0]
        self.calls.append((i, n, bool(auto)))
        return auto or n >= 6


class _PlotProbe:
    """A plot generator that reads the getters it would plot from."""

    def __init__(self, backend):
        self.backend = backend
        self.fires = []

    def generate_plot_info(self, burn=0, thin=1):
        b = self.backend
        chain = b.get_chain(discard=burn, thin=thin)["model_0"]
        self.fires.append((chain.shape[0], float(np.sum(chain)),
                           float(np.sum(b.get_log_like())),
                           float(np.sum(b.accepted))))


def _priors(ndim=NDIM, lo=-3.0, hi=3.0):
    return et.ProbDistContainer({i: et.uniform_dist(lo, hi)
                                 for i in range(ndim)})


def _backend(kind, path=None):
    if kind == "device":
        return et.DeviceBackend()
    if kind == "hdf":
        return et.HDFBackend(path)
    return et.Backend()


def _gibbs():
    return [("model_0", np.array([[True, False]])),
            ("model_0", np.array([[False, True]]))]


# every case: (sampler keywords, start kind); the sampler is built with
# the tempering ``tk`` unless the case gives its own
CASES = {
    "cascade(permute=False)": dict(
        moves=lambda: StretchMove(use_kernels=True),
        tk=dict(permute=False)),
    "cascade(use_kernels=False)": dict(
        moves=lambda: StretchMove(use_kernels=True),
        tk=dict(use_kernels=False)),
    "stretch(periodic)": dict(
        moves=lambda: StretchMove(periodic={"model_0": {0: PERIOD}}),
        priors=lambda: et.ProbDistContainer({
            0: et.uniform_dist(0.0, PERIOD), 1: et.uniform_dist(-3.0, 3.0)}),
        start="periodic"),
    "stretch(gibbs)": dict(
        moves=lambda: StretchMove(gibbs_sampling_setup=_gibbs())),
    "stretch(nsplits=4)": dict(moves=lambda: StretchMove(nsplits=4)),
    "stretch(fixed split)": dict(
        moves=lambda: StretchMove(randomize_split=False)),
    "stretch(branch subset)": dict(
        moves=lambda: [StretchMove(proposal_branch_names=["a"]),
                       StretchMove(proposal_branch_names=["b"])],
        branches=True),
    "blobs(cascade)": dict(blobs=True),
    "blobs(general)": dict(blobs=True, tk=dict(use_kernels=False),
                           moves=lambda: [StretchMove(), GaussianMove(
                               {"model_0": 0.4})]),
    "blobs(deo)": dict(blobs=True, tk=dict(swap_scheme="deo",
                                           adaptation_scheme="syed")),
    "host(per walker)": dict(
        log_like=_np_ll,
        priors=lambda: et.ProbDistContainer({
            0: scipy.stats.norm(0.0, 1.5), 1: et.uniform_dist(-3.0, 3.0)}),
        moves=lambda: [(StretchMove(use_kernels=True), 0.7),
                       (_HostWalk(), 0.3)]),
    "host(vectorized)": dict(log_like=_np_ll_rows, vectorize=True,
                             moves=lambda: [(StretchMove(), 0.6),
                                            (_HostStretch(), 0.4)]),
    "host(pooled)": dict(log_like=_np_ll, pool=True),
}
RUNS = tuple(CASES) + ("hdf", "hdf-resume", "placement(host)",
                       "placement(device)", "placement(hdf)", "hooks")


def _tuned_moves():
    """Moves whose kernel states a rank holds in three ways: whole with a
    length that could pass for the rank's rung count (MALA's ``eps=None``
    base, ``(NDIM,)``, and ``NDIM`` is the rung count of a ``(2, 2)``
    mesh's rank), by rung (AIMH's moments) and by rung and walker behind a
    leading axis (a ``CombineMove``'s per-member counts, ``(2, nt,
    nw)``)."""
    return [(MALAMove(tune_steps=6), 0.4), (AIMHMove(df=5, tune_steps=6), 0.3),
            (CombineMove([StretchMove(), GaussianMove({"model_0": 0.4})]),
             0.3)]


def _sampler(name, backend="host", path=None, seed=7):
    case = CASES.get(name, {})
    tk = dict(ntemps=NT, use_kernels=True)
    tk.update(case.get("tk", {}))
    kw = dict(tempering_kwargs=tk, seed=seed, device="cpu",
              backend=_backend(backend, path))
    if "moves" in case:
        kw["moves"] = case["moves"]()
    if name == "hdf-resume":
        kw["moves"] = [StretchMove(use_kernels=True),
                       SliceMove(tune_steps=3)]
    if name.startswith("placement"):
        kw["moves"] = _tuned_moves()
    if name == "hooks":
        kw.update(moves=StretchMove(use_kernels=True),
                  update_fn=AdjustStretchProposalScale(), update_iterations=2,
                  stopping_fn=_Stop(), stopping_iterations=2)
    if case.get("pool"):
        kw["pool"] = ThreadPool(2)
    if case.get("vectorize"):
        kw["vectorize"] = True
    if case.get("branches"):
        return et.EnsembleSampler(
            NW, {"a": NDIM, "b": NDIM}, _ll2,
            {"a": _priors(), "b": _priors()}, branch_names=["a", "b"], **kw)
    if case.get("blobs"):
        kw["provide_supplemental"] = True
        return et.EnsembleSampler(NW, NDIM, _ll_blobs, _priors(), **kw)
    priors = case["priors"]() if "priors" in case else _priors()
    s = et.EnsembleSampler(NW, NDIM, case.get("log_like", _ll), priors, **kw)
    if name == "hooks":
        s.plot_generator, s.plot_iterations = _PlotProbe(s.backend), 2
    return s


def _start(name):
    rng = np.random.default_rng(1)
    case = CASES.get(name, {})
    if case.get("branches"):
        return et.State({n: torch.from_numpy(rng.uniform(
            -2, 2, (NT, NW, 1, NDIM)).astype(np.float32)) for n in "ab"})
    coords = rng.uniform(-2, 2, (NT, NW, 1, NDIM)).astype(np.float32)
    if case.get("start") == "periodic":
        coords[..., 0] = rng.uniform(0.1, PERIOD - 0.1, (NT, NW, 1))
    if not case.get("blobs"):
        return et.State({"model_0": torch.from_numpy(coords)})
    objs = np.empty((NT, NW), dtype=object)
    objs[...] = [[("walker", t * NW + w) for w in range(NW)]
                 for t in range(NT)]
    supp = et.BranchSupplemental({
        "rid": torch.arange(NT * NW).reshape(NT, NW), "obj": objs})
    sigma = et.BranchSupplemental({"sigma": torch.ones((NT, NW))})
    return et.State({"model_0": torch.from_numpy(coords)},
                    supplemental=supp, branch_supplemental={"model_0": sigma})


def _leaves(tree, prefix=""):
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.detach().cpu().numpy()}
    items = (tree.items() if isinstance(tree, dict)
             else enumerate(tree) if isinstance(tree, (list, tuple)) else ())
    out = {}
    for k, v in items:
        out.update(_leaves(v, f"{prefix}/{k}"))
    return out


def _record(s):
    """Every getter a run is compared on, the move counters, the kernel
    states, and the blobs and supplementals of the last state (``local/``:
    the rank's rows of a per-walker leaf)."""
    out = {}
    for n in s.branch_names:
        out[f"chain/{n}"] = s.get_chain()[n]
        out[f"cold/{n}"] = s.get_chain(temp_index=0)[n]
        out[f"inds/{n}"] = s.get_inds()[n]
    out.update(log_like=s.get_log_like(), log_prior=s.get_log_prior(),
               betas=s.get_betas(), acc=s.acceptance_fraction,
               swaps=s.swap_acceptance_fraction,
               last=s.get_last_sample().log_like.numpy(),
               iteration=s.backend.iteration)
    info = s.backend.move_info or {}
    for key, v in info.items():
        out[f"move_info/{key}"] = v["acceptance_fraction"]
    blobs = s.get_blobs()
    if blobs is not None:
        out["blobs"] = blobs
    for j, m in enumerate(s._all_move_list):
        out[f"local/moves/{j}/accepted"] = m.accepted
        out[f"moves/{j}/proposals"] = m.num_proposals
        for k, v in _leaves(m.kernel_state).items():
            out[f"kernel/{j}{k}"] = v
    last = s._previous_state
    supp = last.supplemental
    if supp is not None:
        for k, v in supp.holder.items():
            out[f"local/supp/{k}"] = v.numpy()
        for k, v in supp.host_holder.items():
            out[f"supp_host/{k}"] = np.asarray([str(x) for x in v.ravel()])
    return out


def _run(name, backend, state, mesh=None, path=None):
    """One configuration's run: ``state`` whole, sharded over ``mesh``
    where given (the placement cases switch between the two)."""
    def place(st):
        return st if mesh is None else shard_state(st, mesh)

    if name == "hdf-resume":
        s = _sampler(name, "hdf", path)
        s.run_mcmc(place(state), STEPS // 2, burn=BURN)
        s = _sampler(name, "hdf", path, seed=99)  # the file's generators
        s.run_mcmc(place(s.get_last_sample()), STEPS - STEPS // 2)
        return _record(s)
    if name.startswith("placement"):
        # whole, sharded, whole; a file sharded, whole, sharded (a file
        # shared by several ranks is laid out by a sharded run)
        kind = name[len("placement("):-1]
        s = _sampler(name, kind, path)
        ways = (place, lambda st: st)[::-1 if kind != "hdf" else 1]
        s.run_mcmc(ways[0](state), 3, burn=BURN)
        s.run_mcmc(ways[1](s.get_last_sample()), 3)
        s.run_mcmc(ways[0](s.get_last_sample()), 3)
        return _record(s)
    s = _sampler(name, "hdf" if name == "hdf" else backend, path)
    s.run_mcmc(place(state), 10 if name == "hooks" else STEPS, burn=BURN)
    out = _record(s)
    if name == "hooks":
        out["stop_calls"] = np.asarray(s.stopping_fn.calls)
        out["plot_fires"] = np.asarray(s.plot_generator.fires)
        out["a"] = s.moves[0].a
    return out


def _backends(name):
    return ("host", "device") if name in CASES else ("host",)


def _shared_dir():
    """A fresh temporary directory of rank 0's, on every rank."""
    import torch.distributed as dist

    box = [tempfile.mkdtemp(prefix="eryn_mesh_surface_")]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _moment_start():
    f = MOMENTS
    return np.random.default_rng(f["seed"]).uniform(
        -2.0, 2.0, (f["nt"], f["nw"], 1, NDIM)).astype(np.float32)


def _moments(chain):
    cold = np.asarray(chain)[:, 0].reshape(-1, NDIM)
    return cold.mean(axis=0), cold.var(axis=0)


def _moment_run(mesh):
    """The north-star target's stretch with the general cascade
    (``permute=False``), sharded: the cold chain's mean and variance."""
    f = MOMENTS
    s = et.EnsembleSampler(
        f["nw"], NDIM, _ll, _priors(NDIM, -5.0, 5.0),
        tempering_kwargs=dict(ntemps=f["nt"], permute=False),
        seed=f["seed"], device="cpu", backend=et.DeviceBackend())
    s.run_mcmc(shard_state(et.State({"model_0": torch.from_numpy(
        _moment_start())}), mesh), f["steps"], burn=f["burn"])
    return _moments(s.get_chain()["model_0"])


def _file_runs(mesh, theirs):
    """A port file written sharded (for ``eryn_tpu`` to resume), and
    ``eryn_tpu``'s file ``theirs`` resumed sharded: its shapes and
    log-likelihoods after."""
    path = os.path.join(_shared_dir(), "port.h5")
    s = et.EnsembleSampler(NW, NDIM, _ll, _priors(), seed=5, device="cpu",
                           tempering_kwargs=dict(ntemps=NT), backend=path)
    s.run_mcmc(shard_state(_start("hdf"), mesh), FILE_STEPS)
    resumed = et.EnsembleSampler(NW, NDIM, _ll, _priors(), seed=6,
                                 device="cpu",
                                 tempering_kwargs=dict(ntemps=NT),
                                 backend=theirs)
    before = resumed.backend.iteration
    resumed.run_mcmc(shard_state(resumed.get_last_sample(), mesh),
                     FILE_STEPS)
    return dict(port_file=path, resumed=(
        before, resumed.backend.iteration,
        tuple(resumed._previous_state.log_like.shape),
        resumed.get_log_like()))


def _tuned_file(path, mesh=None):
    """The tuned moves' first half written to the file ``path``, sharded
    over ``mesh`` where given."""
    s = et.EnsembleSampler(NW, NDIM, _ll, _priors(), seed=8, device="cpu",
                           tempering_kwargs=dict(ntemps=NT),
                           backend=et.HDFBackend(path), moves=_tuned_moves())
    state = _start("hdf")
    s.run_mcmc(state if mesh is None else shard_state(state, mesh),
               STEPS // 2, burn=BURN)
    return path


def _tuned_resume(path):
    """The kernel states stored in the file ``path``, and the record of
    its second half resumed in this process (where the stored kernel
    states do not fit the moves, the warning fails it)."""
    import warnings

    stored = et.HDFBackend(path).get_kernel_states()
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message="Stored move kernel states")
        s = et.EnsembleSampler(NW, NDIM, _ll, _priors(), seed=99,
                               device="cpu", tempering_kwargs=dict(ntemps=NT),
                               backend=et.HDFBackend(path),
                               moves=_tuned_moves())
        s.run_mcmc(s.get_last_sample(), STEPS - STEPS // 2)
    return stored, _record(s)


def _refusal(mesh, nt, nw):
    """The error each rank raises for an ensemble that does not split
    over ``mesh``."""
    s = et.EnsembleSampler(nw, NDIM, _ll, _priors(), seed=3, device="cpu",
                           tempering_kwargs=dict(ntemps=nt))
    state = et.State({"model_0": torch.zeros((nt, nw, 1, NDIM))})
    try:
        s.run_mcmc(shard_state(state, mesh), 2)
    except ValueError as err:
        return str(err)
    return None


def _rank_main(rank, world, theirs):
    """Every configuration of one world size, in each rank."""
    import warnings

    out = {"chains": {}, "refusal": {}, "tuned": {}}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the host side's warnings
        for tp, wp in MESHES[world]:
            mesh = make_mesh(world, temp_parallel=tp)
            folder = _shared_dir()
            for name in RUNS:
                for backend in _backends(name):
                    path = os.path.join(folder, f"{name}-{backend}.h5")
                    out["chains"][(tp, wp), name, backend] = _run(
                        name, backend, _start(name), mesh, path)
            out["refusal"][tp, wp] = _refusal(mesh, 3, NW - 1)
            out["tuned"][tp, wp] = _tuned_file(
                os.path.join(folder, "tuned.h5"), mesh)
        if world == 4:
            out["moments"] = _moment_run(mesh)
            out["files"] = _file_runs(mesh, theirs)
    return out


def _eryn_tpu_file(path):
    """``eryn_tpu`` writes a file from a run sharded over its 8 virtual
    devices."""
    import jax.numpy as jnp

    import eryn_tpu
    from eryn_tpu.backends import HDFBackend as JaxHDFBackend
    from eryn_tpu.parallel.mesh import make_mesh as jmake_mesh
    from eryn_tpu.parallel.mesh import shard_state as jshard_state

    pr = eryn_tpu.ProbDistContainer({i: eryn_tpu.uniform_dist(-3, 3)
                                     for i in range(NDIM)})
    ens = eryn_tpu.EnsembleSampler(
        NW, NDIM, lambda x: -0.5 * jnp.sum(x ** 2), pr,
        tempering_kwargs=dict(ntemps=NT), seed=4,
        backend=JaxHDFBackend(path))
    start = _start("hdf").branches["model_0"].coords.numpy()
    state = ens._setup_state(eryn_tpu.State({"model_0": start}))
    ens.run_mcmc(jshard_state(state, jmake_mesh(8)), FILE_STEPS)
    return ens


class _Spawns:
    """Each world size spawned once, both at the same time, in the
    background (the four ranks after ``eryn_tpu`` has written the file
    they resume); ``spawns[world]`` waits for that size's ranks'
    results."""

    def __init__(self, theirs):
        from concurrent.futures import ThreadPoolExecutor

        self.theirs = theirs
        self.pool = ThreadPoolExecutor(2)
        self.runs = {2: self.pool.submit(launch, _rank_main, 2, theirs,
                                         timeout=240),
                     4: self.pool.submit(self._four)}

    def _four(self):
        _eryn_tpu_file(self.theirs)
        return launch(_rank_main, 4, self.theirs, timeout=240)

    def __getitem__(self, world):
        return self.runs[world].result()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    spawns = _Spawns(str(tmp_path_factory.mktemp("jax") / "jax.h5"))
    yield spawns
    spawns.pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """The one-process chains the sharded ones must equal."""
    import warnings

    folder = tmp_path_factory.mktemp("one_rank")
    out = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for name in RUNS:
            for backend in _backends(name):
                path = str(folder / f"{name}-{backend}.h5")
                out[name, backend] = _run(name, backend, _start(name),
                                          path=path)
    return out


@pytest.fixture(scope="module")
def tuned_one_rank(tmp_path_factory):
    """The tuned moves' file written and resumed in one process."""
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        path = _tuned_file(str(tmp_path_factory.mktemp("tuned") / "t.h5"))
    return _tuned_resume(path)


def _rank_layout(mesh, rank):
    tp, wp = mesh
    nt, nw = NT // tp, NW // wp
    ti, wi = divmod(rank, wp)
    return ti * nt, nt, wi * nw, nw


def _assert_same(got, ref, label, layout):
    """``got`` equals ``ref`` array by array: a ``local/`` leaf and a
    per-rung kernel-state leaf are compared with the reference's rows of
    the rank's temperatures (and walkers)."""
    t0, nt, w0, nw = layout
    assert set(got) == set(ref), (label, set(got) ^ set(ref))
    for key, r in ref.items():
        g = got[key]
        if r is None:
            assert g is None, (label, key)
            continue
        r = np.asarray(r)
        if key.startswith("local/") and r.shape != np.shape(g):
            r = r[t0:t0 + nt, w0:w0 + nw]
        if key.startswith("kernel/") and r.shape != np.shape(g):
            r = r[t0:t0 + nt] if r.shape[0] == NT else r[
                :, t0:t0 + nt, w0:w0 + nw]
        np.testing.assert_array_equal(g, r, err_msg=f"{label} {key}")


@pytest.mark.parametrize("mesh", [(1, 2), (2, 1), (2, 2)])
@pytest.mark.parametrize("name", RUNS)
def test_sharded_chain_equals_one_rank(ranks, one_rank, name, mesh):
    """Each configuration, on a state sharded over the mesh, equals the
    one-rank eager run digit for digit on every rank: chain, cold chain,
    masks, log-likelihood, log-prior, ladder, acceptance and swap
    fractions, the last sample, the move counters and acceptance
    fractions, the kernel states, the blobs and the supplementals (the
    host objects reordered by the swaps), through ``Backend`` and
    ``DeviceBackend`` (``HDFBackend`` for the file cases; the hooks also
    in their calls, the plot generator's reads and the tuned scale)."""
    world = mesh[0] * mesh[1]
    for backend in _backends(name):
        ref = one_rank[name, backend]
        for rank, r in enumerate(ranks[world]):
            _assert_same(r["chains"][mesh, name, backend], ref,
                         f"{mesh} {name} {backend} rank {rank}",
                         _rank_layout(mesh, rank))


def test_stopping_and_plot_hooks_fired_on_every_rank(ranks, one_rank):
    """The hooks ran: ``stopping_fn`` stopped the run at six stored steps
    on every rank alike (the writer rank's decision), the plot generator
    fired every two stored steps, and ``AdjustStretchProposalScale`` moved
    the stretch scale from 2."""
    ref = one_rank["hooks", "host"]
    assert ref["iteration"] == 6 and ref["a"] != 2.0
    assert [int(n) for _, n, _ in ref["stop_calls"]] == [2, 4, 6]
    assert len(ref["plot_fires"]) == 3
    for world in (2, 4):
        for r in ranks[world]:
            for mesh in MESHES[world]:
                assert r["chains"][mesh, "hooks", "host"]["iteration"] == 6


def test_blobs_and_host_objects_shapes(ranks, one_rank):
    """``get_blobs()`` is ``(nsteps, ntemps, nwalkers, 2)`` on every rank,
    and the host objects followed their walkers through the swaps (a
    permutation of the start's)."""
    start = sorted(str(("walker", i)) for i in range(NT * NW))
    for world in (2, 4):
        for r in ranks[world]:
            for mesh in MESHES[world]:
                got = r["chains"][mesh, "blobs(cascade)", "host"]
                assert got["blobs"].shape == (STEPS, NT, NW, 2)
                assert sorted(got["supp_host/obj"]) == start
                assert list(got["supp_host/obj"]) != start


def test_invariants_as_eryn_tpu(ranks):
    """On the same numpy starts, ``eryn_tpu`` sharded over its 8 virtual
    devices stores the getters' shapes the port stores (chain, log-like,
    blobs), with finite log-likelihoods in both, for the general cascade,
    the periodic stretch, blobs and a NumPy likelihood with a SciPy
    prior."""
    import jax
    import jax.numpy as jnp

    import eryn_tpu
    from eryn_tpu.parallel.mesh import make_mesh as jmake_mesh
    from eryn_tpu.parallel.mesh import shard_state as jshard_state

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    from eryn_tpu.moves import StretchMove as JStretch
    from eryn_tpu.utils import PeriodicContainer

    def jll_blobs(x):
        ll = -0.5 * jnp.sum(x * x)
        return ll, jnp.stack([-2.0 * ll, x[0]])

    uni = {i: eryn_tpu.uniform_dist(-3, 3) for i in range(NDIM)}
    cases = {
        "cascade(permute=False)": dict(
            tk=dict(permute=False), log_like=lambda x: -0.5 * jnp.sum(x * x)),
        "stretch(periodic)": dict(
            moves=JStretch(periodic=PeriodicContainer(
                {"model_0": {0: PERIOD}})),
            priors={0: eryn_tpu.uniform_dist(0.0, PERIOD),
                    1: eryn_tpu.uniform_dist(-3, 3)},
            log_like=lambda x: -0.5 * jnp.sum(x * x)),
        "blobs(cascade)": dict(log_like=jll_blobs),
        "host(per walker)": dict(
            log_like=_np_ll,
            priors={0: scipy.stats.norm(0.0, 1.5),
                    1: eryn_tpu.uniform_dist(-3, 3)}),
    }
    for name, c in cases.items():
        kw = {"moves": c["moves"]} if "moves" in c else {}
        ens = eryn_tpu.EnsembleSampler(
            NW, NDIM, c["log_like"],
            eryn_tpu.ProbDistContainer(c.get("priors", uni)),
            tempering_kwargs=dict(ntemps=NT, **c.get("tk", {})), seed=5,
            **kw)
        start = _start(name).branches["model_0"].coords.numpy()
        state = ens._setup_state(eryn_tpu.State({"model_0": start}))
        ens.run_mcmc(jshard_state(state, jmake_mesh(8)), STEPS, burn=BURN)
        ours = ranks[4][0]["chains"][(2, 2), name, "host"]
        assert np.shape(ens.get_chain()["model_0"]) == np.shape(
            ours["chain/model_0"]), name
        theirs_ll = np.asarray(ens.get_log_like())
        assert theirs_ll.shape == ours["log_like"].shape, name
        assert np.all(np.isfinite(theirs_ll)), name
        assert np.all(np.isfinite(ours["log_like"])), name
        if "blobs" in ours:
            blobs = np.asarray(ens.get_blobs())
            assert blobs.shape == ours["blobs"].shape == (STEPS, NT, NW, 2)


def test_general_cascade_moments_as_eryn_tpu(ranks):
    """The stretch move with the general cascade (``permute=False``) on the
    2-D unit Gaussian, 32 walkers, 2 temperatures, 300 stored steps after
    100, from the same numpy start: the cold chain's mean is within 0.15 of
    0 and its variance within 0.25 of 1 per parameter, in ``eryn_tpu`` (one
    process) and in the port sharded over its (2, 2) mesh."""
    import jax.numpy as jnp

    import eryn_tpu

    f = MOMENTS
    pr = eryn_tpu.ProbDistContainer({i: eryn_tpu.uniform_dist(-5, 5)
                                     for i in range(NDIM)})
    ens = eryn_tpu.EnsembleSampler(
        f["nw"], NDIM, lambda x: -0.5 * jnp.sum(x ** 2), pr,
        tempering_kwargs=dict(ntemps=f["nt"], permute=False), seed=f["seed"])
    state = ens._setup_state(eryn_tpu.State({"model_0": _moment_start()}))
    ens.run_mcmc(state, f["steps"], burn=f["burn"])
    results = [("eryn_tpu", _moments(ens.get_chain()["model_0"]))]
    results += [(f"port rank {i}", r["moments"])
                for i, r in enumerate(ranks[4])]
    for label, (mean, var) in results:
        assert np.all(np.abs(mean) < 0.15), (label, mean)
        assert np.all(np.abs(var - 1.0) < 0.25), (label, var)


def test_files_cross_both_ways_on_meshes(ranks):
    """A file the port wrote from its (2, 2) mesh opens in ``eryn_tpu``,
    which resumes it sharded over its 8 virtual devices; a file
    ``eryn_tpu`` wrote from that mesh resumes in the port's (2, 2) mesh
    (its shard on every rank, the file grown by the run)."""
    import jax.numpy as jnp

    import eryn_tpu
    from eryn_tpu.backends import HDFBackend as JaxHDFBackend
    from eryn_tpu.parallel.mesh import make_mesh as jmake_mesh
    from eryn_tpu.parallel.mesh import shard_state as jshard_state

    r4 = ranks[4]
    for r in r4:
        before, after, shard, logl = r["files"]["resumed"]
        assert (before, after) == (FILE_STEPS, 2 * FILE_STEPS)
        assert shard == (NT // 2, NW // 2)
        assert logl.shape == (2 * FILE_STEPS, NT, NW)
        assert np.all(np.isfinite(logl))
    path = r4[0]["files"]["port_file"]
    pr = eryn_tpu.ProbDistContainer({i: eryn_tpu.uniform_dist(-3, 3)
                                     for i in range(NDIM)})
    ens = eryn_tpu.EnsembleSampler(
        NW, NDIM, lambda x: -0.5 * jnp.sum(x ** 2), pr,
        tempering_kwargs=dict(ntemps=NT), seed=4,
        backend=JaxHDFBackend(path))
    assert ens.backend.iteration == FILE_STEPS
    state = ens._setup_state(ens.backend.get_last_sample())
    ens.run_mcmc(jshard_state(state, jmake_mesh(8)), FILE_STEPS)
    assert JaxHDFBackend(path).iteration == 2 * FILE_STEPS
    assert np.all(np.isfinite(np.asarray(ens.get_log_like())))
    theirs = et.HDFBackend(path)
    np.testing.assert_array_equal(
        theirs.get_chain()["model_0"][:FILE_STEPS].shape,
        (FILE_STEPS, NT, NW, 1, NDIM))


@pytest.mark.parametrize("mesh", [(1, 2), (2, 1), (2, 2)])
def test_an_ensemble_that_does_not_split_raises_on_every_rank(ranks, mesh):
    """3 temperatures x 15 walkers split over no mesh of these: every rank
    raises the same ``ValueError`` naming the split at set-up, as
    ``eryn_tpu`` fails to place such a state on its mesh (a
    ``ValueError`` from ``device_put``)."""
    world = mesh[0] * mesh[1]
    errs = [r["refusal"][mesh] for r in ranks[world]]
    assert errs[0] is not None and "does not split evenly" in errs[0]
    assert all(e == errs[0] for e in errs)


def test_eryn_tpu_fails_on_an_ensemble_that_does_not_split():
    """``eryn_tpu``'s side of the refusal: 3 temperatures x 16 walkers on
    its ``make_mesh(8)`` raise a ``ValueError``."""
    import jax
    import jax.numpy as jnp

    import eryn_tpu
    from eryn_tpu.parallel.mesh import make_mesh as jmake_mesh
    from eryn_tpu.parallel.mesh import shard_state as jshard_state

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    pr = eryn_tpu.ProbDistContainer({i: eryn_tpu.uniform_dist(-3, 3)
                                     for i in range(NDIM)})
    ens = eryn_tpu.EnsembleSampler(
        NW, NDIM, lambda x: -0.5 * jnp.sum(x ** 2), pr,
        tempering_kwargs=dict(ntemps=3), seed=4)
    state = ens._setup_state(eryn_tpu.State({"model_0": np.zeros(
        (3, NW, 1, NDIM))}))
    with pytest.raises(ValueError):
        jshard_state(state, jmake_mesh(8))


@pytest.mark.parametrize("mesh", [(1, 2), (2, 1), (2, 2)])
def test_sharded_file_resumes_in_one_process(ranks, tuned_one_rank, mesh):
    """A file that a run sharded over the mesh wrote holds the whole
    ensemble's kernel states, each leaf gathered along the axes its move
    declares: bitwise equal to those of the file one process wrote, MALA's
    ``eps=None`` base, AIMH's moments and a ``CombineMove``'s per-member
    counts among them.  Resumed in one process, the file's chain goes on
    as the one-process file's does, digit for digit."""
    stored, rec = _tuned_resume(ranks[mesh[0] * mesh[1]][0]["tuned"][mesh])
    ref_stored, ref_rec = tuned_one_rank
    assert stored[0] == ref_stored[0]
    assert len(stored[1]) == len(ref_stored[1])
    for i, (got, ref) in enumerate(zip(stored[1], ref_stored[1])):
        assert len(got) == len(ref), (mesh, i)
        for j, (g, r) in enumerate(zip(got, ref)):
            label = f"{mesh} kernel state {i} leaf {j}"
            assert np.shape(g) == np.shape(r), label
            np.testing.assert_array_equal(g, r, err_msg=label)
    _assert_same(rec, ref_rec, f"{mesh} resumed", (0, NT, 0, NW))
