"""The rest of the move zoo on the port's device mesh
(``eryn_tpu_torch.parallel.mesh``): the slice move, the gradient moves, the
per-walker MH family, AIMH, multiple-try, delayed rejection, the model swap
and ``CombineMove``, against one-rank chains and against ``eryn_tpu``.

The port's mesh is explicit SPMD: one process per device over
``torch.distributed``.  Here each world size (2 and 4 ranks) is spawned
once on the CPU (gloo, ``file://`` rendezvous, a time limit on the whole
spawn), the two at the same time, and runs every check of that size in its
ranks; the tests read the ranks' results.  The ranks import this module, so
it imports ``jax`` and ``eryn_tpu`` only inside the tests.

Tolerances: a sharded chain draws every random array at its global shape
from the same generator as one process and keeps its rows, and computes
every ensemble statistic from the gathered rows with the same calls on the
same shapes, so on every mesh it equals the one-rank chain digit for digit
(bitwise), through every getter of ``Backend`` and ``DeviceBackend``, the
moves' device counters and their kernel states (a rank holds the kernel
state's rows of its temperatures).  Against ``eryn_tpu``, which draws from
another generator, the checks are invariants held in both packages on the
same numpy starts: ``tests/test_sharding.py::test_sharded_slice_move``'s
(finite log-likelihoods, the state spread over every rank) at its sizes,
and for MALA, HMC and AIMH the cold chain's moments of the 2-D unit
Gaussian (mean within 0.15 of 0, variance within 0.25 of 1) after the same
number of steps.
"""

import numpy as np
import pytest
import torch

import eryn_tpu_torch as et
from eryn_tpu_torch.moves import (
    AIMHMove,
    BasicSymmetricModelSwapRJMove,
    ChEESHMCMove,
    CombineMove,
    DelayedRejection,
    DistributionGenerate,
    GaussianMove,
    HMCMove,
    MALAMove,
    MHMove,
    ModelSwapRJMove,
    MTDistGenMove,
    MTDistGenMoveRJ,
    SliceMove,
)
from eryn_tpu_torch.parallel import make_mesh, shard_state
from eryn_tpu_torch.parallel._spawn import launch

NT, NW, NDIM = 4, 16, 2
STEPS, BURN = 10, 2
MESHES = {2: [(1, 2), (2, 1)], 4: [(2, 2)]}
# the block moves again on four walker shards of 4: a block of 4 (or a
# half of 8) then often holds none of a rank's walkers, which still draws
BLOCK_MOVES = ("SliceMove(nsplits=4)", "MALAMove(precond)",
               "HMCMove(precond)")
BACKENDS = ("host", "device")
NLMAX = 3
# tests/test_sharding.py::test_sharded_slice_move's sizes
SLICE = dict(ndim=3, nw=32, nt=4, steps=20, seed=44)
# the moment checks: 2-D unit Gaussian, 32 walkers, 2 temperatures
MOMENTS = dict(nw=32, nt=2, steps=300, burn=100, seed=12)
MOMENT_MOVES = ("MALAMove", "HMCMove", "AIMHMove")


class WalkMH(MHMove):
    """A user's MH move, sharded by its own declaration: a Gaussian random
    walk, its normals drawn one per walker through ``rank_draw``."""

    _mesh_sharded = True

    def get_proposal_kernel(self, generator, branch_coords, branch_inds,
                            kernel_state, param_masks=None):
        q = {}
        for name, c in branch_coords.items():
            step = self.rank_draw(
                lambda sh: torch.randn(sh, generator=generator,
                                       dtype=c.dtype, device=c.device),
                c.shape, per_walker=True)
            q[name] = c + 0.4 * step
        c = next(iter(q.values()))
        return q, c.new_zeros(c.shape[:2]), kernel_state


def _ll(x):
    return -0.5 * torch.sum(x * x)


def _ll_rj(coords, inds):
    return torch.sum(torch.where(inds, -0.5 * torch.sum(coords ** 2, dim=-1),
                                 0.0))


def _priors(ndim=NDIM, lo=-3.0, hi=3.0):
    return et.ProbDistContainer({i: et.uniform_dist(lo, hi)
                                 for i in range(ndim)})


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


def _moves(name, pr):
    """The in-model moves of the case ``name`` (a fixed-dimension one)."""
    gauss = {"model_0": 0.3}
    return {
        "MHMove": lambda: WalkMH(),
        "GaussianMove": lambda: GaussianMove(gauss, mode="random",
                                             factor=1.5),
        "DistributionGenerate": lambda: DistributionGenerate(
            {"model_0": pr}),
        "AIMHMove": lambda: AIMHMove(df=5, tune_steps=6),
        "AIMHMove(gamma)": lambda: AIMHMove(df=4.5, tune_steps=6),
        "SliceMove": lambda: SliceMove(tune_steps=6),
        "SliceMove(nsplits=4)": lambda: SliceMove(tune_steps=6, nsplits=4),
        "MALAMove": lambda: MALAMove(tune_steps=6),
        "MALAMove(precond)": lambda: MALAMove(ensemble_precondition=True,
                                              tune_steps=6),
        "HMCMove": lambda: HMCMove(num_leapfrog=(2, 4), tune_steps=6),
        "HMCMove(precond)": lambda: HMCMove(
            num_leapfrog=(2, 3), ensemble_precondition=True, tune_steps=6),
        "ChEESHMCMove": lambda: ChEESHMCMove(max_leapfrog=6, tune_steps=6),
        "MultipleTryMove": lambda: MTDistGenMove(
            {"model_0": pr}, num_try=3, independent=False),
        "MTDistGenMove": lambda: MTDistGenMove({"model_0": pr}, num_try=3,
                                               independent=True),
        "DelayedRejection": lambda: DelayedRejection(
            GaussianMove({"model_0": 0.6}), max_iter=2),
        "CombineMove": lambda: CombineMove([
            GaussianMove(gauss), SliceMove(tune_steps=6)]),
    }[name]()


MOVES = ("MHMove", "GaussianMove", "DistributionGenerate", "AIMHMove",
         "AIMHMove(gamma)", "SliceMove", "SliceMove(nsplits=4)", "MALAMove",
         "MALAMove(precond)",
         "HMCMove", "HMCMove(precond)", "ChEESHMCMove", "MultipleTryMove",
         "MTDistGenMove", "MTDistGenMoveRJ", "DelayedRejection",
         "ModelSwapRJMove", "BasicSymmetricModelSwapRJMove", "CombineMove")
SWAPS = ("ModelSwapRJMove", "BasicSymmetricModelSwapRJMove")


def _backend(backend):
    return et.DeviceBackend() if backend == "device" else et.Backend()


def _sampler(name, backend):
    tk = dict(ntemps=NT, use_kernels=True)
    kw = dict(tempering_kwargs=tk, seed=7, device="cpu",
              backend=_backend(backend))
    if name in SWAPS:
        log_like, priors = _swap_problem()
        swap = (ModelSwapRJMove({n: priors[n] for n in ("pulse", "const")})
                if name == "ModelSwapRJMove"
                else BasicSymmetricModelSwapRJMove([1, 1], [0, 0]))
        return et.EnsembleSampler(
            NW, {"pulse": 1, "const": 1}, log_like, priors,
            branch_names=["pulse", "const"],
            nleaves_max={"pulse": 1, "const": 1},
            nleaves_min={"pulse": 0, "const": 0},
            moves=[GaussianMove({"pulse": 0.05, "const": 0.05})],
            rj_moves=[swap], fill_zero_leaves_val=-1e8, **kw)
    pr = _priors()
    if name == "MTDistGenMoveRJ":
        return et.EnsembleSampler(
            NW, NDIM, _ll_rj, pr, nleaves_max=NLMAX, nleaves_min=0,
            moves=GaussianMove({"model_0": 0.3}),
            rj_moves=[MTDistGenMoveRJ(pr, nleaves_max={"model_0": NLMAX},
                                      nleaves_min={"model_0": 0},
                                      num_try=3)],
            fill_zero_leaves_val=-5.0, **kw)
    return et.EnsembleSampler(NW, NDIM, _ll, pr, moves=_moves(name, pr),
                              **kw)


def _start(name):
    rng = np.random.default_rng(1)
    if name in SWAPS:
        pick = rng.random((NT, NW)) < 0.5
        coords = {"pulse": rng.uniform(0.0, 3.0, (NT, NW, 1, 1)),
                  "const": rng.uniform(-1.0, 1.0, (NT, NW, 1, 1))}
        inds = {"pulse": pick[..., None], "const": ~pick[..., None]}
        return et.State({n: torch.from_numpy(c.astype(np.float32))
                         for n, c in coords.items()},
                        inds={n: torch.from_numpy(m)
                              for n, m in inds.items()})
    nl = NLMAX if name == "MTDistGenMoveRJ" else 1
    coords = rng.uniform(-2, 2, (NT, NW, nl, NDIM)).astype(np.float32)
    inds = (rng.random((NT, NW, nl)) < 0.6 if nl > 1
            else np.ones((NT, NW, nl), dtype=bool))
    return et.State({"model_0": torch.from_numpy(coords)},
                    inds={"model_0": torch.from_numpy(inds)})


def _leaves(tree, prefix=""):
    """The tensors of a kernel state, by path."""
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.detach().cpu().numpy()}
    items = (tree.items() if isinstance(tree, dict)
             else enumerate(tree) if isinstance(tree, (list, tuple)) else ())
    out = {}
    for k, v in items:
        out.update(_leaves(v, f"{prefix}/{k}"))
    return out


def _record(s):
    """Every getter a run is compared on, and its moves' device counters
    and kernel states."""
    from eryn_tpu_torch.ensemble import _walk_moves

    out = {}
    for n in s.branch_names:
        out[f"chain/{n}"] = s.get_chain()[n]
        out[f"cold/{n}"] = s.get_chain(temp_index=0)[n]
        if s.has_reversible_jump:
            out[f"inds/{n}"] = s.get_inds()[n]
            out[f"nleaves/{n}"] = s.get_nleaves()[n]
    out.update(log_like=s.get_log_like(), log_prior=s.get_log_prior(),
               betas=s.get_betas(), acc=s.acceptance_fraction,
               swaps=s.swap_acceptance_fraction,
               last=s.get_last_sample().log_like.numpy())
    if s.has_reversible_jump:
        out["rj_acc"] = s.rj_acceptance_fraction
    for j, m in enumerate(_walk_moves(s._all_move_list)):
        for c in ("loop_iterations", "leapfrog_total", "gamma_misses"):
            if getattr(m, c, None) is not None:
                out[f"counter/{j}/{c}"] = getattr(m, c).cpu().numpy()
        for k, v in _leaves(m.kernel_state).items():
            out[f"kernel/{j}{k}"] = v
    return out


def _chain(name, backend, state):
    s = _sampler(name, backend)
    s.run_mcmc(state, STEPS, burn=BURN)
    return _record(s)


def _setup_check(mesh, case):
    """The error each rank raises at set-up, where only rank 1's shard
    breaks the move's check: an inactive leaf under AIMH, two active
    candidates under the model swap."""
    import warnings

    name = {"aimh": "AIMHMove", "swap": "ModelSwapRJMove"}[case]
    state = _start(name)
    lay_w = NW // mesh.shape[1]
    t, w = mesh.shape[0] - 1, min(1, mesh.shape[1] - 1) * lay_w + 3
    if case == "aimh":
        state.branches["model_0"].inds[t, w, 0] = False
    else:
        state.branches["pulse"].inds[t, w, 0] = True
        state.branches["const"].inds[t, w, 0] = True
    s = _sampler(name, "host")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            s.run_mcmc(shard_state(state, mesh), 2)
    except ValueError as err:
        return str(err)
    return None


def _slice_run(mesh):
    """``test_sharded_slice_move``'s configuration in the port, sharded: 20
    steps; returns the shard's shape and its log-likelihoods."""
    f = SLICE
    s = et.EnsembleSampler(
        f["nw"], f["ndim"], _ll, _priors(f["ndim"], -5.0, 5.0),
        moves=SliceMove(), tempering_kwargs=dict(ntemps=f["nt"],
                                                 use_kernels=True),
        seed=f["seed"], device="cpu")
    state = shard_state(et.State({"model_0": torch.from_numpy(
        _slice_start())}), mesh)
    s.run_mcmc(state, f["steps"])
    last = s._previous_state
    return tuple(last.log_like.shape), last.log_like.numpy(), s.get_log_like()


def _slice_start():
    f = SLICE
    return np.random.default_rng(f["seed"]).uniform(
        -5.0, 5.0, (f["nt"], f["nw"], 1, f["ndim"])).astype(np.float32)


def _moment_start():
    f = MOMENTS
    return np.random.default_rng(f["seed"]).uniform(
        -2.0, 2.0, (f["nt"], f["nw"], 1, NDIM)).astype(np.float32)


def _moment_move(name, pkg):
    return {"MALAMove": lambda: pkg.moves.MALAMove(),
            "HMCMove": lambda: pkg.moves.HMCMove(),
            "AIMHMove": lambda: pkg.moves.AIMHMove()}[name]()


def _moments(chain):
    cold = np.asarray(chain)[:, 0].reshape(-1, NDIM)
    return cold.mean(axis=0), cold.var(axis=0)


def _moment_run(name, mesh):
    """MALA, HMC or AIMH at their defaults on the 2-D unit Gaussian,
    sharded: the cold chain's mean and variance per parameter."""
    import eryn_tpu_torch

    f = MOMENTS
    s = et.EnsembleSampler(
        f["nw"], NDIM, _ll, _priors(NDIM, -5.0, 5.0),
        moves=_moment_move(name, eryn_tpu_torch),
        tempering_kwargs=dict(ntemps=f["nt"], use_kernels=True),
        seed=f["seed"], device="cpu", backend=et.DeviceBackend())
    state = shard_state(et.State({"model_0": torch.from_numpy(
        _moment_start())}), mesh)
    s.run_mcmc(state, f["steps"], burn=f["burn"])
    return _moments(s.get_chain()["model_0"])


def _rank_main(rank, world):
    """Every check of one world size, in each rank."""
    out = {"chains": {}, "setup": {}}
    for tp, wp in MESHES[world]:
        mesh = make_mesh(world, temp_parallel=tp)
        for name in MOVES:
            for backend in BACKENDS:
                out["chains"][(tp, wp), name, backend] = _chain(
                    name, backend, shard_state(_start(name), mesh))
        for case in ("aimh", "swap"):
            out["setup"][(tp, wp), case] = _setup_check(mesh, case)
    if world == 4:
        row = make_mesh(world, temp_parallel=1)
        for name in BLOCK_MOVES:
            out["chains"][(1, 4), name, "host"] = _chain(
                name, "host", shard_state(_start(name), row))
    if world == 4:
        out["slice"] = _slice_run(mesh)
        out["moments"] = {name: _moment_run(name, mesh)
                          for name in MOMENT_MOVES}
    return out


class _Spawns:
    """Each world size spawned once, both at the same time, in the
    background; ``spawns[world]`` waits for that size's ranks' results."""

    def __init__(self, worlds=(2, 4)):
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
    return {(name, backend): _chain(name, backend, _start(name))
            for name in MOVES for backend in BACKENDS}


def _rank_layout(mesh, rank):
    """``(t0, nt, w0, nw)`` of ``rank`` on ``mesh`` (``make_mesh`` lays the
    ranks out row by row)."""
    tp, wp = mesh
    nt, nw = NT // tp, NW // wp
    ti, wi = divmod(rank, wp)
    return ti * nt, nt, wi * nw, nw


def _assert_same(got, ref, label, layout):
    """``got`` equals ``ref`` array by array; a kernel state's per-rung
    leaves (or per-walker ones) are compared to the reference's rows of the
    rank's temperatures (and walkers), and a device counter that holds the
    rank's walkers' count (AIMH's ``gamma_misses``) is left to the caller."""
    t0, nt, w0, nw = layout
    assert set(got) == set(ref), (label, set(got) ^ set(ref))
    for key, r in ref.items():
        g = got[key]
        if r is None:
            assert g is None, (label, key)
            continue
        r = np.asarray(r)
        if key.endswith("gamma_misses"):
            continue
        if key.startswith("kernel/") and r.shape != np.shape(g):
            if r.shape[0] == NT:
                r = r[t0:t0 + nt]
            else:  # CombineMove's per-child counts, (nchildren, NT, NW)
                r = r[:, t0:t0 + nt, w0:w0 + nw]
        np.testing.assert_array_equal(g, r, err_msg=f"{label} {key}")


@pytest.mark.parametrize("mesh", [(1, 2), (2, 1), (2, 2)])
@pytest.mark.parametrize("move", MOVES)
def test_sharded_chain_equals_one_rank(ranks, one_rank, move, mesh):
    """Each move of the zoo, on a state sharded over the mesh, equals the
    one-rank run digit for digit: chain, cold chain, log-likelihood,
    log-prior, ladder, acceptance, swap fractions and the last sample
    (masks, leaf counts and RJ acceptance under reversible jump), through
    ``Backend`` and ``DeviceBackend``, on every rank, with the moves'
    device counters (slice's ``loop_iterations``, ChEES's
    ``leapfrog_total``; AIMH's ``gamma_misses`` summed over the ranks) and
    kernel states (step sizes and dual averaging, ChEES's ``log_T`` and
    Adam moments, AIMH's moments, slice's ``mu``, the sequential and
    combination counters)."""
    world = mesh[0] * mesh[1]
    for backend in BACKENDS:
        ref = one_rank[move, backend]
        got = [r["chains"][mesh, move, backend] for r in ranks[world]]
        for rank, g in enumerate(got):
            _assert_same(g, ref, f"{mesh} {move} {backend} rank {rank}",
                         _rank_layout(mesh, rank))
        for key in ref:
            if key.endswith("gamma_misses"):
                assert sum(int(g[key]) for g in got) == int(ref[key]), key


@pytest.mark.parametrize("move", BLOCK_MOVES)
def test_sharded_blocks_equal_one_rank_where_a_rank_holds_none(
        ranks, one_rank, move):
    """The slice move in four blocks and the preconditioned MALA and HMC
    halves on a (1, 4) mesh, whose walker shards of 4 often lie outside a
    block: a rank that holds none of a block's walkers still makes the
    block's draws, and the chain equals the one-rank chain digit for
    digit (in these runs every rank meets such blocks of the slice move,
    11-15 of them, and of HMC, 1-2)."""
    ref = one_rank[move, "host"]
    for rank, r in enumerate(ranks[4]):
        _assert_same(r["chains"][(1, 4), move, "host"], ref,
                     f"(1, 4) {move} rank {rank}", _rank_layout((1, 4), rank))


@pytest.mark.parametrize("mesh", [(1, 2), (2, 1), (2, 2)])
def test_setup_check_failing_on_one_shard_raises_on_every_rank(ranks, mesh):
    """AIMH's fixed-dimension check and the model swap's one-active-leaf
    check read the whole ensemble's masks: where one walker of one rank's
    shard breaks them, every rank raises the same ``ValueError`` at set-up
    (none waits for the others in a collective until the spawn's time
    limit)."""
    world = mesh[0] * mesh[1]
    for case, words in (("aimh", "fixed-dimension"),
                        ("swap", "exactly one active leaf")):
        errs = [r["setup"][mesh, case] for r in ranks[world]]
        assert errs[0] is not None and words in errs[0], (case, errs[0])
        assert all(e == errs[0] for e in errs), (case, errs)


def test_sharded_slice_move_invariant_matches_eryn_tpu(ranks):
    """``tests/test_sharding.py::test_sharded_slice_move`` in both packages
    on the same numpy start: ``SliceMove()`` at its defaults, 3-D, 32
    walkers, 4 temperatures, 20 steps, sharded (the port on its (2, 2) mesh
    of four ranks, ``eryn_tpu`` on ``make_mesh(8)``, as its test): every
    rank holds its shard and every log-likelihood is finite, in each."""
    import jax
    import jax.numpy as jnp

    import eryn_tpu
    from eryn_tpu.moves import SliceMove as JSlice
    from eryn_tpu.parallel.mesh import make_mesh as jmake_mesh
    from eryn_tpu.parallel.mesh import shard_state as jshard_state

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    f = SLICE
    pr = eryn_tpu.ProbDistContainer({i: eryn_tpu.uniform_dist(-5, 5)
                                     for i in range(f["ndim"])})
    ens = eryn_tpu.EnsembleSampler(
        f["nw"], f["ndim"], lambda x: -0.5 * jnp.sum(x ** 2), pr,
        moves=JSlice(), tempering_kwargs=dict(ntemps=f["nt"]),
        seed=f["seed"])
    state = ens._setup_state(eryn_tpu.State({"model_0": _slice_start()}))
    state, _ = ens._run_bulk(jshard_state(state, jmake_mesh(8)), 1,
                             f["steps"], store=False)
    jax.block_until_ready(state.log_like)
    assert len(state.log_like.sharding.device_set) == 8
    assert np.all(np.isfinite(np.asarray(state.log_like)))
    for rank in ranks[4]:
        shard, logl, stored = rank["slice"]
        assert shard == (f["nt"] // 2, f["nw"] // 2), shard
        assert np.all(np.isfinite(logl)) and np.all(np.isfinite(stored))
        np.testing.assert_array_equal(stored, ranks[4][0]["slice"][2])


@pytest.mark.parametrize("name", MOMENT_MOVES)
def test_gradient_and_aimh_moments_as_eryn_tpu(ranks, name):
    """MALA, HMC and AIMH at their defaults on the 2-D unit Gaussian, 32
    walkers, 2 temperatures, 300 stored steps after 100, from the same
    numpy start: the cold chain's mean is within 0.15 of 0 and its variance
    within 0.25 of 1 per parameter, in ``eryn_tpu`` (one process) and in
    the port sharded over its (2, 2) mesh."""
    import jax.numpy as jnp

    import eryn_tpu

    f = MOMENTS
    pr = eryn_tpu.ProbDistContainer({i: eryn_tpu.uniform_dist(-5, 5)
                                     for i in range(NDIM)})
    ens = eryn_tpu.EnsembleSampler(
        f["nw"], NDIM, lambda x: -0.5 * jnp.sum(x ** 2), pr,
        moves=_moment_move(name, eryn_tpu),
        tempering_kwargs=dict(ntemps=f["nt"]), seed=f["seed"])
    state = ens._setup_state(eryn_tpu.State({"model_0": _moment_start()}))
    ens.run_mcmc(state, f["steps"], burn=f["burn"])
    results = [("eryn_tpu", _moments(ens.get_chain()["model_0"]))]
    results += [(f"port rank {i}", r["moments"][name])
                for i, r in enumerate(ranks[4])]
    for label, (mean, var) in results:
        assert np.all(np.abs(mean) < 0.15), (label, mean)
        assert np.all(np.abs(var - 1.0) < 0.25), (label, var)
