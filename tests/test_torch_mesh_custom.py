"""Users' own move subclasses on the port's device mesh
(``eryn_tpu_torch.parallel.mesh``): the custom-moves example's
``MHMove`` (``KernelJumpMove``, which writes only its proposal, and a
variant with a kernel state made from the state), a bare subclass of a
sharded move, ``CombineMove`` and ``DelayedRejection`` around such moves,
a stretch subclass with its own complement pick, an ``AIMHMove`` and a
``DistributionGenerateRJ`` subclass, and a schedule of a declared and an
undeclared move, against one-rank chains and against ``eryn_tpu``.

A class that does not set ``_mesh_sharded`` itself takes one of two routes
(``Move.mesh_route``): an ``MHMove`` subclass that writes only its proposal
runs the proposal on the gathered coordinates in every rank and evaluates
the likelihood on the rank's rows (``"gathered proposal"``); any other runs
whole on the gathered ensemble in every rank (``"gathered"``).

The port's mesh is explicit SPMD: one process per device over
``torch.distributed``.  Here each world size (2 and 4 ranks) is spawned
once on the CPU (gloo, ``file://`` rendezvous, a time limit on the whole
spawn), the two at the same time, and runs every check of that size in its
ranks; the tests read the ranks' results.  The ranks import this module, so
it imports ``jax`` and ``eryn_tpu`` only inside the tests.

Tolerances: every sharded draw is made at its global shape from the one
generator, so at each move's start every rank's generator is where one
process's is, and a move run whole (or a proposal made whole) in every rank
computes what one process computes: on every mesh each chain equals the
one-rank chain digit for digit (bitwise), through every getter of
``Backend`` and ``DeviceBackend``, the move counters and the kernel states
(a rank holds a per-rung leaf's rows of its temperatures).  Against
``eryn_tpu``, which draws from another generator, the checks are
invariants held in both packages on the same numpy starts:
``tests/test_torch_mesh_zoo.py``'s (finite log-likelihoods, the state
spread over every device, and for the MH and stretch classes the cold
chain's moments of the 2-D unit Gaussian: mean within 0.15 of 0, variance
within 0.25 of 1).
"""

import os
import shutil
import time

import numpy as np
import pytest
import torch

import eryn_tpu_torch as et
from eryn_tpu_torch.examples.custom_moves import SCALE, KernelJumpMove
from eryn_tpu_torch.moves import (
    AIMHMove,
    CombineMove,
    DelayedRejection,
    DistributionGenerateRJ,
    GaussianMove,
    MHMove,
    RedBlueGroupStretchMove,
    StretchMove,
)
from eryn_tpu_torch.parallel import make_mesh, shard_state
from eryn_tpu_torch.parallel._spawn import launch

NT, NW, NDIM = 4, 16, 2
STEPS, BURN = 10, 2
MESHES = {2: [(1, 2), (2, 1)], 4: [(2, 2)]}
BACKENDS = ("host", "device")
NLMAX = 3
# the moment checks: 2-D unit Gaussian, 32 walkers, 2 temperatures; the
# MH class on the (2, 2) mesh, the stretch class on (2, 1), and their
# combination's finite log-likelihoods after INVARIANT_STEPS on (2, 2)
MOMENTS = dict(nw=32, nt=2, steps=1000, burn=200, seed=12)
MOMENT_MOVES = {"KernelJumpMove": (2, 2), "MyStretch": (2, 1)}
INVARIANT_MOVES = ("KernelJumpMove", "MyStretch", "CombineMove")
INVARIANT_STEPS = 20
# the AIMH subclass's file: written on (2, 2), continued on (1, 2)
FILE_STEPS = 5


class ScaledJump(KernelJumpMove):
    """``KernelJumpMove`` with a kernel state made from the state it is
    given: one jump scale a walker, not written for the mesh (it is made
    on the gathered state, whole on every rank)."""

    def init_kernel_state(self, state):
        return {"scale": torch.full(state.log_like.shape, SCALE,
                                    dtype=state.log_like.dtype)}

    def get_proposal_kernel(self, generator, branch_coords, branch_inds,
                            kernel_state, param_masks=None):
        scale = kernel_state["scale"][:, :, None, None]
        q = {n: c + scale * torch.randn(c.shape, generator=generator,
                                        dtype=c.dtype)
             for n, c in branch_coords.items()}
        c = next(iter(q.values()))
        return q, c.new_zeros(c.shape[:2]), kernel_state


class MyStretch(StretchMove):
    """A bare subclass of a sharded move: it does not declare itself
    sharded, so it runs whole in every rank (the fused stretch path)."""


class OwnPick(StretchMove):
    """A stretch subclass with its own complement pick, drawn from the
    generator at the shape it is given (not through ``rank_draw``): on the
    shard it would draw another stream than one process."""

    def choose_c_vals(self, generator, c, ns):
        ntemps, nc = c.shape[:2]
        rint = torch.randint(0, nc, (ntemps, ns), generator=generator,
                             device=c.device)
        idx = rint[:, :, None, None].expand(ntemps, ns, *c.shape[2:])
        return torch.gather(c, 1, idx)


class MyGauss(GaussianMove):
    """A bare subclass of a per-walker MH move: its proposal runs on the
    gathered coordinates."""


class MyAIMH(AIMHMove):
    """A bare AIMH subclass: it runs whole in every rank, and inherits its
    kernel state's axes (the moments split by rung)."""


class MyBirthDeath(DistributionGenerateRJ):
    """A bare birth/death subclass: reversible jump whole in every rank."""


class OwnStep(MHMove):
    """An ``MHMove`` subclass with its own ``_propose_impl``: it runs
    whole in every rank."""

    def _propose_impl(self, generator, state, ctx, kernel_state=()):
        return (state, torch.zeros(state.log_like.shape, dtype=torch.bool),
                kernel_state)


def _ll(x):
    return -0.5 * torch.sum(x * x)


def _ll_rj(coords, inds):
    return torch.sum(torch.where(inds, -0.5 * torch.sum(coords ** 2, dim=-1),
                                 0.0))


class _RowCounter:
    """The unit Gaussian for a batch of walkers (``vectorize=True``),
    counting the rows each call is given."""

    def __init__(self):
        self.rows = []

    def __call__(self, x):
        self.rows.append(int(x.shape[0]))
        return -0.5 * torch.sum(x * x, dim=-1)


def _priors(ndim=NDIM, lo=-3.0, hi=3.0):
    return et.ProbDistContainer({i: et.uniform_dist(lo, hi)
                                 for i in range(ndim)})


def _combine():
    return CombineMove([KernelJumpMove(), StretchMove(use_kernels=True)])


def _moves(name):
    """The in-model moves of the case ``name`` (a fixed-dimension one)."""
    return {
        "KernelJumpMove": lambda: KernelJumpMove(),
        "ScaledJump": lambda: ScaledJump(),
        "MyStretch": lambda: MyStretch(use_kernels=True),
        "OwnPick": lambda: OwnPick(use_kernels=True),
        "CombineMove": _combine,
        "CombineMove+DR": lambda: [
            (_combine(), 0.8),
            (DelayedRejection(MyGauss({"model_0": 0.6}), max_iter=2), 0.2)],
        "MyAIMH": lambda: MyAIMH(df=5, tune_steps=6),
        "MyAIMH(gamma)": lambda: MyAIMH(df=4.5, tune_steps=6),
        "schedule": lambda: [(GaussianMove({"model_0": 0.3}), 0.5),
                             (MyStretch(use_kernels=True), 0.5)],
    }[name]()


CASES = ("KernelJumpMove", "ScaledJump", "MyStretch", "OwnPick",
         "CombineMove", "CombineMove+DR", "MyAIMH", "MyAIMH(gamma)",
         "schedule", "MyBirthDeath")


def _backend(backend):
    if isinstance(backend, str):
        return et.DeviceBackend() if backend == "device" else et.Backend()
    return backend


def _sampler(name, backend="host", seed=7):
    kw = dict(tempering_kwargs=dict(ntemps=NT, use_kernels=True), seed=seed,
              device="cpu", backend=_backend(backend))
    pr = _priors()
    if name == "MyBirthDeath":
        return et.EnsembleSampler(
            NW, NDIM, _ll_rj, pr, nleaves_max=NLMAX, nleaves_min=0,
            moves=RedBlueGroupStretchMove(),
            rj_moves=[MyBirthDeath(pr, nleaves_max={"model_0": NLMAX},
                                   nleaves_min={"model_0": 0})],
            fill_zero_leaves_val=-5.0, **kw)
    return et.EnsembleSampler(NW, NDIM, _ll, pr, moves=_moves(name), **kw)


def _start(name):
    rng = np.random.default_rng(1)
    nl = NLMAX if name == "MyBirthDeath" else 1
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
               last=s.get_last_sample().log_like.numpy(),
               iteration=s.backend.iteration)
    if s.has_reversible_jump:
        out["rj_acc"] = s.rj_acceptance_fraction
    for j, m in enumerate(_walk_moves(s._all_move_list)):
        if getattr(m, "gamma_misses", None) is not None:
            out[f"counter/{j}/gamma_misses"] = m.gamma_misses.cpu().numpy()
        for k, v in _leaves(m.kernel_state).items():
            out[f"kernel/{j}{k}"] = v
    return out


def _chain(name, backend, state):
    s = _sampler(name, backend)
    s.run_mcmc(state, STEPS, burn=BURN)
    return _record(s)


def _rows(name, state):
    """The rows that reached the likelihood in a run of ``name`` from
    ``state`` (the set-up's evaluation included, the probe of two walkers
    not)."""
    log_like = _RowCounter()
    s = et.EnsembleSampler(
        NW, NDIM, log_like, _priors(), moves=_moves(name), vectorize=True,
        tempering_kwargs=dict(ntemps=NT, use_kernels=True), seed=7,
        device="cpu")
    s.run_mcmc(state, STEPS, burn=BURN)
    return sum(n for n in log_like.rows if n != 2)


def _aimh_file(path, mesh):
    """The AIMH subclass's first ``FILE_STEPS`` stored steps written to
    ``path``, sharded over ``mesh`` where given."""
    s = _sampler("MyAIMH", et.HDFBackend(path))
    state = _start("MyAIMH")
    s.run_mcmc(state if mesh is None else shard_state(state, mesh),
               FILE_STEPS, burn=BURN)


def _aimh_resume(path, mesh):
    """The file's chain continued by a fresh sampler (the file's
    generators, clock and kernel states), sharded over ``mesh`` where
    given: its record."""
    s = _sampler("MyAIMH", et.HDFBackend(path), seed=99)
    last = s.get_last_sample()
    s.run_mcmc(last if mesh is None else shard_state(last, mesh), FILE_STEPS)
    return _record(s)


def _moment_start():
    f = MOMENTS
    return np.random.default_rng(f["seed"]).uniform(
        -2.0, 2.0, (f["nt"], f["nw"], 1, NDIM)).astype(np.float32)


def _moments(chain):
    cold = np.asarray(chain)[:, 0].reshape(-1, NDIM)
    return cold.mean(axis=0), cold.var(axis=0)


def _invariant_run(name, mesh=None, pkg=None):
    """``name`` at its defaults on the 2-D unit Gaussian from the moment
    start, sharded over ``mesh`` (the port's) where given, in ``pkg``
    (``eryn_tpu_torch``, or ``eryn_tpu`` on its ``make_mesh(8)``): the
    cold chain's mean and variance per parameter (after ``MOMENTS``'s
    steps for the MH and stretch classes, ``INVARIANT_STEPS`` for the
    combination), whether every stored log-likelihood is finite, and the
    shape of the state the process holds and the devices it spans."""
    f = MOMENTS
    steps, burn = ((f["steps"], f["burn"]) if name in MOMENT_MOVES
                   else (INVARIANT_STEPS, 0))
    if pkg is None:
        s = et.EnsembleSampler(
            f["nw"], NDIM, _ll, _priors(NDIM, -5.0, 5.0),
            moves=_moments_move(name), tempering_kwargs=dict(ntemps=f["nt"]),
            seed=f["seed"], device="cpu", backend=et.DeviceBackend())
        s.run_mcmc(shard_state(et.State({"model_0": torch.from_numpy(
            _moment_start())}), mesh), steps, burn=burn)
        spread = 1
    else:
        import jax.numpy as jnp

        from eryn_tpu.parallel.mesh import make_mesh as jmake_mesh
        from eryn_tpu.parallel.mesh import shard_state as jshard_state

        pr = pkg.ProbDistContainer({i: pkg.uniform_dist(-5, 5)
                                    for i in range(NDIM)})
        s = pkg.EnsembleSampler(
            f["nw"], NDIM, lambda x: -0.5 * jnp.sum(x ** 2), pr,
            moves=_jax_moves(name), tempering_kwargs=dict(ntemps=f["nt"]),
            seed=f["seed"])
        state = s._setup_state(pkg.State({"model_0": _moment_start()}))
        s.run_mcmc(jshard_state(state, jmake_mesh(8)), steps, burn=burn)
        spread = len(s._previous_state.log_like.sharding.device_set)
    return (_moments(s.get_chain()["model_0"]),
            bool(np.all(np.isfinite(s.get_log_like()))),
            tuple(s._previous_state.log_like.shape), spread)


def _moments_move(name):
    return {"KernelJumpMove": KernelJumpMove, "MyStretch": MyStretch,
            "CombineMove": lambda: CombineMove(
                [KernelJumpMove(), StretchMove()])}[name]()


def _wait_for(path, timeout=200.0):
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} was not written")
        time.sleep(0.2)


def _rank_main(rank, world, folder):
    """Every check of one world size, in each rank: the four-rank program
    writes the AIMH subclass's file on (2, 2) first; the two-rank one
    continues it on (1, 2) last."""
    import torch.distributed as dist

    out = {"chains": {}, "rows": {}}
    aimh_file = os.path.join(folder, "aimh.h5")
    if world == 4:
        _aimh_file(aimh_file, make_mesh(4, temp_parallel=2))
        dist.barrier()
        if rank == 0:
            # a copy for the test's own process to continue
            shutil.copyfile(aimh_file, aimh_file + ".copy")
            open(aimh_file + ".done", "w").close()
    for tp, wp in MESHES[world]:
        mesh = make_mesh(world, temp_parallel=tp)
        for name in CASES:
            for backend in BACKENDS:
                out["chains"][(tp, wp), name, backend] = _chain(
                    name, backend, shard_state(_start(name), mesh))
        for name in ("KernelJumpMove", "MyStretch"):
            out["rows"][(tp, wp), name] = _rows(
                name, shard_state(_start(name), mesh))
    out["invariants"] = {
        name: _invariant_run(name, make_mesh(world, temp_parallel=2))
        for name in INVARIANT_MOVES
        if MOMENT_MOVES.get(name, (2, 2)) == (2, world // 2)}
    if world == 2:
        _wait_for(aimh_file + ".done")
        out["resumed"] = _aimh_resume(aimh_file,
                                      make_mesh(2, temp_parallel=1))
    return out


class _Spawns:
    """Each world size spawned once, both at the same time, in the
    background; ``spawns[world]`` waits for that size's ranks' results."""

    def __init__(self, folder, worlds=(2, 4)):
        from concurrent.futures import ThreadPoolExecutor

        self.folder = folder
        self.pool = ThreadPoolExecutor(len(worlds))
        self.runs = {w: self.pool.submit(launch, _rank_main, w, folder,
                                         timeout=240)
                     for w in worlds}

    def __getitem__(self, world):
        return self.runs[world].result()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    spawns = _Spawns(str(tmp_path_factory.mktemp("mesh_custom")))
    yield spawns
    spawns.pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """The one-process chains the sharded ones must equal, the rows their
    likelihood received, and the AIMH subclass's file written and resumed
    in one process."""
    out = {(name, backend): _chain(name, backend, _start(name))
           for name in CASES for backend in BACKENDS}
    for name in ("KernelJumpMove", "MyStretch"):
        out["rows", name] = _rows(name, _start(name))
    path = str(tmp_path_factory.mktemp("aimh_one") / "aimh.h5")
    _aimh_file(path, None)
    out["resumed"] = _aimh_resume(path, None)
    return out


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
    rank's temperatures (and walkers)."""
    t0, nt, w0, nw = layout
    assert set(got) == set(ref), (label, set(got) ^ set(ref))
    for key, r in ref.items():
        g = got[key]
        if r is None:
            assert g is None, (label, key)
            continue
        r = np.asarray(r)
        if key.startswith("kernel/") and r.shape != np.shape(g):
            if r.shape[0] == NT:
                r = r[t0:t0 + nt]
            else:  # CombineMove's per-child counts, (nchildren, NT, NW)
                r = r[:, t0:t0 + nt, w0:w0 + nw]
        np.testing.assert_array_equal(g, r, err_msg=f"{label} {key}")


def test_each_class_names_its_mesh_route():
    """``Move.mesh_route``: a class that declares itself sharded runs on
    the shard, a host move on the host, an ``MHMove`` subclass that writes
    only its proposal (the custom-moves example's ``KernelJumpMove``, a
    bare ``GaussianMove`` subclass) runs its proposal gathered, and every other
    subclass runs whole in every rank; nothing is refused."""
    pr = _priors()

    class HostWalk(MHMove):
        def get_proposal(self, branches_coords, random, branches_inds=None,
                         **kwargs):
            return branches_coords, np.zeros((1, 1))

    routes = {
        StretchMove(): "sharded",
        _combine(): "sharded",
        DelayedRejection(MyGauss({"model_0": 0.6})): "sharded",
        GaussianMove({"model_0": 0.3}): "sharded",
        HostWalk(): "host",
        KernelJumpMove(): "gathered proposal",
        ScaledJump(): "gathered proposal",
        MyGauss({"model_0": 0.3}): "gathered proposal",
        MyStretch(): "gathered",
        OwnPick(): "gathered",
        MyAIMH(): "gathered",
        MyBirthDeath(pr, nleaves_max={"model_0": NLMAX},
                     nleaves_min={"model_0": 0}): "gathered",
        OwnStep(): "gathered",
    }
    for move, route in routes.items():
        assert move.mesh_route() == route, (type(move).__name__, route)


def _jax_moves(name):
    """``name`` in ``eryn_tpu``: the custom-moves example's
    ``KernelJumpMove`` (``examples/custom_moves.py``), a bare
    ``StretchMove`` subclass, the combination of the two."""
    import jax
    import jax.numpy as jnp

    from eryn_tpu.moves import CombineMove as JCombine
    from eryn_tpu.moves import MHMove as JMHMove
    from eryn_tpu.moves import StretchMove as JStretch

    class JKernelJump(JMHMove):
        def get_proposal_kernel(self, key, branch_coords, branch_inds,
                                kernel_state, param_masks=None):
            q = {}
            for n, c in branch_coords.items():
                key, sub = jax.random.split(key)
                q[n] = c + SCALE * jax.random.normal(sub, c.shape,
                                                     dtype=c.dtype)
            factors = jnp.zeros(next(iter(q.values())).shape[:2])
            return q, factors, kernel_state

    class JMyStretch(JStretch):
        pass

    return {"KernelJumpMove": JKernelJump, "MyStretch": JMyStretch,
            "CombineMove": lambda: JCombine([JKernelJump(), JStretch()])
            }[name]()


@pytest.fixture(scope="module")
def jax_runs():
    """``eryn_tpu``'s runs of the invariant classes on ``make_mesh(8)``
    (they run while the ranks' spawns do)."""
    import jax

    import eryn_tpu

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    return {name: _invariant_run(name, pkg=eryn_tpu)
            for name in INVARIANT_MOVES}


@pytest.mark.parametrize("name", INVARIANT_MOVES)
def test_custom_moves_invariants_as_eryn_tpu(ranks, jax_runs, name):
    """The custom-moves example's ``KernelJumpMove``, a bare
    ``StretchMove`` subclass and their ``CombineMove`` in both packages
    from the same numpy start, 32 walkers, 2 temperatures, sharded
    (``eryn_tpu`` on ``make_mesh(8)``; the port on its (2, 2) mesh of four
    ranks, the stretch class on (2, 1) of two): every process holds its
    shard (``eryn_tpu``'s state spans the 8 devices), every stored
    log-likelihood is finite and, for the MH and stretch classes after
    1,000 stored steps (200 of burn-in), the cold chain's mean is within
    0.15 of 0 and its variance within 0.25 of 1 per parameter, in each."""
    f = MOMENTS
    mesh = MOMENT_MOVES.get(name, (2, 2))
    moments, finite, _, spread = jax_runs[name]
    assert finite and spread == 8, (finite, spread)
    results = [("eryn_tpu", moments)]
    for i, r in enumerate(ranks[mesh[0] * mesh[1]]):
        moments, finite, shard, _ = r["invariants"][name]
        assert finite and shard == (f["nt"] // mesh[0],
                                    f["nw"] // mesh[1]), (i, shard)
        results.append((f"port rank {i}", moments))
    if name not in MOMENT_MOVES:
        return
    for label, (mean, var) in results:
        assert np.all(np.abs(mean) < 0.15), (label, mean)
        assert np.all(np.abs(var - 1.0) < 0.25), (label, var)


@pytest.mark.parametrize("mesh", [(1, 2), (2, 1), (2, 2)])
@pytest.mark.parametrize("case", CASES)
def test_sharded_chain_equals_one_rank(ranks, one_rank, case, mesh):
    """Each user's class, on a state sharded over the mesh, equals the
    one-rank run digit for digit: chain, cold chain, log-likelihood,
    log-prior, ladder, acceptance, swap fractions and the last sample
    (masks, leaf counts and RJ acceptance under reversible jump), through
    ``Backend`` and ``DeviceBackend``, on every rank, with the kernel
    states (AIMH's moments by rung, the combination's per-member counts,
    the Gaussian proposal's factors) and AIMH's ``gamma_misses``, which a
    subclass run whole in every rank counts once for the ensemble."""
    world = mesh[0] * mesh[1]
    for backend in BACKENDS:
        ref = one_rank[case, backend]
        for rank, r in enumerate(ranks[world]):
            _assert_same(r["chains"][mesh, case, backend], ref,
                         f"{mesh} {case} {backend} rank {rank}",
                         _rank_layout(mesh, rank))


@pytest.mark.parametrize("mesh", [(1, 2), (2, 1), (2, 2)])
def test_gathered_proposal_evaluates_the_ranks_rows_only(ranks, one_rank,
                                                         mesh):
    """The rows that reach the likelihood on each rank: the custom-moves
    example's ``KernelJumpMove`` (its proposal gathered) evaluates the
    rank's rows only, one world-size-th of one process's; the bare stretch
    subclass (run whole in every rank) evaluates every walker in every
    step, and only the set-up's evaluation is the rank's rows."""
    world = mesh[0] * mesh[1]
    whole = NT * NW
    for rank in ranks[world]:
        got = rank["rows"]
        assert got[mesh, "KernelJumpMove"] * world == one_rank[
            "rows", "KernelJumpMove"], got
        assert (got[mesh, "MyStretch"] - whole // world
                == one_rank["rows", "MyStretch"] - whole), got


def test_aimh_subclass_file_continues_on_another_mesh(ranks, one_rank,
                                                      tmp_path):
    """The AIMH subclass's chain, written to ``HDFBackend`` on (2, 2) and
    continued by a fresh sampler on (1, 2), or in one process, equals the
    chain one process writes and continues, digit for digit: its moments
    (stored whole) resume their tuning bitwise."""
    ref = one_rank["resumed"]
    for rank, r in enumerate(ranks[2]):
        _assert_same(r["resumed"], ref, f"(1, 2) rank {rank}",
                     _rank_layout((1, 2), rank))
    copy = str(tmp_path / "aimh.h5")
    shutil.copyfile(os.path.join(ranks.folder, "aimh.h5.copy"), copy)
    _assert_same(_aimh_resume(copy, None), ref, "one process",
                 (0, NT, 0, NW))
    assert ref["iteration"] == 2 * FILE_STEPS


