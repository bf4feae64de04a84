"""The port's Metropolis-Hastings moves (``MHMove``, ``GaussianMove``,
``DistributionGenerate``) and the sampler's guards, against eryn_tpu.

* Decision for decision: eryn_tpu's move runs from a JAX key; the draws it
  made are rebuilt with the same ``jax.random.split`` sequence and the same
  ``normal`` / ``uniform`` calls on the same subkeys (the dimension draws of
  ``mode="random"``, made by ``jax.random.randint``, whose algorithm the
  port cannot replay, are recorded from eryn_tpu's call), and handed to the
  port's function of the draws.  Accept decisions and new leaf masks must be
  identical; coordinates, factors, log-likelihoods and log-priors agree
  within rtol 1e-5 / atol 1e-6 in float32 (the libraries round ``exp``,
  ``log`` and a matrix product differently) and 1e-12 in float64.
* Statistically: the port's sampler with each move on a small tempered
  unit Gaussian, cold moments against the target.
* The guards: ``dr_moves=``, ``requires_fixed_dimension`` on a branch that
  reversible jump varies (inside a ``CombineMove`` too); a subclass that
  writes one of Eryn's host hooks is a host move and runs one proposal of
  its family's host protocol.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import eryn_tpu
import eryn_tpu.moves as jm
import eryn_tpu_torch as et
from eryn_tpu_torch import moves as tm

torch.set_num_threads(1)

RTOL = {np.float32: 1e-5, np.float64: 1e-12}
ATOL = {np.float32: 1e-6, np.float64: 1e-12}
NT, NW, NDIM = 3, 12, 3


def close(a, b, dtype=np.float32):
    np.testing.assert_allclose(np.asarray(a, dtype=np.float64),
                               np.asarray(b, dtype=np.float64),
                               rtol=RTOL[dtype], atol=ATOL[dtype])


def jit_step(jmove, jctx):
    """eryn_tpu's ``_propose_impl`` of ``jmove`` compiled once: a compiled
    call costs a fraction of an eager one here."""
    return jax.jit(lambda key, state, ks: jmove._propose_impl(key, state, jctx, ks))


def _queue(items):
    """A draw hook that hands out ``items`` in order, whatever it is
    asked."""
    it = iter(items)
    return lambda *args, **kwargs: next(it)


def _t(x):
    return torch.from_numpy(np.array(x))


def _ll_j(x):
    return -0.5 * jnp.sum(x * x)


def _ll_t(x):
    return -0.5 * torch.sum(x * x)


def pair(seed=0, ntemps=NT, **kw):
    """The unit Gaussian in U(-5, 5)^3 in both packages: ``(jax ctx, jax
    state, port ctx, port state)``, the port's state holding eryn_tpu's
    numbers."""
    jpr = eryn_tpu.ProbDistContainer(
        {i: eryn_tpu.uniform_dist(-5.0, 5.0) for i in range(NDIM)})
    tpr = et.ProbDistContainer({i: et.uniform_dist(-5.0, 5.0) for i in range(NDIM)})
    tk = dict(tempering_kwargs=dict(ntemps=ntemps)) if ntemps > 1 else {}
    js = eryn_tpu.EnsembleSampler(NW, NDIM, _ll_j, jpr, seed=0, **tk, **kw)
    ts = et.EnsembleSampler(NW, NDIM, _ll_t, tpr, seed=0, device="cpu", **tk,
                            **kw)
    coords = np.random.default_rng(seed).uniform(
        -2, 2, (ntemps, NW, 1, NDIM)).astype(np.float32)
    jstate = js._setup_state(eryn_tpu.State({"model_0": coords}))
    tstate = et.State(
        {"model_0": _t(coords)},
        inds={"model_0": torch.ones((ntemps, NW, 1), dtype=torch.bool)},
        log_like=_t(jstate.log_like), log_prior=_t(jstate.log_prior),
        betas=_t(jstate.betas))
    return js.get_eval_context(), jstate, ts.get_eval_context(), tstate


def assert_same_step(jout, tout):
    """One ``_propose_impl`` of both packages: decisions identical, floats
    close."""
    jstate, jacc = jout[:2]
    tstate, tacc = tout[:2]
    np.testing.assert_array_equal(np.asarray(tacc, dtype=bool),
                                  np.asarray(jacc, dtype=bool))
    for name, b in tstate.branches.items():
        close(b.coords, jstate.branches[name].coords)
        np.testing.assert_array_equal(b.inds.numpy(),
                                      np.asarray(jstate.branches[name].inds))
    close(tstate.log_like, jstate.log_like)
    close(tstate.log_prior, jstate.log_prior)


# ----------------------------------------------------------------------
# GaussianMove
# ----------------------------------------------------------------------
COVS = {
    "isotropic": 0.3,
    "diagonal": np.array([0.5, 0.2, 0.9]) ** 2,
    "full": 0.25 * np.eye(NDIM) + 0.05,
}
GAUSS_CASES = [
    ("vector", "isotropic", None), ("vector", "diagonal", 2.0),
    ("vector", "full", None), ("vector", "full", 1.5),
    ("random", "diagonal", None), ("random", "isotropic", 3.0),
    ("sequential", "isotropic", None), ("sequential", "diagonal", 2.0),
]


def _jax_gaussian_draws(key, coords, move, recorded):
    """The draws of eryn_tpu's ``GaussianMove.get_proposal_kernel`` from
    ``key`` (``moves/gaussian.py:112-134``), branch by branch:
    ``(noise, jitter uniform, dimension per leaf)``."""
    names = list(coords)
    keys = jax.random.split(key, 2 * len(names))
    out = []
    for i, name in enumerate(names):
        prop = move.all_proposal[name]
        c = coords[name]
        noise = np.array(jax.random.normal(keys[2 * i], c.shape, dtype=c.dtype))
        k_extra, jitter = keys[2 * i + 1], None
        if prop.log_factor is not None:
            k_extra, k_fac = jax.random.split(k_extra)
            jitter = np.array(jax.random.uniform(k_fac, (), dtype=c.dtype))
        dim = recorded.pop(0) if prop.mode == "random" else None
        out.append(tuple(None if x is None else _t(x)
                         for x in (noise, jitter, dim)))
    return out


@pytest.fixture
def record_randint(monkeypatch):
    """``jax.random.randint`` calls record their output."""
    recorded = []
    real = jax.random.randint

    def randint(*args, **kwargs):
        out = real(*args, **kwargs)
        recorded.append(np.array(out).astype(np.int64))
        return out

    monkeypatch.setattr(jax.random, "randint", randint)
    return recorded


@pytest.mark.parametrize("mode,kind,factor,dtype", [
    case + (np.float32,) for case in GAUSS_CASES] + [
    ("vector", "full", 1.5, np.float64), ("random", "diagonal", 2.0, np.float64),
    ("sequential", "isotropic", None, np.float64)])
def test_gaussian_proposal_matches_jax(mode, kind, factor, dtype,
                                       record_randint):
    rng = np.random.default_rng(1)
    coords = {"a": rng.normal(size=(NT, NW, 2, NDIM)).astype(dtype),
              "b": rng.normal(size=(NT, NW, 1, NDIM)).astype(dtype)}
    inds = {"a": rng.random((NT, NW, 2)) < 0.7,
            "b": np.ones((NT, NW, 1), bool)}
    cov = {"a": COVS[kind], "b": COVS[kind]}
    key = jax.random.key(5)
    with jax.enable_x64(dtype == np.float64):
        jmove = jm.GaussianMove(cov, mode=mode, factor=factor)
        jks = jmove.init_kernel_state(None)
        for n in jks:  # a counter mid-cycle
            jks[n] = jnp.asarray(4, jnp.int32)
        q_j, f_j, ks_j = jmove.get_proposal_kernel(
            key, {n: jnp.asarray(c) for n, c in coords.items()},
            {n: jnp.asarray(m) for n, m in inds.items()}, jks)
        draws = _jax_gaussian_draws(key, coords, jmove, record_randint)

    tmove = tm.GaussianMove(cov, mode=mode, factor=factor)
    tmove.draw_gaussian = _queue(draws)
    tks = {n: torch.tensor(4, dtype=torch.int32) for n in jks}
    q_t, f_t, ks_t = tmove.get_proposal_kernel(
        None, {n: _t(c) for n, c in coords.items()},
        {n: _t(m) for n, m in inds.items()}, tks)
    for name in coords:
        close(q_t[name], q_j[name], dtype)
        # the same entries moved
        np.testing.assert_array_equal(q_t[name].numpy() == coords[name],
                                      np.asarray(q_j[name]) == coords[name])
    np.testing.assert_array_equal(f_t.numpy(), np.asarray(f_j))
    assert {n: int(v) for n, v in ks_t.items()} == {
        n: int(v) for n, v in ks_j.items()}


def test_gaussian_gibbs_mask_and_periodic_match_jax():
    """A parameter-level Gibbs mask zeroes the step before the periodic
    wrap, in both packages."""
    rng = np.random.default_rng(2)
    coords = {"m": rng.uniform(0, 6, (NT, NW, 2, NDIM)).astype(np.float32)}
    inds = {"m": np.ones((NT, NW, 2), bool)}
    mask = np.zeros((2, NDIM), bool)
    mask[:, [0, 2]] = True
    key = jax.random.key(8)
    jmove = jm.GaussianMove({"m": 4.0}, periodic=eryn_tpu.utils.PeriodicContainer(
        {"m": {0: 2 * np.pi}}))
    q_j, _, _ = jmove.get_proposal_kernel(
        key, {"m": jnp.asarray(coords["m"])}, {"m": jnp.asarray(inds["m"])},
        {}, param_masks={"m": mask})
    draws = _jax_gaussian_draws(key, coords, jmove, [])
    tmove = tm.GaussianMove({"m": 4.0}, periodic={"m": {0: 2 * np.pi}})
    tmove.draw_gaussian = _queue(draws)
    q_t, _, _ = tmove.get_proposal_kernel(
        None, {"m": _t(coords["m"])}, {"m": _t(inds["m"])}, {},
        param_masks={"m": _t(mask)})
    close(q_t["m"], q_j["m"])
    assert (q_t["m"][..., 1].numpy() == coords["m"][..., 1]).all()
    assert (q_t["m"][..., 0] >= 0).all() and (q_t["m"][..., 0] < 2 * np.pi).all()


def mh_draws(key, jmove, jstate, branch_draws):
    """The draws of eryn_tpu's ``MHMove._propose_impl`` (``moves/mh.py:
    89-127``): per Gibbs split, the proposal's draws from ``kprop``
    (``branch_draws(kprop, coords of the split's branches)``) and the
    accept uniforms from ``kacc``.  Returns ``(proposal draws, accept
    uniforms)``, each a list in the order the port asks for them."""
    proposal, accept = [], []
    for names, _ in jmove.gibbs_iterations_for(jstate):
        key, kprop, kacc = jax.random.split(key, 3)
        proposal += branch_draws(
            kprop, {n: np.asarray(jstate.branches[n].coords) for n in names})
        accept.append(_t(jax.random.uniform(kacc, jstate.log_like.shape,
                                            dtype=jnp.float32)))
    return proposal, accept


@pytest.mark.parametrize("gibbs", [None, ["model_0", ("model_0", np.array(
    [[True, False, True]]))]], ids=["one split", "two splits"])
def test_gaussian_step_matches_jax(gibbs):
    """One whole step (proposal, prior, likelihood, decisions) of a wide
    Gaussian that rejects about half of its proposals."""
    jctx, jstate, tctx, tstate = pair(seed=3)
    key = jax.random.key(13)
    kw = dict(gibbs_sampling_setup=gibbs)
    jmove = jm.GaussianMove({"model_0": 1.5}, **kw)
    jout = jit_step(jmove, jctx)(key, jstate, {})
    draws, accept = mh_draws(
        key, jmove, jstate, lambda k, c: _jax_gaussian_draws(k, c, jmove, []))
    tmove = tm.GaussianMove({"model_0": 1.5}, **kw)
    tmove.draw_gaussian = _queue(draws)
    tmove.draw_accept = _queue(accept)
    tout = tmove._propose_impl(None, tstate, tctx, {})
    assert_same_step(jout, tout)
    assert 0 < np.asarray(jout[1]).mean() < 1


# ----------------------------------------------------------------------
# DistributionGenerate
# ----------------------------------------------------------------------
def _priors(pkg, bounds):
    return pkg.ProbDistContainer(
        {i: pkg.uniform_dist(lo, hi) for i, (lo, hi) in enumerate(bounds)})


def test_distgen_proposal_and_step_match_jax():
    """The draw, the factors ``logq(old) - logq(new)`` over active leaves
    (a generator narrower than the prior, so they are not constant and are
    ``-inf`` where a walker lies outside it), and the decisions."""
    jctx, jstate, tctx, tstate = pair(seed=4)
    bounds = [(-1.5, 2.5), (-2.0, 3.0), (-3.0, 1.5)]
    key = jax.random.key(17)
    jmove = jm.DistributionGenerate({"model_0": _priors(eryn_tpu, bounds)})
    jout = jit_step(jmove, jctx)(key, jstate, ())
    _, kprop, kacc = jax.random.split(key, 3)
    (kb,) = jax.random.split(kprop, 1)
    draw = _t(_priors(eryn_tpu, bounds).sample(kb, (NT, NW, 1)))
    accept = _t(jax.random.uniform(kacc, (NT, NW)))
    tmove = tm.DistributionGenerate({"model_0": _priors(et, bounds)})
    tmove.draw_accept = _queue([accept])
    # the factors alone, from the same draw
    q_j, f_j, _ = jmove.get_proposal_kernel(
        kprop, jstate.branches_coords, jstate.branches_inds, ())
    tmove.draw_generate = _queue([draw, draw])
    q_t, f_t, _ = tmove.get_proposal_kernel(
        None, tstate.branches_coords, tstate.branches_inds, ())
    close(q_t["model_0"], q_j["model_0"])
    close(f_t, f_j)
    assert np.isfinite(f_t.numpy()).any() and np.isinf(f_t.numpy()).any()
    tout = tmove._propose_impl(None, tstate, tctx, ())
    assert_same_step(jout, tout)


def test_distgen_refuses_a_mask_that_splits_a_group():
    pr = et.ProbDistContainer({(0, 1): et.mvn_dist(np.zeros(2), np.eye(2)),
                               2: et.uniform_dist(-1, 1)})
    with pytest.raises(ValueError, match="splits the multivariate"):
        tm.DistributionGenerate(
            {"model_0": pr},
            gibbs_sampling_setup=[("model_0", np.array([[True, False, True]]))])
    tm.DistributionGenerate(  # the whole group: fine
        {"model_0": pr},
        gibbs_sampling_setup=[("model_0", np.array([[True, True, False]]))])


# ----------------------------------------------------------------------
# statistically
# ----------------------------------------------------------------------
@pytest.mark.parametrize("make", [
    lambda pr: tm.GaussianMove({"model_0": np.full(NDIM, 0.5 ** 2)}),
    lambda pr: tm.GaussianMove({"model_0": 0.25 * np.eye(NDIM) + 0.05}),
    lambda pr: tm.GaussianMove({"model_0": 1.0}, mode="sequential",
                               factor=2.0),
    lambda pr: tm.DistributionGenerate({"model_0": pr}),
], ids=["diagonal", "full", "sequential", "distgen"])
def test_samplers_reach_the_unit_gaussian(make):
    pr = et.ProbDistContainer({i: et.uniform_dist(-5.0, 5.0) for i in range(NDIM)})
    s = et.EnsembleSampler(32, NDIM, _ll_t, pr, moves=make(pr),
                           tempering_kwargs=dict(ntemps=3), seed=2,
                           device="cpu")
    start = pr.rvs(size=(3, 32), generator=torch.Generator().manual_seed(2))
    s.run_mcmc(start, 300, burn=150)
    cold = s.get_chain(temp_index=0)["model_0"].reshape(-1, NDIM)
    assert np.abs(cold.mean(axis=0)).max() < 0.2
    assert np.abs(cold.var(axis=0) - 1.0).max() < 0.25
    assert 0 < s.acceptance_fraction[0].mean() < 1


# ----------------------------------------------------------------------
# guards
# ----------------------------------------------------------------------
def _gauss_sampler(**kw):
    pr = et.ProbDistContainer({i: et.uniform_dist(-5.0, 5.0) for i in range(2)})
    return et.EnsembleSampler(8, 2, lambda c, i: torch.zeros(()), pr,
                              device="cpu", **kw)


def test_dr_moves_raises():
    with pytest.raises(NotImplementedError, match="MTDistGenMoveRJ"):
        _gauss_sampler(nleaves_max=3, rj_moves=True, dr_moves=True)


class _FixedDim(tm.GaussianMove):
    requires_fixed_dimension = True


@pytest.mark.parametrize("wrap", [
    lambda m: m,
    lambda m: tm.CombineMove([tm.GroupStretchMove(), m]),
], ids=["alone", "inside CombineMove"])
def test_fixed_dimension_move_refuses_a_varying_branch(wrap):
    move = wrap(_FixedDim({"model_0": 1.0}))
    with pytest.raises(ValueError, match="fixed-dimension"):
        _gauss_sampler(nleaves_max=3, rj_moves=True, moves=move)
    # fine where reversible jump cannot vary the leaf count, or without it
    _gauss_sampler(nleaves_max=3, nleaves_min=3, rj_moves=True,
                   moves=wrap(_FixedDim({"model_0": 1.0})))
    _gauss_sampler(moves=wrap(_FixedDim({"model_0": 1.0})))


def _subclass(base, hook):
    """A subclass writing Eryn's host hook ``hook`` (counting its calls):
    the friends hooks as a snapshot of the ensemble, a whole-ensemble
    ``get_proposal`` as a Gaussian walk, any other hook as the package's
    stock one."""
    def counted(name, fn):
        def hook_fn(self, *args, **kwargs):
            if name == hook:
                self.hook_calls = getattr(self, "hook_calls", 0) + 1
            return fn(self, *args, **kwargs)
        return hook_fn

    def setup_friends(self, branches):
        self.friends = {n: np.array(b.coords[0]) for n, b in branches.items()}

    def find_friends(self, name, s, s_inds=None, branch_supps=None):
        pick = np.random.randint(self.friends[name].shape[0], size=s.shape[:2])
        return self.friends[name][pick]

    def walk(self, coords, random, branches_inds=None, **kwargs):
        q = {n: np.asarray(c) + 0.3 * random.randn(*np.shape(c))
             for n, c in coords.items()}
        return q, np.zeros(next(iter(q.values())).shape[:2])

    own = {"setup_friends": setup_friends, "find_friends": find_friends,
           "get_proposal": walk}
    names = (("setup_friends", "find_friends") if hook in own
             and base is tm.GroupStretchMove else (hook,))
    return type(f"Custom{base.__name__}", (base,), {
        n: counted(n, own.get(n) or getattr(base, n)) for n in names})


def _host_hook_sampler(move):
    pr = et.ProbDistContainer({i: et.uniform_dist(-5.0, 5.0)
                               for i in range(NDIM)})
    if move.is_rj:
        move.nleaves_max, move.nleaves_min = {"model_0": 3}, {"model_0": 0}
        kw = dict(nleaves_max=3, rj_moves=move,
                  moves=tm.GroupStretchMove(n_iter_update=4))

        def ll(c, i):
            return -0.5 * torch.sum(torch.where(i[:, None], c, 0.0) ** 2)
    else:
        kw = dict(moves=move)

        def ll(x):
            return -0.5 * torch.sum(x * x)
    with pytest.warns(UserWarning, match="host extension protocol"):
        s = et.EnsembleSampler(NW, NDIM, ll, pr, device="cpu", seed=2,
                               tempering_kwargs=dict(ntemps=NT), **kw)
    gen = torch.Generator().manual_seed(0)
    nl = 3 if move.is_rj else 1
    coords = pr.rvs(size=(NT, NW, nl), generator=gen)
    inds = torch.rand((NT, NW, nl), generator=gen) < 0.6
    inds[..., 0] = True
    return s, s._setup_state(et.State({"model_0": coords},
                                      inds={"model_0": inds}))


@pytest.mark.parametrize("base,hook,args", [
    (tm.MHMove, "get_proposal", ()),
    (tm.GaussianMove, "get_proposal", ({"model_0": 1.0},)),
    (tm.GroupStretchMove, "setup_friends", ()),
    (tm.GroupStretchMove, "find_friends", ()),
    (tm.MTDistGenMove, "special_like_func", (None,)),
    (tm.MTDistGenMove, "special_generate_logpdf", (None,)),
    (tm.DistributionGenerateRJ, "get_model_change_proposal", (None,)),
    (tm.MTDistGenMoveRJ, "special_generate_func", (None,)),
])
def test_a_host_hook_makes_a_host_move(base, hook, args):
    """A subclass that writes one of Eryn's host hooks is flagged
    ``host_move`` and runs one ``propose(model, state)`` of its family's
    host protocol on the CPU, its hook called, the swap phase after it."""
    cls = _subclass(base, hook)
    if args == (None,):
        args = ({"model_0": _priors(et, [(-5, 5)] * NDIM)},)
    move = cls(*args)
    assert move.host_move
    s, state = _host_hook_sampler(move)
    out, accepted = move.propose(s.get_model(), state)
    assert move.num_proposals == 1 and accepted.shape == (NT, NW)
    assert move.hook_calls > 0
    assert out.log_like.shape == (NT, NW)
    assert torch.all(torch.isfinite(out.log_like))
    assert int(s.temperature_control.time) == (0 if move.is_rj else 1)


def test_delayed_rejection_refuses_an_asymmetric_proposal():
    with pytest.raises(ValueError, match="symmetric"):
        tm.DelayedRejection(tm.DistributionGenerate(
            {"model_0": _priors(et, [(0, 1)])}))
    tm.DelayedRejection(tm.GaussianMove({"model_0": 1.0}))


def test_the_package_exports_the_moves():
    for name in ("MHMove", "GaussianMove", "DistributionGenerate",
                 "GroupMove", "GroupStretchMove", "CombineMove",
                 "DelayedRejection", "MultipleTryMove", "MultipleTryMoveRJ",
                 "MTDistGenMove", "MTDistGenMoveRJ", "ModelSwapRJMove",
                 "BasicSymmetricModelSwapRJMove", "get_mt_computations"):
        assert getattr(et, name) is getattr(tm, name)
        assert name in et.__all__ and name in tm.__all__
