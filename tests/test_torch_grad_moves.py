"""The port's gradient moves (``MALAMove``, ``HMCMove``, ``ChEESHMCMove``)
and the gradient of the tempered posterior they share, against eryn_tpu.

* The gradient context (``moves.mala.grad_context``) against eryn_tpu's
  ``jax.value_and_grad`` closure on a Gaussian, under a reversible-jump
  leaf mask, and at walkers outside the prior (zero gradient there).
* Decision for decision: eryn_tpu's move runs from a JAX key; the draws it
  made (momenta, Langevin noise, accept uniforms, the red/blue permutation)
  are rebuilt from the same ``jax.random.split`` sequence, the HMC lengths
  (``jax.random.randint``) are recorded from eryn_tpu's call, and all are
  handed to the port's draw hooks.  Accept decisions must be identical.
  Float tolerances: rtol 1e-12 in float64.  In float32 a leapfrog
  trajectory compounds a few ulp per gradient evaluation (the libraries
  round the likelihood's reductions and ``exp``/``log`` differently), so
  positions and log-posteriors at the end of a trajectory of up to 32
  steps agree within rtol 1e-4 / atol 1e-5, and a single Langevin step
  within rtol 1e-5 / atol 1e-6.
* ChEES's masked loop of ``max_leapfrog`` iterations against eryn_tpu's
  ``while_loop`` of ``L`` for ``L`` in {1, 7, 32}; the Halton jitter.
* Statistically: each move's sampler on a small tempered unit Gaussian;
  kernel states from eryn_tpu's; a ChEES run (and MALA, slice and AIMH
  kernel states) resumed mid-tuning from ``HDFBackend`` digit for digit.
* The wiring: a likelihood ``torch.func`` cannot differentiate raises a
  ``TypeError`` naming the fix; Gibbs splits are refused.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import eryn_tpu
import eryn_tpu.moves as jm
import eryn_tpu_torch as et
from eryn_tpu_torch import Backend, HDFBackend
from eryn_tpu_torch import moves as tm
from eryn_tpu_torch.interop import kernel_state_from_numpy, kernel_state_to_numpy
from eryn_tpu_torch.moves.chees import _halton2
from eryn_tpu_torch.moves.mala import grad_context

torch.set_num_threads(1)

NT, NW, NDIM = 3, 12, 3
TOL = {  # (rtol, atol): one Langevin step, a leapfrog trajectory
    np.float64: ((1e-12, 1e-12), (1e-12, 1e-12)),
    np.float32: ((1e-5, 1e-6), (1e-4, 1e-5)),
}
TORCH = {np.float32: torch.float32, np.float64: torch.float64}


def close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, dtype=np.float64),
                               np.asarray(b, dtype=np.float64),
                               rtol=tol[0], atol=tol[1])


def _t(x):
    return torch.from_numpy(np.array(x))


def _queue(items):
    it = iter(items)
    return lambda *args, **kwargs: next(it)


def _ll_j(x):
    return -0.5 * jnp.sum(x * x)


def _ll_t(x):
    return -0.5 * torch.sum(x * x)


def _rj_ll_j(c, i):
    return -0.5 * jnp.sum(jnp.where(i[:, None], c, 0.0) ** 2)


def _rj_ll_t(c, i):
    return -0.5 * torch.sum(torch.where(i[:, None], c, 0.0) ** 2)


def pair(dtype=np.float64, seed=0, nleaves=1, low=-2.0, high=2.0):
    """The unit Gaussian in U(-5, 5)^3 on NT x NW walkers in both
    packages (``nleaves > 1``: reversible jump, random leaf masks):
    ``(jax ctx, jax state, port ctx, port state)``, the port's state
    holding eryn_tpu's numbers.  Call inside ``jax.enable_x64`` for
    float64."""
    rj = nleaves > 1
    jpr = eryn_tpu.ProbDistContainer(
        {i: eryn_tpu.uniform_dist(-5.0, 5.0) for i in range(NDIM)})
    tpr = et.ProbDistContainer({i: et.uniform_dist(-5.0, 5.0)
                                for i in range(NDIM)})
    kw = dict(tempering_kwargs=dict(ntemps=NT), seed=0, nleaves_max=nleaves)
    if rj:
        kw.update(rj_moves=True, fill_zero_leaves_val=0.0)
    js = eryn_tpu.EnsembleSampler(NW, NDIM, _rj_ll_j if rj else _ll_j, jpr,
                                  dtype=jnp.dtype(dtype), **kw)
    ts = et.EnsembleSampler(NW, NDIM, _rj_ll_t if rj else _ll_t, tpr,
                            device="cpu", dtype=TORCH[dtype], **kw)
    rng = np.random.default_rng(seed)
    coords = rng.uniform(low, high, (NT, NW, nleaves, NDIM)).astype(dtype)
    inds = (rng.random((NT, NW, nleaves)) < 0.6) if rj else np.ones(
        (NT, NW, nleaves), bool)
    jstate = js._setup_state(eryn_tpu.State({"model_0": coords},
                                            inds={"model_0": inds}))
    tstate = et.State(
        {"model_0": _t(coords)}, inds={"model_0": _t(inds)},
        log_like=_t(jstate.log_like), log_prior=_t(jstate.log_prior),
        betas=_t(jstate.betas))
    return js.get_eval_context(), jstate, ts.get_eval_context(), tstate


def assert_same_step(jout, tout, tol):
    """One ``_propose_impl`` of both packages: decisions identical, floats
    close, kernel states close."""
    jstate, jacc, jks = jout
    tstate, tacc, tks = tout
    np.testing.assert_array_equal(np.asarray(tacc, dtype=bool),
                                  np.asarray(jacc, dtype=bool))
    close(tstate.branches["model_0"].coords,
          jstate.branches["model_0"].coords, tol)
    close(tstate.log_like, jstate.log_like, tol)
    close(tstate.log_prior, jstate.log_prior, tol)
    a, b = kernel_state_to_numpy(tks), kernel_state_to_numpy(jks)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        close(x, y, tol)


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


# ----------------------------------------------------------------------
# the gradient context
# ----------------------------------------------------------------------
@pytest.mark.parametrize("case", ["gaussian", "rj", "out of support"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_grad_context_matches_jax(case, dtype):
    nleaves = 3 if case == "rj" else 1
    with jax.enable_x64(dtype == np.float64):
        jctx, jstate, tctx, tstate = pair(dtype, seed=4, nleaves=nleaves)
        coords = np.array(jstate.branches["model_0"].coords)
        if case == "out of support":
            coords[:, ::3, 0, 1] = 7.5  # a third of the walkers outside
            jstate = jstate.replace(coords={"model_0": jnp.asarray(coords)})
        jmove = jm.MALAMove()
        *_, jgrad = jmove._grad_setup(jstate, jctx)
        (val, (ll_j, lp_j, _)), g_j = jgrad({"model_0": jnp.asarray(coords)})
    grad_fn = grad_context(tctx, {}, tstate.branches_inds, tstate.betas)
    (ll_t, lp_t), g_t = grad_fn({"model_0": _t(coords)})
    tol = TOL[dtype][0]
    close(g_t["model_0"], g_j["model_0"], tol)
    close(ll_t, ll_j, tol)
    close(lp_t, lp_j, tol)
    g = g_t["model_0"].numpy()
    if case == "out of support":
        assert np.all(g[:, ::3] == 0.0) and np.isneginf(lp_t.numpy()[:, ::3]).all()
        assert np.all(g[:, 1::3] != 0.0)
    if case == "rj":
        inactive = ~tstate.branches_inds["model_0"].numpy()
        assert np.all(g[inactive] == 0.0)
    # the Gaussian's gradient is -beta x on active leaves
    active = tstate.branches_inds["model_0"].numpy()[..., None]
    want = np.where(active, -tstate.betas.numpy()[:, None, None, None] * coords,
                    0.0)
    if case == "out of support":
        want[:, ::3] = 0.0
    close(g, want, tol)


def test_a_likelihood_torch_func_cannot_differentiate_raises_at_wiring():
    pr = et.ProbDistContainer({i: et.uniform_dist(-5.0, 5.0)
                               for i in range(NDIM)})
    start = pr.rvs(size=(NT, NW), generator=torch.Generator().manual_seed(0))

    def no_derivative(x):  # vmaps, but zeta has no derivative in x
        return -torch.special.zeta(x * x + 2.0, torch.ones_like(x)).sum()

    s = et.EnsembleSampler(NW, NDIM, no_derivative, pr, moves=tm.MALAMove(),
                           tempering_kwargs=dict(ntemps=NT), device="cpu")
    with pytest.raises(TypeError, match="torch.func"):
        s.run_mcmc(start, 2)

    def detached(x):
        return -0.5 * torch.sum(x.detach() ** 2)

    s = et.EnsembleSampler(NW, NDIM, detached, pr,
                           moves=tm.CombineMove([tm.HMCMove()]),
                           tempering_kwargs=dict(ntemps=NT), device="cpu")
    with pytest.warns(UserWarning, match="zero gradient"):
        s.run_mcmc(start, 2)
    # a move without gradients takes the same detached likelihood quietly
    s = et.EnsembleSampler(NW, NDIM, detached, pr, moves=tm.DEMove(),
                           tempering_kwargs=dict(ntemps=NT), device="cpu")
    s.run_mcmc(start, 2)


def test_gibbs_splits_are_refused():
    for cls in (tm.MALAMove, tm.HMCMove, tm.ChEESHMCMove, tm.AIMHMove):
        with pytest.raises(ValueError, match="gibbs_sampling_setup"):
            cls(gibbs_sampling_setup="model_0")
    with pytest.raises(NotImplementedError, match="ensemble_precondition"):
        tm.ChEESHMCMove(ensemble_precondition=True)


# ----------------------------------------------------------------------
# decision for decision
# ----------------------------------------------------------------------
def _jax_split_draws(key, perm_first, nw):
    """The permutation eryn_tpu's red/blue form draws first, and the rest
    of the key."""
    if not perm_first:
        return None, key
    key, kperm = jax.random.split(key)
    return _t(np.array(jax.random.permutation(kperm, nw)).astype(np.int64)), key


def _normal(key, shape, dtype):
    return _t(np.array(jax.random.normal(key, shape, dtype=dtype)))


def _uniform(key, shape, dtype):
    return _t(np.array(jax.random.uniform(key, shape, dtype=dtype)))


def _mala_draws(key, dtype, precond):
    """eryn_tpu's MALA draws from ``key`` (``mala.py:362-375, 471-482,
    501-510``): ``(perm or None, noise dicts, accept uniforms)``."""
    shape = (NT, NW, 1, NDIM)
    if not precond:
        key, k_xi, k_acc = jax.random.split(key, 3)
        kx = jax.random.split(k_xi, 1)[0]
        return None, [{"model_0": _normal(kx, shape, dtype)}], [
            _uniform(k_acc, (NT, NW), dtype)]
    perm, key = _jax_split_draws(key, True, NW)
    noise, accept = [], []
    n0 = NW - NW // 2
    for ns in (n0, NW - n0):
        key, k_acc = jax.random.split(key)
        key, k_xi = jax.random.split(key)
        kx = jax.random.split(k_xi, 1)[0]
        noise.append({"model_0": _normal(kx, (NT, ns, 1, NDIM), dtype)})
        accept.append(_uniform(k_acc, (NT, ns), dtype))
    return perm, noise, accept


def _port_move(tmove, tstate, jks, perm, **draws):
    tmove.init_kernel_state(tstate)
    if perm is not None:
        tmove.draw_perm = _queue([perm])
    for name, items in draws.items():
        setattr(tmove, name, _queue(items))
    return kernel_state_from_numpy(tmove, jks, tstate)


MALA_CASES = [
    (np.float64, {}), (np.float32, {}),
    (np.float64, dict(ensemble_precondition=True)),
    (np.float64, dict(eps={"model_0": np.array([0.3, 0.5, 0.7])},
                      tune_steps=0)),
    (np.float64, dict(tune_steps=3)),  # past its tuning: frozen
]


@pytest.mark.parametrize("dtype,kw", MALA_CASES)
def test_mala_step_matches_jax(dtype, kw):
    periodic = {"model_0": {1: 3.0}} if "eps" in kw else None
    key = jax.random.key(11)
    with jax.enable_x64(dtype == np.float64):
        jctx, jstate, tctx, tstate = pair(dtype, seed=2)
        jmove = jm.MALAMove(**kw, periodic=periodic and
                            eryn_tpu.utils.PeriodicContainer(periodic))
        jks = jmove.init_kernel_state(jstate)
        if kw.get("tune_steps") == 3:
            jks = {**jks, "t": jnp.asarray(5, jnp.int32),
                   "log_scale_avg": jnp.asarray(0.3, jnp.dtype(dtype))}
        jout = jmove._propose_impl(key, jstate, jctx, jks)
        perm, noise, accept = _mala_draws(key, dtype,
                                          kw.get("ensemble_precondition"))
    tmove = tm.MALAMove(**kw, periodic=periodic)
    tks = _port_move(tmove, tstate, jks, perm, draw_noise=noise,
                     draw_accept=accept)
    tout = tmove._propose_impl(None, tstate, tctx, tks)
    assert_same_step(jout, tout, TOL[dtype][0])
    assert 0 < np.asarray(jout[1]).mean() < 1


def _hmc_draws(key, dtype, precond, jittered, recorded):
    """eryn_tpu's HMC draws (``hmc.py:129-151, 195-210``): momenta per
    trajectory, the recorded lengths, accept uniforms."""
    perm, key = _jax_split_draws(key, precond, NW)
    blocks = [NW] if not precond else [NW - NW // 2, NW // 2]
    momenta, lengths, accept = [], [], []
    for ns in blocks:
        if precond:
            key, k_acc = jax.random.split(key)
        key, k_p = jax.random.split(key)
        kp = jax.random.split(k_p, 1)[0]
        momenta.append({"model_0": _normal(kp, (NT, ns, 1, NDIM), dtype)})
        if jittered:
            key, _ = jax.random.split(key)
            lengths.append(_t(recorded.pop(0)))
        else:
            lengths.append(None)
        if not precond:
            key, k_acc = jax.random.split(key)
        accept.append(_uniform(k_acc, (NT, ns), dtype))
    return perm, momenta, lengths, accept


HMC_CASES = [
    (np.float64, {}), (np.float32, {}),
    (np.float64, dict(num_leapfrog=(2, 6))),
    (np.float32, dict(num_leapfrog=(2, 6))),
    (np.float64, dict(ensemble_precondition=True)),
    (np.float64, dict(ensemble_precondition=True, num_leapfrog=(1, 4))),
    (np.float64, dict(eps=0.9, tune_steps=0)),
]


@pytest.mark.parametrize("dtype,kw", HMC_CASES)
def test_hmc_step_matches_jax(dtype, kw, record_randint):
    key = jax.random.key(5)
    precond = kw.get("ensemble_precondition", False)
    jittered = "num_leapfrog" in kw
    with jax.enable_x64(dtype == np.float64):
        jctx, jstate, tctx, tstate = pair(dtype, seed=3)
        jmove = jm.HMCMove(**kw)
        jks = jmove.init_kernel_state(jstate)
        jout = jmove._propose_impl(key, jstate, jctx, jks)
        perm, momenta, lengths, accept = _hmc_draws(
            key, dtype, precond, jittered, record_randint)
    if jittered:  # the lengths span the range
        assert {int(v) for v in torch.cat([x.ravel() for x in lengths])} == set(
            range(kw["num_leapfrog"][0], kw["num_leapfrog"][1] + 1))
    tmove = tm.HMCMove(**kw)
    tks = _port_move(tmove, tstate, jks, perm, draw_momenta=momenta,
                     draw_lengths=lengths, draw_accept=accept)
    tout = tmove._propose_impl(None, tstate, tctx, tks)
    assert_same_step(jout, tout, TOL[dtype][1])
    assert 0 < np.asarray(jout[1]).mean() < 1


def test_halton_matches_jax():
    t = np.concatenate([np.arange(0, 2000), [2 ** 31 - 2, 123456789]])
    from eryn_tpu.moves.chees import _halton2 as jax_halton

    want = np.asarray(jax_halton(jnp.asarray(t, jnp.int32)))
    got = _halton2(torch.as_tensor(t, dtype=torch.int32), torch.float32)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0] == 0.5 and got[1] == 0.25 and got[2] == 0.75


def _chees_setup(dtype, L, tune_steps=500):
    """Both packages' ChEES move and kernel state, ``log_T`` set so that
    the first proposal (Halton jitter 0.5) integrates ``L`` steps."""
    jctx, jstate, tctx, tstate = pair(dtype, seed=6)
    jmove = jm.ChEESHMCMove(tune_steps=tune_steps)
    jks = jmove.init_kernel_state(jstate)
    eps_time = float(jks["eps_time_base"])
    jks = {**jks, "log_T": jnp.asarray(np.log(eps_time * (2 * L - 0.5)),
                                       jnp.dtype(dtype))}
    return jctx, jstate, tctx, tstate, jmove, jks


@pytest.mark.parametrize("L,dtype", [(1, np.float64), (7, np.float64),
                                     (32, np.float64), (7, np.float32)])
def test_chees_masked_loop_matches_the_while_loop(L, dtype):
    """``max_leapfrog = 32`` masked iterations against eryn_tpu's
    ``while_loop`` of ``L``: the same endpoint, decisions, Adam moments and
    ``log T``; the port's device counter adds ``L``."""
    key = jax.random.key(8)
    with jax.enable_x64(dtype == np.float64):
        jctx, jstate, tctx, tstate, jmove, jks = _chees_setup(dtype, L)
        jout = jax.jit(lambda k, s, ks: jmove._propose_impl(k, s, jctx, ks))(
            key, jstate, jks)
        _, k_p, k_acc = jax.random.split(key, 3)
        kp = jax.random.split(k_p, 1)[0]
        momenta = [{"model_0": _normal(kp, (NT, NW, 1, NDIM), dtype)}]
        accept = [_uniform(k_acc, (NT, NW), dtype)]
    tmove = tm.ChEESHMCMove()
    tks = _port_move(tmove, tstate, jks, None, draw_momenta=momenta,
                     draw_accept=accept)
    assert float(_halton2(tks["t"], TORCH[dtype])) == 0.5
    tout = tmove._propose_impl(None, tstate, tctx, tks)
    assert_same_step(jout, tout, TOL[dtype][1])
    assert int(tmove.leapfrog_total) == L
    # a trajectory of L steps moved the walkers: not the start, and a
    # different endpoint for another L
    assert not np.allclose(tout[0].branches["model_0"].coords,
                           tstate.branches["model_0"].coords)


def test_chees_frozen_after_tuning_matches_jax():
    """Past ``tune_steps`` the step size is the averaged one and ``log T``
    and the Adam moments stay; the jitter counter still moves the length
    (``tune_steps=0``: the move advances it itself)."""
    key = jax.random.key(9)
    for tune_steps, t in ((20, 25), (0, 4)):
        with jax.enable_x64(True):
            jctx, jstate, tctx, tstate, jmove, jks = _chees_setup(
                np.float64, 9, tune_steps=tune_steps)
            jks = {**jks, "t": jnp.asarray(t, jnp.int32),
                   "log_scale_avg": jnp.asarray(-0.2, jnp.float64),
                   "adam_m": jnp.asarray(0.1, jnp.float64)}
            jout = jmove._propose_impl(key, jstate, jctx, jks)
            _, k_p, k_acc = jax.random.split(key, 3)
            kp = jax.random.split(k_p, 1)[0]
            momenta = [{"model_0": _normal(kp, (NT, NW, 1, NDIM), np.float64)}]
            accept = [_uniform(k_acc, (NT, NW), np.float64)]
        tmove = tm.ChEESHMCMove(tune_steps=tune_steps)
        tks = _port_move(tmove, tstate, jks, None, draw_momenta=momenta,
                         draw_accept=accept)
        tout = tmove._propose_impl(None, tstate, tctx, tks)
        assert_same_step(jout, tout, TOL[np.float64][1])
        assert int(tout[2]["t"]) == t + 1


@pytest.mark.parametrize("kind", ["mala", "hmc", "chees"])
def test_kernel_state_from_eryn_tpu(kind):
    """``interop.kernel_state_from_numpy`` takes eryn_tpu's kernel state
    after a few tuned proposals leaf for leaf (sorted keys: the step-size
    base per branch, the dual-averaging clock and iterates, and ChEES's
    ``log_T`` and Adam moments)."""
    cls = {"mala": (jm.MALAMove, tm.MALAMove), "hmc": (jm.HMCMove, tm.HMCMove),
           "chees": (jm.ChEESHMCMove, tm.ChEESHMCMove)}[kind]
    with jax.enable_x64(True):
        jctx, jstate, tctx, tstate = pair(np.float64, seed=1)
        jmove = cls[0]()
        jks = jmove.init_kernel_state(jstate)
        step = jax.jit(lambda k, s, ks: jmove._propose_impl(k, s, jctx, ks))
        for i in range(3):
            jstate, _, jks = step(jax.random.key(i), jstate, jks)
    tmove = cls[1]()
    tks = kernel_state_from_numpy(tmove, jks, tstate)
    assert sorted(tks) == sorted(jks)
    assert int(tks["t"]) == 3 and tks["t"].dtype == torch.int32
    for a, b in zip(kernel_state_to_numpy(tks), kernel_state_to_numpy(jks)):
        np.testing.assert_array_equal(a, np.asarray(b).astype(a.dtype))
    # the port's fresh kernel state has the same structure and numbers
    fresh = kernel_state_to_numpy(tmove.init_kernel_state(tstate))
    with jax.enable_x64(True):
        jfresh = kernel_state_to_numpy(jmove.init_kernel_state(
            pair(np.float64, seed=1)[1]))
    for a, b in zip(fresh, jfresh):
        close(a, b, TOL[np.float64][0])


# ----------------------------------------------------------------------
# statistics and resume
# ----------------------------------------------------------------------
GRAD_MOVES = {
    "mala": lambda: tm.MALAMove(tune_steps=100),
    "mala precond": lambda: tm.MALAMove(tune_steps=100,
                                        ensemble_precondition=True),
    "hmc": lambda: tm.HMCMove(tune_steps=100),
    "hmc jittered": lambda: tm.HMCMove(num_leapfrog=(2, 6), tune_steps=100),
    "chees": lambda: tm.ChEESHMCMove(max_leapfrog=8, tune_steps=100),
}


@pytest.mark.parametrize("kind", list(GRAD_MOVES))
def test_gradient_moves_sample_the_tempered_gaussian(kind):
    """3 x 32 walkers, 3-D unit Gaussian in U(-5, 5)^3: after 100 tuning
    steps, 300 stored; the cold chain's mean within 0.15 and variance
    within 0.2 of the target's, the acceptance inside (0.2, 0.98) (a short
    tuning leaves HMC above its target: eryn_tpu here accepts 0.78-0.96
    of HMC's proposals and 0.62-0.63 of MALA's, seeds 4 and 5)."""
    pr = et.ProbDistContainer({i: et.uniform_dist(-5.0, 5.0)
                               for i in range(NDIM)})
    move = GRAD_MOVES[kind]()
    s = et.EnsembleSampler(32, NDIM, _ll_t, pr, moves=move,
                           tempering_kwargs=dict(ntemps=NT), seed=4,
                           device="cpu")
    s.run_mcmc(pr.rvs(size=(NT, 32), generator=torch.Generator().manual_seed(4)),
               300, burn=100)
    cold = s.get_chain(temp_index=0)["model_0"].reshape(-1, NDIM)
    assert np.all(np.abs(cold.mean(axis=0)) < 0.15), cold.mean(axis=0)
    assert np.all(np.abs(cold.var(axis=0) - 1.0) < 0.2), cold.var(axis=0)
    acc = float(s.acceptance_fraction[0].mean())
    assert 0.2 < acc < 0.98, acc
    if kind == "chees":
        mean_L = float(move.leapfrog_total) / move.num_proposals
        assert 1.0 <= mean_L <= 8.0


RESUME_MOVES = {
    "chees": lambda: tm.ChEESHMCMove(max_leapfrog=8, tune_steps=25),
    "mala": lambda: tm.MALAMove(tune_steps=25),
    "slice": lambda: tm.SliceMove(tune_steps=25),
    "aimh": lambda: tm.AIMHMove(tune_steps=25),
}


@pytest.mark.parametrize("kind", list(RESUME_MOVES))
def test_resume_mid_tuning_digit_for_digit(tmp_path, kind):
    """20 stored steps into ``HDFBackend`` (inside the 25 tuning
    proposals), then 20 more by a fresh sampler (another seed) on the
    file, against 40 in one run, in segments of 5: chains, log-likelihoods,
    accept counts, the clock and the kernel states (dual-averaging clock and
    iterates, ``log T`` and Adam moments; slice's ``mu``; AIMH's weights and
    moments) equal digit for digit."""
    pr = et.ProbDistContainer({i: et.uniform_dist(-5.0, 5.0)
                               for i in range(NDIM)})

    def build(backend, seed=3):
        s = et.EnsembleSampler(16, NDIM, _ll_t, pr, moves=RESUME_MOVES[kind](),
                               tempering_kwargs=dict(ntemps=NT), seed=seed,
                               device="cpu", backend=backend)
        return s, pr.rvs(size=(NT, 16), generator=torch.Generator().manual_seed(1))

    def record(s):
        return dict(chain=s.get_chain()["model_0"], log_like=s.get_log_like(),
                    accepted=s.backend.accepted, betas=s.get_betas(),
                    clock=int(s.temperature_control.time),
                    ks=kernel_state_to_numpy(s._kernel_states))

    fn = str(tmp_path / f"{kind}.h5")
    full, start = build(Backend())
    full.run_mcmc(start, 40, segment_size=5)
    first, start = build(HDFBackend(fn))
    first.run_mcmc(start, 20, segment_size=5)
    assert int(first._kernel_states[0]["t"]) == 20
    del first
    resumed, _ = build(HDFBackend(fn), seed=99)
    resumed.run_mcmc(None, 20, segment_size=5)
    a, b = record(resumed), record(full)
    for key in ("chain", "log_like", "accepted", "betas", "clock"):
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert len(a["ks"]) == len(b["ks"])
    for x, y in zip(a["ks"], b["ks"]):
        np.testing.assert_array_equal(x, y)
    assert int(resumed._kernel_states[0]["t"]) == 40
