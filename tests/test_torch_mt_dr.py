"""The port's delayed rejection, combination and multiple-try moves
(``DelayedRejection``, ``CombineMove``, ``MultipleTryMove``,
``MTDistGenMove``, ``MTDistGenMoveRJ``, ``get_mt_computations``) against
eryn_tpu.

* Decision for decision: each move of eryn_tpu runs from a JAX key; its
  draws are rebuilt with the same ``jax.random.split`` sequence and the
  same ``uniform`` / ``normal`` / ``gumbel`` calls (the prior containers'
  ``sample``) on the same subkeys, and handed to the port's function of
  the draws.  Decisions, picks and new leaf masks identical; coordinates,
  weights, factors, log-likelihoods and log-priors within rtol 1e-5 / atol
  1e-6 (float32; ``exp``, ``log`` and ``logsumexp`` round differently in
  the two libraries).  ``jax.random.categorical`` is the argmax of the
  weights plus ``jax.random.gumbel`` noise, so the port gets that noise.
* Statistically: the port's counterparts of ``tests/test_mt_dr.py`` at a
  smaller depth, with the same gates.
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
from eryn_tpu_torch.moves.multipletry import categorical_pick, gumbel_from_uniform

torch.set_num_threads(1)

NT, NW, NDIM = 3, 12, 3


def close(a, b):
    np.testing.assert_allclose(np.asarray(a, dtype=np.float64),
                               np.asarray(b, dtype=np.float64),
                               rtol=1e-5, atol=1e-6)


def jit_step(jmove, jctx):
    """eryn_tpu's ``_propose_impl`` of ``jmove`` compiled once: a compiled
    call costs a fraction of an eager one here."""
    return jax.jit(lambda key, state, ks: jmove._propose_impl(key, state, jctx, ks))


def _queue(items):
    it = iter(items)
    return lambda *args, **kwargs: next(it)


def _t(x):
    return torch.from_numpy(np.array(x))


def _ll_j(x):
    return -0.5 * jnp.sum(x * x)


def _ll_t(x):
    return -0.5 * torch.sum(x * x)


def pair(ntemps=NT, seed=3, spread=2.0):
    jpr = eryn_tpu.ProbDistContainer(
        {i: eryn_tpu.uniform_dist(-5.0, 5.0) for i in range(NDIM)})
    tpr = et.ProbDistContainer({i: et.uniform_dist(-5.0, 5.0) for i in range(NDIM)})
    tk = dict(tempering_kwargs=dict(ntemps=ntemps)) if ntemps > 1 else {}
    js = eryn_tpu.EnsembleSampler(NW, NDIM, _ll_j, jpr, seed=0, **tk)
    ts = et.EnsembleSampler(NW, NDIM, _ll_t, tpr, seed=0, device="cpu", **tk)
    coords = np.random.default_rng(seed).uniform(
        -spread, spread, (ntemps, NW, 1, NDIM)).astype(np.float32)
    jstate = js._setup_state(eryn_tpu.State({"model_0": coords}))
    tstate = et.State(
        {"model_0": _t(coords)},
        inds={"model_0": torch.ones((ntemps, NW, 1), dtype=torch.bool)},
        log_like=_t(jstate.log_like), log_prior=_t(jstate.log_prior),
        betas=_t(jstate.betas))
    return js.get_eval_context(), jstate, ts.get_eval_context(), tstate


def assert_same_step(jout, tout):
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


def dr_draws(key, max_iter, shape, like_shape):
    """The draws of eryn_tpu's ``DelayedRejection._propose_impl``
    (``moves/delayedrejection.py:268-311``): the candidates' proposal draws
    first, one subkey a stage (a vector-mode ``GaussianMove`` without jitter
    takes its noise from the first of two subkeys,
    ``moves/gaussian.py:112-119``), then one subkey of accept uniforms a
    stage."""

    @jax.jit
    def rebuild(key):
        noise, accept = [], []
        for _ in range(max_iter + 1):
            key, kq = jax.random.split(key)
            k_noise, _ = jax.random.split(kq, 2)
            noise.append(jax.random.normal(k_noise, shape, dtype=jnp.float32))
        for _ in range(max_iter + 1):
            key, ku = jax.random.split(key)
            accept.append(jax.random.uniform(ku, like_shape, dtype=jnp.float32))
        return noise, accept

    noise, accept = rebuild(key)
    return [(_t(x), None, None) for x in noise], [_t(x) for x in accept]


# ----------------------------------------------------------------------
# DelayedRejection and CombineMove
# ----------------------------------------------------------------------
@pytest.mark.parametrize("max_iter", [1, 3])
def test_delayed_rejection_step_matches_jax(max_iter):
    """A wide Gaussian (scale 2.5): most first stages reject, and the
    later stages accept some of those walkers (Mira's alphas)."""
    jctx, jstate, tctx, tstate = pair(spread=1.0)
    cov = {"model_0": 2.5 ** 2}
    key = jax.random.key(31)
    jmove = jm.DelayedRejection(jm.GaussianMove(cov), max_iter=max_iter)
    jout = jit_step(jmove, jctx)(key, jstate, {})
    proposal, accept = dr_draws(key, max_iter, (NT, NW, 1, NDIM), (NT, NW))

    tmove = tm.DelayedRejection(tm.GaussianMove(cov), max_iter=max_iter)
    tmove.proposal.draw_gaussian = _queue(proposal)
    tmove.draw_accept = _queue(accept)
    tout = tmove._propose_impl(None, tstate, tctx, {})
    assert_same_step(jout, tout)

    # the first stage alone accepts fewer walkers: the later stages act
    first = tm.DelayedRejection(tm.GaussianMove(cov), max_iter=0)
    first.proposal.draw_gaussian = _queue(proposal)
    first.draw_accept = _queue(accept)
    acc0 = first._propose_impl(None, tstate, tctx, {})[1]
    assert (tout[1] | ~acc0).all() and tout[1].sum() > acc0.sum()


def test_combine_step_matches_jax():
    """``CombineMove([GroupStretchMove, DelayedRejection(GaussianMove)])``
    at one temperature (no swap phase): each child's draws from its own
    subkeys (``moves/combine.py:78-86``, ``moves/move.py:249``), the
    children's accept flags summed and counted per child."""
    jctx, jstate, tctx, tstate = pair(ntemps=1)
    cov = {"model_0": 0.3}
    key = jax.random.key(41)
    jmove = jm.CombineMove([jm.GroupStretchMove(n_iter_update=2),
                            jm.DelayedRejection(jm.GaussianMove(cov),
                                                max_iter=2)])
    jks = jmove.init_kernel_state(jstate)
    time0 = jnp.asarray(0, jnp.int32)
    jout = jax.jit(lambda k, st, t, ks: jmove.propose_kernel(k, st, t, jctx, ks))(
        key, jstate, time0, jks)

    tmove = tm.CombineMove([tm.GroupStretchMove(n_iter_update=2),
                            tm.DelayedRejection(tm.GaussianMove(cov),
                                                max_iter=2)])
    tks = tmove.init_kernel_state(tstate)
    group, dr = tmove.moves
    shape = (1, NW)

    @jax.jit
    def rebuild(key):
        key, sub = jax.random.split(key)
        _, k_prop, _ = jax.random.split(sub, 3)
        _, kprop, kacc = jax.random.split(k_prop, 3)
        key_z, kb = jax.random.split(kprop, 2)
        key, sub = jax.random.split(key)
        _, k_prop_dr, _ = jax.random.split(sub, 3)
        return (k_prop_dr, jax.random.uniform(key_z, shape),
                jax.random.uniform(kb, shape), jax.random.uniform(kacc, shape))

    k_prop_dr, *draws = rebuild(key)
    stretch, friends, accept = [_t(x) for x in draws]
    group.draw_stretch = _queue([stretch])
    group.draw_friends = _queue([friends])
    group.draw_accept = _queue([accept])
    proposal, accept = dr_draws(k_prop_dr, 2, (1, NW, 1, NDIM), shape)
    dr.proposal.draw_gaussian = _queue(proposal)
    dr.draw_accept = _queue(accept)
    tout = tmove.propose_kernel(None, tstate, torch.tensor(0), tctx, tks)

    assert_same_step((jout[0], jout[1] > 0), (tout[0], tout[1] > 0))
    np.testing.assert_array_equal(tout[1].numpy(), np.asarray(jout[1]))
    per_child_j, per_child_t = jout[4][1], tout[4][1]
    np.testing.assert_array_equal(per_child_t.numpy(), np.asarray(per_child_j))
    assert (per_child_t.sum(0) == tout[1]).all()


# ----------------------------------------------------------------------
# multiple try
# ----------------------------------------------------------------------
def test_gumbel_and_pick_are_jax_categorical():
    key = jax.random.key(2)
    u = jax.random.uniform(key, (50, 7))
    close(gumbel_from_uniform(_t(u)), jax.random.gumbel(key, (50, 7)))
    logw = np.random.default_rng(0).normal(size=(50, 7)).astype(np.float32)
    logw[3] = -np.inf  # a row that is -inf throughout picks 0
    logw[4, 2:] = -np.inf
    j, one_hot = categorical_pick(_t(logw), _t(jax.random.gumbel(key, (50, 7))))
    np.testing.assert_array_equal(
        j.numpy(), np.asarray(jax.random.categorical(key, jnp.asarray(logw))))
    assert j[3] == 0 and j[4] < 2
    assert (one_hot.sum(-1) == 1).all()


def test_get_mt_computations_matches_jax():
    rng = np.random.default_rng(4)
    logP = rng.normal(size=(20, 6))
    logq = rng.normal(size=(20, 6))
    for symmetric in (False, True):
        np.random.seed(7)
        out_j = jm.multipletry.get_mt_computations(logP, logq, symmetric)
        np.random.seed(7)
        out_t = tm.get_mt_computations(logP, logq, symmetric)
        for a, b in zip(out_t, out_j):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _normal_pair(pkg, loc, scale):
    return pkg.ProbDistContainer(
        {i: pkg.prior.normal_dist(loc, scale) for i in range(NDIM)})


@pytest.mark.parametrize("independent", [True, False])
def test_mt_distgen_matches_jax(independent):
    """``MTDistGenMove(num_try=6)`` with a normal generator (the weights
    ``logP - logq`` vary), independent (the chosen slot of the auxiliary
    set holds the current point) or not (a second set drawn from the
    chosen point): tries, weights, the pick, the factors, the decisions."""
    jctx, jstate, tctx, tstate = pair(seed=6)
    T = 6
    key = jax.random.key(51)
    jmove = jm.MTDistGenMove({"model_0": _normal_pair(eryn_tpu, 0.5, 1.5)},
                             num_try=T, independent=independent)
    jout = jit_step(jmove, jctx)(key, jstate, ())
    gen = _normal_pair(eryn_tpu, 0.5, 1.5)

    @jax.jit
    def rebuild(key):
        # moves/mtdistgen.py:188-193, moves/multipletry.py:140-183
        _, k_mt, k_acc = jax.random.split(key, 3)
        key_gen, key_pick, key_aux = jax.random.split(k_mt, 3)
        return (k_mt, gen.sample(key_gen, (NT, NW, T)),
                gen.sample(key_aux, (NT, NW, T)),
                jax.random.gumbel(key_pick, (NT, NW, T), dtype=jnp.float32),
                jax.random.uniform(k_acc, (NT, NW), dtype=jnp.float32))

    k_mt, *draws = rebuild(key)
    sel_j = jax.jit(lambda k, st: jmove.mt_select_kernel(k, st, jctx))(k_mt, jstate)
    tries0, tries1, gumbel, accept = [_t(x) for x in draws]
    tries = [tries0] if independent else [tries0, tries1]

    tmove = tm.MTDistGenMove({"model_0": _normal_pair(et, 0.5, 1.5)},
                             num_try=T, independent=independent)
    tmove.draw_tries = _queue(tries)
    tmove.draw_gumbel = _queue([gumbel])
    sel_t = tmove.mt_select_kernel(None, tstate, tctx)
    for a, b in zip(sel_t, sel_j):
        close(a, b)
    tmove.draw_tries = _queue(tries)
    tmove.draw_gumbel = _queue([gumbel])
    tmove.draw_accept = _queue([accept])
    tout = tmove._propose_impl(None, tstate, tctx, ())
    assert_same_step(jout, tout)
    assert 0 < tout[1].float().mean() < 1


def _leaf_ll_j(c, m):
    return jnp.sum(jnp.where(m, -0.5 * jnp.sum(c * c, axis=-1) + 3.0, 0.0))


def _leaf_ll_t(c, m):
    return torch.sum(torch.where(m, -0.5 * torch.sum(c * c, dim=-1) + 3.0, 0.0))


@pytest.mark.parametrize("fix_change", [None, -1])
def test_mt_rj_matches_jax(fix_change):
    """``MTDistGenMoveRJ(num_try=5)`` on one branch of up to 3 leaves, with
    walkers at both edges of the leaf-count range: births pick among the
    tries, deaths take the removed leaf as try 0 and invert the factors."""
    nl, T = 3, 5
    rng = np.random.default_rng(8)
    coords = rng.uniform(-2, 2, (NT, NW, nl, NDIM)).astype(np.float32)
    inds = rng.random((NT, NW, nl)) < 0.5
    inds[:, 0] = False
    inds[:, 1] = True
    inds[:, 2, 0] = True
    bounds = [(-4.0, 4.0)] * NDIM
    jpr = eryn_tpu.ProbDistContainer(
        {i: eryn_tpu.uniform_dist(*b) for i, b in enumerate(bounds)})
    tpr = et.ProbDistContainer({i: et.uniform_dist(*b) for i, b in enumerate(bounds)})
    kw = dict(nleaves_max=nl, nleaves_min=0, tempering_kwargs=dict(ntemps=NT),
              fill_zero_leaves_val=0.0)
    js = eryn_tpu.EnsembleSampler(NW, NDIM, _leaf_ll_j, jpr, rj_moves=True,
                                  seed=0, **kw)
    ts = et.EnsembleSampler(NW, NDIM, _leaf_ll_t, tpr, rj_moves=True, seed=0,
                            device="cpu", **kw)
    jstate = js._setup_state(eryn_tpu.State({"model_0": coords},
                                            inds={"model_0": inds}))
    tstate = et.State({"model_0": _t(jstate.branches["model_0"].coords)},
                      inds={"model_0": _t(inds)},
                      log_like=_t(jstate.log_like),
                      log_prior=_t(jstate.log_prior), betas=_t(jstate.betas))
    rj = dict(nleaves_max={"model_0": nl}, nleaves_min={"model_0": 0},
              num_try=T, fix_change=fix_change)
    jmove = jm.MTDistGenMoveRJ({"model_0": jpr}, **rj)
    key = jax.random.key(61)
    jout = jmove._propose_impl(key, jstate, js.get_eval_context(), ())

    @jax.jit
    def rebuild(key):
        # moves/mtdistgenrj.py:213-300 and rj_change_kernel (moves/rj.py:42)
        _, k_change, k_draw, k_pick, k_acc = jax.random.split(key, 5)
        k_u, k_slot = jax.random.split(k_change)
        return (jax.random.uniform(k_u, (NT, NW)),
                jax.random.gumbel(k_slot, (NT, NW, nl)),
                jpr.sample(k_draw, (NT, NW, T)),
                jax.random.gumbel(k_pick, (NT, NW, T), dtype=jnp.float32),
                jax.random.uniform(k_acc, (NT, NW)))

    *draws, accept = [_t(x) for x in rebuild(key)]
    tmove = tm.MTDistGenMoveRJ({"model_0": tpr}, **rj)
    tmove.draw_mtrj = _queue([tuple(draws)])
    tmove.draw_accept = _queue([accept])
    tout = tmove._propose_impl(None, tstate, ts.get_eval_context(), ())
    assert_same_step(jout, tout)
    change = tout[0].branches["model_0"].inds.sum(-1) - torch.tensor(inds).sum(-1)
    assert (change == -1).any()
    if fix_change is None:
        assert (change == 1).any()
    # a death that was accepted removed a leaf and kept the others as they
    # were: the removed leaf is try 0, no new coordinates
    died = (change == -1).numpy()
    np.testing.assert_array_equal(
        tout[0].branches["model_0"].coords.numpy()[died],
        np.asarray(jstate.branches["model_0"].coords)[died])


def test_mt_rj_mixin_select_raises():
    move = tm.MultipleTryMoveRJ(num_try=2)
    assert move.mt_rj
    with pytest.raises(NotImplementedError, match="MTDistGenMoveRJ"):
        move.mt_select_kernel(None, None, None)
    with pytest.raises(ValueError, match="symmetric and independent"):
        tm.MultipleTryMove(rj=True, independent=True)


# ----------------------------------------------------------------------
# statistically (tests/test_mt_dr.py at a smaller depth)
# ----------------------------------------------------------------------
def _priors():
    return et.ProbDistContainer({i: et.uniform_dist(-6, 6) for i in range(NDIM)})


def _start(nt, seed=0, scale=None):
    g = torch.Generator().manual_seed(seed)
    if scale is None:
        return _priors().rvs(size=(nt, 32), generator=g)
    return scale * torch.randn((32, NDIM), generator=g)


def _cold(s):
    return s.get_chain(temp_index=0)["model_0"].reshape(-1, NDIM)


def test_mt_distgen_statistics():
    move = tm.MTDistGenMove({"model_0": _priors()}, num_try=10,
                            independent=True)
    s = et.EnsembleSampler(32, NDIM, _ll_t, _priors(), moves=[move],
                           tempering_kwargs=dict(ntemps=3), seed=12,
                           device="cpu")
    s.run_mcmc(_start(3), 250, burn=100)
    chain = _cold(s)
    assert np.abs(chain.mean(axis=0)).max() < 0.25
    assert np.abs(chain.std(axis=0) - 1.0).max() < 0.25
    assert s.acceptance_fraction.mean() > 0.1


def test_mt_distgen_nonindependent_unbiased():
    gen = et.ProbDistContainer({i: et.normal_dist(1.5, 1.2) for i in range(NDIM)})
    move = tm.MTDistGenMove({"model_0": gen}, num_try=8, independent=False)
    s = et.EnsembleSampler(32, NDIM, _ll_t, _priors(), moves=[move], seed=21,
                           device="cpu")
    s.run_mcmc(_start(1, scale=0.1), 400, burn=150)
    chain = _cold(s)
    assert np.abs(chain.mean(axis=0)).max() < 0.08
    assert np.abs(chain.std(axis=0) - 1.0).max() < 0.15


def test_mt_state_dependent_generator():
    """Tries from N(rho x + shift, sig^2), anchored on the current point:
    the auxiliary set must be drawn from the chosen point."""
    rho, shift, sig = 0.7, 0.5, 1.0
    log2pi = float(np.log(2 * np.pi))

    class ARGenMT(tm.MTDistGenMove):
        def _mean(self, state):
            return rho * state.branches[self.key_in].coords[:, :, 0] + shift

        def special_generate_kernel(self, generator, state, num_try):
            mean = self._mean(state)
            nt, nw, ndim = mean.shape
            eps = torch.randn((nt, nw, num_try, ndim), generator=generator,
                              dtype=mean.dtype)
            tries = mean[:, :, None, :] + sig * eps
            d = (tries - mean[:, :, None, :]) / sig
            return tries, -0.5 * torch.sum(d ** 2 + log2pi + 2 * np.log(sig),
                                           dim=-1)

        def special_generate_logpdf_kernel(self, state, coords=None):
            mean = self._mean(state)
            if coords is None:
                coords = state.branches[self.key_in].coords[:, :, 0]
            d = (coords - mean) / sig
            return -0.5 * torch.sum(d ** 2 + log2pi + 2 * np.log(sig), dim=-1)

    gen = et.ProbDistContainer({i: et.normal_dist(0.0, 1.0) for i in range(NDIM)})
    move = ARGenMT({"model_0": gen}, num_try=6, independent=False)
    s = et.EnsembleSampler(32, NDIM, _ll_t, _priors(), moves=[move], seed=31,
                           device="cpu")
    s.run_mcmc(_start(1, scale=0.1), 450, burn=150)
    chain = _cold(s)
    assert np.abs(chain.mean(axis=0)).max() < 0.08
    assert np.abs(chain.std(axis=0) - 1.0).max() < 0.12


def test_mt_rj_finds_the_pulse():
    rng = np.random.default_rng(5)
    t_np = np.linspace(0, 10, 100)
    sigma = 0.3
    data_np = 3.0 * np.exp(-((t_np - 5.0) ** 2) / (2 * 0.7**2))
    data_np = data_np + sigma * rng.standard_normal(len(t_np))
    t = torch.tensor(t_np, dtype=torch.float32)
    data = torch.tensor(data_np, dtype=torch.float32)

    def ll(coords, inds):
        a, b, c = coords[:, 0], coords[:, 1], coords[:, 2]
        p = a[:, None] * torch.exp(-((t[None] - b[:, None]) ** 2)
                                   / (2 * c[:, None] ** 2))
        tmpl = torch.sum(torch.where(inds[:, None], p, 0.0), dim=0)
        return -0.5 * torch.sum(((tmpl - data) / sigma) ** 2)

    pr = et.ProbDistContainer({0: et.uniform_dist(0.5, 5.0),
                               1: et.uniform_dist(0.0, 10.0),
                               2: et.uniform_dist(0.2, 2.0)})
    nlmax = 2
    rj_move = tm.MTDistGenMoveRJ({"model_0": pr},
                                 nleaves_max={"model_0": nlmax},
                                 nleaves_min={"model_0": 0}, num_try=8)
    s = et.EnsembleSampler(
        32, 3, ll, pr, nleaves_max=nlmax, nleaves_min=0, rj_moves=[rj_move],
        tempering_kwargs=dict(ntemps=3),
        fill_zero_leaves_val=float(-0.5 * np.sum((data_np / sigma) ** 2)),
        seed=13, device="cpu")
    g = torch.Generator().manual_seed(13)
    state = et.State(pr.rvs(size=(3, 32, nlmax), generator=g),
                     inds=torch.rand((3, 32, nlmax), generator=g) < 0.5)
    s.run_mcmc(state, 150, burn=100)
    assert s.get_nleaves()["model_0"][:, 0].mean() > 0.9
    assert s.rj_acceptance_fraction is not None


def test_delayed_rejection_statistics():
    inner = tm.GaussianMove({"model_0": 2.5 * np.ones(NDIM)})
    s = et.EnsembleSampler(32, NDIM, _ll_t, _priors(),
                           moves=[tm.DelayedRejection(inner, max_iter=3)],
                           seed=14, device="cpu")
    s.run_mcmc(_start(1, scale=0.1), 300, burn=100)
    chain = _cold(s)
    assert np.abs(chain.mean(axis=0)).max() < 0.3
    assert np.abs(chain.std(axis=0) - 1.0).max() < 0.3
    plain = et.EnsembleSampler(
        32, NDIM, _ll_t, _priors(),
        moves=[tm.GaussianMove({"model_0": 2.5 * np.ones(NDIM)})], seed=14,
        device="cpu")
    plain.run_mcmc(_start(1, scale=0.1), 200, burn=50)
    assert s.acceptance_fraction.mean() > plain.acceptance_fraction.mean()
