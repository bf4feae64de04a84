"""The port's group stretch (``GroupMove``, ``GroupStretchMove``) and config
D, against eryn_tpu.

* Decision for decision: the friend pick (a walker never draws its own
  snapshot column) from eryn_tpu's uniforms, and four whole steps of
  ``GroupStretchMove(n_iter_update=3)`` from one kernel state
  (``interop.kernel_state_from_numpy`` of eryn_tpu's), so that the friends
  table is refreshed at the first and the fourth step and blended away in
  between: decisions, the friends table, the window snapshot and the
  counter identical or within rtol 1e-5 / atol 1e-6 (float32), the draws
  rebuilt with eryn_tpu's ``jax.random.split`` sequence and ``uniform``
  calls.
* Statistically: the port's counterparts of ``tests/test_group.py`` (the
  unit Gaussian; a subclass with its own friend kernels under reversible
  jump) and of ``tests/test_config_d.py`` (the sine and Gaussian pulse,
  ``CombineMove([GroupStretchMove, DelayedRejection(GaussianMove)])``,
  the periodic phase), at a smaller depth, with the same gates.
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
from eryn_tpu_torch.interop import kernel_state_from_numpy, kernel_state_to_numpy
from eryn_tpu_torch.moves.groupstretch import pick_friends

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


@pytest.mark.parametrize("nfriends", [None, 5, 1])
def test_friend_pick_matches_jax(nfriends):
    rng = np.random.default_rng(0)
    coords = rng.normal(size=(NT, NW, 2, NDIM)).astype(np.float32)
    jmove = jm.GroupStretchMove(nfriends=nfriends)
    friends = jmove.setup_friends_kernel({"m": jnp.asarray(coords)}, None)
    key = jax.random.key(3)
    c_j = jmove.find_friends_kernel(key, "m", jnp.asarray(coords), None,
                                    friends)
    u = _t(jax.random.uniform(key, (NT, NW)))
    c_t = pick_friends(u, _t(friends["m"]))
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    if nfriends != 1:
        # no walker with a column of its own picks it
        width = friends["m"].shape[1]
        picked = (c_t.numpy()[:, :, None] == np.asarray(friends["m"])[:, None]
                  ).all(axis=(-1, -2))
        own = picked[:, np.arange(min(width, NW)), np.arange(min(width, NW))]
        assert not own.any()


def _ll_j(x):
    return -0.5 * jnp.sum(x * x)


def _ll_t(x):
    return -0.5 * torch.sum(x * x)


def _pair(periodic):
    jpr = eryn_tpu.ProbDistContainer(
        {i: eryn_tpu.uniform_dist(-5.0, 5.0) for i in range(NDIM)})
    tpr = et.ProbDistContainer({i: et.uniform_dist(-5.0, 5.0) for i in range(NDIM)})
    kw = dict(tempering_kwargs=dict(ntemps=NT))
    js = eryn_tpu.EnsembleSampler(NW, NDIM, _ll_j, jpr, seed=0,
                                  periodic=periodic, **kw)
    ts = et.EnsembleSampler(NW, NDIM, _ll_t, tpr, seed=0, device="cpu",
                            periodic=periodic, **kw)
    coords = np.random.default_rng(5).uniform(
        -2, 2, (NT, NW, 1, NDIM)).astype(np.float32)
    jstate = js._setup_state(eryn_tpu.State({"model_0": coords}))
    tstate = et.State(
        {"model_0": _t(coords)},
        inds={"model_0": torch.ones((NT, NW, 1), dtype=torch.bool)},
        log_like=_t(jstate.log_like), log_prior=_t(jstate.log_prior),
        betas=_t(jstate.betas))
    return js, jstate, ts, tstate


def _group_draws(key, names, shape):
    """The draws of eryn_tpu's ``GroupMove._propose_impl`` with one Gibbs
    split (``moves/group.py:167-169``) and ``GroupStretchMove.
    group_proposal_kernel`` (``moves/groupstretch.py:105-108``,
    ``find_friends_kernel`` ``:86``): the stretch uniforms, per branch the
    friend uniforms, the accept uniforms."""
    @jax.jit
    def rebuild(key):
        _, kprop, kacc = jax.random.split(key, 3)
        key_z, *branch_keys = jax.random.split(kprop, 1 + len(names))
        return (jax.random.uniform(key_z, shape, dtype=jnp.float32),
                [jax.random.uniform(kb, shape) for kb in branch_keys],
                jax.random.uniform(kacc, shape, dtype=jnp.float32))

    stretch, friends, accept = rebuild(key)
    return _t(stretch), [_t(x) for x in friends], _t(accept)


@pytest.mark.parametrize("case", ["plain", "periodic, 8 friends"])
def test_group_stretch_steps_match_jax(case):
    periodic = {"model_0": {1: 3.0}} if case != "plain" else None
    nfriends = 8 if case != "plain" else None
    js, jstate, ts, tstate = _pair(periodic)
    jctx, tctx = js.get_eval_context(), ts.get_eval_context()
    jmove = jm.GroupStretchMove(n_iter_update=3, nfriends=nfriends,
                                periodic=js.periodic)
    tmove = tm.GroupStretchMove(n_iter_update=3, nfriends=nfriends,
                                periodic=ts.periodic)
    jks = jmove.init_kernel_state(jstate)
    tks = kernel_state_from_numpy(tmove, jks, tstate)
    key = jax.random.key(21)
    accepted = []
    jstep = jit_step(jmove, jctx)
    for step in range(4):
        key, sub = jax.random.split(key)
        jstate, jacc, jks = jstep(sub, jstate, jks)
        stretch, friends, accept = _group_draws(sub, ["model_0"], (NT, NW))
        tmove.draw_stretch = _queue([stretch])
        tmove.draw_friends = _queue(friends)
        tmove.draw_accept = _queue([accept])
        tstate, tacc, tks = tmove._propose_impl(None, tstate, tctx, tks)
        np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
        close(tstate.branches["model_0"].coords,
              jstate.branches["model_0"].coords)
        close(tstate.log_like, jstate.log_like)
        for a, b in zip(kernel_state_to_numpy(tks), kernel_state_to_numpy(jks)):
            assert a.dtype == b.dtype
            close(a, b)
        accepted.append(tacc.numpy().mean())
        # the friends are the snapshot of the last refresh (steps 0 and 3)
        snap = tks["snap_coords"]["model_0"]
        table = tks["friends"]["model_0"]
        np.testing.assert_array_equal(table.numpy(),
                                      snap[:, :nfriends].numpy())
        assert int(tks["iter"]) == step + 1
        if step in (1, 2):
            assert not torch.equal(snap, tstate.branches["model_0"].coords)
    assert 0 < np.mean(accepted) < 1


def test_group_stretch_launches_no_stretch_kernel(monkeypatch):
    """GroupStretchMove takes GroupMove's proposal, never StretchMove's
    kernel path, even when the kernels are forced."""
    from eryn_tpu_torch.ops import stretch_kernels as sk

    def forbidden(*args, **kwargs):
        raise AssertionError("a stretch kernel was called")

    for name in ("stretch_propose", "stretch_accept_propose", "stretch_accept"):
        monkeypatch.setattr(sk, name, forbidden)
        monkeypatch.setattr(tm.stretch, name, forbidden)
    move = tm.GroupStretchMove()
    move.use_kernels = True
    assert type(move)._propose_impl is tm.GroupMove._propose_impl
    pr = et.ProbDistContainer({i: et.uniform_dist(-5.0, 5.0) for i in range(NDIM)})
    s = et.EnsembleSampler(NW, NDIM, _ll_t, pr, moves=move, seed=1,
                           tempering_kwargs=dict(ntemps=NT), device="cpu")
    s.run_mcmc(pr.rvs(size=(NT, NW), generator=torch.Generator().manual_seed(1)),
               5)


# ----------------------------------------------------------------------
# statistically
# ----------------------------------------------------------------------
def test_group_stretch_gaussian():
    pr = et.ProbDistContainer({i: et.uniform_dist(-8.0, 8.0) for i in range(NDIM)})
    s = et.EnsembleSampler(40, NDIM, _ll_t, pr,
                           moves=tm.GroupStretchMove(n_iter_update=25),
                           seed=9, device="cpu")
    start = 0.1 * torch.randn((40, NDIM), generator=torch.Generator().manual_seed(9))
    s.run_mcmc(start, 400, burn=200)
    chain = s.get_chain()["model_0"].reshape(-1, NDIM)
    assert np.abs(chain.mean(axis=0)).max() < 0.25
    assert np.abs(chain.std(axis=0) - 1.0).max() < 0.25
    assert 0.1 < s.acceptance_fraction.mean() < 0.9


class MeanFriends(tm.GroupStretchMove):
    """Friends drawn from the half of the stationary group closest in the
    first coordinate (the override hooks, as in ``tests/test_group.py``)."""

    def setup_friends_kernel(self, branches_coords, branches_inds):
        return dict(branches_coords)

    def find_friends_kernel(self, generator, name, s_coords, s_inds, friends):
        table = friends[name]
        ntemps, ns = s_coords.shape[:2]
        nf = table.shape[1]
        d = torch.abs(s_coords[:, :, None, 0, 0] - table[:, None, :, 0, 0])
        k = max(nf // 2, 1)
        idx = torch.topk(-d, k, dim=-1).indices
        pick = torch.randint(0, k, (ntemps, ns, 1), generator=generator)
        chosen = torch.gather(idx, 2, pick)[:, :, 0]
        return torch.gather(
            table, 1, chosen[:, :, None, None].expand(-1, -1, *table.shape[2:]))


def test_group_stretch_custom_friends_under_rj():
    pr = et.ProbDistContainer({0: et.uniform_dist(0.5, 5.0),
                               1: et.uniform_dist(0.0, 10.0)})
    nlmax = 2
    s = et.EnsembleSampler(
        40, 2,
        lambda c, m: -0.5 * torch.sum(torch.where(m[:, None], c ** 2, 0.0)),
        pr, nleaves_max=nlmax, nleaves_min=0, rj_moves=True,
        moves=[MeanFriends(n_iter_update=20)],
        tempering_kwargs=dict(ntemps=3), seed=10, device="cpu")
    g = torch.Generator().manual_seed(10)
    state = et.State(pr.rvs(size=(3, 40, nlmax), generator=g),
                     inds=torch.rand((3, 40, nlmax), generator=g) < 0.5)
    s.run_mcmc(state, 100, burn=50)
    nleaves = s.get_nleaves()["model_0"]
    assert nleaves.min() >= 0 and nleaves.max() <= nlmax
    assert np.all(np.isfinite(s.get_log_like()))


def _config_d_problem():
    """``tests/test_config_d.py:23-57``: 96 points, a Gaussian pulse and a
    sine, noise 0.4."""
    rng = np.random.default_rng(9)
    t_np = np.linspace(0, 10, 96)
    sigma = 0.4
    signal = 2.5 * np.exp(-((t_np - 4.0) ** 2) / (2 * 0.7**2)) + 1.5 * np.sin(
        2 * np.pi * 0.3 * t_np + 0.5)
    data_np = signal + sigma * rng.standard_normal(len(t_np))
    t = torch.tensor(t_np, dtype=torch.float32)
    data = torch.tensor(data_np, dtype=torch.float32)

    def log_like(coords, inds):
        g, s = coords["gauss"], coords["sine"]
        gm, sm = inds["gauss"], inds["sine"]
        pulses = g[:, 0][:, None] * torch.exp(
            -((t[None] - g[:, 1][:, None]) ** 2) / (2 * g[:, 2][:, None] ** 2))
        tmpl = torch.sum(torch.where(gm[:, None], pulses, 0.0), dim=0)
        sines = s[:, 0][:, None] * torch.sin(
            2 * np.pi * s[:, 1][:, None] * t[None] + s[:, 2][:, None])
        tmpl = tmpl + torch.sum(torch.where(sm[:, None], sines, 0.0), dim=0)
        return -0.5 * torch.sum(((tmpl - data) / sigma) ** 2)

    priors = {
        "gauss": et.ProbDistContainer({0: et.uniform_dist(0.5, 5.0),
                                       1: et.uniform_dist(0.0, 10.0),
                                       2: et.uniform_dist(0.2, 2.0)}),
        "sine": et.ProbDistContainer({0: et.uniform_dist(0.3, 4.0),
                                      1: et.uniform_dist(0.05, 1.0),
                                      2: et.uniform_dist(0.0, 2 * np.pi)}),
    }
    return log_like, priors


def test_config_d_group_stretch_with_dr():
    log_like, priors = _config_d_problem()
    move = tm.CombineMove([
        tm.GroupStretchMove(n_iter_update=20),
        tm.DelayedRejection(
            tm.GaussianMove({"gauss": 0.01 * np.ones(3),
                             "sine": 0.01 * np.ones(3)}), max_iter=2),
    ])
    s = et.EnsembleSampler(
        36, {"gauss": 3, "sine": 3}, log_like, priors,
        branch_names=["gauss", "sine"], nleaves_max={"gauss": 1, "sine": 1},
        moves=[move], periodic={"sine": {2: 2 * np.pi}},
        tempering_kwargs=dict(ntemps=3), seed=50, device="cpu")
    g = torch.Generator().manual_seed(50)
    coords = {n: priors[n].rvs(size=(3, 36, 1), generator=g) for n in priors}
    s.run_mcmc(et.State(coords), 200, burn=250)
    chain_g = s.get_chain()["gauss"][:, 0].reshape(-1, 3)
    chain_s = s.get_chain()["sine"][:, 0].reshape(-1, 3)
    assert abs(np.median(chain_g[:, 1]) - 4.0) < 0.4
    assert abs(np.median(chain_s[:, 1]) - 0.3) < 0.05
    assert chain_s[:, 2].min() >= 0.0 and chain_s[:, 2].max() <= 2 * np.pi
    # two swap phases a step, each ticking the clock
    assert int(s.temperature_control.time) == 2 * 450
    sep = move.acceptance_fraction_separate
    assert len(sep) == 2 and all(0 < f.mean() < 1 for f in sep)
    np.testing.assert_allclose(sum(sep), move.acceptance_fraction, rtol=1e-6)
