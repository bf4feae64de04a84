"""The rest of the port's in-model zoo (``DEMove``, ``DESnookerMove``,
``WalkMove``, ``KDEMove``, ``SliceMove``, ``AIMHMove``) against eryn_tpu.

* Decision for decision: eryn_tpu's step runs from a JAX key; its draws
  (the red/blue permutation, normals and uniforms) are rebuilt from the same
  ``jax.random.split`` sequence, and its ``jax.random.randint`` draws (DE's
  and the snooker's indices, the KDE's kernel picks, slice's direction
  pairs and expansion budgets) are recorded from its call; all are handed
  to the port's draw hooks.  Accept decisions must be identical; floats
  agree within rtol 1e-12 in float64 and rtol 1e-5 / atol 1e-6 in float32
  (one proposal, no trajectory).
* Slice's loops run to their caps in the port and stop early in eryn_tpu:
  cases where some walkers resolve at the first shrinkage iteration and
  others need the last, and where stepping out needs its whole budget.
* ``cholesky_ex``: a singular covariance gives eryn_tpu's NaN factor, so
  the proposals on that rung are refused in both packages.
* Statistically: each move's sampler on a small tempered unit Gaussian;
  kernel states from eryn_tpu's.
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
from eryn_tpu_torch.moves.kde import cholesky_or_nan

torch.set_num_threads(1)

NT, NW, NDIM = 3, 12, 3
TOL = {np.float64: (1e-12, 1e-12), np.float32: (1e-5, 1e-6)}
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


def _normal(key, shape, dtype):
    return _t(np.array(jax.random.normal(key, shape, dtype=dtype)))


def _uniform(key, shape, dtype):
    return _t(np.array(jax.random.uniform(key, shape, dtype=dtype)))


def pair(dtype=np.float64, seed=0, nw=NW, collapse=None):
    """The unit Gaussian in U(-5, 5)^3 in both packages: ``(jax ctx, jax
    state, port ctx, port state)``.  ``collapse``: a rung whose walkers all
    sit at one point (a singular ensemble covariance)."""
    jpr = eryn_tpu.ProbDistContainer(
        {i: eryn_tpu.uniform_dist(-5.0, 5.0) for i in range(NDIM)})
    tpr = et.ProbDistContainer({i: et.uniform_dist(-5.0, 5.0)
                                for i in range(NDIM)})
    kw = dict(tempering_kwargs=dict(ntemps=NT), seed=0)
    js = eryn_tpu.EnsembleSampler(nw, NDIM, lambda x: -0.5 * jnp.sum(x * x),
                                  jpr, dtype=jnp.dtype(dtype), **kw)
    ts = et.EnsembleSampler(nw, NDIM, lambda x: -0.5 * torch.sum(x * x), tpr,
                            device="cpu", dtype=TORCH[dtype], **kw)
    coords = np.random.default_rng(seed).uniform(
        -2, 2, (NT, nw, 1, NDIM)).astype(dtype)
    if collapse is not None:
        # a point whose mean over walkers is exact: the deviations are 0
        coords[collapse] = np.array([0.5, -0.25, 1.0], dtype)
    jstate = js._setup_state(eryn_tpu.State({"model_0": coords}))
    tstate = et.State(
        {"model_0": _t(coords)},
        inds={"model_0": torch.ones((NT, nw, 1), dtype=torch.bool)},
        log_like=_t(jstate.log_like), log_prior=_t(jstate.log_prior),
        betas=_t(jstate.betas))
    return js.get_eval_context(), jstate, ts.get_eval_context(), tstate


def assert_same_step(jout, tout, tol):
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
        recorded.append(_t(np.array(out).astype(np.int64)))
        return out

    monkeypatch.setattr(jax.random, "randint", randint)
    return recorded


def _perm(kperm, nw):
    return _t(np.array(jax.random.permutation(kperm, nw)).astype(np.int64))


# ----------------------------------------------------------------------
# the red/blue moves: DE, snooker, walk, KDE
# ----------------------------------------------------------------------
def _red_blue_draws(kind, move, key, dtype, recorded, nw=NW):
    """The draws of eryn_tpu's ``RedBlueMove._propose_impl`` from ``key``
    (``red_blue.py:116-191``), per block: the proposal's draws in the port's
    hook format, and the accept uniforms."""
    key, kperm = jax.random.split(key)
    perm = _perm(kperm, nw)
    sizes = [nw - nw // 2, nw // 2]
    proposal, accept = [], []
    for ns in sizes:
        nc = nw - ns
        key, kprop, kacc = jax.random.split(key, 3)
        shape = (NT, ns)
        if kind == "de":
            key_g, key_h, _ = jax.random.split(kprop, 3)
            hop = (_uniform(key_h, shape, dtype) if move.hop_prob > 0 else None)
            proposal.append((_normal(key_g, shape, dtype), hop,
                             {"model_0": (recorded.pop(0), recorded.pop(0))}))
        elif kind == "snooker":
            proposal.append({"model_0": tuple(recorded.pop(0)
                                              for _ in range(3))})
        elif kind == "walk":
            kb = jax.random.split(kprop, 1)[0]
            kz, km = jax.random.split(kb)
            u = (_uniform(km, shape + (nc,), dtype) if move.s0 is not None
                 else None)
            proposal.append({"model_0": (_normal(kz, shape + (nc,), dtype), u)})
        elif kind == "kde":
            kb = jax.random.split(kprop, 1)[0]
            _, kstep = jax.random.split(kb)
            proposal.append({"model_0": (recorded.pop(0),
                                         _normal(kstep, shape + (NDIM,),
                                                 dtype))})
        accept.append(_uniform(kacc, shape, dtype))
    return perm, proposal, accept


RB_CASES = [
    ("de", np.float64, {}), ("de", np.float32, {}),
    ("de", np.float64, dict(gamma0=0.7, hop_prob=0.0)),
    ("de", np.float64, dict(periodic={"model_0": {0: 2.5}})),
    ("snooker", np.float64, {}), ("snooker", np.float32, {}),
    ("snooker", np.float64, dict(periodic={"model_0": {2: 3.0}})),
    ("walk", np.float64, {}), ("walk", np.float32, {}),
    ("walk", np.float64, dict(s0=3)),
    ("walk", np.float64, dict(periodic={"model_0": {1: 3.0}})),
    ("kde", np.float64, {}), ("kde", np.float32, {}),
    ("kde", np.float64, dict(bw_method=0.5)),
]
RB = {"de": (jm.DEMove, tm.DEMove, "draw_de"),
      "snooker": (jm.DESnookerMove, tm.DESnookerMove, "draw_snooker"),
      "walk": (jm.WalkMove, tm.WalkMove, "draw_walk"),
      "kde": (jm.KDEMove, tm.KDEMove, "draw_kde")}


@pytest.mark.parametrize("kind,dtype,kw", RB_CASES)
def test_red_blue_step_matches_jax(kind, dtype, kw, record_randint):
    jcls, tcls, hook = RB[kind]
    periodic = kw.pop("periodic", None)
    key = jax.random.key(21)
    with jax.enable_x64(dtype == np.float64):
        jctx, jstate, tctx, tstate = pair(dtype, seed=5)
        jmove = jcls(**kw, periodic=periodic and
                     eryn_tpu.utils.PeriodicContainer(periodic))
        jout = jmove._propose_impl(key, jstate, jctx, ())
        perm, proposal, accept = _red_blue_draws(kind, jmove, key, dtype,
                                                 record_randint)
    assert not record_randint
    tmove = tcls(**kw, periodic=periodic)
    tmove.init_kernel_state(tstate)
    tmove.draw_perm = _queue([perm])
    setattr(tmove, hook, _queue(proposal))
    tmove.draw_accept = _queue(accept)
    tout = tmove._propose_impl(None, tstate, tctx, ())
    assert_same_step(jout, tout, TOL[dtype])
    assert 0 < np.asarray(jout[1]).mean() < 1


def test_de_index_draws_are_distinct():
    """The shifted ``randint`` draws give distinct complement picks."""
    from eryn_tpu_torch.moves.de import _distinct3

    g = torch.Generator().manual_seed(0)
    n = 5
    i, j, k = (torch.randint(0, n - s, (4000,), generator=g) for s in range(3))
    a, b, c = _distinct3(i, j, k)
    assert bool(((a != b) & (a != c) & (b != c)).all())
    assert set(torch.cat([a, b, c]).tolist()) == set(range(n))


# ----------------------------------------------------------------------
# slice
# ----------------------------------------------------------------------
def _slice_draws(move, key, dtype, recorded, nw=NW):
    """eryn_tpu's slice draws from ``key`` (``slice.py:145-294``): the
    permutation, and per block the recorded direction pair, the level's
    uniform, the recorded budget, the offset's uniform and the shrinkage
    uniforms of all ``max_shrink`` iterations (each from its iteration's
    key of the chained split)."""
    key, kperm = jax.random.split(key)
    perm = _perm(kperm, nw)
    draws = []
    for ns in (nw - nw // 2, nw // 2):
        shape = (NT, ns)
        key, _, _ = jax.random.split(key, 3)
        key, ky, _, ku0, kshr = jax.random.split(key, 5)
        l_idx, m_idx, J = recorded.pop(0), recorded.pop(0), recorded.pop(0)
        u_shrink, k = [], kshr
        for _ in range(move.max_shrink):
            k, kd = jax.random.split(k)
            u_shrink.append(_uniform(kd, shape, dtype))
        draws.append((l_idx, m_idx, _uniform(ky, shape, dtype), J,
                      _uniform(ku0, shape, dtype), torch.stack(u_shrink)))
    return perm, draws


def _slice_step(dtype, kw, mu=None, seed=7, recorded=None):
    """eryn_tpu's slice step and the port's on the same draws: ``(jax out,
    port out, port move)``."""
    key = jax.random.key(31)
    with jax.enable_x64(dtype == np.float64):
        jctx, jstate, tctx, tstate = pair(dtype, seed=seed)
        jmove = jm.SliceMove(**kw)
        jks = jmove.init_kernel_state(jstate)
        if mu is not None:
            jks = {**jks, "mu": jnp.asarray(mu, jnp.dtype(dtype))}
        jout = jmove._propose_impl(key, jstate, jctx, jks)
        perm, draws = _slice_draws(jmove, key, dtype, recorded)
    assert not recorded
    tmove = tm.SliceMove(**kw)
    tmove.init_kernel_state(tstate)
    tmove.draw_perm = _queue([perm])
    tmove.draw_slice = _queue(draws)
    tks = kernel_state_from_numpy(tmove, jks, tstate)
    return jout, tmove._propose_impl(None, tstate, tctx, tks), tmove


@pytest.mark.parametrize("dtype,kw,mu", [
    (np.float64, {}, None), (np.float32, {}, None),
    (np.float64, dict(max_expand=3, max_shrink=5), 0.05),
    (np.float64, dict(tune_steps=0), 4.0),
])
def test_slice_step_matches_jax(dtype, kw, mu, record_randint):
    jout, tout, tmove = _slice_step(dtype, kw, mu, recorded=record_randint)
    assert_same_step(jout, tout, TOL[dtype])
    expand, shrink, loops = tmove.loop_iterations.tolist()
    assert loops == 2
    assert expand <= 2 * (tmove.max_expand - 1)
    assert 2 <= shrink <= 2 * tmove.max_shrink


def test_slice_loops_resolve_at_the_first_and_the_last_iteration(
        record_randint):
    """A wide direction scale (``mu`` = 40) and a cap of 5 shrinkage
    iterations: with the cap at 1 the same draws resolve some walkers (those
    whose first point lies in the slice), and with the cap at 5 the loop
    needs all 5 iterations in both blocks (some walkers still unresolved at
    the last one keep their point).  eryn_tpu's early-exit loops and the
    port's capped ones agree in both; stepping out needs its whole budget
    with ``mu`` = 0.02."""
    outs = {}
    for cap in (1, 5):
        jout, tout, tmove = _slice_step(np.float64, dict(max_shrink=cap), 40.0,
                                        recorded=record_randint)
        assert_same_step(jout, tout, TOL[np.float64])
        outs[cap] = (np.asarray(jout[1]), tmove.loop_iterations.tolist())
    first = outs[1][0]
    assert 0 < first.mean() < 1  # resolved at the first iteration: some
    acc, (_, shrink, loops) = outs[5]
    assert shrink == 5 * loops  # the last iteration was needed
    assert np.all(acc[first]) and 0 < acc.mean() < 1
    # stepping out: a narrow direction exhausts the expansion budget
    jout, tout, tmove = _slice_step(np.float64, dict(max_expand=4), 0.02,
                                    recorded=record_randint)
    assert_same_step(jout, tout, TOL[np.float64])
    expand, _, loops = tmove.loop_iterations.tolist()
    assert expand == 3 * loops


# ----------------------------------------------------------------------
# AIMH and the Cholesky factor
# ----------------------------------------------------------------------
def _aimh_draws(move, key, dtype, nw=NW):
    """eryn_tpu's AIMH draws from ``key`` (``aimh.py:190-250``)."""
    D = NDIM
    _, k_z, k_u, k_acc = jax.random.split(key, 4)
    k_u2, k_n = jax.random.split(k_u)
    k = int(move.df)
    uu = zz = None
    if k // 2:
        uu = _t(np.array(jax.random.uniform(
            k_u2, (NT, nw, k // 2), dtype, minval=jnp.finfo(dtype).tiny,
            maxval=1.0)))
    if k % 2:
        zz = _normal(k_n, (NT, nw), dtype)
    return [(_normal(k_z, (NT, nw, D), dtype), uu, zz)], [
        _uniform(k_acc, (NT, nw), dtype)]


@pytest.mark.parametrize("dtype,kw", [
    (np.float64, {}), (np.float32, {}), (np.float64, dict(df=7.0)),
    (np.float64, dict(df=3.0, tune_steps=0)),
    (np.float64, dict(tune_steps=2)),  # past its tuning: the moments stay
])
def test_aimh_step_matches_jax(dtype, kw):
    key = jax.random.key(41)
    with jax.enable_x64(dtype == np.float64):
        jctx, jstate, tctx, tstate = pair(dtype, seed=8)
        jmove = jm.AIMHMove(**kw)
        jks = jmove.init_kernel_state(jstate)
        if kw.get("tune_steps") == 2:
            jks = {**jks, "t": jnp.asarray(3, jnp.int32)}
        jout = jmove._propose_impl(key, jstate, jctx, jks)
        draws, accept = _aimh_draws(jmove, key, dtype)
    tmove = tm.AIMHMove(**kw)
    tmove.draw_aimh = _queue(draws)
    tmove.draw_accept = _queue(accept)
    tks = kernel_state_from_numpy(tmove, jks, tstate)
    tout = tmove._propose_impl(None, tstate, tctx, tks)
    assert_same_step(jout, tout, TOL[dtype])
    assert 0 < np.asarray(jout[1]).mean() <= 1


def test_aimh_refusals():
    # any df above 2 is taken: a non-integer one draws a gamma
    assert tm.AIMHMove(df=4.5).gamma and not tm.AIMHMove(df=10).gamma
    with pytest.raises(ValueError, match="df must exceed 2"):
        tm.AIMHMove(df=2.0)
    pr = et.ProbDistContainer({i: et.uniform_dist(-5.0, 5.0)
                               for i in range(NDIM)})
    with pytest.raises(ValueError, match="periodic"):
        s = et.EnsembleSampler(NW, NDIM, lambda x: -0.5 * torch.sum(x * x), pr,
                               moves=tm.AIMHMove(), periodic={"model_0": {0: 2.0}},
                               device="cpu")
        s.run_mcmc(pr.rvs(size=(NW,), generator=torch.Generator()), 2)
    with pytest.raises(ValueError, match="fixed-dimension"):
        et.EnsembleSampler(NW, NDIM, lambda c, i: torch.sum(c), pr,
                           nleaves_max=2, rj_moves=True, moves=tm.AIMHMove(),
                           device="cpu")


def test_cholesky_or_nan_gives_jax_nans():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(4, 3, 3))
    spd = a @ a.transpose(0, 2, 1) + 0.1 * np.eye(3)
    spd[1] = np.diag([1.0, 0.0, -2.0])  # not positive definite
    spd[3] = 0.0  # singular
    with jax.enable_x64(True):
        want = np.asarray(jnp.linalg.cholesky(jnp.asarray(spd)))
    got = cholesky_or_nan(torch.from_numpy(spd)).numpy()
    np.testing.assert_array_equal(got[[1, 3]], want[[1, 3]])  # NaN, 0
    lower = np.tril(np.ones((3, 3), bool))
    assert np.isnan(want[[1, 3]][:, lower]).all()
    assert np.isfinite(want[[0, 2]]).all()
    close(got[[0, 2]], want[[0, 2]], TOL[np.float64])


@pytest.mark.parametrize("kind", ["kde", "aimh"])
def test_singular_covariance_refuses_that_rung(kind, record_randint):
    """One rung's walkers at a single point: the KDE's complement
    covariance (and an AIMH kernel state whose covariance there is not
    positive definite) has no Cholesky factor; both packages refuse every
    proposal on that rung and agree elsewhere."""
    key = jax.random.key(51)
    with jax.enable_x64(True):
        jctx, jstate, tctx, tstate = pair(np.float64, seed=9, collapse=1)
        if kind == "kde":
            jmove, tmove = jm.KDEMove(), tm.KDEMove()
            jout = jmove._propose_impl(key, jstate, jctx, ())
            perm, proposal, accept = _red_blue_draws(
                "kde", jmove, key, np.float64, record_randint)
            tmove.draw_perm = _queue([perm])
            tmove.draw_kde = _queue(proposal)
            tmove.draw_accept = _queue(accept)
            tks = ()
        else:
            jmove, tmove = jm.AIMHMove(tune_steps=0), tm.AIMHMove(tune_steps=0)
            jks = jmove.init_kernel_state(jstate)
            jks = {**jks, "cov": jks["cov"].at[1].set(-jnp.eye(NDIM))}
            jout = jmove._propose_impl(key, jstate, jctx, jks)
            draws, accept = _aimh_draws(jmove, key, np.float64)
            tmove.draw_aimh = _queue(draws)
            tmove.draw_accept = _queue(accept)
            tks = kernel_state_from_numpy(tmove, jks, tstate)
    tout = tmove._propose_impl(None, tstate, tctx, tks)
    assert_same_step(jout, tout, TOL[np.float64])
    acc = np.asarray(tout[1])
    assert not acc[1].any() and acc[[0, 2]].any()
    np.testing.assert_array_equal(tout[0].branches["model_0"].coords[1],
                                  tstate.branches["model_0"].coords[1])


@pytest.mark.parametrize("kind", ["slice", "aimh"])
def test_kernel_state_from_eryn_tpu(kind):
    """``interop.kernel_state_from_numpy`` takes eryn_tpu's kernel state
    after a few proposals: slice's ``mu`` and clock, AIMH's weights,
    moments and clock."""
    cls = {"slice": (jm.SliceMove, tm.SliceMove),
           "aimh": (jm.AIMHMove, tm.AIMHMove)}[kind]
    with jax.enable_x64(True):
        jctx, jstate, tctx, tstate = pair(np.float64, seed=1)
        jmove = cls[0]()
        jks = jmove.init_kernel_state(jstate)
        step = jax.jit(lambda k, s, ks: jmove._propose_impl(k, s, jctx, ks))
        for i in range(3):
            jstate, _, jks = step(jax.random.key(i), jstate, jks)
    tmove = cls[1]()
    tks = kernel_state_from_numpy(tmove, jks, tstate)
    assert sorted(tks) == sorted(jks) and int(tks["t"]) == 3
    for a, b in zip(kernel_state_to_numpy(tks), kernel_state_to_numpy(jks)):
        np.testing.assert_array_equal(a, np.asarray(b).astype(a.dtype))
    if kind == "slice":
        assert float(tks["mu"]) != 1.0  # adapted
    fresh = kernel_state_to_numpy(tmove.init_kernel_state(tstate))
    with jax.enable_x64(True):
        jfresh = kernel_state_to_numpy(jmove.init_kernel_state(
            pair(np.float64, seed=1)[1]))
    for a, b in zip(fresh, jfresh):
        close(a, b, TOL[np.float64])


# ----------------------------------------------------------------------
# statistics
# ----------------------------------------------------------------------
ZOO = {
    "de": tm.DEMove, "snooker": tm.DESnookerMove, "walk": tm.WalkMove,
    "kde": tm.KDEMove, "slice": lambda: tm.SliceMove(tune_steps=100),
    "aimh": lambda: tm.AIMHMove(tune_steps=100),
}


@pytest.mark.parametrize("kind", list(ZOO))
def test_zoo_samples_the_tempered_gaussian(kind):
    """3 x 32 walkers, 3-D unit Gaussian in U(-5, 5)^3, 100 steps of
    burn-in and 200 stored: the cold chain's mean within 0.15 and variance
    within 0.2 of the target's; the acceptance inside (0, 1), or (0, 1] for
    the slice move, which accepts by construction."""
    pr = et.ProbDistContainer({i: et.uniform_dist(-5.0, 5.0)
                               for i in range(NDIM)})
    s = et.EnsembleSampler(32, NDIM, lambda x: -0.5 * torch.sum(x * x), pr,
                           moves=ZOO[kind](), tempering_kwargs=dict(ntemps=NT),
                           seed=4, device="cpu")
    s.run_mcmc(pr.rvs(size=(NT, 32), generator=torch.Generator().manual_seed(4)),
               200, burn=100)
    cold = s.get_chain(temp_index=0)["model_0"].reshape(-1, NDIM)
    assert np.all(np.abs(cold.mean(axis=0)) < 0.15), cold.mean(axis=0)
    assert np.all(np.abs(cold.var(axis=0) - 1.0) < 0.2), cold.var(axis=0)
    acc = float(s.acceptance_fraction[0].mean())
    assert 0 < acc <= 1 if kind == "slice" else 0 < acc < 1, acc
