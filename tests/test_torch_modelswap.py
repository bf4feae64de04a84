"""The port's product-space model comparison (``ModelSwapRJMove``,
``BasicSymmetricModelSwapRJMove``) against eryn_tpu.

* Decision for decision: one proposal over three candidate models from
  eryn_tpu's key: the shift of the model index (drawn by
  ``jax.random.randint``, whose algorithm the port cannot replay, so it is
  recorded from eryn_tpu's call), each candidate's draw (its container's
  ``sample`` on the same subkey) and the accept uniforms.  The flip (new
  masks), decisions identical; coordinates, log-likelihoods and
  log-priors within rtol 1e-5 / atol 1e-6 (float32).
* Statistically: ``tests/test_modelswap.py``'s quadrature Bayes factor of
  a pulse against a constant, with and without tempering, at a smaller
  depth: the cold chain's model probability within 0.05 (0.1 tempered) of
  the quadrature value, exactly one model active in every sample.
* The set-up checks: exactly one active candidate per walker, checked once
  on the host; the legacy positional signature; refused keywords.
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

NW = 64


def close(a, b):
    np.testing.assert_allclose(np.asarray(a, dtype=np.float64),
                               np.asarray(b, dtype=np.float64),
                               rtol=1e-5, atol=1e-6)


def _t(x):
    return torch.from_numpy(np.array(x))


def _queue(items):
    it = iter(items)
    return lambda *args, **kwargs: next(it)


MODELS = {"a": (0.0, 2.0), "b": (-1.0, 1.0), "c": (0.5, 3.0)}


def _three(pkg):
    return {n: pkg.ProbDistContainer({0: pkg.uniform_dist(*b)})
            for n, b in MODELS.items()}


def _ll_j(coords, inds):
    x = sum(jnp.sum(jnp.where(inds[n][:, None], coords[n], 0.0))
            for n in MODELS)
    return -0.5 * (x - 0.7) ** 2 / 0.2


def _ll_t(coords, inds):
    x = sum(torch.sum(torch.where(inds[n][:, None], coords[n], 0.0))
            for n in MODELS)
    return -0.5 * (x - 0.7) ** 2 / 0.2


def test_swap_proposal_matches_jax(monkeypatch):
    nt, nw = 3, 16
    names = list(MODELS)
    rng = np.random.default_rng(3)
    pick = rng.integers(0, 3, (nt, nw))
    coords = {n: rng.uniform(lo, hi, (nt, nw, 1, 1)).astype(np.float32)
              for n, (lo, hi) in MODELS.items()}
    inds = {n: (pick == j)[..., None] for j, n in enumerate(names)}
    kw = dict(branch_names=names, nleaves_max={n: 1 for n in names},
              nleaves_min={n: 0 for n in names},
              tempering_kwargs=dict(ntemps=nt), fill_zero_leaves_val=-1e8)
    js = eryn_tpu.EnsembleSampler(nw, {n: 1 for n in names}, _ll_j,
                                  _three(eryn_tpu), seed=0, **kw)
    ts = et.EnsembleSampler(nw, {n: 1 for n in names}, _ll_t, _three(et),
                            seed=0, device="cpu", **kw)
    jstate = js._setup_state(eryn_tpu.State(coords, inds=inds))
    tstate = et.State({n: _t(jstate.branches[n].coords) for n in names},
                      inds={n: _t(m) for n, m in inds.items()},
                      log_like=_t(jstate.log_like),
                      log_prior=_t(jstate.log_prior), betas=_t(jstate.betas))

    recorded = []
    real = jax.random.randint

    def randint(*args, **kwargs):
        out = real(*args, **kwargs)
        recorded.append(_t(out).to(torch.int64))
        return out

    monkeypatch.setattr(jax.random, "randint", randint)
    jmove = jm.ModelSwapRJMove(_three(eryn_tpu))
    key = jax.random.key(7)
    jout = jmove._propose_impl(key, jstate, js.get_eval_context(), ())
    # moves/modelswap.py:173-190
    k_rest, _, k_acc = jax.random.split(key, 3)
    k_draws = jax.random.split(k_rest, 3)
    draws = {n: _t(_three(eryn_tpu)[n].sample(k_draws[j], (nt, nw)))
             for j, n in enumerate(names)}
    accept = _t(jax.random.uniform(k_acc, (nt, nw)))
    shift = recorded.pop()
    assert set(np.unique(shift.numpy())) == {1, 2}

    tmove = tm.ModelSwapRJMove(_three(et))
    tmove.init_kernel_state(tstate)
    tmove.draw_swap = _queue([(shift, draws)])
    tmove.draw_accept = _queue([accept])
    tout = tmove._propose_impl(None, tstate, ts.get_eval_context(), ())

    np.testing.assert_array_equal(tout[1].numpy(), np.asarray(jout[1]))
    for n in names:
        np.testing.assert_array_equal(tout[0].branches[n].inds.numpy(),
                                      np.asarray(jout[0].branches[n].inds))
        close(tout[0].branches[n].coords, jout[0].branches[n].coords)
    close(tout[0].log_like, jout[0].log_like)
    close(tout[0].log_prior, jout[0].log_prior)
    active = np.stack([tout[0].branches[n].inds[..., 0].numpy()
                       for n in names], -1)
    assert (active.sum(-1) == 1).all()
    # accepted walkers moved to (current + shift) % 3
    acc = tout[1].numpy() > 0
    assert 0 < acc.mean() < 1
    new = active.argmax(-1)
    np.testing.assert_array_equal(new[acc], ((pick + shift.numpy()) % 3)[acc])
    np.testing.assert_array_equal(new[~acc], pick[~acc])


def _problem():
    """``tests/test_modelswap.py:22-58``: a Gaussian pulse in unit noise;
    model A a pulse of free amplitude, model B a constant offset; the
    evidences by quadrature."""
    rng = np.random.default_rng(4)
    npts = 64
    t = np.linspace(0, 1, npts)
    g = np.exp(-((t - 0.5) ** 2) / (2 * 0.1**2))
    data = 1.1 * g + rng.standard_normal(npts)
    amax = 3.0

    def ll_np(template):
        return -0.5 * np.sum((data[None] - template) ** 2, axis=-1)

    a = np.linspace(0.0, amax, 800)
    z_pulse = np.exp(ll_np(a[:, None] * g[None])).mean()
    c = np.linspace(-1.0, 1.0, 800)
    z_const = np.exp(ll_np(np.broadcast_to(c[:, None], (800, npts)))).mean()
    p_pulse_true = z_pulse / (z_pulse + z_const)

    gt = torch.tensor(g, dtype=torch.float32)
    dt = torch.tensor(data, dtype=torch.float32)

    def log_like(coords, inds):
        amp = torch.sum(torch.where(inds["pulse"][:, None], coords["pulse"], 0.0))
        off = torch.sum(torch.where(inds["const"][:, None], coords["const"], 0.0))
        return -0.5 * torch.sum((dt - (amp * gt + off)) ** 2)

    priors = {"pulse": et.ProbDistContainer({0: et.uniform_dist(0.0, amax)}),
              "const": et.ProbDistContainer({0: et.uniform_dist(-1.0, 1.0)})}
    return log_like, priors, p_pulse_true


def _sampler(move, ntemps=1, seed=21):
    log_like, priors, p_true = _problem()
    tk = dict(tempering_kwargs=dict(ntemps=ntemps)) if ntemps > 1 else {}
    s = et.EnsembleSampler(
        NW, {"pulse": 1, "const": 1}, log_like, priors,
        branch_names=["pulse", "const"],
        nleaves_max={"pulse": 1, "const": 1},
        nleaves_min={"pulse": 0, "const": 0},
        moves=[tm.GaussianMove({"pulse": 0.05, "const": 0.05})],
        rj_moves=[move(priors)], fill_zero_leaves_val=-1e8, seed=seed,
        device="cpu", **tk)
    return s, priors, p_true


def _start(priors, ntemps=1):
    g = torch.Generator().manual_seed(7)
    coords = {n: c.rvs(size=(ntemps, NW, 1), generator=g)
              for n, c in priors.items()}
    pick = np.random.default_rng(7).random((ntemps, NW)) < 0.5
    return et.State(coords, inds={"pulse": pick[..., None],
                                  "const": ~pick[..., None]})


@pytest.mark.parametrize("make", [
    lambda pr: tm.ModelSwapRJMove({n: pr[n] for n in ("pulse", "const")}),
    lambda pr: tm.BasicSymmetricModelSwapRJMove([1, 1], [0, 0]),
], ids=["ModelSwapRJMove", "legacy signature, priors wired"])
def test_model_swap_matches_quadrature_bayes_factor(make):
    s, priors, p_true = _sampler(make)
    s.run_mcmc(_start(priors), 900, burn=200)
    nl = s.get_nleaves()
    assert np.all(nl["pulse"] + nl["const"] == 1)
    p_pulse = nl["pulse"][:, 0].mean()
    assert abs(p_pulse - p_true) < 0.05, (p_pulse, p_true)
    chain = s.get_chain()["pulse"][:, 0, :, 0, 0]
    m = s.get_inds()["pulse"][:, 0, :, 0]
    assert abs(np.median(chain[m]) - 1.1) < 0.3


def test_model_swap_with_tempering():
    s, priors, p_true = _sampler(
        lambda pr: tm.ModelSwapRJMove({n: pr[n] for n in ("pulse", "const")}),
        ntemps=3, seed=23)
    s.run_mcmc(_start(priors, 3), 400, burn=100)
    nl = s.get_nleaves()
    assert np.all(nl["pulse"] + nl["const"] == 1)
    p_pulse = nl["pulse"][:, 0].mean()
    assert abs(p_pulse - p_true) < 0.1, (p_pulse, p_true)


def test_model_swap_validation_and_alias():
    assert issubclass(tm.BasicSymmetricModelSwapRJMove, tm.ModelSwapRJMove)
    legacy = tm.BasicSymmetricModelSwapRJMove([1, 1], [0, 0])
    assert legacy.generate_dist is None
    pr_a = et.ProbDistContainer({0: et.uniform_dist(0, 1)})
    pr_b = et.ProbDistContainer({0: et.uniform_dist(0, 2)})
    legacy.wire_sampler_priors({"a": pr_a, "b": pr_b})
    assert legacy.model_names == ["a", "b"]
    assert legacy.nleaves_max == {"a": 1, "b": 1}
    mv = tm.BasicSymmetricModelSwapRJMove(generate_dist={"a": pr_a, "b": pr_b})
    assert mv.model_names == ["a", "b"]
    with pytest.raises(ValueError, match="nleaves_max == 1"):
        tm.BasicSymmetricModelSwapRJMove([2, 1], [0, 0])
    with pytest.raises(ValueError, match="at least two"):
        tm.ModelSwapRJMove({"only": pr_a})
    with pytest.raises(ValueError, match="at least two"):
        tm.ModelSwapRJMove(pr_a)
    with pytest.raises(ValueError, match="jointly"):
        tm.ModelSwapRJMove({"a": pr_a, "b": pr_b},
                           proposal_branch_names=["a"])
    with pytest.raises(RuntimeError, match="never wired"):
        tm.BasicSymmetricModelSwapRJMove([1, 1], [0, 0]).init_kernel_state(None)

    # exactly one active candidate per walker, checked at set-up
    s, priors, _ = _sampler(
        lambda pr: tm.ModelSwapRJMove({n: pr[n] for n in ("pulse", "const")}),
        seed=22)
    bad = _start(priors)
    bad.branches["const"].inds = torch.ones((1, NW, 1), dtype=torch.bool)
    with pytest.raises(ValueError, match="exactly one active"):
        s.run_mcmc(bad, 2)
