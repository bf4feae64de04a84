"""Periodic parameters of the port against eryn_tpu.

* ``PeriodicContainer.distance`` / ``wrap`` on the same numpy inputs
  (negative, out-of-range and multi-period values, int and string keys):
  both packages compute ``fmod`` and one conditional add in float32, so the
  results must be equal; the tolerance is 0.
* One proposal of the periodic ``StretchMove`` (general path) from the draws
  eryn_tpu makes from a JAX key: within rtol 1e-6 / atol 1e-6 (float32; the
  two libraries may round the stretch factor's division differently by an
  ulp), compared modulo the period.
* A short reversible-jump chain with the periodic group stretch on a circle
  (von Mises leaves centred next to the wrap point) in both packages: the
  cold chain's circular moments agree with each other within 0.05 and with
  the analytic ``I1(kappa) / I0(kappa)`` within 0.04; a few thousand
  correlated samples each.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import eryn_tpu
import eryn_tpu_torch
from eryn_tpu.moves import RedBlueGroupStretchMove as JaxRBGS
from eryn_tpu.moves import StretchMove as JaxStretch
from eryn_tpu.utils.periodic import PeriodicContainer as JaxPeriodic
from eryn_tpu_torch.moves import RedBlueGroupStretchMove, StretchMove
from eryn_tpu_torch.utils import PeriodicContainer

torch.set_num_threads(1)

TWO_PI = 2 * np.pi


def _values(shape, seed):
    """Values far outside ``[0, P)`` on both sides, and exact multiples."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-25.0, 25.0, shape).astype(np.float32)
    x.reshape(-1)[:4] = [0.0, -0.0, TWO_PI, -TWO_PI]
    return x


@pytest.mark.parametrize("spec,kwargs", [
    ({"m": {1: TWO_PI}}, {}),
    ({"m": {0: 1.5, 2: TWO_PI}}, {"ndims": {"m": 3}}),
    ({"m": {"phase": TWO_PI}}, {"key_orders": {"m": ["amp", "phase", "w"]}}),
    ({"m": {"phase": 3.0}}, {"key_order": {"m": ["phase", "amp", "w"]}}),
    ({"other": {0: 1.0}}, {}),  # no periodic parameter in this branch
])
def test_distance_and_wrap_match_jax(spec, kwargs):
    a, b = _values((4, 7, 2, 3), 0), _values((4, 7, 2, 3), 1)
    jp, tp = JaxPeriodic(spec, **kwargs), PeriodicContainer(spec, **kwargs)
    d_j = np.asarray(jp.distance({"m": jnp.asarray(a)}, {"m": jnp.asarray(b)})["m"])
    d_t = tp.distance({"m": torch.from_numpy(a)}, {"m": torch.from_numpy(b)})["m"]
    np.testing.assert_array_equal(d_t.numpy(), d_j)
    w_j = np.asarray(jp.wrap({"m": jnp.asarray(a)})["m"])
    w_t = tp.wrap({"m": torch.from_numpy(a)})["m"].numpy()
    np.testing.assert_array_equal(w_t, w_j)
    if "m" in spec:
        periods = tp.period_vector("m", 3, torch.float32, "cpu").numpy()
        for i in np.flatnonzero(np.isfinite(periods)):
            assert (w_t[..., i] >= 0).all() and (w_t[..., i] < periods[i]).all()
            assert (np.abs(d_t.numpy()[..., i]) <= periods[i] / 2).all()
        free = ~np.isfinite(periods)
        np.testing.assert_array_equal(w_t[..., free], a[..., free])
    else:
        np.testing.assert_array_equal(w_t, a)


def test_container_arguments():
    with pytest.raises(ValueError, match="dict"):
        PeriodicContainer([1.0])
    with pytest.raises(ValueError, match="key_order"):
        PeriodicContainer({"m": {"phase": 1.0}})
    with pytest.raises(ValueError, match="periodic must be"):
        StretchMove(periodic=3.0)
    pc = PeriodicContainer({"m": {0: 1.0}})
    assert StretchMove(periodic=pc).periodic is pc
    assert isinstance(StretchMove(periodic={"m": {0: 1.0}}).periodic,
                      PeriodicContainer)
    # the vector grows to the width asked for, and float64 keeps its dtype
    vec = pc.period_vector("m", 3, torch.float64, "cpu")
    assert vec.dtype == torch.float64
    assert vec.tolist() == [1.0, float("inf"), float("inf")]
    assert pc.period_vector("absent", 3, torch.float32, "cpu") is None


def test_sampler_hands_its_container_to_the_moves():
    pr = eryn_tpu_torch.ProbDistContainer(
        {"amp": eryn_tpu_torch.uniform_dist(0.0, 1.0),
         "phase": eryn_tpu_torch.uniform_dist(0.0, TWO_PI)})
    own = PeriodicContainer({"model_0": {0: 1.0}})
    ens = eryn_tpu_torch.EnsembleSampler(
        8, 2, lambda x: -0.5 * torch.sum(x * x), pr,
        moves=[StretchMove(), StretchMove(periodic=own)],
        periodic={"model_0": {"phase": TWO_PI}}, device="cpu",
    )
    vec = ens.periodic.period_vector("model_0", 2, torch.float32, "cpu")
    assert vec.tolist() == [float("inf"), np.float32(TWO_PI)]
    assert ens.moves[0].periodic is ens.periodic
    assert ens.moves[1].periodic is own
    with pytest.raises(ValueError, match="periodic must be"):
        eryn_tpu_torch.EnsembleSampler(8, 2, lambda x: x.sum(), pr,
                                       periodic=[1.0], device="cpu")


@pytest.mark.parametrize("log_proposal", [False, True])
def test_periodic_stretch_proposal_matches_jax(log_proposal, monkeypatch):
    rng = np.random.default_rng(2)
    nt, ns, nc, nl, nd = 3, 6, 5, 2, 3
    period = 2.0
    s = rng.uniform(0, period, (nt, ns, nl, nd)).astype(np.float32)
    c = rng.uniform(0, period, (nt, nc, nl, nd)).astype(np.float32)
    si = np.ones((nt, ns, nl), bool)
    spec = {"m": {0: period, 2: period}}
    key = jax.random.key(5)

    jmove = JaxStretch(use_log_proposal=log_proposal, periodic=JaxPeriodic(spec))
    q_j, f_j = jmove.get_proposal_kernel(
        key, {"m": jnp.asarray(s)}, {"m": jnp.asarray(c)}, {"m": jnp.asarray(si)})
    # the draws eryn_tpu's get_proposal_kernel makes from this key
    key_z, kb = jax.random.split(key, 2)
    u = np.array(jax.random.uniform(key_z, (nt, ns), dtype=jnp.float32))
    rint = np.array(jax.random.randint(kb, (nt, ns), 0, nc))

    move = StretchMove(use_log_proposal=log_proposal, periodic=spec)
    monkeypatch.setattr(torch, "rand", lambda *a, **k: torch.from_numpy(u))
    move.choose_c_vals = lambda generator, cc, n: torch.gather(
        cc, 1, torch.from_numpy(rint)[:, :, None, None].expand(
            nt, ns, *cc.shape[2:]))
    q_t, f_t = move.get_proposal_kernel(
        None, {"m": torch.from_numpy(s)}, {"m": torch.from_numpy(c)},
        {"m": torch.from_numpy(si)})
    q_j, q_t = np.asarray(q_j["m"]), q_t["m"].numpy()
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=1e-6,
                               atol=1e-6)
    # periodic dimensions are wrapped, and agree modulo the period
    for i in (0, 2):
        assert (q_t[..., i] >= 0).all() and (q_t[..., i] < period).all()
        d = np.abs(q_t[..., i] - q_j[..., i])
        np.testing.assert_allclose(np.minimum(d, period - d), 0, atol=1e-6)
    np.testing.assert_allclose(q_t[..., 1], q_j[..., 1], rtol=1e-6, atol=1e-6)
    # the wrap did something: the plain stretch leaves [0, P) somewhere
    plain = StretchMove(use_log_proposal=log_proposal)
    plain.choose_c_vals = move.choose_c_vals
    q_p, _ = plain.get_proposal_kernel(
        None, {"m": torch.from_numpy(s)}, {"m": torch.from_numpy(c)},
        {"m": torch.from_numpy(si)})
    assert not np.allclose(q_p["m"].numpy(), q_t)
    # with periodic parameters the move takes the general path
    state = type("S", (), {"log_like": torch.zeros(1, 1)})()
    move.use_kernels = True
    assert not move._can_fuse(state)


KAPPA, MU = 4.0, 0.2  # von Mises leaves centred next to the wrap point


def _circle_run(package, move_cls, ll, make_state):
    nw, nlmax = 32, 2
    pr = package.ProbDistContainer({0: package.uniform_dist(0.0, TWO_PI),
                                    1: package.uniform_dist(-3.0, 3.0)})
    kwargs = {"device": "cpu"} if package is eryn_tpu_torch else {}
    ens = package.EnsembleSampler(
        nw, 2, ll, pr, nleaves_max=nlmax, nleaves_min=0,
        moves=move_cls(live_dangerously=True), rj_moves=True,
        periodic={"model_0": {0: TWO_PI}}, fill_zero_leaves_val=0.0, seed=11,
        **kwargs,
    )
    rng = np.random.default_rng(6)
    coords = np.stack([rng.uniform(0, TWO_PI, (1, nw, nlmax)),
                       rng.normal(size=(1, nw, nlmax))], axis=-1)
    inds = rng.random((1, nw, nlmax)) < 0.6
    ens.run_mcmc(make_state({"model_0": coords}, inds={"model_0": inds}),
                 1200, burn=300)
    chain = np.asarray(ens.get_chain()["model_0"])[:, 0]
    act = np.asarray(ens.get_inds()["model_0"])[:, 0]
    theta, amp = chain[act][:, 0], chain[act][:, 1]
    assert (theta >= 0).all() and (theta < TWO_PI).all()  # stayed wrapped
    return np.array([np.cos(theta - MU).mean(), np.sin(theta - MU).mean(),
                     amp.mean(), amp.var(), act.mean()])


def test_periodic_rj_chain_on_a_circle_matches_jax():
    # the leaf's normalisation keeps the leaf count near even odds
    off = float(np.log(TWO_PI * 6.0) - np.log(TWO_PI * np.i0(KAPPA))
                - 0.5 * np.log(TWO_PI))

    def ll_jax(coords, inds):
        contrib = (KAPPA * jnp.cos(coords[:, 0] - MU)
                   - 0.5 * coords[:, 1] ** 2 + off)
        return jnp.sum(jnp.where(inds, contrib, 0.0))

    def ll_port(coords, inds):
        contrib = (KAPPA * torch.cos(coords[:, 0] - MU)
                   - 0.5 * coords[:, 1] ** 2 + off)
        return torch.sum(torch.where(inds, contrib, 0.0))

    m_j = _circle_run(eryn_tpu, JaxRBGS, ll_jax, eryn_tpu.State)
    m_t = _circle_run(eryn_tpu_torch, RedBlueGroupStretchMove, ll_port,
                      eryn_tpu_torch.State)
    np.testing.assert_allclose(m_t, m_j, atol=0.05)
    # E cos(theta - mu) = I1(kappa) / I0(kappa); the sine moment vanishes;
    # the amplitude is a unit normal
    a_kappa = 0.86352  # I1(4) / I0(4)
    for m in (m_j, m_t):
        assert abs(m[0] - a_kappa) < 0.04 and abs(m[1]) < 0.04, m
        assert abs(m[2]) < 0.06 and abs(m[3] - 1.0) < 0.1, m
        assert 0.2 < m[4] < 0.8, m
