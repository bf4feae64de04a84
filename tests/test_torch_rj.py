"""Reversible jump and the red/blue group stretch of the port against
eryn_tpu.

* One proposal of ``RedBlueGroupStretchMove`` and of
  ``DistributionGenerateRJ``, with the draws eryn_tpu's functions make from
  a JAX key handed to the port: equal decisions (new masks, which leaves
  move), coordinates and factors within rtol 1e-6 (float32; the two
  libraries may round ``log`` and the prior's three-term sum differently).
* The samplers, statistically: the flat-likelihood and Gaussian-leaf RJ
  checks of ``tests/test_rbgroupstretch.py`` against the same analytic
  targets, and a leaf-count histogram of both packages on a small
  pulse-search configuration (``benchmarks/lisa_style.py`` cut to 256
  points, 4 leaves, 4 x 32 walkers), within 0.12 per bin: the two chains
  are independent and a cold chain's leaf count moves slowly, so 600
  stored steps give a few tens of independent counts per walker.
* The initial log-likelihood of one state, which crosses between the
  packages with NaN-filled dormant slots and all-inactive walkers: within
  rtol 1e-4 (a 256-point float32 sum in another order).
"""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import eryn_tpu
import eryn_tpu_torch
from eryn_tpu.moves import DistributionGenerateRJ as JaxDistGenRJ
from eryn_tpu.moves import RedBlueGroupStretchMove as JaxRBGS
from eryn_tpu_torch.interop import state_from_numpy, state_to_numpy
from eryn_tpu_torch.moves import (
    DistributionGenerateRJ,
    RedBlueGroupStretchMove,
    StretchMove,
)

torch.set_num_threads(1)


def _jax_priors(bounds):
    return eryn_tpu.ProbDistContainer(
        {i: eryn_tpu.uniform_dist(lo, hi) for i, (lo, hi) in enumerate(bounds)}
    )


def _port_priors(bounds):
    return eryn_tpu_torch.ProbDistContainer(
        {i: eryn_tpu_torch.uniform_dist(lo, hi) for i, (lo, hi) in enumerate(bounds)}
    )


# ---------------------------------------------------------------------------
# one proposal from the same draws
# ---------------------------------------------------------------------------

def _group_stretch_pair(gibbs, log_proposal, case, monkeypatch):
    """One group-stretch proposal in both packages from the same draws.

    Cases: ``plain`` (one branch, a temperature with an empty active
    complement, NaN in dormant slots), ``periodic`` (parameter 0 periodic),
    ``two_branches`` (a second branch of another shape, whose complement is
    empty at another temperature), ``overflow`` (pick draws of exactly 1,
    so that ``k + 1`` exceeds the count and the pick is a row of zeros).
    """
    rng = np.random.default_rng(3)
    nt, ns, nc = 3, 5, 6
    shapes = {"m": (4, 2)}
    if case == "two_branches":
        shapes["n"] = (3, 3)
    s, c, ci, si, masks = {}, {}, {}, {}, {}
    for k, (name, (nl, nd)) in enumerate(shapes.items()):
        s[name] = rng.normal(size=(nt, ns, nl, nd)).astype(np.float32)
        c[name] = rng.normal(size=(nt, nc, nl, nd)).astype(np.float32)
        ci[name] = rng.random((nt, nc, nl)) < 0.4
        ci[name][1 + k] = False  # an empty active complement
        c[name][~ci[name]] = np.nan  # dormant slots hold NaN
        si[name] = rng.random((nt, ns, nl)) < 0.7
        # a parameter-level Gibbs mask counts only the selected parameters
        masks[name] = np.zeros((nl, nd), bool)
        masks[name][:, 0] = True
    spec = {"m": {0: 1.5}} if case == "periodic" else None
    key = jax.random.key(11)

    real_uniform = jax.random.uniform

    def uniform(k, shape, **kwargs):
        out = real_uniform(k, shape, **kwargs)
        if case == "overflow" and len(shape) == 3:
            out = out.at[:, ::2, 0].set(1.0)
        return out

    monkeypatch.setattr(jax.random, "uniform", uniform)
    jmove = JaxRBGS(
        use_log_proposal=log_proposal,
        periodic=None if spec is None else eryn_tpu.utils.PeriodicContainer(spec),
    )
    as_jax = lambda d: {n: jnp.asarray(x) for n, x in d.items()}
    q_j, f_j = jmove.get_proposal_kernel(
        key, as_jax(s), as_jax(c), as_jax(si), masks if gibbs else None,
        c_inds=as_jax(ci),
    )
    # the draws eryn_tpu's get_proposal_kernel makes from this key
    key_z, *kbs = jax.random.split(key, 1 + len(shapes))
    u = np.array(uniform(key_z, (nt, ns), dtype=jnp.float32))
    uu = {n: torch.from_numpy(np.array(
              uniform(kb, (nt, ns, shapes[n][0]), dtype=jnp.float32)))
          for n, kb in zip(shapes, kbs)}

    as_torch = lambda d: {n: torch.from_numpy(x) for n, x in d.items()}
    move = RedBlueGroupStretchMove(use_log_proposal=log_proposal,
                                   periodic=spec)
    move.draw_group = lambda *args: (torch.from_numpy(u), uu)
    q_t, f_t = move.get_proposal_kernel(
        None, as_torch(s), as_torch(c), as_torch(si),
        as_torch(masks) if gibbs else None, c_inds=as_torch(ci),
    )
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=1e-6,
                               atol=1e-6)
    for k, name in enumerate(shapes):
        qj, qt = np.asarray(q_j[name]), q_t[name].numpy()
        # the same leaves moved, to the same places: a different pick would
        # move a coordinate by O(1)
        np.testing.assert_array_equal(qt == s[name], qj == s[name])
        if spec is not None and name in spec:
            d = np.abs(qt[..., 0] - qj[..., 0])
            np.testing.assert_allclose(np.minimum(d, 1.5 - d), 0, atol=1e-6)
            moved = si[name] & (np.arange(nt) != 1 + k)[:, None, None]
            assert (qt[..., 0][moved] >= 0).all()
            assert (qt[..., 0][moved] < 1.5).all()
            qj, qt = qj[..., 1:], qt[..., 1:]
        np.testing.assert_allclose(qt, qj, rtol=1e-6, atol=1e-6)
        assert (q_t[name].numpy()[1 + k] == s[name][1 + k]).all()  # identity
        assert (q_t[name].numpy()[0][si[name][0]] != s[name][0][si[name][0]]).all()
    if case == "overflow":
        # the pick is a row of zeros: q = 0 - (0 - s) z = s z
        zz = ((u + 1.0) ** 2 / 2.0 if not log_proposal
              else np.exp((2.0 * u - 1.0) * np.log(2.0)))
        hit = si["m"][0, ::2, 0]
        np.testing.assert_allclose(
            q_t["m"].numpy()[0, ::2, 0][hit],
            (s["m"][0, ::2, 0] * zz[0, ::2, None])[hit], rtol=1e-6)


@pytest.mark.parametrize("gibbs", [False, True])
@pytest.mark.parametrize("log_proposal", [False, True])
def test_group_stretch_proposal_matches_jax(gibbs, log_proposal, monkeypatch):
    _group_stretch_pair(gibbs, log_proposal, "plain", monkeypatch)


@pytest.mark.parametrize("case", ["periodic", "two_branches", "overflow"])
@pytest.mark.parametrize("gibbs", [False, True])
@pytest.mark.parametrize("log_proposal", [False, True])
def test_group_stretch_proposal_cases_match_jax(gibbs, log_proposal, case,
                                                monkeypatch):
    _group_stretch_pair(gibbs, log_proposal, case, monkeypatch)


@pytest.mark.parametrize("nleaves_min,fix_change", [(0, None), (1, None),
                                                     (0, 1), (0, -1)])
def test_birth_death_proposal_matches_jax(nleaves_min, fix_change):
    rng = np.random.default_rng(5)
    nt, nw, nl = 3, 16, 4
    bounds = [(0.5, 5.0), (0.0, 10.0), (0.1, 2.0)]
    coords = np.stack(
        [rng.uniform(lo, hi, (nt, nw, nl)) for lo, hi in bounds], axis=-1
    ).astype(np.float32)
    inds = rng.random((nt, nw, nl)) < 0.5
    inds[..., 0] |= nleaves_min > 0  # every walker within the range
    inds[0, 0] = False
    inds[0, 0, 0] = nleaves_min > 0  # at the lower edge
    inds[0, 1] = True  # the upper edge
    key = jax.random.key(21)

    jmove = JaxDistGenRJ({"m": _jax_priors(bounds)}, nleaves_max={"m": nl},
                         nleaves_min={"m": nleaves_min}, fix_change=fix_change)
    q_j, inds_j, f_j = jmove.get_proposal_kernel(
        key, "m", jnp.asarray(coords), jnp.asarray(inds)
    )
    # the draws eryn_tpu makes from this key (distgenrj.py, rj.py)
    k_change, k_draw = jax.random.split(key)
    k_u, k_slot = jax.random.split(k_change)
    u_change = np.array(jax.random.uniform(k_u, (nt, nw)))
    gumbel = np.array(jax.random.gumbel(k_slot, (nt, nw, nl)))
    draw = np.array(_jax_priors(bounds).sample(k_draw, (nt, nw)))

    move = DistributionGenerateRJ({"m": _port_priors(bounds)}, nleaves_max={"m": nl},
                                  nleaves_min={"m": nleaves_min},
                                  fix_change=fix_change)
    move.draw_rj = lambda *args: tuple(
        torch.from_numpy(x) for x in (u_change, gumbel, draw)
    )
    q_t, inds_t, f_t = move.get_proposal_kernel(
        None, "m", torch.from_numpy(coords), torch.from_numpy(inds)
    )
    np.testing.assert_array_equal(inds_t.numpy(), np.asarray(inds_j))
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=1e-6)
    change = inds_t.numpy().sum(-1) - inds.sum(-1)
    assert set(np.unique(change)) <= {-1, 1}
    if fix_change is None:
        assert {-1, 1} <= set(np.unique(change))
    assert (inds_t.numpy().sum(-1) >= nleaves_min).all()

    # the edge factors at the ends of the leaf-count range
    ef_t = move._edge_factors("m", torch.from_numpy(inds.sum(-1)),
                              inds_t.sum(-1), torch.float32)
    ef_j = jmove._edge_factors("m", jnp.asarray(inds.sum(-1)),
                               jnp.asarray(inds_j).sum(-1), jnp.float32)
    np.testing.assert_array_equal(ef_t.numpy(), np.asarray(ef_j))


def test_fixed_range_proposes_no_change():
    inds = torch.rand((2, 8, 3), generator=torch.Generator().manual_seed(0)) < 0.5
    change, _, new_inds = eryn_tpu_torch.moves.rj.rj_change_kernel(
        torch.rand((2, 8)), torch.rand((2, 8, 3)), inds, 2, 2
    )
    assert (change == 0).all() and torch.equal(new_inds, inds)


# ---------------------------------------------------------------------------
# the samplers, statistically
# ---------------------------------------------------------------------------

NWALKERS = 64


def test_rj_flat_likelihood_preserves_prior():
    """Flat likelihood with birth/death: the leaf-count posterior is
    uniform over 0..3 and the active coordinates reproduce the U(-1, 1)
    prior (the bounds of tests/test_rbgroupstretch.py)."""
    nlmax, ndim = 3, 2
    pr = _port_priors([(-1.0, 1.0)] * ndim)
    ens = eryn_tpu_torch.EnsembleSampler(
        NWALKERS, ndim, lambda coords, inds: torch.zeros(()), pr,
        nleaves_max=nlmax, nleaves_min=0,
        moves=RedBlueGroupStretchMove(live_dangerously=True), rj_moves=True,
        fill_zero_leaves_val=0.0, seed=7, device="cpu",
    )
    rng = np.random.default_rng(7)
    coords = rng.uniform(-1, 1, (1, NWALKERS, nlmax, ndim))
    inds = rng.random((1, NWALKERS, nlmax)) < 0.5
    ens.run_mcmc(eryn_tpu_torch.State({"model_0": coords},
                                      inds={"model_0": inds}), 1500, burn=300)
    chain = ens.get_chain()["model_0"][:, 0]
    inds_c = ens.get_inds()["model_0"][:, 0]
    k = inds_c.sum(axis=-1).ravel()
    freqs = np.bincount(k, minlength=nlmax + 1) / k.size
    assert np.abs(freqs - 1.0 / (nlmax + 1)).max() < 0.08, freqs
    act = chain[inds_c]
    assert abs(act.mean()) < 0.03
    assert abs(act.var() - 1.0 / 3.0) < 0.02
    assert 0 < ens.rj_acceptance_fraction.mean() < 1


def test_rj_gaussian_leaf_marginals():
    """Each active leaf contributes an independent N(0, 0.25) factor; the
    active-leaf marginal must match whatever the activation pattern."""
    nlmax, ndim = 2, 2
    sig2 = 0.25
    off = ndim * np.log(10.0) - 0.5 * ndim * np.log(2 * np.pi * sig2)

    def ll(coords, inds):
        contrib = -0.5 * torch.sum(coords**2, dim=-1) / sig2 + off
        return torch.sum(torch.where(inds, contrib, 0.0))

    ens = eryn_tpu_torch.EnsembleSampler(
        NWALKERS, ndim, ll, _port_priors([(-5.0, 5.0)] * ndim),
        nleaves_max=nlmax, nleaves_min=0,
        moves=RedBlueGroupStretchMove(live_dangerously=True), rj_moves=True,
        fill_zero_leaves_val=0.0, seed=8, backend=eryn_tpu_torch.DeviceBackend(),
        device="cpu",
    )
    rng = np.random.default_rng(8)
    coords = 0.3 * rng.standard_normal((1, NWALKERS, nlmax, ndim))
    inds = rng.random((1, NWALKERS, nlmax)) < 0.5
    ens.run_mcmc(eryn_tpu_torch.State({"model_0": coords},
                                      inds={"model_0": inds}), 1500, burn=400)
    chain = ens.get_chain()["model_0"][:, 0]
    inds_c = ens.get_inds()["model_0"][:, 0]
    act = chain[inds_c].reshape(-1, ndim)
    assert np.abs(act.mean(axis=0)).max() < 0.05
    assert np.abs(act.var(axis=0) - sig2).max() < 0.05
    assert np.isnan(chain[~inds_c]).all()  # dormant leaves stored as NaN


NPTS, NLMAX, NT, NW = 256, 4, 4, 32
BOUNDS = [(0.5, 5.0), (0.0, 10.0), (0.1, 2.0)]


@pytest.fixture(scope="module")
def pulse():
    """The pulse-search data of benchmarks/lisa_style.py at 256 points, and
    a start state with NaN-filled dormant slots and all-inactive walkers."""
    rng = np.random.default_rng(10)
    t = np.linspace(0.0, 10.0, NPTS)
    data = 3.0 * np.exp(-((t - 4.0) ** 2) / (2 * 0.6**2))
    data = data + 0.3 * rng.standard_normal(NPTS)
    srng = np.random.default_rng(4)
    coords = np.stack(
        [srng.uniform(lo, hi, (NT, NW, NLMAX)) for lo, hi in BOUNDS], axis=-1
    ).astype(np.float32)
    inds = srng.random((NT, NW, NLMAX)) < 0.4
    inds[:, :2] = False  # all-inactive walkers
    coords[~inds] = np.nan
    return t, data, {"coords": {"model_0": coords}, "inds": {"model_0": inds},
                     "log_like": None, "log_prior": None, "betas": None}


def _jax_pulse_sampler(t, data, seed=3):
    tj, dj = jnp.asarray(t, jnp.float32), jnp.asarray(data, jnp.float32)

    def ll(coords, inds):
        a, b, c = coords[:, 0], coords[:, 1], coords[:, 2]
        p = a[:, None] * jnp.exp(-((tj[None] - b[:, None]) ** 2)
                                 / (2 * c[:, None] ** 2))
        tmpl = jnp.sum(jnp.where(inds[:, None], p, 0.0), axis=0)
        return -0.5 * jnp.sum(((tmpl - dj) / 0.3) ** 2)

    return eryn_tpu.EnsembleSampler(
        NW, 3, ll, _jax_priors(BOUNDS), nleaves_max=NLMAX, nleaves_min=0,
        moves=JaxRBGS(), rj_moves=True, tempering_kwargs=dict(ntemps=NT),
        fill_zero_leaves_val=float(-0.5 * np.sum((data / 0.3) ** 2)),
        seed=seed,
    )


def _port_pulse_sampler(t, data, seed=3):
    tt = torch.tensor(t, dtype=torch.float32)
    dt = torch.tensor(data, dtype=torch.float32)

    def ll(coords, inds):
        a, b, c = coords[:, 0], coords[:, 1], coords[:, 2]
        p = a[:, None] * torch.exp(-((tt[None] - b[:, None]) ** 2)
                                   / (2 * c[:, None] ** 2))
        tmpl = torch.sum(torch.where(inds[:, None], p, 0.0), dim=0)
        return -0.5 * torch.sum(((tmpl - dt) / 0.3) ** 2)

    return eryn_tpu_torch.EnsembleSampler(
        NW, 3, ll, _port_priors(BOUNDS), nleaves_max=NLMAX, nleaves_min=0,
        moves=RedBlueGroupStretchMove(), rj_moves=True,
        tempering_kwargs=dict(ntemps=NT),
        fill_zero_leaves_val=float(-0.5 * np.sum((data / 0.3) ** 2)),
        seed=seed, device="cpu",
    )


def test_initial_log_like_matches_jax(pulse):
    t, data, start = pulse
    jax_state = eryn_tpu.State(start["coords"], inds=start["inds"])
    back = state_to_numpy(state_from_numpy(state_to_numpy(jax_state),
                                           device="cpu"))
    for key in ("coords", "inds"):
        np.testing.assert_array_equal(back[key]["model_0"],
                                      start[key]["model_0"])
    js = _jax_pulse_sampler(t, data)
    ts = _port_pulse_sampler(t, data)
    j = js._setup_state(jax_state)
    p = ts._setup_state(state_from_numpy(state_to_numpy(jax_state),
                                         device="cpu"))
    np.testing.assert_allclose(p.log_prior.numpy(), np.asarray(j.log_prior))
    np.testing.assert_allclose(p.log_like.numpy(), np.asarray(j.log_like),
                               rtol=1e-4)
    # all-inactive walkers carry the fill value
    np.testing.assert_array_equal(
        p.log_like[:, :2].numpy(), np.float32(js._like_eval.fill_zero_leaves_val)
    )


@pytest.fixture(scope="module")
def pulse_runs(pulse):
    """The pulse search run once in each package (600 stored steps after
    200 of burn-in): ``[eryn_tpu's sampler, the port's]``."""
    t, data, start = pulse
    samplers = []
    for sampler, mk in ((_jax_pulse_sampler(t, data), eryn_tpu.State),
                        (_port_pulse_sampler(t, data), eryn_tpu_torch.State)):
        sampler.run_mcmc(mk(start["coords"], inds=start["inds"]), 600,
                         burn=200)
        samplers.append(sampler)
    return samplers


def test_pulse_leaf_counts_match_jax(pulse_runs):
    hists = []
    for sampler in pulse_runs:
        k = np.asarray(sampler.get_nleaves()["model_0"])[:, 0].ravel()
        hists.append(np.bincount(k, minlength=NLMAX + 1) / k.size)
        centers = np.asarray(sampler.get_chain()["model_0"])[:, 0, ..., 1]
        active = np.asarray(sampler.get_inds()["model_0"])[:, 0]
        assert abs(np.median(centers[active]) - 4.0) < 0.1
    np.testing.assert_allclose(hists[1], hists[0], atol=0.12)
    assert hists[1][0] == 0  # the pulse is always found


def test_pulse_acceptance_matches_jax(pulse_runs):
    """The acceptance fractions of the pulse search, per temperature, in
    both packages.

    In-model: within 0.15 absolute.  The two chains are independent, and a
    chain's acceptance depends on how many walkers froze with a second,
    spurious leaf during burn-in (2 of 32 against 7 of 32 in one pair of
    runs): every pick of such a leaf from the complement is rejected, which
    moved the cold acceptance from 0.52 to 0.44 at equal leaf counts.
    Reversible jump: a birth into a posterior this narrow is rare in both
    packages, below 1 % at every temperature, rarer at the cold end than at
    the hot end, where the few tens of accepted jumps of each run agree
    within a factor of 3."""
    acc = [np.asarray(s.acceptance_fraction).mean(axis=-1) for s in pulse_runs]
    rj = [np.asarray(s.rj_acceptance_fraction).mean(axis=-1)
          for s in pulse_runs]
    assert acc[0].shape == acc[1].shape == rj[0].shape == rj[1].shape == (NT,)
    np.testing.assert_allclose(acc[1], acc[0], atol=0.15)
    assert ((acc[1] > 0.2) & (acc[1] < 0.8)).all(), acc
    for r in rj:
        assert (r < 0.01).all() and r[-1] > r[0] and r[-1] > 0, rj
    assert 1 / 3 < rj[1][-1] / rj[0][-1] < 3, rj


def test_rj_modes_and_the_stretch_warning():
    pr = _port_priors([(-1.0, 1.0)])

    def ll(coords, inds):
        return torch.zeros(())

    with pytest.warns(UserWarning, match="RedBlueGroupStretchMove"):
        eryn_tpu_torch.EnsembleSampler(
            8, 1, ll, pr, nleaves_max=2, nleaves_min=0, rj_moves=True,
            moves=StretchMove(live_dangerously=True), device="cpu",
        )
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ens = eryn_tpu_torch.EnsembleSampler(
            8, 1, ll, {"a": pr, "b": pr}, branch_names=["a", "b"],
            nleaves_max=2, nleaves_min={"a": 0, "b": 1},
            rj_moves="iterate_branches",
            moves=RedBlueGroupStretchMove(live_dangerously=True), device="cpu",
        )
    assert [m.proposal_branch_names for m in ens.rj_moves] == [["a"], ["b"]]
    assert ens.rj_weights == [0.5, 0.5]
    assert ens.rj_moves[1].nleaves_min == {"b": 1}
    assert list(ens.all_moves) == ["RedBlueGroupStretchMove_0",
                                   "DistributionGenerateRJ_0",
                                   "DistributionGenerateRJ_1"]
    with pytest.raises(ValueError, match="rj_moves"):
        eryn_tpu_torch.EnsembleSampler(8, 1, ll, pr, nleaves_max=2,
                                       rj_moves="sideways", device="cpu")
    # periodic parameters are taken, as a container or the dict of one
    move = RedBlueGroupStretchMove(periodic={"model_0": {0: 1.0}})
    assert move.periodic.period_vector(
        "model_0", 2, torch.float32, "cpu").tolist() == [1.0, float("inf")]
    with pytest.raises(ValueError, match="periodic must be"):
        RedBlueGroupStretchMove(periodic="model_0")


@pytest.mark.parametrize("backend", ["Backend", "DeviceBackend"])
def test_rj_stores_masks_and_counters(backend):
    """Masks are stored per step under RJ; both backends read the same
    chain, leaf counts and RJ counters, and the adaptation clock advances
    once per step (the RJ epilogue does not adapt the ladder)."""
    pr = _port_priors([(-1.0, 1.0)] * 2)
    ens = eryn_tpu_torch.EnsembleSampler(
        16, 2, lambda coords, inds: torch.zeros(()), pr, nleaves_max=3,
        moves=RedBlueGroupStretchMove(live_dangerously=True), rj_moves=True,
        tempering_kwargs=dict(ntemps=2), fill_zero_leaves_val=0.0, seed=1,
        backend=getattr(eryn_tpu_torch, backend)(), device="cpu",
    )
    coords = np.random.default_rng(1).uniform(-1, 1, (2, 16, 3, 2))
    ens.run_mcmc(eryn_tpu_torch.State({"model_0": coords}), 40, thin_by=2)
    inds = ens.get_inds()["model_0"]
    assert inds.shape == (40, 2, 16, 3)
    assert len({m.tobytes() for m in inds}) > 1  # the masks changed
    np.testing.assert_array_equal(ens.get_nleaves()["model_0"], inds.sum(-1))
    chain = ens.get_chain()["model_0"]
    assert np.isnan(chain[~inds]).all() and np.isfinite(chain[inds]).all()
    rj = ens.rj_acceptance_fraction
    assert rj.shape == (2, 16) and 0 < rj.mean() < 1
    assert ens.temperature_control.time == 80
    last = ens.get_last_sample()
    np.testing.assert_array_equal(last.branches["model_0"].inds, inds[-1])
    rj_move = ens.rj_moves[0]
    assert rj_move.num_proposals == 80 and rj_move.accepted.shape == (2, 16)


def test_rj_only_schedule():
    """With no in-model repeats a step is only the RJ move: the stored
    in-model accepts and swaps are zeros (as eryn_tpu starts them), and the
    ladder's clock does not advance."""
    pr = _port_priors([(-1.0, 1.0)] * 2)
    ens = eryn_tpu_torch.EnsembleSampler(
        16, 2, lambda coords, inds: torch.zeros(()), pr, nleaves_max=3,
        moves=RedBlueGroupStretchMove(live_dangerously=True), rj_moves=True,
        num_repeats_in_model=0, tempering_kwargs=dict(ntemps=2),
        fill_zero_leaves_val=0.0, seed=2, device="cpu",
    )
    coords = np.random.default_rng(2).uniform(-1, 1, (2, 16, 3, 2))
    ens.run_mcmc(eryn_tpu_torch.State({"model_0": coords}), 20)
    assert (ens.acceptance_fraction == 0).all()
    assert (np.asarray(ens.swap_acceptance_fraction) == 0).all()
    assert 0 < ens.rj_acceptance_fraction.mean() < 1
    assert ens.temperature_control.time == 0
