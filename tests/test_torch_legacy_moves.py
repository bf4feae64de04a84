"""Moves written for Eryn's host protocol, in the port
(``eryn_tpu_torch.moves.legacy``), against ``eryn_tpu``.

The contracts of ``tests/test_legacy_moves.py`` on the port: each family
(``MHMove.get_proposal``, ``RedBlueMove.get_proposal``, the friends hooks
of ``GroupStretchMove``, the multiple-try ``special_*`` hooks, reversible
jump's ``get_model_change_proposal``, a ``propose`` of its own) is flagged
``host_move`` and recovers its target.  Then the MH, red/blue and group
families decision for decision: at ``ntemps=1`` in float64, 50 proposals of
the port's ``move.propose(model, state)`` and ``eryn_tpu``'s from one start
take the same accept decisions, with coordinates within 1e-12 (the port's
``RandomState(s)`` against ``np.random.seed(s)``).
"""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import eryn_tpu
import eryn_tpu.moves.legacy
import eryn_tpu_torch as et
import eryn_tpu_torch.moves.legacy
from eryn_tpu_torch import BranchSupplemental, State
from eryn_tpu_torch.moves import GroupStretchMove, MHMove, RedBlueMove


NDIM = 3
NWALKERS = 32


def log_like(x):
    return -0.5 * torch.sum(x * x)


def _priors(pkg=et):
    return pkg.ProbDistContainer({i: pkg.uniform_dist(-5, 5)
                                  for i in range(NDIM)})


def _start(seed=0, ntemps=1):
    return _priors().rvs(size=(ntemps, NWALKERS),
                         generator=torch.Generator().manual_seed(seed))


def _sampler(moves, seed, **kw):
    with pytest.warns(UserWarning, match="host extension protocol"):
        return et.EnsembleSampler(NWALKERS, NDIM, log_like, _priors(),
                                  moves=moves, seed=seed, device="cpu", **kw)


def _cold(s, discard):
    return s.get_chain()["model_0"][discard:]


def test_legacy_mh_custom_get_proposal():
    class MyMH(MHMove):
        def get_proposal(self, branches_coords, random, branches_inds=None,
                         **kwargs):
            q = {name: np.asarray(c) + 0.8 * random.randn(*np.shape(c))
                 for name, c in branches_coords.items()}
            return q, np.zeros(next(iter(q.values())).shape[:2])

    move = MyMH()
    assert move.host_move and move._legacy_family == "mh"
    s = _sampler(move, 0)
    s.run_mcmc(_start(), 300, burn=150)
    ch = _cold(s, 150)
    assert abs(ch.mean()) < 0.2
    assert abs(ch.std() - 1.0) < 0.2
    assert 0.05 < s.acceptance_fraction.mean() < 0.95


def test_legacy_redblue_custom_get_proposal():
    from eryn_tpu_torch.moves.legacy import stretch_get_proposal

    calls = {"n": 0}

    class MyStretch(RedBlueMove):
        a = 2.0

        def get_proposal(self, s_all, c_all, random, gibbs_ndim=None, **kw):
            calls["n"] += 1
            return stretch_get_proposal(self, s_all, c_all, random,
                                        gibbs_ndim=gibbs_ndim)

    move = MyStretch()
    assert move.host_move and move._legacy_family == "redblue"
    s = _sampler(move, 1)
    s.run_mcmc(_start(), 300, burn=100)
    assert calls["n"] > 0
    ch = _cold(s, 150)
    assert abs(ch.mean()) < 0.2
    assert abs(ch.std() - 1.0) < 0.2


def test_builtin_moves_are_not_legacy():
    from eryn_tpu_torch.moves import (
        DistributionGenerate,
        GaussianMove,
        StretchMove,
    )

    assert not StretchMove().host_move
    assert not GaussianMove({"model_0": 0.1}).host_move
    pr = _priors()
    assert not DistributionGenerate({"model_0": pr}).host_move
    assert not GroupStretchMove().host_move
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        s = et.EnsembleSampler(NWALKERS, NDIM, log_like, pr, seed=3,
                               device="cpu")
    assert not any(s._host_moves)


def test_legacy_group_stretch_reference_protocol():
    """The contract of Eryn's own custom group-stretch test, at its
    scaled-down size: mean-sorted friends in a branch supplemental, repaired
    after births by ``fix_friends``, under reversible jump and tempering."""
    nwalkers, ntemps, ndim = 20, 4, 3
    nleaves_max, nleaves_min = 4, 0
    nfriends = nwalkers
    hook_calls = {"setup": 0, "fix": 0, "find": 0}

    def closest(current_means, means, n):
        dist = np.abs(current_means[:, None] - means[None, :])
        take = min(n, means.shape[0])
        inds_closest = np.argsort(dist, axis=1)[:, :n]
        if take < n:  # pad by repeating the closest
            inds_closest = np.concatenate(
                [inds_closest] + [inds_closest[:, :1]] * (n - take), axis=1)
        return inds_closest

    class MeanGaussianGroupMove(GroupStretchMove):
        def setup_friends(self, branches):
            hook_calls["setup"] += 1
            b = branches["gauss"]
            friends = b.coords[0, b.inds[0]]
            self.means, uni = np.unique(friends[:, 1].copy(),
                                        return_index=True)
            self.friends = friends[uni]
            srt = np.argsort(self.means)
            self.friends[:] = self.friends[srt]
            self.means[:] = self.means[srt]
            b.branch_supplemental[b.inds] = {"inds_closest": closest(
                b.coords[b.inds, 1], self.means, self.nfriends)}
            b.branch_supplemental[~b.inds] = {"inds_closest": -np.ones(
                (ntemps, nwalkers, nleaves_max, self.nfriends),
                dtype=int)[~b.inds]}

        def fix_friends(self, branches):
            hook_calls["fix"] += 1
            b = branches["gauss"]
            fix = b.inds & np.all(
                b.branch_supplemental[:]["inds_closest"] == -1, axis=-1)
            if not np.any(fix):
                return
            b.branch_supplemental[fix] = {"inds_closest": closest(
                b.coords[fix, 1], self.means, self.nfriends)}

        def find_friends(self, name, s, s_inds=None, branch_supps=None):
            hook_calls["find"] += 1
            friends = np.zeros_like(np.asarray(s))
            here = np.clip(branch_supps[name][s_inds]["inds_closest"], 0,
                           self.friends.shape[0] - 1)
            random_inds = here[np.arange(here.shape[0]), np.random.randint(
                self.nfriends, size=(here.shape[0],))]
            friends[s_inds] = self.friends[random_inds]
            return friends

    num = 128
    t = np.linspace(-1, 1, num)
    inj = [[3.3, -0.2, 0.1], [2.6, 0.1, 0.1]]

    def pulse(x, a, b, c):
        return a * np.exp(-((x - b) ** 2) / (2 * c**2))

    y = sum(pulse(t, *p) for p in inj) + np.random.randn(num)
    t_t, y_t = torch.as_tensor(t), torch.as_tensor(y)

    def ll(coords, inds):
        a, b, c = coords[:, 0:1], coords[:, 1:2], coords[:, 2:3]
        tmpl = torch.where(inds[:, None],
                           a * torch.exp(-((t_t - b) ** 2) / (2 * c**2)), 0.0)
        return -0.5 * torch.sum((tmpl.sum(0) - y_t) ** 2)

    coords = np.zeros((ntemps, nwalkers, nleaves_max, ndim))
    for nn, p in enumerate(inj):
        coords[:, :, nn] = np.random.multivariate_normal(
            p, np.diag(np.ones(3) * 0.0001), size=(ntemps, nwalkers))
    inds = np.zeros((ntemps, nwalkers, nleaves_max), dtype=bool)
    inds[:, :, :len(inj)] = True
    priors = {"gauss": et.ProbDistContainer({
        0: et.uniform_dist(2.0, 4.0), 1: et.uniform_dist(t.min(), t.max()),
        2: et.uniform_dist(0.01, 0.3)})}
    with pytest.warns(UserWarning, match="HYBRID"):
        ens = et.EnsembleSampler(
            nwalkers, ndim, ll, priors, tempering_kwargs=dict(ntemps=ntemps),
            branch_names=["gauss"], nleaves_max=nleaves_max,
            nleaves_min=nleaves_min,
            moves=MeanGaussianGroupMove(nfriends=nfriends, n_iter_update=20),
            rj_moves=True, fill_zero_leaves_val=float(-0.5 * np.sum(y**2)),
            seed=4, device="cpu", dtype=torch.float64)
    assert ens._host_moves == [True, False]
    supp = BranchSupplemental(
        {"inds_closest": np.zeros(inds.shape + (nfriends,), dtype=int)},
        base_shape=(ntemps, nwalkers, nleaves_max))
    state = State({"gauss": coords}, inds={"gauss": inds},
                  branch_supplemental={"gauss": supp})
    ens.run_mcmc(state, 120, burn=10)

    assert hook_calls["setup"] >= 2  # the first call and the window's
    assert hook_calls["find"] > 0 and hook_calls["fix"] > 0
    nleaves = ens.get_nleaves()["gauss"][:, 0]
    assert np.median(nleaves) >= 2  # the two strong pulses stay
    assert 0.01 < ens.acceptance_fraction.mean() < 1.0
    assert ens.get_chain()["gauss"].shape[:2] == (120, ntemps)


def test_legacy_mixed_with_builtin_moves():
    """A host move and a native one share the schedule; both run."""
    from eryn_tpu_torch.moves import StretchMove
    from eryn_tpu_torch.moves.legacy import stretch_get_proposal

    class MyStretch(RedBlueMove):
        a = 2.0

        def get_proposal(self, s_all, c_all, random, gibbs_ndim=None, **kw):
            return stretch_get_proposal(self, s_all, c_all, random,
                                        gibbs_ndim=gibbs_ndim)

    s = _sampler([(MyStretch(), 0.5), (StretchMove(), 0.5)], 5)
    s.run_mcmc(_start(), 250, burn=100)
    assert abs(_cold(s, 100).std() - 1.0) < 0.25
    for m in s.moves:
        assert m.num_proposals > 0


def _sharp_mt(base, calls):
    class MyMT(base):
        def special_like_func(self, generated_coords, **kwargs):
            calls["like"] += 1
            pts = np.asarray(generated_coords)
            return (-0.5 * np.sum((pts / 0.5) ** 2, axis=-1)).reshape(
                -1, self.num_try)

        def special_prior_func(self, generated_coords, **kwargs):
            calls["prior"] += 1
            pts = np.asarray(generated_coords)
            inside = np.all(np.abs(pts) < 5.0, axis=-1)
            return np.where(inside, -np.log(10.0) * NDIM, -np.inf).reshape(
                -1, self.num_try)

    return MyMT


def test_legacy_mt_custom_special_like_func():
    """A multiple-try subclass overriding the special_* hooks runs the host
    protocol with the stock get_proposal driving them; the overridden
    likelihood (sigma 0.5) sets the posterior, and the acceptance is
    eryn_tpu's for the same configuration (about 0.05, so the gate is the
    distance to it: 0.01 is 4 standard deviations of 8,000 proposals)."""
    calls = {"like": 0, "prior": 0}
    move = _sharp_mt(et.moves.MTDistGenMove, calls)(_priors(), num_try=8,
                                                    independent=True)
    assert move.host_move and move._legacy_family == "mh"
    s = _sampler(move, 7)
    s.run_mcmc(_start(), 250, burn=100)
    assert calls["like"] > 0 and calls["prior"] > 0
    ch = _cold(s, 100)
    assert abs(ch.mean()) < 0.15
    assert abs(ch.std() - 0.5) < 0.15

    jmove = _sharp_mt(eryn_tpu.moves.MTDistGenMove, {"like": 0, "prior": 0})(
        _priors(eryn_tpu), num_try=8, independent=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        js = eryn_tpu.EnsembleSampler(NWALKERS, NDIM,
                                      lambda x: -0.5 * jnp.sum(x**2),
                                      _priors(eryn_tpu), moves=jmove, seed=7)
        js.run_mcmc(_priors(eryn_tpu).rvs(size=(1, NWALKERS)), 250, burn=100)
    assert abs(s.acceptance_fraction.mean()
               - js.acceptance_fraction.mean()) < 0.01


def test_stock_mtdistgen_not_host_move():
    from eryn_tpu_torch.moves import MTDistGenMove

    assert not MTDistGenMove(_priors(), num_try=4, independent=True).host_move


class _ForcedHostMT(et.moves.MTDistGenMove):
    """No hook overridden: host mode forced, to drive the stock host
    protocol end to end."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.host_move = True
        self._legacy_family = "mh"


def test_mt_host_get_proposal_matches_kernel_statistics():
    """The stock host get_proposal and the kernel path sample one
    posterior."""
    s_host = _sampler(_ForcedHostMT(_priors(), num_try=6, independent=True),
                      11)
    s_host.run_mcmc(_start(), 250, burn=100)
    s_kern = et.EnsembleSampler(
        NWALKERS, NDIM, log_like, _priors(), device="cpu", seed=11,
        moves=et.moves.MTDistGenMove(_priors(), num_try=6, independent=True))
    s_kern.run_mcmc(_start(), 250, burn=100)
    ch_h, ch_k = _cold(s_host, 100), _cold(s_kern, 100)
    assert abs(ch_h.mean() - ch_k.mean()) < 0.2
    assert abs(ch_h.std() - ch_k.std()) < 0.2
    assert abs(ch_h.std() - 1.0) < 0.2


def _flat_rj_run(move, seed, rng_seed):
    pr = et.ProbDistContainer({0: et.uniform_dist(-3, 3),
                               1: et.uniform_dist(-3, 3)})

    def flat_ll(coords, inds):
        return torch.zeros((), dtype=coords.dtype)

    with pytest.warns(UserWarning, match="host extension protocol"):
        s = et.EnsembleSampler(
            NWALKERS, {"model_0": 2}, flat_ll, {"model_0": pr},
            nleaves_max={"model_0": 2}, nleaves_min={"model_0": 0},
            rj_moves=move, fill_zero_leaves_val=0.0, seed=seed, device="cpu",
            moves=et.moves.RedBlueGroupStretchMove(live_dangerously=True))
    coords = pr.rvs(size=(1, NWALKERS, 2),
                    generator=torch.Generator().manual_seed(0))
    inds = np.random.default_rng(rng_seed).random((1, NWALKERS, 2)) < 0.5
    s.run_mcmc(State({"model_0": coords}, inds={"model_0": inds}), 400,
               burn=100)
    k = s.get_inds()["model_0"].sum(axis=-1).ravel()
    return np.array([(k == i).mean() for i in range(3)])


def test_legacy_rj_custom_protocol():
    """A subclass overriding get_model_change_proposal runs the RJ host
    protocol; a flat likelihood gives a uniform leaf-count posterior."""
    calls = {"n": 0}

    class MyRJ(et.moves.DistributionGenerateRJ):
        def get_model_change_proposal(self, inds, random, nmin, nmax):
            calls["n"] += 1
            return super().get_model_change_proposal(inds, random, nmin, nmax)

    pr = et.ProbDistContainer({0: et.uniform_dist(-3, 3),
                               1: et.uniform_dist(-3, 3)})
    move = MyRJ({"model_0": pr}, nleaves_max={"model_0": 2},
                nleaves_min={"model_0": 0})
    assert move.host_move and move._legacy_family == "rj"
    freqs = _flat_rj_run(move, 17, 0)
    assert calls["n"] > 0
    assert np.all(np.abs(freqs - 1 / 3) < 0.1), freqs


def test_stock_distgenrj_not_host_move():
    pr = et.ProbDistContainer({0: et.uniform_dist(-3, 3)})
    move = et.moves.DistributionGenerateRJ(
        {"model_0": pr}, nleaves_max={"model_0": 2},
        nleaves_min={"model_0": 0})
    assert not move.host_move


def test_legacy_mt_rj_custom_special_like_func():
    """A multiple-try RJ subclass overriding special_like_func runs the RJ
    host protocol (death tries inverted, the one leaf less base); a flat
    likelihood gives a uniform leaf-count posterior."""
    calls = {"like": 0}

    class MyMTRJ(et.moves.MTDistGenMoveRJ):
        def special_like_func(self, generated_coords, inds_leaves_rj=None,
                              **kw):
            calls["like"] += 1
            return np.zeros((np.asarray(generated_coords).shape[0],
                             self.num_try))

    pr = et.ProbDistContainer({0: et.uniform_dist(-3, 3),
                               1: et.uniform_dist(-3, 3)})
    move = MyMTRJ({"model_0": pr}, nleaves_max={"model_0": 2},
                  nleaves_min={"model_0": 0}, num_try=4)
    assert move.host_move and move._legacy_family == "rj"
    freqs = _flat_rj_run(move, 29, 1)
    assert calls["like"] > 0
    assert np.all(np.abs(freqs - 1 / 3) < 0.1), freqs


def test_legacy_mt_regenerated_aux_unbiased():
    """The multiple-try auxiliary set drawn anew from the picked point (the
    default flags) keeps detailed balance: the target's moments hold."""
    s = _sampler(_ForcedHostMT(_priors(), num_try=5), 31)
    s.run_mcmc(_start(), 300, burn=100)
    ch = _cold(s, 100)
    assert abs(ch.mean()) < 0.15
    assert abs(ch.std() - 1.0) < 0.15


def test_custom_propose_override_runs_on_host():
    """A move with a propose of its own, written against Eryn's API on
    host arrays, is flagged and driven."""
    calls = {"n": 0}

    class MyPropose(et.moves.Move):
        def propose(self, model, state):
            calls["n"] += 1
            q = {n: np.asarray(c) + 0.5 * model.random.randn(*np.shape(c))
                 for n, c in state.branches_coords.items()}
            logp = np.asarray(model.compute_log_prior_fn(
                q, inds=state.branches_inds))
            logl, _ = model.compute_log_like_fn(
                q, inds=state.branches_inds, logp=logp)
            logl = np.asarray(logl)
            prev = np.asarray(state.log_like) + np.asarray(state.log_prior)
            acc = (logl + logp - prev) > np.log(
                model.random.rand(*prev.shape))
            new_state = type(state)(q, log_like=logl, log_prior=logp,
                                    inds=state.branches_inds)
            state = self.update(state, new_state, acc)
            self.accepted = (acc.astype(float) if self.accepted is None
                             else self.accepted + acc)
            self.num_proposals += 1
            return state, acc

    move = MyPropose()
    assert move.host_move and move._legacy_family == "custom-propose"
    s = _sampler(move, 33)
    s.run_mcmc(_start(), 200, burn=100)
    assert calls["n"] > 0
    ch = _cold(s, 100)
    assert abs(ch.mean()) < 0.25
    assert abs(ch.std() - 1.0) < 0.25


def test_move_update_merges_branch_supplementals():
    """Move.update with NumPy flags carries the accepted walkers'
    supplemental entries; skip_supp_names_update entries stay."""
    ntemps, nw, nl, nd = 1, 4, 1, 2
    rng = np.random.default_rng(3)

    def mk(tag):
        supp = BranchSupplemental(
            {"cache": np.full((ntemps, nw, nl, 3), tag),
             "keep": np.full((ntemps, nw, nl), tag)},
            base_shape=(ntemps, nw, nl))
        return State({"a": rng.standard_normal((ntemps, nw, nl, nd))},
                     log_like=rng.standard_normal((ntemps, nw)),
                     log_prior=np.zeros((ntemps, nw)),
                     branch_supplemental={"a": supp})

    mv = et.StretchMove(skip_supp_names_update=["keep"])
    acc = np.zeros((ntemps, nw), dtype=bool)
    acc[0, 1] = True
    out = mv.update(mk(0.0), mk(1.0), acc)
    supp = out.branches["a"].branch_supplemental
    cache = supp.holder["cache"].numpy()
    assert (cache[0, 1] == 1.0).all() and (cache[0, 0] == 0.0).all()
    assert (supp.holder["keep"].numpy() == 0.0).all()


# ----------------------------------------------------------------------
# decision for decision against eryn_tpu
# ----------------------------------------------------------------------
def _mh_move(pkg):
    class MyMH(pkg.moves.MHMove):
        def get_proposal(self, branches_coords, random, branches_inds=None,
                         **kwargs):
            q = {n: np.asarray(c) + 0.8 * random.randn(*np.shape(c))
                 for n, c in branches_coords.items()}
            return q, np.zeros(next(iter(q.values())).shape[:2])

    return MyMH()


def _redblue_move(pkg):
    class MyStretch(pkg.moves.RedBlueMove):
        a = 2.0

        def get_proposal(self, s_all, c_all, random, gibbs_ndim=None, **kw):
            return pkg.moves.legacy.stretch_get_proposal(
                self, s_all, c_all, random, gibbs_ndim=gibbs_ndim)

    return MyStretch()


def _group_move(pkg):
    class NearestFriends(pkg.moves.GroupStretchMove):
        """Friends: a snapshot of the ensemble; each walker draws one of
        them with the host generator handed to find_friends' caller."""

        def setup_friends(self, branches):
            self.friends = {n: np.array(b.coords[0])
                            for n, b in branches.items()}

        def find_friends(self, name, s, s_inds=None, branch_supps=None):
            pick = self.rng.randint(self.friends[name].shape[0],
                                    size=s.shape[:2])
            return self.friends[name][pick]

    move = NearestFriends(n_iter_update=10)
    move.rng = np.random.RandomState(9)
    return move


@pytest.mark.parametrize("family", ["mh", "redblue", "group"])
def test_host_moves_decide_as_eryn_tpu(family):
    """50 proposals at ntemps=1, float64: the same accept decisions as
    eryn_tpu's host bridge, coordinates within 1e-12."""
    build = {"mh": _mh_move, "redblue": _redblue_move,
             "group": _group_move}[family]
    x0 = np.random.default_rng(0).uniform(-2, 2, (1, 16, 1, NDIM))
    with warnings.catch_warnings(), jax.enable_x64(True):
        warnings.simplefilter("ignore")
        ej = eryn_tpu.EnsembleSampler(
            16, NDIM, lambda x: -0.5 * jnp.sum(x**2), _priors(eryn_tpu),
            moves=build(eryn_tpu), seed=1, dtype=jnp.float64)
        es = et.EnsembleSampler(
            16, NDIM, lambda x: -0.5 * (x * x).sum(), _priors(), device="cpu",
            moves=build(et), seed=1, dtype=torch.float64)
        sj = ej._setup_state(eryn_tpu.State({"model_0": x0}))
        st = es._setup_state(State({"model_0": torch.as_tensor(x0)}))
        mj, mt = ej.get_model(), es.get_model()
        np.random.seed(5)
        mt.random.seed(5)
        decisions = 0
        for k in range(50):
            sj, aj = ej.moves[0].propose(mj, sj)
            st, at = es.moves[0].propose(mt, st)
            np.testing.assert_array_equal(np.asarray(aj), at, err_msg=str(k))
            decisions += int(at.sum())
        assert 0 < decisions < 50 * 16
        np.testing.assert_allclose(st.branches["model_0"].coords.numpy(),
                                   np.asarray(sj.branches["model_0"].coords),
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(st.log_like.numpy(), np.asarray(sj.log_like),
                                   rtol=0, atol=1e-12)
    assert es.moves[0].num_proposals == 50
