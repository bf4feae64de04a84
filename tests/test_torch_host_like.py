"""Host (NumPy) likelihoods and priors in the port, against ``eryn_tpu``.

* The contracts of ``tests/test_vectorize_compat.py`` (``vectorize=True``
  with ``provide_groups`` under reversible jump, supplementals as the
  keyword ``branch_supps`` with a pool, vectorized, and a real spawn pool
  whose chain equals the serial one) and of ``tests/test_blobs.py``'s two
  host cases (``[log_like, *blobs]`` per walker; a ``(n, 1)`` return is
  not blobs).
* The host evaluation exactly: the same NumPy inputs through the port's
  host mode and ``eryn_tpu``'s ``LikelihoodEvaluator.host_call`` give the
  same log-likelihoods and blobs, and the function receives the same
  arguments (recorded by a spy): per walker, vectorized, with
  ``provide_groups`` under reversible jump, two branches with an empty one,
  and with branch supplementals.
* No mode changes quietly: the choice of the host mode warns and shows in
  ``likelihood_mode``; a torch function that fails both probes raises a
  ``TypeError`` with both errors; a gradient move refuses a host
  likelihood.
* The slice whole: the north-star at 4 x 32 with a NumPy likelihood equals
  the same sampler with the torch likelihood (same seed, float64, CPU):
  the same accept and swap decisions, chains within 1e-12; and a host run's
  cold moments against ``eryn_tpu``'s with ``tests/test_legacy_moves.py``'s
  tolerances.
* A SciPy prior in a run.
"""

import copy
import os
import warnings

import numpy as np
import pytest
import scipy.stats
import torch

import jax
import jax.numpy as jnp

import eryn_tpu
import eryn_tpu_torch as et
from eryn_tpu.ensemble import LikelihoodEvaluator as JaxEvaluator
from eryn_tpu_torch import BranchSupplemental, State
from eryn_tpu_torch.ensemble import LikelihoodEvaluator



def _uniform(ndim, lo=-5.0, hi=5.0, pkg=et):
    return pkg.ProbDistContainer({i: pkg.uniform_dist(lo, hi)
                                  for i in range(ndim)})


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


# ----------------------------------------------------------------------
# the contracts of tests/test_vectorize_compat.py
# ----------------------------------------------------------------------
def test_vectorized_groups_rj():
    rng = np.random.default_rng(2)
    t = np.linspace(0, 10, 64)
    sigma = 0.4
    data = 3.0 * np.exp(-((t - 5.0) ** 2) / (2 * 0.8**2))
    data = data + sigma * rng.standard_normal(len(t))
    calls = {"n": 0}

    def log_like(x, groups):
        # x: (active leaves, 3); groups: the walker of each leaf
        calls["n"] += 1
        nwalkers_here = groups.max() + 1 if len(groups) else 0
        templates = np.zeros((nwalkers_here, len(t)))
        for params, g in zip(x, groups):
            a, b, c = params
            templates[g] += a * np.exp(-((t - b) ** 2) / (2 * c**2))
        return -0.5 * np.sum(((templates - data) / sigma) ** 2, axis=-1)

    priors = et.ProbDistContainer({0: et.uniform_dist(0.5, 5.0),
                                   1: et.uniform_dist(0.0, 10.0),
                                   2: et.uniform_dist(0.2, 2.0)})
    ens = et.EnsembleSampler(
        16, 3, log_like, priors, nleaves_max=2, nleaves_min=0, rj_moves=True,
        vectorize=True, provide_groups=True, seed=41, device="cpu",
        fill_zero_leaves_val=float(-0.5 * np.sum((data / sigma) ** 2)),
        moves=et.moves.RedBlueGroupStretchMove(live_dangerously=True))
    coords = priors.rvs(size=(1, 16, 2), generator=_gen())
    inds = np.random.rand(1, 16, 2) < 0.7
    inds[..., 0] = True
    with pytest.warns(UserWarning, match="runs as a NumPy likelihood"):
        ens.run_mcmc(State({"model_0": coords}, inds={"model_0": inds}), 20,
                     burn=5)
    assert ens.likelihood_mode == "host"
    assert calls["n"] > 0
    ll = ens.get_log_like()
    assert ll.shape == (20, 1, 16) and np.all(np.isfinite(ll))
    assert ll[-1].max() > ll[0].max() - 1.0


class CountingPool:
    def __init__(self):
        self.calls = 0

    def map(self, fn, items):
        self.calls += 1
        return [fn(it) for it in items]


def _tagged_state(priors, nwalkers):
    supp = BranchSupplemental(
        {"tag": np.arange(nwalkers, dtype=float).reshape(1, nwalkers, 1)},
        base_shape=(1, nwalkers, 1))
    return State({"model_0": priors.rvs(size=(1, nwalkers, 1),
                                        generator=_gen())},
                 branch_supplemental={"model_0": supp})


def test_callback_supplementals_and_pool():
    """A host likelihood gets the walker's active-leaf branch supplementals
    as the keyword branch_supps, fanned out through the pool's map."""
    ndim, nwalkers = 2, 16
    seen = {"supps": 0}

    def np_ll(x, branch_supps=None):
        assert branch_supps is not None and "model_0" in branch_supps
        tag = branch_supps["model_0"]["tag"]
        assert tag.shape[0] == 1  # this walker's active leaves
        seen["supps"] += 1
        np.polyfit(np.arange(ndim), np.asarray(x, dtype=float), 1)
        return -0.5 * float(np.sum(np.asarray(x) ** 2)) + 0.0 * float(tag[0])

    pool = CountingPool()
    priors = _uniform(ndim)
    ens = et.EnsembleSampler(nwalkers, ndim, np_ll, priors, device="cpu",
                             provide_supplemental=True, pool=pool, seed=31)
    assert ens.likelihood_mode is None  # decided on the run's supplementals
    assert ens.get_model().map_fn == pool.map
    ens.run_mcmc(_tagged_state(priors, nwalkers), 10)
    assert seen["supps"] > 0 and pool.calls > 0
    assert np.isfinite(ens.get_log_like()).all()
    assert ens.likelihood_mode == "host"


def test_callback_vectorized_supplementals():
    """vectorize=True on the host passes the active leaves' supplementals
    as the keyword branch_supps."""
    ndim, nwalkers = 2, 16
    seen = {"n": 0}

    def np_ll(x, groups, branch_supps=None):
        assert branch_supps is not None and "tag" in branch_supps
        assert branch_supps["tag"].shape[0] == x.shape[0]
        seen["n"] += 1
        np.polyfit(np.arange(ndim), np.asarray(x[0], dtype=float), 1)
        amp = np.zeros(int(groups.max()) + 1)
        np.add.at(amp, groups, -0.5 * np.sum(np.asarray(x) ** 2, axis=-1))
        return amp

    priors = _uniform(ndim)
    ens = et.EnsembleSampler(nwalkers, ndim, np_ll, priors, vectorize=True,
                             provide_groups=True, provide_supplemental=True,
                             seed=32, device="cpu")
    ens.run_mcmc(_tagged_state(priors, nwalkers), 10)
    assert seen["n"] > 0
    assert ens.likelihood_mode == "host"
    assert np.isfinite(ens.get_log_like()).all()


def test_real_multiprocessing_pool(tmp_path, monkeypatch):
    """A spawn pool of two processes: the worker pickles, the likelihood
    runs in other processes, and the chain equals the serial run's."""
    import multiprocessing as mp

    from _pool_ll import pool_log_like

    pid_file = tmp_path / "worker_pids.txt"
    monkeypatch.setenv("ERYN_TPU_POOL_PID_FILE", str(pid_file))
    ndim, nwalkers, nsteps = 2, 12, 8
    priors = _uniform(ndim)
    coords = priors.rvs(size=(1, nwalkers, 1), generator=_gen(3))

    def run(pool):
        ens = et.EnsembleSampler(nwalkers, ndim, pool_log_like, priors,
                                 pool=pool, seed=77, device="cpu",
                                 dtype=torch.float64)
        ens.run_mcmc(State({"model_0": coords.clone()}), nsteps)
        return ens.get_chain()["model_0"], ens.get_log_like()

    with mp.get_context("spawn").Pool(2) as pool:
        chain_pool, ll_pool = run(pool)
    monkeypatch.delenv("ERYN_TPU_POOL_PID_FILE")
    chain_serial, ll_serial = run(None)
    worker_pids = {int(p) for p in pid_file.read_text().split()}
    assert worker_pids - {os.getpid()}, "no pool worker ran the likelihood"
    np.testing.assert_array_equal(chain_pool, chain_serial)
    np.testing.assert_array_equal(ll_pool, ll_serial)
    assert np.isfinite(ll_pool).all()


# ----------------------------------------------------------------------
# the host cases of tests/test_blobs.py
# ----------------------------------------------------------------------
NWALKERS_B, NDIM_B = 16, 2


def test_callback_blobs():
    """``[log_like, *blobs]`` per walker: the blob shape is found at
    set-up, and the blobs are stored with the chain."""
    def numpy_like(x):
        x = np.asarray(x)
        ll = float(-0.5 * np.sum(x**2))
        return [ll, -2.0 * ll, x[0]]

    priors = _uniform(NDIM_B)
    ens = et.EnsembleSampler(NWALKERS_B, NDIM_B, numpy_like, priors, seed=31,
                             device="cpu")
    ens.run_mcmc(priors.rvs(size=(NWALKERS_B,), generator=_gen()), 15)
    assert ens.likelihood_mode == "host" and ens._like_eval.returns_blobs
    blobs = ens.get_blobs()
    assert blobs.shape == (15, 1, NWALKERS_B, 2)
    ll = ens.get_log_like()
    np.testing.assert_allclose(blobs[..., 0], -2.0 * ll, rtol=1e-4)
    chain = ens.get_chain()["model_0"]
    np.testing.assert_allclose(blobs[..., 1], chain[:, :, :, 0, 0], rtol=1e-4)


def test_vectorized_callback_keepdims_not_blobs():
    """A vectorized host likelihood returning ``(n, 1)`` is a plain
    likelihood, not zero-width blobs."""
    def numpy_like_vec(x):
        x = np.asarray(x)
        return -0.5 * np.sum(x**2, axis=-1, keepdims=True)

    priors = _uniform(NDIM_B)
    ens = et.EnsembleSampler(NWALKERS_B, NDIM_B, numpy_like_vec, priors,
                             vectorize=True, seed=35, device="cpu")
    ens.run_mcmc(priors.rvs(size=(NWALKERS_B,), generator=_gen()), 10)
    assert ens.likelihood_mode == "host"
    assert not ens._like_eval.returns_blobs
    assert ens.get_blobs() is None
    assert np.isfinite(ens.get_log_like()).all()


# ----------------------------------------------------------------------
# the host evaluation, exactly against eryn_tpu's host_call
# ----------------------------------------------------------------------
def _spy(fn, record):
    def spy(*args, **kwargs):
        record.append(copy.deepcopy((args, kwargs)))
        return fn(*args, **kwargs)

    return spy


def _assert_same(a, b, path="args"):
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif a is None:
        assert b is None, path
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=path)


def _ll_rows(x, *rest, **kw):
    return -0.5 * np.sum(np.asarray(x) ** 2, axis=-1)


def _ll_walker(x, *rest, **kw):
    return -0.5 * float(np.sum(np.asarray(x) ** 2))


def _ll_branches(xs, *rest, **kw):
    return -0.5 * sum(float(np.sum(x**2)) for x in xs if x is not None)


def _ll_blobs(x, *rest, **kw):
    ll = -0.5 * float(np.sum(np.asarray(x) ** 2))
    return [ll, -2.0 * ll, float(np.asarray(x).ravel()[0])]


def _ll_supp(x, branch_supps=None):
    tag = branch_supps["a"]["tag"]
    return -0.5 * float(np.sum(np.asarray(x) ** 2)) + float(np.sum(tag))


def _ll_groups(x, groups):
    out = np.zeros(int(groups.max()) + 1)
    np.add.at(out, groups, -0.5 * np.sum(x**2, axis=-1))
    return out


# name: (fn, branches {name: (nleaves_max, ndim)}, vectorize, groups, rj,
# supplemental)
CASES = {
    "per walker": (_ll_walker, {"a": (1, 3)}, False, False, False, False),
    "vectorized": (_ll_rows, {"a": (1, 3)}, True, False, False, False),
    "groups, rj": (_ll_groups, {"a": (3, 2)}, True, True, True, False),
    "two branches, one empty": (_ll_branches, {"a": (2, 2), "b": (3, 2)},
                                False, False, True, False),
    "blobs": (_ll_blobs, {"a": (1, 3)}, False, False, False, False),
    "branch supplementals": (_ll_supp, {"a": (2, 2)}, False, False, True,
                             True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_host_evaluation_equals_jax_host_call(case):
    """The same NumPy inputs (4 x 6 walkers; a walker outside the prior, a
    walker without leaves) through the port's host mode and eryn_tpu's
    host_call: the log-likelihoods, the blobs and every argument the
    function received."""
    fn, branches, vectorize, groups, rj, supp = CASES[case]
    rng = np.random.default_rng(7)
    nt, nw = 4, 6
    names = list(branches)
    coords = {n: rng.standard_normal((nt, nw, nl, nd))
              for n, (nl, nd) in branches.items()}
    inds = {n: rng.random((nt, nw, nl)) < 0.6
            for n, (nl, _) in branches.items()}
    if not rj:
        inds = {n: np.ones_like(v) for n, v in inds.items()}
    else:
        for n in names:
            inds[n][0, 1] = False  # a walker without leaves
        inds[names[-1]][1] = False  # an empty branch on a whole rung
        inds[names[0]][1, :, 0] = True
    logp = np.zeros((nt, nw))
    logp[2, 3] = -np.inf  # outside the prior: never evaluated
    bsupps = None
    if supp:
        bsupps = {"a": {"tag": rng.standard_normal(
            (nt, nw, branches["a"][0]))}}
    common = dict(branch_names=names, ndims={n: d for n, (_, d)
                                              in branches.items()},
                  nleaves_max={n: l for n, (l, _) in branches.items()},
                  args=None, kwargs=None, vectorize=vectorize,
                  provide_groups=groups, provide_supplemental=supp,
                  fill_zero_leaves_val=-1e10, rj=rj)
    got_args, want_args = [], []
    ours = LikelihoodEvaluator(_spy(fn, got_args), dtype=torch.float64,
                               **common)
    ours.check(torch.device("cpu"), None if bsupps is None else {
        "a": {"tag": torch.as_tensor(bsupps["a"]["tag"])}})
    assert ours.mode == "host"
    with warnings.catch_warnings(), jax.enable_x64(True):
        warnings.simplefilter("ignore")
        ref = JaxEvaluator(_spy(fn, want_args), dtype=jnp.float64,
                           nleaves_min={n: 0 for n in names}, **common)
        got_args.clear()
        want_args.clear()
        ll, blobs = ours(
            {n: torch.as_tensor(v) for n, v in coords.items()},
            {n: torch.as_tensor(v) for n, v in inds.items()},
            torch.as_tensor(logp),
            None if bsupps is None else {"a": {
                "tag": torch.as_tensor(bsupps["a"]["tag"])}})
        ll_ref, blobs_ref = ref.host_call(coords, inds, logp, bsupps)
        ll_ref = np.asarray(ll_ref)
        blobs_ref = None if blobs_ref is None else np.asarray(blobs_ref)
    np.testing.assert_array_equal(ll.numpy(), np.asarray(ll_ref))
    if blobs_ref is None:
        assert blobs is None
    else:
        np.testing.assert_array_equal(blobs.numpy(), np.asarray(blobs_ref))
    assert len(got_args) == len(want_args) > 0
    _assert_same(got_args, want_args)


# ----------------------------------------------------------------------
# no mode changes quietly
# ----------------------------------------------------------------------
def _evaluator(fn, vectorize=False):
    return LikelihoodEvaluator(
        fn, branch_names=["m"], ndims={"m": 3}, nleaves_max={"m": 1},
        args=None, kwargs=None, vectorize=vectorize,
        fill_zero_leaves_val=-1e300, dtype=torch.float32)


def test_the_host_mode_warns_and_shows():
    ev = _evaluator(lambda x: -0.5 * float(np.sum(x**2)))
    with pytest.warns(UserWarning, match="never as a CUDA graph"):
        ev.check(torch.device("cpu"))
    assert ev.mode == "host" and ev.host
    torch_ev = _evaluator(lambda x: -0.5 * (x * x).sum())
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        torch_ev.check(torch.device("cpu"))
    assert torch_ev.mode == "vmap" and not torch_ev.host


def test_a_torch_function_failing_both_probes_raises_with_both():
    """``torch.tensor(float(...))`` cannot vmap, and on NumPy arrays it
    returns a tensor: a torch likelihood never runs on the host."""
    ev = _evaluator(lambda x: torch.tensor(float(x.sum())))
    with pytest.raises(TypeError, match="NumPy likelihood") as info:
        ev.check(torch.device("cpu"))
    assert "not NumPy values" in str(info.value)
    assert ev.mode is None


def test_gradient_moves_refuse_a_host_likelihood():
    pr = _uniform(2)
    s = et.EnsembleSampler(8, 2, lambda x: -0.5 * float(np.sum(x**2)), pr,
                           moves=et.moves.MALAMove(), device="cpu")
    with pytest.raises(TypeError, match="NumPy likelihood, run on the host"):
        s.run_mcmc(pr.rvs(size=(8,), generator=_gen()), 2)


# ----------------------------------------------------------------------
# the slice whole
# ----------------------------------------------------------------------
def _north_star(fn, seed=4, **kw):
    pr = _uniform(5)
    s = et.EnsembleSampler(32, 5, fn, pr, tempering_kwargs=dict(ntemps=4),
                           seed=seed, device="cpu", dtype=torch.float64, **kw)
    start = pr.rvs(size=(4, 32), generator=_gen(1))
    return s, start


@pytest.mark.parametrize("vectorize", [False, True])
def test_host_north_star_equals_the_torch_likelihood(vectorize):
    """4 x 32, float64, 60 stored steps: the NumPy likelihood on the host
    and the same likelihood in torch take the same accept and swap
    decisions, and their chains agree to 1e-12."""
    if vectorize:
        host = (lambda x: -0.5 * np.sum(x**2, axis=-1))
        native = (lambda x: -0.5 * (x * x).sum(-1))
    else:
        host = (lambda x: -0.5 * float(np.sum(x**2)))
        native = (lambda x: -0.5 * (x * x).sum())
    runs = []
    for fn in (host, native):
        s, start = _north_star(fn, vectorize=vectorize)
        s.run_mcmc(start, 60, burn=20)
        runs.append(s)
    h, n = runs
    assert h.likelihood_mode == "host" and n.likelihood_mode != "host"
    np.testing.assert_array_equal(h.backend.accepted, n.backend.accepted)
    np.testing.assert_array_equal(h.backend.swaps_accepted,
                                  n.backend.swaps_accepted)
    for get in ("get_chain", "get_log_like", "get_betas"):
        a, b = getattr(h, get)(), getattr(n, get)()
        a = a["model_0"] if isinstance(a, dict) else a
        b = b["model_0"] if isinstance(b, dict) else b
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)


def test_host_run_moments_match_jax():
    """A host run's cold mean and spread against eryn_tpu's run of the same
    target, within 0.2 (tests/test_legacy_moves.py's tolerances)."""
    s, start = _north_star(lambda x: -0.5 * float(np.sum(x**2)), seed=8)
    s.run_mcmc(start, 300, burn=100)
    ours = s.get_chain(temp_index=0)["model_0"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        js = eryn_tpu.EnsembleSampler(
            32, 5, lambda x: -0.5 * jnp.sum(x**2), _uniform(5, pkg=eryn_tpu),
            tempering_kwargs=dict(ntemps=4), seed=8)
        js.run_mcmc(start.numpy(), 300, burn=100)
    theirs = np.asarray(js.get_chain(temp_index=0)["model_0"])
    assert abs(ours.mean() - theirs.mean()) < 0.2
    assert abs(ours.std() - theirs.std()) < 0.2
    assert abs(ours.std() - 1.0) < 0.2


def test_a_scipy_prior_runs():
    """A SciPy normal prior (host evaluated) in a run: the cold chain
    samples it under a flat likelihood."""
    pr = et.ProbDistContainer({0: scipy.stats.norm(0.0, 1.0),
                               1: et.uniform_dist(-1.0, 1.0)})
    assert pr.host
    s = et.EnsembleSampler(16, 2, lambda x: torch.zeros((), dtype=x.dtype),
                           pr, device="cpu", seed=5, dtype=torch.float64)
    assert s._visits_host
    s.run_mcmc(pr.rvs(size=(16,), generator=_gen()), 400, burn=100)
    ch = s.get_chain()["model_0"][:, 0, :, 0]
    assert abs(ch[..., 0].mean()) < 0.2 and abs(ch[..., 0].std() - 1) < 0.2
    assert np.all(np.abs(ch[..., 1]) <= 1.0)
