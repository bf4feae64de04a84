"""The rest of the sampler's surface against ``eryn_tpu``: pickling, segment
timing and profiler traces, ``walkers_independent``, ``utils.logsumexp``,
``backends.get_test_backends``, ``dr_max_iter``, and ``AIMHMove`` with any
``df`` above 2.

Tolerances: an unpickled sampler continues the original's chain digit for
digit (both generators' states travel); ``walkers_independent``,
``logsumexp`` and the backends are compared exactly.  The gamma draws of
``AIMHMove`` are held to ``scipy.stats.chi2`` by a Kolmogorov-Smirnov test
at p > 1e-3 on 20,000 draws, as ``tests/test_aimh.py:228-251`` holds
``eryn_tpu``'s.
"""

import json
import pickle

import numpy as np
import pytest
import scipy.stats as ss
import torch

import eryn_tpu
import eryn_tpu.backends as jax_backends
import eryn_tpu.utils as jax_utils

import eryn_tpu_torch as et
import eryn_tpu_torch.backends as backends
import eryn_tpu_torch.utils as utils
from eryn_tpu_torch.moves import AIMHMove
from eryn_tpu_torch.moves import aimh as aimh_mod

torch.set_num_threads(1)


def unit_log_like(x):
    """At module level, so that a sampler built on it pickles."""
    return -0.5 * torch.sum(x * x)


def _sampler(backend=None, **kw):
    pr = et.ProbDistContainer({i: et.uniform_dist(-5, 5) for i in range(2)})
    return et.EnsembleSampler(16, 2, unit_log_like, pr,
                              tempering_kwargs=dict(ntemps=3), seed=11,
                              device="cpu", backend=backend, **kw), pr


@pytest.mark.parametrize("backend", ["host", "device"])
def test_pickled_sampler_continues_digit_for_digit(backend):
    """``tests/test_host_api_shims.py:434-456``'s contract (the pool and the
    captured graphs dropped, the clone keeps sampling), and more: the
    clone's next 10 steps equal the original's digit for digit."""
    s, pr = _sampler(et.Backend() if backend == "host" else et.DeviceBackend())
    s.run_mcmc(pr.rvs(size=(3, 16), generator=torch.Generator().manual_seed(0)),
               20, burn=5)
    s.pool = object()  # stands in for an unpicklable pool
    clone = pickle.loads(pickle.dumps(s))
    assert clone.pool is None and clone._graphs is None
    assert clone.backend.iteration == s.backend.iteration == 20
    assert clone.timing.segments == 0  # the timer is rebuilt
    s.run_mcmc(None, 10)
    clone.run_mcmc(None, 10)
    assert clone.backend.iteration == 30
    for getter in ("get_log_like", "get_betas", "get_log_prior"):
        np.testing.assert_array_equal(getattr(s, getter)(),
                                      getattr(clone, getter)())
    np.testing.assert_array_equal(s.get_chain()["model_0"],
                                  clone.get_chain()["model_0"])
    assert int(s.temperature_control.time) == int(
        clone.temperature_control.time)


def test_segment_timer_and_trace_profile(tmp_path):
    """``sampler.timing`` records ``(nsteps, seconds)`` per segment, with
    ``eryn_tpu``'s summary keys; ``trace_profile`` writes a Chrome trace."""
    s, pr = _sampler()
    with utils.trace_profile(tmp_path / "trace") as prof:
        s.run_mcmc(pr.rvs(size=(3, 16), generator=torch.Generator()
                          .manual_seed(1)), 12, burn=4, thin_by=2)
    durations = s.timing.durations
    assert [n for n, _ in durations] == [4, 24]
    assert all(t > 0 for _, t in durations)
    summary = s.timing.summary()
    assert set(summary) == set(jax_utils.SegmentTimer().summary())
    assert summary["total_steps"] == 28 and summary["segments"] == 2
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert trace["traceEvents"]
    assert prof.key_averages()


def test_walkers_independent_matches_eryn_tpu():
    """``tests/test_priors_units.py:130-143``."""
    rng = np.random.default_rng(0)
    good = rng.standard_normal((32, 4))
    bad = np.tile(rng.standard_normal((1, 4)), (32, 1))
    bad[:, 1] = 2 * bad[:, 0]
    nan = good.copy()
    nan[3, 2] = np.nan
    collinear = good.copy()
    collinear[:, 3] = collinear[:, 0] * 3.0
    for x in (good, bad, nan, collinear, good.reshape(32, 2, 2)):
        assert et.walkers_independent(x) == eryn_tpu.walkers_independent(x)
    assert et.walkers_independent(good) and not et.walkers_independent(nan)


def test_logsumexp_and_test_backends_match_eryn_tpu():
    """``tests/test_utils.py:336-347``, and ``utils.logsumexp``."""
    x = np.random.default_rng(1).standard_normal((5, 7)) * 30
    for kw in ({}, {"axis": 0}, {"axis": -1, "keepdims": True},
               {"b": np.linspace(0.5, 2.0, 7)}):
        np.testing.assert_array_equal(utils.logsumexp(x, **kw),
                                      jax_utils.logsumexp(x, **kw))
    ours = backends.get_test_backends()
    theirs = jax_backends.get_test_backends()
    assert [b.__name__ for b in ours] == [b.__name__ for b in theirs]
    assert ours[0] is et.Backend and len(ours) >= 2  # h5py is installed here
    with ours[1]() as backend:  # the temporary file's context
        assert isinstance(backend, et.HDFBackend)


def test_dr_max_iter_is_taken():
    """``dr_max_iter`` (``eryn_tpu/ensemble.py:767``,
    ``eryn_tpu/moves/rj.py:90``): taken by the sampler and the RJ moves."""
    s, _ = _sampler(dr_max_iter=3)
    assert s.dr_max_iter == 3
    from eryn_tpu.moves import DistributionGenerateRJ as JaxRJ
    from eryn_tpu_torch.moves import DistributionGenerateRJ

    pr = {"model_0": et.ProbDistContainer({0: et.uniform_dist(0, 1)})}
    jpr = {"model_0": eryn_tpu.ProbDistContainer({0: eryn_tpu.uniform_dist(0, 1)})}
    assert (DistributionGenerateRJ(pr, dr_max_iter=7).dr_max_iter
            == JaxRJ(jpr, dr_max_iter=7).dr_max_iter == 7)
    assert DistributionGenerateRJ(pr).dr_max_iter == 5


@pytest.mark.parametrize("df", [3, 4.5, 1000])
def test_aimh_chisquare_against_scipy(df):
    """The chi-square of the Student-t proposal: ``-2 sum log U (+ Z^2)``
    for an integer df up to 512, a Marsaglia-Tsang gamma otherwise; both
    distributed as ``chi2(df)``."""
    move = AIMHMove(df=df)
    assert move.gamma == (df != 3)
    like = torch.zeros((40, 500), dtype=torch.float64)
    z, uu, zz = move.draw_aimh(torch.Generator().manual_seed(3), 40, 500, 2,
                               like)
    draws = move._chisquare(uu, zz, like).numpy().ravel()
    assert np.isfinite(draws).all()
    assert ss.kstest(draws, ss.chi2(df).cdf).pvalue > 1e-3


def test_aimh_gamma_miss_raises_at_the_segment_end():
    """A gamma draw whose rounds all reject is NaN, which no proposal
    accepts, and counts on the device; the sampler raises at the end of the
    segment.  A sampler with ``df=4.5`` runs."""
    move = AIMHMove(df=4.5)
    move.gamma_misses = torch.zeros((), dtype=torch.int64)
    rounds = aimh_mod.GAMMA_ROUNDS
    # x = 0 gives v = 1, and log u = 0 is not below 0: every round rejects
    draws = torch.stack([torch.zeros((rounds, 2, 3)), torch.ones((rounds, 2, 3))])
    draws[1, 2, 0, 0] = 0.5  # one draw accepts in its third round
    out = move._chisquare(draws, None, torch.zeros((2, 3)))
    assert torch.isnan(out).sum() == 5 and int(move.gamma_misses) == 5
    with pytest.raises(RuntimeError, match="rounds"):
        move.check_segment()

    pr = et.ProbDistContainer({i: et.uniform_dist(-5, 5) for i in range(2)})
    s = et.EnsembleSampler(16, 2, unit_log_like, pr, moves=AIMHMove(df=4.5),
                           seed=2, device="cpu")
    s.run_mcmc(pr.rvs(size=(16,), generator=torch.Generator().manual_seed(2)),
               20)
    assert int(s.moves[0].gamma_misses) == 0
    assert 0 < s.acceptance_fraction.mean() <= 1
