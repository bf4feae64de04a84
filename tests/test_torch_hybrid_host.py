"""Hybrid scheduling in the port: a host move among native ones.

The contracts of ``tests/test_hybrid_host.py``: one move written for Eryn's
host protocol beside native ones runs eagerly in its slots of the
host-drawn schedule, the native moves keep their path, the posterior and
the ladder hold, and every slot's proposal lands on its move.  Then what the
port adds: the CUDA-graph path (each replay run as its captured body would
run, as ``tests/test_torch_sampler.py`` drives it on the CPU) equals the
eager loop digit for digit, with one replay per native slot and one host
proposal per host slot; and a hybrid run into an ``HDFBackend`` stopped at
half and resumed from the file (the host ``RandomState`` restored) equals
the run uninterrupted, digit for digit.
"""

import warnings

import numpy as np
import pytest
import torch

import eryn_tpu_torch as et
from eryn_tpu_torch.moves import MHMove, StretchMove

NDIM = 3
NWALKERS = 32


def log_like(x):
    return -0.5 * torch.sum(x * x)


def _priors():
    return et.ProbDistContainer({i: et.uniform_dist(-5, 5)
                                 for i in range(NDIM)})


class CustomHostMH(MHMove):
    """A move written against Eryn's host protocol."""

    calls = 0

    def get_proposal(self, branches_coords, random, branches_inds=None,
                     **kwargs):
        type(self).calls += 1
        q = {n: np.asarray(c) + 0.5 * random.randn(*np.shape(c))
             for n, c in branches_coords.items()}
        return q, np.zeros(next(iter(q.values())).shape[:2])


def _sampler(host_weight=0.1, ntemps=1, seed=0, **kw):
    moves = [(StretchMove(), 1.0 - host_weight), (CustomHostMH(), host_weight)]
    if ntemps > 1:
        kw["tempering_kwargs"] = dict(ntemps=ntemps)
    with pytest.warns(UserWarning, match="HYBRID"):
        return et.EnsembleSampler(NWALKERS, NDIM, log_like, _priors(),
                                  moves=moves, seed=seed, device="cpu", **kw)


def _start(ntemps=1, seed=0):
    return _priors().rvs(size=(ntemps, NWALKERS),
                         generator=torch.Generator().manual_seed(seed))


def test_hybrid_engages_and_recovers_posterior():
    CustomHostMH.calls = 0
    s = _sampler(host_weight=0.1)
    assert s._host_moves == [False, True]
    s.run_mcmc(_start(), 400, burn=200)
    assert CustomHostMH.calls > 0 and s.moves[0].num_proposals > 0
    ch = s.get_chain()["model_0"][100:]
    assert abs(ch.mean()) < 0.2
    assert abs(ch.std() - 1.0) < 0.2
    assert 0.05 < s.acceptance_fraction.mean() < 0.95


def test_hybrid_counter_bookkeeping_exact():
    """Every slot's proposal lands on its move, the totals cover every
    slot drawn, and the per-move fractions are stored."""
    s = _sampler(host_weight=0.2, seed=3)
    nsteps = 150
    s.run_mcmc(_start(), nsteps)
    stretch, custom = s.moves
    assert stretch.num_proposals + custom.num_proposals == (
        nsteps * s.num_repeats_in_model)
    assert stretch.num_proposals > 60 and custom.num_proposals > 5
    fr = s.backend.moves_accepted_fraction
    assert set(fr) == {"StretchMove_0", "CustomHostMH_0"}
    for v in fr.values():
        v = np.asarray(v)
        assert np.all(v >= 0) and np.all(v <= 1)
    # the move's own counts of its host proposals agree with the sampler's
    np.testing.assert_allclose(np.asarray(custom.accepted).sum(),
                               fr["CustomHostMH_0"].sum()
                               * custom.num_proposals)


def test_hybrid_tempered_matches_native_statistics():
    s = _sampler(host_weight=0.08, ntemps=4, seed=5)
    s.run_mcmc(_start(4), 500, burn=200)
    ch = s.get_chain()["model_0"][200:, 0]
    assert abs(ch.mean()) < 0.15
    assert abs(ch.std() - 1.0) < 0.15
    ll = s.get_log_like()[200:]
    assert ll[:, 0].mean() > ll[:, -1].mean()
    betas = s.get_betas()
    assert betas.shape[0] == 500
    assert not np.allclose(betas[0], betas[-1])
    assert np.all(np.asarray(s.swap_acceptance_fraction) >= 0)


def test_mixed_schedule_native_after_legacy_in_host_step():
    """Under thin_by=2 a native move's step follows a host step's result
    directly."""
    s = _sampler(host_weight=0.5, ntemps=4, seed=9)
    s.run_mcmc(_start(4), 40, thin_by=2)
    assert s.get_chain()["model_0"].shape[0] == 40
    assert np.all(np.isfinite(s.get_log_like()))


def test_a_host_move_inside_a_combination_is_refused():
    """A composite runs its children's kernels, which would skip a host
    move's hooks: the sampler refuses it rather than run it otherwise."""
    with pytest.raises(ValueError, match="composite move"):
        et.EnsembleSampler(
            NWALKERS, NDIM, log_like, _priors(), device="cpu",
            moves=et.moves.CombineMove([StretchMove(), CustomHostMH()]))


def test_all_host_schedule_stays_host_mode():
    with pytest.warns(UserWarning, match="step-by-step on the host"):
        s = et.EnsembleSampler(NWALKERS, NDIM, log_like, _priors(),
                               moves=CustomHostMH(), seed=0, device="cpu")
    assert all(s._host_moves)
    s.run_mcmc(_start(), 20)
    assert s.moves[0].num_proposals == 20


# ----------------------------------------------------------------------
# the graph path and the resume
# ----------------------------------------------------------------------
class _EagerReplay:
    """A "graph" whose replay runs the body it would have captured."""

    def __init__(self, graphs, key, ctx):
        self.replay = lambda: graphs._body(key, ctx)


def _record(s):
    return {
        "chain": s.get_chain()["model_0"], "ll": s.get_log_like(),
        "betas": s.get_betas(), "accepted": s.backend.accepted,
        "swaps": s.backend.swaps_accepted,
        "fractions": dict(s.backend.moves_accepted_fraction),
        "time": int(s.temperature_control.time),
    }


def _assert_same(a, b):
    for key in a:
        if key == "fractions":
            for k in a[key]:
                np.testing.assert_array_equal(a[key][k], b[key][k])
        else:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_hybrid_graph_path_equals_the_eager_loop(monkeypatch):
    """The graph path with each replay run as its captured body, against
    the eager loop: the same run digit for digit, one replay per native
    slot (but each graph's first, eager), one host proposal per host
    slot."""
    from eryn_tpu_torch.ensemble import EnsembleSampler
    from eryn_tpu_torch.graphs import StepGraphs

    def run(graphed):
        s = _sampler(host_weight=0.25, ntemps=3, seed=2,
                     dtype=torch.float64, num_repeats_in_model=2)
        if graphed:
            monkeypatch.setattr(EnsembleSampler, "_graphed", True)
            monkeypatch.setattr(
                StepGraphs, "_capture",
                lambda self, key, ctx: (_EagerReplay(self, key, ctx), ()))
        s.run_mcmc(_start(3), 30, burn=10)
        s.run_mcmc(None, 10, thin_by=2)
        monkeypatch.undo()
        return s

    eager, graphed = run(False), run(True)
    _assert_same(_record(eager), _record(graphed))
    native, host = graphed.moves
    assert host.num_proposals > 5
    warm = len(graphed._graphs.warm)
    assert all(j == 0 for j, _ in graphed._graphs.warm)
    assert graphed.graph_replays == native.num_proposals - warm
    assert eager.graph_replays == 0


def test_hybrid_resumes_from_a_file_digit_for_digit(tmp_path):
    """A hybrid tempered run into an HDFBackend, stopped after 40 of 80
    stored steps and continued by a new sampler on the file, equals the
    run of 80 steps uninterrupted: the host moves' RandomState, the torch
    generators and the clock come back from the checkpoint."""
    def build(path, seed):
        return _sampler(host_weight=0.3, ntemps=3, seed=seed,
                        dtype=torch.float64, backend=str(path))

    whole = build(tmp_path / "whole.h5", 4)
    whole.run_mcmc(_start(3), 80, segment_size=20)

    first = build(tmp_path / "half.h5", 4)
    first.run_mcmc(_start(3), 40, segment_size=20)
    del first
    second = build(tmp_path / "half.h5", 99)  # the seed is not used
    assert second.backend.numpy_random_state is not None
    second.run_mcmc(None, 40, segment_size=20)
    a, b = _record(whole), _record(second)
    a.pop("fractions")  # the resumed moves count their proposals anew
    b.pop("fractions")
    _assert_same(a, b)
