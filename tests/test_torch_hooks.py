"""The hooks of the port's ``run_mcmc`` and its ``sample()`` generator, on
the CPU, against ``eryn_tpu``'s.

* ``update_fn`` and ``stopping_fn`` fire at the iterations ``eryn_tpu``'s
  fire at (recording hooks on both samplers, a grid of step counts,
  thinning, segment sizes and intervals, a stop that ends the run, and the
  update after the burn);
* ``sample()`` yields every ``thin_by`` steps with ``eryn_tpu``'s update
  cadence, and its ``finally`` saves the checkpoint of an abandoned
  generator;
* the stopping criteria decide as ``eryn_tpu``'s on backends filled with
  one numpy chain, and ``AdjustStretchProposalScale`` changes ``a`` by the
  same factors on equal counters (all exact: the same float64 arithmetic);
* the pipelined ``run_mcmc`` (segment k written while k+1 runs) equals the
  unpipelined path digit for digit, and each segment's checkpoint is the
  state as of its last step;
* ``progress=True`` with and without ``tqdm``; ``tune=True``; the public
  ``compute_log_prior`` and ``compute_log_like``.

Sizes: 1-3 temperatures x 8-16 walkers x 2-3-D, up to 40 steps.
"""

import logging
import types

import numpy as np
import pytest
import torch

import eryn_tpu_torch as et
from eryn_tpu_torch import Backend, DeviceBackend, HDFBackend
from eryn_tpu_torch.moves import StretchMove
from eryn_tpu_torch.utils import (
    AdjustStretchProposalScale,
    AutoCorrelationStop,
    SearchConvergeStopping,
)

torch.set_num_threads(1)

NW, NDIM = 8, 2


class _Recorder:
    """A hook that records the iterations it fires at; as a stopping
    function it returns True at its ``stop_at``-th call."""

    def __init__(self, stop_at=None):
        self.calls, self.stop_at = [], stop_at

    def __call__(self, i, state, sampler):
        self.calls.append(int(i))
        return len(self.calls) == self.stop_at


def _port_sampler(ntemps=1, seed=2, moves=None, nw=NW, **kw):
    pr = et.ProbDistContainer({i: et.uniform_dist(-5.0, 5.0) for i in range(NDIM)})
    s = et.EnsembleSampler(
        nw, NDIM, lambda x: -0.5 * torch.sum(x * x), pr, moves=moves,
        tempering_kwargs=dict(ntemps=ntemps) if ntemps > 1 else {},
        seed=seed, device="cpu", **kw)
    return s, pr.rvs(size=(ntemps, nw), generator=torch.Generator().manual_seed(1))


def _jax_sampler(**kw):
    import eryn_tpu
    import jax.numpy as jnp

    pr = eryn_tpu.ProbDistContainer(
        {i: eryn_tpu.uniform_dist(-5.0, 5.0) for i in range(NDIM)})
    s = eryn_tpu.EnsembleSampler(NW, NDIM, lambda x: -0.5 * jnp.sum(x * x),
                                 pr, seed=2, **kw)
    return s, np.random.default_rng(1).uniform(-3, 3, (1, NW, NDIM))


# nsteps, thin_by, segment_size, update_iterations, stopping_iterations,
# the stopping call that returns True, burn with post_burn_update
CADENCES = [
    (30, 1, None, 10, 15, None, 0),
    (24, 2, None, 6, 4, None, 0),
    (25, 1, 7, 10, 5, None, 0),
    (20, 3, 4, 5, -1, None, 4),
    (18, 1, None, -1, 6, None, 0),
    (20, 1, 8, 3, 7, 2, 0),
]


@pytest.mark.parametrize("case", CADENCES, ids=[str(c) for c in CADENCES])
def test_hooks_fire_where_eryn_tpus_fire(case):
    nsteps, thin_by, seg, upd, stp, stop_at, burn = case
    calls = {}
    for name, make in (("port", _port_sampler), ("jax", _jax_sampler)):
        update, stop = _Recorder(), _Recorder(stop_at)
        s, start = make(update_fn=update, update_iterations=upd,
                        stopping_fn=stop, stopping_iterations=stp)
        s.run_mcmc(start, nsteps, thin_by=thin_by, segment_size=seg,
                   burn=burn or None, post_burn_update=bool(burn))
        calls[name] = (update.calls, stop.calls, s.backend.iteration)
    assert calls["port"] == calls["jax"]
    assert calls["port"][0] or calls["port"][1]


def test_sample_yields_every_thin_by_steps_with_eryn_tpus_updates():
    seen = {}
    for name, make in (("port", _port_sampler), ("jax", _jax_sampler)):
        update = _Recorder()
        s, start = make(update_fn=update, update_iterations=3)
        n = sum(1 for _ in s.sample(start, iterations=6, thin_by=2))
        seen[name] = (n, s.backend.iteration, update.calls)
    assert seen["port"] == seen["jax"] == (6, 6, [2, 3, 5, 6])


class CountingStretch(StretchMove):
    """A stretch move whose kernel state counts its proposals."""

    def init_kernel_state(self, state):
        return {"n": torch.zeros((), dtype=torch.int64)}

    def propose_kernel(self, generator, state, time, ctx, kernel_state=()):
        state, acc, swaps, time, _ = super().propose_kernel(
            generator, state, time, ctx, ())
        return state, acc, swaps, time, {"n": kernel_state["n"] + 1}


def test_abandoned_sample_generator_saves_the_checkpoint(tmp_path):
    fn = str(tmp_path / "gen.h5")
    s, start = _port_sampler(ntemps=3, moves=[CountingStretch()], nw=16,
                             backend=fn)
    for i, _ in enumerate(s.sample(start, iterations=10, thin_by=2)):
        if i == 3:
            break  # the generator is dropped here and its finally runs
    stored = HDFBackend(fn)
    assert stored.iteration == 4
    keys, leaves = stored.get_kernel_states()
    assert keys == ["CountingStretch_0"] and int(leaves[0][0]) == 8
    assert stored.get_sampler_clock() == int(s.temperature_control.time) == 8


# ----------------------------------------------------------------------
# the criteria and the scale update against eryn_tpu's
# ----------------------------------------------------------------------
def _filled_backends(nsteps, chunk):
    """A port and an eryn_tpu ``Backend``, grown chunk by chunk with one
    AR(1) chain (tau near 3) whose log-likelihood plateaus; yields them
    after each chunk."""
    import eryn_tpu

    rng = np.random.default_rng(7)
    x = np.zeros((nsteps, 1, NW, 1, NDIM))
    for t in range(1, nsteps):
        x[t] = 0.5 * x[t - 1] + rng.normal(size=x[t].shape)
    ll = -0.5 * (x**2).sum(axis=(-1, -2)) + np.minimum(
        np.arange(nsteps), 300)[:, None, None] * 0.05
    ours, theirs = Backend(), eryn_tpu.Backend()
    for b in (ours, theirs):
        b.reset(NW, NDIM)
    for k in range(0, nsteps, chunk):
        sl = slice(k, k + chunk)
        for b in (ours, theirs):
            b.grow(chunk)
            b.save_segment({"model_0": x[sl]},
                           {"model_0": np.ones(x[sl].shape[:-1], bool)},
                           ll[sl], np.zeros_like(ll[sl]), np.ones((chunk, 1)))
        yield k + chunk, ours, theirs


@pytest.mark.parametrize("criterion", ["autocorrelation", "search"])
def test_stopping_criteria_decide_as_eryn_tpus(criterion):
    from eryn_tpu.utils import stopping as jax_stopping

    if criterion == "autocorrelation":
        kw = dict(autocorr_multiplier=20, rel_tol=0.1)
        ours, theirs = (AutoCorrelationStop(**kw),
                        jax_stopping.AutoCorrelationStop(**kw))
    else:
        kw = dict(n_iters=3, diff=0.5, start_iteration=50)
        ours, theirs = (SearchConvergeStopping(**kw),
                        jax_stopping.SearchConvergeStopping(**kw))
    decisions = []
    for it, a, b in _filled_backends(1200, 100):
        da = ours(it, None, types.SimpleNamespace(
            backend=a, get_log_like=a.get_log_like))
        db = theirs(it, None, types.SimpleNamespace(
            backend=b, get_log_like=b.get_log_like))
        decisions.append((da, db))
    assert [a for a, _ in decisions] == [b for _, b in decisions]
    assert any(a for a, _ in decisions) and not all(a for a, _ in decisions)


class _ScaleTarget:
    """What ``AdjustStretchProposalScale`` reads and writes on a sampler."""

    def __init__(self):
        self.backend = types.SimpleNamespace(accepted=np.zeros((1, NW)),
                                             iteration=0)
        self.moves = [types.SimpleNamespace(a=2.0)]
        self._step_cache = {"compiled": None}
        self.drops = 0

    def drop_step_graphs(self):
        self.drops += 1


def test_stretch_scale_update_matches_eryn_tpus():
    from eryn_tpu.utils.updates import AdjustStretchProposalScale as JaxAdjust

    ours, theirs = AdjustStretchProposalScale(), JaxAdjust()
    a, b = _ScaleTarget(), _ScaleTarget()
    scales, changes = [], 0
    for rate in (0.5, 0.4, 0.1, 0.0, 0.22, 0.3, 0.05):
        for target in (a, b):
            target.backend.iteration += 100
            target.backend.accepted = target.backend.accepted + 100 * rate
        before = a.moves[0].a
        ours(a.backend.iteration, None, a)
        theirs(b.backend.iteration, None, b)
        changes += a.moves[0].a != before
        scales.append((a.moves[0].a, b.moves[0].a))
    assert [x for x, _ in scales] == [y for _, y in scales]
    assert a.drops == changes > 0


# ----------------------------------------------------------------------
# the pipelined flush
# ----------------------------------------------------------------------
def _record(s):
    b = s.backend
    out = dict(chain=s.get_chain()["model_0"], log_like=s.get_log_like(),
               log_prior=s.get_log_prior(), betas=s.get_betas(),
               accepted=b.accepted, swaps=b.swaps_accepted,
               clock=int(s.temperature_control.time),
               generator=s._gen.get_state().numpy(),
               host_generator=s._host_gen.get_state().numpy())
    return {k: np.asarray(v, dtype=np.float64) for k, v in out.items()}


def _two_moves():
    return [(StretchMove(), 0.5), (StretchMove(a=1.5), 0.5)]


def test_pipelined_run_equals_the_unpipelined_path():
    """Into ``Backend()`` each segment is written while the next runs;
    with a hook at every boundary each is written at once; a
    ``DeviceBackend`` keeps the segments where they are: equal runs."""
    runs = {}
    for name in ("pipelined", "hook every segment", "device backend"):
        kw = {}
        if name == "hook every segment":
            kw = dict(update_fn=lambda *a: None, update_iterations=5)
        if name == "device backend":
            kw = dict(backend=DeviceBackend())
        s, start = _port_sampler(ntemps=3, moves=_two_moves(), nw=16, **kw)
        s.run_mcmc(start, 40, segment_size=5)
        runs[name] = _record(s)
    for name in ("hook every segment", "device backend"):
        for key in runs["pipelined"]:
            np.testing.assert_array_equal(runs[name][key],
                                          runs["pipelined"][key],
                                          err_msg=f"{name}: {key}")


class _RecordingBackend(Backend):
    """Records the checkpoint each segment hands over."""

    def save_segment(self, *args, **kwargs):
        super().save_segment(*args, **kwargs)
        self.seen = getattr(self, "seen", []) + [(
            self.iteration, np.asarray(self.random_state).copy(),
            np.asarray(self.host_random_state).copy(),
            self.get_sampler_clock())]


def test_each_segments_checkpoint_is_as_of_its_last_step():
    """The generators' states and the clock a pipelined run hands over with
    segment k are those after segment k, as runs of one segment each
    leave them."""
    s, start = _port_sampler(ntemps=3, moves=_two_moves(), nw=16,
                             backend=_RecordingBackend())
    s.run_mcmc(start, 20, segment_size=5)
    step, start = _port_sampler(ntemps=3, moves=_two_moves(), nw=16)
    expected = []
    for k in range(4):
        step.run_mcmc(start if k == 0 else None, 5)
        expected.append((5 * (k + 1), step._gen.get_state().numpy(),
                         step._host_gen.get_state().numpy(),
                         int(step.temperature_control.time)))
    assert len(s.backend.seen) == 4
    for got, want in zip(s.backend.seen, expected):
        assert got[0] == want[0] and got[3] == want[3]
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])


# ----------------------------------------------------------------------
# progress, tune, the public evaluations
# ----------------------------------------------------------------------
def test_progress_bar_with_and_without_tqdm(monkeypatch, capsys, caplog):
    import eryn_tpu_torch.pbar as pbar

    s, start = _port_sampler()
    s.run_mcmc(start, 12, segment_size=4, progress=True)
    assert "12/12" in capsys.readouterr().err
    monkeypatch.setattr(pbar, "tqdm", None)
    with caplog.at_level(logging.WARNING, logger=pbar.__name__):
        s.run_mcmc(None, 4, progress=True)
        for _ in s.sample(None, iterations=2, progress=True):
            pass
    assert "install the tqdm" in caplog.text
    assert s.backend.iteration == 18


def test_tune_calls_the_moves_that_override_it():
    """``tune=True`` calls ``tune(state, accepted)`` after every burn
    segment and every segment, as ``eryn_tpu`` does; a move without its
    own ``tune`` is not called."""
    import eryn_tpu.moves as jax_moves

    counts = {}
    for name in ("port", "jax"):
        base = StretchMove if name == "port" else jax_moves.StretchMove
        seen = []

        class Tuned(base):
            def tune(self, state, accepted):
                seen.append(np.asarray(accepted).shape)

        make = _port_sampler if name == "port" else _jax_sampler
        s, start = make(moves=[Tuned(), base()])
        s.run_mcmc(start, 20, burn=10, segment_size=5, tune=True)
        counts[name] = seen
    assert counts["port"] == counts["jax"]
    assert len(counts["port"]) == 6 and counts["port"][0] == (1, NW)


def test_public_log_prior_and_log_like_match_eryn_tpu():
    import eryn_tpu
    import jax.numpy as jnp

    x = np.random.default_rng(2).uniform(-6, 6, (3, NW, NDIM))
    s, _ = _port_sampler()
    pr = eryn_tpu.ProbDistContainer(
        {i: eryn_tpu.uniform_dist(-5.0, 5.0) for i in range(NDIM)})
    j = eryn_tpu.EnsembleSampler(NW, NDIM, lambda v: -0.5 * jnp.sum(v * v),
                                 pr, seed=0)
    lp = s.compute_log_prior(x)
    ll, blobs = s.compute_log_like(x, logp=lp)
    jlp = j.compute_log_prior(x)
    jll, _ = j.compute_log_like(x, logp=jlp)
    assert blobs is None and lp.shape == (3, NW)
    np.testing.assert_array_equal(lp.numpy(), jlp)
    np.testing.assert_allclose(ll.numpy(), jll, rtol=1e-6)
    assert np.isinf(ll.numpy()[~np.isfinite(jlp)]).all()
