"""Deterministic even-odd swaps and the Syed schedule in the port, against
eryn_tpu on the CPU.

* The DEO phase given eryn_tpu's own acceptance draws: decisions, swapped
  state, accepted and proposed counts identical, at three clock values (both
  parities and a wrap).
* ``syed_schedule_kernel`` and ``communication_barrier`` in float64 within
  1e-12 of eryn_tpu's, with and without the ``proposed`` mask, on flat
  stretches (ratios of 1, the 1e-4 floor) and at both ends of the ladder.
* ``temper_kernel`` under DEO: the doubled ratios and the clock that ticks on
  a phase that does not adapt, against eryn_tpu's with the same draws.
* A DEO + Syed run on the CPU meets ``tests/test_syed_schedule.py``'s gates
  (cold mean within 0.15, standard deviation within 0.1 of 1, a descending
  and adapted ladder); a stopped DEO run resumed continues digit for digit;
  the graph path's static buffers over both parities equal the eager loop.

Sizes: 4-6 temperatures x 8-32 walkers, 3-D.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import eryn_tpu
import eryn_tpu_torch as et
from eryn_tpu_torch.interop import state_from_numpy, state_to_numpy
from eryn_tpu_torch.moves import TemperatureControl, make_ladder

torch.set_num_threads(1)

NDIM = 3


def _jax_raccept(key, nt, nw, dtype):
    # eryn_tpu's _swap_kernel_deo draws its raccept from its key this way
    return np.array(jnp.log(jax.random.uniform(key, (nt - 1, nw),
                                                 dtype=dtype)))


def _swap_inputs(nt, nw, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    tree = {"coords": {"m": rng.standard_normal((nt, nw, 2, NDIM)).astype(dtype)},
            "inds": {"m": rng.random((nt, nw, 2)) < 0.5},
            "log_prior": rng.standard_normal((nt, nw)).astype(dtype)}
    logl = (rng.standard_normal((nt, nw)) * 3.0).astype(dtype)
    betas = make_ladder(NDIM, nt).astype(dtype)
    return tree, logl, betas


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree))


def _assert_tree_equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_tree_equal(a[k], b[k])
        return
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("time", [0, 1, 2])
@pytest.mark.parametrize("nt,nw", [(4, 8), (5, 33), (6, 100)])
def test_deo_decisions_match_jax_given_its_draws(time, nt, nw):
    tree, logl, betas = _swap_inputs(nt, nw, seed=time + nt)
    key = jax.random.PRNGKey(time)
    jtc = eryn_tpu.moves.TemperatureControl(NDIM, nw, ntemps=nt,
                                            swap_scheme="deo")
    j_tree, j_logl, j_acc, j_prop = jtc._swap_kernel_deo(
        key, jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(logl),
        jnp.asarray(betas), jnp.asarray(time, jnp.int32))
    raccept = torch.from_numpy(_jax_raccept(key, nt, nw, jnp.float32))
    t_tree, t_logl, t_acc, t_prop = TemperatureControl._swap_kernel_deo(
        _to_torch(tree), torch.from_numpy(logl), torch.from_numpy(betas),
        torch.tensor(time), raccept)
    _assert_tree_equal(t_tree, j_tree)
    np.testing.assert_array_equal(t_logl.numpy(), np.asarray(j_logl))
    np.testing.assert_array_equal(t_acc.numpy(), np.asarray(j_acc))
    np.testing.assert_array_equal(t_prop.numpy(), np.asarray(j_prop))
    # only the boundaries of the clock's parity were attempted, and some
    # swapped
    attempted = np.arange(nt - 1) % 2 == time % 2
    assert np.array_equal(t_prop.numpy() > 0, attempted)
    assert t_acc.numpy()[attempted].sum() > 0
    assert not t_acc.numpy()[~attempted].any()


def _syed_cases():
    rng = np.random.default_rng(3)
    flat = np.array([1.0, 1.0, 0.3, 1.0, 0.0])  # flat stretches: the floor
    return [rng.random(5), flat, np.ones(5), np.zeros(5),
            np.array([1.2, -0.1, 0.5, 0.5, 0.5])]  # clipped at both ends


@pytest.mark.parametrize("case", range(5))
@pytest.mark.parametrize("mask", [None, "even", "odd", "none"])
def test_syed_schedule_matches_jax_in_float64(case, mask):
    ratios = _syed_cases()[case]
    nt = 6
    betas = make_ladder(NDIM, nt, Tmax=np.inf) if case == 4 else make_ladder(
        NDIM, nt)
    proposed = None
    if mask is not None:
        attempted = {"even": np.arange(nt - 1) % 2 == 0,
                     "odd": np.arange(nt - 1) % 2 == 1,
                     "none": np.zeros(nt - 1, bool)}[mask]
        proposed = np.where(attempted, 32.0, 0.0)
    jtc = eryn_tpu.moves.TemperatureControl(NDIM, 32, ntemps=nt,
                                            adaptation_scheme="syed")
    ttc = TemperatureControl(NDIM, 32, ntemps=nt, adaptation_scheme="syed")
    for time in (0, 3, 250):
        with jax.enable_x64(True):
            want = np.asarray(jtc.syed_schedule_kernel(
                jnp.asarray(float(time)), jnp.asarray(betas),
                jnp.asarray(ratios),
                None if proposed is None else jnp.asarray(proposed)))
        got = ttc.syed_schedule_kernel(
            torch.tensor(time), torch.from_numpy(betas),
            torch.from_numpy(ratios),
            None if proposed is None else torch.from_numpy(proposed)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
        # the ends stay, the ladder keeps descending
        assert got[0] == betas[0] and got[-1] == betas[-1]
        assert np.all(np.diff(got) < 0)
    lam_j, tot_j = jtc.communication_barrier(ratios=ratios)
    lam_t, tot_t = ttc.communication_barrier(ratios=ratios)
    np.testing.assert_allclose(lam_t, lam_j, rtol=0, atol=1e-12)
    assert abs(tot_t - tot_j) <= 1e-12


def test_communication_barrier_defaults_to_the_counters():
    jtc = eryn_tpu.moves.TemperatureControl(NDIM, 10, ntemps=4)
    ttc = TemperatureControl(NDIM, 10, ntemps=4)
    acc = np.array([4.0, 7.0, 0.0])
    jtc.swaps_accepted = acc
    ttc.swaps_accepted = torch.from_numpy(acc)  # as a run leaves it
    np.testing.assert_allclose(ttc.communication_barrier()[0],
                               jtc.communication_barrier()[0], atol=1e-12)


@pytest.mark.parametrize("scheme", ["syed", "vousden"])
@pytest.mark.parametrize("adapt", [True, False])
def test_temper_kernel_under_deo_matches_jax(scheme, adapt):
    """Given eryn_tpu's draws, one phase of ``temper_kernel``: the swapped
    state, the doubled swap counts, the ladder (1e-6 relative, float32) and
    the clock, which ticks whether or not the phase adapts."""
    nt, nw = 5, 16
    tree, logl, betas = _swap_inputs(nt, nw, seed=9)
    jstate = eryn_tpu.State(tree["coords"], inds=tree["inds"], log_like=logl,
                            log_prior=tree["log_prior"], betas=betas)
    tstate = state_from_numpy(state_to_numpy(jstate), device="cpu")
    kw = dict(ntemps=nt, swap_scheme="deo", adaptation_scheme=scheme)
    jtc = eryn_tpu.moves.TemperatureControl(NDIM, nw, **kw)
    ttc = TemperatureControl(NDIM, nw, **kw)
    for time in (4, 7):
        key = jax.random.PRNGKey(time)
        ttc.draw_deo = lambda *a: torch.from_numpy(
            _jax_raccept(key, nt, nw, jnp.float32))
        j_new, j_sw, j_time = jtc.temper_kernel(
            key, jstate, jnp.asarray(time, jnp.int32), adapt=adapt)
        t_new, t_sw, t_time = ttc.temper_kernel(
            None, tstate, torch.tensor(time), adapt=adapt)
        assert int(t_time) == int(j_time) == time + 1
        np.testing.assert_array_equal(t_sw.numpy(), np.asarray(j_sw))
        # doubled on the attempted boundaries, 0 on the others
        assert np.all(t_sw.numpy()[np.arange(nt - 1) % 2 != time % 2] == 0)
        np.testing.assert_array_equal(t_new.log_like.numpy(),
                                      np.asarray(j_new.log_like))
        np.testing.assert_array_equal(
            t_new.branches["m"].coords.numpy(),
            np.asarray(j_new.branches["m"].coords))
        np.testing.assert_allclose(t_new.betas.numpy(),
                                   np.asarray(j_new.betas), rtol=1e-6)
        assert np.array_equal(t_new.betas.numpy(), betas) != adapt


def test_scheme_names_are_checked():
    with pytest.raises(ValueError, match="swap_scheme"):
        TemperatureControl(NDIM, 8, ntemps=3, swap_scheme="even-odd")
    with pytest.raises(ValueError, match="adaptation_scheme"):
        TemperatureControl(NDIM, 8, ntemps=3, adaptation_scheme="geometric")
    pr = et.ProbDistContainer({i: et.uniform_dist(-1, 1) for i in range(NDIM)})
    with pytest.raises(ValueError, match="swap_scheme"):
        et.EnsembleSampler(8, NDIM, lambda x: x.sum(), pr, device="cpu",
                           tempering_kwargs=dict(ntemps=3, swap_scheme="x"))


# ----------------------------------------------------------------------
# the sampler
# ----------------------------------------------------------------------
def _deo_sampler(ntemps=6, nw=32, seed=17, backend=None, **kw):
    priors = et.ProbDistContainer({i: et.uniform_dist(-7, 7)
                                   for i in range(NDIM)})
    s = et.EnsembleSampler(
        nw, NDIM, lambda x: -0.5 * torch.sum(x * x), priors,
        tempering_kwargs=dict(ntemps=ntemps, swap_scheme="deo",
                              adaptation_scheme="syed"),
        seed=seed, device="cpu", backend=backend, **kw)
    start = priors.rvs(size=(ntemps, nw),
                       generator=torch.Generator().manual_seed(seed))
    return s, start


def test_deo_with_syed_samples_the_cold_chain():
    """``tests/test_syed_schedule.py::test_syed_with_deo_end_to_end``'s
    configuration and gates on the port; each boundary swaps."""
    s, start = _deo_sampler()
    s.run_mcmc(start, 800, burn=300)
    chain = s.get_chain()["model_0"][:, 0].reshape(-1, NDIM)
    assert np.abs(chain.mean(axis=0)).max() < 0.15
    assert np.abs(chain.std(axis=0) - 1.0).max() < 0.1
    betas = np.asarray(s.get_betas()[-1])
    assert np.all(np.diff(betas) < 0.0)
    assert not np.allclose(betas, s.get_betas()[0])
    swaps = np.asarray(s.swap_acceptance_fraction)
    assert np.all((swaps > 0) & (swaps < 1)), swaps
    assert int(s.temperature_control.time) == 1100
    _, total = s.temperature_control.communication_barrier(ratios=swaps)
    assert 0.0 < total < 5


def _record(s):
    b = s.backend
    return dict(chain=s.get_chain()["model_0"], log_like=s.get_log_like(),
                betas=s.get_betas(), accepted=b.accepted,
                swaps=b.swaps_accepted, time=int(s.temperature_control.time),
                gen=s._gen.get_state().numpy())


def test_stopped_deo_run_resumes_digit_for_digit():
    """31 stored steps (an odd clock) by one sampler, then 20 by a fresh
    sampler (another seed) given its backend, against 51 in one run: the
    same chain, ladders, counts, clock and parity."""
    full, start = _deo_sampler(ntemps=4, nw=16, backend=et.Backend())
    full.run_mcmc(start, 51, segment_size=10)
    store = et.Backend()
    first, start = _deo_sampler(ntemps=4, nw=16, backend=store)
    first.run_mcmc(start, 31, segment_size=10)
    del first
    resumed, _ = _deo_sampler(ntemps=4, nw=16, backend=store, seed=5)
    resumed.run_mcmc(None, 20, segment_size=10)
    a, b = _record(resumed), _record(full)
    assert a["time"] == 51
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


class _EagerReplay:
    """Stands in for a captured graph on the CPU: a replay runs the body."""

    def __init__(self, graphs, key, ctx):
        self.replay = lambda: graphs._body(key, ctx)


def test_graph_path_buffers_alternate_the_parity(monkeypatch):
    """The graph path's static buffers, each replay the captured body, over
    odd and even clocks: the same run as the eager loop, and both parity
    classes swap (every boundary's swap fraction above 0)."""
    from eryn_tpu_torch.ensemble import EnsembleSampler
    from eryn_tpu_torch.graphs import StepGraphs

    def run(graphed):
        s, start = _deo_sampler(ntemps=5, nw=16)
        if graphed:
            monkeypatch.setattr(EnsembleSampler, "_graphed", True)
            monkeypatch.setattr(
                StepGraphs, "_capture",
                lambda self, key, ctx: (_EagerReplay(self, key, ctx), ()))
        s.run_mcmc(start, 13, burn=4)
        s.run_mcmc(None, 6, thin_by=2)
        monkeypatch.undo()
        return s

    eager, graphed = run(False), run(True)
    a, b = _record(eager), _record(graphed)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert a["time"] == 4 + 13 + 12
    assert graphed.graph_replays == 4 + 13 + 12 - 1
    assert np.all(np.asarray(graphed.swap_acceptance_fraction) > 0)


def test_under_rj_the_stored_swaps_are_the_even_boundaries():
    """With one in-model and one RJ move a step, the in-model phase falls on
    even clocks and the RJ phase on odd ones; only the in-model swaps are
    stored.  Both packages: the stored fractions of the odd boundaries are
    0, the even ones' positive, and the clock counts both phases."""
    import eryn_tpu.moves

    def ll_t(c, i):
        return -0.5 * torch.sum(torch.where(i[:, None], c, 0.0) ** 2)

    def ll_j(c, i):
        return -0.5 * jnp.sum(jnp.where(i[:, None], c, 0.0) ** 2)

    kw = dict(nleaves_max=3, rj_moves=True, fill_zero_leaves_val=0.0,
              tempering_kwargs=dict(ntemps=4, swap_scheme="deo",
                                    adaptation_scheme="syed"))
    rng = np.random.default_rng(0)
    coords = rng.uniform(-1, 1, (4, 16, 3, 2))
    inds = rng.random((4, 16, 3)) < 0.5
    port = et.EnsembleSampler(
        16, 2, ll_t, et.ProbDistContainer({i: et.uniform_dist(-1, 1)
                                           for i in range(2)}),
        moves=et.moves.RedBlueGroupStretchMove(live_dangerously=True),
        seed=1, device="cpu", **kw)
    ref = eryn_tpu.EnsembleSampler(
        16, 2, ll_j, eryn_tpu.ProbDistContainer(
            {i: eryn_tpu.uniform_dist(-1, 1) for i in range(2)}),
        moves=eryn_tpu.moves.RedBlueGroupStretchMove(live_dangerously=True),
        seed=1, **kw)
    for s, state in ((port, et.State(coords, inds=inds)),
                     (ref, eryn_tpu.State(coords, inds=inds))):
        s.run_mcmc(state, 40)
        swaps = np.asarray(s.swap_acceptance_fraction)
        assert np.all(swaps[0::2] > 0) and not swaps[1::2].any(), swaps
        assert int(np.asarray(s.temperature_control.time)) == 80
