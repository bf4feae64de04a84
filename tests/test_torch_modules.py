"""Module-level parity of the port with eryn_tpu on the CPU: containers,
priors, ladder, tempering helpers, diagnostics, backends and interop.

Tolerances: functions that run the same float64 NumPy arithmetic in both
packages (ladder, host IACT, segment plan) are compared exactly; float32
tensor results within 1e-6 relative; the device IACT (float64 FFT in torch
against numpy's) within 1e-10.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import eryn_tpu
import eryn_tpu_torch
from eryn_tpu.ensemble import _segment_plan as jax_segment_plan
from eryn_tpu.moves.tempering import make_ladder as jax_make_ladder
from eryn_tpu.moves.tempering import tempered_log_likelihood as jax_tempered
from eryn_tpu.utils.utility import get_integrated_act as jax_iact
from eryn_tpu_torch.ensemble import LikelihoodEvaluator, _segment_plan
from eryn_tpu_torch.interop import (
    state_from_numpy,
    state_to_numpy,
    tempering_from_numpy,
    tempering_to_numpy,
)
from eryn_tpu_torch.moves import make_ladder, mh_accept, tempered_log_likelihood
from eryn_tpu_torch.ops._checks import check_cuda_args
from eryn_tpu_torch.utils.utility import (
    get_integrated_act,
    get_integrated_act_torch,
)

torch.set_num_threads(1)


@pytest.mark.parametrize(
    "ndim,ntemps,Tmax",
    [(5, 10, None), (1, 3, None), (3, None, 50.0), (120, 6, None), (4, 5, np.inf)],
)
def test_make_ladder_matches_jax(ndim, ntemps, Tmax):
    np.testing.assert_array_equal(
        make_ladder(ndim, ntemps=ntemps, Tmax=Tmax),
        jax_make_ladder(ndim, ntemps=ntemps, Tmax=Tmax),
    )


def test_make_ladder_rejects_bad_input():
    with pytest.raises(ValueError):
        make_ladder(0, ntemps=3)
    with pytest.raises(ValueError):
        make_ladder(3)


def test_prior_logpdf_matches_jax():
    bounds = [(-5.0, 5.0), (0.0, 2.0), (-1.0, 3.0)]
    jp = eryn_tpu.ProbDistContainer(
        {i: eryn_tpu.uniform_dist(a, b) for i, (a, b) in enumerate(bounds)}
    )
    tp = eryn_tpu_torch.ProbDistContainer(
        {i: eryn_tpu_torch.uniform_dist(a, b) for i, (a, b) in enumerate(bounds)}
    )
    x = np.random.default_rng(0).uniform(-6, 6, (4, 7, 1, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tp.logpdf(torch.from_numpy(x)).numpy(),
        np.asarray(jp.logpdf(jnp.asarray(x))), rtol=1e-6,
    )


def test_prior_rvs_draws_from_the_generator():
    p = eryn_tpu_torch.ProbDistContainer(
        {"a": eryn_tpu_torch.uniform_dist(1.0, 2.0),
         "b": eryn_tpu_torch.uniform_dist(-3.0, -1.0)}
    )
    assert p.key_order == ["a", "b"] and p.ndim == 2
    x = p.rvs(size=(5, 6), generator=torch.Generator().manual_seed(3))
    y = p.rvs(size=(5, 6), generator=torch.Generator().manual_seed(3))
    assert x.shape == (5, 6, 2) and torch.equal(x, y)
    assert (x[..., 0] >= 1).all() and (x[..., 0] <= 2).all()
    assert (x[..., 1] >= -3).all() and (x[..., 1] <= -1).all()
    with pytest.raises(ValueError):
        eryn_tpu_torch.ProbDistContainer({0: eryn_tpu_torch.uniform_dist(0, 1),
                                          2: eryn_tpu_torch.uniform_dist(0, 1)})


def test_tempered_log_likelihood_guard_matches_jax():
    logl = np.array([[-1.0, -np.inf, 2.0], [-np.inf, -3.0, np.nan]], np.float32)
    betas = np.array([1.0, 0.0], np.float32)
    np.testing.assert_array_equal(
        tempered_log_likelihood(torch.from_numpy(logl), torch.from_numpy(betas)).numpy(),
        np.asarray(jax_tempered(logl, betas)),
    )


def test_mh_accept_never_accepts_nan():
    g = torch.Generator().manual_seed(0)
    logP_new = torch.tensor([[-np.inf, np.nan, 0.0]])
    logP_old = torch.tensor([[-np.inf, 0.0, -1e30]])
    acc = mh_accept(g, torch.zeros(1, 3), logP_new, logP_old)
    assert acc.tolist() == [[False, False, True]]


@pytest.mark.parametrize("nsteps,seg,taper", [
    (5000, 2048, False), (5000, 2048, True), (37, 8, False), (64, 2048, True),
    (3000, 1024, True),
])
def test_segment_plan_matches_jax(nsteps, seg, taper):
    assert _segment_plan(nsteps, seg, taper=taper) == jax_segment_plan(
        nsteps, seg, taper=taper
    )


def test_host_iact_matches_jax():
    rng = np.random.default_rng(0)
    x = np.cumsum(rng.standard_normal((300, 2, 8, 2, 3)), axis=0) * 0.1
    x += rng.standard_normal(x.shape)
    x[:, :, :, 1, 0] = np.nan  # a dead RJ leaf column
    chains = {"a": x, "b": x[..., :1]}
    ours = get_integrated_act(chains)
    theirs = jax_iact(chains)
    for name in chains:
        np.testing.assert_array_equal(ours[name], theirs[name])


def test_device_iact_matches_host():
    rng = np.random.default_rng(1)
    x = np.cumsum(rng.standard_normal((256, 1, 10, 1, 3)), axis=0) * 0.05
    x += rng.standard_normal(x.shape)
    host = get_integrated_act({"m": x})["m"]
    dev = get_integrated_act_torch(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(dev, host, rtol=1e-10)


def test_state_coerces_shapes_and_replaces():
    s = eryn_tpu_torch.State(torch.zeros(3, 5))  # (nwalkers, ndim)
    b = s.branches["model_0"]
    assert b.shape == (1, 3, 1, 5) and b.inds.dtype == torch.bool
    s = eryn_tpu_torch.State({"m": torch.zeros(2, 3, 4)}, log_like=torch.zeros(3))
    assert s.log_like.shape == (1, 3) and s.ntemps == 2 and s.nwalkers == 3
    new = s.replace(coords={"m": torch.ones(2, 3, 1, 4)}, log_like=torch.ones(2, 3))
    assert torch.equal(new.branches["m"].coords, torch.ones(2, 3, 1, 4))
    assert torch.equal(s.branches["m"].coords, torch.zeros(2, 3, 1, 4))
    with pytest.raises(TypeError):
        s.replace(nonsense=1)


def test_interop_round_trip_from_a_jax_state():
    rng = np.random.default_rng(2)
    jstate = eryn_tpu.State(
        {"m": rng.standard_normal((2, 4, 1, 3)).astype(np.float32)},
        log_like=rng.standard_normal((2, 4)).astype(np.float32),
        log_prior=np.zeros((2, 4), np.float32),
        betas=np.array([1.0, 0.5], np.float32),
    )
    d = state_to_numpy(jstate)
    tstate = state_from_numpy(d, device="cpu")
    back = state_to_numpy(tstate)
    for key in ("log_like", "log_prior", "betas"):
        np.testing.assert_array_equal(back[key], d[key])
    np.testing.assert_array_equal(back["coords"]["m"], d["coords"]["m"])
    np.testing.assert_array_equal(back["inds"]["m"], d["inds"]["m"])

    jtc = eryn_tpu.moves.TemperatureControl(3, 4, ntemps=3)
    ttc = eryn_tpu_torch.TemperatureControl(3, 4, ntemps=5)
    tempering_from_numpy(ttc, tempering_to_numpy(jtc))
    np.testing.assert_array_equal(ttc.betas, jtc.betas)
    assert ttc.ntemps == 3 and ttc.time == 0


def _ll(x):
    return -0.5 * torch.sum(x * x)


def _evaluator(fn, vectorize=False):
    return LikelihoodEvaluator(
        fn, branch_names=["m"], ndims={"m": 3}, nleaves_max={"m": 1},
        args=None, kwargs=None, vectorize=vectorize,
        fill_zero_leaves_val=-1e300, dtype=torch.float32,
    )


def test_likelihood_vmap_and_batched_modes_agree():
    x = torch.randn(2, 5, 1, 3, generator=torch.Generator().manual_seed(0))
    inds = {"m": torch.ones(2, 5, 1, dtype=torch.bool)}
    logp = torch.zeros(2, 5)
    logp[0, 1] = -np.inf  # outside the prior support: never evaluated
    a, _ = _evaluator(_ll)({"m": x}, inds, logp)
    b, _ = _evaluator(lambda x: -0.5 * (x * x).sum(-1), vectorize=True)(
        {"m": x}, inds, logp
    )
    torch.testing.assert_close(a, b)
    assert a[0, 1] == -np.inf and torch.isfinite(a[1]).all()


def test_likelihood_that_cannot_vmap_names_vectorize():
    ev = _evaluator(lambda x: torch.tensor(float(x.sum())))
    with pytest.raises(TypeError, match="vectorize=True"):
        ev.check(torch.device("cpu"))


def test_wrapper_checks_refuse_cpu_tensors():
    x = torch.zeros(2, 3)
    with pytest.raises(ValueError, match="CUDA"):
        check_cuda_args("k", x.dtype, x.device, x=(x, (2, 3)))


def _sampler(backend, nw=12, **kw):
    priors = eryn_tpu_torch.ProbDistContainer(
        {i: eryn_tpu_torch.uniform_dist(-5.0, 5.0) for i in range(2)}
    )
    return eryn_tpu_torch.EnsembleSampler(
        nw, 2, _ll, priors, tempering_kwargs=dict(ntemps=3), seed=4,
        backend=backend, device="cpu", **kw
    ), priors


def test_sampler_errors_and_default_backend():
    sampler, priors = _sampler(None)
    with pytest.raises(ValueError, match="run_mcmc has never been called"):
        sampler.run_mcmc(None, 5)
    coords = priors.rvs(size=(3, 12), generator=torch.Generator().manual_seed(0))
    sampler.run_mcmc(coords, 5)
    assert type(sampler.backend) is eryn_tpu_torch.Backend  # CPU default
    assert sampler.iteration == 5
    small, _ = _sampler(None, nw=3)
    with pytest.raises(RuntimeError, match="twice the number of dimensions"):
        small.run_mcmc(coords[:, :3], 2)


@pytest.mark.parametrize("max_device_bytes", [None, 1])
def test_device_backend_reads_like_host_backend(max_device_bytes):
    """Same seed, same chain: every getter of DeviceBackend (including after
    offloading to the host) returns what Backend returns."""
    runs = []
    for backend in (eryn_tpu_torch.Backend(),
                    eryn_tpu_torch.DeviceBackend(max_device_bytes=max_device_bytes)):
        sampler, priors = _sampler(backend)
        coords = priors.rvs(size=(3, 12), generator=torch.Generator().manual_seed(0))
        sampler.run_mcmc(coords, 150, segment_size=64, thin_by=2)
        runs.append(sampler)
    host, dev = runs
    for kw in ({}, {"thin": 3, "discard": 5}, {"temp_index": 0},
               {"slice_vals": np.array([70, 2, 130])}):
        np.testing.assert_array_equal(
            dev.get_chain(**kw)["model_0"], host.get_chain(**kw)["model_0"])
        np.testing.assert_array_equal(dev.get_log_like(**kw), host.get_log_like(**kw))
        np.testing.assert_array_equal(dev.get_betas(**kw), host.get_betas(**kw))
        np.testing.assert_array_equal(
            dev.get_inds(**kw)["model_0"], host.get_inds(**kw)["model_0"])
    np.testing.assert_array_equal(dev.get_log_prior(slice_vals=-1),
                                  host.get_log_prior(slice_vals=-1))
    np.testing.assert_array_equal(dev.acceptance_fraction, host.acceptance_fraction)
    np.testing.assert_array_equal(dev.swap_acceptance_fraction,
                                  host.swap_acceptance_fraction)
    tau = host.get_autocorr_time()["model_0"]
    assert np.all(tau > 0.5)
    np.testing.assert_allclose(dev.get_autocorr_time()["model_0"], tau,
                               rtol=1e-10)
    last_d, last_h = dev.get_last_sample(), host.get_last_sample()
    np.testing.assert_array_equal(last_d.branches["model_0"].coords,
                                  last_h.branches["model_0"].coords)
    # resuming from the stored state continues the run
    dev.run_mcmc(None, 3)
    assert dev.iteration == 153


@pytest.mark.parametrize("use_kernels", [None, True])
def test_float64_sampler_keeps_its_dtype(use_kernels):
    priors = eryn_tpu_torch.ProbDistContainer(
        {i: eryn_tpu_torch.uniform_dist(-5.0, 5.0) for i in range(2)}
    )
    sampler = eryn_tpu_torch.EnsembleSampler(
        10, 2, _ll, priors, dtype=torch.float64, seed=1, device="cpu",
        tempering_kwargs=dict(ntemps=3, use_kernels=use_kernels),
        moves=[eryn_tpu_torch.StretchMove(use_kernels=use_kernels)],
    )
    coords = priors.rvs(size=(3, 10), generator=torch.Generator().manual_seed(0))
    state = sampler.run_mcmc(coords, 30)
    assert state.branches["model_0"].coords.dtype == torch.float64
    assert state.log_like.dtype == state.betas.dtype == torch.float64
    assert sampler.get_chain()["model_0"].dtype == np.float64


@pytest.mark.parametrize("use_kernels", [None, True])
def test_two_branches_sample_their_targets(use_kernels):
    """Two branches (2-D and 1-D): the fused path concatenates them along
    the last axis, the likelihood gets per-branch dicts."""

    def ll(c, i):
        return -0.5 * (torch.sum(c["a"] ** 2) + torch.sum((c["b"] - 1.0) ** 2))

    priors = {
        "a": eryn_tpu_torch.ProbDistContainer(
            {0: eryn_tpu_torch.uniform_dist(-5, 5),
             1: eryn_tpu_torch.uniform_dist(-5, 5)}),
        "b": eryn_tpu_torch.ProbDistContainer(
            {0: eryn_tpu_torch.uniform_dist(-4, 6)}),
    }
    sampler = eryn_tpu_torch.EnsembleSampler(
        16, [2, 1], ll, priors, branch_names=["a", "b"], seed=2, device="cpu",
        tempering_kwargs=dict(ntemps=2, use_kernels=use_kernels),
        moves=[eryn_tpu_torch.StretchMove(use_kernels=use_kernels)],
    )
    g = torch.Generator().manual_seed(0)
    coords = {"a": priors["a"].rvs(size=(2, 16, 1), generator=g),
              "b": priors["b"].rvs(size=(2, 16, 1), generator=g)}
    sampler.run_mcmc(coords, 1500, burn=200)
    chain = sampler.get_chain(temp_index=0)
    assert np.all(np.abs(chain["a"].reshape(-1, 2).mean(0)) < 0.15)
    assert abs(chain["b"].mean() - 1.0) < 0.15
    x = sampler.get_last_sample().branches_coords
    expect = -0.5 * ((x["a"][..., 0, :] ** 2).sum(-1) + (x["b"][..., 0, 0] - 1) ** 2)
    np.testing.assert_allclose(sampler.get_last_sample().log_like, expect,
                               rtol=1e-5, atol=1e-5)


# ----------------------------------------------------------------------
# the adaptation clock on the device
# ----------------------------------------------------------------------
def _within_one_ulp(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype
    assert np.all(np.abs(got - want) <= np.spacing(np.abs(want))), (got, want)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_ladder_adjustment_with_a_device_clock_matches_jax(dtype):
    """The port's ladder update with a 0-d int tensor clock against
    eryn_tpu's with its traced clock (cast to the betas dtype, as its
    ``temper_kernel`` casts it), at four clock values.  The gain, which is
    all the clock sets, is bitwise the reference's ``lag / (time + lag) /
    adaptation_time`` (``eryn_tpu/moves/tempering.py:613-614``); the updated
    ladder is within 1 ulp in float32, and within 4 in float64, where XLA's
    ``exp`` rounds 1 ulp from torch's (and numpy's) and the cumulative sum
    carries that to up to 3 ulp of a rung."""
    import jax

    rng = np.random.default_rng(5)
    betas = make_ladder(3, 6).astype(dtype)
    ratios = rng.random(5).astype(dtype)
    jtc = eryn_tpu.moves.TemperatureControl(3, 8, ntemps=6)
    ttc = eryn_tpu_torch.TemperatureControl(3, 8, ntemps=6)
    ulps = 1 if dtype == np.float32 else 4
    for time in (0, 1, 7, 1000):
        with jax.enable_x64(dtype == np.float64):
            t = jnp.asarray(time, jnp.int32).astype(dtype)
            want_gain = np.asarray(
                jtc.adaptation_lag / (t + jtc.adaptation_lag)
                / jtc.adaptation_time)
            want = np.asarray(jtc.ladder_adjustment_kernel(
                t, jnp.asarray(betas), jnp.asarray(ratios)))
        clock = torch.tensor(time)
        gain = ttc.adaptation_gain(clock, torch.from_numpy(betas))
        assert gain.dtype == torch.from_numpy(betas).dtype
        np.testing.assert_array_equal(gain.numpy(), want_gain)
        got = ttc.ladder_adjustment_kernel(
            clock, torch.from_numpy(betas), torch.from_numpy(ratios)).numpy()
        assert got.dtype == want.dtype
        assert np.all(np.abs(got - want)
                      <= ulps * np.spacing(np.abs(want))), (got, want)
        assert not np.array_equal(got, betas)


def test_temper_kernel_stops_adapting_as_jax_does():
    """Both packages' ``temper_kernel`` with ``stop_adaptation=5`` and one
    swap phase result given to both: at clock 4 the ladder moves, at 5 and
    6 it stays; the clock advances by one each time."""
    rng = np.random.default_rng(6)
    nt, nw, stop = 4, 8, 5
    coords = rng.standard_normal((nt, nw, 1, 3)).astype(np.float32)
    logl = rng.standard_normal((nt, nw)).astype(np.float32)
    logp = np.zeros((nt, nw), np.float32)
    betas = make_ladder(3, nt).astype(np.float32)
    acc = np.array([3.0, 5.0, 1.0], np.float32)
    jtc = eryn_tpu.moves.TemperatureControl(3, nw, ntemps=nt,
                                            stop_adaptation=stop)
    jtc.swap_kernel = lambda key, tree, logl, betas, **kw: (
        tree, logl, jnp.asarray(acc), jnp.full(nt - 1, float(nw)))
    ttc = eryn_tpu_torch.TemperatureControl(3, nw, ntemps=nt,
                                            stop_adaptation=stop)
    ttc.swap_kernel = lambda gen, tree, logl, betas: (
        tree, logl, torch.from_numpy(acc), nw)
    jstate = eryn_tpu.State({"m": coords}, log_like=logl, log_prior=logp,
                            betas=betas)
    tstate = state_from_numpy(state_to_numpy(jstate), device="cpu")
    for time in (stop - 1, stop, stop + 1):
        j_new, _, j_time = jtc.temper_kernel(None, jstate, jnp.int32(time))
        t_new, _, t_time = ttc.temper_kernel(None, tstate, torch.tensor(time))
        assert int(j_time) == int(t_time) == time + 1
        _within_one_ulp(t_new.betas.numpy(), np.asarray(j_new.betas))
        moved = not np.array_equal(t_new.betas.numpy(), betas)
        assert moved == (time < stop)


def _gaussian_sampler(rj=False, **kw):
    if rj:
        priors = eryn_tpu_torch.ProbDistContainer(
            {i: eryn_tpu_torch.uniform_dist(-1.0, 1.0) for i in range(2)})
        sampler = eryn_tpu_torch.EnsembleSampler(
            16, 2,
            lambda c, i: -0.5 * torch.sum(torch.where(i[:, None], c, 0.0) ** 2),
            priors, nleaves_max=3,
            moves=eryn_tpu_torch.moves.RedBlueGroupStretchMove(
                live_dangerously=True),
            rj_moves=True, tempering_kwargs=dict(ntemps=3),
            fill_zero_leaves_val=0.0, device="cpu", **kw)
        shape = (3, 16, 3)
    else:
        priors = eryn_tpu_torch.ProbDistContainer(
            {i: eryn_tpu_torch.uniform_dist(-5.0, 5.0) for i in range(3)})
        sampler = eryn_tpu_torch.EnsembleSampler(
            16, 3, _ll, priors, tempering_kwargs=dict(ntemps=3),
            device="cpu", **kw)
        shape = (3, 16)
    coords = priors.rvs(size=shape, generator=torch.Generator().manual_seed(1))
    return sampler, coords


@pytest.mark.parametrize("rj", [False, True])
def test_clock_after_run_counts_the_adapting_phases(rj):
    """One adapting phase per step (the in-model move's; an RJ move's phase
    does not adapt); the clock is a 0-d tensor on the sampler's device."""
    sampler, coords = _gaussian_sampler(rj=rj, seed=3)
    sampler.run_mcmc(coords, 12, burn=5)
    sampler.run_mcmc(None, 4, thin_by=2)
    time = sampler.temperature_control.time
    assert isinstance(time, torch.Tensor) and time.shape == ()
    assert time.device.type == "cpu" and int(time) == 12 + 5 + 8
    assert not np.allclose(sampler.get_betas()[-1], make_ladder(
        sum(sampler.nleaves_max[n] * sampler.ndims[n]
            for n in sampler.branch_names), 3))


def test_interop_round_trip_carries_the_clock():
    """A run continued in a second sampler from the numpy state, ladder and
    clock of the first (and its generator state) is the first run's
    continuation, digit for digit: a clock restarted at 0 would adapt the
    ladder with another gain."""
    first, coords = _gaussian_sampler(seed=4)
    last = first.run_mcmc(coords, 16)
    d = tempering_to_numpy(first.temperature_control)
    assert d["time"] == 16
    second, _ = _gaussian_sampler(seed=99)
    tempering_from_numpy(second.temperature_control, d)
    second._gen.set_state(first.random_state)
    carried = state_from_numpy(state_to_numpy(last), device="cpu")
    first.run_mcmc(None, 8)
    second.run_mcmc(carried, 8)
    np.testing.assert_array_equal(second.get_chain()["model_0"],
                                  first.get_chain()["model_0"][16:])
    np.testing.assert_array_equal(second.get_betas(), first.get_betas()[16:])
    assert int(second.temperature_control.time) == 24
