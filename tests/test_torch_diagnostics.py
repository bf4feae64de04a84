"""The port's diagnostics against eryn_tpu's on the CPU.

* Host estimators (evidence by thermodynamic integration and stepping
  stone, ``psrf``, rank-normalised R-hat, effective sample size, replica
  round trips) against eryn_tpu's on the same arrays, with dead-leaf NaN
  columns: the same float64 NumPy arithmetic, within 1e-12 relative.
* Device estimators (``*_torch``) against the host ones: within 1e-10
  relative (float64; the FFT and the reductions run in another order).
* Backend getters: the port's ``HDFBackend`` and ``eryn_tpu``'s on one file,
  written by either package, within 1e-12 relative; ``Backend()``,
  ``DeviceBackend()`` (its device forms on CPU tensors) and a file from one
  seed hold the same chain; the device forms within 1e-6 relative of the
  host getters (thermodynamic integration reduces the float32
  log-likelihoods in float64 on the device, NumPy in float32 on the host),
  R-hat and ESS within 1e-10.
* ``TransformContainer`` on NumPy arrays and on tensors against eryn_tpu's.

Sizes: 5 temperatures x 16 walkers x 3-D (60 stored steps), an RJ chain of
3 x 32 walkers with up to 3 leaves of 2-D.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import eryn_tpu
import eryn_tpu.utils.utility as ju
import eryn_tpu_torch as et
import eryn_tpu_torch.utils.utility as tu
from eryn_tpu.backends import HDFBackend as JaxHDFBackend
from eryn_tpu.utils.transform import TransformContainer as JaxTransform
from eryn_tpu_torch.moves import RedBlueGroupStretchMove

torch.set_num_threads(1)

NT, NW, NDIM, STEPS = 5, 16, 3, 60


def _chains(seed=0, nsteps=61, nwalkers=12, ndim=4):
    """AR(1) walkers with dead-leaf NaNs: a walker whose column never
    lives, scattered dead steps, and a column dead everywhere."""
    rng = np.random.default_rng(seed)
    x = np.empty((nsteps, nwalkers, ndim))
    x[0] = rng.standard_normal((nwalkers, ndim))
    for t in range(1, nsteps):
        x[t] = 0.7 * x[t - 1] + rng.standard_normal((nwalkers, ndim))
    x[:, 3, 1] = np.nan
    x[rng.random((nsteps, nwalkers)) < 0.2, 2] = np.nan
    x[:, :, 3] = np.nan
    return x


def _close(got, want, rtol):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                               np.asarray(want, dtype=np.float64),
                               rtol=rtol, atol=0, equal_nan=True)


@pytest.mark.parametrize("seed", [0, 1])
def test_host_estimators_match_jax(seed):
    x = _chains(seed)
    finite = x[..., :3]
    for per_walker in (True, False):
        _close(tu.psrf(finite, 3, per_walker=per_walker),
               ju.psrf(finite, 3, per_walker=per_walker), 1e-12)
    for ours, theirs in ((tu.rank_normalized_rhat, ju.rank_normalized_rhat),
                         (tu.effective_sample_size, ju.effective_sample_size)):
        for a, b in zip(ours(x, return_parts=True),
                        theirs(x, return_parts=True)):
            _close(a, b, 1e-12)
    assert np.isnan(tu.effective_sample_size(x)[3])
    with pytest.raises(ValueError):
        tu.rank_normalized_rhat(x[:3])
    with pytest.raises(ValueError):
        tu.psrf(finite, 2)


@pytest.mark.parametrize("seed", [0, 1])
def test_device_estimators_match_the_host(seed):
    x = _chains(seed)
    t = torch.from_numpy(x)
    for dev, host in ((tu.rank_normalized_rhat_torch, tu.rank_normalized_rhat),
                      (tu.effective_sample_size_torch,
                       tu.effective_sample_size)):
        for a, b in zip(dev(t, return_parts=True),
                        host(x, return_parts=True)):
            _close(a.numpy(), b, 1e-10)
    # float32 in, float64 out, as the host computes
    got = tu.effective_sample_size_torch(t.float())
    assert got.dtype == torch.float64
    _close(got.numpy(), tu.effective_sample_size(x.astype(np.float32)), 1e-10)
    # an even step count, and a 2-D chain (one parameter)
    _close(tu.rank_normalized_rhat_torch(t[1:, :, 0]).numpy(),
           tu.rank_normalized_rhat(x[1:, :, 0]), 1e-10)
    with pytest.raises(ValueError):
        tu.effective_sample_size_torch(t[:3])


def test_evidence_estimators_match_jax():
    rng = np.random.default_rng(2)
    betas = et.make_ladder(NDIM, 6, Tmax=np.inf)
    logls = rng.standard_normal((80, 6, 10)) - 5.0 * np.arange(6)[None, :, None]
    for b in (betas, betas[:-1]):  # with and without a beta = 0 rung
        _close(tu.thermodynamic_integration_log_evidence(b, logls.mean((0, 2))
                                                         [:len(b)]),
               ju.thermodynamic_integration_log_evidence(b, logls.mean((0, 2))
                                                         [:len(b)]), 1e-12)
        ours = tu.stepping_stone_log_evidence(b, logls[:, :len(b)], seed=3,
                                              block_len=20, repeats=30)
        theirs = ju.stepping_stone_log_evidence(b, logls[:, :len(b)], seed=3,
                                                block_len=20, repeats=30)
        _close(ours, theirs, 1e-12)
    with pytest.raises(ValueError):
        tu.thermodynamic_integration_log_evidence(betas, logls.mean((0, 2))[:3])
    jtc = eryn_tpu.moves.TemperatureControl(NDIM, 10, betas=betas)
    ttc = et.TemperatureControl(NDIM, 10, betas=betas)
    _close(ttc.thermodynamic_integration_log_evidence(logls.mean((0, 2))),
           jtc.thermodynamic_integration_log_evidence(logls.mean((0, 2))),
           1e-12)
    _close(ttc.stepping_stone_log_evidence(logls, seed=4, repeats=20),
           jtc.stepping_stone_log_evidence(logls, seed=4, repeats=20), 1e-12)


def test_replica_round_trips_match_jax():
    rng = np.random.default_rng(5)
    rungs = np.clip(np.cumsum(rng.choice([-1, 1], (400, 6)), 0) % 9 - 2, 0, 4)
    assert tu.replica_round_trips(rungs, 5) == ju.replica_round_trips(rungs, 5)
    a = tu.replica_round_trips(rungs, 5, return_counts=True)
    b = ju.replica_round_trips(rungs, 5, return_counts=True)
    assert a[0] == b[0] > 0
    np.testing.assert_array_equal(a[1], b[1])
    with pytest.raises(ValueError):
        tu.replica_round_trips(rungs[0], 5)


# ----------------------------------------------------------------------
# the backends' getters
# ----------------------------------------------------------------------
def _gauss_sampler(backend, adaptive=False):
    priors = et.ProbDistContainer({i: et.uniform_dist(-10.0, 10.0)
                                   for i in range(NDIM)})
    s = et.EnsembleSampler(
        NW, NDIM, lambda x: -0.5 * torch.sum(x * x), priors,
        tempering_kwargs=dict(ntemps=NT, Tmax=np.inf, adaptive=adaptive),
        seed=8, device="cpu", backend=backend)
    start = priors.rvs(size=(NT, NW),
                       generator=torch.Generator().manual_seed(8))
    return s, start


def _rj_sampler(backend):
    pr = et.ProbDistContainer({i: et.uniform_dist(-1.0, 1.0) for i in range(2)})
    s = et.EnsembleSampler(
        32, 2, lambda c, i: -0.5 * torch.sum(torch.where(i[:, None], c, 0.0)
                                             ** 2),
        pr, nleaves_max=3, rj_moves=True,
        moves=RedBlueGroupStretchMove(live_dangerously=True),
        tempering_kwargs=dict(ntemps=3, adaptive=False),
        fill_zero_leaves_val=0.0, seed=3, device="cpu", backend=backend)
    g = torch.Generator().manual_seed(1)
    coords = pr.rvs(size=(3, 32, 3), generator=g)
    inds = torch.rand((3, 32, 3), generator=g) < 0.5
    return s, et.State(coords, inds=inds)


def _getters(b):
    """Every diagnostic getter's result, flattened to named arrays."""
    out = {
        "ti": b.get_evidence_estimate(discard=10),
        "ti_thermo": b.get_evidence_estimate(discard=10, thin=2,
                                             method="thermodynamic"),
        "ss": b.get_evidence_estimate(discard=10, method="stepping_stone",
                                      seed=7, repeats=20),
        "ti_value": b.get_evidence_estimate(return_error=False),
    }
    for name, res in b.get_gelman_rubin_convergence_diagnostic(
            discard=5, doprint=False).items():
        out[f"gr_{name}"] = res
    for name, res in b.get_gelman_rubin_convergence_diagnostic(
            doprint=False, per_walker=False).items():
        out[f"gr_pooled_{name}"] = res
    for name, res in b.get_rank_normalized_rhat(return_parts=True).items():
        out[f"rhat_{name}"] = np.stack(res)
    for name, res in b.get_effective_sample_size(thin=2,
                                                 return_parts=True).items():
        out[f"ess_{name}"] = np.stack(res)
    out["thin_burn"] = b.get_autocorr_thin_burn()
    return {k: np.asarray(v, dtype=np.float64) for k, v in out.items()}


def _compare(a, b, rtol, rtol_ti=None):
    assert a.keys() == b.keys()
    for k in a:
        r = rtol_ti if rtol_ti is not None and k.startswith("ti") else rtol
        _close(a[k], b[k], r)


def _run(sampler_fn, backend, steps=STEPS, **kw):
    s, start = sampler_fn(backend)
    s.run_mcmc(start, steps, segment_size=25, **kw)
    return s


@pytest.mark.parametrize("kind", ["gaussian", "rj"])
def test_backend_getters_agree_across_backends_and_packages(tmp_path, kind):
    fn = str(tmp_path / f"{kind}.h5")
    build = _gauss_sampler if kind == "gaussian" else _rj_sampler
    host = _run(build, et.Backend())
    device = _run(build, et.DeviceBackend())
    filed = _run(build, et.HDFBackend(fn))
    # one seed, one chain
    for s in (device, filed):
        np.testing.assert_array_equal(s.get_chain()["model_0"],
                                      host.get_chain()["model_0"])
        np.testing.assert_array_equal(s.get_log_like(), host.get_log_like())
    ours = _getters(filed.backend)
    theirs = _getters(JaxHDFBackend(fn))
    _compare(ours, theirs, 1e-12)
    _compare(_getters(host.backend), ours, 1e-12)
    # the device forms, on CPU tensors
    _compare(_getters(device.backend), ours, 1e-10, rtol_ti=1e-6)
    if kind == "rj":
        # a leaf slot dead over the whole chain: its columns are dropped, on
        # the host as on the device
        host.backend.inds["model_0"][..., 2] = False
        for seg in device.backend._segs:
            seg["inds"]["model_0"][..., 2] = False
        a, b = _getters(host.backend), _getters(device.backend)
        assert a["rhat_model_0"].shape[-1] == 4
        _compare(b, a, 1e-10, rtol_ti=1e-6)
    info, jinfo = filed.backend.get_info(discard=4), JaxHDFBackend(fn).get_info(
        discard=4)
    assert info.keys() == jinfo.keys()
    for k in ("ac_burn", "ac_thin", "ntemps", "nwalkers", "nbranches",
              "branch names", "ndims", "burn", "thin"):
        assert info[k] == jinfo[k], k
    np.testing.assert_array_equal(info["log_like"], jinfo["log_like"])
    _close(info["tau"]["model_0"], jinfo["tau"]["model_0"], 1e-12)
    assert device.backend.get_info()["tau"] is not None


def test_getters_on_a_file_eryn_tpu_wrote(tmp_path):
    fn = str(tmp_path / "jax.h5")
    priors = eryn_tpu.ProbDistContainer(
        {i: eryn_tpu.uniform_dist(-10.0, 10.0) for i in range(NDIM)})
    sampler = eryn_tpu.EnsembleSampler(
        NW, NDIM, lambda x: -0.5 * jnp.sum(x * x), priors,
        backend=JaxHDFBackend(fn),
        tempering_kwargs=dict(ntemps=NT, Tmax=np.inf, adaptive=False), seed=4)
    sampler.run_mcmc(np.random.default_rng(0).uniform(-3, 3, (NT, NW, NDIM)),
                     STEPS)
    _compare(_getters(et.HDFBackend(fn)), _getters(JaxHDFBackend(fn)), 1e-12)


def test_evidence_errors():
    s = _run(_gauss_sampler, et.DeviceBackend(), steps=20)
    for b in (s.backend, _run(_gauss_sampler, et.Backend(), steps=20).backend):
        with pytest.raises(ValueError, match="no stored samples"):
            b.get_evidence_estimate(discard=20)
    adapting = _run(lambda b: _gauss_sampler(b, adaptive=True), et.Backend(),
                    steps=20)
    for b in (adapting.backend, _run(lambda b: _gauss_sampler(b, True),
                                     et.DeviceBackend(), steps=20).backend):
        with pytest.raises(ValueError, match="adapting"):
            b.get_evidence_estimate()
        # the stepping stone too
        with pytest.raises(ValueError, match="adapting"):
            b.get_evidence_estimate(method="stepping_stone")


def test_an_offloaded_device_backend_takes_the_host_path():
    s = _run(_gauss_sampler, et.DeviceBackend(), steps=40)
    before = _getters(s.backend)
    s.backend.offload()
    assert s.backend._host is not None
    _compare(_getters(s.backend), before, 1e-10, rtol_ti=1e-6)


# ----------------------------------------------------------------------
# TransformContainer
# ----------------------------------------------------------------------
def _transforms(mod):
    return dict(
        input_basis=["a", "b", "c"], output_basis=["a", "f", "b", "c", "g"],
        parameter_transforms={"a": mod.exp, ("b", "c"): lambda b, c: (b + c,
                                                                      b - c)},
        fill_dict={"f": 1.5, "g": -2.0})


def test_transform_container_matches_jax():
    x = np.random.default_rng(6).standard_normal((4, 5, 3))
    ours = et.TransformContainer(**_transforms(np))
    theirs = JaxTransform(**_transforms(np))
    for kw in ({}, {"return_transpose": True}):
        np.testing.assert_array_equal(ours.both_transforms(x, **kw),
                                      theirs.both_transforms(x, **kw))
    tours = et.TransformContainer(**_transforms(torch))
    jtheirs = JaxTransform(**_transforms(jnp))
    with jax.enable_x64(True):
        want = np.asarray(jtheirs(jnp.asarray(x)))
        want_t = np.asarray(jtheirs(jnp.asarray(x), return_transpose=True))
    got = tours(torch.from_numpy(x))
    assert isinstance(got, torch.Tensor)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-15)
    np.testing.assert_allclose(
        tours(torch.from_numpy(x), return_transpose=True).numpy(), want_t,
        rtol=1e-15)
    assert ours.fill_values(x[..., :3]).shape == (4, 5, 5)
    assert et.TransformContainer(["a"], ["a", "b"]).fill_values(x) is x
    with pytest.raises(ValueError):
        et.TransformContainer(["z"], ["a"])
    with pytest.raises(ValueError):
        et.TransformContainer(["a"], ["a"], parameter_transforms={1.5: abs})
