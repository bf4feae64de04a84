"""Blobs in the port against eryn_tpu on the CPU.

* The portable cases of ``tests/test_blobs.py``, each through both packages
  from the same numpy start: the round trip (shape ``(nsteps, ntemps,
  nwalkers, 2)``, ``blob[0] == -2 log_like`` and ``blob[1]`` the first
  parameter of the stored chain), the getters' ``discard``/``thin``/
  ``temp_index`` slicing, and blobs following delayed rejection and
  multiple-try reversible jump.  The shapes equal eryn_tpu's.
* Every move of the zoo and the reversible-jump moves with a likelihood
  that returns ``(ll, [-2 ll, ...])``: the identity holds exactly on every
  stored sample (a move that merged its blobs wrongly breaks it).
* The three backends: ``Backend``, ``DeviceBackend`` and ``HDFBackend``
  return the same blobs for the same run, under every getter keyword, with
  ``get_last_sample`` and ``get_a_sample``, and ``blobs_dtype`` sets the
  stored dtype.
* HDF5 both ways: a file with blobs written by either package opens in
  the other with equal ``get_blobs`` and resumes there with the identity
  on the new samples.

Sizes: 1-3 temperatures x 16-24 walkers, 2-D, 10-40 steps.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import eryn_tpu
import eryn_tpu_torch as et
from eryn_tpu_torch import moves as tm

torch.set_num_threads(1)

NDIM = 2
NWALKERS = 24


def _ll_blobs(x):
    ll = -0.5 * torch.sum(x ** 2)
    return ll, torch.stack([-2.0 * ll, x[0]])


def _jll_blobs(x):
    ll = -0.5 * jnp.sum(x ** 2)
    return ll, jnp.array([-2.0 * ll, x[0]])


def _priors(pkg, lo=-5.0, hi=5.0, ndim=NDIM):
    return pkg.ProbDistContainer({i: pkg.uniform_dist(lo, hi)
                                  for i in range(ndim)})


def _start(ntemps, nwalkers=NWALKERS, seed=0):
    return np.random.default_rng(seed).uniform(-3, 3, (ntemps, nwalkers,
                                                       NDIM))


def _check_identity(sampler, param=True):
    blobs = sampler.get_blobs()
    ll = sampler.get_log_like()
    np.testing.assert_array_equal(blobs[..., 0], -2.0 * ll)
    if param:
        chain = sampler.get_chain()["model_0"]
        np.testing.assert_array_equal(blobs[..., 1], chain[:, :, :, 0, 0])
    return blobs


def test_blobs_roundtrip():
    j = eryn_tpu.EnsembleSampler(NWALKERS, NDIM, _jll_blobs,
                                 _priors(eryn_tpu),
                                 tempering_kwargs=dict(ntemps=3), seed=30)
    t = et.EnsembleSampler(NWALKERS, NDIM, _ll_blobs, _priors(et),
                           tempering_kwargs=dict(ntemps=3), seed=30,
                           device="cpu")
    assert t._like_eval.returns_blobs is False  # found at the first run
    j.run_mcmc(_start(3), 40, burn=10)
    t.run_mcmc(torch.tensor(_start(3), dtype=torch.float32), 40, burn=10)
    assert t._like_eval.returns_blobs and j._like_eval.returns_blobs
    assert t._like_eval.blob_shape == (2,)
    jb = j.get_blobs()
    np.testing.assert_allclose(jb[..., 0], -2.0 * j.get_log_like(), rtol=1e-4)
    tb = _check_identity(t)
    assert tb.shape == jb.shape == (40, 3, NWALKERS, 2)
    assert tb.dtype == np.float32
    # the last state carries the blobs of its coordinates
    last = t._previous_state
    np.testing.assert_array_equal(last.blobs[..., 0].numpy(),
                                  -2.0 * last.log_like.numpy())


def test_getter_slicing():
    kw = dict(discard=10, thin=2, temp_index=1)
    j = eryn_tpu.EnsembleSampler(NWALKERS, NDIM, _jll_blobs,
                                 _priors(eryn_tpu),
                                 tempering_kwargs=dict(ntemps=4), seed=31)
    t = et.EnsembleSampler(NWALKERS, NDIM, _ll_blobs, _priors(et),
                           tempering_kwargs=dict(ntemps=4), seed=31,
                           device="cpu")
    j.run_mcmc(_start(4), 30)
    t.run_mcmc(torch.tensor(_start(4), dtype=torch.float32), 30)
    for name, args in (("get_chain", dict(temp_index=0)),
                       ("get_log_like", kw), ("get_blobs", kw),
                       ("get_blobs", dict(temp_index=0)),
                       ("get_blobs", dict(slice_vals=slice(3, 9, 3)))):
        a, b = getattr(j, name)(**args), getattr(t, name)(**args)
        if isinstance(a, dict):
            a, b = a["model_0"], b["model_0"]
        assert np.shape(a) == np.shape(b), (name, args)
    assert t.get_blobs(**kw).shape == (10, NWALKERS, 2)
    np.testing.assert_array_equal(t.get_blobs(**kw)[..., 0],
                                  -2.0 * t.get_log_like(**kw))
    only = t.get_chain(branch_names="model_0")
    assert set(only) == {"model_0"}
    # a likelihood without blobs stores none
    plain = et.EnsembleSampler(NWALKERS, NDIM, lambda x: -0.5 * torch.sum(x * x),
                               _priors(et), seed=31, device="cpu")
    plain.run_mcmc(torch.tensor(_start(1)[0], dtype=torch.float32), 5)
    assert plain.get_blobs() is None and plain._previous_state.blobs is None


def _ll_rj(c, i):
    ll = -0.5 * torch.sum(torch.where(i[:, None], c, 0.0) ** 2)
    return ll, torch.stack([-2.0 * ll])


def _jll_rj(c, i):
    ll = -0.5 * jnp.sum(jnp.where(i[:, None], c, 0.0) ** 2)
    return ll, jnp.array([-2.0 * ll])


def test_blobs_follow_delayed_rejection_and_mt_rj():
    """Delayed rejection and multiple-try reversible jump merge blobs on
    accept, in both packages: the stored blob stays ``-2 log_like``."""
    start = _start(1)[0] * 0.1
    for pkg, ll, dtype in ((eryn_tpu, _jll_blobs, None),
                           (et, _ll_blobs, "cpu")):
        extra = {} if dtype is None else {"device": "cpu"}
        inner = pkg.moves.GaussianMove({"model_0": 1.5 * np.ones(NDIM)})
        ens = pkg.EnsembleSampler(
            NWALKERS, NDIM, ll, _priors(pkg),
            moves=[pkg.moves.DelayedRejection(inner, max_iter=2)], seed=33,
            **extra)
        ens.run_mcmc(start if dtype is None else torch.tensor(
            start, dtype=torch.float32), 30)
        np.testing.assert_allclose(ens.get_blobs()[..., 0],
                                   -2.0 * ens.get_log_like(), rtol=1e-6)

        pr = _priors(pkg)
        rj_move = pkg.moves.MTDistGenMoveRJ(
            {"model_0": pr}, nleaves_max={"model_0": 2},
            nleaves_min={"model_0": 0}, num_try=4)
        ens2 = pkg.EnsembleSampler(
            NWALKERS, NDIM, _jll_rj if dtype is None else _ll_rj, pr,
            nleaves_max=2, nleaves_min=0, rj_moves=[rj_move],
            fill_zero_leaves_val=0.0, seed=34, **extra)
        rng = np.random.default_rng(3)
        coords = rng.uniform(-5, 5, (1, NWALKERS, 2, NDIM)).astype(np.float32)
        inds = rng.random((1, NWALKERS, 2)) < 0.5
        ens2.run_mcmc(pkg.State({"model_0": coords}, inds={"model_0": inds}),
                      40)
        np.testing.assert_allclose(ens2.get_blobs()[..., 0],
                                   -2.0 * ens2.get_log_like(), rtol=1e-6)
        assert ens2.get_blobs().shape == (40, 1, NWALKERS, 1)


# ----------------------------------------------------------------------
# every move
# ----------------------------------------------------------------------
IN_MODEL = {
    "stretch": lambda pr: tm.StretchMove(),
    "de": lambda pr: tm.DEMove(),
    "snooker": lambda pr: tm.DESnookerMove(),
    "walk": lambda pr: tm.WalkMove(),
    "kde": lambda pr: tm.KDEMove(),
    "gaussian": lambda pr: tm.GaussianMove({"model_0": np.full(NDIM, 0.25)}),
    "distgen": lambda pr: tm.DistributionGenerate({"model_0": pr}),
    "group stretch": lambda pr: tm.GroupStretchMove(n_iter_update=5),
    "red-blue group stretch": lambda pr: tm.RedBlueGroupStretchMove(),
    "mt": lambda pr: tm.MTDistGenMove({"model_0": pr}, num_try=3),
    "mt independent": lambda pr: tm.MTDistGenMove({"model_0": pr}, num_try=3,
                                                  independent=True),
    "dr": lambda pr: tm.DelayedRejection(
        tm.GaussianMove({"model_0": np.full(NDIM, 1.5)}), max_iter=2),
    "combine": lambda pr: tm.CombineMove([
        tm.GroupStretchMove(n_iter_update=5),
        tm.GaussianMove({"model_0": np.full(NDIM, 0.25)})]),
    "mala": lambda pr: tm.MALAMove(tune_steps=10),
    "mala precond": lambda pr: tm.MALAMove(tune_steps=10,
                                           ensemble_precondition=True),
    "hmc": lambda pr: tm.HMCMove(num_leapfrog=(2, 4), tune_steps=10),
    "hmc precond": lambda pr: tm.HMCMove(tune_steps=10,
                                         ensemble_precondition=True),
    "chees": lambda pr: tm.ChEESHMCMove(tune_steps=10, max_leapfrog=6),
    "slice": lambda pr: tm.SliceMove(tune_steps=10),
    "aimh": lambda pr: tm.AIMHMove(tune_steps=10),
}


@pytest.mark.parametrize("kind", sorted(IN_MODEL))
def test_every_in_model_move_keeps_the_blob_identity(kind):
    pr = _priors(et)
    sampler = et.EnsembleSampler(
        16, NDIM, _ll_blobs, pr, moves=IN_MODEL[kind](pr),
        tempering_kwargs=dict(ntemps=2), seed=5, device="cpu")
    sampler.run_mcmc(torch.tensor(_start(2, 16), dtype=torch.float32), 15,
                     burn=5)
    _check_identity(sampler)
    assert 0 < sampler.acceptance_fraction.mean()


def _rj_sampler(kind, rj_move):
    pr = _priors(et, -1.0, 1.0)
    sampler = et.EnsembleSampler(
        16, NDIM, _ll_rj, pr, nleaves_max=3, nleaves_min=0,
        moves=tm.RedBlueGroupStretchMove(live_dangerously=True),
        rj_moves=rj_move(pr), tempering_kwargs=dict(ntemps=2),
        fill_zero_leaves_val=0.0, seed=6, device="cpu")
    g = torch.Generator().manual_seed(2)
    coords = pr.rvs(size=(2, 16, 3), generator=g)
    inds = torch.rand((2, 16, 3), generator=g) < 0.5
    return sampler, et.State(coords, inds=inds)


@pytest.mark.parametrize("kind", ["rj", "mt rj", "model swap"])
def test_every_rj_move_keeps_the_blob_identity(kind):
    if kind == "model swap":
        names = ["a", "b"]
        priors = {"a": et.ProbDistContainer({0: et.uniform_dist(0.0, 2.0)}),
                  "b": et.ProbDistContainer({0: et.uniform_dist(-1.0, 1.0)})}

        def ll(coords, inds):
            x = sum(torch.sum(torch.where(inds[n][:, None], coords[n], 0.0))
                    for n in names)
            v = -0.5 * (x - 0.5) ** 2 / 0.3
            return v, torch.stack([-2.0 * v])

        sampler = et.EnsembleSampler(
            16, {"a": 1, "b": 1}, ll, priors, branch_names=names,
            nleaves_max={"a": 1, "b": 1}, nleaves_min={"a": 0, "b": 0},
            moves=[tm.GaussianMove({"a": 0.05, "b": 0.05})],
            rj_moves=[tm.ModelSwapRJMove(priors)],
            tempering_kwargs=dict(ntemps=2), fill_zero_leaves_val=-1e8,
            seed=0, device="cpu")
        g = torch.Generator().manual_seed(1)
        pick = torch.rand((2, 16, 1), generator=g) < 0.5
        start = et.State({n: priors[n].rvs(size=(2, 16, 1), generator=g)
                          for n in names}, inds={"a": pick, "b": ~pick})
    else:
        sampler, start = _rj_sampler(kind, {
            "rj": lambda pr: True,
            "mt rj": lambda pr: [tm.MTDistGenMoveRJ(
                {"model_0": pr}, nleaves_max={"model_0": 3},
                nleaves_min={"model_0": 0}, num_try=3)],
        }[kind])
    sampler.run_mcmc(start, 20, burn=5)
    _check_identity(sampler, param=False)
    assert sampler.rj_acceptance_fraction.mean() > 0


def test_the_stored_blob_can_be_the_leaf_count():
    """A blob that counts the active leaves equals ``get_nleaves`` at every
    stored sample (the chip's RJ leg holds the same)."""
    def ll(c, i):
        return (-0.5 * torch.sum(torch.where(i[:, None], c, 0.0) ** 2),
                i.sum().to(c.dtype))

    sampler, start = _rj_sampler("rj", lambda pr: True)
    sampler._like_eval.fn = ll
    sampler.log_like_fn = ll
    sampler.run_mcmc(start, 20)
    blobs = sampler.get_blobs()
    assert blobs.shape == (20, 2, 16)
    np.testing.assert_array_equal(blobs, sampler.get_nleaves()["model_0"])


# ----------------------------------------------------------------------
# the backends
# ----------------------------------------------------------------------
def _run_into(backend, blobs_dtype=None):
    s = et.EnsembleSampler(NWALKERS, NDIM, _ll_blobs, _priors(et),
                           tempering_kwargs=dict(ntemps=3), seed=12,
                           device="cpu", backend=backend,
                           blobs_dtype=blobs_dtype)
    s.run_mcmc(torch.tensor(_start(3), dtype=torch.float32), 20,
               segment_size=8)
    return s


def test_the_three_backends_store_the_same_blobs(tmp_path):
    runs = [_run_into(et.Backend(dtype=np.float32)),
            _run_into(et.DeviceBackend(dtype=np.float32)),
            _run_into(et.HDFBackend(str(tmp_path / "b.h5"), dtype=np.float32))]
    keys = [dict(), dict(discard=4, thin=3), dict(temp_index=2),
            dict(slice_vals=np.array([19, 0, 5]))]
    for kw in keys:
        want = runs[0].get_blobs(**kw)
        for r in runs[1:]:
            np.testing.assert_array_equal(r.get_blobs(**kw), want, err_msg=kw)
    for r in runs:
        assert r.backend.has_blobs()
        _check_identity(r)
        last = r.backend.get_last_sample()
        np.testing.assert_array_equal(np.asarray(last.blobs),
                                      runs[0].get_blobs()[-1])
        np.testing.assert_array_equal(np.asarray(
            r.backend.get_a_sample(7).blobs), runs[0].get_blobs()[7])
    # blobs_dtype sets the stored dtype
    wide = _run_into(et.Backend(), blobs_dtype=np.float64)
    assert wide.get_blobs().dtype == np.float64
    np.testing.assert_array_equal(wide.get_blobs(), runs[0].get_blobs())
    dev = et.DeviceBackend(dtype=np.float32, max_device_bytes=1)
    offloaded = _run_into(dev)  # every segment moves to the host
    np.testing.assert_array_equal(offloaded.get_blobs(), runs[0].get_blobs())


def test_compute_log_like_returns_blobs():
    s = et.EnsembleSampler(NWALKERS, NDIM, _ll_blobs, _priors(et),
                           device="cpu")
    x = torch.tensor(_start(1)[0], dtype=torch.float32)
    ll, blobs = s.compute_log_like(x)
    assert blobs.shape == (1, NWALKERS, 2)
    np.testing.assert_array_equal(blobs[..., 0].numpy(), -2.0 * ll.numpy())


def test_port_file_with_blobs_reads_and_resumes_in_eryn_tpu(tmp_path):
    from eryn_tpu.backends import HDFBackend as JaxHDFBackend

    fn = str(tmp_path / "port.h5")
    s = _run_into(et.HDFBackend(fn))
    port_blobs = s.get_blobs()
    jb = JaxHDFBackend(fn)
    assert jb.has_blobs()
    # eryn_tpu's HDFBackend.get_blobs reads an attribute its file backend
    # lacks; its get_value("blobs") reads the file
    np.testing.assert_array_equal(jb.get_value("blobs"), port_blobs)
    j = eryn_tpu.EnsembleSampler(NWALKERS, NDIM, _jll_blobs,
                                 _priors(eryn_tpu), backend=JaxHDFBackend(fn),
                                 tempering_kwargs=dict(ntemps=3), seed=4)
    assert j.backend.iteration == 20
    j.run_mcmc(None, 6)
    blobs = et.HDFBackend(fn).get_blobs()
    assert blobs.shape == (26, 3, NWALKERS, 2)
    np.testing.assert_array_equal(blobs[:20], port_blobs)
    np.testing.assert_allclose(blobs[20:, ..., 0],
                               -2.0 * j.get_log_like()[20:], rtol=1e-6)


def test_eryn_tpu_file_with_blobs_reads_and_resumes_in_the_port(tmp_path):
    from eryn_tpu.backends import HDFBackend as JaxHDFBackend

    fn = str(tmp_path / "jax.h5")
    j = eryn_tpu.EnsembleSampler(NWALKERS, NDIM, _jll_blobs,
                                 _priors(eryn_tpu), backend=JaxHDFBackend(fn),
                                 tempering_kwargs=dict(ntemps=3), seed=4)
    j.run_mcmc(_start(3), 10)
    jblobs = j.backend.get_value("blobs")  # as above
    port = et.HDFBackend(fn)
    assert port.has_blobs()
    np.testing.assert_array_equal(port.get_blobs(), jblobs)
    np.testing.assert_array_equal(
        port.get_blobs(thin=2, temp_index=0),
        j.backend.get_value("blobs", thin=2, temp_index=0))
    s = et.EnsembleSampler(NWALKERS, NDIM, _ll_blobs, _priors(et),
                           backend=fn, tempering_kwargs=dict(ntemps=3),
                           seed=7, device="cpu")
    np.testing.assert_array_equal(s._previous_state.blobs.numpy(),
                                  jblobs[-1])
    s.run_mcmc(None, 6)
    blobs = s.get_blobs()
    assert blobs.shape == (16, 3, NWALKERS, 2)
    np.testing.assert_array_equal(blobs[:10], jblobs)
    np.testing.assert_array_equal(blobs[10:, ..., 0],
                                  -2.0 * s.get_log_like()[10:])
    with pytest.raises(ValueError, match="blobs_dtype"):
        et.EnsembleSampler(NWALKERS, NDIM, _ll_blobs, _priors(et),
                           backend=fn, tempering_kwargs=dict(ntemps=3),
                           blobs_dtype=np.float64, device="cpu")
