"""Supplementals in the port against eryn_tpu on the CPU.

* The nine cases of ``tests/test_supplemental.py`` on the port: the
  container and its object management (each result beside eryn_tpu's),
  host objects following the swaps over a second run, the host registry
  cleared between runs, setitem on host entries, ``copy_into_self``, swaps
  moving a branch tag with its coordinates, ``provide_supplemental`` with
  ``sigma = 2`` (posterior spread within 0.3 of 2), and ``copy=True``
  independence.
* Decision for decision: ``temper_kernel`` on a state with blobs, a state
  supplemental (an int tag, a float entry, an entry named in
  ``skip_swap_supp_names``) and a branch supplemental, for the kernel
  cascade, the general cascade and DEO, given the draws eryn_tpu makes from
  its key: every moved tensor equal to eryn_tpu's.
* A fault: a state's supplementals survived no ``run_mcmc`` (the 6 x 32
  probe; the tags must come back permuted).  A NumPy likelihood (8 walkers,
  2-D) runs in host mode, with and without ``vectorize``; returns that are
  neither torch tensors nor NumPy values per walker are refused with a
  ``TypeError``.
* ``Move.update`` merges accepted walkers' supplemental entries but
  ``skip_supp_names_update``, over the whole ensemble and a subset.
* A graph-path run (each replay run as its captured body) with blobs, a
  state tag, a branch supplemental and a host object equals the eager loop.

Sizes: 1-6 temperatures x 4-32 walkers, 2-D.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import eryn_tpu
import eryn_tpu_torch as et
from eryn_tpu_torch.interop import state_from_numpy, state_to_numpy

torch.set_num_threads(1)

NDIM = 2


def _priors(lo=-5.0, hi=5.0):
    return et.ProbDistContainer({i: et.uniform_dist(lo, hi)
                                 for i in range(NDIM)})


def _gauss(x):
    return -0.5 * torch.sum(x ** 2)


def _both(fn):
    """``fn(package)`` for both packages."""
    return fn(eryn_tpu), fn(et)


def test_branch_supplemental_container():
    for pkg in (eryn_tpu, et):
        supp = pkg.BranchSupplemental(
            {"walker_id": np.arange(12).reshape(3, 4)}, base_shape=(3, 4))
        assert "walker_id" in supp
        assert tuple(supp["walker_id"].shape) == (3, 4)
        assert tuple(supp.flat["walker_id"].shape) == (12,)
        with pytest.raises(ValueError):
            pkg.BranchSupplemental({"bad": np.zeros((2, 2))}, base_shape=(3, 4))
    supp = et.BranchSupplemental({"walker_id": np.arange(12).reshape(3, 4)})
    assert supp.base_shape == (3, 4)  # inferred from the first entry


def test_branch_supplemental_object_management():
    """add/remove/take/put along an axis, each result beside eryn_tpu's."""
    base = np.arange(24, dtype=float).reshape(2, 3, 4)
    idx = np.array([[1, 0, 2], [2, 1, 0]])
    objs = np.empty((2, 3), dtype=object)
    objs[...] = [[("o", t, w) for w in range(3)] for t in range(2)]

    def run(pkg):
        supp = pkg.BranchSupplemental({"a": base.copy()}, base_shape=(2, 3))
        supp.add_objects({"b": np.ones((2, 3)), "obj": objs.copy()})
        assert supp.contained_objects == ["a", "b", "obj"]
        with pytest.raises(ValueError):
            supp.add_objects({"bad": np.zeros((5, 5))})
        out = supp.take_along_axis(idx, axis=1, skip_names=("b",))
        assert sorted(out) == ["a", "obj"]
        taken = {k: np.asarray(v) for k, v in out.items()}
        # put(take(x)) along a permutation is the identity
        supp.put_along_axis(idx, supp.take_along_axis(idx, axis=1), axis=1)
        np.testing.assert_array_equal(np.asarray(supp["a"]), base)
        # a scatter of new values
        supp.put_along_axis(idx[:, :1], {"a": -1.0, "obj": ("new",)}, axis=1)
        after = np.asarray(supp["a"]).copy()
        supp.remove_objects("b")
        assert supp.contained_objects == ["a", "obj"]
        with pytest.raises(ValueError):
            supp.remove_objects(3.14)
        indexed = supp[(1, 2)]
        return taken, after, supp["obj"].copy(), indexed

    (j_taken, j_after, j_obj, j_idx), (t_taken, t_after, t_obj, t_idx) = (
        _both(run))
    np.testing.assert_array_equal(t_taken["a"],
                                  np.take_along_axis(base, idx[..., None], 1))
    for k in j_taken:
        np.testing.assert_array_equal(t_taken[k], j_taken[k])
    np.testing.assert_array_equal(t_after, j_after)
    assert t_obj.tolist() == j_obj.tolist()
    np.testing.assert_array_equal(np.asarray(t_idx["a"]), np.asarray(j_idx["a"]))
    assert t_idx["obj"] == j_idx["obj"]


def _object_state(pr, ntemps, nw, gen):
    flat_ids = np.arange(ntemps * nw).reshape(ntemps, nw)
    objs = np.empty((ntemps, nw), dtype=object)
    bobjs = np.empty((ntemps, nw), dtype=object)
    for t in range(ntemps):
        for w in range(nw):
            objs[t, w] = ("state", t * nw + w)
            bobjs[t, w] = {"branch_id": t * nw + w}
    return flat_ids, et.State(
        {"model_0": pr.rvs(size=(ntemps, nw), generator=gen)},
        supplemental=et.BranchSupplemental(
            {"tag": flat_ids.copy(), "obj": objs}, base_shape=(ntemps, nw)),
        branch_supplemental={"model_0": et.BranchSupplemental(
            {"btag": flat_ids.copy(), "bobj": bobjs},
            base_shape=(ntemps, nw))},
    )


def test_host_object_supplementals_follow_swaps():
    """Object entries live on the host and follow their walkers: after a
    tempered run each walker's object agrees with an int tag that rode the
    swaps, and a second run continues from the reordered registry."""
    ntemps, nw = 6, 32
    pr = _priors()
    ens = et.EnsembleSampler(nw, NDIM, _gauss, pr, device="cpu",
                             tempering_kwargs=dict(ntemps=ntemps), seed=3)
    flat_ids, state = _object_state(pr, ntemps, nw,
                                    torch.Generator().manual_seed(0))
    ens.run_mcmc(state, 60, burn=40)

    def check(final):
        tag = final.supplemental["tag"].numpy()
        obj = final.supplemental["obj"]
        btag = final.branches["model_0"].supplemental["btag"].numpy()
        bobj = final.branches["model_0"].supplemental["bobj"]
        np.testing.assert_array_equal(btag, tag)  # one swap permutation
        assert "__prov__" not in final.supplemental
        for t in range(ntemps):
            for w in range(nw):
                assert obj[t, w] == ("state", int(tag[t, w])), (t, w)
                assert bobj[t, w]["branch_id"] == int(btag[t, w])
        return tag

    tag = check(ens._previous_state)
    assert not np.array_equal(tag, flat_ids)  # swaps happened
    ens.run_mcmc(None, 40)
    tag2 = check(ens._previous_state)
    assert not np.array_equal(tag2, tag)


def test_host_object_registry_cleared_between_runs():
    ntemps, nw = 3, 16
    pr = _priors()
    gen = torch.Generator().manual_seed(5)
    ens = et.EnsembleSampler(nw, NDIM, _gauss, pr, device="cpu",
                             tempering_kwargs=dict(ntemps=ntemps), seed=5)
    objs = np.empty((ntemps, nw), dtype=object)
    objs[...] = [[("run1", i) for i in range(nw)] for _ in range(ntemps)]
    state = et.State(
        {"model_0": pr.rvs(size=(ntemps, nw), generator=gen)},
        supplemental=et.BranchSupplemental({"obj": objs},
                                           base_shape=(ntemps, nw)))
    ens.run_mcmc(state, 10)
    assert "obj" in ens._previous_state.supplemental
    ens.run_mcmc(et.State({"model_0": pr.rvs(size=(ntemps, nw),
                                             generator=gen)}), 10)
    final = ens._previous_state
    assert final.supplemental is None or "obj" not in final.supplemental


def test_branch_supplemental_setitem_host_entries():
    for pkg in (eryn_tpu, et):
        objs = np.empty((2, 3), dtype=object)
        objs[...] = [[("a", i) for i in range(3)] for _ in range(2)]
        supp = pkg.BranchSupplemental({"obj": objs, "x": np.zeros((2, 3))},
                                      base_shape=(2, 3))
        new_objs = np.empty((2, 3), dtype=object)
        new_objs[...] = [[("b", i) for i in range(3)] for _ in range(2)]
        supp["obj"] = new_objs
        assert supp["obj"][0, 0] == ("b", 0)
        supp[(0, 1)] = {"obj": ("c", 9), "x": 4.0, "unknown": 1.0}
        assert supp["obj"][0, 1] == ("c", 9)
        assert float(supp["x"][0, 1]) == 4.0 and float(supp["x"].sum()) == 4.0
        assert "unknown" not in supp


def test_state_copy_into_self():
    s1 = et.State({"m": np.zeros((1, 4, 1, 2))}, log_like=np.zeros((1, 4)),
                  blobs=np.zeros((1, 4, 2)))
    s2 = et.State({"m": np.ones((1, 4, 1, 2))}, log_like=np.ones((1, 4)),
                  blobs=np.ones((1, 4, 2)),
                  supplemental=et.BranchSupplemental({"t": np.ones((1, 4))}))
    s1.copy_into_self(s2)
    assert float(s1.log_like.sum()) == 4.0
    assert float(s1.branches["m"].coords.sum()) == 8.0
    assert float(s1.blobs.sum()) == 8.0
    assert s1.supplemental is s2.supplemental


def test_supplemental_swaps_with_coords():
    """The general cascade moves a branch tag with the coordinates it
    equals, as a permutation of the tags."""
    ntemps, nw = 5, 16
    rng = np.random.default_rng(0)
    coords = rng.standard_normal((ntemps, nw, 1, NDIM))
    tag = coords[:, :, 0, 0].copy()
    state = et.State(
        {"model_0": coords},
        branch_supplemental={"model_0": et.BranchSupplemental(
            {"tag": tag}, base_shape=(ntemps, nw))},
        log_like=rng.standard_normal((ntemps, nw)) * 5,
        log_prior=np.zeros((ntemps, nw)),
        betas=np.logspace(0, -2, ntemps),
    )
    tc = et.TemperatureControl(NDIM, nw, ntemps=ntemps, adaptive=False,
                               use_kernels=False)
    new_state, swaps, _ = tc.temper_kernel(torch.Generator().manual_seed(0),
                                           state, 0, adapt=False)
    assert swaps.sum() > 0
    new_tag = new_state.branches_supplemental["model_0"]["tag"].numpy()
    np.testing.assert_array_equal(
        new_tag, new_state.branches["model_0"].coords[:, :, 0, 0].numpy())
    np.testing.assert_array_equal(np.sort(new_tag.ravel()),
                                  np.sort(tag.ravel()))


def test_provide_supplemental_likelihood():
    """``provide_supplemental=True``: the likelihood receives each walker's
    branch supplemental; ``sigma = 2`` widens the posterior to about 2."""
    nwalkers = 24

    def log_like(x, supps):
        return -0.5 * torch.sum((x / supps["sigma"]) ** 2)

    priors = _priors(-10.0, 10.0)
    ens = et.EnsembleSampler(nwalkers, NDIM, log_like, priors,
                             provide_supplemental=True, seed=70, device="cpu")
    coords = priors.rvs(size=(nwalkers,),
                        generator=torch.Generator().manual_seed(1))
    state = et.State(
        {"model_0": coords},
        branch_supplemental={"model_0": et.BranchSupplemental(
            {"sigma": np.full((1, nwalkers), 2.0)}, base_shape=(1, nwalkers))})
    ens.run_mcmc(state, 300, burn=200)
    chain = ens.get_chain()["model_0"].reshape(-1, NDIM)
    assert abs(chain.std(axis=0).mean() - 2.0) < 0.3


def test_state_copy_true_is_independent():
    supp = et.BranchSupplemental({"tag": np.arange(4.0).reshape(1, 4)},
                                 base_shape=(1, 4))
    objs = np.empty((1, 4), dtype=object)
    objs[:] = [[{"id": i} for i in range(4)]]
    supp["objs"] = objs
    st = et.State({"m": np.zeros((1, 4, 1, 2))}, log_like=np.zeros((1, 4)),
                  log_prior=np.zeros((1, 4)), branch_supplemental={"m": supp},
                  supplemental=et.BranchSupplemental({"s": np.zeros((1, 4))}))
    snap = et.State(st, copy=True)
    snap.branches["m"].supplemental["objs"][0, 0]["id"] = 99
    snap.branches["m"].supplemental["tag"] = np.full((1, 4), -1.0)
    snap.supplemental.holder["s"].fill_(5.0)
    snap.branches["m"].coords.fill_(3.0)
    assert st.branches["m"].supplemental["objs"][0, 0]["id"] == 0
    np.testing.assert_array_equal(st.branches["m"].supplemental["tag"].numpy(),
                                  np.arange(4.0).reshape(1, 4))
    assert float(st.supplemental["s"].sum()) == 0.0
    assert float(st.branches["m"].coords.sum()) == 0.0
    # copy=False shares
    alias = et.State(st)
    assert alias.branches["m"] is st.branches["m"]
    assert alias.supplemental is st.supplemental


# ----------------------------------------------------------------------
# the swap phase, decision for decision
# ----------------------------------------------------------------------
def _swap_state(nt, nw, seed):
    rng = np.random.default_rng(seed)
    coords = rng.standard_normal((nt, nw, 2, NDIM)).astype(np.float32)
    return {
        "coords": {"model_0": coords},
        "inds": {"model_0": rng.random((nt, nw, 2)) < 0.7},
        "log_like": (rng.standard_normal((nt, nw)) * 3).astype(np.float32),
        "log_prior": rng.standard_normal((nt, nw)).astype(np.float32),
        "betas": eryn_tpu.moves.tempering.make_ladder(NDIM, nt).astype(
            np.float32),
        "blobs": rng.standard_normal((nt, nw, 2)).astype(np.float32),
        "supplemental": {
            "rid": np.arange(nt * nw, dtype=np.int32).reshape(nt, nw),
            "noise": rng.random((nt, nw, 3)).astype(np.float32),
            "fixed": np.arange(nt * nw, dtype=np.int32).reshape(nt, nw),
        },
        "branch_supplemental": {"model_0": {
            "sigma": rng.random((nt, nw)).astype(np.float32) + 0.5,
            "flag": rng.random((nt, nw)) < 0.5}},
    }


def _jax_state(d):
    return eryn_tpu.State(
        d["coords"], inds=d["inds"], log_like=d["log_like"],
        log_prior=d["log_prior"], betas=d["betas"], blobs=d["blobs"],
        supplemental=eryn_tpu.BranchSupplemental(d["supplemental"]),
        branch_supplemental={n: eryn_tpu.BranchSupplemental(h)
                             for n, h in d["branch_supplemental"].items()})


@pytest.mark.parametrize("time", [0, 1])
@pytest.mark.parametrize("path", ["kernel", "general", "deo"])
@pytest.mark.parametrize("nt,nw", [(4, 16), (5, 33)])
def test_swaps_move_blobs_and_supplementals_as_eryn_tpu(path, nt, nw, time):
    d = _swap_state(nt, nw, seed=nt * nw + time)
    key = jax.random.PRNGKey(7 + time)
    scheme = "deo" if path == "deo" else "cascade"
    jtc = eryn_tpu.moves.TemperatureControl(
        NDIM, nw, ntemps=nt, adaptive=False, swap_scheme=scheme,
        use_pallas=path == "kernel", skip_swap_supp_names=["fixed"])
    if path == "kernel":
        jtc._swap_kernel_pallas = functools.partial(jtc._swap_kernel_pallas,
                                                    interpret=True)
    j_state, j_swaps, _ = jtc.temper_kernel(key, _jax_state(d),
                                            jnp.asarray(time, jnp.int32),
                                            adapt=False)

    ttc = et.TemperatureControl(
        NDIM, nw, ntemps=nt, adaptive=False, swap_scheme=scheme,
        use_kernels=path == "kernel", skip_swap_supp_names=["fixed"])
    # the draws eryn_tpu's swap phase makes from its key
    if path == "kernel":
        k_pi, k_shift, k_acc = jax.random.split(key, 3)
        draws = (torch.from_numpy(np.asarray(jax.random.permutation(
                     k_pi, nw)).astype(np.int64)),
                 torch.from_numpy(np.asarray(jax.random.randint(
                     k_shift, (nt - 1,), 0, nw)).astype(np.int32)),
                 torch.from_numpy(np.array(jnp.log(jax.random.uniform(
                     k_acc, (nt - 1, nw))))))
        ttc.draw_kernel = lambda *a: draws
    elif path == "general":
        k_perm, k_acc = jax.random.split(key)
        draws = (torch.from_numpy(np.array(jnp.argsort(jax.random.uniform(
                     k_perm, (nt - 1, 2, nw)), axis=-1)).astype(np.int64)),
                 torch.from_numpy(np.array(jnp.log(jax.random.uniform(
                     k_acc, (nt - 1, nw))))))
        ttc.draw_general = lambda *a: draws
    else:
        raccept = torch.from_numpy(np.array(jnp.log(jax.random.uniform(
            key, (nt - 1, nw)))))
        ttc.draw_deo = lambda *a: raccept
    t_state, t_swaps, _ = ttc.temper_kernel(
        None, state_from_numpy(d, device="cpu"), torch.tensor(time),
        adapt=False)

    want, got = state_to_numpy(j_state), state_to_numpy(t_state)
    np.testing.assert_array_equal(t_swaps.numpy(), np.asarray(j_swaps))
    assert 0 < float(t_swaps.sum())
    for key_ in ("log_like", "log_prior", "blobs"):
        np.testing.assert_array_equal(got[key_], want[key_], err_msg=key_)
    for field in ("coords", "inds"):
        np.testing.assert_array_equal(got[field]["model_0"],
                                      want[field]["model_0"], err_msg=field)
    for name in ("rid", "noise", "fixed"):
        np.testing.assert_array_equal(got["supplemental"][name],
                                      want["supplemental"][name], err_msg=name)
    for name in ("sigma", "flag"):
        np.testing.assert_array_equal(
            got["branch_supplemental"]["model_0"][name],
            want["branch_supplemental"]["model_0"][name], err_msg=name)
    # the tag moved as a permutation; the skipped entry did not move
    rid = got["supplemental"]["rid"]
    assert not np.array_equal(rid, d["supplemental"]["rid"])
    np.testing.assert_array_equal(np.sort(rid.ravel()), np.arange(nt * nw))
    np.testing.assert_array_equal(got["supplemental"]["fixed"],
                                  d["supplemental"]["fixed"])
    # the blobs moved with their walkers: slot s now holds walker rid[s]'s
    np.testing.assert_array_equal(got["blobs"].reshape(nt * nw, 2),
                                  d["blobs"].reshape(nt * nw, 2)[rid.ravel()])


# ----------------------------------------------------------------------
# the two faults
# ----------------------------------------------------------------------
def test_supplementals_survive_run_mcmc():
    """The 6 x 32 probe: a state and a branch tag come back from a tempered
    run, permuted alike by the swaps (the port used to drop both)."""
    ntemps, nw = 6, 32
    pr = _priors()
    gen = torch.Generator().manual_seed(2)
    ids = np.arange(ntemps * nw).reshape(ntemps, nw)
    state = et.State(
        {"model_0": pr.rvs(size=(ntemps, nw), generator=gen)},
        supplemental=et.BranchSupplemental({"tag": ids.copy()}),
        branch_supplemental={"model_0": et.BranchSupplemental(
            {"btag": ids.copy()})})
    ens = et.EnsembleSampler(nw, NDIM, _gauss, pr, device="cpu",
                             tempering_kwargs=dict(ntemps=ntemps), seed=3)
    final = ens.run_mcmc(state, 60, burn=40)
    assert final.supplemental is not None
    assert final.branches["model_0"].branch_supplemental is not None
    tag = final.supplemental["tag"].numpy()
    btag = final.branches["model_0"].branch_supplemental["btag"].numpy()
    assert not np.array_equal(tag, ids)
    np.testing.assert_array_equal(np.sort(tag.ravel()), ids.ravel())
    np.testing.assert_array_equal(btag, tag)
    assert ens._previous_state.supplemental["tag"] is not None


@pytest.mark.parametrize("vectorize", [True, False])
def test_a_numpy_likelihood_runs_in_host_mode(vectorize):
    """``-0.5 sum(np.asarray(x)^2)`` on 8 walkers in 2-D runs on the host
    (``likelihood_mode == "host"``), its log-likelihoods the function's."""
    pr = _priors()
    ens = et.EnsembleSampler(
        8, NDIM, lambda x: -0.5 * np.sum(np.asarray(x) ** 2, axis=-1), pr,
        device="cpu", vectorize=vectorize)
    start = pr.rvs(size=(8,), generator=torch.Generator().manual_seed(0))
    with pytest.warns(UserWarning, match="runs as a NumPy likelihood"):
        ens.run_mcmc(start, 5)
    assert ens.likelihood_mode == "host" and ens.backend.iteration == 5
    chain = ens.get_chain()["model_0"][:, 0, :, 0]
    np.testing.assert_allclose(ens.get_log_like()[:, 0],
                               -0.5 * np.sum(chain**2, axis=-1), rtol=1e-5)


@pytest.mark.parametrize("out", ["float", "list", "ndarray pair"])
def test_non_tensor_returns_are_refused(out):
    def fn(x):
        v = float(np.sum(np.asarray(x) ** 2))
        return {"float": v, "list": [v, 2.0 * v],
                "ndarray pair": (np.full(2, v), np.zeros((2, 1)))}[out]

    ens = et.EnsembleSampler(8, NDIM, fn, _priors(), device="cpu",
                             vectorize=True)
    # neither torch tensors nor, called on NumPy arrays, one value per
    # walker of the probe
    with pytest.raises(TypeError, match="Called as a NumPy likelihood"):
        ens.run_mcmc(torch.zeros(8, NDIM), 2)


# ----------------------------------------------------------------------
# Move.update and the graph path
# ----------------------------------------------------------------------
@pytest.mark.parametrize("subset", [False, True])
def test_move_update_merges_supplementals(subset):
    nt, nw = 2, 6
    d = _swap_state(nt, nw, seed=1)
    old = state_from_numpy(d, device="cpu")
    new = old.map_tensors(lambda x: x.clone() if x.dtype == torch.bool
                          else x + 1)
    move = et.moves.MHMove(skip_supp_names_update=["fixed"])
    accepted = torch.tensor([[1, 0, 1, 0, 0, 1], [0, 1, 1, 0, 1, 0]]).bool()
    if subset:
        idx = torch.tensor([[0, 2, 4], [5, 1, 3]])
        sub = new.map_tensors(lambda x: torch.gather(
            x, 1, idx.reshape(idx.shape + (1,) * (x.ndim - 2)).expand(
                idx.shape + x.shape[2:])) if x.ndim >= 2 else x)
        out = move.update(old, sub, accepted, subset=idx)
        # walkers outside the subset keep their values
        inside = np.zeros((nt, nw), bool)
        np.put_along_axis(inside, idx.numpy(), True, axis=1)
        acc = accepted.numpy() & inside
    else:
        out = move.update(old, new, accepted)
        acc = accepted.numpy()
    for field in ("log_like", "blobs"):
        want = np.where(acc.reshape(acc.shape + (1,) * (getattr(
            old, field).ndim - 2)), getattr(new, field), getattr(old, field))
        np.testing.assert_array_equal(getattr(out, field).numpy(), want)
    np.testing.assert_array_equal(
        out.supplemental["rid"].numpy(),
        np.where(acc, new.supplemental["rid"], old.supplemental["rid"]))
    np.testing.assert_array_equal(out.supplemental["fixed"].numpy(),
                                  old.supplemental["fixed"].numpy())
    np.testing.assert_array_equal(
        out.branches["model_0"].supplemental["sigma"].numpy(),
        np.where(acc, new.branches["model_0"].supplemental["sigma"],
                 old.branches["model_0"].supplemental["sigma"]))


def test_graph_path_with_blobs_and_supplementals_matches_the_eager_loop(
        monkeypatch):
    """The graph path's buffers hold the blobs, the state tag and the
    branch supplemental; each replay run as its captured body gives the
    eager loop's run digit for digit, host objects included."""
    from eryn_tpu_torch.ensemble import EnsembleSampler
    from eryn_tpu_torch.graphs import StepGraphs

    ntemps, nw = 4, 16

    def ll(x, supps):
        v = -0.5 * torch.sum((x / supps["sigma"]) ** 2)
        return v, torch.stack([-2.0 * v, x[0]])

    def run(graphed):
        pr = _priors()
        ids, state = _object_state(pr, ntemps, nw,
                                   torch.Generator().manual_seed(4))
        state.branches["model_0"].supplemental["sigma"] = np.ones((ntemps, nw))
        ens = et.EnsembleSampler(
            nw, NDIM, ll, pr, device="cpu", provide_supplemental=True,
            tempering_kwargs=dict(ntemps=ntemps), seed=11,
            moves=[(et.StretchMove(), 0.5), (et.moves.DEMove(), 0.5)])
        if graphed:
            monkeypatch.setattr(EnsembleSampler, "_graphed", True)
            monkeypatch.setattr(
                StepGraphs, "_capture",
                lambda self, key, ctx: (_EagerReplay(self, key, ctx), ()))
        ens.run_mcmc(state, 12, burn=5)
        ens.run_mcmc(None, 6, thin_by=2)
        monkeypatch.undo()
        return ens

    eager, graphed = run(False), run(True)
    assert graphed.graph_replays > 0 and eager.graph_replays == 0
    for getter in ("get_blobs", "get_log_like"):
        np.testing.assert_array_equal(getattr(eager, getter)(),
                                      getattr(graphed, getter)())
    np.testing.assert_array_equal(eager.get_chain()["model_0"],
                                  graphed.get_chain()["model_0"])
    a, b = eager._previous_state, graphed._previous_state
    np.testing.assert_array_equal(a.supplemental["tag"].numpy(),
                                  b.supplemental["tag"].numpy())
    np.testing.assert_array_equal(
        a.branches["model_0"].supplemental["btag"].numpy(),
        b.branches["model_0"].supplemental["btag"].numpy())
    assert a.supplemental["obj"].tolist() == b.supplemental["obj"].tolist()
    blobs, ll_ = graphed.get_blobs(), graphed.get_log_like()
    np.testing.assert_array_equal(blobs[..., 0], -2.0 * ll_)


class _EagerReplay:
    """Stands in for a captured graph on the CPU: a replay runs the body."""

    def __init__(self, graphs, key, ctx):
        self.replay = lambda: graphs._body(key, ctx)
