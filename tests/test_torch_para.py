"""Batched independent ensembles: the port's ``ParaEnsembleSampler`` and
``ParaState`` against ``eryn_tpu``'s on the same numpy inputs, and the
kernels' group axis under ``torch.func.vmap``.

Tolerances: ``ParaState`` folds and unfolds arrays, and the grouped plain
cascade only moves values, so both are bitwise equal to ``eryn_tpu``'s.  The
two samplers draw from different generators, so their chains are held to
the same statistical contract (``tests/test_para.py``: each group's cold
mean within 0.3 of 0 and standard deviation within 0.3 of 1) and to equal
shapes.  The custom ops' vmap rules, a one-group runner against
``EnsembleSampler`` of the same seed, and the graph path's buffers against
the eager loop are bitwise.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import eryn_tpu
from eryn_tpu.ops import pt_swap as jax_swap
from eryn_tpu.parallel.para import ParaEnsembleSampler as JaxPara

import eryn_tpu_torch as et
from eryn_tpu_torch.interop import para_state_from_numpy, para_state_to_numpy
from eryn_tpu_torch.ops import pt_swap, select_kernels, stretch_kernels as sk
from eryn_tpu_torch.parallel import ParaEnsembleSampler
from eryn_tpu_torch.parallel import para as para_mod

torch.set_num_threads(1)

NDIM, NW, G, NT = 2, 24, 4, 3
NSTEPS, BURN = 120, 60


def _torch_ll(x):
    return -0.5 * torch.sum(x * x)


def _priors():
    return et.ProbDistContainer({i: et.uniform_dist(-6, 6) for i in range(NDIM)})


def _coords(ngroups=G, ntemps=NT, seed=0):
    return np.random.default_rng(seed).uniform(
        -2, 2, (ngroups, ntemps, NW, NDIM)).astype(np.float32)


def _para(ngroups=G, seed=60, **kw):
    kw.setdefault("tempering_kwargs", dict(ntemps=NT))
    return ParaEnsembleSampler(ngroups, NW, NDIM, _torch_ll, _priors(),
                               seed=seed, device="cpu", **kw)


@pytest.fixture(scope="module")
def runs():
    """One run of each package on the same numpy start: the contract of
    ``tests/test_para.py::test_para_ensemble_independent_groups``."""
    coords = _coords()
    jpr = eryn_tpu.ProbDistContainer(
        {i: eryn_tpu.uniform_dist(-6, 6) for i in range(NDIM)})
    jp = JaxPara(G, NW, NDIM, lambda x: -0.5 * jnp.sum(x ** 2), jpr,
                 tempering_kwargs=dict(ntemps=NT), seed=60)
    jstate = jp.run_mcmc(jnp.asarray(coords), NSTEPS, burn=BURN)
    tp = _para()
    tstate = tp.run_mcmc(coords, NSTEPS, burn=BURN)
    return jp, jstate, tp, tstate


def test_para_getters_match_eryn_tpu(runs):
    jp, jstate, tp, tstate = runs
    assert isinstance(tstate, et.ParaState)
    assert tuple(tstate.groups_running.shape) == (G,)
    assert bool(tstate.groups_running.all())
    assert tp.get_chain()["model_0"].shape == jp.get_chain()["model_0"].shape
    assert tp.get_chain()["model_0"].shape == (NSTEPS, G, NT, NW, 1, NDIM)
    for getter in ("get_log_like", "get_log_prior", "get_betas"):
        a, b = getattr(tp, getter)(), getattr(jp, getter)()
        assert a.shape == b.shape, getter
        assert np.isfinite(a).all(), getter
    assert tp.get_inds()["model_0"].shape == jp.get_inds()["model_0"].shape
    # the returned states carry the same folded fields
    for f in ("log_like", "log_prior", "betas"):
        assert tuple(getattr(tstate, f).shape) == tuple(
            np.shape(getattr(jstate, f))), f


@pytest.mark.parametrize("which", ["port", "eryn_tpu"])
def test_para_groups_converge_and_stay_independent(runs, which):
    jp, _, tp, _ = runs
    chain = (tp if which == "port" else jp).get_chain()["model_0"]
    for g in range(G):
        vals = np.asarray(chain[:, g, 0]).reshape(-1, NDIM)
        assert np.abs(vals.mean(axis=0)).max() < 0.3, g
        assert np.abs(vals.std(axis=0) - 1.0).max() < 0.3, g
    for g in range(1, G):
        assert not np.allclose(chain[:, 0, 0, 0, 0, 0], chain[:, g, 0, 0, 0, 0])
    # every group's ladder adapted on its own
    betas = (tp if which == "port" else jp).get_betas()
    assert not np.allclose(betas[-1, 0], betas[-1, 1])


def test_para_continues_and_counts(runs):
    _, _, tp, _ = runs
    n0 = tp.get_log_like().shape[0]
    tp.run_mcmc(None, 10)
    assert tp.get_log_like().shape[0] == n0 + 10
    acc = tp.acceptance_fraction
    assert acc.shape == (G, NT, NW) and 0.2 < acc[:, 0].mean() < 0.8
    swaps = tp.swap_acceptance_fraction
    assert swaps.shape == (G, NT - 1) and np.all((swaps > 0) & (swaps < 1))


def test_para_burn_ignores_thin_by_and_rejects_backend():
    """``tests/test_para.py::test_para_burn_ignores_thin_by_and_rejects_
    backend`` in both packages: ``burn`` counts raw steps."""
    with pytest.raises(ValueError, match="backend"):
        ParaEnsembleSampler(2, 16, 2, _torch_ll, _priors(), device="cpu",
                            backend=et.Backend())
    start = np.random.default_rng(1).standard_normal((2, 16, 2)) * 0.1
    para = ParaEnsembleSampler(2, 16, 2, _torch_ll, _priors(), seed=3,
                               device="cpu")
    para.run_mcmc(start, 4, burn=6, thin_by=5)
    assert para._m_nprop.sum() == 6 + 4 * 5
    assert para.get_chain()["model_0"].shape == (4, 2, 1, 16, 1, 2)
    jpr = eryn_tpu.ProbDistContainer(
        {i: eryn_tpu.uniform_dist(-6, 6) for i in range(2)})
    jp = JaxPara(2, 16, 2, lambda x: -0.5 * jnp.sum(x ** 2), jpr, seed=3)
    jp.run_mcmc(start, 4, burn=6, thin_by=5)
    assert (1, 6, False) in jp._fn_cache
    assert jp.get_chain()["model_0"].shape == para.get_chain()["model_0"].shape


def test_para_mesh_raises():
    """``mesh=`` takes a 1-D group mesh (``tests/test_torch_mesh.py`` runs
    one over spawned ranks); anything else raises ``eryn_tpu``'s
    ``ValueError``."""
    with pytest.raises(ValueError, match="1-D group mesh"):
        ParaEnsembleSampler(2, 16, 2, _torch_ll, _priors(), device="cpu",
                            mesh=object())


def _group_ll(st):
    return st.group_view({"ll": st.log_like})["ll"].numpy()


def test_para_groups_running_freezes_and_resets():
    """``tests/test_para.py``'s two ``groups_running`` contracts: stopped
    groups keep their state and their stored chain repeats the frozen
    snapshot bitwise; the mask holds for one call only."""
    para = _para(ngroups=3, seed=63, tempering_kwargs=dict(ntemps=2))
    frozen = _group_ll(para.run_mcmc(_coords(3, 2), 20))
    running = np.array([True, False, True])
    st2 = para.run_mcmc(None, 30, groups_running=running)
    np.testing.assert_array_equal(st2.groups_running.numpy(), running)
    ll2 = _group_ll(st2)
    np.testing.assert_array_equal(ll2[1], frozen[1])
    assert not np.allclose(ll2[0], frozen[0])
    assert not np.allclose(ll2[2], frozen[2])
    ll = para.get_log_like()
    assert ll.shape[0] == 50
    for step in range(20, 50):
        np.testing.assert_array_equal(ll[step, 1], frozen[1])
    st3 = para.run_mcmc(None, 10)  # omitted: every group advances
    assert bool(st3.groups_running.all())
    assert not np.allclose(_group_ll(st3)[1], frozen[1])


def test_para_groups_running_with_burn_matches_eryn_tpu():
    """``burn`` and ``groups_running`` in one call: the stopped group is
    frozen through the burn too, so its stored chain (log-likelihood and
    coordinates) repeats its state from before the call bitwise, in the
    port as in ``eryn_tpu``, whose runner gates right after the burn."""
    coords = _coords(3, 2)
    running = np.array([True, False, True])
    jpr = eryn_tpu.ProbDistContainer(
        {i: eryn_tpu.uniform_dist(-6, 6) for i in range(NDIM)})
    jp = JaxPara(3, NW, NDIM, lambda x: -0.5 * jnp.sum(x ** 2), jpr,
                 tempering_kwargs=dict(ntemps=2), seed=64)
    tp = _para(ngroups=3, seed=64, tempering_kwargs=dict(ntemps=2))
    for p in (jp, tp):
        p.run_mcmc(jnp.asarray(coords) if p is jp else coords, 5)
        ll0 = np.asarray(p.get_log_like())[-1, 1]
        x0 = np.asarray(p.get_chain()["model_0"])[-1, 1]
        p.run_mcmc(None, 8, burn=6, groups_running=running)
        ll, x = np.asarray(p.get_log_like()), np.asarray(
            p.get_chain()["model_0"])
        assert ll.shape[0] == 13
        for step in range(5, 13):
            np.testing.assert_array_equal(ll[step, 1], ll0)
            np.testing.assert_array_equal(x[step, 1], x0)
        assert not np.allclose(ll[-1, 0], ll[4, 0])
        assert not np.allclose(ll[-1, 2], ll[4, 2])


@pytest.mark.parametrize("label", ["chees", "slice", "deo"])
def test_para_move_families(label):
    """``tests/test_para.py::test_para_new_move_families_under_vmap`` on the
    port, at 2 groups: ChEES (its masked leapfrog loop, its counter summed
    over the groups), the slice move (capped loops) and DEO swaps under the
    group map."""
    from eryn_tpu_torch.moves import ChEESHMCMove, SliceMove

    kw, nt = {"tempering_kwargs": dict(ntemps=3, swap_scheme="deo")}, 3
    if label == "chees":
        kw, nt = {"moves": [ChEESHMCMove(tune_steps=50, max_leapfrog=8)],
                  "tempering_kwargs": {}}, 1
    elif label == "slice":
        kw, nt = {"moves": [SliceMove(tune_steps=30)],
                  "tempering_kwargs": {}}, 1
    para = _para(ngroups=2, seed=61, **kw)
    para.run_mcmc(_coords(2, nt), 100 if label == "slice" else 150, burn=60)
    chain = para.get_chain()["model_0"]
    for g in range(2):
        vals = chain[:, g, 0].reshape(-1, NDIM)
        assert np.abs(vals.mean(axis=0)).max() < 0.35, (label, g)
        assert np.abs(vals.std(axis=0) - 1.0).max() < 0.35, (label, g)
    move = para.sampler.moves[0]
    if label == "chees":
        assert int(move.leapfrog_total) >= 2 * 210
    if label == "slice":
        assert int(move.loop_iterations[2]) == 2 * 2 * 160


def test_para_state_folds_like_eryn_tpu():
    """``ParaState`` folds group-batched fields and passes folded ones
    through, as ``eryn_tpu``'s (``tests/test_para.py:65-91``), and
    ``group_view`` unfolds them; the interop carries one over."""
    rng = np.random.default_rng(2)
    ng, nt, nw, nl, nd = 3, 2, 8, 1, 2
    coords5 = rng.standard_normal((ng, nt, nw, nl, nd)).astype(np.float32)
    ll3 = rng.standard_normal((ng, nt, nw)).astype(np.float32)
    inds4 = rng.random((ng, nt, nw, nl)) < 0.7
    betas2 = rng.random((ng, nt)).astype(np.float32)
    for ll, inds in ((ll3, inds4),
                     (ll3.reshape(ng * nt, nw), inds4.reshape(ng * nt, nw, nl))):
        js = eryn_tpu.ParaState({"m": jnp.asarray(coords5)},
                                log_like=jnp.asarray(ll),
                                inds={"m": jnp.asarray(inds)},
                                betas=jnp.asarray(betas2))
        ts = et.ParaState({"m": torch.from_numpy(coords5)},
                          log_like=torch.from_numpy(ll),
                          inds={"m": torch.from_numpy(inds)},
                          betas=torch.from_numpy(betas2))
        assert ts.ngroups == js.ngroups == ng
        np.testing.assert_array_equal(ts.branches["m"].coords.numpy(),
                                      np.asarray(js.branches["m"].coords))
        np.testing.assert_array_equal(ts.branches["m"].inds.numpy(),
                                      np.asarray(js.branches["m"].inds))
        np.testing.assert_array_equal(ts.log_like.numpy(),
                                      np.asarray(js.log_like))
        np.testing.assert_array_equal(ts.betas.numpy(), np.asarray(js.betas))
        tv = ts.group_view({"ll": ts.log_like, "x": ts.branches["m"].coords})
        jv = js.group_view({"ll": js.log_like, "x": js.branches["m"].coords})
        for k in tv:
            np.testing.assert_array_equal(tv[k].numpy(), np.asarray(jv[k]))
        d = para_state_to_numpy(js)
        d["groups_running"] = np.array([True, False, True])
        back = para_state_from_numpy(d, device="cpu")
        assert back.ngroups == ng
        np.testing.assert_array_equal(back.log_like.numpy(), np.asarray(js.log_like))
        np.testing.assert_array_equal(back.groups_running.numpy(),
                                      d["groups_running"])


@pytest.mark.parametrize("nw", [37, 700])
def test_grouped_plain_cascade_matches_vmapped_eryn_tpu(nw):
    """The grouped plain cascade (the tree form, identity relabelling,
    payload as rows) against ``jax.vmap`` of ``eryn_tpu``'s Pallas cascade
    (interpret mode) on the same draws, decision for decision; 700 walkers
    take the rolled form."""
    ng, nt, D = 3, 5, 4
    rng = np.random.default_rng(nw)
    logl = (rng.standard_normal((ng, nt, nw)) * 10).astype(np.float32)
    channels = rng.standard_normal((ng, nt, D, nw)).astype(np.float32)
    betas = np.stack([np.logspace(0, -2 - 0.2 * g, nt) for g in range(ng)]
                     ).astype(np.float32)
    dbetas = (betas[:, :-1] - betas[:, 1:]).astype(np.float32)
    shifts = rng.integers(0, nw, size=(ng, nt - 1)).astype(np.int32)
    raccept = np.log(rng.uniform(size=(ng, nt - 1, nw))).astype(np.float32)
    fn = jax_swap.pt_swap_cascade_multi if nw <= 640 else \
        jax_swap._cascade_multi_rolled
    jl, jc, jsel = jax.vmap(lambda *a: fn(*a, interpret=True))(
        *(jnp.asarray(x) for x in (logl, channels, dbetas, shifts, raccept)))
    t = torch.from_numpy
    rows = t(np.ascontiguousarray(channels.transpose(0, 1, 3, 2)))
    out_l, out_rows = torch.empty_like(t(logl)), [torch.empty_like(rows)]
    acc, sel = torch.empty((ng, nt - 1)), torch.empty((ng, nt - 1, nw))
    pi = torch.arange(nw).expand(ng, nw).contiguous()
    pt_swap.pt_swap_cascade_tree_grouped_ref(
        t(logl), [rows], t(betas), pi, t(shifts), t(raccept), out_l, out_rows,
        acc, sel)
    np.testing.assert_array_equal(out_l.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(out_rows[0].numpy().transpose(0, 1, 3, 2),
                                  np.asarray(jc))
    np.testing.assert_array_equal(sel.numpy(), np.asarray(jsel))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jsel).sum(-1))
    assert 0 < float(sel.sum()) < sel.numel()


def test_custom_ops_vmap_rule_equals_a_loop_over_groups():
    """Inside ``torch.func.vmap`` the wrappers run through the custom ops'
    vmap rules (the plain grouped versions on the CPU): bitwise a Python
    loop over the groups."""
    rng = np.random.default_rng(5)
    ng, nt, nw, D, nl = 3, 4, 10, 3, 3

    def f(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    def u(*shape):
        return torch.from_numpy(rng.uniform(size=shape).astype(np.float32))

    X, ll, lp, betas = f(ng, nt, nw, D), f(ng, nt, nw), f(ng, nt, nw), u(ng, nt)
    nd = torch.full((ng, nt, nw), float(D))
    perm = torch.stack([torch.from_numpy(rng.permutation(nw)) for _ in range(ng)])
    u_all = u(ng, 2, 3, nt, nw)

    def step(X, nd, perm, u_all, ll, lp, betas):
        q, f0 = sk.stretch_propose(X, X, nd, perm, u_all, 0)
        outs = (torch.empty_like(X), torch.empty_like(ll),
                torch.empty_like(ll), torch.empty_like(ll))
        q1, f1 = sk.stretch_accept_propose(q, X, q.sum(-1), q[..., 0], ll, lp,
                                           f0, betas, nd, perm, u_all, *outs)
        sk.stretch_accept(q1, X, q1.sum(-1), q1[..., 0], ll, lp, f1, betas,
                          perm, u_all, 1, *outs)
        out_l = torch.empty_like(ll)
        leaves = [torch.empty_like(outs[0]), torch.empty_like(ll > 0)]
        acc = ll.new_empty((nt - 1,))
        pt_swap.pt_swap_cascade_tree(outs[1], [outs[0], outs[1] > 0], betas,
                                     perm, perm[:nt - 1].to(torch.int32),
                                     torch.log(u_all[0, 0, 1:]), out_l,
                                     leaves, acc)
        return (*outs, out_l, *leaves, acc)

    ins = (X, nd, perm, u_all, ll, lp, betas)
    batched = torch.func.vmap(step)(*ins)
    for g in range(ng):
        for a, b in zip(batched, step(*(x[g] for x in ins))):
            assert torch.equal(a[g], b)
    C, CI = f(ng, nt, nw, nl, D), u(ng, nt, nw, nl) < 0.4
    uu, uz = u(ng, nt, 5, nl), u(ng, nt, 5)

    def gs(C, CI, uz, uu):
        return select_kernels.group_stretch_propose(
            {"m": C[:, 2:7]}, {"m": CI[:, 2:7]}, {"m": C}, {"m": CI}, uz,
            {"m": uu}, skip=(2, 5))

    q, fac = torch.func.vmap(gs)(C, CI, uz, uu)
    for g in range(ng):
        q1, f1 = gs(C[g], CI[g], uz[g], uu[g])
        assert torch.equal(fac[g], f1)
        assert torch.equal(q["m"][g].isnan(), q1["m"].isnan())
        assert torch.equal(q["m"][g].nan_to_num(), q1["m"].nan_to_num())


@pytest.mark.parametrize("kind", ["gaussian", "kernels", "rj"])
def test_one_group_equals_ensemble_sampler(kind):
    """A one-group runner replays ``EnsembleSampler`` of the same seed digit
    for digit (``randomness="different"`` draws one group's numbers from
    the generator as the unbatched draws do), on the general path, on the
    kernels' path (their plain versions through the vmap rules) and under
    reversible jump (the chains compared on active leaves)."""
    if kind == "rj":
        from eryn_tpu_torch.moves import RedBlueGroupStretchMove

        pr = {"g": et.ProbDistContainer({0: et.uniform_dist(-3, 3),
                                         1: et.uniform_dist(0.5, 2.0)})}

        def ll(c, i):
            return torch.where(i, -0.5 * (c[:, 0] - 1.0) ** 2 / 0.1, 0.0).sum()

        kw = dict(branch_names=["g"], nleaves_max=4, nleaves_min=0,
                  moves=RedBlueGroupStretchMove(), rj_moves=True,
                  tempering_kwargs=dict(ntemps=NT), device="cpu")
        rng = np.random.default_rng(0)
        coords = np.stack([rng.uniform(-3, 3, (1, NT, 16, 4)),
                           rng.uniform(0.5, 2, (1, NT, 16, 4))], -1
                          ).astype(np.float32)
        inds = rng.random((1, NT, 16, 4)) < 0.5
        inds[..., 0] = True
        p = ParaEnsembleSampler(1, 16, 2, ll, pr, seed=3, **kw)
        p.run_mcmc({"g": coords}, 20, inds={"g": inds})
        e = et.EnsembleSampler(16, 2, ll, pr, seed=3, **kw)
        e.run_mcmc(et.State({"g": torch.from_numpy(coords[0])},
                            inds={"g": torch.from_numpy(inds[0])}), 20)
        m = p.get_inds()["g"][:, 0]
        np.testing.assert_array_equal(m, e.get_inds()["g"])
        a, b = p.get_chain()["g"][:, 0], e.get_chain()["g"]
        np.testing.assert_array_equal(a[m], b[m])
        return
    kw = dict(tempering_kwargs=dict(ntemps=NT), device="cpu")
    if kind == "kernels":
        kw = dict(moves=et.StretchMove(use_kernels=True),
                  tempering_kwargs=dict(ntemps=NT, use_kernels=True),
                  device="cpu")
    coords = _coords(1)
    p = ParaEnsembleSampler(1, NW, NDIM, _torch_ll, _priors(), seed=5, **kw)
    p.run_mcmc(coords, 25, burn=5)
    e = et.EnsembleSampler(NW, NDIM, _torch_ll, _priors(), seed=5, **kw)
    e.run_mcmc(coords[0], 25, burn=5)
    np.testing.assert_array_equal(p.get_chain()["model_0"][:, 0],
                                  e.get_chain()["model_0"])
    np.testing.assert_array_equal(p.get_betas()[:, 0], e.get_betas())
    np.testing.assert_array_equal(p.get_log_like()[:, 0], e.get_log_like())


class _EagerReplay:
    """Stands in for a captured graph on the CPU: a replay runs the body."""

    def __init__(self, graphs, key, ctx):
        self.replay = lambda: graphs._body(key, ctx)


def test_para_graph_path_buffers_match_the_eager_loop(monkeypatch):
    """The graph path's group-batched buffers, with each replay run as the
    captured body would run: the same run as the eager loop (two weighted
    moves, one of them ChEES with its device counter, burn-in, ``thin_by``
    and a ``groups_running`` mask)."""
    from eryn_tpu_torch.ensemble import EnsembleSampler
    from eryn_tpu_torch.moves import ChEESHMCMove

    def run(graphed):
        para = _para(ngroups=3, seed=2, moves=[
            (et.StretchMove(use_kernels=True), 0.5),
            (ChEESHMCMove(max_leapfrog=6), 0.5)],
            tempering_kwargs=dict(ntemps=NT, use_kernels=True))
        if graphed:
            monkeypatch.setattr(EnsembleSampler, "_graphed", True)
            monkeypatch.setattr(
                para_mod._ParaGraphs, "_capture",
                lambda self, key, ctx: (_EagerReplay(self, key, ctx), ()))
        para.run_mcmc(_coords(3), 10, burn=5)
        para.run_mcmc(None, 5, thin_by=2, groups_running=[True, False, True])
        monkeypatch.undo()
        return para

    eager, graphed = run(False), run(True)
    for getter in ("get_log_like", "get_betas", "get_log_prior"):
        np.testing.assert_array_equal(getattr(eager, getter)(),
                                      getattr(graphed, getter)())
    np.testing.assert_array_equal(eager.get_chain()["model_0"],
                                  graphed.get_chain()["model_0"])
    np.testing.assert_array_equal(eager.acceptance_fraction,
                                  graphed.acceptance_fraction)
    assert int(eager.sampler.moves[1].leapfrog_total) == int(
        graphed.sampler.moves[1].leapfrog_total) > 0
    assert graphed.graph_replays == 25 - len(graphed._graphs.warm)
    assert eager._graphs is None


def _blob_ll_torch(x):
    return -0.5 * torch.sum(x ** 2), torch.sum(x)


def test_para_blob_likelihood_runs_like_eryn_tpu():
    """The queue's inputs (3 groups of 2 x 8 walkers in 2-D, a likelihood
    returning ``(log_like, sum(x))``): the port runs it on its
    log-likelihood and drops the blobs with one warning, as ``eryn_tpu``
    runs it.  The getters' shapes are equal, and over 800 more steps (the
    first 200 dropped) each group's cold moments in both packages lie
    within 0.3 of the unit Gaussian's (``tests/test_para.py``'s tolerance)
    and within 0.35 of the other package's."""
    import warnings

    ng, nt, nw, nd = 3, 2, 8, 2
    coords = np.random.default_rng(5).uniform(-1, 1, (ng, nt, nw, nd))
    jpr = eryn_tpu.ProbDistContainer(
        {i: eryn_tpu.uniform_dist(-6, 6) for i in range(nd)})
    jp = JaxPara(ng, nw, nd, lambda x: (-0.5 * jnp.sum(x ** 2), jnp.sum(x)),
                 jpr, tempering_kwargs=dict(ntemps=nt), seed=8)
    tp = ParaEnsembleSampler(
        ng, nw, nd, _blob_ll_torch, et.ProbDistContainer(
            {i: et.uniform_dist(-6, 6) for i in range(nd)}),
        tempering_kwargs=dict(ntemps=nt), seed=8, device="cpu")
    jp.run_mcmc(jnp.asarray(coords), 10)
    with pytest.warns(UserWarning, match="drops the blobs"):
        tp.run_mcmc(coords.astype(np.float32), 10)
    for getter in ("get_log_like", "get_log_prior", "get_betas"):
        assert getattr(tp, getter)().shape == np.asarray(
            getattr(jp, getter)()).shape, getter
    assert tp.get_chain()["model_0"].shape == (10, ng, nt, nw, 1, nd)
    assert tp.get_chain()["model_0"].shape == np.asarray(
        jp.get_chain()["model_0"]).shape
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the warning came once
        tp.run_mcmc(None, 800)
    jp.run_mcmc(None, 800)
    for g in range(ng):
        moments = []
        for p in (tp, jp):
            vals = np.asarray(p.get_chain()["model_0"])[210:, g, 0]
            vals = vals.reshape(-1, nd)
            moments.append((vals.mean(axis=0), vals.std(axis=0)))
            assert np.abs(moments[-1][0]).max() < 0.3, (g, moments)
            assert np.abs(moments[-1][1] - 1.0).max() < 0.3, (g, moments)
        assert np.abs(moments[0][0] - moments[1][0]).max() < 0.35
        assert np.abs(moments[0][1] - moments[1][1]).max() < 0.35


def test_para_groups_draw_their_own_moves():
    """Two moves at weights 0.5 / 0.5: each group draws its own move at
    every step (``eryn_tpu``'s per-group ``lax.switch``), so the groups'
    move sequences differ, and over 400 steps each group's share of the
    first move lies within four binomial standard deviations (0.1) of 0.5.
    With one move every group runs it at every step."""
    ng = 6
    para = _para(ngroups=ng, seed=12, moves=[
        (et.StretchMove(), 0.5), (et.StretchMove(a=1.5), 0.5)])
    seqs = []
    para.run_mcmc(_coords(ng), 1)
    for _ in range(20):
        before = para.move_proposals.copy()
        para.run_mcmc(None, 1)
        step = para.move_proposals - before
        assert np.array_equal(step.sum(axis=0), np.ones(ng))
        seqs.append(step[0])
    seqs = np.array(seqs).T  # (ngroups, steps): 1 where move 0 ran
    assert len({tuple(s) for s in seqs}) > 1, seqs
    para.run_mcmc(None, 379)
    counts = para.move_proposals
    assert counts.shape == (2, ng) and np.all(counts.sum(axis=0) == 400)
    share = counts[0] / 400.0
    assert np.all(np.abs(share - 0.5) <= 4 * np.sqrt(0.25 / 400)), share
    single = _para(ngroups=ng, seed=12)
    single.run_mcmc(_coords(ng), 7)
    assert np.array_equal(single.move_proposals, np.full((1, ng), 7))
