"""The plain PyTorch swap cascade against the JAX package's Pallas kernel
(interpret mode on the CPU), on the same numpy inputs.

Tolerance: none.  The cascade only moves values, so every output (the
log-likelihoods, all payload channels and the accept mask) must be bitwise
equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from eryn_tpu.ops import pt_swap as jax_swap
from eryn_tpu_torch.ops import pt_swap as port

torch.set_num_threads(1)


def _inputs(ntemps, nwalkers, D, seed=0):
    rng = np.random.default_rng(seed)
    logl = (rng.standard_normal((ntemps, nwalkers)) * 10).astype(np.float32)
    channels = rng.standard_normal((ntemps, D, nwalkers)).astype(np.float32)
    betas = np.logspace(0, -2, ntemps).astype(np.float32)
    dbetas = (betas[:-1] - betas[1:]).astype(np.float32)
    shifts = rng.integers(0, nwalkers, size=ntemps - 1).astype(np.int32)
    raccept = np.log(rng.uniform(size=(ntemps - 1, nwalkers))).astype(np.float32)
    return logl, channels, dbetas, shifts, raccept


@pytest.mark.parametrize("shape", [(6, 37, 4), (10, 100, 7)])
def test_cascade_multi_ref_bitwise_matches_jax(shape):
    inputs = _inputs(*shape)
    out_j = jax_swap.pt_swap_cascade_multi(
        *[jnp.asarray(x) for x in inputs], interpret=True
    )
    out_t = port.pt_swap_cascade_multi_ref(*[torch.from_numpy(x) for x in inputs])
    for t, j in zip(out_t, out_j):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    sel = out_t[2].numpy()
    assert 0 < sel.sum() < sel.size  # both decisions occur


@pytest.mark.parametrize("shape", [(6, 37), (10, 100)])
def test_provenance_cascade_bitwise_matches_jax(shape):
    ntemps, nwalkers = shape
    logl, _, dbetas, shifts, raccept = _inputs(ntemps, nwalkers, 1, seed=5)
    origin = np.arange(ntemps * nwalkers, dtype=np.float32).reshape(shape)
    args = (logl, origin, dbetas, shifts, raccept)
    out_j = jax_swap.pt_swap_cascade(
        *[jnp.asarray(x) for x in args], interpret=True
    )
    out_t = port.pt_swap_cascade(*[torch.from_numpy(x) for x in args])
    for t, j in zip(out_t, out_j):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    # provenance is a permutation that reproduces the swapped logl
    flat = out_t[1].numpy().astype(int).ravel()
    assert sorted(flat) == list(range(ntemps * nwalkers))
    np.testing.assert_array_equal(logl.ravel()[flat], out_t[0].numpy().ravel())


def test_cascade_wrapper_takes_ref_on_cpu():
    inputs = [torch.from_numpy(x) for x in _inputs(4, 9, 3, seed=2)]
    before = port.pt_swap_cascade_multi.launches
    out = port.pt_swap_cascade_multi(*inputs)
    ref = port.pt_swap_cascade_multi_ref(*inputs)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert port.pt_swap_cascade_multi.launches == before


def test_provenance_capacity_guard():
    port._check_provenance_capacity(2, 2**23 - 1)
    with pytest.raises(ValueError, match="2\\*\\*24"):
        port._check_provenance_capacity(2, 2**23)


# -- the large-ensemble (rolled) cascade, above ROLLED_THRESHOLD walkers --

@pytest.mark.parametrize("shape", [(4, 700, 3), (3, 641, 2), (2, 1000, 7)])
def test_rolled_cascade_ref_bitwise_matches_jax(shape):
    inputs = _inputs(*shape, seed=3)
    out_j = jax_swap._cascade_multi_rolled(
        *[jnp.asarray(x) for x in inputs], interpret=True
    )
    out_t = port._cascade_multi_rolled_ref(*[torch.from_numpy(x) for x in inputs])
    for t, j in zip(out_t, out_j):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    sel = out_t[2].numpy()
    assert 0 < sel.sum() < sel.size
    # a walker whose partner lands on a pad lane never swaps
    nw = shape[1]
    nwpad = -(-nw // 128) * 128
    partner = (np.arange(nw)[None] + inputs[3][:, None]) % nwpad
    assert not sel[partner >= nw].any()


def test_rolled_provenance_cascade_bitwise_matches_jax():
    ntemps, nwalkers = 3, 700
    logl, _, dbetas, shifts, raccept = _inputs(ntemps, nwalkers, 1, seed=4)
    origin = np.arange(ntemps * nwalkers, dtype=np.float32).reshape(
        ntemps, nwalkers
    )
    args = (logl, origin, dbetas, shifts, raccept)
    out_j = jax_swap.pt_swap_cascade_rolled(
        *[jnp.asarray(x) for x in args], interpret=True
    )
    out_t = port.pt_swap_cascade_rolled(*[torch.from_numpy(x) for x in args])
    for t, j in zip(out_t, out_j):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    flat = out_t[1].numpy().astype(int).ravel()
    assert sorted(flat) == list(range(ntemps * nwalkers))


@pytest.mark.parametrize("nwalkers", [100, 640, 641, 700, 1000])
def test_proposals_per_rung_matches_jax(nwalkers):
    shifts = np.random.default_rng(nwalkers).integers(
        0, nwalkers, size=19
    ).astype(np.int32)
    shifts[:2] = (0, nwalkers - 1)
    got = port.proposals_per_rung(nwalkers, torch.from_numpy(shifts),
                                  torch.float32)
    want = jax_swap.proposals_per_rung(nwalkers, jnp.asarray(shifts),
                                       jnp.float32)
    if nwalkers <= port.ROLLED_THRESHOLD:
        # every walker is proposed: a host int, no device op
        assert type(got) is int and got == nwalkers
        got = torch.full(shifts.shape, float(got))
    else:
        assert (got.numpy() < nwalkers).any()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.float32


@pytest.mark.parametrize("nwalkers", [640, 641])
def test_cascade_dispatch_at_the_threshold(nwalkers):
    """Both packages switch to the rolled cascade above 640 walkers: the
    dispatching wrapper agrees with JAX's on either side."""
    inputs = _inputs(3, nwalkers, 2, seed=nwalkers)
    out_j = jax_swap.pt_swap_cascade_multi(
        *[jnp.asarray(x) for x in inputs], interpret=True
    )
    t_in = [torch.from_numpy(x) for x in inputs]
    out_t = port.pt_swap_cascade_multi(*t_in)
    for t, j in zip(out_t, out_j):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    plain = (port._cascade_multi_rolled_ref if nwalkers > 640
             else port.pt_swap_cascade_multi_ref)(*t_in)
    assert all(torch.equal(a, b) for a, b in zip(out_t, plain))


def test_temper_kernel_divides_by_proposed_pairings():
    """Above 640 walkers the kernel cascade proposes fewer pairings than
    walkers; the swap ratios are accepted / proposals_per_rung, reported on
    the nwalkers scale (as eryn_tpu's temper_kernel does)."""
    from eryn_tpu_torch import State, TemperatureControl

    ntemps, nw = 4, 700
    rng = np.random.default_rng(9)
    tc = TemperatureControl(3, nw, ntemps=ntemps, adaptive=False,
                            use_kernels=True)
    pi = torch.from_numpy(rng.permutation(nw))
    shifts = torch.from_numpy(rng.integers(0, nw, ntemps - 1).astype(np.int32))
    raccept = torch.from_numpy(
        np.log(rng.random((ntemps - 1, nw))).astype(np.float32))
    tc.draw_kernel = lambda *args: (pi, shifts, raccept)
    logl = torch.from_numpy((rng.standard_normal((ntemps, nw)) * 5)
                            .astype(np.float32))
    state = State(
        {"m": torch.zeros((ntemps, nw, 1, 2))}, log_like=logl,
        log_prior=torch.zeros((ntemps, nw)),
        betas=torch.tensor(tc.betas, dtype=torch.float32),
    )
    _, swaps, _ = tc.temper_kernel(None, state, 0, adapt=False)
    dbetas = (state.betas[:-1] - state.betas[1:]).contiguous()
    _, _, sel = port._cascade_multi_rolled_ref(
        logl[:, pi], torch.zeros((ntemps, 1, nw)), dbetas, shifts, raccept)
    proposed = port.proposals_per_rung(nw, shifts, torch.float32)
    assert (proposed < nw).all()
    np.testing.assert_array_equal(
        swaps.numpy(), (sel.sum(-1) / proposed * nw).numpy())

    # a stub cascade: 20 accepted out of 50 proposed per rung
    tc.swap_kernel = lambda g, tree, logl, betas: (
        tree, logl, torch.full((ntemps - 1,), 20.0),
        torch.full((ntemps - 1,), 50.0))
    _, swaps, _ = tc.temper_kernel(None, state, 0, adapt=False)
    np.testing.assert_allclose(swaps.numpy(), 20.0 / 50.0 * nw, rtol=1e-6)


def test_rolled_wrapper_takes_ref_on_cpu():
    inputs = [torch.from_numpy(x) for x in _inputs(3, 700, 2, seed=6)]
    before = (port._cascade_multi_rolled.launches,
              port.pt_swap_cascade_multi.launches)
    out = port.pt_swap_cascade_multi(*inputs)
    ref = port._cascade_multi_rolled_ref(*inputs)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert (port._cascade_multi_rolled.launches,
            port.pt_swap_cascade_multi.launches) == before


def test_sampler_swap_fractions_above_the_threshold():
    """At 700 walkers the kernel path (the rolled cascade, its plain
    version here) and the general cascade report the same swap acceptance
    within 0.02: the rolled cascade's accepts are divided by the ~9 % fewer
    pairings it proposes; divided by the walker count they read 0.03 and
    0.06 low here."""
    from eryn_tpu_torch import EnsembleSampler, ProbDistContainer, uniform_dist

    priors = ProbDistContainer({i: uniform_dist(-5.0, 5.0) for i in range(2)})
    coords = np.random.default_rng(0).normal(size=(3, 700, 2))
    fractions = []
    for use_kernels in (True, False):
        sampler = EnsembleSampler(
            700, 2, lambda x: -0.5 * torch.sum(x * x), priors,
            tempering_kwargs=dict(ntemps=3, adaptive=False,
                                  use_kernels=use_kernels),
            seed=2, device="cpu",
        )
        sampler.run_mcmc(coords, 200, burn=50)
        fractions.append(sampler.swap_acceptance_fraction)
    assert (fractions[0] < 1).all() and (fractions[0] > 0.2).all()
    np.testing.assert_allclose(fractions[0], fractions[1], atol=0.02)


# -- the tree form: the whole swap phase of the sampler, from given draws --

def _tree(kind, ntemps, nwalkers, dtype, rng):
    """A one-branch Gaussian tree, or a reversible-jump tree with two
    branches, bool leaf masks and several leaves per walker."""
    if kind == "gaussian":
        shapes = {"model_0": (1, 5)}
    else:
        shapes = {"pulse": (8, 3), "noise": (1, 2)}
    coords = {k: rng.standard_normal((ntemps, nwalkers) + s).astype(dtype)
              for k, s in shapes.items()}
    inds = {k: (np.ones((ntemps, nwalkers, s[0]), bool) if kind == "gaussian"
                else rng.random((ntemps, nwalkers, s[0])) < 0.4)
            for k, s in shapes.items()}
    return {"coords": coords, "inds": inds,
            "log_prior": rng.standard_normal((ntemps, nwalkers)).astype(dtype)}


def _leaves(tree):
    """Leaves in sorted key order, the order of both packages."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _tree_inputs(kind, ntemps, nwalkers, dtype, seed):
    rng = np.random.default_rng(seed)
    logl = (rng.standard_normal((ntemps, nwalkers)) * 10).astype(dtype)
    betas = np.logspace(0, -2, ntemps).astype(dtype)
    return _tree(kind, ntemps, nwalkers, dtype, rng), logl, betas


def _port_tree_cascade(tree, logl, betas, pi, shifts, raccept, want_sel=False):
    """The port's tree-form cascade (its plain version, on the CPU) on numpy
    inputs; returns numpy ``(leaves, logl, accepted[, sel])``."""
    t = torch.from_numpy
    leaves = [t(x) for x in _leaves(tree)]
    out_logl = torch.empty_like(t(logl))
    out_leaves = [torch.empty_like(x) for x in leaves]
    accepted = torch.empty(logl.shape[0] - 1, dtype=out_logl.dtype)
    sel = torch.empty_like(t(raccept)) if want_sel else None
    port.pt_swap_cascade_tree(
        t(logl), leaves, t(betas), t(pi), t(shifts), t(raccept), out_logl,
        out_leaves, accepted, sel)
    out = ([x.numpy() for x in out_leaves], out_logl.numpy(), accepted.numpy())
    return out + (sel.numpy(),) if want_sel else out


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kind", ["gaussian", "rj"])
@pytest.mark.parametrize(
    "shape", [(4, 33), (10, 100), (3, 640), (3, 641), (4, 700), (20, 1000)])
def test_tree_cascade_bitwise_matches_jax_swap_kernel(shape, kind, dtype):
    """The tree-form cascade against eryn_tpu's ``_swap_kernel_pallas``
    (interpret mode), with ``pi``, ``shifts`` and ``raccept`` reproduced from
    the JAX key as that function draws them.  Bitwise: the swapped
    log-likelihood, every leaf (bool masks too) and the accepted counts."""
    import jax

    import eryn_tpu

    ntemps, nwalkers = shape
    tree, logl, betas = _tree_inputs(kind, ntemps, nwalkers, dtype,
                                     seed=ntemps * nwalkers)
    with jax.enable_x64(dtype == np.float64):
        jdtype = jnp.float64 if dtype == np.float64 else jnp.float32
        key = jax.random.PRNGKey(nwalkers)
        jtc = eryn_tpu.moves.TemperatureControl(5, nwalkers, ntemps=ntemps)
        j_tree, j_logl, j_acc, j_prop = jtc._swap_kernel_pallas(
            key, jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(logl),
            jnp.asarray(betas), interpret=True)
        assert j_logl.dtype == jdtype
        # eryn_tpu/moves/tempering.py:551-559
        k_pi, k_shift, k_acc = jax.random.split(key, 3)
        pi = np.asarray(jax.random.permutation(k_pi, nwalkers)).astype(np.int64)
        shifts = np.asarray(
            jax.random.randint(k_shift, (ntemps - 1,), 0, nwalkers)
        ).astype(np.int32)
        raccept = np.array(jnp.log(jax.random.uniform(
            k_acc, (ntemps - 1, nwalkers), dtype=jdtype)))
        j_leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(j_tree)]
        j_logl, j_acc, j_prop = (np.asarray(x) for x in (j_logl, j_acc, j_prop))
    assert raccept.dtype == dtype

    leaves, out_logl, accepted = _port_tree_cascade(
        tree, logl, betas, pi, shifts, raccept)
    np.testing.assert_array_equal(out_logl, j_logl)
    assert len(leaves) == len(j_leaves)
    for got, want in zip(leaves, j_leaves):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(accepted, j_acc)
    assert accepted.dtype == dtype and 0 < accepted.sum() < (ntemps - 1) * nwalkers
    proposed = port.proposals_per_rung(nwalkers, torch.from_numpy(shifts),
                                       torch.from_numpy(logl).dtype)
    if nwalkers > port.ROLLED_THRESHOLD:
        proposed = proposed.numpy()
    np.testing.assert_array_equal(np.broadcast_to(proposed, j_prop.shape), j_prop)


def _composed_channel_cascade(tree, logl, betas, pi, shifts, raccept):
    """The swap phase composed from the channel-form cascade as the JAX
    package composes it: pack every leaf into ``(ntemps, D, nwalkers)``
    channels of the log-likelihood's dtype (bool masks as 0/1), relabel by
    ``pi`` with gathers, cascade, relabel back, unpack."""
    t = torch.from_numpy
    logl, betas, pi = t(logl), t(betas), t(pi)
    ntemps, nwalkers = logl.shape
    leaves = [t(x) for x in _leaves(tree)]
    channels = torch.cat(
        [x.reshape(ntemps, nwalkers, -1).to(logl.dtype).transpose(1, 2)
         for x in leaves], dim=1)
    inv_pi = torch.argsort(pi)
    dbetas = (betas[:-1] - betas[1:]).contiguous()
    logl_res, ch_res, sel = port.pt_swap_cascade_multi(
        logl[:, pi], channels[:, :, pi].contiguous(), dbetas, t(shifts),
        t(raccept))
    ch_res = ch_res[:, :, inv_pi]
    out, off = [], 0
    for x in leaves:
        k = int(np.prod(x.shape[2:]))
        arr = ch_res[:, off:off + k].transpose(1, 2).reshape(x.shape)
        off += k
        out.append((arr > 0.5 if x.dtype == torch.bool else arr).numpy())
    return out, logl_res[:, inv_pi].numpy(), sel.sum(-1).numpy(), sel.numpy()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kind", ["gaussian", "rj"])
@pytest.mark.parametrize("shape", [(4, 33), (10, 100), (3, 641), (20, 1000)])
def test_tree_cascade_equals_composed_channel_cascade(shape, kind, dtype):
    """One launch on the state as it lies gives what packing, two gathers,
    the channel-form cascade, two inverse gathers and unpacking give."""
    ntemps, nwalkers = shape
    tree, logl, betas = _tree_inputs(kind, ntemps, nwalkers, dtype, seed=11)
    rng = np.random.default_rng(12)
    pi = rng.permutation(nwalkers)
    shifts = rng.integers(0, nwalkers, ntemps - 1).astype(np.int32)
    raccept = np.log(rng.random((ntemps - 1, nwalkers))).astype(dtype)
    got = _port_tree_cascade(tree, logl, betas, pi, shifts, raccept,
                             want_sel=True)
    want = _composed_channel_cascade(tree, logl, betas, pi, shifts, raccept)
    for a, b in zip(got[0], want[0]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a, b)
    # the log-likelihood moved: its multiset per pair of rungs is kept
    np.testing.assert_array_equal(np.sort(got[1].ravel()), np.sort(logl.ravel()))
    assert not np.array_equal(got[1], logl)


def test_tree_cascade_moves_integer_leaves_beyond_float_precision():
    """Leaves move as bytes: an int64 leaf with values beyond 2**53 and a
    uint8 leaf come back exact, with the row that held them."""
    ntemps, nwalkers = 5, 40
    rng = np.random.default_rng(3)
    logl = (rng.standard_normal((ntemps, nwalkers)) * 10).astype(np.float32)
    big = (2**60 + np.arange(ntemps * nwalkers * 3, dtype=np.int64)).reshape(
        ntemps, nwalkers, 3)
    tag = np.arange(ntemps * nwalkers, dtype=np.int64).reshape(ntemps, nwalkers)
    small = rng.integers(0, 255, (ntemps, nwalkers, 1, 2)).astype(np.uint8)
    tree = {"a": big, "b": tag, "c": small}
    betas = np.logspace(0, -2, ntemps).astype(np.float32)
    pi = rng.permutation(nwalkers)
    shifts = rng.integers(0, nwalkers, ntemps - 1).astype(np.int32)
    raccept = np.log(rng.random((ntemps - 1, nwalkers))).astype(np.float32)
    (a, b, c), out_logl, accepted = _port_tree_cascade(
        tree, logl, betas, pi, shifts, raccept)
    assert accepted.sum() > 0
    flat = b.ravel()  # the origin of every slot
    assert sorted(flat) == list(range(ntemps * nwalkers))
    np.testing.assert_array_equal(out_logl.ravel(), logl.ravel()[flat])
    np.testing.assert_array_equal(a.reshape(-1, 3), big.reshape(-1, 3)[flat])
    np.testing.assert_array_equal(c.reshape(-1, 2), small.reshape(-1, 2)[flat])


def test_tree_wrapper_takes_ref_on_cpu_and_checks_its_outputs():
    tree, logl, betas = _tree_inputs("rj", 4, 21, np.float32, seed=8)
    rng = np.random.default_rng(8)
    pi = rng.permutation(21)
    shifts = rng.integers(0, 21, 3).astype(np.int32)
    raccept = np.log(rng.random((3, 21))).astype(np.float32)
    before = (port.pt_swap_cascade_multi.launches,
              port._cascade_multi_rolled.launches)
    _port_tree_cascade(tree, logl, betas, pi, shifts, raccept)
    assert (port.pt_swap_cascade_multi.launches,
            port._cascade_multi_rolled.launches) == before
    t = torch.from_numpy
    with pytest.raises(ValueError, match="5 leaves but 0 outputs"):
        port.pt_swap_cascade_tree(
            t(logl), [t(x) for x in _leaves(tree)], t(betas), t(pi),
            t(shifts), t(raccept), torch.empty_like(t(logl)), [],
            torch.empty(3))


@pytest.mark.parametrize("nwalkers", [100, 700])
def test_swap_kernel_is_one_tree_cascade(nwalkers, monkeypatch):
    """``TemperatureControl.swap_kernel`` on the kernel path hands the state's
    own leaves to one tree-form cascade and nothing else of the cascade
    family: no packing, no channel form."""
    from eryn_tpu_torch import TemperatureControl
    from eryn_tpu_torch.moves import tempering

    calls = []
    real = tempering.pt_swap_cascade_tree

    def spy(logl, leaves, *args, **kwargs):
        calls.append([x.dtype for x in leaves])
        return real(logl, leaves, *args, **kwargs)

    monkeypatch.setattr(tempering, "pt_swap_cascade_tree", spy)
    for name in ("pt_swap_cascade_multi", "_cascade_multi_rolled"):
        monkeypatch.setattr(port, name, None)
    ntemps = 4
    tree, logl, betas = _tree_inputs("rj", ntemps, nwalkers, np.float32, seed=1)
    tc = TemperatureControl(3, nwalkers, ntemps=ntemps, use_kernels=True)
    t_tree = {k: ({n: torch.from_numpy(x) for n, x in v.items()}
                  if isinstance(v, dict) else torch.from_numpy(v))
              for k, v in tree.items()}
    out_tree, out_logl, accepted, proposed = tc.swap_kernel(
        torch.Generator().manual_seed(0), t_tree, torch.from_numpy(logl),
        torch.from_numpy(betas))
    assert calls == [[torch.float32, torch.float32, torch.bool, torch.bool,
                      torch.float32]]
    assert out_tree["inds"]["pulse"].dtype == torch.bool
    assert accepted.shape == (ntemps - 1,) and accepted.sum() > 0
    assert (type(proposed) is int) == (nwalkers <= port.ROLLED_THRESHOLD)
    np.testing.assert_array_equal(
        np.sort(out_logl.numpy().ravel()), np.sort(logl.ravel()))


def test_grid_and_shared_memory_sizing():
    """The grid stays within 128 blocks of at least 8 walkers, and the
    shared-memory form covers this repo's ensembles in both dtypes; beyond
    a block's shared memory the launch takes the global-memory form."""
    assert [port._chunk_walkers(n) for n in (33, 100, 1000, 1024, 1025, 4001)
            ] == [8, 8, 8, 8, 9, 32]
    for itemsize in (4, 8):
        assert port._shared_bytes(20, 1000, 8, itemsize) < port.SHARED_LIMIT
        assert port._shared_bytes(10, 200, 200, itemsize) < port.SHARED_LIMIT
    assert port._shared_bytes(3, 1500, 12, 8) < port.SHARED_LIMIT
    assert port._shared_bytes(3, 4001, 32, 8) > port.SHARED_LIMIT
    # a chunk wider than the ensemble is the ensemble
    assert (port._shared_bytes(4, 50, 10**6, 4)
            == port._shared_bytes(4, 50, 50, 4))
