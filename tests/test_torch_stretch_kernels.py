"""The plain PyTorch versions of the stretch kernels against the JAX package's
Pallas kernels (interpret mode on the CPU), on the same numpy inputs.

Two forms are held to JAX: the block form (``stretch_*_block``, one
contiguous half, the JAX kernels' own signature), and the port's plain
kernels, which address the walker-order state through the permutation and
merge in place (``stretch_propose_ref``, ``stretch_accept_propose_ref``,
``stretch_accept_ref``), against the JAX kernels composed with ``X[:, perm]``
and the inverse gather as ``eryn_tpu/moves/stretch.py`` composes them.

Tolerances: accept decisions and the values they select are compared
exactly (the selection only moves values).  Proposed coordinates and
detailed-balance factors agree within rtol 1e-6 (about 8 float32 ulp): the
two libraries' ``exp``/``log`` and operation fusion round differently.  An
atol of 1e-6 covers factors near zero, where ``log z`` of ``z`` close to 1 is
tiny and its error is absolute.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from eryn_tpu.ops import stretch_kernels as jax_kernels
from eryn_tpu_torch.ops import stretch_kernels as port

torch.set_num_threads(1)

# (nt, ns, nc, D): a small block, and the odd halves of 99 walkers
SHAPES = [(3, 8, 8, 4), (4, 50, 49, 5)]


def _propose_inputs(shape, seed=0):
    nt, ns, nc, D = shape
    rng = np.random.default_rng(seed)
    s = rng.standard_normal((nt, ns, D)).astype(np.float32)
    c = rng.standard_normal((nt, nc, D)).astype(np.float32)
    ndim_act = rng.integers(1, D + 1, (nt, ns)).astype(np.float32)
    u = rng.random((2, nt, ns)).astype(np.float32)
    return s, c, ndim_act, u


@pytest.mark.parametrize("log_proposal", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_stretch_propose_ref_matches_jax(shape, log_proposal):
    s, c, ndim_act, u = _propose_inputs(shape)
    q_j, fac_j = jax_kernels.stretch_propose(
        jnp.asarray(s), jnp.asarray(c), jnp.asarray(ndim_act), jnp.asarray(u),
        a=2.0, interpret=True, log_proposal=log_proposal,
    )
    q_t, fac_t = port.stretch_propose_block(
        torch.from_numpy(s), torch.from_numpy(c), torch.from_numpy(ndim_act),
        torch.from_numpy(u), a=2.0, log_proposal=log_proposal,
    )
    np.testing.assert_allclose(q_t.numpy(), np.asarray(q_j), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        fac_t.numpy(), np.asarray(fac_j), rtol=1e-6, atol=1e-6
    )
    # the complement pick is a decision: every proposal lies on the ray to
    # the row floor(u1 * nc), in both packages
    nc = c.shape[1]
    rint = np.floor(u[1] * np.float32(nc)).astype(int)
    c_pick = np.take_along_axis(c, rint[:, :, None], axis=1)
    z = (q_t.numpy() - c_pick) / (s - c_pick)
    assert np.allclose(z, z[:, :, :1], rtol=1e-4, atol=1e-4)


def _accept_inputs(nt, ns, D, seed=1):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    q = rng.standard_normal((nt, ns, D)).astype(f32)
    s = rng.standard_normal((nt, ns, D)).astype(f32)
    ll_new = (rng.standard_normal((nt, ns)) * 3).astype(f32)
    ll_old = (rng.standard_normal((nt, ns)) * 3).astype(f32)
    lp_new = np.zeros((nt, ns), f32)
    lp_old = np.zeros((nt, ns), f32)
    # NaN and -inf likelihoods, and an out-of-support proposal
    ll_new[0, :3] = np.nan
    ll_new[1, :3] = -np.inf
    ll_old[1, 3:5] = -np.inf
    lp_new[2, 0] = -np.inf
    fac = (rng.standard_normal((nt, ns)) * 0.5).astype(f32)
    betas = np.linspace(1.0, 0.0, nt).astype(f32)  # the hottest rung is beta=0
    u = rng.random((nt, ns)).astype(f32)
    return q, s, ll_new, lp_new, ll_old, lp_old, fac, betas, u


@pytest.mark.parametrize("shape", [(4, 16, 3), (5, 50, 5)])
def test_stretch_accept_ref_matches_jax(shape):
    inputs = _accept_inputs(*shape)
    out_j = jax_kernels.stretch_accept(
        *[jnp.asarray(x) for x in inputs], interpret=True
    )
    out_t = port.stretch_accept_block(*[torch.from_numpy(x) for x in inputs])
    coords_j, ll_j, lp_j, acc_j = (np.asarray(x) for x in out_j)
    coords_t, ll_t, lp_t, acc_t = (x.numpy() for x in out_t)
    np.testing.assert_array_equal(acc_t, acc_j)
    assert 0 < acc_t.sum() < acc_t.size
    np.testing.assert_array_equal(coords_t, coords_j)
    np.testing.assert_array_equal(ll_t, ll_j)
    np.testing.assert_array_equal(lp_t, lp_j)


def test_stretch_accept_nan_rules():
    """A NaN proposal likelihood never accepts, at any beta; at beta = 0 a
    -inf proposal likelihood tempers to NaN (0 * -inf), which the guard
    turns into -inf, so the proposal is rejected."""
    q, s, ll_new, lp_new, ll_old, lp_old, fac, betas, u = _accept_inputs(3, 6, 2)
    ll_new[:] = np.nan
    ll_new[2] = -np.inf
    betas[:] = [1.0, 0.5, 0.0]
    fac[:] = 0.0
    u[:] = 0.5
    out = port.stretch_accept_block(
        *[torch.from_numpy(x) for x in
          (q, s, ll_new, lp_new, ll_old, lp_old, fac, betas, u)]
    )
    acc = out[3].numpy()
    assert not acc.any()
    # with equal finite posteriors, u = 0.5 accepts everywhere
    ll_new[:] = ll_old[:] = 0.0
    lp_new[:] = lp_old[:] = 0.0
    out = port.stretch_accept_block(
        *[torch.from_numpy(x) for x in
          (q, s, ll_new, lp_new, ll_old, lp_old, fac, betas, u)]
    )
    assert out[3].numpy().all()


# ----------------------------------------------------------------------
# the port's plain kernels: addressed through the permutation, merged in
# place in walker order
# ----------------------------------------------------------------------
NT, D = 4, 5


def _step_inputs(nw, seed):
    """Walker-order state, draws, and the likelihood and prior values of
    each half's proposals (drawn here, so both packages see the same)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    n0 = nw - nw // 2
    state = dict(
        X=rng.standard_normal((NT, nw, D)).astype(f32),
        logl=(rng.standard_normal((NT, nw)) * 3).astype(f32),
        logp=rng.standard_normal((NT, nw)).astype(f32),
        ndim_act=rng.integers(1, D + 1, (NT, nw)).astype(f32),
        perm=rng.permutation(nw),
        u_all=rng.random((2, 3, NT, nw)).astype(f32),
        betas=np.linspace(1.0, 0.0, NT).astype(f32),  # hottest rung beta=0
    )
    new = []
    for ns in (n0, nw - n0):
        ll = (rng.standard_normal((NT, ns)) * 3).astype(f32)
        lp = np.zeros((NT, ns), f32)
        ll[0, :2] = np.nan  # never accepts
        ll[-1, :2] = -np.inf  # tempers to NaN at beta = 0
        lp[1, 0] = -np.inf  # out of support
        new.append((ll, lp))
    return state, new


def _jax_composed(st, new, log_proposal):
    """eryn_tpu/moves/stretch.py's composition: permuted layout, contiguous
    halves, one inverse gather at the end."""
    perm = st["perm"]
    nw = perm.shape[0]
    n0 = nw - nw // 2
    Xp = jnp.asarray(st["X"])[:, perm]
    logl_p = jnp.asarray(st["logl"])[:, perm]
    logp_p = jnp.asarray(st["logp"])[:, perm]
    nd_p = jnp.asarray(st["ndim_act"])[:, perm]
    u_all = jnp.asarray(st["u_all"])
    props, outs = [], []
    for half, (off, ns) in enumerate(((0, n0), (n0, nw - n0))):
        blk = slice(off, off + ns)
        s_blk = Xp[:, blk]
        c_blk = jnp.concatenate([Xp[:, :off], Xp[:, off + ns:]], axis=1)
        q, fac = jax_kernels.stretch_propose(
            s_blk, c_blk, nd_p[:, blk], u_all[half, :2, :, :ns], a=2.0,
            interpret=True, log_proposal=log_proposal,
        )
        ll_new, lp_new = new[half]
        coords, ll, lp, acc = jax_kernels.stretch_accept(
            q, s_blk, jnp.asarray(ll_new), jnp.asarray(lp_new),
            logl_p[:, blk], logp_p[:, blk], fac, jnp.asarray(st["betas"]),
            u_all[half, 2, :, :ns], interpret=True,
        )
        Xp = Xp.at[:, blk].set(coords)
        props.append((q, fac))
        outs.append((ll, lp, acc))
    inv = np.argsort(perm)
    ll, lp, acc = (jnp.concatenate(x, axis=1)[:, inv] for x in zip(*outs))
    return props, tuple(np.asarray(x) for x in (Xp[:, inv], ll, lp, acc))


def _port_composed(st, new, log_proposal, outs=None):
    """The fused path's three calls on the plain versions; outputs start as
    NaN so an entry no half writes would show."""
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in st.items()}
    X = t["X"]
    if outs is None:
        outs = (torch.full_like(X, np.nan),
                *(torch.full_like(t["logl"], np.nan) for _ in range(3)))
    (ll0, lp0), (ll1, lp1) = [
        [torch.from_numpy(x) for x in pair] for pair in new
    ]
    q0, f0 = port.stretch_propose_ref(
        X, X, t["ndim_act"], t["perm"], t["u_all"], 0, 2.0, log_proposal
    )
    q1, f1 = port.stretch_accept_propose_ref(
        q0, X, ll0, lp0, t["logl"], t["logp"], f0, t["betas"], t["ndim_act"],
        t["perm"], t["u_all"], *outs, 2.0, log_proposal,
    )
    port.stretch_accept_ref(
        q1, X, ll1, lp1, t["logl"], t["logp"], f1, t["betas"], t["perm"],
        t["u_all"], 1, *outs,
    )
    return [(q0, f0), (q1, f1)], tuple(x.numpy() for x in outs)


@pytest.mark.parametrize("log_proposal", [False, True])
@pytest.mark.parametrize("nw", [32, 33, 99])
def test_permuted_plain_versions_match_jax_composition(nw, log_proposal):
    st, new = _step_inputs(nw, seed=nw)
    props_j, out_j = _jax_composed(st, new, log_proposal)
    props_t, out_t = _port_composed(st, new, log_proposal)
    for (q_j, f_j), (q_t, f_t) in zip(props_j, props_t):
        np.testing.assert_allclose(q_t.numpy(), np.asarray(q_j), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=1e-6,
                                   atol=1e-6)
    X_j, ll_j, lp_j, acc_j = out_j
    X_t, ll_t, lp_t, acc_t = out_t
    # decisions, and the values they select, exactly
    np.testing.assert_array_equal(acc_t, acc_j)
    assert 0 < acc_t.sum() < acc_t.size
    np.testing.assert_array_equal(ll_t, ll_j)
    np.testing.assert_array_equal(lp_t, lp_j)
    # every walker was written by exactly one half
    assert np.isfinite(X_t).all()
    np.testing.assert_allclose(X_t, X_j, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("nw", [32, 33, 99])
def test_accept_propose_ref_equals_accept_then_propose(nw):
    st, new = _step_inputs(nw, seed=nw + 1)
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in st.items()}
    ll0, lp0 = (torch.from_numpy(x) for x in new[0])
    q0, f0 = port.stretch_propose_ref(t["X"], t["X"], t["ndim_act"], t["perm"],
                                      t["u_all"], 0)
    results = []
    for fused in (True, False):
        outs = (torch.zeros_like(t["X"]),
                *(torch.zeros_like(t["logl"]) for _ in range(3)))
        acc_args = (q0, t["X"], ll0, lp0, t["logl"], t["logp"], f0, t["betas"])
        if fused:
            q1, f1 = port.stretch_accept_propose_ref(
                *acc_args, t["ndim_act"], t["perm"], t["u_all"], *outs,
            )
        else:
            port.stretch_accept_ref(*acc_args, t["perm"], t["u_all"], 0, *outs)
            q1, f1 = port.stretch_propose_ref(
                t["X"], outs[0], t["ndim_act"], t["perm"], t["u_all"], 1,
            )
        results.append((q1, f1, *outs))
    for a, b in zip(*results):
        assert torch.equal(a, b)
    # half 1's complement rows are the merged half 0, not the old state
    n0 = nw - nw // 2
    assert not torch.equal(results[0][2][:, t["perm"][:n0]],
                           t["X"][:, t["perm"][:n0]])


@pytest.mark.parametrize("log_proposal", [False, True])
def test_stretch_propose_wrapper_takes_ref_on_cpu(log_proposal):
    st, _ = _step_inputs(33, seed=3)
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in st.items()}
    args = (t["X"], t["X"], t["ndim_act"], t["perm"], t["u_all"])
    before = port.stretch_propose.launches
    for half in (0, 1):
        q, fac = port.stretch_propose(*args, half, log_proposal=log_proposal)
        q_r, fac_r = port.stretch_propose_ref(*args, half,
                                              log_proposal=log_proposal)
        assert torch.equal(q, q_r) and torch.equal(fac, fac_r)
        assert q.shape == (NT, 17 - half, D)
    assert port.stretch_propose.launches == before  # no kernel launch


def test_stretch_accept_wrappers_take_ref_on_cpu():
    """``stretch_accept`` and ``stretch_accept_propose`` on CPU tensors
    write what their plain versions write, and launch nothing."""
    st, new = _step_inputs(33, seed=4)
    before = (port.stretch_accept.launches,
              port.stretch_accept_propose.launches)
    _, via_ref = _port_composed(st, new, False)
    # the same composition through the wrappers
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in st.items()}
    X = t["X"]
    outs = (torch.full_like(X, np.nan),
            *(torch.full_like(t["logl"], np.nan) for _ in range(3)))
    (ll0, lp0), (ll1, lp1) = [[torch.from_numpy(x) for x in p] for p in new]
    q0, f0 = port.stretch_propose(X, X, t["ndim_act"], t["perm"], t["u_all"], 0)
    q1, f1 = port.stretch_accept_propose(
        q0, X, ll0, lp0, t["logl"], t["logp"], f0, t["betas"], t["ndim_act"],
        t["perm"], t["u_all"], *outs,
    )
    assert port.stretch_accept(
        q1, X, ll1, lp1, t["logl"], t["logp"], f1, t["betas"], t["perm"],
        t["u_all"], 1, *outs,
    ) is None
    for a, b in zip(outs, via_ref):
        np.testing.assert_array_equal(a.numpy(), b)
    assert (port.stretch_accept.launches,
            port.stretch_accept_propose.launches) == before


def test_half_must_be_0_or_1():
    st, _ = _step_inputs(8, seed=5)
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in st.items()}
    with pytest.raises(ValueError, match="half must be 0 or 1"):
        port.stretch_propose(t["X"], t["X"], t["ndim_act"], t["perm"],
                             t["u_all"], 2)
