"""The plain PyTorch versions of the stretch kernels against the JAX package's
Pallas kernels (interpret mode on the CPU), on the same numpy inputs.

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
    q_t, fac_t = port.stretch_propose_ref(
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


@pytest.mark.parametrize("log_proposal", [False, True])
def test_stretch_propose_wrapper_takes_ref_on_cpu(log_proposal):
    args = [torch.from_numpy(x) for x in _propose_inputs(SHAPES[0], seed=3)]
    before = port.stretch_propose.launches
    q, fac = port.stretch_propose(*args, log_proposal=log_proposal)
    q_r, fac_r = port.stretch_propose_ref(*args, log_proposal=log_proposal)
    assert torch.equal(q, q_r) and torch.equal(fac, fac_r)
    assert port.stretch_propose.launches == before  # no kernel launch


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
    out_t = port.stretch_accept_ref(*[torch.from_numpy(x) for x in inputs])
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
    out = port.stretch_accept_ref(
        *[torch.from_numpy(x) for x in
          (q, s, ll_new, lp_new, ll_old, lp_old, fac, betas, u)]
    )
    acc = out[3].numpy()
    assert not acc.any()
    # with equal finite posteriors, u = 0.5 accepts everywhere
    ll_new[:] = ll_old[:] = 0.0
    lp_new[:] = lp_old[:] = 0.0
    out = port.stretch_accept_ref(
        *[torch.from_numpy(x) for x in
          (q, s, ll_new, lp_new, ll_old, lp_old, fac, betas, u)]
    )
    assert out[3].numpy().all()
