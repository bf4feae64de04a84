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
