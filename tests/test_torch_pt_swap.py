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
