"""The CUDA kernels against their plain PyTorch versions on the card, and a
short sampler run through them.  These need a CUDA device and the CUDA
toolkit; without a card they skip.  On a GPU machine::

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest``: the suite's conftest imports jax, which this file does
not need.)

Tolerances: the swap cascades, the accept kernel and the selection kernel
only select and move values, so their outputs must be bitwise equal to the
plain versions'; the proposal's floats agree within 1e-6 (float32) or 1e-12
(float64), a few ulp of ``exp``/``log``.
"""

import numpy as np
import pytest
import torch

from eryn_tpu_torch.ops import pt_swap, select_kernels, stretch_kernels as sk

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 1e-6, torch.float64: 1e-12}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _gen():
    return torch.Generator().manual_seed(0)


def _randn(g, dtype, *shape):
    return torch.randn(shape, generator=g, dtype=torch.float64).to("cuda", dtype)


def _rand(g, dtype, *shape):
    return torch.rand(shape, generator=g, dtype=torch.float64).to("cuda", dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(10, 50, 50, 5), (20, 500, 500, 5),
                                   (8, 50, 49, 13)])
@pytest.mark.parametrize("log_proposal", [False, True])
def test_stretch_propose_kernel(cuda, dtype, shape, log_proposal):
    nt, ns, nc, D = shape
    g = _gen()
    s, c = _randn(g, dtype, nt, ns, D), _randn(g, dtype, nt, nc, D)
    nd = torch.full((nt, ns), float(D), dtype=dtype, device=cuda)
    u = _rand(g, dtype, 2, nt, ns)
    before = sk.stretch_propose.launches
    out = sk.stretch_propose(s, c, nd, u, 2.0, log_proposal)
    ref = sk.stretch_propose_ref(s, c, nd, u, 2.0, log_proposal)
    torch.cuda.synchronize()
    assert sk.stretch_propose.launches == before + 1
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(10, 50, 5), (20, 500, 5), (8, 49, 13)])
def test_stretch_accept_kernel(cuda, dtype, shape):
    nt, ns, D = shape
    g = _gen()
    ll_new, ll_old = _randn(g, dtype, nt, ns), _randn(g, dtype, nt, ns)
    ll_new[0, :3] = float("nan")
    ll_new[1, :3] = float("-inf")
    lp = torch.zeros((nt, ns), dtype=dtype, device=cuda)
    betas = torch.linspace(1.0, 0.0, nt, dtype=dtype, device=cuda)
    args = (_randn(g, dtype, nt, ns, D), _randn(g, dtype, nt, ns, D), ll_new,
            lp, ll_old, lp.clone(), _randn(g, dtype, nt, ns) * 0.5, betas,
            _rand(g, dtype, nt, ns))
    out = sk.stretch_accept(*args)
    ref = sk.stretch_accept_ref(*args)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(10, 100, 7), (8, 99, 13), (3, 1500, 2)])
def test_pt_swap_kernel_bitwise(cuda, dtype, shape):
    nt, nw, D = shape
    g = _gen()
    betas = torch.logspace(0, -2, nt, dtype=dtype, device=cuda)
    args = (
        _randn(g, dtype, nt, nw) * 10, _randn(g, dtype, nt, D, nw),
        (betas[:-1] - betas[1:]).contiguous(),
        torch.randint(0, nw, (nt - 1,), generator=g, dtype=torch.int32).cuda(),
        torch.log(_rand(g, dtype, nt - 1, nw)),
    )
    out = pt_swap.pt_swap_cascade_multi(*args)
    # above 640 walkers the wrapper dispatches to the rolled cascade
    plain = (pt_swap._cascade_multi_rolled_ref if nw > pt_swap.ROLLED_THRESHOLD
             else pt_swap.pt_swap_cascade_multi_ref)
    ref = plain(*args)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(20, 1000, 7), (3, 641, 5), (2, 2100, 3)])
def test_rolled_cascade_kernel_bitwise(cuda, dtype, shape):
    nt, nw, D = shape
    g = _gen()
    betas = torch.logspace(0, -2, nt, dtype=dtype, device=cuda)
    args = (
        _randn(g, dtype, nt, nw) * 10, _randn(g, dtype, nt, D, nw),
        (betas[:-1] - betas[1:]).contiguous(),
        torch.randint(0, nw, (nt - 1,), generator=g, dtype=torch.int32).cuda(),
        torch.log(_rand(g, dtype, nt - 1, nw)),
    )
    before = (pt_swap._cascade_multi_rolled.launches,
              pt_swap.pt_swap_cascade_multi.launches)
    out = pt_swap._cascade_multi_rolled(*args)
    ref = pt_swap._cascade_multi_rolled_ref(*args)
    torch.cuda.synchronize()
    assert (pt_swap._cascade_multi_rolled.launches,
            pt_swap.pt_swap_cascade_multi.launches) == (before[0] + 1, before[1])
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert 0 < out[2].sum() < out[2].numel()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(10, 800, 800, 3), (2, 130, 257, 3),
                                   (1, 1, 1, 1)])
def test_onehot_select_kernel(cuda, dtype, shape):
    nt, Q, M, nd = shape
    g = _gen()
    m = (torch.rand((nt, M), generator=g) < 0.4).to(dtype)
    m[-1] = 0  # an empty active complement
    cs = torch.cumsum(m, dim=-1)
    kq = torch.floor(torch.rand((nt, Q), generator=g, dtype=dtype)
                     * m.sum(-1).clamp(min=1)[:, None])
    kq[:, ::7] = -1.0
    c_clean = torch.randn((nt, M, nd), generator=g, dtype=dtype) * m[..., None]
    args = [x.to(cuda).contiguous() for x in (cs, kq, c_clean)]
    before = select_kernels.onehot_select.launches
    out = select_kernels.onehot_select(*args)
    ref = select_kernels.onehot_select_ref(*args)
    torch.cuda.synchronize()
    assert select_kernels.onehot_select.launches == before + 1
    assert torch.equal(out, ref)
    assert torch.equal(out.cpu(), select_kernels.onehot_select_ref(cs, kq, c_clean))


def test_wrapper_rejects_bad_input(cuda):
    s = torch.zeros((2, 4, 3), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        sk.stretch_propose(s.transpose(0, 1), s.transpose(0, 1),
                           torch.ones((4, 2), device=cuda),
                           torch.rand((2, 4, 2), device=cuda))
    with pytest.raises(TypeError, match="dtype"):
        sk.stretch_propose(s, s, torch.ones((2, 4), device=cuda,
                                            dtype=torch.float64),
                           torch.rand((2, 2, 4), device=cuda))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sampler_runs_through_the_kernels(cuda, dtype):
    from eryn_tpu_torch import (
        DeviceBackend, EnsembleSampler, ProbDistContainer, uniform_dist,
    )

    priors = ProbDistContainer({i: uniform_dist(-5.0, 5.0) for i in range(3)})
    sampler = EnsembleSampler(
        33, 3, lambda x: -0.5 * torch.sum(x * x), priors,
        tempering_kwargs=dict(ntemps=4), seed=0, device=cuda, dtype=dtype,
    )
    assert isinstance(sampler.backend, DeviceBackend)
    counts = [k.launches for k in
              (sk.stretch_propose, sk.stretch_accept, pt_swap.pt_swap_cascade_multi)]
    coords = priors.rvs(size=(4, 33), generator=torch.Generator(cuda).manual_seed(1))
    sampler.run_mcmc(coords, 400, burn=100)
    after = [k.launches for k in
             (sk.stretch_propose, sk.stretch_accept, pt_swap.pt_swap_cascade_multi)]
    assert [a - b for a, b in zip(after, counts)] == [1000, 1000, 500]
    cold = sampler.get_chain(temp_index=0)["model_0"].reshape(-1, 3)
    assert cold.dtype == (np.float32 if dtype == torch.float32 else np.float64)
    assert np.all(np.abs(cold.mean(0)) < 0.2)
    assert np.all(np.isfinite(sampler.get_autocorr_time()["model_0"]))


def test_rj_sampler_runs_through_the_kernels(cuda):
    """Reversible jump with the group stretch on the card: two selection
    launches (one per half) and two cascades (after the in-model and the RJ
    move) per step."""
    from eryn_tpu_torch import EnsembleSampler, ProbDistContainer, uniform_dist
    from eryn_tpu_torch.moves import RedBlueGroupStretchMove

    pr = ProbDistContainer({i: uniform_dist(-1.0, 1.0) for i in range(2)})
    sampler = EnsembleSampler(
        32, 2, lambda c, i: torch.zeros((), device=cuda), pr, nleaves_max=3,
        moves=RedBlueGroupStretchMove(live_dangerously=True), rj_moves=True,
        tempering_kwargs=dict(ntemps=3), fill_zero_leaves_val=0.0, seed=0,
        device=cuda,
    )
    coords = pr.rvs(size=(3, 32, 3), generator=torch.Generator(cuda).manual_seed(1))
    kernels = (select_kernels.onehot_select, pt_swap.pt_swap_cascade_multi)
    counts = [k.launches for k in kernels]
    sampler.run_mcmc(coords, 200, burn=50)
    after = [k.launches for k in kernels]
    assert [a - b for a, b in zip(after, counts)] == [500, 500]
    k = sampler.get_nleaves()["model_0"][:, 0]
    assert set(np.unique(k)) == {0, 1, 2, 3}
    assert 0 < sampler.rj_acceptance_fraction.mean() < 1
