#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``eryn_tpu_torch``) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA Hopper GPU and
the CUDA toolkit::

    python3 chip_smoke.py [--out report.json]

Phases, each printing its own lines:

1. device: the card's name and ``nvidia-smi`` name and power limit;
2. build: the CUDA kernels from ``eryn_tpu_torch/csrc`` (one ``nvcc`` per
   source, in parallel);
3. kernels: each of the five kernels against its plain PyTorch version on
   the card, in float32 and float64, at the main path's shapes and at odd
   shapes, then each kernel's time beside its plain version's, its bound
   (bytes over the memory rate against operations over the peak rate) and
   the time of one empty launch;
4. main path, four legs through ``EnsembleSampler``, each with the launch
   counters set to 0 just before it and read just after:

   * north-star (10 temperatures x 100 walkers, 5-D Gaussian): a run without
     storing, a stored run into ``Backend()``, and a stored run into the
     default ``DeviceBackend`` followed by ``get_autocorr_time``;
   * config E (20 x 1000, 5-D Gaussian, ``bench.py``): every step through
     the large-ensemble cascade;
   * LISA-style reversible jump (10 x 200 walkers, up to 8 Gaussian-pulse
     leaves, 8192-point template, ``benchmarks/lisa_style.py``): the group
     stretch through the selection kernel, births and deaths, and the pulse
     found in the data;
   * a flat-likelihood RJ run (64 walkers, 3 leaves): a uniform leaf-count
     posterior.  It checks the RJ moves, is not part of the main path, and
     its launches stay out of the report.

   The launch counters must show that every step went through the kernels,
   and each chain must meet its target.

The second-to-last line of standard output is a JSON object describing the
kernels, the last ``{"ok": true, "device": {...}}``.  Any failure raises and
exits nonzero; without CUDA, or outside a checkout, it exits 2 and prints no
result.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

NT, NW, NDIM = 10, 100, 5
NOSTORE_STEPS = 2000
STORED_STEPS = 1500
WARM_STEPS = 300
# config E (bench.py:278-308)
E_NT, E_NW, E_STEPS, E_WARM = 20, 1000, 1500, 300
# LISA-style RJ (benchmarks/lisa_style.py:36-96, heavy=True)
L_NPTS, L_NLMAX, L_NT, L_NW, L_STEPS, L_WARM = 8192, 8, 10, 200, 2000, 100
# float32: a few ulp (exp/log of the two code paths may differ); float64
# likewise scaled
TOL = {"float32": 1e-6, "float64": 1e-12}
# H100 SXM: HBM3 rate, and the float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def _time_ms(fn, reps=200):
    """Mean device time of one call, from CUDA events around ``reps``
    back-to-back calls after a warm-up."""
    import torch

    for _ in range(10):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _max_err(a, b):
    a, b = a.double(), b.double()
    same = (a == b) | (a.isnan() & b.isnan())  # equal infs, or both NaN
    diff = (a - b).abs().masked_fill(same, 0.0)
    return float(diff.max()) if diff.numel() else 0.0


def _cascade_args(torch, rand, randn, gen, nt, nw, D, dtype):
    betas = torch.logspace(0, -2, nt, dtype=dtype, device="cuda")
    return (
        randn(nt, nw) * 10, randn(nt, D, nw),
        (betas[:-1] - betas[1:]).contiguous(),
        torch.randint(0, nw, (nt - 1,), generator=gen,
                      dtype=torch.int32).cuda(),
        torch.log(rand(nt - 1, nw)),
    )


def _select_args(torch, rand, randn, nt, Q, M, nd, empty_last=True):
    """Counts, queries and zeroed payload as the group-stretch move makes
    them; with ``empty_last`` the last temperature has no active entry."""
    u = rand(nt, M)
    m = (u < 0.4).to(u.dtype)
    if empty_last:
        m[-1] = 0
    cs = torch.cumsum(m, dim=-1)
    kq = torch.floor(rand(nt, Q) * m.sum(-1).clamp(min=1)[:, None])
    return cs, kq, (randn(nt, M, nd) * m[..., None]).contiguous()


def check_kernels(torch, dtype_name):
    """Every kernel against its plain version at the path's and odd shapes;
    returns ``{kernel: max_abs_err}``."""
    from eryn_tpu_torch.ops import pt_swap, select_kernels, stretch_kernels as sk

    dtype = getattr(torch, dtype_name)
    tol = TOL[dtype_name]
    gen = torch.Generator().manual_seed(1234)
    errs = {}

    def rand(*shape):
        return torch.rand(shape, generator=gen, dtype=torch.float64).to(
            device="cuda", dtype=dtype
        )

    def randn(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float64).to(
            device="cuda", dtype=dtype
        )

    def record(name, outs_k, outs_r):
        errs[name] = max([errs.get(name, 0.0)]
                         + [_max_err(a, b) for a, b in zip(outs_k, outs_r)])

    # (nt, ns, nc, D): the north-star and config E halves, and an odd shape
    for nt, ns, nc, D in ((NT, NW // 2, NW // 2, NDIM),
                          (E_NT, E_NW // 2, E_NW // 2, NDIM), (8, 50, 49, 13)):
        s, c = randn(nt, ns, D), randn(nt, nc, D)
        ndim_act = torch.full((nt, ns), float(D), dtype=dtype, device="cuda")
        u = rand(2, nt, ns)
        for log_proposal in (False, True):
            q_k, f_k = sk.stretch_propose(s, c, ndim_act, u, 2.0, log_proposal)
            q_r, f_r = sk.stretch_propose_ref(s, c, ndim_act, u, 2.0, log_proposal)
            # a different complement pick would move q by O(1), far
            # outside the tolerance: q agreeing means the picks agree
            torch.testing.assert_close(q_k, q_r, rtol=tol, atol=tol)
            torch.testing.assert_close(f_k, f_r, rtol=tol, atol=tol)
            record("stretch_propose", (q_k, f_k), (q_r, f_r))

        ll_new, ll_old = randn(nt, ns) * 3, randn(nt, ns) * 3
        ll_new[0, :3] = float("nan")
        ll_new[1, :3] = float("-inf")
        lp_new = torch.zeros((nt, ns), dtype=dtype, device="cuda")
        lp_old = torch.zeros_like(lp_new)
        lp_new[2, 0] = float("-inf")
        betas = torch.linspace(1.0, 0.0, nt, dtype=dtype, device="cuda")
        args = (randn(nt, ns, D), s, ll_new, lp_new, ll_old, lp_old,
                randn(nt, ns) * 0.5, betas, rand(nt, ns))
        out_k = sk.stretch_accept(*args)
        out_r = sk.stretch_accept_ref(*args)
        # accept decisions identical, and the selected values equal
        for a, b in zip(out_k, out_r):
            torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
        record("stretch_accept", out_k, out_r)

    # the cascades only move values: bitwise equal
    cascades = (
        ("pt_swap_cascade_multi", pt_swap.pt_swap_cascade_multi,
         pt_swap.pt_swap_cascade_multi_ref,
         ((NT, NW, NDIM + 2), (L_NT, L_NW, 4 * L_NLMAX + 1), (8, 99, 13))),
        ("_cascade_multi_rolled", pt_swap._cascade_multi_rolled,
         pt_swap._cascade_multi_rolled_ref,
         ((E_NT, E_NW, NDIM + 2), (3, 641, 5))),
    )
    for name, kernel, plain, shapes in cascades:
        for nt, nw, D in shapes:
            args = _cascade_args(torch, rand, randn, gen, nt, nw, D, dtype)
            out_k, out_r = kernel(*args), plain(*args)
            for a, b in zip(out_k, out_r):
                assert torch.equal(a, b), f"{name} is not bitwise"
            assert 0 < out_k[2].sum() < out_k[2].numel()
            record(name, out_k, out_r)

    # the selection only moves values: equal (a -0.0 may stand for +0.0)
    half = L_NW // 2 * L_NLMAX
    for nt, Q, M, nd in ((L_NT, half, half, 3), (2, 130, 257, 3)):
        args = _select_args(torch, rand, randn, nt, Q, M, nd)
        out_k = select_kernels.onehot_select(*args)
        out_r = select_kernels.onehot_select_ref(*args)
        assert torch.equal(out_k, out_r), "onehot_select disagrees"
        assert out_k[0].any() and not out_k[-1].any()
        record("onehot_select", (out_k,), (out_r,))
    torch.cuda.synchronize()
    return errs


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def time_kernels(torch):
    """Each kernel and its plain version at the main path's shapes, float32,
    with its bound: ``(ms, plain_ms, bound_ms, bound_by)``."""
    from eryn_tpu_torch.ops import pt_swap, select_kernels, stretch_kernels as sk

    g = torch.Generator(device="cuda").manual_seed(7)
    f32 = dict(device="cuda", dtype=torch.float32)

    def rand(*shape):
        return torch.rand(shape, generator=g, **f32)

    def randn(*shape):
        return torch.randn(shape, generator=g, **f32)

    def bound(nbytes, ops):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / F32_OPS_PER_S * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    out = {}
    # the north-star halves, and config E's under a name of their own
    for tag, nt, ns in (("", NT, NW // 2), ("@E", E_NT, E_NW // 2)):
        s, c, u = rand(nt, ns, NDIM), rand(nt, ns, NDIM), rand(2, nt, ns)
        nd = torch.full((nt, ns), float(NDIM), **f32)
        q, fac = sk.stretch_propose(s, c, nd, u)
        acc_args = (rand(nt, ns, NDIM), s, rand(nt, ns), rand(nt, ns),
                    rand(nt, ns), rand(nt, ns), rand(nt, ns), rand(nt),
                    rand(nt, ns))
        # propose: z (4 ops), pick (2), q (3 per coordinate), factor (3)
        out["stretch_propose" + tag] = (
            (s, c, nd, u), (q, fac), nt * ns * (3 * NDIM + 9),
            (lambda a=(s, c, nd, u): sk.stretch_propose(*a)),
            (lambda a=(s, c, nd, u): sk.stretch_propose_ref(*a)),
        )
        # accept: two tempered sums, the difference, log u, compare (10
        # ops), and a select per coordinate
        out["stretch_accept" + tag] = (
            acc_args, sk.stretch_accept(*acc_args), nt * ns * (NDIM + 10),
            (lambda a=acc_args: sk.stretch_accept(*a)),
            (lambda a=acc_args: sk.stretch_accept_ref(*a)),
        )
    for name, kernel, plain, (nt, nw, D) in (
        ("pt_swap_cascade_multi", pt_swap.pt_swap_cascade_multi,
         pt_swap.pt_swap_cascade_multi_ref, (NT, NW, NDIM + 2)),
        ("pt_swap_cascade_multi@rj", pt_swap.pt_swap_cascade_multi,
         pt_swap.pt_swap_cascade_multi_ref, (L_NT, L_NW, 4 * L_NLMAX + 1)),
        ("_cascade_multi_rolled", pt_swap._cascade_multi_rolled,
         pt_swap._cascade_multi_rolled_ref, (E_NT, E_NW, NDIM + 2)),
    ):
        args = _cascade_args(torch, rand, randn, None, nt, nw, D, torch.float32)
        # per rung and walker: a difference, a product and a compare
        out[name] = (args, kernel(*args), 3 * (nt - 1) * nw,
                     (lambda k=kernel, a=args: k(*a)),
                     (lambda p=plain, a=args: p(*a)))
    half = L_NW // 2 * L_NLMAX
    sel_args = _select_args(torch, rand, randn, L_NT, half, half, 3,
                            empty_last=False)
    # per query: a binary search of ceil(log2 M) + 1 compares
    out["onehot_select"] = (
        sel_args, select_kernels.onehot_select(*sel_args),
        L_NT * half * (math.ceil(math.log2(half)) + 1),
        lambda: select_kernels.onehot_select(*sel_args),
        lambda: select_kernels.onehot_select_ref(*sel_args),
    )
    times = {}
    for name, (ins, outs, ops, run_k, run_r) in out.items():
        b_ms, b_by = bound(_nbytes(*ins, *outs), ops)
        times[name] = (_time_ms(run_k), _time_ms(run_r), b_ms, b_by)
    return times


def empty_launch_ms(torch):
    """Device time of one launch of an empty kernel: the floor under every
    kernel of this size."""
    from eryn_tpu_torch.ops import _build

    fn = _build.function("eryn_empty_launch", "p")

    def launch():
        _build.check(fn(torch.cuda.current_stream().cuda_stream), "empty")

    return _time_ms(launch, reps=1000)


def _counting(kernels):
    """Set every launch counter to 0; returns a reader of the counts."""
    for k in kernels:
        k.launches = 0
    return lambda: {k.__name__: k.launches for k in kernels}


def _kernels():
    from eryn_tpu_torch.ops import pt_swap, select_kernels, stretch_kernels as sk

    return (sk.stretch_propose, sk.stretch_accept, pt_swap.pt_swap_cascade_multi,
            pt_swap._cascade_multi_rolled, select_kernels.onehot_select)


def _gaussian_sampler(torch, nt, nw, seed, backend=None):
    from eryn_tpu_torch import EnsembleSampler, ProbDistContainer, uniform_dist

    invcov = torch.eye(NDIM, device="cuda")

    def log_like(x):
        return -0.5 * torch.sum(x * (invcov @ x))

    priors = ProbDistContainer({i: uniform_dist(-5.0, 5.0) for i in range(NDIM)})
    sampler = EnsembleSampler(
        nw, NDIM, log_like, priors, tempering_kwargs=dict(ntemps=nt),
        seed=seed, device="cuda", backend=backend,
    )
    return sampler, priors


def _check_gaussian_chain(np, name, s, nt, allow_hot_one=False):
    """The cold chain of a unit Gaussian, the acceptance, the swaps and the
    adapted ladder.  Swap fractions lie in (0, 1); with ``allow_hot_one`` a
    fraction of 1 is allowed on every boundary but the coldest."""
    from eryn_tpu_torch import make_ladder

    cold = s.get_chain(temp_index=0)["model_0"].reshape(-1, NDIM)
    mean, var = cold.mean(axis=0, dtype=np.float64), cold.var(axis=0, dtype=np.float64)
    acc = float(s.acceptance_fraction[0].mean())
    swaps = np.asarray(s.swap_acceptance_fraction, dtype=np.float64)
    print(f"chain[{name}]: cold mean {np.round(mean, 4).tolist()} "
          f"var {np.round(var, 4).tolist()} acceptance {acc:.4f} "
          f"swap acceptance {np.round(swaps, 4).tolist()}")
    assert np.all(np.abs(mean) < 0.05), mean
    assert np.all(np.abs(var - 1.0) < 0.1), var
    assert 0.2 < acc < 0.8, acc
    if allow_hot_one:
        assert np.all((swaps > 0) & (swaps <= 1)) and swaps[0] < 1, swaps
    else:
        assert np.all((swaps > 0) & (swaps < 1)), swaps
    assert not np.allclose(s.get_betas()[-1], make_ladder(NDIM, nt)), \
        "the ladder did not adapt"


def north_star_leg(torch, card):
    """The north-star configuration's three legs; returns the launch counts
    and rates."""
    import numpy as np

    from eryn_tpu_torch import Backend, DeviceBackend
    from eryn_tpu_torch.utils.utility import get_integrated_act

    _, priors = _gaussian_sampler(torch, NT, NW, 0)
    coords = priors.rvs(size=(NT, NW), generator=torch.Generator(
        device="cuda").manual_seed(0))
    read = _counting(_kernels())
    steps = 0
    rates = {}

    # leg 1: sampling only; the segment must never wait for the device
    s1, _ = _gaussian_sampler(torch, NT, NW, 0)
    state = s1._setup_state(coords)
    state, _ = s1._run_bulk(state, 1, WARM_STEPS, store=False)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    t0 = time.perf_counter()
    state, _ = s1._run_bulk(state, 1, NOSTORE_STEPS, store=False)
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    rates["nostore_steps_per_s"] = NOSTORE_STEPS / (time.perf_counter() - t0)
    steps += WARM_STEPS + NOSTORE_STEPS

    # leg 2: stored into the host Backend
    s2, _ = _gaussian_sampler(torch, NT, NW, 1, backend=Backend())
    s2.run_mcmc(coords, WARM_STEPS, store=False)
    t0 = time.perf_counter()
    s2.run_mcmc(None, STORED_STEPS)
    torch.cuda.synchronize()
    rates["stored_host_steps_per_s"] = STORED_STEPS / (time.perf_counter() - t0)
    steps += WARM_STEPS + STORED_STEPS

    # leg 3: the default backend, which on a GPU keeps the chain on the device
    s3, _ = _gaussian_sampler(torch, NT, NW, 1)
    assert isinstance(s3.backend, DeviceBackend), type(s3.backend)
    s3.run_mcmc(coords, WARM_STEPS, store=False)
    t0 = time.perf_counter()
    s3.run_mcmc(None, STORED_STEPS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    t1 = time.perf_counter()
    tau = s3.get_autocorr_time()["model_0"]
    rates["device_iact_s"] = time.perf_counter() - t1
    rates["stored_device_steps_per_s"] = STORED_STEPS / dt
    tau_max = float(np.nanmax(tau))
    rates["device_ess_per_s"] = STORED_STEPS * NW / max(tau_max, 1.0) / dt
    rates["tau_max"] = tau_max
    steps += WARM_STEPS + STORED_STEPS

    launches = read()
    # two red/blue halves per step, one cascade per step
    assert launches["stretch_propose"] == launches["stretch_accept"] == 2 * steps
    assert launches["pt_swap_cascade_multi"] == steps, launches
    assert launches["_cascade_multi_rolled"] == launches["onehot_select"] == 0

    for name, s in (("Backend", s2), ("DeviceBackend", s3)):
        _check_gaussian_chain(np, name, s, NT)
    assert np.all(np.isfinite(tau)), tau
    # the device IACT agrees with the host estimator on the same chain
    host_tau = get_integrated_act(
        {"model_0": s3.get_chain(temp_index=0)["model_0"][:, None]}
    )["model_0"]
    np.testing.assert_allclose(tau, host_tau, rtol=1e-4)
    print(f"iact: device tau {np.round(tau.ravel(), 3).tolist()} "
          f"(host estimator agrees to 1e-4)")
    for leg in ("nostore_steps_per_s", "stored_host_steps_per_s",
                "stored_device_steps_per_s", "device_ess_per_s"):
        print(f"rate: {leg} = {rates[leg]:.1f} ({card})")
    print(f"rate: device_iact_s = {rates['device_iact_s']:.4f} ({card})")
    print(f"launches[north-star]: {launches} over {steps} steps")
    return launches, rates


def config_e_leg(torch, card):
    """Config E (20 x 1000) into the default DeviceBackend: every step's
    cascade is the large-ensemble kernel."""
    import numpy as np

    s, priors = _gaussian_sampler(torch, E_NT, E_NW, 5)
    coords = priors.rvs(size=(E_NT, E_NW), generator=torch.Generator(
        device="cuda").manual_seed(5))
    read = _counting(_kernels())
    state = s._setup_state(coords)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    s._run_bulk(state, 1, E_WARM, store=False)
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s.run_mcmc(None, E_STEPS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    steps = E_WARM + E_STEPS
    launches = read()
    assert launches["_cascade_multi_rolled"] == steps, launches
    assert launches["pt_swap_cascade_multi"] == 0, launches
    assert launches["stretch_propose"] == launches["stretch_accept"] == 2 * steps
    # at 20 temperatures the default 5-D ladder reaches beta ~ 1e-9, where
    # every proposed swap is accepted
    _check_gaussian_chain(np, "config E", s, E_NT, allow_hot_one=True)
    rates = {"config_e_steps_per_s": E_STEPS / dt,
             "config_e_walker_steps_per_s": E_STEPS * E_NT * E_NW / dt}
    for k, v in rates.items():
        print(f"rate: {k} = {v:.1f} ({card})")
    print(f"launches[config E]: {launches} over {steps} steps")
    return launches, rates


def _pulse_problem(torch, np):
    """benchmarks/lisa_style.py's data (one pulse at t = 4, amplitude 3,
    width 0.6, noise 0.3) and likelihood, in torch on the card."""
    from eryn_tpu_torch import ProbDistContainer, uniform_dist

    rng = np.random.default_rng(10)
    t_np = np.linspace(0.0, 10.0, L_NPTS)
    sigma = 0.3
    data_np = 3.0 * np.exp(-((t_np - 4.0) ** 2) / (2 * 0.6**2))
    data_np = data_np + sigma * rng.standard_normal(L_NPTS)
    t = torch.tensor(t_np, dtype=torch.float32, device="cuda")
    data = torch.tensor(data_np, dtype=torch.float32, device="cuda")

    def ll(coords, inds):
        a, b, c = coords[:, 0], coords[:, 1], coords[:, 2]
        p = a[:, None] * torch.exp(
            -((t[None] - b[:, None]) ** 2) / (2 * c[:, None] ** 2)
        )
        tmpl = torch.sum(torch.where(inds[:, None], p, 0.0), dim=0)
        return -0.5 * torch.sum(((tmpl - data) / sigma) ** 2)

    pr = ProbDistContainer({0: uniform_dist(0.5, 5.0),
                            1: uniform_dist(0.0, 10.0),
                            2: uniform_dist(0.1, 2.0)})
    fill = float(-0.5 * np.sum((data_np / sigma) ** 2))
    return ll, pr, fill


def lisa_rj_leg(torch, card):
    """The LISA-style reversible-jump configuration: group stretch plus
    birth/death, with tempering, into the default DeviceBackend."""
    import numpy as np

    from eryn_tpu_torch import EnsembleSampler, State
    from eryn_tpu_torch.moves import RedBlueGroupStretchMove

    ll, pr, fill = _pulse_problem(torch, np)
    s = EnsembleSampler(
        L_NW, 3, ll, pr, nleaves_max=L_NLMAX, nleaves_min=0,
        moves=RedBlueGroupStretchMove(), rj_moves=True,
        tempering_kwargs=dict(ntemps=L_NT), fill_zero_leaves_val=fill,
        seed=3, device="cuda",
    )
    coords = pr.rvs(size=(L_NT, L_NW, L_NLMAX), generator=torch.Generator(
        device="cuda").manual_seed(3), dtype=torch.float32)
    inds = np.random.default_rng(4).random((L_NT, L_NW, L_NLMAX)) < 0.4
    state = s._setup_state(State({"model_0": coords}, inds={
        "model_0": torch.as_tensor(inds, device="cuda")}))
    read = _counting(_kernels())
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    s._run_bulk(state, 1, L_WARM, store=False)
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s.run_mcmc(None, L_STEPS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    steps = L_WARM + L_STEPS
    launches = read()
    # one selection per red/blue half; a cascade after the in-model move
    # and after the RJ move
    assert launches["onehot_select"] == 2 * steps, launches
    assert launches["pt_swap_cascade_multi"] == 2 * steps, launches
    assert launches["_cascade_multi_rolled"] == 0, launches

    half = slice(L_STEPS // 2, None)
    nleaves = s.get_nleaves()["model_0"][half, 0]
    counts = np.bincount(nleaves.ravel(), minlength=L_NLMAX + 1)
    mode = int(np.argmax(counts))
    centers = s.get_chain(temp_index=0)["model_0"][half][..., 1]
    active = s.get_inds(temp_index=0)["model_0"][half]
    median_b = float(np.median(centers[active]))
    rj = float(s.rj_acceptance_fraction.mean())
    acc = float(s.acceptance_fraction[0].mean())
    print(f"chain[LISA RJ]: cold leaf counts {(counts / counts.sum()).round(4).tolist()} "
          f"mode {mode} median b {median_b:.4f} rj acceptance {rj:.6f} "
          f"in-model acceptance {acc:.4f} "
          "swap acceptance "
          f"{np.round(np.asarray(s.swap_acceptance_fraction, float), 4).tolist()}")
    assert mode >= 1, counts
    assert abs(median_b - 4.0) < 0.3, median_b
    assert 0 < rj < 1, rj
    rates = {"lisa_rj_steps_per_s": L_STEPS / dt}
    print(f"rate: lisa_rj_steps_per_s = {rates['lisa_rj_steps_per_s']:.1f} ({card})")
    print(f"launches[LISA RJ]: {launches} over {steps} steps")
    return launches, rates


def flat_rj_leg(torch):
    """Flat likelihood with birth/death (1 x 64 walkers, up to 3 leaves):
    the leaf-count posterior is uniform."""
    import numpy as np

    from eryn_tpu_torch import EnsembleSampler, ProbDistContainer, State, uniform_dist
    from eryn_tpu_torch.moves import RedBlueGroupStretchMove

    nw, nlmax, steps, burn = 64, 3, 1500, 300
    pr = ProbDistContainer({i: uniform_dist(-1.0, 1.0) for i in range(2)})
    s = EnsembleSampler(
        nw, 2, lambda c, i: torch.zeros((), device="cuda"), pr,
        nleaves_max=nlmax, nleaves_min=0,
        moves=RedBlueGroupStretchMove(live_dangerously=True), rj_moves=True,
        fill_zero_leaves_val=0.0, seed=7, device="cuda",
    )
    rng = np.random.default_rng(7)
    state = State({"model_0": rng.uniform(-1, 1, (1, nw, nlmax, 2))},
                  inds={"model_0": rng.random((1, nw, nlmax)) < 0.5})
    read = _counting(_kernels())
    s.run_mcmc(state, steps, burn=burn)
    launches = read()
    assert launches["onehot_select"] == 2 * (steps + burn), launches
    k = s.get_nleaves()["model_0"][:, 0].ravel()
    freqs = np.bincount(k, minlength=nlmax + 1) / k.size
    print(f"chain[flat RJ]: leaf-count frequencies {freqs.round(4).tolist()}")
    assert np.abs(freqs - 1.0 / (nlmax + 1)).max() < 0.08, freqs
    print(f"launches[flat RJ]: {launches} over {steps + burn} steps")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", help="also write the report as JSON here")
    args = parser.parse_args(argv)

    if not (ROOT / "eryn_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run it from a checkout of the repository "
              "(eryn_tpu_torch/ not found)", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    t_start = time.perf_counter()

    # phase 1: device
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"device: {name}")
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    # phase 2: build
    from eryn_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.1f} s -> "
          f"{_build.library_path().relative_to(ROOT)}")
    for line in _build.library_path().with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # phase 3: kernels against their plain versions, and their times
    errs = {}
    for dtype_name in ("float32", "float64"):
        for k, e in check_kernels(torch, dtype_name).items():
            errs[k] = max(errs.get(k, 0.0), e)
        print(f"kernels[{dtype_name}]: agree with their plain versions")
    times = time_kernels(torch)
    floor = empty_launch_ms(torch)
    print(f"time: empty launch {floor:.4f} ms ({smi})")
    for k, (ms, plain, b_ms, b_by) in times.items():
        print(f"time: {k} {ms:.4f} ms, plain {plain:.4f} ms, bound "
              f"{b_ms:.6f} ms ({b_by}), launch floor {floor:.4f} ms ({smi})")

    # phase 4: the main path, leg by leg
    legs = [north_star_leg(torch, smi), config_e_leg(torch, smi),
            lisa_rj_leg(torch, smi)]
    # a check of the RJ posterior, not a main-path leg: its launches are
    # asserted inside and left out of the report
    flat_rj_leg(torch)
    launches, rates = {}, {}
    for leg_launches, leg_rates in legs:
        for k, v in leg_launches.items():
            launches[k] = launches.get(k, 0) + v
        rates.update(leg_rates)
    assert all(v > 0 for v in launches.values()), launches

    sources = {
        "stretch_propose": ("eryn_tpu_torch/csrc/stretch_kernels.cu",
                            "eryn_tpu/ops/stretch_kernels.py:68"),
        "stretch_accept": ("eryn_tpu_torch/csrc/stretch_kernels.cu",
                           "eryn_tpu/ops/stretch_kernels.py:154"),
        "pt_swap_cascade_multi": ("eryn_tpu_torch/csrc/pt_swap.cu",
                                  "eryn_tpu/ops/pt_swap.py:120"),
        "_cascade_multi_rolled": ("eryn_tpu_torch/csrc/pt_swap.cu",
                                  "eryn_tpu/ops/pt_swap.py:232"),
        "onehot_select": ("eryn_tpu_torch/csrc/select_kernels.cu",
                          "eryn_tpu/ops/select_kernels.py:145"),
    }
    # no single PyTorch call computes any of these functions (the selection's
    # torch.searchsorted gives only the indices), so library_ms is null
    report = {"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[k], "max_abs_err": errs[k],
         "ms": times[k][0], "plain_ms": times[k][1], "bound_ms": times[k][2],
         "bound_by": times[k][3], "library_ms": None,
         "launch_floor_ms": floor}
        for k, (src, rep) in sources.items()
    ]}
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {**report, "rates": rates, "card": smi,
             "times": {k: list(v) for k, v in times.items()}}, indent=1
        ))
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
