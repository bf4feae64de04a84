#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``eryn_tpu_torch``) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA Hopper GPU and
the CUDA toolkit::

    python3 chip_smoke.py [--out report.json]

Phases, each printing its own lines:

1. device: the card's name and ``nvidia-smi`` name and power limit;
2. build: the three CUDA kernels from ``eryn_tpu_torch/csrc``;
3. kernels: each kernel against its plain PyTorch version on the card, in
   float32 and float64, at the north-star shapes and at an odd shape, with
   each kernel's time beside its plain version's;
4. main path: the north-star configuration (10 temperatures x 100 walkers,
   5-D Gaussian, uniform priors) through ``EnsembleSampler``: a run without
   storing, a stored run into ``Backend()``, and a stored run into the
   default backend (a ``DeviceBackend``) followed by ``get_autocorr_time``.
   The kernels' launch counters must show that every step went through
   them, and the chain must have the target's moments.

The second-to-last line of standard output is a JSON object describing the
kernels, the last ``{"ok": true, "device": {...}}``.  Any failure raises and
exits nonzero; without CUDA, or outside a checkout, it exits 2 and prints no
result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

NT, NW, NDIM = 10, 100, 5
NOSTORE_STEPS = 3000
STORED_STEPS = 2000
WARM_STEPS = 500
# float32: a few ulp (exp/log of the two code paths may differ); float64
# likewise scaled
TOL = {"float32": 1e-6, "float64": 1e-12}


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


def check_kernels(torch, dtype_name):
    """Every kernel against its plain version at two shapes; returns
    ``{kernel: max_abs_err}``."""
    from eryn_tpu_torch.ops import pt_swap, stretch_kernels as sk

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

    # (nt, ns, nc, D): the north-star halves, and an odd shape
    for nt, ns, nc, D in ((NT, NW // 2, NW // 2, NDIM), (8, 50, 49, 13)):
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
            errs["stretch_propose"] = max(
                errs.get("stretch_propose", 0.0), _max_err(q_k, q_r),
                _max_err(f_k, f_r),
            )

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
        errs["stretch_accept"] = max(
            [errs.get("stretch_accept", 0.0)]
            + [_max_err(a, b) for a, b in zip(out_k, out_r)]
        )

    for nt, nw, D in ((NT, NW, NDIM + 2), (8, 99, 13)):
        betas = torch.logspace(0, -2, nt, dtype=dtype, device="cuda")
        args = (
            randn(nt, nw) * 10, randn(nt, D, nw),
            (betas[:-1] - betas[1:]).contiguous(),
            torch.randint(0, nw, (nt - 1,), generator=gen,
                          dtype=torch.int32).cuda(),
            torch.log(rand(nt - 1, nw)),
        )
        out_k = pt_swap.pt_swap_cascade_multi(*args)
        out_r = pt_swap.pt_swap_cascade_multi_ref(*args)
        # values only move: bitwise equal
        for a, b in zip(out_k, out_r):
            assert torch.equal(a, b), "pt_swap_cascade_multi is not bitwise"
        assert 0 < out_k[2].sum() < out_k[2].numel()
        errs["pt_swap_cascade_multi"] = max(
            [errs.get("pt_swap_cascade_multi", 0.0)]
            + [_max_err(a, b) for a, b in zip(out_k, out_r)]
        )
    torch.cuda.synchronize()
    return errs


def time_kernels(torch):
    """Each kernel and its plain version at the north-star shapes, float32."""
    from eryn_tpu_torch.ops import pt_swap, stretch_kernels as sk

    g = torch.Generator(device="cuda").manual_seed(7)
    f32 = dict(device="cuda", dtype=torch.float32)

    def rand(*shape):
        return torch.rand(shape, generator=g, **f32)

    ns = NW // 2
    s, c, u = rand(NT, ns, NDIM), rand(NT, ns, NDIM), rand(2, NT, ns)
    nd = torch.full((NT, ns), float(NDIM), **f32)
    acc_args = (rand(NT, ns, NDIM), s, rand(NT, ns), rand(NT, ns),
                rand(NT, ns), rand(NT, ns), rand(NT, ns), rand(NT), rand(NT, ns))
    sw_args = (rand(NT, NW), rand(NT, NDIM + 2, NW), rand(NT - 1),
               torch.randint(0, NW, (NT - 1,), device="cuda", dtype=torch.int32),
               torch.log(rand(NT - 1, NW)))
    return {
        "stretch_propose": (
            _time_ms(lambda: sk.stretch_propose(s, c, nd, u)),
            _time_ms(lambda: sk.stretch_propose_ref(s, c, nd, u)),
        ),
        "stretch_accept": (
            _time_ms(lambda: sk.stretch_accept(*acc_args)),
            _time_ms(lambda: sk.stretch_accept_ref(*acc_args)),
        ),
        "pt_swap_cascade_multi": (
            _time_ms(lambda: pt_swap.pt_swap_cascade_multi(*sw_args)),
            _time_ms(lambda: pt_swap.pt_swap_cascade_multi_ref(*sw_args)),
        ),
    }


def main_path(torch, card):
    """The north-star configuration through the sampler's public entry
    points; returns the launch counts and per-leg rates."""
    import numpy as np

    from eryn_tpu_torch import (
        Backend, DeviceBackend, EnsembleSampler, ProbDistContainer,
        make_ladder, uniform_dist,
    )
    from eryn_tpu_torch.ops import pt_swap, stretch_kernels as sk
    from eryn_tpu_torch.utils.utility import get_integrated_act

    invcov = torch.eye(NDIM, device="cuda")

    def log_like(x):
        return -0.5 * torch.sum(x * (invcov @ x))

    priors = ProbDistContainer({i: uniform_dist(-5.0, 5.0) for i in range(NDIM)})
    coords = priors.rvs(size=(NT, NW), generator=torch.Generator(
        device="cuda").manual_seed(0))

    def make(seed, backend=None):
        return EnsembleSampler(
            NW, NDIM, log_like, priors, tempering_kwargs=dict(ntemps=NT),
            seed=seed, device="cuda", backend=backend,
        )

    kernels = (sk.stretch_propose, sk.stretch_accept, pt_swap.pt_swap_cascade_multi)
    for k in kernels:
        k.launches = 0
    steps = 0
    rates = {}

    # leg 1: sampling only; the segment must never wait for the device
    s1 = make(0)
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
    s2 = make(1, backend=Backend())
    s2.run_mcmc(coords, WARM_STEPS, store=False)
    t0 = time.perf_counter()
    s2.run_mcmc(None, STORED_STEPS)
    torch.cuda.synchronize()
    rates["stored_host_steps_per_s"] = STORED_STEPS / (time.perf_counter() - t0)
    steps += WARM_STEPS + STORED_STEPS

    # leg 3: the default backend, which on a GPU keeps the chain on the device
    s3 = make(1)
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

    launches = {k.__name__: k.launches for k in kernels}
    # two red/blue halves per step, one cascade per step
    assert launches["stretch_propose"] + launches["stretch_accept"] == 4 * steps, launches
    assert launches["stretch_propose"] == launches["stretch_accept"] == 2 * steps
    assert launches["pt_swap_cascade_multi"] == steps, launches

    # the chain samples the target: the cold chain of a unit Gaussian
    for name, s in (("Backend", s2), ("DeviceBackend", s3)):
        cold = s.get_chain(temp_index=0)["model_0"].reshape(-1, NDIM)
        mean, var = cold.mean(axis=0), cold.var(axis=0)
        acc = float(s.acceptance_fraction[0].mean())
        swaps = s.swap_acceptance_fraction
        print(f"chain[{name}]: cold mean {np.round(mean, 4).tolist()} "
              f"var {np.round(var, 4).tolist()} acceptance {acc:.4f} "
              f"swap acceptance {np.round(swaps, 3).tolist()}")
        assert np.all(np.abs(mean) < 0.05), mean
        assert np.all(np.abs(var - 1.0) < 0.1), var
        assert 0.2 < acc < 0.8, acc
        assert np.all((swaps > 0) & (swaps < 1)), swaps
        assert not np.allclose(s.get_betas()[-1], make_ladder(NDIM, NT)), \
            "the ladder did not adapt"
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
    print(f"launches: {launches} over {steps} steps")
    return launches, rates


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

    # phase 3: kernels against their plain versions
    errs = {}
    for dtype_name in ("float32", "float64"):
        for k, e in check_kernels(torch, dtype_name).items():
            errs[k] = max(errs.get(k, 0.0), e)
        print(f"kernels[{dtype_name}]: agree with their plain versions")
    times = time_kernels(torch)
    for k, (ms, plain) in times.items():
        print(f"time: {k} {ms:.4f} ms, plain {plain:.4f} ms ({smi})")

    # phase 4: the main path
    launches, rates = main_path(torch, smi)

    sources = {
        "stretch_propose": ("eryn_tpu_torch/csrc/stretch_kernels.cu",
                            "eryn_tpu/ops/stretch_kernels.py:68"),
        "stretch_accept": ("eryn_tpu_torch/csrc/stretch_kernels.cu",
                           "eryn_tpu/ops/stretch_kernels.py:154"),
        "pt_swap_cascade_multi": ("eryn_tpu_torch/csrc/pt_swap.cu",
                                  "eryn_tpu/ops/pt_swap.py:120"),
    }
    report = {"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[k], "max_abs_err": errs[k],
         "ms": times[k][0], "plain_ms": times[k][1]}
        for k, (src, rep) in sources.items()
    ]}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {**report, "rates": rates, "card": smi}, indent=1
        ))
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
