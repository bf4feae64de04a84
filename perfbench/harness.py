"""One run of one cell: set-up, the measured window, the readers, the check.

Set-up, in order: the cell's files by name; the data, the start state and
the sampler's seed from ``--seed``; the sampler on the device with CUDA
graphs on and a ``DeviceBackend`` sized for the window; the burn-in
(which captures the graphs) and a few stored segments through the same
hook, after which the stored chain is cleared.  The window is one
``EnsembleSampler.run_mcmc`` call whose stopping hook, every
``hook_every`` stored steps, reads the newest sample's cold-chain
log-likelihood maximum to the host, records the host clock and stops the
run once ``seconds`` have passed.  Then the peak memory is read, the
outputs the check needs are taken (a sample of stored steps, the cold
series, the whole stored chain and ladder), the per-layer readers run
(traced runs), the program's state is freed, and the reference judges the
outputs.
"""

from __future__ import annotations

import gc
import math
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from . import cells, iact, trace
from .reference import checks

# the most stored steps a window may ask for; the stopping hook ends it
NSTEPS_MAX = 10_000_000
# device memory the stored chain may take before the backend moves it to
# the host (which would stall the window)
STORE_BYTES = 48 << 30
# where in the window the traced run starts its sessions (a share of it)
TRACE_FROM = 0.4


def seeds(seed):
    """Sub-seeds for the data, the start state, the sampler and the check,
    each under 2**32, from any whole number."""
    ss = np.random.SeedSequence(int(seed) % (1 << 128))
    return [int(x) for x in ss.generate_state(4, dtype=np.uint32)]


def counted_launches():
    """``{wrapper name: launches}`` of the port's counted kernels."""
    from eryn_tpu_torch.graphs import counted_kernels

    return {k.__name__: k.launches for k in counted_kernels()}


def make_moves(spec):
    """``[(move, weight)]`` from ``[[class name in eryn_tpu_torch.moves,
    keyword arguments, weight], ...]``."""
    from eryn_tpu_torch import moves as tm

    return [(getattr(tm, name)(**kwargs), float(w)) for name, kwargs, w in spec]


def build(cell, seed, device, control=False):
    """The sampler, its start state and what the reference will need."""
    from eryn_tpu_torch import (DeviceBackend, EnsembleSampler,
                                ProbDistContainer, State, uniform_dist)

    cfg, tr = cell.config, cell.traffic
    data_seed, start_seed, sampler_seed, check_seed = seeds(seed)
    gens = {k: torch.Generator(device=device).manual_seed(s)
            for k, s in (("data", data_seed), ("start", start_seed))}
    family = cells.module("models", cfg["family"], cell.root)
    prob = family.problem(cfg, tr, gens, device, control=control)
    priors = ProbDistContainer({i: uniform_dist(float(lo), float(hi))
                                for i, (lo, hi) in enumerate(prob.bounds.tolist())})
    tempering = dict(ntemps=int(cfg["ntemps"]), **cfg.get("tempering", {}),
                     **tr.get("tempering", {}))
    sampler = EnsembleSampler(
        int(cfg["nwalkers"]), prob.ndim, prob.log_like, priors,
        tempering_kwargs=tempering,
        moves=make_moves(tr.get("moves", cfg["moves"])),
        backend=DeviceBackend(dtype=np.float32, max_device_bytes=STORE_BYTES),
        seed=sampler_seed, device=device, dtype=torch.float32,
        **prob.sampler_kwargs)
    inds = None if prob.inds is None else {"model_0": prob.inds}
    state = State({"model_0": prob.coords}, inds=inds)
    return SimpleNamespace(sampler=sampler, state=state, prob=prob,
                           family=family, check_seed=check_seed)


def _sample(sampler, steps, k, seed):
    """The stored outputs at ``k`` steps drawn from ``seed`` (the last one
    always among them), as float64 and bool tensors on the host."""
    rng = np.random.default_rng(seed)
    idx = rng.choice(steps - 1, size=min(k, steps) - 1, replace=False)
    idx = np.sort(np.append(idx, steps - 1))
    coords = sampler.get_value("chain", slice_vals=idx)["model_0"]
    inds = sampler.get_value("inds", slice_vals=idx)["model_0"]
    return {
        "steps": idx,
        "coords": torch.from_numpy(np.asarray(coords, dtype=np.float64)),
        "inds": torch.from_numpy(np.asarray(inds, dtype=bool)),
        "log_like": torch.from_numpy(np.asarray(
            sampler.get_value("log_like", slice_vals=idx), dtype=np.float64)),
        "log_prior": torch.from_numpy(np.asarray(
            sampler.get_value("log_prior", slice_vals=idx), dtype=np.float64)),
    }


def measure(workload, seed, seconds, traced, *, device="cuda", t_start=None,
            control=False, tamper=None, log=sys.stderr, root=cells.ROOT):
    """One run; returns the result line's object (``checks`` last).
    ``control``: the configuration's likelihood in its lower precision;
    ``tamper(sampler)``: called once the sampler is built (the tests' and
    the fault readings' way to break the timed path); ``root``: the
    checkout whose ``BENCHMARK.json`` and ``perfbench/`` files name the
    cell."""
    t_measure = time.perf_counter()
    t_start = t_measure if t_start is None else t_start
    cell = cells.load(workload, root)
    tr = cell.traffic
    hook_every = int(tr["hook_every"])
    cuda = torch.device(device).type == "cuda"

    compile_s = 0.0
    if cuda:
        from eryn_tpu_torch.ops import _build

        t0 = time.perf_counter()
        _build.load()
        compile_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
    t_build = time.perf_counter()
    run = build(cell, seed, device, control=control)
    sampler = run.sampler
    t_burn = time.perf_counter()
    if tamper is not None:
        tamper(sampler)

    # burn-in (captures the graphs), then stored segments through the hook
    def warm_hook(i, last, smp):
        float(last.log_like[0].max())
        return False

    sampler.stopping_fn, sampler.stopping_iterations = warm_hook, hook_every
    state = sampler.run_mcmc(run.state, hook_every * int(tr["warm_segments"]),
                             burn=int(tr["burn"]))
    sampler.reset()
    if cuda:
        torch.cuda.synchronize()

    stamps = []
    tracer = None
    if traced:
        tracer = trace.Tracer(tr["trace_segments"], hook_every,
                              TRACE_FROM * seconds, counted_launches)

    def hook(i, last, smp):
        float(last.log_like[0].max())
        now = time.perf_counter()
        stamps.append((i, now))
        if tracer is not None:
            tracer.on_hook(now - t0)
        return now - t0 >= seconds

    sampler.stopping_fn = hook
    setup_s = time.perf_counter() - t_start
    t0 = time.perf_counter()
    state = sampler.run_mcmc(state, NSTEPS_MAX)
    if tracer is not None:
        tracer.close()
    steps, t_end = stamps[-1]
    window_s = t_end - t0
    seg_ms = 1e3 * np.diff([t0] + [t for _, t in stamps])
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    cfg = cell.config
    nt, nw = int(cfg["ntemps"]), int(cfg["nwalkers"])
    series = run.family.cold_series(sampler)
    sample = _sample(sampler, steps, int(tr["check_steps"]), run.check_seed)
    ctx = SimpleNamespace(
        cell=cell, sampler=sampler, state=state, family=run.family,
        steps=steps, window_s=window_s, series=series,
        trace=None if tracer is None else tracer.summary(), log=log,
        tau_max=None, untraced_s_per_step=math.nan)
    if tracer is not None:
        nlost = sum(1 for s in tracer.sessions if s["lost"])
        print(f"trace: {len(tracer.sessions)} segments traced, {nlost} left "
              f"out for lost records {[s['lost'] for s in tracer.sessions if s['lost']]}",
              file=log)
        if ctx.trace is not None:
            # the profiler slows the host (each replayed graph node is
            # recorded): the idle share is the device's busy time a step in
            # the trace against the wall time a step of this run's untraced
            # segments before the trace, the first left out
            ends = np.cumsum(seg_ms) * 1e-3
            calm = seg_ms[1:][ends[1:] < TRACE_FROM * seconds]
            if calm.size:
                ctx.untraced_s_per_step = (float(np.mean(calm)) * 1e-3
                                           / hook_every)
            busy = ctx.trace["busy_s"] / ctx.trace["steps"]
            print(f"trace: device busy {1e3 * busy:.6f} ms a step; the "
                  f"untraced segments' wall {1e3 * ctx.untraced_s_per_step:.6f}"
                  f" ms a step ({calm.size} segments); traced idle "
                  f"{100 * (1 - ctx.trace['busy_s'] / ctx.trace['window_s']):.3f}"
                  f" %", file=log)

    # the per-layer readers that need the program run before it is freed
    on_device = torch.device(device)
    ctx.tau_max = iact.tau_max({k: v.to(on_device) for k, v in series.items()})
    per_layer = {}
    if traced:
        for m in cell.per_layer:
            value = cells.module("metrics", m["name"], cell.root).read(ctx)
            if value is not None:
                per_layer[m["name"]] = {"value": float(value), "unit": m["unit"]}
    breakdown = None
    if ctx.trace is not None:
        t = ctx.trace
        breakdown = {
            "device_ops": [[n, s] for n, s in sorted(
                t["by_name"].items(), key=lambda kv: -kv[1])[:10]],
            "idle_gaps": [[n, s] for n, s in sorted(
                t["idle"].items(), key=lambda kv: -kv[1])[:10]],
        }
    bounds, inputs = run.prob.bounds, dict(run.prob.inputs)
    inputs = {k: (v.detach().cpu() if torch.is_tensor(v) else v)
              for k, v in inputs.items()}
    rhat_series = run.family.rhat_series(series)
    stored_chain = sampler.get_chain()["model_0"]
    stored_inds = sampler.get_inds()["model_0"]
    stored_betas = torch.from_numpy(np.asarray(sampler.get_betas(),
                                               dtype=np.float64))
    check_seed = run.check_seed
    del ctx.sampler, ctx.state, sampler, state, run
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # the reference judges what the window stored
    ref = cells.module("reference", cfg["family"], cell.root)
    dev = lambda x: x.to(on_device)  # noqa: E731
    gaps = checks.logpost_gaps(
        {k: dev(v) for k, v in sample.items() if k != "steps"},
        {k: (dev(v) if torch.is_tensor(v) else v) for k, v in inputs.items()},
        bounds, ref.log_like)
    def chain(r):
        return (torch.from_numpy(stored_chain[:, r]),
                torch.from_numpy(np.asarray(stored_inds[:, r], dtype=bool)))

    moments, ref_var = ref.moment_deviations(
        chain, stored_betas, cfg, inputs, bounds, check_seed, on_device)
    numbers = {
        "logpost_gap": float(gaps.max()),
        "rhat": checks.split_rhat(dev(rhat_series)),
        "moment_z": checks.batch_z(moments, ref_var),
    }
    del stored_chain, stored_inds, moments
    limits = cell.limits
    over = {k: not (math.isfinite(v) and v <= limits[k])
            for k, v in numbers.items()}
    correct = not any(over.values())
    # the stored samples whose log-posterior is off, and each other number
    # over its limit
    failed = (int((gaps > limits["logpost_gap"]).sum())
              + sum(v for k, v in over.items() if k != "logpost_gap"))

    metrics = {}
    if not traced:
        values = {
            "walker_steps_per_s": nt * nw * steps / window_s,
            "cold_ess_per_s": nw * steps / ctx.tau_max / window_s,
            "segment_ms_p95": float(np.percentile(seg_ms, 95)),
            "setup_s": setup_s,
        }
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        metrics = per_layer

    print(f"window: {steps} stored steps in {window_s:.4f} s, "
          f"{len(seg_ms)} segments (p50 {np.percentile(seg_ms, 50):.3f} ms, "
          f"max {seg_ms.max():.3f} ms); set-up {setup_s:.3f} s: imports "
          f"{t_measure - t_start:.3f} s, loading (or building) the kernels "
          f"{compile_s:.3f} s, the sampler {t_burn - t_build:.3f} s, burn-in "
          f"and warm segments {t0 - t_burn:.3f} s; cold tau_max "
          f"{ctx.tau_max:.4f}; stored samples checked {gaps.numel()}",
          file=log)
    print(f"compile: {compile_s:.3f} s loading or building the kernels; "
          f"set-up without it {setup_s - compile_s:.3f} s", file=log)
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    if traced and ctx.trace is not None:
        device_info["busy_s"] = ctx.trace["busy_s"]
        device_info["window_s"] = ctx.trace["window_s"]
    out = {"correct": bool(correct), "attempted": int(gaps.numel()),
           "failed": failed, "metrics": metrics, "device": device_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {k: {"value": v, "limit": limits[k]}
                     for k, v in numbers.items()}
    return out
