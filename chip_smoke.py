#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``eryn_tpu_torch``) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA Hopper GPU and
the CUDA toolkit::

    python3 chip_smoke.py [--out report.json]

(``--cascade-scan`` instead builds the kernels, times the swap cascade on
the device against rungs, walkers and chunk width, and stops; ``--null-leg``
builds them, runs and profiles the null-likelihood RJ leg alone, and stops:
copied into an earlier tree of the port it times that tree.
``--resume-child CONFIG FILE`` is the child process of the resume legs.)

Phases, each printing its own lines:

1. device: the card's name and ``nvidia-smi`` name and power limit;
2. build: the CUDA kernels from ``eryn_tpu_torch/csrc`` (one ``nvcc`` per
   source, in parallel);
3. kernels: the grouped launches of the stretch kernels, the cascade
   (plain and rolled) and the group-stretch proposal at 1, 4 and 64
   groups against their plain grouped versions (max abs error 0, and at
   one group the ungrouped launch) and their times; each of the seven
   kernels (three for the stretch step, two
   cascades, the group-stretch proposal and the selection alone) against
   its plain PyTorch version on the card, in float32 and float64, at the
   main path's shapes and at odd shapes (the cascades in the sampler's tree
   form, as a grid of blocks, as one block and with their rows in global
   memory, and in the channel form; the tree form with the leaves blobs
   and supplementals add, 7 of mixed dtypes and 40 in two launches, plain
   and rolled; the group-stretch proposal on both
   blocks of the RJ split and with two branches, a Gibbs table, an empty
   complement, picks beyond the count, a periodic dimension and the log
   proposal, and at a (2, 2) mesh rank's shape, five temperatures of the
   LISA ensemble), then
   each kernel's time per wrapper call beside its plain version's,
   its bound (bytes over the memory rate against operations over the peak
   rate) and the time of one empty launch, and the host cost of a
   wrapper's parts;
4. main path, the legs below through ``EnsembleSampler``, each with the launch
   counters set to 0 just before it and read just after; every leg runs
   graphed (each move's step captured once as a CUDA graph and replayed),
   and every segment under ``set_sync_debug_mode("error")``:

   * north-star (10 temperatures x 100 walkers, 5-D Gaussian): a run without
     storing, a stored run into ``Backend()``, and a stored run into the
     default ``DeviceBackend`` followed by ``get_autocorr_time``;
   * config E (20 x 1000, 5-D Gaussian, ``bench.py``): every step through
     the large-ensemble cascade;
   * LISA-style reversible jump (10 x 200 walkers, up to 8 Gaussian-pulse
     leaves, 8192-point template, ``benchmarks/lisa_style.py``): the group
     stretch through its fused proposal kernel (two launches per step),
     births and deaths, and the pulse found in the data;
   * the same configuration with the null likelihood of
     ``benchmarks/lisa_style.py`` (``heavy=False``), which isolates the
     sampler's own cost: ``lisa_rj_null_steps_per_s``, and
     ``lisa_rj_overhead_frac`` = heavy rate / null rate;
   * the null configuration once more, shorter, with a user's group-stretch
     move written on the public ``onehot_select`` op (a subclass overriding
     ``get_proposal_kernel`` with separate tensor ops around one selection
     launch per half): from the same seed its chain must equal the fused
     kernel's, and its rate is printed beside it;
   * the long-run legs: ``hdf[north-star]``, 1,200 stored steps in segments
     of 200 (a checkpoint each) into ``HDFBackend`` and ``Backend()``, equal
     digit for digit, with both rates and where the host's time went;
     ``resume[north-star]`` (600 steps) and ``resume[LISA RJ null]`` (400),
     each stopped at the first segment boundary at or past half its steps
     and continued by a fresh sampler, equal to the uninterrupted run digit
     for digit: with h5py a child process (``--resume-child``) writes an
     HDF5 file and is SIGKILLed from its ``update_fn``; without, the first
     sampler's ``Backend()`` is continued in this process (a line says
     which); ``hooks[north-star]``, ``AdjustStretchProposalScale`` and
     ``AutoCorrelationStop`` every 100 steps, graphed equal to
     ``cuda_graph=False`` digit for digit, one capture per change of the
     stretch scale;
   * the tempered-analysis legs at the north-star width: ``deo[north-star]``
     (deterministic even-odd swaps and the Syed schedule, 200 warm and
     1,200 stored steps: every boundary swaps over the replays, no cascade
     launch; ``deo_steps_per_s``, ``deo_device_ess_per_s``,
     ``deo_barrier_total``) and ``evidence[north-star]`` (a fixed ladder
     ending at beta = 0 into ``DeviceBackend`` and ``Backend()``, equal
     digit for digit; stepping-stone and thermodynamic-integration evidence
     against the analytic value, the device getters equal to the host
     ones, their wall times side by side);
   * ``rj_pulse128``, config C of ``bench.py`` (10 x 100 walkers, up to 4
     pulse leaves, the 128-point template): 2,000 warm and 2,000 timed
     steps without storing;
   * the move zoo without gradients (``benchmarks/move_zoo_timing.py``'s
     configuration: 10 x 100, the 5-D unit Gaussian, seed 10): one leg per
     move, ``zoo[GaussianMove(diag)]``, ``zoo[GaussianMove(full)]``,
     ``zoo[DistributionGenerate]``, ``zoo[GroupStretchMove]``,
     ``zoo[MTDistGenMove(8 tries)]``,
     ``zoo[DelayedRejection(GaussianMove(diag))]`` and ``zoo[CombineMove]``
     (group stretch, then delayed rejection: two swap phases a step), each
     200 warm and 1,000 timed steps without storing, then 1,000 stored, the
     cold chain's moments and the acceptance as gates;
     the gradient moves and the rest of the zoo the same way (PR 10:
     ``zoo[DEMove]``, ``zoo[DESnookerMove]``, ``zoo[WalkMove]``,
     ``zoo[KDEMove]``, ``zoo[SliceMove]``, ``zoo[MALAMove]``,
     ``zoo[HMCMove]``, ``zoo[ChEESHMCMove]``, ``zoo[AIMHMove]``, the
     moves' defaults, one cascade a step; slice may accept every proposal),
     with ``loops[...]`` lines for ChEES's mean trajectory length and
     slice's loop iterations over the timed window beside their caps;
     ``zoo[MT-RJ x8]`` (multiple-try birth and death with 8 tries, up to 4
     leaves, the red/blue group stretch: kernel 5 twice a step);
     ``config_d`` (``tests/test_config_d.py``: two branches, a sine and a
     pulse, group stretch and delayed rejection combined, 400 + 400 steps,
     the pulse centre, frequency and wrapped phase as gates) and
     ``modelswap`` (``tests/test_modelswap.py``: 64 x 3 walkers, the
     product-space model swap, 200 + 800 steps, the quadrature model
     probability as gate);
   * ``best_stack[north-star]``: the north-star target under
     ``ChEESHMCMove()`` with DEO swaps and the Syed schedule, 600 steps of
     burn-in (the 500 tuning proposals inside) and 1,200 stored into
     ``DeviceBackend``: ``best_stack_steps_per_s``,
     ``best_stack_ess_per_s``, the cold ``max(tau)`` beside the stretch
     north-star's, the north-star's gates, and no kernel launch;
   * blobs and supplementals through the graphed step:
     ``blobs[north-star]`` (the north-star target through a likelihood that
     returns ``(ll, [-2 ll, x0])`` and divides by a branch supplemental
     ``sigma`` of ones under ``provide_supplemental=True``, an int64 state
     tag ``rid``; 200 warm and 1,200 stored steps: the blob identities on
     every stored sample, ``rid`` a permutation, the north-star's gates,
     one cascade a step and no stretch kernel, ``blobs_steps_per_s`` beside
     ``stored_device_steps_per_s``), ``blobs[lisa-rj-null]`` (the null RJ
     configuration with the leaf count as its blob, equal to
     ``get_nleaves()`` at every sample) and ``replica_flow[cascade]``,
     ``replica_flow[deo]`` (``benchmarks/replica_flow.py``'s 8 x 16
     configuration through ``sample()``, the replica tag in the state
     supplemental: round trips, and per replica per 1k steps);
   * the host side, after the graph-vs-eager phase below and outside the
     check that segments never wait (these steps visit the host by
     design): ``host_like[north-star]`` (the north-star with a NumPy
     likelihood per walker, 100 warm and 300 stored steps: host mode, no
     capture, the fused stretch kernels and the cascade around the host
     calls, the north-star's gates, ``host_like_steps_per_s`` and the host
     ms a step spends inside the user function), ``host_like_vec[...]``
     (the same with ``vectorize=True``), ``host_like_pool[...]`` (per
     walker through a spawn pool of two processes, 50 stored steps: the
     chain and log-likelihoods equal to the serial run digit for digit,
     more than one worker process) and ``hybrid_host[4 x 100]``
     (``benchmarks/hybrid_host.py``'s configuration: the stretch move alone,
     graphed; beside a host MH move at weight 0.1, graphed and with
     ``cuda_graph=False``, equal digit for digit; replays the native slots
     less the first, host proposals the host slots, one cascade a slot);
   * the batched independent ensembles (``ParaEnsembleSampler``, each
     move's step mapped over a group axis, the kernels launched once for
     every group): ``para[north-star x64]`` (64 groups of the north-star
     configuration, 200 steps of burn-in and 1,000 stored: each group's
     cold moments, acceptance, swaps and adapted ladder, the groups' chains
     pairwise different, 3 stretch launches and 1 cascade a step whatever
     the number of groups; ``para_steps_per_s`` and
     ``para_group_steps_per_s`` beside the single north-star's stored
     rate), ``para[zoo x4]`` (``tests/test_para.py:244-272`` on the card:
     ChEES, slice and DEO at 4 x 24, 2-D, 80 + 150 steps, each group's
     moments), ``para[rj_pulse128 x16]`` (config C in 16 groups, 500 + 1,000
     steps: kernels 5 and 3 grouped, each group's leaf-count mode and
     pulse centre), ``para[groups_running]`` (stopped groups frozen bitwise,
     state and stored chain) and ``pickle[north-star]`` (a graphed sampler
     pickled and unpickled: the clone's next 200 steps equal the
     original's digit for digit);
   * ``plot_hook[north-star]``: 200 warm and 1,200 stored steps into
     ``DeviceBackend`` with ``run_mcmc``'s plot hook every 100 stored
     iterations (a generator that reads what ``PlotContainer``'s base and
     tempering groups read, and needs no matplotlib), graphed and with
     ``cuda_graph=False``, and graphed without the hook: fires at 100, ...,
     1,200, the three chains equal digit for digit, every step but the
     first a replay; ``plot_hook_steps_per_s`` beside the unhooked rate,
     each fire's time and the bytes it copied to the host;
   * after the host legs, ``examples[<name>]``: each script of
     ``eryn_tpu_torch/examples`` that needs no matplotlib (``basic_gaussian``,
     ``custom_moves``, ``gradient_moves``, ``multibranch_search``,
     ``nonreversible_pt``, ``pt_evidence``, ``rj_pulse_search``), its
     ``main()`` at full scale with its own assertions: the kernels it runs
     were launched (``EXAMPLE_KERNELS``), and ``custom_moves``'s host route
     reached ``get_proposal`` while its in-graph route was captured;
     ``runtime_plots`` runs only where matplotlib is installed (a line says
     so when it is not);
   * after the examples, the device mesh (``parallel.mesh``; ranks spawned
     over ``torch.distributed``; every sharded step planned on the device,
     eager over gloo; each mesh leg prints its window of stored steps
     apart from the set-up and the burn-in):
     ``mesh[north-star,1rank,nccl]``, ``mesh[north-star,4rank,gloo]`` (a
     (2, 2) mesh of four ranks sharing the card, and DEO),
     ``para_mesh[north-star x64,4rank]``, and on a (2, 2) mesh of four
     ranks ``mesh[lisa-rj-null,4rank,gloo]`` and ``mesh[lisa-rj,4rank,gloo]``
     (the LISA-style RJ configuration with the null and the 8192-point
     likelihood: the group stretch's kernel 5 on each rank's view of its
     temperatures, births and deaths, the cascade) and
     ``mesh[redblue-zoo,4rank,gloo]`` (the north-star with DE, DE-snooker,
     walk and KDE at 0.25 each), 20 + 100 steps each: every chain equal to
     its one-rank eager chain digit for digit (the heavy leg, where it
     drifts, held to the LISA gates with its first differing step), kernels
     5 and 3 launched by every rank; the rest of the move zoo
     (``mesh[slice|gradient-zoo|mh-zoo|modelswap-mtrj,4rank,gloo]``); and
     the rest of the sampler's surface (``mesh_surface_legs``, 10 + 40
     steps each on a (2, 2) mesh): ``mesh[general-cascade,4rank,gloo]``
     (``permute=False``), ``mesh[general-stretch,4rank,gloo]`` (a periodic
     dimension and four splits), ``mesh[blobs,4rank,gloo]`` (blobs, a
     branch supplemental and a host object), ``mesh[host,4rank,gloo]`` (a
     NumPy likelihood, SciPy priors and a legacy host ``MHMove`` at 0.1)
     and ``mesh[resume-hooks,4rank,gloo]`` (the update, stopping and plot
     hooks, stopped at 25 stored steps and continued by a fresh sampler
     from its ``Backend()``), each chain against its one-rank eager chain
     and each rank's launches against that chain's; and users' own move
     subclasses, none declaring itself sharded (``mesh_custom_legs``, 10
     + 40 steps each on a (2, 2) mesh): ``mesh[custom-mh,4rank,gloo]`` (the
     custom-moves example's ``KernelJumpMove``: its proposal on the gathered
     coordinates, its likelihood on the rank's rows),
     ``mesh[custom-stretch,4rank,gloo]`` (a bare ``StretchMove`` subclass,
     whole in every rank: the fused kernels 1-2 and kernel 3),
     ``mesh[custom-combine,4rank,gloo]``
     (``CombineMove([KernelJumpMove(), StretchMove()])``, and
     ``DelayedRejection`` around a bare ``GaussianMove`` subclass at 0.2)
     and ``mesh[custom-rj,4rank,gloo]`` (config C with a bare
     ``DistributionGenerateRJ`` subclass beside ``RedBlueGroupStretchMove``:
     kernel 5 in every rank), each chain equal to its one-rank eager chain
     digit for digit (a difference ends the script) and each rank's
     launches of kernels 1, 2, 3 and 5 equal to that chain's; and the
     sharded route captured with its NCCL collectives on one NCCL rank, a
     ``(1, 1)`` mesh (``mesh_graph_legs``: NCCL takes one rank per card):
     ``mesh_graph[north-star,1x1,nccl]`` (50 + 400 steps),
     ``mesh_graph[lisa-rj,1x1,nccl]`` (20 + 100), and every other native
     move captured: ``mesh_graph[zoo,1x1,nccl]`` (slice, MALA, HMC,
     ChEES-HMC and AIMH at equal weights under the cascade, 30 + 120, the
     stored window crossing ``tune_steps``), ``mesh_graph[best-stack,1x1,
     nccl]`` (``ChEESHMCMove()``, DEO and the Syed ladder, 20 + 80, the
     window crossing ``tune_steps``), ``mesh_graph[general,1x1,nccl]``
     (the general-path stretch with a periodic dimension in four splits,
     DE, DE-snooker, walk, KDE, ``GaussianMove``, ``GroupStretchMove``
     refreshing in the window, a bare ``StretchMove`` subclass and the
     custom-moves example's ``KernelJumpMove`` on the two gathered routes,
     ``DelayedRejection`` around a bare ``GaussianMove`` subclass and a
     ``CombineMove``, 80 + 160), ``mesh_graph[mt-rj,1x1,nccl]`` and
     ``mesh_graph[modelswap,1x1,nccl]`` (20 + 60 and 20 + 80), each
     captured, then eager, from one seed: the chains equal digit for digit,
     graphs replayed (two for each move with a host phase, tuning and
     tuned or a refresh due and not, one for any other), the stored
     segments under ``set_sync_debug_mode("error")``, each replay's
     collectives counted, the kernels' launches inside the replays (kernel
     3 in the zoo's, kernels 1, 2, 3 or 3 and 5 in the profile of the
     replays beside the one-process graphed step's), and the window's
     steps/s captured and eager with the burn-in (NCCL's warm-up, the
     captures) apart;
   * a flat-likelihood RJ run (64 walkers, 3 leaves): a uniform leaf-count
     posterior.  It checks the RJ moves, is not part of the main path, and
     its launches stay out of the report.

   The launch counters must show that every step went through the kernels
   (one cascade launch per tempering phase, none under DEO), every
   schedule entry must be a replay of its move's graph (but the first of
   each, which runs eagerly), no leg may call a plain version of a kernel,
   and each chain must meet its target.  Then graph vs eager: the first
   four legs, the blob leg (blobs, ``rid``, ``sigma`` and a host object
   compared too), the DEO leg, the zoo's ``CombineMove`` and MT-RJ legs, and
   its MALA and AIMH legs and ``para[north-star x64]`` at a quarter of
   their depth, its jittered HMC (3 to 7 steps), ChEES and slice legs at a
   tenth (``tune_steps`` 150) from one seed, with
   ``cuda_graph=False`` and graphed; their chains, ladders, clocks, accept and swap counts and
   kernel states must be equal digit for digit, and their host time per step, replays per
   step and steps/s are printed side by side;
5. profiles (``torch.profiler``, after every timed run): each kernel's
   device time per launch, 50 steady steps of the first four legs, the DEO
   leg, ``rj_pulse128``, the zoo's ``CombineMove`` and MT-RJ legs,
   ``config_d`` and ``modelswap`` graphed (10 steps of the best stack and
   the zoo's slice leg, about 3,000 device ops a step each), the host
   likelihood legs (10 steps per walker, 50 vectorized), the hybrid leg
   and ``para[north-star x64]``, and of the
   graph-vs-eager legs eager (20 steps, 5 of jittered HMC, ChEES and
   slice: an eager step's trace holds several host events a device op)
   (device kernels, memcpys and memsets per step, what the host launched
   per step, device-busy share, the top five device ops), and the device
   time of one tempering phase, cascade beside DEO (``phase[...]``).

The second-to-last line of standard output is a JSON object describing the
kernels, the last ``{"ok": true, "device": {...}}``.  Any failure raises and
exits nonzero; without CUDA, or outside a checkout, it exits 2 and prints no
result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

NT, NW, NDIM = 10, 100, 5
NOSTORE_STEPS = 1500
STORED_STEPS = 1200
WARM_STEPS = 200
# config E (bench.py:278-308)
E_NT, E_NW, E_STEPS, E_WARM = 20, 1000, 1000, 200
# LISA-style RJ (benchmarks/lisa_style.py:36-96, heavy=True)
L_NPTS, L_NLMAX, L_NT, L_NW, L_STEPS, L_WARM = 8192, 8, 10, 200, 1200, 100
# config C (bench.py:225-275): the 128-point pulse search, RJ_NSTEPS steps
P_NPTS, P_NLMAX, P_STEPS = 128, 4, 2000
# the tempered-analysis legs: DEO swaps with the Syed schedule, and a fixed
# ladder that ends at beta = 0 for the evidence of the 5-D unit Gaussian in
# U(-5, 5)^5, 2.5 ln(2 pi) - 5 ln(10)
DEO = dict(swap_scheme="deo", adaptation_scheme="syed")
# the move zoo (benchmarks/move_zoo_timing.py:27-28,31-114): 10 x 100, the
# 5-D unit Gaussian in U(-5, 5)^5, seed 10; its MT-RJ leg (:117-166): up to
# 4 leaves, seed 11
Z_SEED, Z_RJ_SEED, Z_NLMAX = 10, 11, 4
Z_WARM, Z_STEPS, Z_STORED = 200, 1000, 1000
# graph-vs-eager's capped-loop legs: tune_steps, inside their 20 + 100 +
# 100 steps' stored hundred
GVE_TUNE = 150
# the best stack (VERDICT.md:290-296): ChEES-HMC under DEO and the Syed
# schedule on the north-star target, 600 steps of burn-in, then stored
BS_SEED, BS_BURN = 12, 600
# config D (tests/test_config_d.py:22-96) and the model swap
# (tests/test_modelswap.py:153-181) at their own shapes and depths
D_NT, D_NW, D_BURN, D_STEPS = 3, 36, 400, 400
S_NT, S_NW, S_BURN, S_STEPS = 3, 64, 200, 800
# benchmarks/replica_flow.py:45-83: 8 x 16, 3-D, U(-7, 7)^3, a fixed
# ladder, 1,200 steps, seed 17, the start drawn from default_rng(99)
R_NT, R_NW, R_NDIM, R_STEPS, R_SEED = 8, 16, 3, 1200, 17
EVIDENCE = dict(Tmax=math.inf, adaptive=False)
LOG_Z = 2.5 * math.log(2.0 * math.pi) - 5.0 * math.log(10.0)
# float32: a few ulp (exp/log of the two code paths may differ); float64
# likewise scaled
TOL = {"float32": 1e-6, "float64": 1e-12}
# (nt, nw, D) of the stretch kernels' checks: north-star, config E, an odd
# shape, and halves of more than 1024 walkers (the block loops)
STRETCH_SHAPES = ((NT, NW, NDIM), (E_NT, E_NW, NDIM), (8, 99, 13),
                  (3, 4001, 5))
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


def _tree_args(torch, rand, randn, gen, nt, nw, nleaves, ndim, dtype):
    """The sampler's swap tree (coords ``(nt, nw, nleaves, ndim)``, a bool
    leaf mask, the log-prior), its log-likelihood and ladder, and the draws
    of one cascade; then outputs like them, the accepted counts and the
    accept mask."""
    logl = randn(nt, nw) * 10
    leaves = [randn(nt, nw, nleaves, ndim), rand(nt, nw, nleaves) < 0.4,
              randn(nt, nw)]
    args = (
        logl, leaves, torch.logspace(0, -2, nt, dtype=dtype, device="cuda"),
        torch.randperm(nw, generator=gen, device=gen.device).cuda(),
        torch.randint(0, nw, (nt - 1,), generator=gen, dtype=torch.int32,
                      device=gen.device).cuda(),
        torch.log(rand(nt - 1, nw)),
    )

    def outs():
        return (torch.empty_like(logl), [torch.empty_like(x) for x in leaves],
                torch.empty(nt - 1, dtype=dtype, device="cuda"),
                torch.empty((nt - 1, nw), dtype=dtype, device="cuda"))

    return args, outs


def _flat(outs):
    return (outs[0], *outs[1], outs[2], outs[3])


def _mixed_tree_args(torch, rand, randn, gen, nt, nw, nleaves, dtype):
    """The north-star tree with the leaves blobs and supplementals add to
    it (float blobs of width 2, an int64 tag, a float64 entry, a bool flag;
    these kinds repeated up to ``nleaves`` leaves in all); as
    :func:`_tree_args`."""
    args, _ = _tree_args(torch, rand, randn, gen, nt, nw, 1, NDIM, dtype)
    logl, leaves = args[0], list(args[1])
    kinds = (
        lambda: randn(nt, nw, 2),
        lambda: torch.randint(-2**40, 2**40, (nt, nw), generator=gen,
                              dtype=torch.int64, device=gen.device).cuda(),
        lambda: torch.randn((nt, nw, 3), generator=gen, dtype=torch.float64,
                            device=gen.device).cuda(),
        lambda: rand(nt, nw) < 0.5,
    )
    while len(leaves) < nleaves:
        leaves.append(kinds[(len(leaves) - 3) % len(kinds)]())
    args = (logl, leaves) + args[2:]

    def outs():
        return (torch.empty_like(logl), [torch.empty_like(x) for x in leaves],
                torch.empty(nt - 1, dtype=dtype, device="cuda"),
                torch.empty((nt - 1, nw), dtype=dtype, device="cuda"))

    return args, outs


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


def _stretch_state(torch, rand, randn, gen, dtype, nt, nw, D):
    """Walker-order state and draws of one fused step, and each half's
    likelihood and prior values (with NaN and -inf in them)."""
    n0 = nw - nw // 2
    st = dict(
        X=randn(nt, nw, D), logl=randn(nt, nw) * 3, logp=randn(nt, nw),
        ndim_act=torch.full((nt, nw), float(D), dtype=dtype, device="cuda"),
        perm=torch.randperm(nw, generator=gen, device=gen.device).cuda(),
        u_all=rand(2, 3, nt, nw),
        betas=torch.linspace(1.0, 0.0, nt, dtype=dtype, device="cuda"),
    )
    new = []
    for ns in (n0, nw - n0):
        ll, lp = randn(nt, ns) * 3, randn(nt, ns)
        ll[0, :3] = float("nan")
        ll[-1, :3] = float("-inf")
        lp[1, 0] = float("-inf")
        new.append((ll, lp))
    return st, new


def _stretch_step_pair(torch, sk, rand, randn, gen, dtype, nt, nw, D,
                       log_proposal):
    """One fused step through the three stretch kernels and through their
    plain versions, each stage fed the kernel path's inputs; yields
    ``(kernel, kernel outputs, plain outputs, n)`` per stage, of which the
    first ``n`` outputs are proposals (equal within the tolerance) and the
    rest accept results (bitwise equal)."""
    st, new = _stretch_state(torch, rand, randn, gen, dtype, nt, nw, D)
    X, nd, perm, u = st["X"], st["ndim_act"], st["perm"], st["u_all"]
    kw = dict(a=2.0, log_proposal=log_proposal)
    nan = float("nan")
    outs_k = (torch.full_like(X, nan),
              *(torch.full_like(st["logl"], nan) for _ in range(3)))
    outs_r = tuple(x.clone() for x in outs_k)
    q0, f0 = sk.stretch_propose(X, X, nd, perm, u, 0, **kw)
    yield ("stretch_propose", (q0, f0),
           sk.stretch_propose_ref(X, X, nd, perm, u, 0, **kw), 2)
    acc_args = (q0, X, *new[0], st["logl"], st["logp"], f0, st["betas"], nd,
                perm, u)
    q1, f1 = sk.stretch_accept_propose(*acc_args, *outs_k, **kw)
    q1r, f1r = sk.stretch_accept_propose_ref(*acc_args, *outs_r, **kw)
    yield ("stretch_accept_propose", (q1, f1, *outs_k), (q1r, f1r, *outs_r),
           2)
    args = (q1, X, *new[1], st["logl"], st["logp"], f1, st["betas"], perm, u,
            1)
    sk.stretch_accept(*args, *outs_k)
    sk.stretch_accept_ref(*args, *outs_r)
    # every walker written by one of the two halves
    assert not outs_k[0].isnan().any() and not outs_k[3].isnan().any()
    acc = float(outs_k[3].sum())
    assert 0 < acc < outs_k[3].numel(), acc
    yield "stretch_accept", outs_k, outs_r, 0


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

    for nt, nw, D in STRETCH_SHAPES:
        for log_proposal in (False, True):
            for name, outs_k, outs_r, n in _stretch_step_pair(
                    torch, sk, rand, randn, gen, dtype, nt, nw, D, log_proposal):
                for i, (a, b) in enumerate(zip(outs_k, outs_r)):
                    # a different complement pick would move q by O(1), far
                    # outside the tolerance: q agreeing means the picks
                    # agree; accept decisions and merged values are bitwise
                    t = tol if i < n else 0.0
                    torch.testing.assert_close(a, b, rtol=t, atol=t,
                                               equal_nan=True)
                record(name, outs_k, outs_r)

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

    # the tree form, the sampler's entry: the north-star tree at the
    # north-star and config E sizes, the RJ tree, the block loops (more than
    # 1024 walkers), the first rolled size; at two sizes also in one block
    # and with the rows in global memory
    for nt, nw, nl, nd, forms in (
        (NT, NW, 1, NDIM, ("grid", "one block", "global")),
        (E_NT, E_NW, 1, NDIM, ("grid", "one block", "global")),
        (L_NT, L_NW, L_NLMAX, 3, ("grid",)),
        (3, 1500, 1, NDIM, ("grid", "global")),
        (3, 4001, 1, NDIM, ("grid",)),
        (3, 641, 1, NDIM, ("grid",)),
    ):
        name = ("_cascade_multi_rolled" if nw > pt_swap.ROLLED_THRESHOLD
                else "pt_swap_cascade_multi")
        args, outs = _tree_args(torch, rand, randn, gen, nt, nw, nl, nd, dtype)
        out_r = outs()
        pt_swap.pt_swap_cascade_tree_ref(*args, *out_r)
        assert 0 < out_r[2].sum() < (nt - 1) * nw
        for form in forms:
            out_k = outs()
            limit = pt_swap.SHARED_LIMIT
            if form == "global":
                pt_swap.SHARED_LIMIT = 0
            try:
                pt_swap.pt_swap_cascade_tree(
                    *args, *out_k, chunk=nw if form == "one block" else None)
            finally:
                pt_swap.SHARED_LIMIT = limit
            for a, b in zip(_flat(out_k), _flat(out_r)):
                assert a.dtype == b.dtype and torch.equal(a, b), (
                    f"{name} (tree form, {form}) is not bitwise at "
                    f"{(nt, nw)}")
            record(name, _flat(out_k), _flat(out_r))

    # the tree with blobs and supplementals in it: 7 leaves of mixed dtypes,
    # and 40 (two launches of at most 32 leaves, on the same draws), at the
    # north-star size and, rolled, at config E's
    for nt, nw in ((NT, NW), (E_NT, E_NW)):
        name = ("_cascade_multi_rolled" if nw > pt_swap.ROLLED_THRESHOLD
                else "pt_swap_cascade_multi")
        counter = getattr(pt_swap, name)
        for nleaves in (7, 40):
            args, outs = _mixed_tree_args(torch, rand, randn, gen, nt, nw,
                                          nleaves, dtype)
            out_k, out_r = outs(), outs()
            before = counter.launches
            pt_swap.pt_swap_cascade_tree(*args, *out_k)
            groups = counter.launches - before
            assert groups == -(-nleaves // pt_swap.MAX_LEAVES), groups
            pt_swap.pt_swap_cascade_tree_ref(*args, *out_r)
            for a, b in zip(_flat(out_k), _flat(out_r)):
                assert a.dtype == b.dtype and torch.equal(a, b), (
                    f"{name} with {nleaves} mixed leaves is not bitwise at "
                    f"{(nt, nw)}")
            assert 0 < out_r[2].sum() < (nt - 1) * nw
            record(name, _flat(out_k), _flat(out_r))

    # the selection only moves values: equal (a -0.0 may stand for +0.0)
    half = L_NW // 2 * L_NLMAX
    for nt, Q, M, nd in ((L_NT, half, half, 3), (2, 130, 257, 3)):
        args = _select_args(torch, rand, randn, nt, Q, M, nd)
        out_k = select_kernels.onehot_select(*args)
        out_r = select_kernels.onehot_select_ref(*args)
        assert torch.equal(out_k, out_r), "onehot_select disagrees"
        assert out_k[0].any() and not out_k[-1].any()
        record("onehot_select", (out_k,), (out_r,))
    # the group-stretch proposal repeats its plain version operation for
    # operation: equal, NaN (dormant slots) in the same places
    for case in GROUP_CASES:
        case = dict(case)
        log_proposal = case.pop("log_proposal", False)
        args, kw = _group_args(torch, rand, randn, dtype, **case)
        kw["log_proposal"] = log_proposal
        q_k, f_k = select_kernels.group_stretch_propose(*args, **kw)
        q_r, f_r = select_kernels.group_stretch_propose_ref(*args, **kw)
        outs_k = (f_k, *q_k.values())
        outs_r = (f_r, *q_r.values())
        record("group_stretch_propose", outs_k, outs_r)
        assert errs["group_stretch_propose"] == 0.0, (
            f"group_stretch_propose disagrees at {case}")
        for a, b in zip(outs_k, outs_r):
            assert torch.equal(a.isnan(), b.isnan())
        s, si = args[0], args[1]
        for n in s:
            assert torch.equal(q_k[n][~si[n]].isnan(), s[n][~si[n]].isnan())
            assert (q_k[n][0][si[n][0]] != s[n][0][si[n][0]]).any()
    # the launch of a (2, 2) mesh rank of the LISA legs: its five
    # temperatures of the whole permuted ensemble
    args, kw = _group_args(torch, rand, randn, dtype, **GROUP_SHARDED)
    q_k, f_k = select_kernels.group_stretch_propose(*args, **kw)
    q_r, f_r = select_kernels.group_stretch_propose_ref(*args, **kw)
    record("group_stretch_propose[sharded]", (f_k, *q_k.values()),
           (f_r, *q_r.values()))
    assert errs["group_stretch_propose[sharded]"] == 0.0, (
        "group_stretch_propose disagrees at a mesh rank's shape")
    # and of a (2, 2) mesh rank of the zoo's MT-RJ chain, both blocks
    for case in GROUP_SHARDED_MTRJ:
        args, kw = _group_args(torch, rand, randn, dtype, **case)
        q_k, f_k = select_kernels.group_stretch_propose(*args, **kw)
        q_r, f_r = select_kernels.group_stretch_propose_ref(*args, **kw)
        record("group_stretch_propose[sharded mt-rj]", (f_k, *q_k.values()),
               (f_r, *q_r.values()))
        for a, b in zip((f_k, *q_k.values()), (f_r, *q_r.values())):
            assert torch.equal(a.isnan(), b.isnan())
    assert errs["group_stretch_propose[sharded mt-rj]"] == 0.0, (
        "group_stretch_propose disagrees at an MT-RJ mesh rank's shape")
    # and of a (2, 2) mesh rank of the custom RJ leg (config C), both blocks
    for case in GROUP_SHARDED_CONFIG_C:
        args, kw = _group_args(torch, rand, randn, dtype, **case)
        q_k, f_k = select_kernels.group_stretch_propose(*args, **kw)
        q_r, f_r = select_kernels.group_stretch_propose_ref(*args, **kw)
        record("group_stretch_propose[sharded config-c]",
               (f_k, *q_k.values()), (f_r, *q_r.values()))
        for a, b in zip((f_k, *q_k.values()), (f_r, *q_r.values())):
            assert torch.equal(a.isnan(), b.isnan())
    assert errs["group_stretch_propose[sharded config-c]"] == 0.0, (
        "group_stretch_propose disagrees at a config C mesh rank's shape")
    torch.cuda.synchronize()
    return errs


# group_stretch_propose on a (2, 2) mesh rank of the LISA legs: half the
# temperatures, every walker of the view, block 0 of the split
GROUP_SHARDED = dict(nt=L_NT // 2, nw=L_NW, shapes={"m": (L_NLMAX, 3)},
                     off=0, ns=L_NW // 2)
# ... and on a (2, 2) mesh rank of the zoo's MT-RJ chain
# (mesh[modelswap-mtrj]): half the temperatures of the 100-walker view,
# 4 leaves of 5 dimensions, each block of the split
GROUP_SHARDED_MTRJ = tuple(
    dict(nt=NT // 2, nw=NW, shapes={"model_0": (Z_NLMAX, NDIM)}, off=off,
         ns=NW // 2) for off in (0, NW // 2))
# ... and on a (2, 2) mesh rank of config C (mesh[custom-rj]): half the
# temperatures of the 100-walker view, 4 pulse leaves of 3 parameters, each
# block of the split
GROUP_SHARDED_CONFIG_C = tuple(
    dict(nt=NT // 2, nw=NW, shapes={"model_0": (P_NLMAX, 3)}, off=off,
         ns=NW // 2) for off in (0, NW // 2))

# group_stretch_propose's checks: the RJ shape (both blocks of the split),
# then two branches with a Gibbs per-leaf table, an empty complement on one
# temperature, one periodic dimension and the log proposal, then the zoo's
# MT-RJ shape on one process (both blocks); every case has pick draws of
# exactly 1, which force k + 1 > cnt
GROUP_CASES = (
    dict(nt=L_NT, nw=L_NW, shapes={"m": (L_NLMAX, 3)}, off=0, ns=L_NW // 2),
    dict(nt=L_NT, nw=L_NW, shapes={"m": (L_NLMAX, 3)}, off=L_NW // 2,
         ns=L_NW // 2),
    dict(nt=3, nw=37, shapes={"m": (4, 2), "n": (3, 3)}, off=13, ns=12,
         empty=1, periodic=True, gibbs=True, log_proposal=True),
    *(dict(nt=NT, nw=NW, shapes={"model_0": (Z_NLMAX, NDIM)}, off=off,
           ns=NW // 2) for off in (0, NW // 2)),
)


def _group_args(torch, rand, randn, dtype, nt, nw, shapes, off, ns,
                empty=None, periodic=False, gibbs=False, overflow=True):
    """A permuted ensemble of the branches ``shapes`` ``{name: (nl, nd)}``
    with NaN in dormant slots and the draws of block ``[off, off + ns)``, as
    the arguments of ``group_stretch_propose``; with ``overflow`` every
    seventh pick draw is exactly 1."""
    coords, inds, uu, per_leaf, periods = {}, {}, {}, {}, {}
    for name, (nl, nd) in shapes.items():
        m = rand(nt, nw, nl) < 0.4
        if empty is not None:
            m[empty] = False
        x = randn(nt, nw, nl, nd)
        x[~m] = float("nan")
        coords[name], inds[name] = x, m
        uu[name] = rand(nt, ns, nl)
        if overflow:
            uu[name].view(-1)[::7] = 1.0
        per_leaf[name] = (torch.floor(rand(nl) * (nd + 1)) if gibbs else None)
        periods[name] = None
        if periodic:
            periods[name] = torch.full((nd,), float("inf"), dtype=dtype,
                                       device="cuda")
            periods[name][0] = 1.5
    blk = slice(off, off + ns)
    return ({n: x[:, blk] for n, x in coords.items()},
            {n: x[:, blk] for n, x in inds.items()}, coords, inds,
            rand(nt, ns), uu, (off, ns)), dict(per_leaf=per_leaf,
                                               periods=periods)


def _group_bytes_ops(torch, args):
    """Bytes ``group_stretch_propose`` must move for these inputs and its
    operations: the masks of both halves, the moving rows, the distinct
    complement rows this run's draws pick, ``u``, ``uu``, ``q`` and the
    factors; per moving leaf the stretch factor (4 operations), the pick (a
    product, a floor and a search over the word prefixes) and 3 operations a
    coordinate, per walker the factor (a logarithm, a product and an add a
    leaf)."""
    s, si, c, ci, u, uu, (off, ns) = args
    nbytes = 2 * _nbytes(u)  # u read, the factors written
    ops = 0
    for n in s:
        nt, rows, nl, nd = c[n].shape
        comp = torch.cat([ci[n][:, :off], ci[n][:, off + ns:]], 1).reshape(nt, -1)
        cs = torch.cumsum(comp, dim=-1)
        cnt = cs[:, -1:]
        k1 = torch.floor(uu[n].reshape(nt, -1)
                         * cnt.clamp(min=1).to(u.dtype)).long() + 1
        idx = torch.searchsorted(cs, k1).clamp_(max=cs.shape[1] - 1)
        hit = (k1 <= cnt) & si[n].reshape(nt, -1)
        picked = torch.unique(
            (idx + torch.arange(nt, device=idx.device)[:, None] * cs.shape[1]
             )[hit]).numel()
        itemsize = u.element_size()
        nbytes += (ci[n].numel() + uu[n].numel() * itemsize
                   + (2 * s[n].numel() + picked * nd) * itemsize)
        words = -(-comp.shape[1] // 32)
        ops += nt * ns * nl * (4 + 2 + math.ceil(math.log2(max(words, 2)))
                               + 3 * nd) + nt * ns * (2 + nl)
    return nbytes, ops


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def time_kernels(torch):
    """Each kernel and its plain version at the main path's shapes, float32:
    ``({name: {"ms", "plain_ms", "bound_ms", "bound_by"}}, {name: call})``,
    with ``"empty_launch"`` (an empty kernel: the launch floor) beside
    them.  ``ms`` is per wrapper call, back to back between CUDA events; the
    calls are for :func:`device_times`."""
    from eryn_tpu_torch.ops import _build, pt_swap, select_kernels
    from eryn_tpu_torch.ops import stretch_kernels as sk

    g = torch.Generator(device="cuda").manual_seed(7)
    f32 = dict(device="cuda", dtype=torch.float32)

    def rand(*shape):
        return torch.rand(shape, generator=g, **f32)

    def randn(*shape):
        return torch.randn(shape, generator=g, **f32)

    # name: (kernel call, plain call, bytes the function must move, ops)
    calls = {}
    # the north-star step, and config E's under names of their own
    for tag, nt, nw in (("", NT, NW), ("@E", E_NT, E_NW)):
        st, new = _stretch_state(torch, rand, randn, g, torch.float32, nt,
                                 nw, NDIM)
        X, nd, perm, u = st["X"], st["ndim_act"], st["perm"], st["u_all"]
        outs = (torch.empty_like(X),
                *(torch.empty_like(st["logl"]) for _ in range(3)))
        q0, f0 = sk.stretch_propose(X, X, nd, perm, u, 0)
        acc0 = (q0, X, *new[0], st["logl"], st["logp"], f0, st["betas"], nd,
                perm, u, *outs)
        q1, f1 = sk.stretch_accept_propose(*acc0)
        acc1 = (q1, X, *new[1], st["logl"], st["logp"], f1, st["betas"], perm,
                u, 1, *outs)
        b = _stretch_bytes(torch, nt, nw, NDIM, 4, u)
        # propose: z (4 ops), pick (2), q (3 per coordinate), factor (3);
        # accept: two tempered sums, the difference, log u, compare (10
        # ops), and a select per coordinate
        n0, n1 = nw - nw // 2, nw // 2
        ops_p, ops_a = 3 * NDIM + 9, NDIM + 10
        calls["stretch_propose" + tag] = (
            lambda a=(X, X, nd, perm, u, 0): sk.stretch_propose(*a),
            lambda a=(X, X, nd, perm, u, 0): sk.stretch_propose_ref(*a),
            b["propose"], nt * n0 * ops_p)
        calls["stretch_accept_propose" + tag] = (
            lambda a=acc0: sk.stretch_accept_propose(*a),
            lambda a=acc0: sk.stretch_accept_propose_ref(*a),
            b["accept_propose"], nt * (n0 * ops_a + n1 * ops_p))
        calls["stretch_accept" + tag] = (
            lambda a=acc1: sk.stretch_accept(*a),
            lambda a=acc1: sk.stretch_accept_ref(*a),
            b["accept"], nt * n1 * ops_a)
    # the sampler's cascade (the tree form) at the three legs' shapes: every
    # leaf and the log-likelihood read and written once, pi, shifts, raccept
    # and the ladder read once, the accepted counts written; per rung and
    # walker a difference, a product and a compare.  Beside each, the same
    # launch with one block moving the whole payload
    for name, (nt, nw, nl, nd) in (
        ("pt_swap_cascade_multi", (NT, NW, 1, NDIM)),
        ("pt_swap_cascade_multi@rj", (L_NT, L_NW, L_NLMAX, 3)),
        ("_cascade_multi_rolled", (E_NT, E_NW, 1, NDIM)),
    ):
        args, outs = _tree_args(torch, rand, randn, g, nt, nw, nl, nd,
                                torch.float32)
        o = outs()[:3]
        nbytes = (2 * _nbytes(args[0], *args[1]) + _nbytes(*args[2:], o[2]))
        ops = 3 * (nt - 1) * nw
        calls[name] = (
            lambda a=args, o=o: pt_swap.pt_swap_cascade_tree(*a, *o),
            lambda a=args, o=o: pt_swap.pt_swap_cascade_tree_ref(*a, *o),
            nbytes, ops)
        calls[name + "[one block]"] = (
            lambda a=args, o=o, nw=nw: pt_swap.pt_swap_cascade_tree(
                *a, *o, chunk=nw), None, nbytes, ops)
    # the tree with blobs and supplementals in it at the north-star size:
    # 7 leaves of mixed dtypes, and 40 in two launches (each repeats the
    # decisions; the bound counts them once)
    for nleaves in (7, 40):
        args, outs = _mixed_tree_args(torch, rand, randn, g, NT, NW, nleaves,
                                      torch.float32)
        o = outs()[:3]
        nbytes = (2 * _nbytes(args[0], *args[1]) + _nbytes(*args[2:], o[2]))
        calls[f"pt_swap_cascade_multi[{nleaves} mixed leaves]"] = (
            lambda a=args, o=o: pt_swap.pt_swap_cascade_tree(*a, *o),
            lambda a=args, o=o: pt_swap.pt_swap_cascade_tree_ref(*a, *o),
            nbytes, 3 * (NT - 1) * NW)
    # the channel form (the JAX kernels' signatures), which the sampler no
    # longer calls
    for name, kernel, plain, (nt, nw, D) in (
        ("pt_swap_cascade_multi[channels]", pt_swap.pt_swap_cascade_multi,
         pt_swap.pt_swap_cascade_multi_ref, (NT, NW, NDIM + 2)),
        ("pt_swap_cascade_multi[channels]@rj", pt_swap.pt_swap_cascade_multi,
         pt_swap.pt_swap_cascade_multi_ref, (L_NT, L_NW, 4 * L_NLMAX + 1)),
        ("_cascade_multi_rolled[channels]", pt_swap._cascade_multi_rolled,
         pt_swap._cascade_multi_rolled_ref, (E_NT, E_NW, NDIM + 2)),
    ):
        args = _cascade_args(torch, rand, randn, None, nt, nw, D, torch.float32)
        calls[name] = (lambda k=kernel, a=args: k(*a),
                       lambda p=plain, a=args: p(*a),
                       _nbytes(*args, *kernel(*args)), 3 * (nt - 1) * nw)
    half = L_NW // 2 * L_NLMAX
    sel_args = _select_args(torch, rand, randn, L_NT, half, half, 3,
                            empty_last=False)
    # per entry a compare for the mask, per query a search over the
    # ceil(M / 32) word prefixes and the n-th set bit of one word
    calls["onehot_select"] = (
        lambda: select_kernels.onehot_select(*sel_args),
        lambda: select_kernels.onehot_select_ref(*sel_args),
        _nbytes(*sel_args, select_kernels.onehot_select(*sel_args)),
        L_NT * (half + half * (math.ceil(math.log2(half / 32)) + 2)),
    )
    # the sampler's proposal at the RJ shape: block 0 of the split
    grp_args, grp_kw = _group_args(torch, rand, randn, torch.float32,
                                   **GROUP_CASES[0], overflow=False)
    calls["group_stretch_propose"] = (
        lambda: select_kernels.group_stretch_propose(*grp_args, **grp_kw),
        lambda: select_kernels.group_stretch_propose_ref(*grp_args, **grp_kw),
        *_group_bytes_ops(torch, grp_args),
    )
    # a (2, 2) mesh rank's launch in the LISA legs
    shd_args, shd_kw = _group_args(torch, rand, randn, torch.float32,
                                   **GROUP_SHARDED, overflow=False)
    calls["group_stretch_propose[sharded]"] = (
        lambda: select_kernels.group_stretch_propose(*shd_args, **shd_kw),
        lambda: select_kernels.group_stretch_propose_ref(*shd_args, **shd_kw),
        *_group_bytes_ops(torch, shd_args),
    )
    # a (2, 2) mesh rank's launch in the zoo's MT-RJ chain, block 0
    mtrj_args, mtrj_kw = _group_args(torch, rand, randn, torch.float32,
                                     **GROUP_SHARDED_MTRJ[0], overflow=False)
    calls["group_stretch_propose[sharded mt-rj]"] = (
        lambda: select_kernels.group_stretch_propose(*mtrj_args, **mtrj_kw),
        lambda: select_kernels.group_stretch_propose_ref(*mtrj_args,
                                                         **mtrj_kw),
        *_group_bytes_ops(torch, mtrj_args),
    )
    # a (2, 2) mesh rank's launch in the custom RJ leg (config C), block 0
    cc_args, cc_kw = _group_args(torch, rand, randn, torch.float32,
                                 **GROUP_SHARDED_CONFIG_C[0], overflow=False)
    calls["group_stretch_propose[sharded config-c]"] = (
        lambda: select_kernels.group_stretch_propose(*cc_args, **cc_kw),
        lambda: select_kernels.group_stretch_propose_ref(*cc_args, **cc_kw),
        *_group_bytes_ops(torch, cc_args),
    )
    empty = _build.function("eryn_empty_launch", "p")

    def launch_empty():
        _build.check(empty(torch.cuda.current_stream().cuda_stream), "empty")

    times = {"empty_launch": {"ms": _time_ms(launch_empty, reps=1000)}}
    for name, (run_k, run_r, nbytes, ops) in calls.items():
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / F32_OPS_PER_S * 1e3
        times[name] = {
            "ms": _time_ms(run_k),
            "plain_ms": _time_ms(run_r, reps=50) if run_r else None,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        }
    return times, {**{k: c[0] for k, c in calls.items()},
                   "empty_launch": launch_empty}


def cascade_scan(torch, card, reps=100):
    """Device time per launch of the sampler's cascade against the number of
    rungs, of walkers and of walkers in a block's chunk (``torch.profiler``),
    float32, the north-star tree and the RJ tree: what a rung costs, what
    the launch and the move cost, and what the grid is worth."""
    from eryn_tpu_torch.ops import pt_swap

    g = torch.Generator(device="cuda").manual_seed(7)
    f32 = dict(device="cuda", dtype=torch.float32)

    def rand(*shape):
        return torch.rand(shape, generator=g, **f32)

    def randn(*shape):
        return torch.randn(shape, generator=g, **f32)

    calls = {}
    for nt, nw, nl, nd in ((2, 100, 1, 5), (10, 100, 1, 5), (20, 100, 1, 5),
                           (10, 200, 8, 3), (2, 1000, 1, 5), (10, 1000, 1, 5),
                           (20, 1000, 1, 5), (20, 2000, 1, 5)):
        args, outs = _tree_args(torch, rand, randn, g, nt, nw, nl, nd,
                                torch.float32)
        o = outs()[:3]
        for chunk in (None, 8, 32, 128, nw):
            calls[f"{nt} x {nw} x {nl * nd}, chunk "
                  f"{chunk or pt_swap._chunk_walkers(nw)}"
                  f"{'' if chunk else ' (default)'}"] = (
                lambda a=args, o=o, c=chunk: pt_swap.pt_swap_cascade_tree(
                    *a, *o, chunk=c))
    for name, ms in device_times(torch, calls, reps).items():
        print(f"scan: {name}: {ms * 1e3:.2f} us on the device ({card})")


def _stretch_bytes(torch, nt, nw, D, itemsize, u_all):
    """Bytes each stretch kernel must move at ``(nt, nw, D)``: every input
    it needs read once, every output written once.  A proposal reads its
    moving rows and the distinct complement rows this run's draws pick; an
    accept reads, per walker, the row its decision keeps; half 1's
    complement rows are the merged half 0 the fused kernel has just
    written, so it counts them once, as outputs."""
    n0, n1 = nw - nw // 2, nw // 2

    def picked_rows(half, ns, nc):
        r = torch.floor(u_all[half, 1, :, :ns] * nc).long().clamp_(0, nc - 1)
        t = torch.arange(nt, device=r.device)[:, None]
        return int(torch.unique(r + t * nc).numel())

    def propose(half, ns, nc, complement=True):
        rows = nt * ns + (picked_rows(half, ns, nc) if complement else 0)
        # rows, ndim_act, two uniforms, perm (int64); q and the factor
        return (rows * D + 3 * nt * ns + nt * ns * (D + 1)) * itemsize + 8 * nw

    def accept(ns):
        # the kept row, ll/lp new and old, factor, uniform; betas; perm;
        # the merged row, ll, lp and flag
        return ((nt * ns * (D + 6) + nt + nt * ns * (D + 3)) * itemsize
                + 8 * ns)

    return {
        "propose": propose(0, n0, n1),
        "accept_propose": accept(n0) + propose(1, n1, n0, complement=False),
        "accept": accept(n1),
    }


def device_times(torch, calls, reps=100):
    """Device time of each call's kernel launches, in ms per call: the calls
    run ``reps`` times each, in order, under ``torch.profiler``, and the
    device kernels recorded (only these calls launch any) are assigned to
    the calls in launch order."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # launches a call makes (the counted kernels' counters; the empty
    # launch counts none and makes one): a cascade of more than 32 leaves
    # makes one per group, and its device time is theirs summed
    per_call = {}
    for name, fn in calls.items():
        before = sum(k.launches for k in _kernels())
        fn()
        per_call[name] = max(1, sum(k.launches for k in _kernels()) - before)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for fn in calls.values():
            for _ in range(reps):
                fn()
        torch.cuda.synchronize()
    kernels = sorted(
        (e for e in prof.events() if e.device_type == DeviceType.CUDA
         and not e.name.startswith(("Memcpy", "Memset"))),
        key=lambda e: e.time_range.start,
    )
    total = reps * sum(per_call.values())
    assert len(kernels) == total, (
        f"the profiler recorded {len(kernels)} device kernels for {total} "
        "launches")
    out, off = {}, 0
    for name in calls:
        chunk = kernels[off:off + reps * per_call[name]]
        off += len(chunk)
        assert len({e.name for e in chunk}) == 1, (name, {e.name for e in chunk})
        out[name] = sum(e.time_range.elapsed_us() for e in chunk) / reps / 1e3
    return out


def wrapper_host_costs(torch, card, reps=2000):
    """Host time in microseconds per call of the parts of a stretch kernel
    wrapper, at the north-star shape: the argument check of
    ``stretch_accept``'s 14 tensors, two ``torch.empty``, 17 data pointers,
    the stream handle as a ``torch.cuda.Stream`` and as the raw handle the
    wrappers read, and the ctypes call of an empty launch."""
    from eryn_tpu_torch.ops import _build
    from eryn_tpu_torch.ops._checks import check_cuda_args

    f32 = dict(device="cuda", dtype=torch.float32)
    nt, nw, D, ns = NT, NW, NDIM, NW // 2
    X, state = torch.zeros((nt, nw, D), **f32), torch.zeros((nt, nw), **f32)
    q, blk = torch.zeros((nt, ns, D), **f32), torch.zeros((nt, ns), **f32)
    betas, u = torch.zeros(nt, **f32), torch.zeros((2, 3, nt, nw), **f32)
    perm = torch.arange(nw, device="cuda")
    spec = dict(
        q=(q, (nt, ns, D)), X=(X, (nt, nw, D)), ll_new=(blk, (nt, ns)),
        lp_new=(blk, (nt, ns)), logl=(state, (nt, nw)),
        logp=(state, (nt, nw)), factors=(blk, (nt, ns)),
        betas=(betas, (nt,)), perm=(perm, (nw,), torch.int64),
        u_all=(u, (2, 3, nt, nw)), X_out=(X, (nt, nw, D)),
        logl_out=(state, (nt, nw)), logp_out=(state, (nt, nw)),
        acc_out=(state, (nt, nw)),
    )
    tensors = [t for t, *_ in spec.values()] + [q, blk, state]
    empty = _build.function("eryn_empty_launch", "p")
    parts = {
        "check of 14 tensors": lambda: check_cuda_args(
            "stretch_accept", X.dtype, X.device, **spec),
        "two torch.empty": lambda: (torch.empty((nt, ns, D), **f32),
                                    torch.empty((nt, ns), **f32)),
        "17 data_ptr": lambda: [t.data_ptr() for t in tensors],
        "torch.cuda.current_stream()": lambda: (
            torch.cuda.current_stream().cuda_stream),
        "raw stream handle": lambda: torch._C._cuda_getCurrentRawStream(0),
        "ctypes empty launch": lambda: empty(
            torch._C._cuda_getCurrentRawStream(0)),
    }
    out = {}
    for name, fn in parts.items():
        for _ in range(100):
            fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        out[name] = (time.perf_counter() - t0) / reps * 1e6
        torch.cuda.synchronize()
    print("host: " + ", ".join(f"{k} {v:.2f} us" for k, v in out.items())
          + f" per call ({card})")
    return out


def _counting(kernels):
    """Set every launch counter to 0; returns a reader of the counts."""
    for k in kernels:
        k.launches = 0
    return lambda: {k.__name__: k.launches for k in kernels}


@contextlib.contextmanager
def _plain_versions_forbidden():
    """While the main path runs, every plain version of a kernel raises: a
    leg that reached one would fail, whatever its launch counts say."""
    from eryn_tpu_torch.ops import pt_swap, select_kernels, stretch_kernels

    def forbidden(name):
        def plain(*args, **kwargs):
            raise AssertionError(
                f"the main path called the plain version {name}")
        return plain

    saved = [(mod, name, getattr(mod, name))
             for mod in (pt_swap, select_kernels, stretch_kernels)
             for name in dir(mod) if name.endswith("_ref")]
    for mod, name, _ in saved:
        setattr(mod, name, forbidden(name))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


@contextlib.contextmanager
def _segments_never_wait():
    """Every segment a sampler runs (``EnsembleSampler._run_bulk``: its
    replays, its captures and the first eager run of each move, the stored
    legs' snapshot writes) runs under ``set_sync_debug_mode("error")``: a
    segment that waited for the device would raise.  Handing a segment to
    a backend, outside it, may wait; so may the reordering of host
    (object) supplemental entries at a segment's end
    (``EnsembleSampler._apply_prov``, which reads the walkers' provenance),
    the one host read a segment makes, and only where a state holds such
    entries."""
    import torch

    from eryn_tpu_torch import EnsembleSampler

    run_bulk, apply_prov = EnsembleSampler._run_bulk, EnsembleSampler._apply_prov

    def mode(fn, name):
        def checked(self, *args, **kwargs):
            torch.cuda.set_sync_debug_mode(name)
            try:
                return fn(self, *args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode(
                    "error" if name == "default" else "default")
        return checked

    EnsembleSampler._run_bulk = mode(run_bulk, "error")
    EnsembleSampler._apply_prov = mode(apply_prov, "default")
    try:
        yield
    finally:
        EnsembleSampler._run_bulk = run_bulk
        EnsembleSampler._apply_prov = apply_prov


def _assert_replays(name, sampler, steps, per_step):
    """Every entry of the schedule (``per_step`` a step) is a replay of its
    move's graph, but the first of each graph, which ran eagerly."""
    warm = len(sampler._graphs.warm)
    assert warm == per_step, (name, sampler._graphs.warm)
    assert sampler.graph_replays == per_step * steps - warm, (
        name, sampler.graph_replays, steps)
    return sampler.graph_replays


def _kernels():
    from eryn_tpu_torch.ops import pt_swap, select_kernels, stretch_kernels as sk

    return (sk.stretch_propose, sk.stretch_accept_propose, sk.stretch_accept,
            pt_swap.pt_swap_cascade_multi, pt_swap._cascade_multi_rolled,
            select_kernels.group_stretch_propose, select_kernels.onehot_select)


def _gaussian_sampler(torch, nt, nw, seed, backend=None, cuda_graph=True,
                      tempering=None, **kw):
    """The north-star target (``tempering``: more of ``tempering_kwargs``)."""
    from eryn_tpu_torch import EnsembleSampler, ProbDistContainer, uniform_dist

    invcov = torch.eye(NDIM, device="cuda")

    def log_like(x):
        return -0.5 * torch.sum(x * (invcov @ x))

    priors = ProbDistContainer({i: uniform_dist(-5.0, 5.0) for i in range(NDIM)})
    sampler = EnsembleSampler(
        nw, NDIM, log_like, priors,
        tempering_kwargs=dict(ntemps=nt, **(tempering or {})),
        seed=seed, device="cuda", backend=backend, cuda_graph=cuda_graph, **kw,
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


def _assert_stretch_launches(launches, steps):
    """The fused stretch step: propose half 0, accept half 0 and propose
    half 1, accept half 1; one launch of each per step."""
    counts = [launches[k] for k in ("stretch_propose", "stretch_accept_propose",
                                    "stretch_accept")]
    assert counts == [steps] * 3, launches


# legs whose steps run the capped loops (about 3,000 device ops a step):
# fewer profiled steps keep the profiler's event lists short
HEAVY_LEGS = ("best_stack", "zoo[SliceMove]", "zoo[ChEESHMCMove]",
              "zoo[HMCMove(jittered (3, 7))]", "host_like[north-star]")


def _profile_steps(leg, eager=False):
    """Steps profiled of a leg: the profiler's own processing of an eager
    step, several host events a device op, costs far more than the step."""
    if eager:
        return 5 if leg in HEAVY_LEGS else 20
    return 10 if leg in HEAVY_LEGS else 50


def profile_steps(torch, leg, sampler, state, card, steps=50):
    """``torch.profiler`` (CPU and CUDA) over ``steps`` steady steps of a
    leg's sampler, without storing; prints the device's kernels, memcpys
    (by direction) and memsets per step, what the host launched per step
    (CUDA graph launches, and kernel, memcpy and memset calls of the
    runtime outside them), the device-busy share of the window (the union
    of device activity over the host's wall time, which the profiler itself
    slows) and the five device ops that take the most device time.  A
    replayed graph's kernels are recorded one by one, as the eager ones
    are.  Returns ``{leg: summary}``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    state, _ = sampler._run_bulk(state, 1, 2, store=False)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sampler._run_bulk(state, 1, steps, store=False)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    device = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    assert device, f"{leg}: the profiler recorded no device activity"
    copies = sum(e.name.startswith("Memcpy") for e in device)
    sets = sum(e.name.startswith("Memset") for e in device)
    kinds = {}
    for e in device:
        if e.name.startswith("Memcpy"):
            kind = e.name.split()[1]  # HtoD, DtoD, DtoH
            kinds[kind] = kinds.get(kind, 0) + 1 / steps
    api = [e.name for e in prof.events() if e.device_type != DeviceType.CUDA]
    graph_launches = sum(n == "cudaGraphLaunch" for n in api)
    host_launches = sum(
        n.startswith(("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset"))
        for n in api)
    busy, end, by_name = 0.0, -math.inf, {}
    for e in device:
        start, stop = max(e.time_range.start, end), e.time_range.end
        busy += max(stop - start, 0.0)
        end = max(end, stop)
        short = e.name.replace("void ", "").replace(
            "(anonymous namespace)::", "")[:70]
        by_name[short] = by_name.get(short, 0.0) + e.time_range.elapsed_us()
    total = sum(by_name.values()) or 1.0
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    summary = {
        "kernels_per_step": (len(device) - copies - sets) / steps,
        "memcpys_per_step": copies / steps, "memsets_per_step": sets / steps,
        "memcpys_by_kind": kinds,
        "graph_launches_per_step": graph_launches / steps,
        "host_launches_per_step": host_launches / steps,
        "device_busy_share": busy / wall_us,
        "wall_ms_per_step": wall_us / steps / 1e3,
        "device_ms_per_step": busy / steps / 1e3,
        "top5": [[name, t / total] for name, t in top],
    }
    print(f"profile[{leg}]: {summary['kernels_per_step']:.2f} kernels, "
          f"{summary['memcpys_per_step']:.2f} memcpys "
          f"{ {k: round(v, 2) for k, v in kinds.items()} }, "
          f"{summary['memsets_per_step']:.2f} memsets per step on the device; "
          f"the host launched {summary['graph_launches_per_step']:.2f} graphs "
          f"and {summary['host_launches_per_step']:.2f} kernels, memcpys and "
          f"memsets outside them per step; device busy "
          f"{100 * summary['device_busy_share']:.2f} % of "
          f"{summary['wall_ms_per_step']:.4f} ms per step "
          f"({summary['device_ms_per_step']:.4f} ms busy); top device ops "
          + ", ".join(f"{n} {100 * f:.1f} %" for n, f in summary["top5"])
          + f" ({card})")
    return {leg: summary}


@contextlib.contextmanager
def _host_side(sampler):
    """Where a stored run's host time goes: the backend's ``grow``, and for
    each segment handed to it the queueing of its copy to the host, the
    wait for that copy (the device still running the segment, or later
    ones) and the write."""
    took = {"grow": 0.0, "stage": [], "wait": [], "write": []}
    grow, stage, flush = sampler.backend.grow, sampler._stage, sampler._flush

    def timed_grow(n, blobs=None):
        t0 = time.perf_counter()
        grow(n, blobs)
        took["grow"] += time.perf_counter() - t0

    def timed_stage(snaps):
        t0 = time.perf_counter()
        staged = stage(snaps)
        took["stage"].append(time.perf_counter() - t0)
        return staged

    def timed_flush(staged):
        t0 = time.perf_counter()
        staged["copied"].synchronize()
        t1 = time.perf_counter()
        flush(staged)
        took["wait"].append(t1 - t0)
        took["write"].append(time.perf_counter() - t1)

    sampler.backend.grow = timed_grow
    sampler._stage, sampler._flush = timed_stage, timed_flush
    try:
        yield took
    finally:
        del sampler.backend.grow, sampler._stage, sampler._flush


def _stored_run(torch, sampler, leg, card, segment_size=None):
    """``run_mcmc(None, STORED_STEPS)`` into a host or file backend: its
    steps/s, and a ``host[leg]`` line of where the host's time went."""
    with _host_side(sampler) as took:
        t0 = time.perf_counter()
        sampler.run_mcmc(None, STORED_STEPS, segment_size=segment_size)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def ms(values):
        return [round(1e3 * x, 2) for x in values]

    print(f"host[{leg}]: wall {1e3 * wall:.2f} ms for {STORED_STEPS} steps; "
          f"grow {1e3 * took['grow']:.2f} ms; per segment, queueing its copy "
          f"{ms(took['stage'])} ms, waiting for it {ms(took['wait'])} ms, "
          f"writing {ms(took['write'])} ms ({card})")
    return STORED_STEPS / wall


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

    # leg 1: sampling only
    s1, _ = _gaussian_sampler(torch, NT, NW, 0)
    state = s1._setup_state(coords)
    state, _ = s1._run_bulk(state, 1, WARM_STEPS, store=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = s1._run_bulk(state, 1, NOSTORE_STEPS, store=False)
    torch.cuda.synchronize()
    rates["nostore_steps_per_s"] = NOSTORE_STEPS / (time.perf_counter() - t0)
    steps += WARM_STEPS + NOSTORE_STEPS

    # leg 2: stored into the host Backend
    s2, _ = _gaussian_sampler(torch, NT, NW, 1, backend=Backend())
    s2.run_mcmc(coords, WARM_STEPS, store=False)
    rates["stored_host_steps_per_s"] = _stored_run(
        torch, s2, "north-star, Backend", card)
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
    replays = sum(
        _assert_replays("north-star", s, n, 1)
        for s, n in ((s1, WARM_STEPS + NOSTORE_STEPS),
                     (s2, WARM_STEPS + STORED_STEPS),
                     (s3, WARM_STEPS + STORED_STEPS)))
    # per step: each of the three stretch kernels once, one cascade
    _assert_stretch_launches(launches, steps)
    assert launches["pt_swap_cascade_multi"] == steps, launches
    assert launches["_cascade_multi_rolled"] == launches["onehot_select"] == 0
    assert launches["group_stretch_propose"] == 0

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
    print(f"launches[north-star]: {launches} over {steps} steps, "
          f"{replays} graph replays")
    return launches, rates, ("north-star", s1, state)


def config_e_leg(torch, card):
    """Config E (20 x 1000) into the default DeviceBackend: every step's
    cascade is the large-ensemble kernel."""
    import numpy as np

    s, priors = _gaussian_sampler(torch, E_NT, E_NW, 5)
    coords = priors.rvs(size=(E_NT, E_NW), generator=torch.Generator(
        device="cuda").manual_seed(5))
    read = _counting(_kernels())
    state = s._setup_state(coords)
    s._run_bulk(state, 1, E_WARM, store=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s.run_mcmc(None, E_STEPS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    steps = E_WARM + E_STEPS
    launches = read()
    replays = _assert_replays("config E", s, steps, 1)
    assert launches["_cascade_multi_rolled"] == steps, launches
    assert launches["pt_swap_cascade_multi"] == 0, launches
    _assert_stretch_launches(launches, steps)
    # at 20 temperatures the default 5-D ladder reaches beta ~ 1e-9, where
    # every proposed swap is accepted
    _check_gaussian_chain(np, "config E", s, E_NT, allow_hot_one=True)
    rates = {"config_e_steps_per_s": E_STEPS / dt,
             "config_e_walker_steps_per_s": E_STEPS * E_NT * E_NW / dt}
    for k, v in rates.items():
        print(f"rate: {k} = {v:.1f} ({card})")
    print(f"launches[config E]: {launches} over {steps} steps, "
          f"{replays} graph replays")
    return launches, rates, ("config E", s, s._previous_state)


def _pulse_data(npts=128):
    """bench.py's pulse data: one pulse at t = 4, amplitude 3, width 0.6,
    noise 0.3, from one seed."""
    import numpy as np

    rng = np.random.default_rng(10)
    t = np.linspace(0.0, 10.0, npts)
    sigma = 0.3
    data = 3.0 * np.exp(-((t - 4.0) ** 2) / (2 * 0.6**2))
    data = data + sigma * rng.standard_normal(npts)
    return t, data, sigma


def _pulse_problem(torch, np, null=False, npts=L_NPTS):
    """benchmarks/lisa_style.py's data and likelihood (bench.py's at
    ``npts=128``), in torch on the card; with ``null`` its trivial
    likelihood (``heavy=False``), which leaves the sampler's own cost."""
    from eryn_tpu_torch import ProbDistContainer, uniform_dist

    t_np, data_np, sigma = _pulse_data(npts)
    t = torch.tensor(t_np, dtype=torch.float32, device="cuda")
    data = torch.tensor(data_np, dtype=torch.float32, device="cuda")

    def ll(coords, inds):
        a, b, c = coords[:, 0], coords[:, 1], coords[:, 2]
        p = a[:, None] * torch.exp(
            -((t[None] - b[:, None]) ** 2) / (2 * c[:, None] ** 2)
        )
        tmpl = torch.sum(torch.where(inds[:, None], p, 0.0), dim=0)
        return -0.5 * torch.sum(((tmpl - data) / sigma) ** 2)

    def ll_null(coords, inds):
        return -0.5 * torch.sum(torch.where(inds[:, None], coords, 0.0) ** 2)

    pr = ProbDistContainer({0: uniform_dist(0.5, 5.0),
                            1: uniform_dist(0.0, 10.0),
                            2: uniform_dist(0.1, 2.0)})
    fill = float(-0.5 * np.sum((data_np / sigma) ** 2))
    return (ll_null if null else ll), pr, fill


def _lisa_sampler(torch, np, null, move, cuda_graph=True, wrap=None, **kw):
    """The sampler and start state of ``benchmarks/lisa_style.py:build``
    (``wrap``: a maker of another likelihood from its likelihood; ``kw``: a
    backend and hooks)."""
    from eryn_tpu_torch import EnsembleSampler, State

    ll, pr, fill = _pulse_problem(torch, np, null)
    if wrap is not None:
        ll = wrap(ll)
    s = EnsembleSampler(
        L_NW, 3, ll, pr, nleaves_max=L_NLMAX, nleaves_min=0, moves=move,
        rj_moves=True, tempering_kwargs=dict(ntemps=L_NT),
        fill_zero_leaves_val=fill, seed=3, device="cuda",
        # named only when off: --null-leg runs in trees without the option
        **({} if cuda_graph else {"cuda_graph": False}), **kw,
    )
    coords = pr.rvs(size=(L_NT, L_NW, L_NLMAX), generator=torch.Generator(
        device="cuda").manual_seed(3), dtype=torch.float32)
    inds = np.random.default_rng(4).random((L_NT, L_NW, L_NLMAX)) < 0.4
    state = s._setup_state(State({"model_0": coords}, inds={
        "model_0": torch.as_tensor(inds, device="cuda")}))
    return s, state


def _rj_chain_summary(np, s, steps):
    """Cold leaf-count frequencies, the median pulse centre, acceptances
    and swap fractions over the second half of the ``steps`` stored."""
    half = slice(steps // 2, None)
    nleaves = s.get_nleaves()["model_0"][half, 0]
    counts = np.bincount(nleaves.ravel(), minlength=L_NLMAX + 1)
    centers = s.get_chain(temp_index=0)["model_0"][half][..., 1]
    active = s.get_inds(temp_index=0)["model_0"][half]
    return dict(
        counts=counts, median_b=float(np.median(centers[active])),
        rj=float(s.rj_acceptance_fraction.mean()),
        acc=float(s.acceptance_fraction[0].mean()),
        swaps=np.asarray(s.swap_acceptance_fraction, dtype=np.float64),
    )


def _print_rj_chain(np, name, c):
    print(f"chain[{name}]: cold leaf counts "
          f"{(c['counts'] / c['counts'].sum()).round(4).tolist()} "
          f"mode {int(np.argmax(c['counts']))} median b {c['median_b']:.4f} "
          f"rj acceptance {c['rj']:.6f} in-model acceptance {c['acc']:.4f} "
          f"swap acceptance {np.round(c['swaps'], 4).tolist()}")


def lisa_rj_leg(torch, card, null=False, count=True):
    """The LISA-style reversible-jump configuration: group stretch plus
    birth/death, with tempering, into the default DeviceBackend; with
    ``null`` under the trivial likelihood.  Without ``count`` the launch
    counters are left alone (``--null-leg``: the leg through the public
    names only, so that the script can time an earlier tree of the port)."""
    import numpy as np

    from eryn_tpu_torch.moves import RedBlueGroupStretchMove

    leg = "LISA RJ null" if null else "LISA RJ"
    metric = "lisa_rj_null_steps_per_s" if null else "lisa_rj_steps_per_s"
    s, state = _lisa_sampler(torch, np, null, RedBlueGroupStretchMove())
    read = _counting(_kernels()) if count else dict
    s._run_bulk(state, 1, L_WARM, store=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s.run_mcmc(None, L_STEPS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    steps = L_WARM + L_STEPS
    launches = read()
    if count:
        replays = _assert_replays(leg, s, steps, 2)
        print(f"replays[{leg}]: {replays} over {steps} steps")
        # one proposal launch per red/blue half; a cascade after the
        # in-model move and after the RJ move
        assert launches["group_stretch_propose"] == 2 * steps, launches
        assert launches["pt_swap_cascade_multi"] == 2 * steps, launches
        assert launches["_cascade_multi_rolled"] == 0, launches
        assert launches["onehot_select"] == 0, launches

    c = _rj_chain_summary(np, s, L_STEPS)
    _print_rj_chain(np, leg, c)
    assert 0 < c["rj"] < 1, c["rj"]
    if null:
        assert 0.2 < c["acc"] < 0.8, c["acc"]
        assert np.all((c["swaps"] > 0) & (c["swaps"] < 1)), c["swaps"]
    else:
        assert int(np.argmax(c["counts"])) >= 1, c["counts"]
        assert abs(c["median_b"] - 4.0) < 0.3, c["median_b"]
    rates = {metric: L_STEPS / dt}
    print(f"rate: {metric} = {rates[metric]:.1f} ({card})")
    print(f"launches[{leg}]: {launches} over {steps} steps")
    return launches, rates, (leg, s, s._previous_state)


def lisa_rj_null_leg(torch, card):
    return lisa_rj_leg(torch, card, null=True)


def custom_move_leg(torch, card):
    """The null configuration through a user's move on the public
    ``onehot_select`` op: a subclass of the group stretch whose
    ``get_proposal_kernel`` makes the proposal in separate tensor ops around
    one selection launch per branch and half, from a gathered complement.
    It draws what the fused proposal draws, so from the same seed its chain
    must be the fused kernel's, which runs beside it at the same depth."""
    import numpy as np

    from eryn_tpu_torch.moves import RedBlueGroupStretchMove
    from eryn_tpu_torch.ops.select_kernels import onehot_select

    class SelectGroupStretch(RedBlueGroupStretchMove):
        def get_proposal_kernel(self, generator, s_coords, c_coords, s_inds,
                                param_masks=None, c_inds=None):
            (name, s), = s_coords.items()
            c, ci = c_coords[name], c_inds[name]
            nt, ns, nl, nd = s.shape
            u, uu = self.draw_group(generator, nt, ns, {name: nl}, s.dtype,
                                    s.device)
            b = (self.a - 1.0) * u + 1.0
            zz = b * b / self.a
            m = ci.reshape(nt, -1).to(s.dtype)
            cnt = m.sum(dim=-1)
            kq = torch.floor(uu[name] * torch.clamp(cnt, min=1.0)[:, None, None])
            c_sel = onehot_select(
                torch.cumsum(m, dim=-1), kq.reshape(nt, -1),
                torch.where(ci[..., None], c, 0.0).reshape(nt, -1, nd),
            ).reshape(s.shape)
            temp = c_sel - (c_sel - s) * zz[:, :, None, None]
            has_c = cnt > 0
            q = torch.where(s_inds[name][..., None]
                            & has_c[:, None, None, None], temp, s)
            ndim = s_inds[name].sum(dim=-1) * nd * has_c[:, None].to(s.dtype)
            return {name: q}, (ndim - 1.0) * torch.log(zz)

    steps = L_STEPS // 4
    out = {}
    for name, move in (("select", SelectGroupStretch()),
                       ("fused", RedBlueGroupStretchMove())):
        s, state = _lisa_sampler(torch, np, True, move)
        read = _counting(_kernels())
        t0 = time.perf_counter()
        s.run_mcmc(state, steps)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        out[name] = (read(), _rj_chain_summary(np, s, steps), steps / dt,
                     s.get_chain()["model_0"][-1], s)
    launches, c, rate, last, s = out["select"]
    for name in out:
        _assert_replays(name, out[name][4], steps, 2)
    _print_rj_chain(np, "LISA RJ null, selection alone", c)
    assert launches["onehot_select"] == 2 * steps, launches
    assert launches["group_stretch_propose"] == 0, launches
    assert out["fused"][0]["group_stretch_propose"] == 2 * steps
    # the same draws and the same arithmetic: the same chain
    assert np.array_equal(last, out["fused"][3], equal_nan=True), (
        "the fused proposal's chain left the chain of the separate ops")
    for k, v in c.items():
        assert np.array_equal(v, out["fused"][1][k]), k
    rates = {"lisa_rj_null_select_steps_per_s": rate,
             "lisa_rj_null_fused_short_steps_per_s": out["fused"][2]}
    for k, v in rates.items():
        print(f"rate: {k} = {v:.1f} over {steps} stored steps ({card})")
    print(f"launches[LISA RJ null, selection alone]: {launches} over "
          f"{steps} steps")
    return launches, rates, ("LISA RJ null, selection alone", s,
                             s._previous_state)


def _run_state(np, s):
    """What a run left, as numpy: the stored chain, masks, log-likelihoods,
    log-priors, ladders, accept and swap counts, the clock, the move
    accept counters and the moves' kernel states; and where the run has
    them, the stored blobs and the last state's supplemental entries, the
    host (object) entries by the hash of each object's ``repr``."""
    from eryn_tpu_torch.interop import kernel_state_to_numpy

    b = s.backend
    out = dict(
        chain=s.get_chain()["model_0"], inds=s.get_inds()["model_0"],
        log_like=s.get_log_like(), log_prior=s.get_log_prior(),
        betas=s.get_betas(), accepted=b.accepted, swaps=b.swaps_accepted,
        time=int(s.temperature_control.time),
        moves=np.stack([m.accepted for m in s._all_move_list]),
    )
    if s.has_reversible_jump:
        out["rj_accepted"] = b.rj_accepted
    for i, leaf in enumerate(kernel_state_to_numpy(s._kernel_states)):
        out[f"kernel state leaf {i}"] = leaf
    if s.get_blobs() is not None:
        out["blobs"] = s.get_blobs()
    last = s._previous_state
    owners = [("state", last.supplemental)] + [
        (n, b.branch_supplemental) for n, b in last.branches.items()]
    for owner, supp in owners:
        if supp is None:
            continue
        for key, value in supp.holder.items():
            out[f"supplemental {owner} {key}"] = value.cpu().numpy()
        for key, value in supp.host_holder.items():
            out[f"host {owner} {key}"] = np.array(
                [hash(repr(o)) for o in value.ravel()], dtype=np.int64)
    return {k: np.asarray(v) for k, v in out.items()}


def graph_vs_eager(torch, card):
    """North-star, its blob form, its DEO form, config E, LISA RJ, LISA RJ
    null, the zoo's
    ``CombineMove``, MT-RJ, MALA and AIMH legs at a quarter of their
    depth, the jittered HMC, ChEES and slice legs at a tenth (their tuning
    ending inside the stored steps, as the default's does at a quarter),
    from one seed, with ``cuda_graph=False`` and graphed, in turn:
    20 warm steps (the graphed form captures there), a timed segment of
    ``n`` steps without storing (host time until the loop returns, and wall
    time until the device is done), then ``n`` stored steps into the default
    ``DeviceBackend``.  The two forms' chains, masks, log-likelihoods,
    ladders, clocks, accept and swap counts and kernel states must be equal
    digit for digit.  Returns ``({leg: numbers}, {leg: (sampler, state) of the eager
    form})``."""
    import numpy as np

    from eryn_tpu_torch.moves import RedBlueGroupStretchMove

    def gaussian(nt, nw, seed, tempering=None):
        def build(graphed):
            s, priors = _gaussian_sampler(torch, nt, nw, seed,
                                          cuda_graph=graphed,
                                          tempering=tempering)
            coords = priors.rvs(size=(nt, nw), generator=torch.Generator(
                device="cuda").manual_seed(seed))
            return s, s._setup_state(coords)
        return build

    def lisa(null):
        return lambda graphed: _lisa_sampler(
            torch, np, null, RedBlueGroupStretchMove(), cuda_graph=graphed)

    def blobs(graphed):
        s, start = _blob_sampler(torch, seed=2, cuda_graph=graphed,
                                 host_object=True)
        return s, s._setup_state(start)

    # (leg, build, steps, schedule entries a step, clock ticks a step)
    legs = (("north-star", gaussian(NT, NW, 0), STORED_STEPS // 4, 1, 1),
            # blobs, rid, sigma and a host object compared as well
            ("blobs[north-star]", blobs, STORED_STEPS // 4, 1, 1),
            ("deo[north-star]", gaussian(NT, NW, 7, DEO), STORED_STEPS // 4,
             1, 1),
            ("config E", gaussian(E_NT, E_NW, 5), E_STEPS // 4, 1, 1),
            ("LISA RJ", lisa(False), L_STEPS // 4, 2, 1),
            ("LISA RJ null", lisa(True), L_STEPS // 4, 2, 1),
            ("zoo[CombineMove]", lambda graphed: _zoo_sampler(
                torch, "CombineMove", cuda_graph=graphed), Z_STORED // 4, 1,
             2),
            ("zoo[MT-RJ x8]", lambda graphed: _mt_rj_sampler(
                torch, cuda_graph=graphed), Z_STORED // 4, 2, 1)) + tuple(
        # the captured gradient, the masked loops and the replaced cond
        (f"zoo[{name}]", lambda graphed, name=name: _zoo_sampler(
            torch, name, cuda_graph=graphed), Z_STORED // 4, 1, 1)
        for name in ("MALAMove", "AIMHMove")) + tuple(
        # the capped loops, at a tenth of their depth (eagerly about 35 us
        # of host a device op, 3,000 ops a step), their tuning ending
        # inside the stored steps as at the quarter depth's default
        (f"zoo[{name}]", lambda graphed, name=name: _zoo_sampler(
            torch, name, cuda_graph=graphed, tune_steps=GVE_TUNE),
         Z_STORED // 10, 1, 1)
        for name in ("HMCMove(jittered (3, 7))", "ChEESHMCMove", "SliceMove"))
    out, eager_samplers = {}, {}
    for leg, build, n, per_step, ticks in legs:
        runs = {}
        for form in ("eager", "graphed"):
            s, state = build(form == "graphed")
            state, _ = s._run_bulk(state, 1, 20, store=False)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _ = s._run_bulk(state, 1, n, store=False)
            t_host = time.perf_counter() - t0
            torch.cuda.synchronize()
            t_wall = time.perf_counter() - t0
            t0 = time.perf_counter()
            s.run_mcmc(None, n)
            torch.cuda.synchronize()
            t_stored = time.perf_counter() - t0
            runs[form] = dict(
                host_ms_per_step=t_host / n * 1e3,
                wall_ms_per_step=t_wall / n * 1e3,
                steps_per_s=n / t_wall, stored_steps_per_s=n / t_stored,
                replays_per_step=s.graph_replays / (20 + 2 * n),
                state=_run_state(np, s),
            )
            if form == "eager":
                assert s.graph_replays == 0
                eager_samplers[leg] = (s, s._previous_state)
            else:
                _assert_replays(leg, s, 20 + 2 * n, per_step)
        a, b = runs["eager"].pop("state"), runs["graphed"].pop("state")
        for key in a:
            assert a[key].shape == b[key].shape and np.array_equal(
                a[key], b[key], equal_nan=True), (
                f"graph vs eager, {leg}: {key} differs")
        assert a["time"] == ticks * (20 + 2 * n) and not np.array_equal(
            a["betas"][0], a["betas"][-1]), leg
        out[leg] = runs
        e, g = runs["eager"], runs["graphed"]
        print(f"graph-vs-eager[{leg}]: {n} steps a form, chains, masks, "
              f"log-likelihoods, ladders, clock ({a['time']}) and accept and "
              f"swap counts equal digit for digit; host "
              f"{e['host_ms_per_step']:.4f} / {g['host_ms_per_step']:.4f} ms "
              f"per step, wall {e['wall_ms_per_step']:.4f} / "
              f"{g['wall_ms_per_step']:.4f}, "
              f"{e['steps_per_s']:.1f} / {g['steps_per_s']:.1f} steps/s "
              f"without storing, {e['stored_steps_per_s']:.1f} / "
              f"{g['stored_steps_per_s']:.1f} stored, replays per step "
              f"{e['replays_per_step']:.4f} / {g['replays_per_step']:.4f} "
              f"(eager / graphed; {card})")
    return out, eager_samplers


def flat_rj_leg(torch):
    """Flat likelihood with birth/death (1 x 64 walkers, up to 3 leaves):
    the leaf-count posterior is uniform."""
    import numpy as np

    from eryn_tpu_torch import EnsembleSampler, ProbDistContainer, State, uniform_dist
    from eryn_tpu_torch.moves import RedBlueGroupStretchMove

    nw, nlmax, steps, burn = 64, 3, 700, 150
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
    assert launches["group_stretch_propose"] == 2 * (steps + burn), launches
    assert launches["onehot_select"] == 0, launches
    k = s.get_nleaves()["model_0"][:, 0].ravel()
    freqs = np.bincount(k, minlength=nlmax + 1) / k.size
    print(f"chain[flat RJ]: leaf-count frequencies {freqs.round(4).tolist()}")
    assert np.abs(freqs - 1.0 / (nlmax + 1)).max() < 0.08, freqs
    print(f"launches[flat RJ]: {launches} over {steps + burn} steps")


def deo_leg(torch, card):
    """North-star under deterministic even-odd swaps and the Syed schedule:
    200 warm steps, then 1,200 stored into the default ``DeviceBackend``.
    The swap phase is tensor ops inside each step's graph, its parity read
    from the clock there: every boundary must swap over the replays (both
    parity classes), and no cascade kernel may run."""
    import numpy as np

    leg = "deo[north-star]"
    s, priors = _gaussian_sampler(torch, NT, NW, 7, tempering=DEO)
    coords = priors.rvs(size=(NT, NW), generator=torch.Generator(
        device="cuda").manual_seed(7))
    read = _counting(_kernels())
    s.run_mcmc(coords, WARM_STEPS, store=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s.run_mcmc(None, STORED_STEPS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    steps = WARM_STEPS + STORED_STEPS
    launches = read()
    replays = _assert_replays(leg, s, steps, 1)
    _assert_stretch_launches(launches, steps)
    assert launches["pt_swap_cascade_multi"] == 0, launches
    assert launches["_cascade_multi_rolled"] == launches["onehot_select"] == 0
    assert launches["group_stretch_propose"] == 0
    # moments, acceptance, every boundary's swap fraction in (0, 1) (the
    # even ones swap only at even clocks, the odd ones at odd), the ladder
    # moved from its start
    _check_gaussian_chain(np, leg, s, NT)
    betas = s.get_betas()[-1]
    assert np.all(np.diff(betas) < 0), betas
    assert int(s.temperature_control.time) == steps
    swaps = np.asarray(s.swap_acceptance_fraction, dtype=np.float64)
    _, total = s.temperature_control.communication_barrier(ratios=swaps)
    tau_max = float(np.nanmax(s.get_autocorr_time()["model_0"]))
    rates = {"deo_steps_per_s": STORED_STEPS / dt,
             "deo_device_ess_per_s": STORED_STEPS * NW / max(tau_max, 1.0) / dt,
             "deo_barrier_total": total}
    print(f"{leg}: ladder {np.round(betas, 6).tolist()}, swap fraction "
          f"even boundaries {np.round(swaps[0::2], 4).tolist()}, odd "
          f"{np.round(swaps[1::2], 4).tolist()}, clock {steps}")
    for k, v in rates.items():
        print(f"rate: {k} = {v:.4f} ({card})")
    print(f"launches[{leg}]: {launches} over {steps} steps, {replays} graph "
          f"replays")
    return launches, rates, ("deo", s, s._previous_state)


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def evidence_leg(torch, card):
    """North-star on a fixed ladder that ends at beta = 0: 200 warm steps,
    then 1,200 stored into the default ``DeviceBackend`` and, from the same
    seed, into ``Backend()``.  The chains must be equal digit for digit (the
    cumulative counters to float32 rounding);
    stepping stone within 0.3 of the analytic log evidence, thermodynamic
    integration within the larger of twice its error and 2.0
    (``tests/test_backends.py:272-280``); the device getters equal to the
    host getters on the same chain (evidence 1e-6 relative: float32
    log-likelihoods reduced in float64 on the card, in float32 by NumPy;
    Gelman-Rubin, R-hat and ESS 1e-10); R-hat below 1.05.  The wall time of
    each getter's second call, device beside host."""
    import numpy as np

    from eryn_tpu_torch import Backend, DeviceBackend

    leg = "evidence[north-star]"
    read = _counting(_kernels())
    runs = {}
    for form, backend in (("device", None), ("host", Backend())):
        s, priors = _gaussian_sampler(torch, NT, NW, 9, backend=backend,
                                      tempering=EVIDENCE)
        coords = priors.rvs(size=(NT, NW), generator=torch.Generator(
            device="cuda").manual_seed(9))
        s.run_mcmc(coords, WARM_STEPS, store=False)
        s.run_mcmc(None, STORED_STEPS)
        runs[form] = s
    torch.cuda.synchronize()
    steps = 2 * (WARM_STEPS + STORED_STEPS)
    launches = read()
    dev, host = runs["device"], runs["host"]
    assert isinstance(dev.backend, DeviceBackend), type(dev.backend)
    for s in runs.values():
        _assert_replays(leg, s, WARM_STEPS + STORED_STEPS, 1)
    _assert_stretch_launches(launches, steps)
    assert launches["pt_swap_cascade_multi"] == steps, launches
    # the cumulative counters are summed in float32 on the device and in
    # float64 on the host: equal to rounding
    a, b = _chain_record(np, dev), _chain_record(np, host)
    for key in ("accepted", "swaps_accepted"):
        np.testing.assert_allclose(a.pop(key), b.pop(key), rtol=1e-6)
    _assert_same_record(np, leg, a, b)
    betas = dev.get_betas()
    assert betas[-1, -1] == 0.0 and np.all(betas == betas[0]), betas[-1]

    getters = {
        "evidence": lambda b: b.get_evidence_estimate(),
        "gelman_rubin": lambda b: b.get_gelman_rubin_convergence_diagnostic(
            doprint=False)["model_0"],
        "rhat": lambda b: b.get_rank_normalized_rhat(
            return_parts=True)["model_0"],
        "ess": lambda b: b.get_effective_sample_size(
            return_parts=True)["model_0"],
    }
    rates, values = {}, {}
    for name, get in getters.items():
        for form, s in runs.items():
            get(s.backend)  # the device backend unpacks its segment once
            values[form, name], took = _timed(lambda: get(s.backend))
            rates[f"{form}_{name}_s"] = took
        rtol = 1e-6 if name == "evidence" else 1e-10
        np.testing.assert_allclose(
            np.asarray(values["device", name], dtype=np.float64),
            np.asarray(values["host", name], dtype=np.float64), rtol=rtol,
            err_msg=f"{leg}: the device {name} left the host's")
    logz, dlogz = values["device", "evidence"]
    ss, dss = host.backend.get_evidence_estimate(method="stepping_stone")
    rhat = values["device", "rhat"][0]
    print(f"{leg}: log evidence, analytic {LOG_Z:.4f}; stepping stone "
          f"{ss:.4f} +- {dss:.4f}; thermodynamic integration {logz:.4f} +- "
          f"{dlogz:.4f}; R-hat {np.round(rhat, 5).tolist()}; ESS "
          f"{np.round(values['device', 'ess'][0], 1).tolist()}; Gelman-Rubin "
          f"{np.round(values['device', 'gelman_rubin'], 5).tolist()}")
    assert abs(ss - LOG_Z) < 0.3, (ss, LOG_Z)
    assert abs(logz - LOG_Z) < max(2.0 * dlogz, 2.0), (logz, dlogz, LOG_Z)
    assert np.all(rhat < 1.05), rhat
    for name in getters:
        print(f"rate: device_{name}_s = {rates['device_' + name + '_s']:.6f} "
              f"beside host_{name}_s = {rates['host_' + name + '_s']:.6f} "
              f"(second call; {card})")
    print(f"launches[{leg}]: {launches} over {steps} steps")
    return launches, rates, (leg, dev, dev._previous_state)


def rj_pulse128_leg(torch, card):
    """Config C (``bench.py:225-275``): 10 x 100 walkers, up to 4 pulse
    leaves, the 128-point template, birth/death and the group stretch (the
    port's move under reversible jump; ``bench.py`` keeps the plain stretch
    there), ``seed=3``; a warm ``_run_bulk`` of ``P_STEPS`` steps, then a
    timed one without storing."""
    import numpy as np

    from eryn_tpu_torch import EnsembleSampler, State
    from eryn_tpu_torch.moves import RedBlueGroupStretchMove

    leg = "rj_pulse128"
    ll, pr, fill = _pulse_problem(torch, np, npts=P_NPTS)
    s = EnsembleSampler(
        NW, 3, ll, pr, nleaves_max=P_NLMAX, nleaves_min=0,
        moves=RedBlueGroupStretchMove(), rj_moves=True,
        tempering_kwargs=dict(ntemps=NT), fill_zero_leaves_val=fill, seed=3,
        device="cuda")
    coords = pr.rvs(size=(NT, NW, P_NLMAX), generator=torch.Generator(
        device="cuda").manual_seed(3), dtype=torch.float32)
    inds = np.random.default_rng(4).random((NT, NW, P_NLMAX)) < 0.3
    state = s._setup_state(State({"model_0": coords}, inds={
        "model_0": torch.as_tensor(inds, device="cuda")}))
    read = _counting(_kernels())
    state, _ = s._run_bulk(state, 1, P_STEPS, store=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = s._run_bulk(state, 1, P_STEPS, store=False)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    steps = 2 * P_STEPS
    launches = read()
    replays = _assert_replays(leg, s, steps, 2)
    assert launches["group_stretch_propose"] == 2 * steps, launches
    assert launches["pt_swap_cascade_multi"] == 2 * steps, launches
    assert sum(launches.values()) == 4 * steps, launches
    b = state.branches["model_0"]
    nleaves = b.inds.sum(dim=-1)
    assert bool(((nleaves >= 0) & (nleaves <= P_NLMAX)).all())
    assert bool(torch.isfinite(b.coords[b.inds]).all())
    assert bool(torch.isfinite(state.log_like).all())
    counts = torch.bincount(nleaves[0].reshape(-1), minlength=P_NLMAX + 1)
    rates = {"rj_pulse128_steps_per_s": P_STEPS / dt}
    print(f"chain[{leg}]: cold leaf counts at the last step "
          f"{counts.tolist()}, finite coordinates and log-likelihoods")
    print(f"rate: rj_pulse128_steps_per_s = {rates['rj_pulse128_steps_per_s']:.1f} "
          f"({card})")
    print(f"launches[{leg}]: {launches} over {steps} steps, {replays} graph "
          f"replays")
    return launches, rates, (leg, s, state)


# ----------------------------------------------------------------------
# the move zoo without gradients, config D and the model swap
# ----------------------------------------------------------------------
def _zoo_moves():
    """The in-model moves of ``move_zoo_timing.py:build_moves`` but the
    stretch moves: ``{name: (move factory, swap phases per step)}``, each
    with its defaults."""
    import numpy as np

    from eryn_tpu_torch import ProbDistContainer, uniform_dist
    from eryn_tpu_torch import moves as tm

    dist = ProbDistContainer({i: uniform_dist(-5.0, 5.0) for i in range(NDIM)})
    diag = {"model_0": np.diag(np.full(NDIM, 0.5 ** 2))}
    full = {"model_0": 0.25 * np.eye(NDIM) + 0.05}
    return {
        "GaussianMove(diag)": (lambda: tm.GaussianMove(diag), 1),
        "GaussianMove(full)": (lambda: tm.GaussianMove(full), 1),
        "DistributionGenerate": (
            lambda: tm.DistributionGenerate({"model_0": dist}), 1),
        "GroupStretchMove": (lambda: tm.GroupStretchMove(), 1),
        "MTDistGenMove(8 tries)": (lambda: tm.MTDistGenMove(
            {"model_0": dist}, num_try=8, independent=True), 1),
        "DelayedRejection(GaussianMove(diag))": (
            lambda: tm.DelayedRejection(tm.GaussianMove(diag), max_iter=2), 1),
        "CombineMove": (lambda: tm.CombineMove([
            tm.GroupStretchMove(),
            tm.DelayedRejection(tm.GaussianMove(diag), max_iter=2)]), 2),
        "DEMove": (tm.DEMove, 1),
        "DESnookerMove": (tm.DESnookerMove, 1),
        "WalkMove": (tm.WalkMove, 1),
        "KDEMove": (tm.KDEMove, 1),
        "SliceMove": (tm.SliceMove, 1),
        "MALAMove": (tm.MALAMove, 1),
        "HMCMove": (tm.HMCMove, 1),
        "ChEESHMCMove": (tm.ChEESHMCMove, 1),
        "AIMHMove": (tm.AIMHMove, 1),
    }


def _zoo_move(name, **kw):
    """A zoo move by name, or the graph-vs-eager leg's jittered HMC;
    ``kw`` goes to the move's class."""
    from eryn_tpu_torch import moves as tm

    if name == "HMCMove(jittered (3, 7))":
        return tm.HMCMove(num_leapfrog=(3, 7), **kw)
    return _zoo_moves()[name][0](**kw)


def _zoo_sampler(torch, name, seed=Z_SEED, cuda_graph=True, **kw):
    """A zoo leg's sampler and its set-up state (the kernel states made
    too, outside any segment: a move copies its constants to the card
    there); ``kw`` goes to the move's class."""
    s, priors = _gaussian_sampler(torch, NT, NW, seed,
                                  moves=_zoo_move(name, **kw),
                                  cuda_graph=cuda_graph)
    coords = priors.rvs(size=(NT, NW), generator=torch.Generator(
        device="cuda").manual_seed(seed))
    state = s._setup_state(coords)
    s._ensure_kernel_states(state)
    return s, state


def _per_step(launches, steps):
    return {k: round(v / steps, 4) for k, v in launches.items()}


def _zoo_acceptance(np, s):
    """The cold chain's acceptance of the stored run per move (per child
    under ``CombineMove``, whose summed flags reach 2)."""
    move = s._all_move_list[0]
    sep = getattr(move, "acceptance_fraction_separate", None)
    if sep is not None:
        return [float(np.mean(a[0])) for a in sep]
    return [float(s.acceptance_fraction[0].mean())]


def _loop_counters(torch, move):
    """The device counters of a move's data-dependent loops, on the host:
    ChEES's summed trajectory length, slice's iterations needed (stepping
    out, shrinkage, loops run); None for other moves."""
    for name in ("leapfrog_total", "loop_iterations"):
        counter = getattr(move, name, None)
        if counter is not None:
            return torch.atleast_1d(counter).tolist()
    return None


def _print_loop_cost(torch, leg, move, before, after, steps, device_ms, card):
    """ChEES's mean ``L`` and slice's iterations per loop over a timed
    window, beside their caps (every step runs the caps in its graph), and
    the window's device time a step (CUDA events)."""
    if before is None:
        return {}
    if len(before) == 1:
        mean_L = (after[0] - before[0]) / steps
        print(f"loops[{leg}]: mean L {mean_L:.4f} of the cap max_leapfrog = "
              f"{move.max_leapfrog} over the {steps} timed steps; device "
              f"{device_ms:.4f} ms a step ({card})")
        return {"chees_mean_L": mean_L}
    expand, shrink, loops = (a - b for a, b in zip(after, before))
    out = {"slice_expand_iterations": expand / loops,
           "slice_shrink_iterations": shrink / loops}
    print(f"loops[{leg}]: per loop, stepping out needed "
          f"{out['slice_expand_iterations']:.4f} iterations of the cap "
          f"{move.max_expand - 1}, shrinkage "
          f"{out['slice_shrink_iterations']:.4f} of the cap "
          f"{move.max_shrink}, over the {steps} timed steps ({loops} loops); "
          f"device {device_ms:.4f} ms a step ({card})")
    return out


def zoo_leg(torch, card):
    """Each in-model move of the zoo at 10 x 100 on the 5-D unit Gaussian,
    the moves' defaults: ``Z_WARM`` warm and ``Z_STEPS`` timed steps
    without storing, then ``Z_STORED`` stored into the default
    ``DeviceBackend``.  Gates: acceptance strictly inside (0, 1) (in (0, 1]
    for ``SliceMove``, which accepts by construction), the cold chain's
    mean within 0.1 and variance within 0.2 of the unit Gaussian's (a CPU
    run of eryn_tpu at this shape and depth, three seeds, meets them for
    every move); launches: one cascade per swap phase (two a step under
    ``CombineMove``), no stretch kernel (the group stretch runs
    ``GroupMove``'s proposal), no group-stretch proposal.  ChEES and slice
    print their loops' cost (``loops[...]``)."""
    import numpy as np

    launches_all, rates, keep = {}, {}, []
    for name, (_, phases) in _zoo_moves().items():
        leg = f"zoo[{name}]"
        s, state = _zoo_sampler(torch, name)
        move = s._all_move_list[0]
        read = _counting(_kernels())
        state, _ = s._run_bulk(state, 1, Z_WARM, store=False)
        torch.cuda.synchronize()
        before = _loop_counters(torch, move)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        start.record()
        state, _ = s._run_bulk(state, 1, Z_STEPS, store=False)
        end.record()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rates.update(_print_loop_cost(
            torch, leg, move, before, _loop_counters(torch, move), Z_STEPS,
            start.elapsed_time(end) / Z_STEPS, card))
        s.run_mcmc(None, Z_STORED)
        steps = Z_WARM + Z_STEPS + Z_STORED
        launches = read()
        replays = _assert_replays(leg, s, steps, 1)
        assert launches["pt_swap_cascade_multi"] == phases * steps, launches
        assert sum(launches.values()) == phases * steps, launches
        assert int(s.temperature_control.time) == phases * steps
        cold = s.get_chain(temp_index=0)["model_0"].reshape(-1, NDIM)
        mean = cold.mean(axis=0, dtype=np.float64)
        var = cold.var(axis=0, dtype=np.float64)
        acc = _zoo_acceptance(np, s)
        swaps = np.asarray(s.swap_acceptance_fraction, dtype=np.float64)
        metric = f"zoo[{name}]_steps_per_s"
        rates[metric] = Z_STEPS / dt
        print(f"chain[{leg}]: cold mean {np.round(mean, 4).tolist()} var "
              f"{np.round(var, 4).tolist()} acceptance "
              f"{np.round(acc, 4).tolist()} swap acceptance "
              f"{np.round(swaps, 4).tolist()}")
        print(f"rate: {metric} = {rates[metric]:.1f} ({card})")
        print(f"launches[{leg}]: per step {_per_step(launches, steps)} over "
              f"{steps} steps, {replays} graph replays")
        assert all(0 < a < 1 or (name == "SliceMove" and a == 1)
                   for a in acc), acc
        assert np.all(np.abs(mean) < 0.1), mean
        assert np.all(np.abs(var - 1.0) < 0.2), var
        assert np.all((swaps > 0) & (swaps < 1)), swaps
        for k, v in launches.items():
            launches_all[k] = launches_all.get(k, 0) + v
        if name in ("CombineMove", "SliceMove"):
            keep.append((leg, s, state))
    return launches_all, rates, keep


# ----------------------------------------------------------------------
# blobs and supplementals through the graphed step
# ----------------------------------------------------------------------
def _blob_sampler(torch, seed=0, cuda_graph=True, host_object=False):
    """The north-star target through a likelihood that returns ``(ll, [-2
    ll, x0])`` and divides ``x`` by a branch supplemental ``sigma`` of ones
    (``provide_supplemental=True``: the target stays the north-star's),
    with an int64 state tag ``rid`` of ``arange(1000)`` and, with
    ``host_object``, a host object per walker; the sampler and its start,
    a :class:`State`."""
    import numpy as np

    from eryn_tpu_torch import (BranchSupplemental, EnsembleSampler,
                                ProbDistContainer, State, uniform_dist)

    invcov = torch.eye(NDIM, device="cuda")

    def log_like(x, supps):
        y = x / supps["sigma"]
        ll = -0.5 * torch.sum(y * (invcov @ y))
        return ll, torch.stack([-2.0 * ll, x[0]])

    priors = ProbDistContainer({i: uniform_dist(-5.0, 5.0) for i in range(NDIM)})
    s = EnsembleSampler(
        NW, NDIM, log_like, priors, tempering_kwargs=dict(ntemps=NT),
        seed=seed, device="cuda", provide_supplemental=True,
        cuda_graph=cuda_graph)
    coords = priors.rvs(size=(NT, NW), generator=torch.Generator(
        device="cuda").manual_seed(seed))
    supp = {"rid": torch.arange(NT * NW, device="cuda").reshape(NT, NW)}
    if host_object:
        objs = np.empty((NT, NW), dtype=object)
        objs[...] = [[("walker", t * NW + w) for w in range(NW)]
                     for t in range(NT)]
        supp["obj"] = objs
    return s, State(
        {"model_0": coords}, supplemental=BranchSupplemental(supp),
        branch_supplemental={"model_0": BranchSupplemental(
            {"sigma": torch.ones((NT, NW), device="cuda")})})


def blobs_north_star_leg(torch, card):
    """``blobs[north-star]``: the north-star configuration through
    :func:`_blob_sampler`, 200 warm steps, then 1,200 stored into the
    default ``DeviceBackend``.  Every stored ``blob[0]`` is ``-2 log_like``
    (a doubling, exact in float32; float32 rounding allowed), ``blob[1]``
    the first parameter of the stored chain, the final ``rid`` a permutation
    of ``arange(1000)`` other than the identity, and the cold chain meets
    the north-star's gates; the blobs take the general stretch path (the
    fused kernels decline them), so one cascade launch a step and no
    stretch kernel."""
    import numpy as np

    leg = "blobs[north-star]"
    read = _counting(_kernels())
    s, start = _blob_sampler(torch)
    s.run_mcmc(start, WARM_STEPS, store=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s.run_mcmc(None, STORED_STEPS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    steps = WARM_STEPS + STORED_STEPS
    launches = read()
    replays = _assert_replays(leg, s, steps, 1)
    assert launches["pt_swap_cascade_multi"] == steps, launches
    assert all(v == 0 for k, v in launches.items()
               if k != "pt_swap_cascade_multi"), launches
    blobs, ll = s.get_blobs(), s.get_log_like()
    chain = s.get_chain()["model_0"]
    assert blobs.shape == (STORED_STEPS, NT, NW, 2), blobs.shape
    assert blobs.dtype == np.float32, blobs.dtype
    np.testing.assert_allclose(blobs[..., 0], -2.0 * ll,
                               rtol=float(np.finfo(np.float32).eps), atol=0)
    assert np.array_equal(blobs[..., 1], chain[:, :, :, 0, 0])
    rid = s._previous_state.supplemental["rid"].cpu().numpy().ravel()
    ident = np.arange(NT * NW)
    assert np.array_equal(np.sort(rid), ident), "rid is not a permutation"
    assert not np.array_equal(rid, ident), "no walker changed rungs"
    _check_gaussian_chain(np, leg, s, NT)
    exact = int(np.sum(blobs[..., 0] == -2.0 * ll))
    print(f"{leg}: blobs {blobs.shape} {blobs.dtype}; blob[0] == -2 "
          f"log_like exactly at {exact} of {ll.size} samples (the rest "
          f"within float32 rounding), blob[1] == the chain's x0 at all; rid "
          f"a permutation of arange({NT * NW}) with "
          f"{int(np.sum(rid != ident))} walkers off their start slot")
    rates = {"blobs_steps_per_s": STORED_STEPS / dt}
    print(f"rate: blobs_steps_per_s = {rates['blobs_steps_per_s']:.1f} "
          f"({card})")
    print(f"launches[{leg}]: {launches} over {steps} steps, {replays} graph "
          "replays")
    return launches, rates, (leg, s, s._previous_state)


def blobs_lisa_rj_null_leg(torch, card):
    """``blobs[lisa-rj-null]``: the LISA-style RJ configuration under the
    null likelihood (``benchmarks/lisa_style.py:36-96``, ``heavy=False``),
    its blob the number of active leaves; 100 warm and 1,200 stored steps.
    The stored blob equals ``get_nleaves()`` at every sample, the RJ gates
    of the null leg hold, and the group-stretch proposal and the cascade
    launch twice a step each."""
    import numpy as np

    from eryn_tpu_torch.moves import RedBlueGroupStretchMove

    leg = "blobs[lisa-rj-null]"

    def with_count(ll):
        def ll_count(coords, inds):
            return ll(coords, inds), inds.sum().to(coords.dtype)
        return ll_count

    s, state = _lisa_sampler(torch, np, True, RedBlueGroupStretchMove(),
                             wrap=with_count)
    read = _counting(_kernels())
    s._run_bulk(state, 1, L_WARM, store=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s.run_mcmc(None, L_STEPS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    steps = L_WARM + L_STEPS
    launches = read()
    replays = _assert_replays(leg, s, steps, 2)
    assert launches["group_stretch_propose"] == 2 * steps, launches
    assert launches["pt_swap_cascade_multi"] == 2 * steps, launches
    assert all(v == 0 for k, v in launches.items() if k not in (
        "group_stretch_propose", "pt_swap_cascade_multi")), launches
    blobs, nleaves = s.get_blobs(), s.get_nleaves()["model_0"]
    assert blobs.shape == nleaves.shape, (blobs.shape, nleaves.shape)
    assert np.array_equal(blobs, nleaves), "the blob is not the leaf count"
    c = _rj_chain_summary(np, s, L_STEPS)
    _print_rj_chain(np, leg, c)
    assert 0 < c["rj"] < 1, c["rj"]
    assert 0.2 < c["acc"] < 0.8, c["acc"]
    assert np.all((c["swaps"] > 0) & (c["swaps"] < 1)), c["swaps"]
    print(f"{leg}: the stored blob equals get_nleaves() at all "
          f"{nleaves.size} (step, temperature, walker) samples")
    rates = {"blobs_lisa_rj_null_steps_per_s": L_STEPS / dt}
    print(f"rate: blobs_lisa_rj_null_steps_per_s = "
          f"{rates['blobs_lisa_rj_null_steps_per_s']:.1f} ({card})")
    print(f"launches[{leg}]: {launches} over {steps} steps, {replays} graph "
          "replays")
    return launches, rates, (leg, s, s._previous_state)


def replica_flow_leg(torch, card):
    """``replica_flow[cascade]`` and ``replica_flow[deo]``:
    ``benchmarks/replica_flow.py``'s configuration (8 x 16, 3-D, a fixed
    ladder, 1,200 steps through ``sample()``, seed 17, the start from
    ``default_rng(99)``), a replica tag ``rid`` riding the state
    supplemental.  Each step's tag stays on the device until the end; the
    round trips (cold rung to the hottest and back) are counted by
    ``utils.replica_round_trips``.  Trips > 0 for both schemes; one cascade
    launch a step under the cascade, none under DEO, the fused stretch
    kernels (a state tag alone does not make them decline)."""
    import numpy as np

    from eryn_tpu_torch import (BranchSupplemental, EnsembleSampler,
                                ProbDistContainer, State, uniform_dist)
    from eryn_tpu_torch.utils import replica_round_trips

    read = _counting(_kernels())
    rates, kept = {}, []
    for scheme in ("cascade", "deo"):
        leg = f"replica_flow[{scheme}]"
        before = read()
        pr = ProbDistContainer({i: uniform_dist(-7.0, 7.0)
                                for i in range(R_NDIM)})
        coords = np.random.default_rng(99).uniform(
            -3, 3, size=(R_NT, R_NW, 1, R_NDIM))
        s = EnsembleSampler(
            R_NW, R_NDIM, lambda x: -0.5 * torch.sum(x ** 2), pr,
            tempering_kwargs=dict(ntemps=R_NT, adaptive=False,
                                  swap_scheme=scheme),
            seed=R_SEED, device="cuda")
        start = State(
            {"model_0": torch.tensor(coords, dtype=torch.float32,
                                     device="cuda")},
            supplemental=BranchSupplemental({"rid": torch.arange(
                R_NT * R_NW, device="cuda").reshape(R_NT, R_NW)}))
        tags = []
        t0 = time.perf_counter()
        for state in s.sample(start, iterations=R_STEPS, store=False):
            tags.append(state.supplemental["rid"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        tag = torch.stack(tags).reshape(R_STEPS, -1).cpu().numpy()
        rungs = np.empty(tag.shape, dtype=np.int8)
        np.put_along_axis(rungs, tag, np.broadcast_to(
            np.repeat(np.arange(R_NT, dtype=np.int8), R_NW), tag.shape),
            axis=1)
        trips = replica_round_trips(rungs, R_NT)
        assert trips > 0, f"{leg}: no round trip"
        per_k = 1000.0 * trips / (R_NT * R_NW * R_STEPS)
        attempts = R_NT - 1 if scheme == "cascade" else (R_NT - 1) / 2.0
        now = read()
        launches = {k: now[k] - before[k] for k in now}
        _assert_replays(leg, s, R_STEPS, 1)
        _assert_stretch_launches(launches, R_STEPS)
        assert launches["pt_swap_cascade_multi"] == (
            R_STEPS if scheme == "cascade" else 0), launches
        rates[f"replica_flow_{scheme}_trips"] = trips
        rates[f"replica_flow_{scheme}_trips_per_replica_per_1k_steps"] = per_k
        rates[f"replica_flow_{scheme}_steps_per_s"] = R_STEPS / dt
        print(f"{leg}: {trips} round trips, {per_k:.4f} per replica per 1k "
              f"steps, {trips / attempts:.2f} per boundary attempt, "
              f"{R_STEPS / dt:.1f} steps/s through sample() ({card})")
        kept.append((leg, s, s._previous_state))
    return read(), rates, kept


def best_stack_leg(torch, card):
    """The north-star target under ``ChEESHMCMove()`` with DEO swaps and
    the Syed schedule (``tempering_kwargs=dict(ntemps=10,
    swap_scheme="deo", adaptation_scheme="syed")``): ``BS_BURN`` steps of
    burn-in (the 500 tuning proposals fall inside), then ``STORED_STEPS``
    stored into the default ``DeviceBackend``.  Gates as north-star's: the
    cold mean within 0.05, variance within 0.1, acceptance in (0.2, 0.8),
    every DEO boundary swapping, an adapted ladder; no kernel launch (DEO
    swaps with tensor ops, ChEES needs no stretch kernel), every step a
    replay."""
    import numpy as np

    from eryn_tpu_torch.moves import ChEESHMCMove

    leg = "best_stack[north-star]"
    s, priors = _gaussian_sampler(torch, NT, NW, BS_SEED, tempering=DEO,
                                  moves=ChEESHMCMove())
    coords = priors.rvs(size=(NT, NW), generator=torch.Generator(
        device="cuda").manual_seed(BS_SEED))
    move = s._all_move_list[0]
    read = _counting(_kernels())
    t0 = time.perf_counter()
    s.run_mcmc(coords, BS_BURN, store=False)
    torch.cuda.synchronize()
    t_burn = time.perf_counter() - t0
    before = _loop_counters(torch, move)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    start.record()
    s.run_mcmc(None, STORED_STEPS)
    end.record()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    steps = BS_BURN + STORED_STEPS
    launches = read()
    replays = _assert_replays(leg, s, steps, 1)
    assert sum(launches.values()) == 0, launches
    _check_gaussian_chain(np, leg, s, NT)
    assert int(move.kernel_state["t"]) == steps
    tau = s.get_autocorr_time()["model_0"]
    tau_max = float(np.nanmax(tau))
    rates = {"best_stack_steps_per_s": STORED_STEPS / dt,
             "best_stack_ess_per_s": STORED_STEPS * NW / max(tau_max, 1.0) / dt,
             "best_stack_tau_max": tau_max,
             "best_stack_burn_steps_per_s": BS_BURN / t_burn}
    rates.update({f"best_stack_{k}": v for k, v in _print_loop_cost(
        torch, leg, move, before, _loop_counters(torch, move), STORED_STEPS,
        start.elapsed_time(end) / STORED_STEPS, card).items()})
    print(f"{leg}: ladder {np.round(s.get_betas()[-1], 6).tolist()}, cold "
          f"tau {np.round(tau.ravel(), 3).tolist()}, step size "
          f"{math.exp(float(move.kernel_state['log_scale_avg'])):.4f} x the "
          f"heuristic, trajectory {math.exp(float(move.kernel_state['log_T'])):.4f}")
    for k in ("best_stack_steps_per_s", "best_stack_ess_per_s",
              "best_stack_tau_max", "best_stack_burn_steps_per_s"):
        print(f"rate: {k} = {rates[k]:.4f} ({card})")
    print(f"launches[{leg}]: {launches} over {steps} steps, {replays} graph "
          f"replays")
    return launches, rates, ("best_stack", s, s._previous_state)


def _mt_rj_sampler(torch, cuda_graph=True, setup=True, backend=None):
    """``move_zoo_timing.py:time_rj(mt=True)``: 10 x 100, the 5-D branch
    with up to 4 leaves, ``MTDistGenMoveRJ(num_try=8)`` and the red/blue
    group stretch, seed 11; its set-up state (without ``setup`` the global
    start, not evaluated)."""
    import numpy as np

    from eryn_tpu_torch import EnsembleSampler, ProbDistContainer, State, uniform_dist
    from eryn_tpu_torch.moves import MTDistGenMoveRJ, RedBlueGroupStretchMove

    def ll(coords, inds):
        return -0.5 * torch.sum(torch.where(inds[:, None], coords, 0.0) ** 2)

    pr = ProbDistContainer({i: uniform_dist(-5.0, 5.0) for i in range(NDIM)})
    s = EnsembleSampler(
        NW, NDIM, ll, pr, nleaves_max=Z_NLMAX, nleaves_min=0,
        moves=RedBlueGroupStretchMove(),
        rj_moves=[MTDistGenMoveRJ({"model_0": pr},
                                  nleaves_max={"model_0": Z_NLMAX},
                                  nleaves_min={"model_0": 0}, num_try=8)],
        tempering_kwargs=dict(ntemps=NT), seed=Z_RJ_SEED, device="cuda",
        cuda_graph=cuda_graph, backend=backend)
    coords = pr.rvs(size=(NT, NW, Z_NLMAX), generator=torch.Generator(
        device="cuda").manual_seed(Z_RJ_SEED))
    inds = np.random.default_rng(4).random((NT, NW, Z_NLMAX)) < 0.5
    state = State({"model_0": coords}, inds={
        "model_0": torch.as_tensor(inds, device="cuda")})
    if not setup:
        return s, state
    state = s._setup_state(state)
    s._ensure_kernel_states(state)
    return s, state


def zoo_mt_rj_leg(torch, card):
    """The zoo's multiple-try reversible-jump leg: ``Z_WARM`` warm and
    ``Z_STEPS`` timed steps without storing, ``Z_STORED`` stored.  Gates:
    the leaf-count chain finite and within [0, 4]; kernel 5 twice a step
    (the group stretch's halves), the cascade once per swap phase (two a
    step)."""
    import numpy as np

    leg = "zoo[MT-RJ x8]"
    s, state = _mt_rj_sampler(torch)
    read = _counting(_kernels())
    state, _ = s._run_bulk(state, 1, Z_WARM, store=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = s._run_bulk(state, 1, Z_STEPS, store=False)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    s.run_mcmc(None, Z_STORED)
    steps = Z_WARM + Z_STEPS + Z_STORED
    launches = read()
    replays = _assert_replays(leg, s, steps, 2)
    assert launches["group_stretch_propose"] == 2 * steps, launches
    assert launches["pt_swap_cascade_multi"] == 2 * steps, launches
    assert sum(launches.values()) == 4 * steps, launches
    nleaves = s.get_nleaves()["model_0"]
    assert np.all((nleaves >= 0) & (nleaves <= Z_NLMAX)), nleaves
    assert np.all(np.isfinite(s.get_log_like()))
    counts = np.bincount(nleaves[:, 0].ravel(), minlength=Z_NLMAX + 1)
    rj = float(s.rj_acceptance_fraction[0].mean())
    acc = float(s.acceptance_fraction[0].mean())
    assert 0 < rj < 1 and 0 < acc < 1, (rj, acc)
    rates = {"zoo[MT-RJ x8]_steps_per_s": Z_STEPS / dt}
    print(f"chain[{leg}]: cold leaf counts "
          f"{(counts / counts.sum()).round(4).tolist()}, finite, within "
          f"[0, {Z_NLMAX}]; rj acceptance {rj:.4f}, in-model acceptance "
          f"{acc:.4f}")
    print(f"rate: zoo[MT-RJ x8]_steps_per_s = "
          f"{rates['zoo[MT-RJ x8]_steps_per_s']:.1f} ({card})")
    print(f"launches[{leg}]: per step {_per_step(launches, steps)} over "
          f"{steps} steps, {replays} graph replays")
    return launches, rates, (leg, s, state)


def config_d_leg(torch, card):
    """Config D (``tests/test_config_d.py:22-96``): 36 walkers x 3
    temperatures, 96 points, a Gaussian pulse and a sine as two branches,
    ``CombineMove([GroupStretchMove(n_iter_update=20),
    DelayedRejection(GaussianMove, max_iter=2)])``, the sine's phase
    periodic, seed 50; 400 burn-in and 400 stored steps.  Gates as in the
    test: the pulse centre within 0.4 of 4.0, the frequency within 0.05 of
    0.3, the phase inside [0, 2 pi]; two cascade launches a step."""
    import numpy as np

    from eryn_tpu_torch import EnsembleSampler, ProbDistContainer, State, uniform_dist
    from eryn_tpu_torch import moves as tm

    leg = "config_d"
    rng = np.random.default_rng(9)
    t_np = np.linspace(0, 10, 96)
    sigma = 0.4
    signal = 2.5 * np.exp(-((t_np - 4.0) ** 2) / (2 * 0.7**2)) + 1.5 * np.sin(
        2 * np.pi * 0.3 * t_np + 0.5)
    data_np = signal + sigma * rng.standard_normal(len(t_np))
    t = torch.tensor(t_np, dtype=torch.float32, device="cuda")
    data = torch.tensor(data_np, dtype=torch.float32, device="cuda")

    def log_like(coords, inds):
        g, sn = coords["gauss"], coords["sine"]
        gm, sm = inds["gauss"], inds["sine"]
        pulses = g[:, 0][:, None] * torch.exp(
            -((t[None] - g[:, 1][:, None]) ** 2) / (2 * g[:, 2][:, None] ** 2))
        tmpl = torch.sum(torch.where(gm[:, None], pulses, 0.0), dim=0)
        sines = sn[:, 0][:, None] * torch.sin(
            2 * math.pi * sn[:, 1][:, None] * t[None] + sn[:, 2][:, None])
        tmpl = tmpl + torch.sum(torch.where(sm[:, None], sines, 0.0), dim=0)
        return -0.5 * torch.sum(((tmpl - data) / sigma) ** 2)

    priors = {
        "gauss": ProbDistContainer({0: uniform_dist(0.5, 5.0),
                                    1: uniform_dist(0.0, 10.0),
                                    2: uniform_dist(0.2, 2.0)}),
        "sine": ProbDistContainer({0: uniform_dist(0.3, 4.0),
                                   1: uniform_dist(0.05, 1.0),
                                   2: uniform_dist(0.0, 2 * np.pi)}),
    }
    move = tm.CombineMove([
        tm.GroupStretchMove(n_iter_update=20),
        tm.DelayedRejection(tm.GaussianMove(
            {"gauss": 0.01 * np.ones(3), "sine": 0.01 * np.ones(3)}),
            max_iter=2),
    ])
    s = EnsembleSampler(
        D_NW, {"gauss": 3, "sine": 3}, log_like, priors,
        branch_names=["gauss", "sine"], nleaves_max={"gauss": 1, "sine": 1},
        moves=[move], periodic={"sine": {2: 2 * np.pi}},
        tempering_kwargs=dict(ntemps=D_NT), seed=50, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(50)
    coords = {n: priors[n].rvs(size=(D_NT, D_NW, 1), generator=g)
              for n in priors}
    read = _counting(_kernels())
    t0 = time.perf_counter()
    s.run_mcmc(State(coords), D_STEPS, burn=D_BURN)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    steps = D_BURN + D_STEPS
    launches = read()
    replays = _assert_replays(leg, s, steps, 1)
    assert launches["pt_swap_cascade_multi"] == 2 * steps, launches
    assert sum(launches.values()) == 2 * steps, launches
    chain_g = s.get_chain()["gauss"][:, 0].reshape(-1, 3)
    chain_s = s.get_chain()["sine"][:, 0].reshape(-1, 3)
    centre = float(np.median(chain_g[:, 1]))
    freq = float(np.median(chain_s[:, 1]))
    acc = [float(np.mean(a[0])) for a in move.acceptance_fraction_separate]
    rates = {"config_d_steps_per_s": steps / dt}
    print(f"chain[{leg}]: pulse centre {centre:.4f} (4.0), frequency "
          f"{freq:.4f} (0.3), phase in [{chain_s[:, 2].min():.4f}, "
          f"{chain_s[:, 2].max():.4f}], acceptance per child "
          f"{np.round(acc, 4).tolist()}")
    print(f"rate: config_d_steps_per_s = {rates['config_d_steps_per_s']:.1f} "
          f"(burn-in and stored; {card})")
    print(f"launches[{leg}]: per step {_per_step(launches, steps)} over "
          f"{steps} steps, {replays} graph replays")
    assert abs(centre - 4.0) < 0.4, centre
    assert abs(freq - 0.3) < 0.05, freq
    assert chain_s[:, 2].min() >= 0.0 and chain_s[:, 2].max() <= 2 * np.pi
    assert all(0 < a < 1 for a in acc), acc
    return launches, rates, (leg, s, s._previous_state)


def _modelswap_sampler(torch, np, nt, cuda_graph=True, backend=None):
    """``tests/test_modelswap.py:153-181``'s sampler at ``nt`` temperatures
    and its start; with it the quadrature probability of the pulse."""
    from eryn_tpu_torch import EnsembleSampler, ProbDistContainer, State, uniform_dist
    from eryn_tpu_torch.moves import GaussianMove, ModelSwapRJMove

    rng = np.random.default_rng(4)
    npts = 64
    t = np.linspace(0, 1, npts)
    g = np.exp(-((t - 0.5) ** 2) / (2 * 0.1**2))
    data = 1.1 * g + rng.standard_normal(npts)

    def ll_np(template):
        return -0.5 * np.sum((data[None] - template) ** 2, axis=-1)

    a = np.linspace(0.0, 3.0, 800)
    z_pulse = np.exp(ll_np(a[:, None] * g[None])).mean()
    c = np.linspace(-1.0, 1.0, 800)
    z_const = np.exp(ll_np(np.broadcast_to(c[:, None], (800, npts)))).mean()
    p_true = z_pulse / (z_pulse + z_const)
    gt = torch.tensor(g, dtype=torch.float32, device="cuda")
    dt_ = torch.tensor(data, dtype=torch.float32, device="cuda")

    def log_like(coords, inds):
        amp = torch.sum(torch.where(inds["pulse"][:, None], coords["pulse"], 0.0))
        off = torch.sum(torch.where(inds["const"][:, None], coords["const"], 0.0))
        return -0.5 * torch.sum((dt_ - (amp * gt + off)) ** 2)

    priors = {"pulse": ProbDistContainer({0: uniform_dist(0.0, 3.0)}),
              "const": ProbDistContainer({0: uniform_dist(-1.0, 1.0)})}
    s = EnsembleSampler(
        S_NW, {"pulse": 1, "const": 1}, log_like, priors,
        branch_names=["pulse", "const"], nleaves_max={"pulse": 1, "const": 1},
        nleaves_min={"pulse": 0, "const": 0},
        moves=[GaussianMove({"pulse": 0.05, "const": 0.05})],
        rj_moves=[ModelSwapRJMove({n: priors[n] for n in ("pulse", "const")})],
        tempering_kwargs=dict(ntemps=nt), fill_zero_leaves_val=-1e8,
        seed=23, device="cuda", cuda_graph=cuda_graph, backend=backend)
    gen = torch.Generator(device="cuda").manual_seed(7)
    coords = {n: priors[n].rvs(size=(nt, S_NW, 1), generator=gen)
              for n in priors}
    pick = np.random.default_rng(7).random((nt, S_NW)) < 0.5
    start = State(coords, inds={"pulse": torch.as_tensor(pick[..., None]),
                                "const": torch.as_tensor(~pick[..., None])})
    s.p_true = p_true
    return s, start


def modelswap_leg(torch, card):
    """``tests/test_modelswap.py:153-181``: a pulse against a constant, 64
    walkers x 3 temperatures, ``GaussianMove`` and ``ModelSwapRJMove``,
    seed 23; 200 burn-in and 800 stored steps.  Gates: exactly one model
    active in every sample, the cold chain's pulse probability within 0.1
    of the quadrature value; two cascade launches a step."""
    import numpy as np

    leg = "modelswap"
    s, start = _modelswap_sampler(torch, np, S_NT)
    p_true = s.p_true
    read = _counting(_kernels())
    t0 = time.perf_counter()
    s.run_mcmc(start, S_STEPS, burn=S_BURN)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    steps = S_BURN + S_STEPS
    launches = read()
    replays = _assert_replays(leg, s, steps, 2)
    assert launches["pt_swap_cascade_multi"] == 2 * steps, launches
    assert sum(launches.values()) == 2 * steps, launches
    nl = s.get_nleaves()
    p_pulse = float(nl["pulse"][:, 0].mean())
    rj = float(s.rj_acceptance_fraction[0].mean())
    acc = float(s.acceptance_fraction[0].mean())
    rates = {"modelswap_steps_per_s": steps / dt}
    print(f"chain[{leg}]: P(pulse) {p_pulse:.4f}, quadrature {p_true:.4f}; "
          f"one model active in every sample; swap (model) acceptance "
          f"{rj:.4f}, in-model acceptance {acc:.4f}")
    print(f"rate: modelswap_steps_per_s = {rates['modelswap_steps_per_s']:.1f} "
          f"(burn-in and stored; {card})")
    print(f"launches[{leg}]: per step {_per_step(launches, steps)} over "
          f"{steps} steps, {replays} graph replays")
    assert np.all(nl["pulse"] + nl["const"] == 1)
    assert abs(p_pulse - p_true) < 0.1, (p_pulse, p_true)
    assert 0 < rj < 1 and 0 < acc < 1, (rj, acc)
    return launches, rates, (leg, s, s._previous_state)


def tempering_phase_device_ms(torch, samplers, card, reps=50):
    """Device time of one tempering phase (the swap phase and the ladder
    update, eager) of each sampler in ``samplers`` (``{name: sampler}``) on
    its last state: the device kernels ``torch.profiler`` records over
    ``reps`` phases, per phase."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for name, s in samplers.items():
        tc, state = s.temperature_control, s._previous_state
        clock = s._start_clock(tc)
        tc.temper_kernel(s._gen, state, clock)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                tc.temper_kernel(s._gen, state, clock)
            torch.cuda.synchronize()
        device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        assert device, f"{name}: the profiler recorded no device activity"
        out[name] = dict(
            kernels=len(device) / reps,
            device_ms=sum(e.time_range.elapsed_us() for e in device)
            / reps / 1e3)
        print(f"phase[{name}]: one tempering phase {out[name]['kernels']:.2f} "
              f"device ops, {out[name]['device_ms']:.4f} ms on the device "
              f"({card})")
    return out


# the long-run legs: checkpointed storage, a resume, the hooks of run_mcmc
HDF_SEG = 200        # a checkpoint every 200 stored steps
RESUME_SEG = 100
RESUME_STEPS = {"north-star": 600, "LISA RJ null": 400}
HOOK_EVERY, HOOK_STEPS = 100, 600


def _have_h5py():
    """Whether this machine has h5py: without it the resume legs continue a
    run in the same process (a fresh sampler given the first one's
    in-memory ``Backend``) instead of a killed child's HDF5 file."""
    import importlib.util

    return importlib.util.find_spec("h5py") is not None


def _chain_record(np, s):
    """What a stored run leaves, as float64 where it is a float: the chain,
    masks, log-likelihoods and -priors, ladders, the cumulative accept,
    reversible-jump accept and swap counts, the clock, and the states of
    both generators."""
    b = s.backend
    out = dict(
        chain=s.get_chain()["model_0"], inds=s.get_inds()["model_0"],
        log_like=s.get_log_like(), log_prior=s.get_log_prior(),
        betas=s.get_betas(), accepted=b.accepted,
        swaps_accepted=b.swaps_accepted,
        clock=int(s.temperature_control.time),
        generator=s._gen.get_state().numpy(),
        host_generator=s._host_gen.get_state().numpy(),
    )
    if s.has_reversible_jump:
        out["rj_accepted"] = b.rj_accepted
    return {k: (np.asarray(v, dtype=np.float64)
                if np.asarray(v).dtype.kind == "f" else np.asarray(v))
            for k, v in out.items()}


def _assert_same_record(np, leg, a, b):
    assert a.keys() == b.keys(), (leg, a.keys(), b.keys())
    for key in a:
        assert a[key].shape == b[key].shape and np.array_equal(
            a[key], b[key], equal_nan=True), f"{leg}: {key} differs"


def hdf_leg(torch, card):
    """The north-star configuration, 200 warm steps then 1,200 stored with
    a checkpoint every 200 (``segment_size=200``), into ``HDFBackend`` on a
    file and into ``Backend()`` from one seed: equal chains and counters,
    read back as float64, and both rates.  Without h5py only the
    ``Backend()`` run is made."""
    import tempfile

    import numpy as np

    from eryn_tpu_torch import Backend

    read = _counting(_kernels())
    rates, records, samplers = {}, {}, []
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        forms = [("Backend", Backend(), "stored_host_seg200_steps_per_s")]
        if _have_h5py():
            from eryn_tpu_torch import HDFBackend

            forms.insert(0, ("HDFBackend", HDFBackend(f"{tmp}/chain.h5"),
                             "stored_hdf_steps_per_s"))
        for form, backend, metric in forms:
            s, priors = _gaussian_sampler(torch, NT, NW, 2, backend=backend)
            coords = priors.rvs(size=(NT, NW), generator=torch.Generator(
                device="cuda").manual_seed(2))
            s.run_mcmc(coords, WARM_STEPS, store=False)
            rates[metric] = _stored_run(torch, s, f"hdf[north-star], {form}",
                                        card, segment_size=HDF_SEG)
            records[form] = _chain_record(np, s)
            samplers.append(s)
    steps = len(samplers) * (WARM_STEPS + STORED_STEPS)
    launches = read()
    for s in samplers:
        _assert_replays("hdf[north-star]", s, WARM_STEPS + STORED_STEPS, 1)
    _assert_stretch_launches(launches, steps)
    assert launches["pt_swap_cascade_multi"] == steps, launches
    _check_gaussian_chain(np, "hdf[north-star], Backend", samplers[-1], NT)
    if "HDFBackend" in records:
        _assert_same_record(np, "hdf[north-star]", records["HDFBackend"],
                            records["Backend"])
        print(f"hdf[north-star]: HDFBackend and Backend() chains, "
              f"log-likelihoods, -priors, ladders, accept and swap counts "
              f"equal digit for digit over {STORED_STEPS} stored steps")
        print(f"rate: stored_hdf_steps_per_s = "
              f"{rates['stored_hdf_steps_per_s']:.1f} beside Backend() "
              f"{rates['stored_host_seg200_steps_per_s']:.1f}, "
              f"segment_size={HDF_SEG} ({card})")
    else:
        print(f"rate: stored_hdf_steps_per_s = not measured (no h5py); "
              f"Backend() {rates['stored_host_seg200_steps_per_s']:.1f}, "
              f"segment_size={HDF_SEG} ({card})")
    print(f"launches[hdf[north-star]]: {launches} over {steps} steps")
    return launches, rates, ("hdf[north-star]", samplers[-1],
                             samplers[-1]._previous_state)


class _Interrupted(Exception):
    """Ends the first half of an in-process resume leg."""


def _resume_build(torch, np, config, backend, **kw):
    """A resume leg's sampler on ``backend`` and its start state."""
    if config == "north-star":
        s, priors = _gaussian_sampler(torch, NT, NW, 4, backend=backend, **kw)
        return s, priors.rvs(size=(NT, NW), generator=torch.Generator(
            device="cuda").manual_seed(4))
    from eryn_tpu_torch.moves import RedBlueGroupStretchMove

    return _lisa_sampler(torch, np, True, RedBlueGroupStretchMove(),
                         backend=backend, **kw)


def _interrupt_at(half, kill):
    """``update_fn`` that ends the run at the first boundary at or past
    ``half``: by ``SIGKILL`` of its own process, or by an exception."""
    import os
    import signal

    def update(i, state, sampler):
        if i >= half:
            if kill:
                os.kill(os.getpid(), signal.SIGKILL)
            raise _Interrupted(i)

    return update


def resume_child(config, path):
    """``--resume-child``: run a resume leg into the HDF5 file ``path``
    until its ``update_fn`` kills this process."""
    import numpy as np
    import torch

    total = RESUME_STEPS[config]
    s, start = _resume_build(torch, np, config, path,
                             update_fn=_interrupt_at(total // 2, kill=True),
                             update_iterations=RESUME_SEG)
    s.run_mcmc(start, total, segment_size=RESUME_SEG)
    return 0  # not reached: the parent takes an exit 0 as a failure


def resume_leg(torch, card, config):
    """A run of ``RESUME_STEPS[config]`` stored steps, a checkpoint every
    100, ended at the first boundary at or past half of it and continued
    by a fresh sampler, against the uninterrupted run from the same seed:
    equal digit for digit.  With h5py the first part runs in a child
    process into an HDF5 file and is SIGKILLed from its ``update_fn``;
    without, in this process into a ``Backend()``, which a fresh sampler
    takes after the first is deleted and collected."""
    import gc
    import tempfile

    import numpy as np

    from eryn_tpu_torch import Backend

    total = RESUME_STEPS[config]
    half = -(-(total // 2) // RESUME_SEG) * RESUME_SEG
    per_step = 1 if config == "north-star" else 2
    leg = f"resume[{config}]"
    read = _counting(_kernels())
    full, start = _resume_build(torch, np, config, Backend())
    full.run_mcmc(start, total, segment_size=RESUME_SEG)
    steps = total
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        if _have_h5py():
            backend = f"{tmp}/resume.h5"
            child = subprocess.run(
                [sys.executable, str(ROOT / "chip_smoke.py"), "--resume-child",
                 config, backend], capture_output=True, text=True, timeout=600)
            assert child.returncode == -9, (leg, child.returncode,
                                            child.stderr[-2000:])
            how = "a child process SIGKILLed, its HDF5 file resumed"
        else:
            backend = Backend()
            first, start = _resume_build(
                torch, np, config, backend,
                update_fn=_interrupt_at(total // 2, kill=False),
                update_iterations=RESUME_SEG)
            try:
                first.run_mcmc(start, total, segment_size=RESUME_SEG)
            except _Interrupted:
                pass
            _assert_replays(leg, first, half, per_step)
            steps += half
            del first
            gc.collect()
            how = "in one process, a fresh sampler on the first's Backend()"
        resumed, _ = _resume_build(torch, np, config, backend)
        assert resumed.backend.iteration == half, (
            leg, resumed.backend.iteration)
        resumed.run_mcmc(None, total - half, segment_size=RESUME_SEG)
        steps += total - half
        a, b = _chain_record(np, full), _chain_record(np, resumed)
    launches = read()
    _assert_same_record(np, leg, a, b)
    _assert_replays(leg, full, total, per_step)
    _assert_replays(leg, resumed, total - half, per_step)
    if config == "north-star":
        _assert_stretch_launches(launches, steps)
        assert launches["pt_swap_cascade_multi"] == steps, launches
    else:
        assert launches["group_stretch_propose"] == 2 * steps, launches
        assert launches["pt_swap_cascade_multi"] == 2 * steps, launches
    print(f"{leg}: stopped at {half} of {total} steps ({how}) and continued "
          f"to {total}: chain, masks, log-likelihoods, -priors, ladders, "
          f"accept, RJ accept and swap counts, clock ({a['clock']}) and both "
          f"generators' states equal the uninterrupted run digit for digit")
    print(f"launches[{leg}]: {launches} over {steps} steps")
    return launches, {}, (leg, resumed, resumed._previous_state)


def resume_north_star_leg(torch, card):
    return resume_leg(torch, card, "north-star")


def resume_lisa_null_leg(torch, card):
    return resume_leg(torch, card, "LISA RJ null")


class _Recorded:
    """A hook that records the iterations it was called at, what it
    returned and the stretch scale after each call."""

    def __init__(self, fn):
        self.fn, self.calls, self.outs, self.scales = fn, [], [], []

    def __call__(self, i, state, sampler):
        self.calls.append(i)
        self.outs.append(self.fn(i, state, sampler))
        self.scales.append(sampler.moves[0].a)
        return self.outs[-1]


def hooks_leg(torch, card):
    """North-star with ``AdjustStretchProposalScale`` as ``update_fn`` and
    ``AutoCorrelationStop`` as ``stopping_fn``, both every 100 steps, over
    600 stored steps into the default ``DeviceBackend``, graphed and with
    ``cuda_graph=False`` from one seed.  The hooks fire at 100, 200, ...
    (the segments are the intervals' greatest common divisor), up to a
    stop; each change of the scale drops the graphs and the next steps
    capture anew, so the graphed chain equals the eager one digit for
    digit, and every step but one eager run per capture is a replay."""
    import numpy as np

    from eryn_tpu_torch.utils import AdjustStretchProposalScale, AutoCorrelationStop

    read = _counting(_kernels())
    runs = {}
    for graphed in (True, False):
        update = _Recorded(AdjustStretchProposalScale())
        stop = _Recorded(AutoCorrelationStop())
        s, priors = _gaussian_sampler(
            torch, NT, NW, 6, cuda_graph=graphed, update_fn=update,
            update_iterations=HOOK_EVERY, stopping_fn=stop,
            stopping_iterations=HOOK_EVERY)
        coords = priors.rvs(size=(NT, NW), generator=torch.Generator(
            device="cuda").manual_seed(6))
        s.run_mcmc(coords, HOOK_STEPS)
        steps = s.backend.iteration
        # each boundary: the stopping check, then (unless it stopped) the
        # update
        expected = list(range(HOOK_EVERY, steps + 1, HOOK_EVERY))
        assert stop.calls == expected, stop.calls
        assert update.calls == expected[:len(expected) - stop.outs[-1]], (
            update.calls, stop.outs)
        runs[graphed] = (s, steps, update, _chain_record(np, s))
    launches = read()
    (s, steps, update, rec), (e, steps_e, update_e, rec_e) = (runs[True],
                                                              runs[False])
    assert steps == steps_e and update.scales == update_e.scales, (
        update.scales, update_e.scales)
    _assert_same_record(np, "hooks[north-star]", rec, rec_e)
    # a graph set at the start, and one after each change of the scale
    # that steps follow; each set runs its first step eagerly
    changes, sets, a = 0, 1, 2.0
    for i, new in zip(update.calls, update.scales):
        changes += new != a
        sets += new != a and i < steps
        a = new
    assert changes > 0, update.scales
    assert s.graph_captures == sets, (s.graph_captures, sets)
    assert s.graph_replays == steps - sets, (s.graph_replays, steps)
    assert e.graph_replays == 0
    _assert_stretch_launches(launches, 2 * steps)
    assert launches["pt_swap_cascade_multi"] == 2 * steps, launches
    print(f"hooks[north-star]: stopping_fn at "
          f"{list(range(HOOK_EVERY, steps + 1, HOOK_EVERY))}, "
          f"update_fn at {update.calls}, stretch scale "
          f"{[round(float(x), 6) for x in update.scales]} ({changes} changes, "
          f"{sets} captures); the graphed chain equals the cuda_graph=False "
          f"chain digit for digit over {steps} steps")
    print(f"launches[hooks[north-star]]: {launches} over {2 * steps} steps, "
          f"{s.graph_replays} graph replays")
    return launches, {}, ("hooks[north-star]", s, s._previous_state)


# ----------------------------------------------------------------------
# the host side: NumPy likelihoods, a pool, and a host move among native
# ones (between the replays of the native moves' graphs)
# ----------------------------------------------------------------------
HOST_WARM, HOST_STORED = 100, 300
POOL_STEPS = 50
# benchmarks/hybrid_host.py:43-105: 4 x 100, 5-D, U(-10, 10), the start
# uniform(-2, 2) from default_rng(0), seed 7; the stretch move at weight
# 0.9 and a host MH move at 0.1; 64 warm and 300 timed steps in segments
# of 32
HYB_NT, HYB_NW, HYB_WARM, HYB_STEPS, HYB_SEG = 4, 100, 64, 300, 32
POOL_PIDS_ENV = "CHIP_SMOKE_POOL_PIDS"


def host_log_like(x):
    """The north-star's likelihood in NumPy for one walker's ``(5,)`` row.
    Module-level, so that a spawn pool's workers unpickle it by name; in a
    process where ``CHIP_SMOKE_POOL_PIDS`` names a file it appends its pid
    there."""
    import os

    import numpy as np

    pid_file = os.environ.get(POOL_PIDS_ENV)
    if pid_file:
        with open(pid_file, "a") as fh:
            fh.write(f"{os.getpid()}\n")
    return -0.5 * float(np.sum(x ** 2))


def host_log_like_rows(x):
    """The same for the ``(n, 5)`` rows of a vectorized call."""
    import numpy as np

    return -0.5 * np.sum(x ** 2, axis=-1)


class _Timed:
    """A likelihood that adds the wall time spent inside it to
    ``seconds``."""

    def __init__(self, fn):
        self.fn, self.seconds, self.calls = fn, 0.0, 0

    def __call__(self, *args, **kwargs):
        t0 = time.perf_counter()
        try:
            return self.fn(*args, **kwargs)
        finally:
            self.seconds += time.perf_counter() - t0
            self.calls += 1


def _host_sampler(torch, fn, seed=0, **kw):
    """The north-star configuration with a NumPy likelihood."""
    import warnings

    from eryn_tpu_torch import EnsembleSampler, ProbDistContainer, uniform_dist

    priors = ProbDistContainer({i: uniform_dist(-5.0, 5.0) for i in range(NDIM)})
    sampler = EnsembleSampler(NW, NDIM, fn, priors,
                              tempering_kwargs=dict(ntemps=NT), seed=seed,
                              device="cuda", **kw)
    coords = priors.rvs(size=(NT, NW), generator=torch.Generator(
        device="cuda").manual_seed(0))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        state = sampler._setup_state(coords)
    assert any("never as a CUDA graph" in str(w.message) for w in caught), \
        [str(w.message) for w in caught]
    assert sampler.likelihood_mode == "host", sampler.likelihood_mode
    return sampler, state


def _assert_host_mode_launches(leg, sampler, launches, steps):
    """A host likelihood: no graph, one of each stretch kernel and one
    cascade a step."""
    assert sampler.graph_captures == sampler.graph_replays == 0, leg
    _assert_stretch_launches(launches, steps)
    assert launches["pt_swap_cascade_multi"] == steps, (leg, launches)
    assert launches["_cascade_multi_rolled"] == launches["onehot_select"] \
        == launches["group_stretch_propose"] == 0, (leg, launches)


def host_like_leg(torch, card, vectorize=False):
    """The north-star with a NumPy likelihood: per walker, or with
    ``vectorize=True`` once per red/blue half on its ``(n, 5)`` rows; 100
    warm and 300 stored steps into the default ``DeviceBackend``, every
    step eager (no capture), the fused stretch kernels and the cascade
    around the host calls."""
    import numpy as np

    leg = "host_like_vec[north-star]" if vectorize else "host_like[north-star]"
    key = "host_like_vec" if vectorize else "host_like"
    fn = _Timed(host_log_like_rows if vectorize else host_log_like)
    read = _counting(_kernels())
    s, state = _host_sampler(torch, fn, vectorize=vectorize)
    s.run_mcmc(state, HOST_WARM, store=False)
    torch.cuda.synchronize()
    fn.seconds, fn.calls = 0.0, 0
    t0 = time.perf_counter()
    s.run_mcmc(None, HOST_STORED)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    steps = HOST_WARM + HOST_STORED
    launches = read()
    _assert_host_mode_launches(leg, s, launches, steps)
    _check_gaussian_chain(np, leg, s, NT)
    rates = {f"{key}_steps_per_s": HOST_STORED / dt,
             f"{key}_user_ms_per_step": 1e3 * fn.seconds / HOST_STORED,
             f"{key}_calls_per_step": fn.calls / HOST_STORED}
    print(f"rate: {key}_steps_per_s = {rates[key + '_steps_per_s']:.1f}; "
          f"inside the user function "
          f"{rates[key + '_user_ms_per_step']:.3f} ms a step over "
          f"{rates[key + '_calls_per_step']:.1f} calls ({card})")
    print(f"launches[{leg}]: {launches} over {steps} steps, no graph")
    return launches, rates, (leg, s, s._previous_state)


def host_like_vec_leg(torch, card):
    return host_like_leg(torch, card, vectorize=True)


def host_like_pool_leg(torch, card):
    """The per-walker NumPy likelihood through a spawn pool of two
    processes (which never touch CUDA), 50 stored steps: its chain and
    log-likelihoods equal to the serial run of the same seed digit for
    digit, and the likelihood ran in more than one worker process."""
    import multiprocessing as mp
    import os

    import numpy as np

    leg = "host_like_pool[north-star]"
    pid_file = ROOT / "build" / "chip_smoke_pool_pids.txt"
    pid_file.parent.mkdir(parents=True, exist_ok=True)
    pid_file.unlink(missing_ok=True)
    read = _counting(_kernels())
    runs = {}
    for pooled in (True, False):
        if pooled:
            os.environ[POOL_PIDS_ENV] = str(pid_file)
            pool = mp.get_context("spawn").Pool(2)
            os.environ.pop(POOL_PIDS_ENV)
        else:
            pool = None
        try:
            s, state = _host_sampler(torch, host_log_like, pool=pool)
            t0 = time.perf_counter()
            s.run_mcmc(state, POOL_STEPS)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        finally:
            if pool is not None:
                pool.close()
                pool.join()
        runs[pooled] = (s, POOL_STEPS / dt)
    launches = read()
    for pooled, (s, _) in runs.items():
        assert s.graph_captures == s.graph_replays == 0, leg
    _assert_host_mode_launches(leg, runs[False][0], launches,
                               2 * POOL_STEPS)
    (sp, rate_pool), (ss, rate_serial) = runs[True], runs[False]
    np.testing.assert_array_equal(sp.get_chain()["model_0"],
                                  ss.get_chain()["model_0"])
    np.testing.assert_array_equal(sp.get_log_like(), ss.get_log_like())
    pids = {int(p) for p in pid_file.read_text().split()} - {os.getpid()}
    assert len(pids) > 1, pids
    rates = {"host_like_pool_steps_per_s": rate_pool,
             "host_like_serial_steps_per_s": rate_serial}
    print(f"rate: host_like_pool_steps_per_s = {rate_pool:.1f} (Pool(2), "
          f"spawn) beside the serial {rate_serial:.1f} ({card})")
    print(f"pool[{leg}]: chain and log-likelihoods equal to the serial run "
          f"digit for digit over {POOL_STEPS} steps; {len(pids)} worker "
          f"processes ran the likelihood")
    print(f"launches[{leg}]: {launches} over {2 * POOL_STEPS} steps, "
          "no graph")
    return launches, rates, []


def _host_mh_class():
    """The host move of benchmarks/hybrid_host.py: Eryn's host
    ``get_proposal``, ``q = c + 0.3 randn`` from the sampler's RandomState,
    zero factors; counts its calls."""
    import numpy as np

    from eryn_tpu_torch.moves import MHMove

    class CustomHostMH(MHMove):
        calls = 0

        def get_proposal(self, branches_coords, random, branches_inds=None,
                         **kwargs):
            type(self).calls += 1
            q = {n: np.asarray(c) + 0.3 * random.randn(*np.shape(c))
                 for n, c in branches_coords.items()}
            return q, np.zeros(next(iter(q.values())).shape[:2])

    return CustomHostMH


def hybrid_host_leg(torch, card):
    """benchmarks/hybrid_host.py's configuration in three forms: the
    stretch move alone (graphed), the stretch move and the host move
    (graphed: the stretch slots replay, the host slots run eagerly between),
    and the same with ``cuda_graph=False``.  The two hybrid runs are equal
    digit for digit; replays are the native slots (but the first), host
    proposals the host slots; every slot ends in one cascade launch."""
    import warnings

    import numpy as np

    from eryn_tpu_torch import EnsembleSampler, ProbDistContainer, uniform_dist
    from eryn_tpu_torch.moves import StretchMove

    leg = "hybrid_host[4 x 100]"
    priors = ProbDistContainer({i: uniform_dist(-10.0, 10.0)
                                for i in range(NDIM)})
    coords = np.random.default_rng(0).uniform(-2, 2, (HYB_NT, HYB_NW, 1, NDIM))
    host_mh = _host_mh_class()

    def log_like(x):
        return -0.5 * torch.sum(x * x)

    read = _counting(_kernels())
    rates, runs, slots = {}, {}, {"stretch": 0, "cascade": 0}
    for form in ("native", "hybrid", "hybrid_eager"):
        moves = (StretchMove() if form == "native" else
                 [(StretchMove(), 0.9), (host_mh(), 0.1)])
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            s = EnsembleSampler(
                HYB_NW, NDIM, log_like, priors, moves=moves,
                tempering_kwargs=dict(ntemps=HYB_NT), seed=7, device="cuda",
                cuda_graph=form != "hybrid_eager")
        host_mh.calls = 0
        guard = (_segments_never_wait() if form == "native"
                 else contextlib.nullcontext())
        with guard:
            s.run_mcmc(coords, HYB_WARM, segment_size=HYB_SEG)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s.run_mcmc(None, HYB_STEPS, segment_size=HYB_SEG)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        rates[f"{form}_steps_per_s"] = HYB_STEPS / dt
        total = HYB_WARM + HYB_STEPS
        native = s.moves[0].num_proposals
        host = 0 if form == "native" else s.moves[1].num_proposals
        assert native + host == total, (form, native, host)
        assert host_mh.calls == host, (form, host_mh.calls, host)
        if form != "native":
            assert host > 0, form
        replays = (native - 1) if form != "hybrid_eager" else 0
        assert s.graph_replays == replays, (form, s.graph_replays, replays)
        slots["stretch"] += native
        slots["cascade"] += total
        cold = s.get_chain(temp_index=0)["model_0"].reshape(-1, NDIM)
        mean = cold.mean(axis=0, dtype=np.float64)
        var = cold.var(axis=0, dtype=np.float64)
        print(f"chain[{leg}, {form}]: cold mean {np.round(mean, 4).tolist()} "
              f"var {np.round(var, 4).tolist()}; {native} stretch slots, "
              f"{host} host slots, {s.graph_replays} graph replays")
        assert np.all(np.abs(mean) < 0.1) and np.all(np.abs(var - 1) < 0.2)
        if form == "hybrid":
            kept = (leg, s, s._previous_state)
        runs[form] = {k: np.asarray(v) for k, v in dict(
            chain=s.get_chain()["model_0"], log_like=s.get_log_like(),
            betas=s.get_betas(), accepted=s.backend.accepted,
            swaps=s.backend.swaps_accepted).items()}
    for key in runs["hybrid"]:
        np.testing.assert_array_equal(runs["hybrid"][key],
                                      runs["hybrid_eager"][key], err_msg=key)
    launches = read()
    _assert_stretch_launches(launches, slots["stretch"])
    assert launches["pt_swap_cascade_multi"] == slots["cascade"], launches
    print(f"rate: native_steps_per_s = {rates['native_steps_per_s']:.1f}, "
          f"hybrid_steps_per_s = {rates['hybrid_steps_per_s']:.1f}, "
          f"hybrid_eager_steps_per_s = "
          f"{rates['hybrid_eager_steps_per_s']:.1f} ({card})")
    print(f"hybrid[{leg}]: graphed equal to cuda_graph=False digit for digit")
    print(f"launches[{leg}]: {launches} over three runs of "
          f"{HYB_WARM + HYB_STEPS} steps")
    return launches, rates, kept


# ----------------------------------------------------------------------
# batched independent ensembles (ParaEnsembleSampler): the kernels with a
# group axis, the para legs, and pickling
# ----------------------------------------------------------------------
# para[north-star x64]: the north-star configuration in 64 groups
PARA_G, PARA_WARM, PARA_STEPS = 64, 200, 1000
# para[zoo x4] (tests/test_para.py:244-272): 4 groups x 24 walkers, 2-D
PZ_G, PZ_NW, PZ_NDIM, PZ_BURN, PZ_STEPS = 4, 24, 2, 80, 150
# para[rj_pulse128 x16]: config C in 16 groups
PR_G, PR_WARM, PR_STEPS = 16, 500, 1000
GROUP_SIZES = (1, 4, 64)
# the grouped launches a para leg makes (the rolled cascade is held to its
# plain version in phase 3 only: no para leg exceeds 640 walkers)
PARA_KERNELS = ("stretch_propose", "stretch_accept_propose", "stretch_accept",
                "pt_swap_cascade_multi", "group_stretch_propose")


def _stack_groups(torch, parts):
    """Tensors, or dicts of them, of ``G`` groups stacked on a leading
    axis (``parts``: one tuple of arguments per group)."""
    out = []
    for items in zip(*parts):
        if isinstance(items[0], dict):
            out.append({n: torch.stack([x[n] for x in items])
                        for n in items[0]})
        elif isinstance(items[0], (list, tuple)):
            out.append([torch.stack(xs) for xs in zip(*items)])
        else:
            out.append(torch.stack(items))
    return out


def _grouped_stretch_state(torch, rand, randn, gen, dtype, G, nt, nw, D):
    parts = [_stretch_state(torch, rand, randn, gen, dtype, nt, nw, D)
             for _ in range(G)]
    st = {k: torch.stack([p[0][k] for p in parts]) for k in parts[0][0]}
    new = [tuple(torch.stack([p[1][h][i] for p in parts]) for i in range(2))
           for h in range(2)]
    return st, new


def _grouped_stretch_stages(torch, sk, st, new, log_proposal):
    """One grouped fused step and the split form (half 0's accept alone,
    then half 1's proposal from it) through the grouped kernels and their
    plain versions, each plain stage fed the kernel stage's inputs; yields
    ``(kernel, kernel outputs, plain outputs)``."""
    X, nd, perm, u = st["X"], st["ndim_act"], st["perm"], st["u_all"]
    logl, logp, betas = st["logl"], st["logp"], st["betas"]
    kw = dict(a=2.0, log_proposal=log_proposal)
    nan = float("nan")

    def outs():
        return (torch.full_like(X, nan),
                *(torch.full_like(logl, nan) for _ in range(3)))

    o_k, o_r = outs(), outs()
    q0, f0 = sk.stretch_propose_grouped(X, X, nd, perm, u, 0, **kw)
    yield ("stretch_propose", (q0, f0),
           sk.stretch_propose_grouped_ref(X, X, nd, perm, u, 0, **kw))
    a0 = (q0, X, *new[0], logl, logp, f0, betas, nd, perm, u)
    q1, f1 = sk.stretch_accept_propose_grouped(*a0, *o_k, **kw)
    q1r, f1r = sk.stretch_accept_propose_grouped_ref(*a0, *o_r, **kw)
    yield "stretch_accept_propose", (q1, f1, *o_k), (q1r, f1r, *o_r)
    a1 = (q1, X, *new[1], logl, logp, f1, betas, perm, u, 1)
    sk.stretch_accept_grouped(*a1, *o_k)
    sk.stretch_accept_grouped_ref(*a1, *o_r)
    assert not o_k[0].isnan().any() and 0 < float(o_k[3].sum()) < o_k[3].numel()
    yield "stretch_accept", o_k, o_r
    s_k, s_r = outs(), outs()
    a0s = (q0, X, *new[0], logl, logp, f0, betas, perm, u, 0)
    sk.stretch_accept_grouped(*a0s, *s_k)
    sk.stretch_accept_grouped_ref(*a0s, *s_r)
    yield "stretch_accept", s_k, s_r
    yield ("stretch_propose",
           sk.stretch_propose_grouped(X, s_k[0], nd, perm, u, 1, **kw),
           sk.stretch_propose_grouped_ref(X, s_k[0], nd, perm, u, 1, **kw))


def _grouped_tree_args(torch, rand, randn, gen, G, nt, nw, nl, nd, dtype):
    parts = [_tree_args(torch, rand, randn, gen, nt, nw, nl, nd, dtype)[0]
             for _ in range(G)]
    args = _stack_groups(torch, parts)
    logl = args[0]

    def outs():
        return (torch.empty_like(logl), [torch.empty_like(x) for x in args[1]],
                logl.new_empty((G, nt - 1)), logl.new_empty((G, nt - 1, nw)))

    return args, outs


def _grouped_group_args(torch, rand, randn, dtype, G, **case):
    """``G`` groups of :func:`_group_args`, the moving block a view of the
    stacked permuted ensemble as the move has it."""
    parts = [_group_args(torch, rand, randn, dtype, **case)[0]
             for _ in range(G)]
    s, si, c, ci, u, uu = _stack_groups(torch, [p[:6] for p in parts])
    off, ns = parts[0][6]
    blk = slice(off, off + ns)
    return ({n: x[:, :, blk] for n, x in c.items()},
            {n: x[:, :, blk] for n, x in ci.items()}, c, ci, u, uu, (off, ns))


def check_grouped_kernels(torch, dtype_name):
    """The grouped launches (a leading group axis, one launch for every
    group) against their plain grouped versions at ``G`` in
    :data:`GROUP_SIZES`: the stretch step fused and split at the north-star
    shape, the cascade in the tree form at the north-star shape (plain) and
    config E's (rolled), the group-stretch proposal at the RJ shape.  Max
    abs error 0, NaN in the same places, decisions identical; at ``G = 1``
    each equals the ungrouped launch bitwise.  Returns ``{kernel[grouped]:
    max_abs_err}``."""
    from eryn_tpu_torch.ops import pt_swap, select_kernels, stretch_kernels as sk

    dtype = getattr(torch, dtype_name)
    gen = torch.Generator().manual_seed(4321)
    errs = {}

    def rand(*shape):
        return torch.rand(shape, generator=gen, dtype=torch.float64).to(
            device="cuda", dtype=dtype)

    def randn(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float64).to(
            device="cuda", dtype=dtype)

    def record(name, outs_k, outs_r):
        for a, b in zip(outs_k, outs_r):
            assert a.dtype == b.dtype and torch.equal(a.isnan(), b.isnan()), name
        err = max(_max_err(a, b) for a, b in zip(outs_k, outs_r))
        assert err == 0.0, (name, G, dtype_name, err)
        key = f"{name}[grouped]"
        errs[key] = max(errs.get(key, 0.0), err)

    for G in GROUP_SIZES:
        for log_proposal in (False, True):
            st, new = _grouped_stretch_state(torch, rand, randn, gen, dtype, G,
                                             NT, NW, NDIM)
            kept = {}
            for name, outs_k, outs_r in _grouped_stretch_stages(
                    torch, sk, st, new, log_proposal):
                record(name, outs_k, outs_r)
                kept.setdefault(name, [t.clone() for t in outs_k])
            if G == 1:
                # the ungrouped launches on group 0 give the same numbers,
                # stage by stage
                one = {k: v[0] for k, v in st.items()}
                new0 = [tuple(x[0] for x in h) for h in new]
                kw = dict(a=2.0, log_proposal=log_proposal)
                outs = (torch.full_like(one["X"], float("nan")),
                        *(torch.full_like(one["logl"], float("nan"))
                          for _ in range(3)))
                X, nd, perm, u = (one[k] for k in ("X", "ndim_act", "perm",
                                                   "u_all"))
                q0, f0 = sk.stretch_propose(X, X, nd, perm, u, 0, **kw)
                q1, f1 = sk.stretch_accept_propose(
                    q0, X, *new0[0], one["logl"], one["logp"], f0,
                    one["betas"], nd, perm, u, *outs, **kw)
                stages = {"stretch_propose": (q0, f0),
                          "stretch_accept_propose": (q1, f1, *outs)}
                stages = {k: [t.clone() for t in v] for k, v in stages.items()}
                sk.stretch_accept(q1, X, *new0[1], one["logl"], one["logp"],
                                  f1, one["betas"], perm, u, 1, *outs)
                stages["stretch_accept"] = outs
                for name, ungrouped in stages.items():
                    for a, b in zip(ungrouped, kept[name]):
                        assert torch.equal(a.isnan(), b[0].isnan()) and (
                            _max_err(a, b[0]) == 0.0), f"{name} at G = 1"
        for nt, nw in ((NT, NW), (E_NT, E_NW)):
            name = ("_cascade_multi_rolled" if nw > pt_swap.ROLLED_THRESHOLD
                    else "pt_swap_cascade_multi")
            args, outs = _grouped_tree_args(torch, rand, randn, gen, G, nt, nw,
                                            1, NDIM, dtype)
            out_k, out_r = outs(), outs()
            before = getattr(pt_swap, name).launches
            pt_swap.pt_swap_cascade_tree_grouped(*args, *out_k)
            assert getattr(pt_swap, name).launches == before + 1
            pt_swap.pt_swap_cascade_tree_grouped_ref(*args, *out_r)
            assert 0 < float(out_r[2].sum()) < G * (nt - 1) * nw
            record(name, _flat(out_k), _flat(out_r))
            if G == 1:
                one = tuple(x[0] if not isinstance(x, list) else [y[0] for y in x]
                            for x in outs())
                pt_swap.pt_swap_cascade_tree(args[0][0], [x[0] for x in args[1]],
                                             *(x[0] for x in args[2:]), *one)
                for a, b in zip(_flat(one), _flat(out_k)):
                    assert torch.equal(a, b[0]), f"{name} at G = 1"
        gargs = _grouped_group_args(torch, rand, randn, dtype, G,
                                    **GROUP_CASES[1])
        q_k, f_k = select_kernels.group_stretch_propose_grouped(*gargs)
        q_r, f_r = select_kernels.group_stretch_propose_grouped_ref(*gargs)
        record("group_stretch_propose", (f_k, *q_k.values()),
               (f_r, *q_r.values()))
        if G == 1:
            q1, f1 = select_kernels.group_stretch_propose(
                *({n: x[0] for n, x in d.items()} for d in gargs[:4]),
                gargs[4][0], {n: x[0] for n, x in gargs[5].items()}, gargs[6])
            assert torch.equal(f1, f_k[0]) and all(
                torch.equal(q1[n].isnan(), q_k[n][0].isnan()) for n in q1)
    torch.cuda.synchronize()
    return errs


def time_grouped_kernels(torch):
    """The grouped launches and their plain grouped versions, float32: the
    stretch step and the cascade at ``G = 64`` of the north-star shape, the
    rolled cascade at ``G = 4`` of config E's, the group-stretch proposal
    at ``G = 16`` of config C's (block 0 of the split); as
    :func:`time_kernels` (bound: ``G`` times the bytes and operations of
    one group)."""
    from eryn_tpu_torch.ops import pt_swap, select_kernels
    from eryn_tpu_torch.ops import stretch_kernels as sk

    g = torch.Generator(device="cuda").manual_seed(17)
    f32 = dict(device="cuda", dtype=torch.float32)

    def rand(*shape):
        return torch.rand(shape, generator=g, **f32)

    def randn(*shape):
        return torch.randn(shape, generator=g, **f32)

    calls = {}
    G = PARA_G
    st, new = _grouped_stretch_state(torch, rand, randn, g, torch.float32, G,
                                     NT, NW, NDIM)
    X, nd, perm, u = st["X"], st["ndim_act"], st["perm"], st["u_all"]
    outs = (torch.empty_like(X), *(torch.empty_like(st["logl"])
                                   for _ in range(3)))
    q0, f0 = sk.stretch_propose_grouped(X, X, nd, perm, u, 0)
    acc0 = (q0, X, *new[0], st["logl"], st["logp"], f0, st["betas"], nd, perm,
            u, *outs)
    q1, f1 = sk.stretch_accept_propose_grouped(*acc0)
    acc1 = (q1, X, *new[1], st["logl"], st["logp"], f1, st["betas"], perm, u,
            1, *outs)
    b = {k: 0 for k in ("propose", "accept_propose", "accept")}
    for i in range(G):
        for k, v in _stretch_bytes(torch, NT, NW, NDIM, 4, u[i]).items():
            b[k] += v
    n0, n1 = NW - NW // 2, NW // 2
    ops_p, ops_a = 3 * NDIM + 9, NDIM + 10
    tag = f"[G={G}]"
    calls["stretch_propose" + tag] = (
        lambda: sk.stretch_propose_grouped(X, X, nd, perm, u, 0),
        lambda: sk.stretch_propose_grouped_ref(X, X, nd, perm, u, 0),
        b["propose"], G * NT * n0 * ops_p)
    calls["stretch_accept_propose" + tag] = (
        lambda: sk.stretch_accept_propose_grouped(*acc0),
        lambda: sk.stretch_accept_propose_grouped_ref(*acc0),
        b["accept_propose"], G * NT * (n0 * ops_a + n1 * ops_p))
    calls["stretch_accept" + tag] = (
        lambda: sk.stretch_accept_grouped(*acc1),
        lambda: sk.stretch_accept_grouped_ref(*acc1),
        b["accept"], G * NT * n1 * ops_a)
    for name, gs, (nt, nw) in (("pt_swap_cascade_multi", G, (NT, NW)),
                               ("_cascade_multi_rolled", 4, (E_NT, E_NW))):
        args, mk = _grouped_tree_args(torch, rand, randn, g, gs, nt, nw, 1,
                                      NDIM, torch.float32)
        o = mk()[:3]
        nbytes = 2 * _nbytes(args[0], *args[1]) + _nbytes(*args[2:], o[2])
        calls[f"{name}[G={gs}]"] = (
            lambda a=args, o=o: pt_swap.pt_swap_cascade_tree_grouped(*a, *o),
            lambda a=args, o=o: pt_swap.pt_swap_cascade_tree_grouped_ref(*a, *o),
            nbytes, 3 * gs * (nt - 1) * nw)
    case = dict(nt=NT, nw=NW, shapes={"model_0": (P_NLMAX, 3)}, off=0,
                ns=NW // 2, overflow=False)
    gargs = _grouped_group_args(torch, rand, randn, torch.float32, PR_G, **case)
    nbytes = ops = 0
    for i in range(PR_G):
        one = (*({n: x[i] for n, x in d.items()} for d in gargs[:4]),
               gargs[4][i], {n: x[i] for n, x in gargs[5].items()}, gargs[6])
        nb, no = _group_bytes_ops(torch, one)
        nbytes, ops = nbytes + nb, ops + no
    calls[f"group_stretch_propose[G={PR_G}]"] = (
        lambda: select_kernels.group_stretch_propose_grouped(*gargs),
        lambda: select_kernels.group_stretch_propose_grouped_ref(*gargs),
        nbytes, ops)
    times = {}
    for name, (run_k, run_r, nbytes, ops) in calls.items():
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / F32_OPS_PER_S * 1e3
        times[name] = {
            "ms": _time_ms(run_k),
            "plain_ms": _time_ms(run_r, reps=10),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        }
    return times, {k: c[0] for k, c in calls.items()}


class _ParaBulk:
    """A batched runner seen as :func:`profile_steps` sees a sampler:
    ``_run_bulk`` advances the runner's own state."""

    def __init__(self, para):
        self.para = para

    def _run_bulk(self, state, nstored, thin_by, store=True):
        st, clock = self.para._state
        st, clock, _ = self.para._run_segment(st, clock, nstored, thin_by,
                                              store)
        self.para._state = (st, clock)
        return st, None


@contextlib.contextmanager
def _para_segments_never_wait():
    """:func:`_segments_never_wait` for the batched runner's segments
    (``ParaEnsembleSampler._run_segment``); the host copy of a stored
    segment runs after it."""
    import torch

    from eryn_tpu_torch.parallel import ParaEnsembleSampler

    run = ParaEnsembleSampler._run_segment

    def checked(self, *args, **kwargs):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return run(self, *args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    ParaEnsembleSampler._run_segment = checked
    try:
        yield
    finally:
        ParaEnsembleSampler._run_segment = run


def _para_gaussian(torch, G, seed, cuda_graph=True, nw=NW, ndim=NDIM, nt=NT,
                   **kw):
    """The north-star target in ``G`` groups, and its start."""
    from eryn_tpu_torch import ProbDistContainer, uniform_dist
    from eryn_tpu_torch.parallel import ParaEnsembleSampler

    invcov = torch.eye(ndim, device="cuda")

    def log_like(x):
        return -0.5 * torch.sum(x * (invcov @ x))

    lo = -5.0 if ndim == NDIM else -6.0
    priors = ProbDistContainer({i: uniform_dist(lo, -lo) for i in range(ndim)})
    if nt > 1:
        kw.setdefault("tempering_kwargs", dict(ntemps=nt))
    para = ParaEnsembleSampler(G, nw, ndim, log_like, priors, seed=seed,
                               device="cuda", cuda_graph=cuda_graph, **kw)
    coords = priors.rvs(size=(G, nt, nw), generator=torch.Generator(
        device="cuda").manual_seed(seed))
    return para, coords


def _para_digest(para):
    """The first 16 hex digits of a sha256 of a batched runner's stored
    chain, log-likelihoods and ladders: equal digests, equal chains."""
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    for a in (para.get_chain()["model_0"], para.get_log_like(),
              para.get_betas()):
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


def _para_launches(launches):
    return {f"{k}[grouped]": launches[k] for k in PARA_KERNELS}


def _assert_para_replays(leg, para, steps, per_step):
    warm = len(para._graphs.warm)
    assert warm == per_step, (leg, para._graphs.warm)
    assert para.graph_replays == per_step * steps - warm, (
        leg, para.graph_replays, steps)
    return para.graph_replays


def para_north_star_leg(torch, card):
    """``para[north-star x64]``: 64 groups of the north-star configuration
    (10 x 100, 5-D unit Gaussian, ``StretchMove``, the cascade, vousden,
    float32), graphed: ``PARA_WARM`` steps of burn-in, then ``PARA_STEPS``
    stored (the chain stays on the device), timed; the first
    ``get_chain()`` (its copy to the host), timed; ``PARA_STEPS`` steps
    without storing, timed after as many untimed.  Gates per group: the
    north-star's cold moments, acceptance, swaps and adapted ladder, every
    group's chain its own; 3 stretch launches and 1 cascade a step for all
    the groups together, every entry a replay."""
    import numpy as np

    from eryn_tpu_torch import make_ladder

    leg = f"para[north-star x{PARA_G}]"
    para, coords = _para_gaussian(torch, PARA_G, 20)
    read = _counting(_kernels())
    para.run_mcmc(coords, 0, burn=PARA_WARM)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    para.run_mcmc(None, PARA_STEPS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    # the stored chain stays on the device: the first getter copies it
    t0 = time.perf_counter()
    chain = para.get_chain()["model_0"]
    t_get = time.perf_counter() - t0
    # the same steps without storing
    bulk = _ParaBulk(para)
    bulk._run_bulk(None, 1, PARA_STEPS, store=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bulk._run_bulk(None, 1, PARA_STEPS, store=False)
    torch.cuda.synchronize()
    dt_nostore = time.perf_counter() - t0
    steps = PARA_WARM + 3 * PARA_STEPS
    launches = read()
    replays = _assert_para_replays(leg, para, steps, 1)
    _assert_stretch_launches(launches, steps)
    assert launches["pt_swap_cascade_multi"] == steps, launches
    assert sum(launches.values()) == 4 * steps, launches
    cold = chain[:, :, 0, :, 0, :]  # (n, G, nw, ndim)
    cold = cold.transpose(1, 0, 2, 3).reshape(PARA_G, -1, NDIM)
    mean = cold.mean(axis=1, dtype=np.float64)
    var = cold.var(axis=1, dtype=np.float64)
    acc = para.acceptance_fraction[:, 0].mean(axis=-1)
    swaps = para.swap_acceptance_fraction
    betas = para.get_betas()[-1]
    ladder = make_ladder(NDIM, NT)
    print(f"chain[{leg}]: per group, cold |mean| max "
          f"{np.abs(mean).max():.4f}, |var - 1| max "
          f"{np.abs(var - 1).max():.4f}, acceptance in "
          f"[{acc.min():.4f}, {acc.max():.4f}], swap acceptance in "
          f"[{swaps.min():.4f}, {swaps.max():.4f}]")
    assert np.all(np.abs(mean) < 0.05), mean
    assert np.all(np.abs(var - 1.0) < 0.1), var
    assert np.all((acc > 0.2) & (acc < 0.8)), acc
    assert np.all((swaps > 0) & (swaps < 1)), swaps
    assert not any(np.allclose(b, ladder) for b in betas), \
        "a group's ladder did not adapt"
    last = chain[PARA_STEPS - 1].reshape(PARA_G, -1)
    assert len(np.unique(last, axis=0)) == PARA_G, "two groups' chains agree"
    rates = {"para_steps_per_s": PARA_STEPS / dt,
             "para_group_steps_per_s": PARA_G * PARA_STEPS / dt,
             "para_nostore_steps_per_s": PARA_STEPS / dt_nostore,
             "para_get_chain_s": t_get}
    print(f"rate: para_steps_per_s = {rates['para_steps_per_s']:.1f}, "
          f"para_group_steps_per_s = {rates['para_group_steps_per_s']:.1f} "
          f"({PARA_G} groups, {PARA_STEPS} stored steps), "
          f"para_nostore_steps_per_s = "
          f"{rates['para_nostore_steps_per_s']:.1f}, the first get_chain() "
          f"{t_get:.4f} s (the stored chain to the host; {card})")
    print(f"launches[{leg}]: {launches} over {steps} steps, {replays} graph "
          f"replays")
    print(f"digest[{leg}]: {_para_digest(para)}")
    return _para_launches(launches), rates, (leg, _ParaBulk(para), None)


def para_zoo_leg(torch, card):
    """``para[zoo x4]``, the contract of ``tests/test_para.py:244-272`` on
    the card: 4 groups x 24 walkers on the 2-D unit Gaussian with
    ``ChEESHMCMove(tune_steps=50, max_leapfrog=8)``, ``SliceMove(
    tune_steps=50)`` and DEO at 3 temperatures, ``PZ_BURN`` + ``PZ_STEPS``
    steps, graphed; each group's cold mean and standard deviation within
    0.35 of 0 and 1.  No kernel runs ChEES or slice (one temperature); DEO
    runs the three stretch kernels and no cascade."""
    import numpy as np

    from eryn_tpu_torch.moves import ChEESHMCMove, SliceMove

    read = _counting(_kernels())
    total = {}
    rates = {}
    for label, kw, nt in (
            ("chees", dict(moves=[ChEESHMCMove(tune_steps=50,
                                               max_leapfrog=8)]), 1),
            ("slice", dict(moves=[SliceMove(tune_steps=50)]), 1),
            ("deo", dict(tempering_kwargs=dict(ntemps=3,
                                               swap_scheme="deo")), 3)):
        leg = f"para[zoo x{PZ_G}][{label}]"
        para, coords = _para_gaussian(torch, PZ_G, 61, nw=PZ_NW,
                                      ndim=PZ_NDIM, nt=nt, **kw)
        before = read()
        t0 = time.perf_counter()
        para.run_mcmc(coords, PZ_STEPS, burn=PZ_BURN)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = {k: v - before[k] for k, v in read().items()}
        steps = PZ_STEPS + PZ_BURN
        _assert_para_replays(leg, para, steps, 1)
        stretch = steps if label == "deo" else 0
        assert launches["stretch_propose"] == stretch, launches
        assert sum(launches.values()) == 3 * stretch, launches
        chain = para.get_chain()["model_0"][:, :, 0]
        worst = 0.0, 0.0
        for g in range(PZ_G):
            vals = chain[:, g].reshape(-1, PZ_NDIM)
            dm = np.abs(vals.mean(axis=0)).max()
            ds = np.abs(vals.std(axis=0) - 1.0).max()
            assert dm < 0.35 and ds < 0.35, (label, g, dm, ds)
            worst = max(worst[0], dm), max(worst[1], ds)
        rates[f"para_zoo_{label}_steps_per_s"] = steps / dt
        print(f"chain[{leg}]: per group |mean| <= {worst[0]:.4f}, "
              f"|std - 1| <= {worst[1]:.4f}; {steps / dt:.1f} steps/s with "
              f"captures ({card})")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    return _para_launches(total), rates, []


def para_rj_pulse128_leg(torch, card):
    """``para[rj_pulse128 x16]``: config C (``bench.py:225-275``: 10 x 100,
    up to 4 pulse leaves, the 128-point template, group stretch and
    births and deaths) in 16 groups, graphed: ``PR_WARM`` steps of burn-in,
    then ``PR_STEPS`` stored, timed.  Kernels 5 and 3 grouped, two each a
    step; gates per group over the second half: the cold leaf-count mode at
    least 1 and the median pulse centre within 0.3 of 4."""
    import numpy as np

    from eryn_tpu_torch.moves import RedBlueGroupStretchMove
    from eryn_tpu_torch.parallel import ParaEnsembleSampler

    leg = f"para[rj_pulse128 x{PR_G}]"
    ll, pr, fill = _pulse_problem(torch, np, npts=P_NPTS)
    para = ParaEnsembleSampler(
        PR_G, NW, 3, ll, pr, nleaves_max=P_NLMAX, nleaves_min=0,
        moves=RedBlueGroupStretchMove(), rj_moves=True,
        tempering_kwargs=dict(ntemps=NT), fill_zero_leaves_val=fill, seed=3,
        device="cuda")
    coords = pr.rvs(size=(PR_G, NT, NW, P_NLMAX), generator=torch.Generator(
        device="cuda").manual_seed(3), dtype=torch.float32)
    inds = np.random.default_rng(4).random((PR_G, NT, NW, P_NLMAX)) < 0.3
    read = _counting(_kernels())
    para.run_mcmc({"model_0": coords}, 0, burn=PR_WARM,
                  inds={"model_0": inds})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    para.run_mcmc(None, PR_STEPS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    steps = PR_WARM + PR_STEPS
    launches = read()
    replays = _assert_para_replays(leg, para, steps, 2)
    assert launches["group_stretch_propose"] == 2 * steps, launches
    assert launches["pt_swap_cascade_multi"] == 2 * steps, launches
    assert sum(launches.values()) == 4 * steps, launches
    half = slice(PR_STEPS // 2, None)
    inds_c = para.get_inds()["model_0"][half, :, 0]  # (n, G, nw, nl)
    centres = para.get_chain()["model_0"][half, :, 0][..., 1]
    modes, medians = [], []
    for g in range(PR_G):
        counts = np.bincount(inds_c[:, g].sum(-1).ravel(),
                             minlength=P_NLMAX + 1)
        modes.append(int(np.argmax(counts)))
        medians.append(float(np.median(centres[:, g][inds_c[:, g]])))
    print(f"chain[{leg}]: per group cold leaf-count modes {modes}, median "
          f"pulse centres in [{min(medians):.4f}, {max(medians):.4f}]")
    assert min(modes) >= 1, modes
    assert max(abs(m - 4.0) for m in medians) < 0.3, medians
    rates = {"para_rj_pulse128_steps_per_s": PR_STEPS / dt,
             "para_rj_pulse128_group_steps_per_s": PR_G * PR_STEPS / dt}
    print(f"rate: para_rj_pulse128_steps_per_s = "
          f"{rates['para_rj_pulse128_steps_per_s']:.1f}, group steps/s "
          f"{rates['para_rj_pulse128_group_steps_per_s']:.1f} ({card})")
    print(f"launches[{leg}]: {launches} over {steps} steps, {replays} graph "
          f"replays")
    print(f"digest[{leg}]: {_para_digest(para)}")
    return _para_launches(launches), rates, (leg, _ParaBulk(para), None)


def para_groups_running_leg(torch, card):
    """``para[groups_running]``: 8 north-star groups, 50 steps; then 10
    burn and 50 stored steps in one call with groups 1 and 5 stopped: their
    state (``ParaState.group_view``) and their stored chain (log-likelihood
    and coordinates) repeat the frozen snapshot bitwise, and the running
    groups advance; then 20 with every group running, and the stopped ones
    advance again."""
    import numpy as np

    leg = "para[groups_running]"
    G, n, burn = 8, 50, 10
    para, coords = _para_gaussian(torch, G, 21)
    read = _counting(_kernels())
    st1 = para.run_mcmc(coords, n)
    frozen = {k: v.cpu().numpy() for k, v in st1.group_view(
        {"ll": st1.log_like, "x": st1.branches["model_0"].coords,
         "b": st1.betas[:, None]}).items()}
    running = np.ones(G, bool)
    running[[1, 5]] = False
    st2 = para.run_mcmc(None, n, burn=burn, groups_running=running)
    now = {k: v.cpu().numpy() for k, v in st2.group_view(
        {"ll": st2.log_like, "x": st2.branches["model_0"].coords,
         "b": st2.betas[:, None]}).items()}
    assert np.array_equal(st2.groups_running.cpu().numpy(), running)
    for k in now:
        assert np.array_equal(now[k][~running], frozen[k][~running]), k
        assert not np.array_equal(now[k][running], frozen[k][running]), k
    ll = para.get_log_like()
    assert np.array_equal(ll[n:, ~running],
                          np.broadcast_to(frozen["ll"][~running],
                                          ll[n:, ~running].shape))
    x = para.get_chain()["model_0"]
    assert np.array_equal(x[n:, ~running],
                          np.broadcast_to(frozen["x"][~running],
                                          x[n:, ~running].shape))
    st3 = para.run_mcmc(None, 20)
    ll3 = st3.group_view({"ll": st3.log_like})["ll"].cpu().numpy()
    assert not np.array_equal(ll3[~running], frozen["ll"][~running])
    launches = read()
    _assert_stretch_launches(launches, 2 * n + burn + 20)
    print(f"chain[{leg}]: groups 1 and 5 frozen bitwise over {burn} burn "
          f"and {n} stored steps "
          f"(state and stored chain), the other six advanced; all eight "
          f"advance once running again")
    return _para_launches(launches), {}, []


def graph_vs_eager_para(torch, card):
    """``graph-vs-eager[para]``: ``para[north-star x64]`` at a quarter of
    its depth from one seed, ``cuda_graph=False`` and graphed: the chains,
    log-likelihoods, log-priors, ladders and accept and swap fractions equal
    digit for digit; host and wall ms a step side by side."""
    import numpy as np

    leg = f"para[north-star x{PARA_G}]"
    warm, n = PARA_WARM // 4, PARA_STEPS // 4
    runs = {}
    for form in ("eager", "graphed"):
        para, coords = _para_gaussian(torch, PARA_G, 22,
                                      cuda_graph=form == "graphed")
        para.run_mcmc(coords, 0, burn=warm)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        para.run_mcmc(None, n)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        runs[form] = dict(
            wall_ms_per_step=dt / n * 1e3,
            state=dict(chain=para.get_chain()["model_0"],
                       log_like=para.get_log_like(),
                       log_prior=para.get_log_prior(), betas=para.get_betas(),
                       acc=para.acceptance_fraction,
                       swaps=para.swap_acceptance_fraction))
        if form == "graphed":
            _assert_para_replays(leg, para, warm + n, 1)
        else:
            assert para.graph_replays == 0
    a, b = runs["eager"].pop("state"), runs["graphed"].pop("state")
    for key in a:
        assert np.array_equal(a[key], b[key]), f"graph vs eager, {leg}: {key}"
    e, g = runs["eager"], runs["graphed"]
    print(f"graph-vs-eager[{leg}]: {n} stored steps a form, chains, "
          f"log-likelihoods, ladders and accept and swap fractions equal "
          f"digit for digit; wall {e['wall_ms_per_step']:.4f} / "
          f"{g['wall_ms_per_step']:.4f} ms per step (eager / graphed; "
          f"{card})")
    return {leg: runs}


def unit_gaussian_log_like(x):
    """The north-star likelihood at module level, so that a sampler built
    on it pickles."""
    return -0.5 * (x * x).sum()


def pickle_leg(torch, card):
    """``pickle[north-star]``: a graphed north-star segment (200 steps of
    burn-in and 200 stored into the default ``DeviceBackend``), then
    ``pickle.dumps`` and ``loads``: the clone (its graphs captured anew) and
    the original each run 200 more stored steps, equal digit for digit."""
    import pickle

    import numpy as np

    from eryn_tpu_torch import EnsembleSampler, ProbDistContainer, uniform_dist

    leg = "pickle[north-star]"
    priors = ProbDistContainer({i: uniform_dist(-5.0, 5.0)
                                for i in range(NDIM)})
    s = EnsembleSampler(NW, NDIM, unit_gaussian_log_like, priors,
                        tempering_kwargs=dict(ntemps=NT), seed=23,
                        device="cuda")
    coords = priors.rvs(size=(NT, NW), generator=torch.Generator(
        device="cuda").manual_seed(23))
    read = _counting(_kernels())
    s.run_mcmc(coords, 200, burn=200)
    blob = pickle.dumps(s)
    clone = pickle.loads(blob)
    assert clone._graphs is None and clone.pool is None
    captures, replays = clone.graph_captures, clone.graph_replays
    s.run_mcmc(None, 200)
    clone.run_mcmc(None, 200)
    for name, fn in (("chain", lambda x: x.get_chain()["model_0"]),
                     ("log_like", lambda x: x.get_log_like()),
                     ("betas", lambda x: x.get_betas())):
        a, b = fn(s), fn(clone)
        assert a.shape == b.shape and np.array_equal(a, b), f"{leg}: {name}"
    # the clone's first step runs eagerly, its second is captured and
    # replayed
    assert clone.graph_captures == captures + 1
    assert clone.graph_replays == replays + 199
    launches = read()
    _assert_stretch_launches(launches, 800)
    print(f"{leg}: {len(blob)} bytes pickled; the clone's next 200 steps "
          f"equal the original's digit for digit (chain, log-likelihoods, "
          f"ladder), its graph captured anew; timing "
          f"{s.timing.summary()['steps_per_second']:.1f} steps/s over "
          f"{s.timing.segments} segments ({card})")
    return launches, {}, []


# ----------------------------------------------------------------------
# runtime plotting (the run_mcmc plot hook) and the port's examples
# ----------------------------------------------------------------------
PLOT_EVERY, PLOT_SEED = 100, 24
STRETCH_KERNELS = ("stretch_propose", "stretch_accept_propose",
                   "stretch_accept")
CASCADE = ("pt_swap_cascade_multi",)
# the kernels each example launches (basic_gaussian, custom_moves and
# gradient_moves run one temperature: no swap phase; custom_moves and the
# gradient moves have no kernel of their own)
EXAMPLE_KERNELS = {
    "basic_gaussian": STRETCH_KERNELS,
    "custom_moves": (),
    "gradient_moves": STRETCH_KERNELS,
    "multibranch_search": ("group_stretch_propose",) + CASCADE,
    "nonreversible_pt": STRETCH_KERNELS + CASCADE,
    "pt_evidence": STRETCH_KERNELS + CASCADE,
    "rj_pulse_search": ("group_stretch_propose",) + CASCADE,
}


class _PlotProbe:
    """A plot generator that needs no matplotlib: each call reads what
    ``PlotContainer``'s base and tempering groups read (``get_chain``,
    ``get_inds``, ``get_log_like``, ``get_betas``, ``accepted``,
    ``swaps_accepted``, ``iteration``) and records the stored iteration, the
    call's wall time (and each read's) and the bytes its reads brought to
    the host."""

    READS = ("chain", "inds", "log_like", "betas", "counters")

    def __init__(self):
        self.backend = None
        self.iterations, self.ms, self.nbytes, self.split_ms = [], [], [], []

    def generate_plot_info(self, burn=0, thin=1):
        import numpy as np

        b = self.backend
        kw = dict(discard=burn, thin=thin)
        reads = (lambda: [b.get_chain(**kw)["model_0"]],
                 lambda: list(b.get_inds(**kw).values()),
                 lambda: [b.get_log_like(**kw)], lambda: [b.get_betas(**kw)],
                 lambda: [np.asarray(b.accepted),
                          np.asarray(b.swaps_accepted)])
        arrays, split = [], []
        t0 = time.perf_counter()
        it = b.iteration
        for read in reads:
            t1 = time.perf_counter()
            arrays += read()
            split.append(1e3 * (time.perf_counter() - t1))
        self.ms.append(1e3 * (time.perf_counter() - t0))
        self.split_ms.append(split)
        self.iterations.append(it)
        self.nbytes.append(sum(a.nbytes for a in arrays))
        chain = arrays[0]
        assert chain.shape == (it, NT, NW, 1, NDIM), chain.shape
        assert np.all(np.isfinite(chain)) and np.all(np.isfinite(arrays[2]))


def plot_hook_leg(torch, card):
    """``plot_hook[north-star]``: the north-star, 200 warm steps, then 1,200
    stored into the default ``DeviceBackend`` with a plot generator every
    100 stored iterations (``_PlotProbe``), graphed and with
    ``cuda_graph=False``, and graphed without the hook, from one seed.  The
    generator fires at 100, 200, ..., 1,200; the three chains are equal
    digit for digit (the hook touches no generator); every step but the
    first eager one is a replay (the shorter segments replay the same
    graph); the timed stored runs give ``plot_hook_steps_per_s`` beside the
    unhooked rate, and each fire's time and bytes."""
    import numpy as np

    leg = "plot_hook[north-star]"
    read = _counting(_kernels())
    runs = {}
    for label, graphed, hooked in (("graphed", True, True),
                                   ("eager", False, True),
                                   ("unhooked", True, False)):
        s, priors = _gaussian_sampler(torch, NT, NW, PLOT_SEED,
                                      cuda_graph=graphed)
        coords = priors.rvs(size=(NT, NW), generator=torch.Generator(
            device="cuda").manual_seed(PLOT_SEED))
        s.run_mcmc(coords, WARM_STEPS, store=False)
        probe = None
        if hooked:
            probe = _PlotProbe()
            probe.backend = s.backend
            s.plot_generator, s.plot_iterations = probe, PLOT_EVERY
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s.run_mcmc(None, STORED_STEPS)
        torch.cuda.synchronize()
        rate = STORED_STEPS / (time.perf_counter() - t0)
        runs[label] = (s, probe, rate, _chain_record(np, s))
    launches = read()
    steps = WARM_STEPS + STORED_STEPS
    expected = list(range(PLOT_EVERY, STORED_STEPS + 1, PLOT_EVERY))
    for label in ("graphed", "eager"):
        assert runs[label][1].iterations == expected, (
            label, runs[label][1].iterations)
    for label in ("eager", "unhooked"):
        _assert_same_record(np, f"{leg} graphed against {label}",
                            runs["graphed"][3], runs[label][3])
    replays = sum(_assert_replays(leg, runs[k][0], steps, 1)
                  for k in ("graphed", "unhooked"))
    assert runs["eager"][0].graph_replays == 0
    _assert_stretch_launches(launches, 3 * steps)
    assert launches["pt_swap_cascade_multi"] == 3 * steps, launches
    assert sum(launches.values()) == 4 * 3 * steps, launches
    probe, rate = runs["graphed"][1], runs["graphed"][2]
    base = runs["unhooked"][2]
    ms = probe.ms
    print(f"{leg}: the generator fired at {probe.iterations} (graphed and "
          f"cuda_graph=False); the hooked chains equal the unhooked one "
          f"digit for digit over {steps} steps")
    print(f"rate: plot_hook_steps_per_s = {rate:.1f} beside the unhooked "
          f"stored_steps_per_s = {base:.1f} ({rate / base:.4f}); eager "
          f"hooked {runs['eager'][2]:.1f} ({card})")
    print(f"rate: plot_hook_fire_ms first {ms[0]:.3f}, median "
          f"{float(np.median(ms)):.3f}, last {ms[-1]:.3f}, total "
          f"{sum(ms):.3f} over {len(ms)} fires ({card})")
    print(f"rate: plot_hook_fire_bytes first {probe.nbytes[0]}, last "
          f"{probe.nbytes[-1]}, total {sum(probe.nbytes)} copied to the "
          f"host ({card})")
    split = dict(zip(_PlotProbe.READS, (round(x, 3) for x in
                                        probe.split_ms[-1])))
    print(f"rate: plot_hook_last_fire_ms by read {split}; "
          f"{probe.nbytes[-1] / ms[-1] / 1e6:.3f} GB/s ({card})")
    print(f"launches[{leg}]: {launches} over {3 * steps} steps, {replays} "
          f"graph replays")
    rates = {"plot_hook_steps_per_s": rate,
             "plot_hook_unhooked_steps_per_s": base,
             "plot_hook_eager_steps_per_s": runs["eager"][2],
             "plot_hook_fire_ms": [ms[0], float(np.median(ms)), ms[-1]],
             "plot_hook_fire_bytes": probe.nbytes,
             "plot_hook_last_fire_ms_by_read": split}
    return launches, rates, (leg, runs["graphed"][0],
                             runs["graphed"][0]._previous_state)


def examples_leg(torch, card):
    """``examples[<name>]``: each example of ``eryn_tpu_torch/examples``
    that needs no matplotlib, its ``main()`` at full scale on the card (its
    own assertions included), with the launch counters set to 0 just
    before it: the kernels :data:`EXAMPLE_KERNELS` names were launched; the
    host route of ``custom_moves`` reached ``get_proposal`` and its
    in-graph route was captured.  ``runtime_plots`` runs when matplotlib is
    installed."""
    import importlib
    import importlib.util
    import tempfile

    total, rates = {}, {}
    for name, kernels in EXAMPLE_KERNELS.items():
        leg = f"examples[{name}]"
        module = importlib.import_module(f"eryn_tpu_torch.examples.{name}")
        read = _counting(_kernels())
        t0 = time.perf_counter()
        out = module.main()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read()
        for k in kernels:
            assert launches[k] > 0, (leg, k, launches)
        if name == "custom_moves":
            assert out["host_proposals"] > 0, out
            assert out["host_graph_captures"] == 0, out
            assert out["kernel_graph_captures"] == 1, out
            # the warm run and the timed run, one eager step
            assert out["kernel_graph_replays"] == (
                out["steps"] + max(out["steps"] // 4, 4) - 1), out
            rates["custom_moves_host_steps_per_s"] = out["host_steps_per_s"]
            rates["custom_moves_kernel_steps_per_s"] = (
                out["kernel_steps_per_s"])
        if name == "basic_gaussian":
            rates["basic_gaussian_steps_per_s"] = (
                out["timing"]["steps_per_second"])
        rates[f"examples[{name}]_s"] = wall
        rates[f"examples[{name}]_summary"] = out
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        ran = {k: v for k, v in launches.items() if v}
        print(f"{leg}: passed in {wall:.2f} s at full scale; launches {ran} "
              f"({card})")
    if importlib.util.find_spec("matplotlib") is None:
        print("examples[runtime_plots]: not run: matplotlib is not "
              "installed here")
    else:
        from eryn_tpu_torch.examples import runtime_plots

        with tempfile.TemporaryDirectory() as tmp:
            read = _counting(_kernels())
            t0 = time.perf_counter()
            out = runtime_plots.main(outdir=tmp)
            wall = time.perf_counter() - t0
            launches = read()
        assert "pt_gaussian_corner_model_0.png" in out["files"], out
        assert "rj_pulses_leaves_model_0.png" in out["files"], out
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        rates["examples[runtime_plots]_s"] = wall
        print(f"examples[runtime_plots]: {len(out['files'])} files in "
              f"{wall:.2f} s ({card})")
    return total, rates, []


# ----------------------------------------------------------------------
# the device mesh: the north-star over torch.distributed ranks
# ----------------------------------------------------------------------
# mesh[...] legs: the north-star (10 x 100, 5-D), 50 steps of burn-in and
# 200 stored into DeviceBackend (sharded, then 100 more under DEO and the
# Syed ladder); para_mesh[...]: 64 groups over 4 ranks
MESH_SEED, MESH_WARM, MESH_STEPS, MESH_DEO_STEPS = 31, 50, 200, 100
MESH_DEO = dict(swap_scheme="deo", adaptation_scheme="syed")
PM_SEED, PM_WARM, PM_STEPS = 33, 20, 100
MESH_TIMEOUT = 240


def _mesh_record(s):
    """What a mesh leg's chain is held to: the getters' global arrays."""
    return {"chain": s.get_chain()["model_0"], "log_like": s.get_log_like(),
            "log_prior": s.get_log_prior(), "betas": s.get_betas(),
            "acc": s.acceptance_fraction, "swaps": s.swap_acceptance_fraction}


def _mesh_north_star(torch, cuda_graph=True, tempering=None):
    """The mesh legs' sampler (into DeviceBackend) and its global start."""
    from eryn_tpu_torch import DeviceBackend, State

    s, priors = _gaussian_sampler(torch, NT, NW, MESH_SEED,
                                  backend=DeviceBackend(),
                                  cuda_graph=cuda_graph, tempering=tempering)
    coords = priors.rvs(size=(NT, NW), generator=torch.Generator(
        device="cuda").manual_seed(MESH_SEED))
    return s, State({"model_0": coords[:, :, None, :]})


def _comm_check(torch, group):
    """The comm layer's collectives on CUDA tensors over ``group`` (one
    rank: each returns its input); returns the ops checked."""
    from eryn_tpu_torch.parallel import _comm

    x = torch.arange(12.0, device="cuda").reshape(4, 3)
    out = torch.empty_like(x)
    _comm.all_gather_into_tensor(out, x, group=group)
    assert torch.equal(out, x), out
    out = torch.empty_like(x)
    _comm.all_to_all_single(out, x, [4], [4], group=group)
    assert torch.equal(out, x), out
    y = x.clone()
    _comm.all_reduce(y, group=group)
    assert torch.equal(y, x), y
    return ["all_gather_into_tensor", "all_to_all_single", "all_reduce"]


def _mesh_rank(rank, world, temp_parallel):
    """One rank of a mesh leg: the north-star sharded over a ``(temp,
    walker)`` mesh of ``world`` ranks (on one card, every rank's shard on
    ``cuda:0``), the audit of one step first (it leaves the chain as it
    was), then the run, timed; the counts of this process's launches."""
    import torch
    import torch.distributed as dist

    from eryn_tpu_torch.parallel import (
        _comm,
        audit_sampler_comm,
        make_mesh,
        mesh_of_state,
        shard_state,
    )

    read = _counting(_kernels())
    out = {"backend": dist.get_backend(), "device": str(torch.device(
        "cuda", torch.cuda.current_device()))}
    with _plain_versions_forbidden():
        mesh = make_mesh(world, temp_parallel=temp_parallel)
        s, state = _mesh_north_star(torch)
        state = shard_state(state, mesh)
        out["sharded"] = mesh_of_state(state) is not None
        if world == 1:
            out["comm"] = _comm_check(torch, dist.group.WORLD)
        else:
            out["audit"] = audit_sampler_comm(s, state)
            out["shard"] = tuple(state.log_like.shape) if (
                state.log_like is not None) else tuple(
                state.branches["model_0"].coords.shape[:2])
        torch.cuda.synchronize()
        s.timing.reset()  # the audit's step is a segment of its own
        t0 = time.perf_counter()
        s.run_mcmc(state, MESH_STEPS, burn=MESH_WARM)
        torch.cuda.synchronize()
        out["seconds"] = time.perf_counter() - t0
        out["window"] = _window(s, MESH_WARM)
        out["graph_replays"] = s.graph_replays
        out["record"] = _mesh_record(s)
        if world > 1:  # DEO: the edge rungs' point-to-point exchanges
            s, state = _mesh_north_star(torch, tempering=MESH_DEO)
            s.run_mcmc(shard_state(state, mesh), MESH_DEO_STEPS)
            out["deo_record"] = _mesh_record(s)
    out["launches"] = read()
    out["staged"] = dict(_comm.STAGED)
    return out


def _para_mesh_rank(rank, world):
    """One rank of ``para_mesh[...]``: its groups of the 64 over a group
    mesh, graphed (the step makes no collective), timed."""
    import torch

    from eryn_tpu_torch.parallel import _comm, make_group_mesh

    read = _counting(_kernels())
    with _plain_versions_forbidden():
        mesh = make_group_mesh(world)
        para, coords = _para_gaussian(torch, PARA_G, PM_SEED, mesh=mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        para.run_mcmc(coords, PM_STEPS, burn=PM_WARM)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        record = {"chain": para.get_chain()["model_0"],
                  "log_like": para.get_log_like(),
                  "betas": para.get_betas(), "acc": para.acceptance_fraction}
    return {"seconds": seconds, "record": record, "launches": read(),
            "groups": para._g, "graph_replays": para.graph_replays,
            "staged": dict(_comm.STAGED)}


def _same_record(np, leg, got, ref):
    """A leg's chain equals the one-rank chain digit for digit."""
    assert set(got) == set(ref), (leg, set(got), set(ref))
    for key in ref:
        if not np.array_equal(got[key], ref[key], equal_nan=True):
            diff = np.nanmax(np.abs(np.asarray(got[key], dtype=np.float64)
                                    - np.asarray(ref[key], dtype=np.float64)))
            raise AssertionError(
                f"{leg}: {key} differs from the one-rank eager chain "
                f"(max abs {diff})")


def _sum_launches(ranks):
    total = {}
    for r in ranks:
        for k, v in r["launches"].items():
            total[k] = total.get(k, 0) + v
    return total


def _window(s, burn):
    """``[steps, seconds]`` of the stored segments of ``s``'s runs since its
    timer was last reset (``EnsembleSampler.timing``, CUDA events): the
    steps after the first ``burn``, whose segments hold the first eager
    run of each move (and under NCCL the warm-up and the captures)."""
    steps, secs, seen = 0, 0.0, 0
    for n, t in s.timing.durations:
        if seen >= burn:
            steps, secs = steps + n, secs + t
        seen += n
    return [steps, secs]


def _window_rate(ranks, key=None):
    """The slowest rank's steps/s over its stepping window, and the most
    seconds a rank spent before it (set-up, burn-in) beside its run."""
    got = [r if key is None else r[key] for r in ranks]
    sps = min(g["window"][0] / g["window"][1] for g in got)
    setup = max(g["seconds"] - g["window"][1] for g in got)
    return sps, setup


def mesh_legs(torch, card):
    """The device mesh on one card: ``mesh[north-star,1rank,nccl]`` (the
    comm layer and the sampler over NCCL at world size 1, where a state on
    a one-rank mesh runs the one-rank step), ``mesh[north-star,4rank,gloo]``
    (four ranks on ``cuda:0`` over gloo, a ``(2, 2)`` mesh, the sharded
    step) and ``para_mesh[north-star x64,4rank]`` (64 groups over a group
    mesh of four ranks).  Each chain equals the one-rank eager chain of its
    seed digit for digit; kernels 1-3 launch on the card in every rank.  The
    sharded step runs eagerly: gloo's collectives cannot be captured in a
    CUDA graph.  Returns the launches of every rank and of the one-rank
    references, and the legs' rates."""
    import numpy as np

    from eryn_tpu_torch.parallel._spawn import launch

    read = _counting(_kernels())
    ref_s, ref_state = _mesh_north_star(torch, cuda_graph=False)
    ref_s.run_mcmc(ref_state, MESH_STEPS, burn=MESH_WARM)
    ref = _mesh_record(ref_s)
    ref_s, ref_state = _mesh_north_star(torch, cuda_graph=False,
                                        tempering=MESH_DEO)
    ref_s.run_mcmc(ref_state, MESH_DEO_STEPS)
    ref_deo = _mesh_record(ref_s)
    launches = read()
    read = _counting(_kernels())
    pref, pcoords = _para_gaussian(torch, PARA_G, PM_SEED, cuda_graph=False)
    pref.run_mcmc(pcoords, PM_STEPS, burn=PM_WARM)
    pref = {"chain": pref.get_chain()["model_0"],
            "log_like": pref.get_log_like(), "betas": pref.get_betas(),
            "acc": pref.acceptance_fraction}
    launches.update(_para_launches(read()))  # the grouped launches
    steps = MESH_WARM + MESH_STEPS
    rates = {}

    for leg, world, backend, tp in (
            ("mesh[north-star,1rank,nccl]", 1, "nccl", 1),
            ("mesh[north-star,4rank,gloo]", 4, "gloo", 2)):
        t0 = time.perf_counter()
        ranks = launch(_mesh_rank, world, tp, backend=backend,
                       timeout=MESH_TIMEOUT)
        wall = time.perf_counter() - t0
        for r in ranks:
            assert r["backend"] == backend and r["device"] == "cuda:0", r
            assert r["sharded"] == (world > 1), r
            _same_record(np, leg, r["record"], ref)
            if world > 1:
                _same_record(np, f"{leg}, DEO", r["deo_record"], ref_deo)
        got = _sum_launches(ranks)
        # every rank launched kernels 1-3 on the card in every step: the
        # fused trio, sharded as on one rank
        for r in ranks:
            n = r["launches"]
            assert n["pt_swap_cascade_multi"] == steps + (world > 1), n
            # the audited step runs once more; DEO's steps after
            _assert_stretch_launches(n, steps if world == 1 else
                                     steps + 1 + MESH_DEO_STEPS)
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        sps = steps / max(r["seconds"] for r in ranks)
        wsps, setup = _window_rate(ranks)
        rates[f"{leg}_steps_per_s"] = sps
        rates[f"{leg}_window_steps_per_s"] = wsps
        rates[f"{leg}_setup_s"] = setup
        rates[f"{leg}_wall_s"] = wall
        staged = ranks[0]["staged"]
        how = ("eager: gloo's collectives cannot be captured in a CUDA "
               "graph, so the device-planned sharded step runs eagerly"
               if world > 1 else
               f"graphed ({ranks[0]['graph_replays']} replays): a state on a "
               "one-rank mesh runs the one-rank step")
        deo = (f", and {MESH_DEO_STEPS} steps under DEO and the Syed ladder "
               "likewise" if world > 1 else "")
        print(f"{leg}: equals the one-rank eager chain digit for digit "
              f"(chain, log_like, log_prior, betas, acceptance, swaps{deo}); "
              f"{sps:.1f} steps/s over {steps} steps (window "
              f"{wsps:.1f} steps/s over the {MESH_STEPS} stored, set-up and "
              f"burn-in {setup:.2f} s), wall {wall:.1f} s with "
              f"the ranks' start; {how}; staged through host memory: "
              f"{staged or 'none'}; launches {got} ({card})")
        if world == 1:
            print(f"{leg}: NCCL collectives on the card: "
                  f"{ranks[0]['comm']} ({card})")
        else:
            audit = ranks[0]["audit"]
            worst = max(r["audit"]["total_bytes"] for r in ranks)
            rates[f"{leg}_audit_total_bytes"] = worst
            print(f"{leg}: audit per_op {audit['per_op']} (rank 0; shard "
                  f"{ranks[0]['shard']}), total_bytes {worst} at most over "
                  f"the ranks, payload_bytes {audit['payload_bytes']}, "
                  f"full_coords_bytes {audit['full_coords_bytes']}, "
                  f"big_gathers {audit['big_gathers']}")
            assert all(r["audit"]["big_gathers"] == [] for r in ranks)
            assert worst <= 4.0 * audit["payload_bytes"], worst

    leg = f"para_mesh[north-star x{PARA_G},4rank]"
    t0 = time.perf_counter()
    ranks = launch(_para_mesh_rank, 4, backend="gloo", timeout=MESH_TIMEOUT)
    wall = time.perf_counter() - t0
    psteps = PM_WARM + PM_STEPS
    for r in ranks:
        assert r["groups"] == PARA_G // 4, r["groups"]
        _same_record(np, leg, r["record"], pref)
        n = r["launches"]
        assert n["pt_swap_cascade_multi"] == psteps, n
        _assert_stretch_launches(n, psteps)
    got = _sum_launches(ranks)
    for k, v in _para_launches(got).items():
        launches[k] = launches.get(k, 0) + v
    sps = psteps / max(r["seconds"] for r in ranks)
    rates[f"{leg}_steps_per_s"] = sps
    rates[f"{leg}_wall_s"] = wall
    print(f"{leg}: every group equals the one-process eager runner's digit "
          f"for digit (chain, log_like, betas, acceptance); "
          f"{PARA_G // 4} groups a rank, {sps:.1f} steps/s of all the groups "
          f"over {psteps} steps (graphed, {ranks[0]['graph_replays']} "
          f"replays a rank; the step makes no collective), wall {wall:.1f} s "
          f"with the ranks' start; staged through host memory: "
          f"{ranks[0]['staged'] or 'none'}; launches {got} ({card})")
    return launches, rates, []


# mesh[lisa-rj...] and mesh[redblue-zoo...]: the LISA-style RJ configuration
# (10 x 200, 8 leaves; null and 8192-point likelihoods) and the north-star
# with DE, DE-snooker, walk and KDE at 0.25 each, on a (2, 2) mesh of four
# ranks: 20 steps of burn-in and 100 stored into DeviceBackend
MR_WARM, MR_STEPS, MR_ZOO_SEED = 20, 100, 35
MESH_RJ_LEGS = ("lisa-rj-null", "lisa-rj", "redblue-zoo")


def _mesh_rj_sampler(torch, np, leg, cuda_graph=True):
    """A ``mesh[lisa-rj...]`` or ``mesh[redblue-zoo...]`` leg's sampler (into
    DeviceBackend) and its global start, not evaluated."""
    from eryn_tpu_torch import DeviceBackend, EnsembleSampler, State
    from eryn_tpu_torch import moves as tm

    if leg == "redblue-zoo":
        s, priors = _gaussian_sampler(
            torch, NT, NW, MR_ZOO_SEED, backend=DeviceBackend(),
            cuda_graph=cuda_graph,
            moves=[(tm.DEMove(), 0.25), (tm.DESnookerMove(), 0.25),
                   (tm.WalkMove(), 0.25), (tm.KDEMove(), 0.25)])
        coords = priors.rvs(size=(NT, NW), generator=torch.Generator(
            device="cuda").manual_seed(MR_ZOO_SEED))
        return s, State({"model_0": coords[:, :, None, :]})
    ll, pr, fill = _pulse_problem(torch, np, null=leg == "lisa-rj-null")
    s = EnsembleSampler(
        L_NW, 3, ll, pr, nleaves_max=L_NLMAX, nleaves_min=0,
        moves=tm.RedBlueGroupStretchMove(), rj_moves=True,
        tempering_kwargs=dict(ntemps=L_NT), fill_zero_leaves_val=fill,
        seed=3, device="cuda", cuda_graph=cuda_graph,
        backend=DeviceBackend())
    coords = pr.rvs(size=(L_NT, L_NW, L_NLMAX), generator=torch.Generator(
        device="cuda").manual_seed(3), dtype=torch.float32)
    inds = np.random.default_rng(4).random((L_NT, L_NW, L_NLMAX)) < 0.4
    return s, State({"model_0": coords}, inds={
        "model_0": torch.as_tensor(inds, device="cuda")})


def _mesh_rj_record(s):
    """:func:`_mesh_record`, with the masks, the leaf counts and the RJ
    acceptance under reversible jump."""
    out = _mesh_record(s)
    if s.has_reversible_jump:
        out.update(inds=s.get_inds()["model_0"],
                   nleaves=s.get_nleaves()["model_0"],
                   rj_acc=s.rj_acceptance_fraction)
    return out


def _mesh_rj_rank(rank, world):
    """One rank of the ``mesh[lisa-rj...]`` and ``mesh[redblue-zoo...]``
    legs, in turn on one ``(2, 2)`` mesh: each leg's state sharded, its run
    timed, its launches counted (the counters set to 0 just before it), the
    getters' global arrays, and the LISA summary of the heavy leg."""
    import numpy as np
    import torch

    from eryn_tpu_torch.parallel import _comm, make_mesh, shard_state

    out = {}
    with _plain_versions_forbidden():
        mesh = make_mesh(world, temp_parallel=2)
        for leg in MESH_RJ_LEGS:
            s, state = _mesh_rj_sampler(torch, np, leg)
            state = shard_state(state, mesh)
            read = _counting(_kernels())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s.run_mcmc(state, MR_STEPS, burn=MR_WARM)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = read()
            out[leg] = {"seconds": seconds, "launches": launches,
                        "window": _window(s, MR_WARM),
                        "record": _mesh_rj_record(s),
                        "shard": tuple(s._previous_state.log_like.shape),
                        "graph_replays": s.graph_replays}
            if leg == "lisa-rj":
                out[leg]["summary"] = _rj_chain_summary(np, s, MR_STEPS)
    out["staged"] = dict(_comm.STAGED)
    return out


def _first_difference(np, got, ref, steps=MR_STEPS):
    """The first of ``steps`` stored steps at which any getter's array
    differs, the largest absolute difference over the run (NaN in the
    same places is equal) and the getter that differs first; None where
    every array is equal."""
    first, worst, field = None, 0.0, None
    for key in ref:
        a = np.asarray(got[key], dtype=np.float64)
        b = np.asarray(ref[key], dtype=np.float64)
        if np.array_equal(a, b, equal_nan=True):
            continue
        worst = max(worst, float(np.nanmax(np.abs(a - b))))
        field = field or key
        if a.ndim > 1 and a.shape[0] == steps:
            diff = ~((a == b) | (np.isnan(a) & np.isnan(b)))
            step = int(np.flatnonzero(diff.reshape(steps, -1).any(1))[0])
            if first is None or step < first:
                first, field = step, key
    if first is None and worst == 0.0:
        return None
    return first, worst, field


def mesh_rj_legs(torch, card):
    """Reversible jump and the red/blue family on the device mesh:
    ``mesh[lisa-rj-null,4rank,gloo]``, ``mesh[lisa-rj,4rank,gloo]`` and
    ``mesh[redblue-zoo,4rank,gloo]`` on a ``(2, 2)`` mesh of four ranks
    sharing ``cuda:0`` over gloo, 20 + 100 steps each into DeviceBackend.
    The null LISA and the zoo chains equal their one-rank eager chains digit
    for digit; the heavy LISA chain does, or, where the 8192-point
    reduction rounds with the batch's row count, meets the LISA RJ gates
    (leaf-count mode >= 1, pulse centre within 0.3 of 4) with its first
    differing step and largest difference printed.  Each rank launches
    kernel 5 twice a LISA step (its view of its five temperatures) and
    kernel 3 once a tempering phase; no plain version runs.  Returns the
    launches of the ranks and of the references, the ranks' kernel 5
    launches also under ``group_stretch_propose[sharded]``, and the legs'
    rates."""
    import numpy as np

    from eryn_tpu_torch.parallel._spawn import launch

    refs, launches = {}, {}
    for leg in MESH_RJ_LEGS:
        read = _counting(_kernels())
        s, state = _mesh_rj_sampler(torch, np, leg, cuda_graph=False)
        s.run_mcmc(state, MR_STEPS, burn=MR_WARM)
        refs[leg] = _mesh_rj_record(s)
        if leg == "lisa-rj":
            _print_rj_chain(np, f"mesh[{leg}], one-rank eager",
                            _rj_chain_summary(np, s, MR_STEPS))
        for k, v in read().items():
            launches[k] = launches.get(k, 0) + v
    t0 = time.perf_counter()
    ranks = launch(_mesh_rj_rank, 4, backend="gloo", timeout=MESH_TIMEOUT)
    wall = time.perf_counter() - t0
    steps = MR_WARM + MR_STEPS
    rates = {}
    sharded = 0
    for leg in MESH_RJ_LEGS:
        name = f"mesh[{leg},4rank,gloo]"
        drift = None
        for r in ranks:
            got = r[leg]
            assert got["shard"] == (L_NT // 2 if leg != "redblue-zoo"
                                    else NT // 2,
                                    (L_NW if leg != "redblue-zoo"
                                     else NW) // 2), got["shard"]
            assert got["graph_replays"] == 0, got["graph_replays"]
            if leg == "lisa-rj":
                drift = _first_difference(np, got["record"], refs[leg])
                if drift is not None:
                    c = got["summary"]
                    _print_rj_chain(np, f"{name}, rank", c)
                    assert int(np.argmax(c["counts"])) >= 1, c["counts"]
                    assert abs(c["median_b"] - 4.0) < 0.3, c["median_b"]
            else:
                _same_record(np, name, got["record"], refs[leg])
            n = got["launches"]
            rj = leg != "redblue-zoo"
            assert n["pt_swap_cascade_multi"] == (1 + rj) * steps, (name, n)
            assert n["group_stretch_propose"] == 2 * steps * rj, (name, n)
            assert all(n[k] == 0 for k in (
                "stretch_propose", "stretch_accept_propose", "stretch_accept",
                "_cascade_multi_rolled", "onehot_select")), (name, n)
            if rj:
                sharded += n["group_stretch_propose"]
        got = _sum_launches([r[leg] for r in ranks])
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        sps = steps / max(r[leg]["seconds"] for r in ranks)
        wsps, setup = _window_rate(ranks, leg)
        rates[f"{name}_steps_per_s"] = sps
        rates[f"{name}_window_steps_per_s"] = wsps
        rates[f"{name}_setup_s"] = setup
        rates[f"{name}_digit_for_digit"] = drift is None
        if drift is not None:
            rates[f"{name}_first_difference"] = {"step": drift[0],
                                                 "max_abs": drift[1]}
        what = ("chain, masks, leaf counts, log_like, log_prior, betas, "
                "acceptance, RJ acceptance, swaps" if leg != "redblue-zoo"
                else "chain, log_like, log_prior, betas, acceptance, swaps")
        if drift is None:
            verdict = ("equals the one-rank eager chain digit for digit "
                       f"({what})")
        else:
            verdict = (f"differs from the one-rank eager chain from stored "
                       f"step {drift[0]} (largest difference {drift[1]:.6g}) "
                       f"and meets the LISA RJ gates")
        print(f"{name}: {verdict}; {sps:.1f} steps/s over {steps} steps "
              f"(the slowest rank; eager; window {wsps:.1f} steps/s over "
              f"the {MR_STEPS} stored, set-up and burn-in {setup:.2f} s); "
              f"launches {got} ({card})")
    launches["group_stretch_propose[sharded]"] = sharded
    rates["mesh_rj_legs_wall_s"] = wall
    print(f"mesh[lisa-rj...|redblue-zoo,4rank,gloo]: wall {wall:.1f} s with "
          f"the ranks' start; staged through host memory: "
          f"{ranks[0]['staged'] or 'none'} ({card})")
    return launches, rates, []


# mesh[slice|gradient-zoo|mh-zoo|modelswap-mtrj,4rank,gloo]: the rest of the
# move zoo (benchmarks/move_zoo_timing.py:27-166) on a (2, 2) mesh of four
# ranks, 10 steps of burn-in and 40 stored into DeviceBackend each: the
# north-star target for the in-model moves; the model swap of
# tests/test_modelswap.py:153-181 at 4 temperatures (the mesh halves them)
# and the zoo's MT-RJ configuration for the two RJ moves
MZ_WARM, MZ_STEPS, MZ_SEED, MZ_SWAP_NT = 10, 40, 37, 4
MESH_ZOO_LEGS = ("slice", "gradient-zoo", "mh-zoo", "modelswap-mtrj")


def _walk_mh():
    """``MHMove`` with a Gaussian random-walk proposal, a user's subclass
    that declares itself sharded (its normals drawn per walker through
    ``rank_draw``)."""
    import torch

    from eryn_tpu_torch.moves import MHMove

    class WalkMH(MHMove):
        _mesh_sharded = True

        def get_proposal_kernel(self, generator, branch_coords, branch_inds,
                                kernel_state, param_masks=None):
            q = {n: c + 0.3 * self.rank_draw(
                    lambda sh, c=c: torch.randn(sh, generator=generator,
                                                dtype=c.dtype,
                                                device=c.device),
                    c.shape, per_walker=True)
                 for n, c in branch_coords.items()}
            c = next(iter(q.values()))
            return q, c.new_zeros(c.shape[:2]), kernel_state

    return WalkMH()


def _mesh_zoo_samplers(torch, np, leg, cuda_graph=True):
    """A ``mesh[...]`` zoo leg's samplers (into DeviceBackend) and their
    global starts, not evaluated: ``[(chain name, sampler, state)]``."""
    from eryn_tpu_torch import (
        DeviceBackend,
        ProbDistContainer,
        State,
        uniform_dist,
    )
    from eryn_tpu_torch import moves as tm

    def north_star(moves):
        s, priors = _gaussian_sampler(torch, NT, NW, MZ_SEED,
                                      backend=DeviceBackend(),
                                      cuda_graph=cuda_graph, moves=moves)
        coords = priors.rvs(size=(NT, NW), generator=torch.Generator(
            device="cuda").manual_seed(MZ_SEED))
        return s, State({"model_0": coords[:, :, None, :]})

    if leg == "slice":
        return [("SliceMove",) + north_star(tm.SliceMove())]
    if leg == "gradient-zoo":
        return [("MALA|HMC|ChEES",) + north_star(
            [(tm.MALAMove(), 1 / 3), (tm.HMCMove(), 1 / 3),
             (tm.ChEESHMCMove(), 1 / 3)])]
    if leg == "mh-zoo":
        dist = ProbDistContainer({i: uniform_dist(-5.0, 5.0)
                                  for i in range(NDIM)})
        diag = {"model_0": np.diag(np.full(NDIM, 0.5 ** 2))}
        moves = [_walk_mh(), tm.GaussianMove(diag),
                 tm.DistributionGenerate({"model_0": dist}), tm.AIMHMove(),
                 tm.MTDistGenMove({"model_0": dist}, num_try=8,
                                  independent=True),
                 tm.DelayedRejection(tm.GaussianMove(diag), max_iter=2),
                 tm.CombineMove([tm.GaussianMove(diag),
                                 tm.DistributionGenerate({"model_0": dist})])]
        return [("MH family",) + north_star([(m, 1 / 7) for m in moves])]
    out = []
    s, state = _mt_rj_sampler(torch, cuda_graph=cuda_graph, setup=False,
                              backend=DeviceBackend())
    out.append(("MTDistGenMoveRJ x8", s, state))
    s, state = _modelswap_sampler(torch, np, MZ_SWAP_NT, cuda_graph=cuda_graph,
                                  backend=DeviceBackend())
    out.append(("ModelSwapRJMove", s, state))
    return out


def _mesh_zoo_record(s):
    """Every getter's global array a zoo leg's chain is held to, per branch,
    and its moves' device counters."""
    from eryn_tpu_torch.ensemble import _walk_moves

    out = {"log_like": s.get_log_like(), "log_prior": s.get_log_prior(),
           "betas": s.get_betas(), "acc": s.acceptance_fraction,
           "swaps": s.swap_acceptance_fraction}
    for n in s.branch_names:
        out[f"chain[{n}]"] = s.get_chain()[n]
        if s.has_reversible_jump:
            out[f"inds[{n}]"] = s.get_inds()[n]
    if s.has_reversible_jump:
        out["rj_acc"] = s.rj_acceptance_fraction
    for j, m in enumerate(_walk_moves(s._all_move_list)):
        for c in ("loop_iterations", "leapfrog_total"):
            if getattr(m, c, None) is not None:
                out[f"{c}[{j}]"] = getattr(m, c).cpu().numpy()
    return out


def _mesh_zoo_rank(rank, world):
    """One rank of the ``mesh[...]`` zoo legs, in turn on one ``(2, 2)``
    mesh: each chain's state sharded, its run timed, its launches counted
    (the counters set to 0 just before it), the getters' global arrays and
    the wall-clock ends of the legs."""
    import numpy as np
    import torch

    from eryn_tpu_torch.parallel import _comm, make_mesh, shard_state

    out = {}
    with _plain_versions_forbidden():
        mesh = make_mesh(world, temp_parallel=2)
        for leg in MESH_ZOO_LEGS:
            got = out[leg] = {"chains": {}, "seconds": 0.0, "launches": {},
                              "window": [0, 0.0]}
            for name, s, state in _mesh_zoo_samplers(torch, np, leg):
                state = shard_state(state, mesh)
                read = _counting(_kernels())
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                s.run_mcmc(state, MZ_STEPS, burn=MZ_WARM)
                torch.cuda.synchronize()
                got["seconds"] += time.perf_counter() - t0
                got["window"] = [a + b for a, b in zip(
                    got["window"], _window(s, MZ_WARM))]
                for k, v in read().items():
                    got["launches"][k] = got["launches"].get(k, 0) + v
                got["chains"][name] = {
                    "record": _mesh_zoo_record(s),
                    "shard": tuple(s._previous_state.log_like.shape),
                    "graph_replays": s.graph_replays}
            got["end"] = time.time()
    out["staged"] = dict(_comm.STAGED)
    return out


def _zoo_gates(np, name, s_record, mean=0.0, var=1.0):
    """The statistical gates a zoo chain meets where it drifts from the
    one-rank chain: the target's cold moments (``mean`` and ``var`` per
    dimension; the unit Gaussian's by default) and the acceptance in (0,
    1), or under reversible jump finite log-likelihoods and leaf counts in
    range (one candidate active in every model-swap sample)."""
    rec = s_record
    assert np.all(np.isfinite(rec["log_like"])), name
    acc = np.asarray(rec["acc"])[0].mean()
    assert 0 < acc <= 1, (name, acc)
    if "chain[model_0]" in rec and "inds[model_0]" not in rec:
        cold = rec["chain[model_0]"][:, 0].reshape(-1, NDIM)
        assert np.all(np.abs(cold.mean(axis=0) - mean) < 0.3), (
            name, cold.mean(axis=0))
        assert np.all(np.abs(cold.var(axis=0) - var) < 0.5), (
            name, cold.var(axis=0))
    elif "inds[pulse]" in rec:
        one = rec["inds[pulse]"].sum(-1) + rec["inds[const]"].sum(-1)
        assert np.all(one == 1), name
    else:
        nl = rec["inds[model_0]"].sum(-1)
        assert np.all((nl >= 0) & (nl <= Z_NLMAX)), name


def mesh_zoo_legs(torch, card):
    """The rest of the move zoo on the device mesh:
    ``mesh[slice,4rank,gloo]`` (``SliceMove()``),
    ``mesh[gradient-zoo,4rank,gloo]`` (MALA, HMC and ChEES-HMC at 1/3 each,
    tuning on), ``mesh[mh-zoo,4rank,gloo]`` (a user's ``MHMove``,
    ``GaussianMove``, ``DistributionGenerate``, ``AIMHMove``,
    ``MTDistGenMove``, ``DelayedRejection`` and a ``CombineMove`` of two,
    at 1/7 each) and ``mesh[modelswap-mtrj,4rank,gloo]`` (the model swap
    and the zoo's multiple-try reversible jump), on a ``(2, 2)`` mesh of
    four ranks sharing ``cuda:0`` over gloo, 10 + 40 steps each into
    DeviceBackend.  Each chain equals its one-rank eager chain digit for
    digit or, where it drifts on the card, prints its first differing
    stored step and field and meets the zoo's statistical gates.  Each rank
    launches kernel 3 once a tempering phase, as the one-rank chain does,
    and kernel 5 twice an MT-RJ step (the group stretch's halves); no
    plain version runs.  Returns the launches of the ranks and of the
    references, the ranks' kernel 5 launches also under
    ``group_stretch_propose[sharded mt-rj]`` (the shape the kernel phase
    holds against the plain version), and the legs' rates."""
    import numpy as np

    from eryn_tpu_torch.parallel._spawn import launch

    refs, ref_launches, launches = {}, {}, {}
    for leg in MESH_ZOO_LEGS:
        read = _counting(_kernels())
        for name, s, state in _mesh_zoo_samplers(torch, np, leg,
                                                 cuda_graph=False):
            s.run_mcmc(state, MZ_STEPS, burn=MZ_WARM)
            refs[leg, name] = _mesh_zoo_record(s)
        ref_launches[leg] = read()
        for k, v in ref_launches[leg].items():
            launches[k] = launches.get(k, 0) + v
    t0 = time.time()
    ranks = launch(_mesh_zoo_rank, 4, backend="gloo", timeout=MESH_TIMEOUT)
    wall = time.time() - t0
    steps = MZ_WARM + MZ_STEPS
    rates, sharded, last = {}, 0, t0
    for leg in MESH_ZOO_LEGS:
        name = f"mesh[{leg},4rank,gloo]"
        verdicts = []
        for chain in ranks[0][leg]["chains"]:
            drift = None
            for r in ranks:
                got = r[leg]["chains"][chain]
                assert got["graph_replays"] == 0, got["graph_replays"]
                assert got["shard"][0] * 2 in (NT, MZ_SWAP_NT), got["shard"]
                ref = refs[leg, chain]
                if any(not np.array_equal(got["record"][k], ref[k],
                                          equal_nan=True) for k in ref):
                    drift = drift or _first_difference(
                        np, got["record"], ref, steps=MZ_STEPS)
                    _zoo_gates(np, f"{name} {chain}", got["record"])
            if drift is None:
                verdicts.append(f"{chain}: equals the one-rank eager chain "
                                "digit for digit")
            else:
                verdicts.append(
                    f"{chain}: differs from the one-rank eager chain from "
                    f"stored step {drift[0]} (largest difference "
                    f"{drift[1]:.6g}) and meets the zoo's gates")
                rates[f"{name}_first_difference[{chain}]"] = {
                    "step": drift[0], "max_abs": drift[1]}
            rates[f"{name}_digit_for_digit[{chain}]"] = drift is None
        for r in ranks:
            n = r[leg]["launches"]
            # one cascade launch a tempering phase, as on one rank
            assert n["pt_swap_cascade_multi"] == ref_launches[leg][
                "pt_swap_cascade_multi"], (name, n, ref_launches[leg])
            assert n["group_stretch_propose"] == ref_launches[leg][
                "group_stretch_propose"], (name, n)
            assert all(n[k] == 0 for k in (
                "stretch_propose", "stretch_accept_propose", "stretch_accept",
                "_cascade_multi_rolled", "onehot_select")), (name, n)
            sharded += n["group_stretch_propose"]
        got = _sum_launches([r[leg] for r in ranks])
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        nchains = len(ranks[0][leg]["chains"])
        sps = nchains * steps / max(r[leg]["seconds"] for r in ranks)
        wsps, setup = _window_rate(ranks, leg)
        end = max(r[leg]["end"] for r in ranks)
        rates[f"{name}_steps_per_s"] = sps
        rates[f"{name}_window_steps_per_s"] = wsps
        rates[f"{name}_setup_s"] = setup
        rates[f"{name}_wall_s"] = end - last
        start = "the ranks' start and " if last == t0 else ""
        print(f"{name}: {'; '.join(verdicts)}; {sps:.1f} steps/s over "
              f"{nchains} x {steps} steps (the slowest rank; eager; window "
              f"{wsps:.1f} steps/s over the stored steps, set-up and "
              f"burn-in {setup:.2f} s), wall "
              f"{end - last:.1f} s with {start}the set-up; kernel 3 "
              f"launches by the ranks {got['pt_swap_cascade_multi']}; "
              f"launches {got} ({card})")
        last = end
    launches["group_stretch_propose[sharded mt-rj]"] = sharded
    rates["mesh_zoo_legs_wall_s"] = wall
    print(f"mesh[slice|gradient-zoo|mh-zoo|modelswap-mtrj,4rank,gloo]: wall "
          f"{wall:.1f} s with the ranks' start; staged through host memory: "
          f"{ranks[0]['staged'] or 'none'} ({card})")
    return launches, rates, []


# mesh[general-cascade|general-stretch|blobs|host|resume-hooks,4rank,gloo]:
# the rest of the sampler's surface on a (2, 2) mesh of four ranks, 10 steps
# of burn-in and 40 stored each (the north-star at 10 x 100, 5-D); the
# resume leg stops at 25 stored steps (stopping checked every 5, the plot
# probe every 10, AdjustStretchProposalScale every 10 steps) and a fresh
# sampler continues its Backend() to 40
MS_WARM, MS_STEPS, MS_SEED = 10, 40, 41
MS_STOP, MS_STOP_EVERY, MS_PLOT_EVERY, MS_UPDATE_EVERY = 25, 5, 10, 10
MS_PERIOD = 10.0
MESH_SURFACE_LEGS = ("general-cascade", "general-stretch", "blobs", "host",
                     "resume-hooks")


class _StopAt:
    """``AutoCorrelationStop``, or ``MS_STOP`` stored steps: it reads the
    getters at every check."""

    def __init__(self):
        from eryn_tpu_torch.utils import AutoCorrelationStop

        self.auto = AutoCorrelationStop()
        self.calls = []

    def __call__(self, i, state, sampler):
        auto = self.auto(i, state, sampler)
        self.calls.append(sampler.backend.iteration)
        return auto or sampler.backend.iteration >= MS_STOP


def _mesh_surface_sampler(torch, leg, cuda_graph=True, backend=None):
    """A surface leg's sampler (cuda_graph as given) and its global start,
    not evaluated."""
    import warnings

    import scipy.stats

    from eryn_tpu_torch import (
        Backend,
        DeviceBackend,
        EnsembleSampler,
        ProbDistContainer,
        State,
        uniform_dist,
    )
    from eryn_tpu_torch import moves as tm
    from eryn_tpu_torch.utils import AdjustStretchProposalScale

    gen = torch.Generator(device="cuda").manual_seed(MS_SEED)
    if leg == "blobs":
        return _blob_sampler(torch, seed=MS_SEED, cuda_graph=cuda_graph,
                             host_object=True)
    if leg == "general-stretch":
        priors = ProbDistContainer(
            {i: uniform_dist(0.0, MS_PERIOD) if i == 0
             else uniform_dist(-5.0, 5.0) for i in range(NDIM)})

        def log_like(x):
            return -0.5 * torch.sum(x * x)

        s = EnsembleSampler(
            NW, NDIM, log_like, priors, tempering_kwargs=dict(ntemps=NT),
            moves=tm.StretchMove(periodic={"model_0": {0: MS_PERIOD}},
                                 nsplits=4),
            seed=MS_SEED, device="cuda", backend=DeviceBackend(),
            cuda_graph=cuda_graph)
        coords = priors.rvs(size=(NT, NW), generator=gen)
        return s, State({"model_0": coords[:, :, None, :]})
    if leg == "host":
        priors = ProbDistContainer({i: scipy.stats.uniform(-5.0, 10.0)
                                    for i in range(NDIM)})
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the host side's warnings
            s = EnsembleSampler(
                NW, NDIM, host_log_like, priors,
                tempering_kwargs=dict(ntemps=NT),
                moves=[(tm.StretchMove(), 0.9), (_host_mh_class()(), 0.1)],
                seed=MS_SEED, device="cuda", backend=DeviceBackend(),
                cuda_graph=cuda_graph)
        coords = ProbDistContainer({i: uniform_dist(-5.0, 5.0)
                                    for i in range(NDIM)}).rvs(
            size=(NT, NW), generator=gen)
        return s, State({"model_0": coords[:, :, None, :]})
    if leg == "general-cascade":
        kw = dict(tempering=dict(permute=False), backend=DeviceBackend())
    else:  # resume-hooks
        kw = dict(backend=backend or Backend(),
                  update_fn=AdjustStretchProposalScale(),
                  update_iterations=MS_UPDATE_EVERY)
        if backend is None:  # the first sampler stops at MS_STOP
            kw.update(stopping_fn=_StopAt(),
                      stopping_iterations=MS_STOP_EVERY)
    s, priors = _gaussian_sampler(torch, NT, NW, MS_SEED,
                                  cuda_graph=cuda_graph, **kw)
    if leg == "resume-hooks":
        probe = _PlotProbe()
        probe.backend = s.backend
        s.plot_generator, s.plot_iterations = probe, MS_PLOT_EVERY
    coords = priors.rvs(size=(NT, NW), generator=gen)
    return s, State({"model_0": coords[:, :, None, :]})


def _mesh_surface_moments(np, leg):
    """The cold chain's mean and variance per dimension of a surface leg's
    target: the unit Gaussian, the periodic dimension of
    ``general-stretch`` a half-normal (the Gaussian on ``[0, MS_PERIOD)``)."""
    mean, var = np.zeros(NDIM), np.ones(NDIM)
    if leg == "general-stretch":
        mean[0], var[0] = np.sqrt(2.0 / np.pi), 1.0 - 2.0 / np.pi
    return mean, var


def _mesh_surface_gates(np, name, leg, got, ref_host):
    """What a surface leg's chain meets where it drifts from the one-rank
    chain: the zoo's gates on the leg's target (:func:`_zoo_gates`,
    :func:`_mesh_surface_moments`), every stored ``blob[0]`` ``-2
    log_like`` and ``blob[1]`` the chain's first parameter, and the host
    objects a permutation of the one-rank chain's (they follow their
    walkers through other swaps)."""
    rec = got["record"]
    _zoo_gates(np, name, rec, *_mesh_surface_moments(np, leg))
    if "blobs" in rec:
        np.testing.assert_allclose(
            rec["blobs"][..., 0], -2.0 * rec["log_like"],
            rtol=float(np.finfo(np.float32).eps), atol=0, err_msg=name)
        assert np.array_equal(rec["blobs"][..., 1],
                              rec["chain[model_0]"][:, :, :, 0, 0]), name
    assert set(got["host"]) == set(ref_host), name
    for k, objs in got["host"].items():
        assert sorted(objs) == sorted(ref_host[k]), (name, k)


def _mesh_surface_run(torch, np, leg, mesh=None, cuda_graph=True):
    """A surface leg's chain, sharded over ``mesh`` where given; the
    resume leg stops and is continued by a fresh sampler on its backend.
    Returns the sampler that ends the chain and what it is held to."""
    import warnings

    from eryn_tpu_torch.parallel import shard_state

    def place(st):
        return st if mesh is None else shard_state(st, mesh)

    s, state = _mesh_surface_sampler(torch, leg, cuda_graph)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        s.run_mcmc(place(state), MS_STEPS, burn=MS_WARM)
    window = _window(s, MS_WARM)
    extra = {}
    if leg == "resume-hooks":
        stopped = s.backend.iteration
        first = s
        s, _ = _mesh_surface_sampler(torch, leg, cuda_graph,
                                     backend=s.backend)
        s.run_mcmc(place(s.get_last_sample()), MS_STEPS - stopped)
        window = [a + b for a, b in zip(window, _window(s, 0))]
        extra = {"stopped": np.asarray([stopped]),
                 "stop_checks": np.asarray(first.stopping_fn.calls),
                 "plots": np.asarray(first.plot_generator.iterations
                                     + s.plot_generator.iterations),
                 "a": np.asarray([first.moves[0].a, s.moves[0].a])}
    record = _mesh_zoo_record(s)
    record.update(extra)
    blobs = s.get_blobs()
    if blobs is not None:
        record["blobs"] = blobs
    supp = s._previous_state.supplemental
    host = {} if supp is None else supp.host_holder
    return s, record, {k: [str(x) for x in v.ravel()]
                       for k, v in host.items()}, window


def _mesh_surface_rank(rank, world):
    """One rank of the surface legs, in turn on one ``(2, 2)`` mesh: each
    chain's run timed and its launches counted (the counters set to 0 just
    before it), the getters' global arrays, the host objects' order and the
    wall-clock ends of the legs."""
    import numpy as np
    import torch

    from eryn_tpu_torch.parallel import _comm, make_mesh

    out = {}
    with _plain_versions_forbidden():
        mesh = make_mesh(world, temp_parallel=2)
        for leg in MESH_SURFACE_LEGS:
            read = _counting(_kernels())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s, record, host, window = _mesh_surface_run(torch, np, leg, mesh)
            torch.cuda.synchronize()
            out[leg] = {"seconds": time.perf_counter() - t0,
                        "window": window,
                        "launches": read(), "record": record, "host": host,
                        "shard": tuple(s._previous_state.log_like.shape),
                        "graph_replays": s.graph_replays,
                        "end": time.time()}
    out["staged"] = dict(_comm.STAGED)
    return out


def mesh_surface_legs(torch, card):
    """The rest of the sampler's surface on the device mesh, on a ``(2,
    2)`` mesh of four ranks sharing ``cuda:0`` over gloo, 10 + 40 steps of
    the north-star each: ``mesh[general-cascade,4rank,gloo]`` (the general
    swap cascade, ``permute=False``), ``mesh[general-stretch,4rank,gloo]``
    (``StretchMove``'s general path: a periodic dimension and four
    splits), ``mesh[blobs,4rank,gloo]`` (``blobs[north-star]``'s likelihood,
    a branch supplemental, an int64 tag and a host object a walker),
    ``mesh[host,4rank,gloo]`` (a NumPy likelihood, SciPy priors and a
    legacy host ``MHMove`` at 0.1 beside the stretch move) and
    ``mesh[resume-hooks,4rank,gloo]`` (``AdjustStretchProposalScale``,
    ``AutoCorrelationStop`` and a plot generator, stopped at 25 stored steps
    and continued by a fresh sampler from its ``Backend()``: the card's
    machine has no h5py).  Each chain equals its one-rank eager chain digit
    for digit or prints its first differing stored step and field; each
    rank launches the cascade (kernel 3), the group stretch and the
    selection (kernel 5) and the fused stretch trio (kernels 1 and 2) as
    often as the one-rank chain; no plain version runs.  Returns the launches of the ranks and the references, and the
    legs' rates."""
    import numpy as np

    from eryn_tpu_torch.parallel._spawn import launch

    refs, ref_launches, launches = {}, {}, {}
    for leg in MESH_SURFACE_LEGS:
        read = _counting(_kernels())
        _, record, host, _ = _mesh_surface_run(torch, np, leg,
                                               cuda_graph=False)
        refs[leg] = (record, host)
        ref_launches[leg] = read()
        for k, v in ref_launches[leg].items():
            launches[k] = launches.get(k, 0) + v
    t0 = time.time()
    ranks = launch(_mesh_surface_rank, 4, backend="gloo",
                   timeout=MESH_TIMEOUT)
    wall = time.time() - t0
    rates, last = {}, t0
    for leg in MESH_SURFACE_LEGS:
        name = f"mesh[{leg},4rank,gloo]"
        ref, ref_host = refs[leg]
        drift = None
        for i, r in enumerate(ranks):
            got = r[leg]
            assert got["graph_replays"] == 0, got["graph_replays"]
            assert got["shard"] == (NT // 2, NW // 2), got["shard"]
            first = _first_difference(np, got["record"], ref, steps=MS_STEPS)
            if first is None:
                # the same swaps reorder the host objects alike
                assert got["host"] == ref_host, (
                    name, i, "the chain equals the one-rank chain, the host "
                    "objects' order does not")
            else:
                _mesh_surface_gates(np, f"{name} rank {i}", leg, got,
                                    ref_host)
            drift = drift or first
            n, m = got["launches"], ref_launches[leg]
            for k in ("pt_swap_cascade_multi", "_cascade_multi_rolled",
                      "group_stretch_propose", "onehot_select"):
                assert n[k] == m[k], (name, k, n, m)
            # the fused trio, sharded as on one rank
            for k in ("stretch_propose", "stretch_accept_propose",
                      "stretch_accept"):
                assert n[k] == m[k], (name, k, n, m)
        if drift is None:
            verdict = "equals the one-rank eager chain digit for digit"
        else:
            verdict = (f"differs from the one-rank eager chain from stored "
                       f"step {drift[0]} in {drift[2]} (largest difference "
                       f"{drift[1]:.6g})")
            rates[f"{name}_first_difference"] = {
                "step": drift[0], "field": drift[2], "max_abs": drift[1]}
        rates[f"{name}_digit_for_digit"] = drift is None
        got = _sum_launches([r[leg] for r in ranks])
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        steps = MS_WARM + MS_STEPS
        sps = steps / max(r[leg]["seconds"] for r in ranks)
        wsps, setup = _window_rate(ranks, leg)
        end = max(r[leg]["end"] for r in ranks)
        rates[f"{name}_steps_per_s"] = sps
        rates[f"{name}_window_steps_per_s"] = wsps
        rates[f"{name}_setup_s"] = setup
        rates[f"{name}_wall_s"] = end - last
        start = "the ranks' start and " if last == t0 else ""
        note = ""
        if leg == "resume-hooks":
            rec = ref
            note = (f"; stopped at {int(rec['stopped'][0])} stored steps "
                    f"(checks at {rec['stop_checks'].tolist()}), plots at "
                    f"{rec['plots'].tolist()}, stretch scale "
                    f"{rec['a'].tolist()}; continued from its Backend(), "
                    "not an HDF5 file: this machine has no h5py"
                    if not _have_h5py() else
                    f"; stopped at {int(rec['stopped'][0])} stored steps, "
                    "continued from its Backend()")
        print(f"{name}: {verdict}; {sps:.1f} steps/s over {steps} steps "
              f"(the slowest rank; eager; window {wsps:.1f} steps/s over "
              f"the stored steps, set-up and burn-in {setup:.2f} s), wall "
              f"{end - last:.1f} s with "
              f"{start}the set-up; launches by the ranks {got}, by the "
              f"one-rank chain {ref_launches[leg]}{note} ({card})")
        last = end
    rates["mesh_surface_legs_wall_s"] = wall
    print(f"mesh[general-cascade|general-stretch|blobs|host|resume-hooks,"
          f"4rank,gloo]: wall {wall:.1f} s with the ranks' start; staged "
          f"through host memory: {ranks[0]['staged'] or 'none'} ({card})")
    return launches, rates, []


# mesh[custom-mh|custom-stretch|custom-combine|custom-rj,4rank,gloo]: users'
# own move subclasses, none declaring itself sharded, on a (2, 2) mesh of
# four ranks, 10 steps of burn-in and 40 stored each into DeviceBackend (the
# north-star at 10 x 100, 5-D; config C for the RJ leg)
MC_WARM, MC_STEPS, MC_SEED = 10, 40, 43
MESH_CUSTOM_LEGS = ("custom-mh", "custom-stretch", "custom-combine",
                    "custom-rj")


def _custom_classes():
    """The users' classes of the custom legs: the custom-moves example's
    ``KernelJumpMove`` (``eryn_tpu_torch/examples/custom_moves.py``), and
    bare subclasses of ``StretchMove``, ``GaussianMove`` and
    ``DistributionGenerateRJ``."""
    from eryn_tpu_torch import moves as tm
    from eryn_tpu_torch.examples.custom_moves import KernelJumpMove

    class MyStretch(tm.StretchMove):
        pass

    class MyGauss(tm.GaussianMove):
        pass

    class MyBirthDeath(tm.DistributionGenerateRJ):
        pass

    return KernelJumpMove, MyStretch, MyGauss, MyBirthDeath


def _mesh_custom_sampler(torch, np, leg, cuda_graph=True):
    """A custom leg's sampler (into DeviceBackend) and its global start, not
    evaluated."""
    from eryn_tpu_torch import DeviceBackend, EnsembleSampler, State
    from eryn_tpu_torch import moves as tm

    jump, stretch, gauss, birth_death = _custom_classes()
    if leg == "custom-rj":
        ll, pr, fill = _pulse_problem(torch, np, npts=P_NPTS)
        s = EnsembleSampler(
            NW, 3, ll, pr, nleaves_max=P_NLMAX, nleaves_min=0,
            moves=tm.RedBlueGroupStretchMove(),
            rj_moves=[birth_death(pr, nleaves_max={"model_0": P_NLMAX},
                                  nleaves_min={"model_0": 0})],
            tempering_kwargs=dict(ntemps=NT), fill_zero_leaves_val=fill,
            seed=3, device="cuda", cuda_graph=cuda_graph,
            backend=DeviceBackend())
        coords = pr.rvs(size=(NT, NW, P_NLMAX), generator=torch.Generator(
            device="cuda").manual_seed(3), dtype=torch.float32)
        inds = np.random.default_rng(4).random((NT, NW, P_NLMAX)) < 0.3
        return s, State({"model_0": coords}, inds={
            "model_0": torch.as_tensor(inds, device="cuda")})
    diag = {"model_0": np.diag(np.full(NDIM, 0.5 ** 2))}
    moves = {
        "custom-mh": jump,
        "custom-stretch": stretch,
        "custom-combine": lambda: [
            (tm.CombineMove([jump(), tm.StretchMove()]), 0.8),
            (tm.DelayedRejection(gauss(diag), max_iter=2), 0.2)],
    }[leg]()
    s, priors = _gaussian_sampler(torch, NT, NW, MC_SEED,
                                  backend=DeviceBackend(),
                                  cuda_graph=cuda_graph, moves=moves)
    coords = priors.rvs(size=(NT, NW), generator=torch.Generator(
        device="cuda").manual_seed(MC_SEED))
    return s, State({"model_0": coords[:, :, None, :]})


def _mesh_custom_rank(rank, world):
    """One rank of the custom legs, in turn on one ``(2, 2)`` mesh: each
    chain's state sharded, its run timed, its launches counted (the counters
    set to 0 just before it), the getters' global arrays, the moves' routes
    and the wall-clock ends of the legs."""
    import numpy as np
    import torch

    from eryn_tpu_torch.ensemble import _walk_moves
    from eryn_tpu_torch.parallel import _comm, make_mesh, shard_state

    out = {}
    with _plain_versions_forbidden():
        mesh = make_mesh(world, temp_parallel=2)
        for leg in MESH_CUSTOM_LEGS:
            s, state = _mesh_custom_sampler(torch, np, leg)
            state = shard_state(state, mesh)
            read = _counting(_kernels())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s.run_mcmc(state, MC_STEPS, burn=MC_WARM)
            torch.cuda.synchronize()
            out[leg] = {"seconds": time.perf_counter() - t0,
                        "window": _window(s, MC_WARM),
                        "launches": read(), "record": _mesh_zoo_record(s),
                        "routes": [
                            f"{type(x).__name__}: {x.mesh_route()}"
                            for m in _walk_moves(s._all_move_list)
                            for x in (m, getattr(m, "proposal", None))
                            if x is not None],
                        "shard": tuple(s._previous_state.log_like.shape),
                        "graph_replays": s.graph_replays, "end": time.time()}
    out["staged"] = dict(_comm.STAGED)
    return out


def _kernel_work(n):
    """Launches of kernels 1, 2, 3 and 5 in ``n`` (a launch counter's
    reading): the fused stretch launch counts for both 1 and 2, the rolled
    cascade for 3 and the selection alone for 5."""
    return {"1": n["stretch_propose"] + n["stretch_accept_propose"],
            "2": n["stretch_accept"] + n["stretch_accept_propose"],
            "3": n["pt_swap_cascade_multi"] + n["_cascade_multi_rolled"],
            "5": n["group_stretch_propose"] + n["onehot_select"]}


def mesh_custom_legs(torch, card):
    """Users' own move subclasses on the device mesh, none declaring itself
    sharded, on a ``(2, 2)`` mesh of four ranks sharing ``cuda:0`` over
    gloo, 10 + 40 steps each into DeviceBackend:
    ``mesh[custom-mh,4rank,gloo]`` (the custom-moves example's
    ``KernelJumpMove``: its proposal on the gathered coordinates, the
    likelihood on the rank's rows), ``mesh[custom-stretch,4rank,gloo]`` (a
    bare ``StretchMove`` subclass, whole in every rank),
    ``mesh[custom-combine,4rank,gloo]``
    (``CombineMove([KernelJumpMove(), StretchMove()])`` at 0.8 and
    ``DelayedRejection`` around a bare ``GaussianMove`` subclass at 0.2) and
    ``mesh[custom-rj,4rank,gloo]`` (config C, a bare
    ``DistributionGenerateRJ`` subclass beside ``RedBlueGroupStretchMove``).
    Each chain must equal its one-rank eager chain digit for digit: a
    difference prints its first differing stored step and field and fails
    the script.  Each rank launches kernels 1, 2, 3 and 5 as often as that
    chain (the fused stretch launch counted as both 1 and 2); no plain
    version runs.  Returns the launches of the ranks and the references,
    the ranks' kernel 5 launches also under ``group_stretch_propose[sharded
    config-c]`` (the shape the kernel phase holds against the plain
    version), and the legs' rates."""
    import numpy as np

    from eryn_tpu_torch.parallel._spawn import launch

    refs, ref_launches, launches = {}, {}, {}
    for leg in MESH_CUSTOM_LEGS:
        read = _counting(_kernels())
        s, state = _mesh_custom_sampler(torch, np, leg, cuda_graph=False)
        s.run_mcmc(state, MC_STEPS, burn=MC_WARM)
        refs[leg] = _mesh_zoo_record(s)
        ref_launches[leg] = read()
        for k, v in ref_launches[leg].items():
            launches[k] = launches.get(k, 0) + v
    t0 = time.time()
    ranks = launch(_mesh_custom_rank, 4, backend="gloo",
                   timeout=MESH_TIMEOUT)
    wall = time.time() - t0
    steps = MC_WARM + MC_STEPS
    rates, last, sharded, drifts = {}, t0, 0, []
    for leg in MESH_CUSTOM_LEGS:
        name = f"mesh[{leg},4rank,gloo]"
        ref = refs[leg]
        drift = None
        for i, r in enumerate(ranks):
            got = r[leg]
            assert got["graph_replays"] == 0, got["graph_replays"]
            assert got["shard"] == (NT // 2, NW // 2), got["shard"]
            first = _first_difference(np, got["record"], ref, steps=MC_STEPS)
            if first is not None:
                print(f"{name}: rank {i} differs from the one-rank eager "
                      f"chain from stored step {first[0]} in {first[2]} "
                      f"(largest difference {first[1]:.6g}) ({card})")
            drift = drift or first
            work, ref_work = (_kernel_work(got["launches"]),
                              _kernel_work(ref_launches[leg]))
            assert work == ref_work, (name, i, work, ref_work)
            if leg == "custom-rj":
                sharded += got["launches"]["group_stretch_propose"]
        if drift is not None:
            drifts.append(name)
            rates[f"{name}_first_difference"] = {
                "step": drift[0], "field": drift[2], "max_abs": drift[1]}
        rates[f"{name}_digit_for_digit"] = drift is None
        got = _sum_launches([r[leg] for r in ranks])
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        sps = steps / max(r[leg]["seconds"] for r in ranks)
        wsps, setup = _window_rate(ranks, leg)
        end = max(r[leg]["end"] for r in ranks)
        rates[f"{name}_steps_per_s"] = sps
        rates[f"{name}_window_steps_per_s"] = wsps
        rates[f"{name}_setup_s"] = setup
        rates[f"{name}_wall_s"] = end - last
        start = "the ranks' start and " if last == t0 else ""
        verdict = ("equals the one-rank eager chain digit for digit"
                   if drift is None else "DIFFERS from the one-rank eager "
                   "chain")
        print(f"{name}: {verdict}; routes {ranks[0][leg]['routes']}; "
              f"{sps:.1f} steps/s over {steps} steps (the slowest rank; "
              f"eager; window {wsps:.1f} steps/s over the {MC_STEPS} "
              f"stored, set-up and burn-in {setup:.2f} s), wall "
              f"{end - last:.1f} s with {start}the set-up; "
              f"kernels 1, 2, 3, 5 a rank "
              f"{_kernel_work(ranks[0][leg]['launches'])} as the one-rank "
              f"chain; launches by the ranks {got}, by the one-rank chain "
              f"{ref_launches[leg]} ({card})")
        last = end
    launches["group_stretch_propose[sharded config-c]"] = sharded
    rates["mesh_custom_legs_wall_s"] = wall
    print(f"mesh[custom-mh|custom-stretch|custom-combine|custom-rj,4rank,"
          f"gloo]: wall {wall:.1f} s with the ranks' start; staged through "
          f"host memory: {ranks[0]['staged'] or 'none'} ({card})")
    assert not drifts, f"chains differ from their one-rank chains: {drifts}"
    return launches, rates, []


# mesh_graph[...]: the sharded route captured with its NCCL collectives, on a
# one-rank NCCL group (NCCL takes one rank per card): the north-star (50 +
# 400 steps), the LISA-style RJ configuration (20 + 100), the tuning zoo
# (benchmarks/move_zoo_timing.py:27-166's slice, MALA, HMC, ChEES and AIMH
# at equal weights, 30 + 120), the best stack (VERDICT.md:290-296, 20 +
# 80), the general-path moves (80 + 160), multiple-try RJ (20 + 60) and
# the model swap (20 + 80), each run captured, then eager, from the same
# seed, into DeviceBackend; the window is the stored steps, timed apart from
# the set-up and the burn-in (the first eager run of each move, which makes
# NCCL's communicator, and the captures)
MG_LEGS = {"north-star": (50, 400), "lisa-rj": (20, 100), "zoo": (30, 120),
           "best-stack": (20, 80), "general": (80, 160), "mt-rj": (20, 60),
           "modelswap": (20, 80)}
# replayed steps traced, the figures from the first half of them whose
# traces hold every counted launch
MG_PROFILE_STEPS = 20
# the legs of about 1,000-3,000 device ops a step trace fewer steps
MG_PROFILE_HEAVY = ("zoo", "best-stack")
# seconds between a profiler session's start and its step, and between the
# step's end and the session's stop
MG_TRACE_PAUSE = 0.01
# after the window, replays alone (every phase's graph captured): the
# captured route's steady rate
MG_TAIL = 100
# the one rank's time limit: seven legs, each captured, eager and profiled
MG_TIMEOUT = 600
# the tuning moves' tune_steps, each move's stored window crossing it; the
# group stretch's refresh period
MG_TUNE = {"zoo": 14, "best-stack": 50}
MG_REFRESH = 5


def _mesh_graph_sampler(torch, np, leg, cuda_graph):
    """A ``mesh_graph[...]`` leg's sampler (into DeviceBackend) and its
    global start, not evaluated."""
    from eryn_tpu_torch import (
        DeviceBackend,
        EnsembleSampler,
        ProbDistContainer,
        State,
        uniform_dist,
    )
    from eryn_tpu_torch import moves as tm

    if leg == "north-star":
        return _mesh_north_star(torch, cuda_graph=cuda_graph)
    if leg == "lisa-rj":
        return _mesh_rj_sampler(torch, np, leg, cuda_graph=cuda_graph)
    if leg == "mt-rj":
        return _mt_rj_sampler(torch, cuda_graph=cuda_graph, setup=False,
                              backend=DeviceBackend())
    if leg == "modelswap":
        return _modelswap_sampler(torch, np, MZ_SWAP_NT,
                                  cuda_graph=cuda_graph,
                                  backend=DeviceBackend())
    gen = torch.Generator(device="cuda").manual_seed(MESH_SEED)
    if leg == "general":
        jump, stretch, gauss, _ = _custom_classes()
        priors = ProbDistContainer(
            {i: uniform_dist(0.0, MS_PERIOD) if i == 0
             else uniform_dist(-5.0, 5.0) for i in range(NDIM)})
        diag = {"model_0": np.diag(np.full(NDIM, 0.5 ** 2))}
        moves = [tm.StretchMove(periodic={"model_0": {0: MS_PERIOD}},
                                nsplits=4),
                 tm.DEMove(), tm.DESnookerMove(), tm.WalkMove(),
                 tm.KDEMove(), tm.GaussianMove(diag),
                 tm.GroupStretchMove(n_iter_update=MG_REFRESH), stretch(),
                 jump(), tm.DelayedRejection(gauss(diag), max_iter=2),
                 tm.CombineMove([tm.GaussianMove(diag),
                                 tm.DistributionGenerate({"model_0": priors})])]

        def log_like(x):
            return -0.5 * torch.sum(x * x)

        s = EnsembleSampler(
            NW, NDIM, log_like, priors, tempering_kwargs=dict(ntemps=NT),
            moves=[(m, 1 / len(moves)) for m in moves], seed=MESH_SEED,
            device="cuda", backend=DeviceBackend(), cuda_graph=cuda_graph)
        coords = priors.rvs(size=(NT, NW), generator=gen)
        return s, State({"model_0": coords[:, :, None, :]})
    tune = MG_TUNE[leg]
    if leg == "zoo":
        moves = [tm.SliceMove(tune_steps=tune), tm.MALAMove(tune_steps=tune),
                 tm.HMCMove(num_leapfrog=(2, 4), tune_steps=tune),
                 tm.ChEESHMCMove(max_leapfrog=8, tune_steps=tune),
                 tm.AIMHMove(tune_steps=tune)]
        kw = dict(moves=[(m, 1 / len(moves)) for m in moves])
    else:  # best-stack
        kw = dict(moves=tm.ChEESHMCMove(tune_steps=tune), tempering=DEO)
    s, priors = _gaussian_sampler(torch, NT, NW, MESH_SEED,
                                  backend=DeviceBackend(),
                                  cuda_graph=cuda_graph, **kw)
    coords = priors.rvs(size=(NT, NW), generator=gen)
    return s, State({"model_0": coords[:, :, None, :]})


def _mesh_graph_clocks(s):
    """``[(move name, clock value, move)]`` of every clock with a host phase
    in the sampler's moves (``Move.mesh_clocks``)."""
    return [(type(m).__name__, int(t), m)
            for j, move in enumerate(s._all_move_list)
            for m, t in move.mesh_clocks(s._kernel_states[j])]


def _mesh_graph_graphs(s):
    """Per move of a captured run: ``(name, graphs captured, whether it has
    a host phase)``; and the counted kernels' launches inside the replays
    (each graph's captured launches times its replays)."""
    graphs = s._graphs
    per, inside = {}, {}
    for key, (_, counts) in graphs.graphs.items():
        per[key[0]] = per.get(key[0], 0) + 1
        for kernel, n in counts:
            inside[kernel.__name__] = (inside.get(kernel.__name__, 0)
                                       + n * graphs.replayed.get(key, 0))
    moves = s._all_move_list
    return ([(type(moves[j]).__name__, per.get(j, 0),
              bool(moves[j].mesh_clocks(s._kernel_states[j])))
             for j in range(len(moves))], inside)


def _mesh_graph_profile(torch, sampler, schedule, n=MG_PROFILE_STEPS):
    """``torch.profiler`` over replayed steps without storing, their moves
    drawn from the host generator's state ``schedule`` (the same steps for
    two samplers of one configuration), per step: the graph launches, the
    device's ops and busy time, our kernels by name, NCCL's kernels, the
    copy kernels of graph memcpy nodes (``memcpy32_post``: NCCL's one-rank
    gathers among them) and the runtime's memcpys by direction.

    ``n`` steps run as one segment, each traced by a profiler session of
    its own (the first also holds the segment's load of the buffers, the
    last its export), ``MG_TRACE_PAUSE`` after its start and before its
    stop.  The profiler can lose device records: one session over ten zoo
    steps (about 15,700 records) once came back with about a thousand of
    them missing, a swap kernel among them, and one-step sessions in the
    general leg lost records in 1 and 4 of 20 steps.  So each step's trace
    is held against the launch counters of the same step; a step whose
    trace shows fewer launches of one of our kernels than the counters
    recorded is counted in ``lost_steps`` (``lost``: the step, the kernel,
    seen and counted), and the figures are those of the first ``n // 2``
    steps whose traces hold every counted launch; fewer fail the script."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from eryn_tpu_torch.ops import pt_swap, select_kernels
    from eryn_tpu_torch.ops import stretch_kernels as sk

    # our kernels: (key, the device function's name, the wrappers counting
    # its launches)
    ours = (("stretch_propose", r"(?<!group_)stretch_propose_kernel",
             (sk.stretch_propose,)),
            ("stretch_accept_propose", r"stretch_accept_propose_kernel",
             (sk.stretch_accept_propose,)),
            ("stretch_accept", r"stretch_accept_kernel", (sk.stretch_accept,)),
            ("pt_swap_cascade", r"pt_swap_cascade_kernel",
             (pt_swap.pt_swap_cascade_multi, pt_swap._cascade_multi_rolled)),
            ("group_stretch_propose", r"group_stretch_propose_kernel",
             (select_kernels.group_stretch_propose,)),
            ("onehot_select", r"onehot_select_kernel",
             (select_kernels.onehot_select,)))

    def counts():
        return [sum(k.launches for k in wrappers) for _, _, wrappers in ours]

    graphs = sampler._graphs
    replay = graphs.step
    sessions, launched = [], []

    def trace():
        sessions.append(profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]))
        sessions[-1].start()
        time.sleep(MG_TRACE_PAUSE)

    def close():
        torch.cuda.synchronize()
        time.sleep(MG_TRACE_PAUSE)
        sessions[-1].stop()

    def step(row, ctx):
        before = counts()
        replay(row, ctx)
        launched.append([b - a for a, b in zip(before, counts())])
        if len(sessions) < n:
            close()
            trace()

    sampler._host_gen.set_state(schedule)
    torch.cuda.synchronize()
    graphs.step = step
    trace()
    try:
        sampler._run_bulk(sampler._previous_state, 1, n, store=False)
    finally:
        del graphs.step
        close()
    assert len(sessions) == len(launched) == n, (len(sessions), n)
    device, launches, busy, lost, kept = [], 0, 0.0, [], 0
    for i, (prof, want) in enumerate(zip(sessions, launched)):
        events = sorted((e for e in prof.events()
                         if e.device_type == DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        names = [e.name for e in events]
        short = [(i, key, seen, w) for (key, pat, _), w in zip(ours, want)
                 for seen in [sum(bool(re.search(pat, x)) for x in names)]
                 if seen < w]
        lost += short
        if short or kept == n // 2:
            continue
        kept += 1
        launches += sum(e.name == "cudaGraphLaunch" for e in prof.events())
        device += names
        end = -math.inf
        for e in events:
            busy += max(e.time_range.end - max(e.time_range.start, end), 0.0)
            end = max(end, e.time_range.end)
    assert kept == n // 2, (
        f"the profiler lost records in {len({x[0] for x in lost})} of {n} "
        f"traced steps: (step, kernel, seen, counted) {lost}")
    out = {"steps": kept, "lost_steps": len({x[0] for x in lost}),
           "lost": lost, "graph_launches": launches / kept,
           "device_ops": len(device) / kept, "device_ms": busy / kept / 1e3}
    for key, pat in [(key, pat) for key, pat, _ in ours[:5]] + [
            ("nccl", r"(?i)nccl"), ("memcpy32_post", r"memcpy32_post")]:
        out[key] = sum(bool(re.search(pat, name)) for name in device) / kept
    for name in device:
        if name.startswith("Memcpy"):
            kind = "memcpy " + name.split()[1]
            out[kind] = out.get(kind, 0) + 1 / kept
    return out


def _mesh_graph_rank(rank, world):
    """The one NCCL rank of the ``mesh_graph[...]`` legs: per leg the
    sharded route on a ``(1, 1)`` mesh (``_one_rank_layout``), captured,
    then eager; the set-up, the burn-in and the window timed apart, the
    stored segments under ``set_sync_debug_mode("error")``, the kernels'
    launches and the collectives (``_comm.CALLS``) counted over the run,
    and a profile of the replays."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from eryn_tpu_torch.parallel import _comm, make_mesh, shard_state

    out = {"backend": dist.get_backend()}
    with _plain_versions_forbidden():
        mesh = make_mesh(1)
        for leg, (warm, steps) in MG_LEGS.items():
            n_prof = MG_PROFILE_STEPS // (1 + (leg in MG_PROFILE_HEAVY))
            for form in ("captured", "eager"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                s, state = _mesh_graph_sampler(torch, np, leg,
                                               form == "captured")
                state = shard_state(state, mesh)
                s._one_rank_layout = state.sharding.layout
                read = _counting(_kernels())
                calls = dict(_comm.CALLS)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                s.run_mcmc(state, 1, burn=warm)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                clocks = _mesh_graph_clocks(s)
                with _segments_never_wait():
                    s.run_mcmc(None, steps - 1)
                torch.cuda.synchronize()
                t3 = time.perf_counter()
                got = out[leg, form] = {
                    "setup_s": t1 - t0, "burn_s": t2 - t1,
                    "window_s": t3 - t2, "window_steps": steps - 1,
                    "launches": read(),
                    "calls": {k: v - calls.get(k, 0)
                              for k, v in _comm.CALLS.items()
                              if v != calls.get(k, 0)},
                    "sharded": s._mesh_layout is not None,
                    "graph_replays": s.graph_replays,
                    "graph_captures": s.graph_captures,
                    # each host phase's clock over the stored window, and
                    # whether its phase changed there
                    "clocks": [(name, a, b, any(
                        m.phase_of(v) != m.phase_of(a)
                        for v in range(a, b + 1)))
                        for (name, a, m), (_, b, _) in zip(
                            clocks, _mesh_graph_clocks(s))],
                    "record": (_mesh_rj_record(s)
                               if leg in ("north-star", "lisa-rj")
                               else _mesh_zoo_record(s))}
                if form == "captured":
                    got["graphs"], got["inside"] = _mesh_graph_graphs(s)
                    with _segments_never_wait():
                        t0 = time.perf_counter()
                        s._run_bulk(s._previous_state, 1, MG_TAIL,
                                    store=False)
                        torch.cuda.synchronize()
                    got["steady_s"] = time.perf_counter() - t0
                    schedule = s._host_gen.get_state()
                    got["profile"] = _mesh_graph_profile(torch, s, schedule,
                                                         n_prof)
            # the same configuration in one process, graphed, on the same
            # profiled steps: what the sharded route adds to a step
            s, state = _mesh_graph_sampler(torch, np, leg, True)
            s.run_mcmc(state, 1, burn=warm)
            out[leg, "one process"] = {"profile": _mesh_graph_profile(
                torch, s, schedule, n_prof)}
    return out


def mesh_graph_legs(torch, card):
    """``mesh_graph[<leg>,1x1,nccl]`` for each leg of ``MG_LEGS``: the
    sharded route, planned on the device, captured in CUDA graphs with its
    NCCL collectives on one rank (NCCL takes one rank per card, so one card
    shows it at world size 1), against the same route eager from the same
    seed.  Each captured chain must equal its eager chain digit for digit;
    graphs must replay, two for each move with a host phase (whose phase
    must change in the stored window: past ``tune_steps``, a group
    refresh) and one for any other; the stored segments run under
    ``set_sync_debug_mode("error")``; each replay carries its collectives
    (counted at capture); the profile of the replays must show kernels 1,
    2, 3 (north-star) or 3 and 5 (LISA), and the zoo's replays launch
    kernel 3.  Prints the window's steps/s captured and eager, with the
    set-up and the burn-in (NCCL's warm-up and the captures) apart, the
    graphs per move, the collectives, device ops and device time a replayed
    step, and the kernels' launches inside the replays.  Returns the
    launches of both forms and the legs' rates."""
    import numpy as np

    from eryn_tpu_torch.parallel._spawn import launch

    t0 = time.perf_counter()
    rank = launch(_mesh_graph_rank, 1, backend="nccl",
                  timeout=MG_TIMEOUT)[0]
    wall = time.perf_counter() - t0
    assert rank["backend"] == "nccl", rank["backend"]
    launches, rates = {}, {}
    for leg, (warm, steps) in MG_LEGS.items():
        name = f"mesh_graph[{leg},1x1,nccl]"
        cap, eag = rank[leg, "captured"], rank[leg, "eager"]
        assert cap["sharded"] and eag["sharded"], name
        _same_record(np, f"{name}, captured against eager", cap["record"],
                     eag["record"])
        assert cap["graph_replays"] > 0, (name, cap["graph_replays"])
        assert eag["graph_replays"] == 0, (name, eag["graph_replays"])
        assert cap["launches"] == eag["launches"], (name, cap["launches"],
                                                     eag["launches"])
        assert cap["calls"] == eag["calls"] and cap["calls"], (
            name, cap["calls"], eag["calls"])
        prof, one = cap["profile"], rank[leg, "one process"]["profile"]
        assert cap["clocks"] == eag["clocks"], (name, cap["clocks"])
        assert all(c[3] for c in cap["clocks"]), (
            f"{name}: a host phase did not change in the window", cap["clocks"])
        for move, n, phased in cap["graphs"]:
            assert n == 1 + phased, (name, cap["graphs"])
        if leg == "north-star":
            # every step's replay carries its collectives: the gathered
            # log-likelihood of the swap phase
            assert cap["calls"]["all_gather_into_tensor"] == warm + steps, (
                name, cap["calls"])
            _assert_stretch_launches(cap["launches"], warm + steps)
            assert cap["launches"]["pt_swap_cascade_multi"] == warm + steps
            assert min(prof["stretch_propose"], prof["stretch_accept"],
                       prof["stretch_accept_propose"]) == 1, prof
        elif leg == "lisa-rj":
            assert cap["calls"]["all_gather_into_tensor"] == 2 * (
                warm + steps), (name, cap["calls"])
            n = cap["launches"]
            assert n["group_stretch_propose"] == 2 * (warm + steps), n
            assert n["pt_swap_cascade_multi"] == 2 * (warm + steps), n
            assert prof["group_stretch_propose"] == 2, prof
        elif leg == "zoo":
            assert cap["inside"].get("pt_swap_cascade_multi", 0) > 0, (
                name, cap["inside"])
        elif leg == "mt-rj":
            assert cap["inside"].get("group_stretch_propose", 0) > 0, (
                name, cap["inside"])
        if leg != "best-stack":  # DEO swaps with tensor ops
            assert prof["pt_swap_cascade"] >= 1, prof
        for k, v in cap["launches"].items():
            launches[k] = launches.get(k, 0) + v + eag["launches"][k]
        sps = {f: r["window_steps"] / r["window_s"] for f, r in
               (("captured", cap), ("eager", eag))}
        rates[f"{name}_steps_per_s"] = sps["captured"]
        rates[f"{name}_eager_steps_per_s"] = sps["eager"]
        rates[f"{name}_steady_steps_per_s"] = MG_TAIL / cap["steady_s"]
        rates[f"{name}_setup_s"] = cap["setup_s"]
        rates[f"{name}_burn_s"] = cap["burn_s"]
        rates[f"{name}_collectives_per_step"] = {
            k: v / (warm + steps) for k, v in cap["calls"].items()}
        print(f"{name}: captured equals eager digit for digit (chain, "
              f"masks, log_like, log_prior, betas, acceptance, swaps); "
              f"{cap['graph_captures']} graphs captured, "
              f"{cap['graph_replays']} replays, stored segments under "
              f"set_sync_debug_mode('error'); window {sps['captured']:.1f} "
              f"steps/s captured, {sps['eager']:.1f} eager, over "
              f"{cap['window_steps']} stored steps; set-up "
              f"{cap['setup_s']:.2f} s, burn-in of {warm} with NCCL's "
              f"warm-up and the captures {cap['burn_s']:.2f} s (eager "
              f"{eag['burn_s']:.2f} s); collectives {cap['calls']}; "
              f"launches {cap['launches']} ({card})")
        rates[f"{name}_device_ops_per_step"] = prof["device_ops"]
        rates[f"{name}_device_ms_per_step"] = prof["device_ms"]
        rates[f"{name}_launches_in_replays"] = cap["inside"]
        print(f"{name}: steady {MG_TAIL} replayed steps after the window "
              f"(every phase's graph captured) "
              f"{rates[f'{name}_steady_steps_per_s']:.1f} steps/s, "
              f"{rates[f'{name}_steady_steps_per_s'] / sps['eager']:.1f} "
              f"times the eager window ({card})")
        print(f"{name}: graphs per move (name, graphs, host phase) "
              f"{cap['graphs']}; host-phase clocks over the window (name, "
              f"start, end, phase changed) {cap['clocks']}; kernel launches "
              f"inside the replays {cap['inside']} ({card})")
        print(f"{name}: profile of {prof['steps']} replayed steps, per "
              f"step: {prof}; the same configuration in one process, "
              f"graphed: {one} ({card})")
    rates["mesh_graph_legs_wall_s"] = wall
    print(f"mesh_graph[...]: wall {wall:.1f} s with the rank's start "
          f"({card})")
    return launches, rates, []


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", help="also write the report as JSON here")
    parser.add_argument(
        "--cascade-scan", action="store_true",
        help="after the build, only time the swap cascade on the device "
             "against rungs, walkers and chunk width, and stop")
    parser.add_argument(
        "--null-leg", action="store_true",
        help="after the build, only run and profile the null-likelihood RJ "
             "leg, through the package's public names, and stop")
    parser.add_argument(
        "--mesh-legs", action="store_true",
        help="after the build, only run the device mesh's legs, and stop")
    parser.add_argument(
        "--para-digest", action="store_true",
        help="after the build, only run para[north-star x64] and "
             "para[rj_pulse128 x16] and print their chains' digests, and "
             "stop: copied into an earlier tree of the port it digests that "
             "tree's chains")
    parser.add_argument(
        "--resume-child", nargs=2, metavar=("CONFIG", "FILE"),
        help="run the first part of a resume leg into an HDF5 file until "
             "its update_fn kills this process (the resume legs start it)")
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
    if args.resume_child:
        return resume_child(*args.resume_child)
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

    if args.cascade_scan:
        cascade_scan(torch, smi)
        return 0
    if args.mesh_legs or args.para_digest:
        with _plain_versions_forbidden():
            legs = ([mesh_legs, mesh_rj_legs, mesh_zoo_legs,
                     mesh_surface_legs, mesh_custom_legs, mesh_graph_legs]
                    if args.mesh_legs else []) + (
                [para_north_star_leg, para_rj_pulse128_leg]
                if args.para_digest else [])
            for leg in legs:
                t0 = time.perf_counter()
                leg(torch, smi)
                print(f"{leg.__name__}: {time.perf_counter() - t0:.1f} s")
        return 0
    if args.null_leg:
        with _segments_never_wait():
            *_, (leg, sampler, state) = lisa_rj_leg(torch, smi, null=True,
                                                    count=False)
        profile_steps(torch, leg, sampler, state, smi)
        return 0

    # phase 3: kernels against their plain versions, and their times
    errs = {}
    for dtype_name in ("float32", "float64"):
        for k, e in check_kernels(torch, dtype_name).items():
            errs[k] = max(errs.get(k, 0.0), e)
        print(f"kernels[{dtype_name}]: agree with their plain versions")
    for dtype_name in ("float32", "float64"):
        for k, e in check_grouped_kernels(torch, dtype_name).items():
            errs[k] = max(errs.get(k, 0.0), e)
        print(f"kernels[{dtype_name}, grouped]: the grouped launches at G in "
              f"{GROUP_SIZES} equal their plain versions (max abs error 0), "
              f"and at G = 1 the ungrouped launches")
    times, launchers = time_kernels(torch)
    gtimes, glaunchers = time_grouped_kernels(torch)
    times.update(gtimes)
    launchers.update(glaunchers)
    floor = times.pop("empty_launch")
    print(f"time: empty launch {floor['ms']:.4f} ms per call ({smi})")
    for k, t in times.items():
        plain = ("as above" if t["plain_ms"] is None
                 else f"{t['plain_ms']:.4f} ms")
        print(f"time: {k} {t['ms']:.4f} ms per call, plain {plain}, "
              f"bound {t['bound_ms']:.6f} ms "
              f"({t['bound_by']}), launch floor {floor['ms']:.4f} ms ({smi})")

    host_us = wrapper_host_costs(torch, smi)
    print(f"phase 3: {time.perf_counter() - t_start:.1f} s since the start")

    # phase 4: the main path, leg by leg, graphed; then the graphs against
    # the eager loop
    legs = []
    if not _have_h5py():
        print("phase 4: h5py is not installed here: hdf[north-star] runs "
              "into Backend() alone, and the resume legs continue in this "
              "process from an in-memory Backend(), not from a SIGKILLed "
              "child's HDF5 file")
    with _plain_versions_forbidden(), _segments_never_wait(), \
            _para_segments_never_wait():
        for leg in (north_star_leg, config_e_leg, lisa_rj_leg,
                    lisa_rj_null_leg, custom_move_leg, hdf_leg,
                    resume_north_star_leg, resume_lisa_null_leg, hooks_leg,
                    deo_leg, evidence_leg, rj_pulse128_leg, zoo_leg,
                    zoo_mt_rj_leg, config_d_leg, modelswap_leg,
                    best_stack_leg, blobs_north_star_leg,
                    blobs_lisa_rj_null_leg, replica_flow_leg,
                    para_north_star_leg, para_zoo_leg, para_rj_pulse128_leg,
                    para_groups_running_leg, pickle_leg, plot_hook_leg):
            t0 = time.perf_counter()
            legs.append(leg(torch, smi))
            print(f"phase 4: {leg.__name__} {time.perf_counter() - t0:.1f} s")
        # a check of the RJ posterior, not a main-path leg: its launches are
        # asserted inside and left out of the report
        t0 = time.perf_counter()
        flat_rj_leg(torch)
        print(f"phase 4: flat_rj_leg {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        compared, eager = graph_vs_eager(torch, smi)
        compared.update(graph_vs_eager_para(torch, smi))
        print(f"phase 4: graph_vs_eager {time.perf_counter() - t0:.1f} s")
    # the host side: these steps visit the host by design, so they run
    # outside the check that segments never wait (the hybrid leg's native
    # form runs inside it)
    with _plain_versions_forbidden():
        for leg in (host_like_leg, host_like_vec_leg, host_like_pool_leg,
                    hybrid_host_leg, examples_leg, mesh_legs,
                    mesh_rj_legs, mesh_zoo_legs, mesh_surface_legs,
                    mesh_custom_legs, mesh_graph_legs):
            t0 = time.perf_counter()
            legs.append(leg(torch, smi))
            print(f"phase 4: {leg.__name__} {time.perf_counter() - t0:.1f} s")
    print("phase 4: one cascade launch per tempering phase on every leg but "
          "the DEO ones (none there), every step a replay of its moves' "
          "graphs, no segment waited for the device, and no plain version of "
          "a kernel was called")
    launches, rates = {}, {}
    for leg_launches, leg_rates, _ in legs:
        for k, v in leg_launches.items():
            launches[k] = launches.get(k, 0) + v
        rates.update(leg_rates)
    assert all(v > 0 for v in launches.values()), launches
    print(f"rate: best_stack_tau_max = {rates['best_stack_tau_max']:.4f} "
          f"(ChEES-HMC, DEO) beside north-star's stretch tau_max = "
          f"{rates['tau_max']:.4f}; best_stack_ess_per_s = "
          f"{rates['best_stack_ess_per_s']:.1f} beside device_ess_per_s = "
          f"{rates['device_ess_per_s']:.1f} ({smi})")
    print(f"rate: blobs_steps_per_s = {rates['blobs_steps_per_s']:.1f} "
          f"(blobs and supplementals, the general stretch path) beside "
          f"stored_device_steps_per_s = "
          f"{rates['stored_device_steps_per_s']:.1f} (the fused kernels); "
          f"blobs_lisa_rj_null_steps_per_s = "
          f"{rates['blobs_lisa_rj_null_steps_per_s']:.1f} beside "
          f"lisa_rj_null_steps_per_s = "
          f"{rates['lisa_rj_null_steps_per_s']:.1f} ({smi})")
    print(f"rate: host_like_steps_per_s = {rates['host_like_steps_per_s']:.1f}"
          f" (per walker), host_like_vec_steps_per_s = "
          f"{rates['host_like_vec_steps_per_s']:.1f} (vectorized), "
          f"host_like_pool_steps_per_s = "
          f"{rates['host_like_pool_steps_per_s']:.1f} beside "
          f"stored_device_steps_per_s = "
          f"{rates['stored_device_steps_per_s']:.1f} ({smi})")
    print(f"rate: para_steps_per_s = {rates['para_steps_per_s']:.1f} "
          f"({PARA_G} groups, para_group_steps_per_s = "
          f"{rates['para_group_steps_per_s']:.1f}) beside the single "
          f"north-star's stored_device_steps_per_s = "
          f"{rates['stored_device_steps_per_s']:.1f} ({smi})")
    rates["lisa_rj_overhead_frac"] = (rates["lisa_rj_steps_per_s"]
                                      / rates["lisa_rj_null_steps_per_s"])
    print(f"rate: lisa_rj_overhead_frac = {rates['lisa_rj_overhead_frac']:.4f} "
          f"(heavy steps/s over null steps/s; {smi})")

    # phase 5: the profiler, after every timed run (a profiled process may
    # keep tracing costs on its launches): device-only kernel times, then
    # 50 steady steps of each main-path leg
    t0 = time.perf_counter()
    device = device_times(torch, launchers)
    print(f"phase 5: device_times {time.perf_counter() - t0:.1f} s")
    floor["device_ms"] = device.pop("empty_launch")
    print(f"time: empty launch {floor['device_ms']:.4f} ms on the device "
          f"({smi})")
    for k, t in times.items():
        t["device_ms"] = device[k]
        print(f"time: {k} {t['device_ms']:.4f} ms on the device, "
              f"{t['ms']:.4f} ms per call ({smi})")
    t0 = time.perf_counter()
    profiles = {}
    by_name = {}
    for _, _, kept in legs:
        for leg, sampler, state in (kept if isinstance(kept, list) else [kept]):
            by_name[leg] = (sampler, state)
    for leg in ("north-star", "config E", "LISA RJ", "LISA RJ null", "deo",
                "rj_pulse128", "zoo[CombineMove]", "zoo[MT-RJ x8]",
                "config_d", "modelswap", "best_stack", "zoo[SliceMove]",
                "blobs[north-star]", "blobs[lisa-rj-null]",
                "host_like[north-star]", "host_like_vec[north-star]",
                "hybrid_host[4 x 100]", f"para[north-star x{PARA_G}]"):
        profiles.update(profile_steps(torch, leg, *by_name[leg], smi,
                                      steps=_profile_steps(leg)))
    phases = tempering_phase_device_ms(
        torch, {"cascade": by_name["north-star"][0],
                "deo": by_name["deo"][0]}, smi)
    print(f"phase 5: graphed profiles {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for leg, (sampler, state) in eager.items():
        profiles.update(profile_steps(torch, f"{leg}, eager", sampler, state,
                                      smi, steps=_profile_steps(leg, True)))
    print(f"phase 5: eager profiles {time.perf_counter() - t0:.1f} s")

    sources = {
        "stretch_propose": ("eryn_tpu_torch/csrc/stretch_kernels.cu",
                            "eryn_tpu/ops/stretch_kernels.py:68"),
        "stretch_accept_propose": (
            "eryn_tpu_torch/csrc/stretch_kernels.cu",
            "eryn_tpu/ops/stretch_kernels.py:154, "
            "eryn_tpu/ops/stretch_kernels.py:68"),
        "stretch_accept": ("eryn_tpu_torch/csrc/stretch_kernels.cu",
                           "eryn_tpu/ops/stretch_kernels.py:154"),
        "pt_swap_cascade_multi": ("eryn_tpu_torch/csrc/pt_swap.cu",
                                  "eryn_tpu/ops/pt_swap.py:120"),
        "_cascade_multi_rolled": ("eryn_tpu_torch/csrc/pt_swap.cu",
                                  "eryn_tpu/ops/pt_swap.py:232"),
        "group_stretch_propose": ("eryn_tpu_torch/csrc/select_kernels.cu",
                                  "eryn_tpu/ops/select_kernels.py:145"),
        # the LISA mesh legs' ranks' launches, timed at a (2, 2) rank's
        # LISA shape
        "group_stretch_propose[sharded]": (
            "eryn_tpu_torch/csrc/select_kernels.cu",
            "eryn_tpu/ops/select_kernels.py:145"),
        # the zoo mesh legs' ranks' launches (the MT-RJ chain), timed at a
        # (2, 2) rank's MT-RJ shape
        "group_stretch_propose[sharded mt-rj]": (
            "eryn_tpu_torch/csrc/select_kernels.cu",
            "eryn_tpu/ops/select_kernels.py:145"),
        # the custom RJ mesh leg's ranks' launches, timed at a (2, 2) rank's
        # config C shape
        "group_stretch_propose[sharded config-c]": (
            "eryn_tpu_torch/csrc/select_kernels.cu",
            "eryn_tpu/ops/select_kernels.py:145"),
        "onehot_select": ("eryn_tpu_torch/csrc/select_kernels.cu",
                          "eryn_tpu/ops/select_kernels.py:145"),
    }
    # the grouped launches (ParaEnsembleSampler), timed at the para legs'
    # shapes; the rolled cascade runs in phase 3 only (no para leg exceeds
    # 640 walkers), so it lists no launch
    grouped = {
        "stretch_propose": f"[G={PARA_G}]",
        "stretch_accept_propose": f"[G={PARA_G}]",
        "stretch_accept": f"[G={PARA_G}]",
        "pt_swap_cascade_multi": f"[G={PARA_G}]",
        "_cascade_multi_rolled": "[G=4]",
        "group_stretch_propose": f"[G={PR_G}]",
    }
    for k, tag in grouped.items():
        sources[f"{k}[grouped]"] = sources[k]
        times[f"{k}[grouped]"] = {"shape": tag, **times.pop(k + tag)}
    # no single PyTorch call computes any of these functions (the selection's
    # torch.searchsorted gives only the indices), so library_ms is null
    report = {"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches.get(k, 0), "max_abs_err": errs[k],
         **times[k], "library_ms": None, "launch_floor_ms": floor["ms"],
         "launch_floor_device_ms": floor["device_ms"]}
        for k, (src, rep) in sources.items()
    ]}
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {**report, "rates": rates, "card": smi,
             "times": times, "launch_floor": floor, "profiles": profiles,
             "host_us": host_us, "graph_vs_eager": compared,
             "tempering_phases": phases},
            indent=1, default=lambda x: x.tolist()  # the examples' arrays
        ))
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
