"""Start ``n`` ranks of one program on this machine and join them.

A private launcher for the tests and ``chip_smoke.py``: it spawns ``n``
processes (``torch.multiprocessing``'s ``spawn`` context), initialises
``torch.distributed`` in each through a ``file://`` rendezvous in a fresh
temporary directory, runs ``fn(rank, world_size, *args)``, and returns the
ranks' results in rank order.  Every rank joins under one time limit: a rank
that raises, dies or outlives it stops all of them, so a hung collective
fails in seconds rather than hanging its caller.  ``torchrun`` is the way to
start ranks outside the tests.

``fn`` must be importable by name in a fresh interpreter (a module-level
function of a module that the children can import), and its result must
pickle.  Nothing here imports ``jax``.
"""

from __future__ import annotations

import datetime
import os
import queue
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

__all__ = ["launch"]


def _rank_main(fn, rank, world_size, init_file, backend, timeout, results,
               args):
    torch.set_num_threads(1)
    try:
        if torch.cuda.is_available():
            # every rank picks its card before the process group and any
            # mesh touch the device (one card: all ranks share cuda:0)
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            backend, init_method=f"file://{init_file}", rank=rank,
            world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout))
        try:
            out = fn(rank, world_size, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        # the parent raises with this rank's traceback
        results.put((rank, False, traceback.format_exc()))
        raise


def launch(fn, world_size, *args, backend="gloo", timeout=120.0):
    """Run ``fn(rank, world_size, *args)`` on ``world_size`` spawned ranks
    of one ``backend`` process group (``"gloo"`` or ``"nccl"``) and return
    their results as a list in rank order.

    Where CUDA is available each rank selects card ``rank % device_count``
    before the process group starts.  ``timeout`` (seconds) bounds the whole
    run, start-up included, and each collective.  Raises ``RuntimeError``
    with the rank's traceback if a rank fails, and ``TimeoutError`` if the
    ranks do not all finish in time; in both cases every rank is stopped.
    """
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="eryn_spawn_")
    init_file = os.path.join(tmp, "rendezvous")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, rank, world_size, init_file, backend,
                               timeout, results, args),
                         daemon=True)
             for rank in range(world_size)]
    deadline = time.monotonic() + timeout
    out, failure = {}, None
    try:
        for p in procs:
            p.start()
        while len(out) < world_size and failure is None:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"{world_size} ranks of {getattr(fn, '__name__', fn)} did "
                    f"not finish within {timeout} s (ranks done: "
                    f"{sorted(out)}).")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in out]
                if dead:
                    failure = (f"rank {dead[0]} exited with code "
                               f"{procs[dead[0]].exitcode}")
                continue
            if ok:
                out[rank] = value
            else:
                failure = f"rank {rank} failed:\n{value}"
        if failure is not None:
            raise RuntimeError(failure)
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
        return [out[r] for r in range(world_size)]
    finally:
        for p in procs:
            if p.pid is None:  # never started
                continue
            if p.is_alive():
                p.kill()
            p.join(5.0)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
