"""Run one cell of eryn_tpu_torch's benchmark on one NVIDIA GPU.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  ``--trace 0`` prints the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics from a profiled window.  The
last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and ``checks`` last: each number compared beside its
limit); the last lines of standard error repeat the checks.  Without a
CUDA device, or with fewer than the cell asks for, it exits 2 and prints no
result; if JAX or the JAX package was loaded, it exits 3.  A line
``compile: <s> s loading or building the kernels; set-up without it <s> s``
on standard error gives a checkout's first build apart from the warm
set-up (``setup_s`` counts both, as a run that compiles pays both).

The compile caches stay inside the checkout, at fixed paths under
``build/``: the port's kernels in ``build/kernels`` (its own choice),
Triton's and Inductor's here.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "eryn_tpu")


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name, the part before the first dot,
    is one of ``FORBIDDEN`` as a whole word (``eryn_tpu_torch`` is not
    ``eryn_tpu``)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def steady_host():
    """Load from one process with few threads: one intra-op thread, and
    the process (and the threads it starts, the CUDA driver's among them)
    on the third and fourth of the cores it was given, away from the first,
    which the host's own work favours; on fewer than four, on all of them.
    A run is the one process on its card, and the cores it is given are its
    own.  The host's pace still differs between processes, and most where a
    step's host work nears its device time."""
    os.environ["OMP_NUM_THREADS"] = "1"
    cores = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, cores[2:4] if len(cores) >= 4 else cores)


def fix_caches(root=ROOT):
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(root / "build" / sub)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    fix_caches()
    steady_host()
    sys.path.insert(0, str(ROOT))

    import torch

    torch.set_num_threads(1)

    from perfbench import cells, harness

    cell = cells.load(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = harness.measure(args.workload, args.seed, args.seconds,
                          bool(args.trace), device="cuda", t_start=T_START)
    found = forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {found}; no result", file=sys.stderr)
        return 3
    print(f"run: {time.perf_counter() - T_START:.3f} s in all", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
