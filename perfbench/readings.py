"""The readings that the limits of ``correct`` are set from, for one cell, in
one process: sound runs of the program, the control (the configuration's
likelihood in its lower precision) and planted faults, each a whole run at
the cell's own size and window, each on its own seed.

    python3 perfbench/readings.py --workload <cell> --seconds <s> \\
        --runs sound:1,2,3 control:4,5,6 half:7,8,9 [--out file.jsonl]

Prints one JSON line per run: the mode, the seed, ``correct`` and the
numbers compared.  It needs a CUDA device, as ``run.py`` does.
"""

import argparse
import io
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--runs", nargs="+", required=True,
                   help="mode:seed,seed,... with mode sound, control or a "
                        "fault of perfbench/faults.py")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from perfbench.run import fix_caches, steady_host

    fix_caches()
    steady_host()
    import torch

    torch.set_num_threads(1)

    from perfbench import faults, harness

    if not torch.cuda.is_available():
        print("perfbench: readings need a CUDA device", file=sys.stderr)
        return 2
    out = open(args.out, "a") if args.out else None
    try:
        for spec in args.runs:
            mode, seeds = spec.split(":")
            for seed in seeds.split(","):
                t0 = time.perf_counter()
                log = io.StringIO()
                res = harness.measure(
                    args.workload, int(seed), args.seconds, False,
                    control=mode == "control",
                    tamper=faults.FAULTS.get(mode), log=log)
                line = json.dumps({
                    "workload": args.workload, "mode": mode,
                    "seed": int(seed), "correct": res["correct"],
                    "checks": {k: v["value"] for k, v in res["checks"].items()},
                    "metrics": {k: v["value"] for k, v in res["metrics"].items()},
                    "run_s": time.perf_counter() - t0,
                    "log": log.getvalue().strip().splitlines()[-2:]})
                print(line, flush=True)
                if out is not None:
                    out.write(line + "\n")
                    out.flush()
    finally:
        if out is not None:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
