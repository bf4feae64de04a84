"""A small copy of the benchmark for the CPU tests: the repository's
``BENCHMARK.json`` and ``perfbench/`` with each configuration cut to a
few walkers and temperatures and each traffic mix to a few steps."""

import json
import shutil
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
SMALL_CONFIG = {"ntemps": 3, "nwalkers": 24, "nleaves_max": 3}
SMALL_TRAFFIC = {"burn": 30, "hook_every": 5, "warm_segments": 1,
                 "check_steps": 6, "trace_segments": 2}
# a window of 1.5 s holds some hundreds of steps of a few walkers, which mix
# less than a full cell's window: R-hat of sound small runs read 1.003-1.033
# on CPU (six seeds a cell), with half of the walkers left out 3.3-720, with
# the state returned unchanged infinite
SMALL_RHAT = 1.2
# so short a window leaves few batches for the moments' standard errors:
# moment_z of sound small runs read 2.3-11.6 on CPU (six seeds a cell), with
# a biased accept or turned swaps 41-66 (gauss5d.stretch)
SMALL_MOMENT_Z = 20.0
WINDOW_S = 1.5


def small_copy(dst):
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", dst / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for f in (dst / "perfbench" / "configs").glob("*.json"):
        d = json.loads(f.read_text())
        d.update({k: v for k, v in SMALL_CONFIG.items() if k in d})
        f.write_text(json.dumps(d))
    for f in (dst / "perfbench" / "limits").glob("*.json"):
        d = json.loads(f.read_text())
        d["rhat"] = SMALL_RHAT
        d["moment_z"] = SMALL_MOMENT_Z
        f.write_text(json.dumps(d))
    for f in (dst / "perfbench" / "traffic").glob("*.json"):
        d = json.loads(f.read_text())
        d.update(SMALL_TRAFFIC)
        if "npts" in d:
            d["npts"] = 64
        for move in d.get("moves", []):
            if move[0] == "ChEESHMCMove":
                move[1] = dict(move[1], tune_steps=20, max_leapfrog=4,
                               init_num_leapfrog=2)
        f.write_text(json.dumps(d))
    return dst


@pytest.fixture(scope="session")
def small_root(tmp_path_factory):
    return small_copy(tmp_path_factory.mktemp("perfbench_small"))
