"""A run on the CPU at a small size: the result line, the check against
planted faults and the control, and no fall-back to the CPU from the
command."""

import io
import json
import subprocess
import sys

import pytest
import torch

from perfbench import cells, faults, harness

from .conftest import ROOT, WINDOW_S

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]
CELLS = [w["name"] for w in cells.manifest(ROOT)["workloads"]]


def _run(root, workload, seed, **kw):
    return harness.measure(workload, seed, WINDOW_S, False, device="cpu",
                           root=root, log=io.StringIO(), **kw)


@pytest.mark.parametrize("workload", CELLS)
def test_result_line(small_root, workload):
    out = _run(small_root, workload, 2**31 + 17)
    assert list(out) == KEYS
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    names = {m["name"] for m in cells.load(workload, small_root).end_to_end}
    assert set(out["metrics"]) == names
    assert {"walker_steps_per_s", "segment_ms_p95", "setup_s"} <= names
    assert all(m["value"] > 0 for m in out["metrics"].values())
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert {k: set(v) for k, v in out["checks"].items()} == {
        "logpost_gap": {"value", "limit"}, "rhat": {"value", "limit"},
        "moment_z": {"value", "limit"}}
    json.dumps(out, allow_nan=False)


@pytest.mark.parametrize("workload", ["gauss5d.stretch", "lisa-rj.template8k"])
@pytest.mark.parametrize("fault", ["altered", "frozen", "half"])
def test_a_broken_step_is_not_correct(small_root, workload, fault):
    """Each fault the cells can have, planted under the timed path: the
    state returned unchanged, half of the walkers left out, an answer
    altered where it is produced (one chip: no exchange to leave out)."""
    out = _run(small_root, workload, 23, tamper=faults.FAULTS[fault])
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("fault", ["biased", "swap_sign"])
def test_a_chain_of_another_distribution_is_not_correct(small_root, fault):
    """An accept without the proposal's factor, and swaps decided with the
    sign turned, fail ``moment_z`` (each stored log-posterior stays true to
    its coordinates); the pulses' cells read them on the card, at a size
    where the CPU's short window separates them too little."""
    out = _run(small_root, "gauss5d.stretch", 31, tamper=faults.FAULTS[fault])
    assert out["correct"] is False
    z = out["checks"]["moment_z"]
    assert z["value"] > z["limit"], out["checks"]


@pytest.mark.parametrize("workload", ["gauss5d.stretch", "lisa-rj.template8k"])
def test_the_control_is_not_correct(small_root, workload):
    """The reference in the program's place at the nearest lower precision:
    the likelihood in bfloat16 fails ``logpost_gap``."""
    out = _run(small_root, workload, 29, control=True)
    assert out["correct"] is False
    gap = out["checks"]["logpost_gap"]
    assert gap["value"] > gap["limit"]


def test_without_a_card_the_command_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "gauss5d.stretch", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0
    assert r.stdout.strip() == ""


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_on_the_card(workload):
    """The control at the cell's own size, on three seeds, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for seed in (2**31 + 3, 2**31 + 5, 2**31 + 7):
        out = harness.measure(workload, seed, 3.0, False, control=True,
                              log=io.StringIO())
        assert out["correct"] is False
