"""Every file a cell needs is found by its name, and one added later is
found without an edit."""

import json
import shutil

import pytest

from perfbench import cells, harness

from .conftest import ROOT, WINDOW_S, small_copy


def _manifest():
    return cells.manifest(ROOT)


@pytest.mark.parametrize("workload", [w["name"] for w in _manifest()["workloads"]])
def test_every_cell_finds_its_files(workload):
    cell = cells.load(workload, ROOT)
    assert cell.config["family"] in {"gaussian", "pulses"}
    assert {"hook_every", "burn", "check_steps"} <= set(cell.traffic)
    assert hasattr(cells.module("reference", cell.config["family"], ROOT),
                   "moment_deviations")
    assert set(cell.limits) == {"logpost_gap", "rhat", "moment_z"}
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for kind in ("models", "reference"):
        assert hasattr(cells.module(kind, cell.config["family"], ROOT),
                       "log_like" if kind == "reference" else "problem")
    for m in cell.per_layer:
        assert callable(cells.module("metrics", m["name"], ROOT).read)


def test_manifest_names_files_under_paths():
    m = _manifest()
    for c in m["configs"]:
        assert c["file"].startswith("perfbench/")
        assert (ROOT / c["file"]).is_file()
    for w in m["workloads"]:
        assert (ROOT / "perfbench" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "perfbench" / "limits" / f"{w['name']}.json").is_file()
    for metric in m["per_layer"]:
        assert (ROOT / "perfbench" / "metrics" / f"{metric['name']}.py").is_file()


def test_a_cell_added_as_files_runs_without_an_edit(tmp_path):
    root = small_copy(tmp_path)
    here = root / "perfbench"
    m = json.loads((root / "BENCHMARK.json").read_text())
    (here / "traffic" / "short64.json").write_text(json.dumps(
        dict(json.loads((here / "traffic" / "template8k.json").read_text()),
             npts=64)))
    shutil.copy(here / "limits" / "lisa-rj.template8k.json",
                here / "limits" / "lisa-rj.short64.json")
    (here / "metrics" / "stored_steps.py").write_text(
        "def read(ctx):\n    return ctx.steps\n")
    m["workloads"].append({"name": "lisa-rj.short64", "config": "lisa-rj",
                           "traffic": "short64", "chips": 1, "why": "test"})
    m["per_layer"].append({"name": "stored_steps", "unit": "steps",
                           "better": "higher", "source": "program_counter",
                           "layer": "sampler loop", "moves": "walker_steps_per_s",
                           "workloads": ["lisa-rj.short64"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    cell = cells.load("lisa-rj.short64", root)
    assert cell.traffic["npts"] == 64
    assert "stored_steps" in {x["name"] for x in cell.per_layer}
    out = harness.measure("lisa-rj.short64", 5, WINDOW_S, True, device="cpu",
                          root=root)
    assert out["correct"]
    assert out["metrics"]["stored_steps"]["value"] > 0
