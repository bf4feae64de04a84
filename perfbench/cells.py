"""Finding a cell's files by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
Its configuration is the file the manifest gives it; its traffic mix is
``traffic/<traffic>.json``; the limits of its correctness check are
``limits/<cell>.json``; the model family the configuration names has its
program-side code in ``models/<family>.py`` and its plain reference in
``reference/<family>.py``; each per-layer metric has its reader in
``metrics/<metric>.py``.  Adding any of them is adding files.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    root: Path
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)


def manifest(root=ROOT):
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path):
    with open(path) as f:
        return json.load(f)


def reports(metric, workload, e2e_names):
    """Whether a cell reports a metric: the cells its ``workloads`` lists,
    else every cell that reports the end-to-end metric it ``moves`` (or, for
    an end-to-end metric without the key, every cell)."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    if "moves" in metric:
        return metric["moves"] in e2e_names
    return True


def load(workload, root=ROOT):
    """The :class:`Cell` named ``workload``; a ``KeyError`` names the cells
    there are."""
    m = manifest(root)
    cells = {w["name"]: w for w in m["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; the manifest has "
                       f"{sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in m["configs"]}[w["config"]]
    here = Path(root) / "perfbench"
    e2e = [x for x in m["end_to_end"] if reports(x, workload, ())]
    names = {x["name"] for x in e2e}
    return Cell(
        name=workload, root=Path(root), chips=int(w["chips"]),
        config=_json(Path(root) / conf["file"]),
        traffic=_json(here / "traffic" / f"{w['traffic']}.json"),
        limits=_json(here / "limits" / f"{workload}.json"),
        end_to_end=e2e,
        per_layer=[x for x in m["per_layer"] if reports(x, workload, names)],
    )


def module(kind, name, root=ROOT):
    """The module ``perfbench/<kind>/<name>.py``, loaded from its file (a
    name may hold ``.`` or ``-``, which an import statement cannot)."""
    path = Path(root) / "perfbench" / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{kind}_{name}".replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
