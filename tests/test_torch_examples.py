"""The port's examples (``eryn_tpu_torch/examples``) on the CPU.

Each script's ``main(device="cpu", scale=...)`` runs in this process at the
smallest scale that runs (every step count at least 4), so a broken example
fails here; the scripts' statistical assertions run only at ``scale=1.0``,
on the GPU (``chip_smoke.py``'s ``examples[...]`` legs).  The port has one
example for each script of ``examples/``.
"""

import glob
import importlib
import os

import numpy as np
import pytest
import torch

from eryn_tpu_torch.examples import EXAMPLES

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALE = 0.003


def test_every_script_of_examples_has_a_counterpart():
    scripts = sorted(
        os.path.basename(p)[:-3]
        for p in glob.glob(os.path.join(ROOT, "examples", "*.py"))
        if not os.path.basename(p).startswith("_"))
    assert scripts == sorted(EXAMPLES)
    for name in EXAMPLES:
        module = importlib.import_module(f"eryn_tpu_torch.examples.{name}")
        assert callable(module.main), name


# custom_moves and runtime_plots have tests of their own below
@pytest.mark.parametrize(
    "name", [n for n in EXAMPLES if n not in ("custom_moves", "runtime_plots")])
def test_example_runs_on_the_cpu(name, capsys):
    module = importlib.import_module(f"eryn_tpu_torch.examples.{name}")
    out = module.main(device="cpu", scale=SCALE)
    assert isinstance(out, dict) and out
    printed = capsys.readouterr().out
    assert printed.strip(), name


def test_example_defaults_to_the_gpu():
    """Without ``device=`` an example runs on the card, and without CUDA
    it raises, as every entry point of the port does."""
    from eryn_tpu_torch.examples import basic_gaussian

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device"):
        basic_gaussian.main(scale=SCALE)


def test_custom_moves_takes_both_routes():
    from eryn_tpu_torch.examples import custom_moves

    out = custom_moves.main(device="cpu", scale=SCALE)
    # the host route reached Eryn's get_proposal on every step of both
    # runs; on the CPU nothing is captured
    assert out["host_proposals"] == out["steps"] + max(out["steps"] // 4, 4)
    assert out["host_graph_captures"] == out["kernel_graph_captures"] == 0


def test_runtime_plots_writes_its_files(tmp_path):
    pytest.importorskip("matplotlib")
    from eryn_tpu_torch.examples import runtime_plots

    out = runtime_plots.main(device="cpu", scale=SCALE, outdir=str(tmp_path))
    files = set(os.listdir(tmp_path))
    assert files == set(out["files"])
    for tag in ("corner_model_0", "trace_model_0", "log_like", "betas",
                "swap_acceptance", "logl_betas", "ridgeline_model_0",
                "acceptance", "acceptance_evolution",
                "acceptance_tempered_evolution"):
        assert f"pt_gaussian_{tag}.png" in files, tag
    for tag in ("corner_model_0", "leaves_model_0",
                "leaves_evolution_model_0"):
        assert f"rj_pulses_{tag}.png" in files, tag
    assert np.isfinite(out["mean_leaves"])
