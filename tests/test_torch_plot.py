"""Runtime plotting on the port (``eryn_tpu_torch/utils/plot.py``) and the
plot hook of its ``run_mcmc``, on the CPU, against ``eryn_tpu``'s.

* Both packages' ``PlotContainer`` read one chain that ``eryn_tpu`` wrote
  to an HDF5 file (a tempered chain, and a reversible-jump one), each
  through its own ``HDFBackend`` with the same options: the same files,
  and the same acceptance histories (to 1e-12).
* The cases of ``tests/test_utils.py``'s plot tests on the port's own
  ``Backend`` and ``DeviceBackend``, and every module-level plot function.
* The hook fires at the stored iterations ``eryn_tpu``'s fires at, beside
  ``stopping_fn`` and ``update_fn`` in the same order; the backend then
  holds every segment run; a hooked chain equals an unhooked one digit for
  digit, on the graph path too; the default generator writes
  ``output_*.png`` into ``plot_folder``; a pickled sampler keeps its hook.
* Importing the package does not import matplotlib.

A plot group that fails only warns (runtime plotting never ends a run), so
these tests turn that warning into an error.

Sizes: 2-D, 16 walkers, up to 3 temperatures and 30 steps.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import eryn_tpu_torch as et
from eryn_tpu_torch import Backend, DeviceBackend
from eryn_tpu_torch.utils import plot as P
from eryn_tpu_torch.utils.plot import PlotContainer

torch.set_num_threads(1)
pytest.importorskip("matplotlib")
pytestmark = pytest.mark.filterwarnings("error:plot group")

NW, NDIM, NT, NSTEPS = 16, 2, 3, 30


def _rj_like_jax(c, m):
    import jax.numpy as jnp

    return jnp.sum(jnp.where(m, -0.5 * jnp.sum(c**2, axis=-1), 0.0))


def _rj_like(c, m):
    return torch.sum(torch.where(m, -0.5 * torch.sum(c**2, dim=-1), 0.0))


def unit_gaussian(x):
    return -0.5 * torch.sum(x * x)


def _jax_file(path, kind):
    """An ``eryn_tpu`` chain in an HDF5 file: 3 x 16 tempered walkers, or
    the RJ configuration of ``tests/test_utils.py:181-215``."""
    import eryn_tpu
    import jax.numpy as jnp
    from eryn_tpu.backends import HDFBackend

    pr = eryn_tpu.ProbDistContainer(
        {i: eryn_tpu.uniform_dist(-5, 5) for i in range(NDIM)})
    rng = np.random.default_rng(5)
    if kind == "pt":
        s = eryn_tpu.EnsembleSampler(
            NW, NDIM, lambda x: -0.5 * jnp.sum(x**2), pr,
            tempering_kwargs=dict(ntemps=NT), seed=24,
            backend=HDFBackend(path))
        s.run_mcmc(rng.uniform(-3, 3, (NT, NW, NDIM)), NSTEPS)
    else:
        s = eryn_tpu.EnsembleSampler(
            NW, NDIM, _rj_like_jax, pr, nleaves_max=2, nleaves_min=0,
            rj_moves=True, fill_zero_leaves_val=-100.0, seed=25,
            backend=HDFBackend(path))
        coords = rng.uniform(-3, 3, (1, NW, 2, NDIM))
        inds = rng.random((1, NW, 2)) < 0.5
        inds[..., 0] = True
        s.run_mcmc(eryn_tpu.State({"model_0": coords},
                                  inds={"model_0": inds}), NSTEPS)
    return path


# ----------------------------------------------------------------------
# the same file through both packages
# ----------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["pt", "rj"])
def test_both_packages_plot_one_file_alike(kind, tmp_path):
    from eryn_tpu.backends import HDFBackend as JaxHDF
    from eryn_tpu.utils.plot import PlotContainer as JaxPlotContainer

    path = _jax_file(str(tmp_path / "chain.h5"), kind)
    opts = dict(fp="p",
                which_plots="all" if kind == "pt" else ("base", "rj", "advanced"),
                info_keys={"model_0": ["alpha", "beta"]},
                corner_kwargs={"bins": 10})
    containers = {}
    for name, cls, backend in (
            ("jax", JaxPlotContainer, JaxHDF(path, read_only=True)),
            ("port", PlotContainer, et.HDFBackend(path, read_only=True))):
        pc = cls(backend=backend, plot_dir=str(tmp_path / name), **opts)
        pc.produce_plots()
        containers[name] = pc
    jax_pc, port_pc = containers["jax"], containers["port"]
    files = sorted(os.listdir(tmp_path / "port"))
    assert files == sorted(os.listdir(tmp_path / "jax"))
    assert "p_corner_model_0.png" in files
    assert "p_act_evolution_model_0.png" in files
    if kind == "rj":
        assert "p_leaves_model_0.png" in files
    else:
        assert {"p_ridgeline_model_0.png", "p_logl_betas.png"} <= set(files)
    assert port_pc._steps == jax_pc._steps == [NSTEPS]
    np.testing.assert_allclose(port_pc._total_acc_history,
                               jax_pc._total_acc_history, rtol=0, atol=1e-12)
    assert port_pc._move_acc_history.keys() == jax_pc._move_acc_history.keys()
    assert port_pc._move_acc_history
    for key, hist in jax_pc._move_acc_history.items():
        np.testing.assert_allclose(port_pc._move_acc_history[key], hist,
                                   rtol=0, atol=1e-12, err_msg=key)
    assert port_pc._labels("model_0", 2) == ["alpha", "beta"]


# ----------------------------------------------------------------------
# the cases of tests/test_utils.py on the port's own backends
# ----------------------------------------------------------------------
def _port_run(backend, ntemps=NT, nsteps=NSTEPS, seed=24, **kw):
    pr = et.ProbDistContainer({i: et.uniform_dist(-5, 5) for i in range(NDIM)})
    s = et.EnsembleSampler(
        NW, NDIM, unit_gaussian, pr,
        tempering_kwargs=dict(ntemps=ntemps) if ntemps > 1 else {},
        seed=seed, device="cpu", backend=backend, **kw)
    start = pr.rvs(size=(ntemps, NW), generator=torch.Generator().manual_seed(seed))
    if nsteps:
        s.run_mcmc(start, nsteps)
    return s, start


def test_plot_container(tmp_path):
    s, _ = _port_run(DeviceBackend())
    pc = PlotContainer(fp="test", backend=s.backend, plot_dir=str(tmp_path),
                       which_plots=("base", "tempering", "advanced"))
    pc.produce_plots()
    produced = os.listdir(tmp_path)
    for tag in ("corner_model_0", "trace_model_0", "log_like", "betas",
                "swap_acceptance", "ridgeline_model_0", "logl_betas",
                "acceptance", "acceptance_evolution",
                "acceptance_tempered_evolution", "act_evolution_model_0"):
        assert f"test_{tag}.png" in produced, tag
    # the history accumulates across calls, one row a call
    s.run_mcmc(None, NSTEPS)
    pc.which_plots = "advanced"
    pc.produce_plots()
    assert pc._steps == [NSTEPS, 2 * NSTEPS]
    assert pc._total_acc_history.shape == (2, NT, NW)
    np.testing.assert_allclose(pc._total_acc_history[1],
                               s.backend.accepted / (2 * NSTEPS))
    (hist,) = pc._move_acc_history.values()
    assert isinstance(hist, np.ndarray) and hist.shape == (2, NT, NW)


def test_plot_rj_and_info_keys(tmp_path):
    pr = et.ProbDistContainer({i: et.uniform_dist(-5, 5) for i in range(NDIM)})
    s = et.EnsembleSampler(
        NW, NDIM, _rj_like, pr, nleaves_max=2, nleaves_min=0, rj_moves=True,
        fill_zero_leaves_val=-100.0, seed=25, device="cpu",
        backend=DeviceBackend())
    g = torch.Generator().manual_seed(25)
    coords = pr.rvs(size=(1, NW, 2), generator=g)
    inds = torch.rand((1, NW, 2), generator=g) < 0.5
    s.run_mcmc(et.State({"model_0": coords}, inds={"model_0": inds}), NSTEPS)
    pc = PlotContainer(fp="rj", backend=s.backend, plot_dir=str(tmp_path),
                       info_keys={"model_0": ["alpha", "beta"]},
                       which_plots=("base", "rj"))
    pc.produce_plots()
    produced = os.listdir(tmp_path)
    assert "rj_leaves_model_0.png" in produced
    assert "rj_leaves_evolution_model_0.png" in produced
    assert pc._labels("model_0", 2) == ["alpha", "beta"]


@pytest.mark.parametrize("spelling", ["bare_string", "reference_kwargs"])
def test_plot_container_keyword_spellings(spelling, tmp_path):
    """``which_plots="base"`` selects the group (not its characters), and
    Eryn's spellings ``plots=``, ``parent_folder=`` with ``branches=``,
    ``truths=`` and ``overlay_covariance=``."""
    s, _ = _port_run(Backend() if spelling == "bare_string"
                     else DeviceBackend(), ntemps=1, nsteps=15, seed=81)
    if spelling == "bare_string":
        pc = PlotContainer(fp="bare", backend=s.backend,
                           plot_dir=str(tmp_path), which_plots="base",
                           corner_kwargs={"bins": 10})
    else:
        pc = PlotContainer(fp="bare", backend=s.backend, plots="base",
                           parent_folder=str(tmp_path), branches=["model_0"],
                           truths={"model_0": np.zeros(2)},
                           overlay_covariance={"model_0": np.eye(2)})
    assert pc.plot_dir == str(tmp_path) and pc.which_plots == "base"
    pc.produce_plots()
    assert sorted(os.listdir(tmp_path)) == [
        "bare_corner_model_0.png", "bare_log_like.png",
        "bare_trace_model_0.png"]


def test_module_level_plot_functions(tmp_path):
    """Every module-level plot function of ``eryn_tpu``'s exists on the
    port and renders (``tests/test_utils.py``'s case)."""
    import eryn_tpu.utils.plot as jax_plot

    public = {n for n in jax_plot.__all__}
    assert public == set(P.__all__)
    rng = np.random.default_rng(0)
    nsteps, ntemps, nwalkers, nl, nd = 30, 3, 8, 2, 2
    chain = {"m": rng.standard_normal((nsteps, ntemps, nwalkers, nl, nd))}
    logl = rng.standard_normal((nsteps, ntemps, nwalkers)) - 3
    betas = np.tile(np.logspace(0, -1, ntemps), (nsteps, 1))
    nleaves = {"m": rng.integers(0, nl + 1, (nsteps, ntemps, nwalkers))}
    steps = np.arange(nsteps)

    f = str(tmp_path / "x.png")
    P.cornerplot(chain["m"][:, 0].reshape(-1, nd), truths=np.zeros(nd),
                 overlay_covariance=np.eye(nd), filename=f)
    P.traceplot(chain["m"][:, 0], labels=["a", "b"], truths=np.zeros(nd),
                filename=f)
    P.plot_loglikelihood(logl[:, 0], filename=f)
    P.tempering_ridgeplot(chain["m"], filename=f)
    P.plot_swap_acceptance(np.full(ntemps - 1, 0.3), filename=f)
    P.plot_logl_betas(betas, logl, filename=f)
    P.plot_betas_evolution(betas, filename=f)
    P.plot_leaves(nleaves["m"], 0, nl, filename=f)
    P.plot_leaves_evolution(nleaves["m"][:, 0], filename=f)
    P.plot_acceptance_fraction(
        steps, np.abs(rng.random((nsteps, ntemps, nwalkers))),
        {"mv": np.full(nsteps, 0.3)}, filename=f)
    P.plot_tempered_acceptance_fraction(
        steps, np.abs(rng.random((nsteps, ntemps, nwalkers))), filename=f)
    P.produce_base_plots(chain, logl, parent_folder=str(tmp_path / "base"))
    P.produce_tempering_plots(chain, betas, logl, np.full(ntemps - 1, 0.3),
                              parent_folder=str(tmp_path / "temp"))
    P.produce_advanced_plots(
        steps, np.abs(rng.random((nsteps, ntemps, nwalkers))), {},
        chain=chain, parent_folder=str(tmp_path / "adv"))
    P.produce_rj_plots(nleaves, {"m": 0}, {"m": nl},
                       parent_folder=str(tmp_path / "rj"))
    assert os.path.exists(tmp_path / "base" / "corner_m.png")
    assert os.path.exists(tmp_path / "temp" / "ridgeplot_m.png")
    assert os.path.exists(tmp_path / "adv" / "m" / "act_evolution_30.png")
    assert os.path.exists(tmp_path / "rj" / "leaves_m.png")


def test_reference_namespace_exports():
    from eryn_tpu_torch.ensemble import PlotContainer as from_ensemble
    from eryn_tpu_torch.utils import PlotContainer as from_utils

    assert from_ensemble is from_utils is PlotContainer


# ----------------------------------------------------------------------
# the hook
# ----------------------------------------------------------------------
class RecordingPlots:
    """A plot generator that draws nothing: it records, in a log shared
    with the other hooks, the stored iteration its backend holds at each
    call, and reads what ``PlotContainer``'s base and tempering groups
    read."""

    def __init__(self, log):
        self.log, self.backend = log, None

    def generate_plot_info(self, burn=0, thin=1):
        b = self.backend
        assert (burn, thin) == (0, 1)
        self.log.append(("plot", int(b.iteration)))
        chain = b.get_chain()["model_0"]
        assert chain.shape[0] == b.iteration
        b.get_inds(), b.get_log_like(), b.get_betas()
        b.accepted, b.swaps_accepted


class _Hook:
    def __init__(self, log, name, stop_at=None):
        self.log, self.name, self.stop_at, self.calls = log, name, stop_at, 0

    def __call__(self, i, state, sampler):
        self.calls += 1
        self.log.append((self.name, int(i)))
        return self.calls == self.stop_at


def _jax_sampler(**kw):
    import eryn_tpu
    import jax.numpy as jnp

    pr = eryn_tpu.ProbDistContainer(
        {i: eryn_tpu.uniform_dist(-5.0, 5.0) for i in range(NDIM)})
    s = eryn_tpu.EnsembleSampler(8, NDIM, lambda x: -0.5 * jnp.sum(x * x),
                                 pr, seed=2, **kw)
    return s, np.random.default_rng(1).uniform(-3, 3, (1, 8, NDIM))


def _port_sampler(**kw):
    pr = et.ProbDistContainer({i: et.uniform_dist(-5.0, 5.0) for i in range(NDIM)})
    s = et.EnsembleSampler(8, NDIM, unit_gaussian, pr, seed=2, device="cpu",
                           **kw)
    return s, pr.rvs(size=(1, 8), generator=torch.Generator().manual_seed(1))


# nsteps, thin_by, segment_size, plot_iterations, update_iterations,
# stopping_iterations, the stopping call that returns True
CADENCES = [
    (30, 1, None, 7, -1, -1, None),
    (30, 1, 4, 7, -1, -1, None),
    (12, 3, None, 5, -1, -1, None),
    (24, 2, 5, 6, 4, 9, 2),
]


@pytest.mark.parametrize("case", CADENCES, ids=[str(c) for c in CADENCES])
def test_plot_hook_fires_where_eryn_tpus_fires(case):
    """The plots count stored iterations, the updates count steps; at a
    boundary the plots come before the stopping check and the update."""
    nsteps, thin_by, seg, plot_it, upd, stp, stop_at = case
    logs = {}
    for name, make in (("port", _port_sampler), ("jax", _jax_sampler)):
        log = []
        plots = RecordingPlots(log)
        kw = dict(plot_generator=plots, plot_iterations=plot_it)
        if upd > 0:
            kw.update(update_fn=_Hook(log, "update"), update_iterations=upd)
        if stp > 0:
            kw.update(stopping_fn=_Hook(log, "stop", stop_at),
                      stopping_iterations=stp)
        s, start = make(**kw)
        plots.backend = s.backend
        s.run_mcmc(start, nsteps, thin_by=thin_by, segment_size=seg)
        logs[name] = log
    assert logs["port"] == logs["jax"]
    assert [i for k, i in logs["port"] if k == "plot"]


def _record(sampler):
    last = sampler._previous_state
    return dict(
        chain=sampler.get_chain()["model_0"], log_like=sampler.get_log_like(),
        log_prior=sampler.get_log_prior(), betas=sampler.get_betas(),
        accepted=sampler.backend.accepted,
        swaps=sampler.backend.swaps_accepted,
        time=np.asarray(int(sampler.temperature_control.time)),
        last=last.branches["model_0"].coords.numpy(),
        m_acc=np.stack([m.accepted for m in sampler._all_move_list]),
    )


class _EagerReplay:
    """Stands in for a captured graph on the CPU: a replay runs the body."""

    def __init__(self, graphs, key, ctx):
        self.replay = lambda: graphs._body(key, ctx)


@pytest.mark.parametrize("graphed", [False, True], ids=["eager", "graphed"])
@pytest.mark.parametrize("backend", [Backend, DeviceBackend])
def test_hooked_chain_equals_the_unhooked_one(graphed, backend, monkeypatch):
    """The hook reads the backend and touches no generator: a run with it
    (segments of 5, a host backend flushed before each fire) gives the
    unhooked run's chain, on the graph path too (each replay runs the
    captured body)."""
    from eryn_tpu_torch.ensemble import EnsembleSampler
    from eryn_tpu_torch.graphs import StepGraphs

    records, fired = [], []
    for hooked in (True, False):
        if graphed:
            monkeypatch.setattr(EnsembleSampler, "_graphed", True)
            monkeypatch.setattr(
                StepGraphs, "_capture",
                lambda self, key, ctx: (_EagerReplay(self, key, ctx), ()))
        log = []
        plots = RecordingPlots(log) if hooked else None
        s, start = _port_run(backend(), nsteps=0, plot_generator=plots,
                             plot_iterations=5 if hooked else -1)
        if hooked:
            plots.backend = s.backend
        s.run_mcmc(start, 17, burn=3)
        s.run_mcmc(None, 8, thin_by=2)
        monkeypatch.undo()
        records.append(_record(s))
        fired.append(log)
        if graphed:
            assert s.graph_replays == 3 + 17 + 16 - 1
    # each run counts its own stored iterations: the second fires at its
    # fifth (the backend's 22nd)
    assert fired[0] == [("plot", i) for i in (5, 10, 15, 22)]
    a, b = records
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_default_generator_writes_into_plot_folder(tmp_path):
    s, start = _port_run(None, ntemps=1, nsteps=0, plot_iterations=10,
                         plot_folder=str(tmp_path / "plots"))
    assert isinstance(s.plot_generator, PlotContainer)
    assert s.plot_generator.backend is s.backend
    assert s.plot_generator.which_plots == ("base",)
    s.run_mcmc(start, 10)
    assert sorted(os.listdir(tmp_path / "plots")) == [
        "output_corner_model_0.png", "output_log_like.png",
        "output_trace_model_0.png"]
    tempered, _ = _port_run(None, nsteps=0, plot_iterations=10)
    assert tempered.plot_generator.which_plots == ("base", "tempering", "rj")
    assert tempered.plot_generator.plot_dir == "."
    # no interval, no generator
    assert _port_run(None, nsteps=0)[0].plot_generator is None


def test_pickled_sampler_keeps_its_hook():
    log = []
    plots = RecordingPlots(log)
    s, start = _port_run(Backend(), nsteps=0, plot_generator=plots,
                         plot_iterations=4)
    plots.backend = s.backend
    s.run_mcmc(start, 8)
    clone = pickle.loads(pickle.dumps(s))
    assert clone.plot_iterations == 4
    assert clone.plot_generator.backend is clone.backend
    clone.run_mcmc(None, 8)
    s.run_mcmc(None, 8)
    assert log == [("plot", i) for i in (4, 8, 12, 16)]
    assert clone.plot_generator.log == [("plot", i) for i in (4, 8, 12, 16)]
    np.testing.assert_array_equal(clone.get_chain()["model_0"],
                                  s.get_chain()["model_0"])
    default = pickle.loads(pickle.dumps(_port_run(
        None, nsteps=0, plot_iterations=3)[0]))
    assert default.plot_generator.backend is default.backend


def test_importing_the_port_imports_no_matplotlib():
    code = (
        "import sys\n"
        "import eryn_tpu_torch, eryn_tpu_torch.utils, eryn_tpu_torch.utils.plot\n"
        "import eryn_tpu_torch.ensemble, eryn_tpu_torch.examples\n"
        "from eryn_tpu_torch.utils import PlotContainer\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('matplotlib', 'jax', 'eryn_tpu')]\n"
        "assert not bad, bad\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
