"""The port's HDF5 backend, checkpoint and resume, on the CPU.

A file the port writes has ``eryn_tpu``'s schema: ``eryn_tpu``'s
``HDFBackend`` reads the same values from it, and ``eryn_tpu``'s sampler
resumes it; a file ``eryn_tpu`` writes opens and resumes in the port.  A
port run resumed from its file (by a fresh sampler, or after the process
that wrote it was SIGKILLed inside one ``run_mcmc``) continues the
uninterrupted run digit for digit: the chain, masks, log-likelihoods and
-priors, ladders, cumulative counters, the adaptation clock, the moves'
kernel states and both generators' states are equal with tolerance 0.

Sizes: 3 temperatures x 16 walkers x 3-D unit Gaussian, or 3 x 32 walkers
with up to 3 leaves of 2-D under reversible jump; 20-40 steps.
"""

import os
import signal
import subprocess
import sys
import warnings

import h5py
import numpy as np
import pytest
import torch

import eryn_tpu_torch as et
from eryn_tpu_torch import Backend, HDFBackend, State, TempHDFBackend
from eryn_tpu_torch.interop import kernel_state_to_numpy
from eryn_tpu_torch.moves import (
    CombineMove,
    DelayedRejection,
    GaussianMove,
    GroupStretchMove,
    RedBlueGroupStretchMove,
    StretchMove,
)

torch.set_num_threads(1)

NT, NW, NDIM = 3, 16, 3
RJ_NW, RJ_NDIM, RJ_NLEAVES = 32, 2, 3


def _gauss_ll(x):
    return -0.5 * torch.sum(x * x)


def _rj_ll(c, i):
    return -0.5 * torch.sum(torch.where(i[:, None], c, 0.0) ** 2)


class CountingStretch(StretchMove):
    """A stretch move whose kernel state counts its proposals: a kernel
    state that a resume must carry."""

    def init_kernel_state(self, state):
        return {"n": torch.zeros((), dtype=torch.int64,
                                 device=state.log_like.device)}

    def propose_kernel(self, generator, state, time, ctx, kernel_state=()):
        state, acc, swaps, time, _ = super().propose_kernel(
            generator, state, time, ctx, ())
        return state, acc, swaps, time, {"n": kernel_state["n"] + 1}


def _moves(kind):
    if kind == "two moves":
        return [(StretchMove(), 0.6), (StretchMove(a=1.6), 0.4)]
    if kind == "counting":
        return [CountingStretch()]
    if kind == "group":
        return [GroupStretchMove(n_iter_update=20)]
    if kind == "combine":
        return [CombineMove([
            GroupStretchMove(n_iter_update=20),
            DelayedRejection(GaussianMove({"model_0": 0.5},
                                          mode="sequential"), max_iter=2),
        ])]
    return None


def build(backend=None, kind="gaussian", dtype=torch.float32, seed=3, **kw):
    """A sampler on the CPU and its start: the tempered Gaussian (``kind``
    "gaussian", "two moves" or "counting") or the small RJ configuration."""
    g = torch.Generator().manual_seed(1)
    if kind == "rj":
        pr = et.ProbDistContainer(
            {i: et.uniform_dist(-1.0, 1.0) for i in range(RJ_NDIM)})
        s = et.EnsembleSampler(
            RJ_NW, RJ_NDIM, _rj_ll, pr, nleaves_max=RJ_NLEAVES, rj_moves=True,
            moves=RedBlueGroupStretchMove(live_dangerously=True),
            tempering_kwargs=dict(ntemps=NT), fill_zero_leaves_val=0.0,
            seed=seed, device="cpu", dtype=dtype, backend=backend, **kw)
        coords = pr.rvs(size=(NT, RJ_NW, RJ_NLEAVES), generator=g, dtype=dtype)
        inds = torch.rand((NT, RJ_NW, RJ_NLEAVES), generator=g) < 0.5
        return s, State(coords, inds=inds)
    pr = et.ProbDistContainer({i: et.uniform_dist(-5.0, 5.0) for i in range(NDIM)})
    s = et.EnsembleSampler(
        NW, NDIM, _gauss_ll, pr, moves=_moves(kind),
        tempering_kwargs=dict(ntemps=NT), seed=seed, device="cpu",
        dtype=dtype, backend=backend, **kw)
    return s, pr.rvs(size=(NT, NW), generator=g, dtype=dtype)


def record(s):
    """Everything a stored run leaves, float64 where it is a float."""
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


def assert_same(a, b):
    assert a.keys() == b.keys()
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


# ----------------------------------------------------------------------
# the schema, both ways
# ----------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["gaussian", "rj"])
def test_port_file_reads_the_same_in_eryn_tpu(tmp_path, kind):
    """Every getter of ``eryn_tpu``'s ``HDFBackend`` on a port-written file
    returns what the port's returns, unsorted and repeated reads too."""
    from eryn_tpu.backends import HDFBackend as JaxHDFBackend

    fn = str(tmp_path / "port.h5")
    s, start = build(HDFBackend(fn), kind)
    s.run_mcmc(start, 12, segment_size=5)
    ours, theirs = HDFBackend(fn), JaxHDFBackend(fn)
    assert theirs.iteration == ours.iteration == 12
    for kw in ({}, dict(slice_vals=np.array([7, 1, 1, 3])),
               dict(slice_vals=slice(None, None, -2)), dict(slice_vals=-1),
               dict(discard=2, thin=3, temp_index=0)):
        for name in ("chain", "inds"):
            a, b = ours.get_value(name, **kw), theirs.get_value(name, **kw)
            assert a.keys() == b.keys()
            for n in a:
                np.testing.assert_array_equal(a[n], b[n], err_msg=f"{name} {kw}")
        for name in ("log_like", "log_prior", "betas"):
            np.testing.assert_array_equal(ours.get_value(name, **kw),
                                          theirs.get_value(name, **kw),
                                          err_msg=f"{name} {kw}")
    for name in ("accepted", "swaps_accepted", "rj_accepted"):
        a, b = getattr(ours, name), getattr(theirs, name)
        assert (a is None) == (b is None) == (name == "rj_accepted"
                                               and kind != "rj")
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=name)
    a, b = ours.moves_accepted_fraction, theirs.moves_accepted_fraction
    # h5py lists a group's members in name order
    assert list(a) == list(b) == sorted(s.all_moves)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key])
    assert theirs.key_order == ours.key_order == s.key_order
    assert theirs.move_keys == ours.move_keys == sorted(s.all_moves)
    assert theirs.shape == ours.shape == s.shape
    assert (theirs.get_sampler_clock() == ours.get_sampler_clock()
            == int(s.temperature_control.time))
    last_ours, last_theirs = ours.get_last_sample(), theirs.get_last_sample()
    np.testing.assert_array_equal(
        np.asarray(last_ours.branches["model_0"].coords),
        np.asarray(last_theirs.branches["model_0"].coords))


def test_eryn_tpu_file_resumes_in_the_port(tmp_path):
    """A file ``eryn_tpu`` wrote: the port's sampler takes its last sample
    and clock, draws from its own ``seed=`` (the file's JAX key is not a
    torch state), and continues the file."""
    import eryn_tpu
    import jax.numpy as jnp
    from eryn_tpu.backends import HDFBackend as JaxHDFBackend

    fn = str(tmp_path / "jax.h5")
    priors = eryn_tpu.ProbDistContainer(
        {i: eryn_tpu.uniform_dist(-5.0, 5.0) for i in range(NDIM)})
    jax_sampler = eryn_tpu.EnsembleSampler(
        NW, NDIM, lambda x: -0.5 * jnp.sum(x * x), priors,
        backend=JaxHDFBackend(fn), tempering_kwargs=dict(ntemps=NT), seed=4)
    start = np.random.default_rng(0).uniform(-3, 3, (NT, NW, NDIM))
    jax_sampler.run_mcmc(start, 10)
    clock = int(np.asarray(jax_sampler.temperature_control.time))
    last = jax_sampler.backend.get_last_sample()
    with h5py.File(fn, "r") as f:
        assert "prng_state_key" in f["mcmc"].attrs

    s, _ = build(fn, seed=7)
    assert s.backend.iteration == 10
    assert int(s.temperature_control.time) == clock
    prev = s._previous_state
    for field in ("log_like", "log_prior", "betas"):
        np.testing.assert_array_equal(np.asarray(getattr(prev, field)),
                                      np.asarray(getattr(last, field)))
    np.testing.assert_array_equal(
        np.asarray(prev.branches["model_0"].coords),
        np.asarray(last.branches["model_0"].coords))
    assert torch.equal(s._gen.get_state(),
                       torch.Generator().manual_seed(7).get_state())
    s.run_mcmc(None, 5)
    assert s.backend.iteration == 15
    assert np.isfinite(s.get_log_like()).all()
    assert int(s.temperature_control.time) == clock + 5
    assert JaxHDFBackend(fn).iteration == 15


def test_eryn_tpu_resumes_a_port_file(tmp_path):
    """``eryn_tpu``'s sampler resumes a port-written file: it finds no key
    of its own there (the torch states are under names it does not read)
    and keeps its seed, restores the clock and continues."""
    import eryn_tpu
    import jax.numpy as jnp
    from eryn_tpu.backends import HDFBackend as JaxHDFBackend

    fn = str(tmp_path / "port.h5")
    s, start = build(fn)
    s.run_mcmc(start, 12)
    port_chain = s.get_chain()["model_0"]
    priors = eryn_tpu.ProbDistContainer(
        {i: eryn_tpu.uniform_dist(-5.0, 5.0) for i in range(NDIM)})
    jax_sampler = eryn_tpu.EnsembleSampler(
        NW, NDIM, lambda x: -0.5 * jnp.sum(x * x), priors,
        backend=JaxHDFBackend(fn), tempering_kwargs=dict(ntemps=NT), seed=4)
    assert jax_sampler.backend.iteration == 12
    assert (int(np.asarray(jax_sampler.temperature_control.time))
            == int(s.temperature_control.time))
    jax_sampler.run_mcmc(None, 6)
    assert HDFBackend(fn).iteration == 18
    assert np.isfinite(jax_sampler.get_log_like()).all()
    np.testing.assert_array_equal(jax_sampler.get_chain()["model_0"][:12],
                                  port_chain)


def test_generator_states_are_under_names_of_their_own(tmp_path):
    """The torch states are the datasets ``torch_generator/device`` and
    ``torch_generator/host``; no attribute is ``prng_state_key`` or starts
    with ``random_state_``."""
    fn = str(tmp_path / "names.h5")
    s, start = build(fn, kind="two moves")
    s.run_mcmc(start, 8)
    with h5py.File(fn, "r") as f:
        g = f["mcmc"]
        names = list(g.attrs)
        assert "prng_state_key" not in names
        assert not [n for n in names if n.startswith("random_state")]
        np.testing.assert_array_equal(g["torch_generator/device"][()],
                                      s._gen.get_state().numpy())
        np.testing.assert_array_equal(g["torch_generator/host"][()],
                                      s._host_gen.get_state().numpy())


# ----------------------------------------------------------------------
# resume
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
@pytest.mark.parametrize("kind", ["gaussian", "two moves", "rj", "counting"])
def test_resume_continues_digit_for_digit(tmp_path, dtype, kind):
    """20 stored steps, then 20 more by a fresh sampler (another seed) on
    the same file, against 40 in one run, in segments of 5: equal digit
    for digit.  Two weighted moves draw their schedule from the host
    generator, so this holds only if its state is restored too."""
    fn = str(tmp_path / "resume.h5")
    full, start = build(Backend(), kind, dtype)
    full.run_mcmc(start, 40, segment_size=5)
    first, start = build(HDFBackend(fn), kind, dtype)
    first.run_mcmc(start, 20, segment_size=5)
    del first
    resumed, _ = build(HDFBackend(fn), kind, dtype, seed=99)
    assert resumed.backend.iteration == 20
    resumed.run_mcmc(None, 20, segment_size=5)
    assert_same(record(resumed), record(full))
    if kind == "counting":
        assert int(resumed._kernel_states[0]["n"]) == 40
        assert int(full._kernel_states[0]["n"]) == 40


def test_resume_from_an_in_memory_backend():
    """A fresh sampler given another's ``Backend()`` continues it as it
    would a file."""
    full, start = build(Backend(), "two moves")
    full.run_mcmc(start, 30, segment_size=10)
    store = Backend()
    first, start = build(store, "two moves")
    first.run_mcmc(start, 10, segment_size=10)
    del first
    resumed, _ = build(store, "two moves", seed=5)
    resumed.run_mcmc(None, 20, segment_size=10)
    assert_same(record(resumed), record(full))


def _killed_child(fn, half):
    """Run 40 steps into ``fn`` in segments of 10, SIGKILLed from the
    ``update_fn`` at the first boundary at or past ``half``."""

    def update(i, state, sampler):
        if i >= half:
            os.kill(os.getpid(), signal.SIGKILL)

    s, start = build(fn, "counting", update_fn=update, update_iterations=10)
    s.run_mcmc(start, 40, segment_size=10)


def test_sigkill_inside_one_run_resumes_from_the_last_segment(tmp_path):
    """A child process runs one ``run_mcmc`` of 40 steps into a file and is
    SIGKILLed at step 20.  The file's checkpoint is that of step 20 (the
    clock and the counting move's kernel state agree with a run of 20
    steps), and a fresh sampler on it finishes the 40 steps digit for
    digit as the uninterrupted run does."""
    fn = str(tmp_path / "killed.h5")
    code = (
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('m', {__file__!r})\n"
        "m = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(m)\n"
        f"m._killed_child({fn!r}, 20)\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    child = subprocess.run([sys.executable, "-c", code], env=env,
                           capture_output=True, text=True, timeout=300)
    assert child.returncode == -signal.SIGKILL, child.stderr[-3000:]

    half, start = build(Backend(), "counting")
    half.run_mcmc(start, 20, segment_size=10)
    stored = HDFBackend(fn)
    assert stored.iteration == 20
    assert stored.get_sampler_clock() == int(half.temperature_control.time)
    keys, leaves = stored.get_kernel_states()
    assert keys == ["CountingStretch_0"] and int(leaves[0][0]) == 20

    full, start = build(Backend(), "counting")
    full.run_mcmc(start, 40, segment_size=10)
    resumed, _ = build(fn, "counting", seed=11)
    assert int(resumed.temperature_control.time) == int(
        half.temperature_control.time)
    resumed.run_mcmc(None, 20, segment_size=10)
    assert int(resumed._kernel_states[0]["n"]) == 40
    assert_same(record(resumed), record(full))


def test_combine_resumes_mid_window_digit_for_digit(tmp_path):
    """``CombineMove([GroupStretchMove(n_iter_update=20),
    DelayedRejection(GaussianMove(mode="sequential"))])``: 30 stored steps,
    in the middle of the second friends window, then 20 more by a fresh
    sampler on the file, against 50 in one run.  The friends table, the
    window's snapshot, both counters and the per-child accept counts are
    restored, so the chain continues digit for digit."""
    fn = str(tmp_path / "combine.h5")
    full, start = build(Backend(), "combine")
    full.run_mcmc(start, 50, segment_size=10)
    first, start = build(HDFBackend(fn), "combine")
    first.run_mcmc(start, 30, segment_size=10)
    (group_ks, dr_ks), _ = first._kernel_states[0]
    # the sequential counter: three candidates a step, NDIM dimensions
    assert int(group_ks["iter"]) == 30
    assert int(dr_ks["model_0"]) == (30 * 3) % NDIM
    del first
    resumed, _ = build(HDFBackend(fn), "combine", seed=99)
    resumed.run_mcmc(None, 20, segment_size=10)
    assert_same(record(resumed), record(full))
    for a, b in zip(kernel_state_to_numpy(resumed._kernel_states),
                    kernel_state_to_numpy(full._kernel_states)):
        np.testing.assert_array_equal(a, b)
    assert int(resumed._kernel_states[0][0][0]["iter"]) == 50


def _jax_sampler(fn, kind):
    import eryn_tpu
    import eryn_tpu.moves as jm
    import jax.numpy as jnp
    from eryn_tpu.backends import HDFBackend as JaxHDFBackend

    group = jm.GroupStretchMove(n_iter_update=20)
    move = group if kind == "group" else jm.CombineMove([
        group, jm.DelayedRejection(
            jm.GaussianMove({"model_0": 0.5}, mode="sequential"), max_iter=2)])
    priors = eryn_tpu.ProbDistContainer(
        {i: eryn_tpu.uniform_dist(-5.0, 5.0) for i in range(NDIM)})
    return eryn_tpu.EnsembleSampler(
        NW, NDIM, lambda x: -0.5 * jnp.sum(x * x), priors, moves=[move],
        backend=JaxHDFBackend(fn), tempering_kwargs=dict(ntemps=NT), seed=4)


def _group_iter(kernel_state, kind):
    ks = kernel_state if kind == "group" else kernel_state[0][0]
    return int(np.asarray(ks["iter"]))


@pytest.mark.parametrize("kind", ["group", "combine"])
def test_group_kernel_state_crosses_from_eryn_tpu(tmp_path, kind):
    """A file eryn_tpu wrote with a group-stretch move: the port restores
    its kernel state leaf for leaf and continues the window's counter."""
    from eryn_tpu.backends import HDFBackend as JaxHDFBackend

    fn = str(tmp_path / "jax.h5")
    js = _jax_sampler(fn, kind)
    js.run_mcmc(np.random.default_rng(0).uniform(-3, 3, (NT, NW, NDIM)), 12)
    _, stored = JaxHDFBackend(fn).get_kernel_states()
    s, _ = build(fn, kind, seed=7)
    s._ensure_kernel_states(s._setup_state(None))
    ours = kernel_state_to_numpy(s._kernel_states)
    assert len(ours) == len(stored[0])
    for a, b in zip(ours, stored[0]):
        np.testing.assert_array_equal(a, np.asarray(b).astype(a.dtype))
    assert _group_iter(s._kernel_states[0], kind) == 12
    s.run_mcmc(None, 5)
    assert _group_iter(s._kernel_states[0], kind) == 17
    assert np.isfinite(s.get_log_like()).all()


@pytest.mark.parametrize("kind", ["group", "combine"])
def test_eryn_tpu_resumes_a_group_kernel_state(tmp_path, kind):
    """The reverse: eryn_tpu resumes a port file and its group-stretch
    kernel state (its window counter continues from the port's)."""
    fn = str(tmp_path / "port.h5")
    s, start = build(fn, kind)
    s.run_mcmc(start, 12)
    port_chain = s.get_chain()["model_0"]
    js = _jax_sampler(fn, kind)
    js.run_mcmc(None, 6)
    assert _group_iter(js._kernel_states[0], kind) == 18
    assert HDFBackend(fn).iteration == 18
    np.testing.assert_array_equal(js.get_chain()["model_0"][:12], port_chain)


def test_mismatched_resume_raises(tmp_path):
    """The three checks of a backend that holds a chain: the tracked moves,
    the priors' key order and the shape."""
    fn = str(tmp_path / "check.h5")
    s, start = build(fn)
    s.run_mcmc(start, 4)
    with pytest.raises(ValueError, match="Configuration of moves has changed"):
        build(fn, kind="two moves")
    build(fn, kind="two moves", track_moves=False)  # not checked then
    with pytest.raises(ValueError, match="incompatible with sampler shape"):
        et.EnsembleSampler(
            2 * NW, NDIM, _gauss_ll,
            et.ProbDistContainer({i: et.uniform_dist(-5.0, 5.0)
                                  for i in range(NDIM)}),
            tempering_kwargs=dict(ntemps=NT), device="cpu", backend=fn)

    named = str(tmp_path / "named.h5")

    def named_sampler(keys):
        pr = et.ProbDistContainer({k: et.uniform_dist(-5.0, 5.0) for k in keys})
        return et.EnsembleSampler(NW, NDIM, _gauss_ll, pr, device="cpu",
                                  backend=named), pr

    s, pr = named_sampler(["a", "b", "c"])
    s.run_mcmc(pr.rvs(size=(NW,), generator=torch.Generator().manual_seed(0)),
               4)
    assert HDFBackend(named).key_order == {"model_0": ["a", "b", "c"]}
    with pytest.raises(ValueError, match="key order from priors does not match"):
        named_sampler(["b", "a", "c"])
    assert named_sampler(["a", "b", "c"])[0].backend.iteration == 4


def test_changed_kernel_states_warn_and_start_fresh(tmp_path):
    """Stored kernel states of other moves (moves untracked, so the
    constructor does not refuse) are not restored: a warning, then fresh
    states."""
    fn = str(tmp_path / "ks.h5")
    s, start = build(fn, "counting", track_moves=False)
    s.run_mcmc(start, 6)
    resumed, _ = build(fn, "gaussian", track_moves=False)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        resumed.run_mcmc(None, 2)
    assert any("move keys changed" in str(w.message) for w in caught)


def test_temp_hdf_backend():
    with TempHDFBackend() as backend:
        s, start = build(backend)
        s.run_mcmc(start, 6)
        assert backend.iteration == 6
        fn = backend.filename
        assert os.path.exists(fn)
    assert not os.path.exists(fn)


def test_without_h5py_the_backend_raises(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        HDFBackend(str(tmp_path / "x.h5"))
