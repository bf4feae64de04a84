"""The compiled segment: each move's step captured once as a CUDA graph and
replayed.

Counterpart of :mod:`eryn_tpu.ensemble`'s ``_make_one_step`` (one
``lax.switch`` branch per move) and ``_get_bulk_fn`` (the cache of the
compiled ``lax.scan``).  The sampler's state lives in static device buffers
that :class:`StepGraphs` owns; for each move, and for whether it is the
first move of its kind (in-model or reversible jump) in a step, one
``torch.cuda.CUDAGraph`` records the move's proposal with its tempering
epilogue, the accept counters and the copy of the new state back into the
buffers.  The move schedule stays on the host, so a step is one replay per
entry of its schedule row: the graphs grow with the moves, not with the
rows (moves to the power of the repeats).

A host move (Eryn's host protocol, :mod:`~eryn_tpu_torch.moves.legacy`) is
never captured: its slot copies the buffers out, runs the move eagerly and
copies the result back, between the replays of the native moves.

Under a device mesh whose process group is NCCL
(:mod:`~eryn_tpu_torch.parallel.mesh`) the buffers hold the rank's shard,
and each rank captures the sharded step of every move that declares it
planned on the device (:meth:`~eryn_tpu_torch.moves.Move.
mesh_device_planned`: every native move, and users' subclasses), its
collectives on the capturing stream; its first, eager run makes NCCL's
communicators.  Any other move runs eagerly in its slots, on the buffers.
The collectives a graph captured are counted at each replay
(:data:`~eryn_tpu_torch.parallel._comm.CALLS`), as the kernels' launches
are.  A move whose sharded step has a host phase (a tuning move: tuning or
tuned; a group move: a refresh due or not; :meth:`~eryn_tpu_torch.moves.
Move.mesh_clocks`) has a graph per phase: the phase decides only which
exchanges run, every result is decided on the device clock.  The host
keeps a shadow of each such clock (:class:`HostPhases`, which the eager
mesh loop uses too).

A move is captured the second time it is due: its first run is the same
body, eager, which builds the kernels, lets ``torch.func.vmap`` trace the
likelihood and warms the allocator.  Every graph shares one memory pool
and registers the sampler's generator, so each replay draws the numbers the
eager ops would have drawn and advances the generator's offset as they
would.  A capture reads nothing back and replays nothing, so it moves
neither the chain nor the generator.  A capture that fails raises.
"""

from __future__ import annotations

import contextlib
import gc

import torch

from .state import State
from .utils.pytree import tree_flatten

__all__ = ["StepGraphs", "counted_kernels"]


def counted_kernels():
    """The kernel wrappers whose ``launches`` count their launches."""
    from .ops import pt_swap, select_kernels, stretch_kernels as sk

    return (sk.stretch_propose, sk.stretch_accept_propose, sk.stretch_accept,
            pt_swap.pt_swap_cascade_multi, pt_swap._cascade_multi_rolled,
            select_kernels.group_stretch_propose,
            select_kernels.onehot_select)


@contextlib.contextmanager
def fixed_phases(clocks, phase):
    """Within it each move of ``clocks`` (``[(move, clock)]``, :meth:`~
    eryn_tpu_torch.moves.Move.mesh_clocks`) runs its sharded step in its
    entry of ``phase``, reading no clock on the host."""
    for (m, _), p in zip(clocks, phase):
        m._step_phase = p
    try:
        yield
    finally:
        for m, _ in clocks:
            m._step_phase = None


class HostPhases:
    """The host's shadow of the clocks of a sampler's moves whose sharded
    step has a host phase (:meth:`~eryn_tpu_torch.moves.Move.mesh_clocks`),
    for its eager loop and its graphs alike.  A move's clocks are read from
    the device at its first step, and again when its kernel state holds
    other clock tensors than its last step left (a restored or replaced
    kernel state); each step adds one to them."""

    def __init__(self):
        # move index: (the clocks its last step left, their values)
        self.shadows = {}

    def phase(self, j, clocks):
        """The phase of move ``j``'s next step, whose clocks are
        ``clocks``: one entry per clock, ``()`` for none."""
        if not clocks:
            return ()
        tensors = [t for _, t in clocks]
        shadow = self.shadows.get(j)
        if shadow is None or len(shadow[0]) != len(tensors) or any(
                a is not b for a, b in zip(shadow[0], tensors)):
            shadow = self.shadows[j] = (tensors, [int(t) for t in tensors])
        return tuple(m.phase_of(v) for (m, _), v in zip(clocks, shadow[1]))

    def advance(self, j, clocks):
        """After a step of move ``j``: its shadow one step on, ``clocks``
        the clocks its kernel state now holds."""
        shadow = self.shadows.get(j)
        if shadow is not None:
            self.shadows[j] = ([t for _, t in clocks],
                               [v + 1 for v in shadow[1]])


def _assign(dst, src):
    """``dst[...] = src`` unless ``src`` is ``dst`` (a move that leaves a
    field as it is returns it as it was)."""
    if not (src.data_ptr() == dst.data_ptr() and src.shape == dst.shape
            and src.stride() == dst.stride()):
        dst.copy_(src)


def _tensor_leaves(tree):
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _contiguous_copy(x):
    return x.clone(memory_format=torch.contiguous_format)


def _layout(state):
    """What the buffers of ``state`` are: each tensor's path, shape and
    dtype (:meth:`~eryn_tpu_torch.state.State.tensor_leaves`)."""
    return [(path, tuple(x.shape), x.dtype) for path, x in state.tensor_leaves()]


def _assign_state(dst, src):
    """Copy every tensor of the state ``src`` (coordinates, masks, the
    per-walker fields, blobs, the numeric supplemental entries) into the
    state ``dst`` of the same layout."""
    src_leaves = src.tensor_leaves()
    dst_leaves = dst.tensor_leaves()
    if [p for p, _ in src_leaves] != [p for p, _ in dst_leaves]:
        raise RuntimeError(
            "a step changed the layout of the state: "
            f"{[p for p, _ in dst_leaves]} -> {[p for p, _ in src_leaves]}")
    for (_, d), (_, x) in zip(dst_leaves, src_leaves):
        _assign(d, x)


class StepGraphs:
    """Static buffers and one CUDA graph per move of a sampler.

    ``state`` (coordinates and leaf masks per branch, log-likelihood,
    log-prior, ladder, blobs, and the numeric entries of the state and
    branch supplementals), ``clock``, ``accepted``, ``rj_accepted`` (None
    without reversible jump) and ``swaps`` are the buffers a step reads and
    writes; the sampler's ``_m_acc`` and kernel states are written in place.
    """

    def __init__(self, sampler):
        self.sampler = sampler
        # (move index, first of its kind[, phase...]): (graph, counts)
        self.graphs = {}
        self.calls = {}  # the same keys: the collectives a graph captured
        self.replayed = {}  # the same keys: replays so far
        self.eager = {}  # move index: whether its slots run eagerly
        self.warm = set()  # keys whose body has run eagerly once
        self.pool = self.stream = None
        self.state = self.clock = self.layout = None
        self.accepted = self.rj_accepted = self.swaps = None

    def fits(self, state):
        """Whether ``state`` has the layout of the buffers (true before they
        are made)."""
        return self.state is None or _layout(state) == self.layout

    def load(self, state, time):
        """Copy ``state`` and the clock ``time`` into the buffers (made at
        the first call, in the layout of ``state``: see :meth:`fits`);
        returns the buffers' state."""
        if self.state is None:
            self.state = state.map_tensors(_contiguous_copy)
            self.layout = _layout(state)
            self.clock = time.clone()
            logl = self.state.log_like
            ntemps = logl.shape[0]
            self.accepted = torch.zeros_like(logl)
            if self.sampler.has_reversible_jump:
                self.rj_accepted = torch.zeros_like(logl)
            self.swaps = logl.new_zeros((max(ntemps - 1, 0),))
            return self.state
        _assign_state(self.state, state)
        _assign(self.clock, time)
        return self.state

    def export(self):
        """``(state, clock, swaps)``: copies of the buffers, which later
        replays do not touch."""
        return State(self.state, copy=True), self.clock.clone(), self.swaps.clone()

    def step(self, row, ctx):
        """One sampler step: for each move index of the schedule ``row``,
        the replay of its graph, or its capture and replay, or (the first
        time it is due) its body run eagerly."""
        smp = self.sampler
        nin = len(smp.moves)
        kinds = set()
        for j in row:
            j = int(j)
            kind = j < nin
            key = (j, kind not in kinds)
            kinds.add(kind)
            smp._m_nprop[j] += 1
            if smp._host_moves[j]:
                self._host_entry(key)
                continue
            # the clocks are written in place: the same after the step
            clocks = smp._phase_clocks(j)
            key += smp._phases.phase(j, clocks)
            if self._runs_eagerly(j) or key not in self.warm:
                self._body(key, ctx)
                smp._phases.advance(j, clocks)
                self.warm.add(key)
                continue
            entry = self.graphs.get(key)
            if entry is None:
                entry = self.graphs[key] = self._capture(key, ctx)
            graph, counts = entry
            graph.replay()
            smp._phases.advance(j, clocks)
            self.replayed[key] = self.replayed.get(key, 0) + 1
            for kernel, n in counts:
                kernel.launches += n
            calls = self.calls.get(key)
            if calls:
                from .parallel import _comm

                for name, n in calls:
                    _comm.CALLS[name] += n
            smp.graph_replays += 1

    def _runs_eagerly(self, j):
        """Whether native move ``j`` runs eagerly in its slots: under a
        mesh, a move whose sharded step is not planned on the device (a
        composite with a host member)."""
        if j not in self.eager:
            smp = self.sampler
            self.eager[j] = (smp._mesh_layout is not None and not smp.
                             _all_move_list[j].mesh_device_planned(self.state))
        return self.eager[j]

    def _host_entry(self, key):
        """A host move's slot: the buffers' state out, the move run eagerly
        (:meth:`EnsembleSampler._host_step`), its result back in."""
        j, first = key
        smp = self.sampler
        state, clock, _ = self.export()
        state, acc, swaps, clock = smp._host_step(smp._all_move_list[j],
                                                  state, clock)
        self.load(state, clock)
        smp._m_acc[j] += acc
        self._record(j, first, acc, swaps)

    def _record(self, j, first, acc, swaps):
        """The step's accept flags (and, for an in-model move, swaps) into
        their buffers: the first move of its kind sets them, later ones add
        their flags."""
        in_model = j < len(self.sampler.moves)
        out = self.accepted if in_model else self.rj_accepted
        if first:
            out.copy_(acc)
        else:
            out.add_(acc)
        if in_model:
            self.swaps.copy_(swaps)

    def _body(self, key, ctx):
        """What a graph records: the move on the buffers, in the phase of
        ``key`` (:class:`HostPhases`), then the results copied back into
        them."""
        j, first = key[:2]
        smp = self.sampler
        move = smp._all_move_list[j]
        kernel_state = smp._kernel_states[j]
        with fixed_phases(smp._phase_clocks(j), key[2:]):
            state, acc, swaps, time, new_kernel_state = move.step_kernel(
                smp._gen, self.state, self.clock, ctx, kernel_state
            )
        for dst, src in zip(_tensor_leaves(kernel_state),
                            _tensor_leaves(new_kernel_state)):
            _assign(dst, src)
        smp._m_acc[j] += acc
        self._record(j, first, acc, swaps)
        _assign(self.clock, time)
        _assign_state(self.state, state)

    def _capture(self, key, ctx):
        """Capture the body of ``key`` into a graph on a side stream, with
        the generator registered and its state kept; returns ``(graph,
        ((kernel, launches per replay), ...))``, and keeps the collectives
        it captured, ``((name, calls per replay), ...)``, in
        ``self.calls[key]``."""
        from .parallel import _comm

        smp = self.sampler
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(smp.device)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(smp._gen)
        kernels = counted_kernels()
        before = [k.launches for k in kernels]
        calls_before = dict(_comm.CALLS)
        rng = smp._gen.get_state()
        self.stream.wait_stream(torch.cuda.current_stream(smp.device))
        error = None
        # a graph that the garbage collector destroys while this one is
        # captured (another sampler's, left in a reference cycle) frees
        # device memory and so invalidates the capture: collect before,
        # and not during it
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(self.stream):
                graph.capture_begin(pool=self.pool)
                try:
                    self._body(key, ctx)
                except Exception as err:  # re-raised below, once ended
                    error = err
                try:
                    graph.capture_end()
                except RuntimeError as err:
                    error = error or err
        finally:
            if collecting:
                gc.enable()
        smp._gen.set_state(rng)
        # the wrappers counted calls made while capturing: no launch yet
        counts = tuple((k, k.launches - b) for k, b in zip(kernels, before)
                       if k.launches != b)
        for k, b in zip(kernels, before):
            k.launches = b
        self.calls[key] = tuple((name, n - calls_before.get(name, 0))
                                for name, n in _comm.CALLS.items()
                                if n != calls_before.get(name, 0))
        _comm.CALLS.clear()
        _comm.CALLS.update(calls_before)
        if error is not None:
            # PyTorch leaves the failed capture's state in each generator
            # it registered, the device's default one too, and every later
            # draw from them raises: each gets a fresh state at its seed
            # and offset
            index = smp._gen.device.index
            for gen in (smp._gen, torch.cuda.default_generators[
                    torch.cuda.current_device() if index is None else index]):
                gen.graphsafe_set_state(gen.clone_state())
            move = smp._all_move_list[key[0]]
            fn = smp.log_like_fn
            raise RuntimeError(
                f"capturing the step of {type(move).__name__} (move "
                f"{key[0]}) with log_like_fn "
                f"{getattr(fn, '__qualname__', repr(fn))} in a CUDA graph "
                f"failed: {error}. Everything a step runs must stay on the "
                "device (no .item(), no copy from or to the host); "
                "EnsembleSampler(..., cuda_graph=False) runs the eager loop."
            ) from error
        torch.cuda.current_stream(smp.device).wait_stream(self.stream)
        smp.graph_captures += 1
        return graph, counts
