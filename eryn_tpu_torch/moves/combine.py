"""Sequential combination of moves inside one proposal.

Port of :mod:`eryn_tpu.moves.combine`: the children run one after another
in the same step, each with its own tempering epilogue (so a step has one
swap phase per child, and the adaptation clock ticks on each), and their
accept flags are summed.  The combination is one entry of the sampler's
schedule, and on a CUDA device one graph.  It runs on a state sharded over
a device mesh where each of its children does.
"""

from __future__ import annotations

import numpy as np
import torch

from .move import Move

__all__ = ["CombineMove"]


class CombineMove(Move):
    """Run a list of moves in turn in one proposal.

    The kernel state is the tuple of the children's states and a per-child
    accept counter ``(nchildren, ntemps, nwalkers)``;
    :attr:`acceptance_fraction_separate` reads it after a run.
    """

    _mesh_sharded = True

    def __init__(self, moves, **kwargs):
        self.moves_list = list(moves)
        super().__init__(**kwargs)

    @property
    def moves(self):
        """The child moves."""
        return self.moves_list

    @property
    def acceptance_fraction_separate(self):
        """Per-child acceptance fractions: a list of ``(ntemps, nwalkers)``
        arrays, one per child, or None before a run."""
        if self.kernel_state is None or not self.num_proposals:
            return None
        counts = self.kernel_state[1].cpu().numpy().astype(np.float64)
        return [counts[i] / self.num_proposals for i in range(counts.shape[0])]

    def mesh_ready(self):
        """None where the combination and each child run sharded, else the
        first refusal."""
        for why in [super().mesh_ready()] + [m.mesh_ready()
                                             for m in self.moves_list]:
            if why is not None:
                return why
        return None

    def wire_mesh(self, layout):
        super().wire_mesh(layout)
        for m in self.moves_list:
            m.wire_mesh(layout)

    def propagate_wiring(self):
        """Hand the combination's tempering control and periodic container
        to the children that have none."""
        for m in self.moves_list:
            if m.temperature_control is None:
                m.temperature_control = self.temperature_control
            if m.periodic is None:
                m.periodic = self.periodic
            if hasattr(m, "propagate_wiring"):
                m.propagate_wiring()

    def init_kernel_state(self, state):
        self.propagate_wiring()
        # the rank's walkers under a mesh
        ntemps, nwalkers = state.log_like.shape
        per_child = state.log_like.new_zeros(
            (len(self.moves_list), ntemps, nwalkers))
        return (
            tuple(m.init_kernel_state(state) for m in self.moves_list),
            per_child,
        )

    def kernel_state_axes(self, kernel_state):
        child_states, _ = kernel_state
        return [ax for m, ks in zip(self.moves_list, child_states)
                for ax in m.kernel_state_axes(ks)] + [(1, 2)]

    def propose_kernel(self, generator, state, time, ctx, kernel_state=()):
        child_states, per_child = kernel_state
        accs, new_states = [], []
        for m, ks in zip(self.moves_list, child_states):
            state, acc, swaps, time, ks = m.propose_kernel(
                generator, state, time, ctx, ks)
            accs.append(acc)
            new_states.append(ks)
        accepted = accs[0]
        for acc in accs[1:]:
            accepted = accepted + acc
        per_child = per_child + torch.stack(accs)
        return state, accepted, swaps, time, (tuple(new_states), per_child)
