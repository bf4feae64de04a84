"""Faults planted under the timed path, to show that the check sees them.

Each is a ``tamper(sampler)`` for :func:`perfbench.harness.measure`, which
calls it once the sampler is built.  The benchmark's own runs plant none;
``readings.py`` and the tests do.
"""

from __future__ import annotations

import torch


def _wrap_steps(sampler, make):
    for move in sampler._all_move_list:
        move.step_kernel = make(move.step_kernel)


def frozen(sampler):
    """Every move's step returns its state unchanged (its draws and its
    bookkeeping still run)."""
    def make(step):
        def body(generator, state, time, ctx, kernel_state):
            _, acc, swaps, t, ks = step(generator, state, time, ctx,
                                        kernel_state)
            return state, acc, swaps, t, ks
        return body
    _wrap_steps(sampler, make)


def half(sampler):
    """Half of the walkers (the upper half, at every temperature) are left
    out of every move: they keep the state they came in with."""
    from eryn_tpu_torch import State

    def merge(new, old):
        nw = old.log_like.shape[1]
        keep = torch.arange(nw, device=old.log_like.device) >= nw // 2

        def pick(a, b):
            return torch.where(keep.reshape((1, nw) + (1,) * (a.ndim - 2)),
                               b, a)

        out = State(new)
        for n, b in new.branches.items():
            o = old.branches[n]
            out.branches[n] = type(b)(
                pick(b.coords, o.coords), inds=pick(b.inds, o.inds),
                branch_supplemental=b.branch_supplemental)
        out.log_like = pick(new.log_like, old.log_like)
        out.log_prior = pick(new.log_prior, old.log_prior)
        return out

    def make(step):
        def body(generator, state, time, ctx, kernel_state):
            new, acc, swaps, t, ks = step(generator, state, time, ctx,
                                          kernel_state)
            return merge(new, state), acc, swaps, t, ks
        return body
    _wrap_steps(sampler, make)


def altered(sampler):
    """Every log-likelihood is altered where it is produced, by one part in
    ten thousand."""
    fn = sampler._like_eval.fn

    def log_like(*args, **kwargs):
        return fn(*args, **kwargs) * (1.0 + 1e-4)

    sampler._like_eval.fn = log_like


def biased(sampler):
    """Every move accepts without its proposal's factor: the stretch moves'
    ``z^(d-1)``, HMC's change of kinetic energy.  The chain then samples
    another distribution, each stored log-posterior still true to its
    coordinates."""
    def zero_factors(fn, at):
        def body(*args, **kwargs):
            out = list(fn(*args, **kwargs))
            out[at] = torch.zeros_like(out[at])
            return tuple(out)
        return body

    for move in sampler.moves:
        if hasattr(move, "_fused_kernels"):  # the fused stretch kernels
            fused = move._fused_kernels

            def kernels(X, logl, logp, ndim_act, *rest, _fused=fused):
                # the factor is (ndim_act - 1) log z inside the kernels
                return _fused(X, logl, logp, torch.ones_like(ndim_act), *rest)
            move._fused_kernels = kernels
        if hasattr(move, "get_proposal_block"):  # the general red/blue path
            move.get_proposal_block = zero_factors(move.get_proposal_block, 1)
        if hasattr(move, "_accept_and_merge"):  # HMC's accept
            merge = move._accept_and_merge

            def accept(generator, state, names, coords, x1, factors, *rest,
                       _merge=merge):
                return _merge(generator, state, names, coords, x1,
                              torch.zeros_like(factors), *rest)
            move._accept_and_merge = accept


def swap_sign(sampler):
    """Every swap between rungs is decided with the sign of the
    log-likelihood difference turned: the pairs still exchange whole, the
    ladder adapts on the counts."""
    tc = sampler.temperature_control
    swap = tc.swap_kernel

    def swap_kernel(generator, swap_tree, logl, betas, **kwargs):
        tree, neg, accepted, proposed = swap(generator, swap_tree, -logl,
                                             betas, **kwargs)
        return tree, -neg, accepted, proposed
    tc.swap_kernel = swap_kernel


FAULTS = {"frozen": frozen, "half": half, "altered": altered,
          "biased": biased, "swap_sign": swap_sign}
