"""Stretch-move kernels: the proposal and the tempered accept that bracket
the likelihood of each red/blue half.

Port of :mod:`eryn_tpu.ops.stretch_kernels`, redesigned for the card.  The
JAX kernels work on each half as a contiguous block of the permuted
ensemble; here the kernels (``csrc/stretch_kernels.cu``) read the
walker-order state ``(nt, nw, .)`` through the walker permutation ``perm``
(int64), read their uniforms from ``u_all`` ``(2, 3, nt, nw)`` at their
offsets, and merge each half in place into walker-order outputs.  With
``n0 = nw - nw // 2``, half 0 is walkers ``perm[:n0]`` and half 1 walkers
``perm[n0:]``; each half's complement is the other half, in the same order.

Three entries, each with a plain PyTorch version (``*_ref``) of the same
signature: :func:`stretch_propose`, :func:`stretch_accept` and
:func:`stretch_accept_propose` (accept half 0, then propose half 1, in one
launch).  A wrapper takes its plain version only for tensors on the CPU; on
a CUDA tensor it launches the kernel or raises.  :func:`stretch_propose_block`
and :func:`stretch_accept_block` are the JAX kernels' arithmetic on
contiguous half blocks, which the plain versions call between a gather by
``perm`` and a scatter back to walker order.

Groups: each entry has a grouped form (``*_grouped``, plain version
``*_grouped_ref``) over ``G`` independent ensembles, every argument with a
leading group axis (``perm`` ``(G, nw)``, ``u_all`` ``(G, 2, 3, nt, nw)``,
``betas`` ``(G, nt)``, ...), one launch of ``G * nt`` blocks.  Inside
``torch.func.vmap`` the wrappers reach it through the custom ops of
:mod:`~eryn_tpu_torch.ops._grouped`.
"""

from __future__ import annotations

import math

import torch

from . import _build, _grouped
from ._checks import SUFFIX, check_cuda_args

__all__ = [
    "stretch_accept",
    "stretch_accept_block",
    "stretch_accept_grouped",
    "stretch_accept_grouped_ref",
    "stretch_accept_propose",
    "stretch_accept_propose_grouped",
    "stretch_accept_propose_grouped_ref",
    "stretch_accept_propose_ref",
    "stretch_accept_ref",
    "stretch_propose",
    "stretch_propose_block",
    "stretch_propose_grouped",
    "stretch_propose_grouped_ref",
    "stretch_propose_ref",
]


def _half_size(nw, half):
    """Walkers in ``half`` of ``nw``: half 0 takes the odd one."""
    if half not in (0, 1):
        raise ValueError(f"half must be 0 or 1, got {half}.")
    return nw - nw // 2 if half == 0 else nw // 2


def _halves(perm, half):
    """Walkers of ``half`` and of its complement."""
    ns = _half_size(perm.shape[0], half)
    if half == 0:
        return perm[:ns], perm[ns:]
    n0 = perm.shape[0] - ns
    return perm[n0:], perm[:n0]


def _launch(name, x, signature, *args):
    """Launch ``eryn_<name>_<dtype>`` on the current stream of ``x``'s
    device."""
    _build.launch(f"eryn_{name}_{SUFFIX[x.dtype]}", name, x.get_device(),
                  signature, *args)


# ----------------------------------------------------------------------
# block form: the JAX kernels' arithmetic on contiguous half blocks
# ----------------------------------------------------------------------
def stretch_propose_block(s, c, ndim_act, u, a=2.0, log_proposal=False):
    """z draw, complement pick and affine stretch for one contiguous half
    block, as :func:`eryn_tpu.ops.stretch_kernels.stretch_propose` computes
    them.

    Args:
        s: ``(nt, ns, D)`` coordinates being moved (branches concatenated).
        c: ``(nt, nc, D)`` complement coordinates.
        ndim_act: ``(nt, ns)`` active dimensionality per walker, as float.
        u: ``(2, nt, ns)`` uniforms: the z draw, then the complement pick.
        a: stretch scale.

    Returns:
        ``(q (nt, ns, D), factors (nt, ns))``.
    """
    nt, ns, D = s.shape
    nc = c.shape[1]
    u_z, u_pick = u[0], u[1]
    if log_proposal:
        # ptemcee scaling density g(z) ~ 1/z: ln z ~ U[-ln a, ln a]
        zz = torch.exp((2.0 * u_z - 1.0) * math.log(a))
    else:
        b = (a - 1.0) * u_z + 1.0
        zz = b * b / a
    rint = torch.floor(u_pick * nc).long().clamp_(0, nc - 1)
    c_temp = torch.gather(c, 1, rint[:, :, None].expand(nt, ns, D))
    q = c_temp - (c_temp - s) * zz[:, :, None]
    exponent = ndim_act if log_proposal else ndim_act - 1.0
    return q, exponent * torch.log(zz)


def stretch_accept_block(q, s, ll_new, lp_new, ll_old, lp_old, factors, betas,
                         u):
    """Tempered Metropolis-Hastings accept and merge for one contiguous half
    block, as :func:`eryn_tpu.ops.stretch_kernels.stretch_accept` computes
    them.  ``betas`` is ``(nt,)``; every other per-walker input is
    ``(nt, ns)``.

    Returns ``(coords, logl, logp, accepted)``; ``accepted`` is 1.0 or 0.0 in
    the state dtype.
    """
    b = betas[:, None]
    tl_new = ll_new * b
    tl_old = ll_old * b
    # beta == 0 singularity guard (ptemcee): NaN -> -inf
    tl_new = torch.where(torch.isnan(tl_new), -math.inf, tl_new)
    tl_old = torch.where(torch.isnan(tl_old), -math.inf, tl_old)
    lnpdiff = factors + (tl_new + lp_new) - (tl_old + lp_old)
    d = lnpdiff - torch.log(u)
    d = torch.where(torch.isnan(d), -math.inf, d)  # NaN never accepts
    acc = d > 0.0
    return (
        torch.where(acc[:, :, None], q, s),
        torch.where(acc, ll_new, ll_old),
        torch.where(acc, lp_new, lp_old),
        acc.to(q.dtype),
    )


# ----------------------------------------------------------------------
# plain versions of the kernels: gather by perm, block arithmetic, scatter
# ----------------------------------------------------------------------
def stretch_propose_ref(X, C, ndim_act, perm, u_all, half, a=2.0,
                        log_proposal=False):
    """Plain version of :func:`stretch_propose`."""
    p, pc = _halves(perm, half)
    return stretch_propose_block(
        X[:, p], C[:, pc], ndim_act[:, p], u_all[half, :2, :, :p.shape[0]],
        a, log_proposal,
    )


def stretch_accept_ref(q, X, ll_new, lp_new, logl, logp, factors, betas,
                       perm, u_all, half, X_out, logl_out, logp_out, acc_out):
    """Plain version of :func:`stretch_accept`."""
    p, _ = _halves(perm, half)
    coords, ll, lp, acc = stretch_accept_block(
        q, X[:, p], ll_new, lp_new, logl[:, p], logp[:, p], factors, betas,
        u_all[half, 2, :, :p.shape[0]],
    )
    X_out[:, p] = coords
    logl_out[:, p] = ll
    logp_out[:, p] = lp
    acc_out[:, p] = acc


def stretch_accept_propose_ref(q, X, ll_new, lp_new, logl, logp, factors,
                               betas, ndim_act, perm, u_all, X_out, logl_out,
                               logp_out, acc_out, a=2.0, log_proposal=False):
    """Plain version of :func:`stretch_accept_propose`."""
    stretch_accept_ref(q, X, ll_new, lp_new, logl, logp, factors, betas, perm,
                       u_all, 0, X_out, logl_out, logp_out, acc_out)
    return stretch_propose_ref(X, X_out, ndim_act, perm, u_all, 1, a,
                               log_proposal)


# ----------------------------------------------------------------------
# kernel wrappers
# ----------------------------------------------------------------------
def stretch_propose(X, C, ndim_act, perm, u_all, half, a=2.0,
                    log_proposal=False):
    """z draw, complement pick and affine stretch for one half, in one
    launch.

    Args:
        X: ``(nt, nw, D)`` walker-order coordinates (branches concatenated);
            the moving walkers' rows are read here.
        C: ``(nt, nw, D)`` walker-order coordinates the complement rows are
            read from: ``X`` for half 0, the merged output of half 0's
            accept for half 1.
        ndim_act: ``(nt, nw)`` active dimensionality per walker, as float.
        perm: ``(nw,)`` int64 walker permutation that splits the halves.
        u_all: ``(2, 3, nt, nw)`` uniforms of the step; this call reads
            ``u_all[half, :2, :, :ns]`` (z draw, complement pick).
        half: 0 or 1.
        a: stretch scale.

    Returns:
        ``(q (nt, ns, D), factors (nt, ns))`` in the half's order.
    """
    if _grouped.batched(X, C, ndim_act, perm, u_all):
        return _stretch_propose_op(X, C, ndim_act, perm, u_all, half,
                                   float(a), bool(log_proposal))
    if X.device.type == "cpu":
        return stretch_propose_ref(X, C, ndim_act, perm, u_all, half, a,
                                   log_proposal)
    return _propose_launch(X[None], C[None], ndim_act[None], perm[None],
                           u_all[None], half, a, log_proposal, squeeze=True)


stretch_propose.launches = 0


def _propose_launch(X, C, ndim_act, perm, u_all, half, a, log_proposal,
                    squeeze=False):
    """One launch of the proposal over the groups of ``X`` ``(G, nt, nw,
    D)``; ``squeeze`` drops the group axis of the results."""
    G, nt, nw, D = X.shape
    ns = _half_size(nw, half)
    check_cuda_args(
        "stretch_propose", X.dtype, X.device,
        X=(X, (G, nt, nw, D)), C=(C, (G, nt, nw, D)),
        ndim_act=(ndim_act, (G, nt, nw)), perm=(perm, (G, nw), torch.int64),
        u_all=(u_all, (G, 2, 3, nt, nw)),
    )
    q = torch.empty((G, nt, ns, D), dtype=X.dtype, device=X.device)
    fac = torch.empty((G, nt, ns), dtype=X.dtype, device=X.device)
    _launch(
        "stretch_propose", X, "pppppppiiiiidip",
        X.data_ptr(), C.data_ptr(), ndim_act.data_ptr(), perm.data_ptr(),
        u_all.data_ptr(), q.data_ptr(), fac.data_ptr(), G, nt, nw, D, half,
        float(a), int(bool(log_proposal)),
    )
    stretch_propose.launches += 1
    return (q[0], fac[0]) if squeeze else (q, fac)


def _check_accept(name, ins, half, outs, **more):
    """Check the inputs and outputs of an accept, each with a leading group
    axis; returns ``(G, nt, nw, D)``."""
    q, X, ll_new, lp_new, logl, logp, factors, betas, perm, u_all = ins
    X_out, logl_out, logp_out, acc_out = outs
    G, nt, nw, D = X.shape
    ns = _half_size(nw, half)
    blk, state = (G, nt, ns), (G, nt, nw)
    check_cuda_args(
        name, X.dtype, X.device,
        q=(q, (G, nt, ns, D)), X=(X, (G, nt, nw, D)), ll_new=(ll_new, blk),
        lp_new=(lp_new, blk), logl=(logl, state), logp=(logp, state),
        factors=(factors, blk), betas=(betas, (G, nt)),
        perm=(perm, (G, nw), torch.int64), u_all=(u_all, (G, 2, 3, nt, nw)),
        X_out=(X_out, (G, nt, nw, D)), logl_out=(logl_out, state),
        logp_out=(logp_out, state), acc_out=(acc_out, state), **more,
    )
    return G, nt, nw, D


def _lift(tensors):
    """A leading group axis of one on each tensor (a view)."""
    return tuple(t[None] for t in tensors)


def stretch_accept(q, X, ll_new, lp_new, logl, logp, factors, betas, perm,
                   u_all, half, X_out, logl_out, logp_out, acc_out):
    """Tempered Metropolis-Hastings accept of one half, merged in place into
    the walker-order outputs, in one launch.

    ``q``, ``ll_new``, ``lp_new`` and ``factors`` are the half's proposal,
    its log-likelihood, log-prior and detailed-balance factors, in the
    half's order (``(nt, ns, D)`` and ``(nt, ns)``); ``X`` ``(nt, nw, D)``,
    ``logl`` and ``logp`` ``(nt, nw)`` the walker-order state before the
    step; ``betas`` ``(nt,)``; the accept uniforms are
    ``u_all[half, 2, :, :ns]``.  Writes the merged rows, log-likelihoods,
    log-priors and accept flags (1.0 or 0.0 in the state dtype) of the
    half's walkers into ``X_out``, ``logl_out``, ``logp_out`` and
    ``acc_out`` (which must not overlap the inputs); the other half's
    entries are left as they are.
    """
    ins = (q, X, ll_new, lp_new, logl, logp, factors, betas, perm, u_all)
    outs = (X_out, logl_out, logp_out, acc_out)
    if _grouped.batched(*ins, *outs):
        for out, new in zip(outs, _stretch_accept_op(*ins, half, *outs)):
            out.copy_(new)
        return
    if X.device.type == "cpu":
        return stretch_accept_ref(*ins, half, *outs)
    _accept_launch(_lift(ins), half, _lift(outs))


stretch_accept.launches = 0


def _accept_launch(ins, half, outs):
    """One launch of the accept over the groups of ``ins`` and ``outs``."""
    G, nt, nw, D = _check_accept("stretch_accept", ins, half, outs)
    _launch(
        "stretch_accept", ins[1], "ppppppppppppppiiiiip",
        *(t.data_ptr() for t in ins + outs), G, nt, nw, D, half,
    )
    stretch_accept.launches += 1


def stretch_accept_propose(q, X, ll_new, lp_new, logl, logp, factors, betas,
                           ndim_act, perm, u_all, X_out, logl_out, logp_out,
                           acc_out, a=2.0, log_proposal=False):
    """:func:`stretch_accept` of half 0, then :func:`stretch_propose` of
    half 1 from the merged rows, in one launch (one block per temperature,
    a block barrier between the two).

    Arguments as for the two; returns half 1's ``(q, factors)``.
    """
    ins = (q, X, ll_new, lp_new, logl, logp, factors, betas, perm, u_all)
    outs = (X_out, logl_out, logp_out, acc_out)
    if _grouped.batched(*ins, ndim_act, *outs):
        *new, q1, fac1 = _stretch_accept_propose_op(
            *ins, ndim_act, *outs, float(a), bool(log_proposal))
        for out, x in zip(outs, new):
            out.copy_(x)
        return q1, fac1
    if X.device.type == "cpu":
        return stretch_accept_propose_ref(
            *ins[:8], ndim_act, perm, u_all, *outs, a, log_proposal,
        )
    q1, fac1 = _accept_propose_launch(_lift(ins), ndim_act[None],
                                      _lift(outs), a, log_proposal)
    return q1[0], fac1[0]


stretch_accept_propose.launches = 0


def _accept_propose_launch(ins, ndim_act, outs, a, log_proposal):
    """One launch of the fused accept and proposal over the groups."""
    G, nt, nw, D = ins[1].shape
    _check_accept("stretch_accept_propose", ins, 0, outs,
                  ndim_act=(ndim_act, (G, nt, nw)))
    X = ins[1]
    q1 = torch.empty((G, nt, nw // 2, D), dtype=X.dtype, device=X.device)
    fac1 = torch.empty((G, nt, nw // 2), dtype=X.dtype, device=X.device)
    _launch(
        "stretch_accept_propose", X, "pppppppppppppppppiiiidip",
        *(t.data_ptr() for t in (*ins[:8], ndim_act, *ins[8:], *outs, q1,
                                 fac1)),
        G, nt, nw, D, float(a), int(bool(log_proposal)),
    )
    stretch_accept_propose.launches += 1
    return q1, fac1


# ----------------------------------------------------------------------
# grouped entries: G ensembles in one launch, every argument with a
# leading group axis
# ----------------------------------------------------------------------
def stretch_propose_grouped_ref(X, C, ndim_act, perm, u_all, half, a=2.0,
                                log_proposal=False):
    """Plain version of :func:`stretch_propose_grouped`: the plain version
    of each group in turn."""
    parts = [stretch_propose_ref(X[g], C[g], ndim_act[g], perm[g], u_all[g],
                                 half, a, log_proposal)
             for g in range(X.shape[0])]
    return (torch.stack([p[0] for p in parts]),
            torch.stack([p[1] for p in parts]))


def stretch_propose_grouped(X, C, ndim_act, perm, u_all, half, a=2.0,
                            log_proposal=False):
    """:func:`stretch_propose` of ``G`` groups in one launch: ``X``, ``C``
    ``(G, nt, nw, D)``, ``ndim_act`` ``(G, nt, nw)``, ``perm`` ``(G, nw)``,
    ``u_all`` ``(G, 2, 3, nt, nw)``; returns ``(q (G, nt, ns, D), factors
    (G, nt, ns))``.  CPU tensors take the plain version."""
    if X.device.type == "cpu":
        return stretch_propose_grouped_ref(X, C, ndim_act, perm, u_all, half,
                                           a, log_proposal)
    return _propose_launch(X, C, ndim_act, perm, u_all, half, a, log_proposal)


def stretch_accept_grouped_ref(q, X, ll_new, lp_new, logl, logp, factors,
                               betas, perm, u_all, half, X_out, logl_out,
                               logp_out, acc_out):
    """Plain version of :func:`stretch_accept_grouped`."""
    for g in range(X.shape[0]):
        stretch_accept_ref(q[g], X[g], ll_new[g], lp_new[g], logl[g], logp[g],
                           factors[g], betas[g], perm[g], u_all[g], half,
                           X_out[g], logl_out[g], logp_out[g], acc_out[g])


def stretch_accept_grouped(q, X, ll_new, lp_new, logl, logp, factors, betas,
                           perm, u_all, half, X_out, logl_out, logp_out,
                           acc_out):
    """:func:`stretch_accept` of ``G`` groups in one launch, every argument
    with a leading group axis (``betas`` ``(G, nt)``)."""
    ins = (q, X, ll_new, lp_new, logl, logp, factors, betas, perm, u_all)
    outs = (X_out, logl_out, logp_out, acc_out)
    if X.device.type == "cpu":
        return stretch_accept_grouped_ref(*ins, half, *outs)
    _accept_launch(ins, half, outs)


def stretch_accept_propose_grouped_ref(q, X, ll_new, lp_new, logl, logp,
                                       factors, betas, ndim_act, perm, u_all,
                                       X_out, logl_out, logp_out, acc_out,
                                       a=2.0, log_proposal=False):
    """Plain version of :func:`stretch_accept_propose_grouped`."""
    stretch_accept_grouped_ref(q, X, ll_new, lp_new, logl, logp, factors,
                               betas, perm, u_all, 0, X_out, logl_out,
                               logp_out, acc_out)
    return stretch_propose_grouped_ref(X, X_out, ndim_act, perm, u_all, 1, a,
                                       log_proposal)


def stretch_accept_propose_grouped(q, X, ll_new, lp_new, logl, logp, factors,
                                   betas, ndim_act, perm, u_all, X_out,
                                   logl_out, logp_out, acc_out, a=2.0,
                                   log_proposal=False):
    """:func:`stretch_accept_propose` of ``G`` groups in one launch, every
    argument with a leading group axis; returns half 1's ``(q, factors)``
    ``(G, nt, nw // 2, D)`` and ``(G, nt, nw // 2)``."""
    ins = (q, X, ll_new, lp_new, logl, logp, factors, betas, perm, u_all)
    outs = (X_out, logl_out, logp_out, acc_out)
    if X.device.type == "cpu":
        return stretch_accept_propose_grouped_ref(
            *ins[:8], ndim_act, perm, u_all, *outs, a, log_proposal)
    return _accept_propose_launch(ins, ndim_act, outs, a, log_proposal)


# ----------------------------------------------------------------------
# the custom ops the wrappers call inside torch.func.vmap
# ----------------------------------------------------------------------
Tensor = torch.Tensor


@torch.library.custom_op("eryn_tpu_torch::stretch_propose", mutates_args=())
def _stretch_propose_op(X: Tensor, C: Tensor, ndim_act: Tensor, perm: Tensor,
                        u_all: Tensor, half: int, a: float,
                        log_proposal: bool) -> tuple[Tensor, Tensor]:
    return stretch_propose(X, C, ndim_act, perm, u_all, half, a,
                           log_proposal)


@_stretch_propose_op.register_vmap
def _(info, in_dims, X, C, ndim_act, perm, u_all, half, a, log_proposal):
    args = [_grouped.leading(info, x, d)
            for x, d in zip((X, C, ndim_act, perm, u_all), in_dims)]
    return stretch_propose_grouped(*args, half, a, log_proposal), (0, 0)


@torch.library.custom_op("eryn_tpu_torch::stretch_accept", mutates_args=())
def _stretch_accept_op(
        q: Tensor, X: Tensor, ll_new: Tensor, lp_new: Tensor, logl: Tensor,
        logp: Tensor, factors: Tensor, betas: Tensor, perm: Tensor,
        u_all: Tensor, half: int, X_out: Tensor, logl_out: Tensor,
        logp_out: Tensor, acc_out: Tensor,
) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    outs = tuple(t.clone() for t in (X_out, logl_out, logp_out, acc_out))
    stretch_accept(q, X, ll_new, lp_new, logl, logp, factors, betas, perm,
                   u_all, half, *outs)
    return outs


@_stretch_accept_op.register_vmap
def _(info, in_dims, q, X, ll_new, lp_new, logl, logp, factors, betas, perm,
      u_all, half, X_out, logl_out, logp_out, acc_out):
    ins = [_grouped.leading(info, x, d) for x, d in zip(
        (q, X, ll_new, lp_new, logl, logp, factors, betas, perm, u_all),
        in_dims[:10])]
    outs = [_grouped.leading(info, x, d).clone() for x, d in zip(
        (X_out, logl_out, logp_out, acc_out), in_dims[11:])]
    stretch_accept_grouped(*ins, half, *outs)
    return tuple(outs), (0, 0, 0, 0)


@torch.library.custom_op("eryn_tpu_torch::stretch_accept_propose",
                         mutates_args=())
def _stretch_accept_propose_op(
        q: Tensor, X: Tensor, ll_new: Tensor, lp_new: Tensor, logl: Tensor,
        logp: Tensor, factors: Tensor, betas: Tensor, perm: Tensor,
        u_all: Tensor, ndim_act: Tensor, X_out: Tensor, logl_out: Tensor,
        logp_out: Tensor, acc_out: Tensor, a: float, log_proposal: bool,
) -> tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
    outs = tuple(t.clone() for t in (X_out, logl_out, logp_out, acc_out))
    return (*outs, *stretch_accept_propose(
        q, X, ll_new, lp_new, logl, logp, factors, betas, ndim_act, perm,
        u_all, *outs, a, log_proposal))


@_stretch_accept_propose_op.register_vmap
def _(info, in_dims, q, X, ll_new, lp_new, logl, logp, factors, betas, perm,
      u_all, ndim_act, X_out, logl_out, logp_out, acc_out, a, log_proposal):
    ins = [_grouped.leading(info, x, d) for x, d in zip(
        (q, X, ll_new, lp_new, logl, logp, factors, betas, perm, u_all,
         ndim_act), in_dims[:11])]
    outs = [_grouped.leading(info, x, d).clone() for x, d in zip(
        (X_out, logl_out, logp_out, acc_out), in_dims[11:15])]
    q1, fac1 = stretch_accept_propose_grouped(
        *ins[:8], ins[10], ins[8], ins[9], *outs, a, log_proposal)
    return (*outs, q1, fac1), (0,) * 6
