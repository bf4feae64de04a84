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
"""

from __future__ import annotations

import math

import torch

from . import _build
from ._checks import SUFFIX, check_cuda_args

__all__ = [
    "stretch_accept",
    "stretch_accept_block",
    "stretch_accept_propose",
    "stretch_accept_propose_ref",
    "stretch_accept_ref",
    "stretch_propose",
    "stretch_propose_block",
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
    if X.device.type == "cpu":
        return stretch_propose_ref(X, C, ndim_act, perm, u_all, half, a,
                                   log_proposal)
    nt, nw, D = X.shape
    ns = _half_size(nw, half)
    check_cuda_args(
        "stretch_propose", X.dtype, X.device,
        X=(X, (nt, nw, D)), C=(C, (nt, nw, D)), ndim_act=(ndim_act, (nt, nw)),
        perm=(perm, (nw,), torch.int64), u_all=(u_all, (2, 3, nt, nw)),
    )
    q = torch.empty((nt, ns, D), dtype=X.dtype, device=X.device)
    fac = torch.empty((nt, ns), dtype=X.dtype, device=X.device)
    _launch(
        "stretch_propose", X, "pppppppiiiidip",
        X.data_ptr(), C.data_ptr(), ndim_act.data_ptr(), perm.data_ptr(),
        u_all.data_ptr(), q.data_ptr(), fac.data_ptr(), nt, nw, D, half,
        float(a), int(bool(log_proposal)),
    )
    stretch_propose.launches += 1
    return q, fac


stretch_propose.launches = 0


def _check_accept(name, ins, half, outs, **more):
    """Check the inputs and outputs of an accept; returns ``(nt, nw, D)``."""
    q, X, ll_new, lp_new, logl, logp, factors, betas, perm, u_all = ins
    X_out, logl_out, logp_out, acc_out = outs
    nt, nw, D = X.shape
    ns = _half_size(nw, half)
    blk, state = (nt, ns), (nt, nw)
    check_cuda_args(
        name, X.dtype, X.device,
        q=(q, (nt, ns, D)), X=(X, (nt, nw, D)), ll_new=(ll_new, blk),
        lp_new=(lp_new, blk), logl=(logl, state), logp=(logp, state),
        factors=(factors, blk), betas=(betas, (nt,)),
        perm=(perm, (nw,), torch.int64), u_all=(u_all, (2, 3, nt, nw)),
        X_out=(X_out, (nt, nw, D)), logl_out=(logl_out, state),
        logp_out=(logp_out, state), acc_out=(acc_out, state), **more,
    )
    return nt, nw, D


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
    if X.device.type == "cpu":
        return stretch_accept_ref(*ins, half, *outs)
    nt, nw, D = _check_accept("stretch_accept", ins, half, outs)
    _launch(
        "stretch_accept", X, "ppppppppppppppiiiip",
        *(t.data_ptr() for t in ins + outs), nt, nw, D, half,
    )
    stretch_accept.launches += 1


stretch_accept.launches = 0


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
    if X.device.type == "cpu":
        return stretch_accept_propose_ref(
            *ins[:8], ndim_act, perm, u_all, *outs, a, log_proposal,
        )
    nt, nw, D = X.shape
    _check_accept("stretch_accept_propose", ins, 0, outs,
                  ndim_act=(ndim_act, (nt, nw)))
    q1 = torch.empty((nt, nw // 2, D), dtype=X.dtype, device=X.device)
    fac1 = torch.empty((nt, nw // 2), dtype=X.dtype, device=X.device)
    _launch(
        "stretch_accept_propose", X, "pppppppppppppppppiiidip",
        *(t.data_ptr() for t in (*ins[:8], ndim_act, perm, u_all, *outs, q1,
                                 fac1)),
        nt, nw, D, float(a), int(bool(log_proposal)),
    )
    stretch_accept_propose.launches += 1
    return q1, fac1


stretch_accept_propose.launches = 0
