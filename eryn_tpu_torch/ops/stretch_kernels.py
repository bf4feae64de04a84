"""Stretch-move kernels: the proposal and the tempered accept that bracket
the likelihood of each red/blue half.

Port of :mod:`eryn_tpu.ops.stretch_kernels`.  Each function has a plain
PyTorch version (``*_ref``) and a hand-written CUDA kernel
(``csrc/stretch_kernels.cu``).  The wrapper takes the plain version only for
tensors on the CPU; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import math

import torch

from . import _build
from ._checks import SUFFIX, check_cuda_args

__all__ = [
    "stretch_propose",
    "stretch_accept",
    "stretch_propose_ref",
    "stretch_accept_ref",
]


def stretch_propose_ref(s, c, ndim_act, u, a=2.0, log_proposal=False):
    """Plain version of :func:`stretch_propose`."""
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


def stretch_propose(s, c, ndim_act, u, a=2.0, log_proposal=False):
    """z draw, complement pick and affine stretch for one half, in one launch.

    Args:
        s: ``(nt, ns, D)`` coordinates being moved (branches concatenated).
        c: ``(nt, nc, D)`` complement coordinates.
        ndim_act: ``(nt, ns)`` active dimensionality per walker, as float.
        u: ``(2, nt, ns)`` uniforms: the z draw, then the complement pick.
        a: stretch scale.

    Returns:
        ``(q (nt, ns, D), factors (nt, ns))``.
    """
    if s.device.type == "cpu":
        return stretch_propose_ref(s, c, ndim_act, u, a, log_proposal)
    nt, ns, D = s.shape
    nc = c.shape[1]
    check_cuda_args(
        "stretch_propose", s.dtype, s.device,
        s=(s, (nt, ns, D)), c=(c, (nt, nc, D)),
        ndim_act=(ndim_act, (nt, ns)), u=(u, (2, nt, ns)),
    )
    q = torch.empty_like(s)
    fac = torch.empty((nt, ns), dtype=s.dtype, device=s.device)
    fn = _build.function(
        f"eryn_stretch_propose_{SUFFIX[s.dtype]}", "ppppppiiiidip"
    )
    with torch.cuda.device(s.device):
        err = fn(
            s.data_ptr(), c.data_ptr(), ndim_act.data_ptr(), u.data_ptr(),
            q.data_ptr(), fac.data_ptr(), nt, ns, nc, D, float(a),
            int(bool(log_proposal)), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "stretch_propose")
    stretch_propose.launches += 1
    return q, fac


stretch_propose.launches = 0


def stretch_accept_ref(q, s, ll_new, lp_new, ll_old, lp_old, factors, betas, u):
    """Plain version of :func:`stretch_accept`."""
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


def stretch_accept(q, s, ll_new, lp_new, ll_old, lp_old, factors, betas, u):
    """Tempered Metropolis-Hastings accept and merge for one half, in one
    launch.  ``betas`` is ``(nt,)``; every other per-walker input is
    ``(nt, ns)``.

    Returns ``(coords, logl, logp, accepted)``; ``accepted`` is 1.0 or 0.0 in
    the state dtype.
    """
    if q.device.type == "cpu":
        return stretch_accept_ref(
            q, s, ll_new, lp_new, ll_old, lp_old, factors, betas, u
        )
    nt, ns, D = q.shape
    blk = (nt, ns)
    check_cuda_args(
        "stretch_accept", q.dtype, q.device,
        q=(q, (nt, ns, D)), s=(s, (nt, ns, D)),
        ll_new=(ll_new, blk), lp_new=(lp_new, blk),
        ll_old=(ll_old, blk), lp_old=(lp_old, blk),
        factors=(factors, blk), betas=(betas, (nt,)), u=(u, blk),
    )
    coords = torch.empty_like(q)
    ll = torch.empty(blk, dtype=q.dtype, device=q.device)
    lp = torch.empty_like(ll)
    acc = torch.empty_like(ll)
    fn = _build.function(
        f"eryn_stretch_accept_{SUFFIX[q.dtype]}", "pppppppppppppiiip"
    )
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), s.data_ptr(), ll_new.data_ptr(), lp_new.data_ptr(),
            ll_old.data_ptr(), lp_old.data_ptr(), factors.data_ptr(),
            betas.data_ptr(), u.data_ptr(), coords.data_ptr(), ll.data_ptr(),
            lp.data_ptr(), acc.data_ptr(), nt, ns, D,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "stretch_accept")
    stretch_accept.launches += 1
    return coords, ll, lp, acc


stretch_accept.launches = 0
