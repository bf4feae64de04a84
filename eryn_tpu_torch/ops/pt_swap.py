"""Parallel-tempering swap cascade as one kernel launch.

Port of :mod:`eryn_tpu.ops.pt_swap`.  The cascade is sequential over the
``ntemps - 1`` rungs; rung ``i`` walker ``w`` pairs with rung ``i - 1`` walker
``(w + shift_i) mod nwalkers``.  Combined with a fresh uniform relabelling of
the walker axis per cascade (applied by the caller), each rung's pairing is a
uniformly relabelled random rotation: a state-independent bijection, so the
Metropolis swap stays valid.

Above :data:`ROLLED_THRESHOLD` walkers the cascade is the JAX package's
large-ensemble variant: the rotation runs modulo ``nwpad``, the walker count
rounded up to a multiple of 128, and a walker whose partner index lands at or
beyond ``nwalkers`` skips the rung.  :func:`proposals_per_rung` counts the
pairings each rung actually proposes, which callers divide the accepted
swaps by.  Two CUDA kernels (``csrc/pt_swap.cu``) carry the two variants.
"""

from __future__ import annotations

import torch

from . import _build
from ._checks import SUFFIX, check_cuda_args

__all__ = [
    "ROLLED_THRESHOLD",
    "proposals_per_rung",
    "pt_swap_cascade",
    "pt_swap_cascade_multi",
    "pt_swap_cascade_multi_ref",
    "pt_swap_cascade_rolled",
]

#: above this walker count the cascade rotates modulo the 128-padded width
#: (:func:`_cascade_multi_rolled`), as the JAX package does
ROLLED_THRESHOLD = 640


def _padded_width(nwalkers):
    return -(-nwalkers // 128) * 128


def _check_provenance_capacity(ntemps, nwalkers):
    # provenance indices ride a float32 channel and are exact only up to
    # 2^24; beyond that the final gather would silently corrupt the ensemble
    if ntemps * nwalkers >= 2**24:
        raise ValueError(
            f"pt_swap cascade provenance is carried in float32 and supports "
            f"at most 2**24 - 1 ensemble slots; got ntemps*nwalkers = "
            f"{ntemps * nwalkers}."
        )


def proposals_per_rung(nwalkers, shifts, dtype):
    """Pairings each rung proposes: the int ``nwalkers`` up to
    :data:`ROLLED_THRESHOLD` (no device op), beyond it a ``(ntemps - 1,)``
    tensor in ``dtype`` on the device of ``shifts`` counting the walkers
    whose partner ``(w + s) mod nwpad`` is a real walker (at least
    ``nwalkers - 127``)."""
    if nwalkers <= ROLLED_THRESHOLD:
        return nwalkers
    w = torch.arange(nwalkers, device=shifts.device)
    partner = (w[None, :] + shifts[:, None].long()) % _padded_width(nwalkers)
    return (partner < nwalkers).sum(dim=-1).to(dtype)


def pt_swap_cascade_multi_ref(logl, channels, dbetas, shifts, raccept):
    """Plain version of :func:`pt_swap_cascade_multi`."""
    ntemps, nwalkers = logl.shape
    out_l = logl.clone()
    out_c = channels.clone()
    w = torch.arange(nwalkers, device=logl.device)
    sels = []
    for i in range(ntemps - 1, 0, -1):
        partner = (w + shifts[i - 1].long()) % nwalkers
        # copies: row i is overwritten before row i-1 is written from it
        a = out_l[i].clone()
        b = out_l[i - 1, partner]
        sel = dbetas[i - 1] * (a - b) > raccept[i - 1]
        ci = out_c[i].clone()
        cj = out_c[i - 1][:, partner]
        out_l[i] = torch.where(sel, b, a)
        out_l[i - 1, partner] = torch.where(sel, a, b)
        out_c[i] = torch.where(sel, cj, ci)
        out_c[i - 1][:, partner] = torch.where(sel, ci, cj)
        sels.append(sel)
    if sels:
        sel = torch.stack(sels[::-1]).to(logl.dtype)
    else:
        sel = logl.new_zeros((0, nwalkers))
    return out_l, out_c, sel


def pt_swap_cascade_multi(logl, channels, dbetas, shifts, raccept):
    """Run the full swap cascade in one launch, carrying ``D`` payload
    channels through every rung.

    Args:
        logl: ``(ntemps, nwalkers)`` log-likelihoods.
        channels: ``(ntemps, D, nwalkers)`` payload channels (flattened
            coords, masks, priors), swapped identically to ``logl``.
        dbetas: ``(ntemps - 1,)`` ``betas[i-1] - betas[i]`` per rung.
        shifts: ``(ntemps - 1,)`` int32 rotation offsets in
            ``[0, nwalkers)``.
        raccept: ``(ntemps - 1, nwalkers)`` log-uniform acceptance draws.

    Returns:
        ``(logl, channels, sel)`` with ``sel`` the ``(ntemps - 1, nwalkers)``
        accepted-swap mask (1.0 / 0.0, in rung-``i`` walker order).

    Above :data:`ROLLED_THRESHOLD` walkers this is
    :func:`_cascade_multi_rolled`.
    """
    ntemps, nwalkers = logl.shape
    if nwalkers > ROLLED_THRESHOLD:
        return _cascade_multi_rolled(logl, channels, dbetas, shifts, raccept)
    if logl.device.type == "cpu":
        return pt_swap_cascade_multi_ref(logl, channels, dbetas, shifts, raccept)
    out = _launch("pt_swap_cascade_multi", "eryn_pt_swap_cascade", logl,
                  channels, dbetas, shifts, raccept)
    pt_swap_cascade_multi.launches += 1
    return out


pt_swap_cascade_multi.launches = 0


def _launch(name, symbol, logl, channels, dbetas, shifts, raccept):
    """Check the arguments and launch one of the two cascade kernels."""
    ntemps, nwalkers = logl.shape
    D = channels.shape[1]
    check_cuda_args(
        name, logl.dtype, logl.device,
        logl=(logl, (ntemps, nwalkers)),
        channels=(channels, (ntemps, D, nwalkers)),
        dbetas=(dbetas, (ntemps - 1,)), i_shifts=(shifts, (ntemps - 1,)),
        raccept=(raccept, (ntemps - 1, nwalkers)),
    )
    out_l = torch.empty_like(logl)
    out_c = torch.empty_like(channels)
    sel = torch.empty_like(raccept)
    fn = _build.function(f"{symbol}_{SUFFIX[logl.dtype]}", "ppppppppiiip")
    with torch.cuda.device(logl.device):
        err = fn(
            logl.data_ptr(), channels.data_ptr(), dbetas.data_ptr(),
            shifts.data_ptr(), raccept.data_ptr(), out_l.data_ptr(),
            out_c.data_ptr(), sel.data_ptr(), ntemps, nwalkers, D,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, name)
    return out_l, out_c, sel


def _cascade_multi_rolled_ref(logl, channels, dbetas, shifts, raccept):
    """Plain version of :func:`_cascade_multi_rolled`.

    Rung ``i`` walker ``w`` pairs with rung ``i - 1`` walker ``p = (w + s)
    mod nwpad`` only where ``p < nwalkers``; seen from rung ``i - 1``, walker
    ``v`` is the partner of ``(v - s) mod nwpad``, so both rows are gathers
    and nothing is padded."""
    ntemps, nwalkers = logl.shape
    nwpad = _padded_width(nwalkers)
    out_l = logl.clone()
    out_c = channels.clone()
    w = torch.arange(nwalkers, device=logl.device)
    sels = []
    for i in range(ntemps - 1, 0, -1):
        s = shifts[i - 1].long()
        partner = (w + s) % nwpad
        valid = partner < nwalkers
        p = torch.where(valid, partner, 0)
        source = (w - s) % nwpad  # rung i walker paired with rung i-1 lane w
        back = source < nwalkers
        src = torch.where(back, source, 0)
        a = out_l[i].clone()
        b = out_l[i - 1].clone()
        sel = valid & (dbetas[i - 1] * (a - b[p]) > raccept[i - 1])
        take = back & sel[src]
        ci = out_c[i].clone()
        cj = out_c[i - 1].clone()
        out_l[i] = torch.where(sel, b[p], a)
        out_l[i - 1] = torch.where(take, a[src], b)
        out_c[i] = torch.where(sel, cj[:, p], ci)
        out_c[i - 1] = torch.where(take, ci[:, src], cj)
        sels.append(sel)
    if sels:
        sel = torch.stack(sels[::-1]).to(logl.dtype)
    else:
        sel = logl.new_zeros((0, nwalkers))
    return out_l, out_c, sel


def _cascade_multi_rolled(logl, channels, dbetas, shifts, raccept):
    """The swap cascade for more than :data:`ROLLED_THRESHOLD` walkers: the
    arguments and results of :func:`pt_swap_cascade_multi`, with rotations
    modulo the 128-padded width and pairs whose partner is not a real
    walker skipped (``sel`` 0 there).  One launch of the second cascade
    kernel on CUDA tensors; the plain version on CPU tensors."""
    if logl.device.type == "cpu":
        return _cascade_multi_rolled_ref(logl, channels, dbetas, shifts, raccept)
    out = _launch("_cascade_multi_rolled", "eryn_pt_swap_cascade_rolled", logl,
                  channels, dbetas, shifts, raccept)
    _cascade_multi_rolled.launches += 1
    return out


_cascade_multi_rolled.launches = 0


def pt_swap_cascade(logl, origin, dbetas, shifts, raccept):
    """Provenance-carrying cascade: one channel holding each slot's flat
    origin index; the caller applies the composed permutation with a
    gather."""
    ntemps, nwalkers = logl.shape
    if logl.dtype == torch.float32:  # float64 carries exact integers to 2^53
        _check_provenance_capacity(ntemps, nwalkers)
    logl2, ch, sel = pt_swap_cascade_multi(
        logl, origin[:, None].contiguous(), dbetas, shifts, raccept
    )
    return logl2, ch[:, 0], sel


def pt_swap_cascade_rolled(logl, origin, dbetas, shifts, raccept):
    """Provenance-carrying form of :func:`_cascade_multi_rolled` at any
    walker count."""
    ntemps, nwalkers = logl.shape
    if logl.dtype == torch.float32:
        _check_provenance_capacity(ntemps, nwalkers)
    logl2, ch, sel = _cascade_multi_rolled(
        logl, origin[:, None].contiguous(), dbetas, shifts, raccept
    )
    return logl2, ch[:, 0], sel
