"""Parallel-tempering swap cascade as one kernel launch.

Port of :mod:`eryn_tpu.ops.pt_swap`.  The cascade is sequential over the
``ntemps - 1`` rungs; rung ``i`` walker ``w`` pairs with rung ``i - 1`` walker
``(w + shift_i) mod nwalkers``.  Combined with a fresh uniform relabelling of
the walker axis per cascade (applied by the caller), each rung's pairing is a
uniformly relabelled random rotation: a state-independent bijection, so the
Metropolis swap stays valid.

The CUDA kernel (``csrc/pt_swap.cu``) rotates modulo ``nwalkers`` at every
ensemble size.  The JAX package switches above 640 walkers to a variant that
pads the walker axis to 128 lanes and skips pairs whose partner lands on a
pad lane; the port proposes every pairing instead, so its swap decisions
above 640 walkers match the JAX package only statistically.
"""

from __future__ import annotations

import torch

from . import _build
from ._checks import SUFFIX, check_cuda_args

__all__ = [
    "pt_swap_cascade",
    "pt_swap_cascade_multi",
    "pt_swap_cascade_multi_ref",
]


def _check_provenance_capacity(ntemps, nwalkers):
    # provenance indices ride a float32 channel and are exact only up to
    # 2^24; beyond that the final gather would silently corrupt the ensemble
    if ntemps * nwalkers >= 2**24:
        raise ValueError(
            f"pt_swap cascade provenance is carried in float32 and supports "
            f"at most 2**24 - 1 ensemble slots; got ntemps*nwalkers = "
            f"{ntemps * nwalkers}."
        )


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
    """
    if logl.device.type == "cpu":
        return pt_swap_cascade_multi_ref(logl, channels, dbetas, shifts, raccept)
    ntemps, nwalkers = logl.shape
    D = channels.shape[1]
    check_cuda_args(
        "pt_swap_cascade_multi", logl.dtype, logl.device,
        logl=(logl, (ntemps, nwalkers)),
        channels=(channels, (ntemps, D, nwalkers)),
        dbetas=(dbetas, (ntemps - 1,)), i_shifts=(shifts, (ntemps - 1,)),
        raccept=(raccept, (ntemps - 1, nwalkers)),
    )
    out_l = torch.empty_like(logl)
    out_c = torch.empty_like(channels)
    sel = torch.empty_like(raccept)
    fn = _build.function(
        f"eryn_pt_swap_cascade_{SUFFIX[logl.dtype]}", "ppppppppiiip"
    )
    with torch.cuda.device(logl.device):
        err = fn(
            logl.data_ptr(), channels.data_ptr(), dbetas.data_ptr(),
            shifts.data_ptr(), raccept.data_ptr(), out_l.data_ptr(),
            out_c.data_ptr(), sel.data_ptr(), ntemps, nwalkers, D,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "pt_swap_cascade_multi")
    pt_swap_cascade_multi.launches += 1
    return out_l, out_c, sel


pt_swap_cascade_multi.launches = 0


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
