"""Masked-uniform selection: the complement pick of the group-stretch move.

Port of :func:`eryn_tpu.ops.select_kernels.onehot_select`.  For every query
``k`` the result is the payload row of the ``(k + 1)``-th active entry: the
row whose running active count ``cs`` equals ``k + 1``.  Inactive rows of
the payload are zero, so a query that finds no such row (an empty active
complement, or ``k = -1``) returns zeros.  The CUDA kernel
(``csrc/select_kernels.cu``) does one binary search per query; the wrapper
takes the plain version only for tensors on the CPU.

The JAX package's ``mask_cumsum`` (a TPU workaround for ``cumsum``) is not
ported: callers use :func:`torch.cumsum`.
"""

from __future__ import annotations

import torch

from . import _build
from ._checks import SUFFIX, check_cuda_args

__all__ = ["onehot_select", "onehot_select_ref"]


def onehot_select_ref(cs, kq, c_clean):
    """Plain version of :func:`onehot_select`: the first index whose count
    reaches ``k + 1`` (``torch.searchsorted``), its row where the count
    equals ``k + 1``, zeros elsewhere."""
    M = cs.shape[1]
    k1 = kq + 1.0
    idx = torch.searchsorted(cs, k1).clamp_(max=M - 1)
    hit = torch.gather(cs, 1, idx) == k1
    rows = torch.gather(
        c_clean, 1, idx[..., None].expand(-1, -1, c_clean.shape[-1])
    )
    return torch.where(hit[..., None], rows, 0.0)


def onehot_select(cs, kq, c_clean):
    """Select, for every query, the payload row of the ``(kq + 1)``-th active
    entry, in one launch.

    Args:
        cs: ``(nt, M)`` non-decreasing running counts of the 0/1 activity
            mask (its ``cumsum``), as floats.
        kq: ``(nt, Q)`` integer-valued query draws.
        c_clean: ``(nt, M, nd)`` payload rows, inactive rows zeroed.

    Returns:
        ``(nt, Q, nd)``: the selected rows, equal to the JAX package's
        one-hot contraction (up to the sign of a zero).
    """
    if cs.device.type == "cpu":
        return onehot_select_ref(cs, kq, c_clean)
    nt, M = cs.shape
    Q = kq.shape[1]
    nd = c_clean.shape[-1]
    check_cuda_args(
        "onehot_select", cs.dtype, cs.device,
        cs=(cs, (nt, M)), kq=(kq, (nt, Q)), c_clean=(c_clean, (nt, M, nd)),
    )
    out = torch.empty((nt, Q, nd), dtype=cs.dtype, device=cs.device)
    _build.launch(
        f"eryn_onehot_select_{SUFFIX[cs.dtype]}", "onehot_select",
        cs.get_device(), "ppppiiiip",
        cs.data_ptr(), kq.data_ptr(), c_clean.data_ptr(), out.data_ptr(),
        nt, M, Q, nd,
    )
    onehot_select.launches += 1
    return out


onehot_select.launches = 0
