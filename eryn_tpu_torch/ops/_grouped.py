"""The kernels under ``torch.func.vmap``: the group axis of
:class:`~eryn_tpu_torch.parallel.ParaEnsembleSampler`.

A kernel is called through :mod:`ctypes` on raw pointers, which a
``BatchedTensor`` (a tensor inside ``vmap``) does not have.  So each wrapper
that finds a batched argument calls a ``torch.library.custom_op`` of the
kernel instead, whose vmap rule moves the batched dimension to the front
and calls the grouped launch: one launch for every group, every per-group
array with a leading group axis.  The ops return new tensors (a wrapper
whose contract writes into given outputs copies the op's results into
them), and the rule of each op runs the plain grouped version on CPU
tensors, so the CPU runs the same rule the card does.
"""

from __future__ import annotations

import torch

__all__ = ["batched", "leading"]


def batched(*tensors):
    """Whether any of ``tensors`` (tensors, None, or lists of them) is a
    tensor batched by ``torch.func.vmap``."""
    is_batched = torch._C._functorch.is_batchedtensor
    for x in tensors:
        if isinstance(x, (list, tuple)):
            if batched(*x):
                return True
        elif isinstance(x, torch.Tensor) and is_batched(x):
            return True
    return False


def leading(info, x, dim):
    """``x`` with its batched dimension ``dim`` first, contiguous; an
    unbatched ``x`` (``dim`` None) is repeated for every group."""
    if x is None:
        return None
    if dim is None:
        return x.expand((info.batch_size,) + tuple(x.shape)).contiguous()
    return x.movedim(dim, 0).contiguous()


def leading_all(info, xs, dims):
    """:func:`leading` over a list of tensors and its list of dims."""
    if dims is None:
        dims = [None] * len(xs)
    return [leading(info, x, d) for x, d in zip(xs, dims)]
