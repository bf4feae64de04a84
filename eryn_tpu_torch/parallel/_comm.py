"""The collectives the device mesh uses, over ``torch.distributed`` groups.

Four operations, each on a process group of the mesh (the whole mesh, or
the ranks along one of its dimensions): :func:`all_gather_into_tensor`,
:func:`all_to_all_single` (with uneven splits), :func:`all_reduce` (a sum)
and :func:`batch_isend_irecv` (point-to-point exchanges); and
:func:`barrier`, which moves no data (a file's readers wait for its
writer).  Every call goes
through ``torch.distributed``'s module attributes, so
:mod:`~eryn_tpu_torch.parallel.comm_audit` sees it.

Under NCCL the tensors stay on the card.  Under gloo, which several ranks
sharing one card need (NCCL takes one rank per card), an operation that
gloo refuses on a CUDA tensor is run on host copies instead, and
:data:`STAGED` records it with gloo's reason; gloo's point-to-point
operations always take host memory.  Nothing here imports ``jax``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed import distributed_c10d as c10d

__all__ = [
    "STAGED",
    "all_gather_into_tensor",
    "all_reduce",
    "all_to_all_single",
    "barrier",
    "batch_isend_irecv",
]

#: operations run on host copies under gloo, by name, with the reason
STAGED = {}


def _staged(name, group, tensors):
    """Whether ``name`` runs on host copies for these tensors on
    ``group``."""
    return (any(t.is_cuda for t in tensors)
            and dist.get_backend(group) == "gloo" and name in STAGED)


def _run(name, group, fn, ins, outs):
    """``fn(ins, outs)``; under gloo, on host copies of CUDA tensors when
    gloo refuses them (the refusal is recorded and later calls go straight
    to the copies).  ``outs`` are written in place."""
    tensors = list(ins) + list(outs)
    if (not _staged(name, group, tensors) and any(t.is_cuda for t in tensors)
            and dist.get_backend(group) == "gloo"):
        try:
            fn(ins, outs)
            return
        except RuntimeError as err:  # gloo's refusal of a device tensor
            STAGED[name] = str(err).strip().splitlines()[0]
    if not _staged(name, group, tensors):
        fn(ins, outs)
        return
    host_in = [t.cpu() for t in ins]
    host_out = [torch.empty(t.shape, dtype=t.dtype) for t in outs]
    fn(host_in, host_out)
    for t, h in zip(outs, host_out):
        t.copy_(h)


def all_gather_into_tensor(out, inp, group=None):
    """``out`` (the group's size times ``inp``'s elements, in group rank
    order) gathers ``inp`` from every rank of ``group``."""
    def fn(ins, outs):
        # PyTorch's newer name for the same collective, where it has one
        gather = getattr(dist, "all_gather_single", None)
        (gather or dist.all_gather_into_tensor)(outs[0], ins[0], group=group)

    _run("all_gather_into_tensor", group, fn, [inp.contiguous()], [out])
    return out


def all_to_all_single(out, inp, out_splits, in_splits, group=None):
    """Rank ``q`` of ``group`` receives rows ``in_splits[q]`` of ``inp``
    (rows along dim 0, in group rank order); ``out`` takes ``out_splits[p]``
    rows from each rank ``p``."""
    def fn(ins, outs):
        dist.all_to_all_single(outs[0], ins[0], output_split_sizes=out_splits,
                               input_split_sizes=in_splits, group=group)

    _run("all_to_all_single", group, fn, [inp.contiguous()], [out])
    return out


def all_reduce(t, group=None):
    """Sum ``t`` over ``group``, in place."""
    def fn(ins, outs):
        if ins[0] is not outs[0]:
            outs[0].copy_(ins[0])
        dist.all_reduce(outs[0], group=group)

    _run("all_reduce", group, fn, [t], [t])
    return t


def batch_isend_irecv(sends, recvs, group=None):
    """Send each ``(tensor, global rank)`` of ``sends`` and receive into each
    ``(tensor, global rank)`` of ``recvs``, all in one batch, and wait for
    it."""
    tensors = [t for t, _ in sends] + [t for t, _ in recvs]
    if not tensors:
        return
    if any(t.is_cuda for t in tensors) and dist.get_backend(group) == "gloo":
        STAGED.setdefault("batch_isend_irecv",
                          "gloo's send and recv take host memory")

    def fn(ins, outs):
        # P2POp accepts only c10d's own isend and irecv
        ops = ([dist.P2POp(c10d.isend, t, peer, group)
                for t, (_, peer) in zip(ins, sends)]
               + [dist.P2POp(c10d.irecv, t, peer, group)
                  for t, (_, peer) in zip(outs, recvs)])
        for work in dist.batch_isend_irecv(ops):
            work.wait()

    _run("batch_isend_irecv", group, fn, [t.contiguous() for t, _ in sends],
         [t for t, _ in recvs])


def barrier(group=None):
    """Wait until every rank of ``group`` reaches this call."""
    dist.barrier(group=group)
