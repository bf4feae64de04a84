"""Communication-pattern audit of the sharded sampler step.

Port of :mod:`eryn_tpu.parallel.comm_audit`.  A sharded run can compute the
right answer while gathering the whole ensemble every step (right numbers,
destroyed multi-device performance), so tests hold the traffic itself to
bounds.  ``eryn_tpu`` reads the collectives out of the compiled step's HLO;
torch has no such program, so :func:`audit_sampler_comm` runs one sharded
step with the functions of ``torch.distributed`` wrapped and records every
collective call any module makes during it (:func:`recording`).

Each call is recorded as ``(op, dtype, shape, nbytes)``: ``op`` one of
:data:`COLLECTIVE_OPS`, ``shape`` and ``nbytes`` those of what the call
writes into this rank's buffers (the gathered tensor of an all-gather, the
rows an all-to-all delivers here, the received tensors of point-to-point
exchanges, the reduced tensor of an all-reduce), as ``eryn_tpu`` counts
the per-device result shapes of the HLO collectives.

=========================================== ======================
``torch.distributed`` call                  audit op
=========================================== ======================
``all_gather*``                             ``all-gather``
``all_reduce``                              ``all-reduce``
``send``/``recv``/``isend``/``irecv``,
``batch_isend_irecv``                       ``collective-permute``
``all_to_all*``                             ``all-to-all``
``reduce_scatter*``                         ``reduce-scatter``
=========================================== ======================
"""

from __future__ import annotations

import contextlib
import functools
import math

import torch
import torch.distributed as dist

__all__ = ["COLLECTIVE_OPS", "audit_sampler_comm", "collective_stats",
           "recording"]

COLLECTIVE_OPS = (
    "all-gather",
    "all-reduce",
    "collective-permute",
    "all-to-all",
    "reduce-scatter",
)

_DTYPE_NAMES = {
    torch.float64: "f64", torch.float32: "f32", torch.float16: "f16",
    torch.bfloat16: "bf16", torch.int64: "s64", torch.int32: "s32",
    torch.int16: "s16", torch.int8: "s8", torch.uint8: "u8",
    torch.bool: "pred",
}

# the wrapped functions: name -> (audit op, the received tensors of a call)
_CALLS = {
    "all_gather_into_tensor": ("all-gather", lambda a, k: [_arg(a, k, 0,
                                                                "output_tensor")]),
    "all_gather_single": ("all-gather", lambda a, k: [_arg(a, k, 0,
                                                           "output_tensor")]),
    "all_gather": ("all-gather", lambda a, k: list(_arg(a, k, 0,
                                                        "tensor_list"))),
    "all_reduce": ("all-reduce", lambda a, k: [_arg(a, k, 0, "tensor")]),
    "all_to_all_single": ("all-to-all", lambda a, k: [_arg(a, k, 0,
                                                           "output")]),
    "all_to_all": ("all-to-all", lambda a, k: list(_arg(a, k, 0,
                                                        "output_tensor_list"))),
    "reduce_scatter_tensor": ("reduce-scatter", lambda a, k: [_arg(a, k, 0,
                                                                   "output")]),
    "reduce_scatter": ("reduce-scatter", lambda a, k: [_arg(a, k, 0,
                                                            "output")]),
    "recv": ("collective-permute", lambda a, k: [_arg(a, k, 0, "tensor")]),
    "irecv": ("collective-permute", lambda a, k: [_arg(a, k, 0, "tensor")]),
    "send": ("collective-permute", lambda a, k: []),
    "isend": ("collective-permute", lambda a, k: []),
    "batch_isend_irecv": ("collective-permute", lambda a, k: [
        op.tensor for op in _arg(a, k, 0, "p2p_op_list")
        if getattr(op.op, "__name__", "") == "irecv"]),
}


def _arg(args, kwargs, i, name):
    return args[i] if len(args) > i else kwargs[name]


@contextlib.contextmanager
def recording():
    """Record every collective call made through ``torch.distributed``
    while the block runs; yields the list of records ``(op, tensors)``,
    one per call (the calls inside ``batch_isend_irecv`` count once, as
    the batch)."""
    calls = []
    depth = [0]
    saved = {}

    def wrap(name, fn):
        op, received = _CALLS[name]

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if depth[0] == 0:
                calls.append((op, [t for t in received(args, kwargs)
                                   if isinstance(t, torch.Tensor)]))
            depth[0] += 1
            try:
                return fn(*args, **kwargs)
            finally:
                depth[0] -= 1

        return wrapper

    for name in _CALLS:
        fn = getattr(dist, name, None)
        if fn is not None:
            saved[name] = fn
            setattr(dist, name, wrap(name, fn))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


def collective_stats(calls):
    """The records of :func:`recording` as ``(op, dtype, shape, nbytes)``
    tuples, one per received tensor (a call that receives nothing here, a
    lone send, reports zero bytes)."""
    out = []
    for op, tensors in calls:
        if not tensors:
            out.append((op, None, (), 0))
        for t in tensors:
            out.append((op, _DTYPE_NAMES.get(t.dtype, str(t.dtype)),
                        tuple(t.shape), t.numel() * t.element_size()))
    return out


def audit_sampler_comm(sampler, state):
    """Run ONE sharded sampler step and tally its collective traffic.

    Args:
        sampler: an :class:`~eryn_tpu_torch.EnsembleSampler`.
        state: this rank's shard of a state
            (:func:`~eryn_tpu_torch.parallel.mesh.shard_state`) on a mesh
            of more than one rank.  Every rank calls this together.

    The step runs eagerly, as every sharded step does, and is the whole
    schedule of one step: under reversible jump both proposal phases, the
    in-model move and the birth/death move, each with its swap phase,
    whose payload carries the leaf masks.  The sampler's generators (the
    host moves' NumPy one too), clock, ladder, moves' kernel states and
    last state are restored after it, so the audit leaves the chain as it
    was.

    Returns:
        dict with ``per_op`` ``{op: {"count", "bytes"}}``, ``total_bytes``
        (what this rank received over the step), ``full_coords_bytes`` (the
        whole unsharded coords tensor: what an all-gather regression would
        move), ``payload_bytes`` (coords + log_like + log_prior of the
        whole ensemble: one swap phase's payload) and ``big_gathers`` (any
        all-gather or all-reduce whose single result is at least the full
        coords tensor).
    """
    state = sampler._setup_state(state, skip_initial_state_check=True)
    if sampler._mesh_layout is None:
        raise ValueError("audit_sampler_comm needs a state sharded over a "
                         "mesh of more than one rank (shard_state).")
    tc = sampler.temperature_control
    numpy_state = sampler._np_random.get_state()
    saved = (sampler._gen.get_state(), sampler._host_gen.get_state(),
             sampler._previous_state,
             None if tc is None else (tc.time, tc.betas, tc.swaps_accepted),
             None if sampler._m_acc is None else sampler._m_acc.clone(),
             sampler._m_nprop.copy(),
             None if sampler._kernel_states is None
             else list(sampler._kernel_states))
    try:
        with recording() as calls:
            sampler._run_bulk(state, 1, 1, store=False)
    finally:
        sampler._gen.set_state(saved[0])
        sampler._host_gen.set_state(saved[1])
        sampler._np_random.set_state(numpy_state)
        sampler._previous_state = saved[2]
        if tc is not None:
            tc.time, tc.betas, tc.swaps_accepted = saved[3]
        sampler._m_acc, sampler._m_nprop = saved[4], saved[5]
        sampler._kernel_states = saved[6]
    stats = collective_stats(calls)

    per_op = {}
    for op, _dt, _shape, nb in stats:
        slot = per_op.setdefault(op, {"count": 0, "bytes": 0})
        slot["count"] += 1
        slot["bytes"] += nb

    itemsize = torch.empty((), dtype=sampler.dtype).element_size()
    full_coords = sum(math.prod(sampler.shape[n]) * itemsize
                      for n in sampler.branch_names)
    payload = full_coords + 2 * sampler.ntemps * sampler.nwalkers * itemsize
    big = [
        {"op": op, "dtype": dt, "shape": list(shape), "bytes": nb}
        for op, dt, shape, nb in stats
        if op in ("all-gather", "all-reduce") and nb >= full_coords
    ]
    return {
        "per_op": per_op,
        "total_bytes": sum(s[-1] for s in stats),
        "full_coords_bytes": full_coords,
        "payload_bytes": payload,
        "big_gathers": big,
    }
