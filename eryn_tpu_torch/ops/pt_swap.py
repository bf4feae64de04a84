"""Parallel-tempering swap cascade as one kernel launch.

Port of :mod:`eryn_tpu.ops.pt_swap` and of the relabelling, packing and
epilogue its caller wraps around it
(``eryn_tpu/moves/tempering.py:_swap_kernel_pallas``).  The cascade is
sequential over the ``ntemps - 1`` rungs; rung ``i`` slot ``w`` pairs with
rung ``i - 1`` slot ``(w + shift_i) mod nwalkers``.  Combined with a fresh
uniform relabelling ``pi`` of the walker axis per cascade (slot ``w`` holds
walker ``pi[w]``), each rung's pairing is a uniformly relabelled random
rotation: a state-independent bijection, so the Metropolis swap stays valid.

Above :data:`ROLLED_THRESHOLD` walkers the cascade is the JAX package's
large-ensemble variant: the rotation runs modulo ``nwpad``, the walker count
rounded up to a multiple of 128, and a slot whose partner index lands at or
beyond ``nwalkers`` skips the rung.  :func:`proposals_per_rung` counts the
pairings each rung actually proposes, which callers divide the accepted
swaps by.

Only the log-likelihood decides a swap, so the CUDA kernel
(``csrc/pt_swap.cu``) decides on the log-likelihood and an int32 origin per
slot in shared memory, and then moves the state once, by origin.  Two
entries share it:

* :func:`pt_swap_cascade_tree`, the sampler's: the log-likelihood and any
  list of ``(ntemps, nwalkers, ...)`` leaves in their own layouts and
  dtypes, relabelled by ``pi`` through an index, swapped, and written back
  in walker order, with the accepted pairings of each rung counted;
* :func:`pt_swap_cascade_multi` / :func:`_cascade_multi_rolled`, the JAX
  kernels' signatures: ``(ntemps, D, nwalkers)`` payload channels of an
  ensemble that is already relabelled.

Each has a plain PyTorch version (``*_ref``), which CPU tensors take; on a
CUDA tensor a wrapper launches the kernel or raises.
:func:`pt_swap_cascade_tree_grouped` runs ``G`` independent ladders in one
launch (every argument with a leading group axis, ``blockIdx.y`` the group
in the kernel); inside ``torch.func.vmap`` :func:`pt_swap_cascade_tree`
reaches it through a custom op (:mod:`~eryn_tpu_torch.ops._grouped`).  The
launch counters
belong to the two variants of the kernel: ``pt_swap_cascade_multi.launches``
counts launches of the cascade modulo ``nwalkers``,
``_cascade_multi_rolled.launches`` of the cascade modulo the padded width,
from either entry.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build, _grouped
from ._checks import SUFFIX, check_cuda_args

__all__ = [
    "MAX_LEAVES",
    "ROLLED_THRESHOLD",
    "proposals_per_rung",
    "pt_swap_cascade",
    "pt_swap_cascade_multi",
    "pt_swap_cascade_multi_ref",
    "pt_swap_cascade_rolled",
    "pt_swap_cascade_tree",
    "pt_swap_cascade_tree_grouped",
    "pt_swap_cascade_tree_grouped_ref",
    "pt_swap_cascade_tree_ref",
]

#: above this walker count the cascade rotates modulo the 128-padded width
#: (:func:`_cascade_multi_rolled`), as the JAX package does
ROLLED_THRESHOLD = 640

#: leaves one launch of :func:`pt_swap_cascade_tree` moves: the capacity of
#: the table that rides the launch by value (``csrc/pt_swap.cu:kMaxLeaves``).
#: More leaves take one launch per group of at most this many
MAX_LEAVES = 32

#: shared memory a block may use on the H100; an ensemble whose rings of
#: rows need more keeps them in global memory, in one block
SHARED_LIMIT = 232448


def _padded_width(nwalkers):
    return -(-nwalkers // 128) * 128


def _modulus(nwalkers):
    """What the rotations run modulo at this walker count."""
    return _padded_width(nwalkers) if nwalkers > ROLLED_THRESHOLD else nwalkers


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


# ----------------------------------------------------------------------
# plain versions
# ----------------------------------------------------------------------
def _rung_loop(logl, origin, dbetas, shifts, raccept, modulus):
    """The rungs of the cascade on the log-likelihood and an origin index,
    both ``(ntemps, nwalkers)`` in slot order and updated in place.

    Rung ``i`` slot ``w`` pairs with rung ``i - 1`` slot ``p = (w + s) mod
    modulus`` only where ``p < nwalkers``; seen from rung ``i - 1``, slot
    ``v`` is the partner of ``(v - s) mod modulus``, so both rows are
    gathers and nothing is padded.  Returns the ``(ntemps - 1, nwalkers)``
    bool accept mask."""
    ntemps, nwalkers = logl.shape
    w = torch.arange(nwalkers, device=logl.device)
    sels = []
    for i in range(ntemps - 1, 0, -1):
        s = shifts[i - 1].long()
        partner = (w + s) % modulus
        valid = partner < nwalkers
        p = torch.where(valid, partner, 0)
        source = (w - s) % modulus  # rung i slot paired with rung i-1 slot w
        back = source < nwalkers
        src = torch.where(back, source, 0)
        a = logl[i].clone()
        b = logl[i - 1].clone()
        sel = valid & (dbetas[i - 1] * (a - b[p]) > raccept[i - 1])
        take = back & sel[src]
        oa = origin[i].clone()
        ob = origin[i - 1].clone()
        logl[i] = torch.where(sel, b[p], a)
        logl[i - 1] = torch.where(take, a[src], b)
        origin[i] = torch.where(sel, ob[p], oa)
        origin[i - 1] = torch.where(take, oa[src], ob)
        sels.append(sel)
    if sels:
        return torch.stack(sels[::-1])
    return torch.zeros((0, nwalkers), dtype=torch.bool, device=logl.device)


def _channels_ref(logl, channels, dbetas, shifts, raccept, modulus):
    ntemps, nwalkers = logl.shape
    out_l = logl.clone()
    origin = torch.arange(ntemps * nwalkers, device=logl.device).reshape(
        ntemps, nwalkers)
    sel = _rung_loop(out_l, origin, dbetas, shifts, raccept, modulus)
    # out_c[t, :, w] = channels[ts, :, ws] with (ts, ws) the origin of (t, w)
    ts = torch.div(origin, nwalkers, rounding_mode="floor")
    out_c = channels[ts[:, None, :], torch.arange(
        channels.shape[1], device=logl.device)[None, :, None],
        (origin - ts * nwalkers)[:, None, :]]
    return out_l, out_c, sel.to(logl.dtype)


def pt_swap_cascade_multi_ref(logl, channels, dbetas, shifts, raccept):
    """Plain version of :func:`pt_swap_cascade_multi` up to
    :data:`ROLLED_THRESHOLD` walkers (rotations modulo ``nwalkers``)."""
    return _channels_ref(logl, channels, dbetas, shifts, raccept,
                         logl.shape[1])


def _cascade_multi_rolled_ref(logl, channels, dbetas, shifts, raccept):
    """Plain version of :func:`_cascade_multi_rolled` (rotations modulo the
    128-padded width, pairs with a partner beyond ``nwalkers`` skipped)."""
    return _channels_ref(logl, channels, dbetas, shifts, raccept,
                         _padded_width(logl.shape[1]))


def pt_swap_cascade_tree_ref(logl, leaves, betas, pi, shifts, raccept,
                             out_logl, out_leaves, accepted, sel=None):
    """Plain version of :func:`pt_swap_cascade_tree`: gather by ``pi``, the
    rungs on the log-likelihood and an origin index, one gather per leaf."""
    ntemps, nwalkers = logl.shape
    dbetas = betas[:-1] - betas[1:]
    slots = logl[:, pi]
    rows = torch.arange(ntemps, device=logl.device)[:, None] * nwalkers
    dest = (rows + pi[None, :]).reshape(-1)  # flat walker-order slot of (t, w)
    origin = dest.reshape(ntemps, nwalkers).clone()
    mask = _rung_loop(slots, origin, dbetas, shifts, raccept,
                      _modulus(nwalkers))
    out_logl[:, pi] = slots
    origin = origin.reshape(-1)
    n = ntemps * nwalkers
    for leaf, out in zip(leaves, out_leaves):
        if leaf.numel():
            out.view(n, -1)[dest] = leaf.reshape(n, -1)[origin]
    accepted.copy_(mask.sum(dim=-1))
    if sel is not None:
        sel.copy_(mask)


# ----------------------------------------------------------------------
# kernel wrappers
# ----------------------------------------------------------------------
def _shared_bytes(ntemps, nwalkers, chunk, itemsize):
    """Shared memory of one block (``csrc/pt_swap.cu:launch_cascade``): rings
    of four rows of log-likelihoods as they lie, of acceptance draws, of
    relabelled log-likelihoods and of int32 origins, the relabelling, the
    per-rung differences, rotations and counts, and the final origins of its
    chunk."""
    return ((12 * nwalkers + ntemps - 1) * itemsize
            + (5 * nwalkers + 2 * (ntemps - 1)
               + ntemps * min(chunk, nwalkers)) * 4)


def _chunk_walkers(nwalkers):
    """Walkers of every rung whose payload one block of the grid moves: 8,
    or what keeps the grid within 128 blocks (one wave of the card's 132
    SMs, as every block repeats the decision pass)."""
    return max(8, -(-nwalkers // 128))


def _launch(rolled, logl, betas, dbetas, pi, shifts, raccept, out_logl,
            accepted, sel, table, chunk):
    """Launch the cascade kernel over the groups of ``logl`` ``(G, ntemps,
    nwalkers)`` (every other array with the same leading group axis) and
    count the launch.  ``table`` lists, per leaf, ``(tensor in, tensor out,
    row bytes, channels)``."""
    ngroups, ntemps, nwalkers = logl.shape
    if ntemps * nwalkers >= 2**31:
        raise ValueError(
            "the swap cascade carries int32 origins and supports fewer than "
            f"2**31 ensemble slots; got {ntemps * nwalkers}.")
    if ngroups > 65535:
        raise ValueError(
            f"the swap cascade takes at most 65535 groups; got {ngroups}.")
    scratch = None
    if _shared_bytes(ntemps, nwalkers, chunk, logl.element_size()) > SHARED_LIMIT:
        scratch = torch.empty((ngroups, ntemps, nwalkers), dtype=torch.int32,
                              device=logl.device)
    n = len(table)
    ptr = ctypes.c_void_p * n
    ints = ctypes.c_int * n

    def address(x):
        return None if x is None else x.data_ptr()

    name = "_cascade_multi_rolled" if rolled else "pt_swap_cascade_multi"
    _build.launch(
        f"eryn_pt_swap_cascade_{SUFFIX[logl.dtype]}", name, logl.get_device(),
        "ppppppppppppppiiiiiiip",
        logl.data_ptr(), address(betas), address(dbetas), address(pi),
        shifts.data_ptr(), raccept.data_ptr(), out_logl.data_ptr(),
        address(accepted), address(sel), address(scratch),
        ptr(*(t[0].data_ptr() for t in table)),
        ptr(*(t[1].data_ptr() for t in table)),
        ints(*(t[2] for t in table)), ints(*(t[3] for t in table)),
        n, ngroups, ntemps, nwalkers, chunk, int(rolled), SHARED_LIMIT,
    )
    if rolled:
        _cascade_multi_rolled.launches += 1
    else:
        pt_swap_cascade_multi.launches += 1


def pt_swap_cascade_tree(logl, leaves, betas, pi, shifts, raccept, out_logl,
                         out_leaves, accepted, sel=None, chunk=None):
    """The whole swap phase from given draws, in one launch: relabel the
    walker axis by ``pi``, run the cascade, relabel back.

    Args:
        logl: ``(ntemps, nwalkers)`` log-likelihoods, float32 or float64.
        leaves: sequence of contiguous tensors with leading ``(ntemps,
            nwalkers)`` dims, of any dtype (bool masks and integers move as
            bytes), swapped as ``logl`` is.  Above :data:`MAX_LEAVES` the
            kernel is launched once per group of at most that many leaves,
            every launch on the same draws, so every group makes the same
            swaps; only the first writes ``out_logl``, ``accepted`` and
            ``sel``.
        betas: ``(ntemps,)`` inverse temperatures; rung ``i`` decides with
            ``betas[i-1] - betas[i]``.
        pi: ``(nwalkers,)`` int64 relabelling: slot ``w`` holds walker
            ``pi[w]``.
        shifts: ``(ntemps - 1,)`` int32 rotation offsets.
        raccept: ``(ntemps - 1, nwalkers)`` log-uniform acceptance draws, in
            slot order.
        out_logl: written with the swapped log-likelihoods, walker order.
        out_leaves: one tensor like each leaf, written with the swapped
            leaf; it must not overlap any input.
        accepted: ``(ntemps - 1,)`` in the dtype of ``logl``, written with
            the accepted pairings of each rung.
        sel: optionally ``(ntemps - 1, nwalkers)`` in the dtype of ``logl``,
            written with the accept mask (1.0 / 0.0) in slot order.
        chunk: walkers per block of the grid (:func:`_chunk_walkers`).

    Above :data:`ROLLED_THRESHOLD` walkers the rotations run modulo the
    128-padded width and :func:`proposals_per_rung` gives the pairings
    proposed.  Every value of the outputs is a value of the inputs, moved.
    """
    if len(leaves) != len(out_leaves):
        raise ValueError(
            f"pt_swap_cascade_tree: {len(leaves)} leaves but "
            f"{len(out_leaves)} outputs.")
    if _grouped.batched(logl, leaves, betas, pi, shifts, raccept, out_logl,
                        out_leaves, accepted, sel):
        new_logl, new_leaves, new_acc, new_sel = _cascade_tree_op(
            logl, list(leaves), betas, pi, shifts, raccept, sel is not None)
        for out, x in zip([out_logl, accepted, *out_leaves],
                          [new_logl, new_acc, *new_leaves]):
            out.copy_(x)
        if sel is not None:
            sel.copy_(new_sel)
        return
    if logl.device.type == "cpu":
        return pt_swap_cascade_tree_ref(logl, leaves, betas, pi, shifts,
                                        raccept, out_logl, out_leaves,
                                        accepted, sel)
    _tree_launch(logl[None], [x[None] for x in leaves], betas[None], pi[None],
                 shifts[None], raccept[None], out_logl[None],
                 [x[None] for x in out_leaves], accepted[None],
                 None if sel is None else sel[None], chunk)


def _tree_launch(logl, leaves, betas, pi, shifts, raccept, out_logl,
                 out_leaves, accepted, sel, chunk):
    """Check the arguments of a grouped tree cascade (every one with a
    leading group axis) and launch it, once per group of at most
    :data:`MAX_LEAVES` leaves."""
    G, ntemps, nwalkers = logl.shape
    more = {} if sel is None else {"sel": (sel, (G, ntemps - 1, nwalkers))}
    for k, (leaf, out) in enumerate(zip(leaves, out_leaves)):
        more[f"leaves[{k}]"] = (leaf, leaf.shape, leaf.dtype)
        more[f"out_leaves[{k}]"] = (out, leaf.shape, leaf.dtype)
    check_cuda_args(
        "pt_swap_cascade_tree", logl.dtype, logl.device,
        logl=(logl, (G, ntemps, nwalkers)), betas=(betas, (G, ntemps)),
        pi=(pi, (G, nwalkers), torch.int64),
        i_shifts=(shifts, (G, ntemps - 1)),
        raccept=(raccept, (G, ntemps - 1, nwalkers)),
        out_logl=(out_logl, (G, ntemps, nwalkers)),
        accepted=(accepted, (G, ntemps - 1)), **more,
    )
    table = []
    for k, (leaf, out) in enumerate(zip(leaves, out_leaves)):
        if leaf.shape[:3] != (G, ntemps, nwalkers):
            raise ValueError(
                f"pt_swap_cascade_tree: leaves[{k}] has shape "
                f"{tuple(leaf.shape[1:])}, expected leading dims "
                f"{(ntemps, nwalkers)}.")
        if leaf.data_ptr() == out.data_ptr():
            raise ValueError(
                f"pt_swap_cascade_tree: out_leaves[{k}] overlaps its input.")
        row_bytes = math.prod(leaf.shape[3:]) * leaf.element_size()
        if ntemps * nwalkers * row_bytes >= 2**31:
            raise ValueError(
                f"pt_swap_cascade_tree: leaves[{k}] holds 2**31 bytes or "
                "more; the kernel indexes a leaf with 32 bits.")
        if row_bytes:
            table.append((leaf, out, row_bytes, 0))
    chunk = _chunk_walkers(nwalkers) if chunk is None else chunk
    rolled = nwalkers > ROLLED_THRESHOLD
    for g in range(max(1, -(-len(table) // MAX_LEAVES))):
        group = table[g * MAX_LEAVES:(g + 1) * MAX_LEAVES]
        if g == 0:
            _launch(rolled, logl, betas, None, pi, shifts, raccept, out_logl,
                    accepted, sel, group, chunk)
        else:
            # the same decisions again; the kernel works on its logl output
            # in place, so a later group writes it into scratch
            _launch(rolled, logl, betas, None, pi, shifts, raccept,
                    torch.empty_like(out_logl), None, None, group, chunk)


def pt_swap_cascade_tree_grouped_ref(logl, leaves, betas, pi, shifts,
                                     raccept, out_logl, out_leaves, accepted,
                                     sel=None):
    """Plain version of :func:`pt_swap_cascade_tree_grouped`: the plain
    version of each group in turn."""
    for g in range(logl.shape[0]):
        pt_swap_cascade_tree_ref(
            logl[g], [x[g] for x in leaves], betas[g], pi[g], shifts[g],
            raccept[g], out_logl[g], [x[g] for x in out_leaves], accepted[g],
            None if sel is None else sel[g])


def pt_swap_cascade_tree_grouped(logl, leaves, betas, pi, shifts, raccept,
                                 out_logl, out_leaves, accepted, sel=None,
                                 chunk=None):
    """:func:`pt_swap_cascade_tree` of ``G`` independent ladders in one
    launch: ``logl`` ``(G, ntemps, nwalkers)``, each leaf ``(G, ntemps,
    nwalkers, ...)``, ``betas`` ``(G, ntemps)``, ``pi`` ``(G, nwalkers)``,
    ``shifts`` ``(G, ntemps - 1)``, ``raccept`` ``(G, ntemps - 1,
    nwalkers)``, and the outputs likewise (``accepted`` ``(G, ntemps -
    1)``).  Group ``g`` computes what the ungrouped call computes on the
    ``g``-th entries; CPU tensors take the plain version."""
    if logl.device.type == "cpu":
        return pt_swap_cascade_tree_grouped_ref(
            logl, leaves, betas, pi, shifts, raccept, out_logl, out_leaves,
            accepted, sel)
    _tree_launch(logl, list(leaves), betas, pi, shifts, raccept, out_logl,
                 list(out_leaves), accepted, sel, chunk)


Tensor = torch.Tensor


@torch.library.custom_op("eryn_tpu_torch::pt_swap_cascade_tree",
                         mutates_args=())
def _cascade_tree_op(logl: Tensor, leaves: list[Tensor], betas: Tensor,
                     pi: Tensor, shifts: Tensor, raccept: Tensor,
                     with_sel: bool,
                     ) -> tuple[Tensor, list[Tensor], Tensor, Tensor]:
    out_logl = torch.empty_like(logl)
    out_leaves = [torch.empty_like(x) for x in leaves]
    accepted = logl.new_empty((logl.shape[0] - 1,))
    sel = torch.empty_like(raccept)
    pt_swap_cascade_tree(logl, leaves, betas, pi, shifts, raccept, out_logl,
                         out_leaves, accepted, sel if with_sel else None)
    return out_logl, out_leaves, accepted, sel


@_cascade_tree_op.register_vmap
def _(info, in_dims, logl, leaves, betas, pi, shifts, raccept, with_sel):
    logl, betas, pi, shifts, raccept = (
        _grouped.leading(info, x, d) for x, d in zip(
            (logl, betas, pi, shifts, raccept),
            (in_dims[0], *in_dims[2:6])))
    leaves = _grouped.leading_all(info, leaves, in_dims[1])
    out_logl = torch.empty_like(logl)
    out_leaves = [torch.empty_like(x) for x in leaves]
    accepted = logl.new_empty((logl.shape[0], logl.shape[1] - 1))
    sel = torch.empty_like(raccept)
    pt_swap_cascade_tree_grouped(logl, leaves, betas, pi, shifts, raccept,
                                 out_logl, out_leaves, accepted,
                                 sel if with_sel else None)
    return ((out_logl, out_leaves, accepted, sel),
            (0, [0] * len(out_leaves), 0, 0))


def _launch_channels(name, rolled, logl, channels, dbetas, shifts, raccept):
    """Check the arguments of a channel-form cascade, allocate its outputs
    and launch."""
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
    table = [(channels, out_c, channels.element_size(), D)] if D else []
    _launch(rolled, logl[None], None, dbetas[None], None, shifts[None],
            raccept[None], out_l[None], None, sel[None], table,
            _chunk_walkers(nwalkers))
    return out_l, out_c, sel


def pt_swap_cascade_multi(logl, channels, dbetas, shifts, raccept):
    """Run the full swap cascade in one launch on an ensemble that is
    already relabelled, moving ``D`` payload channels with it.

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
    if logl.shape[1] > ROLLED_THRESHOLD:
        return _cascade_multi_rolled(logl, channels, dbetas, shifts, raccept)
    if logl.device.type == "cpu":
        return pt_swap_cascade_multi_ref(logl, channels, dbetas, shifts, raccept)
    return _launch_channels("pt_swap_cascade_multi", False, logl, channels,
                            dbetas, shifts, raccept)


pt_swap_cascade_multi.launches = 0


def _cascade_multi_rolled(logl, channels, dbetas, shifts, raccept):
    """The swap cascade for more than :data:`ROLLED_THRESHOLD` walkers: the
    arguments and results of :func:`pt_swap_cascade_multi`, with rotations
    modulo the 128-padded width and pairs whose partner is not a real
    walker skipped (``sel`` 0 there).  One launch on CUDA tensors; the
    plain version on CPU tensors."""
    if logl.device.type == "cpu":
        return _cascade_multi_rolled_ref(logl, channels, dbetas, shifts, raccept)
    return _launch_channels("_cascade_multi_rolled", True, logl, channels,
                            dbetas, shifts, raccept)


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
