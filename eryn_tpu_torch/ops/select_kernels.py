"""Masked-uniform selection, and the group-stretch proposal built on it.

Port of :func:`eryn_tpu.ops.select_kernels.onehot_select`, the complement
pick of the red/blue group stretch.  For every query ``k`` the pick is the
payload row of the ``(k + 1)``-th active entry; a query that finds none (an
empty active complement, ``k + 1`` above the count, or ``k = -1``) reads a
row of zeros.

Two entries share one device routine (``csrc/select_kernels.cu``: the 0/1
mask as one ballot word per 32 entries with an exclusive prefix of their
bit counts in shared memory, a pick a search over the prefixes and the
``n``-th set bit of one word):

* :func:`group_stretch_propose`, the whole proposal of
  :class:`~eryn_tpu_torch.moves.rbgroupstretch.RedBlueGroupStretchMove` for
  every branch in one launch: the scan of the complement's masks where they
  lie, the count, the pick, the stretch (periodic or not), the move mask and
  the factors.  This is what the sampler calls.
* :func:`onehot_select`, the selection alone with the JAX kernel's signature
  (running counts, queries, a zeroed payload).

Each takes its plain version only for tensors on the CPU.

:func:`group_stretch_propose_grouped` is the proposal of ``G`` independent
ensembles in one launch.  Every input of the kernel is per temperature row
but the per-leaf dimensions and the periods, which are the move's and the
same for every group; so ``G`` groups of ``nt`` temperatures are ``G * nt``
rows of the same launch, and only the wrapper changes.  Inside
``torch.func.vmap`` :func:`group_stretch_propose` reaches it through a
custom op (:mod:`~eryn_tpu_torch.ops._grouped`).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ..utils.periodic import wrap_coords, wrap_distance
from . import _build, _grouped
from ._checks import SUFFIX, check_cuda_args

__all__ = [
    "MAX_BRANCHES",
    "group_stretch_propose",
    "group_stretch_propose_grouped",
    "group_stretch_propose_grouped_ref",
    "group_stretch_propose_ref",
    "onehot_select",
    "onehot_select_ref",
]

#: branches one launch of :func:`group_stretch_propose` takes: the capacity
#: of the table that rides the launch by value
#: (``csrc/select_kernels.cu:kMaxBranches``)
MAX_BRANCHES = 8

#: shared memory a block may use on the H100.  The mask words and their
#: prefixes take 8 bytes per 32 entries, so about 929,000 entries of one
#: temperature's complement fit; beyond that the wrappers raise
SHARED_LIMIT = 232448


def _check_entries(name, M):
    words = -(-M // 32)
    if 8 * words > SHARED_LIMIT:
        raise ValueError(
            f"{name}: {M} entries a temperature need {8 * words} bytes of "
            f"shared memory for the mask words and prefixes; a block has "
            f"{SHARED_LIMIT}."
        )


def onehot_select_ref(cs, kq, c_clean):
    """Plain version of :func:`onehot_select`: the first index whose count
    reaches ``k + 1`` (``torch.searchsorted``), its row where the count
    equals ``k + 1``, zeros elsewhere."""
    M = cs.shape[1]
    if M == 0:  # nothing to select from
        return cs.new_zeros((*kq.shape, c_clean.shape[-1]))
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
    _check_entries("onehot_select", M)
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


def _complement(x, skip):
    """The rows of ``x`` ``(nt, rows, ...)`` outside ``skip = (off, n)``."""
    off, n = skip
    if n == 0:
        return x
    return torch.cat([x[:, :off], x[:, off + n:]], dim=1)


def _stretch_factor(u, a, log_proposal):
    if log_proposal:
        return torch.exp((2.0 * u - 1.0) * math.log(a))
    b = (a - 1.0) * u + 1.0
    return b * b / a


def group_stretch_propose_ref(s, s_inds, c, c_inds, u, uu, skip=(0, 0),
                              a=2.0, log_proposal=False, per_leaf=None,
                              periods=None):
    """Plain version of :func:`group_stretch_propose` (same arguments and
    results): the complement gathered by ``torch.cat``, its running counts
    by ``cumsum``, :func:`onehot_select_ref`, then the stretch, the move mask
    and the factors in separate tensor ops."""
    names = list(s)
    first = s[names[0]]
    ntemps, ns = first.shape[:2]
    dtype, device = first.dtype, first.device
    zz = _stretch_factor(u, a, log_proposal)  # one z per walker

    q = {}
    ndim_active = torch.zeros((ntemps, ns), dtype=dtype, device=device)
    for name in names:
        sb = s[name]  # (nt, ns, nl, nd)
        cb = _complement(c[name], skip)  # (nt, nc, nl, nd)
        ci = _complement(c_inds[name], skip)
        nt, nc, nl, nd = cb.shape
        nls = sb.shape[2]
        M = nc * nl
        m = ci.reshape(nt, M).to(dtype)
        cnt = m.sum(dim=-1)  # active complement leaves per temperature
        cs = torch.cumsum(m, dim=-1)
        # the k-th active entry; k is an exact integer in the float dtype
        kq = torch.floor(
            uu[name] * torch.clamp(cnt, min=1.0)[:, None, None]
        ).reshape(nt, ns * nls)
        # dormant slots may hold NaN: the selection reads zeros there
        c_clean = torch.where(ci[..., None], cb, 0.0).reshape(nt, M, nd)
        c_sel = onehot_select_ref(cs, kq, c_clean).reshape(nt, ns, nls, nd)
        diff = c_sel - sb
        period = None if periods is None else periods.get(name)
        if period is not None:
            diff = wrap_distance(diff, period)
        temp = c_sel - diff * zz[:, :, None, None]
        if period is not None:
            temp = wrap_coords(temp, period)

        # only active leaves move, and only where the complement has an
        # active leaf: a temperature whose complement has none proposes
        # the identity for this branch, and its dims leave the factors
        has_c = cnt > 0
        move_mask = s_inds[name][..., None] & has_c[:, None, None, None]
        q[name] = torch.where(move_mask, temp, sb)

        has_c2 = has_c[:, None].to(dtype)
        leaf_dims = None if per_leaf is None else per_leaf.get(name)
        if leaf_dims is None:
            ndim_active = ndim_active + s_inds[name].sum(dim=-1) * nd * has_c2
        else:
            ndim_active = ndim_active + (
                s_inds[name] * leaf_dims
            ).sum(dim=-1) * has_c2

    if log_proposal:
        factors = ndim_active * torch.log(zz)
    else:
        factors = (ndim_active - 1.0) * torch.log(zz)
    return q, factors


def _rows_view(name, arg, x, shape, dtype, device):
    """Raise unless ``x`` has ``shape`` and ``dtype`` on ``device`` and is
    contiguous within a temperature: a block of walkers of a larger
    contiguous tensor, or a contiguous tensor."""
    if x.device != device:
        raise ValueError(f"{name}: {arg} is on {x.device}, not {device}.")
    if x.dtype != dtype:
        raise TypeError(f"{name}: {arg} has dtype {x.dtype}, not {dtype}.")
    if x.shape != shape:
        raise ValueError(
            f"{name}: {arg} has shape {tuple(x.shape)}, expected "
            f"{tuple(shape)}.")
    if not x[0].is_contiguous() or (x.shape[0] > 1 and x.stride(0) >= 2**31):
        raise ValueError(
            f"{name}: {arg} must be contiguous within a temperature.")


def group_stretch_propose(s, s_inds, c, c_inds, u, uu, skip=(0, 0), a=2.0,
                          log_proposal=False, per_leaf=None, periods=None):
    """The group-stretch proposal of one red/blue block, every branch in one
    launch.

    Each active leaf of a moving walker stretches toward a uniformly chosen
    active leaf of the same branch in the complement: with ``cnt`` the
    complement's active leaves at that temperature, ``k = floor(uu *
    max(cnt, 1))`` picks the ``(k + 1)``-th of them in the flattened
    ``(complement walker, leaf)`` order (a row of zeros if ``k + 1 > cnt``),
    and ``q = c_sel - (c_sel - s) * z`` with ``z`` drawn from ``u`` as the
    stretch move draws it.  Inactive leaves, and every leaf of a branch whose
    complement is empty at that temperature, stay as they are bit for bit.

    Args (dicts are keyed by branch name, in the order of ``s``):
        s: ``{name: (nt, ns, nl, nd)}`` moving coordinates, float32 or
            float64; contiguous, or a block of walkers ``x[:, off:off + ns]``
            of a contiguous tensor.
        s_inds: ``{name: (nt, ns, nl)}`` bool leaf masks, likewise.
        c: ``{name: (nt, rows, nl, nd)}`` contiguous coordinates holding
            the complement; with ``skip`` it may be the tensor ``s`` is a
            block of.
        c_inds: ``{name: (nt, rows, nl)}`` bool, contiguous.
        u: ``(nt, ns)`` uniforms of the stretch factor.
        uu: ``{name: (nt, ns, nl)}`` uniforms of the picks.
        skip: ``(off, n)``: rows ``[off, off + n)`` of ``c`` are not part of
            the complement, which is the rows before and after them, in
            that order.
        a: stretch scale.
        log_proposal: draw ``ln z`` uniformly on ``[-ln a, ln a]``.
        per_leaf: optionally ``{name: (nl,) or None}``, the moving
            dimensions of each leaf in the state dtype (a Gibbs mask summed
            over its parameters); ``nd`` where absent.
        periods: optionally ``{name: (nd,) or None}`` periods in the state
            dtype, ``inf`` where a parameter is not periodic: the difference
            is wrapped into ``[-P/2, P/2)`` and the proposal into ``[0, P)``.

    Returns:
        ``(q, factors)``: ``{name: (nt, ns, nl, nd)}`` and ``(nt, ns)``, the
        factors ``(N - 1) ln z`` (``N ln z`` with ``log_proposal``) with
        ``N`` the dimensions that moved.
    """
    names = list(s)
    first = s[names[0]]
    if _grouped.batched(u, *(list(x.values())
                             for x in (s, s_inds, c, c_inds, uu))):
        return _grouped_call(s, s_inds, c, c_inds, u, uu, skip, a,
                             log_proposal, per_leaf, periods)
    if first.device.type == "cpu":
        return group_stretch_propose_ref(s, s_inds, c, c_inds, u, uu, skip, a,
                                         log_proposal, per_leaf, periods)
    name = "group_stretch_propose"
    if len(names) > MAX_BRANCHES:
        raise ValueError(
            f"{name} takes at most {MAX_BRANCHES} branches in one launch; "
            f"got {len(names)}.")
    nt, ns = first.shape[:2]
    dtype, device = first.dtype, first.device
    off, nskip = skip
    rows = c[names[0]].shape[1]
    if not (0 <= off and 0 <= nskip and off + nskip <= rows):
        raise ValueError(f"{name}: skip {skip} lies outside {rows} rows.")
    small = {}
    for n in names:
        nl, nd = c[n].shape[2:]
        _rows_view(name, f"s[{n}]", s[n], (nt, ns, nl, nd), dtype, device)
        _rows_view(name, f"s_inds[{n}]", s_inds[n], (nt, ns, nl), torch.bool,
                   device)
        _check_entries(name, (rows - nskip) * nl)
        if nt * rows * nl * nd >= 2**31:
            raise ValueError(
                f"{name}: c[{n}] holds 2**31 elements or more; the kernel "
                "indexes a branch with 32 bits.")
        small[f"c[{n}]"] = (c[n], (nt, rows, nl, nd))
        small[f"c_inds[{n}]"] = (c_inds[n], (nt, rows, nl), torch.bool)
        small[f"uu[{n}]"] = (uu[n], (nt, ns, nl))
        if per_leaf is not None and per_leaf.get(n) is not None:
            small[f"per_leaf[{n}]"] = (per_leaf[n], (nl,))
        if periods is not None and periods.get(n) is not None:
            small[f"periods[{n}]"] = (periods[n], (nd,))
    check_cuda_args(name, dtype, device, u=(u, (nt, ns)), **small)

    q = {n: torch.empty((nt, ns) + tuple(c[n].shape[2:]), dtype=dtype,
                        device=device) for n in names}
    factors = torch.empty((nt, ns), dtype=dtype, device=device)

    def optional(table, n):
        x = None if table is None else table.get(n)
        return None if x is None else x.data_ptr()

    nb = len(names)
    ptr = ctypes.c_void_p * nb
    ints = ctypes.c_int * nb
    _build.launch(
        f"eryn_group_stretch_propose_{SUFFIX[dtype]}", name,
        first.get_device(), "ppppppppppppippiiiiiddiip",
        ptr(*(s[n].data_ptr() for n in names)),
        ptr(*(s_inds[n].data_ptr() for n in names)),
        ptr(*(c[n].data_ptr() for n in names)),
        ptr(*(c_inds[n].data_ptr() for n in names)),
        ptr(*(uu[n].data_ptr() for n in names)),
        ptr(*(optional(per_leaf, n) for n in names)),
        ptr(*(optional(periods, n) for n in names)),
        ptr(*(q[n].data_ptr() for n in names)),
        ints(*(s[n].stride(0) for n in names)),
        ints(*(s_inds[n].stride(0) for n in names)),
        ints(*(c[n].shape[2] for n in names)),
        ints(*(c[n].shape[3] for n in names)),
        nb, u.data_ptr(), factors.data_ptr(), nt, ns, rows, off, nskip,
        float(a), math.log(a), int(bool(log_proposal)), SHARED_LIMIT,
    )
    group_stretch_propose.launches += 1
    return q, factors


group_stretch_propose.launches = 0


def group_stretch_propose_grouped_ref(s, s_inds, c, c_inds, u, uu,
                                      skip=(0, 0), a=2.0, log_proposal=False,
                                      per_leaf=None, periods=None):
    """Plain version of :func:`group_stretch_propose_grouped`: the plain
    version of each group in turn."""
    names = list(s)
    parts = [
        group_stretch_propose_ref(
            *({n: x[n][g] for n in names} for x in (s, s_inds, c, c_inds)),
            u[g], {n: uu[n][g] for n in names}, skip, a, log_proposal,
            per_leaf, periods)
        for g in range(u.shape[0])
    ]
    return ({n: torch.stack([q[n] for q, _ in parts]) for n in names},
            torch.stack([f for _, f in parts]))


def group_stretch_propose_grouped(s, s_inds, c, c_inds, u, uu, skip=(0, 0),
                                  a=2.0, log_proposal=False, per_leaf=None,
                                  periods=None):
    """:func:`group_stretch_propose` of ``G`` groups in one launch: every
    tensor of ``s``, ``s_inds``, ``c``, ``c_inds``, ``uu`` and ``u`` with a
    leading group axis (``s`` and ``s_inds`` a block of walkers of a
    contiguous tensor, or contiguous), ``per_leaf`` and ``periods`` shared
    by the groups.  The ``G * nt`` rows are one launch of the kernel."""
    names = list(s)
    if u.device.type == "cpu":
        return group_stretch_propose_grouped_ref(
            s, s_inds, c, c_inds, u, uu, skip, a, log_proposal, per_leaf,
            periods)
    G, nt = u.shape[:2]

    def rows(x):
        return {n: x[n].reshape((G * nt,) + tuple(x[n].shape[2:]))
                for n in names}

    q, factors = group_stretch_propose(
        rows(s), rows(s_inds), rows(c), rows(c_inds),
        u.reshape((G * nt,) + tuple(u.shape[2:])), rows(uu), skip, a,
        log_proposal, per_leaf, periods)
    return ({n: q[n].reshape((G, nt) + tuple(q[n].shape[1:])) for n in names},
            factors.reshape(G, nt, -1))


def _grouped_call(s, s_inds, c, c_inds, u, uu, skip, a, log_proposal,
                  per_leaf, periods):
    """Call the custom op of the proposal on the branches' lists."""
    names = list(s)

    def opt(table):
        return [None if table is None else table.get(n) for n in names]

    *q, factors = _group_stretch_op(
        *([x[n] for n in names] for x in (s, s_inds, c, c_inds)), u,
        [uu[n] for n in names], list(skip), float(a), bool(log_proposal),
        opt(per_leaf), opt(periods))
    return dict(zip(names, q)), factors


Tensor = torch.Tensor


def _as_tables(names, per_leaf, periods):
    def table(xs):
        return None if all(x is None for x in xs) else dict(zip(names, xs))

    return table(per_leaf), table(periods)


@torch.library.custom_op("eryn_tpu_torch::group_stretch_propose",
                         mutates_args=())
def _group_stretch_op(
        s: list[Tensor], s_inds: list[Tensor], c: list[Tensor],
        c_inds: list[Tensor], u: Tensor, uu: list[Tensor], skip: list[int],
        a: float, log_proposal: bool, per_leaf: list[Optional[Tensor]],
        periods: list[Optional[Tensor]]) -> list[Tensor]:
    names = [str(k) for k in range(len(s))]
    q, factors = group_stretch_propose(
        *(dict(zip(names, x)) for x in (s, s_inds, c, c_inds)), u,
        dict(zip(names, uu)), tuple(skip), a, log_proposal,
        *_as_tables(names, per_leaf, periods))
    return [q[n] for n in names] + [factors]


@_group_stretch_op.register_vmap
def _(info, in_dims, s, s_inds, c, c_inds, u, uu, skip, a, log_proposal,
      per_leaf, periods):
    if any(d is not None for d in (in_dims[9] or []) + (in_dims[10] or [])):
        raise ValueError(
            "group_stretch_propose under vmap: the per-leaf dimensions and "
            "the periods are the move's, shared by every group.")
    names = [str(k) for k in range(len(s))]

    def lead(xs, dims):
        return dict(zip(names, _grouped.leading_all(info, xs, dims)))

    q, factors = group_stretch_propose_grouped(
        lead(s, in_dims[0]), lead(s_inds, in_dims[1]), lead(c, in_dims[2]),
        lead(c_inds, in_dims[3]), _grouped.leading(info, u, in_dims[4]),
        lead(uu, in_dims[5]), tuple(skip), a, log_proposal,
        *_as_tables(names, per_leaf, periods))
    return [q[n] for n in names] + [factors], [0] * (len(names) + 1)
