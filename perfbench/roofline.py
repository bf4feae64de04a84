"""The table of peaks, and the operations and bytes of the port's
hand-written kernels and of a configuration's likelihood, from their
shapes: the least time the card could take for each.

The kernel counts are frozen copies of the ones ``chip_smoke.py`` uses
(``_stretch_bytes``, ``_group_bytes_ops``, the cascade's), with one change:
where those read the run's draws (which complement rows a proposal picks),
these take the expected number of distinct rows that uniform picks hit,
since the benchmark does not see the program's draws.  Every input byte is
counted read once and every output byte written once.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM data sheet, dense, at its 700 W limit
F32_OPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12


def least_s(ops, nbytes):
    """The larger of the compute and the memory bound, in seconds."""
    return max(ops / F32_OPS_PER_S, nbytes / HBM_BYTES_PER_S)


def distinct_picks(picks, rows):
    """Expected distinct rows among ``picks`` uniform draws over ``rows``."""
    if rows <= 0 or picks <= 0:
        return 0.0
    return rows * (1.0 - (1.0 - 1.0 / rows) ** picks)


def stretch(nt, nw, ndim, itemsize=4):
    """``{kernel: (ops, bytes)}`` of one launch of each fused stretch
    kernel at ``(nt, nw, ndim)`` (``_stretch_bytes`` and the ops of
    ``time_kernels``): a proposal reads its moving rows and the distinct
    complement rows its draws pick, per walker a stretch draw (4 ops), a
    pick (2), 3 ops a coordinate and the factor (3); an accept reads per
    walker the row its decision keeps, two tempered sums, a difference, a
    logarithm and a compare (10 ops) and a select a coordinate."""
    n0, n1 = nw - nw // 2, nw // 2
    d = ndim

    def propose(ns, nc, complement=True):
        rows = nt * ns + (nt * distinct_picks(ns, nc) if complement else 0)
        return (rows * d + 3 * nt * ns + nt * ns * (d + 1)) * itemsize + 8 * nw

    def accept(ns):
        return (nt * ns * (d + 6) + nt + nt * ns * (d + 3)) * itemsize + 8 * ns

    ops_p, ops_a = 3 * d + 9, d + 10
    return {
        "stretch_propose": (nt * n0 * ops_p, propose(n0, n1)),
        "stretch_accept_propose": (nt * (n0 * ops_a + n1 * ops_p),
                                   accept(n0) + propose(n1, n0, False)),
        "stretch_accept": (nt * n1 * ops_a, accept(n1)),
    }


def cascade(nt, nw, leaf_bytes_per_walker, itemsize=4):
    """``(ops, bytes)`` of one swap-phase launch (``pt_swap_cascade_tree``):
    the log-likelihood and every leaf read and written once (``leaf_bytes_
    per_walker``: the leaves the benchmark knows the phase moves, the
    coordinates, the log-prior and the masks), ``pi`` (int64), the shifts,
    the acceptance draws and the ladder read, the accepted counts written;
    per rung and walker a difference, a product and a compare."""
    nbytes = (2 * nt * nw * (itemsize + leaf_bytes_per_walker)
              + 8 * nw + 4 * (nt - 1) + itemsize * (nt - 1) * nw
              + itemsize * nt + itemsize * (nt - 1))
    return 3 * (nt - 1) * nw, nbytes


def group_stretch(nt, nw, nleaves, ndim, active_share, itemsize=4):
    """``(ops, bytes)`` of one ``group_stretch_propose`` launch for half of
    the walkers (``_group_bytes_ops``): both halves' masks, the moving
    rows read and written, the distinct active complement leaves that the
    moving active leaves pick, ``u``, ``uu``, ``q`` and the factors; per
    moving leaf the stretch factor (4), the pick (a product, a floor and a
    search over the mask's 32-bit words) and 3 operations a coordinate, per
    walker the factor (a logarithm, a product and an add a leaf).
    ``active_share``: the share of active leaves in the state."""
    ns = nw // 2
    moving = nt * ns * nleaves
    comp_active = ns * nleaves * active_share
    picks = ns * nleaves * active_share
    picked = nt * distinct_picks(picks, comp_active)
    nbytes = (2 * nt * ns * itemsize  # u read, factors written
              + nt * nw * nleaves  # the masks of both halves
              + moving * itemsize  # uu
              + (2 * moving * ndim + picked * ndim) * itemsize)
    words = -(-(ns * nleaves) // 32)
    ops = (moving * (4 + 2 + math.ceil(math.log2(max(words, 2))) + 3 * ndim)
           + nt * ns * (2 + nleaves))
    return ops, nbytes
