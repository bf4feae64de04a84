"""Device meshes for the sampler: explicit SPMD over ``torch.distributed``.

Port of :mod:`eryn_tpu.parallel.mesh`.  ``eryn_tpu`` places the ``(ntemps,
nwalkers)`` axes of a ``State`` on a ``jax.sharding.Mesh`` and lets GSPMD
partition one program.  Here every device runs its own process (a rank:
``torchrun``, or :func:`~eryn_tpu_torch.parallel._spawn.launch`), the mesh
is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks, and each
rank holds its shard of the state and exchanges what a step needs with the
collectives of :mod:`~eryn_tpu_torch.parallel._comm`.

:func:`make_mesh` builds the 2-D ``("temp", "walker")`` mesh and
:func:`make_group_mesh` the 1-D ``("group",)`` mesh of
:class:`~eryn_tpu_torch.parallel.ParaEnsembleSampler`.  :func:`shard_state`
keeps the rank's shard of a state: a leaf whose leading dims are ``(ntemps,
nwalkers)`` is split over ``(temp, walker)``, every other leaf (the ladder)
is whole on every rank (:func:`sharding_for_state`).  A sampler given a
sharded state runs the sharded step (:class:`MeshLayout`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from . import _comm

__all__ = [
    "GROUP_AXIS",
    "MeshLayout",
    "StateSharding",
    "TEMP_AXIS",
    "WALKER_AXIS",
    "constrain_state",
    "make_group_mesh",
    "make_mesh",
    "map_rows",
    "mesh_of_state",
    "place_leaves",
    "shard_state",
    "sharding_for_state",
]

TEMP_AXIS = "temp"
WALKER_AXIS = "walker"
GROUP_AXIS = "group"


def _world_size(n_devices):
    """The mesh's rank count: ``n_devices``, which the process group must
    hold (default: all of its ranks)."""
    if not dist.is_initialized():
        raise RuntimeError(
            "A device mesh spans the ranks of torch.distributed's process "
            "group: start one process per device (torchrun) and call "
            "torch.distributed.init_process_group first.")
    world = dist.get_world_size()
    if n_devices is None:
        n_devices = world
    if world < n_devices:
        raise ValueError(
            f"Requested mesh over {n_devices} devices but only {world} "
            "available.")
    return int(n_devices)


def _device_type():
    """The mesh's devices: the rank's card where CUDA is available, else
    the CPU."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def make_group_mesh(n_devices=None):
    """1-D mesh over the independent-ensemble ``group`` axis, over the
    first ``n_devices`` ranks (default: all), as ``eryn_tpu``'s
    ``make_group_mesh``: the groups never communicate."""
    from torch.distributed.device_mesh import init_device_mesh

    n = _world_size(n_devices)
    return init_device_mesh(_device_type(), (n,),
                            mesh_dim_names=(GROUP_AXIS,))


def make_mesh(n_devices=None, temp_parallel=None):
    """Build a 2-D ``(temp, walker)`` device mesh.

    Args:
        n_devices: ranks in the mesh (default: all of the process group's).
        temp_parallel: size of the mesh's temperature axis (default: 2 when
            ``n_devices`` is even and > 2, else 1: the walker axis is the
            primary data-parallel axis, since ``nwalkers >> ntemps``).

    On a machine with CUDA the mesh's devices are the ranks' current
    cards, else the CPU.
    """
    from torch.distributed.device_mesh import init_device_mesh

    n = _world_size(n_devices)
    if temp_parallel is None:
        temp_parallel = 2 if (n % 2 == 0 and n > 2) else 1
    if n % temp_parallel != 0:
        raise ValueError("n_devices must be divisible by temp_parallel.")
    return init_device_mesh(_device_type(),
                            (temp_parallel, n // temp_parallel),
                            mesh_dim_names=(TEMP_AXIS, WALKER_AXIS))


def _spec_for_leaf(x, ntemps, nwalkers):
    """Partition rule: shard leading (ntemps, nwalkers) dims; replicate
    everything else (the ladder, scalars)."""
    shape = tuple(getattr(x, "shape", ()))
    if len(shape) >= 2 and shape[0] == ntemps and shape[1] == nwalkers:
        return (TEMP_AXIS, WALKER_AXIS) + (None,) * (len(shape) - 2)
    return ()


def _ensemble_dims(state):
    """``(ntemps, nwalkers)`` of a state, evaluated or not."""
    if state.log_like is not None:
        return tuple(state.log_like.shape)
    first = next(iter(state.branches.values()))
    return tuple(first.coords.shape[:2])


class MeshLayout:
    """Where this rank's shard lies in a ``(temp, walker)`` mesh, and the
    mesh's collectives on it.

    ``ntemps`` and ``nwalkers`` are the global ensemble dims, ``nt``/``nw``
    the shard's, ``t0``/``w0`` its offsets; ``tp``/``wp`` the mesh's sizes
    and ``ti``/``wi`` this rank's coordinates on it; ``device`` the rank's
    device.  ``ranks[ti][wi]`` is the global rank at a mesh coordinate.

    Every exchange of the sharded step is planned on the device: its split
    sizes are the mesh's and the ensemble's, whatever the state, and the
    indices it reads (a permutation, a cascade's origins) stay there.
    """

    def __init__(self, mesh, ntemps, nwalkers):
        names = tuple(mesh.mesh_dim_names or ())
        if names != (TEMP_AXIS, WALKER_AXIS):
            raise ValueError(
                "A state is sharded over a (temp, walker) mesh (make_mesh); "
                f"got dimensions {names}.")
        self.mesh = mesh
        self.tp, self.wp = (int(s) for s in mesh.shape)
        coord = mesh.get_coordinate()
        if coord is None:
            raise ValueError("This rank is not in the mesh.")
        self.ti, self.wi = (int(c) for c in coord)
        self.ntemps, self.nwalkers = int(ntemps), int(nwalkers)
        if self.ntemps % self.tp or self.nwalkers % self.wp:
            raise ValueError(
                f"An ensemble of {self.ntemps} temperatures x {self.nwalkers} "
                f"walkers does not split evenly over a ({self.tp}, "
                f"{self.wp}) (temp, walker) mesh.")
        self.nt = self.ntemps // self.tp
        self.nw = self.nwalkers // self.wp
        self.t0, self.w0 = self.ti * self.nt, self.wi * self.nw
        self.ranks = mesh.mesh.tolist()
        self.rank = self.ranks[self.ti][self.wi]
        self.size = self.tp * self.wp
        self.device = _rank_device(mesh.device_type)
        self.world = _mesh_group(mesh)
        #: whether the mesh's collectives are NCCL's, which a CUDA graph can
        #: capture (gloo's cannot)
        self.nccl = _needs_device(self.world)
        self.temp_group = mesh.get_group(TEMP_AXIS)
        self.walker_group = mesh.get_group(WALKER_AXIS)
        # the walker shards of this temperature shard, in the walker
        # group's rank order
        row = self.ranks[self.ti]
        self._walker_order = [row.index(r) for r in
                              self._group_order(self.walker_group, row)]

    def local(self, x):
        """This rank's shard of a global ``(ntemps, nwalkers, ...)``
        tensor."""
        return x[self.t0:self.t0 + self.nt, self.w0:self.w0 + self.nw]

    # ------------------------------------------------------------------
    # whole-mesh gathers of sharded values (getters, the audit, the step)
    # ------------------------------------------------------------------
    def _rank_order(self):
        """Mesh coordinate ``(ti, wi)`` of each rank of the mesh's group, in
        that group's rank order."""
        order = [None] * self.size
        group_ranks = dist.get_process_group_ranks(self.world)
        for ti, row in enumerate(self.ranks):
            for wi, r in enumerate(row):
                order[group_ranks.index(r)] = (ti, wi)
        return order

    def gather(self, x, axis=0):
        """The global tensor of which ``x`` is this rank's shard along axes
        ``(axis, axis + 1)`` (``(nt, nw)`` there), gathered over the whole
        mesh on ``x``'s device (:meth:`gather_axes`)."""
        return self.gather_axes(x, axis, axis + 1)

    # ------------------------------------------------------------------
    # the sharded step's exchanges
    # ------------------------------------------------------------------
    def walker_view(self, x):
        """A walker-order view ``(nt, nwalkers, ...)`` of this rank's
        temperatures from its shard ``x`` ``(nt, nw, ...)``: its own walkers
        in place, zeros elsewhere (the rows only this rank writes: its
        log-likelihood, log-prior and blobs in a red/blue move)."""
        out = x.new_zeros((self.nt, self.nwalkers) + tuple(x.shape[2:]))
        out[:, self.w0:self.w0 + self.nw] = x
        return out

    def own(self, x):
        """This rank's walkers ``(nt, nw, ...)`` of a walker-order view."""
        return x[:, self.w0:self.w0 + self.nw].contiguous()

    def gather_walkers(self, tensors):
        """Walker-order views ``(nt, nwalkers, ...)`` of ``tensors`` (this
        rank's ``(nt, nw, ...)`` shards) with every walker of the rank's
        temperatures filled: each rank of the temperature shard sends its
        rows to every other one in one ``all_to_all_single`` over the walker
        axis, all tensors packed as bytes (bool leaf masks among them).  The
        split sizes are the mesh's, ``nt`` rows of each of ``nw`` walkers
        from each other rank, whatever the state.  New tensors, which the
        caller may write."""
        tensors = list(tensors)
        if self.wp == 1:
            return [x.clone(memory_format=torch.contiguous_format)
                    for x in tensors]
        nw = self.nw
        flat = [x.transpose(0, 1).reshape(nw, -1) for x in tensors]
        rows = _pack(flat)
        splits = [0 if p == self.wi else nw for p in self._walker_order]
        out = rows.new_empty(((self.wp - 1) * nw, rows.shape[1]))
        _comm.all_to_all_single(out, rows.repeat(self.wp - 1, 1), splits,
                                splits, group=self.walker_group)
        full = rows.new_empty((self.nwalkers, rows.shape[1]))
        k = 0
        for p in self._walker_order:
            if p == self.wi:
                full[p * nw:(p + 1) * nw] = rows
            else:
                full[p * nw:(p + 1) * nw] = out[k * nw:(k + 1) * nw]
                k += 1
        return [y.reshape((self.nwalkers, self.nt) + tuple(x.shape[2:]))
                .transpose(0, 1).contiguous()
                for y, x in zip(_unpack(full, flat), tensors)]

    def own_positions(self, walkers):
        """``(pos, valid)`` for a red/blue block whose walkers are
        ``walkers`` (global indices, ``(ns,)``, on the device, in block
        order): the positions in the block of this rank's walkers, in block
        order, then of other ranks' walkers, cut to ``min(nw, ns)`` (the
        most of the block a rank can hold: a count of the mesh, not of the
        permutation), and whether each is this rank's.  The rows at ``pos``
        are the ones the rank evaluates; the others are padding, whose
        results the caller discards."""
        ns = walkers.shape[0]
        if self.wp == 1:
            return (torch.arange(ns, device=walkers.device),
                    torch.ones(ns, dtype=torch.bool, device=walkers.device))
        mine = (walkers >= self.w0) & (walkers < self.w0 + self.nw)
        pos = torch.argsort((~mine).to(torch.uint8), stable=True)[
            :min(self.nw, ns)]
        return pos, mine[pos]

    def share_rows(self, values, walkers, pos, valid):
        """Every walker's row of a block, in block order ``(nt, ns, ...)``,
        from each rank's rows ``values`` (each ``(nt, len(pos), ...)``) at
        the positions ``pos`` of :meth:`own_positions`, the ``valid`` ones
        the rank's: each rank puts its walkers' rows in place and the
        temperature shard exchanges them (:meth:`gather_walkers`)."""
        values = list(values)
        if self.wp == 1:
            return values
        # padding rows land in a last column, which is dropped
        slot = torch.where(valid, walkers[pos] - self.w0, self.nw)
        own = []
        for v in values:
            buf = v.new_zeros((self.nt, self.nw + 1) + tuple(v.shape[2:]))
            buf[:, slot] = v
            own.append(buf[:, :self.nw])
        return [x[:, walkers] for x in self.gather_walkers(own)]

    def _group_order(self, group, members):
        """``members`` (global ranks) in ``group``'s rank order."""
        ranks = dist.get_process_group_ranks(group)
        return sorted(members, key=ranks.index)

    def gather_rung(self, tensors, t=0):
        """Rung ``t`` of every walker, ``(nwalkers, ...)``, of each
        ``(nt, nw, ...)`` tensor of ``tensors`` (this rank's shards), on
        every rank: the ranks of the temperature shard that holds the rung
        send their rows of it to every other rank in one
        ``all_to_all_single`` over the mesh (all tensors packed as bytes),
        so each rank receives the rung's rows it lacks and nothing else."""
        locs = list(tensors)
        holder = t // self.nt
        mine = self.ti == holder
        # a rank outside the holding shard sends nothing; its row 0 gives
        # the packed width
        rows = _pack([x[t - self.t0 if mine else 0].reshape(self.nw, -1)
                      for x in locs])
        order = dist.get_process_group_ranks(self.world)
        coords = {r: (ti, wi) for ti, row in enumerate(self.ranks)
                  for wi, r in enumerate(row)}
        in_splits, out_splits, sources = [], [], []
        for r in order:
            other = r != self.rank
            in_splits.append(self.nw if mine and other else 0)
            held = coords[r][0] == holder and other
            out_splits.append(self.nw if held else 0)
            if held:
                sources.append(coords[r][1])
        inp = rows.repeat(sum(1 for n in in_splits if n), 1)
        out = rows.new_empty((sum(out_splits), rows.shape[1]))
        _comm.all_to_all_single(out, inp, out_splits, in_splits,
                                group=self.world)
        full = rows.new_empty((self.nwalkers, rows.shape[1]))
        for k, wi in enumerate(sources):
            full[wi * self.nw:(wi + 1) * self.nw] = out[k * self.nw:
                                                        (k + 1) * self.nw]
        if mine:
            full[self.w0:self.w0 + self.nw] = rows
        like = [x[0].reshape(self.nw, -1) for x in locs]
        return [y.reshape((self.nwalkers,) + tuple(x.shape[2:]))
                for y, x in zip(_unpack(full, like), locs)]

    def move_rows(self, leaves, origin):
        """Every leaf ``(nt, nw, ...)`` of this rank's shard after a swap
        cascade, each slot ``(t, w)`` taking the row of the global slot
        ``origin[t0 + t, w0 + w]`` (a flat ``t * nwalkers + w``; ``origin``
        is the whole ``(ntemps, nwalkers)`` map on the device, equal on
        every rank).  In a cascade a row moves at most one rung up, and at
        most ``nwalkers`` rows cross a rung boundary downwards (one a
        pairing), so the exchanges are static, as ``eryn_tpu``'s
        boundary-local cascade's: the rank's temperatures' rows over the
        walker axis (:meth:`gather_walkers`), then, from the top shard of
        the ladder down, one batch of point-to-point exchanges at each
        boundary between temperature shards, in which the upper shard sends
        the ``nwalkers`` rows that may cross downwards (the origins that
        cross, sorted, which both sides compute from ``origin``) and the
        lower shard its top rung.  All leaves travel packed as bytes."""
        NW, nt = self.nwalkers, self.nt
        n = nt * NW
        o = origin.reshape(self.ntemps, NW).to(torch.int64)
        full = self.gather_walkers(leaves)
        rows = _pack([x.reshape(n, -1) for x in full])
        # the table the slots read: this shard's rows, the top rung of the
        # shard below, the rows that crossed down from the shard above
        table = torch.cat([rows, rows.new_zeros((2 * NW, rows.shape[1]))])
        lo, hi = self.t0 * NW, (self.t0 + nt) * NW
        above = below = crossed = None
        if self.ti + 1 < self.tp:
            above = self.ranks[self.ti + 1][self.wi]
            crossed = _crossing(o, self.t0 + nt)
        if self.ti > 0:
            below = self.ranks[self.ti - 1][self.wi]

        def source(v):
            """Rows of ``table`` holding the origins ``v``."""
            idx = (v - lo).clamp(0, n - 1)
            if below is not None:
                idx = torch.where(v // NW == self.t0 - 1, n + v % NW, idx)
            if crossed is not None:
                at = torch.searchsorted(crossed, v).clamp(max=NW - 1)
                idx = torch.where(v >= hi, n + NW + at, idx)
            return idx

        if above is not None:
            _comm.batch_isend_irecv([(rows[n - NW:], above)],
                                    [(table[n + NW:], above)],
                                    group=self.world)
        if below is not None:
            down = table[source(_crossing(o, self.t0))]
            _comm.batch_isend_irecv([(down, below)],
                                    [(table[n:n + NW], below)],
                                    group=self.world)
        mine = self.local(o).reshape(-1)
        new = table[source(mine)]
        flat = [x.reshape(nt * self.nw, -1) for x in leaves]
        return [y.reshape(x.shape) for y, x in zip(_unpack(new, flat), leaves)]

    def temp_halo(self, tensors):
        """Each ``(nt, nw, ...)`` tensor with the neighbouring temperature
        shards' edge rungs around it: ``(nt + 2, nw, ...)`` with row 0 the
        rung below ``t0`` and the last row the rung above this shard's
        last, where those exist (a shard at an end of the ladder has one
        fewer row).  One batch of point-to-point exchanges with the two
        neighbours of this walker shard."""
        below = self.ranks[self.ti - 1][self.wi] if self.ti > 0 else None
        above = (self.ranks[self.ti + 1][self.wi] if self.ti + 1 < self.tp
                 else None)
        first = _pack([x[0].reshape(1, -1) for x in tensors])
        last = _pack([x[-1].reshape(1, -1) for x in tensors])
        sends, recvs = [], []
        from_below = from_above = None
        if below is not None:
            from_below = torch.empty_like(first)
            sends.append((first, below))
            recvs.append((from_below, below))
        if above is not None:
            from_above = torch.empty_like(last)
            sends.append((last, above))
            recvs.append((from_above, above))
        _comm.batch_isend_irecv(sends, recvs, group=self.world)
        rows = [x[:1] for x in tensors]
        lo = (_unpack(from_below, rows) if from_below is not None
              else [x[:0] for x in tensors])
        hi = (_unpack(from_above, rows) if from_above is not None
              else [x[:0] for x in tensors])
        return [torch.cat([a, x, b]) for a, x, b in zip(lo, tensors, hi)]

    def sum(self, t):
        """Sum ``t`` over the mesh, in place."""
        return _comm.all_reduce(t, group=self.world)

    @property
    def writer(self):
        """Whether this rank writes what the mesh stores once (an HDF5
        file): the mesh's first rank, ``ranks[0][0]``."""
        return self.rank == self.ranks[0][0]

    def barrier(self):
        """Wait for every rank of the mesh (a file's readers for its
        writer)."""
        _comm.barrier(group=self.world)

    def writer_says(self, flag):
        """``flag`` as the writer rank has it, on every rank (one
        all-reduce of one number): a decision, such as stopping a run, that
        no rank may take alone."""
        comm = self.device if _needs_device(self.world) else torch.device("cpu")
        t = torch.tensor([1.0 if (flag and self.writer) else 0.0],
                         device=comm)
        self.sum(t)
        return bool(t.item() > 0)

    def gather_axes(self, x, taxis=None, waxis=None):
        """The global tensor of which ``x`` is this rank's block along the
        temperature axis ``taxis`` (``nt`` long there) and the walker axis
        ``waxis`` (``nw``); either is None where ``x`` is whole along it,
        and the block is then taken from the ranks at coordinate 0 of that
        mesh axis.  One all-gather over the mesh; bool tensors travel as
        bytes."""
        x = x.contiguous()
        send = x.view(torch.uint8) if x.dtype == torch.bool else x
        out = send.new_empty((self.size * send.numel(),))
        _comm.all_gather_into_tensor(out, send.reshape(-1), group=self.world)
        out = out.view((self.size,) + tuple(send.shape))
        shape = list(send.shape)
        if taxis is not None:
            shape[taxis] = self.ntemps
        if waxis is not None:
            shape[waxis] = self.nwalkers
        full = send.new_empty(shape)
        for block, (ti, wi) in zip(out, self._rank_order()):
            if (taxis is None and ti) or (waxis is None and wi):
                continue
            idx = [slice(None)] * len(shape)
            if taxis is not None:
                idx[taxis] = slice(ti * self.nt, (ti + 1) * self.nt)
            if waxis is not None:
                idx[waxis] = slice(wi * self.nw, (wi + 1) * self.nw)
            full[tuple(idx)] = block
        return full.view(torch.bool) if x.dtype == torch.bool else full

    def take_axes(self, x, taxis=None, waxis=None):
        """This rank's block of a global ``x`` along ``taxis`` and
        ``waxis`` (either None: whole there); NumPy arrays or tensors."""
        idx = [slice(None)] * x.ndim
        if taxis is not None:
            idx[taxis] = slice(self.t0, self.t0 + self.nt)
        if waxis is not None:
            idx[waxis] = slice(self.w0, self.w0 + self.nw)
        return x[tuple(idx)]

    def gather_numpy(self, a, axis=0):
        """:meth:`gather` of a host array, through the mesh's device."""
        return self.gather_axes_numpy(a, axis, axis + 1)

    def gather_axes_numpy(self, a, taxis=None, waxis=None):
        """:meth:`gather_axes` of a host array, through the mesh's
        device."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        comm = self.device if _needs_device(self.world) else torch.device("cpu")
        return self.gather_axes(t.to(comm), taxis, waxis).cpu().numpy()

    def gather_state(self, state):
        """The whole ensemble's state of which ``state`` is this rank's
        shard: every per-walker tensor (coordinates, leaf masks,
        log-likelihood, log-prior, blobs, the numeric supplemental entries)
        gathered over the mesh; the ladder and the host objects are whole
        on every rank already."""
        return map_rows(state, self.gather, (self.nt, self.nw))

    def local_state(self, state):
        """This rank's shard of a whole-ensemble state (the inverse of
        :meth:`gather_state`)."""
        return map_rows(state, self.local, (self.ntemps, self.nwalkers))

    def placement(self):
        """What identifies where this rank's shard lies: the mesh's shape,
        the rank's coordinates and the global dims."""
        return (self.tp, self.wp, self.ti, self.wi, self.ntemps,
                self.nwalkers)


def same_placement(a, b):
    """Whether two :class:`MeshLayout` (or None, the whole ensemble in
    every process) place a rank's rows alike."""
    if a is None or b is None:
        return a is b
    return a.placement() == b.placement()


def convert_rows(x, taxis, waxis, src, dst):
    """``x`` (a tensor or a NumPy array), whose axis ``taxis`` runs over
    temperatures and ``waxis`` over walkers (either None: ``x`` has no such
    axis), laid out by placement ``src`` (a :class:`MeshLayout`, or None
    for the whole ensemble in every process), as ``dst`` lays it out:
    gathered over ``src``'s mesh (a collective: every rank of it calls
    this together) and cut to ``dst``'s rows."""
    if same_placement(src, dst):
        return x
    numpy = isinstance(x, np.ndarray)
    if src is not None:
        gt = taxis if src.tp > 1 else None
        gw = waxis if src.wp > 1 else None
        if gt is not None or gw is not None:
            x = (src.gather_axes_numpy(x, gt, gw) if numpy
                 else src.gather_axes(x, gt, gw))
    if dst is not None:
        x = dst.take_axes(x, taxis if dst.tp > 1 else None,
                          waxis if dst.wp > 1 else None)
        x = np.ascontiguousarray(x) if numpy else x.contiguous()
    return x


def map_rows(state, fn, dims):
    """``state`` with ``fn`` applied to every tensor whose leading dims are
    ``dims`` (the per-walker fields; the ladder is left as it is)."""
    def rows(x):
        return (fn(x).contiguous()
                if x.ndim >= 2 and tuple(x.shape[:2]) == dims else x)

    return state.map_tensors(rows)


def place_leaves(leaves, axes, src, dst):
    """A kernel state's leaves (tensors, NumPy arrays, or None where one
    could not be stored) of placement ``src`` laid out by ``dst``, along
    each leaf's ``(rung, walker)`` axes ``axes``
    (:meth:`~eryn_tpu_torch.moves.Move.kernel_state_axes` of the kernel
    state made on ``dst``)."""
    if same_placement(src, dst) or len(axes) != len(leaves):
        return leaves  # restore_kernel_state names a changed structure
    return [x if x is None or ax == (None, None)
            else convert_rows(x if isinstance(x, torch.Tensor)
                              else np.asarray(x), *ax, src, dst)
            for x, ax in zip(leaves, axes)]


def _crossing(origin, b):
    """The origins of the rows that cross the rung boundary ``b`` downwards
    in a swap cascade whose slots took the rows ``origin`` (the whole
    ``(ntemps, nwalkers)`` flat map): those of a slot below ``b`` from a
    rung at ``b`` or above, sorted, padded to ``nwalkers`` with
    ``ntemps * nwalkers``."""
    ntemps, nw = origin.shape
    keys = origin[:b].reshape(-1)
    keys = torch.where(keys >= b * nw, keys, ntemps * nw)
    return torch.sort(keys).values[:nw].contiguous()


def _pack(rows):
    """``(n, k_i)`` tensors of any dtypes as one ``(n, sum bytes)`` uint8
    tensor, row by row."""
    # through a flat view: a contiguous tensor with a dim of size 1 may
    # keep any stride there, which a view as bytes refuses
    return torch.cat([r.contiguous().reshape(-1).view(torch.uint8)
                      .reshape(r.shape[0], -1) for r in rows], dim=1)


def _unpack(packed, like):
    """Split ``packed`` (from :func:`_pack`) back into tensors of the dtypes
    and trailing shapes of ``like``, one per row of ``packed``."""
    out, off = [], 0
    n = packed.shape[0]
    for x in like:
        per_row = (x.numel() // max(x.shape[0], 1)) * x.element_size()
        # a copy with the rows' own stride: a view of a single row keeps
        # the packed row's stride, which a wider dtype cannot view
        chunk = packed[:, off:off + per_row].clone(
            memory_format=torch.contiguous_format)
        off += per_row
        out.append(chunk.view(x.dtype).reshape((n,) + tuple(x.shape[1:])))
    return out


def _needs_device(group):
    """Whether ``group``'s collectives need device tensors (NCCL)."""
    return dist.get_backend(group) == "nccl"


def _rank_device(device_type):
    if device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device_type)


def _mesh_group(mesh):
    """The process group of all of the mesh's ranks."""
    ranks = sorted(mesh.mesh.flatten().tolist())
    if ranks == list(range(dist.get_world_size())):
        return dist.group.WORLD
    return dist.new_group(ranks)


class StateSharding:
    """How a state lies on a mesh: the mesh, the global ``(ntemps,
    nwalkers)``, each tensor leaf's partition spec (``("temp", "walker",
    None, ...)`` or ``()`` for a whole leaf, by the leaf's path in
    :meth:`~eryn_tpu_torch.state.State.tensor_leaves`) and the rank's
    :class:`MeshLayout`."""

    def __init__(self, mesh, dims, specs, layout=None):
        self.mesh = mesh
        self.ntemps, self.nwalkers = dims
        self.specs = specs
        self.layout = layout

    def __repr__(self):
        return (f"StateSharding(mesh={tuple(self.mesh.shape)}, "
                f"global=({self.ntemps}, {self.nwalkers}))")


def sharding_for_state(state, mesh):
    """The :class:`StateSharding` of ``state`` on ``mesh``: per leaf the
    partition spec of ``eryn_tpu``'s rule (works before evaluation too: the
    ensemble dims then come from the coordinates)."""
    dims = _ensemble_dims(state)
    specs = {path: _spec_for_leaf(x, *dims)
             for path, x in state.tensor_leaves()}
    return StateSharding(mesh, dims, specs)


def shard_state(state, mesh):
    """This rank's shard of ``state`` on ``mesh``, on the rank's device
    (its current card on a ``"cuda"`` mesh, else the CPU).  Every rank
    passes the same global state.  The result records the mesh and the
    global shape (``state.sharding``); a sampler given it runs the sharded
    step."""
    sharding = sharding_for_state(state, mesh)
    layout = MeshLayout(mesh, sharding.ntemps, sharding.nwalkers)
    sharding.layout = layout
    dims = (sharding.ntemps, sharding.nwalkers)

    def place(x):
        if _spec_for_leaf(x, *dims):
            x = layout.local(x)
        return x.to(layout.device).contiguous()

    local = state.map_tensors(place)
    local.sharding = sharding
    return local


def mesh_of_state(state):
    """The mesh a sharded state lies on, or None for a state that is not
    sharded or a mesh of one rank."""
    sharding = getattr(state, "sharding", None)
    if sharding is None or sharding.layout is None:
        return None
    if sharding.layout.size <= 1:
        return None
    return sharding.mesh


def constrain_state(state, mesh):
    """Check that every sharded leaf of ``state`` is this rank's shard on
    ``mesh`` (the shard's shape, on the rank's device) and every other leaf
    whole; returns ``state``, or raises ``ValueError``.  (``eryn_tpu``
    anchors a traced state's sharding here; explicit SPMD has nothing to
    anchor, so the port checks.)"""
    sharding = getattr(state, "sharding", None)
    if sharding is None or sharding.mesh is not mesh:
        raise ValueError("The state is not sharded over this mesh "
                         "(shard_state).")
    layout = sharding.layout
    for path, x in state.tensor_leaves():
        spec = sharding.specs.get(path)
        if spec is None:
            raise ValueError(f"Leaf {path} is not part of the sharded state.")
        if spec:
            want = (layout.nt, layout.nw)
            if tuple(x.shape[:2]) != want:
                raise ValueError(
                    f"Leaf {path} has leading dims {tuple(x.shape[:2])}; this "
                    f"rank's shard is {want}.")
        if x.device != layout.device:
            raise ValueError(
                f"Leaf {path} lies on {x.device}, not on the rank's device "
                f"{layout.device}.")
    return state
