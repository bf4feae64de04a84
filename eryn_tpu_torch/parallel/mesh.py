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
    "mesh_of_state",
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
        self.temp_group = mesh.get_group(TEMP_AXIS)
        self.walker_group = mesh.get_group(WALKER_AXIS)

    def local(self, x):
        """This rank's shard of a global ``(ntemps, nwalkers, ...)``
        tensor."""
        return x[self.t0:self.t0 + self.nt, self.w0:self.w0 + self.nw]

    def owner(self, t, w):
        """Global rank holding the global slot ``(t, w)`` (NumPy arrays or
        ints)."""
        ranks = np.asarray(self.ranks)
        return ranks[np.asarray(t) // self.nt, np.asarray(w) // self.nw]

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
        in place, zeros elsewhere until :meth:`fill_rows` fills them."""
        out = x.new_zeros((self.nt, self.nwalkers) + tuple(x.shape[2:]))
        out[:, self.w0:self.w0 + self.nw] = x
        return out

    def own(self, x):
        """This rank's walkers ``(nt, nw, ...)`` of a walker-order view."""
        return x[:, self.w0:self.w0 + self.nw].contiguous()

    def gather_walkers(self, tensors):
        """Walker-order views of ``tensors`` (this rank's shards) with every
        walker filled: each walker shard's rows gathered within the
        temperature shard in one exchange."""
        views = [self.walker_view(x) for x in tensors]
        self.fill_rows(views, list(tensors), np.arange(self.nwalkers))
        return views

    def _group_order(self, group, members):
        """``members`` (global ranks) in ``group``'s rank order."""
        ranks = dist.get_process_group_ranks(group)
        return sorted(members, key=ranks.index)

    def fill_rows(self, buf, local, walkers):
        """Write into ``buf``, a walker-order view ``(nt, nwalkers, ...)`` of
        this rank's temperatures, the rows of every walker of ``walkers``
        (global indices, on the host; every rank of the temperature shard
        passes the same) that another rank of this temperature shard holds,
        and send that rank the rows it needs from ``local``, this rank's
        ``(nt, nw, ...)``: one ``all_to_all_single`` over the walker axis,
        carrying ``nt`` rows of each walker not held here.

        ``buf`` and ``local`` are a tensor each, or lists of tensors of one
        length (several leaves of any dtypes, the bool leaf masks among
        them), whose rows then travel packed as bytes in the one
        exchange."""
        if self.wp == 1:
            return
        bufs = [buf] if isinstance(buf, torch.Tensor) else list(buf)
        locs = [local] if isinstance(local, torch.Tensor) else list(local)
        w = np.sort(np.asarray(walkers))
        shard = w // self.nw
        dev = bufs[0].device
        mine = torch.as_tensor(w[shard == self.wi] - self.w0, device=dev)
        count = int(mine.numel())
        # a walker's rows of every leaf: (count, nt * ...) each, as bytes
        flat = [x[:, mine].transpose(0, 1).reshape(count, x[:, :1].numel())
                for x in locs]
        rows = _pack(flat)
        sends, in_splits, out_splits, dest = [], [], [], []
        row_ranks = self.ranks[self.ti]
        for r in self._group_order(self.walker_group, row_ranks):
            p = row_ranks.index(r)
            if p == self.wi:
                in_splits.append(0)
                out_splits.append(0)
                continue
            sends.append(rows)
            in_splits.append(count)
            theirs = w[shard == p]
            out_splits.append(theirs.size)
            dest.append(theirs)
        inp = torch.cat(sends).contiguous()
        out = inp.new_empty((sum(out_splits), rows.shape[1]))
        _comm.all_to_all_single(out, inp, out_splits, in_splits,
                                group=self.walker_group)
        idx = torch.as_tensor(np.concatenate(dest), device=dev)
        # one row of each leaf gives _unpack its dtype and row width
        like = [x[:, :1].transpose(0, 1).reshape(1, -1) for x in locs]
        for b, got in zip(bufs, _unpack(out, like)):
            b[:, idx] = got.reshape((idx.numel(), b.shape[0])
                                    + tuple(b.shape[2:])).transpose(0, 1)

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
        """Every leaf ``(nt, nw, ...)`` of this rank's shard, each slot
        ``(t, w)`` taking the row of the global slot ``origin[t0 + t, w0 +
        w]`` (a flat ``t * nwalkers + w``; ``origin`` is the whole
        ``(ntemps, nwalkers)`` map, equal on every rank).  Rows held here
        are copied; the others arrive in one ``all_to_all_single`` over the
        mesh, all leaves packed as bytes, each row once."""
        NW = self.nwalkers
        o = origin.cpu().numpy().astype(np.int64)
        owner = self.owner(o // NW, o % NW)
        # the row's flat index in its owner's shard
        src = (o // NW % self.nt) * self.nw + (o % NW % self.nw)
        n = self.nt * self.nw
        dev = leaves[0].device
        flat = [x.reshape(n, -1) for x in leaves]
        packed = _pack(flat)
        new = packed.new_empty(packed.shape)
        mine_owner = self.local(owner).reshape(-1)
        mine_src = self.local(src).reshape(-1)
        here = np.flatnonzero(mine_owner == self.rank)
        new[torch.as_tensor(here, device=dev)] = packed[
            torch.as_tensor(mine_src[here], device=dev)]
        send, in_splits, out_splits, recv_at = [], [], [], []
        for r in dist.get_process_group_ranks(self.world):
            if r == self.rank:
                in_splits.append(0)
                out_splits.append(0)
                continue
            ti, wi = np.argwhere(np.asarray(self.ranks) == r)[0]
            blk = (slice(ti * self.nt, (ti + 1) * self.nt),
                   slice(wi * self.nw, (wi + 1) * self.nw))
            wanted = (owner[blk] == self.rank).reshape(-1)
            send.append(src[blk].reshape(-1)[wanted])
            in_splits.append(int(wanted.sum()))
            at = np.flatnonzero(mine_owner == r)
            recv_at.append(at)
            out_splits.append(at.size)
        inp = packed[torch.as_tensor(np.concatenate(send), device=dev)]
        out = packed.new_empty((sum(out_splits), packed.shape[1]))
        _comm.all_to_all_single(out, inp, out_splits, in_splits,
                                group=self.world)
        new[torch.as_tensor(np.concatenate(recv_at), device=dev)] = out
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


def _pack(rows):
    """``(n, k_i)`` tensors of any dtypes as one ``(n, sum bytes)`` uint8
    tensor, row by row."""
    return torch.cat([r.contiguous().view(torch.uint8) for r in rows], dim=1)


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
