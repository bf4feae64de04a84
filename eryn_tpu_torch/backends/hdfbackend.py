"""Chain storage in an HDF5 file, with checkpoint and resume.

Port of :mod:`eryn_tpu.backends.hdfbackend`, writing the same schema (group
``name`` with attributes ``version``, ``nbranches``, ``branch_names``,
``ntemps``, ``nwalkers``, ``has_blobs``, ``rj`` and ``iteration``; groups
``info``, ``ndims``, ``nleaves_max`` and ``key_order``; datasets
``accepted``, ``swaps_accepted``, ``rj_accepted``, ``log_like``,
``log_prior``, ``betas`` and, once ``has_blobs``, ``blobs`` ``(nsteps,
ntemps, nwalkers, ...)`` in the blobs' dtype; ``chain/<branch>`` and ``inds/<branch>``;
``moves/<key>/acceptance_fraction``; ``kernel_states/<move>/<leaf>`` and the
attribute ``tempering_time``), so a file written by either package opens and
resumes in the other.

The sampler's two ``torch.Generator`` states are datasets of their own,
``torch_generator/device`` and ``torch_generator/host``, beside its
``numpy.random.RandomState`` (the host hooks' generator) as
``torch_generator/numpy``: ``eryn_tpu`` reads
the attribute ``prng_state_key`` as a JAX key and collects every attribute
named ``random_state_*``, so neither name may hold them.  A file written by
``eryn_tpu`` has neither dataset, and a port sampler resuming it seeds its
generators from ``seed=``.

Under a device mesh (:mod:`~eryn_tpu_torch.parallel.mesh`) the file holds
the whole ensemble, in the same schema: every rank gathers what it
stores, the mesh's first rank (``MeshLayout.writer``) writes it, and the
other ranks wait at a barrier after each write, so that a read on any rank
sees it.  Every rank reads the file.

``h5py`` is imported when a backend is made; without it the constructor
raises an ``ImportError``.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np

from .backend import Backend

__all__ = ["HDFBackend", "TempHDFBackend"]

_OPEN_RETRIES = 100
_OPEN_RETRY_SLEEP = 0.1
_GENERATORS = "torch_generator"


def _h5py():
    try:
        import h5py
    except ImportError:
        raise ImportError("You must install 'h5py' to use the HDFBackend") from None
    return h5py


def _retry(fn):
    """``fn()``, retried while another process holds the file's lock."""
    for attempt in range(_OPEN_RETRIES):
        try:
            return fn()
        except BlockingIOError:
            if attempt == _OPEN_RETRIES - 1:
                raise
            time.sleep(_OPEN_RETRY_SLEEP)


class HDFBackend(Backend):
    """HDF5 file backend.

    Args:
        filename: path of the HDF5 file.
        name: group name inside the file (default ``"mcmc"``).
        read_only: open the file read-only.
        dtype: NumPy dtype of the stored floats (default float64).
        compression, compression_opts: h5py dataset options.
    """

    def __init__(self, filename, name="mcmc", read_only=False, dtype=None,
                 compression=None, compression_opts=None,
                 store_missing_leaves=np.nan):
        _h5py()
        self.filename = filename
        self.name = name
        self.read_only = read_only
        self.compression = compression
        self.compression_opts = compression_opts
        self.store_missing_leaves = store_missing_leaves
        self.dtype = np.dtype(dtype) if dtype is not None else np.dtype(np.float64)

    @property
    def initialized(self):
        if not os.path.exists(self.filename):
            return False
        try:
            with self.open() as f:
                return self.name in f
        except OSError:
            return False

    def open(self, mode="r"):
        """The file, opened in ``mode``, retried while another process
        holds its lock."""
        if self.read_only and mode != "r":
            raise RuntimeError(
                "The backend has been loaded in read-only mode. Set "
                "`read_only = False` to make changes."
            )
        h5py = _h5py()
        return _retry(lambda: h5py.File(self.filename, mode))

    # ------------------------------------------------------------------
    def reset(self, nwalkers, ndims, nleaves_max=1, ntemps=1, branch_names=None,
              rj=False, moves=None, info=None, key_order=None):
        """Create the file's layout, replacing the group ``name``; this
        process writes it from here."""
        self._rows = self._ranks = None
        if branch_names is None:
            branch_names = ["model_0"]
        if isinstance(branch_names, str):
            branch_names = [branch_names]

        def per_branch(val):
            if isinstance(val, (int, np.integer)):
                return {bn: int(val) for bn in branch_names}
            return {k: int(v) for k, v in val.items()}

        self.nwalkers = int(nwalkers)
        self.ntemps = ntemps = int(ntemps)
        self.branch_names = list(branch_names)
        self.nbranches = len(branch_names)
        self.ndims = per_branch(ndims)
        self.nleaves_max = per_branch(nleaves_max)
        self.rj = rj
        self.move_keys = list(moves) if moves else None

        from .. import __version__

        opts = dict(compression=self.compression,
                    compression_opts=self.compression_opts)
        with self.open("a") as f:
            if self.name in f:
                del f[self.name]
            g = f.create_group(self.name)
            g.attrs["version"] = __version__
            g.attrs["nbranches"] = len(branch_names)
            g.attrs["branch_names"] = branch_names
            g.attrs["ntemps"] = ntemps
            g.attrs["nwalkers"] = nwalkers
            g.attrs["has_blobs"] = False
            g.attrs["rj"] = rj
            g.attrs["iteration"] = 0

            g.create_group("info")
            for key, value in (info or {}).items():
                try:
                    g["info"].attrs[key] = value
                except TypeError:  # not storable as an attribute
                    pass
            for group in ("ndims", "nleaves_max"):
                g.create_group(group)
                for key, value in getattr(self, group).items():
                    g[group].attrs[key] = value

            g.create_dataset("accepted", data=np.zeros((ntemps, nwalkers)),
                             **opts)
            g.create_dataset("swaps_accepted",
                             data=np.zeros((max(ntemps - 1, 0),)), **opts)
            if rj:
                g.create_dataset("rj_accepted",
                                 data=np.zeros((ntemps, nwalkers)), **opts)
            for field, shape in (("log_like", (ntemps, nwalkers)),
                                 ("log_prior", (ntemps, nwalkers)),
                                 ("betas", (ntemps,))):
                g.create_dataset(field, (0,) + shape, maxshape=(None,) + shape,
                                 dtype=self.dtype, **opts)

            chain = g.create_group("chain")
            inds = g.create_group("inds")
            orders = g.create_group("key_order")
            for name in branch_names:
                shape = (ntemps, nwalkers, self.nleaves_max[name])
                chain.create_dataset(
                    name, (0,) + shape + (self.ndims[name],),
                    maxshape=(None,) + shape + (self.ndims[name],),
                    dtype=self.dtype, **opts)
                inds.create_dataset(name, (0,) + shape,
                                    maxshape=(None,) + shape, dtype=bool,
                                    **opts)
                if key_order is not None and len(key_order.get(name, ())) > 0:
                    orders.attrs[name] = key_order[name]

            if moves is not None:
                group = g.create_group("moves")
                for key in moves:
                    group.create_group(key).create_dataset(
                        "acceptance_fraction", (ntemps, nwalkers),
                        maxshape=(ntemps, nwalkers), dtype=self.dtype, **opts)

    #: the mesh whose writer rank writes the file (it stays after a
    #: sharded chain continues whole in every rank), or None: this process
    _ranks = None
    #: the rank's MeshLayout whose rows this process is given to store
    #: (gathered for the writer), or None: the whole ensemble's
    _rows = None

    def reset_sharded(self, layout, nwalkers, ndims, ntemps=1, **kwargs):
        """The file's layout for the whole ``ntemps x nwalkers`` ensemble
        that ``layout`` splits, written by the writer rank; every rank
        stores through the writer from here (see the module)."""
        if layout.writer:
            self.reset(nwalkers, ndims, ntemps=ntemps, **kwargs)
        self._rows = self._ranks = layout
        layout.barrier()

    def reshard(self, layout):
        """The file holds the whole ensemble whatever the placement: from
        here the rows to write are ``layout``'s shard (or whole), and the
        mesh's writer rank goes on writing them."""
        self._rows = layout
        self._ranks = layout or self._ranks

    @contextlib.contextmanager
    def _written(self):
        """A block in which the writer rank writes; under a mesh every rank
        waits at its end for the write."""
        try:
            yield
        finally:
            if self._ranks is not None:
                self._ranks.barrier()

    def _writes(self):
        """Whether this process writes the file."""
        return self._ranks is None or self._ranks.writer

    # ------------------------------------------------------------------
    # attributes read from the file
    # ------------------------------------------------------------------
    def _attr(self, name):
        with self.open() as f:
            return f[self.name].attrs[name]

    def __getattr__(self, item):
        # only reached when an attribute is not set: a backend opened on an
        # existing file reads its description from the file
        if item in ("nwalkers", "ntemps", "rj", "nbranches"):
            return self._attr(item)
        if item == "branch_names":
            return [str(n) for n in self._attr("branch_names")]
        if item in ("ndims", "nleaves_max"):
            with self.open() as f:
                attrs = f[self.name][item].attrs
                return {key: int(attrs[key]) for key in attrs}
        if item == "move_keys":
            with self.open() as f:
                g = f[self.name]
                return list(g["moves"].keys()) if "moves" in g else None
        if item == "key_order":
            with self.open() as f:
                g = f[self.name]
                if "key_order" not in g:
                    return None
                return {key: list(np.atleast_1d(value))
                        for key, value in g["key_order"].attrs.items()}
        if item == "info":
            with self.open() as f:
                return dict(f[self.name]["info"].attrs)
        raise AttributeError(item)

    @property
    def iteration(self):
        return int(self._attr("iteration"))

    def _generator_state(self, which):
        with self.open() as f:
            g = f[self.name]
            if _GENERATORS not in g or which not in g[_GENERATORS]:
                return None
            return g[_GENERATORS][which][()]

    @property
    def random_state(self):
        """The state of the sampler's generator on its device (uint8), or
        None."""
        return self._generator_state("device")

    @property
    def host_random_state(self):
        """The state of the sampler's host generator (uint8), or None."""
        return self._generator_state("host")

    @property
    def numpy_random_state(self):
        """The state of the sampler's ``numpy.random.RandomState`` (uint8),
        or None."""
        return self._generator_state("numpy")

    # ------------------------------------------------------------------
    # writes
    # ------------------------------------------------------------------
    def has_blobs(self):
        return bool(self._attr("has_blobs"))

    def grow(self, ngrow, blobs=None):
        """Resize the datasets by ``ngrow`` steps; ``blobs``, one step's
        blobs, creates the resizable ``blobs`` dataset (its shape and dtype)
        at the first call that gives it and sets ``has_blobs``; under a
        mesh ``blobs`` are the rank's shard's, and the dataset the whole
        ensemble's."""
        if blobs is not None and self._rows is not None:
            lay = self._rows
            blobs = np.empty((lay.ntemps, lay.nwalkers)
                             + np.shape(blobs)[2:], np.asarray(blobs).dtype)
        with self._written():
            if self._writes():
                self._grow(ngrow, blobs)

    def _grow(self, ngrow, blobs):
        with self.open("a") as f:
            g = f[self.name]
            ntot = int(g.attrs["iteration"]) + int(ngrow)
            for field in ("log_like", "log_prior", "betas"):
                g[field].resize(ntot, axis=0)
            for name in g.attrs["branch_names"]:
                g["chain"][name].resize(ntot, axis=0)
                g["inds"][name].resize(ntot, axis=0)
            if blobs is None:
                return
            blobs = np.asarray(blobs)
            if g.attrs["has_blobs"]:
                g["blobs"].resize(ntot, axis=0)
            else:
                g.create_dataset(
                    "blobs", (ntot,) + blobs.shape,
                    maxshape=(None,) + blobs.shape, dtype=blobs.dtype,
                    compression=self.compression,
                    compression_opts=self.compression_opts)
                g.attrs["has_blobs"] = True

    def save_segment(self, coords, inds, log_like, log_prior, betas,
                     blobs=None, accepted=None, rj_accepted=None, swaps_accepted=None,
                     moves_accepted_fraction=None, random_state=None,
                     host_random_state=None, sampler_clock=None,
                     kernel_states=None, numpy_random_state=None):
        """Append a segment and its checkpoint (see
        :meth:`Backend.save_segment`) in one opening of the file, with
        ``iteration`` written last: a process killed between two segments
        leaves a file whose every part describes the same step.  Under a
        mesh the rank's shard of each field is gathered and the writer
        writes the whole; the kernel states come whole."""
        lay = self._rows
        if lay is not None:
            def whole(x, axis=1):
                return None if x is None else lay.gather_numpy(
                    np.asarray(x), axis=axis)

            ndim = {n: np.ndim(c) for n, c in coords.items()}
            coords = {n: whole(c) for n, c in coords.items()}
            # the masks of a segment, or one step's (no step axis)
            inds = {n: whole(m, 1 if np.ndim(m) == ndim[n] - 1 else 0)
                    for n, m in inds.items()}
            log_like, log_prior = whole(log_like), whole(log_prior)
            blobs, accepted = whole(blobs), whole(accepted)
            rj_accepted = whole(rj_accepted)
            if moves_accepted_fraction is not None:
                moves_accepted_fraction = {
                    k: whole(v, 0) for k, v in moves_accepted_fraction.items()}
        with self._written():
            if self._writes():
                self._save_segment(
                    coords, inds, log_like, log_prior, betas, blobs,
                    accepted, rj_accepted, swaps_accepted,
                    moves_accepted_fraction, random_state, host_random_state,
                    sampler_clock, kernel_states, numpy_random_state)

    def _save_segment(self, coords, inds, log_like, log_prior, betas,
                      blobs, accepted, rj_accepted, swaps_accepted,
                      moves_accepted_fraction, random_state,
                      host_random_state, sampler_clock, kernel_states,
                      numpy_random_state):
        log_like = np.asarray(log_like, dtype=self.dtype)
        n = log_like.shape[0]

        with self.open("a") as f:
            g = f[self.name]
            it = int(g.attrs["iteration"])
            sl = slice(it, it + n)
            for name in g.attrs["branch_names"]:
                c = np.array(coords[name], dtype=self.dtype)
                m = np.broadcast_to(np.asarray(inds[name], dtype=bool),
                                    c.shape[:-1])
                c[~m] = self.store_missing_leaves
                g["chain"][name][sl] = c
                g["inds"][name][sl] = m
            g["log_like"][sl] = log_like
            g["log_prior"][sl] = np.asarray(log_prior, dtype=self.dtype)
            g["betas"][sl] = np.asarray(betas, dtype=self.dtype)
            if blobs is not None and g.attrs["has_blobs"]:
                g["blobs"][sl] = np.asarray(blobs)
            for field, value in (("accepted", accepted),
                                 ("rj_accepted", rj_accepted),
                                 ("swaps_accepted", swaps_accepted)):
                if value is not None and field in g:
                    g[field][:] = g[field][:] + np.asarray(
                        value, dtype=np.float64).sum(axis=0)
            if moves_accepted_fraction is not None and "moves" in g:
                for key, val in moves_accepted_fraction.items():
                    if val is not None and key in g["moves"]:
                        g["moves"][key]["acceptance_fraction"][:] = (
                            np.asarray(val))
            for which, state in (("device", random_state),
                                 ("host", host_random_state),
                                 ("numpy", numpy_random_state)):
                if state is not None:
                    _put(g.require_group(_GENERATORS), which,
                         np.asarray(state, dtype=np.uint8))
            if sampler_clock is not None:
                g.attrs["tempering_time"] = int(sampler_clock)
            if kernel_states is not None:
                _write_kernel_states(g, *kernel_states)
            g.attrs["iteration"] = it + n

    def save_kernel_states(self, kernel_states, move_keys=None):
        """Store the moves' kernel states under
        ``kernel_states/<move>/<leaf>``, rewritten whole."""
        super().save_kernel_states(kernel_states, move_keys)
        with self._written():
            if self._writes():
                with self.open("a") as f:
                    _write_kernel_states(f[self.name],
                                         *self._kernel_state_leaves)

    def save_sampler_clock(self, time):
        """Store the adaptation clock as the attribute ``tempering_time``."""
        with self._written():
            if self._writes():
                with self.open("a") as f:
                    f[self.name].attrs["tempering_time"] = int(time)

    def get_sampler_clock(self):
        with self.open() as f:
            val = f[self.name].attrs.get("tempering_time")
        return None if val is None else int(val)

    def get_kernel_states(self):
        with self.open() as f:
            g = f[self.name]
            if "kernel_states" not in g:
                return None
            group = g["kernel_states"]
            keys = group.attrs.get("move_keys")
            keys = None if keys is None else [str(k) for k in keys]
            out = []
            for i in sorted(group, key=int):
                sub = group[i]
                n = int(sub.attrs.get("nleaves", len(sub)))
                out.append([sub[str(j)][()] if str(j) in sub else None
                            for j in range(n)])
        return keys, out

    # ------------------------------------------------------------------
    # reads
    # ------------------------------------------------------------------
    def get_value(self, name, thin=1, discard=0, temp_index=None,
                  branch_names=None, slice_vals=None):
        """Read one stored field from the file."""
        with self.open() as f:
            g = f[self.name]
            iteration = int(g.attrs["iteration"])
            if iteration <= 0:
                raise AttributeError(
                    "You must run the sampler with 'store == True' before "
                    "accessing the results."
                )
            if slice_vals is None:
                slice_vals = slice(discard + thin - 1, iteration, thin)
            # h5py reads strictly increasing indices and forward slices: any
            # other selection is read sorted and unique, then reordered
            inv = None
            if isinstance(slice_vals, slice):
                # resolve against the stored range: the datasets are
                # preallocated longer
                if (slice_vals.step or 1) < 0:
                    slice_vals, inv = np.unique(
                        np.arange(iteration)[slice_vals], return_inverse=True)
                else:
                    slice_vals = slice(*slice_vals.indices(iteration))
            elif np.ndim(slice_vals) == 0:
                iv = int(slice_vals)
                slice_vals = iv + iteration if iv < 0 else iv
            else:
                idx = np.asarray(slice_vals)
                if idx.dtype == bool:
                    idx = np.flatnonzero(idx)
                idx = np.where(idx < 0, idx + iteration, idx)
                if idx.size and np.any(np.diff(idx) <= 0):
                    slice_vals, inv = np.unique(idx, return_inverse=True)
                else:
                    slice_vals = idx

            def read(dset):
                out = (dset[slice_vals] if temp_index is None
                       else dset[slice_vals, temp_index])
                return out if inv is None else out[inv]

            if name in ("chain", "inds"):
                keep = (list(g.attrs["branch_names"]) if branch_names is None
                        else self._keep_branches(branch_names))
                return {str(n): read(g[name][n]) for n in keep}
            if name in ("log_like", "log_prior", "betas"):
                return read(g[name])
            if name == "blobs":
                if not g.attrs["has_blobs"]:
                    raise AttributeError("No blobs stored.")
                return read(g["blobs"])
            raise ValueError(f"Unknown value name: {name}")

    def _counter(self, field):
        with self.open() as f:
            g = f[self.name]
            return g[field][:] if field in g else None

    @property
    def accepted(self):
        return self._counter("accepted")

    @property
    def rj_accepted(self):
        return self._counter("rj_accepted")

    @property
    def swaps_accepted(self):
        return self._counter("swaps_accepted")

    @property
    def moves_accepted_fraction(self):
        with self.open() as f:
            g = f[self.name]
            if "moves" not in g:
                return None
            return {key: g["moves"][key]["acceptance_fraction"][:]
                    for key in g["moves"]}

    def get_a_sample(self, it):
        """The :class:`~eryn_tpu_torch.state.State` stored at iteration
        ``it`` (host tensors; dead leaves read as 0)."""
        from ..state import State

        with self.open() as f:
            g = f[self.name]
            iteration = int(g.attrs["iteration"])
            if iteration <= 0:
                raise AttributeError(
                    "You must run the sampler with 'store == True' before "
                    "accessing the results."
                )
            it = int(it)
            if it < 0:
                it += iteration
            if not 0 <= it < iteration:
                raise IndexError(
                    f"Sample index {it} out of range for {iteration} stored "
                    "iterations."
                )
            coords, inds = {}, {}
            for name in g.attrs["branch_names"]:
                m = g["inds"][name][it]
                coords[str(name)] = np.where(m[..., None],
                                             g["chain"][name][it], 0.0)
                inds[str(name)] = m
            log_like, log_prior = g["log_like"][it], g["log_prior"][it]
            betas = g["betas"][it]
            blobs = g["blobs"][it] if g.attrs["has_blobs"] else None
        return State(coords, inds=inds, log_like=log_like,
                     log_prior=log_prior, betas=betas, blobs=blobs,
                     random_state=self.random_state)


def _put(group, name, arr):
    """``group[name] = arr``, in place when the shape is unchanged."""
    if name in group and group[name].shape == arr.shape:
        group[name][...] = arr
        return
    if name in group:
        del group[name]
    group.create_dataset(name, data=arr)


def _write_kernel_states(g, move_keys, per_move):
    """``kernel_states/<move>/<leaf>``, rewritten whole (the arrays are
    small tuning values); a leaf that could not be stored is a missing
    index, and ``nleaves`` keeps the count."""
    if "kernel_states" in g:
        del g["kernel_states"]
    group = g.create_group("kernel_states")
    if move_keys is not None:
        group.attrs["move_keys"] = list(move_keys)
    for i, leaves in enumerate(per_move):
        sub = group.create_group(str(i))
        sub.attrs["nleaves"] = len(leaves)
        for j, arr in enumerate(leaves):
            if arr is not None:
                sub.create_dataset(str(j), data=arr)


class TempHDFBackend:
    """Context manager giving an :class:`HDFBackend` on a temporary file,
    removed on exit."""

    def __init__(self, dtype=None, compression=None, compression_opts=None):
        self.dtype = dtype
        self.filename = None
        self.compression = compression
        self.compression_opts = compression_opts

    def __enter__(self):
        import tempfile

        f = tempfile.NamedTemporaryFile(prefix="eryn-", suffix=".h5",
                                        delete=False)
        f.close()
        self.filename = f.name
        return HDFBackend(f.name, "test", dtype=self.dtype,
                          compression=self.compression,
                          compression_opts=self.compression_opts)

    def __exit__(self, exception_type, exception_value, traceback):
        os.remove(self.filename)
