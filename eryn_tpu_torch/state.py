"""Ensemble state containers on torch tensors.

Port of :mod:`eryn_tpu.state`.  Shapes are those of the JAX package (and of
Eryn):

* ``coords``: ``(ntemps, nwalkers, nleaves_max, ndim)`` per branch
* ``inds``:   ``(ntemps, nwalkers, nleaves_max)`` boolean leaf mask
* ``log_like`` / ``log_prior``: ``(ntemps, nwalkers)``
* ``betas``: ``(ntemps,)``

The containers hold tensors as given; the sampler moves them to its device
and dtype when it sets up a run.
"""

from __future__ import annotations

import copy as _copy

import numpy as np
import torch

__all__ = ["Branch", "BranchSupplemental", "ParaState", "State",
           "resolve_device"]


def resolve_device(device):
    """The device a sampler or a state is built on: ``device`` when given,
    else the card.  Without CUDA a missing ``device`` raises rather than
    falling back to the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "eryn_tpu_torch runs on the GPU by default, and no CUDA device "
            'is available; pass device="cpu" to run on the CPU.'
        )
    return torch.device("cuda")


def _as_tensor(x):
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


def _coerce_coords(coords):
    """Coerce 1-D to 4-D coords input to the canonical 4-D layout."""
    coords = _as_tensor(coords)
    if coords.ndim == 1:
        return coords[None, None, None, :]
    if coords.ndim == 2:
        return coords[None, :, None, :]
    if coords.ndim == 3:
        return coords[:, :, None, :]
    if coords.ndim != 4:
        raise ValueError(
            "coords must be 1, 2, 3 or 4 dimensional; got shape "
            f"{tuple(coords.shape)}."
        )
    return coords


class Branch:
    """One model type in the ensemble: padded leaf coordinates, their
    activation mask and the branch's supplemental (``branch_supplemental``,
    also read as ``supplemental``)."""

    def __init__(self, coords, inds=None, branch_supplemental=None):
        coords = _coerce_coords(coords)
        ntemps, nwalkers, nleaves_max, _ = coords.shape
        if inds is None:
            inds = torch.ones(
                (ntemps, nwalkers, nleaves_max), dtype=torch.bool,
                device=coords.device,
            )
        else:
            inds = _as_tensor(inds).to(torch.bool)
            if tuple(inds.shape) != (ntemps, nwalkers, nleaves_max):
                raise ValueError(
                    f"inds shape {tuple(inds.shape)} incompatible with coords "
                    f"shape {tuple(coords.shape)}."
                )
        self.coords = coords
        self.inds = inds
        self.branch_supplemental = branch_supplemental

    @property
    def supplemental(self):
        """The name ``eryn_tpu`` reads ``branch_supplemental`` by."""
        return self.branch_supplemental

    @supplemental.setter
    def supplemental(self, value):
        self.branch_supplemental = value

    @property
    def shape(self):
        return tuple(self.coords.shape)

    @property
    def ntemps(self):
        return self.coords.shape[0]

    @property
    def nwalkers(self):
        return self.coords.shape[1]

    @property
    def nleaves_max(self):
        return self.coords.shape[2]

    @property
    def ndim(self):
        return self.coords.shape[3]

    @property
    def nleaves(self):
        return self.inds.sum(dim=-1)

    def __repr__(self):
        return f"Branch(shape={self.shape})"


def _as_object_array(value):
    """``value`` as a NumPy object array when it is object-like (object
    dtype, or a sequence NumPy cannot make numeric), else None."""
    if isinstance(value, np.ndarray) and value.dtype == object:
        return value
    if isinstance(value, (list, tuple)):
        try:
            probe = np.asarray(value)
        except ValueError:  # ragged
            probe = np.empty(len(value), dtype=object)
            probe[:] = value
        if probe.dtype == object:
            return probe
    return None


def _expand_index(idx, ndim):
    """``idx`` with trailing unit dims up to ``ndim``."""
    return idx.reshape(tuple(idx.shape) + (1,) * (ndim - idx.ndim))


class BranchSupplemental:
    """Per-walker side data indexed like the ensemble (leading
    ``base_shape``, by default the first two dims of the first entry).

    Numeric entries are tensors (``holder``): the sampler moves them to its
    device, passes a branch's entries to the likelihood under
    ``provide_supplemental=True``, and the swap phase moves them with their
    walkers, inside the graphed step.  Object-dtype entries stay NumPy
    object arrays on the host (``host_holder``): the sampler follows each
    walker through the swaps with an index that rides the step and
    reorders them at the end of each segment.
    """

    def __init__(self, obj_info: dict, base_shape=None, copy=False):
        self.holder = {}
        self.host_holder = {}
        self.base_shape = tuple(base_shape) if base_shape is not None else None
        self.add_objects(obj_info, copy=copy)
        if self.base_shape is None:
            self.base_shape = self._infer_base_shape()

    def _infer_base_shape(self):
        for source in (self.holder, self.host_holder):
            if source:
                return tuple(next(iter(source.values())).shape[:2])
        return ()

    def _check_base(self, name, shape):
        base = self.base_shape
        if base and tuple(shape[:len(base)]) != base:
            raise ValueError(
                f"Supplemental entry '{name}' with shape {tuple(shape)} does "
                f"not lead with base_shape {base}."
            )

    def add_objects(self, obj_info: dict, copy=False):
        """Add entries; each must lead with ``base_shape`` (its trailing
        dims are free).  Object-dtype values go to ``host_holder``; with
        ``copy`` they are copied."""
        for name, value in obj_info.items():
            obj = _as_object_array(value)
            if obj is not None:
                self._check_base(name, obj.shape)
                self.holder.pop(name, None)
                self.host_holder[name] = obj.copy() if copy else obj
                continue
            arr = _as_tensor(value)
            self._check_base(name, arr.shape)
            self.host_holder.pop(name, None)
            self.holder[name] = arr.clone() if copy else arr

    def remove_objects(self, names):
        """Remove the entries ``names`` (a string or a list of them)."""
        if isinstance(names, str):
            names = [names]
        if not isinstance(names, list):
            raise ValueError("names must be a string or list of strings.")
        for name in names:
            if name in self.host_holder:
                del self.host_holder[name]
            else:
                del self.holder[name]

    @property
    def contained_objects(self):
        """The names of the entries, numeric first."""
        return list(self.holder) + list(self.host_holder)

    def __contains__(self, name):
        return name in self.holder or name in self.host_holder

    def __getitem__(self, key):
        if isinstance(key, str):
            if key in self.holder:
                return self.holder[key]
            return self.host_holder[key]
        # any other key indexes every entry
        out = {name: value[key] for name, value in self.holder.items()}
        out.update({name: value[key]
                    for name, value in self.host_holder.items()})
        return out

    def __setitem__(self, key, value):
        if isinstance(key, str):
            self.add_objects({key: value})
            return
        if not isinstance(value, dict):
            raise ValueError(
                "Setting with an index requires a dict of per-name values."
            )
        for name, val in value.items():
            if name in self.host_holder:
                self.host_holder[name][key] = val
            elif name in self.holder:
                # a new tensor: a state that shares the old one keeps it
                new = self.holder[name].clone()
                new[key] = _as_tensor(val).to(device=new.device,
                                              dtype=new.dtype)
                self.holder[name] = new
            # a name not stored is ignored, as in Eryn

    def take_along_axis(self, indices, axis: int, skip_names=()):
        """Every entry but ``skip_names`` gathered along ``axis`` by
        ``indices`` (of the dims of ``base_shape``; an entry's trailing
        dims broadcast)."""
        out = {}
        for name, values in self.holder.items():
            if name in skip_names:
                continue
            idx = _as_tensor(indices).to(device=values.device,
                                         dtype=torch.int64)
            idx = _expand_index(idx, values.ndim)
            shape = list(values.shape)
            shape[axis] = idx.shape[axis]
            out[name] = torch.gather(values, axis, idx.expand(shape))
        idx_np = np.asarray(indices.cpu() if isinstance(indices, torch.Tensor)
                            else indices)
        for name, values in self.host_holder.items():
            if name in skip_names:
                continue
            idx = idx_np.reshape(idx_np.shape + (1,) * (values.ndim
                                                         - idx_np.ndim))
            out[name] = np.take_along_axis(values, idx, axis=axis)
        return out

    def put_along_axis(self, indices, values_in: dict, axis: int):
        """Scatter ``values_in`` into the entries along ``axis`` at
        ``indices``; a numeric entry becomes a new tensor."""
        for name, target in list(self.holder.items()):
            if name not in values_in:
                continue
            idx = _as_tensor(indices).to(device=target.device,
                                         dtype=torch.int64)
            idx = _expand_index(idx, target.ndim)
            shape = list(target.shape)
            shape[axis] = idx.shape[axis]
            src = _as_tensor(values_in[name]).to(device=target.device,
                                                 dtype=target.dtype)
            self.holder[name] = target.scatter(
                axis, idx.expand(shape), src.expand(shape))
        idx_np = np.asarray(indices.cpu() if isinstance(indices, torch.Tensor)
                            else indices)
        for name, target in self.host_holder.items():
            if name not in values_in:
                continue
            idx = idx_np.reshape(idx_np.shape + (1,) * (target.ndim
                                                         - idx_np.ndim))
            idx = np.broadcast_to(
                idx, np.take_along_axis(target, idx, axis=axis).shape)
            np.put_along_axis(target, idx, values_in[name], axis=axis)

    @property
    def flat(self):
        """Every entry with the ``base_shape`` dims flattened into one."""
        nbase = len(self.base_shape)
        out = {name: v.reshape((-1,) + tuple(v.shape[nbase:]))
               for name, v in self.holder.items()}
        out.update({name: v.reshape((-1,) + v.shape[nbase:])
                    for name, v in self.host_holder.items()})
        return out

    def with_holder(self, holder):
        """A supplemental with the numeric entries ``holder`` and this one's
        host entries (shared, not copied) and ``base_shape``: what a step
        makes when its entries move."""
        new = BranchSupplemental.__new__(BranchSupplemental)
        new.holder = dict(holder)
        new.host_holder = self.host_holder
        new.base_shape = self.base_shape
        return new

    def map_tensors(self, fn):
        """:meth:`with_holder` of ``fn`` applied to every numeric entry."""
        return self.with_holder({k: fn(v) for k, v in self.holder.items()})

    def copy(self):
        """An independent copy: numeric entries cloned, host entries deep
        copied."""
        new = self.map_tensors(torch.clone)
        new.host_holder = {k: _copy.deepcopy(v)
                           for k, v in self.host_holder.items()}
        return new

    def __repr__(self):
        host = f", host={list(self.host_holder)}" if self.host_holder else ""
        return f"BranchSupplemental({list(self.holder)}{host})"


class State:
    """Full ensemble snapshot: ``branches``, ``log_like``, ``log_prior``,
    ``blobs``, ``betas``, ``supplemental`` and ``random_state`` (the state of
    the sampler's ``torch.Generator``).

    ``State(other)`` shares ``other``'s branches and supplementals;
    ``State(other, copy=True)`` clones every tensor and deep-copies the host
    entries of the supplementals.

    ``sharding`` is None, or, for a rank's shard of a state on a device
    mesh, the :class:`~eryn_tpu_torch.parallel.mesh.StateSharding` that
    :func:`~eryn_tpu_torch.parallel.mesh.shard_state` recorded; the copies
    and replacements below keep it."""

    sharding = None

    def __init__(
        self,
        coords,
        inds=None,
        log_like=None,
        log_prior=None,
        blobs=None,
        betas=None,
        supplemental=None,
        branch_supplemental=None,
        random_state=None,
        copy=False,
    ):
        if isinstance(coords, State):
            other = coords
            if copy:
                def supp(s):
                    return None if s is None else s.copy()

                self.branches = {
                    n: Branch(b.coords.clone(), inds=b.inds.clone(),
                              branch_supplemental=supp(b.branch_supplemental))
                    for n, b in other.branches.items()
                }
                self.supplemental = supp(other.supplemental)
            else:
                self.branches = dict(other.branches)
                self.supplemental = other.supplemental
            for field in ("log_like", "log_prior", "blobs", "betas"):
                x = getattr(other, field)
                setattr(self, field, x.clone() if copy and x is not None
                        else x)
            self.random_state = other.random_state
            self.sharding = other.sharding
            return

        if isinstance(coords, Branch):
            coords = {"model_0": coords}
        if not isinstance(coords, dict):
            coords = {"model_0": coords}
        if inds is not None and not isinstance(inds, dict):
            inds = {"model_0": inds}
        if branch_supplemental is not None and not isinstance(
            branch_supplemental, dict
        ):
            branch_supplemental = {"model_0": branch_supplemental}

        self.branches = {}
        for name, c in coords.items():
            if isinstance(c, Branch):
                self.branches[name] = c
                continue
            supp = (
                None if branch_supplemental is None
                else branch_supplemental.get(name)
            )
            if isinstance(supp, dict):
                supp = BranchSupplemental(supp)
            self.branches[name] = Branch(
                c, inds=None if inds is None else inds.get(name),
                branch_supplemental=supp,
            )

        def opt(x):
            return None if x is None else _as_tensor(x)

        self.log_like = opt(log_like)
        self.log_prior = opt(log_prior)
        self.blobs = opt(blobs)
        self.betas = opt(betas)
        if isinstance(supplemental, dict):
            supplemental = BranchSupplemental(supplemental)
        self.supplemental = supplemental
        self.random_state = random_state
        if self.log_like is not None and self.log_like.ndim == 1:
            self.log_like = self.log_like[None, :]
        if self.log_prior is not None and self.log_prior.ndim == 1:
            self.log_prior = self.log_prior[None, :]

    @property
    def branch_names(self):
        return list(self.branches)

    @property
    def branches_coords(self):
        return {n: b.coords for n, b in self.branches.items()}

    @property
    def branches_inds(self):
        return {n: b.inds for n, b in self.branches.items()}

    @property
    def branches_supplemental(self):
        return {n: b.branch_supplemental for n, b in self.branches.items()}

    @property
    def ntemps(self):
        return next(iter(self.branches.values())).ntemps

    @property
    def nwalkers(self):
        return next(iter(self.branches.values())).nwalkers

    def copy_into_self(self, state_to_copy: "State"):
        """Take every field of ``state_to_copy`` (shared, not copied)."""
        self.branches = dict(state_to_copy.branches)
        self.log_like = state_to_copy.log_like
        self.log_prior = state_to_copy.log_prior
        self.blobs = state_to_copy.blobs
        self.betas = state_to_copy.betas
        self.supplemental = state_to_copy.supplemental
        self.random_state = state_to_copy.random_state
        self.sharding = state_to_copy.sharding

    def get_log_posterior(self, temper=False):
        """Tempered or untempered log posterior."""
        betas = self.betas[:, None] if temper and self.betas is not None else 1.0
        return betas * self.log_like + self.log_prior

    def get_betas(self):
        return self.betas

    def tensor_leaves(self):
        """Every tensor of the state as ``(path, tensor)`` in a fixed order:
        per branch its coordinates and masks, the per-walker fields that are
        set, the numeric entries of the state supplemental, then of each
        branch supplemental (entries in sorted name order)."""
        out = []
        for n, b in self.branches.items():
            out += [(("coords", n), b.coords), (("inds", n), b.inds)]
        for field in ("log_like", "log_prior", "betas", "blobs"):
            x = getattr(self, field)
            if x is not None:
                out.append(((field,), x))
        if self.supplemental is not None:
            out += [(("supplemental", k), self.supplemental.holder[k])
                    for k in sorted(self.supplemental.holder)]
        for n, b in self.branches.items():
            supp = b.branch_supplemental
            if supp is not None:
                out += [(("branch_supplemental", n, k), supp.holder[k])
                        for k in sorted(supp.holder)]
        return out

    def map_tensors(self, fn):
        """A state of the same layout with ``fn`` applied to every tensor of
        :meth:`tensor_leaves`; host entries of the supplementals are
        shared."""
        def supp(s):
            return None if s is None else s.map_tensors(fn)

        def opt(x):
            return None if x is None else fn(x)

        new = State.__new__(State)
        new.branches = {
            n: Branch(fn(b.coords), inds=fn(b.inds),
                      branch_supplemental=supp(b.branch_supplemental))
            for n, b in self.branches.items()
        }
        for field in ("log_like", "log_prior", "betas", "blobs"):
            setattr(new, field, opt(getattr(self, field)))
        new.supplemental = supp(self.supplemental)
        new.random_state = self.random_state
        new.sharding = self.sharding
        return new

    def replace(self, **updates) -> "State":
        """Copy of this state with the given fields replaced (``coords``,
        ``inds`` and ``branch_supplemental`` as per-branch dicts; a branch
        missing from ``branch_supplemental`` keeps its own)."""
        new = State.__new__(State)
        new.branches = dict(self.branches)
        new.log_like = updates.pop("log_like", self.log_like)
        new.log_prior = updates.pop("log_prior", self.log_prior)
        new.blobs = updates.pop("blobs", self.blobs)
        new.betas = updates.pop("betas", self.betas)
        new.supplemental = updates.pop("supplemental", self.supplemental)
        new.random_state = updates.pop("random_state", self.random_state)
        new.sharding = self.sharding
        if ("coords" in updates or "inds" in updates
                or "branch_supplemental" in updates):
            coords = updates.pop("coords", self.branches_coords)
            inds = updates.pop("inds", self.branches_inds)
            supps = {**self.branches_supplemental,
                     **updates.pop("branch_supplemental", {})}
            new.branches = {
                n: Branch(coords[n], inds=inds[n],
                          branch_supplemental=supps[n])
                for n in self.branches
            }
        if updates:
            raise TypeError(f"Unknown State fields: {list(updates)}")
        return new

    def __repr__(self):
        shapes = {n: b.shape for n, b in self.branches.items()}
        return f"State(branches={shapes})"


class ParaState(State):
    """State of ``ngroups`` independent ensembles
    (:class:`~eryn_tpu_torch.parallel.ParaEnsembleSampler`), port of
    :class:`eryn_tpu.state.ParaState`.

    Group-batched 5-D coordinates ``(ngroups, ntemps, nwalkers,
    nleaves_max, ndim)`` are stored with the group and temperature axes
    folded together (a leading ``ngroups * ntemps``), as are 4-D leaf masks,
    3-D ``log_like`` and ``log_prior`` and 2-D ``betas``; input that is
    already folded passes through as it is.  ``ngroups`` is kept for
    :meth:`group_view`, and ``groups_running`` is the ``(ngroups,)`` bool
    mask of the groups a run advanced.
    """

    def __init__(self, coords, groups_running=None, ngroups=None, **kwargs):
        if isinstance(coords, dict):
            first = next(iter(coords.values()))
            arr = first.coords if isinstance(first, Branch) else _as_tensor(first)
            if arr.ndim == 5:
                ngroups = arr.shape[0] if ngroups is None else ngroups
                coords = {n: _fold(c) for n, c in coords.items()}
                if kwargs.get("inds") is not None:
                    kwargs["inds"] = {
                        n: _fold(v) if _as_tensor(v).ndim == 4 else _as_tensor(v)
                        for n, v in kwargs["inds"].items()
                    }
                for field in ("log_like", "log_prior"):
                    if kwargs.get(field) is not None:
                        x = _as_tensor(kwargs[field])
                        kwargs[field] = _fold(x) if x.ndim == 3 else x
                if kwargs.get("betas") is not None:
                    b = _as_tensor(kwargs["betas"])
                    if b.ndim == 2:
                        kwargs["betas"] = b.reshape(-1)
        super().__init__(coords, **kwargs)
        self.ngroups = ngroups
        self.groups_running = (None if groups_running is None
                               else _as_tensor(groups_running))

    def group_view(self, field_dict):
        """Unfold ``(ngroups * ntemps, ...)`` tensors of a (nested) dict back
        to ``(ngroups, ntemps, ...)``."""
        if self.ngroups is None:
            return field_dict
        ng = self.ngroups

        def unfold(x):
            if isinstance(x, dict):
                return {k: unfold(v) for k, v in x.items()}
            return x.reshape((ng, x.shape[0] // ng) + tuple(x.shape[1:]))

        return unfold(field_dict)

    def __repr__(self):
        shapes = {n: b.shape for n, b in self.branches.items()}
        return f"ParaState(ngroups={self.ngroups}, branches={shapes})"


def _fold(x):
    """The two leading axes of ``x`` as one."""
    x = _as_tensor(x)
    return x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))
