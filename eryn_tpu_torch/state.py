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

import torch

__all__ = ["Branch", "BranchSupplemental", "State", "resolve_device"]


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
    """One model type in the ensemble: padded leaf coordinates and their
    activation mask."""

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


class BranchSupplemental:
    """Dict of tensors indexed like the ensemble (leading ``base_shape``).

    Only the holder is ported: the sampler's main path carries no
    supplemental data, and a state that holds some takes the general (CPU)
    proposal path."""

    def __init__(self, obj_info: dict, base_shape=None):
        self.holder = {k: _as_tensor(v) for k, v in obj_info.items()}
        if base_shape is None and self.holder:
            base_shape = tuple(next(iter(self.holder.values())).shape[:2])
        self.base_shape = tuple(base_shape or ())

    def __getitem__(self, key):
        return self.holder[key]

    def __contains__(self, key):
        return key in self.holder

    def __repr__(self):
        return f"BranchSupplemental({list(self.holder)})"


class State:
    """Full ensemble snapshot: ``branches``, ``log_like``, ``log_prior``,
    ``blobs``, ``betas``, ``supplemental`` and ``random_state`` (the state of
    the sampler's ``torch.Generator``)."""

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
            clone = (lambda x: None if x is None else x.clone()) if copy else (
                lambda x: x
            )
            self.branches = {
                n: Branch(
                    clone(b.coords), inds=clone(b.inds),
                    branch_supplemental=b.branch_supplemental,
                )
                for n, b in other.branches.items()
            }
            self.log_like = clone(other.log_like)
            self.log_prior = clone(other.log_prior)
            self.blobs = clone(other.blobs)
            self.betas = clone(other.betas)
            self.supplemental = other.supplemental
            self.random_state = other.random_state
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

    def get_log_posterior(self, temper=False):
        """Tempered or untempered log posterior."""
        betas = self.betas[:, None] if temper and self.betas is not None else 1.0
        return betas * self.log_like + self.log_prior

    def get_betas(self):
        return self.betas

    def replace(self, **updates) -> "State":
        """Copy of this state with the given fields replaced (``coords`` and
        ``inds`` as per-branch dicts)."""
        new = State.__new__(State)
        new.branches = dict(self.branches)
        new.log_like = updates.pop("log_like", self.log_like)
        new.log_prior = updates.pop("log_prior", self.log_prior)
        new.blobs = updates.pop("blobs", self.blobs)
        new.betas = updates.pop("betas", self.betas)
        new.supplemental = updates.pop("supplemental", self.supplemental)
        new.random_state = updates.pop("random_state", self.random_state)
        if "coords" in updates or "inds" in updates:
            coords = updates.pop("coords", self.branches_coords)
            inds = updates.pop("inds", self.branches_inds)
            new.branches = {
                n: Branch(
                    coords[n], inds=inds[n],
                    branch_supplemental=self.branches[n].branch_supplemental,
                )
                for n in self.branches
            }
        if updates:
            raise TypeError(f"Unknown State fields: {list(updates)}")
        return new

    def __repr__(self):
        shapes = {n: b.shape for n, b in self.branches.items()}
        return f"State(branches={shapes})"
