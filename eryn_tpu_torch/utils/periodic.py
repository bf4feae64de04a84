"""Periodic-parameter handling.

Port of :mod:`eryn_tpu.utils.periodic`.  Each branch's periods are one dense
``(ndim,)`` vector with ``inf`` where a parameter is not periodic, so the
signed distance and the wrap are a few tensor ops over the whole
``(..., nleaves_max, ndim)`` ensemble, and the same vector is what the
group-stretch kernel (``csrc/select_kernels.cu``) reads.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["PeriodicContainer", "wrap_distance", "wrap_coords"]


def wrap_distance(d, period):
    """The differences ``d`` ``(..., ndim)`` wrapped into ``[-P/2, P/2)``
    where ``period`` ``(ndim,)`` is finite, untouched where it is ``inf``."""
    finite = torch.isfinite(period)
    p = torch.where(finite, period, 1.0)
    half = 0.5 * p
    return torch.where(finite, torch.remainder(d + half, p) - half, d)


def wrap_coords(x, period):
    """The coordinates ``x`` ``(..., ndim)`` wrapped into ``[0, P)`` where
    ``period`` ``(ndim,)`` is finite."""
    finite = torch.isfinite(period)
    p = torch.where(finite, period, 1.0)
    return torch.where(finite, torch.remainder(x, p), x)


class PeriodicContainer:
    """Minimal signed distance and wrapping for periodic parameters.

    Args:
        periodic: ``{branch_name: {param_index_or_name: period}}``.  String
            keys are resolved against ``key_orders`` (or ``key_order``),
            ``{branch_name: [param names]}``.
        ndims: optionally ``{branch_name: ndim}``; a branch's vector is
            otherwise as long as its largest periodic index needs and is
            padded with ``inf`` when a longer one is asked for.
    """

    def __init__(self, periodic, ndims=None, key_orders=None, key_order=None):
        if not isinstance(periodic, dict):
            raise ValueError("periodic must be a dict of dicts.")
        self.periodic_in = periodic
        self._key_orders = key_orders or key_order or {}
        self._ndims = dict(ndims) if ndims else {}
        self._vectors = {
            name: self._build_vector(name, spec)
            for name, spec in periodic.items()
        }
        self._tensors = {}

    @classmethod
    def coerce(cls, periodic, ndims=None, key_orders=None):
        """None or a container as they are; a ``{branch: {parameter:
        period}}`` dict as a container built from it."""
        if periodic is None or isinstance(periodic, cls):
            return periodic
        if not isinstance(periodic, dict):
            raise ValueError(
                "periodic must be PeriodicContainer or dict if not None.")
        return cls(periodic, ndims=ndims, key_orders=key_orders)

    def _resolve_index(self, name, key):
        if isinstance(key, (int, np.integer)):
            return int(key)
        order = self._key_orders.get(name)
        if order is None:
            raise ValueError(
                f"String parameter key '{key}' requires a key_order for "
                f"branch '{name}'."
            )
        return list(order).index(key)

    def _build_vector(self, name, spec):
        idx = {self._resolve_index(name, k): float(v) for k, v in spec.items()}
        ndim = self._ndims.get(name, max(idx) + 1 if idx else 0)
        vec = np.full((ndim,), np.inf)
        for i, period in idx.items():
            vec[i] = period
        return vec

    def period_vector(self, name, ndim, dtype, device):
        """The ``(ndim,)`` periods of branch ``name`` as a tensor (``inf``
        where not periodic), or None for a branch without periodic
        parameters.  Built once per dtype and device."""
        vec = self._vectors.get(name)
        if vec is None:
            return None
        if len(vec) < ndim:
            vec = np.concatenate([vec, np.full((ndim - len(vec),), np.inf)])
            self._vectors[name] = vec
        key = (name, ndim, dtype, torch.device(device))
        out = self._tensors.get(key)
        if out is None:
            out = torch.tensor(vec[:ndim], dtype=dtype, device=device)
            self._tensors[key] = out
        return out

    def _vector_like(self, name, x):
        return self.period_vector(name, x.shape[-1], x.dtype, x.device)

    def distance(self, p1: dict, p2: dict, xp=None) -> dict:
        """Minimal signed distance ``p2 - p1`` per branch, periodic
        dimensions wrapped into ``[-P/2, P/2)``.  ``xp`` (Eryn's array
        module) is accepted and not used."""
        out = {}
        for name in p1:
            d = p2[name] - p1[name]
            vec = self._vector_like(name, d)
            out[name] = d if vec is None else wrap_distance(d, vec)
        return out

    def wrap(self, p: dict, xp=None) -> dict:
        """Coordinates wrapped into ``[0, P)`` per periodic dimension.
        ``xp`` (Eryn's array module) is accepted and not used."""
        out = {}
        for name, x in p.items():
            vec = self._vector_like(name, x)
            out[name] = x if vec is None else wrap_coords(x, vec)
        return out
