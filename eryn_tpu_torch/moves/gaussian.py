"""Metropolis move with Gaussian proposals.

Port of :mod:`eryn_tpu.moves.gaussian`.  Each branch's covariance (a
scalar, a diagonal or a full matrix) becomes a scale vector or a Cholesky
factor, computed once on the host in float64 and copied to each device
and dtype once; the ``vector``, ``random`` and ``sequential`` modes are
masks over the whole ensemble, and the sequential dimension counter is a
0-d int32 tensor of the move's kernel state.
"""

from __future__ import annotations

import numpy as np
import torch

from .mh import MHMove

__all__ = ["GaussianMove"]

_ALLOWED_MODES = ("vector", "random", "sequential")


class _BranchProposal:
    """One branch's proposal: ``kind`` (isotropic, diagonal or full), its
    scale or Cholesky factor (float64 on the host, cached per device and
    dtype), the jitter ``log_factor`` and the ``mode``."""

    def __init__(self, cov, factor, mode):
        try:
            scale = float(cov)
            if scale <= 0:
                raise ValueError("covariance must be positive.")
            self.kind = "isotropic"
            self.host = np.sqrt(scale)
        except TypeError:
            cov = np.atleast_1d(np.asarray(cov, dtype=np.float64))
            if cov.ndim == 1:
                if np.any(cov <= 0):
                    raise ValueError(
                        "diagonal covariance entries must be positive."
                    )
                self.kind = "diagonal"
                self.host = np.sqrt(cov)
            elif cov.ndim == 2 and cov.shape[0] == cov.shape[1]:
                self.kind = "full"
                # transposed: a row of noise times it is one draw
                self.host = np.linalg.cholesky(cov).T.copy()
            else:
                raise ValueError("Invalid proposal scale dimensions")

        if factor is None:
            self.log_factor = None
        else:
            if factor < 1.0:
                raise ValueError("'factor' must be >= 1.0")
            self.log_factor = float(np.log(factor))

        if mode not in _ALLOWED_MODES:
            raise ValueError(
                f"'{mode}' is not a recognized mode. Please select from: "
                f"{_ALLOWED_MODES}"
            )
        if self.kind == "full" and mode != "vector":
            raise ValueError("full covariance requires mode='vector'")
        self.mode = mode
        self._on = {}

    def scale_on(self, like):
        """The scale (a 0-d or ``(ndim,)`` tensor) or the transposed
        Cholesky factor in the dtype and on the device of ``like``."""
        key = (like.device, like.dtype)
        if key not in self._on:
            self._on[key] = torch.as_tensor(self.host).to(
                device=like.device, dtype=like.dtype)
        return self._on[key]


class GaussianMove(MHMove):
    """Gaussian Metropolis proposal per branch.

    Args:
        cov_all: ``{branch_name: scalar | (ndim,) | (ndim, ndim)}``
            covariance.
        mode: ``"vector"`` (all dimensions), ``"random"`` (one random
            dimension per leaf) or ``"sequential"`` (cycle the dimensions,
            one per step).
        factor: optional scale jitter ``exp(U(-log f, log f))``, one draw
            per branch and step.
    """

    #: every mode is symmetric in (x, y), so DelayedRejection may wrap it
    symmetric_proposal = True
    _mesh_sharded = True

    def __init__(self, cov_all, mode="vector", factor=None, **kwargs):
        self.all_proposal = {
            name: _BranchProposal(cov, factor, mode)
            for name, cov in cov_all.items()
        }
        self.mode = mode
        super().__init__(**kwargs)

    def run_branches(self, state):
        names = super().run_branches(state)
        return [n for n in names if n in self.all_proposal]

    def init_kernel_state(self, state):
        self.prepare_constants(state)
        like = state.log_like
        for name, prop in self.all_proposal.items():
            if name in state.branches:
                prop.scale_on(like)
        # per-branch sequential-dimension counter
        return {
            name: torch.zeros((), dtype=torch.int32, device=like.device)
            for name, p in self.all_proposal.items()
            if p.mode == "sequential"
        }

    def draw_gaussian(self, generator, name, coords):
        """Randomness of one branch's proposal: the standard normal
        ``noise`` shaped like ``coords``, the jitter's uniform (0-d, or None
        without ``factor``) and, in ``random`` mode, the dimension per leaf
        ``(ntemps, nwalkers, nleaves_max)`` int64 (else None).  The noise
        and the dimensions are per walker, the jitter whole."""
        prop = self.all_proposal[name]
        kw = dict(generator=generator, dtype=coords.dtype,
                  device=coords.device)
        noise = self.rank_draw(lambda sh: torch.randn(sh, **kw), coords.shape,
                               per_walker=True)
        jitter = None if prop.log_factor is None else torch.rand((), **kw)
        dim = None
        if prop.mode == "random":
            dim = self.rank_draw(
                lambda sh: torch.randint(0, coords.shape[-1], sh,
                                         generator=generator,
                                         device=coords.device),
                coords.shape[:-1], per_walker=True)
        return noise, jitter, dim

    def get_proposal_kernel(self, generator, branch_coords, branch_inds,
                            kernel_state, param_masks=None):
        q = {}
        new_kernel_state = dict(kernel_state) if kernel_state else {}
        for name, coords in branch_coords.items():
            inds = branch_inds[name]
            prop = self.all_proposal[name]
            noise, jitter, dim = self.draw_gaussian(generator, name, coords)
            ndim = coords.shape[-1]

            scale = prop.scale_on(coords)
            dx = noise @ scale if prop.kind == "full" else noise * scale
            if jitter is not None:
                # U(-log f, log f), mapped as eryn_tpu maps its uniform
                lf = prop.log_factor
                dx = dx * torch.exp(jitter * (2.0 * lf) - lf)

            iota = torch.arange(ndim, device=coords.device)
            if prop.mode == "random":
                dx = torch.where(iota == dim[..., None], dx, 0.0)
            elif prop.mode == "sequential":
                idx = kernel_state[name]
                dx = torch.where(iota == idx % ndim, dx, 0.0)
                new_kernel_state[name] = (idx + 1) % ndim

            mask = None if param_masks is None else param_masks.get(name)
            if mask is not None:
                # the Gibbs selection zeroes the step before the wrap
                dx = torch.where(mask, dx, 0.0)

            # only active leaves move
            xnew = torch.where(inds[..., None], coords + dx, coords)
            if self.periodic is not None:
                xnew = self.periodic.wrap({name: xnew})[name]
            q[name] = xnew

        first = next(iter(q.values()))
        factors = first.new_zeros(first.shape[:2])
        return q, factors, new_kernel_state
