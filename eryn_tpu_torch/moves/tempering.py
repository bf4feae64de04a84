"""Parallel tempering: the temperature ladder, the swap phase and ladder
adaptation.

Port of :mod:`eryn_tpu.moves.tempering`.  Two swap schemes:

* ``"cascade"`` (default), the stochastic sweep from the highest rung to the
  lowest.  It has two forms: the general form
  (:meth:`TemperatureControl._swap_cascade_general`: per rung, two uniform
  random walker permutations, carrying a provenance index that one gather
  applies to the swap payload at the end; the path on the CPU), and the
  kernel form (:meth:`TemperatureControl._swap_cascade_kernel`: one uniform
  relabelling of the walker axis per cascade, a random rotation per rung,
  and the whole swap phase in one CUDA launch on the state as it lies,
  :func:`~eryn_tpu_torch.ops.pt_swap.pt_swap_cascade_tree`), taken on a
  CUDA device whenever ``permute`` is on.  Above 640 walkers its rotations
  skip some pairings, and the accepted swaps are divided by the pairings
  actually proposed.  Both are valid state-independent pairings, so they
  agree statistically, not decision for decision.
* ``"deo"``, deterministic even-odd swaps (non-reversible parallel
  tempering, Okabe et al. 2001; Syed et al. 2021): phase ``t`` attempts the
  boundaries of parity ``t % 2``, each walker paired with itself on the
  neighbouring rung; the pairs are disjoint, so the phase is three shifted
  selects (:meth:`TemperatureControl._swap_kernel_deo`).  The parity comes
  from the clock tensor, so a captured step alternates at every replay.

Two ladder adaptations: ``"vousden"`` (arXiv:1501.05823, each interior rung
drifts by the difference of its neighbours' acceptance) and ``"syed"``
(the communication-barrier schedule of Syed et al. 2021, §5: the rungs are
damped toward the inverse of the estimated cumulative barrier at equal
spacing).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.pt_swap import (
    _check_provenance_capacity,
    proposals_per_rung,
    pt_swap_cascade_tree,
)

__all__ = ["TemperatureControl", "make_ladder", "tempered_log_likelihood"]


# Geometric temperature-step table indexed by dimension, targeting a 25%
# swap-acceptance ratio for a Gaussian posterior (ptemcee's published
# constants, as in eryn_tpu.moves.tempering).
_TSTEP_TABLE = np.array([
    25.2741, 7.0, 4.47502, 3.5236, 3.0232, 2.71225, 2.49879, 2.34226, 2.22198,
    2.12628, 2.04807, 1.98276, 1.92728, 1.87946, 1.83774, 1.80096, 1.76826,
    1.73895, 1.7125, 1.68849, 1.66657, 1.64647, 1.62795, 1.61083, 1.59494,
    1.58014, 1.56632, 1.55338, 1.54123, 1.5298, 1.51901, 1.50881, 1.49916,
    1.49, 1.4813, 1.47302, 1.46512, 1.45759, 1.45039, 1.4435, 1.4369, 1.43056,
    1.42448, 1.41864, 1.41302, 1.40761, 1.40239, 1.39736, 1.3925, 1.38781,
    1.38327, 1.37888, 1.37463, 1.37051, 1.36652, 1.36265, 1.35889, 1.35524,
    1.3517, 1.34825, 1.3449, 1.34164, 1.33847, 1.33538, 1.33236, 1.32943,
    1.32656, 1.32377, 1.32104, 1.31838, 1.31578, 1.31325, 1.31076, 1.30834,
    1.30596, 1.30364, 1.30137, 1.29915, 1.29697, 1.29484, 1.29275, 1.29071,
    1.2887, 1.28673, 1.2848, 1.28291, 1.28106, 1.27923, 1.27745, 1.27569,
    1.27397, 1.27227, 1.27061, 1.26898, 1.26737, 1.26579, 1.26424, 1.26271,
    1.26121, 1.25973,
])


def make_ladder(ndim, ntemps=None, Tmax=None):
    """Geometric inverse-temperature ladder (ptemcee's selection rule): 25%
    swap-acceptance spacing by dimension, with ``Tmax=inf`` appending a
    beta = 0 rung.  Returns a float64 numpy array."""
    if not isinstance(ndim, (int, np.integer)) or ndim < 1:
        raise ValueError("Invalid number of dimensions specified.")
    if ntemps is None and Tmax is None:
        raise ValueError("Must specify one of ``ntemps`` and ``Tmax``.")
    if Tmax is not None and Tmax <= 1:
        raise ValueError("``Tmax`` must be greater than 1.")
    if ntemps is not None and (
        not isinstance(ntemps, (int, np.integer)) or ntemps < 1
    ):
        raise ValueError("Invalid number of temperatures specified.")

    if ndim > _TSTEP_TABLE.shape[0]:
        tstep = 1.0 + 2.0 * np.sqrt(np.log(4.0)) / np.sqrt(ndim)
    else:
        tstep = _TSTEP_TABLE[ndim - 1]

    append_inf = False
    if Tmax == np.inf:
        if ntemps is None:
            raise ValueError(
                "Must specify at least one of ntemps and finite Tmax."
            )
        append_inf = True
        Tmax = None
        ntemps = ntemps - 1

    if ntemps is not None:
        if Tmax is None:
            Tmax = tstep ** (ntemps - 1)
    else:
        ntemps = int(np.log(Tmax) / np.log(tstep) + 2)

    betas = np.logspace(0, -np.log10(Tmax), ntemps)
    if append_inf:
        betas = np.concatenate((betas, [0.0]))
    return betas


def tempered_log_likelihood(logl, betas):
    """``beta * logl`` with the ptemcee beta == 0 guard: anywhere the product
    is NaN (``0 * -inf``) return ``-inf``."""
    if logl.ndim == 2 and betas.ndim == 1:
        betas = betas[:, None]
    out = logl * betas
    return torch.where(torch.isnan(out), -math.inf, out)


def _flatten(tree, prefix=()):
    """Leaves of a nested dict as ``(path, tensor)`` in sorted key order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], prefix + (k,))
        return out
    return [(prefix, tree)]


def _unflatten(paths, leaves):
    tree = {}
    for path, leaf in zip(paths, leaves):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return tree


def _gather_walkers(tree, flat, ntemps, nwalkers):
    """Apply a flat ``(ntemps * nwalkers)`` provenance index to every leaf."""
    paths, leaves = zip(*_flatten(tree))
    return _unflatten(paths, [
        leaf.reshape((ntemps * nwalkers,) + leaf.shape[2:])[flat]
        .reshape(leaf.shape)
        for leaf in leaves
    ])


def _interp(x, xp, fp):
    """``jnp.interp(x, xp, fp)`` for ascending ``xp``: linear between the
    knots, ``fp[0]`` below ``xp[0]`` and ``fp[-1]`` above ``xp[-1]``."""
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, len(xp) - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    f = fp[i - 1] + (delta / dx) * df
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class TemperatureControl:
    """Temperature ladder, swap cascade and ladder adaptation.

    Attributes (``betas``, ``time``, ``swaps_accepted``, ``swaps_proposed``)
    mirror Eryn's object; the sampler sets them after each run.  ``time``,
    the adaptation clock, is a Python int until a run and the run's clock
    after it, a 0-d int tensor on the sampler's device: reading it on the
    host (``int(tc.time)``) waits for the run.  :meth:`temper_kernel` is
    the per-step entry point.

    ``use_kernels``: None (default) runs the kernel cascade when the state
    lies on a CUDA device and ``permute`` is on; True runs it on any device
    (on the CPU through its plain PyTorch version); False always runs the
    general cascade.  ``swap_scheme`` is ``"cascade"`` or ``"deo"``,
    ``adaptation_scheme`` ``"vousden"`` or ``"syed"`` (see the module).
    The swaps move blobs and the numeric supplemental entries with their
    walkers, but the state supplemental's ``skip_swap_supp_names``.

    On a state sharded over a device mesh (``mesh_layout``, which the
    sampler sets) the swap phase runs sharded: the kernel cascade and the
    general cascade decide on the gathered log-likelihood
    (:meth:`_swap_cascade_sharded`, :meth:`_swap_general_sharded`), DEO
    exchanges the neighbouring shards' edge rungs
    (:meth:`_swap_deo_sharded`); the ladder stays whole on every rank.
    """

    #: the rank's :class:`~eryn_tpu_torch.parallel.mesh.MeshLayout` under a
    #: device mesh, else None
    mesh_layout = None

    def __init__(
        self,
        effective_ndim=None,
        nwalkers=None,
        ntemps=1,
        betas=None,
        Tmax=None,
        adaptive=True,
        adaptation_lag=10000,
        adaptation_time=100,
        stop_adaptation=-1,
        permute=True,
        use_kernels=None,
        swap_scheme="cascade",
        adaptation_scheme="vousden",
        skip_swap_supp_names=(),
    ):
        if swap_scheme not in ("cascade", "deo"):
            raise ValueError(
                f"swap_scheme must be 'cascade' or 'deo', got {swap_scheme!r}."
            )
        if adaptation_scheme not in ("vousden", "syed"):
            raise ValueError(
                "adaptation_scheme must be 'vousden' or 'syed', got "
                f"{adaptation_scheme!r}."
            )
        if betas is None:
            if ntemps == 1:
                betas = np.array([1.0])
            else:
                betas = make_ladder(effective_ndim, ntemps=ntemps, Tmax=Tmax)
        betas = np.asarray(betas, dtype=np.float64)

        self.nwalkers = nwalkers
        self.betas = betas
        self.ntemps = ntemps = len(betas)
        self.permute = permute
        self.skip_swap_supp_names = list(skip_swap_supp_names)
        self.use_kernels = use_kernels
        self.swap_scheme = swap_scheme
        self.adaptation_scheme = adaptation_scheme
        self.time = 0
        self.adaptive = adaptive
        self.adaptation_time = adaptation_time
        self.adaptation_lag = adaptation_lag
        self.stop_adaptation = stop_adaptation
        self.swaps_proposed = np.full(ntemps - 1, nwalkers)
        self.swaps_accepted = np.zeros(ntemps - 1)
        # the generator of the host API's swaps (temper_comps,
        # temperature_swaps); a sampler gives its own
        self.generator = None
        self._deo_phase_ticked = False

    # ------------------------------------------------------------------
    # tempered posterior
    # ------------------------------------------------------------------
    def __getstate__(self):
        # the sampler's generator is the sampler's to pickle: it hands it
        # back on unpickling
        return {**self.__dict__, "generator": None}

    def tempered_likelihood(self, logl, betas=None):
        """``beta * logl`` with the ``beta == 0`` guard, on NumPy arrays or
        tensors (the kind of ``logl``); ``betas`` default to the ladder, and
        a 1-D ``logl`` needs them."""
        if betas is None:
            if np.ndim(logl) == 1:
                raise ValueError(
                    "If inputing a 1D logl array, need to provide 1D betas "
                    "array of the same length."
                )
            betas = self.betas
        if isinstance(logl, torch.Tensor):
            return tempered_log_likelihood(
                logl, torch.as_tensor(betas, dtype=logl.dtype,
                                      device=logl.device))
        logl, betas = np.asarray(logl), _host(betas)
        if logl.ndim == 2 and betas.ndim == 1:
            betas = betas[:, None]
        with np.errstate(invalid="ignore"):
            out = logl * betas
        return np.where(np.isnan(out), -np.inf, out)

    def compute_log_posterior_tempered(self, logl, logp, betas=None):
        """``beta * logl + logp`` (see :meth:`tempered_likelihood`)."""
        if betas is None:
            betas = self.betas
        out = self.tempered_likelihood(logl, betas)
        if isinstance(out, torch.Tensor):
            return out + torch.as_tensor(logp, dtype=out.dtype,
                                         device=out.device)
        return out + _host(logp)

    # ------------------------------------------------------------------
    # swap cascade
    # ------------------------------------------------------------------
    def _use_kernel_cascade(self, logl):
        if not self.permute or self.use_kernels is False:
            return False
        return self.use_kernels is True or logl.device.type == "cuda"

    def swap_kernel(self, generator, swap_tree, logl, betas, time=None):
        """One swap phase: the cascade, highest rung to lowest, or under
        ``swap_scheme="deo"`` one even-odd sweep of the parity of ``time``.

        Args:
            generator: the sampler's ``torch.Generator``.
            swap_tree: nested dict of tensors with leading ``(ntemps,
                nwalkers)`` dims, exchanged alongside ``logl``.
            logl: ``(ntemps, nwalkers)`` log-likelihoods.
            time: the clock (a 0-d int tensor; None: ``self.time``), whose
                parity picks the DEO boundaries.

        Returns:
            ``(swap_tree, logl, swaps_accepted, swaps_proposed)``: accepted
            pairings per boundary, ``(ntemps - 1,)``, and proposed ones: the
            int ``nwalkers`` where every walker is proposed (see
            :func:`~eryn_tpu_torch.ops.pt_swap.proposals_per_rung`), under
            DEO a tensor, 0 on the boundaries not attempted.
        """
        ntemps, nwalkers = self._dims(logl)
        if ntemps == 1:
            return swap_tree, logl, logl.new_zeros((0,)), logl.new_zeros((0,))
        if self.mesh_layout is not None:
            return self._swap_sharded(generator, swap_tree, logl, betas,
                                      self.time if time is None else time)
        if self.swap_scheme == "deo":
            raccept = self.draw_deo(generator, ntemps, nwalkers, logl.dtype,
                                    logl.device)
            return self._swap_kernel_deo(
                swap_tree, logl, betas, self.time if time is None else time,
                raccept)
        if self._use_kernel_cascade(logl):
            pi, shifts, raccept = self.draw_kernel(
                generator, ntemps, nwalkers, logl.dtype, logl.device
            )
            return self._swap_cascade_kernel(
                swap_tree, logl, betas, pi, shifts, raccept
            )
        perms, raccept = self.draw_general(generator, ntemps, nwalkers,
                                           logl.dtype, logl.device)
        swap_tree, logl, accepted = self._swap_cascade_general(
            swap_tree, logl, betas, perms, raccept
        )
        return swap_tree, logl, accepted, nwalkers

    def _dims(self, logl):
        """The ensemble's ``(ntemps, nwalkers)``: the global ones under a
        device mesh, where ``logl`` is this rank's shard."""
        if self.mesh_layout is None:
            return tuple(logl.shape)
        return self.mesh_layout.ntemps, self.mesh_layout.nwalkers

    def _swap_sharded(self, generator, swap_tree, logl, betas, time):
        """:meth:`swap_kernel` on this rank's shard: the draws of the phase
        one process would run (DEO, the kernel cascade or the general
        cascade, chosen as there) at their global shape, then the sharded
        form of the phase."""
        ntemps, nwalkers = self._dims(logl)
        if self.swap_scheme == "deo":
            raccept = self.draw_deo(generator, ntemps, nwalkers, logl.dtype,
                                    logl.device)
            return self._swap_deo_sharded(swap_tree, logl, betas, time,
                                          raccept)
        if self._use_kernel_cascade(logl):
            pi, shifts, raccept = self.draw_kernel(
                generator, ntemps, nwalkers, logl.dtype, logl.device)
            return self._swap_cascade_sharded(swap_tree, logl, betas, pi,
                                              shifts, raccept)
        perms, raccept = self.draw_general(generator, ntemps, nwalkers,
                                           logl.dtype, logl.device)
        return self._swap_general_sharded(swap_tree, logl, betas, perms,
                                          raccept)

    def _swap_cascade_sharded(self, swap_tree, logl, betas, pi, shifts,
                              raccept):
        """The kernel cascade on a sharded state: the log-likelihood
        gathered over the mesh (``(ntemps, nwalkers)``, small), one launch
        of :func:`~eryn_tpu_torch.ops.pt_swap.pt_swap_cascade_tree` on it
        with one int32 leaf, the slots' origins (every rank makes the same
        decisions), then each slot of this rank's shard takes its origin's
        row: rows held here are copied, the others moved once
        (:meth:`~eryn_tpu_torch.parallel.mesh.MeshLayout.move_rows`).
        Returns what :meth:`_swap_cascade_kernel` returns, for the shard."""
        lay = self.mesh_layout
        ntemps, nwalkers = lay.ntemps, lay.nwalkers
        full = lay.gather(logl)
        origin = torch.arange(ntemps * nwalkers, dtype=torch.int32,
                              device=logl.device).reshape(ntemps, nwalkers)
        out_logl = torch.empty_like(full)
        out_origin = torch.empty_like(origin)
        accepted = full.new_empty((ntemps - 1,))
        pt_swap_cascade_tree(full, [origin], betas, pi, shifts, raccept,
                             out_logl, [out_origin], accepted)
        proposed = proposals_per_rung(nwalkers, shifts, logl.dtype)
        paths, leaves = zip(*_flatten(swap_tree))
        moved = lay.move_rows(list(leaves), out_origin)
        return (_unflatten(paths, moved), lay.local(out_logl).contiguous(),
                accepted, proposed)

    def _swap_general_sharded(self, swap_tree, logl, betas, perms, raccept):
        """The general cascade on a sharded state: its decisions
        (:meth:`_cascade_general_decisions`) on the log-likelihood gathered
        over the mesh, which every rank makes alike, then each slot of this
        rank's shard takes its origin's row, each row moved once
        (:meth:`~eryn_tpu_torch.parallel.mesh.MeshLayout.move_rows`).
        Returns what :meth:`swap_kernel` returns, for the shard."""
        lay = self.mesh_layout
        logl_new, flat, accepted = self._cascade_general_decisions(
            lay.gather(logl), betas, perms, raccept)
        paths, leaves = zip(*_flatten(swap_tree))
        moved = lay.move_rows(list(leaves),
                              flat.reshape(lay.ntemps, lay.nwalkers))
        return (_unflatten(paths, moved), lay.local(logl_new).contiguous(),
                accepted, lay.nwalkers)

    def _swap_deo_sharded(self, swap_tree, logl, betas, time, raccept):
        """A DEO phase on a sharded state: this shard's rungs with the
        neighbouring shards' edge rungs (the only rows a parity phase pairs
        across shards: each walker with itself, so within the walker
        shard), the decisions of :meth:`_swap_kernel_deo` on those rows,
        and the accepted swaps of each boundary counted where its lower
        rung lies and summed over the mesh (integer counts: exact).
        Returns what :meth:`_swap_kernel_deo` returns, for the shard."""
        lay = self.mesh_layout
        ntemps, nwalkers = lay.ntemps, lay.nwalkers
        nt, t0, w0 = lay.nt, lay.t0, lay.w0
        dtype, device = logl.dtype, logl.device
        paths, leaves = zip(*_flatten(swap_tree))
        ext = lay.temp_halo([logl, *leaves])
        lo = t0 - 1 if t0 > 0 else 0  # the global rung of ext's first row
        hi = lo + ext[0].shape[0]
        parity = torch.as_tensor(time, device=device) % 2
        bounds = torch.arange(lo, hi - 1, device=device)
        active = bounds % 2 == parity
        dbetas = (betas[lo:hi - 1] - betas[lo + 1:hi]).to(dtype)
        ll = ext[0]
        paccept = dbetas[:, None] * (ll[1:] - ll[:-1])
        sel = (paccept > raccept[lo:hi - 1, w0:w0 + lay.nw]) & active[:, None]
        pad = torch.zeros((1, lay.nw), dtype=torch.bool, device=device)
        move_down = torch.cat([sel, pad])
        move_up = torch.cat([pad, sel])
        keep = slice(t0 - lo, t0 - lo + nt)

        def exchange(x):
            down = torch.cat([x[1:], x[-1:]])
            up = torch.cat([x[:1], x[:-1]])
            extra = (1,) * (x.ndim - 2)
            return torch.where(move_down.reshape(move_down.shape + extra),
                               down,
                               torch.where(move_up.reshape(move_up.shape
                                                           + extra), up, x)
                               )[keep].contiguous()

        counts = logl.new_zeros((ntemps - 1,))
        own = slice(t0, min(t0 + nt, ntemps - 1))  # boundaries counted here
        counts[own] = sel[own.start - lo:own.stop - lo].sum(dim=-1).to(dtype)
        lay.sum(counts)
        proposed = (torch.arange(ntemps - 1, device=device) % 2
                    == parity).to(dtype) * nwalkers
        return (_unflatten(paths, [exchange(x) for x in ext[1:]]),
                exchange(ext[0]), counts, proposed)

    def draw_general(self, generator, ntemps, nwalkers, dtype, device):
        """Randomness of one general cascade: the walker orders ``perms``
        ``(ntemps - 1, 2, nwalkers)`` (identities without ``permute``) and
        the log-uniform acceptance draws ``raccept``."""
        if self.permute:
            perms = torch.argsort(
                torch.rand((ntemps - 1, 2, nwalkers), generator=generator,
                           device=device),
                dim=-1,
            )
        else:
            perms = torch.arange(nwalkers, device=device).expand(
                ntemps - 1, 2, nwalkers
            )
        raccept = torch.log(
            torch.rand((ntemps - 1, nwalkers), generator=generator,
                       dtype=dtype, device=device)
        )
        return perms, raccept

    @staticmethod
    def draw_kernel(generator, ntemps, nwalkers, dtype, device):
        """Randomness of one kernel cascade: the walker relabelling ``pi``,
        the per-rung rotations ``shifts`` (int32) and the log-uniform
        acceptance draws ``raccept``."""
        pi = torch.argsort(
            torch.rand(nwalkers, generator=generator, device=device)
        )
        shifts = torch.randint(
            0, nwalkers, (ntemps - 1,), generator=generator, device=device,
            dtype=torch.int32,
        )
        raccept = torch.log(
            torch.rand((ntemps - 1, nwalkers), generator=generator,
                       dtype=dtype, device=device)
        )
        return pi, shifts, raccept

    @staticmethod
    def draw_deo(generator, ntemps, nwalkers, dtype, device):
        """Randomness of one DEO phase: the log-uniform acceptance draws
        ``raccept``, ``(ntemps - 1, nwalkers)``."""
        return torch.log(
            torch.rand((ntemps - 1, nwalkers), generator=generator,
                       dtype=dtype, device=device)
        )

    @staticmethod
    def _swap_kernel_deo(swap_tree, logl, betas, time, raccept):
        """DEO phase from the given draws: boundary ``b`` (rungs ``b`` and
        ``b + 1``) is attempted iff ``b % 2 == time % 2``, walker by walker,
        and accepted iff ``dbeta_b (L[b+1] - L[b]) > raccept[b]``.  The
        parity is read from the clock on its device, never on the host, so
        a captured step attempts the other class at the next replay.
        Returns ``(swap_tree, logl, swaps_accepted, swaps_proposed)`` with
        ``nwalkers`` proposed on the attempted boundaries and 0 on the
        others."""
        ntemps, nwalkers = logl.shape
        dtype = logl.dtype
        parity = torch.as_tensor(time, device=logl.device) % 2
        active = torch.arange(ntemps - 1, device=logl.device) % 2 == parity
        dbetas = (betas[:-1] - betas[1:]).to(dtype)
        paccept = dbetas[:, None] * (logl[1:] - logl[:-1])
        sel = (paccept > raccept) & active[:, None]
        pad = torch.zeros((1, nwalkers), dtype=torch.bool, device=logl.device)
        move_down = torch.cat([sel, pad])  # rung i takes rung i + 1's row
        move_up = torch.cat([pad, sel])  # rung i takes rung i - 1's row

        def exchange(x):
            # the pairs of one parity are disjoint: three shifted selects
            down = torch.cat([x[1:], x[-1:]])
            up = torch.cat([x[:1], x[:-1]])
            extra = (1,) * (x.ndim - 2)
            return torch.where(move_down.reshape(move_down.shape + extra),
                               down,
                               torch.where(move_up.reshape(move_up.shape
                                                           + extra), up, x))

        paths, leaves = zip(*_flatten(swap_tree))
        swap_tree = _unflatten(paths, [exchange(x) for x in leaves])
        accepted = sel.sum(dim=-1).to(dtype)
        proposed = active.to(dtype) * nwalkers
        return swap_tree, exchange(logl), accepted, proposed

    def _swap_cascade_general(self, swap_tree, logl, betas, perms, raccept):
        """General cascade from the given draws: ``perms`` is
        ``(ntemps - 1, 2, nwalkers)`` (walker orders of rung i and rung i-1
        per boundary)."""
        ntemps, nwalkers = logl.shape
        logl_new, flat, accepted = self._cascade_general_decisions(
            logl, betas, perms, raccept)
        swap_tree = _gather_walkers(swap_tree, flat, ntemps, nwalkers)
        return swap_tree, logl_new, accepted

    @staticmethod
    def _cascade_general_decisions(logl, betas, perms, raccept):
        """The general cascade's decisions on the whole ``(ntemps,
        nwalkers)`` log-likelihood: ``(log-likelihood after the phase, the
        flat slot each slot's walker came from, accepted swaps per
        boundary)``.  Per rung, the log-likelihood travels with an origin
        channel in its dtype, which float32 carries exactly up to
        :func:`~eryn_tpu_torch.ops.pt_swap._check_provenance_capacity`."""
        ntemps, nwalkers = logl.shape
        if logl.dtype == torch.float32:  # float64 carries exact ints to 2^53
            _check_provenance_capacity(ntemps, nwalkers)
        inv_perms = torch.argsort(perms, dim=-1)
        origin0 = torch.arange(
            ntemps * nwalkers, dtype=logl.dtype, device=logl.device
        ).reshape(ntemps, nwalkers)
        data = torch.stack([logl, origin0], dim=-1)  # (ntemps, nwalkers, 2)
        accepted = []
        for i in range(ntemps - 1, 0, -1):
            dbeta = betas[i - 1] - betas[i]
            di = data[i][perms[i - 1, 0]]
            di1 = data[i - 1][perms[i - 1, 1]]
            sel = (dbeta * (di[:, 0] - di1[:, 0]) > raccept[i - 1])[:, None]
            accepted.append(sel.sum().to(logl.dtype))
            # the gathers above copied both rows, so the writes below
            # cannot clobber their own inputs
            data[i] = torch.where(sel, di1, di)[inv_perms[i - 1, 0]]
            data[i - 1] = torch.where(sel, di, di1)[inv_perms[i - 1, 1]]
        flat = data[..., 1].long().reshape(-1)
        return data[..., 0], flat, torch.stack(accepted[::-1])

    def _swap_cascade_kernel(self, swap_tree, logl, betas, pi, shifts, raccept):
        """Kernel cascade from the given draws (see :meth:`draw_kernel`), in
        one launch: the relabelling by ``pi`` is an index inside the kernel,
        every leaf of the tree moves once in its own layout and dtype, and
        the accepted pairings are counted there
        (:func:`~eryn_tpu_torch.ops.pt_swap.pt_swap_cascade_tree`).  Returns
        ``(swap_tree, logl, swaps_accepted, swaps_proposed)``; above
        :data:`~eryn_tpu_torch.ops.pt_swap.ROLLED_THRESHOLD` walkers a rung
        proposes fewer than ``nwalkers`` pairings."""
        ntemps, nwalkers = logl.shape
        paths, leaves = zip(*_flatten(swap_tree))
        leaves = [x if x.is_contiguous() else x.contiguous() for x in leaves]
        logl_new = torch.empty_like(logl)
        leaves_new = [torch.empty_like(x) for x in leaves]
        accepted = logl.new_empty((ntemps - 1,))
        pt_swap_cascade_tree(logl, leaves, betas, pi, shifts, raccept,
                             logl_new, leaves_new, accepted)
        proposed = proposals_per_rung(nwalkers, shifts, logl.dtype)
        return _unflatten(paths, leaves_new), logl_new, accepted, proposed

    # ------------------------------------------------------------------
    # ladder adaptation
    # ------------------------------------------------------------------
    def adaptation_gain(self, time, betas):
        """The gain of the ladder's update at clock ``time`` (a 0-d int
        tensor, or a Python int): ``lag / (time + lag) / adaptation_time``,
        a 0-d tensor in the dtype and on the device of ``betas``."""
        # on the device, so that a captured step reads the clock as it
        # stands.  Both operands of each division are tensors: PyTorch
        # divides a CUDA tensor by a host scalar as a product with its
        # reciprocal, an ulp from IEEE division
        t = torch.as_tensor(time, device=betas.device).to(betas.dtype)
        lag = torch.full_like(t, self.adaptation_lag)
        return lag / (t + lag) / torch.full_like(t, self.adaptation_time)

    def ladder_adjustment_kernel(self, time, betas, ratios):
        """Ladder adjustment per arXiv:1501.05823: each interior rung drifts
        by the local difference of neighbouring acceptance ratios, with the
        gain :meth:`adaptation_gain` at clock ``time``."""
        dSs = self.adaptation_gain(time, betas) * (ratios[:-1] - ratios[1:])
        deltaTs = torch.diff(1.0 / betas[:-1]) * torch.exp(dSs)
        new_mid = 1.0 / (torch.cumsum(deltaTs, dim=0) + 1.0 / betas[0])
        return torch.cat([betas[:1], new_mid, betas[-1:]])

    def syed_schedule_kernel(self, time, betas, ratios, proposed=None):
        """Communication-barrier schedule update (Syed, Bouchard-Cote,
        Deligiannidis & Doucet 2021, JRSS-B, §5.1).  The cumulative barrier
        is piecewise linear over the current ladder through the rejection
        rates (``lam[k] = sum_{i<k} (1 - ratios[i])``); the rungs move, with
        the gain :meth:`adaptation_gain`, toward its inverse at equally
        spaced targets, where every boundary rejects alike.

        Args:
            time: the clock.
            betas: ``(ntemps,)`` descending ladder; its ends stay.
            ratios: ``(ntemps - 1,)`` acceptance per attempt (under DEO the
                raw ratios, not the doubled ones).
            proposed: the proposals per boundary of this phase (a tensor),
                or None.  A boundary that proposed nothing (the other DEO
                parity) takes the mean rejection of those that did, which
                keeps the equal-rejection fixed point.
        """
        dtype = betas.dtype
        r = 1.0 - torch.clamp(ratios.to(dtype), 0.0, 1.0)
        if isinstance(proposed, torch.Tensor):
            attempted = proposed > 0
            n_att = torch.clamp(attempted.to(dtype).sum(), min=1.0)
            mean_r = torch.where(attempted, r, 0.0).sum() / n_att
            r = torch.where(attempted, r, mean_r)
        # a floor keeps the barrier strictly increasing, so its inverse is
        # defined on flat stretches
        r = torch.clamp(r, min=1e-4)
        lam = torch.cat([r.new_zeros((1,)), torch.cumsum(r, dim=0)])
        n = betas.shape[0]
        steps = torch.arange(n, dtype=dtype, device=betas.device)
        targets = lam[-1] * steps / torch.full_like(lam[-1], n - 1)
        beta_star = _interp(targets, lam, betas)
        kappa = self.adaptation_gain(time, betas)
        new_mid = (1.0 - kappa) * betas[1:-1] + kappa * beta_star[1:-1]
        return torch.cat([betas[:1], new_mid, betas[-1:]])

    def communication_barrier(self, ratios=None):
        """Estimated cumulative communication barrier (Syed et al. 2021,
        §3.2): the running sum of the rejection rates per boundary from the
        cold rung down, on the host.  ``ratios`` default to
        ``swaps_accepted / swaps_proposed``.  Returns ``(lambdas, total)``,
        ``lambdas`` shaped ``(ntemps,)``; about ``1 + total`` rungs
        suffice."""
        if ratios is None:
            ratios = _host(self.swaps_accepted) / np.maximum(
                _host(self.swaps_proposed).astype(float), 1.0)
        r = 1.0 - np.clip(_host(ratios).astype(float), 0.0, 1.0)
        lam = np.concatenate([[0.0], np.cumsum(r)])
        return lam, float(lam[-1])

    # ------------------------------------------------------------------
    # evidence over this control's ladder
    # ------------------------------------------------------------------
    def thermodynamic_integration_log_evidence(self, logls, betas=None):
        """Thermodynamic-integration log evidence from the mean
        log-likelihood per rung ``logls`` over ``betas`` (default: the
        current ladder); returns ``(log_evidence, error)``."""
        from ..utils.utility import thermodynamic_integration_log_evidence

        betas = self.betas if betas is None else betas
        return thermodynamic_integration_log_evidence(betas, logls)

    def stepping_stone_log_evidence(self, logls, betas=None, block_len=50,
                                    repeats=100, seed=None):
        """Stepping-stone log evidence from ``logls`` ``(nsteps, ntemps,
        nwalkers)`` over ``betas`` (default: the current ladder); returns
        ``(log_evidence, bootstrap_error)``."""
        from ..utils.utility import stepping_stone_log_evidence

        betas = self.betas if betas is None else betas
        return stepping_stone_log_evidence(
            betas, logls, block_len=block_len, repeats=repeats, seed=seed)

    def temper_kernel(self, generator, state, time, adapt=True):
        """Swap cascade, then (optionally) ladder adaptation.

        Args:
            generator: the sampler's ``torch.Generator``.
            state: :class:`~eryn_tpu_torch.state.State`.
            time: adaptation clock, a 0-d int tensor on the state's device
                (a Python int is taken too); it advances by one per adapting
                phase, and under DEO, where its parity picks the boundaries,
                by one per phase; the ladder stops adapting once it reaches
                ``stop_adaptation`` (when that is not negative).  Nothing
                here reads it on the host, so a captured step reads it as
                it stands at each replay.
            adapt: in-model moves adapt the ladder; reversible-jump moves do
                not.

        Returns:
            ``(state, swaps_accepted, time)``.
        """
        ntemps, nwalkers = self._dims(state.log_like)
        if ntemps == 1:
            return state, state.log_like.new_zeros((0,)), time
        swap_tree = {
            "coords": state.branches_coords,
            "inds": state.branches_inds,
            "log_prior": state.log_prior,
        }
        branch_supps = {n: s.holder
                        for n, s in state.branches_supplemental.items()
                        if s is not None and s.holder}
        if branch_supps:
            swap_tree["branch_supps"] = branch_supps
        if state.blobs is not None:
            swap_tree["blobs"] = state.blobs
        supp = state.supplemental
        if supp is not None:
            moved = {k: v for k, v in supp.holder.items()
                     if k not in self.skip_swap_supp_names}
            if moved:
                swap_tree["supps"] = moved
        deo = self.swap_scheme == "deo"
        # the cascade needs no clock (and an override may take none)
        swap_tree, logl, swaps_accepted, swaps_proposed = self.swap_kernel(
            generator, swap_tree, state.log_like, state.betas,
            **({"time": time} if deo else {})
        )
        # every consumer normalizes by nwalkers proposals per rung, so counts
        # from a cascade that proposed fewer pairings are rescaled to that
        # scale, as the JAX package does (a cascade rung always proposes
        # some).  DEO attempts a boundary every other phase: its ratios are
        # doubled, so that their mean over phases is the acceptance per
        # attempt, as the cascade's is
        if deo:
            raw_ratios = swaps_accepted / torch.clamp(swaps_proposed, min=1.0)
            ratios = 2.0 * raw_ratios
        else:
            raw_ratios = ratios = swaps_accepted / swaps_proposed
        swaps_accepted = ratios * nwalkers
        betas = state.betas
        if adapt and self.adaptive:
            time = torch.as_tensor(time, device=betas.device)
            if self.adaptation_scheme == "syed":
                # the barrier wants the rates per attempt and which
                # boundaries were attempted
                new_betas = self.syed_schedule_kernel(
                    time, betas, raw_ratios, proposed=swaps_proposed)
            else:
                new_betas = self.ladder_adjustment_kernel(time, betas, ratios)
            if self.stop_adaptation >= 0:
                new_betas = torch.where(time < self.stop_adaptation,
                                        new_betas, betas)
            betas = new_betas
            time = time + 1
        elif deo:
            # the clock is DEO's parity: it ticks on every phase, the
            # reversible-jump moves' too
            time = time + 1
        if "supps" in swap_tree:
            supp = supp.with_holder({**supp.holder, **swap_tree["supps"]})
        new_state = state.replace(
            coords=swap_tree["coords"],
            inds=swap_tree["inds"],
            branch_supplemental={
                n: state.branches[n].branch_supplemental.with_holder(h)
                for n, h in swap_tree.get("branch_supps", {}).items()},
            log_like=logl,
            log_prior=swap_tree["log_prior"],
            blobs=swap_tree.get("blobs"),
            betas=betas,
            supplemental=supp,
        )
        return new_state, swaps_accepted, time

    # ------------------------------------------------------------------
    # the host API: a step run on the host (moves/legacy.py) and user code
    # written against Eryn's mutation-style calls
    # ------------------------------------------------------------------
    def _host_generator(self, generator):
        generator = generator if generator is not None else self.generator
        if generator is None:
            raise ValueError(
                "The host tempering API draws from a torch.Generator: pass "
                "generator=, or use a control wired to a sampler (which "
                "gives it its own).")
        return generator

    def temper_comps(self, state, adapt=True, generator=None):
        """One swap phase of a filled :class:`~eryn_tpu_torch.state.State`
        and, with ``adapt``, the ladder's adaptation: :meth:`temper_kernel`
        on the generator's device (the swap kernel on a CUDA device) at the
        clock ``time``, which advances as in the sampler's own steps.
        ``betas``, ``time`` and ``swaps_accepted`` take the phase's values;
        returns the new state."""
        generator = self._host_generator(generator)
        device = generator.device
        if state.log_like.device != device:
            state = state.map_tensors(lambda x: x.to(device))
        if state.betas is None:
            state = state.replace(betas=torch.as_tensor(
                _host(self.betas), dtype=state.log_like.dtype, device=device))
        time = torch.as_tensor(self.time, device=device).to(torch.int64)
        new_state, swaps, time = self.temper_kernel(generator, state, time,
                                                    adapt=adapt)
        self.swaps_accepted = swaps
        self.swaps_proposed = np.full(self.ntemps - 1, state.nwalkers)
        self.time = time
        self.betas = new_state.betas
        return new_state

    def temperature_swaps(self, x, logP, logl, logp, inds=None, blobs=None,
                          supps=None, branch_supps=None, generator=None):
        """Eryn's swap call on host arrays: one swap phase of ``x``
        (``{branch: coords}``), ``logl``, ``logp`` and the optional ``inds``,
        ``blobs`` and supplementals (their entries set in place), drawn from
        the generator on its device.  Records ``swaps_accepted`` (under DEO
        the clock ticks, once per phase with :meth:`adapt_temps`) and
        returns ``(x, logP, logl, logp, inds, blobs, supps,
        branch_supps)``, ``logP`` tempered anew from the swapped parts."""
        generator = self._host_generator(generator)
        device = generator.device
        logl = np.asarray(logl)

        def put(v):
            return torch.as_tensor(np.asarray(v), device=device)

        swap_tree = {"logp": put(logp)}
        if x is not None:
            swap_tree["x"] = {n: put(v) for n, v in x.items()}
        if inds is not None:
            swap_tree["inds"] = {n: put(v) for n, v in inds.items()}
        if blobs is not None:
            swap_tree["blobs"] = put(blobs)
        supps_holder = getattr(supps, "holder", None)
        if supps_holder:
            swap_tree["supps"] = {k: put(v) for k, v in supps_holder.items()
                                  if k not in self.skip_swap_supp_names}
        bs_holders = {n: {k: put(v) for k, v in bs.holder.items()}
                      for n, bs in (branch_supps or {}).items()
                      if getattr(bs, "holder", None)}
        if bs_holders:
            swap_tree["branch_supps"] = bs_holders
        logl_t = put(logl)
        betas = torch.as_tensor(_host(self.betas), dtype=logl_t.dtype,
                                device=device)
        swap_tree, logl_new, accepted, proposed = self.swap_kernel(
            generator, swap_tree, logl_t, betas)
        nwalkers = logl.shape[-1]
        ratios = _host(accepted) / np.maximum(_host(proposed), 1.0)
        if self.swap_scheme == "deo":
            # the per-attempt rescale of temper_kernel; the parity clock
            # ticks once this phase, also when adapt_temps follows
            ratios = 2.0 * ratios
            self.time = int(_host(self.time)) + 1
            self._deo_phase_ticked = True
        self.swaps_accepted = ratios * nwalkers
        self.swaps_proposed = np.full(self.ntemps - 1, nwalkers)
        logl_out = _host(logl_new)
        logp_out = _host(swap_tree["logp"])
        logP_out = self.compute_log_posterior_tempered(logl_out, logp_out)

        def out(tree):
            return {n: _host(v) for n, v in tree.items()}

        if supps_holder:
            for k, v in swap_tree["supps"].items():
                supps[k] = _host(v)
        for name, holder in swap_tree.get("branch_supps", {}).items():
            for k, v in holder.items():
                branch_supps[name][k] = _host(v)
        return (out(swap_tree["x"]) if x is not None else None, logP_out,
                logl_out, logp_out,
                out(swap_tree["inds"]) if inds is not None else None,
                _host(swap_tree["blobs"]) if blobs is not None else None,
                supps, branch_supps)

    def do_swaps_indexing(self, i, iperm_sel, i1perm_sel, dbeta, x, logP,
                          logl, logp, inds=None, blobs=None, supps=None,
                          branch_supps=None):
        """Apply one rung's accepted swaps in place between rungs ``i`` and
        ``i - 1`` on host arrays: ``iperm_sel`` and ``i1perm_sel`` are the
        accepted walkers of each, and ``logP`` is tempered anew with
        ``dbeta = betas[i - 1] - betas[i]``.  Returns Eryn's 8-tuple
        ``(x, logP, logl, logp, inds, blobs, supps, branch_supps)``."""
        iperm_sel = np.asarray(iperm_sel)
        i1perm_sel = np.asarray(i1perm_sel)

        def swap_pairwise(arr):
            keep_hi = np.copy(arr[i, iperm_sel])
            arr[i, iperm_sel] = arr[i - 1, i1perm_sel]
            arr[i - 1, i1perm_sel] = keep_hi

        def swap_holder(holder):
            hi = holder[i, iperm_sel]
            lo = holder[i - 1, i1perm_sel]
            for key in self.skip_swap_supp_names:
                for side in (hi, lo):
                    if hasattr(side, "pop"):
                        side.pop(key, None)
            holder[i, iperm_sel] = lo
            holder[i - 1, i1perm_sel] = hi

        for name in x:
            swap_pairwise(x[name])
            if inds is not None and name in inds:
                swap_pairwise(inds[name])
            if branch_supps is not None and branch_supps.get(name) is not None:
                swap_holder(branch_supps[name])

        logl_hi = np.copy(logl[i, iperm_sel])
        logl_lo = np.copy(logl[i - 1, i1perm_sel])
        logp_hi = np.copy(logp[i, iperm_sel])
        logP_hi = np.copy(logP[i, iperm_sel])
        logP_lo = np.copy(logP[i - 1, i1perm_sel])
        logl[i, iperm_sel] = logl_lo
        logp[i, iperm_sel] = logp[i - 1, i1perm_sel]
        logP[i, iperm_sel] = logP_lo - dbeta * logl_lo
        logl[i - 1, i1perm_sel] = logl_hi
        logp[i - 1, i1perm_sel] = logp_hi
        logP[i - 1, i1perm_sel] = logP_hi + dbeta * logl_hi
        if blobs is not None:
            swap_pairwise(blobs)
        if supps is not None:
            swap_holder(supps)
        return (x, logP, logl, logp, inds, blobs, supps, branch_supps)

    def adapt_temps(self):
        """Ladder adaptation from ``swaps_accepted / swaps_proposed`` on
        the host, as Eryn's call: ``betas`` move and the clock advances
        (unless :meth:`temperature_swaps` already ticked this DEO phase)."""
        if self.adaptive and self.ntemps > 1:
            time = int(_host(self.time))
            if self.stop_adaptation < 0 or time < self.stop_adaptation:
                betas = torch.as_tensor(_host(self.betas), dtype=torch.float64)
                ratios = torch.as_tensor(
                    _host(self.swaps_accepted) / _host(self.swaps_proposed),
                    dtype=torch.float64)
                if self.adaptation_scheme == "syed":
                    proposed = None
                    if self.swap_scheme == "deo":
                        # the 2x per-attempt values, zero on the boundaries
                        # not attempted
                        proposed = ratios > 0
                        ratios = ratios / 2.0
                    new = self.syed_schedule_kernel(time, betas, ratios,
                                                    proposed=proposed)
                else:
                    new = self.ladder_adjustment_kernel(time, betas, ratios)
                self.betas = new.numpy()
            if self._deo_phase_ticked:
                self._deo_phase_ticked = False
            else:
                self.time = int(_host(self.time)) + 1
