"""In-memory chain storage on the host.

Port of :mod:`eryn_tpu.backends.backend`: NumPy buffers with Eryn's layout
``(nsteps, ntemps, nwalkers, nleaves_max, ndim)`` per branch, dead leaves
NaN-masked on save, and the same getters, the diagnostics among them
(autocorrelation, evidence, Gelman-Rubin, rank-normalised R-hat, effective
sample size; :mod:`eryn_tpu_torch.utils.utility`); and the checkpoint a run
needs to continue: the states of the sampler's two generators, the
adaptation clock and the moves' kernel states.
"""

from __future__ import annotations

import numpy as np

from ..utils.pytree import tree_flatten

__all__ = ["Backend", "host_leaves"]


def host_leaves(leaves):
    """The leaves as NumPy arrays; a leaf that is no array (an object a
    custom move keeps on the host) becomes None, keeping its position."""
    out = []
    for leaf in leaves:
        if hasattr(leaf, "detach"):  # a tensor, wherever it lies
            leaf = leaf.detach().cpu().numpy()
        arr = np.asarray(leaf)
        out.append(None if arr.dtype == object else arr)
    return out


class Backend:
    """In-memory backend.

    Under a device mesh (:mod:`~eryn_tpu_torch.parallel.mesh`) the sampler
    resets it through :meth:`reset_sharded`: it then stores the rank's
    shard, and its getters and counters (``accepted``, ``rj_accepted``,
    :attr:`move_info`), which every rank reads alike, gather the shards
    into the global arrays.  :meth:`reshard` moves a stored chain to
    another placement of the state (sharded, or whole in every process).
    The kernel states it is given are the whole ensemble's whatever the
    placement (the sampler gathers them)."""

    device_resident = False
    #: the rank's MeshLayout whose shard this backend stores, or None
    _shard = None

    def __init__(self, store_missing_leaves=np.nan, dtype=None):
        self.initialized = False
        self.store_missing_leaves = store_missing_leaves
        self.dtype = np.dtype(dtype) if dtype is not None else np.dtype(np.float64)

    def reset(self, nwalkers, ndims, nleaves_max=1, ntemps=1, branch_names=None,
              rj=False, moves=None, info=None, key_order=None):
        """Allocate empty chain storage.  ``key_order`` is the priors'
        parameter order per branch, which a resume must match."""
        if branch_names is None:
            branch_names = ["model_0"]
        if isinstance(branch_names, str):
            branch_names = [branch_names]

        def per_branch(val):
            if isinstance(val, (int, np.integer)):
                return {bn: int(val) for bn in branch_names}
            return {k: int(v) for k, v in val.items()}

        self.nwalkers = int(nwalkers)
        self.ntemps = int(ntemps)
        self.branch_names = list(branch_names)
        self.nbranches = len(self.branch_names)
        self.ndims = per_branch(ndims)
        self.nleaves_max = per_branch(nleaves_max)
        self.rj = rj
        self.move_keys = list(moves) if moves else None
        self.info = dict(info) if info else {}
        self.key_order = dict(key_order) if key_order else None

        self.iteration = 0
        self.chain = {
            n: np.empty((0,) + self.shape[n], dtype=self.dtype)
            for n in self.branch_names
        }
        self.inds = {
            n: np.empty((0,) + self.shape[n][:3], dtype=bool)
            for n in self.branch_names
        }
        self.log_like = np.empty((0, ntemps, nwalkers), dtype=self.dtype)
        self.log_prior = np.empty((0, ntemps, nwalkers), dtype=self.dtype)
        self.betas = np.empty((0, ntemps), dtype=self.dtype)
        self.blobs = None
        # cumulative counters in float64, as a file holds them: the swap
        # counts per step are ratios times nwalkers, not integers
        self.accepted = np.zeros((ntemps, nwalkers))
        self.rj_accepted = np.zeros((ntemps, nwalkers)) if rj else None
        self.swaps_accepted = np.zeros((ntemps - 1,)) if ntemps > 1 else None
        self.moves_accepted_fraction = (
            {key: np.zeros((ntemps, nwalkers)) for key in self.move_keys}
            if self.move_keys else None
        )
        self.random_state = None
        self.host_random_state = None
        self.numpy_random_state = None
        self._kernel_state_leaves = None
        self._sampler_clock = None
        self._shard = None
        self.initialized = True

    def reset_sharded(self, layout, nwalkers, ndims, ntemps=1, **kwargs):
        """:meth:`reset` for this rank's shard of the ``ntemps x nwalkers``
        ensemble that ``layout`` (a
        :class:`~eryn_tpu_torch.parallel.mesh.MeshLayout`) splits: the
        storage holds the shard, and ``ntemps``, ``nwalkers`` and
        :attr:`shape` are the global ensemble's."""
        self.reset(layout.nw, ndims, ntemps=layout.nt, **kwargs)
        self._shard = layout
        self.ntemps, self.nwalkers = layout.ntemps, layout.nwalkers
        # the ladder and the swap counts are whole on every rank
        if self.betas is not None:
            self.betas = np.empty((0, self.ntemps), dtype=self.dtype)
        self.swaps_accepted = (np.zeros((self.ntemps - 1,))
                               if self.ntemps > 1 else None)

    def reshard(self, layout):
        """Continue the stored chain on another placement: ``layout``'s
        shard, or the whole ensemble in every process for None.  The
        stored rows are gathered from the old placement's ranks and cut to
        the new one's (every rank calls this together)."""
        from ..parallel.mesh import convert_rows, same_placement

        src = self._shard
        if not same_placement(src, layout):
            def conv(x, taxis=0):
                return (None if x is None
                        else convert_rows(x, taxis, taxis + 1, src, layout))

            self._reshard_store(conv)
            for name in ("accepted", "rj_accepted"):
                self._counter_set(name, conv(self._counter_get(name)))
            if self.moves_accepted_fraction is not None:
                self.moves_accepted_fraction = {
                    k: conv(np.asarray(v))
                    for k, v in self.moves_accepted_fraction.items()}
        self._shard = layout

    def _reshard_store(self, conv):
        """The stored steps through ``conv`` (their step axis first)."""
        for n in self.branch_names:
            self.chain[n] = conv(self.chain[n], 1)
            self.inds[n] = conv(self.inds[n], 1)
        self.log_like = conv(self.log_like, 1)
        self.log_prior = conv(self.log_prior, 1)
        self.blobs = conv(self.blobs, 1)

    # ------------------------------------------------------------------
    # cumulative counters: the rank's shard held, the whole ensemble's read
    # ------------------------------------------------------------------
    def _counter_get(self, name):
        return self.__dict__.get("_count_" + name)

    def _counter_set(self, name, value):
        self.__dict__["_count_" + name] = value

    def _whole_counter(self, name):
        x = self._counter_get(name)
        if x is None or self._shard is None:
            return x
        return self._shard.gather_numpy(np.asarray(x))

    accepted = property(lambda self: self._whole_counter("accepted"),
                        lambda self, v: self._counter_set("accepted", v))
    rj_accepted = property(lambda self: self._whole_counter("rj_accepted"),
                           lambda self, v: self._counter_set("rj_accepted", v))
    # the swap counts are whole on every rank
    swaps_accepted = property(
        lambda self: self._counter_get("swaps_accepted"),
        lambda self, v: self._counter_set("swaps_accepted", v))

    @property
    def shape(self):
        """Per-branch ``(ntemps, nwalkers, nleaves_max, ndim)``."""
        return {
            n: (self.ntemps, self.nwalkers, self.nleaves_max[n], self.ndims[n])
            for n in self.branch_names
        }

    def has_blobs(self):
        return self.blobs is not None

    def grow(self, ngrow, blobs=None):
        """Preallocate ``ngrow`` more steps; ``blobs``, one step's blobs
        (any values, their shape and dtype count), allocates the blob
        storage at the first call that gives it (NaN before)."""
        if not self.initialized:
            raise AttributeError("Backend must be reset before growing.")

        def extend(arr, fill):
            extra = np.full((int(ngrow),) + arr.shape[1:], fill, dtype=arr.dtype)
            return np.concatenate([arr, extra], axis=0)

        for n in self.branch_names:
            self.chain[n] = extend(self.chain[n], np.nan)
            self.inds[n] = extend(self.inds[n], False)
        self.log_like = extend(self.log_like, np.nan)
        self.log_prior = extend(self.log_prior, np.nan)
        self.betas = extend(self.betas, np.nan)
        if blobs is not None:
            blobs = np.asarray(blobs)
            if self.blobs is None:
                self.blobs = np.full(
                    (self.log_like.shape[0] - int(ngrow),) + blobs.shape,
                    np.nan, dtype=blobs.dtype)
            self.blobs = extend(self.blobs, np.nan)

    def save_segment(self, coords, inds, log_like, log_prior, betas,
                     blobs=None, accepted=None, rj_accepted=None, swaps_accepted=None,
                     moves_accepted_fraction=None, random_state=None,
                     host_random_state=None, sampler_clock=None,
                     kernel_states=None, numpy_random_state=None):
        """Append a segment of stored steps (every array leads with the
        ``nstored`` axis; ``inds`` may also be one step's masks, constant
        over the segment; ``blobs`` are stored where the storage was grown
        with them; ``accepted``, ``rj_accepted`` and
        ``swaps_accepted`` are per-step counts, summed into the cumulative
        counters), with the checkpoint as of the segment's last step: the
        generators' states, the adaptation clock and the kernel states in
        the form :meth:`get_kernel_states` returns."""
        log_like = np.asarray(log_like, dtype=self.dtype)
        n = log_like.shape[0]
        sl = slice(self.iteration, self.iteration + n)
        for name in self.branch_names:
            c = np.array(coords[name], dtype=self.dtype)
            m = np.asarray(inds[name], dtype=bool)
            c[~np.broadcast_to(m, c.shape[:-1])] = self.store_missing_leaves
            self.chain[name][sl] = c
            self.inds[name][sl] = m
        self.log_like[sl] = log_like
        self.log_prior[sl] = np.asarray(log_prior, dtype=self.dtype)
        self.betas[sl] = np.asarray(betas, dtype=self.dtype)
        if blobs is not None and self.blobs is not None:
            self.blobs[sl] = np.asarray(blobs)
        for field, value in (("accepted", accepted),
                             ("rj_accepted", rj_accepted),
                             ("swaps_accepted", swaps_accepted)):
            held = self._counter_get(field)
            if value is not None and held is not None:
                self._counter_set(field, held + np.asarray(
                    value, dtype=np.float64).sum(axis=0))
        if self.moves_accepted_fraction is not None and moves_accepted_fraction:
            for key, val in moves_accepted_fraction.items():
                self.moves_accepted_fraction[key] = np.asarray(val)
        if random_state is not None:
            self.random_state = random_state
        if host_random_state is not None:
            self.host_random_state = host_random_state
        if numpy_random_state is not None:
            self.numpy_random_state = numpy_random_state
        if sampler_clock is not None:
            self.save_sampler_clock(sampler_clock)
        if kernel_states is not None:
            self._kernel_state_leaves = kernel_states
        self.iteration += n

    def save_step(self, state, accepted, rj_accepted=None,
                  swaps_accepted=None, moves_accepted_fraction=None):
        """Append one stored step from a state: Eryn's per-step write, for
        a loop driven from the host (storage grown beforehand with
        :meth:`grow`).  ``accepted`` ``(ntemps, nwalkers)`` and the other
        counts are this step's; the state's tensors are copied to the
        host."""
        def host(x):
            if x is None:
                return None
            if hasattr(x, "detach"):
                x = x.detach().cpu().numpy()
            return np.asarray(x)[None]

        betas = (np.ones((1, self.ntemps)) if state.betas is None
                 else host(state.betas))
        self.save_segment(
            coords={n: host(state.branches[n].coords)
                    for n in self.branch_names},
            inds={n: host(state.branches[n].inds) for n in self.branch_names},
            log_like=host(state.log_like), log_prior=host(state.log_prior),
            betas=betas, blobs=host(state.blobs), accepted=host(accepted),
            rj_accepted=host(rj_accepted),
            swaps_accepted=host(swaps_accepted),
            moves_accepted_fraction=moves_accepted_fraction,
        )

    # ------------------------------------------------------------------
    # checkpoint: what a resumed run needs beyond the chain
    # ------------------------------------------------------------------
    def save_kernel_states(self, kernel_states, move_keys=None):
        """Store the moves' kernel states (one tree of tensors per move) as
        flat lists of host arrays, with the move keys they belong to."""
        self._kernel_state_leaves = (
            None if move_keys is None else list(move_keys),
            [host_leaves(tree_flatten(ks)[0]) for ks in kernel_states],
        )

    def get_kernel_states(self):
        """``(move_keys, per-move leaf lists)``, or None before any save.
        A None leaf could not be stored; the sampler keeps a fresh one
        there."""
        return self._kernel_state_leaves

    def save_sampler_clock(self, time):
        """Store ``TemperatureControl.time``, the ladder adaptation clock:
        a resume without it would restart the adaptation at its largest
        gain and leave the uninterrupted chain."""
        self._sampler_clock = int(time)

    def get_sampler_clock(self):
        """The stored clock, or None."""
        return self._sampler_clock

    @property
    def move_info(self):
        """``{move key: {"acceptance_fraction": array}}``, or None without
        tracked moves; under a mesh the whole ensemble's."""
        if self.moves_accepted_fraction is None:
            return None

        def whole(val):
            val = np.asarray(val)
            if self._shard is None:
                return val
            return self._shard.gather_numpy(val)

        return {
            key: {"acceptance_fraction": whole(val)}
            for key, val in self.moves_accepted_fraction.items()
        }

    def get_move_info(self):
        return self.move_info

    # ------------------------------------------------------------------
    # getters
    # ------------------------------------------------------------------
    def _check_stored(self):
        if not self.initialized or self.iteration <= 0:
            raise AttributeError(
                "You must run the sampler with 'store == True' before "
                "accessing the results."
            )

    def get_value(self, name, thin=1, discard=0, temp_index=None,
                  branch_names=None, slice_vals=None):
        if self._shard is None:
            return self._get_value(name, thin, discard, temp_index,
                                   branch_names, slice_vals)
        out = self._get_value(name, thin, discard, None, branch_names,
                              slice_vals)
        step = not isinstance(slice_vals, (int, np.integer))

        def whole(x):
            if name != "betas":  # the ladder is whole on every rank
                x = self._shard.gather_numpy(x, axis=int(step))
            if temp_index is None:
                return x
            return x[:, temp_index] if step else x[temp_index]

        if isinstance(out, dict):
            return {n: whole(x) for n, x in out.items()}
        return whole(out)

    def _get_value(self, name, thin=1, discard=0, temp_index=None,
                   branch_names=None, slice_vals=None):
        self._check_stored()
        if slice_vals is None:
            slice_vals = slice(discard + thin - 1, self.iteration, thin)
        keep = self._keep_branches(branch_names)
        scalar_step = isinstance(slice_vals, (int, np.integer))

        def read(arr):
            # resolve against the STORED range: buffers are preallocated
            out = arr[: self.iteration][slice_vals]
            if temp_index is None:
                return out
            return out[temp_index] if scalar_step else out[:, temp_index]

        if name == "chain":
            return {n: read(self.chain[n]) for n in keep}
        if name == "inds":
            return {n: read(self.inds[n]) for n in keep}
        if name in ("log_like", "log_prior", "betas"):
            return read(getattr(self, name))
        if name == "blobs":
            if self.blobs is None:
                raise AttributeError("No blobs stored.")
            return read(self.blobs)
        raise ValueError(f"Unknown value name: {name}")

    def _keep_branches(self, branch_names):
        if branch_names is None:
            return self.branch_names
        if isinstance(branch_names, str):
            return [branch_names]
        return list(branch_names)

    def get_chain(self, **kwargs):
        return self.get_value("chain", **kwargs)

    def get_inds(self, **kwargs):
        return self.get_value("inds", **kwargs)

    def get_nleaves(self, **kwargs):
        return {n: m.sum(axis=-1) for n, m in self.get_inds(**kwargs).items()}

    def get_log_like(self, **kwargs):
        return self.get_value("log_like", **kwargs)

    def get_log_prior(self, **kwargs):
        return self.get_value("log_prior", **kwargs)

    def get_blobs(self, **kwargs):
        """The stored blobs ``(nsteps, ntemps, nwalkers, ...)`` with the
        getter keywords of :meth:`get_value`, or None without blobs."""
        if not self.has_blobs():
            return None
        return self.get_value("blobs", **kwargs)

    def get_betas(self, **kwargs):
        return self.get_value("betas", **kwargs)

    def get_log_posterior(self, temper=False, **kwargs):
        logl = self.get_log_like(**kwargs)
        logp = self.get_log_prior(**kwargs)
        if temper:
            betas = self.get_betas(**kwargs)
            betas = betas.reshape(betas.shape + (1,) * (logl.ndim - betas.ndim))
            return betas * logl + logp
        return logl + logp

    def get_a_sample(self, it):
        """The :class:`~eryn_tpu_torch.state.State` stored at iteration
        ``it`` (host tensors)."""
        from ..state import State

        self._check_stored()
        it = int(it)
        if it < 0:
            it += self.iteration
        if not 0 <= it < self.iteration:
            raise IndexError(
                f"Sample index {it} out of range for {self.iteration} stored "
                "iterations."
            )
        sl = slice(it, it + 1)
        coords, inds = {}, {}
        for name in self.branch_names:
            c = self.get_chain(slice_vals=sl, branch_names=name)[name][0].copy()
            m = self.get_inds(slice_vals=sl, branch_names=name)[name][0]
            c[~m] = 0.0  # strip the NaN mask for live use
            coords[name], inds[name] = c, m
        blobs = self.get_blobs(slice_vals=sl)
        return State(
            coords, inds=inds,
            log_like=self.get_log_like(slice_vals=sl)[0],
            log_prior=self.get_log_prior(slice_vals=sl)[0],
            betas=self.get_betas(slice_vals=sl)[0],
            blobs=None if blobs is None else blobs[0],
            random_state=self.random_state,
        )

    def get_last_sample(self):
        return self.get_a_sample(self.iteration - 1)

    def get_autocorr_time(self, discard=0, thin=1, all_temps=False,
                          multiply_thin=True, **kwargs):
        """Per-parameter IACT per branch, ``{branch: (ntemps_kept,
        nleaves_max, ndim)}``, from the cold chain unless ``all_temps``."""
        from ..utils.utility import get_integrated_act

        if all_temps:
            x = self.get_chain(discard=discard, thin=thin)
        else:
            cold = self.get_chain(discard=discard, thin=thin, temp_index=0)
            x = {name: arr[:, None] for name, arr in cold.items()}
        out = get_integrated_act(x, **kwargs)
        factor = thin if multiply_thin else 1
        return {name: values * factor for name, values in out.items()}

    # ------------------------------------------------------------------
    # diagnostics
    # ------------------------------------------------------------------
    def get_autocorr_thin_burn(self, tau=None):
        """Suggested ``(discard, thin)`` from the per-parameter integrated
        autocorrelation times (``tau``, or :meth:`get_autocorr_time`'s):
        twice the largest tau, and half the smallest (at least 1)."""
        if tau is None:
            tau = self.get_autocorr_time()
        tau_max = max(np.nanmax(np.atleast_1d(v)) for v in tau.values())
        tau_min = min(np.nanmin(np.atleast_1d(v)) for v in tau.values())
        return int(2 * tau_max), max(int(0.5 * tau_min), 1)

    @staticmethod
    def _fixed_ladder(betas_all, discard, thin, iteration):
        """The one ladder of the stored steps ``betas_all``; the two
        errors of an evidence estimate otherwise."""
        if betas_all.shape[0] == 0:
            raise ValueError(
                f"discard={discard} / thin={thin} leave no stored samples "
                f"({iteration} iterations stored); cannot compute evidence."
            )
        if not (betas_all == betas_all[0]).all():
            raise ValueError(
                "Cannot compute evidence while betas are adapting. Use "
                "stop_adaptation or discard the adaptation phase."
            )
        return betas_all[0]

    def get_evidence_estimate(self, discard=0, thin=1, return_error=True,
                              method="therodynamic", **ss_kwargs):
        """Log evidence by thermodynamic integration (``method`` starting
        with ``"thermo"``, or ``"thero"``, Eryn's spelling and the default)
        or else stepping stone (``ss_kwargs``: ``block_len``, ``repeats``,
        ``seed``).  Raises a ``ValueError`` when no step is left or the
        ladder changed over the steps kept.  Returns ``(logZ, error)``, or
        ``logZ`` without ``return_error``."""
        from ..utils.utility import (
            stepping_stone_log_evidence,
            thermodynamic_integration_log_evidence,
        )

        logls_all = self.get_log_like(discard=discard, thin=thin)
        betas = self._fixed_ladder(self.get_betas(discard=discard, thin=thin),
                                   discard, thin, self.iteration)
        if method.startswith(("thero", "thermo")):
            logls = np.mean(logls_all, axis=(0, -1))
            logZ, dlogZ = thermodynamic_integration_log_evidence(betas, logls)
        else:
            logZ, dlogZ = stepping_stone_log_evidence(betas, logls_all,
                                                      **ss_kwargs)
        return (logZ, dlogZ) if return_error else logZ

    def _cold_columns(self, discard, thin):
        """Per branch, the cold chain's active values as ``(nsteps,
        nwalkers, ncols)`` (NaN where a leaf is dead), with only the
        columns that hold a value somewhere."""
        chain = self.get_chain(discard=discard, thin=thin, temp_index=0)
        inds = self.get_inds(discard=discard, thin=thin, temp_index=0)
        out = {}
        for name, arr in chain.items():
            nsteps, nwalkers, nleaves_max, ndim = arr.shape
            vals = np.where(inds[name][..., None], arr, np.nan).reshape(
                nsteps, nwalkers, nleaves_max * ndim)
            keep = ~np.all(np.isnan(vals), axis=(0, 1))
            out[name] = vals[:, :, keep]
        return out

    def get_gelman_rubin_convergence_diagnostic(self, discard=0, thin=1,
                                                doprint=True, **kwargs):
        """Gelman-Rubin R-hat per branch over the cold chain's active
        parameters (``kwargs`` to :func:`~eryn_tpu_torch.utils.utility.psrf`,
        e.g. ``per_walker``)."""
        from ..utils.utility import psrf

        out = {}
        for name, vals in self._cold_columns(discard, thin).items():
            out[name] = psrf(vals, vals.shape[-1], **kwargs)
            if doprint:
                print(f"Gelman-Rubin R-hat for {name}: {out[name]}")
        return out

    def _modern(self, fn, device_fn, label, discard, thin, doprint,
                return_parts):
        """``fn`` (the host estimator; ``device_fn`` is its device form, for
        a device-resident backend) per branch over the cold chain."""
        out = {}
        for name, vals in self._cold_columns(discard, thin).items():
            out[name] = fn(vals, vals.shape[-1], return_parts=return_parts)
            if doprint:
                value = out[name][0] if return_parts else out[name]
                print(f"{label} for {name}: {value}")
        return out

    def get_rank_normalized_rhat(self, discard=0, thin=1, doprint=False,
                                 return_parts=False):
        """Rank-normalised split R-hat per branch over the cold chain's
        active parameters (with ``return_parts``, ``(rhat, bulk, tail)``);
        converged below about 1.01."""
        from ..utils.utility import (
            rank_normalized_rhat,
            rank_normalized_rhat_torch,
        )

        return self._modern(rank_normalized_rhat, rank_normalized_rhat_torch,
                            "rank-normalized R-hat", discard, thin, doprint,
                            return_parts)

    def get_effective_sample_size(self, discard=0, thin=1, doprint=False,
                                  return_parts=False):
        """Bulk and tail effective sample size per branch over the cold
        chain's active parameters (with ``return_parts``, ``(ess, bulk,
        tail)``)."""
        from ..utils.utility import (
            effective_sample_size,
            effective_sample_size_torch,
        )

        return self._modern(effective_sample_size, effective_sample_size_torch,
                            "effective sample size", discard, thin, doprint,
                            return_parts)

    def get_info(self, discard=0, thin=1):
        """Everything stored, with the autocorrelation times and the
        ``(ac_burn, ac_thin)`` they suggest (``tau`` None and both 1 when
        they cannot be computed)."""
        out = {"samples": self.get_chain(discard=discard, thin=thin),
               **self.info}
        out["thin"] = thin
        out["burn"] = discard
        out["log_like"] = self.get_log_like(discard=discard, thin=thin)
        out["log_prior"] = self.get_log_prior(discard=discard, thin=thin)
        out["inds"] = self.get_inds(discard=discard, thin=thin)
        out["betas"] = self.get_betas(discard=discard, thin=thin)
        out["shapes"] = self.shape
        out["ntemps"] = self.ntemps
        out["nwalkers"] = self.nwalkers
        out["nbranches"] = self.nbranches
        out["branch names"] = self.branch_names
        out["ndims"] = self.ndims
        try:
            tau = self.get_autocorr_time()
            out["tau"] = tau
            out["ac_burn"], out["ac_thin"] = self.get_autocorr_thin_burn(tau)
        except Exception as e:  # noqa: BLE001 -- the info is still returned
            print("Failed to calculate the autocorrelation length. Will not "
                  f"output this piece of information. \n\n Actual error: "
                  f"[{e}]")
            out["tau"] = None
            out["ac_thin"] = out["ac_burn"] = 1
        out["ac_thin"] = max(out["ac_thin"], 1)
        return out
