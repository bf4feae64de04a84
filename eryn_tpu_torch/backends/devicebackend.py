"""Chain storage in device memory.

Port of :mod:`eryn_tpu.backends.devicebackend`.  Stored segments stay on the
device as the sampler's packed snapshot buffers and are unpacked on first
read; getters move only the slice they return to the host, and the
diagnostics (the IACT, thermodynamic-integration evidence, Gelman-Rubin,
rank-normalised R-hat and effective sample size) reduce the chain on the
device, so only per-rung or per-parameter results cross.  Cumulative counters are summed on the device and
fetched on first read.  When the stored chain outgrows ``max_device_bytes``
everything so far moves to host memory and sampling continues.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from .backend import Backend

__all__ = ["DeviceBackend"]


class _LazySeg:
    """One stored segment, kept packed until first read; the first read
    runs the sampler's ``unpack`` closure once and drops the packed
    buffers."""

    __slots__ = ("n", "_packed", "_unpack", "_data")

    def __init__(self, n, packed, unpack):
        self.n = int(n)
        self._packed = packed
        self._unpack = unpack
        self._data = None

    def nbytes(self):
        if self._data is None:
            arrays = self._packed.values()
        else:
            arrays = [
                *self._data["chain"].values(), *self._data["inds"].values(),
                self._data["log_like"], self._data["log_prior"],
                self._data["betas"], self._data.get("blobs"),
            ]
        return sum(a.numel() * a.element_size() for a in arrays
                   if a is not None)

    def __getitem__(self, key):
        if self._data is None:
            self._data = self._unpack(self._packed)
            self._packed = None
        return self._data[key]

    def __getstate__(self):
        # the unpacker is a closure of the sampler: a pickled segment is
        # unpacked first
        self["chain"]
        return (self.n, self._data)

    def __setstate__(self, state):
        self.n, self._data = state
        self._packed = self._unpack = None


class DeviceBackend(Backend):
    """In-memory backend whose chain stays on the device (see the module
    docstring)."""

    device_resident = True

    def __init__(self, store_missing_leaves=np.nan, dtype=None,
                 max_device_bytes=None):
        self._counter_host = {}
        self._counter_dev = {}
        super().__init__(store_missing_leaves=store_missing_leaves, dtype=dtype)
        self.max_device_bytes = max_device_bytes

    # -- cumulative counters, summed on the device, fetched on first read --
    def _counter_get(self, name):
        dev = self._counter_dev.get(name)
        if dev:
            folded = torch.stack(dev).sum(dim=0).cpu().numpy()
            host = self._counter_host.get(name)
            self._counter_host[name] = (
                folded.astype(self.dtype) if host is None else host + folded
            )
            self._counter_dev[name] = []
        return self._counter_host.get(name)

    def _counter_set(self, name, value):
        self._counter_host[name] = value
        self._counter_dev[name] = []

    def _reshard_store(self, conv):
        """Everything stored so far to host memory as the whole ensemble's
        (:meth:`offload` gathers a sharded chain); later segments land on
        the device in the new placement."""
        self.offload()

    def reset(self, *args, **kwargs):
        super().reset(*args, **kwargs)
        self.chain = self.inds = None
        self.log_like = self.log_prior = self.betas = None
        self._segs = []
        self._host = None  # offloaded prefix: dict of numpy arrays
        self._has_blobs = False

    def grow(self, ngrow, blobs=None):
        """Nothing to preallocate: segments arrive as device buffers (with
        their blobs, where the sampler stores some)."""

    def has_blobs(self):
        return self._has_blobs

    def save_segment_packed(self, n, packed, unpack, accepted_sum=None,
                            rj_accepted_sum=None, swaps_accepted_sum=None,
                            moves_accepted_fraction=None, random_state=None,
                            host_random_state=None, numpy_random_state=None):
        """Append a segment as the sampler's packed snapshot buffers.  No
        device work and no host transfer happen here: counter sums arrive
        pre-reduced, and ``unpack`` runs on first read.  The clock and the
        kernel states, device values, are saved at the end of a run."""
        if "blobs" in packed:
            if not self._has_blobs and self.iteration > 0:
                raise ValueError(
                    "DeviceBackend: blobs arrived after steps stored "
                    "without them; store the chain in a new backend.")
            self._has_blobs = True
        elif self._has_blobs:
            raise ValueError(
                "DeviceBackend: a segment without blobs after steps stored "
                "with them; store the chain in a new backend.")
        self._segs.append(_LazySeg(n, dict(packed), unpack))
        if accepted_sum is not None:
            self._counter_dev.setdefault("accepted", []).append(accepted_sum)
        if rj_accepted_sum is not None and self.rj:
            self._counter_dev.setdefault("rj_accepted", []).append(
                rj_accepted_sum
            )
        if swaps_accepted_sum is not None and self.ntemps > 1:
            self._counter_dev.setdefault("swaps_accepted", []).append(
                swaps_accepted_sum
            )
        if self.moves_accepted_fraction is not None and moves_accepted_fraction:
            self.moves_accepted_fraction.update(moves_accepted_fraction)
        if random_state is not None:
            self.random_state = random_state
        if host_random_state is not None:
            self.host_random_state = host_random_state
        if numpy_random_state is not None:
            self.numpy_random_state = numpy_random_state
        self.iteration += int(n)
        if (
            self.max_device_bytes is not None
            and self.device_bytes() > self.max_device_bytes
        ):
            self.offload()

    # ------------------------------------------------------------------
    # reads
    # ------------------------------------------------------------------
    def _seg_arrays(self, field, branch=None):
        """Per-segment device tensors of one field (static masks broadcast
        to the segment length); under a device mesh the global ones,
        gathered from every rank's shard."""
        parts = []
        for seg in self._segs:
            arr = seg[field][branch] if branch is not None else seg[field]
            if field == "inds" and arr.ndim == 3:
                arr = arr.expand((seg.n,) + tuple(arr.shape))
            if self._shard is not None and field != "betas":
                arr = self._shard.gather(arr, axis=1)
            parts.append(arr)
        return parts

    def _read(self, field, branch, slice_vals, temp_index):
        """Slice one field over the stored steps and move only the result
        to the host."""
        def temps(x):
            return x if temp_index is None else x[:, temp_index]

        idx = np.arange(self.iteration)[slice_vals]
        host = None
        if self._host is not None:
            host = self._host[field][branch] if branch else self._host[field]
        n_host = 0 if host is None else host.shape[0]
        # gather in ascending step order, segment by segment (the chain is
        # never concatenated on the device), then restore the requested order
        order = np.argsort(idx, kind="stable")
        sidx = idx[order]
        parts = []
        if host is not None:
            parts.append(temps(host[sidx[sidx < n_host]]))
        dev_idx = sidx[sidx >= n_host] - n_host
        off = 0
        for arr in self._seg_arrays(field, branch):
            n = arr.shape[0]
            sel = dev_idx[(dev_idx >= off) & (dev_idx < off + n)] - off
            off += n
            if sel.size or not parts:
                rows = arr[torch.as_tensor(sel, device=arr.device)]
                parts.append(temps(rows).cpu().numpy())
        out = np.concatenate(parts, axis=0) if len(parts) > 1 else parts[0]
        return out[np.argsort(order)]

    def get_value(self, name, thin=1, discard=0, temp_index=None,
                  branch_names=None, slice_vals=None):
        self._check_stored()
        if slice_vals is None:
            slice_vals = slice(discard + thin - 1, self.iteration, thin)
        drop = isinstance(slice_vals, (int, np.integer))
        if drop:
            iv = int(slice_vals) + (self.iteration if slice_vals < 0 else 0)
            if not 0 <= iv < self.iteration:
                raise IndexError(
                    f"Step {int(slice_vals)} out of range for "
                    f"{self.iteration} stored iterations."
                )
            slice_vals = slice(iv, iv + 1)

        def read(field, branch=None):
            out = self._read(field, branch, slice_vals, temp_index)
            return out[0] if drop else out

        if name in ("chain", "inds"):
            return {n: read(name, n) for n in self._keep_branches(branch_names)}
        if name in ("log_like", "log_prior", "betas"):
            return read(name)
        if name == "blobs":
            if not self._has_blobs:
                raise AttributeError("No blobs stored.")
            return read(name)
        raise ValueError(f"Unknown value name: {name}")

    def get_autocorr_time(self, discard=0, thin=1, all_temps=False,
                          multiply_thin=True, window=50, average=True, tol=0,
                          quiet=True):
        """Per-parameter IACT computed on the device: the chain never
        crosses to the host, only the taus do.  Takes the host path once
        part of the chain has been offloaded."""
        from ..utils.utility import _check_tol, get_integrated_act_torch

        if self._host is not None:
            return super().get_autocorr_time(
                discard=discard, thin=thin, all_temps=all_temps,
                multiply_thin=multiply_thin, window=window, average=average,
                tol=tol, quiet=quiet,
            )
        self._check_stored()
        sl = slice(discard + thin - 1, self.iteration, thin)
        factor = thin if multiply_thin else 1
        out = {}
        for name in self.branch_names:
            parts = self._seg_arrays("chain", name)
            chain = parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)
            chain = chain[sl]
            if not all_temps:
                chain = chain[:, 0:1]
            tau = get_integrated_act_torch(
                chain.double(), window=window, average=average
            )
            out[name] = tau.cpu().numpy() * factor
        nsteps = len(range(discard + thin - 1, self.iteration, thin))
        _check_tol(
            [np.nanmax(t) / factor for t in out.values()], nsteps, tol, quiet
        )
        return out

    def _device_field(self, field, branch, discard, thin):
        """One field over the kept steps, on the device."""
        parts = self._seg_arrays(field, branch)
        arr = parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)
        return arr[slice(discard + thin - 1, self.iteration, thin)]

    def get_evidence_estimate(self, discard=0, thin=1, return_error=True,
                              method="therodynamic", **ss_kwargs):
        """Thermodynamic integration with the mean log-likelihood per rung
        reduced on the device (float64): only ``(ntemps,)`` means and the
        ladders cross.  Stepping stone, whose bootstrap resamples the
        steps, and an offloaded chain take the host path."""
        if self._host is not None or not method.startswith(("thero",
                                                              "thermo")):
            return super().get_evidence_estimate(
                discard=discard, thin=thin, return_error=return_error,
                method=method, **ss_kwargs)
        from ..utils.utility import thermodynamic_integration_log_evidence

        self._check_stored()
        betas = self._fixed_ladder(
            self._device_field("betas", None, discard, thin).cpu().numpy(),
            discard, thin, self.iteration)
        ll = self._device_field("log_like", None, discard, thin)
        logls = ll.to(torch.float64).mean(dim=(0, 2)).cpu().numpy()
        logZ, dlogZ = thermodynamic_integration_log_evidence(betas, logls)
        return (logZ, dlogZ) if return_error else logZ

    def _cold_columns_device(self, name, discard, thin):
        """The cold chain's values of one branch as ``(nsteps, nwalkers,
        nleaves_max * ndim)`` on the device, NaN where a leaf is dead (the
        host getters' layout before their column selection)."""
        x = self._device_field("chain", name, discard, thin)[:, 0]
        m = self._device_field("inds", name, discard, thin)[:, 0]
        nsteps, nwalkers, nleaves_max, ndim = x.shape
        return torch.where(m[..., None], x.to(torch.float64),
                           torch.nan).reshape(nsteps, nwalkers, -1)

    def get_gelman_rubin_convergence_diagnostic(self, discard=0, thin=1,
                                                doprint=True, **kwargs):
        """Gelman-Rubin R-hat per branch, every walker a chain, with each
        walker's NaN-aware mean and variance reduced on the device: only
        ``(nwalkers, ncols)`` summaries cross.  The pooled form
        (``per_walker=False``) and an offloaded chain take the host
        path."""
        if self._host is not None or not kwargs.get("per_walker", True):
            return super().get_gelman_rubin_convergence_diagnostic(
                discard=discard, thin=thin, doprint=doprint, **kwargs)
        self._check_stored()
        out = {}
        for name in self.branch_names:
            vals = self._cold_columns_device(name, discard, thin)
            nsteps = vals.shape[0]
            finite = torch.isfinite(vals)
            cnt = finite.sum(dim=0)
            mean = torch.where(finite, vals, 0.0).sum(dim=0) / cnt.clamp(min=1)
            var = torch.where(finite, (vals - mean) ** 2, 0.0).sum(
                dim=0) / (cnt - 1).clamp(min=1)
            mean = torch.where(cnt > 0, mean, torch.nan).cpu().numpy()
            var = torch.where(cnt > 1, var, torch.nan).cpu().numpy()
            keep = cnt.sum(dim=0).cpu().numpy() > 0
            with np.errstate(invalid="ignore"), warnings.catch_warnings():
                # the aggregation of utils.utility.psrf(per_walker=True)
                warnings.simplefilter("ignore", RuntimeWarning)
                W = np.nanmean(var[:, keep], axis=0)
                B = nsteps * np.nanvar(mean[:, keep], axis=0, ddof=1)
                var_est = (1.0 - 1.0 / nsteps) * W + B / nsteps
                out[name] = np.sqrt(var_est / W)
            if doprint:
                print(f"Gelman-Rubin R-hat for {name}: {out[name]}")
        return out

    def _modern(self, fn, device_fn, label, discard, thin, doprint,
                return_parts):
        """The rank-normalised R-hat or the effective sample size by
        ``device_fn`` on the device: only the per-parameter results
        cross."""
        if self._host is not None:
            return super()._modern(fn, device_fn, label, discard, thin,
                                   doprint, return_parts)
        self._check_stored()
        out = {}
        for name in self.branch_names:
            vals = self._cold_columns_device(name, discard, thin)
            # the host getters' columns: those with a value somewhere
            keep = (~torch.isnan(vals).all(dim=1).all(dim=0)).cpu().numpy()
            res = device_fn(vals, return_parts=True)
            res = tuple(r.cpu().numpy()[keep] for r in res)
            out[name] = res if return_parts else res[0]
            if doprint:
                print(f"{label} for {name}: {res[0]}")
        return out

    # ------------------------------------------------------------------
    # memory
    # ------------------------------------------------------------------
    def device_bytes(self):
        """Device-memory footprint of the stored segments."""
        return sum(seg.nbytes() for seg in self._segs)

    def offload(self):
        """Move everything stored on the device to host memory; later
        segments keep landing on the device."""
        if not self._segs:
            return

        def pull(field, branch=None):
            new = np.concatenate(
                [a.cpu().numpy() for a in self._seg_arrays(field, branch)]
            )
            if self._host is None:
                return new
            old = self._host[field][branch] if branch else self._host[field]
            return np.concatenate([old, new])

        scalars = ("log_like", "log_prior", "betas") + (
            ("blobs",) if self._has_blobs else ())
        fields = {f: pull(f) for f in scalars}
        for f in ("chain", "inds"):
            fields[f] = {n: pull(f, n) for n in self.branch_names}
        self._host = fields
        self._segs = []
