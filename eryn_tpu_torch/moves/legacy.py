"""Eryn's host protocol: moves written against NumPy hooks.

Port of :mod:`eryn_tpu.moves.legacy`.  A user extends Eryn's proposals by
subclassing and writing host hooks on NumPy arrays:

* ``RedBlueMove``/``StretchMove`` subclasses write ``get_proposal(s_all,
  c_all, random, gibbs_ndim=None)``;
* ``MHMove`` subclasses (and the multiple-try moves' ``special_*`` hooks,
  driven by their stock ``get_proposal``) write ``get_proposal(
  branches_coords, random, branches_inds=None, ...)``;
* ``GroupMove``/``GroupStretchMove`` subclasses write ``setup_friends`` /
  ``find_friends`` / ``fix_friends``;
* reversible-jump subclasses write ``get_proposal(coords, inds,
  nleaves_min, nleaves_max, random)`` or ``get_model_change_proposal``.

Such a move is flagged ``host_move`` at construction, and
:func:`host_propose` runs its family's protocol here: on host copies of the
state, with ``model.random`` (the sampler's ``numpy.random.RandomState``)
and the sampler's likelihood and prior, which the
:class:`~eryn_tpu_torch.model.Model` returns as NumPy arrays.  The result
goes back to the state's device, where the control's
:meth:`~eryn_tpu_torch.moves.tempering.TemperatureControl.temper_comps`
runs the swap phase.  The sampler runs a host move eagerly in its slot of
the schedule, between the replays of the native moves' CUDA graphs.
"""

from __future__ import annotations

import numpy as np
import torch

from ..state import BranchSupplemental, State
from .tempering import _host as _np

__all__ = [
    "cleanup_proposals_gibbs",
    "fix_logp_gibbs",
    "gibbs_iterator",
    "groupstretch_get_proposal",
    "host_propose",
    "is_legacy_move",
    "setup_proposals",
    "stretch_get_proposal",
]


# ----------------------------------------------------------------------
# host views of the state
# ----------------------------------------------------------------------
class _HostSupp:
    """NumPy copy of a :class:`~eryn_tpu_torch.state.BranchSupplemental`
    with Eryn's indexing surface: hooks write into it in place, and
    :meth:`to_supp` makes a supplemental on the device again (numeric
    entries in their dtypes, object entries on the host)."""

    def __init__(self, holder, base_shape, dtypes=None):
        self.holder = holder
        self.base_shape = tuple(base_shape)
        self.dtypes = dtypes or {}

    @classmethod
    def of(cls, supp):
        holder = {k: np.array(_np(v)) for k, v in supp.holder.items()}
        holder.update({k: np.array(v) for k, v in supp.host_holder.items()})
        return cls(holder, supp.base_shape,
                   {k: v.dtype for k, v in supp.holder.items()})

    def __getitem__(self, key):
        if isinstance(key, str):
            return self.holder[key]
        return {name: value[key] for name, value in self.holder.items()}

    def __setitem__(self, key, value):
        if isinstance(key, str):
            self.holder[key] = np.asarray(value)
            return
        if not isinstance(value, dict):
            raise ValueError(
                "Setting with an index requires a dict of per-name values."
            )
        for name, val in value.items():
            self.holder[name][key] = val

    def __contains__(self, name):
        return name in self.holder

    @property
    def contained_objects(self):
        return list(self.holder)

    def take_along_axis(self, indices, axis, skip_names=()):
        return {
            name: np.take_along_axis(
                value,
                indices.reshape(indices.shape
                                + (1,) * (value.ndim - indices.ndim)),
                axis=axis,
            )
            for name, value in self.holder.items() if name not in skip_names
        }

    def copy(self):
        return _HostSupp({k: v.copy() for k, v in self.holder.items()},
                         self.base_shape, dict(self.dtypes))

    def to_supp(self, device):
        entries = {}
        for k, v in self.holder.items():
            if v.dtype == object:
                entries[k] = v
            else:
                entries[k] = torch.as_tensor(v, dtype=self.dtypes.get(k),
                                             device=device)
        return BranchSupplemental(entries, base_shape=self.base_shape)


class _HostBranch:
    """The branch a hook receives: NumPy ``coords`` and ``inds`` (hooks
    write into them) and the ``branch_supplemental``."""

    def __init__(self, coords, inds, branch_supplemental=None):
        self.coords = coords
        self.inds = inds
        self.branch_supplemental = branch_supplemental

    @property
    def supplemental(self):
        return self.branch_supplemental

    @property
    def shape(self):
        return self.coords.shape

    @property
    def nleaves(self):
        return self.inds.sum(axis=-1)



def is_legacy_move(move):
    """Whether ``move`` runs Eryn's host protocol (:attr:`~eryn_tpu_torch.
    moves.Move.host_move`)."""
    return bool(getattr(move, "host_move", False))

def _host_snapshot(state):
    """A mutable host copy of ``state``; ``like`` keeps the state for the
    way back (its device and dtypes)."""
    def opt(x):
        return None if x is None else np.array(_np(x))

    def supp(s):
        return None if s is None or not (s.holder or s.host_holder) \
            else _HostSupp.of(s)

    return {
        "coords": {n: np.array(_np(c))
                   for n, c in state.branches_coords.items()},
        "inds": {n: np.array(_np(v)) for n, v in state.branches_inds.items()},
        "log_like": np.array(_np(state.log_like)),
        "log_prior": np.array(_np(state.log_prior)),
        "blobs": opt(state.blobs),
        "betas": opt(state.betas),
        "supp": supp(state.supplemental),
        "branch_supps": {n: supp(s)
                         for n, s in state.branches_supplemental.items()},
        "like": state,
    }


def _branches_view(hs):
    return {
        name: _HostBranch(hs["coords"][name], hs["inds"][name],
                          branch_supplemental=hs["branch_supps"].get(name))
        for name in hs["coords"]
    }


def _host_to_state(hs):
    """The host copy ``hs`` as a state on the device, in the dtypes, of the
    state it was taken from."""
    like = hs["like"]
    device = like.log_like.device

    def put(x, ref):
        if x is None or ref is None:
            return ref
        return torch.as_tensor(x, dtype=ref.dtype, device=device)

    branch_supps = {}
    for name, branch in like.branches.items():
        bs = hs["branch_supps"].get(name)
        branch_supps[name] = (branch.branch_supplemental if bs is None
                              else bs.to_supp(device))
    return State(
        {n: put(hs["coords"][n], b.coords) for n, b in like.branches.items()},
        inds={n: torch.as_tensor(hs["inds"][n], dtype=torch.bool,
                                 device=device) for n in like.branches},
        log_like=put(hs["log_like"], like.log_like),
        log_prior=put(hs["log_prior"], like.log_prior),
        blobs=put(hs["blobs"], like.blobs),
        betas=put(hs["betas"], like.betas),
        supplemental=(like.supplemental if hs["supp"] is None
                      else hs["supp"].to_supp(device)),
        branch_supplemental=branch_supps,
    )


def _host_state(state):
    """``state`` with its tensors on the host (hooks read it with
    ``np.asarray``)."""
    if state.log_like.device.type == "cpu":
        return state
    return state.map_tensors(lambda x: x.cpu())


# ----------------------------------------------------------------------
# the protocol's shared steps
# ----------------------------------------------------------------------
def gibbs_iterator(move, all_branch_names):
    """``(branch_names_run, inds_run)`` per Gibbs split of ``move``, the
    masks NumPy arrays or None."""
    for split in getattr(move, "gibbs_iterations", None) or [None]:
        if split is None:
            yield list(all_branch_names), [None] * len(all_branch_names)
        else:
            kept = [(n, m) for n, m in split if n in all_branch_names]
            yield ([n for n, _ in kept],
                   [None if m is None else _np(m) for _, m in kept])


def _split_inds(ir, inds):
    """The leaves of ``inds`` that the split mask ``ir`` proposes on."""
    tmp = np.zeros_like(inds, dtype=bool)
    tmp[:, :, ir.astype(int).sum(axis=-1).astype(bool)] = True
    tmp[~inds] = False
    return tmp


def setup_proposals(branch_names_run, inds_run, coords, inds):
    """Gibbs-aware proposal inputs: ``(coords, inds, at_least_one)``."""
    inds_go, coords_go = {}, {}
    at_least_one = False
    for bnr, ir in zip(branch_names_run, inds_run):
        inds_go[bnr] = inds[bnr] if ir is None else _split_inds(ir, inds[bnr])
        at_least_one = at_least_one or bool(np.any(inds_go[bnr]))
        coords_go[bnr] = coords[bnr]
    return coords_go, inds_go, at_least_one


def cleanup_proposals_gibbs(branch_names_run, inds_run, q, coords):
    """Restore the parameters this split holds fixed, and fill in the
    branches not proposed, in ``q``."""
    for bnr, ir in zip(branch_names_run, inds_run):
        if ir is not None:
            q[bnr][:, :, ~ir] = _np(coords[bnr])[:, :, ~ir]
    for key, value in coords.items():
        if key not in q:
            q[key] = np.array(_np(value))


def fix_logp_gibbs(branch_names_run, inds_run, logp, inds):
    """In place: a walker without a leaf in this split but with leaves
    elsewhere gets ``-inf``; one without leaves anywhere 0."""
    total = np.zeros_like(logp, dtype=int)
    total_here = np.zeros_like(logp, dtype=int)
    for bnr, ir in zip(branch_names_run, inds_run):
        inds_b = _np(inds[bnr])
        tmp = inds_b if ir is None else _split_inds(ir, inds_b)
        total += tmp.sum(axis=-1)
        total_here += tmp.sum(axis=-1)
    for name, iv in inds.items():
        if name not in branch_names_run:
            total += _np(iv).sum(axis=-1)
    logp[(total != 0) & (total_here == 0)] = -np.inf
    logp[(total == 0) & (total_here == 0)] = 0.0


def _log_posterior(move, logl, logp, betas):
    """The tempered posterior over the state's ladder ``betas``
    (untempered without a control)."""
    tc = move.temperature_control
    if tc is None:
        return np.asarray(logl) + np.asarray(logp)
    return tc.compute_log_posterior_tempered(np.asarray(logl),
                                             np.asarray(logp), betas=betas)


def _merge_accept(hs, q, logl, logp, blobs, accepted, subset=None,
                  new_inds=None):
    """Accepted walkers of the proposal into the host state.  ``subset``
    is the ``(ntemps, Ns)`` walker index of a red/blue half that ``q`` and
    ``logl`` cover; ``accepted`` is always ``(ntemps, nwalkers)``;
    ``new_inds`` carries the leaf flips of a reversible-jump proposal."""
    if subset is None:
        acc = accepted
        for n in hs["coords"]:
            hs["coords"][n][acc] = np.asarray(q[n])[acc]
            if new_inds is not None and n in new_inds:
                hs["inds"][n][acc] = np.asarray(new_inds[n])[acc]
        hs["log_like"][acc] = np.asarray(logl)[acc]
        hs["log_prior"][acc] = np.asarray(logp)[acc]
        if blobs is not None and hs["blobs"] is not None:
            hs["blobs"][acc] = np.asarray(blobs)[acc]
        return
    keep = np.take_along_axis(accepted, subset, axis=1)
    t_idx, s_idx = np.nonzero(keep)
    w_idx = subset[t_idx, s_idx]
    for n in hs["coords"]:
        hs["coords"][n][t_idx, w_idx] = np.asarray(q[n])[t_idx, s_idx]
    hs["log_like"][t_idx, w_idx] = np.asarray(logl)[t_idx, s_idx]
    hs["log_prior"][t_idx, w_idx] = np.asarray(logp)[t_idx, s_idx]
    if blobs is not None and hs["blobs"] is not None:
        hs["blobs"][t_idx, w_idx] = np.asarray(blobs)[t_idx, s_idx]


def _log_prior(model, q, inds):
    """The log prior of ``q`` as a float64 host array."""
    return np.array(_np(model.compute_log_prior_fn(q, inds=inds)),
                    dtype=np.float64)


def _evaluate(model, q, inds, logp):
    """``(log_like, blobs)`` of ``q`` as host arrays."""
    logl, blobs = model.compute_log_like_fn(q, inds=inds, logp=logp)
    return (np.array(_np(logl), dtype=np.float64),
            None if blobs is None else _np(blobs))


def _gibbs_ndim(branch_names_run, inds_run, coords):
    total = 0
    for bnr, ir in zip(branch_names_run, inds_run):
        total += (ir.sum() if ir is not None
                  else int(np.prod(coords[bnr].shape[-2:])))
    return total


def _finish(move, model, hs, accepted):
    """The tail of every family: the host copy back on the device, the
    move's counters, and the swap phase (with ladder adaptation unless the
    move is reversible jump) through the control's ``temper_comps``."""
    state = _host_to_state(hs)
    move.accepted = (accepted.astype(float) if move.accepted is None
                     else np.asarray(move.accepted) + accepted)
    move.num_proposals += 1
    tc = model.temperature_control
    if (tc is not None and not move.prevent_swaps
            and state.log_like.shape[0] > 1):
        state = tc.temper_comps(state, adapt=move.adapt_temps,
                                generator=model.generator)
    return state, accepted


# ----------------------------------------------------------------------
# the families
# ----------------------------------------------------------------------
def _propose_mh(move, model, state):
    """The whole-ensemble family (``MHMove``, the multiple-try moves)."""
    hs = _host_snapshot(state)
    names = list(hs["coords"])
    ntemps, nwalkers = hs["log_like"].shape
    accepted = np.zeros((ntemps, nwalkers), dtype=bool)
    move.setup(hs["coords"])

    for branch_names_run, inds_run in gibbs_iterator(move, names):
        coords_go, inds_go, any_prop = setup_proposals(
            branch_names_run, inds_run, hs["coords"], hs["inds"])
        if not any_prop:
            continue
        move.current_model = model
        move.current_state = _host_state(state)
        q, factors = move.get_proposal(
            coords_go, model.random, branches_inds=inds_go,
            supps=hs["supp"], branch_supps=hs["branch_supps"])
        q = {n: np.array(_np(v)) for n, v in q.items()}
        cleanup_proposals_gibbs(branch_names_run, inds_run, q, hs["coords"])
        q = {n: q[n] for n in names}

        mt_ll = move.__dict__.pop("mt_ll", None)
        mt_lp = move.__dict__.pop("mt_lp", None)
        if mt_ll is not None and mt_lp is not None:
            # a multiple-try move evaluated the chosen points already
            logl, logp, new_blobs = np.array(mt_ll), np.array(mt_lp), None
        else:
            logp = _log_prior(model, q, inds=hs["inds"])
            fix_logp_gibbs(branch_names_run, inds_run, logp, hs["inds"])
            logl, new_blobs = _evaluate(model, q, hs["inds"], logp)
        logP = _log_posterior(move, logl, logp, hs["betas"])
        prev_logP = _log_posterior(move, hs["log_like"], hs["log_prior"],
                                   hs["betas"])
        lnpdiff = np.asarray(factors) + logP - prev_logP
        acc = lnpdiff > np.log(model.random.rand(ntemps, nwalkers))
        _merge_accept(hs, q, logl, logp, new_blobs, acc)
        accepted |= acc

    return _finish(move, model, hs, accepted)


def _propose_redblue(move, model, state):
    """The red/blue family: each split proposed from the others."""
    hs = _host_snapshot(state)
    names = list(hs["coords"])
    ntemps, nwalkers = hs["log_like"].shape
    ndim_total = sum(int(np.prod(hs["coords"][n].shape[-2:])) for n in names)
    if nwalkers < 2 * ndim_total and not move.live_dangerously:
        raise RuntimeError(
            "It is unadvisable to use a red-blue move with fewer walkers "
            "than twice the number of dimensions. Set live_dangerously=True "
            "to override."
        )
    move.setup(_branches_view(hs))

    accepted = np.zeros((ntemps, nwalkers), dtype=bool)
    all_inds = np.tile(np.arange(nwalkers), (ntemps, 1))
    split_ids = all_inds % move.nsplits
    if move.randomize_split:
        for row in split_ids:
            model.random.shuffle(row)

    for branch_names_run, inds_run in gibbs_iterator(move, names):
        coords_go, inds_go, any_prop = setup_proposals(
            branch_names_run, inds_run, hs["coords"], hs["inds"])
        if not any_prop:
            continue
        accepted_here = np.zeros((ntemps, nwalkers), dtype=bool)
        for split in range(move.nsplits):
            S1 = split_ids == split
            nw_here = int(S1[0].sum())
            subset = all_inds[S1].reshape(ntemps, nw_here)

            new_inds = {
                n: np.take_along_axis(hs["inds"][n], subset[:, :, None], 1)
                for n in names}
            real_inds_subset = {
                n: np.take_along_axis(inds_go[n], subset[:, :, None], 1)
                for n in branch_names_run}
            subset_coords = {
                n: np.take_along_axis(hs["coords"][n],
                                      subset[:, :, None, None], 1)
                for n in names}
            sets = {
                n: [np.take_along_axis(
                    hs["coords"][n],
                    all_inds[split_ids == j].reshape(ntemps, -1)[
                        :, :, None, None], axis=1)
                    for j in range(move.nsplits)]
                for n in branch_names_run}
            s = {n: sets[n][split] for n in sets}
            c = {n: sets[n][:split] + sets[n][split + 1:] for n in sets}

            move.current_model = model
            move.current_state = _host_state(state)
            q, factors = move.get_proposal(
                s, c, model.random,
                gibbs_ndim=_gibbs_ndim(branch_names_run, inds_run,
                                       hs["coords"]))
            q = {n: np.array(_np(v)) for n, v in q.items()}
            cleanup_proposals_gibbs(branch_names_run, inds_run, q,
                                    subset_coords)
            for n in names:
                if n not in q:
                    q[n] = subset_coords[n].copy()
            q = {n: q[n] for n in names}

            logp = _log_prior(model, q, inds=new_inds)
            fix_logp_gibbs(branch_names_run, inds_run, logp, real_inds_subset)
            logl, new_blobs = _evaluate(model, q, new_inds, logp)
            logl[np.isnan(logl)] = -1e300

            betas = hs["betas"]
            logP = _log_posterior(move, logl, logp, betas)
            prev_logP = _log_posterior(
                move, np.take_along_axis(hs["log_like"], subset, axis=1),
                np.take_along_axis(hs["log_prior"], subset, axis=1), betas)
            lnpdiff = np.asarray(factors) + logP - prev_logP
            keep = lnpdiff > np.log(model.random.rand(ntemps, nw_here))

            np.put_along_axis(accepted_here, subset, keep, axis=1)
            accepted |= accepted_here
            _merge_accept(hs, q, logl, logp, new_blobs, accepted_here,
                          subset=subset)

    return _finish(move, model, hs, accepted)


def _propose_group(move, model, state):
    """The group family: a stationary friends group, set up anew every
    ``n_iter_update`` proposals from the ensemble before the proposal, and
    repaired by ``fix_friends`` between."""
    hs = _host_snapshot(state)
    names = list(hs["coords"])
    ntemps, nwalkers = hs["log_like"].shape
    if move.nfriends is None:
        move.nfriends = nwalkers

    branches = _branches_view(hs)
    move.setup(branches)
    it = getattr(move, "iter", 0)
    if it == 0 or it % move.n_iter_update == 0:
        move.setup_friends(branches)
    old_branches = None
    if it != 0 and it % move.n_iter_update == 0:
        old_branches = {
            n: _HostBranch(
                b.coords.copy(), b.inds.copy(),
                branch_supplemental=(None if b.branch_supplemental is None
                                     else b.branch_supplemental.copy()))
            for n, b in branches.items()}
    if it != 0 and it % move.n_iter_update != 0:
        move.fix_friends(branches)

    accepted = np.zeros((ntemps, nwalkers), dtype=bool)
    for branch_names_run, inds_run in gibbs_iterator(move, names):
        coords_go, inds_go, any_prop = setup_proposals(
            branch_names_run, inds_run, hs["coords"], hs["inds"])
        if not any_prop:
            continue
        new_branch_supps = {n: None if bs is None else bs.copy()
                            for n, bs in hs["branch_supps"].items()}
        move.current_model = model
        move.current_state = _host_state(state)
        q, factors = move.get_proposal(
            {n: coords_go[n] for n in branch_names_run}, model.random,
            gibbs_ndim=_gibbs_ndim(branch_names_run, inds_run, hs["coords"]),
            s_inds_all={n: inds_go[n] for n in branch_names_run},
            branch_supps=new_branch_supps)
        q = {n: np.array(_np(v)) for n, v in q.items()}
        cleanup_proposals_gibbs(branch_names_run, inds_run, q, hs["coords"])
        q = {n: q[n] for n in names}

        logp = _log_prior(model, q, inds=hs["inds"])
        fix_logp_gibbs(branch_names_run, inds_run, logp, hs["inds"])
        logl, new_blobs = _evaluate(model, q, hs["inds"], logp)
        logP = _log_posterior(move, logl, logp, hs["betas"])
        prev_logP = _log_posterior(move, hs["log_like"], hs["log_prior"],
                                   hs["betas"])
        lnpdiff = np.asarray(factors) + logP - prev_logP
        acc = lnpdiff > np.log(model.random.rand(ntemps, nwalkers))
        _merge_accept(hs, q, logl, logp, new_blobs, acc)
        # accepted supplemental values follow their walkers
        for n, bs in new_branch_supps.items():
            old_bs = hs["branch_supps"].get(n)
            if bs is None or old_bs is None:
                continue
            for k in bs.holder:
                old_bs.holder[k][acc] = bs.holder[k][acc]
        accepted |= acc

    state_out, accepted = _finish(move, model, hs, accepted)
    if old_branches is not None:
        # the window's bookkeeping is the ensemble before the proposal
        move.setup_friends(old_branches)
    move.iter = it + 1
    return state_out, accepted


def _propose_rj(move, model, state):
    """The reversible-jump family: ``get_proposal -> (q, new_inds,
    factors)`` per branch split, the edge factors of the leaf-count range,
    the multiple-try hand-off, and the swap phase without adaptation."""
    hs = _host_snapshot(state)
    names = list(hs["coords"])
    ntemps, nwalkers = hs["log_like"].shape
    accepted = np.zeros((ntemps, nwalkers), dtype=bool)
    move.setup(_branches_view(hs))

    for branch_names_run, inds_run in gibbs_iterator(move, names):
        run = [n for n in branch_names_run if n in move.nleaves_max]
        if not run:
            raise ValueError(
                "No models are getting a reversible jump proposal. Check "
                "nleaves_min and nleaves_max or do not use an rj proposal."
            )
        nlmax = {k: move.nleaves_max[k] for k in run}
        nlmin = {k: move.nleaves_min.get(k, 0) for k in run}
        move.current_model = model
        move.current_state = _host_state(state)
        q, new_inds, factors = move.get_proposal(
            {k: hs["coords"][k] for k in run},
            {k: hs["inds"][k] for k in run}, nlmin, nlmax, model.random,
            branch_supps=hs["branch_supps"], supps=hs["supp"])
        q = {n: np.array(_np(v)) for n, v in q.items()}
        new_inds = {n: np.array(_np(v), dtype=bool)
                    for n, v in new_inds.items()}
        cleanup_proposals_gibbs(branch_names_run, inds_run, q, hs["coords"])
        for n in names:
            if n not in q:
                q[n] = np.array(hs["coords"][n])
            if n not in new_inds:
                new_inds[n] = np.array(hs["inds"][n])
        q = {n: q[n] for n in names}
        new_inds = {n: new_inds[n] for n in names}

        edge = np.zeros((ntemps, nwalkers))
        log_half = np.log(0.5)
        for n in run:
            nmax, nmin = nlmax[n], nlmin[n]
            if nmin > nmax:
                raise ValueError(
                    "nleaves_min cannot be greater than nleaves_max.")
            if nmin == nmax or nmin + 1 == nmax:
                continue
            old_n = hs["inds"][n].sum(axis=-1)
            new_n = new_inds[n].sum(axis=-1)
            edge += np.where(old_n == nmin, log_half, 0.0)
            edge += np.where(old_n == nmax, log_half, 0.0)
            edge -= np.where(new_n == nmin, log_half, 0.0)
            edge -= np.where(new_n == nmax, log_half, 0.0)
        factors = np.asarray(_np(factors), dtype=float) + edge

        # a multiple-try move's readouts replace the evaluation
        mt_lp = move.__dict__.pop("mt_lp", None)
        mt_ll = move.__dict__.pop("mt_ll", None)
        if mt_lp is not None:
            logp = np.array(mt_lp, dtype=float).reshape(ntemps, nwalkers)
        else:
            logp = _log_prior(model, q, inds=new_inds)
        fix_logp_gibbs(branch_names_run, inds_run, logp, new_inds)
        if mt_ll is not None:
            logl = np.array(mt_ll, dtype=float).reshape(ntemps, nwalkers)
            new_blobs = None
        else:
            logl, new_blobs = _evaluate(model, q, new_inds, logp)

        logP = _log_posterior(move, logl, logp, hs["betas"])
        prev_logP = _log_posterior(move, hs["log_like"], hs["log_prior"],
                                   hs["betas"])
        lnpdiff = factors + logP - prev_logP
        acc = lnpdiff > np.log(model.random.rand(ntemps, nwalkers))
        _merge_accept(hs, q, logl, logp, new_blobs, acc, new_inds=new_inds)
        accepted |= acc

    return _finish(move, model, hs, accepted)


def _propose_custom(move, model, state):
    """A move with a ``propose`` of its own: it runs on a host copy of the
    state (NumPy reads it), and its result goes back to the device in the
    dtypes of ``state``."""
    new_state, accepted = move.propose(model, _host_state(state))
    hs = _host_snapshot(new_state)
    hs["like"] = state
    return _host_to_state(hs), _np(accepted).astype(bool)


_FAMILIES = {
    "mh": _propose_mh,
    "redblue": _propose_redblue,
    "group": _propose_group,
    "rj": _propose_rj,
    "custom-propose": _propose_custom,
}


def host_propose(move, model, state):
    """One proposal of a host move by its family's protocol; returns
    ``(state on the device, accepted NumPy bool flags)``."""
    family = getattr(move, "_legacy_family", None)
    if family not in _FAMILIES:
        raise RuntimeError(
            f"Move {type(move).__name__} is flagged host_move but has no "
            f"recognized host protocol family ({family!r})."
        )
    return _FAMILIES[family](move, model, state)


# ----------------------------------------------------------------------
# the stock proposals of the host protocol
# ----------------------------------------------------------------------
def host_rvs(dist, random, size):
    """``size`` draws of a container ``dist`` as a float64 host array,
    from a CPU generator seeded by one draw of the host ``random``."""
    gen = torch.Generator().manual_seed(int(random.randint(0, 2**31 - 1)))
    return _np(dist.rvs(size=size, generator=gen, dtype=torch.float64))


def host_logpdf(dist, x):
    """``dist.logpdf`` of host points, as a float64 host array."""
    return _np(dist.logpdf(torch.as_tensor(np.asarray(x, dtype=np.float64))))


def _periodic_np(periodic, fn, name, *arrays):
    """``periodic.distance`` or ``.wrap`` of host arrays, as a host array
    (the container works on tensors)."""
    shape = arrays[0].shape
    flat = [{name: torch.from_numpy(np.ascontiguousarray(
        a.reshape((-1,) + shape[-2:])))} for a in arrays]
    return _np(getattr(periodic, fn)(*flat)[name]).reshape(shape)


def stretch_get_proposal(move, s_all, c_all, random, gibbs_ndim=None):
    """The stretch proposal of a red/blue split: each walker's complement
    drawn uniformly from the other splits, one ``z`` per walker shared by
    the branches.  Returns ``(q, factors)``."""
    newpos = {}
    zz = None
    ndim = 0
    for i, name in enumerate(s_all):
        s = np.asarray(s_all[name])
        c = np.concatenate([np.asarray(x) for x in c_all[name]], axis=1)
        ntemps, Ns, nleaves_max, ndim_here = s.shape
        ndim += nleaves_max * ndim_here
        rint = random.randint(c.shape[1], size=(ntemps, Ns))
        c_temp = np.take_along_axis(c, rint[:, :, None, None], axis=1)
        if i == 0:
            u = random.rand(ntemps, Ns)
            if getattr(move, "use_log_proposal", False):
                zz = np.exp((2.0 * u - 1.0) * np.log(move.a))
            else:
                zz = ((move.a - 1.0) * u + 1.0) ** 2.0 / move.a
        diff = (c_temp - s if move.periodic is None
                else _periodic_np(move.periodic, "distance", name, s, c_temp))
        temp = c_temp - diff * zz[:, :, None, None]
        if move.periodic is not None:
            temp = _periodic_np(move.periodic, "wrap", name, temp)
        newpos[name] = temp

    # the density 1/z (log proposal) has exponent N, Goodman-Weare's N - 1;
    # under Gibbs N counts the updated dimensions
    shift = 0.0 if getattr(move, "use_log_proposal", False) else 1.0
    n_eff = ndim if gibbs_ndim is None else np.asarray(gibbs_ndim)
    return newpos, (n_eff - shift) * np.log(zz)


def groupstretch_get_proposal(move, s_all, random, gibbs_ndim=None,
                              s_inds_all=None, branch_supps=None):
    """The stretch proposal against the complement the move's
    ``find_friends`` picks.  Returns ``(q, factors)``."""
    newpos = {}
    zz = None
    ndim = 0
    for i, name in enumerate(s_all):
        s = np.asarray(s_all[name])
        ntemps, nwalkers, nleaves_max, ndim_here = s.shape
        ndim += nleaves_max * ndim_here
        s_inds = None if s_inds_all is None else np.asarray(s_inds_all[name])
        c = np.asarray(move.find_friends(name, s, s_inds=s_inds,
                                         branch_supps=branch_supps))
        if i == 0:
            zz = ((move.a - 1.0) * random.rand(ntemps, nwalkers) + 1.0) \
                ** 2.0 / move.a
        diff = (c - s if move.periodic is None
                else _periodic_np(move.periodic, "distance", name, s, c))
        temp = c - diff * zz[:, :, None, None]
        if move.periodic is not None:
            temp = _periodic_np(move.periodic, "wrap", name, temp)
        newpos[name] = temp

    factors = (ndim - 1.0) * np.log(zz)
    if gibbs_ndim is not None:
        # the factors of the updated dimensions only
        factors = factors / (ndim - 1.0) * (np.asarray(gibbs_ndim) - 1.0)
    return newpos, factors
