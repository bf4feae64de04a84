"""Runtime diagnostic plotting.

Port of :mod:`eryn_tpu.utils.plot`: corner, trace, log-likelihood,
temperature-ladder and swap diagnostics, leaf-count histograms and their
evolution, and the evolution of the acceptance fraction and of the
autocorrelation time, in the producer families ``produce_base_plots``,
``produce_tempering_plots``, ``produce_rj_plots`` and
``produce_advanced_plots``, driven from a backend by
:meth:`PlotContainer.produce_plots` (``EnsembleSampler(plot_iterations=...)``
calls it every so many stored iterations).  Everything here works on host
NumPy arrays: the backends' getters return them, and the counters a
:class:`~eryn_tpu_torch.DeviceBackend` keeps on the device are copied once
per read.  matplotlib is imported at the first plot, not with the module,
so the package runs where matplotlib is absent.
"""

from __future__ import annotations

import os

import numpy as np

from .utility import _host

__all__ = [
    "PlotContainer",
    "save_or_show",
    "cov_ellipse",
    "overlay_fim_covariance",
    "cornerplot",
    "traceplot",
    "plot_loglikelihood",
    "tempering_ridgeplot",
    "plot_swap_acceptance",
    "plot_logl_betas",
    "plot_betas_evolution",
    "plot_leaves",
    "plot_leaves_evolution",
    "plot_acceptance_fraction",
    "plot_tempered_acceptance_fraction",
    "plot_act_evolution",
    "produce_base_plots",
    "produce_tempering_plots",
    "produce_advanced_plots",
    "produce_rj_plots",
]


def _get_plt():
    import matplotlib

    # never replace an interactive matplotlib backend: only force Agg when
    # matplotlib has not yet materialized one
    if "matplotlib.pyplot" not in __import__("sys").modules:
        matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def _flat_cold_chain(backend, name, burn=0, thin=1):
    """(nsamples, ndim) active-leaf samples from the cold chain."""
    chain = backend.get_chain(discard=burn, thin=thin)[name]
    inds = backend.get_inds(discard=burn, thin=thin)[name]
    x = chain[:, 0]
    m = inds[:, 0]
    return x[m]


class PlotContainer:
    """Diagnostic plots drawn from a backend (Eryn's ``plot.py:1208-1392``).

    Args:
        fp: file prefix for saved figures.
        backend: backend to read chains from (any of the port's three).
        plot_dir: directory for output files (Eryn's ``parent_folder``).
        thin_chain_by_ac: thin by the autocorrelation estimate before
            plotting.
        which_plots: the groups ``produce_plots`` draws, of ``"base"``,
            ``"tempering"``, ``"rj"``, ``"advanced"`` and ``"all"``, or one
            of them as a string (Eryn's ``plots``).
    """

    def __init__(
        self,
        fp="output",
        backend=None,
        plot_dir=".",
        thin_chain_by_ac=False,
        corner_kwargs=None,
        parameter_transforms=None,
        info_keys=None,
        which_plots=("base",),
        plots=None,
        parent_folder=None,
        branches=None,
        truths=None,
        overlay_covariance=None,
        tempering_palette=None,
        discard=0,
        stop=int(1e4),
    ):
        self.fp = fp
        self.backend = backend
        # Eryn's spellings of two keywords (plot.py:1223-1233)
        self.plot_dir = parent_folder if parent_folder is not None else plot_dir
        self.thin_chain_by_ac = thin_chain_by_ac
        self.corner_kwargs = corner_kwargs or {}
        self.parameter_transforms = parameter_transforms
        #: {branch: [labels]} parameter names used on axes; falls back to the
        #: backend's persisted prior key_order (Eryn's plot.py:1306)
        self.info_keys = info_keys
        self.which_plots = plots if plots is not None else which_plots
        #: restrict plotting to these branches (None = all)
        self.branches = branches
        #: {branch: (ndim,) true values} drawn as lines on the corner plots
        self.truths = truths
        #: {branch: (ndim, ndim) covariance} 1-sigma Gaussian overlay on the
        #: corner diagonals (Eryn's cornerplot overlay, plot.py:232-241)
        self.overlay_covariance = overlay_covariance
        #: palette for the temperature-colored plots (Eryn's plot.py:1229);
        #: unknown names (e.g. seaborn's "icefire") fall back gracefully
        self.tempering_palette = tempering_palette
        #: default burn for produce_plots: absolute if >= 1, else a fraction
        #: of the stored iteration count (Eryn's plot.py:1304-1305)
        self.discard = discard
        #: produce_plots becomes a no-op past this many stored steps
        #: (Eryn's plot.py:1300-1301)
        self.stop = stop
        # acceptance-evolution history accumulated across produce_plots
        # calls (Eryn accumulates the same way, plot.py:1344-1364)
        self._steps = []
        self._total_acc_history = None
        self._move_acc_history = {}

    def _labels(self, name, ndim):
        src = self.info_keys
        if src is None:
            src = getattr(self.backend, "key_order", None) or {}
        labels = src.get(name) if isinstance(src, dict) else src
        if labels is not None and len(labels) == ndim:
            return [str(lb) for lb in labels]
        return [f"param {d}" for d in range(ndim)]

    #: False: draw, and write nothing (a rank of a device mesh other than
    #: the one that writes the files)
    save_files = True

    def _path(self, tag):
        if not self.save_files:
            return os.devnull
        os.makedirs(self.plot_dir, exist_ok=True)
        return os.path.join(self.plot_dir, f"{self.fp}_{tag}.png")

    # ------------------------------------------------------------------
    # individual plots
    # ------------------------------------------------------------------
    def generate_corner(self, burn=0, thin=1, name=None, save=True):
        """Corner (pair) plot of the cold chain (Eryn's ``plot.py:989``-family)."""
        plt = _get_plt()
        backend = self.backend
        names = [name] if name else (self.branches or backend.branch_names)
        figs = []
        for nm in names:
            samples = _flat_cold_chain(backend, nm, burn, thin)
            if self.parameter_transforms is not None:
                samples = np.asarray(
                    self.parameter_transforms.both_transforms(samples)
                )
            ndim = samples.shape[-1]
            labels = self._labels(nm, ndim)
            fig, axes = plt.subplots(
                ndim, ndim, figsize=(2.0 * ndim, 2.0 * ndim)
            )
            axes = np.atleast_2d(axes)
            bins = self.corner_kwargs.get("bins", 40)
            hist_kwargs = {
                k: v for k, v in self.corner_kwargs.items() if k != "bins"
            }
            for i in range(ndim):
                for j in range(ndim):
                    ax = axes[i, j]
                    if j > i:
                        ax.set_visible(False)
                    elif i == j:
                        ax.hist(
                            samples[:, i],
                            bins=bins,
                            histtype="step",
                            **hist_kwargs,
                        )
                    else:
                        ax.hist2d(samples[:, j], samples[:, i], bins=bins)
                    if i < ndim - 1:
                        ax.set_xticklabels([])
                    if j > 0:
                        ax.set_yticklabels([])
                    if i == ndim - 1:
                        ax.set_xlabel(labels[j])
                    if j == 0 and i > 0:
                        ax.set_ylabel(labels[i])
            truths = None if self.truths is None else self.truths.get(nm)
            if truths is not None:
                truths = np.atleast_1d(np.asarray(truths, dtype=float))
                for i in range(ndim):
                    for j in range(i + 1):
                        ax = axes[i, j]
                        ax.axvline(truths[j], color="C3", lw=1)
                        if j < i:
                            ax.axhline(truths[i], color="C3", lw=1)
            ocov = (
                None
                if self.overlay_covariance is None
                else self.overlay_covariance.get(nm)
            )
            if ocov is not None:
                ocov = np.asarray(ocov, dtype=float)
                center = (
                    truths
                    if truths is not None
                    else samples.mean(axis=0)
                )
                for i in range(ndim):
                    sd = np.sqrt(ocov[i, i])
                    g = np.linspace(center[i] - 4 * sd, center[i] + 4 * sd, 200)
                    dens = np.exp(-0.5 * ((g - center[i]) / sd) ** 2)
                    ax = axes[i, i]
                    ymax = ax.get_ylim()[1]
                    ax.plot(g, dens * ymax, color="C2", lw=1, ls="--")
            fig.suptitle(f"{nm} corner")
            if save:
                fig.savefig(self._path(f"corner_{nm}"))
                plt.close(fig)
            figs.append(fig)
        return figs

    def plot_trace(self, burn=0, thin=1, save=True):
        plt = _get_plt()
        backend = self.backend
        for nm in self.branches or backend.branch_names:
            chain = backend.get_chain(discard=burn, thin=thin)[nm]
            inds = backend.get_inds(discard=burn, thin=thin)[nm]
            nsteps, ntemps, nwalkers, nl, nd = chain.shape
            labels = self._labels(nm, nd)
            fig, axes = plt.subplots(nd, 1, figsize=(8, 2 * nd), squeeze=False)
            # stale coordinates of INACTIVE leaves must not be plotted
            lead = np.where(inds[:, 0, :, 0, None], chain[:, 0, :, 0, :], np.nan)
            for d in range(nd):
                axes[d, 0].plot(
                    lead[..., d], alpha=0.3, lw=0.5, color="k"
                )
                axes[d, 0].set_ylabel(labels[d])
            fig.suptitle(f"{nm} trace (cold chain)")
            if save:
                fig.savefig(self._path(f"trace_{nm}"))
                plt.close(fig)

    def plot_log_like(self, burn=0, thin=1, save=True):
        plt = _get_plt()
        ll = self.backend.get_log_like(discard=burn, thin=thin)
        fig, ax = plt.subplots()
        ax.plot(ll[:, 0].max(axis=-1), label="cold max")
        ax.plot(ll[:, 0].mean(axis=-1), label="cold mean")
        ax.set_xlabel("iteration")
        ax.set_ylabel("log like")
        ax.legend()
        if save:
            fig.savefig(self._path("log_like"))
            plt.close(fig)

    def plot_betas(self, burn=0, thin=1, save=True):
        """Temperature-ladder evolution (Eryn's tempering plots)."""
        plt = _get_plt()
        betas = self.backend.get_betas(discard=burn, thin=thin)
        fig, ax = plt.subplots()
        with np.errstate(divide="ignore"):
            ax.semilogy(betas)
        ax.set_xlabel("iteration")
        ax.set_ylabel("beta")
        if save:
            fig.savefig(self._path("betas"))
            plt.close(fig)

    def plot_swap_acceptance(self, save=True):
        plt = _get_plt()
        backend = self.backend
        if backend.swaps_accepted is None:
            return
        frac = _host(backend.swaps_accepted) / (
            backend.iteration * backend.nwalkers
        )
        fig, ax = plt.subplots()
        ax.plot(frac, "o-")
        ax.axhline(0.25, ls="--", color="gray")
        ax.set_xlabel("temperature rung")
        ax.set_ylabel("swap acceptance")
        if save:
            fig.savefig(self._path("swap_acceptance"))
            plt.close(fig)

    def plot_leaves_hist(self, burn=0, thin=1, save=True):
        plt = _get_plt()
        backend = self.backend
        nleaves = backend.get_nleaves(discard=burn, thin=thin)
        for nm, nl in nleaves.items():
            fig, ax = plt.subplots()
            vals = nl[:, 0].flatten()
            bins = np.arange(vals.min() - 0.5, vals.max() + 1.5)
            ax.hist(vals, bins=bins)
            ax.set_xlabel("leaf count")
            ax.set_title(f"{nm} leaves (cold chain)")
            if save:
                fig.savefig(self._path(f"leaves_{nm}"))
                plt.close(fig)

    def plot_leaves_evolution(self, burn=0, thin=1, save=True):
        plt = _get_plt()
        nleaves = self.backend.get_nleaves(discard=burn, thin=thin)
        for nm, nl in nleaves.items():
            fig, ax = plt.subplots()
            ax.plot(nl[:, 0].mean(axis=-1))
            ax.set_xlabel("iteration")
            ax.set_ylabel("mean leaf count")
            ax.set_title(nm)
            if save:
                fig.savefig(self._path(f"leaves_evolution_{nm}"))
                plt.close(fig)

    def plot_acceptance_fraction(self, save=True):
        plt = _get_plt()
        backend = self.backend
        frac = _host(backend.accepted) / max(backend.iteration, 1)
        fig, ax = plt.subplots()
        ax.plot(frac.mean(axis=-1), "o-")
        ax.set_xlabel("temperature")
        ax.set_ylabel("mean acceptance fraction")
        if save:
            fig.savefig(self._path("acceptance"))
            plt.close(fig)

    def plot_tempering_ridgeline(self, burn=0, thin=1, max_samples=10000, save=True):
        """Ridgeline ("joy") plot: per-parameter KDEs stacked by temperature,
        showing the posterior broadening up the ladder
        (Eryn's ``plot.py:409-566``; plain-matplotlib KDE instead of seaborn)."""
        try:
            from scipy.stats import gaussian_kde
        except ImportError:  # scipy is an optional extra
            import warnings

            warnings.warn(
                "scipy not available; skipping the tempering ridgeline plot.",
                stacklevel=2,
            )
            return

        plt = _get_plt()
        backend = self.backend
        rng = np.random.default_rng(42)
        for nm in self.branches or backend.branch_names:
            chain = backend.get_chain(discard=burn, thin=thin)[nm]
            inds = backend.get_inds(discard=burn, thin=thin)[nm]
            # stale inactive-leaf slots are finite junk: NaN-mask them so
            # the per-temperature densities only see live samples
            chain = np.where(inds[..., None], chain, np.nan)
            nsteps, ntemps, nwalkers, nl, nd = chain.shape
            labels = self._labels(nm, nd)
            fig, axes = plt.subplots(
                ntemps,
                nd,
                figsize=(3.0 * nd, 0.7 * ntemps),
                sharex="col",
                squeeze=False,
            )
            colors = _palette(ntemps, self.tempering_palette)
            for d in range(nd):
                lo, hi = None, None
                for t in range(ntemps):
                    samples = chain[:, t, :, :, d].reshape(-1)
                    samples = samples[np.isfinite(samples)]
                    if samples.size > max_samples:
                        samples = rng.choice(samples, max_samples, replace=False)
                    ax = axes[t, d]
                    color = colors[t]
                    if samples.size > 4 and samples.std() > 0:
                        grid = np.linspace(
                            samples.min(), samples.max(), 200
                        )
                        dens = gaussian_kde(samples, bw_method=0.25)(grid)
                        ax.fill_between(grid, dens, color=color, alpha=0.8)
                        lo = grid[0] if lo is None else min(lo, grid[0])
                        hi = grid[-1] if hi is None else max(hi, grid[-1])
                    ax.set_yticks([])
                    for side in ("top", "right", "left"):
                        ax.spines[side].set_visible(False)
                    if d == 0:
                        ax.set_ylabel(
                            rf"$\beta_{{{t}}}$", rotation=0, ha="right"
                        )
                axes[-1, d].set_xlabel(labels[d])
            fig.suptitle(f"{nm} tempering ridgeline")
            fig.subplots_adjust(hspace=-0.2)
            if save:
                fig.savefig(self._path(f"ridgeline_{nm}"))
                plt.close(fig)

    def plot_logl_betas(self, burn=0, thin=1, save=True):
        """Mean tempered log-likelihood per rung vs beta, with the
        stepping-stone evidence in the title (Eryn's ``plot.py:633-661``)."""
        from .utility import stepping_stone_log_evidence

        plt = _get_plt()
        backend = self.backend
        logl = backend.get_log_like(discard=burn, thin=thin)
        betas = backend.get_betas(discard=burn, thin=thin)
        ntemps = betas.shape[1]
        if ntemps < 2:
            return
        fig, ax = plt.subplots(figsize=(8, 5))
        cmap = plt.get_cmap("coolwarm")
        for t in range(ntemps):
            ax.semilogx(
                max(betas[-1, t], 1e-12),
                np.mean(logl[:, t]),
                ".",
                ms=10,
                color=cmap(t / max(ntemps - 1, 1)),
            )
        title = "mean log-like vs beta"
        try:
            logZ, dlogZ = stepping_stone_log_evidence(betas[-1], logl)
            title = rf"$\log Z$ = {logZ:.2f} $\pm$ {dlogZ:.2f}"
        except Exception:
            pass
        ax.set_xlabel(r"$\beta$")
        ax.set_ylabel(r"$\langle \log L \rangle_\beta$")
        ax.set_title(title)
        if save:
            fig.savefig(self._path("logl_betas"))
            plt.close(fig)

    def _record_acceptance_history(self):
        backend = self.backend
        it = max(backend.iteration, 1)
        self._steps.append(backend.iteration)
        total = (_host(backend.accepted) / float(it))[None]
        if self._total_acc_history is None:
            self._total_acc_history = total
        else:
            self._total_acc_history = np.vstack(
                [self._total_acc_history, total]
            )
        fractions = getattr(backend, "moves_accepted_fraction", None)
        if fractions:
            for key, val in fractions.items():
                val = _host(val)[None]
                if key not in self._move_acc_history:
                    self._move_acc_history[key] = val
                else:
                    self._move_acc_history[key] = np.vstack(
                        [self._move_acc_history[key], val]
                    )

    def plot_acceptance_evolution(self, save=True):
        """Cold-chain total (+ per-move) acceptance fraction over sampler
        iterations (Eryn's ``plot.py:813-840``); history is accumulated across
        ``produce_plots`` calls."""
        if self._total_acc_history is None:
            self._record_acceptance_history()
        plt = _get_plt()
        fig, ax = plt.subplots(figsize=(8, 5))
        ax.plot(
            self._steps,
            self._total_acc_history[:, 0].mean(axis=-1),
            color="black",
            lw=2,
            label="Total",
        )
        for key, hist in self._move_acc_history.items():
            if hist.shape[0] == len(self._steps):
                ax.plot(
                    self._steps, hist[:, 0].mean(axis=-1), "o-", label=key
                )
        ax.axhline(0.234, color="gray", ls="--", lw=1, alpha=0.7)
        ax.set_xlabel("sampler iteration")
        ax.set_ylabel("acceptance fraction")
        ax.legend()
        if save:
            fig.savefig(self._path("acceptance_evolution"))
            plt.close(fig)

    def plot_tempered_acceptance_evolution(self, save=True):
        """Per-temperature acceptance fraction over iterations
        (Eryn's ``plot.py:841-904``)."""
        if self._total_acc_history is None:
            self._record_acceptance_history()
        plt = _get_plt()
        hist = self._total_acc_history
        ntemps = hist.shape[1]
        cmap = plt.get_cmap("coolwarm")
        fig, ax = plt.subplots(figsize=(8, 5))
        for t in range(ntemps):
            ax.plot(
                self._steps,
                hist[:, t].mean(axis=-1),
                "o-",
                color=cmap(t / max(ntemps - 1, 1)),
                alpha=0.8,
            )
        ax.set_xlabel("sampler iteration")
        ax.set_ylabel("acceptance fraction")
        ax.set_title("acceptance per temperature (blue=cold, red=hot)")
        if save:
            fig.savefig(self._path("acceptance_tempered_evolution"))
            plt.close(fig)

    def plot_act_evolution(self, burn=0, thin=1, npoints=10, save=True):
        """Integrated-ACT estimate on growing chain prefixes plus the final
        per-parameter values (Eryn's ``plot.py:906-988``)."""
        from .utility import get_integrated_act

        plt = _get_plt()
        backend = self.backend
        chain = backend.get_chain(discard=burn, thin=thin)
        for nm, samples in chain.items():
            nsteps, ntemps, nwalkers, nl, nd = samples.shape
            if nsteps < 8:
                continue
            points = np.unique(
                np.exp(
                    np.linspace(
                        np.log(min(100, nsteps)), np.log(nsteps), npoints
                    )
                ).astype(int)
            )
            taus = []
            for n in points:
                tau_n = get_integrated_act(
                    {nm: samples[:n, :1]}
                )[nm]
                taus.append(np.nanmax(tau_n))
            fig, axes = plt.subplots(1, 2, figsize=(11, 4))
            axes[0].loglog(points, taus, "o-")
            axes[0].loglog(
                points, np.asarray(points) / 50.0, "--", color="gray",
                label=r"$\tau = N/50$",
            )
            axes[0].set_xlabel("chain length")
            axes[0].set_ylabel(r"max $\hat\tau$")
            axes[0].legend()
            tau_final = get_integrated_act({nm: samples[:, :1]})[nm]
            vals = np.asarray(tau_final).reshape(-1)
            axes[1].bar(np.arange(vals.size), vals)
            axes[1].set_xticks(np.arange(vals.size))
            axes[1].set_xticklabels(
                self._labels(nm, nd) * nl if vals.size == nd * nl else None,
                rotation=45,
            )
            axes[1].set_ylabel(r"$\hat\tau$ per parameter")
            fig.suptitle(f"{nm} autocorrelation evolution")
            if save:
                fig.savefig(self._path(f"act_evolution_{nm}"))
                plt.close(fig)

    # ------------------------------------------------------------------
    # grouped producers (Eryn's plot.py:989-1206)
    # ------------------------------------------------------------------
    def produce_base_plots(self, burn=0, thin=1):
        self.generate_corner(burn=burn, thin=thin)
        self.plot_trace(burn=burn, thin=thin)
        self.plot_log_like(burn=burn, thin=thin)

    def produce_tempering_plots(self, burn=0, thin=1):
        self.plot_betas(burn=burn, thin=thin)
        self.plot_swap_acceptance()
        self.plot_logl_betas(burn=burn, thin=thin)
        self.plot_tempering_ridgeline(burn=burn, thin=thin)

    def produce_rj_plots(self, burn=0, thin=1):
        self.plot_leaves_hist(burn=burn, thin=thin)
        self.plot_leaves_evolution(burn=burn, thin=thin)

    def produce_advanced_plots(self, burn=0, thin=1):
        self._record_acceptance_history()
        self.plot_acceptance_fraction()
        self.plot_acceptance_evolution()
        self.plot_tempered_acceptance_evolution()
        self.plot_act_evolution(burn=burn, thin=thin)

    def produce_plots(self, burn=0, thin=1):
        """Drive all configured plot groups from the backend
        (Eryn's ``plot.py:1208-1392``)."""
        if self.backend is None or self.backend.iteration <= 0:
            return
        if self.backend.iteration > self.stop:
            return
        if burn == 0 and self.discard:
            burn = (
                int(self.discard)
                if self.discard >= 1
                else int(self.discard * self.backend.iteration)
            )
        if self.thin_chain_by_ac:
            try:
                burn, thin = self.backend.get_autocorr_thin_burn()
            except Exception:
                pass
        groups = {
            "base": self.produce_base_plots,
            "tempering": self.produce_tempering_plots,
            "rj": self.produce_rj_plots,
            "advanced": self.produce_advanced_plots,
        }
        which = self.which_plots
        if isinstance(which, str):
            # a bare string must select the GROUP, not iterate characters
            which = tuple(groups) if which == "all" else (which,)
        elif "all" in which:
            which = tuple(groups)
        for key in which:
            try:
                groups[key](burn=burn, thin=thin)
            except Exception as e:  # noqa: BLE001
                # runtime plotting must never abort a sampling run
                import warnings

                warnings.warn(
                    f"plot group '{key}' failed: {e!r}", stacklevel=2
                )
                continue

    # Eryn's name
    def generate_plot_info(self, burn=0, thin=1, **kwargs):
        self.produce_plots(burn=burn, thin=thin)


# ---------------------------------------------------------------------------
# module-level, data-driven plot functions (Eryn's API, which builds them on
# corner, seaborn and pandas; these are matplotlib only).  PlotContainer
# (above) draws from a backend.
# ---------------------------------------------------------------------------

def save_or_show(fig, filename=None):
    """Save ``fig`` to ``filename`` (and close it) or show it
    (Eryn's ``plot.py:34-45``)."""
    plt = _get_plt()
    if filename is not None:
        fig.savefig(filename, bbox_inches="tight")
        plt.close(fig)
    else:
        fig.show()
    return fig


def _palette(n, palette=None):
    plt = _get_plt()
    if isinstance(palette, (list, tuple)):
        return list(palette)[:n]
    name = palette if isinstance(palette, str) else "coolwarm"
    try:
        cmap = plt.get_cmap(name)
    except ValueError:
        # seaborn palette names ("icefire", ...) are not matplotlib cmaps
        cmap = plt.get_cmap("coolwarm")
    return [cmap(i / max(n - 1, 1)) for i in range(n)]


def cov_ellipse(mean, cov, ax, n_std=1.0, **kwargs):
    """Covariance ellipse via eigendecomposition (Eryn's ``plot.py:48-81``)."""
    from matplotlib.patches import Ellipse

    eigenvalues, eigenvectors = np.linalg.eigh(np.asarray(cov))
    order = eigenvalues.argsort()[::-1]
    eigenvalues = eigenvalues[order]
    eigenvectors = eigenvectors[:, order]
    width, height = 2 * n_std * np.sqrt(eigenvalues)
    angle = np.degrees(np.arctan2(eigenvectors[1, 0], eigenvectors[0, 0]))
    ellipse = Ellipse(
        xy=tuple(np.asarray(mean)), width=width, height=height, angle=angle,
        **kwargs,
    )
    return ax.add_patch(ellipse)


def overlay_fim_covariance(
    fig,
    covariance,
    means=None,
    nsigmas=(1, 2, 3),
    plot_1d=False,
    colors=None,
    linestyles=None,
    linewidths=None,
    alpha=0.7,
    labels=None,
):
    """Overlay information-matrix confidence contours on a corner-style
    figure's axes grid (Eryn's ``plot.py:82-229``)."""
    covariance = np.asarray(covariance)
    nd = covariance.shape[0]
    if means is None:
        means = np.zeros(nd)
    means = np.asarray(means)
    axes = np.asarray(fig.axes).reshape(nd, nd)
    colors = list(colors) if colors is not None else ["C2"] * len(nsigmas)
    linestyles = (
        list(linestyles) if linestyles is not None else ["-"] * len(nsigmas)
    )
    linewidths = (
        list(linewidths) if linewidths is not None else [1.5] * len(nsigmas)
    )
    for i in range(nd):
        for j in range(i):
            ax = axes[i, j]
            sub = covariance[np.ix_([j, i], [j, i])]
            for k, ns in enumerate(nsigmas):
                cov_ellipse(
                    (means[j], means[i]), sub, ax, n_std=ns,
                    facecolor="none", edgecolor=colors[k % len(colors)],
                    linestyle=linestyles[k % len(linestyles)],
                    linewidth=linewidths[k % len(linewidths)], alpha=alpha,
                )
        if plot_1d:
            ax = axes[i, i]
            sd = np.sqrt(covariance[i, i])
            for k, ns in enumerate(nsigmas):
                for sign in (-1, 1):
                    ax.axvline(
                        means[i] + sign * ns * sd,
                        color=colors[k % len(colors)],
                        linestyle=linestyles[k % len(linestyles)],
                        linewidth=linewidths[k % len(linewidths)],
                        alpha=alpha,
                    )
    return fig


def cornerplot(
    data,
    *args,
    means=None,
    overlay_covariance=None,
    legend_label="Samples",
    overlay_label="Information Matrix Covariance",
    filename=None,
    **kwargs,
):
    """Corner plot with optional covariance overlay
    (Eryn's ``plot.py:232-330``; matplotlib-only, no ``corner`` dependency)."""
    plt = _get_plt()
    data = np.asarray(data)
    data = data.reshape(-1, data.shape[-1])
    data = data[np.isfinite(data).all(axis=-1)]
    nd = data.shape[-1]
    labels = kwargs.pop("labels", None)
    truths = kwargs.pop("truths", None)
    bins = kwargs.pop("bins", 40)
    fig, axes = plt.subplots(nd, nd, figsize=(2.0 * nd, 2.0 * nd))
    axes = np.atleast_2d(axes)
    for i in range(nd):
        for j in range(nd):
            ax = axes[i, j]
            if j > i:
                ax.set_visible(False)
            elif i == j:
                ax.hist(data[:, i], bins=bins, histtype="step", density=True)
                if truths is not None:
                    ax.axvline(np.atleast_1d(truths)[i], color="C3", lw=1)
            else:
                ax.hist2d(data[:, j], data[:, i], bins=bins)
                if truths is not None:
                    t = np.atleast_1d(truths)
                    ax.axvline(t[j], color="C3", lw=1)
                    ax.axhline(t[i], color="C3", lw=1)
            if i < nd - 1:
                ax.set_xticklabels([])
            if j > 0:
                ax.set_yticklabels([])
            if labels is not None and i == nd - 1:
                ax.set_xlabel(labels[j])
            if labels is not None and j == 0 and i > 0:
                ax.set_ylabel(labels[i])
    if overlay_covariance is not None:
        center = means
        if center is None:
            center = truths if truths is not None else data.mean(axis=0)
        overlay_fim_covariance(
            fig, overlay_covariance, means=center, nsigmas=(1, 2, 3)
        )
    return save_or_show(fig, filename)


def traceplot(chain, labels=None, truths=None, filename=None):
    """Trace plots of an ``(nsteps, nwalkers, nleaves, ndim)`` chain
    (Eryn's ``plot.py:333-363``)."""
    plt = _get_plt()
    chain = np.asarray(chain)
    nsteps, nwalkers, nleaves, ndim = chain.shape
    fig, axs = plt.subplots(
        ndim, 1, figsize=(10, 2.5 * ndim), sharex=True, squeeze=False
    )
    axs = axs[:, 0]
    for i in range(ndim):
        axs[i].plot(
            chain[..., i].reshape(nsteps, -1), alpha=0.5, lw=0.5,
            rasterized=True,
        )
        if truths is not None:
            for t in np.atleast_2d(truths):
                axs[i].axhline(t[i], color="k", linestyle="--")
        if labels is not None:
            axs[i].set_ylabel(labels[i])
    axs[-1].set_xlabel("Step")
    fig.tight_layout()
    return save_or_show(fig, filename)


def plot_loglikelihood(logl, filename=None):
    """Per-walker log-likelihood evolution (Eryn's ``plot.py:366-406``)."""
    plt = _get_plt()
    logl = np.asarray(logl)
    fig = plt.figure(figsize=(10, 6))
    for j in range(logl.shape[1]):
        plt.plot(logl[:, j], color=f"C{j % 10}", alpha=0.8, rasterized=True)
    plt.xlabel("Sampler Iteration")
    plt.ylabel("Log-Likelihood")
    return save_or_show(fig, filename)


def tempering_ridgeplot(
    chain,
    labels=None,
    palette=None,
    bw_adjust=0.5,
    aspect=5,
    height=0.5,
    hspace=-0.25,
    max_samples=10000,
    filename=None,
):
    """Ridge (joy) plot of the tempered distributions per parameter
    (Eryn's ``plot.py:409-565``; matplotlib + scipy KDE)."""
    from scipy.stats import gaussian_kde

    plt = _get_plt()
    chain = np.asarray(chain)
    nsteps, ntemps, nwalkers, nleaves, ndim = chain.shape
    colors = _palette(ntemps, palette)
    rng = np.random.default_rng(42)
    fig, axes = plt.subplots(
        ntemps, ndim,
        figsize=(max(2.0, aspect * height) * ndim, height * 2 * ntemps),
        sharex="col", squeeze=False,
    )
    for d in range(ndim):
        for t in range(ntemps):
            samples = chain[:, t, :, :, d].reshape(-1)
            samples = samples[np.isfinite(samples)]
            if samples.size > max_samples:
                samples = rng.choice(samples, max_samples, replace=False)
            ax = axes[t, d]
            if samples.size > 4 and samples.std() > 0:
                grid = np.linspace(samples.min(), samples.max(), 200)
                dens = gaussian_kde(samples, bw_method=bw_adjust * 0.5)(grid)
                ax.fill_between(grid, dens, color=colors[t], alpha=0.8)
            ax.set_yticks([])
            for side in ("top", "right", "left"):
                ax.spines[side].set_visible(False)
            if d == 0:
                ax.set_ylabel(rf"$\beta_{{{t}}}$", rotation=0, ha="right")
        axes[-1, d].set_xlabel(
            labels[d] if labels is not None else rf"$x_{d}$"
        )
    fig.subplots_adjust(hspace=hspace)
    return save_or_show(fig, filename)


def plot_swap_acceptance(swap_acceptance_fraction, palette=None, filename=None):
    """Bar plot of swap acceptance between adjacent rungs
    (Eryn's ``plot.py:568-630``)."""
    plt = _get_plt()
    saf = np.asarray(swap_acceptance_fraction)
    ntemps = saf.shape[0] + 1
    fig, ax = plt.subplots(figsize=(8, 5))
    x = np.arange(ntemps - 1)
    ax.bar(
        x, saf, color=_palette(ntemps - 1, palette), edgecolor="white",
        linewidth=0.5,
    )
    ax.axhline(0.25, color="gray", linestyle="--", lw=1, alpha=0.7, label="0.25")
    ax.set_xticks(x)
    ax.set_xticklabels(
        [rf"{i}$\leftrightarrow${i + 1}" for i in range(ntemps - 1)]
    )
    ax.set_ylabel("Swap acceptance")
    ax.legend()
    return save_or_show(fig, filename)


def plot_logl_betas(betas, logl, palette=None, filename=None):
    """Mean log-likelihood vs beta with the stepping-stone evidence in the
    title (Eryn's ``plot.py:633-661``)."""
    from .utility import stepping_stone_log_evidence

    plt = _get_plt()
    betas = np.asarray(betas)
    logl = np.asarray(logl)
    ntemps = betas.shape[1]
    colors = _palette(ntemps, palette)
    fig = plt.figure(figsize=(10, 6))
    for t in range(ntemps):
        plt.semilogx(
            max(betas[-1, t], 1e-12), np.mean(logl[:, t]), ".",
            c=colors[t], label=rf"$T_{t}$",
        )
    logZ, dlogZ = stepping_stone_log_evidence(betas[-1], logl)
    plt.ylabel(r"$<\log{\mathcal{L}}>_{\beta}$")
    plt.xlabel(r"$\beta$")
    plt.title(r"$\log{\mathcal{Z}} = %.2f \pm %.2f$" % (logZ, dlogZ))
    return save_or_show(fig, filename)


def plot_betas_evolution(betas, palette=None, filename=None):
    """Inverse-temperature ladder evolution (Eryn's ``plot.py:663-719``)."""
    plt = _get_plt()
    betas = np.asarray(betas)
    nsteps, ntemps = betas.shape
    colors = _palette(ntemps, palette)
    fig, ax = plt.subplots(figsize=(10, 6))
    with np.errstate(divide="ignore"):
        for t in range(ntemps):
            ax.semilogy(betas[:, t], color=colors[t])
    ax.set_xlabel("Sampler Iteration")
    ax.set_ylabel(r"$\beta$")
    return save_or_show(fig, filename)


def plot_leaves(
    nleaves, nleaves_min, nleaves_max, palette=None, iteration=0, filename=None
):
    """Histogram of leaf counts per temperature (Eryn's ``plot.py:722-791``)."""
    from matplotlib.colors import to_rgba

    plt = _get_plt()
    nleaves = np.asarray(nleaves)
    bns = np.arange(nleaves_min, nleaves_max + 2) - 0.5
    ntemps = nleaves.shape[1]
    colors = _palette(ntemps, palette)
    fig = plt.figure(figsize=(8, 5))
    for temp, tempcolor in enumerate(colors):
        plt.hist(
            nleaves[:, temp].flatten(), bins=bns, histtype="stepfilled",
            edgecolor=tempcolor, facecolor=to_rgba(tempcolor, 0.2),
            density=True, ls="-", zorder=100 - temp, rasterized=True,
        )
    plt.xlabel("Number of leaves")
    plt.ylabel("Density")
    return save_or_show(fig, filename)


def plot_leaves_evolution(nleaves, palette=None, filename=None):
    """Cold-chain leaf-count evolution per walker (Eryn's ``plot.py:794-810``)."""
    plt = _get_plt()
    nleaves = np.asarray(nleaves)
    fig, ax = plt.subplots(figsize=(10, 4))
    ax.plot(nleaves, alpha=0.4, lw=0.7, rasterized=True)
    ax.set_xlabel("Sampler Iteration")
    ax.set_ylabel("Number of leaves")
    return save_or_show(fig, filename)


def plot_acceptance_fraction(
    steps, total_acceptance_fraction, moves_acceptance_fraction, filename=None
):
    """Cold-chain acceptance evolution, total + per move
    (Eryn's ``plot.py:813-838``)."""
    plt = _get_plt()
    taf = np.asarray(total_acceptance_fraction)
    fig = plt.figure(figsize=(10, 6))
    plt.plot(
        steps, taf[:, 0].mean(axis=1), label="Total", color="black", lw=2
    )
    for move, acc in (moves_acceptance_fraction or {}).items():
        plt.plot(steps, np.asarray(acc), label=move, alpha=0.8)
    plt.xlabel("Step")
    plt.ylabel("Acceptance fraction")
    plt.legend()
    return save_or_show(fig, filename)


def plot_tempered_acceptance_fraction(
    steps, total_acceptance_fraction, palette=None, filename=None
):
    """Acceptance evolution per temperature (Eryn's ``plot.py:841-903``)."""
    plt = _get_plt()
    taf = np.asarray(total_acceptance_fraction)
    ntemps = taf.shape[1]
    colors = _palette(ntemps, palette)
    fig = plt.figure(figsize=(10, 6))
    for temp in range(ntemps):
        plt.plot(
            steps, taf[:, temp].mean(axis=1), color=colors[temp], lw=1.5,
            marker="o", alpha=0.8, rasterized=True,
        )
    plt.xlabel("Step")
    plt.ylabel("Acceptance fraction")
    return save_or_show(fig, filename)


def plot_act_evolution(chain, iteration=0, parent_folder="."):
    """Autocorrelation-time evolution per branch in the cold chain
    (Eryn's ``plot.py:906-986``)."""
    from .utility import get_integrated_act

    plt = _get_plt()
    NPOINTS = 10
    iteration = int(iteration) or next(iter(chain.values())).shape[0]
    points = np.unique(
        np.exp(
            np.linspace(np.log(min(100, iteration)), np.log(iteration), NPOINTS)
        ).astype(int)
    )
    for branch, samples in chain.items():
        samples = np.asarray(samples)
        branch_folder = os.path.join(parent_folder, branch)
        os.makedirs(branch_folder, exist_ok=True)
        nsteps, ntemps, nwalkers, nleaves, ndim = samples.shape
        cold = samples[:, :1]
        taus = []
        for point in points:
            if point > nsteps or point < 4:
                continue
            tau = get_integrated_act({branch: cold[:point]})[branch]
            taus.append((point, np.nanmax(np.atleast_1d(tau))))
        if not taus:
            continue
        pts, tmax = zip(*taus)
        fig, ax = plt.subplots(figsize=(8, 5))
        ax.loglog(pts, tmax, "o-", label=r"max $\tau$")
        ax.loglog(pts, np.asarray(pts) / 50.0, "--", color="gray",
                  label=r"$N/50$")
        ax.set_xlabel("Steps")
        ax.set_ylabel(r"$\tau$")
        ax.legend()
        save_or_show(
            fig, os.path.join(branch_folder, f"act_evolution_{iteration}.png")
        )


def produce_base_plots(
    chain,
    logl,
    truths=None,
    overlay_covariance=None,
    labels=None,
    iteration=0,
    parent_folder=".",
):
    """Corner + trace + log-likelihood plots per branch
    (Eryn's ``plot.py:989-1057``)."""
    os.makedirs(parent_folder, exist_ok=True)
    for branch, samples in chain.items():
        samples = np.asarray(samples)
        cold = samples[:, 0]
        cornerplot(
            cold.reshape(-1, cold.shape[-1]),
            truths=None if truths is None else truths.get(branch),
            overlay_covariance=(
                None
                if overlay_covariance is None
                else overlay_covariance.get(branch)
            ),
            labels=None if labels is None else labels.get(branch),
            filename=os.path.join(parent_folder, f"corner_{branch}.png"),
        )
        traceplot(
            cold,
            labels=None if labels is None else labels.get(branch),
            truths=None if truths is None else truths.get(branch),
            filename=os.path.join(parent_folder, f"trace_{branch}.png"),
        )
    plot_loglikelihood(
        np.asarray(logl)[:, 0],
        filename=os.path.join(parent_folder, "loglikelihood.png"),
    )


def produce_tempering_plots(
    chain,
    betas,
    logl,
    swap_acceptance_fraction,
    labels=None,
    parent_folder=".",
    palette=None,
):
    """Ridgeline + swap acceptance + logl-vs-beta + beta evolution
    (Eryn's ``plot.py:1060-1116``)."""
    os.makedirs(parent_folder, exist_ok=True)
    for branch, samples in chain.items():
        tempering_ridgeplot(
            np.asarray(samples),
            labels=None if labels is None else labels.get(branch),
            palette=palette,
            filename=os.path.join(parent_folder, f"ridgeplot_{branch}.png"),
        )
    plot_swap_acceptance(
        np.asarray(swap_acceptance_fraction), palette=palette,
        filename=os.path.join(parent_folder, "swap_acceptance.png"),
    )
    plot_logl_betas(
        np.asarray(betas), np.asarray(logl), palette=palette,
        filename=os.path.join(parent_folder, "logl_betas.png"),
    )
    plot_betas_evolution(
        np.asarray(betas), palette=palette,
        filename=os.path.join(parent_folder, "betas_evolution.png"),
    )


def produce_advanced_plots(
    steps,
    total_acceptance_fraction,
    moves_acceptance_fraction,
    palette=None,
    iteration=0,
    chain=None,
    parent_folder=".",
):
    """Acceptance + ACT evolution plots (Eryn's ``plot.py:1119-1158``)."""
    os.makedirs(parent_folder, exist_ok=True)
    plot_acceptance_fraction(
        steps, total_acceptance_fraction, moves_acceptance_fraction,
        filename=os.path.join(parent_folder, "acceptance_fraction.png"),
    )
    plot_tempered_acceptance_fraction(
        steps, total_acceptance_fraction, palette=palette,
        filename=os.path.join(
            parent_folder, "tempered_acceptance_fraction.png"
        ),
    )
    if chain is not None:
        plot_act_evolution(
            chain, iteration=iteration, parent_folder=parent_folder
        )


def produce_rj_plots(
    nleaves,
    nleaves_min,
    nleaves_max,
    palette=None,
    parent_folder=".",
    iteration=0,
):
    """Leaf-count histograms + cold-chain evolution per branch
    (Eryn's ``plot.py:1161-1206``)."""
    os.makedirs(parent_folder, exist_ok=True)
    for branch, leaves in nleaves.items():
        leaves = np.asarray(leaves)
        plot_leaves(
            leaves,
            nleaves_min[branch],
            nleaves_max[branch],
            palette=palette,
            iteration=iteration,
            filename=os.path.join(parent_folder, f"leaves_{branch}.png"),
        )
        plot_leaves_evolution(
            leaves[:, 0],
            palette=palette,
            filename=os.path.join(
                parent_folder, f"leaves_evolution_{branch}.png"
            ),
        )
