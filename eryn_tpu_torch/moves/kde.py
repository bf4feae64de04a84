"""Kernel-density-estimate ensemble proposal.

Port of :mod:`eryn_tpu.moves.kde`: fit a Gaussian KDE to the complement half
(Scott's bandwidth on its sample covariance, regularized by ``jitter``) and
propose independent draws from it, with factors ``log q(s) - log
q(q_new)``.  The density at ``m`` points is a whitened distance matrix
against the ``nc`` kernels and a ``logsumexp``; the per-temperature
Cholesky factor is ``torch.linalg.cholesky_ex``, which leaves its status
on the device: a factor that fails is NaN, as ``jnp.linalg.cholesky``
gives, so its proposals are refused and no step waits for the host.

Meant for fully active branches: under reversible jump the padded columns
would enter the covariance.
"""

from __future__ import annotations

import math

import torch

from .red_blue import RedBlueMove

__all__ = ["KDEMove", "cholesky_or_nan"]


def cholesky_or_nan(a):
    """Lower Cholesky factors of the batch ``a`` ``(..., d, d)``; where a
    factorization fails, NaN on and below the diagonal and zero above, as
    ``jnp.linalg.cholesky`` gives, without reading its status on the
    host."""
    chol, info = torch.linalg.cholesky_ex(a)
    return torch.where((info != 0)[..., None, None],
                       torch.full_like(chol, math.nan).tril(), chol)


def periodic_refused(move, names, ndims, label):
    """Raise for a branch with periodic parameters: exact independence
    factors on a torus need a sum over periodic images."""
    if move.periodic is None:
        return
    for n in names:
        vec = move.periodic._vectors.get(n)
        if vec is not None and any(v != math.inf for v in vec[:ndims[n]]):
            raise ValueError(
                f"{label} does not support periodic parameters: the "
                "independence factors are computed on the unwrapped space. "
                "Use DEMove/StretchMove for periodic dimensions.")


class KDEMove(RedBlueMove):
    """Gaussian-KDE independent proposal from the complement half.

    Args:
        bw_method: bandwidth factor; None takes Scott's ``nc ** (-1 / (d +
            4))``.
        jitter: diagonal regularization of the complement covariance,
            relative to its mean variance.
    """

    _mesh_sharded = True

    def __init__(self, bw_method=None, jitter=1e-10, **kwargs):
        super().__init__(**kwargs)
        self.bw_method = bw_method
        self.jitter = float(jitter)

    @staticmethod
    def _kde_logpdf(x, kernels, chol_inv, logdet, d):
        """log KDE density of ``x`` ``(nt, m, d)`` against ``kernels``
        ``(nt, nc, d)`` with the whitening ``chol_inv`` ``(nt, d, d)``."""
        nc = kernels.shape[1]
        xw = torch.einsum("tmd,tde->tme", x, chol_inv)
        kw = torch.einsum("tnd,tde->tne", kernels, chol_inv)
        x2 = torch.sum(xw ** 2, dim=-1)[:, :, None]
        k2 = torch.sum(kw ** 2, dim=-1)[:, None, :]
        cross = torch.einsum("tme,tne->tmn", xw, kw)
        maha = x2 + k2 - 2.0 * cross
        logk = -0.5 * maha - 0.5 * logdet[:, None, None]
        logk = logk - 0.5 * d * math.log(2.0 * math.pi)
        return torch.logsumexp(logk, dim=-1) - math.log(nc)

    def draw_kde(self, generator, names, nt, ns, nc, dims, like):
        """Per branch the kernel picked per walker in ``[0, nc)`` and the
        standard normals ``(nt, ns, d)`` of its draw, ``dims`` mapping
        branches to ``d``."""
        def pick(shape):
            return torch.randint(0, nc, shape, generator=generator,
                                 device=like.device)

        def normal(shape):
            return torch.randn(shape, generator=generator, dtype=like.dtype,
                               device=like.device)

        return {n: (self.rank_draw(pick, (nt, ns)),
                    self.rank_draw(normal, (nt, ns, dims[n])))
                for n in names}

    def get_proposal_kernel(self, generator, s_coords, c_coords, s_inds,
                            param_masks=None):
        if param_masks is not None and any(
                m is not None for m in param_masks.values()):
            raise ValueError(
                "KDEMove does not support Gibbs parameter masks: the "
                "independence factors are computed for the full KDE draw. "
                "Use DEMove/StretchMove for Gibbs-split updates.")
        names = list(s_coords)
        periodic_refused(self, names, {n: s_coords[n].shape[-1] for n in names},
                         "KDEMove")
        first = s_coords[names[0]]
        ntemps, ns = first.shape[:2]
        dtype = first.dtype
        dims = {n: c.shape[2] * c.shape[3] for n, c in c_coords.items()}
        nc = c_coords[names[0]].shape[1]
        for n in names:
            if nc <= dims[n]:
                raise ValueError(
                    f"KDEMove needs more complement walkers ({nc}) than "
                    f"parameters ({dims[n]}) for a non-singular KDE "
                    "covariance.")
        draws = self.draw_kde(generator, names, ntemps, ns, nc, dims, first)

        newpos = {}
        factors = first.new_zeros((ntemps, ns))
        for name in names:
            s, c = s_coords[name], c_coords[name]
            nt, nc, nl, nd = c.shape
            d = nl * nd
            flat_c = c.reshape(nt, nc, d)
            flat_s = s.reshape(nt, ns, d)

            mean = flat_c.mean(dim=1, keepdim=True)
            dev = flat_c - mean
            cov = torch.einsum("tnd,tne->tde", dev, dev) / (nc - 1)
            var_scale = torch.diagonal(cov, dim1=1, dim2=2).sum(dim=-1) / d
            eye = torch.eye(d, dtype=dtype, device=first.device)
            cov = cov + (self.jitter * var_scale)[:, None, None] * eye
            bw = (float(self.bw_method) if self.bw_method is not None
                  else nc ** (-1.0 / (d + 4)))
            cov = cov * bw ** 2
            chol = cholesky_or_nan(cov)
            # whitening: rows times L^-T
            chol_inv = torch.linalg.solve_triangular(
                chol, eye.expand(nt, d, d), upper=False).transpose(1, 2)
            logdet = 2.0 * torch.sum(
                torch.log(torch.diagonal(chol, dim1=1, dim2=2)), dim=-1)

            pick, eps = draws[name]
            centers = torch.gather(flat_c, 1, pick[:, :, None].expand(-1, -1, d))
            q = centers + torch.einsum("tsd,ted->tse", eps, chol)
            newpos[name] = q.reshape(ntemps, ns, nl, nd)

            logq_old = self._kde_logpdf(flat_s, flat_c, chol_inv, logdet, d)
            logq_new = self._kde_logpdf(q, flat_c, chol_inv, logdet, d)
            factors = factors + (logq_old - logq_new)
        return newpos, factors
