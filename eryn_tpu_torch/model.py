"""Model carrier handed to moves.

Port of :mod:`eryn_tpu.model`: the capability bundle of Eryn's ``Model``
namedtuple, plus the :class:`~eryn_tpu_torch.moves.move.EvalContext` and the
sampler's ``torch.Generator``.
"""

from __future__ import annotations

__all__ = ["Model"]


class Model:
    """Read-only capability bundle for proposals.

    Attributes: ``log_like_fn``; ``compute_log_like_fn(coords, inds=None,
    logp=None, ...) -> (log_like, blobs)`` and ``compute_log_prior_fn(
    coords, inds=None)``, which take and return host (NumPy) arrays, as
    Eryn's host protocol reads them; ``temperature_control``; ``map_fn``
    (``pool.map`` when the sampler has a pool, else ``map``); ``random``,
    the sampler's ``numpy.random.RandomState`` for host hooks; and
    ``generator``, the sampler's ``torch.Generator``.
    """

    def __init__(
        self,
        log_like_fn,
        compute_log_like_fn,
        compute_log_prior_fn,
        temperature_control,
        map_fn,
        random,
        eval_context=None,
        generator=None,
    ):
        self.log_like_fn = log_like_fn
        self.compute_log_like_fn = compute_log_like_fn
        self.compute_log_prior_fn = compute_log_prior_fn
        self.temperature_control = temperature_control
        self.map_fn = map_fn
        self.random = random
        self.generator = generator
        self._eval_context = eval_context

    def get_eval_context(self):
        if self._eval_context is None:
            raise RuntimeError(
                "This Model carries no EvalContext: construct it through "
                "sampler.get_model()."
            )
        return self._eval_context

    def __iter__(self):
        return iter(
            (
                self.log_like_fn,
                self.compute_log_like_fn,
                self.compute_log_prior_fn,
                self.temperature_control,
                self.map_fn,
                self.random,
            )
        )
