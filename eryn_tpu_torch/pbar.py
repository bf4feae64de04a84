"""Progress bar of ``run_mcmc`` and ``sample``, with ``tqdm`` optional.

Port of :mod:`eryn_tpu.pbar`.
"""

from __future__ import annotations

import logging

__all__ = ["get_progress_bar"]

logger = logging.getLogger(__name__)

try:
    import tqdm
except ImportError:
    tqdm = None


class _NoOpPBar:
    """Stands in for a bar where none is shown."""

    def __enter__(self):
        return self

    def __exit__(self, *args):
        pass

    def update(self, count):
        pass


def get_progress_bar(display, total):
    """A ``tqdm`` bar, or a stand-in that shows nothing.

    Args:
        display: False or None for no bar, True for ``tqdm.tqdm``, or the
            name of a ``tqdm`` variant (``"notebook"`` for
            ``tqdm.tqdm_notebook``).
        total: the number of updates expected.
    """
    if not display:
        return _NoOpPBar()
    if tqdm is None:
        logger.warning(
            "You must install the tqdm library to use progress indicators."
        )
        return _NoOpPBar()
    if display is True:
        return tqdm.tqdm(total=total)
    return getattr(tqdm, f"tqdm_{display}")(total=total)
