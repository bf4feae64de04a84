"""Batched independent ensembles (port of :mod:`eryn_tpu.parallel`; the
device meshes of ``eryn_tpu.parallel.mesh`` are not ported)."""

from .para import ParaEnsembleSampler

__all__ = ["ParaEnsembleSampler"]
