"""Scaling over several ensembles and several devices: batched independent
ensembles, device meshes and the sharded sampler step (port of
:mod:`eryn_tpu.parallel`)."""

from .comm_audit import audit_sampler_comm, collective_stats
from .mesh import (
    constrain_state,
    make_group_mesh,
    make_mesh,
    mesh_of_state,
    shard_state,
    sharding_for_state,
)
from .para import ParaEnsembleSampler

__all__ = [
    "make_mesh",
    "make_group_mesh",
    "shard_state",
    "sharding_for_state",
    "mesh_of_state",
    "constrain_state",
    "audit_sampler_comm",
    "collective_stats",
    "ParaEnsembleSampler",
]
