"""Diagnostics, hooks and parameter utilities of the port."""

from .periodic import PeriodicContainer
from .profiling import SegmentTimer, trace_profile
from .stopping import AutoCorrelationStop, SearchConvergeStopping, Stopping
from .updates import (
    AdjustStretchProposalScale,
    CompositeUpdate,
    Update,
    UpdateStep,
)
from .transform import TransformContainer
from .utility import (
    effective_sample_size,
    effective_sample_size_torch,
    get_acf,
    get_integrated_act,
    get_integrated_act_torch,
    groups_from_inds,
    groups_from_inds_torch,
    logsumexp,
    psrf,
    rank_normalized_rhat,
    rank_normalized_rhat_torch,
    replica_round_trips,
    stepping_stone_log_evidence,
    thermodynamic_integration_log_evidence,
)

__all__ = ["AdjustStretchProposalScale", "AutoCorrelationStop",
           "CompositeUpdate", "PeriodicContainer", "SearchConvergeStopping",
           "SegmentTimer", "Stopping", "TransformContainer", "Update",
           "UpdateStep",
           "effective_sample_size", "effective_sample_size_torch", "get_acf",
           "get_integrated_act", "get_integrated_act_torch",
           "groups_from_inds", "groups_from_inds_torch", "logsumexp", "psrf",
           "rank_normalized_rhat", "rank_normalized_rhat_torch",
           "replica_round_trips",
           "stepping_stone_log_evidence",
           "thermodynamic_integration_log_evidence", "trace_profile"]
