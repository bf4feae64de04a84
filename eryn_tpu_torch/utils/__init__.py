"""Diagnostics, hooks and parameter utilities of the port."""

from .periodic import PeriodicContainer
from .stopping import AutoCorrelationStop, SearchConvergeStopping, Stopping
from .updates import (
    AdjustStretchProposalScale,
    CompositeUpdate,
    Update,
    UpdateStep,
)
from .utility import get_acf, get_integrated_act, get_integrated_act_torch

__all__ = ["AdjustStretchProposalScale", "AutoCorrelationStop",
           "CompositeUpdate", "PeriodicContainer", "SearchConvergeStopping",
           "Stopping", "Update", "UpdateStep", "get_acf",
           "get_integrated_act", "get_integrated_act_torch"]
