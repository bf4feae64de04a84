"""Diagnostics and parameter utilities of the port."""

from .periodic import PeriodicContainer
from .utility import get_acf, get_integrated_act, get_integrated_act_torch

__all__ = ["PeriodicContainer", "get_acf", "get_integrated_act",
           "get_integrated_act_torch"]
