"""Diagnostics of the port."""

from .utility import get_acf, get_integrated_act, get_integrated_act_torch

__all__ = ["get_acf", "get_integrated_act", "get_integrated_act_torch"]
