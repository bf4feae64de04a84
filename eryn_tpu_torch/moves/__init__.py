"""Proposals and parallel tempering of the port."""

from .move import EvalContext, Move, active_ndim, mh_accept
from .red_blue import RedBlueMove
from .stretch import StretchMove
from .tempering import TemperatureControl, make_ladder, tempered_log_likelihood

__all__ = [
    "EvalContext",
    "Move",
    "RedBlueMove",
    "StretchMove",
    "TemperatureControl",
    "active_ndim",
    "make_ladder",
    "mh_accept",
    "tempered_log_likelihood",
]
