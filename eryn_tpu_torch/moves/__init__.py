"""Proposals and parallel tempering of the port."""

from .distgenrj import DistributionGenerateRJ
from .move import EvalContext, Move, active_ndim, mh_accept
from .rbgroupstretch import RedBlueGroupStretchMove
from .red_blue import RedBlueMove
from .rj import ReversibleJumpMove
from .stretch import StretchMove
from .tempering import TemperatureControl, make_ladder, tempered_log_likelihood

__all__ = [
    "DistributionGenerateRJ",
    "EvalContext",
    "Move",
    "RedBlueGroupStretchMove",
    "RedBlueMove",
    "ReversibleJumpMove",
    "StretchMove",
    "TemperatureControl",
    "active_ndim",
    "make_ladder",
    "mh_accept",
    "tempered_log_likelihood",
]
