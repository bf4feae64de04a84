"""Proposals and parallel tempering of the port."""

from .combine import CombineMove
from .delayedrejection import DelayedRejection
from .distgen import DistributionGenerate
from .distgenrj import DistributionGenerateRJ
from .gaussian import GaussianMove
from .group import GroupMove
from .groupstretch import GroupStretchMove
from .mh import MHMove
from .modelswap import BasicSymmetricModelSwapRJMove, ModelSwapRJMove
from .move import EvalContext, Move, active_ndim, mh_accept
from .mtdistgen import MTDistGenMove
from .mtdistgenrj import MTDistGenMoveRJ
from .multipletry import MultipleTryMove, MultipleTryMoveRJ, get_mt_computations
from .rbgroupstretch import RedBlueGroupStretchMove
from .red_blue import RedBlueMove
from .rj import ReversibleJumpMove
from .stretch import StretchMove
from .tempering import TemperatureControl, make_ladder, tempered_log_likelihood

__all__ = [
    "BasicSymmetricModelSwapRJMove",
    "CombineMove",
    "DelayedRejection",
    "DistributionGenerate",
    "DistributionGenerateRJ",
    "EvalContext",
    "GaussianMove",
    "GroupMove",
    "GroupStretchMove",
    "MHMove",
    "MTDistGenMove",
    "MTDistGenMoveRJ",
    "ModelSwapRJMove",
    "Move",
    "MultipleTryMove",
    "MultipleTryMoveRJ",
    "RedBlueGroupStretchMove",
    "RedBlueMove",
    "ReversibleJumpMove",
    "StretchMove",
    "TemperatureControl",
    "active_ndim",
    "get_mt_computations",
    "make_ladder",
    "mh_accept",
    "tempered_log_likelihood",
]
