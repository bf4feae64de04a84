"""Proposals and parallel tempering of the port."""

from .aimh import AIMHMove
from .chees import ChEESHMCMove
from .combine import CombineMove
from .de import DEMove, DESnookerMove
from .delayedrejection import DelayedRejection
from .distgen import DistributionGenerate
from .distgenrj import DistributionGenerateRJ
from .gaussian import GaussianMove
from .group import GroupMove
from .hmc import HMCMove
from .kde import KDEMove
from .mala import MALAMove
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
from .slice import SliceMove
from .stretch import StretchMove
from .tempering import TemperatureControl, make_ladder, tempered_log_likelihood
from .walk import WalkMove

__all__ = [
    "AIMHMove",
    "BasicSymmetricModelSwapRJMove",
    "ChEESHMCMove",
    "CombineMove",
    "DEMove",
    "DESnookerMove",
    "DelayedRejection",
    "DistributionGenerate",
    "DistributionGenerateRJ",
    "EvalContext",
    "GaussianMove",
    "GroupMove",
    "GroupStretchMove",
    "HMCMove",
    "KDEMove",
    "MALAMove",
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
    "SliceMove",
    "StretchMove",
    "TemperatureControl",
    "WalkMove",
    "active_ndim",
    "get_mt_computations",
    "make_ladder",
    "mh_accept",
    "tempered_log_likelihood",
]
