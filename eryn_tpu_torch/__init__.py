"""eryn_tpu_torch: the PyTorch and CUDA port of eryn_tpu.

The port mirrors :mod:`eryn_tpu`'s modules and public names.  Its samplers
(the parallel-tempered stretch sampler, reversible jump with the red/blue
group stretch, the gradient-free moves: Metropolis-Hastings, Gaussian,
distribution draws, the group stretch, combinations, delayed rejection,
multiple try and model swaps, and in ``eryn_tpu_torch.moves`` the gradient
moves MALA, HMC and ChEES-HMC, differential evolution, walk, KDE, slice and
adaptive independence moves) run on an NVIDIA Hopper GPU through hand-written CUDA
kernels (``csrc/``): the stretch proposal, the tempered accept, the swap
cascade and its large-ensemble form, the group-stretch proposal and the
masked-uniform complement selection inside it.  Each kernel has a plain
PyTorch version, which is what runs for tensors on the CPU.
``eryn_tpu_torch.parallel.ParaEnsembleSampler`` runs many independent
ensembles in the same launches (``ParaState`` holds their state).
"""

__version__ = "0.1.0"

from .backends import Backend, DeviceBackend, HDFBackend, TempHDFBackend
from .ensemble import EnsembleSampler, walkers_independent
from .model import Model
from .moves import (
    BasicSymmetricModelSwapRJMove,
    CombineMove,
    DelayedRejection,
    DistributionGenerate,
    GaussianMove,
    GroupMove,
    GroupStretchMove,
    MHMove,
    ModelSwapRJMove,
    MTDistGenMove,
    MTDistGenMoveRJ,
    MultipleTryMove,
    MultipleTryMoveRJ,
    StretchMove,
    TemperatureControl,
    get_mt_computations,
    make_ladder,
)
from .prior import (
    LogUniformDistribution,
    MappedUniformDistribution,
    MultivariateNormalDistribution,
    NormalDistribution,
    ProbDistContainer,
    UniformDistribution,
    log_uniform,
    mvn_dist,
    normal_dist,
    uniform_dist,
)
from .state import Branch, BranchSupplemental, ParaState, State
from .utils.transform import TransformContainer

__all__ = [
    "Backend",
    "BasicSymmetricModelSwapRJMove",
    "Branch",
    "BranchSupplemental",
    "CombineMove",
    "DelayedRejection",
    "DeviceBackend",
    "DistributionGenerate",
    "EnsembleSampler",
    "GaussianMove",
    "GroupMove",
    "GroupStretchMove",
    "HDFBackend",
    "LogUniformDistribution",
    "MHMove",
    "MTDistGenMove",
    "MTDistGenMoveRJ",
    "MappedUniformDistribution",
    "Model",
    "ModelSwapRJMove",
    "MultipleTryMove",
    "MultipleTryMoveRJ",
    "MultivariateNormalDistribution",
    "NormalDistribution",
    "ParaState",
    "ProbDistContainer",
    "State",
    "StretchMove",
    "TemperatureControl",
    "TempHDFBackend",
    "TransformContainer",
    "UniformDistribution",
    "get_mt_computations",
    "log_uniform",
    "make_ladder",
    "mvn_dist",
    "normal_dist",
    "uniform_dist",
    "walkers_independent",
    "__version__",
]
