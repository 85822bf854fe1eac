"""gpr_calculator_tpu_torch -- the on-the-fly GPR force field in PyTorch.

Port of ``gpr_calculator_tpu`` (JAX) for one NVIDIA H100: the SO(3)
descriptor, the RBF and Dot many-body covariances with hand-written CUDA
K_FF/K_EF kernels (and the RBF's fused dK/dgamma passes), the
Cholesky-factored GP with analytic-gradient hyperparameter training, the
uncertainty-dispatched hybrid calculator and the on-the-fly NEB.
Imports PyTorch, never JAX.
"""
from . import config  # noqa: F401  (sets the float32 matmul precision)

from .models.gp import GP  # noqa: E402
from .models.kernels import RBF, Dot  # noqa: E402
from .ops.so3 import SO3  # noqa: E402
from .calculator import GPR  # noqa: E402
from .atoms import Atoms, FixAtoms, au_on_al100_images  # noqa: E402
from .calculators import EMT  # noqa: E402
from .neb import get_images, neb_calc  # noqa: E402

__version__ = "0.1.0"
__all__ = ["GP", "GPR", "SO3", "RBF", "Dot", "Atoms", "FixAtoms", "EMT",
           "au_on_al100_images", "neb_calc", "get_images"]
