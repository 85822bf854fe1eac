from .gp import GP  # noqa
from .kernels import RBF, Dot  # noqa
