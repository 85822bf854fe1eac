from .gp import GP, CUR  # noqa
from .kernels import RBF, Dot  # noqa
