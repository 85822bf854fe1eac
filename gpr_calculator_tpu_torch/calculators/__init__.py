from .base import Calculator  # noqa
from .emt import EMT  # noqa
from .lj import LJ, LennardJones  # noqa
