from .base import Calculator  # noqa
from .emt import EMT  # noqa
