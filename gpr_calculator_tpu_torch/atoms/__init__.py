from .atoms import Atoms, Cell, CHEMICAL_SYMBOLS, ATOMIC_NUMBERS  # noqa
from .constraints import FixAtoms  # noqa
from .neighborlist import neighbor_pairs  # noqa
from .build import au_on_al100_images  # noqa
