"""Matrix formats: MM I/O, loader pipeline, protected containers.

The port's own copy of the JAX package's NumPy host layer
(``abft_sparse_cg_tpu.formats``), limited to what the DIA and ELL
execution layouts need; tests hold both builds byte-identical.
"""

from .loader import AssembledMatrix, assemble, load_matrix
from .mmio import MMHeader, read_coordinate, write_coordinate
from .protected import FORMATS, ProtectedMatrix, build_protected

__all__ = [
    "AssembledMatrix",
    "assemble",
    "load_matrix",
    "MMHeader",
    "read_coordinate",
    "write_coordinate",
    "FORMATS",
    "ProtectedMatrix",
    "build_protected",
]
