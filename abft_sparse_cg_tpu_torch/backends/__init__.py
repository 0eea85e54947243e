"""Backend registry + targets, in the JAX package's order (portable,
native, accelerator; backends/__init__.py:12-22): ``torch`` (plain
PyTorch on the CPU), ``cpu`` (the native C++/OpenMP library; registered
where its source and a compiler exist, built at first use), then
``cuda`` (the CUDA kernels; registered only where a card is present)."""

from . import registry
from .registry import available, create, list_contexts, register

from . import torch_backend  # noqa: F401  (registers "torch")
from . import cpp_backend  # noqa: F401  (registers "cpu" if buildable)
from . import cuda_backend  # noqa: F401  (registers "cuda" if available)

__all__ = ["registry", "available", "create", "list_contexts", "register"]
