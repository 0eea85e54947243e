"""A vector row-sharded over a mesh: one tensor per shard, on its device.

Counterpart of a ``jax.Array`` laid out ``P("shard")`` over the 1-D mesh
of ``abft_sparse_cg_tpu.parallel.sharded``.  The loops of solver.cg,
solver.pipelined and solver.checkpoint run on it as they stand: a
``ShardedVector`` takes part in torch's function dispatch
(``__torch_function__``), so the same expressions that update a whole
(R,) tensor update one of these shard by shard:

  - arithmetic with another sharded vector of the same partition, a
    Python number or a 0-d tensor (alpha, beta: on the first shard's
    device, copied to each shard's) runs per shard, on its device;
  - ``torch.sum`` (so ``ops.blas1.dot``) is the per-shard partial sums
    added in shard order on the first shard's device: the ``lax.psum``
    of sharded_kernel.py:190-191;
  - ``torch.zeros_like``, ``torch.clone`` and ``torch.isfinite`` keep the
    partition, ``torch.equal`` compares shard by shard;
  - ``cpu()`` (and ``numpy()``) gathers the rows on the host in execution
    order; ``scatter`` puts a whole vector onto the shards.

Anything else raises ``TypeError``: a whole-vector operation reaching a
sharded vector is a fault of the caller, not something to gather for.
"""

from __future__ import annotations

import operator

import numpy as np
import torch

__all__ = ["ShardedVector"]

# Per-shard functions of torch's dispatch, by name: the binary operators
# reach ``__torch_function__`` as TensorBase methods when a tensor is the
# left operand (``alpha * p``).
_ELEMENTWISE = {"add", "sub", "mul", "isfinite", "clone", "zeros_like",
                "__add__", "__radd__", "__sub__", "__rsub__", "__mul__",
                "__rmul__"}


class ShardedVector:
    """``parts``: one 1-D tensor per shard, in shard order, each on its
    shard's device; every shard holds the same number of rows."""

    def __init__(self, parts):
        self.parts = tuple(parts)
        shapes = {tuple(p.shape) for p in self.parts}
        if len(shapes) != 1 or len(next(iter(shapes))) != 1:
            raise ValueError(f"shards of shapes {sorted(shapes)}: expected "
                             "1-D shards of one length")

    # -- placement --------------------------------------------------------

    @classmethod
    def scatter(cls, v, devices) -> "ShardedVector":
        """The rows of ``v`` (a tensor or a NumPy vector, R a multiple of
        the shard count) split into ``len(devices)`` shards, each copied
        onto its device."""
        v = torch.as_tensor(v)
        n = len(devices)
        if v.dim() != 1 or v.shape[0] % n:
            raise ValueError(f"{tuple(v.shape)} rows do not split into {n} "
                             "shards")
        R_loc = v.shape[0] // n
        return cls(v[s * R_loc:(s + 1) * R_loc].to(dev, copy=True)
                   for s, dev in enumerate(devices))

    def gather(self, device) -> torch.Tensor:
        """The whole vector on ``device``, rows in shard order."""
        return torch.cat([p.to(device) for p in self.parts])

    def cpu(self) -> torch.Tensor:
        return self.gather(torch.device("cpu"))

    def numpy(self) -> np.ndarray:
        return self.cpu().numpy()

    def detach(self) -> "ShardedVector":
        return ShardedVector(p.detach() for p in self.parts)

    @property
    def devices(self) -> tuple:
        return tuple(p.device for p in self.parts)

    @property
    def device(self) -> torch.device:
        """The first shard's device, where the scalars of a solve live."""
        return self.parts[0].device

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    @property
    def shape(self) -> torch.Size:
        return torch.Size([len(self.parts) * self.parts[0].shape[0]])

    def __repr__(self) -> str:
        return (f"ShardedVector({len(self.parts)} x {self.parts[0].shape[0]} "
                f"rows, {self.dtype}, on {list(map(str, self.devices))})")

    # -- arithmetic ---------------------------------------------------------

    def _map(self, fn, *args):
        """``fn`` applied shard by shard; ``args`` are sharded vectors of
        this partition, numbers or 0-d tensors (copied to each shard's
        device)."""
        for a in args:
            if isinstance(a, ShardedVector) and (
                    len(a.parts) != len(self.parts)
                    or a.parts[0].shape != self.parts[0].shape):
                raise ValueError(f"{a!r} and {self!r}: other partitions")
            if isinstance(a, torch.Tensor) and a.dim() != 0:
                raise TypeError(f"a {tuple(a.shape)} tensor and {self!r}: "
                                "only 0-d tensors mix with a sharded vector")

        def arg(a, s, dev):
            if isinstance(a, ShardedVector):
                return a.parts[s]
            if isinstance(a, torch.Tensor):
                return a.to(dev, non_blocking=True)
            return a

        return ShardedVector(
            fn(*(arg(a, s, p.device) for a in args))
            for s, p in enumerate(self.parts))

    def __add__(self, o):
        return self._map(operator.add, self, o)

    def __radd__(self, o):
        return self._map(operator.add, o, self)

    def __sub__(self, o):
        return self._map(operator.sub, self, o)

    def __rsub__(self, o):
        return self._map(operator.sub, o, self)

    def __mul__(self, o):
        return self._map(operator.mul, self, o)

    def __rmul__(self, o):
        return self._map(operator.mul, o, self)

    def sum(self) -> torch.Tensor:
        """The partial sums of the shards added in shard order on the
        first shard's device (``lax.psum``)."""
        dev = self.device
        total = torch.sum(self.parts[0])
        for p in self.parts[1:]:
            total = total + torch.sum(p).to(dev)
        return total

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        first = next(a for a in args if isinstance(a, ShardedVector))
        if name == "sum" and len(args) == 1 and not kwargs:
            return first.sum()
        if name == "equal" and len(args) == 2:
            a, b = args
            return (isinstance(a, ShardedVector)
                    and isinstance(b, ShardedVector)
                    and len(a.parts) == len(b.parts)
                    and all(torch.equal(x, y)
                            for x, y in zip(a.parts, b.parts)))
        if name in _ELEMENTWISE and not kwargs:
            return first._map(func, *args)
        raise TypeError(f"{name or func} has no sharded form: gather the "
                        "vector first (ShardedVector.gather)")
