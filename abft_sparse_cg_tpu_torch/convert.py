"""Carry device state across from the JAX package.

For this system the "parameters" are the device matrix and the solver
state.  These two functions build the port's ``MatrixDevice`` and
``CGState`` from the JAX package's fields given as NumPy arrays (for
example ``{k: np.asarray(v) for k, v in jax_md._asdict().items()}``),
so classify and a resumed solve can run on identical inputs in both
packages.  The target ``device`` is always given.
"""

from __future__ import annotations

import numpy as np
import torch

from .ecc.codec import from_numpy_u32
from .ops.spmv import MatrixDevice, SpmvStats
from .solver.cg import CGState

__all__ = ["matrix_device_from_numpy", "cg_state_from_numpy"]


def _u32(a, device):
    return None if a is None else from_numpy_u32(np.asarray(a), device)


def _i32(a, device):
    return None if a is None else torch.tensor(
        np.asarray(a, dtype=np.int32), device=device)


def matrix_device_from_numpy(fields, device: torch.device) -> MatrixDevice:
    """The DIA and ELL fields of a JAX ``MatrixDevice``: ``words``
    (sequence of uint32 planes), ``cksum``, ``values``, ``fold``,
    ``fold_ck``, ``ell_len``, ``gidx``, ``perm_pos``; the value plane
    keeps its dtype."""
    values = np.asarray(fields["values"])
    return MatrixDevice(
        words=tuple(_u32(w, device) for w in fields["words"]),
        cksum=_u32(fields["cksum"], device),
        values=torch.tensor(values, device=device),
        fold=_u32(fields.get("fold"), device),
        fold_ck=_u32(fields.get("fold_ck"), device),
        ell_len=_i32(fields.get("ell_len"), device),
        gidx=_i32(fields.get("gidx"), device),
        perm_pos=_i32(fields.get("perm_pos"), device),
    )


def cg_state_from_numpy(fields, device: torch.device) -> CGState:
    """A JAX ``CGState``'s fields: itr, x, r, p, rr, rz, trace, and
    ``stats`` as the five SpmvStats integers (tuple or mapping); the
    vectors keep their dtype."""

    def vec(a):
        return torch.tensor(np.asarray(a), device=device)

    st = fields["stats"]
    if isinstance(st, dict):
        st = [st[k] for k in SpmvStats._fields]
    return CGState(
        itr=int(fields["itr"]),
        x=vec(fields["x"]), r=vec(fields["r"]), p=vec(fields["p"]),
        rr=vec(fields["rr"]), rz=vec(fields["rz"]),
        stats=SpmvStats(*(int(np.asarray(v)) for v in st)),
        trace=vec(fields["trace"]),
    )
