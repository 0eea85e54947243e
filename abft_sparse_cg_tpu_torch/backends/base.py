"""Backend protocol + the host-side result the CLI prints from.

Counterpart of ``abft_sparse_cg_tpu.backends.base`` (:17-146),
re-declared because that module imports jax (through ops.spmv).  The
message rendering is the reference's, verbatim; tests hold
``stats_to_messages`` and ``ERRCODES`` equal to the JAX ones.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..ecc.layout import OVERALL_PARITY_BIT

from ..ops.spmv import ERRCODES

__all__ = ["HostResult", "Backend", "slot_to_canonical", "stats_to_messages"]


@dataclass
class HostResult:
    """Solve outcome, host types only."""

    x: np.ndarray
    iterations: int
    rr: float
    errcode: int
    err_index: int              # canonical element index (-1 if none)
    corrected_count: int
    corrected_index: int
    corrected_bit: int
    messages: List[str] = field(default_factory=list)
    solve_seconds: float = 0.0
    compile_seconds: float = 0.0
    rr_trace: Optional[np.ndarray] = None

    @property
    def failed(self) -> bool:
        return self.errcode != 0


def slot_to_canonical(mat) -> np.ndarray:
    """Inverse of ell_slot: flat exec slot -> canonical element index."""
    inv = np.full(mat.exec_size, -1, dtype=np.int64)
    inv[mat.ell_slot] = np.arange(mat.nnz, dtype=np.int64)
    return inv


def stats_to_messages(mat, errcode, err_slot, cor_slot, cor_bit,
                      r_dev: int = None):
    """Render ABFT events with the reference's exact stdout strings
    (CSR/CPUContext.cpp:233,278,324,331,398); exec slots map back to the
    canonical element index the reference prints."""
    if hasattr(mat, "slot_to_canonical"):
        inv = mat.slot_to_canonical()
    else:
        inv = slot_to_canonical(mat)

    def canon_slot(slot):
        if r_dev is None or r_dev == mat.R or slot < 0:
            return slot
        k, r = divmod(slot, r_dev)
        return k * mat.R + r if r < mat.R else -1

    err_slot = canon_slot(err_slot)
    cor_slot = canon_slot(cor_slot)
    msgs = []
    err_index = -1
    opb_global = mat.layout.col_word * 32 + OVERALL_PARITY_BIT

    if cor_slot >= 0:
        idx = int(inv[cor_slot])
        if cor_bit == opb_global:
            msgs.append(f"[ECC] corrected overall parity bit at index {idx}")
        else:
            msgs.append(f"[ECC] corrected bit {cor_bit} at index {idx}")

    if errcode != 0:
        template = ERRCODES[mat.fmt][errcode]
        if err_slot >= 0:
            err_index = int(inv[err_slot])
        if "{index}" in template:
            msgs.append(template.format(index=err_index))
        else:
            msgs.append(template)  # double-bit / breakdown: no index

    return msgs, err_index


class Backend:
    """Interface every target implements (duck-typed; see registry)."""

    target = "?"

    def solve(self, mat, b: np.ndarray, max_itrs: int, conv_threshold: float,
              dtype: str = "auto",
              reps: int = 0) -> HostResult:
        raise NotImplementedError

    def spmv_once(self, mat, x: np.ndarray, dtype: str = "auto"):
        """One A@x for the CLI's final verification (cg.cpp:127-144):
        ``(w, errcode, messages)``."""
        raise NotImplementedError
