"""Backend protocol + the host-side result the CLI prints from.

Counterpart of ``abft_sparse_cg_tpu.backends.base`` (:17-289),
re-declared because that module imports jax (through ops.spmv).  The
message rendering is the reference's, verbatim; tests hold
``stats_to_messages`` and ``ERRCODES`` equal to the JAX ones.
``solve_refined`` is the ``--refine K`` loop: f32 (or the target's
dtype) inner solves around a binary64 true-residual restart on the host.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import List, Optional

import numpy as np

from ..ecc.layout import ECC_COL_MASK, OVERALL_PARITY_BIT
from ..ops.spmv import ERR_DOUBLE, ERR_SED, ERRCODES

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
    # The repaired matrix after a corrected solve (scrub.
    # scrubbed_from_device), when the backend was asked for it.
    scrubbed: Optional[object] = None

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

    @staticmethod
    def _host_residual_spmv(mat, x):
        """Binary64 A@x on the host through the ECC correct-on-read
        oracle, the refinement restart's residual SpMV (base.py:148):
        the protected planes are host-resident binary64 already.  Works
        on plain and split matrices (both expose the global canonical
        planes).  Returns (w, errcode, messages) as spmv_once does; the
        messages index canonical elements."""
        from ..ecc import codec
        from ..ecc.values import planes_to_f64_np

        words, flags = codec.check_and_correct_np(
            mat.mode, mat.words_list(), mat.layout)
        planes = dict(zip(mat.layout.word_names, words))
        cols = planes["col"]
        if mat.mode in codec.ECC_MODES:
            cols = cols & ECC_COL_MASK
        cols = np.clip(cols.astype(np.int64), 0, mat.N - 1)
        if mat.fmt == "csr":
            rows = np.repeat(np.arange(mat.N), np.diff(mat.row_ptr))
        else:
            rows = np.clip(planes["row"].astype(np.int64), 0, mat.N - 1)
        vals = planes_to_f64_np(planes["value_lo"], planes["value_hi"])
        w = np.zeros(mat.N)
        np.add.at(w, rows, vals * np.asarray(x, np.float64)[cols])
        errcode, err_slot = 0, -1
        if mat.mode == "sed" and flags["detected"].any():
            errcode = ERR_SED
            err_slot = int(np.flatnonzero(flags["detected"])[0])
        elif mat.mode == "secded" and flags["double"].any():
            errcode = ERR_DOUBLE
            err_slot = int(np.flatnonzero(flags["double"])[0])
        msgs = []
        cor = np.flatnonzero(flags["corrected"])
        if len(cor):
            idx = int(cor[0])
            bit = int(flags["corrected_bit"].reshape(-1)[idx])
            opb_global = mat.layout.col_word * 32 + OVERALL_PARITY_BIT
            if bit == opb_global:
                msgs.append(
                    f"[ECC] corrected overall parity bit at index {idx}")
            else:
                msgs.append(f"[ECC] corrected bit {bit} at index {idx}")
        if errcode != 0:
            template = ERRCODES[mat.fmt][errcode]
            msgs.append(template.format(index=err_slot)
                        if "{index}" in template else template)
        return w, errcode, msgs

    def solve_refined(self, mat, b: np.ndarray, max_itrs: int,
                      conv_threshold: float, refine: int,
                      **kw) -> HostResult:
        """Mixed-precision iterative refinement (``--refine K``,
        base.py:202): up to ``refine`` rounds of [inner CG on the current
        residual] + [binary64 true-residual restart on the host].  ``rr``
        is the true f64 squared residual norm, ``iterations`` sums the
        inner solves'.  A nonzero errcode of an inner solve or of the
        residual pass aborts with that result (fail-stop wins);
        correction lines of the residual pass are deduplicated against
        the inner solves' by their text."""
        inner_kw = dict(kw)
        inner_kw.pop("reps", None)
        x = np.zeros(mat.N, dtype=np.float64)
        b64 = np.asarray(b, dtype=np.float64)
        rhs = b64
        total_iters = 0
        total_solve = total_compile = 0.0
        msgs = []
        corrected = 0
        res = None
        rr = float(b64 @ b64)
        for _round in range(max(1, refine + 1)):
            if rr <= conv_threshold:
                break
            # Reduce the residual norm^2 by ~1e6 per round, floored at
            # the caller's target.
            inner_conv = max(conv_threshold, rr * 1e-6)
            res = self.solve(mat, rhs, max_itrs, inner_conv, reps=1,
                             **inner_kw)
            total_iters += res.iterations
            total_solve += res.solve_seconds
            total_compile += res.compile_seconds
            corrected += res.corrected_count
            msgs.extend(res.messages)
            if res.errcode != 0:
                return replace(res, iterations=total_iters, messages=msgs,
                               solve_seconds=total_solve,
                               compile_seconds=total_compile)
            x = x + np.asarray(res.x, dtype=np.float64)
            w, errcode, emsgs = self._host_residual_spmv(mat, x)
            fresh = [m for m in emsgs if m not in msgs]
            msgs.extend(fresh)
            corrected += sum(1 for m in fresh if "corrected bit" in m)
            if errcode != 0:
                return replace(res, x=x, errcode=errcode,
                               iterations=total_iters, messages=msgs,
                               corrected_count=corrected,
                               solve_seconds=total_solve,
                               compile_seconds=total_compile)
            r64 = b64 - np.asarray(w, dtype=np.float64)
            rr = float(r64 @ r64)
            rhs = r64
        if res is None:   # ||b||^2 already under the threshold
            return HostResult(x=x, iterations=0, rr=rr, errcode=0,
                              err_index=-1, corrected_count=0,
                              corrected_index=-1, corrected_bit=-1)
        return replace(res, x=x, rr=rr, iterations=total_iters,
                       messages=msgs, corrected_count=corrected,
                       solve_seconds=total_solve,
                       compile_seconds=total_compile)
