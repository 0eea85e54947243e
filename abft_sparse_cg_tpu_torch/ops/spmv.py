"""SpMV with ABFT check/correct, plain PyTorch — the port's oracle.

Counterpart of ``abft_sparse_cg_tpu.ops.spmv`` for the DIA execution
layout (planes ``(D, R)``, w[r] = sum_d vals[d, r] * x[r + off_d]) and the
banded-ELL layout (planes ``(K, R)``, w[r] = sum over k < ell_len[r] of
vals[k, r] * x[g[k, r]]), with the same detect-fast / repair-rarely
structure (see that module's docstring):

  - ``fast(md, x) -> (w, trigger)``: w from the pre-derived value plane
    plus the cheap signals — per-element overall parity and per-8-row-
    block XOR checksums of the word planes (D x 8 or K x 8 words per
    block, padding slots included) against their encode-time values;
  - ``classify(md) -> (SpmvStats, MatrixDevice)``: the one-shot 7-mask
    locate / correct / double-bit classify, returning scrubbed planes
    with re-derived values, checksums and fold;
  - ``full(md, x) -> (w, SpmvStats)``: check-and-correct on read, the
    semantic oracle and the CLI's verification pass.

Stats are Python ints: the classify path runs once per fault and its
result decides host-side control flow anyway.  The flat and split
layouts are not ported yet (ROADMAP.md queue 1 item 9): the port's
``build_protected`` refuses the matrices that route there.

Out-of-range ELL gather indices (a flipped col bit in modes none and
constraints, where the ECC byte is not masked off) follow the jnp
oracle's gather: an index below zero wraps once by R, then the index is
clamped to [0, R).  The kernels do the same (ops.spmv_cuda).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ecc.codec import (
    ECC_MODES,
    MODES,
    check_and_correct,
    from_numpy_u32,
    narrow,
    parity32,
    widen,
)
from ..ecc.fold import fold_words
from ..ecc.layout import ECC_COL_MASK
from ..ecc.values import planes_to_value
from ..formats.protected import not_ported
from ..formats.reorder import inverse_permutation

__all__ = [
    "ERRCODES",
    "SpmvStats",
    "MatrixDevice",
    "SpmvImpl",
    "make_matrix_device",
    "make_spmv",
    "make_constraints_check",
    "not_ported",
    "take_clamped",
    "ell_product",
    "exec_gather_host",
]

# Error codes (0 = clean); the numbering, precedence and strings are the
# reference's (ops/spmv.py:73-120), re-declared because that module
# imports jax.
ERR_NONE = 0
ERR_SED = 1          # sed: parity failure
ERR_DOUBLE = 2       # secded: double-bit signature
ERR_COL_SIZE = 3     # constraints: col out of range
ERR_COL_ORDER = 4    # constraints: col order violated
ERR_ROW_SIZE = 5     # constraints (coo): row out of range
ERR_ROW_ORDER = 6    # constraints (coo): row order violated
ERR_BREAKDOWN = 7    # solver: p.A.p <= 0 or non-finite residual
ERR_PHANTOM = 8      # trigger twice in a row with nothing to repair

_COMMON = {
    ERR_NONE: None,
    ERR_SED: "[ECC] error detected at index {index}",
    ERR_DOUBLE: "[ECC] double-bit error detected",
    ERR_BREAKDOWN: "[CG] breakdown detected: p.A.p is not positive "
                   "(matrix is not SPD, or corrupted beyond detection)",
    ERR_PHANTOM: "[ECC] persistent error signal with no locatable fault "
                 "(kernel or hardware miscompute suspected)",
}
ERRCODES = {
    "csr": {
        **_COMMON,
        ERR_COL_SIZE: "column size constraint violated at index {index}",
        ERR_COL_ORDER: "column order constraint violated at index {index}",
        ERR_ROW_SIZE: "row size constraint violated for row {index}",
        ERR_ROW_ORDER: "row order constraint violated for row{index}",
    },
    "coo": {
        **_COMMON,
        ERR_COL_SIZE: "column size constraint violated for index {index}",
        ERR_COL_ORDER: "column index order violated at index {index}",
        ERR_ROW_SIZE: "row size constraint violated for index {index}",
        ERR_ROW_ORDER: "row index order violated at index {index}",
    },
}


class SpmvStats(NamedTuple):
    """Per-SpMV ABFT outcome (-1 slots mean 'none')."""

    errcode: int = ERR_NONE
    err_slot: int = -1             # flat exec slot of the first error
    corrected_count: int = 0
    first_cor_slot: int = -1
    first_cor_bit: int = -1

    @staticmethod
    def clean() -> "SpmvStats":
        return SpmvStats()

    def merge_first(self, new: "SpmvStats") -> "SpmvStats":
        """Accumulate across iterations, keeping first-seen events."""
        had_err = self.errcode != 0
        had_cor = self.first_cor_slot >= 0
        return SpmvStats(
            errcode=self.errcode if had_err else new.errcode,
            err_slot=self.err_slot if had_err else new.err_slot,
            corrected_count=self.corrected_count + new.corrected_count,
            first_cor_slot=(self.first_cor_slot if had_cor
                            else new.first_cor_slot),
            first_cor_bit=(self.first_cor_bit if had_cor
                           else new.first_cor_bit),
        )


class MatrixDevice(NamedTuple):
    """Device-resident DIA or ELL matrix: the fields the kernels and
    classify read.  Word-like planes hold uint32 bit patterns in int32
    tensors; (D, R) below reads (K, R) for ELL."""

    words: tuple                   # W x (D, R) int32, codeword-word order
    cksum: torch.Tensor            # (W, R/8) int32 encode-time block XORs
    values: torch.Tensor           # (D, R) compute-dtype value plane
    fold: torch.Tensor = None      # (D, R) int32 rotated fold (ECC modes)
    fold_ck: torch.Tensor = None   # (1, R/8) int32 fold of ``cksum``
    ell_len: torch.Tensor = None   # (R,) int32 valid slots per row
    gidx: torch.Tensor = None      # ELL under a permutation: (K, R) int32
    #                                exec-space gather indices, derived at
    #                                upload and again after a repair
    perm_pos: torch.Tensor = None  # (R,) int32 canonical -> exec row


class SpmvImpl(NamedTuple):
    """``full``/``fast``/``classify``/``fast_pw`` as in the reference."""

    full: object
    fast: object = None
    classify: object = None
    fast_pw: object = None


def exec_gather_host(mat) -> np.ndarray:
    """Exec-space gather plane of a permuted ELL matrix: the stored index
    (ECC byte masked in the ECC modes) clipped to [0, N) and mapped
    through the permutation (ops/spmv.py:242)."""
    pos = inverse_permutation(mat.perm)
    g = mat.ell[mat.ell_gather_word]
    if mat.mode in ECC_MODES and mat.ell_gather_word == "col":
        g = g & np.uint32(ECC_COL_MASK)
    return pos[np.clip(g.astype(np.int64), 0, mat.N - 1)].astype(np.int32)


def make_matrix_device(mat, dtype: torch.dtype,
                       device: torch.device) -> MatrixDevice:
    """Upload a ProtectedMatrix's DIA or ELL planes to ``device`` and
    derive the value plane (truncating f32 conversion for float32), the
    fold and its checksum baseline — all from the same words — and, for
    a permuted ELL matrix, the gather plane and ``perm_pos``, like the
    reference (ops/spmv.py:333-405)."""
    if mat.exec_kind not in ("dia", "ell"):
        raise not_ported(f"the {mat.exec_kind!r} execution layout", "9")
    names = mat.layout.word_names
    words = tuple(from_numpy_u32(mat.ell[n], device) for n in names)
    wide = [widen(w) for w in words]
    values = planes_to_value(wide[names.index("value_lo")],
                             wide[names.index("value_hi")], dtype)
    cksum = from_numpy_u32(mat.ell_cksum, device)
    fold = fold_ck = None
    if mat.mode in ECC_MODES:
        fold = narrow(fold_words(wide))
        fold_ck = narrow(fold_words([widen(c) for c in cksum]))[None, :]
    gidx = perm_pos = None
    if mat.perm is not None and mat.exec_kind == "ell":
        gidx = torch.from_numpy(exec_gather_host(mat)).to(device)
        pp = np.zeros(mat.R, dtype=np.int32)
        pp[: mat.N] = inverse_permutation(mat.perm)
        perm_pos = torch.from_numpy(pp).to(device)
    ell_len = torch.from_numpy(np.asarray(mat.ell_len, np.int32)).to(device)
    return MatrixDevice(words=words, cksum=cksum, values=values, fold=fold,
                        fold_ck=fold_ck, ell_len=ell_len, gidx=gidx,
                        perm_pos=perm_pos)


# --------------------------------------------------------------------------
# Signals and stats helpers (ops/spmv.py:408-471)
# --------------------------------------------------------------------------

def _xor_rows(t: torch.Tensor) -> torch.Tensor:
    """XOR-reduce the first axis."""
    out = t[0]
    for i in range(1, t.shape[0]):
        out = out ^ t[i]
    return out


def _fold_blocks(plane: torch.Tensor) -> torch.Tensor:
    """(D, R) plane -> (R/8,) XOR of each exact 8-row block."""
    return _xor_rows(_xor_rows(plane).reshape(-1, 8).T)


def _device_checksums(words) -> torch.Tensor:
    return torch.stack([_fold_blocks(p) for p in words])


def _cksum_mismatch(md: MatrixDevice, words_idx=None) -> torch.Tensor:
    """Any 8-row-block XOR differing from its encode-time value?"""
    bad = None
    for w, plane in enumerate(md.words):
        if words_idx is not None and w not in words_idx:
            continue
        m = _fold_blocks(plane) != md.cksum[w]
        bad = m if bad is None else (bad | m)
    return torch.any(bad)


def _parity_any(words) -> torch.Tensor:
    """Does any element fail overall parity?"""
    return torch.any(parity32(widen(_xor_rows(torch.stack(words)))) != 0)


def _first_slot(flags) -> tuple:
    hits = torch.nonzero(flags.reshape(-1))
    if hits.numel() == 0:
        return False, -1
    return True, int(hits[0, 0])


def _corrected_stats(flags, errcode: int, err_slot: int) -> SpmvStats:
    cor_any, cor_slot = _first_slot(flags["corrected"])
    cor_bit = (int(flags["corrected_bit"].reshape(-1)[cor_slot])
               if cor_any else -1)
    return SpmvStats(errcode=errcode, err_slot=err_slot,
                     corrected_count=int(flags["corrected"].sum()),
                     first_cor_slot=cor_slot, first_cor_bit=cor_bit)


def _raise_err(code, flags, errcode, err_slot):
    any_, slot = _first_slot(flags)
    if any_ and errcode == ERR_NONE:
        return code, slot
    return errcode, err_slot


def make_constraints_check(mat):
    """``check(md) -> SpmvStats`` running only the structural checks."""
    cfg = _config(mat, "constraints")

    def check(md: MatrixDevice) -> SpmvStats:
        errcode, err_slot = cfg.constraints(md, ERR_NONE, -1)
        return SpmvStats(errcode, err_slot)

    return check


def _config(mat, mode):
    if mat.exec_kind == "dia":
        return _DiaConfig(mat.fmt, mat.layout, mat.N, mat.dia_offsets)
    if mat.exec_kind == "ell":
        # The reference masks the ECC byte out of the column only in the
        # ECC modes; none/constraints gather with the raw column.
        return _EllConfig(mat.fmt, mat.layout, mat.N,
                          ecc_mode=mode in ECC_MODES)
    raise not_ported(f"the {mat.exec_kind!r} execution layout", "9")


def make_spmv(mat, dtype=torch.float32, mode: str = None) -> SpmvImpl:
    """The plain SpmvImpl of a matrix (counterpart of ops/spmv.py:538-728).
    ``x`` is an (R,) vector in ``dtype`` on the matrix's device."""
    mode = mat.mode if mode is None else mode
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    cfg = _config(mat, mode)

    def full(md: MatrixDevice, x):
        if mode == "none":
            return cfg.compute_w(md, None, x, dtype, values=md.values), \
                SpmvStats.clean()
        if mode == "constraints":
            errcode, err_slot = cfg.constraints(md, ERR_NONE, -1)
            w = cfg.compute_w(md, None, x, dtype, values=md.values)
            return w, SpmvStats(errcode, err_slot)
        checked, flags = check_and_correct(
            mode, [widen(w) for w in md.words], cfg.layout)
        errcode, err_slot = ERR_NONE, -1
        if mode == "sed":
            errcode, err_slot = _raise_err(ERR_SED, flags["detected"],
                                           errcode, err_slot)
        elif mode == "secded":
            errcode, err_slot = _raise_err(ERR_DOUBLE, flags["double"],
                                           errcode, err_slot)
        w = cfg.compute_w(md, checked, x, dtype)
        return w, _corrected_stats(flags, errcode, err_slot)

    if mode == "none":
        def fast_pw_none(md, x):
            w = cfg.compute_w(md, None, x, dtype, values=md.values)
            return w, torch.zeros((), dtype=torch.bool, device=x.device), \
                torch.sum(x * w)

        return SpmvImpl(full=full, fast_pw=fast_pw_none)

    if mode == "constraints":
        # Lazy schedule: the hot loop scans only the index-word checksums;
        # a trigger runs the structural checks once (ops/spmv.py:602-635).
        check_words = tuple(sorted({cfg.gather_w, cfg.col_w}))

        def fast_cons(md, x):
            w = cfg.compute_w(md, None, x, dtype, values=md.values)
            return w, _cksum_mismatch(md, check_words)

        def fast_pw_cons(md, x):
            w, trigger = fast_cons(md, x)
            return w, trigger, torch.sum(x * w)

        def classify_cons(md):
            errcode, err_slot = cfg.constraints(md, ERR_NONE, -1)
            md2 = md._replace(cksum=_device_checksums(md.words))
            return SpmvStats(errcode, err_slot), md2

        return SpmvImpl(full=full, fast=fast_cons, classify=classify_cons,
                        fast_pw=fast_pw_cons)

    def fast(md: MatrixDevice, x):
        w = cfg.compute_w(md, None, x, dtype, values=md.values)
        if mode == "sec7":
            trigger = _cksum_mismatch(md)        # no parity bit stored
        elif mode in ("sed", "sec8"):
            trigger = _parity_any(md.words)
        else:  # secded: parity for odd-weight, checksum for even-weight
            trigger = _parity_any(md.words) | _cksum_mismatch(md)
        return w, trigger

    def fast_pw(md, x):
        w, trigger = fast(md, x)
        return w, trigger, torch.sum(x * w)

    def classify(md: MatrixDevice):
        checked, flags = check_and_correct(
            mode, [widen(w) for w in md.words], cfg.layout)
        errcode, err_slot = ERR_NONE, -1
        if mode == "sed":
            errcode, err_slot = _raise_err(ERR_SED, flags["detected"],
                                           errcode, err_slot)
        elif mode == "secded":
            errcode, err_slot = _raise_err(ERR_DOUBLE, flags["double"],
                                           errcode, err_slot)
        stats = _corrected_stats(flags, errcode, err_slot)
        # Scrub: adopt the corrected planes and re-derive everything that
        # was derived from them (values, checksums, fold and its
        # baseline), so the resumed fast loop streams consistent data.
        words2 = tuple(narrow(c) for c in checked)
        cksum2 = _device_checksums(words2)
        fold2 = fold_ck2 = None
        if md.fold is not None:
            fold2 = narrow(fold_words(checked))
            fold_ck2 = narrow(fold_words([widen(c) for c in cksum2]))[None, :]
        gidx2 = md.gidx
        if gidx2 is not None:
            gidx2 = cfg.gather_indices(md, checked).to(torch.int32)
        md2 = md._replace(
            words=words2, cksum=cksum2,
            values=planes_to_value(checked[cfg.vlo_w], checked[cfg.vhi_w],
                                   dtype),
            fold=fold2, fold_ck=fold_ck2, gidx=gidx2)
        return stats, md2

    return SpmvImpl(full=full, fast=fast, classify=classify, fast_pw=fast_pw)


# --------------------------------------------------------------------------
# DIA: stencil over (D, R) planes
# --------------------------------------------------------------------------

def dia_product(values: torch.Tensor, offsets, x: torch.Tensor):
    """w[r] = sum_d values[d, r] * x[r + off_d], zero outside [0, R),
    summed in diagonal order d = 0..D-1 (the reference's order)."""
    R = x.shape[0]
    pad_lo = max(0, -min(offsets))
    pad_hi = max(0, max(offsets))
    xp = F.pad(x, (pad_lo, pad_hi)) if (pad_lo or pad_hi) else x
    w = torch.zeros_like(x)
    for d, off in enumerate(offsets):
        s = pad_lo + off
        w = w + values[d] * xp[s:s + R]
    return w


class _DiaConfig:
    def __init__(self, fmt, layout, N, offsets):
        self.fmt = fmt
        self.layout = layout
        self.N = N
        self.offsets = tuple(offsets)
        names = layout.word_names
        self.gather_w = names.index("row" if fmt == "coo" else "col")
        self.col_w = names.index("col")
        self.vlo_w = names.index("value_lo")
        self.vhi_w = names.index("value_hi")

    def compute_w(self, md, words, x, dtype, values=None):
        """``words``: widened planes (used only when ``values`` is None)."""
        vals = values if values is not None else planes_to_value(
            words[self.vlo_w], words[self.vhi_w], dtype)
        return dia_product(vals, self.offsets, x)

    def constraints(self, md, errcode, err_slot):
        """An occupied slot's index words must match its (diagonal, row)
        position (ops/spmv.py:773-803)."""
        words = md.words
        D, R = words[0].shape
        dev = words[0].device
        occupied = words[0] != 0
        for wd in words[1:]:
            occupied = occupied | (wd != 0)
        ridx = torch.arange(R, dtype=torch.int32, device=dev)[None, :]
        off = torch.tensor(self.offsets, dtype=torch.int32, device=dev)
        expect = ridx + off[:, None]
        g = words[self.gather_w]
        bad = occupied & (g != expect)
        gw = widen(g)
        size_code = ERR_ROW_SIZE if self.fmt == "coo" else ERR_COL_SIZE
        order_code = ERR_ROW_ORDER if self.fmt == "coo" else ERR_COL_ORDER
        errcode, err_slot = _raise_err(size_code, bad & (gw >= self.N),
                                       errcode, err_slot)
        errcode, err_slot = _raise_err(order_code, bad & (gw < self.N),
                                       errcode, err_slot)
        if self.fmt == "coo":
            c = words[self.col_w]
            badc = occupied & (c != ridx)
            cw = widen(c)
            errcode, err_slot = _raise_err(ERR_COL_SIZE, badc & (cw >= self.N),
                                           errcode, err_slot)
            errcode, err_slot = _raise_err(ERR_COL_ORDER, badc & (cw < self.N),
                                           errcode, err_slot)
        return errcode, err_slot


# --------------------------------------------------------------------------
# ELL: gather over transposed (K, R) planes
# --------------------------------------------------------------------------

def take_clamped(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``a[idx]`` with the jnp gather's out-of-range rule: a negative
    index wraps once by len(a), then every index is clamped into range."""
    n = a.shape[0]
    idx = idx.to(torch.int64)
    idx = torch.where(idx < 0, idx + n, idx).clamp_(0, n - 1)
    return a[idx]


def ell_product(values: torch.Tensor, gidx: torch.Tensor,
                ell_len: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """w[r] = sum over k < ell_len[r] of values[k, r] * x[gidx[k, r]],
    summed in slot order k = 0..K-1, one rounding per multiply and per
    add (the kernels' order, so their w is bit-identical)."""
    w = torch.zeros_like(x)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    for k in range(values.shape[0]):
        xk = take_clamped(x, gidx[k])
        w = w + torch.where(ell_len > k, values[k] * xk, zero)
    return w


class _EllConfig:
    def __init__(self, fmt, layout, N, ecc_mode=True):
        self.fmt = fmt
        self.layout = layout
        self.N = N
        names = layout.word_names
        self.gather_w = names.index("row" if fmt == "coo" else "col")
        self.col_w = names.index("col")
        self.vlo_w = names.index("value_lo")
        self.vhi_w = names.index("value_hi")
        self.ecc_gather_mask = ecc_mode and self.gather_w == self.col_w

    def gather_indices(self, md, words=None):
        """Exec-space gather indices (int32 semantics: a word with bit
        31 set is negative).  ``words=None`` means the resident planes,
        so the pre-derived ``md.gidx`` applies under a permutation;
        otherwise (corrected words) the index is mapped through
        ``perm_pos`` again (ops/spmv.py:829-843)."""
        if words is None:
            if md.gidx is not None:
                return md.gidx
            g = md.words[self.gather_w]
        else:
            g = words[self.gather_w]
        if self.ecc_gather_mask:
            g = g & int(ECC_COL_MASK)
        g = narrow(g)
        if md.perm_pos is not None:
            g = take_clamped(md.perm_pos, g)
        return g

    def compute_w(self, md, words, x, dtype, values=None):
        """``words``: widened planes (used when ``values`` is None: the
        check-and-correct oracle's corrected words)."""
        if values is not None:
            return ell_product(values, self.gather_indices(md), md.ell_len,
                               x)
        vals = planes_to_value(words[self.vlo_w], words[self.vhi_w], dtype)
        return ell_product(vals, self.gather_indices(md, words), md.ell_len,
                           x)

    def constraints(self, md, errcode, err_slot):
        """The reference's bounds and ordering checks over the valid
        slots (ops/spmv.py:855-877)."""
        words = md.words
        K, R = words[0].shape
        kio = torch.arange(K, dtype=torch.int32,
                           device=words[0].device)[:, None]
        valid = kio < md.ell_len[None, :]
        col = widen(words[self.col_w])
        errcode, err_slot = _raise_err(ERR_COL_SIZE, valid & (col >= self.N),
                                       errcode, err_slot)
        pair_valid = (kio[:-1] + 1) < md.ell_len[None, :]

        def pad(bad):  # (K-1, R) pair flags -> (K, R), last slot clean
            return torch.cat([bad, torch.zeros_like(bad[:1])])

        if self.fmt == "coo":
            row = widen(words[self.gather_w])
            errcode, err_slot = _raise_err(
                ERR_ROW_SIZE, valid & (row >= self.N), errcode, err_slot)
            bad = pad(pair_valid & (row[1:] <= row[:-1]))
            errcode, err_slot = _raise_err(ERR_ROW_ORDER, bad, errcode,
                                           err_slot)
            grp = torch.arange(R, dtype=torch.int64,
                               device=col.device)[None, :]
            errcode, err_slot = _raise_err(
                ERR_COL_ORDER, valid & (col != grp), errcode, err_slot)
        else:
            bad = pad(pair_valid & (col[1:] <= col[:-1]))
            errcode, err_slot = _raise_err(ERR_COL_ORDER, bad, errcode,
                                           err_slot)
        return errcode, err_slot
