"""SpMV with ABFT check/correct, plain PyTorch — the port's oracle.

Counterpart of ``abft_sparse_cg_tpu.ops.spmv`` for every execution
layout, with the same detect-fast / repair-rarely structure (see that
module's docstring):

  - DIA, planes ``(D, R)``: w[r] = sum_d vals[d, r] * x[r + off_d];
  - banded ELL, planes ``(K, R)``: w[r] = sum over k < ell_len[r] of
    vals[k, r] * x[g[k, r]];
  - FLAT, 1-D exec-sorted planes ``(E,)``: w[r] = sum over the slots of
    row r of vals[j] * x[g[j]], the row's slots found through a row
    pointer derived once at upload from the clean ``__flat_group__``;
    a bordered-split tail with a ``dense_plan`` computes the same w from
    span-densified ``dense_td``/``dense_tb`` arrays instead;
  - split composites: ``combine_impls`` of the two parts, part-b exec
    slots offset past part a's.

  - ``fast(md, x) -> (w, trigger)``: w from the pre-derived value plane
    plus the cheap signals — per-element overall parity and per-8-row-
    block (flat: 8-slot block) XOR checksums of the word planes against
    their encode-time values;
  - ``classify(md) -> (SpmvStats, MatrixDevice)``: the one-shot 7-mask
    locate / correct / double-bit classify, returning scrubbed planes
    with every derived plane (values, checksums, fold, gather plane,
    dense tail arrays) re-derived from the scrubbed words;
  - ``full(md, x) -> (w, SpmvStats)``: check-and-correct on read, the
    semantic oracle and the CLI's verification pass.

Stats are Python ints: the classify path runs once per fault and its
result decides host-side control flow anyway.

Out-of-range gather indices (a flipped col bit in modes none and
constraints, where the ECC byte is not masked off) follow the jnp
oracle's gather on the ELL and flat layouts alike: an index below zero
wraps once by R, then the index is clamped to [0, R).  The kernels do
the same (ops.spmv_cuda).
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
from ..tracing import span

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
    "window_positions",
    "ell_product",
    "flat_product",
    "flat_row_blocks",
    "FLAT_TILE",
    "FLAT_RUN_ROWS",
    "exec_gather_host",
    "combine_impls",
    "dense_tail_plan",
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
    """Device-resident DIA, ELL or flat matrix: the fields the kernels
    and classify read.  Word-like planes hold uint32 bit patterns in
    int32 tensors; (D, R) below reads (K, R) for ELL and (E,) for flat,
    and R/8 reads E/8 for flat.  A split matrix uploads as a (main,
    tail) pair of these."""

    words: tuple                   # W x (D, R) int32, codeword-word order
    cksum: torch.Tensor            # (W, R/8) int32 encode-time block XORs
    values: torch.Tensor           # (D, R) compute-dtype value plane
    fold: torch.Tensor = None      # (D, R) int32 rotated fold (ECC modes)
    fold_ck: torch.Tensor = None   # (1, R/8) int32 fold of ``cksum``
    ell_len: torch.Tensor = None   # (R,) int32 valid slots per row
    gidx: torch.Tensor = None      # ELL/flat under a permutation: int32
    #                                exec-space gather indices, derived at
    #                                upload and again after a repair
    perm_pos: torch.Tensor = None  # (R,) int32 canonical -> exec row
    flat_group: torch.Tensor = None  # flat: (E,) int32 output row per slot
    row_ptr: torch.Tensor = None   # flat: (R+1,) int32 first slot of each
    #                                row, from the clean flat_group (the
    #                                port's addition: kernel E's rows)
    flat_plan: torch.Tensor = None  # flat: (B, 4) int32 kernel E's row
    #                                blocks (flat_row_blocks), from row_ptr
    flat_sync: torch.Tensor = None  # flat: (B,) int32 zeros, kernel E's
    #                                long-row chunk flags (zero between
    #                                calls: the kernel clears them)
    dense_td: torch.Tensor = None  # dense-plan tails: (T, S) span-
    #                                densified outlier rows
    dense_tb: torch.Tensor = None  # (T, S) span-densified transpose
    #                                images (ops/spmv.py:177-186)


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


def perm_positions(mat, device) -> torch.Tensor:
    """``perm_pos`` of a permuted matrix: (R,) int32 canonical -> exec
    row, zero on pad rows."""
    pp = np.zeros(mat.R, dtype=np.int32)
    pp[: mat.N] = inverse_permutation(mat.perm)
    return torch.from_numpy(pp).to(device)


@span("ops.upload")
def make_matrix_device(mat, dtype: torch.dtype, device: torch.device,
                       rows: tuple = None):
    """Upload a ProtectedMatrix's exec planes to ``device`` and derive
    the value plane (truncating f32 conversion for float32), the fold
    and its checksum baseline — all from the same words — and, under a
    permutation, the gather plane and ``perm_pos``; for a flat matrix
    also ``flat_group``, the row pointer, kernel E's row-block plan and
    a dense-plan tail's
    ``dense_td``/``dense_tb``, like the reference (ops/spmv.py:333-405).
    A split matrix uploads as a (main, tail) pair.

    ``rows`` (lo, hi), multiples of 8, of a DIA or ELL matrix: only those
    exec rows of every plane and their checksum blocks, one shard's
    (parallel.sharded), each derived plane equal to those rows of the
    whole upload's; the gather plane keeps its global indices and no
    ``perm_pos`` is uploaded (the repair assembles the whole planes)."""
    if mat.exec_kind == "split":
        return (make_matrix_device(mat.main, dtype, device),
                make_matrix_device(mat.tail, dtype, device))
    rs = cs = slice(None)
    if rows is not None:
        lo, hi = rows
        if mat.exec_kind == "flat" or lo % 8 or hi % 8:
            raise ValueError(f"rows {rows} of a {mat.exec_kind} matrix")
        rs, cs = slice(lo, hi), slice(lo // 8, hi // 8)

    def host(a, sl):
        # a shard's rows as an array of its own (never a view of the
        # whole plane: on the CPU the upload shares its memory)
        return a if rows is None else np.array(a[..., sl])

    names = mat.layout.word_names
    words = tuple(from_numpy_u32(host(mat.ell[n], rs), device)
                  for n in names)
    wide = [widen(w) for w in words]
    values = planes_to_value(wide[names.index("value_lo")],
                             wide[names.index("value_hi")], dtype)
    cksum = from_numpy_u32(host(mat.ell_cksum, cs), device)
    fold = fold_ck = None
    if mat.mode in ECC_MODES:
        fold = narrow(fold_words(wide))
        fold_ck = narrow(fold_words([widen(c) for c in cksum]))[None, :]
    gidx = perm_pos = None
    if mat.perm is not None and mat.exec_kind in ("ell", "flat"):
        gidx = torch.from_numpy(host(exec_gather_host(mat), rs)).to(device)
        if rows is None:
            perm_pos = perm_positions(mat, device)
    ell_len = torch.from_numpy(
        np.asarray(host(mat.ell_len, rs), np.int32)).to(device)
    md = MatrixDevice(words=words, cksum=cksum, values=values, fold=fold,
                      fold_ck=fold_ck, ell_len=ell_len, gidx=gidx,
                      perm_pos=perm_pos)
    if mat.exec_kind != "flat":
        return md
    grp = np.asarray(mat.ell["__flat_group__"], np.int32)
    row_ptr = np.searchsorted(grp[: mat.nnz], np.arange(mat.R + 1),
                              side="left").astype(np.int32)
    if mat.exec_size != -(-mat.nnz // 8) * 8:
        # kernel E's blocks check the signals of [0, ceil8(nnz)) only
        raise ValueError(f"flat planes of {mat.exec_size} slots for "
                         f"{mat.nnz} entries: expected nnz rounded up to 8")
    plan = flat_row_blocks(row_ptr)
    md = md._replace(
        flat_group=torch.from_numpy(grp).to(device),
        row_ptr=torch.from_numpy(row_ptr).to(device),
        flat_plan=torch.from_numpy(plan).to(device),
        flat_sync=torch.zeros(len(plan), dtype=torch.int32, device=device))
    if mat.dense_plan is not None:
        cfg = _config(mat, mat.mode)
        td, tb = cfg.dense_arrays(wide, values, md.flat_group, perm_pos)
        md = md._replace(dense_td=td, dense_tb=tb)
    return md


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
    """(D, R) plane -> (R/8,) XOR of each exact 8-row block; a flat
    (E,) plane -> (E/8,) XOR of each 8-slot block."""
    folded = plane if plane.dim() == 1 else _xor_rows(plane)
    return _xor_rows(folded.reshape(-1, 8).T)


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
    # The reference masks the ECC byte out of the column only in the ECC
    # modes; none/constraints gather with the raw column.
    if mat.exec_kind == "ell":
        return _EllConfig(mat.fmt, mat.layout, mat.N,
                          ecc_mode=mode in ECC_MODES)
    if mat.exec_kind == "flat":
        return _FlatConfig(mat.fmt, mat.layout, mat.N, mat.nnz, mat.R,
                           ecc_mode=mode in ECC_MODES,
                           dense_plan=mat.dense_plan)
    raise ValueError(f"no config for a {mat.exec_kind!r} matrix")


def combine_impls(impl_a: SpmvImpl, impl_b: SpmvImpl,
                  slot_offset: int) -> SpmvImpl:
    """Compose two part implementations into one (ops/spmv.py:495):
    w = w_a + w_b, triggers OR, stats merged with part-b exec slots
    offset past part a's exec size so the host routes them back; the
    device matrix is the (part a, part b) pair."""

    def shift(st: SpmvStats) -> SpmvStats:
        return st._replace(
            err_slot=(st.err_slot + slot_offset if st.err_slot >= 0
                      else st.err_slot),
            first_cor_slot=(st.first_cor_slot + slot_offset
                            if st.first_cor_slot >= 0
                            else st.first_cor_slot))

    full = fast = fast_pw = classify = None
    if impl_a.full is not None and impl_b.full is not None:
        def full(md, x):
            wa, sa = impl_a.full(md[0], x)
            wb, sb = impl_b.full(md[1], x)
            return wa + wb, sa.merge_first(shift(sb))

    if impl_a.fast is not None and impl_b.fast is not None:
        def fast(md, x):
            wa, ta = impl_a.fast(md[0], x)
            wb, tb = impl_b.fast(md[1], x)
            return wa + wb, ta | tb
    if impl_a.fast_pw is not None and impl_b.fast_pw is not None:
        def fast_pw(md, x):
            wa, ta, pa = impl_a.fast_pw(md[0], x)
            wb, tb, pb = impl_b.fast_pw(md[1], x)
            return wa + wb, ta | tb, pa + pb
    if impl_a.classify is not None and impl_b.classify is not None:
        def classify(md):
            sa, mda = impl_a.classify(md[0])
            sb, mdb = impl_b.classify(md[1])
            return sa.merge_first(shift(sb)), (mda, mdb)

    return SpmvImpl(full=full, fast=fast, classify=classify,
                    fast_pw=fast_pw)


def make_spmv(mat, dtype=torch.float32, mode: str = None) -> SpmvImpl:
    """The plain SpmvImpl of a matrix (counterpart of ops/spmv.py:538-728).
    ``x`` is an (R,) vector in ``dtype`` on the matrix's device."""
    mode = mat.mode if mode is None else mode
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    if mat.exec_kind == "split":
        return combine_impls(make_spmv(mat.main, dtype, mode),
                             make_spmv(mat.tail, dtype, mode),
                             mat.main.exec_size)
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
        values2 = planes_to_value(checked[cfg.vlo_w], checked[cfg.vhi_w],
                                  dtype)
        td2, tb2 = md.dense_td, md.dense_tb
        if td2 is not None:
            # A corrupted index plane mis-routes its entry until the
            # repair lands: re-derive from the scrubbed words.
            td2, tb2 = cfg.dense_arrays(checked, values2, md.flat_group,
                                        md.perm_pos)
        md2 = md._replace(
            words=words2, cksum=cksum2, values=values2, fold=fold2,
            fold_ck=fold_ck2, gidx=gidx2, dense_td=td2, dense_tb=tb2)
        return stats, md2

    return SpmvImpl(full=full, fast=fast, classify=classify, fast_pw=fast_pw)


# --------------------------------------------------------------------------
# DIA: stencil over (D, R) planes
# --------------------------------------------------------------------------

def dia_product(values: torch.Tensor, offsets, x: torch.Tensor,
                halo: int = None):
    """w[r] = sum_d values[d, r] * x[r + off_d], zero outside [0, R),
    summed in diagonal order d = 0..D-1 (the reference's order).
    ``halo`` H: the per-shard form, x is a shard's x_ext of R + 2H rows
    (parallel.sharded_kernel.halo_exchange) and row r reads
    x_ext[H + r + off_d]."""
    R = values.shape[-1]
    if halo is None:
        pad_lo = max(0, -min(offsets))
        pad_hi = max(0, max(offsets))
        xp = F.pad(x, (pad_lo, pad_hi)) if (pad_lo or pad_hi) else x
    else:
        if x.shape[0] != R + 2 * halo or max(map(abs, offsets)) > halo:
            raise ValueError(f"dia_product: x of {x.shape[0]} rows for "
                             f"{R} rows, halo {halo}, offsets {offsets}")
        pad_lo, xp = halo, x
    w = x.new_zeros(R)
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


def window_positions(g: torch.Tensor, rows: int, base: int, halo: int,
                     n: int) -> torch.Tensor:
    """Positions in one shard's x_ext (n = R_loc + 2 * halo rows) of the
    global gather indices ``g``: the global rule first (a negative index
    wraps once by ``rows``, then clamps into [0, rows)), then g - base +
    halo, clamped into [0, n).  Every valid index lands inside; a
    corrupted one may not and is clamped into the window, as the TPU
    kernel clamps it (spmv_pallas.py:704-707) — where the single-device
    product reads x[g] (a decided divergence, ROADMAP.md queue 3)."""
    g = g.to(torch.int64)
    g = torch.where(g < 0, g + rows, g).clamp_(0, rows - 1)
    return (g - base + halo).clamp_(0, n - 1)


def ell_product(values: torch.Tensor, gidx: torch.Tensor,
                ell_len: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """w[r] = sum over k < ell_len[r] of values[k, r] * x[gidx[k, r]],
    summed in slot order k = 0..K-1, one rounding per multiply and per
    add (the kernels' order, so their w is bit-identical)."""
    w = x.new_zeros(values.shape[-1])
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    for k in range(values.shape[0]):
        xk = take_clamped(x, gidx[k])
        w = w + torch.where(ell_len > k, values[k] * xk, zero)
    return w


# Kernel C's schedule (csrc/ell_spmv_detect.cu kRows, kSlab, kStages).
ELL_TILE_ROWS = 128     # rows of one tile = threads of one block
ELL_SLAB = 4            # slots of one staged slab
ELL_STAGES = 4          # slabs in a block's shared-memory ring


def ell_grid(R: int, sms: int, per_sm: int) -> int:
    """Kernel C's grid: the card's resident blocks (``per_sm`` on each of
    ``sms`` SMs, from the occupancy query), at most one per warp of the
    R rows."""
    return max(1, min(sms * per_sm, R // 32))


def ell_block_rows(R: int, grid: int) -> np.ndarray:
    """``(grid, 2)`` int64 rows ``[lo, hi)`` of kernel C's blocks: block b
    takes the contiguous whole warps [b W / G, (b + 1) W / G) of the W =
    R / 32 warps of rows, in tiles of ELL_TILE_ROWS rows."""
    W = R // 32
    edges = W * np.arange(grid + 1, dtype=np.int64) // grid * 32
    return np.stack([edges[:-1], edges[1:]], 1)


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


# --------------------------------------------------------------------------
# FLAT: 1-D exec-sorted planes (unstructured matrices, split tails)
# --------------------------------------------------------------------------

_DENSE_MAX_T = 64       # outlier count cap
_DENSE_MAX_PLANES = 4   # td bytes cap, in value-plane (R*4) equivalents


def dense_tail_plan(mat, outliers_canonical):
    """Build-time (CLEAN structure) plan of a bordered tail's span-window
    product (ops/spmv.py:260): ``(rows, starts, S)`` — the outliers'
    exec rows, each outlier's 128-aligned span start and one shared
    padded width S — or None when it does not apply.  NumPy only."""
    if mat.exec_kind != "flat" or len(outliers_canonical) > _DENSE_MAX_T:
        return None
    if mat.perm is not None:
        pos = inverse_permutation(mat.perm)
        rows = pos[np.asarray(outliers_canonical)]
    else:
        pos = None
        rows = np.asarray(outliers_canonical)
    rows = rows.astype(np.int32)
    T = len(rows)
    dst = np.asarray(mat.ell["__flat_group__"])[: mat.nnz]
    g = np.asarray(mat.ell[mat.ell_gather_word])[: mat.nnz]
    if mat.ell_gather_word == "col" and mat.mode in ECC_MODES:
        g = g & np.uint32(ECC_COL_MASK)
    src = g.astype(np.int64)
    if pos is not None:
        src = pos[np.clip(src, 0, mat.N - 1)]
    tbl = np.full(mat.R, -1, np.int32)
    tbl[rows] = np.arange(T, dtype=np.int32)
    tdst = tbl[np.clip(dst, 0, mat.R - 1)]
    a_mask = tdst >= 0
    starts = np.zeros(T, np.int64)
    spans = np.ones(T, np.int64)
    for t in range(T):
        s = src[a_mask & (tdst == t)]
        if len(s):
            starts[t] = (s.min() // 128) * 128
            spans[t] = s.max() - starts[t] + 1
    S = int(-(-spans.max() // 128) * 128)
    if mat.R % 128 or S > mat.R or T * S > _DENSE_MAX_PLANES * mat.R:
        return None
    starts = np.minimum(starts, mat.R - S)  # stays 128-aligned (R is)
    # Every tail entry must land inside one window: row entries by their
    # gather source, transpose images by their output row (the loader's
    # symmetrization guarantees it; a non-symmetric assembly falls back).
    tsrc = tbl[np.clip(src, 0, mat.R - 1)]

    def in_win(t, idx):
        return (idx >= starts[t]) & (idx < starts[t] + S)

    covered = np.where(
        a_mask, in_win(np.maximum(tdst, 0), src),
        (tsrc >= 0) & in_win(np.maximum(tsrc, 0), dst))
    if not covered.all():
        return None
    return (tuple(int(r) for r in rows),
            tuple(int(s) for s in starts), S)


def flat_product(values: torch.Tensor, gidx: torch.Tensor,
                 row_ptr: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """w[r] = sum over j in [row_ptr[r], row_ptr[r+1]) of values[j] *
    x[gidx[j]] (the jnp gather's clamp), summed in kernel E's order: lane
    l of 32 sums the row's slots l, l + 32, l + 64, ... in turn, then
    the 32 lane sums combine in an XOR butterfly (offsets 16, 8, 4, 2,
    1).  One rounding per multiply and per add, so kernel E's w is
    bit-identical to this on the same inputs."""
    R = x.shape[0]
    dev = x.device
    ptr = row_ptr.to(torch.int64)
    nnz = int(ptr[-1])
    rows = torch.repeat_interleave(torch.arange(R, device=dev),
                                   ptr[1:] - ptr[:-1])
    pos = torch.arange(nnz, device=dev) - ptr[:-1][rows]
    prod = values[:nnz] * take_clamped(x, gidx[:nnz])
    key = rows * 32 + (pos & 31)
    rnd = pos >> 5
    order = torch.argsort(rnd, stable=True)
    acc = torch.zeros(R * 32, dtype=x.dtype, device=dev)
    start = 0
    # Round k adds slot 32k + l of every row to lane l: keys are unique
    # within a round, so each lane sums its slots in order.
    for n in torch.bincount(rnd).tolist() if nnz else ():
        sel = order[start:start + n]
        k = key[sel]
        acc[k] = acc[k] + prod[sel]
        start += n
    lanes = acc.view(R, 32)
    lane = torch.arange(32, device=dev)
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, lane ^ o]
    return lanes[:, 0].contiguous()


# Kernel E's row-block plan (csrc/flat_spmv_detect.cu kTile, kRunRows).
FLAT_TILE = 2048        # slots of one block's shared-memory tile
FLAT_RUN_ROWS = 1024    # rows of one run


def flat_row_blocks(row_ptr, tile: int = FLAT_TILE,
                    run_rows: int = FLAT_RUN_ROWS) -> np.ndarray:
    """Kernel E's thread blocks, ``(B, 4)`` int32, from the CSR row
    pointer: ``(first row, end row, first slot, end slot)`` for a run of
    consecutive rows whose slots together fit one tile (greedy, at most
    ``run_rows`` rows), and ``(row, -1 - (first | last << 1), first slot,
    end slot)`` for each tile-sized chunk of a row of more than ``tile``
    slots (a long row: its chunks' blocks hand the row's running lane
    sums on in order).  Every slot and every row is in exactly one
    block; the chunks come first, each row's in order, so that they
    start first.  One searchsorted per block."""
    ptr = np.asarray(row_ptr, np.int64)
    R = len(ptr) - 1
    runs, chunks = [], []
    r = 0
    while r < R:
        end = int(np.searchsorted(ptr, ptr[r] + tile, side="right")) - 1
        end = min(end, r + run_rows, R)
        if end > r:
            runs.append((r, end, ptr[r], ptr[end]))
            r = end
            continue
        for c in range(int(ptr[r]), int(ptr[r + 1]), tile):
            flags = (c == ptr[r]) | (c + tile >= ptr[r + 1]) << 1
            chunks.append((r, -1 - flags, c, min(c + tile, ptr[r + 1])))
        r += 1
    return np.asarray(chunks + runs, np.int64).reshape(-1, 4).astype(
        np.int32)


class _FlatConfig(_EllConfig):
    """The flat layout (ops/spmv.py:887-1032); ``gather_indices`` is the
    ELL one on 1-D planes."""

    def __init__(self, fmt, layout, N, nnz, R, ecc_mode=True,
                 dense_plan=None):
        super().__init__(fmt, layout, N, ecc_mode)
        self.nnz = nnz
        self.R = R
        self.dense_plan = dense_plan

    def _valid(self, words):
        E = words[0].shape[0]
        return torch.arange(E, device=words[0].device) < self.nnz

    def dense_arrays(self, words, values, flat_group, perm_pos):
        """(dense_td, dense_tb) of a bordered tail from widened words
        (ops/spmv.py:921): each tail entry is densified into its
        outlier's span window — a dense-row entry by its gather source,
        a transpose image by its output row; entries outside every
        window drop (detection covers them).  Re-derived after a
        scrub."""
        rows, starts, S = self.dense_plan
        T = len(rows)
        dev = values.device
        O = torch.tensor(rows, dtype=torch.int64, device=dev)
        st = torch.tensor(starts, dtype=torch.int64, device=dev)
        tbl = torch.full((self.R,), -1, dtype=torch.int64, device=dev)
        tbl[O] = torch.arange(T, device=dev)
        g = words[self.gather_w]
        if self.ecc_gather_mask:
            g = g & int(ECC_COL_MASK)
        g = narrow(g).to(torch.int64).clamp(0, self.R - 1)
        if perm_pos is not None:
            g = perm_pos.to(torch.int64)[g]
        valid = self._valid(words)
        dst = flat_group.to(torch.int64).clamp(0, self.R - 1)
        tdst = torch.where(valid, tbl[dst], -1)
        tsrc = torch.where(valid, tbl[g], -1)
        zero = torch.zeros((), dtype=values.dtype, device=dev)

        def densify(t_of, win_idx):
            off = win_idx - st[t_of.clamp(0, T - 1)]
            inb = (t_of >= 0) & (off >= 0) & (off < S)
            pos = torch.where(inb, t_of * S + off, T * S)
            out = torch.zeros(T * S + 1, dtype=values.dtype, device=dev)
            out.index_add_(0, pos, torch.where(inb, values, zero))
            return out[: T * S].reshape(T, S)

        td = densify(tdst, g)                                  # dense rows
        tb = densify(torch.where(tdst >= 0, -1, tsrc), dst)    # images
        return td, tb

    def compute_w(self, md, words, x, dtype, values=None):
        """``words``: widened planes (used when ``values`` is None)."""
        if values is not None:
            if md.dense_td is not None:
                return self._compute_w_dense(md, x)
            return flat_product(values, self.gather_indices(md), md.row_ptr,
                                x)
        vals = planes_to_value(words[self.vlo_w], words[self.vhi_w], dtype)
        return flat_product(vals, self.gather_indices(md, words), md.row_ptr,
                            x)

    def _compute_w_dense(self, md, x):
        """A bordered tail's product from its span windows
        (ops/spmv.py:985): dense rows as (T, S) matvecs over x windows,
        transpose images as T windowed AXPYs."""
        rows, starts, S = self.dense_plan
        O = torch.tensor(rows, dtype=torch.int64, device=x.device)
        xs = torch.stack([x[s:s + S] for s in starts])
        wa = torch.sum(md.dense_td * xs, dim=1)
        xO = x[O]
        w = torch.zeros_like(x)
        for t, s in enumerate(starts):
            w[s:s + S] = w[s:s + S] + xO[t] * md.dense_tb[t]
        return w.index_add(0, O, wa)

    def constraints(self, md, errcode, err_slot):
        """The reference's bounds and ordering checks over the valid
        slots, within each row (ops/spmv.py:1006-1032)."""
        words = md.words
        valid = self._valid(words)
        col = widen(words[self.col_w])
        grp = md.flat_group
        errcode, err_slot = _raise_err(ERR_COL_SIZE, valid & (col >= self.N),
                                       errcode, err_slot)
        # Pair violations flag the FIRST element of the pair.
        same = (grp[1:] == grp[:-1]) & valid[1:]

        def pad(bad):
            return torch.cat([bad, torch.zeros_like(bad[:1])])

        if self.fmt == "coo":
            row = widen(words[self.gather_w])
            errcode, err_slot = _raise_err(
                ERR_ROW_SIZE, valid & (row >= self.N), errcode, err_slot)
            errcode, err_slot = _raise_err(
                ERR_ROW_ORDER, pad(same & (row[1:] <= row[:-1])), errcode,
                err_slot)
            errcode, err_slot = _raise_err(
                ERR_COL_ORDER, valid & (col != grp.to(torch.int64)),
                errcode, err_slot)
        else:
            errcode, err_slot = _raise_err(
                ERR_COL_ORDER, pad(same & (col[1:] <= col[:-1])), errcode,
                err_slot)
        return errcode, err_slot
