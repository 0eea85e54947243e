"""Outlier/bordered and band splits: banded main part + flat tail part.

The port's copy of ``abft_sparse_cg_tpu.formats.split`` (see that
module's docstring for the design).  ``try_split`` decomposes A = M + T
at the canonical level: ``tail`` = every entry incident to an outlier
index (a few dense rows), ``main`` = the rest.  ``try_band_split`` peels
the entries outside a cut bandwidth into the tail instead.  Each part is
an ordinary ProtectedMatrix sharing one execution space (the tail is
built with the main's permutation imposed); ECC is encoded once over
the global canonical planes, so the codewords are bit-identical to an
unsplit build, and ABFT events map back to global canonical indices.

The routing constants and the cost model are the JAX build's (fitted on
a TPU v5e), kept so both packages split the same matrices.  Not copied:
the ``ABFT_BAND_CUT`` calibration override and ``row_align``.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict

import numpy as np

from .loader import AssembledMatrix
from .protected import ProtectedMatrix, flat_checksums

__all__ = ["CompositeMatrix", "try_split", "try_band_split",
           "benes_beats_rolled"]

_MAX_OUTLIERS = 256
_MAX_TAIL_FRAC = 0.25
# A handful of truly dense rows may put most of nnz in the tail and stay
# cheap on the span-window (dense-plan) path; the tail cap relaxes to:
_MAX_TAIL_FRAC_DENSE = 0.80
_FEW_OUTLIERS = 32
_DEG_FACTOR = 4

# --- band split (matrices whose band exceeds the kernel cap) ---
_BAND_CUT_MAX = 1920
_ROLLED_MAX_BAND = 16256
_BAND_TAIL_MAX_FRAC = 0.10
_BAND_TAIL_FALLBACK_FRAC = 0.50
# The JAX build's per-entry per-iteration cost model (ns, TPU v5e).
_MAIN_NS_PER_WROW = 0.20
_MAIN_NS_SCAN = 0.012
_TAIL_NS = 12.0
_BENES_NS = 0.13
_BENES_MARGIN = 2.0


def benes_beats_rolled(nnz: int, N: int, band: int) -> bool:
    """The JAX build's whole-matrix decision once a band split has
    declined: keep wide-band ELL, or rebuild flat (split.py:90)."""
    from .protected import _BAND_SPLIT_TRIGGER

    if band <= _BAND_SPLIT_TRIGGER or not nnz:
        return False
    R = -(-N // 128) * 128
    if nnz + R > (1 << 23):       # past the Benes total envelope
        return False
    if band > _ROLLED_MAX_BAND:
        return True
    rolled = nnz * (2 * (band // 128) + 1) * _main_ns(band)
    benes = (1.3 * nnz + 2.2 * R) * _BENES_NS
    return benes * _BENES_MARGIN < rolled


def _main_ns(cut: int) -> float:
    return _MAIN_NS_PER_WROW if cut <= _BAND_CUT_MAX else _MAIN_NS_SCAN


@dataclass(frozen=True)
class CompositeMatrix:
    """A = M + T; duck-compatible with ProtectedMatrix where the
    backends and the CLI need it (planes are GLOBAL canonical order)."""

    fmt: str
    mode: str
    N: int
    nnz: int
    layout: object
    planes: Dict[str, np.ndarray]       # global canonical planes
    row_ptr: np.ndarray                 # CSR only
    flat_cksum: np.ndarray
    main: ProtectedMatrix
    tail: ProtectedMatrix
    idx_main: np.ndarray                # part canonical -> global canonical
    idx_tail: np.ndarray
    block_size: int = 0
    num_blocks: int = 1

    exec_kind = "split"

    @property
    def R(self) -> int:
        return self.main.R

    @property
    def K(self) -> int:
        return max(self.main.K, self.tail.K)

    @property
    def band(self) -> int:
        return self.main.band

    @property
    def perm(self):
        return self.main.perm

    @property
    def dia_offsets(self):
        return self.main.dia_offsets

    @property
    def exec_size(self) -> int:
        return self.main.exec_size + self.tail.exec_size

    def to_exec_order(self, v: np.ndarray) -> np.ndarray:
        return self.main.to_exec_order(v)

    def from_exec_order(self, v: np.ndarray) -> np.ndarray:
        return self.main.from_exec_order(v)

    def words_list(self):
        return [self.planes[n] for n in self.layout.word_names]

    def diagonal(self) -> np.ndarray:
        # The diagonal belongs to whichever part holds it; sum covers both.
        return self.main.diagonal() + self.tail.diagonal()

    def slot_to_canonical(self) -> np.ndarray:
        """Composite exec slot -> GLOBAL canonical element index (tail
        slots are offset by the main part's exec size)."""
        from ..backends.base import slot_to_canonical

        inv = np.full(self.exec_size, -1, dtype=np.int64)
        im = slot_to_canonical(self.main)
        sel = im >= 0
        inv[: self.main.exec_size][sel] = self.idx_main[im[sel]]
        it = slot_to_canonical(self.tail)
        sel = it >= 0
        inv[self.main.exec_size:][sel] = self.idx_tail[it[sel]]
        return inv

    def with_planes(self, planes: Dict[str, np.ndarray]) -> "CompositeMatrix":
        """Corruption semantics of ProtectedMatrix.with_planes: the new
        global planes are re-split; build-time checksums stay."""
        mainp = {n: p[self.idx_main] for n, p in planes.items()}
        tailp = {n: p[self.idx_tail] for n, p in planes.items()}
        return replace(self, planes=planes,
                       main=self.main.with_planes(mainp),
                       tail=self.tail.with_planes(tailp))

    def with_scrubbed_planes(self, planes) -> "CompositeMatrix":
        mainp = {n: p[self.idx_main] for n, p in planes.items()}
        tailp = {n: p[self.idx_tail] for n, p in planes.items()}
        return replace(
            self, planes=planes,
            flat_cksum=(flat_checksums(planes, self.layout, self.nnz)
                        if self.flat_cksum is not None else None),
            main=self.main.with_scrubbed_planes(mainp),
            tail=self.tail.with_scrubbed_planes(tailp),
        )


def _composite(fmt, assembled, mode, layout, planes, row_ptr, main, tail,
               tail_mask):
    from ..ecc.codec import ECC_MODES
    from ..ops.spmv_unstructured import attach_plan

    tail = attach_plan(tail)   # adopted: the tail's attach step runs now
    flat_cksum = (flat_checksums(planes, layout, assembled.nnz)
                  if mode in ECC_MODES else None)
    return CompositeMatrix(
        fmt=fmt, mode=mode, N=assembled.N, nnz=assembled.nnz,
        layout=layout, planes=planes, row_ptr=row_ptr,
        flat_cksum=flat_cksum, main=main, tail=tail,
        idx_main=np.flatnonzero(~tail_mask),
        idx_tail=np.flatnonzero(tail_mask),
        block_size=assembled.block_size,
        num_blocks=assembled.num_blocks,
    )


def try_band_split(fmt, assembled, mode, layout, planes, row_ptr, reorder,
                   row_align=None):
    """Band decomposition A = M + T for matrices whose (post-RCM)
    bandwidth exceeds the banded kernels' window cap (split.py:210):
    ``main`` = entries within a cut bandwidth, ``tail`` = the
    out-of-band remainder on the flat layout.  The cut comes from the
    JAX build's cost model; None when no cut pays."""
    rows = assembled.rows.astype(np.int64)
    cols = assembled.cols.astype(np.int64)
    N, nnz = assembled.N, assembled.nnz

    cand_perms = [None]
    if reorder in ("auto", "rcm") and mode != "constraints":
        from .reorder import inverse_permutation, rcm_permutation

        cand_perms.append(rcm_permutation(rows, cols, N))
    pcands = []
    for perm in cand_perms:
        if perm is None:
            er, ec = rows, cols
        else:
            pos = inverse_permutation(perm)
            er, ec = pos[rows], pos[cols]
        off = np.abs(er - ec)
        pcands.append((perm, off, int(off.max()) if nnz else 0))

    kernel_whole = any(band <= _ROLLED_MAX_BAND for _, _, band in pcands)
    cuts = list(range(256, _BAND_CUT_MAX + 1, 256)) + list(
        range(_BAND_CUT_MAX + 1024, _ROLLED_MAX_BAND + 1, 1024))
    tail_cap = (_BAND_TAIL_MAX_FRAC if kernel_whole
                else _BAND_TAIL_FALLBACK_FRAC)

    best = None
    whole_cost = None   # best un-split option (wide-band ELL)
    for perm, off, band in pcands:
        if band <= _ROLLED_MAX_BAND:
            wc = nnz * (2 * (band // 128) + 1) * _main_ns(band)
            if whole_cost is None or wc < whole_cost:
                whole_cost = wc
        for c in cuts:
            tail_n = int((off > c).sum())
            if tail_n == 0 or tail_n > tail_cap * nnz:
                continue
            wrows = 2 * (c // 128) + 1
            cost = ((nnz - tail_n) * wrows * _main_ns(c)
                    + tail_n * _TAIL_NS)
            if best is None or cost < best[0]:
                best = (cost, perm, c, off)
    if best is None or (whole_cost is not None and whole_cost <= best[0]):
        return None
    _, perm, cut, off = best

    tail_mask = off > cut
    from .protected import build_protected

    main = build_protected(fmt, _sub_assembled(assembled, ~tail_mask), mode,
                           reorder="none", split="none", force_perm=perm,
                           row_align=row_align, _part=True)
    if main.exec_kind not in ("dia", "ell") or main.band > cut:
        return None
    tail = build_protected(fmt, _sub_assembled(assembled, tail_mask), mode,
                           reorder="none", split="none", force_perm=perm,
                           force_exec="flat", row_align=row_align,
                           _attach_unstr=False, _part=True)
    if tail.R != main.R:
        return None
    return _composite(fmt, assembled, mode, layout, planes, row_ptr, main,
                      tail, tail_mask)


def _sub_assembled(a: AssembledMatrix, mask: np.ndarray) -> AssembledMatrix:
    # Canonical order is the (row, col) sort; a subsequence stays sorted.
    return AssembledMatrix(
        rows=a.rows[mask], cols=a.cols[mask], values=a.values[mask],
        N=a.N, nnz=int(mask.sum()),
        block_size=a.block_size, num_blocks=a.num_blocks,
    )


def try_split(fmt, assembled, mode, layout, planes, row_ptr, reorder,
              row_align=None):
    """The bordered decomposition (split.py:336); None if it does not
    pay."""
    from .protected import build_protected

    rows = assembled.rows.astype(np.int64)
    cols = assembled.cols.astype(np.int64)
    N, nnz = assembled.N, assembled.nnz

    deg = np.bincount(rows, minlength=N)
    med = max(1, int(np.median(deg[deg > 0])))
    cap = max(64, _DEG_FACTOR * med)
    outliers = np.flatnonzero(deg > cap)
    if not len(outliers) or len(outliers) > _MAX_OUTLIERS:
        return None
    is_out = np.zeros(N, dtype=bool)
    is_out[outliers] = True
    tail_mask = is_out[rows] | is_out[cols]
    tail_frac = tail_mask.sum() / max(nnz, 1)
    few = len(outliers) <= _FEW_OUTLIERS
    if (tail_frac > (_MAX_TAIL_FRAC_DENSE if few else _MAX_TAIL_FRAC)
            or not (~tail_mask).any()):
        return None

    main = build_protected(fmt, _sub_assembled(assembled, ~tail_mask), mode,
                           reorder=reorder, split="none",
                           row_align=row_align, _part=True)
    if main.exec_kind == "flat":
        return None  # the core is not banded either; flat alone is simpler

    tail = build_protected(fmt, _sub_assembled(assembled, tail_mask), mode,
                           reorder="none", split="none",
                           force_perm=main.perm, row_align=row_align,
                           _attach_unstr=False, _part=True)
    if tail.R != main.R:
        return None
    if tail.exec_kind == "flat":
        from ..ops.spmv import dense_tail_plan

        plan = dense_tail_plan(tail, outliers)
        if plan is not None:
            tail = replace(tail, dense_plan=plan)
    if tail_frac > _MAX_TAIL_FRAC and not (
            few and tail.dense_plan is not None):
        return None
    return _composite(fmt, assembled, mode, layout, planes, row_ptr, main,
                      tail, tail_mask)
