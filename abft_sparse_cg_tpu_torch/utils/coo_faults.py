"""Index faults of COO128 codewords placed by position, for the checks of
constraints mode's two signal planes (tests/test_torch_coo.py,
tests/test_torch_cuda.py, chip_smoke.py).

A COO128 codeword's global bits 0-31 are its col word and 32-63 its row
word (the injector's INDEX region, inject.py).  Two faults matter to the
live scan of constraints mode, which checks each index word against its
own 8-row block checksum:

  - ``row_word_flip``: one bit of the row word.  Only the second plane
    (row) sees it; a scan of the col word alone would not.
  - ``col_row_fault``: row bit j and col bits j, j + 1, j + 2 of one
    element.  Under ecc.fold.FOLD_SHIFTS the col word folds unrotated and
    the row word at rotations 0, 1, 2, so the four flips cancel in the
    rotated fold of (col, row): a single derived plane would miss it,
    while each word's own checksum changes.
"""

from __future__ import annotations

from ..ecc import codec

__all__ = ["flip_at", "row_word_flip", "col_row_fault"]


def flip_at(mat, index: int, bits):
    """A copy of ``mat`` with the global codeword ``bits`` of canonical
    element ``index`` flipped (the stored checksums kept, as an injected
    fault keeps them)."""
    words = codec.flip_bits(mat.words_list(), index, list(bits), mat.layout)
    return mat.with_planes(dict(zip(mat.layout.word_names, words)))


def row_word_flip(mat, index: int, bit: int = 5):
    """Bit ``bit`` of element ``index``'s row word flipped."""
    if mat.fmt != "coo":
        raise ValueError("a row word exists in COO128 codewords only")
    return flip_at(mat, index, [32 + bit])


def col_row_fault(mat, index: int, j: int = 0):
    """Row bit j and col bits j, j + 1, j + 2 of element ``index`` flipped:
    four flips whose rotated fold is zero."""
    if mat.fmt != "coo" or not 0 <= j <= 21:
        raise ValueError("a COO128 matrix and 0 <= j <= 21 (col bits below "
                         "the ECC byte)")
    return flip_at(mat, index, [j, j + 1, j + 2, 32 + j])
