"""Rotated XOR fold of the word planes, on tensors.

Counterpart of ``abft_sparse_cg_tpu.ecc.fold.fold_words`` (:55-77): the
one plane the live detection of the kernels streams instead of every
codeword word.  The rotation sets (``FOLD_SHIFTS``) are the reference's;
see its module docstring for why every 1- and 2-bit fault within an
element changes the fold and every odd-weight fault flips its parity.
"""

from __future__ import annotations

from .codec import MASK32

__all__ = ["FOLD_SHIFTS", "fold_words"]

# Rotation-distance sets per word index (the JAX package's, ecc/fold.py:55):
# each set has odd size (parity preservation) and the induced columns
# {b + s mod 32 : s in set} are distinct across all (word, bit) pairs.
FOLD_SHIFTS = ((0,), (0, 1, 2), (0, 1, 3), (0, 2, 3))


def _rotl32(w, s: int):
    if s == 0:
        return w
    return ((w << s) & MASK32) | (w >> (32 - s))


def fold_words(words):
    """XOR-fold widened (int64) word planes, in codeword-word order."""
    if len(words) > len(FOLD_SHIFTS):
        raise ValueError(f"at most {len(FOLD_SHIFTS)} word planes fold")
    out = None
    for j, w in enumerate(words):
        for s in FOLD_SHIFTS[j]:
            t = _rotl32(w, s)
            out = t if out is None else out ^ t
    return out
