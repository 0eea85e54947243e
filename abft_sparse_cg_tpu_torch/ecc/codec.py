"""Tensor paths of the ECC codec: parity, syndrome, locate, correct.

Counterpart of the jnp paths of ``abft_sparse_cg_tpu.ecc.codec``
(:75-280), with the same semantics mode by mode (see that module's
table), plus a copy of its NumPy paths: ``encode`` (the matrix build)
and ``flip_bits`` (fault injection), which work on uint32 NumPy planes.

Word representation.  PyTorch has no usable uint32 arithmetic (``<<``
and ``>>`` on ``torch.uint32`` raise on the CPU) and no popcount, so:

  - device planes hold the uint32 bit patterns in ``torch.int32``
    tensors (``from_numpy_u32``; the kernels read them as ``uint32_t``);
  - the eager codec works on ``torch.int64`` tensors holding the values
    in ``[0, 2**32)`` (``widen``), with masked shifts and a SWAR
    popcount; ``narrow`` maps results back to int32 bit patterns.

Every function below takes and returns widened (int64) words.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .layout import (
    CodewordLayout,
    NUM_PARITY_BITS,
    OVERALL_PARITY_BIT,
    SED_PARITY_BIT,
)

__all__ = [
    "MODES",
    "ECC_MODES",
    "MASK32",
    "widen",
    "narrow",
    "from_numpy_u32",
    "to_numpy_u32",
    "popcount32",
    "parity32",
    "overall_parity",
    "syndrome",
    "decode_flipped_bit",
    "check_and_correct",
    "check_and_correct_np",
    "encode",
    "flip_bits",
]

MODES = ("none", "constraints", "sed", "sec7", "sec8", "secded")
ECC_MODES = ("sed", "sec7", "sec8", "secded")

MASK32 = 0xFFFFFFFF


def widen(t: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns (or any integer tensor) -> int64 in [0, 2**32)."""
    return t.to(torch.int64) & MASK32


def narrow(t: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 tensor with the same low 32 bits."""
    return t.to(torch.int32)


def from_numpy_u32(a: np.ndarray, device) -> torch.Tensor:
    """A uint32 NumPy plane -> int32 tensor of the same bits on ``device``."""
    a = np.ascontiguousarray(a, dtype=np.uint32)
    return torch.from_numpy(a.view(np.int32).copy()).to(device)


def to_numpy_u32(t: torch.Tensor) -> np.ndarray:
    """Inverse of ``from_numpy_u32`` (int32 or widened int64 input)."""
    return narrow(t).cpu().numpy().view(np.uint32)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of each 32-bit value (widened int64 input)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & MASK32) >> 24


def parity32(x: torch.Tensor) -> torch.Tensor:
    """popcount mod 2 of each 32-bit value."""
    return popcount32(x) & 1


def overall_parity(words: Sequence[torch.Tensor]) -> torch.Tensor:
    """Overall (1-bit) parity of each codeword: popcount(xor of words) & 1."""
    acc = words[0]
    for w in words[1:]:
        acc = acc ^ w
    return parity32(acc)


def syndrome(words: Sequence[torch.Tensor], layout: CodewordLayout):
    """7-bit Hamming syndrome, packed into bits 25..31 (0 when clean)."""
    masks = layout.masks  # (7, num_words) uint32 constants
    result = torch.zeros_like(words[0])
    for p in range(1, NUM_PARITY_BITS + 1):
        acc = words[0] & int(masks[p - 1, 0])
        for w in range(1, layout.num_words):
            acc = acc ^ (words[w] & int(masks[p - 1, w]))
        result = result | (parity32(acc) << (32 - p))
    return result


def _bit_length_u8(x: torch.Tensor) -> torch.Tensor:
    out = torch.zeros_like(x)
    v = x
    for _ in range(8):
        out = torch.where(v > 0, out + 1, out)
        v = v >> 1
    return out


def decode_flipped_bit(syn: torch.Tensor, layout: CodewordLayout):
    """Nonzero syndrome -> global bit index of the flipped bit (same
    numbering as the reference's injector: ``word*32 + bit``).  Undefined
    for a zero syndrome; callers gate on ``syn != 0``."""
    x = torch.zeros_like(syn)
    for p in range(1, NUM_PARITY_BITS + 1):
        x = x | (((syn >> (32 - p)) & 1) << (p - 1))
    blen = _bit_length_u8(x)
    is_pow2 = (x != 0) & ((x & (x - 1)) == 0)
    # uint32 arithmetic in the reference: wrap x - blen - 1 mod 2**32.
    data_bit = (x - blen - 1) & MASK32
    data_bit = torch.where(data_bit >= layout.parity_region_start,
                           data_bit + 8, data_bit)
    parity_bit = (layout.col_word * 32 + 31 - (blen - 1)) & MASK32
    return torch.where(is_pow2, parity_bit, data_bit) & MASK32


def _xor_bit_into_planes(words, global_bit, do_it, layout):
    """XOR bit ``global_bit`` (per element) into the planes where ``do_it``."""
    out = []
    one = torch.ones_like(global_bit)
    zero = torch.zeros_like(global_bit)
    for w in range(layout.num_words):
        hit = do_it & ((global_bit >> 5) == w)
        mask = torch.where(hit, one << (global_bit & 31), zero)
        out.append(words[w] ^ mask)
    return out


def check_and_correct(mode: str, words: Sequence[torch.Tensor],
                      layout: CodewordLayout):
    """Verify (and for SEC modes repair) each codeword.

    Returns ``(corrected_words, flags)`` exactly as the reference's
    ``check_and_correct``: ``detected``/``corrected``/``double`` bool
    tensors and ``corrected_bit`` (int64, 0 where nothing was fixed)."""
    zeros_b = torch.zeros(words[0].shape, dtype=torch.bool,
                          device=words[0].device)
    flags = {
        "detected": zeros_b,
        "corrected": zeros_b,
        "corrected_bit": torch.zeros_like(words[0]),
        "double": zeros_b,
    }
    if mode in ("none", "constraints"):
        return list(words), flags
    if mode == "sed":
        return list(words), dict(flags, detected=overall_parity(words) != 0)
    if mode == "sec7":
        syn = syndrome(words, layout)
        bad = syn != 0
        bit = torch.where(bad, decode_flipped_bit(syn, layout),
                          torch.zeros_like(syn))
        corrected = _xor_bit_into_planes(words, bit, bad, layout)
        return corrected, dict(flags, corrected=bad, corrected_bit=bit)
    if mode not in ("sec8", "secded"):
        raise ValueError(f"unknown ABFT mode: {mode!r}")
    par = overall_parity(words) != 0
    syn = syndrome(words, layout)
    has_syn = syn != 0
    # parity fail + syndrome   -> correct the located bit
    # parity fail, no syndrome -> the overall-parity bit itself flipped
    fix_data = par & has_syn
    fix_pbit = par & ~has_syn
    pbit_global = layout.col_word * 32 + OVERALL_PARITY_BIT
    bit = torch.where(
        fix_pbit, torch.full_like(syn, pbit_global),
        torch.where(fix_data, decode_flipped_bit(syn, layout),
                    torch.zeros_like(syn)))
    corrected = _xor_bit_into_planes(words, bit, par, layout)
    flags = dict(flags, corrected=par, corrected_bit=bit)
    if mode == "secded":
        double = ~par & has_syn
        flags = dict(flags, double=double, detected=double)
    return corrected, flags


def check_and_correct_np(mode: str, words, layout: CodewordLayout):
    """``check_and_correct`` on uint32 NumPy planes, for the host paths
    (the Jacobi diagonal, the refinement residual): the JAX codec's
    NumPy path (codec.py:216), with the syndrome decoded only where a
    parity or syndrome fired.  Returns uint32 planes and NumPy flags
    (``corrected_bit`` uint32)."""
    words = [np.asarray(w, dtype=np.uint32) for w in words]
    zeros_b = np.zeros(words[0].shape, dtype=bool)
    flags = {"detected": zeros_b, "corrected": zeros_b,
             "corrected_bit": np.zeros(words[0].shape, dtype=np.uint32),
             "double": zeros_b}
    if mode in ("none", "constraints"):
        return list(words), flags
    if mode == "sed":
        return list(words), dict(flags,
                                 detected=_np_overall_parity(words) != 0)
    if mode not in ("sec7", "sec8", "secded"):
        raise ValueError(f"unknown ABFT mode: {mode!r}")
    syn = _np_syndrome(words, layout)
    has_syn = syn != 0
    if mode == "sec7":
        fix, fix_data = has_syn, has_syn
    else:
        fix = _np_overall_parity(words) != 0
        fix_data = fix & has_syn
    bit = np.zeros(words[0].shape, dtype=np.uint32)
    # parity fail, no syndrome: the overall-parity bit itself flipped
    bit[fix & ~has_syn] = layout.col_word * 32 + OVERALL_PARITY_BIT
    where = np.flatnonzero(fix_data)
    bit.reshape(-1)[where] = _np_decode(syn.reshape(-1)[where], layout)
    out = list(words)
    for k in np.flatnonzero(fix):
        b = int(bit.reshape(-1)[k])
        w, shift = divmod(b, 32)
        if w < layout.num_words:
            if out[w] is words[w]:
                out[w] = words[w].copy()
            out[w].reshape(-1)[k] ^= np.uint32(1 << shift)
    flags = dict(flags, corrected=fix, corrected_bit=bit)
    if mode == "secded":
        double = ~fix & has_syn
        flags = dict(flags, double=double, detected=double)
    return out, flags


def _np_decode(syn: np.ndarray, layout: CodewordLayout) -> np.ndarray:
    """``decode_flipped_bit`` on uint32 NumPy syndromes."""
    syn = syn.astype(np.int64)
    x = np.zeros_like(syn)
    for p in range(1, NUM_PARITY_BITS + 1):
        x |= ((syn >> (32 - p)) & 1) << (p - 1)
    blen = np.zeros_like(x)
    v = x.copy()
    for _ in range(8):
        blen = np.where(v > 0, blen + 1, blen)
        v >>= 1
    is_pow2 = (x != 0) & ((x & (x - 1)) == 0)
    data_bit = (x - blen - 1) & MASK32
    data_bit = np.where(data_bit >= layout.parity_region_start,
                        data_bit + 8, data_bit)
    parity_bit = (layout.col_word * 32 + 31 - (blen - 1)) & MASK32
    return (np.where(is_pow2, parity_bit, data_bit) & MASK32).astype(
        np.uint32)


# --------------------------------------------------------------------------
# NumPy paths (host side): encode at build time, flip bits for injection
# --------------------------------------------------------------------------

def _np_parity32(x: np.ndarray) -> np.ndarray:
    return np.bitwise_count(x).astype(np.uint32) & np.uint32(1)


def _np_overall_parity(words) -> np.ndarray:
    acc = words[0]
    for w in words[1:]:
        acc = acc ^ w
    return _np_parity32(acc)


def _np_syndrome(words, layout: CodewordLayout) -> np.ndarray:
    masks = layout.masks
    result = np.zeros_like(words[0])
    for p in range(1, NUM_PARITY_BITS + 1):
        acc = words[0] & np.uint32(masks[p - 1, 0])
        for w in range(1, layout.num_words):
            acc = acc ^ (words[w] & np.uint32(masks[p - 1, w]))
        result = result | (_np_parity32(acc) << np.uint32(32 - p))
    return result


def encode(mode: str, words, layout: CodewordLayout):
    """Set the ECC bits of ``mode`` into fresh uint32 codeword planes.

    ``words`` must carry a clean 24-bit column (high byte zero).  Returns
    a new list of planes; only the column word changes.  Hamming bits
    first, then overall parity over the codeword including them (the
    reference's encode order)."""
    if mode not in MODES:
        raise ValueError(f"unknown ABFT mode: {mode!r}")
    words = list(words)
    cw = layout.col_word
    if mode in ("none", "constraints"):
        return words
    if mode == "sed":
        par = _np_overall_parity(words)
        words[cw] = words[cw] | (par << np.uint32(SED_PARITY_BIT))
        return words
    words[cw] = words[cw] | _np_syndrome(words, layout)
    if mode == "sec7":
        return words
    par = _np_overall_parity(words)
    words[cw] = words[cw] | (par << np.uint32(OVERALL_PARITY_BIT))
    return words


def flip_bits(words, index: int, bits, layout: CodewordLayout):
    """New uint32 planes with the global ``bits`` of element ``index``
    flipped (the reference injector's bit numbering)."""
    words = list(words)
    for b in bits:
        w, bit = divmod(int(b), 32)
        plane = words[w].copy()
        plane[index] ^= np.uint32(1 << bit)
        words[w] = plane
    return words
