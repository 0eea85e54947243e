"""Fault injector: flip random bits in one matrix element, post-encode.

A copy of ``abft_sparse_cg_tpu.inject``: ONE random victim element,
``num_flips`` independently-random bit positions (repeats allowed — two
hits on the same bit cancel), restricted to a region:

  =======  ===================  ===================
  kind     coo (128-bit)        csr (96-bit)
  =======  ===================  ===================
  ANY      [0, 128)             [0, 96)
  VALUE    [64, 128)            [0, 64)
  INDEX    [0, 64)              [64, 96)
  =======  ===================  ===================

The RNG is an explicit ``np.random.Generator``, drawn in the same order
as the JAX package's, so one seed flips the same bits in both.  Prints
the reference banner: ``*** flipping bit B at index I ***``.
"""

from __future__ import annotations

import numpy as np

from .ecc import codec
from .formats.protected import ProtectedMatrix

__all__ = ["BITFLIP_KINDS", "bitflip_region", "inject_bitflips"]

BITFLIP_KINDS = ("ANY", "VALUE", "INDEX")


def bitflip_region(fmt: str, kind: str):
    """(start, end) global-bit region for a format/kind pair."""
    if kind not in BITFLIP_KINDS:
        raise ValueError(f"unknown bit-flip kind: {kind!r}")
    if fmt == "coo":
        return {"ANY": (0, 128), "VALUE": (64, 128), "INDEX": (0, 64)}[kind]
    if fmt == "csr":
        return {"ANY": (0, 96), "VALUE": (0, 64), "INDEX": (64, 96)}[kind]
    raise ValueError(f"unknown format: {fmt!r}")


def inject_bitflips(
    mat: ProtectedMatrix,
    kind: str = "ANY",
    num_flips: int = 1,
    rng: np.random.Generator | None = None,
    echo=print,
) -> ProtectedMatrix:
    """Return a copy of ``mat`` with bits flipped in one random element.
    The stored checksums are not refreshed (they are encode-time data)."""
    if rng is None:
        rng = np.random.default_rng()
    start, end = bitflip_region(mat.fmt, kind)

    index = int(rng.integers(0, mat.nnz))
    bits = [int(rng.integers(start, end)) for _ in range(num_flips)]
    for b in bits:
        echo(f"*** flipping bit {b} at index {index} ***")

    words = codec.flip_bits(mat.words_list(), index, bits, mat.layout)
    planes = dict(zip(mat.layout.word_names, words))
    return mat.with_planes(planes)
