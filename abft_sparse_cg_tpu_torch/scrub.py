"""Offline matrix scrub: verify and repair a protected matrix in one pass.

Counterpart of ``abft_sparse_cg_tpu.scrub``.  The solvers repair a
fault functionally (the classify pass scrubs the device planes); this is
the explicit maintenance form, memory scrubbing in the RAS sense: the
full ECC check over the canonical planes, what is correctable
corrected, what is not reported, in the reference's ``[ECC]`` strings.

Host-side NumPy (``ecc.codec.check_and_correct_np``, the codec the
device paths share), so the outcomes are those of a solve.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from .ecc import codec
from .ecc.codec import to_numpy_u32
from .ecc.layout import OVERALL_PARITY_BIT

__all__ = ["ScrubReport", "scrub", "scrubbed_from_device"]


def scrubbed_from_device(mat, md):
    """A solve's final device planes as a host matrix (scrub.py:26).

    ``md`` is the device matrix a solver returned (``CGResult.md``): a
    MatrixDevice, a split's (main, tail) pair, or a mesh upload
    (``parallel.sharded.ShardedDevice``, whose shards' rows are
    gathered here in shard order).  After a repaired solve those planes
    are the scrubbed data, the reference's in-place write-back
    (CSR/CPUContext.cpp:275-277): the caller holds a repaired,
    self-consistent matrix, its checksums refreshed."""
    if mat.exec_kind == "split":
        main = scrubbed_from_device(mat.main, md[0])
        tail = scrubbed_from_device(mat.tail, md[1])
        planes = {}
        for n in mat.layout.word_names:
            g = mat.planes[n].copy()
            g[mat.idx_main] = main.planes[n]
            g[mat.idx_tail] = tail.planes[n]
            planes[n] = g
        return mat.with_scrubbed_planes(planes)
    shards = getattr(md, "shards", (md,))
    shape0 = mat.ell[mat.layout.word_names[0]].shape
    planes = {}
    for i, name in enumerate(mat.layout.word_names):
        arr = np.concatenate([to_numpy_u32(sh.words[i]) for sh in shards],
                             axis=-1)
        # Mesh-padded planes (parallel.sharded._pad_matrix) append zero
        # rows past R (the last axis): strip them so that the exec slots
        # line up with the canonical slot map.  Flat planes keep their
        # build-time length.
        arr = arr[..., : shape0[-1]]
        planes[name] = np.ascontiguousarray(arr.reshape(-1)[mat.ell_slot],
                                            dtype=np.uint32)
    return mat.with_scrubbed_planes(planes)


@dataclass
class ScrubReport:
    corrected: int              # elements repaired
    uncorrectable: int          # sed detections / secded double-bit errors
    indices: List[int]          # canonical indices of repaired elements
    messages: List[str]         # reference-format event strings


def scrub(mat):
    """``(repaired_matrix, report)`` (scrub.py:71).  In the correction
    modes (sec7, sec8, secded) the repaired planes replace the corrupted
    ones and the execution layout is re-derived from them; its
    encode-time checksums then match again by construction.  The
    detection modes (sed, a secded double-bit error) only report."""
    words = mat.words_list()
    fixed, flags = codec.check_and_correct_np(mat.mode, words, mat.layout)

    opb = mat.layout.col_word * 32 + OVERALL_PARITY_BIT
    messages = []
    indices = np.flatnonzero(flags["corrected"])
    for i in indices:
        bit = int(flags["corrected_bit"].reshape(-1)[i])
        if bit == opb:
            messages.append(f"[ECC] corrected overall parity bit at index {i}")
        else:
            messages.append(f"[ECC] corrected bit {bit} at index {i}")

    detected = np.flatnonzero(flags["detected"])
    for i in detected:
        if mat.mode == "sed":
            messages.append(f"[ECC] error detected at index {int(i)}")
        else:
            messages.append("[ECC] double-bit error detected")

    repaired = mat.with_planes(dict(zip(mat.layout.word_names, fixed)))
    report = ScrubReport(corrected=len(indices),
                         uncorrectable=len(detected),
                         indices=[int(i) for i in indices],
                         messages=messages)
    return repaired, report
