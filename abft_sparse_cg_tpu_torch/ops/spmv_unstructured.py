"""Whether the JAX build's Benes-route plan attaches to a flat matrix.

The JAX package carries flat matrices on a TPU kernel tier
(``abft_sparse_cg_tpu.ops.spmv_unstructured``) whose build-time plan
routes products through Benes networks — a workaround for a TPU's lack
of a fast gather.  Its build then routes on whether that plan exists:
a wide-band ELL matrix is rebuilt flat only when the plan attaches
(formats/protected.py:514-520).  The port's flat kernel (kernel E,
ops.spmv_cuda) gathers directly and needs no plan, so this module keeps
only the plan's envelope arithmetic, which decides that routing:

  - ``wants_unstructured`` (spmv_unstructured.py:70): a flat layout
    without a dense-tail plan, with nnz + R <= 2^23;
  - the padded-slot total of ``unstructured_plan`` (:288-310) against
    ``_MAX_TOTAL_M``, and its greedy 128-row blocks;
  - each block's slot grid ``M`` and unpermute width ``V2`` of
    ``_block_plan`` (:123-188, :215-221) against ``_MAX_M``.

``plan_attaches(mat)`` equals the JAX ``unstructured_plan(mat) is not
None`` (tests/test_torch_formats.py); the constants keep the JAX names.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np

__all__ = ["wants_unstructured", "plan_attaches", "attach_plan"]

_MAX_M = 1 << 20          # per-block slot-grid cap of the TPU kernel
_S_CAP = 512              # max slots per virtual row (hub rows split)
_ALLOWED = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128,
            192, 256, 384, 512)
_BLOCK_TARGET = 1 << 19   # greedy block size in padded slots
_MAX_TOTAL_M = 1 << 23    # padded slots across blocks


def _pow2_at_least(v: int) -> int:
    return 1 << max(7, int(v - 1).bit_length())   # >= 128


def wants_unstructured(mat) -> bool:
    """Flat layouts without a dense-tail plan, within the total
    envelope (a necessary condition; ``plan_attaches`` is exact)."""
    if mat.exec_kind != "flat" or mat.dense_plan is not None:
        return False
    if mat.nnz < 1:
        return False
    return mat.nnz + mat.R <= _MAX_TOTAL_M


def _padded(cnts) -> int:
    """Padded slot-grid size of virtual-row counts per allowed size."""
    return int((-(-cnts // 128) * 128 * np.asarray(_ALLOWED)).sum())


def _block_fits(deg) -> bool:
    """``_block_plan(...) is not None`` for one block of row degrees."""
    allowed = np.asarray(_ALLOWED)
    full_k = deg // _S_CAP
    rem = deg - full_k * _S_CAP
    has_rem = (rem > 0) | (deg == 0)      # empty rows still get 1 slot
    cls = np.searchsorted(allowed, np.maximum(rem[has_rem], 1))
    cnts = np.bincount(cls, minlength=len(allowed)).astype(np.int64)
    cnts[-1] += int(full_k.sum())         # _S_CAP == allowed[-1]
    if _pow2_at_least(_padded(cnts)) > _MAX_M:
        return False
    V = int((-(-cnts // 128) * 128).sum())
    extras = int(full_k.sum() + has_rem.sum()) - len(deg)
    return _pow2_at_least(max(V, len(deg) + extras)) <= _MAX_M


def plan_attaches(mat) -> bool:
    """The JAX ``unstructured_plan(mat) is not None`` for a flat matrix
    (without running the routing it would compute)."""
    nnz, R = mat.nnz, mat.R
    grp = np.asarray(mat.ell["__flat_group__"][:nnz]).astype(np.int64)
    deg = np.bincount(grp, minlength=R)
    allowed = np.asarray(_ALLOWED)
    nA = len(allowed)
    remn = deg - (deg // _S_CAP) * _S_CAP
    has_rem = (remn > 0) | (deg == 0)
    full_k = (deg // _S_CAP).reshape(-1, 128).sum(axis=1)
    rem_cls = np.where(has_rem,
                       np.searchsorted(allowed, np.maximum(remn, 1)), nA)
    ngrp = R // 128
    grp_cls = np.zeros((ngrp, nA), np.int64)
    gidx128 = np.repeat(np.arange(ngrp), 128)
    sel = rem_cls < nA
    np.add.at(grp_cls, (gidx128[sel], rem_cls[sel]), 1)
    grp_cls[:, nA - 1] += full_k
    if _padded(grp_cls.sum(axis=0)) > _MAX_TOTAL_M:
        return False
    cuts = [0]
    acc = np.zeros(nA, np.int64)
    for g in range(ngrp):
        if acc.any() and _padded(acc + grp_cls[g]) > _BLOCK_TARGET:
            cuts.append(g * 128)
            acc[:] = 0
        acc += grp_cls[g]
    cuts.append(R)
    return all(_block_fits(deg[r0:r1]) for r0, r1 in zip(cuts[:-1], cuts[1:]))


def attach_plan(mat):
    """``mat`` with ``unstr_attached`` set where the JAX build would
    attach its plan (formats.protected and formats.split call it on the
    layouts they adopt)."""
    if wants_unstructured(mat) and not mat.unstr_attached \
            and plan_attaches(mat):
        return replace(mat, unstr_attached=True)
    return mat
