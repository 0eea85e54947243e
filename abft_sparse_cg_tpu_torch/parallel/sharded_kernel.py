"""The row-sharded kernel tier: kernels A and C per shard, with a halo
exchange.

Counterpart of ``abft_sparse_cg_tpu.parallel.sharded_kernel`` (see its
docstring), whose ``shard_map`` body runs the per-iteration Pallas
kernels per shard.  Here one process drives every shard of a mesh
(parallel.sharded.Mesh), with one launch per shard, each on its shard's
device; the vectors are parallel.vector.ShardedVectors:

  - each shard holds its own contiguous rows of the planes
    (parallel.sharded.ShardedDevice), placed by
    ``_device_put_sharded``;
  - ``halo_exchange`` fills each shard's preallocated x_ext, its R_loc
    rows of x with the neighbour shards' H edge rows on each side and
    zeros at the global ends: only the edges cross a device boundary
    (``copy_edge``), as the two ``lax.ppermute`` edges do
    (sharded_kernel.py:173-174 of the JAX package);
  - kernel A's halo form (``dia_fast_halo``) or kernel C's halo form
    (``ell_fast_halo``, the shard's first row as ``base``), each through a
    launcher resolved once per shard, computes the shard's w, trigger and
    pw in one device launch; w stays on the shard;
  - the trigger is the OR over shards and pw the sum over shards in shard
    order, on the first shard's device, as the ``lax.psum``s (:190-191);
  - a split's flat tail runs on the first shard's device (kernel E), on
    p gathered there, and its w is added back into each shard's rows;
  - classify, correct and scrub run on the whole planes, assembled on the
    first shard's device for the repair only, as JAX's GSPMD classify
    names the same element and slot; the scrubbed rows go back to their
    shards and nothing whole stays resident.

Shards on one card launch in turn on that card's current stream: the
one-launch epilogue of kernels A and C counts blocks with one counter per
library per card (csrc/dia_common.cuh::finish_call), so two launches of
one kernel must never run at once on a card.  Shards on distinct cards
launch on their own cards' streams and may run at once.
"""

from __future__ import annotations

import torch

from ..ops.spmv import (
    SpmvImpl,
    SpmvStats,
    combine_impls,
    make_constraints_check,
    make_spmv,
)
from ..ops.spmv_cuda import (
    _ELL_MAX_K,
    dia_fast_halo,
    dia_launcher,
    dia_spec,
    ell_fast_halo,
    ell_launcher,
    ell_spec,
    make_cuda_product,
    make_cuda_spmv,
    product_spec,
)
from .sharded import ShardedDevice, assemble_rows, shard_rows
from .vector import ShardedVector

__all__ = ["supports_shardmap", "make_shardmap_spmv", "halo_exchange",
           "ext_buffers", "copy_edge"]


def _halo(mat) -> int:
    """H: the largest |offset| (DIA) or the band (ELL), rounded up to 128
    rows, as the TPU kernels' x windows (spmv_pallas.py:115-123)."""
    if mat.exec_kind == "dia":
        m = max((abs(o) for o in mat.dia_offsets), default=0)
    else:
        m = max(mat.band, 0)
    return -(-m // 128) * 128


def supports_shardmap(mat, dtype, ndev: int) -> bool:
    """The envelope of the kernel tier (sharded_kernel.py:319): a DIA or
    banded-ELL matrix (a split through its banded main part, with a flat
    tail), float32, shard rows a multiple of 1024, and the halo within
    one neighbour's rows (a two-edge exchange).  The JAX envelope's
    Mosaic caps (``_ellb_ok``) are TPU limits; kernel C's own cap is K
    <= 512."""
    if ndev < 2 or dtype != torch.float32:
        return False
    if mat.exec_kind == "split":
        return (getattr(mat.tail, "exec_kind", None) == "flat"
                and supports_shardmap(mat.main, dtype, ndev))
    if mat.exec_kind not in ("dia", "ell"):
        return False
    if mat.R % (1024 * ndev):
        return False
    R_loc = mat.R // ndev
    if mat.exec_kind == "ell" and not 1 <= mat.K <= _ELL_MAX_K:
        return False
    return _halo(mat) <= R_loc


def copy_edge(dst: torch.Tensor, src: torch.Tensor):
    """One neighbour edge of a halo exchange: ``src``'s rows (on the
    neighbour's device) into ``dst`` (rows of an x_ext on the shard's):
    the rows that cross a device boundary, one ``lax.ppermute`` edge.
    torch orders a copy between two cards against the current streams of
    both."""
    dst.copy_(src, non_blocking=True)


def ext_buffers(x: ShardedVector, halo: int) -> list:
    """One zeroed x_ext of R_loc + 2 ``halo`` rows per shard of ``x``, on
    its device: ``halo_exchange``'s preallocated output (the rows past the
    global ends are never written, so stay zero)."""
    R_loc = x.parts[0].shape[0]
    return [p.new_zeros(R_loc + 2 * halo) for p in x.parts]


def halo_exchange(x: ShardedVector, halo: int, out: list = None) -> list:
    """Each shard's x_ext of ``x``: [left neighbour's last ``halo`` rows |
    the shard's R_loc rows | right neighbour's first ``halo`` rows],
    zeros past the global ends, on the shard's device, written into
    ``out`` (``ext_buffers``; allocated when None).  Only the 2 ``halo``
    edge rows of an interior shard cross a device boundary (``copy_edge``,
    the two ``lax.ppermute`` edges of sharded_kernel.py:173-174); its own
    rows are a copy on its device."""
    if out is None:
        out = ext_buffers(x, halo)
    parts, n = x.parts, len(x.parts)
    R_loc = parts[0].shape[0]
    for s, ext in enumerate(out):
        ext[halo:halo + R_loc].copy_(parts[s])
        if halo and s:
            copy_edge(ext[:halo], parts[s - 1][R_loc - halo:])
        if halo and s < n - 1:
            copy_edge(ext[halo + R_loc:], parts[s + 1][:halo])
    return out


def _shard_kernels(smd: ShardedDevice, spec, halo: int, is_dia: bool,
                   R_loc: int) -> list:
    """One callable x_ext -> (w, trig, pw) per shard of ``smd``: the
    launcher of kernel A's or C's halo form (C's with the shard's first
    row), resolved once for the shard; the plain versions on the CPU."""
    fns = []
    for s, md in enumerate(smd.shards):
        dev = md.values.device
        if dev.type == "cuda":
            fns.append(dia_launcher(md, spec, dev, halo) if is_dia
                       else ell_launcher(md, spec, dev, halo, s * R_loc))
        elif is_dia:
            fns.append(lambda x, m=md: dia_fast_halo(m, x, spec, halo))
        else:
            fns.append(lambda x, m=md, b=s * R_loc:
                       ell_fast_halo(m, x, spec, halo, b))
    return fns


def make_shardmap_spmv(mat, mesh, dtype=torch.float32, mode: str = None,
                       detect: bool = True) -> SpmvImpl:
    """The SpmvImpl of the kernel tier on ``mesh`` (sharded_kernel.py:
    342): the same contract as ``make_cuda_spmv``, on a ShardedDevice
    (a split: on the (ShardedDevice, tail MatrixDevice) pair of
    ``_device_put_sharded``).  ``detect=False``: the detection-free
    per-shard products of the lazy ``--check-interval`` schedule's
    unchecked iterations (``full`` and ``classify`` None, as
    ``make_cuda_product``).  A split's flat tail runs on the first
    shard's device through the single-device tier, kernel E."""
    mode = mat.mode if mode is None else mode
    n = mesh.size
    if not supports_shardmap(mat, dtype, n):
        raise ValueError("matrix outside the shard_map kernel envelope")
    if mat.exec_kind == "split":
        tail = (make_cuda_spmv if detect else make_cuda_product)(
            mat.tail, dtype, mode)
        return combine_impls(
            make_shardmap_spmv(mat.main, mesh, dtype, mode, detect),
            _on_first(tail, mesh), mat.main.exec_size)
    R_loc = mat.R // n
    H = _halo(mat)
    is_dia = mat.exec_kind == "dia"
    spec = (dia_spec if is_dia else ell_spec)(mat, mode)
    if not detect:
        spec = product_spec(mat, mode)
    last = [None, None]       # the ShardedDevice, its shard callables
    bufs = []                 # the shards' x_ext, allocated at first use
    first = mesh.devices[0]

    def fast_pw(smd: ShardedDevice, x: ShardedVector):
        if last[0] is not smd:
            last[:] = smd, _shard_kernels(smd, spec, H, is_dia, R_loc)
        if not bufs:
            bufs.extend(ext_buffers(x, H))
        outs = [f(xe) for f, xe in
                zip(last[1], halo_exchange(x, H, bufs))]
        # The trigger's OR and pw's sum over shards, in shard order, on
        # the first shard's device (the lax.psum's, :190-191); w stays
        # on the shards.
        trig, pw = outs[0][1], outs[0][2]
        for _, t, p in outs[1:]:
            trig = trig | t.to(first)
            pw = pw + p.to(first)
        return ShardedVector(o[0] for o in outs), trig, pw

    def fast(smd, x):
        w, trig, _ = fast_pw(smd, x)
        return w, trig

    if not detect:
        return SpmvImpl(full=None, fast=fast, fast_pw=fast_pw)
    return _wrap_mode(mat, dtype, mode, mesh, fast, fast_pw)


def _on_first(impl: SpmvImpl, mesh) -> SpmvImpl:
    """A split's flat tail on the first shard's device (kernel E): p
    gathered there, the one all-gather of JAX's sharded.py docstring,
    and the tail's w added back into each shard's rows.  The tail's
    planes and classify stay as the single-device tier has them."""
    first = mesh.devices[0]

    def whole(fn):
        if fn is None:
            return None

        def call(md, x):
            w, *rest = fn(md, x.gather(first))
            return (ShardedVector.scatter(w, mesh.devices), *rest)

        return call

    return SpmvImpl(full=whole(impl.full), fast=whole(impl.fast),
                    classify=impl.classify, fast_pw=whole(impl.fast_pw))


def _wrap_mode(mat, dtype, mode, mesh, fast, fast_pw) -> SpmvImpl:
    """SpmvImpl around the sharded ``fast``/``fast_pw`` (spmv_cuda.
    _wrap_mode): the rare paths assemble the whole planes on the first
    shard's device (parallel.sharded.assemble_rows), run the plain
    ops.spmv ones there, and hand back shard copies of the scrubbed
    planes; nothing whole outlives the call."""
    plain = make_spmv(mat, dtype, mode)
    first = mesh.devices[0]

    def whole(smd):
        return assemble_rows(smd, mat, first)

    def classify(smd):
        stats, md = plain.classify(whole(smd))
        return stats, ShardedDevice(shard_rows(md, mesh))

    if mode == "none":
        def full_none(smd, x):
            return fast(smd, x)[0], SpmvStats.clean()

        return SpmvImpl(full=full_none, fast_pw=fast_pw)
    if mode == "constraints":
        check = make_constraints_check(mat)

        def full_cons(smd, x):
            return fast(smd, x)[0], check(whole(smd))

        return SpmvImpl(full=full_cons, fast=fast, classify=classify,
                        fast_pw=fast_pw)

    def full(smd, x):
        w, st = plain.full(whole(smd), x.gather(first))
        return ShardedVector.scatter(w, mesh.devices), st

    return SpmvImpl(full=full, fast=fast, classify=classify,
                    fast_pw=fast_pw)
