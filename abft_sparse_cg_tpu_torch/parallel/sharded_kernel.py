"""The row-sharded kernel tier: kernels A and C per shard, with a halo
exchange.

Counterpart of ``abft_sparse_cg_tpu.parallel.sharded_kernel`` (see its
docstring), whose ``shard_map`` body runs the per-iteration Pallas
kernels per shard.  Here one process drives every shard of a mesh
(parallel.sharded.Mesh), with one launch per shard:

  - each shard holds its own contiguous rows of the planes
    (parallel.sharded.ShardedDevice), placed by
    ``_device_put_sharded``;
  - ``halo_exchange`` builds each shard's x_ext, its R_loc rows of x with
    the neighbour shards' H edge rows on each side and zeros at the
    global ends, as the two ``lax.ppermute`` edges do
    (sharded_kernel.py:173-175 of the JAX package).  It is the one place
    that shards on distinct cards would replace with peer copies;
  - kernel A's halo form (``dia_fast_halo``) or kernel C's halo form
    (``ell_fast_halo``, the shard's first row as ``base``), each through a
    launcher resolved once per shard, computes the shard's w, trigger and
    pw in one device launch;
  - the trigger is the OR over shards and pw the sum over shards in shard
    order, as the ``lax.psum``s (:190-191);
  - classify, correct and scrub run on the whole planes, as JAX's GSPMD
    classify does, and the shard copies are re-derived from the scrubbed
    planes before the loop resumes.

All shard launches go on the current stream of the first shard's device,
one after another: the one-launch epilogue of kernels A and C counts
blocks with one counter per library (csrc/dia_common.cuh::finish_call),
so two launches of one kernel must never run at once.
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
from .sharded import ShardedDevice, shard_rows

__all__ = ["supports_shardmap", "make_shardmap_spmv", "halo_exchange"]


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


def halo_exchange(x: torch.Tensor, mesh, halo: int) -> list:
    """Each shard's x_ext of ``mesh``: [left neighbour's last ``halo``
    rows | the shard's R / N rows | right neighbour's first ``halo``
    rows], zeros past the global ends, on the shard's device."""
    n = mesh.size
    R_loc = x.shape[0] // n
    zeros = x.new_zeros(halo)
    out = []
    for s, dev in enumerate(mesh.devices):
        lo = x[s * R_loc - halo:s * R_loc] if s else zeros
        hi = x[(s + 1) * R_loc:(s + 1) * R_loc + halo] if s < n - 1 else zeros
        out.append(torch.cat([lo, x[s * R_loc:(s + 1) * R_loc], hi]).to(dev))
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
            make_shardmap_spmv(mat.main, mesh, dtype, mode, detect), tail,
            mat.main.exec_size)
    R_loc = mat.R // n
    H = _halo(mat)
    is_dia = mat.exec_kind == "dia"
    spec = (dia_spec if is_dia else ell_spec)(mat, mode)
    if not detect:
        spec = product_spec(mat, mode)
    last = [None, None]       # the ShardedDevice, its shard callables

    def fast_pw(smd: ShardedDevice, x):
        if last[0] is not smd:
            last[:] = smd, _shard_kernels(smd, spec, H, is_dia, R_loc)
        outs = [f(xe) for f, xe in
                zip(last[1], halo_exchange(x, mesh, H))]
        dev = x.device
        w = torch.cat([o[0].to(dev) for o in outs])
        trig, pw = outs[0][1].to(dev), outs[0][2].to(dev)
        for _, t, p in outs[1:]:
            trig = trig | t.to(dev)
            pw = pw + p.to(dev)
        return w, trig, pw

    def fast(smd, x):
        w, trig, _ = fast_pw(smd, x)
        return w, trig

    if not detect:
        return SpmvImpl(full=None, fast=fast, fast_pw=fast_pw)
    return _wrap_mode(mat, dtype, mode, mesh, fast, fast_pw)


def _wrap_mode(mat, dtype, mode, mesh, fast, fast_pw) -> SpmvImpl:
    """SpmvImpl around the sharded ``fast``/``fast_pw`` (spmv_cuda.
    _wrap_mode): the rare paths run the plain ops.spmv ones on the whole
    planes, and a classify hands back shard copies re-derived from the
    scrubbed planes."""
    plain = make_spmv(mat, dtype, mode)

    def classify(smd):
        stats, md = plain.classify(smd.md)
        return stats, ShardedDevice(md, shard_rows(md, mesh))

    if mode == "none":
        def full_none(smd, x):
            return fast(smd, x)[0], SpmvStats.clean()

        return SpmvImpl(full=full_none, fast_pw=fast_pw)
    if mode == "constraints":
        check = make_constraints_check(mat)

        def full_cons(smd, x):
            return fast(smd, x)[0], check(smd.md)

        return SpmvImpl(full=full_cons, fast=fast, classify=classify,
                        fast_pw=fast_pw)
    return SpmvImpl(full=lambda smd, x: plain.full(smd.md, x), fast=fast,
                    classify=classify, fast_pw=fast_pw)
