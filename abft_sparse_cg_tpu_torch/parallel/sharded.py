"""Row-sharded CG over a 1-D mesh of shards, driven by one process.

Counterpart of ``abft_sparse_cg_tpu.parallel.sharded`` (see its
docstring).  The JAX package shards with GSPMD: one program, its
operands laid out over a 1-D device mesh, XLA inserting the collectives.
Here a mesh is a tuple of ``torch.device``s, one per shard, that one
process drives, as JAX's single controller drives its shards.  The
devices may be distinct cards (``default_mesh(N)``), or every shard may
live on one card or on the CPU (``default_mesh(N, device)``): the three
run the same code, and only which device a shard's tensors and launches
live on differs.

  - ``_device_put_sharded`` uploads, for a matrix (a split's banded main
    part) in the kernel tier's envelope, each shard's rows of every plane
    from the host straight onto its own device (``upload_shards``: a
    ``ShardedDevice``), and puts every vector per shard
    (parallel.vector.ShardedVector): b, Jacobi's M^-1, and so the
    solvers' x, r, p and w.  Between repairs no device holds a whole
    plane or a whole vector; the rare paths assemble the planes on the
    first shard's device for the repair only (``assemble_rows``,
    parallel.sharded_kernel).  A split's flat tail uploads onto the first
    shard's device, where kernel E runs it.
  - ``make_sharded_solver`` runs solver.cg's loops over the per-shard
    kernel tier inside its envelope (parallel.sharded_kernel.
    supports_shardmap); the scalars of the solve (rr, rz, alpha, beta,
    the trace) live on the first shard's device.
  - Outside the envelope (flat, float64, R not a multiple of 1024 N) the
    planes, mesh-padded to a multiple of 8 N rows (JAX's mesh padding;
    zero codewords, as the build's padding), and the vectors stay whole
    on the first shard's device, where the single-device program runs
    through that device's single-device tier (the cuda SpmvImpl on a
    card, the plain one on the CPU): GSPMD computes the same numbers.
    The JAX package entry-shards flat planes and split tails
    (``_put_flat``, padding the entries to 8 * N); that moves where
    partial sums are taken, not what the program computes, and the flat
    planes here keep their build-time length, which kernel E's row plan
    requires (a decided divergence, ROADMAP.md queue 3).
"""

from __future__ import annotations

from dataclasses import replace
from typing import NamedTuple

import numpy as np
import torch

from ..formats.protected import ProtectedMatrix
from ..ops.spmv import (
    MatrixDevice,
    make_matrix_device,
    make_spmv,
    perm_positions,
)
from ..solver.cg import make_cg_continue, make_lazy_ci_continue, solver_of
from .vector import ShardedVector

__all__ = ["Mesh", "ShardedDevice", "ShardedVector", "default_mesh",
           "pad_rows", "mesh_rows", "shard_rows", "upload_shards",
           "assemble_rows", "sharded_spmv",
           "make_sharded_continue", "make_sharded_solver", "solve_sharded"]


class Mesh(NamedTuple):
    """A 1-D mesh: one ``torch.device`` per shard; a device may hold
    several shards."""

    devices: tuple

    @property
    def size(self) -> int:
        return len(self.devices)


def default_mesh(n_devices=None, device=None) -> Mesh:
    """``device`` given: ``n_devices`` shards (default 1), all on that
    device — a one-card mesh, or the CPU's.  Otherwise one shard per
    CUDA card, the first ``n_devices`` of them (default all), as the
    JAX function takes ``jax.devices()[:n]``."""
    if device is not None:
        return Mesh((torch.device(device),) * (n_devices or 1))
    devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(tuple(devs))


def pad_rows(arr: np.ndarray, R_pad: int, axis: int = 0):
    pad = R_pad - arr.shape[axis]
    if pad == 0:
        return arr
    width = [(0, 0)] * arr.ndim
    width[axis] = (0, pad)
    return np.pad(arr, width)


def mesh_rows(mat, n: int) -> int:
    """R padded to a multiple of 8 * n (sharded.py:155)."""
    return -(-mat.R // (8 * n)) * (8 * n)


class ShardedDevice(NamedTuple):
    """A row-sharded DIA or banded-ELL matrix on a mesh: one MatrixDevice
    per shard, on its device, holding its own contiguous R / N rows of
    words, values, fold, ell_len and gidx and its R / 8N blocks of the
    checksum baselines.  No device holds the whole planes: the repair
    assembles them on the first shard's device for the classify only
    (``assemble_rows``) and splits the scrubbed planes back
    (``shard_rows``)."""

    shards: tuple


def shard_rows(md: MatrixDevice, mesh: Mesh) -> tuple:
    """Each shard's own contiguous copies of its R / N rows of ``md``'s
    planes (checksum baselines: its R / 8N blocks), on its device."""
    n = mesh.size
    R = md.values.shape[-1]
    if R % (8 * n):
        raise ValueError(f"{R} rows do not split into {n} shards of whole "
                         "8-row checksum blocks")
    R_loc = R // n

    def own(t, s, dev, per=1):
        if t is None:
            return None
        sl = slice(s * R_loc // per, (s + 1) * R_loc // per)
        return t[..., sl].to(dev, copy=True,
                             memory_format=torch.contiguous_format)

    return tuple(
        MatrixDevice(
            words=tuple(own(w, s, dev) for w in md.words),
            cksum=own(md.cksum, s, dev, 8), values=own(md.values, s, dev),
            fold=own(md.fold, s, dev), fold_ck=own(md.fold_ck, s, dev, 8),
            ell_len=own(md.ell_len, s, dev), gidx=own(md.gidx, s, dev))
        for s, dev in enumerate(mesh.devices))


def upload_shards(mat: ProtectedMatrix, mesh: Mesh, dtype) -> ShardedDevice:
    """Each shard's rows of every plane of ``mat`` (R a multiple of 8 N)
    uploaded from the host straight onto its own device, derived there
    (ops.spmv.make_matrix_device's ``rows``): equal to ``shard_rows`` of
    the whole upload, without the whole upload."""
    n = mesh.size
    if mat.R % (8 * n):
        raise ValueError(f"{mat.R} rows do not split into {n} shards of "
                         "whole 8-row checksum blocks")
    R_loc = mat.R // n
    return ShardedDevice(tuple(
        make_matrix_device(mat, dtype, dev, rows=(s * R_loc, (s + 1) * R_loc))
        for s, dev in enumerate(mesh.devices)))


def assemble_rows(smd: ShardedDevice, mat: ProtectedMatrix,
                  device) -> MatrixDevice:
    """The whole planes of ``smd`` on ``device`` (and ``mat``'s
    ``perm_pos`` under a permutation): what the rare paths of a repair
    read (classify, the ECC ``full``, the constraints check), dropped
    when they return."""
    parts = smd.shards

    def cat(get, dim=-1):
        ts = [get(md) for md in parts]
        if ts[0] is None:
            return None
        return torch.cat([t.to(device) for t in ts], dim)

    return MatrixDevice(
        words=tuple(cat(lambda md, i=i: md.words[i])
                    for i in range(len(parts[0].words))),
        cksum=cat(lambda md: md.cksum), values=cat(lambda md: md.values),
        fold=cat(lambda md: md.fold), fold_ck=cat(lambda md: md.fold_ck),
        ell_len=cat(lambda md: md.ell_len), gidx=cat(lambda md: md.gidx),
        perm_pos=(perm_positions(mat, device) if mat.perm is not None
                  and mat.exec_kind == "ell" else None))


def _pad_matrix(mat: ProtectedMatrix, R_pad: int) -> ProtectedMatrix:
    """``mat`` with R_pad rows: zero codewords appended to every row
    plane, zero checksum blocks, exec slots k * R + r moved to k * R_pad
    + r (a flat matrix keeps its entries; its row count grows)."""
    if R_pad == mat.R:
        return mat
    ell_len = pad_rows(mat.ell_len, R_pad)
    if mat.exec_kind == "flat":
        return replace(mat, ell_len=ell_len)
    ell = {k: pad_rows(v, R_pad, 1) for k, v in mat.ell.items()}
    k, r = np.divmod(mat.ell_slot, mat.R)
    return replace(mat, ell=ell, ell_len=ell_len, ell_slot=k * R_pad + r,
                   ell_cksum=pad_rows(mat.ell_cksum, R_pad // 8, 1))


def _device_put_sharded(mat, b: np.ndarray, mesh: Mesh, dtype):
    """``(md, b, put_vec)``: the upload of ``mat`` onto ``mesh``
    (sharded.py:120), b in execution order, and the function that puts
    any canonical (N,) vector so.  A matrix (a split's main part) in the
    kernel tier's envelope uploads each shard's rows straight onto its
    device (a ShardedDevice) and its vectors as ShardedVectors; a split's
    flat tail uploads onto the first shard's device.  Any other matrix
    uploads its mesh-padded planes, and its vectors whole, onto the first
    shard's device, where the single-device program runs."""
    from .sharded_kernel import supports_shardmap

    n = mesh.size
    dev = mesh.devices[0]
    if mat.exec_kind == "split":
        # The composite's slot offset (main.exec_size) is baked against
        # the single-device exec grid: the mesh must not re-pad the main
        # part's rows.
        if mat.R % (8 * n):
            raise ValueError(
                f"bordered-split sharding needs R ({mat.R}) divisible by "
                f"8 * n_devices ({8 * n}) so exec slots keep their "
                "single-device grid; use fewer devices")
        md_main, bdev, put_vec = _device_put_sharded(mat.main, b, mesh,
                                                     dtype)
        return ((md_main, make_matrix_device(mat.tail, dtype, dev)), bdev,
                put_vec)
    R_pad = mesh_rows(mat, n)
    sharded = supports_shardmap(mat, dtype, n)
    if sharded:
        md = upload_shards(mat, mesh, dtype)
    else:
        md = make_matrix_device(_pad_matrix(mat, R_pad), dtype, dev)

    def put_vec(v):
        """Canonical (N,) host vector -> exec-order, padded, placed as
        the matrix is."""
        vpad = np.zeros(R_pad, dtype=np.float64)
        vpad[: mat.N] = mat.to_exec_order(np.asarray(v, np.float64))
        t = torch.tensor(vpad, dtype=dtype)
        if sharded:
            return ShardedVector.scatter(t, mesh.devices)
        return t.to(dev)

    return md, put_vec(b), put_vec


def sharded_spmv(mat: ProtectedMatrix, mesh: Mesh, dtype, mode: str = None):
    """The SpmvImpl of ``mat`` on ``mesh``, for the upload of
    ``_device_put_sharded``: the per-shard kernels inside the kernel
    envelope (``make_shardmap_spmv``), else the single-device SpmvImpl
    of the mesh's device on the mesh-padded planes (the cuda one on a
    card, the plain one on the CPU), which computes what GSPMD's program
    computes (sharded.py:216)."""
    from .sharded_kernel import make_shardmap_spmv, supports_shardmap

    mode = mat.mode if mode is None else mode
    if supports_shardmap(mat, dtype, mesh.size):
        return make_shardmap_spmv(mat, mesh, dtype, mode)
    if mesh.devices[0].type == "cuda":
        from ..ops.spmv_cuda import make_cuda_spmv

        return make_cuda_spmv(mat, dtype, mode)
    return make_spmv(mat, dtype, mode)


def make_sharded_continue(mat: ProtectedMatrix, mesh: Mesh,
                          conv_threshold: float, dtype, mode: str = None,
                          check_interval: int = 1):
    """``continue_(md, state, upto, minv=None) -> (CGState, md)`` of
    ``mat`` on ``mesh`` (solver.cg's contract), as pallas_backend.py:
    72-125 and :222-258 route: solver.cg's loop over ``sharded_spmv``,
    on the lazy schedule over the per-shard kernels' detection-free form
    when ``check_interval`` > 1 inside the kernel envelope; live
    outside it."""
    from .sharded_kernel import make_shardmap_spmv, supports_shardmap

    mode = mat.mode if mode is None else mode
    spmv = sharded_spmv(mat, mesh, dtype, mode)
    if (check_interval > 1 and spmv.classify is not None
            and supports_shardmap(mat, dtype, mesh.size)):
        product = make_shardmap_spmv(mat, mesh, dtype, mode, detect=False)
        return make_lazy_ci_continue(spmv, product, check_interval,
                                     conv_threshold)
    return make_cg_continue(spmv, conv_threshold)


def make_sharded_solver(mat: ProtectedMatrix, mesh: Mesh, max_itrs: int,
                        conv_threshold: float, dtype, mode: str = None,
                        check_interval: int = 1):
    """``solve(md, b, minv=None) -> CGResult`` of ``mat`` on ``mesh``,
    for the upload of ``_device_put_sharded``: solver.cg's loops over
    ``make_sharded_continue``."""
    return solver_of(make_sharded_continue(mat, mesh, conv_threshold,
                                           dtype, mode, check_interval),
                     max_itrs)


def solve_sharded(mat: ProtectedMatrix, b: np.ndarray, max_itrs: int,
                  conv_threshold: float, mesh: Mesh = None, dtype=None):
    """Row-sharded CG over all CUDA cards, or over ``mesh``.  ``b`` is in
    canonical order; the returned ``CGResult.x`` is in execution order
    and mesh-padded (map back with ``mat.from_exec_order`` after
    stripping the padding), a ShardedVector on the kernel tier (``.cpu()``
    gathers it)."""
    if mesh is None:
        mesh = default_mesh()
    dtype = dtype or torch.float32
    md, bdev, _ = _device_put_sharded(mat, b, mesh, dtype)
    return make_sharded_solver(mat, mesh, max_itrs, conv_threshold,
                               dtype)(md, bdev)
