"""Row-sharded CG over a 1-D mesh of shards, driven by one process.

Counterpart of ``abft_sparse_cg_tpu.parallel.sharded`` (see its
docstring).  The JAX package shards with GSPMD: one program, its
operands laid out over a 1-D device mesh, XLA inserting the collectives.
Here a mesh is a tuple of ``torch.device``s, one per shard, that one
process drives, as JAX's single controller drives its shards.  On one
card, and on the CPU, every shard of the mesh lives on that device.

  - ``_device_put_sharded`` uploads the planes padded to a multiple of
    8 * N rows (JAX's mesh padding; zero codewords, as the build's
    padding) onto the first shard's device and, for a matrix (a split's
    banded main part) in the kernel tier's envelope, gives each shard
    its own contiguous copies of its rows of every plane it reads, on
    its own device (``ShardedDevice``): what the per-shard kernels of
    parallel.sharded_kernel read.  The vectors stay whole (R,) tensors
    on the first shard's device.
  - ``make_sharded_solver`` runs the per-shard kernel tier inside its
    envelope (parallel.sharded_kernel.supports_shardmap) and otherwise
    the single-device program that GSPMD runs, on the mesh-padded
    planes, through the device's single-device tier (the cuda SpmvImpl
    on a card, the plain one on the CPU): GSPMD computes the same
    numbers.  The JAX package entry-shards flat planes and split tails
    (``_put_flat``, padding the entries to 8 * N); that moves where
    partial sums are taken, not what the program computes, and the flat
    planes here keep their build-time length, which kernel E's row plan
    requires.

Shards on distinct cards need per-shard vectors and peer copies, which
no machine here can verify: a mesh of distinct devices is refused
(ROADMAP.md queue 1 item 11).
"""

from __future__ import annotations

from dataclasses import replace
from typing import NamedTuple

import numpy as np
import torch

from ..formats.protected import ProtectedMatrix, not_ported
from ..ops.spmv import MatrixDevice, make_matrix_device, make_spmv
from ..solver.cg import make_cg_continue, make_lazy_ci_continue, solver_of

__all__ = ["Mesh", "ShardedDevice", "default_mesh", "pad_rows",
           "mesh_rows", "shard_rows", "sharded_spmv",
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
    """A row-sharded DIA or banded-ELL matrix on a mesh.  ``md``: the
    whole (mesh-padded) planes on the first shard's device, which the
    rare paths read (classify, correct and scrub, the ECC ``full``);
    ``shards``: one MatrixDevice per shard, on its device, holding its
    own contiguous rows of words, values, fold, ell_len, gidx and the
    checksum baselines (re-derived from ``md`` after a scrub)."""

    md: MatrixDevice
    shards: tuple

    @property
    def cksum(self):
        """The stored-checksum baseline (solver.cg's repair check)."""
        return self.md.cksum


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
    """``(md, b, put_vec)``: the mesh-padded upload of ``mat`` onto
    ``mesh`` (sharded.py:120), b in execution order, and the function
    that puts any canonical (N,) vector so.  A matrix (a split's main
    part) in the kernel tier's envelope uploads as a ShardedDevice;
    any other as the whole planes only."""
    from .sharded_kernel import supports_shardmap

    n = mesh.size
    if len(set(mesh.devices)) > 1:
        raise not_ported("a mesh of shards on distinct devices", "11")
    dev = mesh.devices[0]
    if mat.exec_kind == "split":
        # The composite's slot offset (main.exec_size) is baked against
        # the single-device exec grid: the mesh must not re-pad the
        # main part's rows.
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
    md = make_matrix_device(_pad_matrix(mat, R_pad), dtype, dev)
    if supports_shardmap(mat, dtype, n):
        md = ShardedDevice(md, shard_rows(md, mesh))

    def put_vec(v):
        """Canonical (N,) host vector -> exec-order, padded."""
        vpad = np.zeros(R_pad, dtype=np.float64)
        vpad[: mat.N] = mat.to_exec_order(np.asarray(v, np.float64))
        return torch.tensor(vpad, dtype=dtype, device=dev)

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
    stripping the padding)."""
    if mesh is None:
        mesh = default_mesh()
    dtype = dtype or torch.float32
    md, bdev, _ = _device_put_sharded(mat, b, mesh, dtype)
    return make_sharded_solver(mat, mesh, max_itrs, conv_threshold,
                               dtype)(md, bdev)
