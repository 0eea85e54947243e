"""Kernel C's schedule and its summation order, on the CPU.

Kernel C (csrc/ell_spmv_detect.cu) runs a grid of the card's resident
blocks (ops.spmv.ell_grid: blocks per SM from the occupancy query times
the SMs, at most one per warp of rows); block b takes the contiguous
warps of rows of ops.spmv.ell_block_rows, in tiles of ELL_TILE_ROWS rows,
and streams each tile's (K, rows) planes through a ring of ELL_STAGES
slabs of ELL_SLAB slots in shared memory: slab s + ELL_STAGES - 1 is
issued while slab s is summed, and slab s + 1's x gathers are in flight
meanwhile; value and gather slabs past the tile's longest row are
skipped, the signal plane is read over all K slots.  The
kernel needs the card; these tests hold what it relies on, with a NumPy
replay of that schedule:

  - the blocks' rows partition [0, R) in whole warps, balanced to one
    warp;
  - every (row, slot) below the row's length is summed exactly once, in
    slot order, from the slab the ring holds for it when it is read (a
    stage is never overwritten before it is consumed, nor before the
    gathers one slab ahead have read it); every signal word is folded
    exactly once; no value slab past a tile's longest row is copied;
  - the replay's w is bit-identical to ``ops.spmv.ell_product`` (the
    plain version kernel C is held to on the card), NaN payloads aside,
    and its trigger equals ``signals_plain``, clean and with a flipped
    bit.

Shapes: the whole dense-radius-3d -b 10 shape (R 221,184, K 175) and one
shard of it (R_loc 55,296) on 132 SMs, schedule only (their planes would
take hundreds of MB here); with data: that shard's rows at K = 21, R =
32, K = 1, K = 13 (not a multiple of the slab), tiles of empty rows, a
built dense-radius-3d matrix in every mode, and the edge matrices the
card is held to (utils.ell_edges).
"""

import numpy as np
import pytest
import torch

from abft_sparse_cg_tpu_torch.formats import assemble, build_protected
from abft_sparse_cg_tpu_torch.inject import inject_bitflips
from abft_sparse_cg_tpu_torch.ops.spmv import (
    ELL_SLAB,
    ELL_STAGES,
    ELL_TILE_ROWS,
    MatrixDevice,
    ell_block_rows,
    ell_grid,
    ell_product,
    make_matrix_device,
)
from abft_sparse_cg_tpu_torch.ops.spmv_cuda import (
    EllSpec,
    ell_gather_plane,
    ell_spec,
    signals_plain,
)
from abft_sparse_cg_tpu_torch.utils.ell_edges import (
    ROW_CUT,
    cut_rows,
    ell_edge_cases,
)
from abft_sparse_cg_tpu_torch.utils.matzoo import dense_radius_3d

torch.set_num_threads(1)
CPU = torch.device("cpu")
F32 = np.float32
SMS = 132                   # H100 SXM
MODES = ["none", "constraints", "sed", "sec7", "sec8", "secded"]


def gather_np(g, R):
    """The jnp gather rule of ell_gather (dia_common.cuh): int32, below
    zero wraps once by R, then clamp into [0, R)."""
    g = g.astype(np.int64)
    g = np.where(g < 0, g + R, g)
    return np.clip(g, 0, R - 1)


def parity(words):
    """popcount & 1 of each uint32 word."""
    v = words.copy()
    for sh in (16, 8, 4, 2, 1):
        v ^= v >> np.uint32(sh)
    return (v & np.uint32(1)).astype(bool)


def replay(K, R, ell_len, per_sm, values=None, gidx=None, x=None,
           plane=None, base=None, use_parity=False, use_cksum=False,
           signals=None, sms=SMS):
    """Kernel C's schedule in NumPy.  Without ``values`` only the
    schedule runs (coverage, order, ring stages; ``signals`` True: the
    signal slabs too, without a plane); returns (w or None, trigger,
    summed count per (slot, row), folded count per (slot, row)).
    ``sms``: the card's SMs."""
    grid = ell_grid(R, sms, per_sm)
    blocks = ell_block_rows(R, grid)
    T, S, P = ELL_TILE_ROWS, ELL_SLAB, ELL_STAGES
    data = values is not None
    if signals is None:
        signals = plane is not None
    nsig = -(-K // S) if signals else 0
    summed = np.zeros((K, R), np.int8)
    folded = np.zeros((K, R), np.int8)
    last = np.full(R, -1, np.int64)        # the last slot summed, per row
    w = np.full(R, np.nan, F32) if data else None
    g_all = gather_np(gidx, R) if data else None
    trig = False
    for lo, hi in blocks.tolist():
        for r0 in range(lo, hi, T):
            nrows = min(T, hi - r0)
            assert nrows % 32 == 0
            rows = np.arange(r0, r0 + nrows)
            n = np.clip(ell_len[rows], 0, K)
            nval = -(-int(n.max()) // S)
            nsl = max(nval, nsig)
            tag = np.full((P, 2), -1)       # the slab each stage holds
            ring_v = np.zeros((P, S, T), F32)
            ring_g = np.zeros((P, S, T), np.int64)
            ring_s = np.zeros((P, S, T), np.uint32)

            def issue(s):
                st, k0 = s % P, s * S
                ns = min(S, K - k0)
                if s < nval:
                    tag[st, 0] = s
                    if data:
                        ring_v[st, :ns, :nrows] = values[k0:k0 + ns, rows]
                        ring_g[st, :ns, :nrows] = g_all[k0:k0 + ns, rows]
                if s < nsig:
                    tag[st, 1] = s
                    if plane is not None:
                        ring_s[st, :ns, :nrows] = plane[k0:k0 + ns, rows]

            def gather(s):
                """Slab s's x gathers (zeros where a row has no slot)."""
                assert tag[s % P, 0] == s
                if not data:
                    return None
                return x[ring_g[s % P, :, :nrows]]

            for s in range(P - 1):
                if s < nsl:
                    issue(s)
            wr = np.zeros(nrows, F32)
            acc = np.zeros(nrows, np.uint32)
            odd = np.zeros(nrows, bool)
            xc = None
            for s in range(nsl):
                if s + P - 1 < nsl:
                    issue(s + P - 1)        # before slab s is read
                st, k0 = s % P, s * S
                ns = min(S, K - k0)
                # The gathers run one slab ahead: slab s + 1's are read
                # from its stage while slab s is summed.
                if s == 0 and nval:
                    xc = gather(0)
                xn = gather(s + 1) if s + 1 < nval else None
                if s < nsig:
                    assert tag[st, 1] == s
                    words = ring_s[st, :ns, :nrows]
                    folded[k0:k0 + ns, rows] += 1
                    odd |= parity(words).any(axis=0)
                    acc ^= np.bitwise_xor.reduce(words, axis=0)
                cnt = np.clip(n - k0, 0, S)
                if cnt.max() > 0:
                    assert tag[st, 0] == s
                for j in range(S):
                    on = cnt > j
                    if not on.any():
                        continue
                    k = k0 + j
                    r = rows[on]
                    assert np.all(last[r] == k - 1)
                    last[r] = k
                    summed[k, r] += 1
                    if data:
                        prod = (ring_v[st, j, :nrows][on]
                                * xc[j][on]).astype(F32)
                        wr[on] = (wr[on] + prod).astype(F32)
                xc = xn
            if data:
                w[rows] = wr
            if plane is not None:
                if use_parity:
                    trig |= bool(odd.any())
                if use_cksum:
                    blk = np.bitwise_xor.reduce(acc.reshape(-1, 8), axis=1)
                    trig |= bool(np.any(blk != base[rows[::8] // 8]))
    return w, trig, summed, folded


def check_coverage(K, R, ell_len, summed, folded, signals):
    valid = np.arange(K)[:, None] < np.clip(ell_len, 0, K)[None, :]
    assert np.array_equal(summed, valid.astype(np.int8))
    assert np.all(folded == (1 if signals else 0))


@pytest.mark.parametrize("per_sm", [2, 4])
@pytest.mark.parametrize("R", [32, 4096, 55_296, 221_184])
def test_blocks_partition_rows_in_balanced_warps(R, per_sm):
    grid = ell_grid(R, SMS, per_sm)
    assert grid == min(SMS * per_sm, R // 32)
    b = ell_block_rows(R, grid)
    assert b.shape == (grid, 2) and b[0, 0] == 0 and b[-1, 1] == R
    assert np.array_equal(b[1:, 0], b[:-1, 1])
    warps = (b[:, 1] - b[:, 0]) // 32
    assert np.all((b % 32) == 0) and np.all(warps >= 1)
    assert warps.max() - warps.min() <= 1


@pytest.mark.parametrize("R", [221_184, 55_296])
def test_schedule_covers_the_dense_radius_shape(R):
    """The whole dense-radius-3d -b 10 shape (R 221,184, K 175) and one
    shard of it (R_loc 55,296): schedule only, rows of 150-175 slots
    with runs of empty rows (the zero rows past N)."""
    K = 175
    rng = np.random.default_rng(1)
    ell_len = rng.integers(150, K + 1, R).astype(np.int32)
    ell_len[-1664:] = 0
    ell_len[4096:4096 + 256] = 0           # whole tiles of empty rows
    for per_sm in (2, 4):
        _, _, summed, folded = replay(K, R, ell_len, per_sm, signals=True)
        check_coverage(K, R, ell_len, summed, folded, True)
        # The detection-free product: only the value slabs, none past a
        # tile's longest row.
        _, _, summed, folded = replay(K, R, ell_len, per_sm)
        check_coverage(K, R, ell_len, summed, folded, False)


def synthetic(K, R, seed, empty_tiles=False):
    """(values, gather plane, ell_len, x, signal plane, baseline) of a
    random banded-ELL matrix: row lengths 0..K, gather indices around
    the row (some out of range, which the clamp handles), x with -0.0
    and a NaN."""
    rng = np.random.default_rng(seed)
    ell_len = rng.integers(0, K + 1, R).astype(np.int32)
    if empty_tiles:
        ell_len[:ELL_TILE_ROWS] = 0
        ell_len[-32:] = 0
    values = rng.standard_normal((K, R)).astype(F32)
    gidx = (np.arange(R)[None, :] + rng.integers(-40, 41, (K, R))).astype(
        np.int32)
    gidx[0, :4] = [-1, -R - 3, R + 5, 2 ** 31 - 1]
    x = rng.standard_normal(R).astype(F32)
    x[rng.integers(0, R, 8)] = -0.0
    x[R // 2] = np.nan
    plane = rng.integers(0, 2 ** 32, (K, R), dtype=np.uint32)
    base = np.bitwise_xor.reduce(
        np.bitwise_xor.reduce(plane, axis=0).reshape(-1, 8), axis=1)
    return values, gidx, ell_len, x, plane, base


def device_of(values, gidx, ell_len, plane, base):
    """A MatrixDevice whose word 0 is the signal plane (constraints
    style) and word 1 the gather plane."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a).view(np.int32))
    return MatrixDevice(words=(t(plane), t(gidx)),
                        cksum=torch.stack([t(base), t(base)]),
                        values=torch.from_numpy(values),
                        ell_len=torch.from_numpy(ell_len))


def same_bits(a, b):
    nan = np.isnan(b)
    return (np.array_equal(nan, np.isnan(a))
            and np.array_equal(a[~nan].view(np.int32),
                               b[~nan].view(np.int32)))


@pytest.mark.parametrize("K,R", [(21, 55_296), (1, 4096), (13, 4096),
                                 (8, 32), (13, 32), (1, 32), (16, 640)])
@pytest.mark.parametrize("per_sm", [2, 4])
def test_replay_is_bit_identical_with_equal_signals(K, R, per_sm):
    """Random planes (rows of 0..K slots, out-of-range gathers, -0.0 and
    NaN in x) on 132 SMs, and on one SM: blocks of many tiles."""
    replay_case(K, R, per_sm, SMS)
    replay_case(K, R, per_sm, 1)


def replay_case(K, R, per_sm, sms):
    values, gidx, ell_len, x, plane, base = synthetic(
        K, R, seed=K * 7 + R, empty_tiles=R >= 256)
    md = device_of(values, gidx, ell_len, plane, base)
    spec = EllSpec(K, True, True, 0, 1, False, rows=R)
    want = ell_product(md.values, ell_gather_plane(md, spec), md.ell_len,
                       torch.from_numpy(x)).numpy()
    for faulted in (False, True):
        if faulted:
            plane = plane.copy()
            plane[K // 2, R // 3] ^= np.uint32(1 << 5)
            md = device_of(values, gidx, ell_len, plane, base)
        for use_parity, use_cksum in ((True, False), (False, True),
                                      (True, True)):
            sp = spec._replace(use_parity=use_parity, use_cksum=use_cksum)
            with np.errstate(invalid="ignore"):
                w, trig, summed, folded = replay(
                    K, R, ell_len, per_sm, values, gidx, x, plane, base,
                    use_parity, use_cksum, sms=sms)
            check_coverage(K, R, ell_len, summed, folded, True)
            assert same_bits(w, want)
            assert trig == bool(signals_plain(md, sp))
            # A random plane has odd-weight words: parity always fires.
            assert trig == (use_parity or faulted)


@pytest.mark.parametrize("mode", MODES)
def test_replay_on_a_built_matrix(mode):
    """dense-radius-3d (side 12, K 93 after the build) in each mode,
    clean and with 1- and 2-bit faults: the replay's w equals
    ell_product bit for bit and its trigger signals_plain's."""
    rows, cols, vals, n = dense_radius_3d(side=12)
    m = build_protected("csr", assemble(cols, rows, vals, n, 1), mode)
    assert m.exec_kind == "ell"
    spec = ell_spec(m, mode)
    x = np.random.default_rng(3).standard_normal(m.R).astype(F32)
    for mm in (m, inject_bitflips(m, "ANY", 1, np.random.default_rng(21),
                                  echo=lambda s: None),
               inject_bitflips(m, "ANY", 2, np.random.default_rng(22),
                               echo=lambda s: None)):
        md = make_matrix_device(mm, torch.float32, CPU)
        g = ell_gather_plane(md, spec)
        want = ell_product(md.values, g, md.ell_len, torch.from_numpy(x))
        plane = base = None
        if spec.plane is not None:
            p, b = ((md.fold, md.fold_ck[0]) if spec.plane == "fold"
                    else (md.words[spec.plane], md.cksum[spec.plane]))
            plane = p.numpy().view(np.uint32)
            base = b.numpy().view(np.uint32)
        w, trig, summed, folded = replay(
            spec.K, m.R, md.ell_len.numpy(), 4, md.values.numpy(),
            g.numpy(), x, plane, base, spec.use_parity, spec.use_cksum)
        check_coverage(spec.K, m.R, md.ell_len.numpy(), summed, folded,
                       plane is not None)
        assert same_bits(w, want.numpy())
        assert trig == bool(signals_plain(md, spec))


@pytest.mark.parametrize("case,K", [("R32", 3), ("K1", 1), ("K13", 13),
                                    ("empty-tiles", 3)])
def test_replay_on_the_edge_matrices(case, K):
    """The edge matrices the card tests and chip_smoke.py hold kernel C
    to (utils.ell_edges), secded, as the card gets them (R = 32 cut from
    the build): their stated K and rows, whole empty tiles where named,
    and the replay's w bit-identical to ell_product with its trigger
    signals_plain's, clean and with a 1-bit fault."""
    asm, kw = ell_edge_cases()[case]
    m = build_protected("csr", asm, "secded", force_exec="ell", **kw)
    assert m.exec_kind == "ell" and m.K == K
    R = ROW_CUT.get(case, m.R)
    assert R == (32 if case == "R32" else m.R)
    x = np.random.default_rng(4).standard_normal(R).astype(F32)
    for mm in (m, inject_bitflips(m, "ANY", 1, np.random.default_rng(21),
                                  echo=lambda s: None)):
        md = cut_rows(make_matrix_device(mm, torch.float32, CPU),
                      ROW_CUT.get(case))
        ell_len = md.ell_len.numpy()
        if case == "empty-tiles":
            assert (ell_len.reshape(-1, ELL_TILE_ROWS).max(axis=1) == 0).any()
        spec = ell_spec(mm, "secded")
        g = ell_gather_plane(md, spec)
        want = ell_product(md.values, g, md.ell_len, torch.from_numpy(x))
        w, trig, summed, folded = replay(
            K, R, ell_len, 8, md.values.numpy(), g.numpy(), x,
            md.fold.numpy().view(np.uint32),
            md.fold_ck[0].numpy().view(np.uint32), spec.use_parity,
            spec.use_cksum)
        check_coverage(K, R, ell_len, summed, folded, True)
        assert same_bits(w, want.numpy())
        assert trig == bool(signals_plain(md, spec))
