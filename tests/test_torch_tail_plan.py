"""The split tail's schedule and its summation order, on the CPU.

Kernels B and D run a bordered split's dense-plan tail in one pass
(csrc/dia_common.cuh, "The split tail of the fused kernels B and D"): in
phase 1 every non-outlier row adds its mirrored AXPY terms in window
order right after its main product (the windows of its 128-row tile from
a host-static bit mask, solver.fused.tail_tiles), an outlier row keeps
its main product, block c sums chunk c of the dense rows
(solver.fused.tail_chunk, 16-byte groups), and every thread folds whole
8-slot blocks of the tail's signal plane; after the grid sync every block
reduces the chunk partials and finishes the outlier rows, and pw is the
phase-1 partials plus the outlier rows' p . w.  The kernels need the
card; these tests replay that schedule in NumPy float32, one rounding
per operation, and hold:

  - the window table against a brute-force scan of every row;
  - the replay's w bit-identical to solver.fused.split_tail_plain (the
    plain version the kernels are held to on the card) on every
    non-outlier row, and on the outlier rows bit-identical to the plain
    element order (for t = 0..T-1: the dense sum at o_t, then the AXPY
    term) with the replay's own dense sums; those sums and pw within
    float32 reach of the plain version's;
  - every dense-row slot summed exactly once, the chunks fitting the
    grid in one round, every row and 8-slot signal block taken once;
  - the 8-slot signal grouping against ops.spmv_cuda.signals_plain in
    every mode, with flips at the first and last slot of a block and at
    the plane's edge.

Shapes: the card tests' split matrices (tests/test_torch_cuda.py::
split_matrix: arrowhead, a DIA main with the outlier rows inside each
other's windows; a bordered block-diagonal ELL main; spans_matrix: two
windows that overlap, and two outliers each inside the other's window),
and synthetic tails whose windows overlap, nest, meet at a tile edge or
use all 64 bits.
"""

import numpy as np
import pytest
import torch

from abft_sparse_cg_tpu_torch.ops.spmv import (
    dia_product,
    ell_product,
    make_matrix_device,
)
from abft_sparse_cg_tpu_torch.ops.spmv_cuda import (
    _signal_planes,
    ell_gather_plane,
    fast_spec,
    signals_plain,
)
from abft_sparse_cg_tpu_torch.solver.fused import (
    TILE_ROWS,
    TailSpec,
    split_tail_plain,
    tail_chunk,
    tail_spec,
    tail_tiles,
)
from test_torch_cuda import spans_matrix, split_matrix

torch.set_num_threads(1)
CPU = torch.device("cpu")
F32 = np.float32
BLOCK = 256                 # kBlock of csrc/fused_cg_dia.cu, fused_cg_ell.cu
MODES = ["none", "constraints", "sed", "sec7", "sec8", "secded"]


def bits(mask):
    """The set bits of a uint64, ascending (__ffsll order)."""
    m = int(mask)
    out = []
    while m:
        t = (m & -m).bit_length() - 1
        out.append(t)
        m &= m - 1
    return out


def butterfly(v):
    """Lane 0 of an XOR butterfly over 32 lanes (offsets 16 .. 1), as
    block_sum's shuffles and warp_butterfly add (every lane ends equal)."""
    v = np.asarray(v, F32).copy()
    lanes = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = (v + v[lanes ^ o]).astype(F32)
    return v[0]


def block_sum(v):
    """dia_common.cuh::block_sum of a block's per-thread values: each
    warp's butterfly, then thread 0 adds the warps in order from 0."""
    v = np.asarray(v, F32)
    total = F32(0)
    for w in range(len(v) // 32):
        total = F32(total + butterfly(v[32 * w:32 * w + 32]))
    return total


def grid_total(part):
    """grid_total: thread k adds partials k, k + BLOCK, ... in turn, then
    block_sum."""
    v = np.zeros(BLOCK, F32)
    for i0 in range(0, len(part), BLOCK):
        seg = np.asarray(part[i0:i0 + BLOCK], F32)
        v[:len(seg)] = (v[:len(seg)] + seg).astype(F32)
    return block_sum(v)


def replay(main_w, p, rows, starts, S, td, tb, grid):
    """One product of the split tail as kernels B and D run it on ``grid``
    blocks of BLOCK threads: (w, pw, dense sums, chunk partials, the rows
    each thread took, the slots each chunk summed)."""
    R, T = len(p), len(rows)
    stride = grid * BLOCK
    tiles = tail_tiles(starts, S, R)
    po = p[list(rows)].astype(F32)
    own = {o: t for t, o in enumerate(rows)}     # tail_stage / tail_outlier
    w = np.array(main_w, F32)
    tmain = np.zeros(T, F32)
    pw_thread = np.zeros(stride, F32)
    taken = np.zeros(R, np.int64)
    for tid in range(stride):                    # phase 1, row loop
        for i in range(tid, R, stride):
            taken[i] += 1
            if i in own:
                tmain[own[i]] = w[i]
                continue
            v = w[i]
            for t in bits(tiles[i // TILE_ROWS]):             # tail_axpy
                v = F32(v + F32(po[t] * tb[t, i - starts[t]]))
            w[i] = v
            pw_thread[tid] = F32(pw_thread[tid] + F32(p[i] * v))
    part_pw = [block_sum(pw_thread[b * BLOCK:(b + 1) * BLOCK])
               for b in range(grid)]
    chunk = tail_chunk(S, T, grid)                 # tail_dense_chunk
    nch = -(-S // chunk)
    part = np.zeros(T * nch, F32)
    summed = np.zeros((T, S), np.int64)
    for c in range(T * nch):
        t, q = divmod(c, nch)
        g0, g1 = q * chunk // 4, min((q + 1) * chunk, S) // 4
        v = np.zeros(BLOCK, F32)
        for k in range(BLOCK):
            for g in range(g0 + k, g1, BLOCK):       # the thread's groups
                for e in range(4 * g, 4 * g + 4):
                    v[k] = F32(v[k] + F32(td[t, e] * p[starts[t] + e]))
                    summed[t, e] += 1
        part[c] = block_sum(v)
    ds = np.zeros(T, F32)                          # tail_finish
    for t in range(T):
        lanes = np.zeros(32, F32)
        for q in range(nch):
            lanes[q % 32] = F32(lanes[q % 32] + part[t * nch + q])
        ds[t] = butterfly(lanes)
    wo = np.zeros(T, F32)
    for t0, o in enumerate(rows):
        win = int(tiles[o // TILE_ROWS])
        v = tmain[t0]
        for t in bits(win | (1 << t0)):
            if t == t0:
                v = F32(v + ds[t])
            if (win >> t) & 1:
                v = F32(v + F32(po[t] * tb[t, o - starts[t]]))
        wo[t0] = v
        w[o] = v
    s = F32(0)
    for t in range(T):
        s = F32(s + F32(po[t] * wo[t]))
    pw = F32(grid_total(part_pw) + s)
    return dict(w=w, pw=pw, ds=ds, part=part, taken=taken, summed=summed,
                chunks=T * nch)


def element_order(main_w, p, rows, starts, S, tb, ds):
    """The plain element order at the outlier rows: w[o] = main, then for
    t = 0..T-1 the dense sum ds[t] at o_t and the AXPY term where o lies in
    window t, with the given dense sums."""
    out = []
    for o in rows:
        v = F32(main_w[o])
        for t, (ot, st) in enumerate(zip(rows, starts)):
            if o == ot:
                v = F32(v + ds[t])
            if st <= o < st + S:
                v = F32(v + F32(F32(p[ot]) * tb[t, o - st]))
        out.append(v)
    return np.array(out, F32)


class FakeTail:
    """The fields split_tail_plain reads of a tail MatrixDevice."""

    def __init__(self, td, tb):
        self.dense_td = torch.from_numpy(td)
        self.dense_tb = torch.from_numpy(tb)
        self.values = torch.zeros(8)


def check_replay(main_w, p, rows, starts, S, td, tb, grid):
    out = replay(main_w, p, rows, starts, S, td, tb, grid)
    R, T = len(p), len(rows)
    ts = TailSpec(tuple(rows), tuple(starts), S, False, False, None)
    wp, _, pwp = split_tail_plain(FakeTail(td, tb), ts, torch.from_numpy(p),
                                  torch.from_numpy(np.array(main_w, F32)))
    wp = wp.numpy()
    plain = np.ones(R, bool)
    plain[list(rows)] = False
    # non-outlier rows: the plain version's bits
    np.testing.assert_array_equal(out["w"][plain].view(np.uint32),
                                  wp[plain].view(np.uint32))
    # outlier rows: the plain element order with the replay's dense sums
    want = element_order(main_w, p, rows, starts, S, tb, out["ds"])
    np.testing.assert_array_equal(out["w"][list(rows)].view(np.uint32),
                                  want.view(np.uint32))
    # the dense sums and pw differ from the plain version's in order only
    ref_ds = np.array([np.dot(td[t].astype(np.float64),
                              p[st:st + S].astype(np.float64))
                       for t, st in enumerate(starts)])
    np.testing.assert_allclose(out["ds"], ref_ds, rtol=1e-4,
                               atol=1e-5 * np.abs(td).sum(axis=1).max())
    np.testing.assert_allclose(out["w"][list(rows)], wp[list(rows)],
                               rtol=1e-4, atol=1e-4)
    scale = float(np.abs(p.astype(np.float64) * wp).sum())
    assert abs(float(out["pw"]) - float(pwp)) <= 1e-5 * scale
    # coverage: each row once, each dense slot once, one round of chunks
    assert (out["taken"] == 1).all()
    assert (out["summed"] == 1).all()
    assert out["chunks"] <= max(grid, T)
    return out


def test_window_table_matches_a_scan():
    """tail_tiles against a brute-force scan of every row and window,
    including bit 63 and windows that nest, overlap and meet at a tile
    edge."""
    R, S = 64 * 128, 512
    rng = np.random.default_rng(0)
    starts = [0, 0, 384, 512, R - S] + [int(s) * 128 for s in rng.integers(
        0, (R - S) // 128 + 1, size=59)]
    tiles = tail_tiles(starts, S, R)
    assert tiles.dtype == np.uint64 and tiles.shape == (R // TILE_ROWS,)
    i = np.arange(R)
    for t, st in enumerate(starts):
        inside = (i >= st) & (i < st + S)
        got = ((tiles[i // TILE_ROWS] >> np.uint64(t)) & np.uint64(1)) == 1
        np.testing.assert_array_equal(got, inside, err_msg=f"window {t}")
    assert any(int(v) >> 63 for v in tiles)  # window 63 is in the table


@pytest.mark.parametrize("S,T,grid", [
    (81920, 30, 792), (81920, 30, 1056), (128, 1, 1), (1024, 64, 8),
    (512, 3, 100), (4096, 2, 1056)])
def test_chunks_fit_the_grid(S, T, grid):
    """tail_chunk: 128-aligned chunks covering each dense row, at most one
    per block when the grid holds T blocks or more."""
    chunk = tail_chunk(S, T, grid)
    nch = -(-S // chunk)
    assert chunk % 128 == 0 and chunk >= 128
    assert (nch - 1) * chunk < S <= nch * chunk
    assert T * nch <= max(grid, T)


def synthetic(R, S, starts, rows, seed):
    rng = np.random.default_rng(seed)
    T = len(rows)
    td = rng.standard_normal((T, S)).astype(F32)
    tb = rng.standard_normal((T, S)).astype(F32)
    p = rng.standard_normal(R).astype(F32)
    main_w = rng.standard_normal(R).astype(F32)
    return main_w, p, td, tb


@pytest.mark.parametrize("case", ["overlap-at-tile-edge", "nested",
                                  "outlier-in-other-window", "disjoint"])
@pytest.mark.parametrize("grid", [1, 3, 8])
def test_replay_on_synthetic_tails(case, grid):
    """Windows that overlap by one tile, nest, hold another outlier's row,
    or are disjoint; a grid of one block, one that does not divide R, and
    one of several strides."""
    R, S = 2048, 512
    starts, rows = {
        "overlap-at-tile-edge": ([0, 384, 1536], [700, 5, 1600]),
        "nested": ([0, 0, 128], [2000, 1000, 300]),
        "outlier-in-other-window": ([256, 512, 1024], [600, 300, 1100]),
        "disjoint": ([0, 512, 1024, 1536], [1500, 100, 1800, 700]),
    }[case]
    main_w, p, td, tb = synthetic(R, S, starts, rows, 7)
    check_replay(main_w, p, rows, starts, S, td, tb, grid)


def main_product(m, md, p):
    spec = fast_spec(m.main, "secded")
    pt = torch.from_numpy(p)
    if m.main.exec_kind == "dia":
        return dia_product(md[0].values, spec.offsets, pt).numpy()
    g = ell_gather_plane(md[0], spec).to(torch.int64)
    return ell_product(md[0].values, g, md[0].ell_len, pt).numpy()


@pytest.mark.parametrize("shape", ["dia", "ell", "windows share a tile",
                                   "outlier in another window"])
@pytest.mark.parametrize("grid", [2, 7])
def test_replay_on_split_matrices(shape, grid):
    """The card tests' split matrices (split_matrix, spans_matrix): w
    bit-identical to the plain version off the outlier rows, the element
    order on them."""
    m = (split_matrix("secded", shape) if shape in ("dia", "ell")
         else spans_matrix("secded", shape))
    md = make_matrix_device(m, torch.float32, CPU)
    rows, starts, S = m.tail.dense_plan
    p = np.random.default_rng(3).standard_normal(m.R).astype(F32)
    main_w = main_product(m, md, p)
    check_replay(main_w, p, rows, starts, S, md[1].dense_td.numpy(),
                 md[1].dense_tb.numpy(), grid)


def signals_replay(plane, base, use_parity, use_cksum, grid):
    """tail_signals on ``grid`` blocks: thread tid folds 8-slot blocks
    tid, tid + stride, ...; returns (fired, blocks taken)."""
    words = plane.view(np.uint32).reshape(-1, 8)
    stride = grid * BLOCK
    taken = np.zeros(len(words), np.int64)
    bad = False
    for tid in range(min(stride, len(words))):
        g = np.arange(tid, len(words), stride)
        taken[g] += 1
        blk = words[g]
        if use_parity:
            bad |= bool(np.any(parity(blk)))
        if use_cksum:
            x = np.bitwise_xor.reduce(blk, axis=1)
            bad |= bool(np.any(x != base.view(np.uint32)[g]))
    return bad, taken


def parity(words):
    """popcount & 1 of each uint32 word."""
    v = words.astype(np.uint32)
    for s in (16, 8, 4, 2, 1):
        v = v ^ (v >> np.uint32(s))
    return v & np.uint32(1)


def flipped(md, spec, j, bit):
    """``md`` with bit ``bit`` of slot j of ``spec``'s signal plane flipped
    (a clone; the baseline is kept, as an injected fault keeps it)."""
    plane = _signal_planes(md, spec)[0][0].clone()
    plane[j] ^= torch.tensor(1 << bit, dtype=torch.int64).to(torch.int32)
    if spec.plane == "fold":
        return md._replace(fold=plane)
    words = list(md.words)
    words[spec.plane] = plane
    return md._replace(words=tuple(words))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("main", ["dia", "ell"])
def test_signal_blocks_match_plain(mode, main):
    """The 8-slot grouping against signals_plain on the tail's own plane,
    clean and with one flipped bit at the first and last slot of a block
    and at the plane's edge; every block taken once."""
    m = split_matrix(mode, main)
    md = make_matrix_device(m, torch.float32, CPU)[1]
    ts = tail_spec(m, mode)
    E = m.tail.exec_size
    assert E % 8 == 0
    if ts.plane is None:
        assert not bool(signals_plain(md, ts))
        return
    cases = [("clean", md)] + [
        (f"slot {j} bit {b}", flipped(md, ts, j, b))
        for j, b in ((8, 0), (15, 31), (E - 8, 5), (E - 1, 17))]
    for label, mdf in cases:
        plane, base = _signal_planes(mdf, ts)[0]
        for grid in (1, 5):
            got, taken = signals_replay(plane.numpy(), base.numpy(),
                                        ts.use_parity, ts.use_cksum, grid)
            assert (taken == 1).all()
            assert got == bool(signals_plain(mdf, ts)), (label, grid)
        assert got == (label != "clean"), label
