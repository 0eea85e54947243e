"""Kernel D's tail-free schedule and its summation order, on the CPU.

Kernel D's tail-free instances (csrc/fused_cg_ell.cu, ``row_loop``) run
the grid and schedule of solver.fused.ell_row_plan: as many blocks of 128
threads per SM as their ring and window leave room for (at most one per
warp of rows); block b owns the contiguous warps of rows [lo, hi) of
ops.spmv.ell_block_rows.  In the product pass thread t takes row lo +
128 j + t of tile j and sums it from kernel C's staged slabs in slot
order; under the "window" schedule p is gathered from the block's copy
of p over [lo - hb, hi + hb) (hb = ell_halo(band)) staged after the
barrier that published p, and an index outside it reads p in device
memory; under "l2" every index reads device memory.  In the vector passes thread t takes rows lo + 512 j + 4t ..
lo + 512 j + 4t + 3.  pw is summed per thread over its tiles, rr and rz
per thread over its rows in order; then per block (warp butterflies,
then the 4 warps in order) and over the grid by the block that arrives
last at the barrier (partials i, i + 128, ... per thread, then the block
sum).  Three barriers per iteration: pw with the trigger's OR, rr with
rz, and the update's.

The kernel needs the card; these tests replay the schedule in NumPy
float32, one rounding per operation, and hold:

  - the partition: every row in one tile of one block and in one vector
    step of one thread, once, tiles of whole warps; the plan's blocks per
    SM, grid and schedule on the H100's shared memory;
  - the window: every valid gather of a clean matrix lands in its block's
    window; an index a fault moved out of it takes the device-memory
    read, and w is bit-identical to ops.spmv.ell_product either way;
  - with the plain loop's alpha and beta (solver.fused.fused_cg_ell_plain
    run one iteration at a time), x, r and p after every iteration bit
    for bit against the plain loop's; pw, rr and rz in the new order
    within float32 reach of the plain sums (and, in that order, equal to
    the replay's straight sums over the partition);
  - the exit state after the limit, after a trigger, after a breakdown,
    and when a lazy window closes mid-run (the snapshot included), each
    equal to the plain loop's bit for bit.

Cases: a narrow band (dense-radius, several tiles per block, a short
last block), a band over the window cap (the l2 schedule), RCM ``gidx``,
Jacobi, lazy CI 4, two planes (constraints mode on COO128), a fault, a
breakdown, and kernel C's edge shapes (utils.ell_edges).
"""

import functools
import math

import numpy as np
import pytest
import torch

from abft_sparse_cg_tpu_torch.backends.torch_backend import jacobi_minv
from abft_sparse_cg_tpu_torch.formats import assemble, build_protected
from abft_sparse_cg_tpu_torch.inject import inject_bitflips
from abft_sparse_cg_tpu_torch.ops.spmv import (
    ell_block_rows,
    ell_product,
    make_matrix_device,
)
from abft_sparse_cg_tpu_torch.ops.spmv_cuda import (
    ell_fast_plain,
    ell_gather_plane,
    ell_spec,
    signals_plain,
)
from abft_sparse_cg_tpu_torch.solver.cg import init_state
from abft_sparse_cg_tpu_torch.solver.fused import (
    ELL_MAX_BLOCKS_PER_SM,
    ELL_SCHEDULES,
    ell_halo,
    ell_ring_bytes,
    ell_row_plan,
    ell_window_rows,
    fused_cg_ell_plain,
)
from abft_sparse_cg_tpu_torch.utils.ell_edges import ell_edge_cases
from abft_sparse_cg_tpu_torch.utils.matgen import (
    shuffle_labels,
    spd_tridiagonal,
)
from abft_sparse_cg_tpu_torch.utils.matzoo import dense_radius_3d

torch.set_num_threads(1)
CPU = torch.device("cpu")
F32 = np.float32
BLOCK = 128        # kRows of csrc/fused_cg_ell.cu: threads = tile rows
STEP = 4 * BLOCK   # rows of one vector-pass step of a block
SMS = 132          # H100 SXM
ERR_BREAKDOWN = 7


def h100_occupancy(smem):
    """Resident blocks per SM of kernel D's tail-free instances at
    ``smem`` bytes of dynamic shared memory on an H100 (228 KB per SM, 1
    KB reserved per block, ~0.5 KB of static shared memory), at most
    ELL_MAX_BLOCKS_PER_SM (the launch bounds hold the registers to it)."""
    return min(ELL_MAX_BLOCKS_PER_SM, 233472 // (smem + 1024 + 512))


def butterfly(v):
    """Lane 0 of XOR butterflies over the last axis of 32 lanes (offsets
    16 .. 1; every lane ends equal)."""
    lanes = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = (v + v[..., lanes ^ o]).astype(F32)
    return v[..., 0]


def block_sums(v):
    """grid_reduce's block step for each row of v (G, BLOCK): each warp's
    butterfly, then the warps added in order from 0."""
    w = butterfly(np.asarray(v, F32).reshape(v.shape[0], BLOCK // 32, 32))
    t = np.zeros(v.shape[0], F32)
    for i in range(w.shape[1]):
        t = (t + w[:, i]).astype(F32)
    return t


def grid_sum(part):
    """grid_reduce's last block: thread i adds partials i, i + BLOCK, ...
    in turn, then the block step."""
    v = np.zeros(BLOCK, F32)
    for i0 in range(0, len(part), BLOCK):
        seg = np.asarray(part[i0:i0 + BLOCK], F32)
        v[:len(seg)] = (v[:len(seg)] + seg).astype(F32)
    return block_sums(v[None])[0]


def gather_np(g, R):
    """ell_gather (dia_common.cuh): int32, below zero wraps once by R,
    then clamp into [0, R)."""
    g = np.asarray(g).astype(np.int64)
    g = np.where(g < 0, g + R, g)
    return np.clip(g, 0, R - 1)


class Partition:
    """Block b's rows [lo[b], hi[b]); product tile j of every block at
    once (thread rows (G, BLOCK), the rows that exist); vector step j
    (each thread's first row of four)."""

    def __init__(self, R, grid):
        self.R, self.grid = R, grid
        blocks = ell_block_rows(R, grid)
        self.lo, self.hi = blocks[:, 0], blocks[:, 1]
        most = int((self.hi - self.lo).max())
        t = np.arange(BLOCK)[None, :]
        self.tiles = []
        for j in range(-(-most // BLOCK)):
            r = self.lo[:, None] + j * BLOCK + t
            self.tiles.append((r, r < self.hi[:, None]))
        self.steps = []
        for j in range(-(-most // STEP)):
            r = self.lo[:, None] + j * STEP + 4 * t
            self.steps.append((r, r < self.hi[:, None]))

    def tile_sum(self, term):
        """Per thread, the sum over its tiles' rows in order of
        term(rows) -> (G, BLOCK)."""
        acc = np.zeros((self.grid, BLOCK), F32)
        for r, ok in self.tiles:
            acc[ok] = (acc[ok] + term(r[ok])).astype(F32)
        return acc

    def step_sum(self, term):
        """Per thread, the sum over its vector steps, four rows each in
        order, of term(rows) -> (G, BLOCK)."""
        acc = np.zeros((self.grid, BLOCK), F32)
        for r, ok in self.steps:
            for k in range(4):
                acc[ok] = (acc[ok] + term(r[ok] + k)).astype(F32)
        return acc

    @staticmethod
    def total(thread_partials):
        """The grid total in the kernel's fixed order."""
        return grid_sum(block_sums(thread_partials))


class Replay:
    """Kernel D's tail-free loop over one ELL matrix in NumPy float32."""

    def __init__(self, md, spec, x, r, p, minv, grid, schedule):
        self.vals = md.values.numpy().astype(F32)
        self.K, self.R = self.vals.shape
        self.g = gather_np(ell_gather_plane(md, spec).numpy(), self.R)
        self.n = np.clip(md.ell_len.numpy(), 0, self.K)
        self.part = Partition(self.R, grid)
        hb = ell_halo(spec.band) if schedule == "window" else None
        lo, hi = self.part.lo, self.part.hi
        if hb is None:
            self.wlo = np.zeros(grid, np.int64)
            self.wn = np.zeros(grid, np.int64)
        else:
            self.wlo = np.where(lo < hi, np.maximum(lo - hb, 0), 0)
            self.wn = np.where(lo < hi, np.minimum(hi + hb, self.R)
                               - self.wlo, 0)
            assert np.all(self.wn <= ell_window_rows(self.R, grid,
                                                     spec.band))
        self.minv = None if minv is None else np.asarray(minv, F32)
        self.x = np.asarray(x, F32).copy()
        self.r = np.asarray(r, F32).copy()
        self.p = np.asarray(p, F32).copy()
        self.w = np.zeros(self.R, F32)
        self.snap = None
        self.outside = 0      # valid slots read from device memory

    def product(self):
        """The product pass: each block stages its window of p, each
        thread sums its tiles' rows in slot order (window, or device
        memory outside it), pw in the fixed order.  Returns pw."""
        wins = [self.p[a:a + n].copy() for a, n in zip(self.wlo, self.wn)]
        for r, ok in self.part.tiles:
            blk, _ = np.nonzero(ok)
            rows = r[ok]
            wlo, wn = self.wlo[blk], self.wn[blk]
            acc = np.zeros(rows.shape, F32)
            for k in range(self.K):
                valid = k < self.n[rows]
                gi = self.g[k, rows]
                inwin = (gi >= wlo) & (gi < wlo + wn)
                xv = self.p[gi].copy()
                for b in np.unique(blk[inwin]):
                    sel = inwin & (blk == b)
                    xv[sel] = wins[b][gi[sel] - self.wlo[b]]
                self.outside += int(np.count_nonzero(valid & ~inwin
                                                     & (wn > 0)))
                acc = np.where(valid, (acc + (self.vals[k, rows] * xv)
                                       .astype(F32)).astype(F32), acc)
            self.w[rows] = acc
        pw = self.part.total(self.part.tile_sum(
            lambda rows: (self.p[rows] * self.w[rows]).astype(F32)))
        return pw

    def rpass(self, alpha):
        """r1 = r - alpha w (in the w buffer), rr1 and rz1 in the fixed
        order."""
        r1 = (self.r - (alpha * self.w).astype(F32)).astype(F32)
        rr1 = self.part.total(self.part.step_sum(
            lambda rows: (r1[rows] * r1[rows]).astype(F32)))
        rz1 = rr1
        if self.minv is not None:
            rz1 = self.part.total(self.part.step_sum(
                lambda rows: (r1[rows] * (self.minv[rows] * r1[rows])
                              .astype(F32)).astype(F32)))
        self.r1 = r1
        return rr1, rz1

    def commit(self, alpha, beta, chk, snapshot):
        """The update pass, in place; a checked lazy iteration's state
        goes to the snapshot."""
        z = self.r1 if self.minv is None else (self.minv * self.r1).astype(F32)
        self.x = (self.x + (alpha * self.p).astype(F32)).astype(F32)
        self.p = (z + (beta * self.p).astype(F32)).astype(F32)
        self.r = self.r1
        if chk and snapshot:
            self.snap = (self.x.copy(), self.r.copy(), self.p.copy())


def replay_solve(md, spec, b, minv, grid, schedule, upto, conv=0.0, ci=1):
    """The kernel's whole loop from init_state, with its own fixed-order
    pw, rr and rz, as the card runs it on a grid of ``grid`` blocks
    under ``schedule`` (the card's: solver.fused.ell_plan; the trigger:
    the signal planes' at a checked iteration): (itr, trig, err, x, r, p,
    trace, snapshot or None)."""
    s = init_state(b, upto, minv)
    rp = Replay(md, spec, s.x.numpy(), s.r.numpy(), s.p.numpy(),
                None if minv is None else minv.numpy(), grid, schedule)
    signals = spec.plane is not None and bool(signals_plain(md, spec))
    rr, rz = F32(s.rr), F32(s.rz)
    itr = its = trig = err = 0
    trace = []
    while itr < upto and rr > F32(conv):
        chk = ci == 1 or itr % ci == ci - 1
        pw = rp.product()
        if chk and signals:
            trig = 1
            break
        with np.errstate(divide="ignore", invalid="ignore"):
            alpha = F32(rz / pw)
            rr1, rz1 = rp.rpass(alpha)
        if pw <= 0 or not math.isfinite(rr1):
            err = ERR_BREAKDOWN
            break
        beta = F32(rz1 / rz)
        rp.commit(alpha, beta, chk, snapshot=ci > 1)
        trace.append(rr1)
        itr, rr, rz = itr + 1, rr1, rz1
        if chk:
            its = itr
    if ci > 1 and its != itr and not trig and not err:
        trig = int(signals)     # the exit window's signals pass
    snap = rp.snap if ci > 1 else None
    return itr, trig, err, rp.x, rp.r, rp.p, np.array(trace, F32), snap


def wide_band(n=16384, off=6000):
    """Diagonal, +-1 and +-off: a band whose window leaves room for too
    few blocks per SM (forced to ELL: it is DIA-shaped)."""
    i = np.arange(n)
    rows = np.concatenate([i, i[1:], i[off:]])
    cols = np.concatenate([i, i[:-1], i[:-off]])
    vals = np.concatenate([np.full(n, 6.0), -np.ones(n - 1),
                           -np.ones(n - off)])
    return rows, cols, vals, n


@functools.lru_cache(maxsize=None)
def matrix(case):
    """(ProtectedMatrix, mode) of a case (built once per process)."""
    if case.startswith("edge "):
        asm, kw = ell_edge_cases()[case[5:]]
        return build_protected("csr", asm, "secded", force_exec="ell",
                               **kw), "secded"
    if case == "band over the cap":
        rows, cols, vals, n = wide_band()
        return build_protected("csr", assemble(cols, rows, vals, n, 1),
                               "secded", force_exec="ell"), "secded"
    if case == "RCM gidx":
        rows, cols, vals, n = shuffle_labels(*spd_tridiagonal(6000),
                                             seed=11)
        return build_protected("csr", assemble(cols, rows, vals, n, 1),
                               "sec7", force_exec="ell"), "sec7"
    if case == "two planes":
        rows, cols, vals, n = dense_radius_3d(side=8)
        return build_protected("coo", assemble(cols, rows, vals, n, 2),
                               "constraints"), "constraints"
    if case == "breakdown":
        # symmetric, indefinite: the last diagonal entries negative
        rows, cols, vals, n = spd_tridiagonal(2048)
        vals = vals.copy()
        vals[(rows == cols) & (rows >= 2040)] = -3.0
        return build_protected("csr", assemble(cols, rows, vals, n, 1),
                               "secded", force_exec="ell"), "secded"
    rows, cols, vals, n = dense_radius_3d(side=8)
    return build_protected("csr", assemble(cols, rows, vals, n, 2),
                           "secded"), "secded"


# case -> (replay grid, Jacobi, check interval, limit, fault seed); the
# schedule is the H100's (ell_row_plan), the grid small so that blocks
# take several tiles and the last one is short.  "corrupted index": a
# gather word moved far outside its block's window with the signal plane
# left as built, so nothing triggers and the loop runs on it.
CASES = {
    "narrow band": (5, False, 1, 12, None),
    "corrupted index": (3, False, 1, 8, None),
    "narrow band Jacobi": (7, True, 1, 8, None),
    "lazy window closing mid-run": (4, True, 4, 6, None),
    "trigger at the first check": (3, False, 4, 25, 12),
    "band over the cap": (2, False, 1, 10, None),
    "RCM gidx": (6, False, 1, 10, None),
    "two planes": (3, False, 1, 8, None),
    "breakdown": (3, False, 1, 60, None),
    "edge R32": (1, False, 1, 8, None),
    "edge K1": (4, False, 1, 8, None),       # converges at once
    "edge K13": (9, False, 1, 8, None),
    "edge empty-tiles": (5, False, 4, 9, None),
}


def setup(case):
    """(md, spec, b, minv, grid, schedule, ci, upto, mode)."""
    grid, precond, ci, upto, fault = CASES[case]
    m, mode = matrix(case)
    if fault is not None:
        m = inject_bitflips(m, "ANY", 1, np.random.default_rng(fault),
                            echo=lambda s: None)
    md = make_matrix_device(m, torch.float32, CPU)
    spec = ell_spec(m, mode)
    if case == "corrupted index":
        md, _ = corrupted_index(md, spec, 5, m.R - 7)
    grid = max(1, min(grid, m.R // 32))
    planes = 2 if spec.plane2 is not None else 1
    _, schedule = ell_row_plan(m.R, spec.band, planes, SMS, h100_occupancy)
    rng = np.random.default_rng(7)
    b = torch.zeros(m.R, dtype=torch.float32)
    b[: m.N] = torch.tensor(rng.random(m.N), dtype=torch.float32)
    minv = None
    if precond:
        minv = torch.zeros(m.R, dtype=torch.float32)
        minv[: m.N] = torch.tensor(m.to_exec_order(jacobi_minv(m, "jacobi")))
    return md, spec, b, minv, grid, schedule, ci, upto, mode


def plain_steps(md, spec, b, minv, upto):
    """fused_cg_ell_plain one iteration at a time, detection-free (the
    signals change no arithmetic; the caller decides the triggers): per
    iteration its alpha, rr1, rz1 and the state after it (x, r, p),
    until the limit or a breakdown."""
    spec = spec._replace(plane=None, plane2=None, use_parity=False,
                         use_cksum=False)
    s = init_state(b, upto, minv)
    x, r, p, rr, rz = s.x.clone(), s.r.clone(), s.p.clone(), s.rr, s.rz
    trace = torch.full((upto + 1,), float("nan"))
    steps = []
    for itr in range(upto):
        alpha = rz / ell_fast_plain(md, p, spec)[2]
        out = fused_cg_ell_plain(md, spec, x, r, p, rr, rz, itr, itr + 1,
                                 0.0, trace, None, minv)
        if out.err or out.itr == itr:     # a breakdown, or converged
            break
        steps.append((alpha, out.rr, out.rz, x.clone(), r.clone(),
                      p.clone()))
        rr, rz = out.rr, out.rz
    return steps


def bits_equal(a, b):
    a = np.asarray(a, F32)
    b = np.asarray(b, F32)
    return np.array_equal(a.view(np.int32), b.view(np.int32))


def test_partition_covers_every_row_once():
    for R, grid in ((32, 1), (1024, 5), (12288, 7), (221184, 528),
                    (221184, 1056), (4096, 128), (8192, 260)):
        part = Partition(R, grid)
        for chunks, width in ((part.tiles, 1), (part.steps, 4)):
            seen = np.zeros(R, np.int64)
            for r, ok in chunks:
                for k in range(width):
                    np.add.at(seen, r[ok] + k, 1)
            assert np.all(seen == 1), (R, grid, width)
        # tiles of whole warps, balanced to one warp
        for r, ok in part.tiles:
            assert np.all(ok.sum(1) % 32 == 0)
        size = part.hi - part.lo
        assert size.max() - size.min() <= 32


def test_grid_and_schedule_follow_the_matrix():
    """The stream's plan on the H100's shared memory: dense-radius-3d -b
    10 (band 1,627) takes the window at 5 blocks per SM with one signal
    plane, 4 with two; stencil27-shuffled -b 10 (band 4,681) the l2
    schedule at 7; small matrices one block per warp."""
    plan = functools.partial(ell_row_plan, sms=SMS,
                             occupancy=h100_occupancy)
    assert plan(221184, 1627, 1) == (660, "window")
    assert plan(221184, 1627, 2) == (528, "window")
    assert plan(640000, 4681, 1) == (924, "l2")
    assert plan(32, 0, 1) == (1, "window")
    assert plan(4096, 20, 1) == (128, "window")
    # forced: the l2 grid, or the window at the most blocks it fits
    assert plan(221184, 1627, 1, schedule="l2") == (924, "l2")
    assert plan(640000, 4681, 1, schedule="window") == (396, "window")
    with pytest.raises(ValueError):
        plan(640000, 60000, 1, schedule="window")
    # the window of the largest block: its rows and the halo either side
    assert ell_window_rows(221184, 660, 1627) == 352 + 2 * 1628
    assert ell_ring_bytes(1) == 24576 and ell_ring_bytes(2) == 32768
    assert ell_halo(1627) == 1628 and ell_halo(0) == 0
    assert set(ELL_SCHEDULES) == {"window", "l2", "grid-stride"}


@pytest.mark.parametrize("case", sorted(CASES))
def test_replay_holds_the_plain_loop(case):
    md, spec, b, minv, grid, schedule, ci, upto, mode = setup(case)
    assert schedule == ("l2" if case == "band over the cap" else "window")
    if case == "two planes":
        assert spec.plane2 is not None
    if case == "RCM gidx":
        assert spec.gather == "gidx"
    steps = plain_steps(md, spec, b, minv, upto)
    # the plain loop whole, with the signals and the check interval
    s0 = init_state(b, upto, minv)
    final = (s0.x.clone(), s0.r.clone(), s0.p.clone())
    out = fused_cg_ell_plain(md, spec, *final, s0.rr, s0.rz, 0, upto, 0.0,
                             torch.full((upto + 1,), float("nan")), None,
                             minv, ci)
    signals = spec.plane is not None and bool(signals_plain(md, spec))
    rp = Replay(md, spec, s0.x.numpy(), s0.r.numpy(), s0.p.numpy(),
                None if minv is None else minv.numpy(), grid, schedule)
    rr, rz = F32(s0.rr), F32(s0.rz)
    k, r_trig, r_err = 0, 0, 0
    while k < upto and rr > 0:
        chk = ci == 1 or k % ci == ci - 1
        pw = rp.product()
        if k:
            # the state after iteration k - 1
            _, _, _, xs, rs, ps = steps[k - 1]
            assert bits_equal(rp.x, xs) and bits_equal(rp.r, rs) \
                and bits_equal(rp.p, ps), f"{case}: state after {k}"
        assert bits_equal(rp.w, ell_product(
            md.values, ell_gather_plane(md, spec), md.ell_len,
            torch.from_numpy(rp.p.copy())))
        pw_plain = float(ell_fast_plain(md, torch.from_numpy(rp.p.copy()),
                                        spec)[2])
        assert pw == pytest.approx(pw_plain, rel=1e-5)
        if chk and signals:
            r_trig = 1
            break
        if k == len(steps):
            # the plain loop stopped here: a breakdown
            with np.errstate(divide="ignore", invalid="ignore"):
                rr1, _ = rp.rpass(F32(rz / pw))
            r_err = ERR_BREAKDOWN
            assert pw <= 0 or not math.isfinite(rr1)
            break
        alpha, rr1_p, rz1_p, _, _, _ = steps[k]
        rr1, rz1 = rp.rpass(F32(alpha))
        assert rr1 == pytest.approx(float(rr1_p), rel=1e-5)
        assert rz1 == pytest.approx(float(rz1_p), rel=1e-4)
        assert rr1 == Partition.total(rp.part.step_sum(
            lambda rows: (rp.r1[rows] * rp.r1[rows]).astype(F32)))
        beta = F32(F32(rz1_p) / rz)
        rp.commit(F32(alpha), beta, chk, snapshot=ci > 1)
        rr, rz = F32(rr1_p), F32(rz1_p)
        k += 1
    # only the corrupted index leaves its block's window
    assert (rp.outside > 0) == (case == "corrupted index"), case
    assert (r_trig, r_err, k) == (out.trig, out.err, out.itr), case
    assert bits_equal(rp.x, final[0]) and bits_equal(rp.r, final[1]) \
        and bits_equal(rp.p, final[2]), f"{case}: exit state"
    if case == "trigger at the first check":
        assert out.itr == ci - 1 and out.trig == 1
    if case == "breakdown":
        assert out.err == ERR_BREAKDOWN and out.itr >= 2
    if case == "lazy window closing mid-run":
        assert 0 < out.snap.itr < out.itr and not out.trig
    if case in ("narrow band", "RCM gidx", "band over the cap"):
        assert out.itr == upto       # the limit
    if ci > 1 and out.snap.itr > 0:
        assert all(bits_equal(a, c) for a, c in zip(
            rp.snap, (out.snap.x, out.snap.r, out.snap.p)))


@pytest.mark.parametrize("case", ["narrow band", "narrow band Jacobi",
                                  "band over the cap", "two planes"])
def test_replay_solve_tracks_the_plain_loop(case):
    """The replay's own fixed-order sums against the plain loop's
    torch.sum: the same iterations, the trace within float32 reach (1e-5;
    1e-4 with Jacobi's rz, as the card tests hold the kernel), x close."""
    md, spec, b, minv, grid, schedule, _, upto, _ = setup(case)
    itr, trig, err, x, _, _, trace, _ = replay_solve(
        md, spec, b, minv, grid, schedule, upto)
    s = init_state(b, upto, minv)
    xp = s.x.clone()
    tp = torch.full((upto + 1,), float("nan"))
    out = fused_cg_ell_plain(md, spec, xp, s.r.clone(), s.p.clone(), s.rr,
                             s.rz, 0, upto, 0.0, tp, None, minv)
    assert (itr, trig, err) == (out.itr, out.trig, out.err)
    np.testing.assert_allclose(trace, tp[:itr].numpy(),
                               rtol=1e-4 if minv is not None else 1e-5)
    np.testing.assert_allclose(x, xp.numpy(), rtol=0,
                               atol=1e-5 * float(xp.abs().max()))


def corrupted_index(md, spec, row, to):
    """``md`` with slot 0 of ``row`` gathering from row ``to`` (its gather
    word rewritten, the ECC byte cleared; the signal planes left as
    built, so that nothing fires), and the old index."""
    words = list(md.words)
    plane = words[spec.gather].clone()
    old = int(plane[0, row])
    plane[0, row] = to
    words[spec.gather] = plane
    return md._replace(words=tuple(words)), old


def test_a_corrupted_index_outside_the_window_reads_device_memory():
    """An index a fault moved far outside its block's window (the signals
    left blind to it) is read from p in device memory, and w stays
    bit-identical to ops.spmv.ell_product; the two schedules agree."""
    md, spec, b, minv, grid, schedule, _, _, mode = setup("narrow band")
    assert mode == "secded" and schedule == "window"
    assert spec.gather != "gidx" and spec.mask_ecc
    R = md.values.shape[1]
    part = Partition(R, grid)
    row = int(part.lo[0]) + 5
    far = R - 7
    assert far >= part.hi[0] + ell_halo(spec.band)
    mdx, old = corrupted_index(md, spec, row, far)
    assert (old & 0xFFFFFF) != far and not bool(signals_plain(mdx, spec))
    p = np.random.default_rng(3).standard_normal(R).astype(F32)
    pws = {}
    for sched in ("window", "l2"):
        rp = Replay(mdx, spec, np.zeros(R, F32), p, p, None, grid, sched)
        pws[sched] = rp.product()
        want = ell_product(mdx.values, ell_gather_plane(mdx, spec),
                           mdx.ell_len, torch.from_numpy(p))
        assert bits_equal(rp.w, want), sched
        if sched == "window":
            assert rp.outside == 1
    assert pws["window"] == pws["l2"]
    # and the whole plain loop runs on the corrupted index
    s = init_state(b, 6)
    out = fused_cg_ell_plain(mdx, spec, s.x.clone(), s.r.clone(),
                             s.p.clone(), s.rr, s.rz, 0, 6, 0.0,
                             torch.full((7,), float("nan")))
    itr, trig, _, x, _, _, _, _ = replay_solve(mdx, spec, b, None, grid,
                                               "window", 6)
    assert (itr, trig) == (out.itr, out.trig) == (6, 0)
