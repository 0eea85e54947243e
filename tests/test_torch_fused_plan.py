"""Kernel B's tail-free schedule and its summation order, on the CPU.

Kernel B's tail-free instances (csrc/fused_cg_dia.cu, ``row_loop``) give
block b the rows [b nb, (b + 1) nb) (solver.fused.dia_block_rows) and
thread t the rows lo + 4t .. lo + 4t + 3 of each 1024-row tile [lo, hi)
of that range.  Under the "fold" schedule the update of iteration k - 1
runs in iteration k's product pass: each thread writes x and p_k = z +
beta p_(k-1) for its rows into the second p buffer, stages p_k of its
tile and of max|offset| halo rows on either side (recomputed from r_k
and p_(k-1) by the same operations) in shared memory, and runs the
stencil from there; r and p are double-buffered, and the exit leaves
the state in the caller's buffers.  Under "three-sync" the same product
reads p in place and a pass of its own updates x, r, p; "window" runs
three-sync's passes with the product reading p from shared memory,
staged per tile in one window per cluster of offsets
(solver.fused.dia_window_plan).  pw, rr and rz
are summed per thread over its rows in order, per block (warp
butterflies, then the warps in order) and over the grid by the block
that arrives last at the barrier (partials i, i + 256, ... per thread,
then the block sum).

The kernel needs the card; these tests replay the schedule in NumPy
float32, one rounding per operation, and hold:

  - the partition: every row of a matrix in one tile of one thread, once;
  - with the plain loop's alpha and beta (solver.fused.
    fused_cg_dia_plain run one iteration at a time), x, r and p after
    every iteration bit for bit against the plain loop's, w against
    ops.spmv.dia_product, the staged tile (fold) or windows (window)
    against p_k on every row the stencil reads, each read inside the
    window of its diagonal; and pw and rr in the new fixed order within float32
    reach of the plain loop's sums (and, in that order, equal to a
    straight sum over the partition);
  - the exit state: after the limit, a trigger at the first checked
    iteration after folded updates, a breakdown after folded updates,
    and a lazy window closing mid-run (the snapshot included), each
    equal to the plain loop's bit for bit.

Cases: a tridiagonal of one tile, a tridiagonal whose blocks take
several tiles and whose last block is short, 2-D Laplacians (offsets
+-1, +-side) below the fold threshold (fold) and above it (window, one
window; three-sync forced), a tridiagonal with couplings 2,000 rows away
(three windows), Jacobi, lazy CI 4.  The window plan itself: its
clusters, its budget, and every read of every tile at HPCG's 104^3
stencil and other shapes inside its window.
"""

import math

import numpy as np
import pytest
import torch

from abft_sparse_cg_tpu_torch.formats import assemble, build_protected
from abft_sparse_cg_tpu_torch.inject import inject_bitflips
from abft_sparse_cg_tpu_torch.ops.spmv import dia_product, make_matrix_device
from abft_sparse_cg_tpu_torch.ops.spmv_cuda import (
    dia_fast_plain,
    dia_spec,
    signals_plain,
)
from abft_sparse_cg_tpu_torch.solver.cg import init_state
from abft_sparse_cg_tpu_torch.solver.fused import (
    FOLD_MAX_HALO,
    SCHEDULES,
    WINDOW_MAX_SMEM,
    dia_block_rows,
    dia_schedule,
    dia_window_plan,
    fused_cg_dia_plain,
)
from abft_sparse_cg_tpu_torch.utils.matgen import (
    spd_laplacian_2d,
    spd_tridiagonal,
)

torch.set_num_threads(1)
CPU = torch.device("cpu")
F32 = np.float32
BLOCK = 256        # kBlock of csrc/fused_cg_dia.cu
ROWS = 4           # kRows
TILE = BLOCK * ROWS
ERR_BREAKDOWN = 7


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


class Partition:
    """Block b's rows [lo0, hi0); tile j of every block at once: its
    thread rows r (G, BLOCK), the rows that exist, the tile's lo and hi."""

    def __init__(self, R, grid):
        self.R, self.grid = R, grid
        nb = dia_block_rows(R, grid)
        self.lo0 = np.minimum(np.arange(grid) * nb, R)
        self.hi0 = np.minimum(self.lo0 + nb, R)
        self.tiles = []
        for j in range(-(-nb // TILE)):
            lo = self.lo0 + j * TILE
            hi = np.minimum(lo + TILE, self.hi0)
            r = lo[:, None] + ROWS * np.arange(BLOCK)[None, :]
            self.tiles.append((r, r < hi[:, None], lo, hi))

    def thread_sum(self, term):
        """Per thread, the sum over its rows in order (tile by tile, then
        the 4 rows) of term(rows) -> (G, BLOCK)."""
        acc = np.zeros((self.grid, BLOCK), F32)
        for r, ok, _, _ in self.tiles:
            for k in range(ROWS):
                rows = r[ok] + k
                acc[ok] = (acc[ok] + term(rows)).astype(F32)
        return acc

    def total(self, term):
        """The grid total in the kernel's fixed order, and the blocks'
        partials."""
        part = block_sums(self.thread_sum(term))
        return grid_sum(part), part


class Windows:
    """The window schedule's stage of one tile of every block at once,
    from a window plan (csrc/fused_cg_dia.cu stage_windows and the
    stencil's shift): window c at float ``at[c]`` of the set, of
    (hi - lo) + ext[c] staged rows from lo + starts[c]; diagonal d reads
    float shift[d] + (row - lo)."""

    def __init__(self, plan, offsets):
        self.plan = plan
        self.at = np.cumsum([0] + [TILE + e for e in plan.ext])[:-1]
        self.set = plan.set_floats
        self.shift = [int(self.at[c]) + int(o) - plan.starts[c]
                      for o, c in zip(offsets, plan.window)]

    def stage(self, p, lo, hi):
        """The staged sets (G, set) of tile [lo, hi) of every block, as
        float64 (rows outside [0, R) 0, unstaged floats NaN)."""
        R = p.shape[0]
        s = np.full((lo.shape[0], self.set), np.nan)
        for c, (st, e) in enumerate(zip(self.plan.starts, self.plan.ext)):
            rows = lo[:, None] + st + np.arange(TILE + e)[None, :]
            v = np.where((rows >= 0) & (rows < R),
                         p[np.clip(rows, 0, R - 1)], 0.0)
            staged = np.arange(TILE + e)[None, :] < (hi - lo + e)[:, None]
            s[:, self.at[c]:self.at[c] + TILE + e] = np.where(staged, v,
                                                              np.nan)
        return s

    def read(self, s, g, rows, lo, hi, d):
        """Diagonal d's read of ``rows`` (of blocks g) of tile [lo, hi)
        from its staged sets ``s``: (values, whether each index lies in
        its window's staged floats)."""
        c = self.plan.window[d]
        idx = rows - lo[g] + self.shift[d]
        inside = (idx >= self.at[c]) & (
            idx < self.at[c] + hi[g] - lo[g] + self.plan.ext[c])
        return s[g, np.clip(idx, 0, self.set - 1)], inside


class Replay:
    """Kernel B's tail-free loop over one DIA matrix in NumPy float32."""

    def __init__(self, vals, offsets, x, r, p, minv, grid, schedule):
        self.vals = np.asarray(vals, F32)
        self.offsets = tuple(int(o) for o in offsets)
        self.R = self.vals.shape[1]
        self.H = max(abs(o) for o in self.offsets)
        self.part = Partition(self.R, grid)
        self.fold = schedule == "fold"
        self.windows = (Windows(dia_window_plan(self.offsets), self.offsets)
                        if schedule == "window" else None)
        self.minv = None if minv is None else np.asarray(minv, F32)
        self.x = np.asarray(x, F32).copy()
        self.rb = [np.asarray(r, F32).copy(), np.zeros(self.R, F32)]
        self.pb = [np.asarray(p, F32).copy(), np.zeros(self.R, F32)]
        self.w = np.zeros(self.R, F32)
        self.cr = self.cp = 0
        self.pend = self.chk_p = False
        self.alpha_p = self.beta_p = F32(0)
        self.snap = None
        self.tile_ok = True

    def z(self, rv, rows):
        return rv if self.minv is None else (self.minv[rows] * rv).astype(F32)

    def next_p(self, rows, beta):
        """z + beta p_(k-1) of these rows, from r_k and p_(k-1)."""
        rv = self.rb[self.cr][rows]
        pv = self.pb[self.cp][rows]
        return (self.z(rv, rows) + (beta * pv).astype(F32)).astype(F32)

    def stencil(self, pk_at):
        """w of every thread row, the D products in diagonal order, each
        x entry from ``pk_at(j, cols, ok, d)`` (tile j, diagonal d)."""
        for j, (r, ok, lo, hi) in enumerate(self.part.tiles):
            for k in range(ROWS):
                rows = r[ok] + k
                acc = np.zeros(rows.shape, F32)
                for d, off in enumerate(self.offsets):
                    acc = (acc + (self.vals[d, rows]
                                  * pk_at(j, rows + off, ok, d)).astype(F32)
                           ).astype(F32)
                self.w[rows] = acc

    def window_stencil(self, pk):
        """The window schedule's stencil: each tile's windows staged from
        p_k, every read checked against p_k (0 outside [0, R)) and
        against its window's staged floats."""
        R, wn = self.R, self.windows
        sets = []
        for r, ok, lo, hi in self.part.tiles:
            sets.append(wn.stage(pk.astype(np.float64), lo, hi))

        def from_window(j, c, ok, d):
            _, _, lo, hi = self.part.tiles[j]
            g = np.nonzero(ok)[0]
            v, inside = wn.read(sets[j], g, c - self.offsets[d], lo, hi, d)
            v = v.astype(F32)
            want = np.where((c >= 0) & (c < R), pk[np.clip(c, 0, R - 1)],
                            F32(0))
            self.tile_ok &= bool(inside.all()) and np.array_equal(
                v.view(np.int32), want.view(np.int32))
            return v

        self.stencil(from_window)

    def product(self, snapshot):
        """The product pass: the pending update (fold), the stencil, and
        pw in the fixed order.  Returns (pw, the state it materialised:
        x, r_k, p_k)."""
        R, H, allr = self.R, self.H, np.arange(self.R)
        if not self.fold:
            pk = self.pb[0]
            if self.windows is not None:
                self.window_stencil(pk)
            else:
                self.stencil(lambda j, c, ok, d: np.where(
                    (c >= 0) & (c < R), pk[np.clip(c, 0, R - 1)], F32(0)))
            pw, _ = self.part.total(lambda rows: (pk[rows] * self.w[rows])
                                    .astype(F32))
            return pw, (self.x, self.rb[0], pk)
        if self.pend:
            pold = self.pb[self.cp]
            pk = self.next_p(allr, self.beta_p)
            self.x = (self.x + (self.alpha_p * pold).astype(F32)).astype(F32)
            self.pb[self.cp ^ 1] = pk
            if self.chk_p and snapshot:
                self.snap = (self.x.copy(), self.rb[self.cr].copy(),
                             pk.copy())
        else:
            pk = self.pb[self.cp]
        # the shared tiles: own rows from the stage, halo rows recomputed
        tiles = []
        for r, ok, lo, hi in self.part.tiles:
            t = np.zeros((self.part.grid, TILE + 2 * H), F32)
            g, col = np.nonzero(ok)
            for k in range(ROWS):
                t[g, H + ROWS * col + k] = pk[r[ok] + k]
            for side in (lo[:, None] - H + np.arange(H)[None, :],
                         hi[:, None] + np.arange(H)[None, :]):
                gg = np.repeat(np.arange(self.part.grid), H)
                rows = side.ravel()
                inside = (rows >= 0) & (rows < R)
                v = np.zeros(rows.shape, F32)
                if self.pend:
                    v[inside] = self.next_p(rows[inside], self.beta_p)
                else:
                    v[inside] = self.pb[self.cp][rows[inside]]
                t[gg, H + rows - np.repeat(lo, H)] = v
            tiles.append(t)

        def from_tile(j, c, ok, d):
            lo = self.part.tiles[j][2]
            g = np.nonzero(ok)[0]
            v = tiles[j][g, H + c - lo[g]]
            want = np.where((c >= 0) & (c < R), pk[np.clip(c, 0, R - 1)],
                            F32(0))
            self.tile_ok &= np.array_equal(v.view(np.int32),
                                           want.view(np.int32))
            return v

        self.stencil(from_tile)
        pw, _ = self.part.total(lambda rows: (pk[rows] * self.w[rows])
                                .astype(F32))
        return pw, (self.x, self.rb[self.cr], pk)

    def rpass(self, alpha):
        """r1 = r - alpha w (the other r buffer, or w), rr1 and rz1 in
        the fixed order."""
        rcur = self.rb[self.cr]
        r1 = (rcur - (alpha * self.w).astype(F32)).astype(F32)
        rr1, _ = self.part.total(lambda rows: (r1[rows] * r1[rows])
                                 .astype(F32))
        rz1 = rr1
        if self.minv is not None:
            rz1, _ = self.part.total(lambda rows: (r1[rows] * (
                self.minv[rows] * r1[rows]).astype(F32)).astype(F32))
        self.r1 = r1
        return rr1, rz1

    def commit(self, alpha, beta, chk, snapshot):
        """The update: pending until the next product pass (fold), or in
        place (three-sync)."""
        if self.fold:
            self.rb[self.cr ^ 1] = self.r1
            if self.pend:
                self.cp ^= 1
            self.cr ^= 1
            self.pend, self.alpha_p, self.beta_p = True, alpha, beta
            self.chk_p = chk
            return
        p = self.pb[0]
        self.x = (self.x + (alpha * p).astype(F32)).astype(F32)
        self.rb[0] = self.r1
        self.pb[0] = (self.z(self.r1, np.arange(self.R))
                      + (beta * p).astype(F32)).astype(F32)
        if chk and snapshot:
            self.snap = (self.x.copy(), self.rb[0].copy(), self.pb[0].copy())

    def finish(self, stopped, snapshot):
        """The exit: the caller's buffers hold the state before a stopped
        iteration, or the pending update applied."""
        if not self.fold:
            return self.x, self.rb[0], self.pb[0]
        if stopped or not self.pend:
            pk = self.pb[self.cp ^ 1] if stopped and self.pend else \
                self.pb[self.cp]
            return self.x, self.rb[self.cr], pk
        allr = np.arange(self.R)
        pold = self.pb[self.cp]
        pn = self.next_p(allr, self.beta_p)
        self.x = (self.x + (self.alpha_p * pold).astype(F32)).astype(F32)
        if self.chk_p and snapshot:
            self.snap = (self.x.copy(), self.rb[self.cr].copy(), pn.copy())
        return self.x, self.rb[self.cr], pn


def replay_solve(md, spec, b, minv, grid, schedule, upto, conv=0.0, ci=1):
    """The kernel's whole loop from init_state, with its own fixed-order
    pw, rr and rz, as the card runs it on a grid of ``grid`` blocks (the
    trigger: the signal planes' at a checked iteration): (itr, trig, err,
    x, r, p, trace), x, r, p as the exit leaves them."""
    s = init_state(b, upto, minv)
    rp = Replay(md.values.numpy(), spec.offsets, s.x.numpy(), s.r.numpy(),
                s.p.numpy(), None if minv is None else minv.numpy(), grid,
                schedule)
    signals = spec.plane is not None and bool(signals_plain(md, spec))
    rr, rz = F32(s.rr), F32(s.rz)
    itr = its = trig = err = 0
    trace = []
    while itr < upto and rr > F32(conv):
        chk = ci == 1 or itr % ci == ci - 1
        pw, _ = rp.product(snapshot=ci > 1)
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
    x, r, p = rp.finish(stopped=bool(trig or err), snapshot=ci > 1)
    return itr, trig, err, x, r, p, np.array(trace, F32)


def matrix(case):
    """(ProtectedMatrix, mode) of a case."""
    if case in ("tridiagonal one tile",):
        rows, cols, vals, n = spd_tridiagonal(512)
        return build_protected("csr", assemble(cols, rows, vals, n, 2),
                               "secded")
    if case == "tridiagonal ragged blocks":
        rows, cols, vals, n = spd_tridiagonal(4096)
        return build_protected("csr", assemble(cols, rows, vals, n, 3),
                               "secded")
    if case.startswith("laplacian above the threshold"):
        side = FOLD_MAX_HALO + 18
        rows, cols, vals, n = spd_laplacian_2d(side)
        return build_protected("csr", assemble(cols, rows, vals, n, 1),
                               "none")
    if case == "far couplings":
        rows, cols, vals, n = far_coupled(6144, FAR)
        return build_protected("csr", assemble(cols, rows, vals, n, 2),
                               "secded")
    if case == "breakdown":
        # symmetric, indefinite: the last 8 diagonal entries negative; pw
        # turns negative at iteration 2
        rows, cols, vals, n = spd_tridiagonal(2048)
        vals = vals.copy()
        vals[(rows == cols) & (rows >= 2040)] = -3.0
        return build_protected("csr", assemble(cols, rows, vals, n, 1),
                               "secded")
    rows, cols, vals, n = spd_laplacian_2d(40)
    return build_protected("csr", assemble(cols, rows, vals, n, 3),
                           "secded")


FAR = 2000    # far_coupled's second band: three windows


def far_coupled(n, far):
    """A tridiagonal (4, -1) with couplings -1 at distance ``far``, whose
    offsets (0, +-1, +-far) cluster into three windows: strictly
    diagonally dominant, so SPD.  One triangle, 0-based."""
    rows, cols, vals, n = spd_tridiagonal(n)
    fi = np.arange(n - far, dtype=np.int64)
    return (np.concatenate([rows, fi + far]), np.concatenate([cols, fi]),
            np.concatenate([vals, np.full(n - far, -1.0)]), n)


# case -> (grid, Jacobi, check interval, limit, fault seed)
CASES = {
    "tridiagonal one tile": (1, False, 1, 40, None),
    "tridiagonal ragged blocks": (5, False, 1, 12, None),
    "laplacian fold": (3, False, 1, 25, None),
    "laplacian fold Jacobi": (7, True, 1, 25, None),
    "laplacian above the threshold": (37, False, 1, 4, None),
    "laplacian above the threshold three-sync": (37, False, 1, 4, None),
    "far couplings": (5, False, 4, 12, None),
    "trigger after folded updates": (3, False, 4, 25, 12),
    "breakdown": (3, False, 1, 60, None),
    "lazy window closing mid-run": (4, True, 4, 6, None),
}
# the cases that force a schedule, and each case's schedule (else fold)
FORCED = {"laplacian above the threshold three-sync": "three-sync"}
SCHEDULE_OF = {"laplacian above the threshold": "window",
               "laplacian above the threshold three-sync": "three-sync",
               "far couplings": "window"}


def plain_steps(md, spec, b, minv, upto):
    """fused_cg_dia_plain one iteration at a time, detection-free (the
    signals change no arithmetic; the caller decides the triggers): per
    iteration its alpha, rr1, rz1 and the state after it (x, r, p),
    until the limit or a breakdown."""
    spec = spec._replace(plane=None, use_parity=False, use_cksum=False)
    s = init_state(b, upto, minv)
    x, r, p, rr, rz = s.x.clone(), s.r.clone(), s.p.clone(), s.rr, s.rz
    trace = torch.full((upto + 1,), float("nan"))
    steps = []
    for itr in range(upto):
        alpha = rz / dia_fast_plain(md, p, spec)[2]
        out = fused_cg_dia_plain(md, spec, x, r, p, rr, rz, itr, itr + 1,
                                 0.0, trace, None, minv)
        if out.err:
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
    for R, grid in ((1024, 1), (12288, 5), (819200, 528), (819200, 1056),
                    (8192000, 528), (288, 7), (4096, 132)):
        part = Partition(R, grid)
        seen = np.zeros(R, np.int64)
        for r, ok, lo, hi in part.tiles:
            assert np.all(lo % 8 == 0) and np.all(r[ok] + 3 < hi.repeat(
                BLOCK).reshape(r.shape)[ok])
            for k in range(ROWS):
                np.add.at(seen, r[ok] + k, 1)
        assert np.all(seen == 1), (R, grid)
        assert dia_block_rows(R, grid) % 8 == 0


def test_schedule_follows_the_offsets():
    assert dia_schedule((-1, 0, 1)) == "fold"
    assert dia_schedule((-FOLD_MAX_HALO, 0, FOLD_MAX_HALO)) == "fold"
    assert dia_schedule((-FOLD_MAX_HALO - 1, 0, 1)) == "window"
    assert dia_schedule(SCATTERED) == "three-sync"
    assert set(SCHEDULES) == {"fold", "three-sync", "window"}


def stencil27(side):
    """The offsets of the 27-point stencil on a side^3 grid."""
    return tuple(sorted({dz * side * side + dy * side + dx
                         for dz in (-1, 0, 1) for dy in (-1, 0, 1)
                         for dx in (-1, 0, 1)}))


def laplacian(side):
    return (-side, -1, 0, 1, side)


# offsets whose windows pass the budget: seven clusters a tile apart and
# more, each a window of 1,024 rows and more
SCATTERED = tuple(sorted({0, 1, -1} | {k * 5000 for k in range(-3, 4)}))


def test_window_plan_of_hpcg_104():
    """HPCG's 104^3 stencil: three windows (offsets around -10,816, 0 and
    +10,816), each 210 rows wide, their starts and ends on multiples of 4,
    both sets inside the budget."""
    offs = stencil27(104)
    plan = dia_window_plan(offs)
    assert len(plan.starts) == 3 and plan.window == (0,) * 9 + (1,) * 9 + (
        2,) * 9
    for c in range(3):
        mine = [o for o, w in zip(offs, plan.window) if w == c]
        assert max(mine) - min(mine) == 210
        assert plan.starts[c] % 4 == 0 and plan.ext[c] % 4 == 0
        assert plan.starts[c] <= min(mine) < plan.starts[c] + 4
        assert max(mine) - plan.starts[c] <= plan.ext[c] < max(
            mine) - plan.starts[c] + 4
    assert [(min(c) + max(c)) // 2 for c in (
        [o for o, w in zip(offs, plan.window) if w == k] for k in range(3))
    ] == [-10816, 0, 10816]
    assert plan.set_floats == 3 * (TILE + 216)
    assert 2 * 4 * plan.set_floats <= WINDOW_MAX_SMEM


@pytest.mark.parametrize("side,windows", [(1100, 3), (530, 1), (2048, 3)])
def test_window_plan_of_a_laplacian(side, windows):
    """A 2-D Laplacian past the fold's cap: three small windows where
    +-side lies more than a tile from +-1, else one window over all."""
    plan = dia_window_plan(laplacian(side))
    assert len(plan.starts) == windows
    if windows == 3:
        assert max(plan.ext) <= 8 and plan.window == (0, 1, 1, 1, 2)
    else:
        assert plan.ext == (-(-(2 * side + side % 4) // 4) * 4,)


@pytest.mark.parametrize("offsets", [
    SCATTERED,                                      # too many floats
    tuple(range(-3000, 3001, 900)),                 # one cluster too wide
    tuple(k * 1100 for k in range(-5, 5)),          # too many windows
])
def test_window_plan_past_the_budget_falls_back(offsets):
    """Offsets whose windows pass WINDOW_MAX_SMEM or WINDOW_MAX windows
    have no plan and take the three-sync schedule."""
    assert dia_window_plan(offsets) is None
    assert dia_schedule(offsets) == "three-sync"


@pytest.mark.parametrize("shape", ["hpcg 104", "laplacian 1100",
                                   "stencil 24", "far couplings",
                                   "tridiagonal", "periodic 3d"])
def test_window_reads_land_in_their_windows(shape):
    """For every row of every tile of every block, and every diagonal,
    the index the stencil reads lands inside the staged floats of its
    diagonal's window and reads p there (0 for a column outside [0, R)),
    at the card's grid (528 blocks: 132 SMs x 4) and at small ones."""
    offsets, R, grid = {
        "hpcg 104": (stencil27(104), 104 ** 3, 528),
        "laplacian 1100": (laplacian(1100), 1100 ** 2 + 16, 528),
        "stencil 24": (stencil27(24), 24 ** 3, 7),
        "far couplings": ((-FAR, -1, 0, 1, FAR), 12288, 5),
        "tridiagonal": ((-1, 0, 1), 288, 7),
        # the zoo's periodic-3d at side 44: five windows
        "periodic 3d": ((-83248, -1936, -1892, -44, -43, -1, 0, 1, 43, 44,
                         1892, 1936, 83248), 85248, 528),
    }[shape]
    assert R % 32 == 0
    wn = Windows(dia_window_plan(offsets), offsets)
    part = Partition(R, grid)
    p = np.arange(1, R + 1, dtype=np.float64)     # every row its own value
    reads = 0
    for r, ok, lo, hi in part.tiles:
        sets = wn.stage(p, lo, hi)
        g = np.nonzero(ok)[0]
        for k in range(ROWS):
            rows = r[ok] + k
            for d, off in enumerate(offsets):
                v, inside = wn.read(sets, g, rows, lo, hi, d)
                c = rows + off
                want = np.where((c >= 0) & (c < R), c + 1.0, 0.0)
                assert inside.all() and np.array_equal(v, want), (shape, d)
                reads += rows.size
    assert reads == R * len(offsets)


@pytest.mark.parametrize("case", sorted(CASES))
def test_replay_holds_the_plain_loop(case):
    grid, precond, ci, upto, fault = CASES[case]
    m = matrix(case)
    if fault is not None:
        m = inject_bitflips(m, "ANY", 1, np.random.default_rng(fault),
                            echo=lambda s: None)
    mode = "none" if "above" in case else "secded"
    md = make_matrix_device(m, torch.float32, CPU)
    spec = dia_spec(m, mode)
    schedule = FORCED.get(case) or dia_schedule(spec.offsets)
    assert schedule == SCHEDULE_OF.get(case, "fold")
    rng = np.random.default_rng(7)
    b = torch.zeros(m.R, dtype=torch.float32)
    b[: m.N] = torch.tensor(rng.random(m.N), dtype=torch.float32)
    minv = None
    if precond:
        d = md.values[spec.offsets.index(0)]
        minv = torch.where(d != 0, 1.0 / d, torch.zeros_like(d))
    steps = plain_steps(md, spec, b, minv, upto)
    # the plain loop whole, with the signals and the check interval
    s0 = init_state(b, upto, minv)
    final = (s0.x.clone(), s0.r.clone(), s0.p.clone())
    out = fused_cg_dia_plain(md, spec, *final, s0.rr, s0.rz, 0, upto, 0.0,
                             torch.full((upto + 1,), float("nan")), None,
                             minv, ci)
    signals = spec.plane is not None and bool(signals_plain(md, spec))
    rp = Replay(md.values.numpy(), spec.offsets, s0.x.numpy(),
                s0.r.numpy(), s0.p.numpy(),
                None if minv is None else minv.numpy(), grid, schedule)
    rz = F32(s0.rz)
    k, r_trig, r_err = 0, 0, 0
    while k < upto:
        chk = ci == 1 or k % ci == ci - 1
        pw, (x, rk, pk) = rp.product(snapshot=ci > 1)
        if k:
            # the state after iteration k - 1, as this pass materialised it
            _, _, _, xs, rs, ps = steps[k - 1]
            assert bits_equal(x, xs) and bits_equal(rk, rs) \
                and bits_equal(pk, ps), f"{case}: state after {k}"
        assert bits_equal(rp.w, dia_product(md.values, spec.offsets,
                                            torch.from_numpy(pk.copy())))
        assert rp.tile_ok, f"{case}: a staged tile differs from p_{k}"
        pw_plain = float(dia_fast_plain(md, torch.from_numpy(pk.copy()),
                                        spec)[2])
        assert pw == pytest.approx(pw_plain, rel=1e-5)
        if chk and signals:
            r_trig = 1
            break
        if k == len(steps):
            # the plain loop stopped here: a breakdown
            rr1, _ = rp.rpass(F32(rz / pw))
            r_err = ERR_BREAKDOWN
            assert pw <= 0 or not math.isfinite(rr1)
            break
        alpha, rr1_p, rz1_p, _, _, _ = steps[k]
        rr1, rz1 = rp.rpass(F32(alpha))
        assert rr1 == pytest.approx(float(rr1_p), rel=1e-5)
        assert rz1 == pytest.approx(float(rz1_p), rel=1e-4)
        r_total, _ = rp.part.total(lambda rows: (rp.r1[rows] * rp.r1[rows])
                                   .astype(F32))
        assert r_total == rr1
        beta = F32(F32(rz1_p) / rz)
        rp.commit(F32(alpha), beta, chk, snapshot=ci > 1)
        rz = F32(rz1_p)
        k += 1
    assert (r_trig, r_err, k) == (out.trig, out.err, out.itr), case
    x, r, p = rp.finish(stopped=bool(r_trig or r_err), snapshot=ci > 1)
    assert bits_equal(x, final[0]) and bits_equal(r, final[1]) \
        and bits_equal(p, final[2]), f"{case}: exit state"
    if case == "trigger after folded updates":
        assert out.itr == ci - 1 and out.trig == 1
    if case == "breakdown":
        assert out.err == ERR_BREAKDOWN and out.itr >= 2
    if case == "lazy window closing mid-run":
        assert 0 < out.snap.itr < out.itr and not out.trig
    if ci > 1 and out.snap.itr > 0:
        assert all(bits_equal(a, c) for a, c in zip(
            rp.snap, (out.snap.x, out.snap.r, out.snap.p)))


@pytest.mark.parametrize("case", ["tridiagonal ragged blocks",
                                  "laplacian fold Jacobi",
                                  "laplacian above the threshold"])
def test_replay_solve_tracks_the_plain_loop(case):
    """The replay's own fixed-order sums against the plain loop's
    torch.sum: the same iterations, the trace within float32 reach (1e-5;
    1e-4 with Jacobi's rz, as the card tests hold the kernel), x close."""
    grid, precond, _, upto, _ = CASES[case]
    m = matrix(case)
    mode = "none" if "above" in case else "secded"
    md = make_matrix_device(m, torch.float32, CPU)
    spec = dia_spec(m, mode)
    b = torch.zeros(m.R, dtype=torch.float32)
    b[: m.N] = torch.tensor(np.random.default_rng(7).random(m.N),
                            dtype=torch.float32)
    minv = None
    if precond:
        d = md.values[spec.offsets.index(0)]
        minv = torch.where(d != 0, 1.0 / d, torch.zeros_like(d))
    itr, trig, err, x, _, _, trace = replay_solve(
        md, spec, b, minv, grid, dia_schedule(spec.offsets), upto)
    s = init_state(b, upto, minv)
    xp = s.x.clone()
    tp = torch.full((upto + 1,), float("nan"))
    out = fused_cg_dia_plain(md, spec, xp, s.r.clone(), s.p.clone(), s.rr,
                             s.rz, 0, upto, 0.0, tp, None, minv)
    assert (itr, trig, err) == (out.itr, out.trig, out.err)
    np.testing.assert_allclose(trace, tp[:itr].numpy(),
                               rtol=1e-4 if precond else 1e-5)
    np.testing.assert_allclose(x, xp.numpy(), rtol=0,
                               atol=1e-5 * float(xp.abs().max()))
