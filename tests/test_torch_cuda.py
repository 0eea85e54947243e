"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device.  The
file imports nothing of JAX or of the JAX package, so it also runs where
JAX is not installed:

    PYTHONPATH=. python -m pytest --noconftest -p no:cacheprovider \\
        -m cuda tests/test_torch_cuda.py

Tolerances: w bit-exact for kernels A, C and E (explicitly rounded
multiplies and adds in the plain version's order), pw and the rr trace
to 1e-5 relative (per-block partials summed in another order than
torch.sum); the split tail's rr
trace to 1e-3 above float32's noise floor (its dot products are summed
in fixed chunks, the plain loop's by torch.sum).
"""

import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from abft_sparse_cg_tpu_torch.formats import assemble, build_protected
from abft_sparse_cg_tpu_torch.inject import inject_bitflips
from abft_sparse_cg_tpu_torch.ops.spmv import make_matrix_device
from abft_sparse_cg_tpu_torch.ops.spmv_cuda import (
    dia_fast,
    dia_fast_plain,
    dia_spec,
    ell_fast,
    ell_fast_plain,
    ell_spec,
)
from abft_sparse_cg_tpu_torch.solver import fused as fused_module
from abft_sparse_cg_tpu_torch.solver.cg import init_state
from abft_sparse_cg_tpu_torch.solver.fused import (
    DIA_TILE,
    SCHEDULES,
    WINDOW_MAX_SMEM,
    dia_block_rows,
    dia_schedule,
    dia_window_plan,
    fused_cg_dia,
    fused_cg_ell,
    fused_grid,
    make_fused_solver,
)
from abft_sparse_cg_tpu_torch.utils.ell_edges import (
    ROW_CUT,
    cut_rows,
    ell_edge_cases,
)
from abft_sparse_cg_tpu_torch.utils.matgen import (
    row_lengths_assembled,
    shuffle_labels,
    spd_tridiagonal,
)
from abft_sparse_cg_tpu_torch.utils.matzoo import dense_radius_3d

MODES = ["none", "constraints", "sed", "sec7", "sec8", "secded"]
CPU = torch.device("cpu")

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def dia_matrix(mode, n=4096, blocks=2, fmt="csr"):
    rows, cols, vals, n = spd_tridiagonal(n)
    return build_protected(fmt, assemble(cols, rows, vals, n, blocks),
                           mode)


def faulted(m, flips, seed, kind="ANY"):
    return inject_bitflips(m, kind, flips, np.random.default_rng(seed),
                           echo=lambda s: None)


def same_bits(a, b):
    """Bit-identical, NaN payloads aside."""
    nan = torch.isnan(b)
    return (torch.equal(nan, torch.isnan(a))
            and torch.equal(a[~nan].view(torch.int32),
                            b[~nan].view(torch.int32)))


@pytest.mark.parametrize("mode", MODES)
def test_kernel_a_matches_plain(dev, mode):
    m = dia_matrix(mode)
    spec = dia_spec(m, mode)
    x = torch.tensor(np.random.default_rng(5).random(m.R),
                     dtype=torch.float32, device=dev)
    variants = [m, faulted(m, 1, 31), faulted(m, 2, 32),
                faulted(m, 1, 33, "INDEX")]
    for mm in variants:
        md = make_matrix_device(mm, torch.float32, dev)
        before = dia_fast.launches
        wk, tk, pk = dia_fast(md, x, spec)
        assert dia_fast.launches == before + 1
        wp, tp, pp = dia_fast_plain(md, x, spec)
        assert same_bits(wk, wp)
        torch.testing.assert_close(pk, pp, rtol=1e-5, atol=0,
                                   equal_nan=True)
        assert bool(tk) == bool(tp)


def test_kernel_a_rejects_bad_arguments(dev):
    m = dia_matrix("secded")
    md = make_matrix_device(m, torch.float32, dev)
    spec = dia_spec(m, "secded")
    x = torch.rand(m.R, device=dev)
    with pytest.raises(ValueError):
        dia_fast(md, x.double(), spec)
    with pytest.raises(ValueError):
        dia_fast(md, torch.rand(2 * m.R, device=dev)[::2], spec)
    with pytest.raises(ValueError):
        dia_fast(md, x[: m.R - 32], spec)


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("mode,flips,seed", [
    ("none", 0, 0), ("constraints", 0, 0), ("secded", 0, 0),
    ("secded", 1, 6), ("sec7", 1, 6), ("sed", 1, 6), ("secded", 2, 3)])
def test_kernel_b_matches_plain(dev, mode, flips, seed, schedule):
    m = dia_matrix(mode)
    if flips:
        m = faulted(m, flips, seed)
    b = torch.zeros(m.R, dtype=torch.float32)
    b[: m.N] = torch.tensor(np.random.default_rng(7).random(m.N))
    solve = make_fused_solver(m, mode, 300, 1e-8, schedule=schedule)
    before = fused_cg_dia.launches
    on_schedule = fused_cg_dia.schedules[schedule]
    rk = solve(make_matrix_device(m, torch.float32, dev), b.to(dev))
    assert fused_cg_dia.launches > before
    assert fused_cg_dia.schedules[schedule] > on_schedule
    rp = solve(make_matrix_device(m, torch.float32, CPU), b)
    assert rk.iterations == rp.iterations
    assert tuple(rk.stats) == tuple(rp.stats)
    it = rk.iterations
    np.testing.assert_allclose(rk.rr_trace[:it].cpu().numpy(),
                               rp.rr_trace[:it].numpy(), rtol=1e-5)
    # Deterministic reductions: a second run is bit-identical.
    rk2 = solve(make_matrix_device(m, torch.float32, dev), b.to(dev))
    assert torch.equal(rk2.rr_trace[:it], rk.rr_trace[:it])
    assert torch.equal(rk2.x, rk.x)


def kernel_b_run(md, spec, b, upto, minv=None, ci=1, schedule=None,
                 conv=0.0):
    """One launch of kernel B from init_state: (FusedOut, x, r, p,
    trace)."""
    s = init_state(b, upto, minv)
    x, r, p = s.x.clone(), s.r.clone(), s.p.clone()
    tr = torch.full_like(s.trace, float("nan"))
    out = fused_cg_dia(md, spec, x, r, p, s.rr, s.rz, 0, upto, conv, tr,
                       None, minv, ci, schedule=schedule)
    torch.cuda.synchronize()
    return out, x, r, p, tr


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_kernel_b_state_after_a_trigger(dev, schedule):
    """An iteration that triggers or breaks down leaves x, r and p as
    they were before it, in the caller's buffers, also after folded
    updates: a lazy CI 4 run on a faulted matrix triggers at its first
    check (iteration 3) with the state of a clean 3-iteration run of the
    same matrix bit for bit; a live run triggers at once and leaves the
    entry state; an indefinite matrix breaks down at iteration 2 with
    the state of a 2-iteration run."""
    m = faulted(varied_dia_matrix("secded"), 1, 12)
    md = make_matrix_device(m, torch.float32, dev)
    spec = dia_spec(m, "secded")
    b = torch.zeros(m.R, dtype=torch.float32)
    b[: m.N] = torch.tensor(np.random.default_rng(7).random(m.N))
    b = b.to(dev)
    short = kernel_b_run(md, spec, b, 3, ci=4, schedule=schedule)
    full = kernel_b_run(md, spec, b, 300, ci=4, schedule=schedule)
    assert (full[0].itr, full[0].trig) == (3, 1)
    assert short[0].itr == 3
    for a, c in zip(short[1:4], full[1:4]):
        assert torch.equal(a, c)
    live = kernel_b_run(md, spec, b, 300, schedule=schedule)
    s = init_state(b, 300)
    assert (live[0].itr, live[0].trig) == (0, 1)
    for a, c in zip(live[1:4], (s.x, s.r, s.p)):
        assert torch.equal(a, c)
    rows, cols, vals, n = spd_tridiagonal(2048)
    vals = vals.copy()
    vals[(rows == cols) & (rows >= 2040)] = -3.0
    mi = build_protected("csr", assemble(cols, rows, vals, n, 1), "secded")
    mdi = make_matrix_device(mi, torch.float32, dev)
    spi = dia_spec(mi, "secded")
    bi = torch.zeros(mi.R, dtype=torch.float32)
    bi[: mi.N] = torch.tensor(np.random.default_rng(7).random(mi.N))
    bi = bi.to(dev)
    broke = kernel_b_run(mdi, spi, bi, 300, schedule=schedule)
    two = kernel_b_run(mdi, spi, bi, 2, schedule=schedule)
    assert broke[0].err == 7 and broke[0].itr == 2
    for a, c in zip(broke[1:4], two[1:4]):
        assert torch.equal(a, c)


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("shape", ["tridiagonal", "laplacian", "Jacobi",
                                   "lazy"])
def test_kernel_b_replays_bit_for_bit(dev, shape, schedule):
    """Kernel B on the card's grid against tests/test_torch_fused_plan.py's
    NumPy replay of its schedule and fixed-order reductions: iterations,
    trace, x, r and p bit for bit."""
    from test_torch_fused_plan import replay_solve

    from abft_sparse_cg_tpu_torch.utils.matgen import spd_laplacian_2d

    if shape == "laplacian":
        rows, cols, vals, n = spd_laplacian_2d(40)
        m = build_protected("csr", assemble(cols, rows, vals, n, 5),
                            "secded")
    else:
        m = varied_dia_matrix("secded", n=5000, blocks=3)
    spec = dia_spec(m, "secded")
    b = torch.zeros(m.R, dtype=torch.float32)
    b[: m.N] = torch.tensor(np.random.default_rng(7).random(m.N))
    minv = jacobi_minv(m, CPU) if shape == "Jacobi" else None
    ci = 4 if shape == "lazy" else 1
    upto = 30
    grid = fused_grid(0, "dia", False, minv is not None)
    itr, trig, err, x, r, p, trace = replay_solve(
        make_matrix_device(m, torch.float32, CPU), spec, b, minv, grid,
        schedule, upto, 1e-8, ci)
    # the replay's entry state (rr0 and rz0 summed on the CPU, as the
    # replay sums them)
    s = init_state(b, upto, minv)
    xk, rk, pk = (v.to(dev) for v in (s.x, s.r, s.p))
    tk = torch.full((upto + 1,), float("nan"), device=dev)
    out = fused_cg_dia(make_matrix_device(m, torch.float32, dev), spec, xk,
                       rk, pk, s.rr.to(dev), s.rz.to(dev), 0, upto, 1e-8, tk,
                       None, None if minv is None else minv.to(dev), ci,
                       schedule=schedule)
    torch.cuda.synchronize()
    assert (out.itr, out.trig, out.err) == (itr, trig, err)
    assert same_bits(tk[:itr].cpu(), torch.from_numpy(trace))
    for a, c in zip((xk, rk, pk), (x, r, p)):
        assert same_bits(a.cpu(), torch.from_numpy(np.asarray(c)))


def stencil27_matrix(mode, side=24, fmt="csr"):
    """HPCG's 27-point stencil (26 on the diagonal, -1 off it) on a
    side^3 grid in its natural order: DIA, offsets to +-(side^2 + side +
    1), past the fold's cap from side 22 on."""
    rows, cols = [], []
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                d = dz * side * side + dy * side + dx
                if d > 0:
                    continue
                iz = np.arange(max(0, -dz), side - max(0, dz))
                iy = np.arange(max(0, -dy), side - max(0, dy))
                ix = np.arange(max(0, -dx), side - max(0, dx))
                r = np.add.outer(np.add.outer(iz * side * side, iy * side),
                                 ix).ravel()
                rows.append(r)
                cols.append(r + d)
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    vals = np.where(rows == cols, 26.0, -1.0)
    return build_protected(fmt, assemble(cols, rows, vals, side ** 3, 1),
                           mode)


def budget_window_matrix(mode, fmt="csr"):
    """A DIA matrix whose offsets (0, +-1, +-1000, +-2000, +-2560) make one
    window of 1,024 + 5,120 rows: its two window sets take the whole of
    WINDOW_MAX_SMEM.  Diagonal 8, -1 off it: SPD."""
    n = 8192
    rows, cols, vals = [np.arange(n)], [np.arange(n)], [np.full(n, 8.0)]
    for d in (1, 1000, 2000, 2560):
        rows.append(np.arange(d, n))
        cols.append(np.arange(n - d))
        vals.append(np.full(n - d, -1.0))
    return build_protected(fmt, assemble(
        np.concatenate(cols), np.concatenate(rows), np.concatenate(vals), n,
        1), mode)


def periodic_matrix(mode, fmt="csr"):
    """The zoo's periodic-3d (side 44): DIA, offsets to +-83,248 in five
    clusters, so five windows."""
    from abft_sparse_cg_tpu_torch.utils.matzoo import zoo_assembled

    return build_protected(fmt, zoo_assembled("periodic-3d", 1), mode)


@pytest.mark.parametrize("shape", ["stencil 24", "varied", "budget",
                                   "periodic", "stencil 40 on 16 blocks"])
@pytest.mark.parametrize("variant,mode,fmt", [
    ("live", "secded", "csr"), ("lazy", "secded", "csr"),
    ("lazy fault", "secded", "csr"), ("Jacobi", "secded", "csr"),
    ("lazy Jacobi", "secded", "csr"), ("live", "constraints", "coo"),
    ("lazy", "constraints", "coo")])
def test_kernel_b_window_equals_three_sync(dev, monkeypatch, shape, variant,
                                          mode, fmt):
    """Kernel B's window schedule against three-sync, one launch each
    from the same entry state: only where the stencil reads p from
    differs, so itr, trig, err, rr, x, r, p and the trace are the same
    bits.  HPCG's stencil at 24^3 (offsets to +-601, one window), the
    varied tridiagonal, a matrix whose windows take the whole budget,
    the zoo's periodic-3d (five windows) and HPCG's stencil at 40^3
    (three windows) on a grid of 16 blocks, so that each block runs four
    tiles and restages all three windows into both window sets in turn
    (the card's own grid gives these shapes one tile per block),
    live, lazy CI 4 (and a 1-bit fault that triggers at the first
    check), Jacobi, secded on CSR96 and the two-plane constraints
    instances on COO128; each launch counted under its schedule."""
    m = {"stencil 24": stencil27_matrix, "varied": varied_dia_matrix,
         "budget": budget_window_matrix, "periodic": periodic_matrix,
         "stencil 40 on 16 blocks": lambda mode, fmt: stencil27_matrix(
             mode, side=40, fmt=fmt)}[shape](mode, fmt=fmt)
    if "fault" in variant:
        m = faulted(m, 1, 12)
    spec = dia_spec(m, mode)
    if shape == "stencil 24":
        assert max(abs(o) for o in spec.offsets) == 601
        assert dia_schedule(spec.offsets) == "window"
    if shape == "budget":
        assert 2 * 4 * dia_window_plan(spec.offsets).set_floats == \
            WINDOW_MAX_SMEM
    if shape == "periodic":
        assert len(dia_window_plan(spec.offsets).starts) == 5
    if shape == "stencil 40 on 16 blocks":
        assert len(dia_window_plan(spec.offsets).starts) == 3
        monkeypatch.setattr(fused_module, "fused_grid",
                            lambda *args, **kw: 16)
        assert dia_block_rows(m.R, 16) > 3 * DIA_TILE
    assert (spec.plane2 is not None) == (mode == "constraints")
    md = make_matrix_device(m, torch.float32, dev)
    b = torch.zeros(m.R, dtype=torch.float32)
    b[: m.N] = torch.tensor(np.random.default_rng(7).random(m.N))
    minv = jacobi_minv(m, dev) if "Jacobi" in variant else None
    ci = 4 if "lazy" in variant else 1
    runs = []
    for sched in ("three-sync", "window"):
        before = dict(fused_cg_dia.schedules)
        runs.append(kernel_b_run(md, spec, b.to(dev), 60, minv, ci, sched,
                                 1e-8))
        before[sched] += 1
        assert fused_cg_dia.schedules == before
    (o3, *v3), (ow, *vw) = runs
    assert (ow.itr, ow.trig, ow.err) == (o3.itr, o3.trig, o3.err)
    assert ow.itr > 0 and (ow.trig == 1) == ("fault" in variant)
    assert same_bits(ow.rr.cpu(), o3.rr.cpu())
    for a, c in zip(vw, v3):
        assert same_bits(a.cpu(), c.cpu())
    if ci > 1:
        for a, c in zip(ow.snap[1:4], o3.snap[1:4]):
            assert same_bits(a.cpu(), c.cpu())


def test_kernel_b_counts_window_launches(dev):
    """fused_cg_dia.schedules["window"] counts every tail-free launch of
    a solve on a matrix past the fold's cap (HPCG's stencil at 24^3),
    and none on a fold matrix, whose launches all count as "fold"."""
    for m, sched in ((stencil27_matrix("secded"), "window"),
                     (dia_matrix("secded"), "fold")):
        b = torch.zeros(m.R, dtype=torch.float32)
        b[: m.N] = torch.tensor(np.random.default_rng(7).random(m.N))
        solve = make_fused_solver(faulted(m, 1, 6), "secded", 300, 1e-8)
        before, launches = dict(fused_cg_dia.schedules), fused_cg_dia.launches
        res = solve(make_matrix_device(faulted(m, 1, 6), torch.float32, dev),
                    b.to(dev))
        n = fused_cg_dia.launches - launches
        assert n >= 2 and res.stats.corrected_count == 1   # a repair: 2+
        before[sched] += n
        assert fused_cg_dia.schedules == before


def ell_matrix(mode, shape="dense-radius", fmt="csr"):
    if shape == "dense-radius":
        rows, cols, vals, n = dense_radius_3d(side=16)
        return build_protected(fmt, assemble(cols, rows, vals, n, 2), mode)
    rows, cols, vals, n = shuffle_labels(*spd_tridiagonal(8192), seed=11)
    return build_protected(fmt, assemble(cols, rows, vals, n, 1), mode,
                           force_exec="ell")


@pytest.mark.parametrize("shape", ["dense-radius", "permuted"])
@pytest.mark.parametrize("mode", MODES)
def test_kernel_c_matches_plain(dev, mode, shape):
    m = ell_matrix(mode, shape)
    spec = ell_spec(m, mode)
    x = torch.tensor(np.random.default_rng(5).random(m.R),
                     dtype=torch.float32, device=dev)
    variants = [m, faulted(m, 1, 31), faulted(m, 2, 32),
                faulted(m, 1, 33, "INDEX")]
    for mm in variants:
        md = make_matrix_device(mm, torch.float32, dev)
        before = ell_fast.launches
        wk, tk, pk = ell_fast(md, x, spec)
        assert ell_fast.launches == before + 1
        wp, tp, pp = ell_fast_plain(md, x, spec)
        torch.testing.assert_close(wk, wp, rtol=0, atol=0, equal_nan=True)
        torch.testing.assert_close(pk, pp, rtol=1e-5, atol=0,
                                   equal_nan=True)
        assert bool(tk) == bool(tp)


def test_kernel_c_rejects_bad_arguments(dev):
    m = ell_matrix("secded")
    md = make_matrix_device(m, torch.float32, dev)
    spec = ell_spec(m, "secded")
    x = torch.rand(m.R, device=dev)
    with pytest.raises(ValueError):
        ell_fast(md, x.double(), spec)
    with pytest.raises(ValueError):
        ell_fast(md, x[: m.R - 32], spec)
    with pytest.raises(ValueError):
        ell_fast(md._replace(ell_len=md.ell_len.long()), x, spec)


@pytest.mark.parametrize("mode,flips,seed,shape", [
    ("none", 0, 0, "dense-radius"), ("constraints", 0, 0, "dense-radius"),
    ("secded", 0, 0, "dense-radius"), ("secded", 1, 6, "dense-radius"),
    ("sec7", 1, 6, "permuted"), ("sed", 1, 6, "dense-radius"),
    ("secded", 2, 3, "dense-radius"), ("secded", 0, 0, "permuted")])
def test_kernel_d_matches_plain(dev, mode, flips, seed, shape):
    m = ell_matrix(mode, shape)
    if flips:
        m = faulted(m, flips, seed)
    b = torch.zeros(m.R, dtype=torch.float32)
    b[: m.N] = torch.tensor(np.random.default_rng(7).random(m.N))
    solve = make_fused_solver(m, mode, 300, 1e-8)
    before = fused_cg_ell.launches
    # mode none keeps the first design's loop; the rest run the stream
    sched = "grid-stride" if mode == "none" else "window"
    on_schedule = fused_cg_ell.schedules[sched]
    rk = solve(make_matrix_device(m, torch.float32, dev), b.to(dev))
    assert fused_cg_ell.launches > before
    assert fused_cg_ell.schedules[sched] > on_schedule
    rp = solve(make_matrix_device(m, torch.float32, CPU), b)
    assert rk.iterations == rp.iterations
    assert tuple(rk.stats) == tuple(rp.stats)
    it = rk.iterations
    np.testing.assert_allclose(rk.rr_trace[:it].cpu().numpy(),
                               rp.rr_trace[:it].numpy(), rtol=1e-5)
    rk2 = solve(make_matrix_device(m, torch.float32, dev), b.to(dev))
    assert torch.equal(rk2.rr_trace[:it], rk.rr_trace[:it])
    assert torch.equal(rk2.x, rk.x)


def kernel_d_grid(md, spec):
    """Kernel D's tail-free grid and schedule on this card for ``md``
    (solver.fused.ell_plan)."""
    from abft_sparse_cg_tpu_torch.solver.fused import ell_plan

    return ell_plan(0, md.values.shape[1], spec.band,
                    2 if spec.plane2 is not None else 1)


def test_kernel_d_plan_on_the_card(dev):
    """The card's occupancy gives the plan tests/test_torch_fused_ell_
    plan.py holds on its model of the H100: dense-radius-3d -b 10 at 5
    blocks per SM with one signal plane, 4 with two, the window;
    stencil27-shuffled -b 10 the l2 schedule at 7."""
    from test_torch_fused_ell_plan import h100_occupancy

    from abft_sparse_cg_tpu_torch.solver.fused import ell_plan, ell_row_plan

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for R, band, planes in ((221184, 1627, 1), (221184, 1627, 2),
                            (640000, 4681, 1)):
        assert ell_plan(dev.index, R, band, planes) == \
            ell_row_plan(R, band, planes, sms, h100_occupancy)


@pytest.mark.parametrize("case", [
    "narrow band", "narrow band Jacobi",
    "lazy window closing mid-run", "trigger at the first check",
    "two planes", "RCM gidx", "band over the cap", "breakdown", "edge R32",
    "edge K1", "edge K13", "edge empty-tiles", "corrupted index"])
def test_kernel_d_replays_bit_for_bit(dev, case):
    """Kernel D's tail-free instances on the card's grid against tests/
    test_torch_fused_ell_plan.py's NumPy replay of their schedule and
    fixed-order reductions: exit state, trace, x, r and p bit for bit (the
    lazy snapshot too).  Covers the window and the l2 schedule (a band
    over the cap), RCM gidx, Jacobi, lazy CI 4, two planes, a trigger, a
    breakdown, kernel C's edge shapes (utils.ell_edges, R 32 cut from a
    built matrix) and an index moved far outside its block's window with
    the signal plane left blind to it (read from device memory: the
    replay's w is ops.spmv.ell_product's)."""
    from test_torch_fused_ell_plan import Partition, replay_solve, setup

    from abft_sparse_cg_tpu_torch.solver.fused import ell_halo

    md, spec, b, minv, _, _, ci, upto, _ = setup(case)
    if case == "edge R32":
        md, b = cut_rows(md, ROW_CUT["R32"]), b[: ROW_CUT["R32"]]
    grid, schedule = kernel_d_grid(md, spec)
    assert schedule == ("l2" if case == "band over the cap" else "window")
    if case == "corrupted index":
        # setup moved slot 0 of row 5 to row R - 7: past block 0's window
        part = Partition(md.values.shape[1], grid)
        assert md.values.shape[1] - 7 >= part.hi[0] + ell_halo(spec.band)
    itr, trig, err, x, r, p, trace, snap = replay_solve(
        md, spec, b, minv, grid, schedule, upto, 1e-8, ci)
    s = init_state(b, upto, minv)
    xk, rk, pk = (v.to(dev) for v in (s.x, s.r, s.p))
    tk = torch.full((upto + 1,), float("nan"), device=dev)
    before = fused_cg_ell.schedules[schedule]
    mdk = md._replace(**{f: None if getattr(md, f) is None else
                         (tuple(t.to(dev) for t in getattr(md, f))
                          if f == "words" else getattr(md, f).to(dev))
                         for f in md._fields})
    out = fused_cg_ell(mdk, spec, xk, rk, pk, s.rr.to(dev), s.rz.to(dev),
                       0, upto, 1e-8, tk, None,
                       None if minv is None else minv.to(dev), ci,
                       schedule=schedule)
    torch.cuda.synchronize()
    assert fused_cg_ell.schedules[schedule] == before + 1
    assert (out.itr, out.trig, out.err) == (itr, trig, err)
    assert same_bits(tk[:itr].cpu(), torch.from_numpy(trace))
    for a, c in zip((xk, rk, pk), (x, r, p)):
        assert same_bits(a.cpu(), torch.from_numpy(np.asarray(c)))
    if snap is not None and out.snap.itr > 0:
        for a, c in zip((out.snap.x, out.snap.r, out.snap.p), snap):
            assert same_bits(a.cpu(), torch.from_numpy(np.asarray(c)))


@pytest.mark.parametrize("variant", ["lazy", "lazy Jacobi"])
@pytest.mark.parametrize("schedule", ["window", "l2"])
def test_kernel_d_clean_lazy_equals_live(dev, variant, schedule):
    """A clean lazy (CI 4) solve on kernel D equals the live one bit for
    bit (one grid, one partition, one reduction order for every instance
    of the stream), under each schedule; and, where the two schedules'
    plans give one grid (this matrix: one block per warp of rows), the
    two schedules' x are the same bits."""
    from abft_sparse_cg_tpu_torch.solver.fused import ell_plan

    m = ell_matrix("secded")
    precond = "Jacobi" in variant
    b = torch.zeros(m.R, dtype=torch.float32)
    b[: m.N] = torch.tensor(np.random.default_rng(7).random(m.N))
    args = (jacobi_minv(m, dev),) if precond else ()
    xs = {}
    for ci in (1, 4):
        for sched in ("window", "l2"):
            solve = make_fused_solver(m, "secded", 300, 1e-8,
                                      precond=precond, check_interval=ci,
                                      schedule=sched)
            xs[ci, sched] = solve(make_matrix_device(m, torch.float32, dev),
                                  b.to(dev), *args).x
    assert torch.equal(xs[4, schedule], xs[1, schedule])
    assert ell_plan(0, m.R, m.band, 1, "window")[0] == \
        ell_plan(0, m.R, m.band, 1, "l2")[0]
    assert torch.equal(xs[1, "window"], xs[1, "l2"])


# --------------------------------------------------------------------------
# Kernel E, the split tail of kernels B and D, the per-iteration tier
# --------------------------------------------------------------------------

def flat_matrix(mode, shape, fmt="csr"):
    """Flat layouts: powerlaw-graph (hub rows), stencil27-shuffled under
    its RCM permutation (the gidx plane), K = 729 dense rows."""
    from abft_sparse_cg_tpu_torch.utils.matzoo import (
        powerlaw_graph,
        stencil27_shuffled,
    )

    tri, kw = {"powerlaw": (lambda: powerlaw_graph(n=8192),
                            {"split": "none"}),
               "stencil27": (lambda: stencil27_shuffled(side=16),
                             {"force_exec": "flat"}),
               "k729": (lambda: dense_radius_3d(side=9, rx=4, ry=4, rz=4),
                        {"force_exec": "flat"})}[shape]
    rows, cols, vals, n = tri()
    m = build_protected(fmt, assemble(cols, rows, vals, n, 1), mode, **kw)
    assert m.exec_kind == "flat"
    return m


@pytest.mark.parametrize("shape", ["powerlaw", "stencil27", "k729"])
@pytest.mark.parametrize("mode", MODES)
def test_kernel_e_matches_plain(dev, mode, shape):
    """Kernel E against its plain version: w bit-exact (same lane order
    and butterfly), pw to 1e-5, the trigger equal; clean and faulted."""
    from abft_sparse_cg_tpu_torch.ops.spmv_cuda import (
        flat_fast,
        flat_fast_plain,
        flat_spec,
    )

    m = flat_matrix(mode, shape)
    spec = flat_spec(m, mode)
    x = torch.tensor(np.random.default_rng(5).random(m.R),
                     dtype=torch.float32, device=dev)
    for mm in (m, faulted(m, 1, 31), faulted(m, 2, 32),
               faulted(m, 1, 33, "INDEX")):
        md = make_matrix_device(mm, torch.float32, dev)
        before = flat_fast.launches
        wk, tk, pk = flat_fast(md, x, spec)
        assert flat_fast.launches == before + 1
        wp, tp, pp = flat_fast_plain(md, x, spec)
        assert same_bits(wk, wp)
        torch.testing.assert_close(pk, pp, rtol=1e-5, atol=0,
                                   equal_nan=True)
        assert bool(tk) == bool(tp)


@pytest.mark.parametrize("shape", ["powerlaw-hubs", "row-lengths"])
@pytest.mark.parametrize("mode", ["none", "constraints", "sec8", "secded"])
def test_kernel_e_rows_of_every_length(dev, mode, shape):
    """Kernel E's row blocks on hub rows (powerlaw-graph at the zoo's
    size: rows of up to 10,875 slots, past the tile) and on rows of every
    length class: w bit-identical to the plain version, the trigger
    equal, pw to 1e-5; clean and faulted, x with -0.0, NaN and inf."""
    from abft_sparse_cg_tpu_torch.ops.spmv import FLAT_TILE
    from abft_sparse_cg_tpu_torch.ops.spmv_cuda import (
        flat_fast,
        flat_fast_plain,
        flat_spec,
    )
    from abft_sparse_cg_tpu_torch.utils.matzoo import zoo_assembled

    if shape == "powerlaw-hubs":
        m = build_protected("csr", zoo_assembled("powerlaw-graph"), mode,
                            split="none")
    else:
        m = build_protected("csr", row_lengths_assembled(), mode,
                            force_exec="flat")
    assert m.exec_kind == "flat"
    spec = flat_spec(m, mode)
    rng = np.random.default_rng(5)
    xs = rng.standard_normal(m.R).astype(np.float32)
    x = torch.tensor(xs, device=dev)
    xs[rng.permutation(m.R)[:64]] = -0.0
    xs[rng.permutation(m.R)[:4]] = np.nan
    xs[rng.permutation(m.R)[:4]] = np.inf
    x_odd = torch.tensor(xs, device=dev)
    for mm in (m, faulted(m, 1, 31), faulted(m, 2, 32)):
        md = make_matrix_device(mm, torch.float32, dev)
        assert int(torch.diff(md.row_ptr).max()) > FLAT_TILE
        for xx in (x, x_odd):
            wk, tk, pk = flat_fast(md, xx, spec)
            wp, tp, pp = flat_fast_plain(md, xx, spec)
            assert same_bits(wk, wp)
            assert bool(tk) == bool(tp)
            torch.testing.assert_close(pk, pp, rtol=1e-5, atol=0,
                                       equal_nan=True)


def one_launch_calls(kernel, dev):
    """[(m, [call, call])] per matrix (clean, faulted): the solvers' impls
    of kernel A, C or E (live, detection-free) on x, or kernel C's halo
    form as the sharded tier resolves it for shard 1 of 4 (live and
    detection-free launchers on the shard's x_ext)."""
    from abft_sparse_cg_tpu_torch.ops.spmv_cuda import (
        ell_launcher,
        make_cuda_product,
        make_cuda_spmv,
        product_spec,
    )

    out = []
    if kernel == "C halo":
        from abft_sparse_cg_tpu_torch.parallel.sharded import (
            default_mesh,
            shard_rows,
        )
        from abft_sparse_cg_tpu_torch.parallel.sharded_kernel import (
            _halo,
            halo_exchange,
        )
        from abft_sparse_cg_tpu_torch.parallel.vector import ShardedVector

        m0 = sharded_matrix("secded", "ell", 4)
        R_loc, H = m0.R // 4, _halo(m0)
        mesh = default_mesh(4, dev)
        x = torch.tensor(np.random.default_rng(5).random(m0.R),
                         dtype=torch.float32, device=dev)
        ext1 = halo_exchange(ShardedVector.scatter(x, mesh.devices), H)[1]
        for m in (m0, halo_fault(m0, 4)):
            md1 = shard_rows(make_matrix_device(m, torch.float32, dev),
                             mesh)[1]
            fns = [ell_launcher(md1, spec, dev, H, R_loc)
                   for spec in (ell_spec(m, "secded"),
                                product_spec(m, "secded"))]
            out.append((m, [lambda f=f: f(ext1) for f in fns]))
        return out
    m = {"A": lambda: dia_matrix("secded"),
         "C": lambda: ell_matrix("secded"),
         "E": lambda: flat_matrix("secded", "powerlaw")}[kernel]()
    x = torch.tensor(np.random.default_rng(5).random(m.R),
                     dtype=torch.float32, device=dev)
    for mm in (m, faulted(m, 1, 31)):
        md = make_matrix_device(mm, torch.float32, dev)
        out.append((mm, [lambda f=impl.fast_pw, a=md: f(a, x) for impl in
                         (make_cuda_spmv(mm), make_cuda_product(mm))]))
    return out


def one_launch_profile(kernel):
    """Per call of one_launch_calls(kernel), the device operations (names)
    the profiler lists for 5 calls after a warm-up call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    names = []
    for _, calls in one_launch_calls(kernel, torch.device("cuda", 0)):
        for call in calls:
            call()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    call()
                torch.cuda.synchronize()
            names.append([e.name for e in prof.events()
                          if e.device_type == DeviceType.CUDA])
    return names


@pytest.mark.parametrize("kernel", ["A", "C", "C halo", "E"])
def test_one_launch_per_call_and_repeatable(dev, kernel):
    """Kernels A, C (and C's halo form on a shard) and E as the solvers
    call them (live and detection-free): one device operation per call in
    the profiler's list of a fresh process (a long one, as this test
    process, loses profiler events: on the card it once listed none of
    kernel E's 5), and 105 back-to-back calls on one matrix give
    identical w, pw and trigger (the block counter and, in E, the chunk
    flags reset themselves), clean and faulted."""
    tests = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(tests)
    run = subprocess.run(
        [sys.executable, "-c", "import json, test_torch_cuda as t; "
         f"print(json.dumps(t.one_launch_profile({kernel!r})))"],
        cwd=root, capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": os.pathsep.join((root, tests))})
    assert run.returncode == 0, run.stderr[-3000:]
    for ops in json.loads(run.stdout.strip().splitlines()[-1]):
        assert len(ops) == 5, ops
    for _, calls in one_launch_calls(kernel, dev):
        for call in calls:
            first = call()
            outs = [call() for _ in range(105)]
            torch.cuda.synchronize()
            for w, trig, pw in outs:
                assert same_bits(w, first[0])
                assert same_bits(pw.view(1), first[2].view(1))
                assert bool(trig) == bool(first[1])


@pytest.mark.parametrize("case", ["R32", "K1", "K13", "empty-tiles"])
@pytest.mark.parametrize("mode", ["none", "constraints", "sec8", "secded"])
def test_kernel_c_ragged_edges(dev, mode, case):
    """Kernel C and its detection-free product at the edges of its
    schedule (utils.ell_edges: R = 32, K = 1, K = 13, whole tiles of empty
    rows): w bit-exact to the plain version, the trigger equal, pw to
    1e-5; clean and faulted."""
    from abft_sparse_cg_tpu_torch.ops.spmv_cuda import product_spec

    asm, kw = ell_edge_cases()[case]
    m = build_protected("csr", asm, mode, force_exec="ell", **kw)
    assert m.exec_kind == "ell" and (case != "K13" or m.K == 13)
    R = ROW_CUT.get(case, m.R)
    x = torch.tensor(np.random.default_rng(5).standard_normal(R),
                     dtype=torch.float32, device=dev)
    for mm in (m, faulted(m, 1, 31)):
        md = cut_rows(make_matrix_device(mm, torch.float32, dev),
                      ROW_CUT.get(case))
        for spec in (ell_spec(mm, mode), product_spec(mm, mode)):
            wk, tk, pk = ell_fast(md, x, spec)
            wp, tp, pp = ell_fast_plain(md, x, spec)
            assert same_bits(wk, wp), (case, spec.detect)
            assert bool(tk) == bool(tp)
            torch.testing.assert_close(pk, pp, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("fmt,mode", [
    ("csr", "none"), ("csr", "constraints"), ("csr", "secded"),
    ("coo", "constraints")],
    ids=["none", "constraints", "secded", "coo-constraints"])
def test_kernel_c_many_tiles_per_block(dev, fmt, mode):
    """Kernel C where every block walks at least three 128-row tiles (R
    past 3 tiles per resident block), so its ring of slabs runs on from
    one tile into the next: 13 diagonals over the first half of the rows,
    a tridiagonal over the rest, 2,000 empty rows between them (tiles of
    4, 1 and 0 value slabs).  Live and as the product, clean and
    faulted: w bit-exact to the plain version, the trigger equal, pw to
    1e-5.  COO constraints runs the two-plane instance (its fourth ring
    slab, its own occupancy and grid), with a row-word flip and the
    4-bit col/row fault besides, each of which must fire it."""
    from abft_sparse_cg_tpu_torch._build import library
    from abft_sparse_cg_tpu_torch.ops.spmv import ELL_TILE_ROWS, ell_grid
    from abft_sparse_cg_tpu_torch.ops.spmv_cuda import product_spec
    from abft_sparse_cg_tpu_torch.utils.coo_faults import (
        col_row_fault,
        row_word_flip,
    )

    planes = 2 if fmt == "coo" else 1
    per_sm, sms = ctypes.c_int(0), ctypes.c_int(0)
    assert library("ell_spmv_detect").abft_ell_spmv_occupancy(
        dev.index, 0, planes, ctypes.addressof(per_sm),
        ctypes.addressof(sms)) == 0
    n = 3 * ELL_TILE_ROWS * sms.value * per_sm.value + 1000
    h = n // 2
    i = np.arange(h)
    rows, cols, vals = [i], [i], [np.full(h, 20.0)]
    for d in range(1, 7):
        rows.append(i[d:])
        cols.append(i[:-d])
        vals.append(-np.ones(h - d) / d)
    r, c, v, _ = spd_tridiagonal(n - h - 2000)
    rows.append(r + h + 2000)
    cols.append(c + h + 2000)
    vals.append(v)
    m = build_protected(fmt, assemble(
        np.concatenate(cols), np.concatenate(rows), np.concatenate(vals), n,
        1), mode, force_exec="ell")
    assert m.exec_kind == "ell" and m.K == 13
    assert (ell_spec(m, mode).plane2 is not None) == (planes == 2)
    grid = ell_grid(m.R, sms.value, per_sm.value)
    assert m.R // grid >= 3 * ELL_TILE_ROWS
    x = torch.tensor(np.random.default_rng(5).standard_normal(m.R),
                     dtype=torch.float32, device=dev)
    cases = [(m, False), (faulted(m, 1, 31), None)]
    if fmt == "coo":
        cases += [(row_word_flip(m, m.nnz // 3 + 1), True),
                  (col_row_fault(m, m.nnz // 3), True)]
    for mm, fires in cases:
        md = make_matrix_device(mm, torch.float32, dev)
        for spec in (ell_spec(mm, mode), product_spec(mm, mode)):
            before = ell_fast.two_plane_launches
            wk, tk, pk = ell_fast(md, x, spec)
            wp, tp, pp = ell_fast_plain(md, x, spec)
            assert same_bits(wk, wp), spec.detect
            assert bool(tk) == bool(tp)
            torch.testing.assert_close(pk, pp, rtol=1e-5, atol=1e-6)
            if spec.detect:
                assert ell_fast.two_plane_launches == before + (planes == 2)
                if fires is not None and mode != "none":
                    assert bool(tk) == fires


def bordered(core, k=600, seed=3):
    """``core`` plus two dense rows of ``k`` entries (a bordered split
    with a dense-plan tail), diagonally dominant."""
    rows, cols, vals, n = core
    rows, cols, vals = list(rows), list(cols), list(vals)
    rng = np.random.default_rng(seed)
    for r in (17, 900):
        for c in np.setdiff1d(rng.choice(n, size=k, replace=False), [r]):
            rows.append(max(r, int(c)))
            cols.append(min(r, int(c)))
            vals.append(-0.01)
    rows, cols = np.array(rows), np.array(cols)
    vals = np.array(vals, dtype=float)
    deg = np.bincount(rows, minlength=n) + np.bincount(cols, minlength=n)
    diag = rows == cols
    vals[diag] = np.abs(vals[diag]) + 0.01 * deg[rows[diag]] + 4.0
    return rows, cols, vals, n


def split_matrix(mode, main, fmt="csr"):
    from abft_sparse_cg_tpu_torch.utils.matzoo import (
        arrowhead,
        blockdiag_random,
    )

    rows, cols, vals, n = (arrowhead(n=8192) if main == "dia"
                           else bordered(blockdiag_random(n=4000)))
    m = build_protected(fmt, assemble(cols, rows, vals, n, 1), mode)
    assert m.exec_kind == "split" and m.main.exec_kind == main
    assert m.tail.dense_plan is not None
    return m


# Dense rows coupled to whole column ranges, (row, lo, hi), on a 4096-row
# tridiagonal core: windows that overlap where both spans' entries share
# a 128-row tile, and outlier rows inside the other outlier's window.
SPANS = {
    "windows share a tile": ((100, 0, 1200), (3000, 1100, 2300)),
    "outlier in another window": ((1500, 2000, 3100), (2500, 1000, 2100)),
}


def spans_matrix(mode, case, n=4096):
    """A bordered split whose dense plan has the windows of SPANS[case]
    (diagonally dominant)."""
    rows, cols, vals, n = spd_tridiagonal(n)
    pairs = {(int(r), int(c)) for r, c in zip(rows, cols)}
    rows, cols, vals = list(rows), list(cols), list(vals)
    for r, lo, hi in SPANS[case]:
        for c in range(lo, hi):
            key = (max(r, c), min(r, c))
            if key not in pairs:
                pairs.add(key)
                rows.append(key[0])
                cols.append(key[1])
                vals.append(-0.01)
    rows, cols = np.array(rows), np.array(cols)
    vals = np.array(vals, dtype=float)
    deg = np.bincount(rows, minlength=n) + np.bincount(cols, minlength=n)
    diag = rows == cols
    vals[diag] = np.abs(vals[diag]) + 0.01 * deg[rows[diag]] + 4.0
    m = build_protected("csr", assemble(cols, rows, vals, n, 1), mode)
    assert m.exec_kind == "split" and m.main.exec_kind == "dia"
    assert m.tail.dense_plan is not None
    return m


@pytest.mark.parametrize("case", sorted(SPANS))
@pytest.mark.parametrize("mode,flips,seed", [
    ("secded", 0, 0), ("secded", 1, 6), ("sed", 1, 6)])
def test_split_tail_windows(dev, case, mode, flips, seed):
    """Kernel B's split tail where two windows overlap and where an
    outlier row lies inside the other's window: the plain loop's
    iterations and events, its trace to 1e-3 above float32's noise floor,
    a second run bit-identical."""
    m = spans_matrix(mode, case)
    rows, starts, S = m.tail.dense_plan
    assert len(rows) == 2 and max(starts) < min(starts) + S  # overlap
    if case == "outlier in another window":
        assert all(st <= o < st + S for o in rows for st in starts)
    if flips:
        m = faulted(m, flips, seed)
    b = torch.zeros(m.R, dtype=torch.float32)
    b[: m.N] = torch.tensor(np.random.default_rng(7).random(m.N))
    solve = make_fused_solver(m, mode, 300, 1e-8)
    before = fused_cg_dia.tail_launches
    rk = solve(make_matrix_device(m, torch.float32, dev), b.to(dev))
    assert fused_cg_dia.tail_launches > before
    rp = solve(make_matrix_device(m, torch.float32, CPU), b)
    assert rk.iterations == rp.iterations
    assert tuple(rk.stats) == tuple(rp.stats)
    it = rk.iterations
    t0 = rp.rr_trace[:it].numpy()
    above = t0 > (t0[0] * 1e-5 if it else 0)
    np.testing.assert_allclose(rk.rr_trace[:it].cpu().numpy()[above],
                               t0[above], rtol=1e-3)
    rk2 = solve(make_matrix_device(m, torch.float32, dev), b.to(dev))
    assert torch.equal(rk2.x, rk.x)


@pytest.mark.parametrize("shape", ["dia", "ell", "windows share a tile",
                                   "outlier in another window"])
def test_split_tail_replays_bit_for_bit(dev, shape):
    """One iteration of kernel B or D with the split tail on the card's
    grid, against tests/test_torch_tail_plan.py's NumPy replay of the
    schedule: w (through r = b - alpha w), pw (through alpha) and x equal
    bit for bit."""
    from test_torch_tail_plan import main_product, replay

    from abft_sparse_cg_tpu_torch.ops.spmv_cuda import fast_spec
    from abft_sparse_cg_tpu_torch.solver.cg import init_state
    from abft_sparse_cg_tpu_torch.solver.fused import fused_grid, tail_spec

    m = (split_matrix("secded", shape) if shape in ("dia", "ell")
         else spans_matrix("secded", shape))
    spec = fast_spec(m.main, "secded")
    kernel = fused_cg_dia if m.main.exec_kind == "dia" else fused_cg_ell
    md = make_matrix_device(m, torch.float32, dev)
    b = np.zeros(m.R, np.float32)
    b[: m.N] = np.random.default_rng(7).random(m.N)
    s = init_state(torch.from_numpy(b).to(dev), 4)
    x, r, p = s.x.clone(), s.r.clone(), s.p.clone()
    out = kernel(md[0], spec, x, r, p, s.rr, s.rz, 0, 1, 0.0,
                 torch.full_like(s.trace, float("nan")),
                 (md[1], tail_spec(m, "secded")))
    assert (out.itr, out.trig, out.err) == (1, 0, 0)
    rows, starts, S = m.tail.dense_plan
    mdc = make_matrix_device(m, torch.float32, CPU)
    got = replay(main_product(m, mdc, b), b, rows, starts, S,
                 mdc[1].dense_td.numpy(), mdc[1].dense_tb.numpy(),
                 fused_grid(0, m.main.exec_kind, True))
    alpha = np.float32(np.float32(s.rz.item()) / got["pw"])
    np.testing.assert_array_equal(x.cpu().numpy(), alpha * b)
    np.testing.assert_array_equal(r.cpu().numpy(), b - alpha * got["w"])


@pytest.mark.parametrize("main", ["dia", "ell"])
@pytest.mark.parametrize("mode,flips,seed", [
    ("none", 0, 0), ("constraints", 0, 0), ("secded", 0, 0),
    ("secded", 1, 6), ("sec7", 1, 9), ("sed", 1, 6), ("secded", 2, 3)])
def test_split_tail_matches_plain(dev, mode, flips, seed, main):
    """Kernel B (DIA main) and D (ELL main) with the split tail against
    their plain loop: iterations and events equal, the rr trace to 1e-3
    above float32's noise floor (the tail's dot products are summed in
    another order), a second run bit-identical."""
    m = split_matrix(mode, main)
    if flips:
        m = faulted(m, flips, seed)
    b = torch.zeros(m.R, dtype=torch.float32)
    b[: m.N] = torch.tensor(np.random.default_rng(7).random(m.N))
    solve = make_fused_solver(m, mode, 300, 1e-8)
    kernel = fused_cg_dia if main == "dia" else fused_cg_ell
    before = kernel.tail_launches
    rk = solve(make_matrix_device(m, torch.float32, dev), b.to(dev))
    assert kernel.tail_launches > before
    rp = solve(make_matrix_device(m, torch.float32, CPU), b)
    assert rk.iterations == rp.iterations
    assert tuple(rk.stats) == tuple(rp.stats)
    it = rk.iterations
    t0 = rp.rr_trace[:it].numpy()
    above = t0 > (t0[0] * 1e-5 if it else 0)
    np.testing.assert_allclose(rk.rr_trace[:it].cpu().numpy()[above],
                               t0[above], rtol=1e-3)
    rk2 = solve(make_matrix_device(m, torch.float32, dev), b.to(dev))
    assert torch.equal(rk2.rr_trace[:it], rk.rr_trace[:it])
    assert torch.equal(rk2.x, rk.x)


@pytest.mark.parametrize("shape", ["flat", "band-split"])
def test_per_iteration_tier(dev, shape):
    """Flat matrices and band splits run the per-iteration tier on the
    card (kernel E, and kernel C for a band split's main): a corrected
    fault, the answer within float32 reach of b."""
    from abft_sparse_cg_tpu_torch.backends.cuda_backend import CudaBackend
    from abft_sparse_cg_tpu_torch.ops.spmv_cuda import flat_fast
    from abft_sparse_cg_tpu_torch.solver.fused import supports_fused
    from abft_sparse_cg_tpu_torch.utils.matzoo import band_plus_random

    if shape == "flat":
        m = flat_matrix("secded", "stencil27")
    else:
        rows, cols, vals, n = band_plus_random(n=16384)
        m = build_protected("csr", assemble(cols, rows, vals, n, 1),
                            "secded")
        assert m.exec_kind == "split" and m.tail.dense_plan is None
    assert not supports_fused(m, torch.float32)
    m = faulted(m, 1, 6)
    b = np.random.default_rng(1).random(m.N)
    before = flat_fast.launches
    res = CudaBackend("secded").solve(m, b, 500, 1e-8, reps=1)
    assert flat_fast.launches > before
    assert res.corrected_count == 1 and not res.failed
    w, code, _ = CudaBackend("secded").spmv_once(m, res.x)
    assert code == 0 and np.abs(w - b).max() < 1e-2


# --------------------------------------------------------------------------
# The Jacobi and lazy instances of kernels B and D, the detection-free
# products of kernels A, C and E, the per-iteration lazy loop
# --------------------------------------------------------------------------

def jacobi_minv(m, device):
    from abft_sparse_cg_tpu_torch.backends.torch_backend import (
        jacobi_minv as host_minv)

    minv = torch.zeros(m.R, dtype=torch.float32)
    minv[: m.N] = torch.tensor(m.to_exec_order(host_minv(m, "jacobi")))
    return minv.to(device)


def varied_dia_matrix(mode, n=4096, blocks=2, fmt="csr"):
    """dia_matrix with its diagonal scaled row by row by up to 10x: a
    Jacobi M^-1 that is not a multiple of I, so that a Jacobi instance
    that ignored or misindexed it would leave the plain loop."""
    rows, cols, vals, n = spd_tridiagonal(n)
    diag = rows == cols
    vals = vals.copy()
    vals[diag] *= 1.0 + 9.0 * np.random.default_rng(2).random(diag.sum())
    return build_protected(fmt, assemble(cols, rows, vals, n, blocks),
                           mode)


def fused_matrix(layout, mode, fmt="csr"):
    if layout == "dia":
        return varied_dia_matrix(mode, fmt=fmt)
    if layout == "ell":
        return ell_matrix(mode, fmt=fmt)
    return split_matrix(mode, "dia", fmt)


@pytest.mark.parametrize("layout,schedule", [
    ("dia", "fold"), ("dia", "three-sync"), ("dia", "window"), ("ell", None),
    ("split", None)])
@pytest.mark.parametrize("variant", ["lazy", "Jacobi", "lazy Jacobi"])
@pytest.mark.parametrize("mode,flips,seed", [
    ("secded", 0, 0), ("secded", 1, 6), ("sed", 1, 6)])
def test_fused_instances_match_plain(dev, layout, variant, mode, flips,
                                     seed, schedule):
    """The lazy (CI 4) and Jacobi instances of kernels B and D (and of
    the split tail) against their plain loops: iterations and events
    equal, the trace to 1e-5 (1e-4 with Jacobi, whose rz = r . z is one
    more reduction summed in another order than torch.sum; 1e-3 above
    float32's noise floor for the split tail); a clean lazy solve's x
    equals the live instance's bit for bit, and a rolled-back faulted
    one equals the clean one.  Kernel B's tail-free instances run under
    each schedule."""
    m = fused_matrix(layout, mode)
    precond = "Jacobi" in variant
    ci = 4 if "lazy" in variant else 1
    b = torch.zeros(m.R, dtype=torch.float32)
    b[: m.N] = torch.tensor(np.random.default_rng(7).random(m.N))
    mf = faulted(m, flips, seed) if flips else m
    args = (jacobi_minv(m, dev),) if precond else ()
    cpu_args = (jacobi_minv(m, CPU),) if precond else ()
    solve = make_fused_solver(mf, mode, 300, 1e-8, precond=precond,
                              check_interval=ci, schedule=schedule)
    kernel = fused_cg_ell if layout == "ell" else fused_cg_dia
    name = ("split tail " if layout == "split" else "") + variant
    before = kernel.instances.get(name, 0)
    rk = solve(make_matrix_device(mf, torch.float32, dev), b.to(dev), *args)
    assert kernel.instances.get(name, 0) > before
    rp = solve(make_matrix_device(mf, torch.float32, CPU), b, *cpu_args)
    assert rk.iterations == rp.iterations
    assert tuple(rk.stats) == tuple(rp.stats)
    it = rk.iterations
    t0 = rp.rr_trace[:it].numpy()
    above, tol = np.ones(it, bool), 1e-4 if precond else 1e-5
    if layout == "split":
        above, tol = t0 > (t0[0] * 1e-5 if it else 0), 1e-3
    np.testing.assert_allclose(rk.rr_trace[:it].cpu().numpy()[above],
                               t0[above], rtol=tol)
    if mode == "secded":
        live = make_fused_solver(m, mode, 300, 1e-8, precond=precond,
                                 schedule=schedule)(
            make_matrix_device(m, torch.float32, dev), b.to(dev), *args)
        assert torch.equal(rk.x, live.x)
    if precond and not flips:
        # These diagonals vary: the unpreconditioned solve leaves the
        # Jacobi one far past the tolerance above, so the comparison can
        # tell a kernel that ignored M^-1 from one that applied it.
        un = make_fused_solver(m, mode, 300, 1e-8, check_interval=ci)(
            make_matrix_device(m, torch.float32, CPU), b)
        assert not same_trajectory(un, rp, 1e-2)


def same_trajectory(r1, r2, rtol):
    """Equal iteration counts and rr traces within ``rtol``."""
    it = r1.iterations
    return it == r2.iterations and np.allclose(
        r1.rr_trace[:it].cpu().numpy(), r2.rr_trace[:it].cpu().numpy(),
        rtol=rtol, atol=0)


@pytest.mark.parametrize("shape", ["dia", "ell", "flat"])
def test_detection_free_product_matches_plain(dev, shape):
    """Kernels A, C and E under product_spec: no signal plane, the gather
    masking of the mode kept; w bit-exact (A: to 1e-6) against the plain
    version, a constant-False trigger even on a faulted matrix."""
    from abft_sparse_cg_tpu_torch.ops.spmv_cuda import (
        flat_fast,
        make_cuda_product,
    )

    m = {"dia": lambda: dia_matrix("secded"),
         "ell": lambda: ell_matrix("secded", "permuted"),
         "flat": lambda: flat_matrix("secded", "powerlaw")}[shape]()
    kernel = {"dia": dia_fast, "ell": ell_fast, "flat": flat_fast}[shape]
    prod = make_cuda_product(m)
    x = torch.tensor(np.random.default_rng(5).random(m.R),
                     dtype=torch.float32)
    for mm in (m, faulted(m, 1, 31)):
        before = kernel.product_launches
        wk, tk, pk = prod.fast_pw(make_matrix_device(mm, torch.float32, dev),
                                  x.to(dev))
        assert kernel.product_launches == before + 1
        wp, tp, pp = prod.fast_pw(make_matrix_device(mm, torch.float32, CPU),
                                  x)
        tol = 1e-6 if shape == "dia" else 0
        torch.testing.assert_close(wk.cpu(), wp, rtol=tol, atol=0,
                                   equal_nan=True)
        torch.testing.assert_close(pk.cpu(), pp, rtol=1e-5, atol=0,
                                   equal_nan=True)
        assert not bool(tk) and not bool(tp)


@pytest.mark.parametrize("shape", ["flat", "band-split"])
def test_per_iteration_lazy(dev, shape):
    """The per-iteration tier's lazy loop on the card: a clean solve's x
    equals the live one's, a faulted one is corrected through a rollback
    to the same x."""
    from abft_sparse_cg_tpu_torch.backends.cuda_backend import CudaBackend
    from abft_sparse_cg_tpu_torch.utils.matzoo import band_plus_random

    if shape == "flat":
        m = flat_matrix("secded", "powerlaw")
    else:
        rows, cols, vals, n = band_plus_random(n=16384)
        m = build_protected("csr", assemble(cols, rows, vals, n, 1),
                            "secded")
    b = np.random.default_rng(1).random(m.N)
    be = CudaBackend("secded")
    live = be.solve(m, b, 500, 1e-8, reps=1)
    lazy = be.solve(m, b, 500, 1e-8, reps=1, check_interval=4)
    assert lazy.iterations == live.iterations
    np.testing.assert_array_equal(lazy.x, live.x)
    fixed = be.solve(faulted(m, 1, 6), b, 500, 1e-8, reps=1,
                     check_interval=4)
    assert fixed.corrected_count == 1 and not fixed.failed
    np.testing.assert_array_equal(fixed.x, live.x)


# ---- the row-sharded kernel tier (parallel/) --------------------------------

def sharded_matrix(mode, layout, n=4, fmt="csr"):
    """A DIA or banded-ELL matrix (dense-radius-3d, band 221) of R a
    multiple of 1024 * n rows, in the kernel tier's envelope."""
    from abft_sparse_cg_tpu_torch.parallel.sharded_kernel import (
        supports_shardmap,
    )

    if layout == "dia":
        m = dia_matrix(mode, n=8192, blocks=2, fmt=fmt)
    else:
        rows, cols, vals, N = dense_radius_3d(side=16)
        m = build_protected(fmt, assemble(cols, rows, vals, N, 2), mode,
                            row_align=1024 * n)
    assert m.exec_kind == layout and supports_shardmap(m, torch.float32, n)
    return m


def halo_fault(m, n, seed=0, word="col"):
    """``m`` with a 1-bit flip in the last row of shard 1 (the first halo
    row of shard 2), in the col word every detecting mode covers (or
    ``word``: the row word, which constraints mode on COO128 scans as
    its second plane)."""
    row = 2 * (m.R // n) - 1
    slot = np.flatnonzero(m.ell_slot % m.R == row)[seed]
    planes = {k: v.copy() for k, v in m.planes.items()}
    planes[word][slot] ^= np.uint32(1 << 2)
    return m.with_planes(planes)


@pytest.mark.parametrize("layout", ["dia", "ell"])
@pytest.mark.parametrize("mode", MODES)
def test_halo_kernels_match_plain_and_single_device(dev, mode, layout):
    """Kernels A's and C's halo forms on 4 shards of one card: w bit-exact
    to their plain versions and, concatenated, to the single-device
    kernel's w; the trigger equal, on the faulted row's shard only; pw to
    1e-5.  Clean and with a fault in a halo row."""
    from abft_sparse_cg_tpu_torch.ops.spmv_cuda import (
        dia_fast_halo,
        ell_fast_halo,
    )
    from abft_sparse_cg_tpu_torch.parallel.sharded import (
        default_mesh,
        shard_rows,
    )
    from abft_sparse_cg_tpu_torch.parallel.sharded_kernel import (
        _halo,
        halo_exchange,
    )
    from abft_sparse_cg_tpu_torch.parallel.vector import ShardedVector

    n = 4
    m0 = sharded_matrix(mode, layout, n)
    R_loc, H = m0.R // n, _halo(m0)
    spec = (dia_spec if layout == "dia" else ell_spec)(m0, mode)
    single = dia_fast if layout == "dia" else ell_fast
    halo_fn = dia_fast_halo if layout == "dia" else ell_fast_halo
    mesh = default_mesh(n, dev)
    x = torch.tensor(np.random.default_rng(5).standard_normal(m0.R),
                     dtype=torch.float32, device=dev)
    for m in (m0, halo_fault(m0, n)) if mode != "none" else (m0,):
        md = make_matrix_device(m, torch.float32, dev)
        shards = shard_rows(md, mesh)
        ext = halo_exchange(ShardedVector.scatter(x, mesh.devices), H)
        before = halo_fn.launches
        outs = []
        for s in range(n):
            args = (H,) if layout == "dia" else (H, s * R_loc)
            wk, tk, pk = halo_fn(shards[s], ext[s], spec, *args)
            cpu = shard_rows(make_matrix_device(m, torch.float32, CPU),
                             default_mesh(n, CPU))[s]
            wp, tp, pp = halo_fn(cpu, ext[s].cpu(), spec, *args)
            assert same_bits(wk.cpu(), wp), s
            assert bool(tk) == bool(tp), s
            torch.testing.assert_close(pk.cpu(), pp, rtol=1e-5, atol=0)
            assert not bool(tk) or s == 1
            outs.append(wk)
        assert halo_fn.launches == before + n
        w1, t1, _ = single(md, x, spec)
        assert same_bits(torch.cat(outs), w1)


def halo_shard_calls(m, dev, n=4):
    """Kernel C's halo form on the ``n`` shards of ``m`` as a sharded solve
    resolves it (one ``ell_launcher`` per shard), each with its shard's
    x_ext: ([call], [x_ext])."""
    from abft_sparse_cg_tpu_torch.ops.spmv_cuda import ell_launcher
    from abft_sparse_cg_tpu_torch.parallel.sharded import (
        default_mesh,
        shard_rows,
    )
    from abft_sparse_cg_tpu_torch.parallel.sharded_kernel import (
        _halo,
        halo_exchange,
    )
    from abft_sparse_cg_tpu_torch.parallel.vector import ShardedVector

    R_loc, H = m.R // n, _halo(m)
    mesh = default_mesh(n, dev)
    x = torch.tensor(np.random.default_rng(5).standard_normal(m.R),
                     dtype=torch.float32, device=dev)
    shards = shard_rows(make_matrix_device(m, torch.float32, dev), mesh)
    calls = [ell_launcher(md, ell_spec(m, "secded"), dev, H, s * R_loc)
             for s, md in enumerate(shards)]
    return calls, halo_exchange(ShardedVector.scatter(x, mesh.devices), H)


def halo_shard_profile(rounds=5):
    """The device operations (names) the profiler lists for ``rounds``
    rounds of the 4 shards' halo calls, after a warm-up round."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    calls, ext = halo_shard_calls(sharded_matrix("secded", "ell", 4),
                                  torch.device("cuda", 0))
    for c, e in zip(calls, ext):
        c(e)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(rounds):
            for c, e in zip(calls, ext):
                c(e)
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == DeviceType.CUDA]


def test_kernel_c_halo_repeatable_on_every_shard(dev, monkeypatch):
    """Kernel C's halo form through the launchers a sharded solve resolves
    once per shard, one device operation per call: 5 rounds of the 4
    shards' calls are 20 device operations, all kernel C, in the
    profiler's list of a fresh process (a long one, as this test
    process, loses profiler events: it listed 18-19 of 20 on the card),
    and here each of those 20 calls writes its own outputs (handed to it
    filled with NaN and a set trigger).  100 more rounds back to back
    give identical w, pw and trigger, clean and with a halo-row fault
    (which fires on shard 1 only)."""
    from abft_sparse_cg_tpu_torch.ops import spmv_cuda

    tests = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(tests)
    run = subprocess.run(
        [sys.executable, "-c", "import json, test_torch_cuda as t; "
         "print(json.dumps(t.halo_shard_profile()))"],
        cwd=root, capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": os.pathsep.join((root, tests))})
    assert run.returncode == 0, run.stderr[-3000:]
    ops = json.loads(run.stdout.strip().splitlines()[-1])
    assert len(ops) == 20, ops
    assert all("ell_spmv_detect_kernel" in o for o in ops), ops

    plain = spmv_cuda._call_outputs

    def poisoned(x, rows=None):
        w, t, p = plain(x, rows)
        w.fill_(float("nan"))
        t.fill_(True)
        p.fill_(float("nan"))
        return w, t, p

    n = 4
    m0 = sharded_matrix("secded", "ell", n)
    for m in (m0, halo_fault(m0, n)):
        calls, ext = halo_shard_calls(m, dev, n)
        first = [c(e) for c, e in zip(calls, ext)]
        torch.cuda.synchronize()
        with monkeypatch.context() as mp:
            mp.setattr(spmv_cuda, "_call_outputs", poisoned)
            outs = [[c(e) for c, e in zip(calls, ext)] for _ in range(5)]
        outs += [[c(e) for c, e in zip(calls, ext)] for _ in range(100)]
        torch.cuda.synchronize()
        for rnd in outs:
            for (w, t, p), (w0, t0, p0) in zip(rnd, first):
                assert same_bits(w, w0) and bool(t) == bool(t0)
                assert same_bits(p.view(1), p0.view(1))
        assert [bool(t) for _, t, _ in first] == (
            [False] * n if m is m0 else [False, True, False, False])


@pytest.mark.parametrize("layout", ["dia", "ell"])
def test_sharded_back_to_back_repeat(dev, layout):
    """All shard launches go on one stream, one after another: a sharded
    SpMV repeated 100 times back to back gives the same w, trigger and pw
    every time (kernel A's block counter, one per library, resets)."""
    from abft_sparse_cg_tpu_torch.parallel.sharded import (
        _device_put_sharded,
        default_mesh,
    )
    from abft_sparse_cg_tpu_torch.parallel.sharded_kernel import (
        make_shardmap_spmv,
    )

    m = sharded_matrix("secded", layout)
    mesh = default_mesh(4, dev)
    b = np.random.default_rng(7).random(m.N)
    md, x, _ = _device_put_sharded(m, b, mesh, torch.float32)
    impl = make_shardmap_spmv(m, mesh)
    w0, t0, p0 = impl.fast_pw(md, x)
    torch.cuda.synchronize()
    outs = [impl.fast_pw(md, x) for _ in range(100)]
    torch.cuda.synchronize()
    for w, t, p in outs:
        assert same_bits(w.cpu(), w0.cpu())
        assert bool(t) == bool(t0) == False  # noqa: E712
        assert same_bits(p.view(1), p0.view(1))


@pytest.mark.parametrize("layout", ["dia", "ell"])
def test_sharded_solve_on_one_card(dev, layout):
    """solve_sharded on a 4-shard mesh of one card: the single-device
    cuda solve's iterations, x within 2e-5; a fault in a halo row is
    corrected once and the result equals the clean solve; a clean lazy
    (CI 4) solve equals the live one bit for bit."""
    from abft_sparse_cg_tpu_torch.backends.cuda_backend import CudaBackend
    from abft_sparse_cg_tpu_torch.parallel.sharded import (
        _device_put_sharded,
        default_mesh,
        make_sharded_solver,
        solve_sharded,
    )

    m = sharded_matrix("secded", layout)
    mesh = default_mesh(4, dev)
    b = np.random.default_rng(7).random(m.N)
    ref = CudaBackend("secded").solve(m, b, 300, 1e-5, dtype="f32", reps=1)
    live = solve_sharded(m, b, 300, 1e-5, mesh=mesh)
    assert live.stats.errcode == 0 and live.iterations == ref.iterations
    np.testing.assert_allclose(live.x.cpu().numpy()[: m.N],
                               m.to_exec_order(ref.x), rtol=2e-5, atol=1e-7)
    fixed = solve_sharded(halo_fault(m, 4), b, 300, 1e-5, mesh=mesh)
    assert fixed.stats.corrected_count == 1
    assert torch.equal(fixed.x, live.x)
    md, bdev, _ = _device_put_sharded(m, b, mesh, torch.float32)
    lazy = make_sharded_solver(m, mesh, 300, 1e-5, torch.float32,
                               check_interval=4)(md, bdev)
    assert torch.equal(lazy.x, live.x)


LAUNCH_LAYOUT = {"A": "dia", "A halo": "dia", "B": "dia", "C": "ell",
                 "C halo": "ell", "D": "ell", "E": "flat"}


def launch_on(kernel, tdev):
    """One call of ``kernel``'s wrapper (kernels A, C and E and the halo
    forms of A and C) or one solve of kernel B or D, every operand on
    ``tdev``."""
    from abft_sparse_cg_tpu_torch.ops.spmv_cuda import (
        dia_fast_halo,
        ell_fast_halo,
        flat_fast,
        flat_spec,
    )
    from abft_sparse_cg_tpu_torch.parallel.sharded import (
        default_mesh,
        shard_rows,
    )
    from abft_sparse_cg_tpu_torch.parallel.sharded_kernel import _halo

    f32 = torch.float32
    layout = LAUNCH_LAYOUT[kernel]
    if kernel.endswith("halo"):
        m = sharded_matrix("secded", layout)
        H, R_loc = _halo(m), m.R // 4
        md = shard_rows(make_matrix_device(m, f32, tdev),
                        default_mesh(4, tdev))[1]
        ext = torch.rand(R_loc + 2 * H, device=tdev)
        if layout == "dia":
            return dia_fast_halo(md, ext, dia_spec(m, "secded"), H)
        return ell_fast_halo(md, ext, ell_spec(m, "secded"), H, R_loc)
    m = {"dia": dia_matrix, "ell": ell_matrix,
         "flat": lambda mode: flat_matrix(mode, "powerlaw")}[layout]("secded")
    md = make_matrix_device(m, f32, tdev)
    if kernel in ("B", "D"):
        b = torch.zeros(m.R, dtype=f32)
        b[: m.N] = torch.tensor(np.random.default_rng(7).random(m.N))
        return make_fused_solver(m, "secded", 50, 1e-8)(md, b.to(tdev))
    fn, spec = {"A": (dia_fast, dia_spec), "C": (ell_fast, ell_spec),
                "E": (flat_fast, flat_spec)}[kernel]
    return fn(md, torch.rand(m.R, device=tdev), spec(m, "secded"))


@pytest.mark.parametrize("kernel", list(LAUNCH_LAYOUT))
def test_launch_keeps_the_current_device(dev, kernel):
    """Every C entry point restores the caller's device: with the first
    card current, a launch on the last card (on a one-card host, the
    same card) leaves the first card current, so a later
    ``torch.cuda.current_stream()`` without an argument stays on it."""
    tdev = torch.device("cuda", torch.cuda.device_count() - 1)
    with torch.cuda.device(dev):
        launch_on(kernel, tdev)
        torch.cuda.synchronize(tdev)
        assert torch.cuda.current_device() == dev.index
        assert torch.cuda.current_stream().device == dev


@pytest.mark.skipif(torch.cuda.device_count() < 2,
                    reason="needs 2 CUDA cards, found "
                           f"{torch.cuda.device_count()}")
@pytest.mark.parametrize("flips", [0, 1], ids=["clean", "fault"])
def test_two_cards_equal_two_shards_of_one(dev, flips):
    """DIA -b 10 secded at --devices 2 (one shard per card, edges copied
    between the cards) against the 2-shard mesh of one card: the same
    iterations, corrections and x, bit for bit."""
    from abft_sparse_cg_tpu_torch.backends.cuda_backend import CudaBackend
    from abft_sparse_cg_tpu_torch.parallel.sharded import (
        default_mesh,
        solve_sharded,
    )

    rows, cols, vals, n = spd_tridiagonal(81920)
    m = build_protected("csr", assemble(cols, rows, vals, n, 10), "secded")
    assert m.exec_kind == "dia" and m.R % 2048 == 0
    if flips:
        m = faulted(m, flips, 1)
    b = np.random.default_rng(11).random(m.N)
    two = CudaBackend("secded").solve(m, b, 1000, 1e-3, dtype="f32",
                                      reps=1, devices=2)
    one = solve_sharded(m, b, 1000, 1e-3, mesh=default_mesh(2, dev))
    assert not two.failed and one.stats.errcode == 0
    assert two.iterations == one.iterations
    assert two.corrected_count == one.stats.corrected_count == flips
    np.testing.assert_array_equal(
        two.x, m.from_exec_order(one.x.cpu().numpy()[: m.N]))


# --------------------------------------------------------------------------
# cg-coo: COO128 codewords, the two-plane instances of constraints mode
# --------------------------------------------------------------------------

def coo_kernel_matrix(kernel, mode):
    """A COO128 build of the shape each kernel's card test uses: kernel A
    the tridiagonal, C dense-radius-3d, E powerlaw-graph (flat)."""
    if kernel == "A":
        return dia_matrix(mode, fmt="coo")
    if kernel == "C":
        return ell_matrix(mode, fmt="coo")
    return flat_matrix(mode, "powerlaw", fmt="coo")


def coo_faults(m, mode):
    """Clean, a random 1-bit fault (ECC modes) or INDEX flip, a row-word
    flip and, in none and constraints, the 4-bit col/row fault (its
    rotated fold is zero)."""
    from abft_sparse_cg_tpu_torch.utils.coo_faults import (
        col_row_fault,
        row_word_flip,
    )

    out = [("clean", m), ("row word", row_word_flip(m, m.nnz // 3 + 1))]
    if mode in ("none", "constraints"):
        out += [("index", faulted(m, 1, 33, "INDEX")),
                ("4bit col/row", col_row_fault(m, m.nnz // 3))]
    else:
        out += [("1bit", faulted(m, 1, 31)), ("2bit", faulted(m, 2, 32))]
    return out


def coo_kernel(kernel):
    from abft_sparse_cg_tpu_torch.ops.spmv_cuda import (
        flat_fast,
        flat_fast_plain,
        flat_spec,
    )

    return {"A": (dia_fast, dia_fast_plain, dia_spec),
            "C": (ell_fast, ell_fast_plain, ell_spec),
            "E": (flat_fast, flat_fast_plain, flat_spec)}[kernel]


@pytest.mark.parametrize("kernel", ["A", "C", "E"])
@pytest.mark.parametrize("mode", MODES)
def test_coo_kernels_match_plain(dev, mode, kernel):
    """Kernels A, C and E on COO128 planes against their plain versions:
    w bit-exact, pw to 1e-5, the trigger equal; constraints mode runs the
    two-plane instance (one launch each, counted as two-plane) and fires
    on the row-word flip and the 4-bit col/row fault."""
    fast, plain, spec_of = coo_kernel(kernel)
    m0 = coo_kernel_matrix(kernel, mode)
    spec = spec_of(m0, mode)
    assert (spec.plane2 is not None) == (mode == "constraints")
    x = torch.tensor(np.random.default_rng(5).random(m0.R),
                     dtype=torch.float32, device=dev)
    for label, m in coo_faults(m0, mode):
        md = make_matrix_device(m, torch.float32, dev)
        before = (fast.launches, fast.two_plane_launches)
        wk, tk, pk = fast(md, x, spec)
        assert (fast.launches, fast.two_plane_launches) == (
            before[0] + 1, before[1] + (mode == "constraints"))
        wp, tp, pp = plain(md, x, spec)
        assert same_bits(wk, wp), label
        torch.testing.assert_close(pk, pp, rtol=1e-5, atol=0,
                                   equal_nan=True)
        assert bool(tk) == bool(tp), label
        if mode == "constraints" and label != "clean":
            assert bool(tk), label


@pytest.mark.parametrize("kernel", ["A", "C", "E"])
def test_coo_row_word_fault_seen_by_the_second_plane_only(dev, kernel):
    """Constraints mode on COO128, a flip in one element's row word: the
    two-plane kernel fires, and the same kernel scanning the col word
    alone (the spec without its second plane: the one-plane instance)
    does not; on the clean matrix neither does."""
    from abft_sparse_cg_tpu_torch.utils.coo_faults import row_word_flip

    fast, _, spec_of = coo_kernel(kernel)
    m0 = coo_kernel_matrix(kernel, "constraints")
    spec = spec_of(m0, "constraints")
    one = spec._replace(plane2=None)
    x = torch.rand(m0.R, device=dev)
    for m, want in ((m0, False), (row_word_flip(m0, m0.nnz // 2), True)):
        md = make_matrix_device(m, torch.float32, dev)
        assert bool(fast(md, x, spec)[1]) == want
        assert not bool(fast(md, x, one)[1])


@pytest.mark.parametrize("layout", ["dia", "ell"])
@pytest.mark.parametrize("mode", MODES)
def test_coo_halo_kernels_match_plain(dev, mode, layout):
    """The halo forms of kernels A and C on 4 shards of a COO128 build:
    w bit-exact to the plain versions and, concatenated, to the
    single-device kernel's; with a row-word flip in a halo row, the
    trigger on that row's shard only (constraints: the second plane)."""
    from abft_sparse_cg_tpu_torch.ops.spmv_cuda import (
        dia_fast_halo,
        ell_fast_halo,
    )
    from abft_sparse_cg_tpu_torch.parallel.sharded import (
        default_mesh,
        shard_rows,
    )
    from abft_sparse_cg_tpu_torch.parallel.sharded_kernel import (
        _halo,
        halo_exchange,
    )
    from abft_sparse_cg_tpu_torch.parallel.vector import ShardedVector

    n = 4
    m0 = sharded_matrix(mode, layout, n, fmt="coo")
    R_loc, H = m0.R // n, _halo(m0)
    spec = (dia_spec if layout == "dia" else ell_spec)(m0, mode)
    single = dia_fast if layout == "dia" else ell_fast
    halo_fn = dia_fast_halo if layout == "dia" else ell_fast_halo
    mesh = default_mesh(n, dev)
    x = torch.tensor(np.random.default_rng(5).standard_normal(m0.R),
                     dtype=torch.float32, device=dev)
    faults = [] if mode == "none" else [halo_fault(m0, n, word="row")]
    for k, m in enumerate([m0, *faults]):
        md = make_matrix_device(m, torch.float32, dev)
        shards = shard_rows(md, mesh)
        ext = halo_exchange(ShardedVector.scatter(x, mesh.devices), H)
        outs, fired = [], []
        for s in range(n):
            args = (H,) if layout == "dia" else (H, s * R_loc)
            wk, tk, pk = halo_fn(shards[s], ext[s], spec, *args)
            wp, tp, pp = (dia_fast_plain if layout == "dia" else
                          ell_fast_plain)(shards[s], ext[s], spec, *args)
            assert same_bits(wk, wp), s
            assert bool(tk) == bool(tp), s
            torch.testing.assert_close(pk, pp, rtol=1e-5, atol=0)
            outs.append(wk)
            fired.append(bool(tk))
        assert fired == ([False, True, False, False] if k else [False] * n)
        w1, _, _ = single(md, x, spec)
        assert same_bits(torch.cat(outs), w1)


@pytest.mark.parametrize("layout", ["dia", "ell", "split"])
@pytest.mark.parametrize("variant", ["live", "lazy", "Jacobi"])
@pytest.mark.parametrize("mode", ["constraints", "secded"])
def test_coo_fused_match_plain(dev, layout, variant, mode):
    """Kernels B and D (and B's split tail) on COO128 against their plain
    loops: iterations and events equal, the trace to 1e-5 (1e-4 with
    Jacobi, 1e-3 above float32's noise floor for the split tail);
    constraints mode launches the two-plane instance; a clean lazy x
    equals the live one bit for bit; a corrected 1-bit fault (secded) or
    a row-word flip (constraints) gives the plain loop's events."""
    from abft_sparse_cg_tpu_torch.utils.coo_faults import row_word_flip

    m = fused_matrix(layout, mode, fmt="coo")
    precond, ci = variant == "Jacobi", 4 if variant == "lazy" else 1
    b = torch.zeros(m.R, dtype=torch.float32)
    b[: m.N] = torch.tensor(np.random.default_rng(7).random(m.N))
    args = (jacobi_minv(m, dev),) if precond else ()
    cpu_args = (jacobi_minv(m, CPU),) if precond else ()
    kernel = fused_cg_ell if layout == "ell" else fused_cg_dia
    name = " ".join(["split tail"] * (layout == "split")
                    + ["lazy"] * (ci > 1) + ["Jacobi"] * precond) or "live"
    name += " two-plane" * (mode == "constraints")
    fault = (faulted(m, 1, 6) if mode == "secded"
             else row_word_flip(m, m.nnz // 3 + 1))
    results = {}
    for label, mm in (("clean", m), ("fault", fault)):
        solve = make_fused_solver(mm, mode, 300, 1e-8, precond=precond,
                                  check_interval=ci)
        before = kernel.instances.get(name, 0)
        rk = solve(make_matrix_device(mm, torch.float32, dev), b.to(dev),
                   *args)
        assert kernel.instances.get(name, 0) > before, name
        rp = solve(make_matrix_device(mm, torch.float32, CPU), b, *cpu_args)
        assert rk.iterations == rp.iterations, label
        assert tuple(rk.stats) == tuple(rp.stats), label
        it = rk.iterations
        t0 = rp.rr_trace[:it].numpy()
        above, tol = np.ones(it, bool), 1e-4 if precond else 1e-5
        if layout == "split":
            above, tol = t0 > (t0[0] * 1e-5 if it else 0), 1e-3
        np.testing.assert_allclose(rk.rr_trace[:it].cpu().numpy()[above],
                                   t0[above], rtol=tol)
        results[label] = rk
    if ci > 1:
        live = make_fused_solver(m, mode, 300, 1e-8)(
            make_matrix_device(m, torch.float32, dev), b.to(dev))
        assert torch.equal(results["clean"].x, live.x)
    if mode == "secded":
        assert results["fault"].stats.corrected_count == 1


def test_csr_constraints_keeps_one_plane(dev):
    """CSR96 constraints mode scans the col word alone: its specs have no
    second plane, and kernels A and B launch their one-plane instances
    (no two-plane launch counted), matching their plain versions."""
    m = dia_matrix("constraints")
    spec = dia_spec(m, "constraints")
    assert spec.plane2 is None and spec.plane == m.layout.col_word
    x = torch.tensor(np.random.default_rng(5).random(m.R),
                     dtype=torch.float32, device=dev)
    before = dia_fast.two_plane_launches
    for mm in (m, faulted(m, 1, 33, "INDEX")):
        md = make_matrix_device(mm, torch.float32, dev)
        wk, tk, pk = dia_fast(md, x, spec)
        wp, tp, pp = dia_fast_plain(md, x, spec)
        assert same_bits(wk, wp) and bool(tk) == bool(tp)
    assert dia_fast.two_plane_launches == before
    b = torch.zeros(m.R, dtype=torch.float32)
    b[: m.N] = torch.tensor(np.random.default_rng(7).random(m.N))
    names = dict(fused_cg_dia.instances)
    r = make_fused_solver(m, "constraints", 300, 1e-8)(
        make_matrix_device(m, torch.float32, dev), b.to(dev))
    assert r.stats.errcode == 0
    assert fused_cg_dia.instances.get("live", 0) > names.get("live", 0)
    assert not any(k.endswith("two-plane") and v != names.get(k, 0)
                   for k, v in fused_cg_dia.instances.items())


# --------------------------------------------------------------------------
# The segmented solve (--checkpoint) on kernels B and D, the pipelined
# solver over kernels A, C and E
# --------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["dia", "ell", "split"])
@pytest.mark.parametrize("ci", [1, 4], ids=["live", "lazy"])
@pytest.mark.parametrize("flips", [0, 1], ids=["clean", "fault"])
def test_checkpointed_fused_continue_matches_straight(dev, tmp_path, layout,
                                                      ci, flips):
    """make_fused_continue under CheckpointedSolve in segments of 3
    iterations, one launch of kernel B or D per segment (and one more per
    repair), each from the state the last one left: the straight solve's
    iterations, events and x bit for bit, live and lazy alike (the
    checked iterations are the same, itr % CI == CI - 1, and a launch
    boundary changes no reduction order); a fault is corrected once."""
    from abft_sparse_cg_tpu_torch.solver.checkpoint import CheckpointedSolve
    from abft_sparse_cg_tpu_torch.solver.fused import make_fused_continue

    m = fused_matrix(layout, "secded")
    mf = faulted(m, 1, 6) if flips else m
    b = torch.zeros(m.R, dtype=torch.float32)
    b[: m.N] = torch.tensor(np.random.default_rng(7).random(m.N))
    b = b.to(dev)
    md = make_matrix_device(mf, torch.float32, dev)
    straight = make_fused_solver(mf, "secded", 300, 1e-8,
                                 check_interval=ci)(md, b)
    kernel = fused_cg_ell if layout == "ell" else fused_cg_dia
    before = kernel.launches
    seg = CheckpointedSolve(
        None, 1e-8, every=3, path=str(tmp_path / "ck.npz"),
        continue_fn=make_fused_continue(mf, "secded", 1e-8,
                                        check_interval=ci)).run(
        make_matrix_device(mf, torch.float32, dev), b, 300)
    segments = -(-seg.iterations // 3)
    assert kernel.launches - before >= segments
    assert seg.iterations == straight.iterations
    assert tuple(seg.stats) == tuple(straight.stats)
    assert seg.stats.corrected_count == flips
    assert torch.equal(seg.x, straight.x)
    it = seg.iterations
    assert torch.equal(seg.rr_trace[:it], straight.rr_trace[:it])


@pytest.mark.parametrize("shape", ["dia", "ell", "flat"])
@pytest.mark.parametrize("flips", [0, 1], ids=["clean", "fault"])
def test_pipelined_on_the_kernels_matches_plain(dev, shape, flips):
    """The pipelined solver over make_cuda_spmv (kernels A, C, E, one
    launch per iteration and per restart) against itself over make_spmv,
    the plain SpmvImpl, on the card: the kernels' w is their plain
    versions' bit for bit and every other operation is the same torch
    call, so iterations, events, the trace and x are equal bit for bit;
    a fault is repaired once and the recurrences restart."""
    from abft_sparse_cg_tpu_torch.ops.spmv import make_spmv
    from abft_sparse_cg_tpu_torch.ops.spmv_cuda import (
        flat_fast,
        make_cuda_spmv,
    )
    from abft_sparse_cg_tpu_torch.solver.pipelined import (
        make_pipelined_solver,
    )

    m = {"dia": lambda: dia_matrix("secded"),
         "ell": lambda: ell_matrix("secded"),
         "flat": lambda: flat_matrix("secded", "stencil27")}[shape]()
    m = faulted(m, 1, 6) if flips else m
    b = torch.zeros(m.R, dtype=torch.float32)
    b[: m.N] = torch.tensor(np.random.default_rng(7).random(m.N))
    b = b.to(dev)
    kernel = {"dia": dia_fast, "ell": ell_fast, "flat": flat_fast}[shape]
    before = kernel.launches
    rk = make_pipelined_solver(make_cuda_spmv(m, torch.float32), 300, 1e-8)(
        make_matrix_device(m, torch.float32, dev), b)
    assert kernel.launches - before >= rk.iterations + 1
    rp = make_pipelined_solver(make_spmv(m, torch.float32), 300, 1e-8)(
        make_matrix_device(m, torch.float32, dev), b)
    assert rk.iterations == rp.iterations and rk.stats == rp.stats
    assert rk.stats.errcode == 0 and rk.stats.corrected_count == flips
    it = rk.iterations
    assert same_bits(rk.rr_trace[:it], rp.rr_trace[:it])
    assert same_bits(rk.x, rp.x)


@pytest.mark.parametrize("ci", [1, 4])
def test_kernel_b_solve_spans_and_host_reads(dev, ci):
    """One clean kernel-B solve, live and lazy (CI 4): the launch's spans
    once per launch, the state clones under ``fused.args`` once per
    solve beside the launch's arguments, and two blocking host reads (the
    launch's outputs; live, the repair check's baseline compare, lazy,
    the snapshot's iteration)."""
    from abft_sparse_cg_tpu_torch import tracing

    m = dia_matrix("secded")
    b = torch.zeros(m.R, dtype=torch.float32)
    b[: m.N] = torch.tensor(np.random.default_rng(7).random(m.N))
    md = make_matrix_device(m, torch.float32, dev)
    solve = make_fused_solver(m, "secded", 300, 1e-8, check_interval=ci)
    solve(md, b.to(dev))            # builds and loads the kernel
    torch.cuda.synchronize()
    tracing.reset()
    before = fused_cg_dia.launches
    res = solve(md, b.to(dev))
    launches = fused_cg_dia.launches - before
    snap = tracing.snapshot()
    tracing.reset()
    t = {name: e["count"] for (name, prof), e in snap.items() if not prof}
    assert res.stats.errcode == 0 and launches == 1
    assert t["solver.solve"] == t["solver.init"] == 1
    for name in ("fused.launch", "fused.read", "fused.merge"):
        assert t[name] == launches, name
    assert t["fused.args"] == launches + 1
    assert t["solver.guard" if ci == 1 else "solver.resolve"] == 1
    assert t["solver.host_reads"] == 2
    assert "solver.classify" not in t
