"""The lazy ``--check-interval`` schedule of the port against the JAX
package.

Whole-solve tier: ``solver.fused.make_fused_solver(check_interval=CI)``
(kernels B's and D's lazy plain loops on CPU tensors, float32) against
the Pallas megakernel's lazy branch in interpret mode, on the 1024-row
tridiagonal of tests/test_fused.py (DIA, and forced to ELL) and its
bordered split (a 2048-row core with two dense rows: DIA main, dense-
plan tail).  Per-iteration tier: ``solver.cg.make_lazy_ci_solver`` over
``make_cuda_spmv`` and ``make_cuda_product`` (their plain versions on
CPU tensors) against ``make_lazy_ci_solver`` over the Pallas kernels in
interpret mode, the cases of tests/test_lazy_periter.py.  Iterations,
errcode and corrections must be equal; x agrees to rtol 1e-4 / atol
1e-5 and the trace to rtol 1e-4 (float32 reductions summed in another
order than the TPU kernels'; a split tail's trace to 1e-3 above the
noise floor, tests/test_fused.py's rule).  Within the port, a clean lazy
solve equals the live one bit for bit and a rolled-back faulted solve
equals the clean one.  ``_lazy_exit_resolve`` and the ``auto`` policy
are held exactly.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from abft_sparse_cg_tpu.formats import assemble, build_protected
from abft_sparse_cg_tpu.inject import inject_bitflips
from abft_sparse_cg_tpu.ops.spmv import make_matrix_device as jmake_md
from abft_sparse_cg_tpu.ops.spmv_pallas import (
    make_pallas_product,
    make_pallas_spmv,
)
from abft_sparse_cg_tpu.solver import cg as jcg
from abft_sparse_cg_tpu.solver.fused import make_fused_solver as jfused
from abft_sparse_cg_tpu.utils.matgen import spd_tridiagonal
from abft_sparse_cg_tpu.utils.matzoo import band_plus_random, powerlaw_graph
from abft_sparse_cg_tpu_torch.backends.cuda_backend import (
    CudaBackend,
    _check_interval,
)
from abft_sparse_cg_tpu_torch.ops.spmv import (
    ERR_BREAKDOWN,
    ERR_DOUBLE,
    ERR_PHANTOM,
    ERR_SED,
    SpmvStats,
    make_matrix_device,
)
from abft_sparse_cg_tpu_torch.ops.spmv_cuda import (
    make_cuda_product,
    make_cuda_spmv,
)
from abft_sparse_cg_tpu_torch.solver import cg
from abft_sparse_cg_tpu_torch.solver.fused import (
    make_fused_solver,
    supports_fused,
)

MAX_ITRS, CONV = 300, 1e-8
CPU = torch.device("cpu")
# Small eager CPU tensors: one intra-op thread per process, so that
# parallel test workers do not oversubscribe the cores.
torch.set_num_threads(1)


def tridiagonal(mode, n=1024, force=None):
    rows, cols, vals, n = spd_tridiagonal(n)
    return build_protected("csr", assemble(cols, rows, vals, n, 1), mode,
                           force_exec=force)


def bordered(mode):
    """tests/test_fused.py's split_matrix: a 2048-row tridiagonal core
    with two dense rows of 300 entries."""
    rows, cols, vals, n = spd_tridiagonal(2048)
    rows, cols, vals = list(rows), list(cols), list(vals)
    rng = np.random.default_rng(3)
    for r in (17, 900):
        targets = np.setdiff1d(rng.choice(n, size=300, replace=False),
                               [r - 1, r, r + 1])
        for c in targets:
            rows.append(max(r, int(c)))
            cols.append(min(r, int(c)))
            vals.append(-0.01)
    rows, cols = np.array(rows), np.array(cols)
    vals = np.array(vals, dtype=float)
    deg = np.bincount(rows, minlength=n) + np.bincount(cols, minlength=n)
    diag = rows == cols
    vals[diag] = deg.astype(float)[rows[diag]] + 4.0
    m = build_protected("csr", assemble(cols, rows, vals, n, 1), mode)
    assert m.exec_kind == "split" and m.tail.dense_plan is not None
    return m


def make(layout, mode):
    if layout == "dia":
        return tridiagonal(mode)
    if layout == "ell":
        return tridiagonal(mode, force="ell")
    return bordered(mode)


def inject(m, flips, seed, kind="ANY"):
    return inject_bitflips(m, kind, flips, np.random.default_rng(seed),
                           echo=lambda s: None)


def bvec(m, seed=77):
    b = np.zeros(m.R, np.float32)
    b[: m.N] = np.random.default_rng(seed).random(m.N)
    return b


def jstats(st):
    return tuple(int(v) for v in st)


def port_fused(m, mode, ci, b):
    return make_fused_solver(m, mode, MAX_ITRS, CONV, check_interval=ci)(
        make_matrix_device(m, torch.float32, CPU), torch.tensor(b))


# The interpret-mode references, compiled once per (matrix family, mode,
# CI) and shared by the tests of this module: a faulted copy, or a matrix
# of the family with other values, has the same static layout and runs
# on the same compiled megakernel (the values arrive as arguments).
_JAX_FUSED = {}


def jax_fused(m, mode, ci, b, family):
    key = (family, mode, ci)
    if key not in _JAX_FUSED:
        _JAX_FUSED[key] = jax.jit(jfused(m, mode, MAX_ITRS, CONV,
                                         interpret=True, check_interval=ci))
    return _JAX_FUSED[key](jmake_md(m, jnp.float32), jnp.asarray(b))


def assert_same_solve(jr, tr, split=False, floor=None):
    """Iterations and events equal; the trace to 1e-4 (a split tail's to
    1e-3 above float32's noise floor, rr0 * 1e-5; with ``floor``, to 1e-4
    above rr0 * floor); x to rtol 1e-4 / atol 1e-5 when the solve
    stood."""
    it = int(jr.iterations)
    assert tr.iterations == it
    assert tuple(tr.stats) == jstats(jr.stats)
    want = np.asarray(jr.rr_trace)[:it]
    got = tr.rr_trace[:it].numpy()
    keep, tol = np.ones(it, bool), 1e-4
    if split and it:
        keep, tol = want > want[0] * 1e-5, 1e-3
    elif floor and it:
        keep = want > want[0] * floor
    np.testing.assert_allclose(got[keep], want[keep], rtol=tol)
    if tr.stats.errcode == 0:
        np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x),
                                   rtol=1e-4, atol=1e-5)


# --------------------------------------------------------------------------
# Whole-solve tier: kernels B and D, lazy instances (plain loops)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["dia", "ell", "split"])
def test_fused_lazy_clean_matches_pallas_and_live(layout):
    """tests/test_fused.py:487: CI 4 on a clean solve — the JAX lazy
    megakernel's iterations and trace; x equal to the port's live solve
    bit for bit."""
    m = make(layout, "secded")
    b = bvec(m)
    tr = port_fused(m, "secded", 4, b)
    assert_same_solve(jax_fused(m, "secded", 4, b, layout), tr,
                      layout == "split")
    live = port_fused(m, "secded", 1, b)
    assert tr.iterations == live.iterations
    assert torch.equal(tr.x, live.x)
    k = live.iterations
    assert torch.equal(tr.rr_trace[:k], live.rr_trace[:k])


@pytest.mark.parametrize("layout,ci", [("dia", 4), ("ell", 3),
                                       ("split", 4)])
def test_fused_lazy_rollback_matches_pallas(layout, ci):
    """tests/test_fused.py:501: a fault triggers at the first checked
    iteration, the solve rolls back to the snapshot, scrubs and lands on
    the clean solve bit for bit (trace slots included); the same events
    and iterations as the JAX lazy megakernel."""
    m = make(layout, "secded")
    b = bvec(m)
    m2 = inject(m, 1, 8)
    tr = port_fused(m2, "secded", ci, b)
    assert_same_solve(jax_fused(m2, "secded", ci, b, layout), tr,
                      layout == "split")
    assert tr.stats.errcode == 0 and tr.stats.corrected_count == 1
    clean = port_fused(m, "secded", ci, b)
    assert tr.iterations == clean.iterations
    assert torch.equal(tr.x, clean.x)
    k = clean.iterations
    assert torch.equal(tr.rr_trace[:k], clean.rr_trace[:k])


@pytest.mark.parametrize("seed", [3, 5, 9, 11])
def test_fused_lazy_rollback_equals_clean(seed):
    """Within the port, CI 7 (the window spans the exit): every
    corrected fault rolls back to the clean solve bit for bit."""
    m = tridiagonal("secded")
    b = bvec(m)
    clean = port_fused(m, "secded", 7, b)
    r = port_fused(inject(m, 1, seed), "secded", 7, b)
    assert r.stats.errcode == 0 and r.stats.corrected_count == 1
    assert r.iterations == clean.iterations
    assert torch.equal(r.x, clean.x)


@pytest.mark.parametrize("mode,flips,seed,kind,err", [
    ("sed", 1, 5, "ANY", ERR_SED), ("secded", 2, 12, "VALUE", ERR_DOUBLE)])
def test_fused_lazy_failstop_rolls_back(mode, flips, seed, kind, err):
    """tests/test_fused.py:585-606: an uncorrectable fault fail-stops
    with the state rolled back to the last verified snapshot — the
    entry state, iteration 0 — as the JAX lazy megakernel does."""
    m = inject(tridiagonal(mode), flips, seed, kind)
    b = bvec(m)
    tr = port_fused(m, mode, 4, b)
    assert tr.stats.errcode == err and tr.iterations == 0
    assert_same_solve(jax_fused(m, mode, 4, b, "dia"), tr)


def _benign_col_bump(m):
    """A planes copy with one column index moved up by one inside its
    row's order (tests/test_fused.py:620-633)."""
    cols, rp = np.asarray(m.planes["col"]), np.asarray(m.row_ptr)
    for row in range(m.N):
        lo, hi = rp[row], rp[row + 1]
        cs = cols[lo:hi]
        for i in range(hi - lo):
            nxt = cs[i + 1] if i + 1 < hi - lo else m.N
            prv = cs[i - 1] if i > 0 else -1
            if prv < cs[i] + 1 < nxt and cs[i] + 1 < m.N:
                planes = {k: v.copy() for k, v in m.planes.items()}
                planes["col"][lo + i] += np.uint32(1)
                return m.with_planes(planes)
    raise AssertionError("no benign column change found")


def test_fused_lazy_constraints_adopts_and_failstops():
    """tests/test_fused.py:609-640: clean equals live; a benign index
    change is adopted (classify refreshes the baseline) and the retry
    from the snapshot completes as the JAX lazy megakernel's does; an
    out-of-range column fail-stops."""
    m = tridiagonal("constraints", force="ell")
    b = bvec(m)
    clean = port_fused(m, "constraints", 4, b)
    live = port_fused(m, "constraints", 1, b)
    assert clean.stats.errcode == 0 and torch.equal(clean.x, live.x)
    m2 = _benign_col_bump(m)
    tr = port_fused(m2, "constraints", 4, b)
    assert tr.stats.errcode == 0 and tr.iterations > 0
    assert_same_solve(jax_fused(m2, "constraints", 4, b, "ell"), tr)
    planes = {k: v.copy() for k, v in m.planes.items()}
    planes["col"][10] |= np.uint32(1 << 23)
    r3 = port_fused(m.with_planes(planes), "constraints", 4, b)
    assert r3.stats.errcode != 0


def test_fused_lazy_mode_none_runs_live():
    """Mode none has no signals: a check interval runs the live loop
    (fused.py:257), the same solve as CI 1."""
    m = tridiagonal("none")
    b = bvec(m)
    a, c = port_fused(m, "none", 4, b), port_fused(m, "none", 1, b)
    assert a.iterations == c.iterations and torch.equal(a.x, c.x)


def test_fused_lazy_breakdown_stands():
    """A fault-free breakdown under the lazy schedule: classify finds
    nothing, the state is not rolled back, ERR_BREAKDOWN as the JAX
    megakernel reports."""
    rows, cols, vals, n = spd_tridiagonal(1024)
    m = build_protected("csr", assemble(cols, rows, -vals, n, 1), "secded")
    b = bvec(m)
    tr = port_fused(m, "secded", 4, b)
    assert tr.stats.errcode == ERR_BREAKDOWN and tr.iterations == 0
    assert_same_solve(jax_fused(m, "secded", 4, b, "dia"), tr)


# --------------------------------------------------------------------------
# Per-iteration tier: the lazy loop over the products (plain versions)
# --------------------------------------------------------------------------

def periter_matrix(shape, mode):
    if shape == "dia":
        m = tridiagonal(mode, n=512)
    elif shape == "ell":
        m = tridiagonal(mode, force="ell")
    elif shape == "flat":
        rows, cols, vals, n = powerlaw_graph(n=2048)
        m = build_protected("csr", assemble(cols, rows, vals, n, 1), mode,
                            split="none")
        assert m.exec_kind == "flat"
    else:
        rows, cols, vals, n = band_plus_random(n=16384)
        m = build_protected("csr", assemble(cols, rows, vals, n, 1), mode)
        assert m.exec_kind == "split" and m.tail.dense_plan is None
    return m


def periter_solvers(m, mode, ci, max_itrs=200, conv=1e-6):
    """(JAX lazy over the Pallas kernels in interpret mode, the port's
    lazy and live loops over the cuda impl and product on CPU)."""
    product = make_pallas_product(m, jnp.float32, mode, interpret=True)
    assert product is not None
    jlazy = jax.jit(jcg.make_lazy_ci_solver(
        make_pallas_spmv(m, jnp.float32, mode, interpret=True), product,
        ci, max_itrs, conv))
    impl = make_cuda_spmv(m, torch.float32, mode)
    tlazy = cg.make_lazy_ci_solver(impl, make_cuda_product(m, torch.float32,
                                                           mode),
                                   ci, max_itrs, conv)
    tlive = cg.make_cg_solver(impl, max_itrs, conv)

    def run(mat, reference=True):
        b = np.zeros(mat.R, np.float32)
        b[: mat.N] = mat.to_exec_order(
            np.random.default_rng(17).random(mat.N))
        jr = (jlazy(jmake_md(mat, jnp.float32), jnp.asarray(b)) if reference
              else None)
        md = make_matrix_device(mat, torch.float32, CPU)
        return jr, tlazy(md, torch.tensor(b)), tlive(md, torch.tensor(b))

    return run


@pytest.mark.parametrize("shape,mode,ci,flips,seed", [
    ("dia", "secded", 4, 0, 0), ("dia", "sec8", 3, 1, 3),
    ("ell", "secded", 4, 1, 5), ("dia", "constraints", 5, 0, 0),
    ("dia", "sed", 4, 1, 6), ("flat", "secded", 4, 1, 9),
    ("band-split", "secded", 4, 1, 4)])
def test_periter_lazy_matches_pallas(shape, mode, ci, flips, seed):
    """tests/test_lazy_periter.py: the same iterations and events as the
    JAX lazy loop; a clean lazy solve equals the port's live one bit for
    bit, and a corrected one (rolled back) equals the clean one; a sed
    fail-stop reports the entry state (iteration 0).  On the power-law
    graph (hub rows: a wide spectrum) the float32 trajectories of the
    two summation orders part below ~rr0 * 1e-9: the solve stops at 1e-4
    there, and the trace is held above rr0 * 1e-5."""
    m = periter_matrix(shape, mode)
    flat = shape == "flat"
    run = periter_solvers(m, mode, ci, conv=1e-4 if flat else 1e-6)
    jr, tr, live = run(inject(m, flips, seed) if flips else m)
    assert_same_solve(jr, tr, floor=1e-5 if flat else None)
    if mode == "sed":
        assert tr.stats.errcode == ERR_SED and tr.iterations == 0
        return
    assert tr.stats.errcode == 0
    if flips:
        assert tr.stats.corrected_count == 1
        _, tr_clean, live = run(m, reference=False)
        assert torch.equal(tr.x, tr_clean.x)
    assert tr.iterations == live.iterations
    assert torch.equal(tr.x, live.x)


def test_periter_lazy_reads_no_trigger_unchecked():
    """Unchecked iterations run the detection-free product only: with a
    check interval longer than the solve, kernel A's product runs every
    iteration and the checked impl only in the exit verify."""
    m = periter_matrix("dia", "secded")
    impl = make_cuda_spmv(m, torch.float32, "secded")
    calls = {"checked": 0, "product": 0}
    prod = make_cuda_product(m, torch.float32, "secded")

    def counted(fn, key):
        def f(md, x):
            calls[key] += 1
            return fn(md, x)
        return f

    solve = cg.make_lazy_ci_solver(
        impl._replace(fast_pw=counted(impl.fast_pw, "checked")),
        prod._replace(fast_pw=counted(prod.fast_pw, "product")), 1000,
        200, 1e-6)
    b = torch.tensor(bvec(m))
    r = solve(make_matrix_device(m, torch.float32, CPU), b)
    assert r.stats.errcode == 0
    assert calls == {"checked": 1, "product": r.iterations}


# --------------------------------------------------------------------------
# Equal by construction
# --------------------------------------------------------------------------

class _Md(NamedTuple):
    """A stand-in device matrix: only the checksum baseline matters."""

    cksum: object


RESOLVE_CASES = [
    # (trig, err, verify, classify (errcode, corrected), changes base, stuck)
    (False, 0, False, (0, 0), False, 0),
    (False, 0, True, (0, 1), True, 0),
    (True, 0, False, (0, 1), True, 1),
    (True, 0, False, (0, 0), False, 0),
    (True, 0, False, (0, 0), False, 1),
    (True, 0, False, (0, 0), True, 1),
    (True, 0, False, (ERR_SED, 0), False, 0),
    (False, ERR_BREAKDOWN, False, (0, 0), False, 0),
    (False, ERR_BREAKDOWN, False, (0, 1), True, 0),
    (False, ERR_BREAKDOWN, True, (ERR_DOUBLE, 0), False, 0),
]


@pytest.mark.parametrize("case", RESOLVE_CASES)
def test_lazy_exit_resolve_matches(case):
    """solver.cg._lazy_exit_resolve against JAX's on a table of inputs:
    done, the rolled-back or kept state, the stats and the phantom
    guard's count, as test_phantom_guard_matches does."""
    trig, err, ver, (cerr, ccor), changes, stuck = case
    st_cls = SpmvStats(errcode=cerr, err_slot=3 if cerr else -1,
                       corrected_count=ccor,
                       first_cor_slot=5 if ccor else -1,
                       first_cor_bit=7 if ccor else -1)
    base = np.arange(4, dtype=np.int32)
    after = base + (1 if changes else 0)

    def state(itr, lib, arr):
        v = arr(np.full(8, float(itr), np.float32))
        return (itr, v, v + 1, v + 2, arr(np.float32(itr)),
                arr(np.float32(2 * itr)))

    # JAX
    jmd = _Md(jnp.asarray(base))

    def jcls(md):
        return (jcg.SpmvStats(*(jnp.int32(v) for v in st_cls)),
                _Md(jnp.asarray(after)))

    def jstate(itr):
        i, x, r, p, rr, rz = state(itr, jnp, jnp.asarray)
        return jcg.CGState(jnp.int32(i), x, r, p, rr, rz,
                           jcg.SpmvStats.clean(), jnp.zeros(4))

    jdone, jmd2, js2, jstuck = jcg._lazy_exit_resolve(
        jmd, jstate(9), jstate(4), jnp.bool_(trig), jnp.int32(err),
        lambda md, p: jnp.bool_(ver), jcls, jnp.int32(stuck))
    # port
    tmd = _Md(torch.tensor(base))

    def tcls(md):
        return st_cls, _Md(torch.tensor(after))

    def tstate(itr):
        i, x, r, p, rr, rz = state(itr, torch, torch.tensor)
        return cg.CGState(i, x, r, p, rr, rz, SpmvStats.clean(),
                          torch.zeros(4))

    tdone, tmd2, ts2, tstuck = cg._lazy_exit_resolve(
        tmd, tstate(9), tstate(4), trig, err, lambda md, p: ver, tcls,
        stuck)
    assert tdone == bool(jdone) and tstuck == int(jstuck)
    assert tuple(ts2.stats) == jstats(js2.stats)
    assert ts2.itr == int(js2.itr)
    for f in ("x", "r", "p", "rr", "rz"):
        np.testing.assert_array_equal(getattr(ts2, f).numpy(),
                                      np.asarray(getattr(js2, f)))
    np.testing.assert_array_equal(tmd2.cksum.numpy(),
                                  np.asarray(jmd2.cksum))
    if case == (True, 0, False, (0, 0), False, 1):
        assert ts2.stats.errcode == ERR_PHANTOM


def test_check_interval_auto_policy():
    """'auto' is live on the whole-solve tier and 32 on the per-iteration
    tier; None is live; an int K is max(1, K); junk is refused."""
    fused = tridiagonal("secded")
    flat = periter_matrix("flat", "secded")
    assert supports_fused(fused, torch.float32)
    assert not supports_fused(flat, torch.float32)
    assert _check_interval("auto", fused) == 1
    assert _check_interval("auto", flat) == 32
    assert _check_interval(None, flat) == 1
    assert _check_interval(0, fused) == 1
    assert _check_interval("8", flat) == 8
    with pytest.raises(ValueError):
        _check_interval("often", fused)


@pytest.mark.parametrize("shape,ci", [("dia", 4), ("flat", "auto")])
def test_cuda_backend_lazy_on_cpu_tensors(shape, ci):
    """The cuda target's lazy routes on a CPU device (plain versions):
    the whole-solve lazy loop on DIA, the per-iteration lazy loop (auto:
    32) on a flat matrix; a corrected fault, the clean answer."""
    m = periter_matrix(shape, "secded")
    b = np.random.default_rng(1).random(m.N)
    be = CudaBackend("secded", device="cpu")
    clean = be.solve(m, b, MAX_ITRS, CONV, check_interval=ci)
    fixed = be.solve(inject(m, 1, 6), b, MAX_ITRS, CONV, check_interval=ci)
    assert fixed.corrected_count == 1 and not fixed.failed
    assert fixed.messages[0].startswith("[ECC] corrected")
    np.testing.assert_array_equal(fixed.x, clean.x)
