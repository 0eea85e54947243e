"""Jacobi PCG and mixed-precision refinement of the port against the JAX
package.

Whole-solve tier: ``solver.fused.make_fused_solver(precond=True)``
(kernels B's and D's Jacobi plain loops on CPU tensors, float32, live
and lazy) against the Pallas megakernel's ``precond`` branch in
interpret mode, on the 1024-row tridiagonal of tests/test_fused.py (DIA,
and forced to ELL) with a varying diagonal, and its bordered split:
iterations and events equal, x to rtol 1e-4 / atol 1e-5, the trace to
rtol 1e-4 (1e-3 above float32's noise floor for a split tail).  The
per-iteration loop in float64 against the jnp solver with the same M^-1
to 1e-12.  ``diagonal()`` byte for byte, a corrected fault on the
diagonal included.  ``solve_refined`` recovers float64-level accuracy on
tests/test_refine.py's ill-conditioned matrix and stops on a fail-stop.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from abft_sparse_cg_tpu.formats import assemble as jassemble
from abft_sparse_cg_tpu.formats import build_protected as jbuild
from abft_sparse_cg_tpu.inject import inject_bitflips
from abft_sparse_cg_tpu.ops.spmv import make_matrix_device as jmake_md
from abft_sparse_cg_tpu.ops.spmv import make_spmv as jmake_spmv
from abft_sparse_cg_tpu.solver import cg as jcg
from abft_sparse_cg_tpu.solver.fused import make_fused_solver as jfused
from abft_sparse_cg_tpu.utils import matzoo as jzoo
from abft_sparse_cg_tpu.utils.matgen import spd_tridiagonal
from abft_sparse_cg_tpu_torch.backends.cuda_backend import CudaBackend
from abft_sparse_cg_tpu_torch.backends.torch_backend import (
    TorchBackend,
    jacobi_minv,
)
from abft_sparse_cg_tpu_torch.formats import assemble, build_protected
from abft_sparse_cg_tpu_torch.ops.spmv import (
    ERR_DOUBLE,
    make_matrix_device,
    make_spmv,
)
from abft_sparse_cg_tpu_torch.solver import cg
from abft_sparse_cg_tpu_torch.solver.fused import make_fused_solver
from abft_sparse_cg_tpu_torch.utils import matzoo

MAX_ITRS, CONV = 300, 1e-8
CPU = torch.device("cpu")
# Small eager CPU tensors: one intra-op thread per process, so that
# parallel test workers do not oversubscribe the cores.
torch.set_num_threads(1)


def varied(tri, seed=2):
    """``tri`` with its diagonal scaled row by row by up to 10x, so that
    Jacobi changes the iteration."""
    rows, cols, vals, n = tri
    vals = np.array(vals, dtype=float)
    diag = rows == cols
    vals[diag] *= 1.0 + 9.0 * np.random.default_rng(seed).random(diag.sum())
    return rows, cols, vals, n


def bordered_tri():
    """tests/test_fused.py's bordered matrix: a 2048-row tridiagonal core
    with two dense rows of 300 entries (DIA main, dense-plan tail)."""
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
    return rows, cols, vals, n


def tri_of(layout):
    if layout == "split":
        return varied(bordered_tri())
    return varied(spd_tridiagonal(1024))


def jmatrix(layout, mode):
    rows, cols, vals, n = tri_of(layout)
    m = jbuild("csr", jassemble(cols, rows, vals, n, 1), mode,
               force_exec="ell" if layout == "ell" else None)
    assert m.exec_kind == layout
    return m


def inject(m, flips, seed):
    return inject_bitflips(m, "ANY", flips, np.random.default_rng(seed),
                           echo=lambda s: None)


def exec_vec(m, v, dtype=np.float32):
    out = np.zeros(m.R, dtype)
    out[: m.N] = m.to_exec_order(np.asarray(v, np.float64))
    return out


def bvec(m):
    return exec_vec(m, np.random.default_rng(77).random(m.N))


def minv_vec(m, dtype=np.float32):
    return exec_vec(m, jacobi_minv(m, "jacobi"), dtype)


def jstats(st):
    return tuple(int(v) for v in st)


def assert_same_solve(jr, tr, split=False, rtol=1e-4):
    it = int(jr.iterations)
    assert tr.iterations == it
    assert tuple(tr.stats) == jstats(jr.stats)
    want = np.asarray(jr.rr_trace)[:it]
    got = tr.rr_trace[:it].numpy()
    keep, tol = np.ones(it, bool), rtol
    if split and it:
        keep, tol = want > want[0] * 1e-5, 1e-3
    np.testing.assert_allclose(got[keep], want[keep], rtol=tol)
    if tr.stats.errcode == 0:
        np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x),
                                   rtol=rtol, atol=rtol * 0.1)


def port_fused(m, mode, b, minv, ci=1):
    return make_fused_solver(m, mode, MAX_ITRS, CONV, precond=True,
                             check_interval=ci)(
        make_matrix_device(m, torch.float32, CPU), torch.tensor(b),
        torch.tensor(minv))


def jax_fused(m, mode, b, minv, ci=1):
    return jax.jit(jfused(m, mode, MAX_ITRS, CONV, interpret=True,
                          precond=True, check_interval=ci))(
        jmake_md(m, jnp.float32), jnp.asarray(b), jnp.asarray(minv))


# --------------------------------------------------------------------------
# Whole-solve tier: the Jacobi instances of kernels B and D (plain loops)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("layout,mode,flips", [
    ("dia", "none", 0), ("dia", "secded", 1), ("ell", "none", 0),
    ("ell", "secded", 1), ("split", "secded", 0), ("dia", "sed", 1)])
def test_fused_jacobi_matches_pallas(layout, mode, flips):
    """tests/test_fused.py:241-265: the Jacobi kernel variant against
    the JAX megakernel's, clean and with an injected fault (corrected,
    or a sed fail-stop)."""
    m = jmatrix(layout, mode)
    b, minv = bvec(m), minv_vec(m)
    mf = inject(m, flips, 6) if flips else m
    tr = port_fused(mf, mode, b, minv)
    assert_same_solve(jax_fused(mf, mode, b, minv), tr, layout == "split")
    if flips and mode == "secded":
        assert tr.stats.corrected_count == 1 and tr.stats.errcode == 0
    # Jacobi changes the iteration on this varied diagonal
    plain = make_fused_solver(m, mode, MAX_ITRS, CONV)(
        make_matrix_device(m, torch.float32, CPU), torch.tensor(b))
    assert plain.iterations != tr.iterations or layout == "split"


def test_fused_jacobi_refuses_a_mismatched_minv():
    """The Jacobi builder needs minv and the unpreconditioned one refuses
    it (fused.py:2065-2068)."""
    m = jmatrix("dia", "secded")
    md = make_matrix_device(m, torch.float32, CPU)
    b, minv = torch.tensor(bvec(m)), torch.tensor(minv_vec(m))
    with pytest.raises(ValueError):
        make_fused_solver(m, "secded", MAX_ITRS, CONV)(md, b, minv)
    with pytest.raises(ValueError):
        make_fused_solver(m, "secded", MAX_ITRS, CONV, precond=True)(md, b)


@pytest.mark.parametrize("layout", ["dia", "ell"])
def test_fused_lazy_jacobi(layout):
    """tests/test_fused.py:539: the lazy schedule on the Jacobi instance
    — the JAX lazy Jacobi megakernel's solve; clean equal to live bit for
    bit; a rolled-back corrected fault equal to the clean solve."""
    m = jmatrix(layout, "secded")
    b, minv = bvec(m), minv_vec(m)
    lz = port_fused(m, "secded", b, minv, ci=4)
    assert_same_solve(jax_fused(m, "secded", b, minv, ci=4), lz)
    live = port_fused(m, "secded", b, minv)
    assert lz.iterations == live.iterations and torch.equal(lz.x, live.x)
    fixed = port_fused(inject(m, 1, 8), "secded", b, minv, ci=4)
    assert fixed.stats.corrected_count == 1 and fixed.stats.errcode == 0
    assert torch.equal(fixed.x, live.x)


# --------------------------------------------------------------------------
# Per-iteration tier, float64, against the jnp solver
# --------------------------------------------------------------------------

def zoo_matrix(shape, mode):
    if shape == "flat":
        tri, kw = jzoo.stencil27_shuffled(side=10), {"force_exec": "flat"}
    else:
        tri, kw = jzoo.band_plus_random(n=16384), {}
    rows, cols, vals, n = varied(tri)
    return jbuild("csr", jassemble(cols, rows, vals, n, 1), mode, **kw)


@pytest.mark.parametrize("shape,mode,flips", [
    ("dia", "secded", 1), ("flat", "secded", 1), ("band", "sec8", 1),
    ("flat", "none", 0)])
def test_cg_f64_jacobi_matches_jnp(shape, mode, flips):
    """solver.cg with minv, float64, against the jnp solver's Jacobi
    path (cg.py:81-128): the same iterations and events, the trace and x
    to 1e-12."""
    m = jmatrix("dia", mode) if shape == "dia" else zoo_matrix(shape, mode)
    if flips:
        m = inject(m, flips, 6)
    b = bvec(m).astype(np.float64)
    minv = minv_vec(m, np.float64)
    jr = jax.jit(jcg.make_cg_solver(jmake_spmv(m, jnp.float64, mode),
                                    MAX_ITRS, CONV))(
        jmake_md(m, jnp.float64), jnp.asarray(b), jnp.asarray(minv))
    tr = cg.make_cg_solver(make_spmv(m, torch.float64, mode), MAX_ITRS,
                           CONV)(make_matrix_device(m, torch.float64, CPU),
                                 torch.tensor(b), torch.tensor(minv))
    assert_same_solve(jr, tr, rtol=1e-12)


def test_periter_lazy_jacobi_matches_pallas():
    """The per-iteration lazy loop with minv (cg.py:325-433) against the
    JAX one over the Pallas kernels in interpret mode, a corrected fault
    rolled back."""
    from abft_sparse_cg_tpu.ops.spmv_pallas import (
        make_pallas_product,
        make_pallas_spmv,
    )
    from abft_sparse_cg_tpu_torch.ops.spmv_cuda import (
        make_cuda_product,
        make_cuda_spmv,
    )

    m = inject(jmatrix("dia", "secded"), 1, 3)
    b, minv = bvec(m), minv_vec(m)
    jr = jax.jit(jcg.make_lazy_ci_solver(
        make_pallas_spmv(m, jnp.float32, "secded", interpret=True),
        make_pallas_product(m, jnp.float32, "secded", interpret=True), 4,
        MAX_ITRS, CONV))(jmake_md(m, jnp.float32), jnp.asarray(b),
                         jnp.asarray(minv))
    tr = cg.make_lazy_ci_solver(
        make_cuda_spmv(m, torch.float32, "secded"),
        make_cuda_product(m, torch.float32, "secded"), 4, MAX_ITRS, CONV)(
        make_matrix_device(m, torch.float32, CPU), torch.tensor(b),
        torch.tensor(minv))
    assert_same_solve(jr, tr)
    assert tr.stats.corrected_count == 1


# --------------------------------------------------------------------------
# The preconditioner's set-up
# --------------------------------------------------------------------------

def _diag_slot(m):
    """Canonical index of a diagonal entry of a CSR matrix."""
    rows = np.repeat(np.arange(m.N), np.diff(m.row_ptr))
    cols = m.planes["col"] & np.uint32(0x00FFFFFF)
    return int(np.flatnonzero(rows == cols)[7])


@pytest.mark.parametrize("shape", ["dia", "ell", "split"])
@pytest.mark.parametrize("mode", ["none", "sec8", "secded"])
def test_diagonal_matches_jax_byte_for_byte(shape, mode):
    """formats.protected/split ``diagonal()`` equal to JAX's bytes, clean
    and with a flipped value bit on a diagonal entry: the ECC modes
    correct it first, mode none reads it as stored."""
    if shape == "ell":
        tri, kw = matzoo.dense_radius_3d(side=6), {}
        jtri = jzoo.dense_radius_3d(side=6)
    elif shape == "split":
        tri, kw = matzoo.arrowhead(n=2048), {}
        jtri = jzoo.arrowhead(n=2048)
    else:
        tri, kw = spd_tridiagonal(512), {}
        jtri = tri
    rows, cols, vals, n = tri
    tm = build_protected("csr", assemble(cols, rows, vals, n, 1), mode, **kw)
    rows, cols, vals, n = jtri
    jm = jbuild("csr", jassemble(cols, rows, vals, n, 1), mode, **kw)
    assert tm.exec_kind == jm.exec_kind == shape
    assert tm.diagonal().tobytes() == jm.diagonal().tobytes()
    k = _diag_slot(jm)
    planes = {n_: p.copy() for n_, p in jm.planes.items()}
    planes["value_hi"][k] ^= np.uint32(1 << 20)
    tm2, jm2 = tm.with_planes(planes), jm.with_planes(planes)
    d2 = tm2.diagonal()
    assert d2.tobytes() == jm2.diagonal().tobytes()
    assert (d2.tobytes() == tm.diagonal().tobytes()) == (mode != "none")


def test_jacobi_minv_pads_and_zero_diagonal():
    """M^-1 is 1 where the diagonal is zero, and the exec vector is zero
    on pad rows (jnp_backend.py:188-229)."""
    rows, cols, vals, n = spd_tridiagonal(100)
    vals = np.array(vals, dtype=float)
    vals[(rows == cols) & (rows == 5)] = 0.0
    m = build_protected("csr", assemble(cols, rows, vals, n, 1), "none")
    minv = jacobi_minv(m, "jacobi")
    assert minv[5] == 1.0 and minv[4] == 1.0 / m.diagonal()[4]
    vec = TorchBackend("none")._exec_vector(m, minv, torch.float64)
    assert m.R > m.N and not vec[m.N:].any()
    assert jacobi_minv(m, "none") is None
    with pytest.raises(ValueError):
        jacobi_minv(m, "ilu")


@pytest.mark.parametrize("ci", [None, 4])
def test_cuda_backend_jacobi_on_cpu_tensors(ci):
    """The cuda target with -p jacobi on a CPU device: kernel B's Jacobi
    plain loop (lazy with a check interval), a corrected fault, an
    answer within float32 reach of b."""
    m = jmatrix("dia", "secded")
    b = np.random.default_rng(1).random(m.N)
    be = CudaBackend("secded", device="cpu")
    res = be.solve(inject(m, 1, 6), b, MAX_ITRS, CONV, precond="jacobi",
                   check_interval=ci)
    assert res.corrected_count == 1 and not res.failed
    w, code, _ = be.spmv_once(m, res.x)
    assert code == 0 and np.abs(w - b).max() < 1e-3


# --------------------------------------------------------------------------
# Mixed-precision refinement (tests/test_refine.py's matrix)
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def illcond():
    r, c, v, n = matzoo.aniso_laplace_2d(side=32, eps=1e-2)
    a = assemble(np.asarray(c), np.asarray(r), np.asarray(v, float), n, 1)
    m = build_protected("csr", a, "secded")
    return a, m, np.random.default_rng(3).random(m.N)


def _true_rr(a, x, b):
    ax = np.zeros(a.N)
    np.add.at(ax, a.rows, a.values * np.asarray(x, np.float64)[a.cols])
    r64 = b - ax
    return float(r64 @ r64)


@pytest.mark.parametrize("target", ["torch", "cuda"])
def test_refinement_recovers_f64_accuracy(illcond, target):
    """Float32 CG stalls at a true residual far above the target;
    solve_refined reports the true float64 residual and recovers six
    orders of magnitude (test_f32_stalls_and_refinement_recovers), on
    the plain float32 loop and on the cuda target's kernel B (plain
    version on CPU tensors)."""
    a, m, b = illcond
    be = (TorchBackend("secded") if target == "torch"
          else CudaBackend("secded", device="cpu"))
    res32 = be.solve(m, b, 2500, 1e-10, dtype="f32")
    t32 = _true_rr(a, res32.x, b)
    resr = be.solve_refined(m, b, 2500, 1e-10, refine=5, dtype="f32")
    tr = _true_rr(a, resr.x, b)
    assert t32 > 1e-4, t32
    assert tr == pytest.approx(resr.rr, rel=1e-6)
    assert tr < t32 * 1e-6 and tr < 1e-7, (tr, t32)


def test_refinement_stops_on_fail_stop(illcond):
    """A double-bit fault fail-stops the first inner solve: refinement
    returns that result (test_refine_aborts_on_fail_stop)."""
    _, m, b = illcond
    m2 = inject(m, 2, 5)
    res = TorchBackend("secded").solve_refined(m2, b, 50, 1e-10, refine=3,
                                               dtype="f32")
    assert res.failed and res.errcode == ERR_DOUBLE
    assert "double-bit" in res.messages[-1]


def test_host_residual_matches_jax(illcond):
    """The refinement's binary64 host residual equals JAX's (w, errcode,
    messages), with a corrected fault on the planes."""
    from abft_sparse_cg_tpu.backends.base import Backend as JBackend
    from abft_sparse_cg_tpu_torch.backends.base import Backend

    a, m, b = illcond
    rows, cols, vals, n = jzoo.aniso_laplace_2d(side=32, eps=1e-2)
    jm = jbuild("csr", jassemble(np.asarray(cols), np.asarray(rows),
                                 np.asarray(vals, float), n, 1), "secded")
    planes = {k: p.copy() for k, p in jm.planes.items()}
    planes["value_lo"][11] ^= np.uint32(1 << 3)
    x = np.random.default_rng(4).random(m.N)
    w1, e1, m1 = JBackend._host_residual_spmv(jm.with_planes(planes), x)
    w2, e2, m2 = Backend._host_residual_spmv(m.with_planes(planes), x)
    assert w1.tobytes() == w2.tobytes() and e1 == e2 and m1 == m2
    assert m2 and m2[0].startswith("[ECC] corrected bit")
