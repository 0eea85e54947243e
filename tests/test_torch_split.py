"""The port's solvers on the flat and split layouts against the JAX
package.

The split tail's plain loop (kernels B's and D's ``kTail`` instance, on
CPU tensors, float32) against the megakernel's split branch run in
interpret mode, on tests/test_fused.py's bordered matrix (a 2048-row
tridiagonal core with two dense rows of 300 entries: DIA main, dense-
plan tail): iterations and ABFT events equal, a fault in either part;
the rr trace to 1e-3 above float32's noise floor (the rule of
tests/test_fused.py for split matrices: the tail's dot products are
summed in another order).  The per-iteration loop (solver.cg, float64)
on a flat, a band-split and a bordered-split matrix against the jnp
solver to 1e-12, and the cuda target's two tiers on CPU tensors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from abft_sparse_cg_tpu.backends.base import stats_to_messages
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
from abft_sparse_cg_tpu_torch.ops.spmv import make_matrix_device, make_spmv
from abft_sparse_cg_tpu_torch.solver import cg
from abft_sparse_cg_tpu_torch.solver.fused import (
    make_fused_solver,
    supports_fused,
)

CPU = torch.device("cpu")
# Small eager CPU tensors: one intra-op thread per process, so that
# parallel test workers do not oversubscribe the cores.
torch.set_num_threads(1)


def build(tri, mode, **kw):
    rows, cols, vals, n = tri
    return jbuild("csr", jassemble(cols, rows, vals, n, 1), mode, **kw)


def matrix(shape, mode):
    """stencil27-shuffled side 10 forced flat (RCM gidx plane),
    band+random-1pct n = 16384 (band split), arrowhead n = 2048
    (bordered split)."""
    if shape == "flat":
        m = build(jzoo.stencil27_shuffled(side=10), mode, force_exec="flat")
    elif shape == "band":
        m = build(jzoo.band_plus_random(n=16384), mode)
        assert m.tail.dense_plan is None
    else:
        m = build(jzoo.arrowhead(n=2048), mode)
        assert m.tail.dense_plan is not None
    assert m.exec_kind == ("flat" if shape == "flat" else "split")
    return m

# --------------------------------------------------------------------------

MAX_ITRS, CONV = 300, 1e-8


def bordered_matrix(mode):
    """tests/test_fused.py's split_matrix: a 2048-row tridiagonal core
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
    m = jbuild("csr", jassemble(cols, rows, vals, n, 1), mode)
    assert m.exec_kind == "split" and m.tail.dense_plan is not None
    return m


def bvec(m, seed=77):
    b = np.zeros(m.R, np.float32)
    b[: m.N] = np.random.default_rng(seed).random(m.N)
    return b


SPLIT_CASES = [("none", 0, 0), ("constraints", 0, 0), ("secded", 0, 0),
               ("sec8", 1, 6), ("secded", 1, 6), ("sed", 1, 6),
               ("secded", 2, 3), ("secded", 1, 9)]


@pytest.mark.parametrize("mode,flips,seed", SPLIT_CASES,
                         ids=[f"{c[0]}-{c[1]}-{c[2]}" for c in SPLIT_CASES])
def test_split_tail_matches_pallas_megakernel(mode, flips, seed):
    """Kernel B's split-tail plain loop vs the megakernel's split branch
    in interpret mode: iterations and ABFT events equal (a fault in the
    main or the tail part), the rr trace to rtol 1e-3 above float32's
    noise floor."""
    m = bordered_matrix(mode)
    if flips:
        m = inject_bitflips(m, "ANY", flips, np.random.default_rng(seed),
                            echo=lambda s: None)
    assert supports_fused(m, torch.float32)
    b = bvec(m)
    jr = jax.jit(jfused(m, mode, MAX_ITRS, CONV, interpret=True))(
        jmake_md(m, jnp.float32), jnp.asarray(b))
    tr = make_fused_solver(m, mode, MAX_ITRS, CONV)(
        make_matrix_device(m, torch.float32, CPU), torch.tensor(b))
    it = int(jr.iterations)
    assert tr.iterations == it
    assert tuple(tr.stats) == tuple(int(v) for v in jr.stats)
    # tests/test_fused.py's split rule: the tail's dot products are summed
    # in another order, and once rr falls ~5 orders below rr0 float32
    # rounding noise dominates the trace; compare above that floor.
    t0 = np.asarray(jr.rr_trace)[:it]
    above = t0 > (float(t0[0]) * 1e-5 if it else 0)
    np.testing.assert_allclose(tr.rr_trace[:it].numpy()[above], t0[above],
                               rtol=1e-3)
    if tr.stats.errcode == 0:
        np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x),
                                   rtol=1e-4, atol=1e-5)


CG_CASES = [("flat", "none", 0, 0), ("flat", "secded", 1, 6),
            ("flat", "sed", 1, 6), ("flat", "constraints", 0, 0),
            ("band", "secded", 1, 6), ("band", "secded", 2, 3),
            ("arrow", "sec7", 1, 6), ("arrow", "none", 0, 0)]


@pytest.mark.parametrize("shape,mode,flips,seed", CG_CASES,
                         ids=[f"{c[0]}-{c[1]}-{c[2]}" for c in CG_CASES])
def test_cg_f64_matches_jnp(shape, mode, flips, seed):
    """The per-iteration loop on the flat and split layouts, float64,
    against the jnp solver."""
    m = matrix(shape, mode)
    if flips:
        m = inject_bitflips(m, "ANY", flips, np.random.default_rng(seed),
                            echo=lambda s: None)
    b = bvec(m).astype(np.float64)
    jr = jax.jit(jcg.make_cg_solver(jmake_spmv(m, jnp.float64, mode),
                                    MAX_ITRS, CONV))(
        jmake_md(m, jnp.float64), jnp.asarray(b))
    tr = cg.make_cg_solver(make_spmv(m, torch.float64, mode), MAX_ITRS,
                           CONV)(make_matrix_device(m, torch.float64, CPU),
                                 torch.tensor(b))
    it = int(jr.iterations)
    assert tr.iterations == it
    assert tuple(tr.stats) == tuple(int(v) for v in jr.stats)
    np.testing.assert_allclose(tr.rr_trace[:it].numpy(),
                               np.asarray(jr.rr_trace)[:it], rtol=1e-12)
    np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x), rtol=1e-12,
                               atol=1e-14)


@pytest.mark.parametrize("shape,fused", [("flat", False), ("band", False),
                                         ("arrow", True)])
def test_cuda_backend_tiers_on_cpu_tensors(shape, fused):
    """The cuda target's routing, run on a CPU device (plain versions):
    a bordered split with a dense plan takes the whole-solve tier, flat
    matrices and band splits the per-iteration tier; a corrected fault
    prints its canonical index and the answer is right."""
    m = matrix(shape, "secded")
    assert supports_fused(m, torch.float32) == fused
    m = inject_bitflips(m, "ANY", 1, np.random.default_rng(6),
                        echo=lambda s: None)
    b = np.random.default_rng(1).random(m.N)
    be = CudaBackend("secded", device="cpu")
    res = be.solve(m, b, MAX_ITRS, CONV)
    jres = jcg.make_cg_solver(jmake_spmv(m, jnp.float64, "secded"),
                              MAX_ITRS, CONV)
    assert res.corrected_count == 1 and not res.failed
    assert res.messages[0].startswith("[ECC] corrected")
    jb = np.zeros(m.R)
    jb[: m.N] = m.to_exec_order(b)
    jr = jax.jit(jres)(jmake_md(m, jnp.float64), jnp.asarray(jb))
    jmsgs, _ = stats_to_messages(m, *(int(v) for v in (
        jr.stats.errcode, jr.stats.err_slot, jr.stats.first_cor_slot,
        jr.stats.first_cor_bit)))
    assert res.messages == jmsgs
    w, code, _ = be.spmv_once(m, res.x)
    assert code == 0 and np.abs(w - b).max() < 1e-2
