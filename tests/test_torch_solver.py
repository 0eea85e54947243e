"""The port's solvers against the JAX package.

``solver.fused`` (kernels B's and D's plain loops on CPU tensors,
float32) against the Pallas megakernel run in interpret mode, and
``solver.cg`` (float64) against the jnp solver, on the 1024-row
tridiagonal of tests/test_fused.py (DIA, and label-shuffled and forced
to ELL) and the dense-radius-3d zoo family at side 10 (ELL, K = 175),
with seeded right-hand sides and injections.
Iterations and ABFT events must be equal.  The float32 trace agrees to
rtol 1e-4: its reductions (pw, rr) are summed in another order than the
TPU kernel's lane-vector accumulation.  The float64 trace agrees to
1e-12 (same expressions, reduction order only).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from abft_sparse_cg_tpu.formats import assemble, build_protected
from abft_sparse_cg_tpu.inject import inject_bitflips
from abft_sparse_cg_tpu.ops.spmv import make_matrix_device as jmake_md
from abft_sparse_cg_tpu.ops.spmv import make_spmv as jmake_spmv
from abft_sparse_cg_tpu.solver import cg as jcg
from abft_sparse_cg_tpu.solver.fused import make_fused_continue as jcontinue
from abft_sparse_cg_tpu.solver.fused import make_fused_solver as jfused
from abft_sparse_cg_tpu.utils.matgen import shuffle_labels, spd_tridiagonal
from abft_sparse_cg_tpu.utils.matzoo import dense_radius_3d
from abft_sparse_cg_tpu_torch.backends.cuda_backend import CudaBackend
from abft_sparse_cg_tpu_torch.convert import cg_state_from_numpy
from abft_sparse_cg_tpu_torch.ops.spmv import (
    ERR_BREAKDOWN,
    ERR_DOUBLE,
    ERR_PHANTOM,
    ERR_SED,
    SpmvStats,
    make_matrix_device,
    make_spmv,
)
from abft_sparse_cg_tpu_torch.solver import cg
from abft_sparse_cg_tpu_torch.solver.fused import (
    make_fused_continue,
    make_fused_solver,
    supports_fused,
)

MAX_ITRS, CONV = 300, 1e-8
CPU = torch.device("cpu")
# Small eager CPU tensors: one intra-op thread per process, so that
# parallel test workers do not oversubscribe the cores.
torch.set_num_threads(1)


def dia_matrix(mode, n=1024, sign=1.0):
    rows, cols, vals, n = spd_tridiagonal(n)
    m = build_protected("csr", assemble(cols, rows, sign * vals, n, 1), mode)
    assert m.exec_kind == "dia"
    return m


def inject(m, flips, seed):
    return inject_bitflips(m, "ANY", flips, np.random.default_rng(seed),
                           echo=lambda s: None)


def bvec(m, seed=77):
    b = np.zeros(m.R, np.float32)
    b[: m.N] = np.random.default_rng(seed).random(m.N)
    return b


def jstats(st):
    return tuple(int(v) for v in st)


def run_both_fused(m, mode):
    b = bvec(m)
    jr = jax.jit(jfused(m, mode, MAX_ITRS, CONV, interpret=True))(
        jmake_md(m, jnp.float32), jnp.asarray(b))
    tr = make_fused_solver(m, mode, MAX_ITRS, CONV)(
        make_matrix_device(m, torch.float32, CPU), torch.tensor(b))
    return jr, tr


def assert_same_solve(jr, tr, rtol=1e-4):
    it = int(jr.iterations)
    assert tr.iterations == it
    assert tuple(tr.stats) == jstats(jr.stats)
    np.testing.assert_allclose(tr.rr_trace[:it].numpy(),
                               np.asarray(jr.rr_trace)[:it], rtol=rtol)
    assert torch.isnan(tr.rr_trace[it:]).all()


# (case, mode, flips, seed, expected errcode, expected corrections)
FUSED_CASES = [
    ("clean", "none", 0, 0, 0, 0),
    ("clean", "constraints", 0, 0, 0, 0),
    ("clean", "secded", 0, 0, 0, 0),
    ("corrected", "sec7", 1, 6, 0, 1),
    ("corrected", "sec8", 1, 6, 0, 1),
    ("corrected", "secded", 1, 6, 0, 1),
    ("sed-halt", "sed", 1, 6, ERR_SED, 0),
    ("double-halt", "secded", 2, 3, ERR_DOUBLE, 0),
]


@pytest.mark.parametrize("case,mode,flips,seed,err,cor", FUSED_CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in FUSED_CASES])
def test_fused_matches_pallas_megakernel(case, mode, flips, seed, err, cor):
    m = dia_matrix(mode)
    if flips:
        m = inject(m, flips, seed)
    jr, tr = run_both_fused(m, mode)
    assert_same_solve(jr, tr)
    assert tr.stats.errcode == err and tr.stats.corrected_count == cor
    if err == 0:
        np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x),
                                   rtol=1e-4, atol=1e-5)


def test_fused_breakdown_matches():
    """A negative-definite matrix: p.A.p < 0 at the first iteration."""
    m = dia_matrix("secded", sign=-1.0)
    jr, tr = run_both_fused(m, "secded")
    assert_same_solve(jr, tr)
    assert tr.stats.errcode == ERR_BREAKDOWN and tr.iterations == 0


@pytest.mark.parametrize("mode", ["none", "secded"])
def test_resume_from_jax_state(mode):
    """A JAX megakernel run stopped at upto=3, carried over with
    convert.cg_state_from_numpy, finishes like the straight JAX run."""
    m = inject(dia_matrix(mode), 1, 6) if mode != "none" else \
        dia_matrix(mode)
    b = jnp.asarray(bvec(m))
    jmd = jmake_md(m, jnp.float32)
    cont = jax.jit(jcontinue(m, mode, CONV, interpret=True))
    s3, jmd3 = cont(jmd, jcg.init_state(b, MAX_ITRS), jnp.int32(3))
    assert int(s3.itr) == 3
    fields = {k: np.asarray(v) for k, v in s3._asdict().items()
              if k != "stats"}
    fields["stats"] = jstats(s3.stats)
    state = cg_state_from_numpy(fields, CPU)
    assert state.itr == 3 and state.x.dtype == torch.float32
    tmd = make_matrix_device(m, torch.float32, CPU)
    if mode != "none":
        tmd = make_spmv(m, torch.float32, mode).classify(tmd)[1]
    s, _ = make_fused_continue(m, mode, CONV)(tmd, state, MAX_ITRS)
    straight = jax.jit(jfused(m, mode, MAX_ITRS, CONV, interpret=True))(
        jmd, b)
    assert s.itr == int(straight.iterations)
    np.testing.assert_allclose(s.trace[: s.itr].numpy(),
                               np.asarray(straight.rr_trace)[: s.itr],
                               rtol=1e-4)


CG_CASES = [("none", 0, 0), ("constraints", 0, 0), ("secded", 0, 0),
            ("sec8", 1, 6), ("secded", 1, 6), ("sed", 1, 6),
            ("secded", 2, 3)]


@pytest.mark.parametrize("mode,flips,seed", CG_CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in CG_CASES])
def test_cg_f64_matches_jnp(mode, flips, seed):
    """The per-iteration detect-fast/repair-rarely loop, float64."""
    m = dia_matrix(mode)
    if flips:
        m = inject(m, flips, seed)
    b = bvec(m).astype(np.float64)
    jr = jax.jit(jcg.make_cg_solver(jmake_spmv(m, jnp.float64, mode),
                                    MAX_ITRS, CONV))(
        jmake_md(m, jnp.float64), jnp.asarray(b))
    tr = cg.make_cg_solver(make_spmv(m, torch.float64, mode), MAX_ITRS,
                           CONV)(make_matrix_device(m, torch.float64, CPU),
                                 torch.tensor(b))
    assert_same_solve(jr, tr, rtol=1e-12)
    np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x), rtol=1e-12,
                               atol=1e-14)


def test_cuda_backend_routes_to_fused_on_cpu_tensors():
    """The cuda target's routing, run on a CPU device (plain versions)."""
    m = inject(dia_matrix("secded"), 1, 6)
    assert supports_fused(m, torch.float32)
    assert not supports_fused(m, torch.float64)
    b = np.random.default_rng(1).random(m.N)
    res = CudaBackend("secded", device="cpu").solve(m, b, MAX_ITRS, CONV)
    assert res.corrected_count == 1 and not res.failed
    assert res.messages[0].startswith("[ECC] corrected bit")
    w, code, _ = CudaBackend("secded", device="cpu").spmv_once(m, res.x)
    assert code == 0 and np.abs(w - b).max() < 1e-3
    # float64 never reaches kernel B: the target rejects it up front.
    with pytest.raises(ValueError, match="f64"):
        CudaBackend("secded", device="cpu").solve(m, b, MAX_ITRS, CONV,
                                                  dtype="f64")


@pytest.mark.parametrize("trigged,st1,consumed,stuck", [
    (True, SpmvStats(), False, 0), (True, SpmvStats(), False, 1),
    (True, SpmvStats(), True, 1), (False, SpmvStats(), False, 1),
    (True, SpmvStats(corrected_count=1, first_cor_slot=4), False, 1),
    (True, SpmvStats(errcode=ERR_SED, err_slot=3), False, 1)])
def test_phantom_guard_matches(trigged, st1, consumed, stuck):
    jst = jcg.SpmvStats(*(jnp.int32(v) for v in st1))
    jout, jstuck = jcg._phantom_guard(jnp.bool_(trigged), jst,
                                      jnp.bool_(consumed), jnp.int32(stuck))
    tout, tstuck = cg._phantom_guard(trigged, st1, consumed, stuck)
    assert tuple(tout) == jstats(jout) and tstuck == int(jstuck)
    if stuck == 1 and trigged and not consumed and st1 == SpmvStats():
        assert tout.errcode == ERR_PHANTOM



# --------------------------------------------------------------------------
# The banded-ELL layout: kernel D's plain loop and the f64 CG loop
# --------------------------------------------------------------------------

def ell_matrix(mode, shape="dense-radius"):
    """dense-radius-3d at side 10 (R = 1024, K = 175) or the shuffled
    tridiagonal forced to ELL under its RCM permutation (the gidx
    plane), both inside the Pallas megakernel's envelope."""
    if shape == "dense-radius":
        rows, cols, vals, n = dense_radius_3d(side=10)
        m = build_protected("csr", assemble(cols, rows, vals, n, 1), mode)
    else:
        rows, cols, vals, n = shuffle_labels(*spd_tridiagonal(1024), seed=11)
        m = build_protected("csr", assemble(cols, rows, vals, n, 1), mode,
                            force_exec="ell")
    assert m.exec_kind == "ell" and m.R % 1024 == 0
    return m


ELL_FUSED_CASES = FUSED_CASES + [
    ("permuted-clean", "secded", 0, 0, 0, 0),
    ("permuted-corrected", "sec8", 1, 6, 0, 1),
]


@pytest.mark.parametrize("case,mode,flips,seed,err,cor", ELL_FUSED_CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in ELL_FUSED_CASES])
def test_fused_ell_matches_pallas_megakernel(case, mode, flips, seed, err,
                                             cor):
    """Kernel D's plain loop vs the ELL branch of the Pallas megakernel in
    interpret mode: the same iterations and ABFT events, the trace to
    rtol 1e-4 (reduction order)."""
    m = ell_matrix(mode, "permuted" if case.startswith("permuted")
                   else "dense-radius")
    if flips:
        m = inject(m, flips, seed)
    jr, tr = run_both_fused(m, mode)
    assert_same_solve(jr, tr)
    assert tr.stats.errcode == err and tr.stats.corrected_count == cor
    if err == 0:
        np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x),
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("mode,flips,seed", CG_CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in CG_CASES])
def test_cg_f64_ell_matches_jnp(mode, flips, seed):
    """The per-iteration loop of the torch target on the ELL layout,
    float64, against the jnp solver."""
    m = ell_matrix(mode)
    if flips:
        m = inject(m, flips, seed)
    b = bvec(m).astype(np.float64)
    jr = jax.jit(jcg.make_cg_solver(jmake_spmv(m, jnp.float64, mode),
                                    MAX_ITRS, CONV))(
        jmake_md(m, jnp.float64), jnp.asarray(b))
    tr = cg.make_cg_solver(make_spmv(m, torch.float64, mode), MAX_ITRS,
                           CONV)(make_matrix_device(m, torch.float64, CPU),
                                 torch.tensor(b))
    assert_same_solve(jr, tr, rtol=1e-12)
    np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x), rtol=1e-12,
                               atol=1e-14)


def test_cuda_backend_routes_ell_to_fused_on_cpu_tensors():
    """The cuda target on a permuted ELL matrix, run on a CPU device:
    kernel D's plain loop, the correction message with the canonical
    index, and the answer in canonical order."""
    m = inject(ell_matrix("secded", "permuted"), 1, 6)
    assert supports_fused(m, torch.float32) and m.perm is not None
    b = np.random.default_rng(1).random(m.N)
    res = CudaBackend("secded", device="cpu").solve(m, b, MAX_ITRS, CONV)
    assert res.corrected_count == 1 and not res.failed
    assert res.messages[0].startswith("[ECC] corrected")
    w, code, _ = CudaBackend("secded", device="cpu").spmv_once(m, res.x)
    assert code == 0 and np.abs(w - b).max() < 1e-3
