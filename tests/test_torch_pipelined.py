"""The port's pipelined CG (solver/pipelined.py) against the JAX
package's, the ports of tests/test_pipelined.py.

Float64 on the CPU (``-t torch`` against ``-t jnp``), the 96-row
tridiagonal in three blocks: iterations, stats and messages equal, x
within rtol 1e-10 of JAX's pipelined solve and the rr trace within rtol
1e-8 above 1e-12 of its first value (the same recurrences, their sums
in another order: rounding that the recurred products carry from
iteration to iteration, 5e-10 relative at rr ~ 1e-12), and within the
port the JAX test's bounds against the standard solver.  The cuda
target's routing runs on CPU tensors here (the kernels' plain versions):
its pipelined solve over ``make_cuda_spmv`` equals the torch target's
float32 one bit for bit.
"""

import numpy as np
import pytest
import torch

from abft_sparse_cg_tpu.backends import create as jcreate
from abft_sparse_cg_tpu.formats import assemble as jassemble
from abft_sparse_cg_tpu.formats import build_protected as jbuild
from abft_sparse_cg_tpu.inject import inject_bitflips as jinject
from abft_sparse_cg_tpu.utils.matgen import spd_laplacian_2d, spd_tridiagonal
from abft_sparse_cg_tpu_torch.backends.cuda_backend import CudaBackend
from abft_sparse_cg_tpu_torch.backends.torch_backend import TorchBackend
from abft_sparse_cg_tpu_torch.formats import assemble, build_protected
from abft_sparse_cg_tpu_torch.inject import inject_bitflips
from abft_sparse_cg_tpu_torch.ops.spmv import ERR_BREAKDOWN

torch.set_num_threads(1)


def both(mode="none", n=96, blocks=3, fmt="csr", tri=None):
    rows, cols, vals, n = tri or spd_tridiagonal(n)
    return (jbuild(fmt, jassemble(cols, rows, vals, n, blocks), mode),
            build_protected(fmt, assemble(cols, rows, vals, n, blocks),
                            mode))


def inject_both(jm, tm, kind, flips, seed):
    quiet = dict(echo=lambda s: None)
    return (jinject(jm, kind, flips, np.random.default_rng(seed), **quiet),
            inject_bitflips(tm, kind, flips, np.random.default_rng(seed),
                            **quiet))


def solve_both(jm, tm, b, max_itrs, conv, **kw):
    """(JAX's, the port's) float64 pipelined solve of the same system."""
    jr = jcreate("jnp", tm.mode).solve(jm, b, max_itrs, conv, verbose=False,
                                       dtype="f64", solver="pipelined", **kw)
    tr = TorchBackend(tm.mode).solve(tm, b, max_itrs, conv,
                                     solver="pipelined", **kw)
    return jr, tr


def assert_same(jr, tr):
    assert (tr.iterations, tr.errcode, tr.corrected_count, tr.messages) == \
        (jr.iterations, jr.errcode, jr.corrected_count, jr.messages)
    it = tr.iterations
    np.testing.assert_allclose(tr.rr_trace[:it], jr.rr_trace[:it],
                               rtol=1e-8, atol=1e-12 * jr.rr_trace[0])
    if not tr.failed:
        np.testing.assert_allclose(tr.x, jr.x, rtol=1e-10, atol=1e-14)


@pytest.mark.parametrize("fmt", ["csr", "coo"])
@pytest.mark.parametrize("mode", ["none", "sed", "sec8", "secded"])
def test_pipelined_matches_standard(fmt, mode):
    jm, tm = both(mode, fmt=fmt)
    b = np.random.default_rng(404).random(tm.N)
    jr, pip = solve_both(jm, tm, b, 500, 1e-12)
    assert_same(jr, pip)
    std = TorchBackend(mode).solve(tm, b, 500, 1e-12)
    assert not std.failed and not pip.failed
    # The same Krylov process in exact arithmetic (tests/test_pipelined.py
    # bounds): one iteration apart at most, x to 1e-8, the shared trace.
    assert abs(pip.iterations - std.iterations) <= 1
    np.testing.assert_allclose(pip.x, std.x, rtol=1e-8, atol=1e-12)
    k = min(std.iterations, pip.iterations) - 1
    np.testing.assert_allclose(pip.rr_trace[:k], std.rr_trace[:k],
                               rtol=1e-6)


def test_pipelined_solves_laplacian():
    jm, tm = both("secded", blocks=2, tri=spd_laplacian_2d(14))
    b = np.random.default_rng(1).random(tm.N)
    jr, res = solve_both(jm, tm, b, 2000, 1e-16)
    assert_same(jr, res)
    assert not res.failed
    rows, cols, vals, n = spd_laplacian_2d(14)
    a = assemble(cols, rows, vals, n, 2)
    d = np.zeros((a.N, a.N))
    d[a.rows, a.cols] = a.values
    np.testing.assert_allclose(d @ res.x, b, atol=1e-6)


def test_pipelined_corrects_injected_fault():
    """Trigger, classify, restart the recurrences: every seed's fault is
    repaired before an update consumes it, so the solve equals the clean
    one, and JAX's solve of the faulted matrix."""
    jm, tm = both("secded")
    b = np.random.default_rng(2).random(tm.N)
    _, clean = solve_both(jm, tm, b, 500, 1e-10)
    assert not clean.failed and clean.corrected_count == 0
    for seed in range(4):
        jm2, tm2 = inject_both(jm, tm, "ANY", 1, seed)
        jr, res = solve_both(jm2, tm2, b, 500, 1e-10)
        assert_same(jr, res)
        assert not res.failed and res.corrected_count == 1, seed
        np.testing.assert_allclose(res.x, clean.x, rtol=1e-12)
        assert res.iterations == clean.iterations


def test_pipelined_sed_detects_and_halts():
    jm, tm = both("sed")
    jm2, tm2 = inject_both(jm, tm, "ANY", 1, 1)
    b = np.random.default_rng(3).random(tm.N)
    jr, res = solve_both(jm2, tm2, b, 500, 1e-10)
    assert_same(jr, res)
    assert res.failed and res.errcode == 1
    assert any("error detected at index" in s for s in res.messages)


def test_pipelined_breakdown_guard():
    n = 32
    idx = np.arange(n)
    jm = jbuild("csr", jassemble(idx, idx, -np.ones(n), n, 1), "none")
    tm = build_protected("csr", assemble(idx, idx, -np.ones(n), n, 1),
                         "none")
    b = np.random.default_rng(4).random(n)
    jr, res = solve_both(jm, tm, b, 100, 1e-10)
    assert_same(jr, res)
    assert res.failed and res.errcode == ERR_BREAKDOWN


def test_pipelined_sharded_matches():
    """--devices 8: the single-device program on the mesh-padded planes,
    as JAX's GSPMD program computes it."""
    jm, tm = both("secded", n=64, blocks=4)
    b = np.random.default_rng(5).random(tm.N)
    single = TorchBackend("secded").solve(tm, b, 300, 1e-10,
                                          solver="pipelined")
    jr, shard = solve_both(jm, tm, b, 300, 1e-10, devices=8)
    assert_same(jr, shard)
    assert not shard.failed and shard.iterations == single.iterations
    np.testing.assert_allclose(shard.x, single.x, rtol=1e-12)


def test_pipelined_rejects_preconditioner():
    jm, tm = both("none", n=32, blocks=1)
    b = np.random.default_rng(6).random(tm.N)
    with pytest.raises(ValueError) as je:
        jcreate("jnp", "none").solve(jm, b, 100, 1e-8, verbose=False,
                                     dtype="f64", solver="pipelined",
                                     precond="jacobi")
    with pytest.raises(ValueError) as te:
        TorchBackend("none").solve(tm, b, 100, 1e-8, solver="pipelined",
                                   precond="jacobi")
    assert str(te.value) == str(je.value)


def test_checkpoint_with_pipelined_is_refused():
    """jnp_backend.py:104-107: the pipelined recurrence carries state a
    snapshot cannot re-seed."""
    jm, tm = both("none", n=32, blocks=1)
    b = np.random.default_rng(7).random(tm.N)
    with pytest.raises(ValueError) as je:
        jcreate("jnp", "none").solve(jm, b, 100, 1e-8, verbose=False,
                                     dtype="f64", solver="pipelined",
                                     checkpoint="unused.npz")
    with pytest.raises(ValueError) as te:
        TorchBackend("none").solve(tm, b, 100, 1e-8, solver="pipelined",
                                   checkpoint="unused.npz")
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("mode,flips", [("none", 0), ("secded", 1),
                                        ("sed", 1)])
def test_cuda_routing_on_cpu_tensors(mode, flips):
    """The cuda target's pipelined solve (over make_cuda_spmv: kernels A,
    C and E, here their plain versions on CPU tensors) in float32 equals
    the torch target's float32 pipelined solve bit for bit; a check
    interval warns and runs live, 'auto' runs live silently."""
    _, tm = both(mode, n=1024, blocks=1)
    if flips:
        tm = inject_bitflips(tm, "ANY", flips, np.random.default_rng(3),
                             echo=lambda s: None)
    b = np.random.default_rng(8).random(tm.N)
    want = TorchBackend(mode).solve(tm, b, 300, 1e-8, dtype="f32",
                                    solver="pipelined")
    cuda = CudaBackend(mode, device="cpu")
    for ci in (None, "auto", 4):
        got = cuda.solve(tm, b, 300, 1e-8, solver="pipelined",
                         check_interval=ci)
        assert (got.iterations, got.errcode, got.messages) == \
            (want.iterations, want.errcode, want.messages)
        np.testing.assert_array_equal(got.x, want.x)


def test_cuda_pipelined_check_interval_warns(capsys):
    _, tm = both("secded", n=1024, blocks=1)
    b = np.random.default_rng(9).random(tm.N)
    cuda = CudaBackend("secded", device="cpu")
    cuda.solve(tm, b, 300, 1e-8, solver="pipelined", check_interval="auto")
    assert capsys.readouterr().err == ""
    cuda.solve(tm, b, 300, 1e-8, solver="pipelined", check_interval=4)
    assert capsys.readouterr().err == (
        "warning: --check-interval has no pipelined-solver variant; "
        "running the live detection schedule\n")
