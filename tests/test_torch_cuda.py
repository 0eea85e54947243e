"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device.  The
file imports nothing of JAX or of the JAX package, so it also runs where
JAX is not installed:

    PYTHONPATH=. python -m pytest --noconftest -p no:cacheprovider \\
        -m cuda tests/test_torch_cuda.py

Tolerances: w to 1e-6 relative for kernel A and bit-exact for kernels C
and E (both use explicitly rounded multiplies and adds in the plain
version's order), pw and the rr trace to 1e-5 relative (per-block
partials summed in another order than torch.sum); the split tail's rr
trace to 1e-3 above float32's noise floor (its dot products are summed
in fixed chunks, the plain loop's by torch.sum).
"""

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
from abft_sparse_cg_tpu_torch.solver.fused import (
    fused_cg_dia,
    fused_cg_ell,
    make_fused_solver,
)
from abft_sparse_cg_tpu_torch.utils.matgen import (
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


def dia_matrix(mode, n=4096, blocks=2):
    rows, cols, vals, n = spd_tridiagonal(n)
    return build_protected("csr", assemble(cols, rows, vals, n, blocks),
                           mode)


def faulted(m, flips, seed, kind="ANY"):
    return inject_bitflips(m, kind, flips, np.random.default_rng(seed),
                           echo=lambda s: None)


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
        torch.testing.assert_close(wk, wp, rtol=1e-6, atol=0,
                                   equal_nan=True)
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


@pytest.mark.parametrize("mode,flips,seed", [
    ("none", 0, 0), ("constraints", 0, 0), ("secded", 0, 0),
    ("secded", 1, 6), ("sec7", 1, 6), ("sed", 1, 6), ("secded", 2, 3)])
def test_kernel_b_matches_plain(dev, mode, flips, seed):
    m = dia_matrix(mode)
    if flips:
        m = faulted(m, flips, seed)
    b = torch.zeros(m.R, dtype=torch.float32)
    b[: m.N] = torch.tensor(np.random.default_rng(7).random(m.N))
    solve = make_fused_solver(m, mode, 300, 1e-8)
    before = fused_cg_dia.launches
    rk = solve(make_matrix_device(m, torch.float32, dev), b.to(dev))
    assert fused_cg_dia.launches > before
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


def ell_matrix(mode, shape="dense-radius"):
    if shape == "dense-radius":
        rows, cols, vals, n = dense_radius_3d(side=16)
        return build_protected("csr", assemble(cols, rows, vals, n, 2), mode)
    rows, cols, vals, n = shuffle_labels(*spd_tridiagonal(8192), seed=11)
    return build_protected("csr", assemble(cols, rows, vals, n, 1), mode,
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
    rk = solve(make_matrix_device(m, torch.float32, dev), b.to(dev))
    assert fused_cg_ell.launches > before
    rp = solve(make_matrix_device(m, torch.float32, CPU), b)
    assert rk.iterations == rp.iterations
    assert tuple(rk.stats) == tuple(rp.stats)
    it = rk.iterations
    np.testing.assert_allclose(rk.rr_trace[:it].cpu().numpy(),
                               rp.rr_trace[:it].numpy(), rtol=1e-5)
    rk2 = solve(make_matrix_device(m, torch.float32, dev), b.to(dev))
    assert torch.equal(rk2.rr_trace[:it], rk.rr_trace[:it])
    assert torch.equal(rk2.x, rk.x)


# --------------------------------------------------------------------------
# Kernel E, the split tail of kernels B and D, the per-iteration tier
# --------------------------------------------------------------------------

def flat_matrix(mode, shape):
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
    m = build_protected("csr", assemble(cols, rows, vals, n, 1), mode, **kw)
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
        torch.testing.assert_close(wk, wp, rtol=0, atol=0, equal_nan=True)
        torch.testing.assert_close(pk, pp, rtol=1e-5, atol=0,
                                   equal_nan=True)
        assert bool(tk) == bool(tp)


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


def split_matrix(mode, main):
    from abft_sparse_cg_tpu_torch.utils.matzoo import (
        arrowhead,
        blockdiag_random,
    )

    rows, cols, vals, n = (arrowhead(n=8192) if main == "dia"
                           else bordered(blockdiag_random(n=4000)))
    m = build_protected("csr", assemble(cols, rows, vals, n, 1), mode)
    assert m.exec_kind == "split" and m.main.exec_kind == main
    assert m.tail.dense_plan is not None
    return m


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
