"""The port's DIA and ELL SpMV (ops.spmv, ops.spmv_cuda) against the JAX
package.

Inputs: the 1024-row SPD tridiagonal of tests/test_fused.py (DIA, and
label-shuffled and forced to ELL under its RCM permutation), the
dense-radius-3d zoo family at side 10 (ELL, K = 175), a seeded x, and
seeded 1-/2-bit injections; each in CSR96 codewords and, in the
``coo-`` cases, COO128 (cg-coo: the ELL product gathers from the row
word, and constraints mode streams the col and the row word, each
against its own baseline), with cg-coo's index faults beside them: a
row-word flip and, in constraints mode, the 4-bit col/row fault whose
rotated fold is zero (utils/coo_faults.py).  Kernels A's and C's plain versions are
held against the Pallas kernels run in interpret mode; classify and the
float64 ``full`` oracle against the jnp implementation.  Tolerances:
w rtol 1e-6 and pw rtol 1e-5 in float32 (the products sum in the same
order as the TPU kernels' up to float32 rounding of the slot sum, and pw
is reduced in another order); the float64 oracle 1e-12.
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
from abft_sparse_cg_tpu.ops.spmv_pallas import make_pallas_spmv
from abft_sparse_cg_tpu.utils.matgen import shuffle_labels, spd_tridiagonal
from abft_sparse_cg_tpu.utils.matzoo import (
    arrowhead,
    blockdiag_random,
    dense_radius_3d,
)
from abft_sparse_cg_tpu_torch.convert import matrix_device_from_numpy
from abft_sparse_cg_tpu_torch.ecc.codec import to_numpy_u32
from abft_sparse_cg_tpu_torch.ops.spmv import (
    ell_product,
    make_matrix_device,
    make_spmv,
)
from abft_sparse_cg_tpu_torch.ops.spmv_cuda import (
    dia_fast,
    dia_fast_plain,
    dia_spec,
    ell_fast,
    ell_fast_plain,
    ell_gather_plane,
    ell_spec,
    make_cuda_spmv,
)
from abft_sparse_cg_tpu_torch.utils.coo_faults import (
    col_row_fault,
    row_word_flip,
)

MODES = ["none", "constraints", "sed", "sec7", "sec8", "secded"]
CPU = torch.device("cpu")
# Small eager CPU tensors: one intra-op thread per process, so that
# parallel test workers do not oversubscribe the cores.
torch.set_num_threads(1)
ECC = ["sed", "sec7", "sec8", "secded"]
COO_FAULTS = ("row word", "4bit col/row")


def fmt_params(modes):
    """Each mode as a CSR96 case (its id the mode's name) and a COO128
    one (``coo-<mode>``)."""
    return ([pytest.param("csr", m, id=m) for m in modes]
            + [pytest.param("coo", m, id=f"coo-{m}") for m in modes])


def coo_faults(m, mode):
    """cg-coo's index faults of a COO128 matrix: a row-word flip (in
    constraints mode only the second signal plane sees it) and, in
    constraints mode, the 4-bit col/row fault; none for CSR96."""
    if m.fmt != "coo" or mode == "none":
        return []
    out = [("row word", row_word_flip(m, m.nnz // 3 + 1))]
    if mode == "constraints":
        out.append(("4bit col/row", col_row_fault(m, m.nnz // 3)))
    return out


def dia_matrix(mode, n=1024, fmt="csr"):
    rows, cols, vals, n = spd_tridiagonal(n)
    m = build_protected(fmt, assemble(cols, rows, vals, n, 1), mode)
    assert m.exec_kind == "dia" and m.dia_offsets == (-1, 0, 1)
    return m


def cases(mode, fmt="csr"):
    """(label, matrix): clean plus the faults the mode is built for."""
    m = dia_matrix(mode, fmt=fmt)
    out = [("clean", m)]
    if mode in ECC:
        for flips, seed in ((1, 31), (2, 32), (1, 33)):
            out.append((f"{flips}bit-s{seed}", inject_bitflips(
                m, "ANY", flips, np.random.default_rng(seed),
                echo=lambda s: None)))
    if mode == "constraints":
        out.append(("index", inject_bitflips(
            m, "INDEX", 1, np.random.default_rng(34), echo=lambda s: None)))
    return out + coo_faults(m, mode)


def xvec(m, dtype=np.float32, seed=5):
    return np.random.default_rng(seed).random(m.R).astype(dtype)


def jfields(jmd):
    return {k: (None if v is None else
                (tuple(np.asarray(w) for w in v) if k == "words"
                 else np.asarray(v)))
            for k, v in jmd._asdict().items()}


def assert_md_equal(jmd, tmd):
    for a, b in zip(jmd.words, tmd.words):
        np.testing.assert_array_equal(np.asarray(a), to_numpy_u32(b))
    np.testing.assert_array_equal(np.asarray(jmd.cksum),
                                  to_numpy_u32(tmd.cksum))
    jv = np.asarray(jmd.values)
    np.testing.assert_array_equal(tmd.values.numpy().view(jv.dtype), jv)
    if jmd.fold is None:
        assert tmd.fold is None and tmd.fold_ck is None
    else:
        np.testing.assert_array_equal(np.asarray(jmd.fold),
                                      to_numpy_u32(tmd.fold))
        np.testing.assert_array_equal(np.asarray(jmd.fold_ck),
                                      to_numpy_u32(tmd.fold_ck))


@pytest.mark.parametrize("fmt,mode", fmt_params(MODES))
def test_matrix_device_bit_exact(fmt, mode):
    for _, m in cases(mode, fmt):
        for jdt, tdt in ((jnp.float32, torch.float32),
                         (jnp.float64, torch.float64)):
            assert_md_equal(jmake_md(m, jdt), make_matrix_device(m, tdt, CPU))


@pytest.mark.parametrize("fmt,mode", fmt_params(MODES))
def test_dia_fast_plain_matches_pallas_kernel(fmt, mode):
    """Kernel A's plain version vs spmv_pallas._make_dia_fast (interpret):
    same w, pw and trigger, clean and under injected faults."""
    all_cases = cases(mode, fmt)
    # Faults change plane contents, never structure: one compile serves
    # every case.
    kernel = jax.jit(make_pallas_spmv(all_cases[0][1], jnp.float32, mode,
                                      interpret=True).fast_pw)
    for label, m in all_cases:
        x = xvec(m)
        jw, jtrig, jpw = kernel(jmake_md(m, jnp.float32), jnp.asarray(x))
        spec = dia_spec(m, mode)
        tw, ttrig, tpw = dia_fast(make_matrix_device(m, torch.float32, CPU),
                                  torch.tensor(x), spec)
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6,
                                   err_msg=label)
        np.testing.assert_allclose(float(tpw), float(jpw), rtol=1e-5,
                                   err_msg=label)
        assert bool(ttrig) == bool(jtrig), (mode, label)
        if label == "clean":
            assert not bool(ttrig)
        elif mode in ("sec7", "secded") or label.startswith("1bit") \
                or label == "index" or label in COO_FAULTS:
            assert bool(ttrig), (mode, label)


def test_dia_fast_takes_plain_version_only_on_cpu():
    m = dia_matrix("secded")
    md = make_matrix_device(m, torch.float32, CPU)
    spec = dia_spec(m, "secded")
    x = torch.tensor(xvec(m))
    before = dia_fast.launches
    out = dia_fast(md, x, spec)
    ref = dia_fast_plain(md, x, spec)
    assert dia_fast.launches == before  # the plain path counts nothing
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        dia_fast(md, x.to("meta"), spec)


@pytest.mark.parametrize("fmt,mode", fmt_params(["constraints"] + ECC))
def test_classify_bit_exact(fmt, mode):
    """Stats and scrubbed planes vs the jnp classify, on the JAX
    MatrixDevice carried over by convert.matrix_device_from_numpy."""
    all_cases = cases(mode, fmt)
    jclassify = jax.jit(jmake_spmv(all_cases[0][1], jnp.float32,
                                   mode).classify)
    for label, m in all_cases:
        jmd = jmake_md(m, jnp.float32)
        jst, jmd2 = jclassify(jmd)
        tmd = matrix_device_from_numpy(jfields(jmd), CPU)
        tst, tmd2 = make_spmv(m, torch.float32, mode).classify(tmd)
        assert tuple(tst) == tuple(int(v) for v in jst), (mode, label)
        assert_md_equal(jmd2, tmd2)


@pytest.mark.parametrize("fmt,mode", fmt_params(MODES))
def test_full_f64_matches_jnp(fmt, mode):
    all_cases = cases(mode, fmt)
    jfull = jax.jit(jmake_spmv(all_cases[0][1], jnp.float64, mode).full)
    for label, m in all_cases:
        x = xvec(m, np.float64)
        jw, jst = jfull(jmake_md(m, jnp.float64), jnp.asarray(x))
        tw, tst = make_spmv(m, torch.float64, mode).full(
            make_matrix_device(m, torch.float64, CPU), torch.tensor(x))
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-12,
                                   atol=1e-12, err_msg=label)
        assert tuple(tst) == tuple(int(v) for v in jst), (mode, label)


@pytest.mark.parametrize("mode", MODES)
def test_cuda_impl_full_matches_plain_on_cpu(mode):
    """The cuda SpmvImpl's full (kernel A in none/constraints, the plain
    oracle in the ECC modes) agrees with the plain impl."""
    for label, m in cases(mode):
        md = make_matrix_device(m, torch.float32, CPU)
        x = torch.tensor(xvec(m))
        w1, s1 = make_cuda_spmv(m, torch.float32, mode).full(md, x)
        w2, s2 = make_spmv(m, torch.float32, mode).full(md, x)
        torch.testing.assert_close(w1, w2, rtol=0, atol=0)
        assert s1 == s2, (mode, label)


@pytest.mark.parametrize("fmt,mode", fmt_params(MODES))
def test_cuda_impl_full_matches_pallas_full(fmt, mode):
    """``spmv_once``'s path: the cuda SpmvImpl's full (kernel A's plain
    version on CPU tensors in none/constraints, the check-and-correct
    oracle in the ECC modes) vs make_pallas_spmv(...).full in interpret
    mode, float32, clean and under injected faults."""
    all_cases = cases(mode, fmt)
    jfull = jax.jit(make_pallas_spmv(all_cases[0][1], jnp.float32, mode,
                                     interpret=True).full)
    for label, m in all_cases:
        x = xvec(m)
        jw, jst = jfull(jmake_md(m, jnp.float32), jnp.asarray(x))
        tw, tst = make_cuda_spmv(m, torch.float32, mode).full(
            make_matrix_device(m, torch.float32, CPU), torch.tensor(x))
        assert tuple(tst) == tuple(int(v) for v in jst), (mode, label)
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6,
                                   err_msg=label)


def test_non_dia_layouts_not_ported():
    """The layouts this package refused before the flat and split ports:
    a bordered matrix the JAX build splits and a K = 729 one it lays out
    flat now upload and multiply; the float64 oracle equals the jnp one
    (tests/test_torch_flat.py holds them in every mode)."""
    for kind, (rows, cols, vals, n) in (
            ("split", arrowhead(n=2048)),
            ("flat", dense_radius_3d(side=10, rx=4, ry=4, rz=4))):
        m = build_protected("csr", assemble(cols, rows, vals, n, 1),
                            "secded")
        assert m.exec_kind == kind
        x = xvec(m, np.float64)
        jw, jst = jax.jit(jmake_spmv(m, jnp.float64, "secded").full)(
            jmake_md(m, jnp.float64), jnp.asarray(x))
        tw, tst = make_spmv(m, torch.float64, "secded").full(
            make_matrix_device(m, torch.float64, CPU), torch.tensor(x))
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-12,
                                   atol=1e-12)
        assert tuple(tst) == tuple(int(v) for v in jst)


# --------------------------------------------------------------------------
# The banded-ELL layout: kernel C's plain version, classify, the oracle
# --------------------------------------------------------------------------

def ell_matrix(shape, mode, fmt="csr"):
    """dense-radius-3d at side 10 (N = 1000, K = 175, band 223) or the
    shuffled tridiagonal forced to ELL under its RCM permutation."""
    if shape == "dense-radius":
        rows, cols, vals, n = dense_radius_3d(side=10)
        m = build_protected(fmt, assemble(cols, rows, vals, n, 1), mode)
    else:
        rows, cols, vals, n = shuffle_labels(*spd_tridiagonal(1024), seed=11)
        m = build_protected(fmt, assemble(cols, rows, vals, n, 1), mode,
                            force_exec="ell")
        assert (m.perm is not None) == (mode != "constraints")
    assert m.exec_kind == "ell" and m.R <= 4096
    return m


def ell_cases(shape, mode, fmt="csr"):
    m = ell_matrix(shape, mode, fmt)
    out = [("clean", m)]
    for flips, seed in ((1, 31), (2, 32), (1, 33), (1, 35)):
        out.append((f"{flips}bit-s{seed}", inject_bitflips(
            m, "ANY", flips, np.random.default_rng(seed),
            echo=lambda s: None)))
    out.append(("index", inject_bitflips(
        m, "INDEX", 1, np.random.default_rng(34), echo=lambda s: None)))
    return out + coo_faults(m, mode)


def moved_rows(m0, m1):
    """Rows whose gather word differs between two builds."""
    g0, g1 = m0.ell[m0.ell_gather_word], m1.ell[m1.ell_gather_word]
    return np.unique(np.nonzero(g0 != g1)[1])


ELL_SHAPES = ["dense-radius", "permuted"]


@pytest.mark.parametrize("fmt,mode", fmt_params(MODES))
@pytest.mark.parametrize("shape", ELL_SHAPES)
def test_ell_matrix_device_bit_exact(shape, fmt, mode):
    for _, m in ell_cases(shape, mode, fmt)[:3]:
        for jdt, tdt in ((jnp.float32, torch.float32),
                         (jnp.float64, torch.float64)):
            jmd, tmd = jmake_md(m, jdt), make_matrix_device(m, tdt, CPU)
            assert_md_equal(jmd, tmd)
            np.testing.assert_array_equal(np.asarray(jmd.ell_len),
                                          tmd.ell_len.numpy())
            for f in ("gidx", "perm_pos"):
                a, b = getattr(jmd, f), getattr(tmd, f)
                assert (a is None) == (b is None), f
                if a is not None:
                    np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("fmt,mode", fmt_params(MODES))
@pytest.mark.parametrize("shape", ELL_SHAPES)
def test_ell_fast_plain_matches_pallas_kernel(shape, fmt, mode):
    """Kernel C's plain version vs spmv_pallas._make_ellb_fast run in
    interpret mode: the same trigger, w within 1e-6 of each row's
    absolute sum sum_k |v x| (the two sum up to 175 slots in another
    float32 order, and the rows of dense-radius-3d cancel to ~1/4 of
    that sum) and pw within 1e-5, clean and under injected faults.  A fault that moves a gather index outside the TPU kernel's
    row window is clamped to that window there and globally here (the
    jnp oracle's rule, ROADMAP.md queue 3): rows whose index moved are
    held against the jnp ``fast`` instead."""
    all_cases = ell_cases(shape, mode, fmt)
    m0 = all_cases[0][1]
    kernel = jax.jit(make_pallas_spmv(m0, jnp.float32, mode,
                                      interpret=True).fast_pw)
    jfast = jax.jit(jmake_spmv(m0, jnp.float32, mode).fast_pw)
    spec = ell_spec(m0, mode)
    for label, m in all_cases:
        x = xvec(m)
        jmd = jmake_md(m, jnp.float32)
        jw, jtrig, jpw = (np.asarray(v) for v in kernel(jmd, jnp.asarray(x)))
        ow, _, opw = (np.asarray(v) for v in jfast(jmd, jnp.asarray(x)))
        tw, ttrig, tpw = ell_fast(make_matrix_device(m, torch.float32, CPU),
                                  torch.tensor(x), spec)
        tw = tw.numpy()
        md64 = make_matrix_device(m, torch.float64, CPU)
        absw = ell_product(md64.values.abs(), ell_gather_plane(md64, spec),
                           md64.ell_len, torch.tensor(x, dtype=torch.float64)
                           ).numpy()
        moved = moved_rows(m0, m)
        want = jw.copy()
        want[moved] = ow[moved]
        fin = np.isfinite(want)
        np.testing.assert_array_equal(np.isfinite(tw), fin, err_msg=label)
        assert np.all(np.abs(tw - want)[fin] <= 1e-6 * absw[fin]), label
        np.testing.assert_allclose(float(tpw), float(opw if len(moved)
                                                     else jpw), rtol=1e-5,
                                   err_msg=label)
        assert bool(ttrig) == bool(jtrig), (mode, label)
        if label == "clean" or mode == "none":
            assert not bool(ttrig), (mode, label)
        elif label in COO_FAULTS:
            assert bool(ttrig), (mode, label)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", ELL_SHAPES)
def test_ell_full_f64_matches_jnp(shape, mode):
    all_cases = ell_cases(shape, mode)
    jfull = jax.jit(jmake_spmv(all_cases[0][1], jnp.float64, mode).full)
    for label, m in all_cases:
        x = xvec(m, np.float64)
        jw, jst = jfull(jmake_md(m, jnp.float64), jnp.asarray(x))
        tw, tst = make_spmv(m, torch.float64, mode).full(
            make_matrix_device(m, torch.float64, CPU), torch.tensor(x))
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-12,
                                   atol=1e-12, err_msg=label)
        assert tuple(tst) == tuple(int(v) for v in jst), (mode, label)


@pytest.mark.parametrize("fmt,mode", fmt_params(["constraints"] + ECC))
@pytest.mark.parametrize("shape", ELL_SHAPES)
def test_ell_classify_bit_exact(shape, fmt, mode):
    """Stats and scrubbed planes (values, checksums, fold, and the gidx
    plane re-derived through perm_pos) vs the jnp classify."""
    all_cases = ell_cases(shape, mode, fmt)
    jclassify = jax.jit(jmake_spmv(all_cases[0][1], jnp.float32,
                                   mode).classify)
    for label, m in all_cases:
        jmd = jmake_md(m, jnp.float32)
        jst, jmd2 = jclassify(jmd)
        tmd = matrix_device_from_numpy(jfields(jmd), CPU)
        tst, tmd2 = make_spmv(m, torch.float32, mode).classify(tmd)
        assert tuple(tst) == tuple(int(v) for v in jst), (mode, label)
        assert_md_equal(jmd2, tmd2)
        if jmd2.gidx is not None:
            np.testing.assert_array_equal(np.asarray(jmd2.gidx),
                                          tmd2.gidx.numpy())


@pytest.fixture(scope="module")
def clamp_matrix():
    rows, cols, vals, n = blockdiag_random(n=600)
    m = build_protected("csr", assemble(cols, rows, vals, n, 1), "none")
    assert m.exec_kind == "ell"
    return m


@pytest.mark.parametrize("bit", range(32))
def test_ell_out_of_range_index_clamps_like_jnp(clamp_matrix, bit):
    """Mode none gathers with the raw col word: flip each of its 32 bits
    in one element (bit 31 makes the int32 index negative) and hold the
    port's products against the jnp oracle's clamped gather: float64 to
    1e-12, and kernel C's plain version in float32 to 1e-6 of each row's
    absolute sum (summation order)."""
    m = clamp_matrix
    words = m.words_list()
    idx = m.nnz // 2
    cw = m.layout.col_word
    words[cw] = words[cw].copy()
    words[cw][idx] ^= np.uint32(1 << bit)
    mf = m.with_planes(dict(zip(m.layout.word_names, words)))
    x = xvec(mf, np.float64)
    jw, _ = jax.jit(jmake_spmv(mf, jnp.float64, "none").full)(
        jmake_md(mf, jnp.float64), jnp.asarray(x))
    tw, _ = make_spmv(mf, torch.float64, "none").full(
        make_matrix_device(mf, torch.float64, CPU), torch.tensor(x))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-12,
                               atol=1e-12)
    x32 = x.astype(np.float32)
    jw32, _ = jax.jit(jmake_spmv(mf, jnp.float32, "none").full)(
        jmake_md(mf, jnp.float32), jnp.asarray(x32))
    spec = ell_spec(mf, "none")
    kw, _, _ = ell_fast(make_matrix_device(mf, torch.float32, CPU),
                        torch.tensor(x32), spec)
    md64 = make_matrix_device(mf, torch.float64, CPU)
    absw = ell_product(md64.values.abs(), ell_gather_plane(md64, spec),
                       md64.ell_len, torch.tensor(x)).numpy()
    assert np.all(np.abs(kw.numpy() - np.asarray(jw32)) <= 1e-6 * absw)


def test_ell_fast_takes_plain_version_only_on_cpu():
    m = ell_matrix("dense-radius", "secded")
    md = make_matrix_device(m, torch.float32, CPU)
    spec = ell_spec(m, "secded")
    x = torch.tensor(xvec(m))
    before = ell_fast.launches
    out = ell_fast(md, x, spec)
    ref = ell_fast_plain(md, x, spec)
    assert ell_fast.launches == before
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        ell_fast(md, x.to("meta"), spec)


@pytest.mark.parametrize("mode", MODES)
def test_cuda_impl_full_matches_plain_on_cpu_ell(mode):
    """The cuda SpmvImpl's full on ELL (kernel C's plain version in
    none/constraints, the check-and-correct oracle in the ECC modes)
    agrees with the plain impl."""
    for label, m in ell_cases("permuted", mode):
        md = make_matrix_device(m, torch.float32, CPU)
        x = torch.tensor(xvec(m))
        w1, s1 = make_cuda_spmv(m, torch.float32, mode).full(md, x)
        w2, s2 = make_spmv(m, torch.float32, mode).full(md, x)
        torch.testing.assert_close(w1, w2, rtol=0, atol=0)
        assert s1 == s2, (mode, label)
