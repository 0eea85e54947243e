"""cg-coo in the port against the JAX package: COO128 codewords on every
layout.

COO128 codewords are ``[col, row, value_lo, value_hi]``; execution groups
by column, so the ELL and flat products gather from the row word, with
no ECC mask (PARITY.md).  Constraints mode streams both index words, each
against its own 8-row (flat: 8-slot) block checksum (spmv_pallas.py:
283-298, :459-460): the port's specs carry a second signal plane
(ops.spmv_cuda ``plane2``), which every kernel's two-plane instance
scans.

Inputs, all small and seeded: the 1024-row SPD tridiagonal (DIA, and
forced to ELL), dense-radius-3d at side 8 (ELL, K = 175), a
label-shuffled 2-D Laplacian of side 24 (ELL under its RCM permutation
in the ECC modes; constraints never permutes), powerlaw-graph at n =
2048 (flat, ``split="none"``), band+random-1pct at n = 16384 (band
split), arrowhead at n = 2048 (bordered split) and tests/test_fused.py's
bordered tridiagonal (a dense-plan tail the fused kernels take).
Faults: seeded random flips, and the index faults of
utils/coo_faults.py placed by position — a row-word flip, which in
constraints mode only the second plane sees, and the 4-bit col/row
fault, whose rotated fold is zero.

Held here: both packages' ``build_protected("coo", ...)`` byte for byte
on every layout and mode; the port's upload equal to the JAX
MatrixDevice carried over by convert.matrix_device_from_numpy; the
signal planes in codeword-word order, each against its own baseline;
kernel E's plain version against the JAX flat product (the Pallas Benes
kernel in interpret mode where its plan attaches, else jnp; w to 1e-6
of each row's sum |v x|, pw to 1e-5, the trigger exact); the plain loops
of kernels B and D and of the split tail against the JAX megakernel in
interpret mode (iterations and events exact, the trace to 1e-4, a split
tail's to 1e-3 above float32's noise floor); classify bit-exact on the
flat and split layouts.  Kernels A's and C's plain versions on COO128
are the ``coo-`` cases of tests/test_torch_spmv.py; the CLI's are those
of tests/test_torch_cli.py.
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
from abft_sparse_cg_tpu.ops.spmv_pallas import make_pallas_spmv
from abft_sparse_cg_tpu.solver.fused import make_fused_solver as jfused
from abft_sparse_cg_tpu.utils import matgen as jmatgen
from abft_sparse_cg_tpu.utils import matzoo as jzoo
from abft_sparse_cg_tpu_torch.convert import matrix_device_from_numpy
from abft_sparse_cg_tpu_torch.ecc.codec import to_numpy_u32, widen
from abft_sparse_cg_tpu_torch.ecc.fold import fold_words
from abft_sparse_cg_tpu_torch.formats import assemble, build_protected
from abft_sparse_cg_tpu_torch.ops.spmv import (
    flat_product,
    make_matrix_device,
    make_spmv,
)
from abft_sparse_cg_tpu_torch.ops.spmv_cuda import (
    _signal_planes,
    ell_gather_plane,
    fast_spec,
    flat_fast,
    flat_spec,
    signals_plain,
)
from abft_sparse_cg_tpu_torch.solver.fused import (
    make_fused_solver,
    tail_spec,
)
from abft_sparse_cg_tpu_torch.utils.coo_faults import (
    col_row_fault,
    row_word_flip,
)

MODES = ["none", "constraints", "sed", "sec7", "sec8", "secded"]
ECC = ["sed", "sec7", "sec8", "secded"]
CPU = torch.device("cpu")
MAX_ITRS, CONV = 300, 1e-8
# Small eager CPU tensors: one intra-op thread per process, so that
# parallel test workers do not oversubscribe the cores.
torch.set_num_threads(1)


def bordered():
    """tests/test_fused.py's split_matrix: a 2048-row tridiagonal core
    with two dense rows of 300 entries (a dense-plan tail)."""
    rows, cols, vals, n = jmatgen.spd_tridiagonal(2048)
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


# layout -> (triplet generator, build kwargs, exec kind)
LAYOUTS = {
    "dia": (lambda: jmatgen.spd_tridiagonal(1024), {}, "dia"),
    "ell": (lambda: jzoo.dense_radius_3d(side=8), {}, "ell"),
    "rcm-ell": (lambda: jmatgen.shuffle_labels(
        *jmatgen.spd_laplacian_2d(24), seed=11), {}, "ell"),
    "flat": (lambda: jzoo.powerlaw_graph(n=2048), {"split": "none"},
             "flat"),
    "band-split": (lambda: jzoo.band_plus_random(n=16384), {}, "split"),
    "bordered-split": (lambda: jzoo.arrowhead(n=2048), {}, "split"),
}


def jbuild_coo(tri, mode, **kw):
    rows, cols, vals, n = tri
    return jbuild("coo", jassemble(cols, rows, vals, n, 1), mode, **kw)


def build_coo(tri, mode, **kw):
    rows, cols, vals, n = tri
    return build_protected("coo", assemble(cols, rows, vals, n, 1), mode,
                           **kw)


def layout_matrix(layout, mode):
    make, kw, kind = LAYOUTS[layout]
    m = jbuild_coo(make(), mode, **kw)
    assert m.fmt == "coo" and m.exec_kind == kind
    return m


def coo_faults(m, mode):
    """(label, matrix): clean, a seeded 1-bit flip, and the positioned
    index faults (a row-word flip; the 4-bit col/row fault in
    constraints mode)."""
    out = [("clean", m), ("1bit", inject_bitflips(
        m, "ANY", 1, np.random.default_rng(31), echo=lambda s: None))]
    if mode != "none":
        out.append(("row word", row_word_flip(m, m.nnz // 3 + 1)))
    if mode == "constraints":
        out.append(("4bit col/row", col_row_fault(m, m.nnz // 3)))
    return out


def xvec(m, dtype=np.float32, seed=5):
    return np.random.default_rng(seed).random(m.R).astype(dtype)


FIELDS = ("ell_len", "ell_slot", "ell_cksum", "flat_cksum", "dia_offsets",
          "perm", "band", "exec_kind", "N", "nnz", "K", "R")


def assert_same_routing(jm, tm):
    """Byte-identical builds: planes, exec planes, slot maps, checksums,
    the dense plan, a split's parts and its index maps."""
    assert tm.exec_kind == jm.exec_kind and tm.fmt == jm.fmt == "coo"
    if jm.exec_kind == "split":
        for part in ("main", "tail"):
            assert_same_routing(getattr(jm, part), getattr(tm, part))
        for f in ("idx_main", "idx_tail", "flat_cksum"):
            a, b = getattr(jm, f), getattr(tm, f)
            assert (a is None) == (b is None), f
            assert a is None or np.array_equal(a, b), f
        np.testing.assert_array_equal(tm.slot_to_canonical(),
                                      jm.slot_to_canonical())
        return
    for name in ("planes", "ell"):
        a, b = getattr(jm, name), getattr(tm, name)
        assert list(a) == list(b), name
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), \
                (name, k)
    for f in FIELDS:
        a, b = getattr(jm, f), getattr(tm, f)
        if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            assert (a is None) == (b is None), f
            assert a is None or (a.dtype == b.dtype
                                 and np.array_equal(a, b)), f
        else:
            assert a == b, f
    assert tm.dense_plan == jm.dense_plan
    assert tm.layout.word_names == jm.layout.word_names \
        == ("col", "row", "value_lo", "value_hi")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_coo_build_byte_identical(layout, mode):
    make, kw, kind = LAYOUTS[layout]
    tri = make()
    jm, tm = jbuild_coo(tri, mode, **kw), build_coo(tri, mode, **kw)
    assert tm.exec_kind == kind
    if layout == "rcm-ell":
        assert (tm.perm is not None) == (mode != "constraints")
    assert_same_routing(jm, tm)


def jfields(jmd):
    return {k: (None if v is None else
                (tuple(np.asarray(w) for w in v) if k == "words"
                 else np.asarray(v)))
            for k, v in jmd._asdict().items()}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("layout", ["dia", "ell", "rcm-ell"])
def test_coo_upload_equals_the_jax_device(layout, mode):
    """The port's make_matrix_device of a COO build equals the JAX
    MatrixDevice carried over by convert.matrix_device_from_numpy: the
    four word planes, checksums, values, fold, ell_len, gidx and
    perm_pos, clean and faulted."""
    m0 = layout_matrix(layout, mode)
    for label, m in coo_faults(m0, mode)[:3]:
        jmd = jmake_md(m, jnp.float32)
        got = make_matrix_device(m, torch.float32, CPU)
        want = matrix_device_from_numpy(jfields(jmd), CPU)
        assert len(got.words) == len(want.words) == 4
        for f in ("words", "cksum", "values", "fold", "fold_ck", "ell_len",
                  "gidx", "perm_pos"):
            a, b = getattr(got, f), getattr(want, f)
            assert (a is None) == (b is None), (label, f)
            if a is None:
                continue
            for ta, tb in (zip(a, b) if f == "words" else [(a, b)]):
                assert ta.dtype == tb.dtype and torch.equal(ta, tb), \
                    (label, f)


@pytest.mark.parametrize("layout", ["dia", "ell", "flat"])
def test_coo_signal_planes_each_against_its_baseline(layout):
    """Constraints mode on COO128 streams the col and the row word in
    codeword-word order, each against its own baseline.  A row-word flip
    fires only through the second plane; the 4-bit col/row fault leaves
    the rotated fold of the two words unchanged (a single derived plane
    would miss it) while each word's checksum changes; both triggers
    equal the JAX jnp path's."""
    m0 = layout_matrix(layout, "constraints")
    spec = fast_spec(m0, "constraints")
    assert (spec.plane, spec.plane2) == (0, 1)
    assert not spec.use_parity and spec.use_cksum
    md0 = make_matrix_device(m0, torch.float32, CPU)
    pairs = _signal_planes(md0, spec)
    assert [p.data_ptr() for p, _ in pairs] == [
        md0.words[0].data_ptr(), md0.words[1].data_ptr()]
    assert [b.data_ptr() for _, b in pairs] == [
        md0.cksum[0].data_ptr(), md0.cksum[1].data_ptr()]
    assert not bool(signals_plain(md0, spec))
    jfast = jax.jit(jmake_spmv(m0, jnp.float32, "constraints").fast_pw)
    x = xvec(m0)
    for label, m in (("row word", row_word_flip(m0, m0.nnz // 3 + 1)),
                     ("4bit col/row", col_row_fault(m0, m0.nnz // 3))):
        md = make_matrix_device(m, torch.float32, CPU)
        _, jtrig, _ = jfast(jmake_md(m, jnp.float32), jnp.asarray(x))
        assert bool(signals_plain(md, spec)) == bool(jtrig) is True, label
        one = spec._replace(plane2=None)
        if label == "row word":
            assert not bool(signals_plain(md, one))
        else:
            fold0 = fold_words([widen(w) for w in md0.words[:2]])
            fold1 = fold_words([widen(w) for w in md.words[:2]])
            assert torch.equal(fold0, fold1)
            assert bool(signals_plain(md, one))


@pytest.fixture(scope="module")
def flat_kernels():
    """The JAX flat product of each mode's COO powerlaw build: the
    Pallas route in interpret mode (the Benes kernel where its plan
    attaches, else jnp), compiled once per mode."""
    return {}


@pytest.mark.parametrize("mode", MODES)
def test_coo_flat_fast_plain_matches_jax(flat_kernels, mode):
    """Kernel E's plain version on COO128 (the row word gathers) against
    make_pallas_spmv(interpret=True) and the jnp flat fast path: w to
    1e-6 of each row's sum |v x|, pw to 1e-5, the trigger exact, clean
    and with each fault."""
    m0 = layout_matrix("flat", mode)
    spec = flat_spec(m0, mode)
    assert spec.gather == ("gidx" if m0.perm is not None else
                           m0.layout.word_names.index("row"))
    assert not spec.mask_ecc
    if mode not in flat_kernels:
        flat_kernels[mode] = (
            jax.jit(make_pallas_spmv(m0, jnp.float32, mode,
                                     interpret=True).fast_pw),
            jax.jit(jmake_spmv(m0, jnp.float32, mode).fast_pw))
    kernel, jfast = flat_kernels[mode]
    for label, m in coo_faults(m0, mode):
        x = xvec(m)
        jmd = jmake_md(m, jnp.float32)
        tmd = make_matrix_device(m, torch.float32, CPU)
        tw, ttrig, tpw = flat_fast(tmd, torch.tensor(x), spec)
        tw = tw.numpy()
        absw = flat_product(tmd.values.double().abs(),
                            ell_gather_plane(tmd, spec), tmd.row_ptr,
                            torch.tensor(x, dtype=torch.float64)).numpy()
        refs = [tuple(np.asarray(v) for v in jfast(jmd, jnp.asarray(x)))]
        gw = m0.ell_gather_word
        if np.array_equal(m.ell[gw], m0.ell[gw]):
            # the Benes route's windows are the clean build's: a fault
            # that moves a gather index is held against jnp only
            refs.append(tuple(np.asarray(v) for v in kernel(
                jmd, jnp.asarray(x))))
        for want, wtrig, wpw in refs:
            fin = np.isfinite(want)
            np.testing.assert_array_equal(np.isfinite(tw), fin,
                                          err_msg=label)
            assert np.all(np.abs(tw - want)[fin] <= 1e-6 * absw[fin]), label
            np.testing.assert_allclose(float(tpw), float(wpw), rtol=1e-5,
                                       err_msg=label)
            assert bool(ttrig) == bool(wtrig), (mode, label)
        if label == "clean" or mode == "none":
            assert not bool(ttrig)
        elif label in ("row word", "4bit col/row"):
            assert bool(ttrig), (mode, label)


@pytest.mark.parametrize("mode", ["constraints"] + ECC)
@pytest.mark.parametrize("layout", ["flat", "band-split",
                                    "bordered-split"])
def test_coo_classify_bit_exact(layout, mode):
    """Stats and the scrubbed device planes vs the jnp classify on the
    flat and split layouts (a split's tail slots offset past its main
    part's); in constraints mode the structural check's error code and
    slot (a row-word flip that keeps the rows in range and in order is
    benign there, in both packages)."""
    m0 = layout_matrix(layout, mode)
    jclassify = jax.jit(jmake_spmv(m0, jnp.float32, mode).classify)
    tclassify = make_spmv(m0, torch.float32, mode).classify
    for label, m in coo_faults(m0, mode):
        jst, jmd2 = jclassify(jmake_md(m, jnp.float32))
        tst, tmd2 = tclassify(make_matrix_device(m, torch.float32, CPU))
        assert tuple(tst) == tuple(int(v) for v in jst), (mode, label)
        parts = zip(jmd2, tmd2) if m.exec_kind == "split" else [(jmd2,
                                                                 tmd2)]
        for j, t in parts:
            for a, b in zip(j.words, t.words):
                np.testing.assert_array_equal(np.asarray(a),
                                              to_numpy_u32(b))
            np.testing.assert_array_equal(np.asarray(j.cksum),
                                          to_numpy_u32(t.cksum))
            jv = np.asarray(j.values)
            np.testing.assert_array_equal(t.values.numpy().view(jv.dtype),
                                          jv)


# --------------------------------------------------------------------------
# Kernels B and D and the split tail: the plain loops against the JAX
# megakernel in interpret mode
# --------------------------------------------------------------------------

def fused_matrix(family, mode):
    if family == "dia":
        tri, kw = jmatgen.spd_tridiagonal(1024), {}
    elif family == "ell":
        tri, kw = jmatgen.spd_tridiagonal(1024), {"force_exec": "ell"}
    else:
        tri, kw = bordered(), {}
    m = jbuild_coo(tri, mode, **kw)
    assert m.R % 1024 == 0
    if family == "split":
        assert m.exec_kind == "split" and m.tail.dense_plan is not None
    else:
        assert m.exec_kind == family
    return m


def bvec(m, seed=77):
    b = np.zeros(m.R, np.float32)
    b[: m.N] = np.random.default_rng(seed).random(m.N)
    return b


def assert_same_solve(jr, tr, split=False):
    """Iterations and events equal; the trace to 1e-4 (a split tail's to
    1e-3 above float32's noise floor, rr0 * 1e-5); x to rtol 1e-4 / atol
    1e-5 when the solve stood."""
    it = int(jr.iterations)
    assert tr.iterations == it
    assert tuple(tr.stats) == tuple(int(v) for v in jr.stats)
    want = np.asarray(jr.rr_trace)[:it]
    got = tr.rr_trace[:it].numpy()
    keep, tol = np.ones(it, bool), 1e-4
    if split and it:
        keep, tol = want > want[0] * 1e-5, 1e-3
    np.testing.assert_allclose(got[keep], want[keep], rtol=tol)
    if tr.stats.errcode == 0:
        np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x),
                                   rtol=1e-4, atol=1e-5)


FUSED_CASES = [("dia", "secded", 1), ("dia", "constraints", 1),
               ("dia", "constraints", 4), ("ell", "constraints", 1),
               ("ell", "secded", 4), ("split", "constraints", 1),
               ("split", "secded", 1)]


@pytest.mark.parametrize("family,mode,ci", FUSED_CASES,
                         ids=[f"{f}-{m}-ci{c}" for f, m, c in FUSED_CASES])
def test_coo_fused_plain_matches_megakernel(family, mode, ci):
    """fused_cg_dia_plain / fused_cg_ell_plain (and the split tail, two
    signal planes in constraints mode) through make_fused_solver against
    the JAX megakernel in interpret mode: clean, then a corrected 1-bit
    fault (secded) or a row-word flip and the 4-bit col/row fault
    (constraints: the same fail-stop)."""
    m0 = fused_matrix(family, mode)
    spec = fast_spec(m0.main if family == "split" else m0, mode)
    assert (spec.plane2 is not None) == (mode == "constraints")
    if family == "split":
        assert (tail_spec(m0, mode).plane2 is not None) == (
            mode == "constraints")
    kernel = jax.jit(jfused(m0, mode, MAX_ITRS, CONV, interpret=True,
                            check_interval=ci))
    solve = make_fused_solver(m0, mode, MAX_ITRS, CONV, check_interval=ci)
    b = bvec(m0)
    cases = [("clean", m0)]
    if mode == "secded":
        cases.append(("1bit", inject_bitflips(
            m0, "ANY", 1, np.random.default_rng(6), echo=lambda s: None)))
    else:
        cases += [("row word", row_word_flip(m0, m0.nnz // 3 + 1)),
                  ("4bit col/row", col_row_fault(m0, m0.nnz // 3))]
    for label, m in cases:
        jr = kernel(jmake_md(m, jnp.float32), jnp.asarray(b))
        tr = solve(make_matrix_device(m, torch.float32, CPU),
                   torch.tensor(b))
        assert_same_solve(jr, tr, split=family == "split")
        if label == "1bit":
            assert tr.stats.corrected_count == 1 and tr.stats.errcode == 0
        elif label != "clean":
            assert tr.stats.errcode != 0, label
