"""The port's flat layout and kernel E's plain version against the JAX
package.

Inputs, all small: the powerlaw-graph zoo family at n = 2048 (flat with
``split="none"``, under its RCM permutation: hub rows up to 1,178
entries beside rows of 2), stencil27-shuffled at side 10 forced flat
under its RCM permutation (the gidx plane), band+random-1pct at n =
16384 (band split: ELL main, flat tail without a dense plan), arrowhead
at n = 2048 (bordered split: DIA main, dense-plan tail), a seeded x and
seeded 1-/2-bit injections.

Kernel E's plain version (``flat_fast_plain``) is held against the
Benes-route Pallas kernel (``make_unstructured_spmv``) run in interpret
mode (rows whose gather index a fault moved: against the jnp path only)
and against the jnp flat ``fast``: w to 1e-6 of each row's sum |v x|
(the two sum a row in other float32 orders), pw to 1e-5 relative, the
trigger exact.  Device planes, classify and every integer output are
bit-exact; float64 products agree to 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from abft_sparse_cg_tpu.formats import assemble as jassemble
from abft_sparse_cg_tpu.formats import build_protected as jbuild
from abft_sparse_cg_tpu.inject import inject_bitflips
from abft_sparse_cg_tpu.ops.spmv import MatrixDevice as JMatrixDevice
from abft_sparse_cg_tpu.ops.spmv import make_matrix_device as jmake_md
from abft_sparse_cg_tpu.ops.spmv import make_spmv as jmake_spmv
from abft_sparse_cg_tpu.ops.spmv_unstructured import make_unstructured_spmv
from abft_sparse_cg_tpu.utils import matzoo as jzoo
from abft_sparse_cg_tpu_torch.ecc.codec import to_numpy_u32
from abft_sparse_cg_tpu_torch.ops.spmv import (
    flat_product,
    make_matrix_device,
    make_spmv,
)
from abft_sparse_cg_tpu_torch.ops.spmv_cuda import (
    ell_gather_plane,
    flat_fast,
    flat_fast_plain,
    flat_spec,
    make_cuda_spmv,
)

MODES = ["none", "constraints", "sed", "sec7", "sec8", "secded"]
ECC = ["sed", "sec7", "sec8", "secded"]
CPU = torch.device("cpu")
# Small eager CPU tensors: one intra-op thread per process, so that
# parallel test workers do not oversubscribe the cores.
torch.set_num_threads(1)

# name -> (generator, build kwargs, exec kind)
FLAT = {
    "powerlaw": (lambda: jzoo.powerlaw_graph(n=2048), {"split": "none"}),
    "stencil27-rcm": (lambda: jzoo.stencil27_shuffled(side=10),
                      {"force_exec": "flat"}),
}
SPLIT = {
    "arrowhead": lambda: jzoo.arrowhead(n=2048),
    "band+random": lambda: jzoo.band_plus_random(n=16384),
}


def build(tri, mode, **kw):
    rows, cols, vals, n = tri
    return jbuild("csr", jassemble(cols, rows, vals, n, 1), mode, **kw)


def flat_matrix(shape, mode):
    make, kw = FLAT[shape]
    m = build(make(), mode, **kw)
    assert m.exec_kind == "flat"
    # Both shapes adopt an RCM exec permutation (not in constraints mode).
    assert (m.perm is None) == (mode == "constraints")
    return m


def faults(m, mode):
    """(label, matrix): clean, two 1-bit and one 2-bit flip, an index
    flip in none/constraints."""
    out = [("clean", m)]
    for flips, seed in ((1, 31), (2, 32), (1, 33)):
        out.append((f"{flips}bit-s{seed}", inject_bitflips(
            m, "ANY", flips, np.random.default_rng(seed),
            echo=lambda s: None)))
    if mode in ("none", "constraints"):
        out.append(("index", inject_bitflips(
            m, "INDEX", 1, np.random.default_rng(34), echo=lambda s: None)))
    return out


def xvec(m, dtype=np.float32, seed=5):
    return np.random.default_rng(seed).random(m.R).astype(dtype)


def abs_rowsum(md, spec, x):
    """Each row's sum |v x| in float64 (the float32 tolerance's scale)."""
    return flat_product(md.values.double().abs(),
                        ell_gather_plane(md, spec), md.row_ptr,
                        torch.tensor(x, dtype=torch.float64)).numpy()


def assert_md_equal(jmd, tmd):
    for a, b in zip(jmd.words, tmd.words):
        np.testing.assert_array_equal(np.asarray(a), to_numpy_u32(b))
    np.testing.assert_array_equal(np.asarray(jmd.cksum),
                                  to_numpy_u32(tmd.cksum))
    jv = np.asarray(jmd.values)
    np.testing.assert_array_equal(tmd.values.numpy().view(jv.dtype), jv)
    for f in ("fold", "fold_ck"):
        a, b = getattr(jmd, f), getattr(tmd, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(np.asarray(a), to_numpy_u32(b))
    for f in ("flat_group", "gidx", "perm_pos", "dense_td", "dense_tb"):
        a, b = getattr(jmd, f), getattr(tmd, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", list(FLAT) + list(SPLIT))
def test_matrix_device_bit_exact(shape, mode):
    """Flat planes, flat_group, gidx, perm_pos and a dense-plan tail's
    td/tb, float32 and float64, clean and faulted."""
    m = flat_matrix(shape, mode) if shape in FLAT else build(
        SPLIT[shape](), mode)
    for _, mm in faults(m, mode)[:2]:
        for jdt, tdt in ((jnp.float32, torch.float32),
                         (jnp.float64, torch.float64)):
            jmd, tmd = jmake_md(mm, jdt), make_matrix_device(mm, tdt, CPU)
            if mm.exec_kind == "split":
                for j, t in zip(jmd, tmd):
                    assert_md_equal(j, t)
            else:
                assert_md_equal(jmd, tmd)


@pytest.fixture(scope="module")
def benes_products():
    """One jitted Benes-route product per flat shape: the Pallas kernel
    in interpret mode reads only the md.unstr arrays, which every mode's
    build of one shape gives the same structure."""
    out = {}
    for shape in FLAT:
        m0 = flat_matrix(shape, "none")
        impl = make_unstructured_spmv(m0, jnp.float32, "none",
                                      interpret=True)
        assert impl is not None

        def product(unstr, x, _f=impl.fast_pw):
            md = JMatrixDevice(words=(), ell_len=None, cksum=None,
                               unstr=unstr)
            w, _, pw = _f(md, x)
            return w, pw

        out[shape] = jax.jit(product)
    return out


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", list(FLAT))
def test_flat_fast_plain_matches_pallas_kernel(benes_products, shape, mode):
    """Kernel E's plain version vs the Benes-route kernel (interpret) and
    the jnp flat fast path: w to 1e-6 of sum |v x| per row, pw to 1e-5,
    the trigger exact (the Benes tier's trigger is the jnp folds')."""
    m0 = flat_matrix(shape, mode)
    spec = flat_spec(m0, mode)
    jfast = jax.jit(jmake_spmv(m0, jnp.float32, mode).fast_pw)
    for label, m in faults(m0, mode):
        x = xvec(m)
        jmd = jmake_md(m, jnp.float32)
        bw, bpw = (np.asarray(v) for v in benes_products[shape](
            jmd.unstr, jnp.asarray(x)))
        ow, otrig, opw = (np.asarray(v) for v in jfast(jmd, jnp.asarray(x)))
        tmd = make_matrix_device(m, torch.float32, CPU)
        tw, ttrig, tpw = flat_fast(tmd, torch.tensor(x), spec)
        tw = tw.numpy()
        absw = abs_rowsum(tmd, spec, x)
        # The Benes kernel scans x in windows fixed by the clean build: a
        # gather index a fault moves out of its window reads 0 there (a
        # TPU artifact) and the clamped x entry here — the rows whose
        # index moved are held against the jnp path only.
        gw = m0.ell_gather_word
        moved = np.unique(m0.ell["__flat_group__"][
            np.nonzero(m.ell[gw] != m0.ell[gw])[0]])
        if len(moved):
            bw = bw.copy()
            bw[moved], bpw = ow[moved], opw
        # Constraints mode never reorders, so its exec order is not the
        # fixture's (mode none, permuted): the jnp path only.
        refs = [(ow, opw)] if mode == "constraints" else [(bw, bpw),
                                                          (ow, opw)]
        for want, wpw in refs:
            fin = np.isfinite(want)
            np.testing.assert_array_equal(np.isfinite(tw), fin,
                                          err_msg=label)
            assert np.all(np.abs(tw - want)[fin] <= 1e-6 * absw[fin]), label
            np.testing.assert_allclose(float(tpw), float(wpw), rtol=1e-5,
                                       err_msg=label)
        assert bool(ttrig) == bool(otrig), (mode, label)
        if label == "clean" or mode == "none":
            assert not bool(ttrig)
        elif label == "index" or (mode in ECC and (
                mode in ("sec7", "secded") or label.startswith("1bit"))):
            assert bool(ttrig), (mode, label)


@pytest.mark.parametrize("bit", range(32))
def test_flat_out_of_range_index_clamps_like_jnp(bit):
    """Mode none gathers with the raw col word: each of its 32 bits
    flipped in one element (bit 31 makes the int32 index negative); the
    float64 product equals the jnp oracle's clamped gather to 1e-12, and
    kernel E's plain version in float32 agrees to 1e-6 of sum |v x|."""
    m = flat_matrix("powerlaw", "none")
    words = m.words_list()
    cw = m.layout.col_word
    words[cw] = words[cw].copy()
    words[cw][m.nnz // 2] ^= np.uint32(1 << bit)
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
    spec = flat_spec(mf, "none")
    md = make_matrix_device(mf, torch.float32, CPU)
    kw, _, _ = flat_fast(md, torch.tensor(x32), spec)
    assert np.all(np.abs(kw.numpy() - np.asarray(jw32))
                  <= 1e-6 * abs_rowsum(md, spec, x32))


def test_flat_product_is_lane_ordered():
    """flat_product sums lane by lane, then in the butterfly: a row of
    64 slots whose lane sums cancel differently than a left-to-right
    sum shows the order."""
    vals = torch.tensor([1.0, 1e8] + [0.0] * 30 + [1.0, -1e8] + [0.0] * 30,
                        dtype=torch.float32)
    g = torch.zeros(64, dtype=torch.int32)
    ptr = torch.tensor([0, 64] + [64] * 31, dtype=torch.int32)
    x = torch.ones(32, dtype=torch.float32)
    w = flat_product(vals, g, ptr, x)
    # lane 0: 1 + 1 = 2, lane 1: 1e8 - 1e8 = 0 -> 2 (left to right: 0)
    assert float(w[0]) == 2.0 and torch.all(w[1:] == 0)


@pytest.mark.parametrize("mode", ["constraints"] + ECC)
@pytest.mark.parametrize("shape", ["powerlaw", "stencil27-rcm", "arrowhead",
                                   "band+random"])
def test_classify_bit_exact(shape, mode):
    """Stats and scrubbed device planes (values, checksums, fold, gidx,
    dense td/tb) vs the jnp classify; a split's stats carry the tail's
    slots offset past the main part's."""
    m0 = flat_matrix(shape, mode) if shape in FLAT else build(
        SPLIT[shape](), mode)
    jclassify = jax.jit(jmake_spmv(m0, jnp.float32, mode).classify)
    tclassify = make_spmv(m0, torch.float32, mode).classify
    for label, m in faults(m0, mode):
        jst, jmd2 = jclassify(jmake_md(m, jnp.float32))
        tst, tmd2 = tclassify(make_matrix_device(m, torch.float32, CPU))
        assert tuple(tst) == tuple(int(v) for v in jst), (mode, label)
        if m.exec_kind == "split":
            for j, t in zip(jmd2, tmd2):
                assert_md_equal(j, t)
        else:
            assert_md_equal(jmd2, tmd2)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", ["stencil27-rcm", "arrowhead",
                                   "band+random"])
def test_full_f64_matches_jnp(shape, mode):
    """The float64 check-and-correct oracle (the CLI's verification
    pass) and, for splits, the composite stats routing."""
    m0 = flat_matrix(shape, mode) if shape in FLAT else build(
        SPLIT[shape](), mode)
    jfull = jax.jit(jmake_spmv(m0, jnp.float64, mode).full)
    for label, m in faults(m0, mode):
        x = xvec(m, np.float64)
        jw, jst = jfull(jmake_md(m, jnp.float64), jnp.asarray(x))
        tw, tst = make_spmv(m, torch.float64, mode).full(
            make_matrix_device(m, torch.float64, CPU), torch.tensor(x))
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-12,
                                   atol=1e-12, err_msg=label)
        assert tuple(tst) == tuple(int(v) for v in jst), (mode, label)


@pytest.mark.parametrize("mode", MODES)
def test_cuda_impl_matches_plain_on_cpu_split(mode):
    """The cuda SpmvImpl of a band split (kernel C's and E's plain
    versions combined) agrees with the plain impl: full bit-exact in
    none/constraints (same sums), fast_pw within float32 rounding."""
    m0 = build(SPLIT["band+random"](), mode)
    cuda, plain = (make_cuda_spmv(m0, torch.float32, mode),
                   make_spmv(m0, torch.float32, mode))
    for label, m in faults(m0, mode)[:3]:
        md = make_matrix_device(m, torch.float32, CPU)
        x = torch.tensor(xvec(m))
        w1, s1 = cuda.full(md, x)
        w2, s2 = plain.full(md, x)
        assert s1 == s2, (mode, label)
        torch.testing.assert_close(w1, w2, rtol=0, atol=0)
        w1, t1, p1 = cuda.fast_pw(md, x)
        w2, t2, p2 = plain.fast_pw(md, x)
        assert bool(t1) == bool(t2), (mode, label)
        torch.testing.assert_close(w1, w2, rtol=0, atol=0)


def test_flat_fast_takes_plain_version_only_on_cpu():
    m = flat_matrix("stencil27-rcm", "secded")
    md = make_matrix_device(m, torch.float32, CPU)
    spec = flat_spec(m, "secded")
    x = torch.tensor(xvec(m))
    before = flat_fast.launches
    out = flat_fast(md, x, spec)
    ref = flat_fast_plain(md, x, spec)
    assert flat_fast.launches == before
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        flat_fast(md, x.to("meta"), spec)
