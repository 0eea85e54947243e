"""The port's own host layer against the JAX package's.

``abft_sparse_cg_tpu_torch`` keeps a copy of the NumPy host layer
(formats, ecc.layout, the NumPy codec, inject, the CLI parser, the
matrix generators) instead of importing the JAX package.  These tests
hold the copy equal to the original: ``build_protected`` byte for byte
in every mode on the DIA stand-in, the three ELL shapes and the flat and
split routes of the zoo (wide-band ELL included), the Benes-plan attach
predicate that routing depends on, the same parsed arguments, injected
bits and generated matrices.  Sizes stay small (N <= ~27k).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from abft_sparse_cg_tpu import cli as jcli
from abft_sparse_cg_tpu import inject as jinject
from abft_sparse_cg_tpu.ecc import codec as jcodec
from abft_sparse_cg_tpu.ecc import layout as jlayout
from abft_sparse_cg_tpu.formats import assemble as jassemble
from abft_sparse_cg_tpu.formats import build_protected as jbuild
from abft_sparse_cg_tpu.utils import matgen as jmatgen
from abft_sparse_cg_tpu.utils import matzoo as jmatzoo
from abft_sparse_cg_tpu_torch import cli, inject
from abft_sparse_cg_tpu_torch.ecc import codec, layout
from abft_sparse_cg_tpu_torch.formats import assemble, build_protected
from abft_sparse_cg_tpu_torch.utils import matgen, matzoo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ["none", "constraints", "sed", "sec7", "sec8", "secded"]

# name -> (triplet generator, build kwargs, expected exec kind)
SHAPES = {
    "tridiagonal": (lambda: matgen.spd_tridiagonal(4096), {}, "dia"),
    "dense-radius-3d": (lambda: matzoo.dense_radius_3d(side=12), {},
                        "ell"),
    "blockdiag-random": (lambda: matzoo.blockdiag_random(n=6000), {},
                         "ell"),
    "shuffled-ell": (lambda: matgen.shuffle_labels(
        *matgen.spd_tridiagonal(4096), seed=11), {"force_exec": "ell"},
        "ell"),
}
FIELDS = ("ell_len", "ell_slot", "ell_cksum", "flat_cksum", "dia_offsets",
          "perm", "band", "exec_kind", "N", "nnz", "K", "R")


def both_builds(tri, mode, **kw):
    rows, cols, vals, n = tri
    jm = jbuild("csr", jassemble(cols, rows, vals, n, 1), mode, **kw)
    tm = build_protected("csr", assemble(cols, rows, vals, n, 1), mode, **kw)
    return jm, tm


def assert_same_build(jm, tm):
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
    assert tm.layout.word_names == jm.layout.word_names
    np.testing.assert_array_equal(tm.layout.masks, jm.layout.masks)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_build_protected_byte_identical(shape, mode):
    make, kw, kind = SHAPES[shape]
    jm, tm = both_builds(make(), mode, **kw)
    assert tm.exec_kind == kind
    if shape == "shuffled-ell" and mode != "constraints":
        assert tm.perm is not None  # the RCM permutation is active
    assert_same_build(jm, tm)


# Every route, row-aligned as ``--devices 8`` aligns it (cuda: 8192 rows,
# torch: 128) and at a width no build pads to by itself.
ALIGN_CASES = [(f, a) for f in ("tridiagonal", "dense-radius-3d",
                                "shuffled-ell") for a in (8192, 384)]


@pytest.mark.parametrize("mode", ["none", "constraints", "secded"])
@pytest.mark.parametrize("shape,align", ALIGN_CASES,
                         ids=[f"{f}-{a}" for f, a in ALIGN_CASES])
def test_row_align_builds_byte_identical(shape, align, mode):
    make, kw, kind = SHAPES[shape]
    jm, tm = both_builds(make(), mode, row_align=align, **kw)
    assert tm.exec_kind == kind and tm.R % align == 0
    assert_same_build(jm, tm)


def test_row_align_must_be_a_multiple_of_128():
    rows, cols, vals, n = matgen.spd_tridiagonal(256)
    with pytest.raises(ValueError, match="row_align"):
        build_protected("csr", assemble(cols, rows, vals, n, 1), "secded",
                        row_align=1000)


def assert_same_routing(jm, tm):
    """Byte-identical builds of any layout: planes, slot maps, checksums,
    __flat_group__, the dense plan, whether the Benes plan attaches, and
    a split's parts, index maps and composite slot routing."""
    assert tm.exec_kind == jm.exec_kind
    if jm.exec_kind == "split":
        for part in ("main", "tail"):
            assert_same_routing(getattr(jm, part), getattr(tm, part))
        for f in ("idx_main", "idx_tail", "flat_cksum"):
            a, b = getattr(jm, f), getattr(tm, f)
            assert (a is None) == (b is None), f
            assert a is None or np.array_equal(a, b), f
        assert (tm.R, tm.K, tm.band, tm.exec_size) == \
            (jm.R, jm.K, jm.band, jm.exec_size)
        np.testing.assert_array_equal(tm.slot_to_canonical(),
                                      jm.slot_to_canonical())
        return
    assert_same_build(jm, tm)
    assert tm.dense_plan == jm.dense_plan
    assert tm.unstr_attached == (getattr(jm, "unstr_plan", None) is not None)


# name -> (triplets, build kwargs, JAX routing); small sizes of the zoo
# families the JAX build lays out flat or split.
ROUTES = {
    "powerlaw": (lambda: matzoo.powerlaw_graph(n=2048), {}, "split"),
    "powerlaw-flat": (lambda: matzoo.powerlaw_graph(n=2048),
                      {"split": "none"}, "flat"),
    "stencil27-rcm-flat": (lambda: matzoo.stencil27_shuffled(side=10),
                           {"force_exec": "flat"}, "flat"),
    "k729": (lambda: matzoo.dense_radius_3d(side=10, rx=4, ry=4, rz=4), {},
             "flat"),
    "k1": (lambda: _pairs(1024), {"reorder": "none"}, "flat"),
    "band-split": (lambda: matzoo.band_plus_random(n=16384), {}, "split"),
    "bordered-split": (lambda: matzoo.arrowhead(n=2048), {}, "split"),
}


def _pairs(n, seed=0):
    """One off-diagonal entry per row at a random partner: K = 1, which
    no ELL kernel tier takes, so the JAX build lays it out flat."""
    p = np.random.default_rng(seed).permutation(n)
    a, b = p[0::2], p[1::2]
    return np.maximum(a, b), np.minimum(a, b), np.full(n // 2, 0.5), n


# k729 (343k entries) in one plain and one ECC mode, the rest in all six.
ROUTE_CASES = [(f, m) for f in ROUTES for m in MODES
               if f != "k729" or m in ("none", "secded")]


ALIGNED_ROUTES = [(f, m) for f in ROUTES if f != "k729"
                  for m in ("none", "secded")]


@pytest.mark.parametrize("family,mode", ALIGNED_ROUTES,
                         ids=[f"{f}-{m}" for f, m in ALIGNED_ROUTES])
def test_flat_and_split_row_align_byte_identical(family, mode):
    """row_align on the flat and split routes (cli.py:325-340 passes it
    to every part of a split)."""
    make, kw, kind = ROUTES[family]
    jm, tm = both_builds(make(), mode, row_align=8192, **kw)
    assert tm.exec_kind == kind and tm.R % 8192 == 0
    assert_same_routing(jm, tm)


@pytest.mark.parametrize("family,mode", ROUTE_CASES,
                         ids=[f"{f}-{m}" for f, m in ROUTE_CASES])
def test_flat_and_split_builds_byte_identical(family, mode):
    make, kw, kind = ROUTES[family]
    jm, tm = both_builds(make(), mode, **kw)
    assert tm.exec_kind == kind
    assert_same_routing(jm, tm)


@pytest.mark.parametrize("family,kwargs,jax_kind", [
    ("arrowhead", dict(n=4096), "split"),
    ("dense-radius-k729", None, "flat"),
])
def test_flat_and_split_routes_refused(family, kwargs, jax_kind):
    """Where the JAX build returns the split or flat layout, the port's
    build now returns the same layout, byte for byte (it refused these
    matrices before the flat and split layouts were ported), also with
    ``force_exec="flat"``."""
    make = matzoo.ZOO[family][0]
    tri = make(**kwargs) if kwargs else make()
    rows, cols, vals, n = tri
    jm = jbuild("csr", jassemble(cols, rows, vals, n, 1), "secded")
    tm = build_protected("csr", assemble(cols, rows, vals, n, 1), "secded")
    assert jm.exec_kind == jax_kind
    assert_same_routing(jm, tm)
    assert_same_routing(
        jbuild("csr", jassemble(cols, rows, vals, n, 1), "secded",
               force_exec="flat"),
        build_protected("csr", assemble(cols, rows, vals, n, 1), "secded",
                        force_exec="flat"))


def test_declined_band_split_refused():
    """A band in (1920, 16256] whose band split the JAX build declines
    stays ELL there, and here too now (the port refused it before)."""
    rows, cols, vals, n = matzoo.band_plus_random(n=8192)
    jm = jbuild("csr", jassemble(cols, rows, vals, n, 1), "secded")
    assert jm.exec_kind == "ell" and 1920 < jm.band <= 16256
    tm = build_protected("csr", assemble(cols, rows, vals, n, 1), "secded")
    assert_same_routing(jm, tm)


def test_stencil27_routes_flat_under_rcm():
    """stencil27-shuffled at side 30: band 2611 after RCM, the band split
    declines, the JAX cost model favours its Benes route and the plan
    attaches — flat under the permutation, in both builds."""
    jm, tm = both_builds(matzoo.stencil27_shuffled(side=30), "secded")
    assert jm.exec_kind == "flat" and jm.perm is not None
    assert_same_routing(jm, tm)


def test_wide_band_ell_when_the_plan_does_not_attach(monkeypatch):
    """The same matrix with both packages' 2^23-slot Benes envelope cut
    to 2^16: the plan no longer attaches, so both builds keep it as
    wide-band ELL (band 2611) — the case the port refused before."""
    from abft_sparse_cg_tpu.ops import spmv_unstructured as junstr
    from abft_sparse_cg_tpu_torch.ops import spmv_unstructured as tunstr

    monkeypatch.setattr(junstr, "_MAX_TOTAL_M", 1 << 16)
    monkeypatch.setattr(tunstr, "_MAX_TOTAL_M", 1 << 16)
    jm, tm = both_builds(matzoo.stencil27_shuffled(side=30), "secded")
    assert jm.exec_kind == "ell" and 1920 < jm.band <= 16256
    assert_same_routing(jm, tm)


@pytest.mark.parametrize("caps", [None, "block", "grid", "total"])
@pytest.mark.parametrize("family", ["powerlaw-flat", "stencil27-rcm-flat",
                                    "k729"])
def test_attach_predicate_equals_jax_plan(monkeypatch, family, caps):
    """The port's envelope arithmetic (ops.spmv_unstructured.
    plan_attaches) equals ``unstructured_plan(m) is not None`` of the JAX
    package, with the real caps and with each cap shrunk in both
    packages so that its refusal branch is taken."""
    from abft_sparse_cg_tpu.ops import spmv_unstructured as junstr
    from abft_sparse_cg_tpu_torch.ops import spmv_unstructured as tunstr

    shrink = {"block": {"_BLOCK_TARGET": 1 << 12},
              "grid": {"_BLOCK_TARGET": 1 << 12, "_MAX_M": 1 << 13},
              "total": {"_MAX_TOTAL_M": 1 << 13}}.get(caps, {})
    for name, v in shrink.items():
        monkeypatch.setattr(junstr, name, v)
        monkeypatch.setattr(tunstr, name, v)
    monkeypatch.setattr(junstr, "_PLAN_CACHE", {})
    make, kw, _ = ROUTES[family]
    kw = dict(kw, force_exec="flat")
    rows, cols, vals, n = make()
    jm = jbuild("csr", jassemble(cols, rows, vals, n, 1), "none",
                _attach_unstr=False, **kw)
    tm = build_protected("csr", assemble(cols, rows, vals, n, 1), "none",
                         _attach_unstr=False, **kw)
    assert jm.exec_kind == tm.exec_kind == "flat"
    want = junstr.unstructured_plan(jm) is not None
    assert tunstr.plan_attaches(tm) == want
    if caps is None:
        assert want


def test_layout_and_codec_constants_equal():
    for name in ("NUM_PARITY_BITS", "OVERALL_PARITY_BIT", "SED_PARITY_BIT"):
        assert getattr(layout, name) == getattr(jlayout, name)
    assert layout.ECC_COL_MASK == jlayout.ECC_COL_MASK
    assert codec.MODES == jcodec.MODES and codec.ECC_MODES == jcodec.ECC_MODES
    for a, b in ((layout.CSR96, jlayout.CSR96), (layout.COO128,
                                                  jlayout.COO128)):
        assert (a.name, a.num_words, a.col_word, a.word_names) == \
            (b.name, b.num_words, b.col_word, b.word_names)
        np.testing.assert_array_equal(a.masks, b.masks)


@pytest.mark.parametrize("mode", MODES)
def test_numpy_encode_equal(mode):
    rng = np.random.default_rng(4)
    for lay, jlay in ((layout.CSR96, jlayout.CSR96),
                      (layout.COO128, jlayout.COO128)):
        words = [rng.integers(0, 1 << 32, 5000, dtype=np.uint64)
                 .astype(np.uint32) for _ in range(lay.num_words)]
        words[lay.col_word] &= np.uint32(0x00FFFFFF)
        for a, b in zip(codec.encode(mode, words, lay),
                        jcodec.encode(mode, words, jlay)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind,flips,seed", [
    ("ANY", 1, 1), ("ANY", 2, 2), ("VALUE", 1, 3), ("INDEX", 1, 4),
    ("ANY", 3, 5)])
def test_inject_bitflips_equal(kind, flips, seed):
    jm, tm = both_builds(matzoo.dense_radius_3d(side=10), "secded")
    jbanners, tbanners = [], []
    jout = jinject.inject_bitflips(jm, kind, flips,
                                   np.random.default_rng(seed),
                                   echo=jbanners.append)
    tout = inject.inject_bitflips(tm, kind, flips,
                                  np.random.default_rng(seed),
                                  echo=tbanners.append)
    assert tbanners == jbanners
    assert_same_build(jout, tout)
    # Injection keeps the encode-time checksums (never refreshed).
    np.testing.assert_array_equal(tout.ell_cksum, tm.ell_cksum)


ARGVS = [
    [], ["-b", "4", "-m", "secded", "-x"], ["-x", "2", "VALUE"],
    ["-x", "INDEX", "-m", "constraints", "--seed", "9"],
    ["-c", "1e-6", "-i", "50", "-f", "some.mtx", "--dtype", "f64"],
    ["--quiet", "--reps", "3", "--check-interval", "auto"],
    ["--check-interval", "8", "--devices", "2", "--solver", "pipelined"],
    ["-p", "jacobi", "--refine", "2", "--checkpoint", "s.npz",
     "--checkpoint-every", "5", "--resume", "--format", "coo"],
    ["-t", "cuda", "-l"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a) or "-")
def test_parse_arguments_equal(argv):
    """The copied parser gives the JAX one's result; the only difference
    is the default target (cuda here, jnp there)."""
    got = cli.parse_arguments(list(argv), "csr")
    want = jcli.parse_arguments(list(argv), "csr")
    if "-t" not in argv:
        assert got.pop("target") == "cuda" and want.pop("target") == "jnp"
    got["matrix_file"] = os.path.normpath(got["matrix_file"])
    want["matrix_file"] = os.path.normpath(want["matrix_file"])
    assert got == want


@pytest.mark.parametrize("argv", [["-b", "0"], ["-c", "x"], ["--bogus"],
                                  ["-x", "nope"], ["--dtype", "f16"]])
def test_parse_arguments_rejects_like_jax(argv, capsys):
    with pytest.raises(SystemExit) as t:
        cli.parse_arguments(list(argv), "csr")
    tout = capsys.readouterr().out
    with pytest.raises(SystemExit) as j:
        jcli.parse_arguments(list(argv), "csr")
    assert t.value.code == j.value.code == 1
    assert tout == capsys.readouterr().out


ZOO_ARGS = {
    "graded-mesh-1d": dict(n=3000), "aniso-laplace-2d": dict(side=40),
    "powerlaw-graph": dict(n=2048), "band+random-1pct": dict(n=4096),
    "stencil27-shuffled": dict(side=10), "dense-radius-3d": dict(side=9),
    "dense-radius-k729": None, "bitreversal-banded": dict(n=2048),
    "arrowhead": dict(n=2048), "periodic-3d": dict(side=9),
    "blockdiag-random": dict(n=3000),
}


@pytest.mark.parametrize("family", list(ZOO_ARGS))
def test_zoo_generators_equal(family):
    assert list(matzoo.ZOO) == list(jmatzoo.ZOO)
    assert matzoo.ZOO[family][1] == jmatzoo.ZOO[family][1]
    kw = ZOO_ARGS[family]
    got = matzoo.ZOO[family][0](**kw) if kw else matzoo.ZOO[family][0]()
    want = jmatzoo.ZOO[family][0](**kw) if kw else jmatzoo.ZOO[family][0]()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_matgen_and_mmio_equal(tmp_path):
    for fn, args in (("spd_tridiagonal", (300,)),
                     ("spd_laplacian_2d", (17,)),
                     ("spd_wideband", (500, 40)),
                     ("spd_denseband", (400, 6))):
        for a, b in zip(getattr(matgen, fn)(*args),
                        getattr(jmatgen, fn)(*args)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    tri = matgen.shuffle_labels(*matgen.spd_tridiagonal(300), seed=5)
    p1, p2 = str(tmp_path / "a.mtx"), str(tmp_path / "b.mtx")
    matgen.write_mm_triangle(p1, *tri)
    jmatgen.write_mm_triangle(p2, *tri)
    with open(p1) as f1, open(p2) as f2:
        assert f1.read() == f2.read()
    from abft_sparse_cg_tpu.formats import load_matrix as jload
    from abft_sparse_cg_tpu_torch.formats import load_matrix

    a, b = load_matrix(p1, 3), jload(p1, 3)
    for f in ("cols", "rows", "values"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert (a.N, a.nnz, a.block_size) == (b.N, b.nnz, b.block_size)


def test_port_imports_nothing_of_the_jax_package():
    """Every module of the port and chip_smoke.py import in a fresh
    interpreter without pulling in jax or any module of the JAX
    package."""
    code = (
        "import sys, pkgutil, importlib\n"
        "import abft_sparse_cg_tpu_torch as p\n"
        "for mod in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(mod.name)\n"
        "import chip_smoke\n"
        "bad = sorted(k for k in sys.modules if k == 'jax'\n"
        "             or k.startswith('jax.') or k == 'abft_sparse_cg_tpu'\n"
        "             or k.startswith('abft_sparse_cg_tpu.'))\n"
        "assert not bad, bad\n"
        "new = ('formats.split', 'ops.spmv_unstructured', 'ops.spmv_cuda',\n"
        "       'solver.fused', 'backends.cuda_backend', 'parallel.sharded',\n"
        "       'parallel.sharded_kernel')\n"
        "assert all(p.__name__ + '.' + n in sys.modules for n in new)\n"
        "print('ok', len([k for k in sys.modules\n"
        "                 if k.startswith(p.__name__)]))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=REPO, timeout=120)
    assert p.returncode == 0, p.stderr
    assert p.stdout.startswith("ok") and int(p.stdout.split()[1]) >= 27
