"""The port's own host layer against the JAX package's.

``abft_sparse_cg_tpu_torch`` keeps a copy of the NumPy host layer
(formats, ecc.layout, the NumPy codec, inject, the CLI parser, the
matrix generators) instead of importing the JAX package.  These tests
hold the copy equal to the original: ``build_protected`` byte for byte
in every mode on the DIA stand-in and the three ELL shapes, the same
refusals where the JAX build leaves DIA and ELL, the same parsed
arguments, injected bits and generated matrices.  Sizes stay small
(N <= ~20k).
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


@pytest.mark.parametrize("family,kwargs,jax_kind", [
    ("arrowhead", dict(n=4096), "split"),
    ("dense-radius-k729", None, "flat"),
])
def test_flat_and_split_routes_refused(family, kwargs, jax_kind):
    """Where the JAX build returns the split or flat layout, the port's
    build refuses in one line naming ROADMAP.md queue 1 item 9."""
    make = matzoo.ZOO[family][0]
    tri = make(**kwargs) if kwargs else make()
    rows, cols, vals, n = tri
    assert jbuild("csr", jassemble(cols, rows, vals, n, 1),
                  "secded").exec_kind == jax_kind
    with pytest.raises(NotImplementedError, match="queue 1 item 9") as e:
        build_protected("csr", assemble(cols, rows, vals, n, 1), "secded")
    assert "\n" not in str(e.value)
    with pytest.raises(NotImplementedError, match="item 9"):
        build_protected("csr", assemble(cols, rows, vals, n, 1), "secded",
                        force_exec="flat")


def test_declined_band_split_refused():
    """The recorded divergence (ROADMAP.md queue 3): a band in
    (1920, 16256] whose band split the JAX build declines stays ELL
    there and is refused here."""
    rows, cols, vals, n = matzoo.band_plus_random(n=8192)
    jm = jbuild("csr", jassemble(cols, rows, vals, n, 1), "secded")
    assert jm.exec_kind == "ell" and 1920 < jm.band <= 16256
    with pytest.raises(NotImplementedError, match="band of"):
        build_protected("csr", assemble(cols, rows, vals, n, 1), "secded")


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
    is the default target (torch here, jnp there)."""
    got = cli.parse_arguments(list(argv), "csr")
    want = jcli.parse_arguments(list(argv), "csr")
    if "-t" not in argv:
        assert got.pop("target") == "torch" and want.pop("target") == "jnp"
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
        "print('ok', len([k for k in sys.modules\n"
        "                 if k.startswith(p.__name__)]))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=REPO, timeout=120)
    assert p.returncode == 0, p.stderr
    assert p.stdout.startswith("ok") and int(p.stdout.split()[1]) >= 25
