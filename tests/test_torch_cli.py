"""The port's CLI contract: run_tests' four classes on ``-t torch``, line
for line identity with the JAX CLI's ``-t jnp`` in float64 (on the DIA
stand-in, a banded-ELL matrix, and flat, band-split and bordered-split
matrices; with ``-p jacobi``, ``--refine 2`` and ``--check-interval 4``,
which both targets run live, on DIA and ELL), the default ``cuda``
target, the unported-flag errors, and the package's independence from
JAX."""

import ast
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from abft_sparse_cg_tpu import cli as jcli
from abft_sparse_cg_tpu.backends import base as jbase
from abft_sparse_cg_tpu.formats import assemble, build_protected
from abft_sparse_cg_tpu.ops import spmv as jspmv
from abft_sparse_cg_tpu.utils.matgen import spd_tridiagonal, write_mm_triangle
from abft_sparse_cg_tpu.utils.matzoo import (
    arrowhead,
    band_plus_random,
    dense_radius_3d,
    stencil27_shuffled,
)
from abft_sparse_cg_tpu_torch import cli
from abft_sparse_cg_tpu_torch.backends import base
from abft_sparse_cg_tpu_torch.device import compute_dtype
from abft_sparse_cg_tpu_torch.ops import spmv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ["none", "constraints", "sed", "sec7", "sec8", "secded"]
# Small eager CPU tensors: one intra-op thread per process, so that
# parallel test workers do not oversubscribe the cores.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def mtx(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mtx") / "tri128.mtx")
    rows, cols, vals, n = spd_tridiagonal(128)
    write_mm_triangle(path, rows, cols, vals, n)
    return path


def run(main, argv, capsys):
    """Exit code and output of a CLI main: the port's returns its code,
    the JAX one (and an unknown target-mode) raises SystemExit."""
    try:
        code = main(argv)
    except SystemExit as e:
        code = e.code
    out = capsys.readouterr()
    return code, out.out, out.err


def total_error(out):
    m = re.search(r"^total error = (\S+)", out, re.M)
    return float(m.group(1)) if m else float("inf")


def test_list(capsys):
    code, out, _ = run(cli.main_csr, ["--list"], capsys)
    assert code == 0
    impls = re.findall(r"^\t(\S+)-(\S+)$", out, re.M)
    assert [("torch", m) for m in MODES] == impls[:6]


@pytest.mark.parametrize("mode", MODES)
def test_class1_clean(mtx, mode, capsys):
    code, out, _ = run(cli.main_csr, ["-f", mtx, "-b", "4", "--seed", "11",
                                      "-t", "torch", "-m", mode], capsys)
    assert code == 0 and total_error(out) < 1.0
    assert "ran for" in out and "time taken" in out


def test_default_target_is_cuda(mtx, capsys):
    """Without -t the CLI runs the kernels on the card; without a card
    cuda-<mode> is not registered and the run stops, exit 1, instead of
    carrying on on the CPU."""
    code, out, err = run(cli.main_csr, ["-f", mtx, "-b", "2"], capsys)
    if torch.cuda.is_available():
        assert code == 0 and "implementation        = cuda-none" in out
    else:
        assert code == 1
        assert "No implementation found for cuda-none" in err


def test_class2_sed_detects(mtx, capsys):
    code, out, _ = run(cli.main_csr, ["-f", mtx, "-b", "4", "--seed", "11",
                                      "-t", "torch", "-m", "sed", "-x"],
                       capsys)
    assert code == 1 and "error detected at index" in out


@pytest.mark.parametrize("mode", ["sec7", "sec8", "secded"])
def test_class3_sec_corrects(mtx, mode, capsys):
    code, out, _ = run(cli.main_csr, ["-f", mtx, "-b", "4", "--seed", "11",
                                      "-t", "torch", "-m", mode, "-x"],
                       capsys)
    assert code == 0 and "[ECC] corrected" in out


def test_class4_secded_double(mtx, capsys):
    code, out, _ = run(cli.main_csr, ["-f", mtx, "-b", "4", "--seed", "11",
                                      "-t", "torch", "-m", "secded", "-x",
                                      "2"], capsys)
    assert code == 1 and "double-bit error detected" in out


def contract_lines(out):
    """Everything but the timing lines and the target name."""
    return [ln.replace("jnp-", "T-").replace("torch-", "T-")
            for ln in out.splitlines()
            if not ln.startswith(("compile time", "time taken"))]


# The solver options, each without and with an injected fault.
OPTION_RUNS = [[*opt, *fault]
               for opt in (["-p", "jacobi"], ["--refine", "2"],
                           ["--check-interval", "4"])
               for fault in (["-m", "secded"], ["-m", "secded", "-x"])]


@pytest.mark.parametrize("flags", [
    ["-m", "none"], ["-m", "secded", "-x"], ["-m", "sed", "-x"],
    ["-m", "secded", "-x", "2"], ["-m", "sec7", "-x", "VALUE"],
    ["-m", "constraints", "-x", "INDEX"], ["-m", "sec8", "-x", "3"],
    *OPTION_RUNS], ids=lambda f: "_".join(f))
def test_f64_stdout_identical_to_jnp(mtx, flags, capsys):
    argv = ["-f", mtx, "-b", "4", "--seed", "5", "--dtype", "f64", *flags]
    jcode, jout, _ = run(jcli.main_csr, argv + ["-t", "jnp"], capsys)
    tcode, tout, _ = run(cli.main_csr, argv + ["-t", "torch"], capsys)
    assert tcode == jcode
    assert contract_lines(tout) == contract_lines(jout)
    assert any(ln.startswith("iteration") for ln in tout.splitlines()) \
        or jcode == 1


def test_cuda_target_without_card(mtx, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the cuda target registers")
    code, out, err = run(cli.main_csr, ["-f", mtx, "-t", "cuda", "-m",
                                        "secded"], capsys)
    assert code == 1
    assert "No implementation found for cuda-secded" in err


@pytest.mark.parametrize("flags", [
    ["--solver", "pipelined"],
    ["--checkpoint", "snap.npz"], ["--resume"], ["--profile", "trace"],
    ["--format", "coo"]], ids=lambda f: f[0])
def test_unported_flags_fail_with_one_line(mtx, flags, capsys):
    code, out, _ = run(cli.main_csr, ["-f", mtx, "-t", "torch", *flags],
                       capsys)
    assert code == 1
    assert out.strip().count("\n") == 0 and "not ported" in out


# The run_tests classes, each -x kind.
FAULT_RUNS = [["-m", "none"], ["-m", "secded", "-x"], ["-m", "sed", "-x"],
              ["-m", "secded", "-x", "2"], ["-m", "sec7", "-x", "VALUE"],
              ["-m", "constraints", "-x", "INDEX"], ["-m", "sec8", "-x", "3"]]


@pytest.mark.parametrize("flags", FAULT_RUNS, ids=lambda f: "_".join(f))
def test_devices_f64_stdout_identical_to_jnp(mtx, flags, capsys):
    """``--devices 8`` (row-sharded over 8 shards: the port's on the CPU,
    JAX's on the 8-device virtual mesh) in float64: stdout equal line
    for line, clean and in every -x class."""
    argv = ["-f", mtx, "-b", "4", "--seed", "5", "--dtype", "f64",
            "--devices", "8", *flags]
    jcode, jout, _ = run(jcli.main_csr, argv + ["-t", "jnp"], capsys)
    tcode, tout, _ = run(cli.main_csr, argv + ["-t", "torch"], capsys)
    assert tcode == jcode
    assert contract_lines(tout) == contract_lines(jout)
    assert "iteration" in tout or jcode == 1


def test_cuda_devices_past_the_cards_fail_with_one_line(mtx, capsys,
                                                        monkeypatch):
    """``-t cuda --devices N`` on a host with fewer than N cards: exit 1
    with the JAX CLI's message (jnp_backend.py:201-205)."""
    from abft_sparse_cg_tpu_torch.backends import registry
    from abft_sparse_cg_tpu_torch.backends.cuda_backend import CudaBackend

    monkeypatch.setattr(registry, "_REGISTRY", registry._REGISTRY + [
        ("cuda", "secded", lambda: CudaBackend("secded"))])
    cards = torch.cuda.device_count()
    code, out, _ = run(cli.main_csr, ["-f", mtx, "-t", "cuda", "-m",
                                      "secded", "--devices",
                                      str(cards + 2)], capsys)
    assert code == 1
    assert out.splitlines()[-1] == (
        f"options unsupported for target 'cuda': requested {cards + 2} "
        f"devices, found {cards}")
    jcode, jout, _ = run(jcli.main_csr, ["-f", mtx, "-t", "jnp", "-m",
                                         "secded", "--devices", "9"], capsys)
    assert jcode == 1 and jout.splitlines()[-1] == (
        "options unsupported for target 'jnp': requested 9 devices, "
        "found 8")


def test_refine_with_checkpoint_is_refused(mtx, capsys):
    """--refine and --checkpoint together: the JAX CLI's refusal
    (cli.py:387-389), one line, exit 1."""
    code, out, _ = run(cli.main_csr, ["-f", mtx, "-t", "torch", "--refine",
                                      "2", "--checkpoint", "snap.npz"],
                       capsys)
    assert code == 1
    assert out.strip() == ("--refine cannot be combined with "
                           "--checkpoint/--resume")


def test_check_interval_on_torch_warns_and_runs_live(mtx, capsys):
    """-t torch has no lazy schedule: a check interval > 1 prints the
    jnp target's warning on stderr and runs the live solve."""
    from abft_sparse_cg_tpu_torch.backends import torch_backend

    torch_backend._warned_live.discard("torch")
    argv = ["-f", mtx, "-b", "2", "--seed", "3", "-t", "torch", "-m",
            "secded"]
    code, out, err = run(cli.main_csr, argv + ["--check-interval", "8"],
                         capsys)
    assert code == 0 and "no lazy schedule on the torch route" in err
    _, live, _ = run(cli.main_csr, argv, capsys)
    assert contract_lines(out) == contract_lines(live)


def test_check_interval_auto_and_1_run_live(mtx, capsys):
    for ci in ("1", "auto"):
        code, out, _ = run(cli.main_csr, ["-f", mtx, "-b", "2", "-t",
                                          "torch", "--check-interval", ci],
                           capsys)
        assert code == 0 and total_error(out) < 1.0


def test_non_dia_matrix_not_ported(tmp_path, capsys):
    """Two dense rows route the matrix to the split layout, which this
    package refused before the split layouts were ported: it now runs,
    with -t torch's float64 stdout equal to -t jnp's line for line."""
    n = 256
    rows, cols, vals, n = spd_tridiagonal(n)
    extra = [(r, c) for r in (20, 200) for c in range(0, n, 3)
             if abs(r - c) > 1]
    rows = np.concatenate([rows, [max(r, c) for r, c in extra]])
    cols = np.concatenate([cols, [min(r, c) for r, c in extra]])
    vals = np.concatenate([vals, np.full(len(extra), -1e-3)])
    path = str(tmp_path / "bordered.mtx")
    write_mm_triangle(path, rows, cols, vals, n)
    m = build_protected("csr", assemble(cols, rows, vals, n, 1), "none")
    assert m.exec_kind in ("split", "flat")
    argv = ["-f", path, "--seed", "2", "--dtype", "f64"]
    jcode, jout, _ = run(jcli.main_csr, argv + ["-t", "jnp"], capsys)
    code, out, _ = run(cli.main_csr, argv + ["-t", "torch"], capsys)
    assert code == jcode == 0 and "not ported" not in out
    assert contract_lines(out) == contract_lines(jout)


@pytest.fixture(scope="module")
def layout_mtx(tmp_path_factory):
    """.mtx files of a flat (stencil27-shuffled, side 30: flat under its
    RCM permutation), a band-split (band+random-1pct, n = 16384) and a
    bordered-split (arrowhead, n = 2048) matrix."""
    d = tmp_path_factory.mktemp("layouts")
    out = {}
    for name, tri in (("band-split", band_plus_random(n=16384)),
                      ("bordered-split", arrowhead(n=2048))):
        out[name] = str(d / f"{name}.mtx")
        write_mm_triangle(out[name], *tri)
    out["flat"] = str(d / "stencil27.mtx")
    write_mm_triangle(out["flat"], *stencil27_shuffled(side=30))
    return out


LAYOUT_RUNS = [(lay, flags) for lay in ("flat", "band-split",
                                        "bordered-split")
               for flags in (["-m", "none"], ["-m", "secded", "-x"],
                             ["-m", "sed", "-x"], ["-m", "secded", "-x", "2"],
                             ["-m", "constraints", "-x", "INDEX"])] + [
    (lay, [*flags, "--devices", "8"]) for lay in ("flat", "band-split",
                                                  "bordered-split")
    for flags in (["-m", "secded", "-x"], ["-m", "sed", "-x"])]


@pytest.mark.parametrize("layout,flags", LAYOUT_RUNS,
                         ids=[f"{lay}-{'_'.join(f)}" for lay, f in
                              LAYOUT_RUNS])
def test_layouts_f64_stdout_identical_to_jnp(layout_mtx, layout, flags,
                                             capsys):
    """The flat and split layouts on -t torch in float64: stdout equal to
    -t jnp line for line, clean and in the run_tests -x classes, and
    row-sharded over 8 shards."""
    argv = ["-f", layout_mtx[layout], "-b", "1", "--seed", "3", "--dtype",
            "f64", *flags]
    jcode, jout, _ = run(jcli.main_csr, argv + ["-t", "jnp"], capsys)
    tcode, tout, _ = run(cli.main_csr, argv + ["-t", "torch"], capsys)
    assert tcode == jcode
    assert contract_lines(tout) == contract_lines(jout)
    assert "iteration" in tout or jcode == 1


@pytest.fixture(scope="module")
def ell_mtx(tmp_path_factory):
    """dense-radius-3d at side 10: N = 1000, K = 175, the ELL layout."""
    path = str(tmp_path_factory.mktemp("mtx") / "dense_radius.mtx")
    write_mm_triangle(path, *dense_radius_3d(side=10))
    return path


@pytest.mark.parametrize("flags", [
    ["-m", "none"], ["-m", "sed", "-x"], ["-m", "sec8", "-x"],
    ["-m", "secded", "-x", "2"], ["-m", "secded", "-x"],
    ["-m", "constraints", "-x", "INDEX"], *OPTION_RUNS],
    ids=lambda f: "_".join(f))
def test_ell_f64_stdout_identical_to_jnp(ell_mtx, flags, capsys):
    """The banded-ELL path on -t torch in float64: stdout equal to -t jnp
    line for line, clean, in the run_tests -x classes and with the
    solver options."""
    argv = ["-f", ell_mtx, "-b", "2", "--seed", "1", "--dtype", "f64",
            *flags]
    jcode, jout, _ = run(jcli.main_csr, argv + ["-t", "jnp"], capsys)
    tcode, tout, _ = run(cli.main_csr, argv + ["-t", "torch"], capsys)
    assert tcode == jcode
    assert contract_lines(tout) == contract_lines(jout)
    assert "iteration" in tout or jcode == 1


def test_dtype_policy():
    assert compute_dtype("torch") == torch.float64
    assert compute_dtype("cuda") == torch.float32
    assert compute_dtype("torch", "f32") == torch.float32
    with pytest.raises(ValueError, match="f64"):
        compute_dtype("cuda", "f64")


def test_errcodes_equal_jax():
    assert spmv.ERRCODES == jspmv.ERRCODES
    for name in ("ERR_NONE", "ERR_SED", "ERR_DOUBLE", "ERR_COL_SIZE",
                 "ERR_COL_ORDER", "ERR_ROW_SIZE", "ERR_ROW_ORDER",
                 "ERR_BREAKDOWN", "ERR_PHANTOM"):
        assert getattr(spmv, name) == getattr(jspmv, name), name


@pytest.mark.parametrize("fmt", ["csr", "coo"])
def test_stats_to_messages_equal_jax(fmt):
    rows, cols, vals, n = spd_tridiagonal(128)
    m = build_protected(fmt, assemble(cols, rows, vals, n, 2), "secded")
    opb = m.layout.col_word * 32 + 24
    for errcode in range(9):
        for err_slot, cor_slot, cor_bit in ((-1, -1, -1), (5, 7, 3),
                                            (m.R + 9, 11, opb)):
            args = (m, errcode, err_slot, cor_slot, cor_bit)
            assert base.stats_to_messages(*args) == \
                jbase.stats_to_messages(*args)
    np.testing.assert_array_equal(base.slot_to_canonical(m),
                                  jbase.slot_to_canonical(m))


def test_package_never_imports_jax():
    """Every module of the port, and chip_smoke.py, import without jax
    and without any module of the JAX package."""
    code = (
        "import sys, pkgutil, importlib\n"
        "import abft_sparse_cg_tpu_torch as p\n"
        "for mod in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(mod.name)\n"
        "import chip_smoke\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'abft_sparse_cg_tpu'))\n"
        "assert not bad, bad\n"
        "mods = [k for k in sys.modules if k.startswith(p.__name__)]\n"
        "print('ok', len(mods))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=REPO, timeout=120)
    assert p.returncode == 0, p.stderr
    assert p.stdout.startswith("ok") and int(p.stdout.split()[1]) >= 15


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py names no module of jax or of the JAX package: its
    host layer is the port's own copy (what it pulls in through those
    imports is checked by test_package_never_imports_jax)."""
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append("." * node.level + (node.module or ""))
    assert "abft_sparse_cg_tpu_torch.formats" in names
    bad = [n for n in names
           if n.split(".")[0] in ("jax", "jaxlib", "abft_sparse_cg_tpu")
           or n.startswith(".")]
    assert not bad, bad
