"""The port's CLI contract: run_tests' four classes on ``-t torch``, line
for line identity with the JAX CLI's ``-t jnp`` in float64 (on the DIA
stand-in, a banded-ELL matrix, and flat, band-split and bordered-split
matrices; with ``-p jacobi``, ``--refine 2`` and ``--check-interval 4``,
which both targets run live, on DIA and ELL), the same for cg-coo
(``main_coo``, what bin/cg-coo-torch runs, against bin/cg-coo's) on
every layout in every -x class and a 4-bit INDEX run (the ``coo-``
cases), the default ``cuda`` target, the witnesses of the two chaotic
float64 runs, and the package's independence from JAX
(test_torch_cli_surface.py holds --checkpoint, --solver pipelined and
--profile)."""

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
from abft_sparse_cg_tpu.utils.matgen import (
    shuffle_labels,
    spd_laplacian_2d,
    spd_tridiagonal,
    write_mm_triangle,
)
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


def test_coo_list_and_help(capsys):
    """``main_coo`` (bin/cg-coo-torch): the same --list as cg-csr-torch
    and the JAX cg-coo's, and a --help that names cg-coo-torch."""
    code, out, _ = run(cli.main_coo, ["--list"], capsys)
    _, csr_out, _ = run(cli.main_csr, ["--list"], capsys)
    assert code == 0 and out == csr_out
    impls = re.findall(r"^\t(\S+)-(\S+)$", out, re.M)
    assert [("torch", m) for m in MODES] == impls[:6]
    code, out, _ = run(cli.main_coo, ["--help"], capsys)
    assert code == 0
    assert "Usage: cg-coo-torch [OPTIONS]" in out and "--format" in out
    jcode, jout, _ = run(jcli.main_coo, ["--help"], capsys)
    assert jcode == 0 and "Usage: cg-coo" in jout


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

# The run_tests classes, each -x kind.
FAULT_RUNS = [["-m", "none"], ["-m", "secded", "-x"], ["-m", "sed", "-x"],
              ["-m", "secded", "-x", "2"], ["-m", "sec7", "-x", "VALUE"],
              ["-m", "constraints", "-x", "INDEX"], ["-m", "sec8", "-x", "3"]]
# cg-coo: the same classes and a 4-bit INDEX flip, which in constraints
# mode can land on both index words of one element.
COO = "coo"
COO_RUNS = [[COO, *f] for f in FAULT_RUNS + [
    ["-m", "constraints", "-x", "4", "INDEX"]]]


def mains(flags):
    """(JAX main, port main, flags): bin/cg-coo's and bin/cg-coo-torch's
    ``main_coo`` for a case that starts with COO, else the cg-csr ones."""
    if flags[:1] == [COO]:
        return jcli.main_coo, cli.main_coo, flags[1:]
    return jcli.main_csr, cli.main_csr, flags


def run_ids(flags):
    return "_".join(flags).replace(f"{COO}_", f"{COO}-", 1)


@pytest.mark.parametrize("flags", [
    ["-m", "none"], ["-m", "secded", "-x"], ["-m", "sed", "-x"],
    ["-m", "secded", "-x", "2"], ["-m", "sec7", "-x", "VALUE"],
    ["-m", "constraints", "-x", "INDEX"], ["-m", "sec8", "-x", "3"],
    *OPTION_RUNS, *COO_RUNS], ids=run_ids)
def test_f64_stdout_identical_to_jnp(mtx, flags, capsys):
    jmain, tmain, flags = mains(flags)
    argv = ["-f", mtx, "-b", "4", "--seed", "5", "--dtype", "f64", *flags]
    jcode, jout, _ = run(jmain, argv + ["-t", "jnp"], capsys)
    tcode, tout, _ = run(tmain, argv + ["-t", "torch"], capsys)
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


@pytest.mark.parametrize("flags", FAULT_RUNS + COO_RUNS, ids=run_ids)
def test_devices_f64_stdout_identical_to_jnp(mtx, flags, capsys):
    """``--devices 8`` (row-sharded over 8 shards: the port's on the CPU,
    JAX's on the 8-device virtual mesh) in float64: stdout equal line
    for line, clean and in every -x class, cg-csr and cg-coo."""
    jmain, tmain, flags = mains(flags)
    argv = ["-f", mtx, "-b", "4", "--seed", "5", "--dtype", "f64",
            "--devices", "8", *flags]
    jcode, jout, _ = run(jmain, argv + ["-t", "jnp"], capsys)
    tcode, tout, _ = run(tmain, argv + ["-t", "torch"], capsys)
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
def layout_mtx(tmp_path_factory, mtx):
    """.mtx files of a flat (stencil27-shuffled, side 30: flat under its
    RCM permutation), a band-split (band+random-1pct, n = 16384) and a
    bordered-split (arrowhead, n = 2048) matrix; for cg-coo also the DIA
    stand-in, a banded-ELL (dense-radius-3d, side 8) and an RCM-ELL one
    (a label-shuffled 2-D Laplacian of side 24: ELL under its RCM
    permutation in the ECC modes; constraints never permutes)."""
    d = tmp_path_factory.mktemp("layouts")
    out = {"dia": mtx}
    for name, tri in (("band-split", band_plus_random(n=16384)),
                      ("bordered-split", arrowhead(n=2048)),
                      ("ell", dense_radius_3d(side=8)),
                      ("rcm-ell", shuffle_labels(*spd_laplacian_2d(24),
                                                 seed=11))):
        out[name] = str(d / f"{name}.mtx")
        write_mm_triangle(out[name], *tri)
    out["flat"] = str(d / "stencil27.mtx")
    write_mm_triangle(out["flat"], *stencil27_shuffled(side=30))
    return out


# cg-coo's bordered split under sec8 -x 3 at --seed 3: the three flips
# land in one value (two of them in its exponent), sec8 miscorrects a
# fourth bit, and CG on the corrupted, unsymmetric matrix amplifies
# rounding about 1e4-fold per iteration.  The two packages' float64 sums
# differ in order (rr0 by 4e-16), so their rr lines part at iteration 3;
# test_coo_chaotic_run_agrees_but_its_rr_lines holds that run instead.
CHAOTIC = ("bordered-split", [COO, "-m", "sec8", "-x", "3"])

LAYOUT_RUNS = [(lay, flags) for lay in ("flat", "band-split",
                                        "bordered-split")
               for flags in (["-m", "none"], ["-m", "secded", "-x"],
                             ["-m", "sed", "-x"], ["-m", "secded", "-x", "2"],
                             ["-m", "constraints", "-x", "INDEX"])] + [
    (lay, [*flags, "--devices", "8"]) for lay in ("flat", "band-split",
                                                  "bordered-split")
    for flags in (["-m", "secded", "-x"], ["-m", "sed", "-x"])] + [
    (lay, flags) for lay in ("dia", "ell", "rcm-ell", "flat", "band-split",
                             "bordered-split") for flags in COO_RUNS
    if (lay, flags) != CHAOTIC] + [
    ("ell", [*flags, "--devices", "8"]) for flags in COO_RUNS]


@pytest.mark.parametrize("layout,flags", LAYOUT_RUNS,
                         ids=[f"{lay}-{run_ids(f)}" for lay, f in
                              LAYOUT_RUNS])
def test_layouts_f64_stdout_identical_to_jnp(layout_mtx, layout, flags,
                                             capsys):
    """The flat and split layouts on -t torch in float64: stdout equal to
    -t jnp line for line, clean and in the run_tests -x classes, and
    row-sharded over 8 shards; cg-coo on every layout."""
    jmain, tmain, flags = mains(flags)
    argv = ["-f", layout_mtx[layout], "-b", "1", "--seed", "3", "--dtype",
            "f64", *flags]
    jcode, jout, _ = run(jmain, argv + ["-t", "jnp"], capsys)
    tcode, tout, _ = run(tmain, argv + ["-t", "torch"], capsys)
    assert tcode == jcode
    assert contract_lines(tout) == contract_lines(jout)
    assert "iteration" in tout or jcode == 1


def test_coo_chaotic_run_agrees_but_its_rr_lines(layout_mtx, capsys):
    """The CHAOTIC run: the same exit code, banner, [ECC] events,
    iteration count and verification lines as -t jnp, and rr lines equal
    to the printed digit up to the iteration after the correction; the
    later ones agree to 1e-3 of rr0 (rounding amplified by the corrupted
    matrix, not a different solve)."""
    layout, flags = CHAOTIC
    jmain, tmain, flags = mains(flags)
    argv = ["-f", layout_mtx[layout], "-b", "1", "--seed", "3", "--dtype",
            "f64", *flags]
    jcode, jout, _ = run(jmain, argv + ["-t", "jnp"], capsys)
    tcode, tout, _ = run(tmain, argv + ["-t", "torch"], capsys)
    assert tcode == jcode == 0 and "[ECC] corrected" in tout
    jl, tl = contract_lines(jout), contract_lines(tout)
    assert len(jl) == len(tl)
    rr = [(a, b) for a, b in zip(jl, tl) if a.startswith("iteration")]
    assert [a for a, b in zip(jl, tl) if not a.startswith("iteration")] \
        == [b for a, b in zip(jl, tl) if not a.startswith("iteration")]
    assert rr[:3] == [(a, a) for a, _ in rr[:3]]
    rr0 = float(rr[0][0].split()[-1])
    for a, b in rr:
        assert a.split()[:3] == b.split()[:3]
        assert abs(float(a.split()[-1]) - float(b.split()[-1])) <= 1e-3 * rr0


def test_coo_chaotic_rr_lines_follow_summation_order(layout_mtx,
                                                     monkeypatch, capsys):
    """Why the CHAOTIC run's rr lines part from -t jnp's: the port's own
    solve, with only the order of its float64 sums changed (solver.cg's
    dot and the rr of calc_xr: torch.sum, the reversed vector, NumPy's
    pairwise sum, the exactly rounded math.fsum), prints four different
    rr lines at iteration 3 from the same lines before it, every other
    line equal, and -t jnp's iteration 3 is a fifth value: jnp is one
    more summation order, not a different solve."""
    layout, flags = CHAOTIC
    jmain, tmain, flags = mains(flags)
    argv = ["-f", layout_mtx[layout], "-b", "1", "--seed", "3", "--dtype",
            "f64", *flags]
    _, jout, _ = run(jmain, argv + ["-t", "jnp"], capsys)
    outs = {}
    for name, (code, lines) in run_in_orders(tmain, argv, monkeypatch,
                                             capsys).items():
        assert code == 0 and any("[ECC] corrected" in ln
                                 for ln in lines), name
        outs[name] = lines
    jl = contract_lines(jout)

    def split(lines):
        rr = [ln for ln in lines if ln.startswith("iteration")]
        return rr, [ln for ln in lines if not ln.startswith("iteration")]

    jrr, jrest = split(jl)
    parts = {name: split(lines) for name, lines in outs.items()}
    assert all(rest == jrest for _, rest in parts.values())
    assert all(rr[:3] == jrr[:3] for rr, _ in parts.values())
    third = {name: rr[3] for name, (rr, _) in parts.items()}
    assert len(set(third.values())) == len(outs)
    assert jrr[3] not in third.values()


def summation_orders():
    """The four float64 summation orders of the chaotic-run witnesses:
    torch.sum, the reversed vector, NumPy's pairwise sum and the exactly
    rounded math.fsum."""
    import math

    return {"torch.sum": torch.sum,
            "reversed": lambda v: torch.sum(torch.flip(v, [0])),
            "pairwise": lambda v: torch.tensor(np.sum(v.numpy()),
                                               dtype=v.dtype),
            "fsum": lambda v: torch.tensor(math.fsum(v.tolist()),
                                           dtype=v.dtype)}


def run_in_orders(tmain, argv, monkeypatch, capsys):
    """{order: (exit code, contract lines)} of the port's run with
    solver.cg's dot and calc_xr's rr summed in each order."""
    from abft_sparse_cg_tpu_torch.solver import cg

    outs = {}
    for name, total in summation_orders().items():
        def calc_xr(x, r, p, w, alpha, total=total):
            x = x + alpha * p
            r = r - alpha * w
            return x, r, total(r * r)

        monkeypatch.setattr(cg, "dot", lambda a, b, t=total: t(a * b))
        monkeypatch.setattr(cg, "calc_xr", calc_xr)
        code, out, _ = run(tmain, argv + ["-t", "torch"], capsys)
        outs[name] = (code, contract_lines(out))
    return outs


def test_csr_chaotic_rr_lines_follow_summation_order(layout_mtx,
                                                     monkeypatch, capsys):
    """cg-csr's bordered split under sec8 -x 3 at --seed 3 (the CHAOTIC
    run's cg-csr twin): the miscorrection leaves an exponent-sized entry
    and the first iteration after it is already chaotic.  Held on what
    is not: the exit code, the banner, the [ECC] lines and rr0 equal to
    -t jnp's in every summation order; at iteration 1 the port's own
    orders give at least three different rr lines, none of them jnp's.
    The iteration count and the final error differ among the port's own
    orders, so they are not held (ROADMAP.md, decided divergences)."""
    argv = ["-f", layout_mtx["bordered-split"], "-b", "1", "--seed", "3",
            "--dtype", "f64", "-m", "sec8", "-x", "3"]
    jcode, jout, _ = run(jcli.main_csr, argv + ["-t", "jnp"], capsys)
    jl = contract_lines(jout)
    jrr = [ln for ln in jl if ln.startswith("iteration")]
    head = jl[: jl.index(jrr[0])]
    assert jcode == 0 and any(ln.startswith("[ECC] corrected") for ln in head)
    outs = run_in_orders(cli.main_csr, argv, monkeypatch, capsys)
    first = set()
    for name, (code, lines) in outs.items():
        rr = [ln for ln in lines if ln.startswith("iteration")]
        assert code == 0, name
        assert lines[: len(head)] == head, name
        assert rr[0] == jrr[0], name
        first.add(rr[1])
    assert len(first) >= 3
    assert jrr[1] not in first


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
