"""``bin/cg-csr-torch -t cpu`` (``cli.main_csr``) against ``bin/cg-csr -t
cpu``: stdout equal line for line except ``time taken``, exit codes
equal, on tests/data/small.mtx -b 4 --seed 5, in every run_tests -x
class, with ``-p jacobi``, ``--refine 2``, ``--check-interval 4`` (and
its warning on stderr) and ``--quiet``; the three refusals; ``--profile``;
``--list``; the line order through a pipe; and ``./run_tests
bin/cg-csr-torch``.  Captured with capfd:
the library writes its rr and correction lines to fd 1 itself.
test_torch_cli_cpu_coo.py holds the same for cg-coo, in its own file so
that the test workers run the two side by side."""

import json
import os
import re
import subprocess
import sys

import pytest
import torch

from abft_sparse_cg_tpu import cli as jcli
from abft_sparse_cg_tpu.backends import jnp_backend
from abft_sparse_cg_tpu_torch import cli
from abft_sparse_cg_tpu_torch.backends import torch_backend

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = os.path.join(REPO, "tests", "data", "small.mtx")
BASE = ["-f", SMALL, "-b", "4", "--seed", "5", "-t", "cpu"]
torch.set_num_threads(1)

# The run_tests -x classes (tests/test_torch_cli.py::FAULT_RUNS), then the
# solver options and --quiet on a corrected run.
CPU_RUNS = [["-m", "none"], ["-m", "secded", "-x"], ["-m", "sed", "-x"],
            ["-m", "secded", "-x", "2"], ["-m", "sec7", "-x", "VALUE"],
            ["-m", "constraints", "-x", "INDEX"], ["-m", "sec8", "-x", "3"]
            ] + [[*opt, "-m", "secded", "-x"]
                 for opt in (["-p", "jacobi"], ["--refine", "2"],
                             ["--check-interval", "4"], ["--quiet"])]
REFUSALS = [["--devices", "2"], ["--solver", "pipelined"],
            ["--checkpoint", "snap.npz"]]


def ids(flags):
    return "_".join(f.lstrip("-") for f in flags)


def run_fd(main, argv, capfd):
    """Exit code, stdout and stderr of one in-process CLI run, fd 1 and
    2 included (the port's main returns its code, the JAX one raises
    SystemExit)."""
    try:
        code = main(argv)
    except SystemExit as e:
        code = e.code
    sys.stdout.flush()
    out = capfd.readouterr()
    return code, out.out, out.err


def untimed(out):
    return [ln for ln in out.splitlines() if not ln.startswith("time taken")]


def identical_to_jax(jmain, tmain, argv, capfd, monkeypatch):
    """Run both CLIs on ``argv`` (each warns afresh) and hold the port's
    exit code and stdout, less ``time taken``, to the JAX CLI's."""
    monkeypatch.setattr(torch_backend, "_warned_live", set())
    monkeypatch.setattr(jnp_backend, "_warned_live", set())
    jcode, jout, jerr = run_fd(jmain, argv, capfd)
    tcode, tout, terr = run_fd(tmain, argv, capfd)
    assert tcode == jcode
    assert untimed(tout) == untimed(jout)
    assert "implementation        = cpu-" in tout
    return tcode, tout, terr, jerr


def check_run(jmain, tmain, flags, capfd, monkeypatch):
    code, out, err, jerr = identical_to_jax(jmain, tmain, [*BASE, *flags],
                                            capfd, monkeypatch)
    if "--quiet" not in flags and code == 0:
        assert re.search(r"^iteration +0 :  rr = ", out, re.M)
        assert "total error" in out
    if "-x" in flags and code == 0:
        assert "[ECC] corrected" in out
    warning = "warning: --check-interval has no lazy schedule on the cpu route"
    assert (warning in err) == (warning in jerr) == (
        "--check-interval" in flags)


def check_refusal(jmain, tmain, flags, tmp_path, capfd, monkeypatch):
    if flags[0] == "--checkpoint":
        flags = [flags[0], str(tmp_path / flags[1])]
    code, out, _, _ = identical_to_jax(jmain, tmain,
                                       [*BASE, "-m", "secded", *flags],
                                       capfd, monkeypatch)
    assert code == 1
    assert out.splitlines()[-1].startswith(
        "options unsupported for target 'cpu': ")


def check_run_tests(exe):
    """./run_tests EXE on the small matrix: only passed lines, and the
    cpu target's 11 (6 clean, 1 sed -x, 3 sec -x, 1 secded -x 2).  One
    OpenMP thread per run: the other test workers hold the cores."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    p = subprocess.run(
        [os.path.join(REPO, "run_tests"),
         f"{sys.executable} {os.path.join(REPO, 'bin', exe)}", "-f", SMALL],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=900)
    lines = p.stdout.splitlines()
    assert p.returncode == 0 and lines, p.stderr
    assert all(ln.startswith("passed ") for ln in lines), lines
    cpu = [ln for ln in lines if " -t cpu " in ln]
    assert len(cpu) == 11
    assert sum(ln.endswith(" -x") for ln in cpu) == 4
    assert sum(ln.endswith(" -x 2") for ln in cpu) == 1
    assert len(lines) == 22 + 11 * torch.cuda.is_available()


@pytest.mark.parametrize("flags", CPU_RUNS, ids=ids)
def test_csr_cpu_stdout_identical_to_jax(flags, capfd, monkeypatch):
    check_run(jcli.main_csr, cli.main_csr, flags, capfd, monkeypatch)


@pytest.mark.parametrize("flags", REFUSALS, ids=ids)
def test_csr_cpu_refusals_identical_to_jax(flags, tmp_path, capfd,
                                           monkeypatch):
    check_refusal(jcli.main_csr, cli.main_csr, flags, tmp_path, capfd,
                  monkeypatch)


def test_list_orders_torch_cpu_cuda(capfd):
    code, out, _ = run_fd(cli.main_csr, ["--list"], capfd)
    assert code == 0
    targets = [t for t, _ in re.findall(r"^\t(\S+?)-(\S+)$", out, re.M)]
    order = ["torch", "cpu"] + ["cuda"] * torch.cuda.is_available()
    assert sorted(set(targets), key=targets.index) == order
    assert targets.count("cpu") == 6


def test_profile_writes_a_trace_and_keeps_stdout(tmp_path, capfd):
    """--profile DIR on -t cpu: stdout equal to bin/cg-csr -t cpu
    --profile's, and a CPU trace in DIR that holds the native solve's
    span."""
    pdir = tmp_path / "new" / "cpu"
    argv = [*BASE, "-m", "secded", "-x"]
    jcode, jout, _ = run_fd(jcli.main_csr,
                            argv + ["--profile", str(tmp_path / "jax")],
                            capfd)
    tcode, tout, _ = run_fd(cli.main_csr, argv + ["--profile", str(pdir)],
                            capfd)
    assert tcode == jcode == 0
    assert untimed(tout) == untimed(jout)
    with open(pdir / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "abft_cg_solve" in names


def test_profile_on_torch_records_the_solve_spans(tmp_path, capfd):
    """--profile DIR on -t torch: the trace holds the port's own spans
    of the solve and of the upload that TorchBackend.solve makes inside
    the window."""
    pdir = tmp_path / "torch"
    argv = [*BASE[:-1], "torch", "-m", "secded", "-x", "--profile",
            str(pdir)]
    code, out, _ = run_fd(cli.main_csr, argv, capfd)
    assert code == 0 and "[ECC] corrected" in out
    with open(pdir / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"solver.solve", "solver.init", "ops.upload"} <= names


def test_through_a_pipe_the_lines_keep_their_order(capfd):
    """bin/cg-csr-torch -t cpu into a pipe: Python's block-buffered echo
    and banner still come before the library's own lines (the backend
    flushes sys.stdout before the native call), as in-process in
    bin/cg-csr -t cpu."""
    argv = [*BASE, "-m", "sec8", "-x"]
    _, jout, _ = run_fd(jcli.main_csr, argv, capfd)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONUNBUFFERED"}
    p = subprocess.run([sys.executable, os.path.join(REPO, "bin",
                                                     "cg-csr-torch"), *argv],
                       capture_output=True, text=True, env=env, timeout=300)
    assert p.returncode == 0, p.stderr
    assert untimed(p.stdout) == untimed(jout)
    assert "[ECC] corrected" in p.stdout


def test_run_tests_csr_passes_every_cpu_class():
    check_run_tests("cg-csr-torch")
