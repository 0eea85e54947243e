"""The rest of the port's CLI surface against the JAX CLI's: the
``--checkpoint``/``--resume`` and ``--solver pipelined`` stdout cases,
float64, ``-t torch`` against ``-t jnp`` line for line (less the time
lines and the target name), on the layouts of tests/test_torch_cli.py
(DIA, banded ELL, flat, band split, bordered split; cg-csr and cg-coo;
the run_tests -x classes; 8 shards), the pipelined refusals and its
check-interval warning, and ``--profile``.  Its own file, beside
test_torch_cli.py, so that the test workers can run the two side by
side."""

import pytest

from abft_sparse_cg_tpu import cli as jcli
from abft_sparse_cg_tpu_torch import cli
from test_torch_cli import (  # noqa: F401  (layout_mtx, mtx: fixtures)
    COO,
    contract_lines,
    layout_mtx,
    mains,
    mtx,
    run,
    run_ids,
)


# The rest of the CLI's surface (--checkpoint/--resume, --solver
# pipelined): the layouts in the -x classes, cg-coo among them, and on
# 8 shards.
SURFACE_RUNS = [
    (lay, flags) for lay in ("dia", "ell", "flat", "band-split",
                             "bordered-split")
    for flags in (["-m", "secded", "-x"], ["-m", "sed", "-x"])] + [
    ("dia", flags) for flags in (
        ["-m", "none"], ["-m", "secded", "-x", "2"],
        ["-m", "constraints", "-x", "INDEX"], [COO, "-m", "secded", "-x"],
        [COO, "-m", "constraints", "-x", "INDEX"])] + [
    ("ell", [COO, "-m", "secded", "-x"]),
    ("bordered-split", [COO, "-m", "constraints", "-x", "INDEX"])] + [
    (lay, ["-m", "secded", "-x", "--devices", "8"])
    for lay in ("dia", "ell", "bordered-split")]
SURFACE_IDS = [f"{lay}-{run_ids(f)}" for lay, f in SURFACE_RUNS]


@pytest.mark.parametrize("layout,flags", SURFACE_RUNS, ids=SURFACE_IDS)
def test_checkpoint_resume_f64_stdout_identical_to_jnp(
        layout_mtx, layout, flags, tmp_path, capsys):
    """--checkpoint: a partial run (-i 4 --checkpoint P), then --resume
    to the full limit in segments of 3 (--checkpoint-every 3), each
    package from its own snapshot: both runs' exit codes and stdout
    equal to -t jnp's line for line."""
    jmain, tmain, flags = mains(flags)
    argv = ["-f", layout_mtx[layout], "-b", "1", "--seed", "3", "--dtype",
            "f64", *flags]
    outs = {}
    for target, main in (("jnp", jmain), ("torch", tmain)):
        snap = str(tmp_path / f"{target}.npz")
        part = run(main, argv + ["-t", target, "-i", "4", "--checkpoint",
                                 snap], capsys)
        full = run(main, argv + ["-t", target, "--checkpoint", snap,
                                 "--resume", "--checkpoint-every", "3"],
                   capsys)
        outs[target] = [(code, contract_lines(out))
                        for code, out, _ in (part, full)]
    assert outs["torch"] == outs["jnp"]
    assert "iteration" in "".join(outs["torch"][1][1]) \
        or outs["torch"][1][0] == 1


@pytest.mark.parametrize("layout,flags", SURFACE_RUNS, ids=SURFACE_IDS)
def test_pipelined_f64_stdout_identical_to_jnp(layout_mtx, layout, flags,
                                               capsys):
    """--solver pipelined on -t torch: exit code and stdout equal to -t
    jnp's line for line."""
    jmain, tmain, flags = mains(flags)
    argv = ["-f", layout_mtx[layout], "-b", "1", "--seed", "3", "--dtype",
            "f64", "--solver", "pipelined", *flags]
    jcode, jout, _ = run(jmain, argv + ["-t", "jnp"], capsys)
    tcode, tout, _ = run(tmain, argv + ["-t", "torch"], capsys)
    assert tcode == jcode
    assert contract_lines(tout) == contract_lines(jout)
    assert "iteration" in tout or jcode == 1


@pytest.mark.parametrize("flags", [
    ["--solver", "pipelined", "-p", "jacobi"],
    ["--solver", "pipelined", "--checkpoint", "snap.npz"]],
    ids=["pipelined-jacobi", "pipelined-checkpoint"])
def test_pipelined_refusals_equal_jnp(mtx, flags, capsys):
    """Pipelined with -p jacobi or --checkpoint: the JAX CLI's one line,
    "options unsupported for target '<t>': ...", exit 1."""
    argv = ["-f", mtx, "-b", "4", "--seed", "5", "--dtype", "f64", "-m",
            "secded", *flags]
    jcode, jout, _ = run(jcli.main_csr, argv + ["-t", "jnp"], capsys)
    tcode, tout, _ = run(cli.main_csr, argv + ["-t", "torch"], capsys)
    assert tcode == jcode == 1
    assert tout.splitlines()[-1] == jout.splitlines()[-1].replace(
        "'jnp'", "'torch'")
    assert tout.splitlines()[-1].startswith(
        "options unsupported for target 'torch': ")


def test_pipelined_check_interval_warns_and_runs_live(mtx, capsys):
    """--solver pipelined --check-interval 4: stdout equal to -t jnp's,
    and -t jnp's live-schedule warning on stderr (the torch route has no
    lazy schedule)."""
    from abft_sparse_cg_tpu.backends import jnp_backend
    from abft_sparse_cg_tpu_torch.backends import torch_backend

    jnp_backend._warned_live.discard("jnp")
    torch_backend._warned_live.discard("torch")
    argv = ["-f", mtx, "-b", "4", "--seed", "5", "--dtype", "f64", "-m",
            "secded", "-x", "--solver", "pipelined", "--check-interval", "4"]
    jcode, jout, jerr = run(jcli.main_csr, argv + ["-t", "jnp"], capsys)
    tcode, tout, terr = run(cli.main_csr, argv + ["-t", "torch"], capsys)
    assert tcode == jcode == 0
    assert contract_lines(tout) == contract_lines(jout)
    assert "no lazy schedule on the jnp route" in jerr
    assert ("warning: --check-interval has no lazy schedule on the torch "
            "route; running the live detection schedule") in terr


@pytest.mark.parametrize("main", ["csr", "coo"])
def test_profile_writes_a_trace_and_keeps_stdout(mtx, tmp_path, main,
                                                 capsys):
    """--profile DIR: stdout equal to -t jnp's (which writes its own
    trace), and a torch.profiler trace in DIR, created if missing, that
    holds the solve's operators."""
    import json

    jmain, tmain = ((jcli.main_csr, cli.main_csr) if main == "csr"
                    else (jcli.main_coo, cli.main_coo))
    argv = ["-f", mtx, "-b", "4", "--seed", "5", "--dtype", "f64", "-m",
            "secded", "-x"]
    jcode, jout, _ = run(jmain, argv + ["-t", "jnp", "--profile",
                                        str(tmp_path / "jax")], capsys)
    pdir = tmp_path / "new" / "torch"
    tcode, tout, _ = run(tmain, argv + ["-t", "torch", "--profile",
                                        str(pdir)], capsys)
    assert tcode == jcode == 0
    assert contract_lines(tout) == contract_lines(jout)
    with open(pdir / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::sum" in names
