"""``bin/cg-coo-torch -t cpu`` (``cli.main_coo``) against ``bin/cg-coo -t
cpu``: the cases of test_torch_cli_cpu.py on COO128 codewords, a 4-bit
INDEX flip in constraints mode among them, and ``./run_tests
bin/cg-coo-torch``."""

import pytest

from abft_sparse_cg_tpu import cli as jcli
from abft_sparse_cg_tpu_torch import cli
from test_torch_cli_cpu import (
    CPU_RUNS,
    REFUSALS,
    check_refusal,
    check_run,
    check_run_tests,
    ids,
)

COO_RUNS = CPU_RUNS + [["-m", "constraints", "-x", "4", "INDEX"]]


@pytest.mark.parametrize("flags", COO_RUNS, ids=ids)
def test_coo_cpu_stdout_identical_to_jax(flags, capfd, monkeypatch):
    check_run(jcli.main_coo, cli.main_coo, flags, capfd, monkeypatch)


@pytest.mark.parametrize("flags", REFUSALS, ids=ids)
def test_coo_cpu_refusals_identical_to_jax(flags, tmp_path, capfd,
                                           monkeypatch):
    check_refusal(jcli.main_coo, cli.main_coo, flags, tmp_path, capfd,
                  monkeypatch)


def test_run_tests_coo_passes_every_cpu_class():
    check_run_tests("cg-coo-torch")
