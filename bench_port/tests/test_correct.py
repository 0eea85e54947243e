"""``correct``: the comparison passes sound runs of the program, fails
the bfloat16 control and fails a run whose timed path is broken."""

import time

import pytest
import torch

from bench_port import control, entry, harness

CELLS = ["hpcg-104-secded.stream", "hpcg-104-secded.lazy32",
         "hpcg-104-secded.faults"]
CPU = torch.device("cpu")


def run(root, cell, entry_=None, seed=2**31 + 5):
    c = harness.find_cell(root, cell)
    return harness.run_cell(c, seed, 0.2, False, CPU, time.perf_counter(),
                            entry=entry_).result


class Broken:
    """The program's entry with its answers broken where they are
    produced."""

    def __init__(self, fault):
        self.fault = fault

    def __getattr__(self, name):
        return getattr(entry, name)

    def prepare(self, mat, config, traffic, device):
        solve = entry.prepare(mat, config, traffic, device)

        def broken(md, b):
            a = solve(md, b)
            x = a.x.clone()
            if self.fault == "state unchanged":
                return a._replace(x=torch.zeros_like(x), rr=float(b @ b))
            if self.fault == "half the rows left out":
                x[x.shape[0] // 2:] = 0
            elif self.fault == "an element altered":
                x[x.shape[0] // 3] += 1e-2 * float(x.abs().max())
            elif self.fault == "iterations altered":
                return a._replace(iterations=a.iterations - 1)
            elif self.fault == "r.r altered":
                return a._replace(rr=a.rr * 1.5)
            elif self.fault == "an error reported":
                return a._replace(errcode=1)
            elif self.fault == "a correction reported":
                return a._replace(corrected=1)
            return a._replace(x=x)

        return broken


@pytest.mark.parametrize("cell", CELLS)
def test_sound_runs_are_correct(tiny_root, cell):
    r = run(tiny_root, cell)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("fault", [
    "state unchanged", "half the rows left out", "an element altered",
    "iterations altered", "r.r altered", "an error reported",
    "a correction reported"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(tiny_root, cell, fault):
    r = run(tiny_root, cell, Broken(fault))
    assert not r["correct"]
    assert r["failed"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_the_bfloat16_control_is_not_correct(tiny_root, cell):
    c = harness.find_cell(tiny_root, cell)
    limits = c.config["limits"]
    recs = control.windows(c, [11, 12], [21, 22, 23], 0.2, CPU,
                           lambda rec: None)
    for rec in recs:
        ok = all(rec[k] <= limits[k] for k in limits)
        assert rec["compared"] > 0
        assert ok == (rec["side"] == "program"), rec
