"""Fault traffic: the device flip equals the host injection followed by
an upload, the draw follows ``inject.py``'s order, a sound run of the
faults cell is ``correct`` with one repair per fault, and a run whose
repair path is broken is not."""

import re
import time

import numpy as np
import pytest
import torch

from bench_port import entry, harness
from bench_port.matrices import hpcg27

from abft_sparse_cg_tpu_torch.ecc import codec
from abft_sparse_cg_tpu_torch.inject import bitflip_region, inject_bitflips
from abft_sparse_cg_tpu_torch.ops.spmv import make_matrix_device

CELL = "hpcg-104-secded.faults"
CPU = torch.device("cpu")
CONFIG = {"num_blocks": 1, "format": "csr", "mode": "secded",
          "dtype": "float32"}
SEED = 2**31 + 11


def small(kind):
    """HPCG's stencil at 6^3: as DIA, and as ELL under a permutation
    (so that the gather plane ``gidx`` is derived too)."""
    tri = hpcg27.triangle(6, 6, 6)
    asm = entry.assemble(tri[1], tri[0], tri[2], tri[3], 1)
    if kind == "dia":
        return tri, entry.build_protected("csr", asm, "secded")
    perm = np.random.default_rng(3).permutation(tri[3])
    return tri, entry.build_protected("csr", asm, "secded",
                                      force_exec="ell", force_perm=perm)


def host_flip(mat, element, bits):
    """What inject_bitflips does once it has drawn (element, bits)."""
    words = codec.flip_bits(mat.words_list(), element, bits, mat.layout)
    return mat.with_planes(dict(zip(mat.layout.word_names, words)))


# bits: a low mantissa bit, the exponent's top bit (an inf or a NaN in
# the float32 value plane), index bits, the ECC byte's top bit (bit 31
# of the column word: a negative int32)
@pytest.mark.parametrize("bits", [[3], [62], [64], [80], [95], [5, 70]])
@pytest.mark.parametrize("kind", ["dia", "ell"])
def test_the_device_flip_equals_injection_and_upload(kind, bits):
    tri, mat = small(kind)
    assert mat.exec_kind == kind and (kind == "dia") == (mat.perm is None)
    inj = entry.Injector(mat, CONFIG)
    assert inj.nnz == mat.nnz == harness.stored_entries(tri, 1)
    clean = entry.planes(make_matrix_device(mat, torch.float32, CPU))
    for element in (0, mat.nnz // 3, mat.nnz - 1):
        md = make_matrix_device(mat, torch.float32, CPU)
        ref = entry.planes(make_matrix_device(host_flip(mat, element, bits),
                                              torch.float32, CPU))
        out = entry.planes(inj(md, element, bits))
        assert set(out) == set(ref)
        assert "gidx" in out or kind == "dia"
        for name in ref:
            assert torch.equal(out[name], ref[name]), (name, element)
        slots = {int(s) for w in range(3) for s in torch.nonzero(
            out[f"words.{w}"].reshape(-1) != clean[f"words.{w}"].reshape(-1))}
        assert slots == {inj.slot(element)}


@pytest.mark.parametrize("kind", ["ANY", "VALUE", "INDEX"])
def test_the_draw_follows_inject_bitflips(kind):
    _, mat = small("dia")
    assert harness.CSR_REGIONS[kind] == bitflip_region("csr", kind)
    faults = harness.Faults({"fault_every": 10, "fault_flips": 1,
                             "fault_kind": kind}, SEED, mat.nnz,
                            entry.Injector(mat, CONFIG))
    for index in (-3, 0, 9, 19, harness.TRACE_BASE + 9):
        said = []
        rng = np.random.default_rng(
            harness._hashed(f"{SEED}:fault:{index}"))
        inject_bitflips(mat, kind, 1, rng=rng, echo=said.append)
        bit, element = map(int, re.findall(r"\d+", said[0]))
        assert faults.draw(index) == (element, [bit])


def run(root, entry_=None, traced=False, seconds=1.5, every=None):
    """A run of the faults cell on the CPU; ``every`` makes the faults
    denser than the mix's, so that a short window on a busy host holds
    faulted requests."""
    c = harness.find_cell(root, CELL)
    if every is not None:
        c = c._replace(traffic=dict(c.traffic, fault_every=every))
    return harness.run_cell(c, SEED, seconds, traced, CPU,
                            time.perf_counter(), entry=entry_).result


def test_a_sound_faults_run_is_correct_with_one_repair_per_fault(tiny_root):
    r = run(tiny_root, traced=True, every=2)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 50
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert m["solver.repairs"] == 1.0
    assert m["solver.classify_ms"] > 0
    assert "solver.host_ms" not in m      # not one of this cell's metrics
    assert [k for k in r["checks"]][-2:] == ["bad_status",
                                             "unrepaired_planes"]


class Broken:
    """The program's entry with its repair path broken."""

    def __init__(self, fault):
        self.fault = fault

    def __getattr__(self, name):
        return getattr(entry, name)

    def Injector(self, mat, config):
        inj = entry.Injector(mat, config)
        if self.fault != "an injector that flips nothing":
            return inj

        class Idle(entry.Injector):
            def __call__(self, md, element, bits):
                return md

        return Idle(mat, config)

    def prepare(self, mat, config, traffic, device):
        solve = entry.prepare(mat, config, traffic, device)

        def broken(md, b):
            a = solve(md, b)
            if self.fault == "the repaired matrix dropped":
                return a._replace(md=md)
            if a.corrected != 1:
                return a
            if self.fault == "a correction reported at another slot":
                return a._replace(first_cor_slot=a.first_cor_slot + 1)
            if self.fault == "two corrections reported":
                return a._replace(corrected=2)
            if self.fault == "x altered on a faulted answer":
                x = a.x.clone()
                x[x.shape[0] // 3] += 1e-2 * float(x.abs().max())
                return a._replace(x=x)
            if self.fault == "planes left unrepaired":
                # a scrub that leaves one bit of the value plane wrong
                values = a.md.values.clone()
                values.view(torch.int32)[0] ^= 1
                return a._replace(md=a.md._replace(values=values))
            return a

        return broken


@pytest.mark.parametrize("fault", [
    "the repaired matrix dropped", "an injector that flips nothing",
    "a correction reported at another slot", "two corrections reported",
    "x altered on a faulted answer", "planes left unrepaired"])
def test_a_broken_repair_path_is_not_correct(tiny_root, fault):
    r = run(tiny_root, Broken(fault), every=2)
    assert r["attempted"] >= 2
    assert not r["correct"]
    if fault == "planes left unrepaired":
        assert r["checks"]["unrepaired_planes"]["value"] > 0
    else:
        assert r["failed"] > 0
