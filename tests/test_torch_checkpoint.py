"""The port's scrub and checkpoint/resume (scrub.py, solver/checkpoint.py,
``HostResult.scrubbed``) against the JAX package's.

Ports of tests/test_checkpoint_scrub.py (the 96-row tridiagonal in three
blocks), tests/test_fused.py::test_lazy_checkpointed_solve (on the
port's plain loop of kernel B's lazy instance) and the sharded cases of
tests/test_checkpoint_sharded.py (8 shards on the CPU).  Each runs the
JAX function and the port's on the same inputs:

  - float64 segmented and resumed solves: iterations and stats equal, x
    within rtol 1e-12 of JAX's (the two packages sum in one order on the
    CPU; JAX's own bound between its segmented and straight solves), and
    within the port bit for bit of its straight solve;
  - float32 (the kernel tiers' dtype): bit for bit against the port's
    straight solve, and JAX's iterations and stats with x to rtol 1e-4,
    atol 1e-5 (tests/test_torch_lazy.py's float32 bound);
  - scrub: the repaired planes, the report and the messages equal;
  - snapshots: either package's ``.npz`` loads in the other field for
    field, and the CLI resumes the other package's snapshot to the same
    stdout (``--checkpoint``/``--resume`` on ``-t jnp`` and ``-t torch``).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from abft_sparse_cg_tpu import cli as jcli
from abft_sparse_cg_tpu.backends import create as jcreate
from abft_sparse_cg_tpu.formats import assemble as jassemble
from abft_sparse_cg_tpu.formats import build_protected as jbuild
from abft_sparse_cg_tpu.inject import inject_bitflips as jinject
from abft_sparse_cg_tpu.ops.spmv import make_matrix_device as jmake_md
from abft_sparse_cg_tpu.ops.spmv import make_spmv as jmake_spmv
from abft_sparse_cg_tpu.scrub import scrub as jscrub
from abft_sparse_cg_tpu.scrub import scrubbed_from_device as jscrubbed
from abft_sparse_cg_tpu.solver import checkpoint as jck
from abft_sparse_cg_tpu.solver.cg import init_state as jinit_state
from abft_sparse_cg_tpu.utils.matgen import spd_tridiagonal
from abft_sparse_cg_tpu_torch import cli
from abft_sparse_cg_tpu_torch.backends.torch_backend import TorchBackend
from abft_sparse_cg_tpu_torch.formats import assemble, build_protected
from abft_sparse_cg_tpu_torch.inject import inject_bitflips
from abft_sparse_cg_tpu_torch.ops.spmv import make_matrix_device, make_spmv
from abft_sparse_cg_tpu_torch.parallel.sharded import (
    _device_put_sharded,
    default_mesh,
    make_sharded_continue,
    make_sharded_solver,
)
from abft_sparse_cg_tpu_torch.parallel.sharded_kernel import (
    supports_shardmap,
)
from abft_sparse_cg_tpu_torch.parallel.vector import ShardedVector
from abft_sparse_cg_tpu_torch.scrub import scrub, scrubbed_from_device
from abft_sparse_cg_tpu_torch.solver.cg import init_state
from abft_sparse_cg_tpu_torch.solver.checkpoint import (
    CheckpointedSolve,
    load_state,
    save_state,
)
from abft_sparse_cg_tpu_torch.solver.fused import (
    make_fused_continue,
    make_fused_solver,
)

CPU = torch.device("cpu")
F32, F64 = torch.float32, torch.float64
NDEV = 8
torch.set_num_threads(1)


def both(mode="secded", n=96, blocks=3, **kw):
    """(JAX matrix, port matrix) of the n-row tridiagonal in ``blocks``."""
    rows, cols, vals, n = spd_tridiagonal(n)
    return (jbuild("csr", jassemble(cols, rows, vals, n, blocks), mode,
                   **kw),
            build_protected("csr", assemble(cols, rows, vals, n, blocks),
                            mode, **kw))


def inject_both(jm, tm, kind, flips, seed):
    quiet = dict(echo=lambda s: None)
    return (jinject(jm, kind, flips, np.random.default_rng(seed), **quiet),
            inject_bitflips(tm, kind, flips, np.random.default_rng(seed),
                            **quiet))


def bvec(m, seed=11):
    b = np.zeros(m.R)
    b[: m.N] = np.random.default_rng(seed).random(m.N)
    return b


def jsolve(jm, b, max_itrs, tmp, every=3, resume=False, dtype=jnp.float64):
    """JAX's CheckpointedSolve over its plain SpMV."""
    return jck.CheckpointedSolve(
        jmake_spmv(jm, dtype), 1e-12, every=every,
        path=str(tmp / "j.npz")).run(jmake_md(jm, dtype),
                                     jnp.asarray(b, dtype), max_itrs,
                                     resume=resume)


def tsolve(tm, b, max_itrs, path, every=3, resume=False, dtype=F64,
           conv=1e-12):
    """The port's CheckpointedSolve over its plain SpMV."""
    return CheckpointedSolve(make_spmv(tm, dtype), conv, every=every,
                             path=str(path)).run(
        make_matrix_device(tm, dtype, CPU), torch.tensor(b, dtype=dtype),
        max_itrs, resume=resume)


def assert_same(jr, tr, rtol=1e-12, atol=0.0):
    assert tr.iterations == int(jr.iterations)
    assert tuple(tr.stats) == tuple(int(v) for v in jr.stats)
    it = tr.iterations
    np.testing.assert_allclose(tr.rr_trace[:it].numpy(),
                               np.asarray(jr.rr_trace)[:it], rtol=1e-10)
    np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x), rtol=rtol,
                               atol=atol)


def test_checkpoint_roundtrip_and_exchange(tmp_path):
    """save_state/load_state round trip, and each package loads the
    other's snapshot field for field (names, dtypes and values)."""
    jm, tm = both()
    b = bvec(tm)
    ts = init_state(torch.tensor(b), 100)
    tpath, jpath = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    save_state(tpath, ts)
    jck.save_state(jpath, jinit_state(jnp.asarray(b), 100))
    with np.load(tpath) as zt, np.load(jpath) as zj:
        assert sorted(zt.files) == sorted(zj.files)
        for f in zt.files:
            assert zt[f].dtype == zj[f].dtype and zt[f].shape == zj[f].shape
            # rr and rz: a float64 sum, in another order (1 ulp)
            np.testing.assert_allclose(zt[f], zj[f], rtol=1e-15)
    for path in (tpath, jpath):
        s2 = load_state(path, F64)
        assert s2.itr == ts.itr and s2.stats == ts.stats
        with np.load(path) as z:
            for f in ("x", "r", "p", "rr", "rz", "trace"):
                np.testing.assert_array_equal(getattr(s2, f).numpy(), z[f])
    js = jck.load_state(tpath, dtype=jnp.float64)
    assert int(js.itr) == 0


def test_segmented_solve_matches_straight(tmp_path):
    jm, tm = both()
    b = bvec(tm)
    seg = tsolve(tm, b, 500, tmp_path / "t.npz")
    assert_same(jsolve(jm, b, 500, tmp_path), seg)
    ref = TorchBackend("secded").solve(tm, b[: tm.N], 500, 1e-12)
    assert seg.iterations == ref.iterations
    np.testing.assert_array_equal(seg.x.numpy()[: tm.N], ref.x)
    np.testing.assert_array_equal(seg.rr_trace.numpy()[: ref.iterations],
                                  ref.rr_trace[: ref.iterations])


def test_resume_from_partial(tmp_path):
    """Four iterations, a "crash", then a resume to the end: JAX's
    iterations and x, and the port's straight solve's x bit for bit."""
    jm, tm = both()
    b = bvec(tm)
    path = tmp_path / "t.npz"
    r1 = tsolve(tm, b, 4, path, every=2)
    assert r1.iterations == 4
    r2 = tsolve(tm, b, 500, path, every=50, resume=True)
    jsolve(jm, b, 4, tmp_path, every=2)
    assert_same(jsolve(jm, b, 500, tmp_path, every=50, resume=True), r2)
    ref = TorchBackend("secded").solve(tm, b[: tm.N], 500, 1e-12)
    assert r2.iterations == ref.iterations
    np.testing.assert_array_equal(r2.x.numpy()[: tm.N], ref.x)


def test_scrub_repairs_injected_fault():
    jm, tm = both("sec8")
    jm2, tm2 = inject_both(jm, tm, "ANY", 1, 3)
    jrep, jreport = jscrub(jm2)
    repaired, report = scrub(tm2)
    assert report.corrected == 1 and report.uncorrectable == 0
    assert vars(report) == vars(jreport)
    assert any(s.startswith("[ECC] corrected") for s in report.messages)
    for n in tm.layout.word_names:
        np.testing.assert_array_equal(repaired.planes[n], tm.planes[n])
        np.testing.assert_array_equal(repaired.planes[n], jrep.planes[n])
        np.testing.assert_array_equal(repaired.ell[n], jrep.ell[n])
    np.testing.assert_array_equal(repaired.ell_cksum, jrep.ell_cksum)
    # The scrubbed matrix solves clean, with no further correction.
    b = np.random.default_rng(4).random(tm.N)
    res = TorchBackend("sec8").solve(repaired, b, 300, 1e-8)
    assert not res.failed and res.corrected_count == 0
    assert res.scrubbed is None


@pytest.mark.parametrize("mode,flips,kind,seed", [
    ("sed", 1, "ANY", 5), ("secded", 2, "VALUE", 12)])
def test_scrub_reports_sed_and_double(mode, flips, kind, seed):
    jm, tm = both(mode)
    jm2, tm2 = inject_both(jm, tm, kind, flips, seed)
    _, jrep = jscrub(jm2)
    _, rep = scrub(tm2)
    assert rep.uncorrectable >= 1 and vars(rep) == vars(jrep)
    want = ("error detected at index" if mode == "sed"
            else "double-bit error detected")
    assert any(want in s for s in rep.messages)


def test_segmented_solve_with_fault_matches_straight(tmp_path):
    """The repair across segment boundaries: the fault classifies once
    (the scrubbed device matrix is carried into the next segment), and
    the returned device planes are the repaired data, equal to JAX's."""
    jm, tm = both("secded")
    jm2, tm2 = inject_both(jm, tm, "ANY", 1, 9)
    b = bvec(tm2)
    seg = tsolve(tm2, b, 500, tmp_path / "t.npz", every=2)
    jseg = jsolve(jm2, b, 500, tmp_path, every=2)
    assert_same(jseg, seg)
    assert seg.stats.errcode == 0 and seg.stats.corrected_count == 1
    ref = TorchBackend("secded").solve(tm2, b[: tm2.N], 500, 1e-12)
    assert not ref.failed and seg.iterations == ref.iterations
    np.testing.assert_array_equal(seg.x.numpy()[: tm2.N], ref.x)
    repaired = scrubbed_from_device(tm2, seg.md)
    jrepaired = jscrubbed(jm2, jseg.md)
    for n in tm.layout.word_names:
        np.testing.assert_array_equal(repaired.planes[n], tm.planes[n])
        np.testing.assert_array_equal(repaired.planes[n],
                                      jrepaired.planes[n])
    np.testing.assert_array_equal(repaired.ell_cksum, jrepaired.ell_cksum)


@pytest.mark.parametrize("want", [True, "auto", False])
def test_solve_returns_scrubbed_matrix(want):
    """HostResult.scrubbed after a corrected solve: JAX's planes and
    checksums (the reference's in-place write-back), fully
    self-consistent: re-solving it raises no event.  "auto" is on for
    the CPU; False withholds it."""
    jm, tm = both("secded")
    jm2, tm2 = inject_both(jm, tm, "ANY", 1, 21)
    b = np.random.default_rng(8).random(tm.N)
    res = TorchBackend("secded").solve(tm2, b, 300, 1e-10,
                                       want_scrubbed=want)
    jres = jcreate("jnp", "secded").solve(jm2, b, 300, 1e-10, verbose=False,
                                          dtype="f64")
    assert not res.failed and res.corrected_count == 1
    assert res.messages == jres.messages
    if want is False:
        assert res.scrubbed is None
        return
    for n in tm.layout.word_names:
        np.testing.assert_array_equal(res.scrubbed.planes[n], tm.planes[n])
        np.testing.assert_array_equal(res.scrubbed.planes[n],
                                      jres.scrubbed.planes[n])
        np.testing.assert_array_equal(res.scrubbed.ell[n], jres.scrubbed.ell[n])
    np.testing.assert_array_equal(res.scrubbed.ell_cksum,
                                  jres.scrubbed.ell_cksum)
    res2 = TorchBackend("secded").solve(res.scrubbed, b, 300, 1e-10)
    assert not res2.failed and res2.corrected_count == 0 and not res2.messages
    assert res2.scrubbed is None


def test_scrubbed_split_and_mesh_padded_planes():
    """scrubbed_from_device on a bordered split's (main, tail) pair and
    on a mesh-padded upload (8 shards): the repaired canonical planes,
    equal to JAX's from its own solve."""
    n = 512
    rows, cols, vals, n = spd_tridiagonal(n)
    extra = [(r, c) for r in (20, 200) for c in range(0, n, 3)
             if abs(r - c) > 1]
    rows = np.concatenate([rows, [max(r, c) for r, c in extra]])
    cols = np.concatenate([cols, [min(r, c) for r, c in extra]])
    vals = np.concatenate([vals, np.full(len(extra), -1e-3)])
    split = [jbuild("csr", jassemble(cols, rows, vals, n, 1), "secded"),
             build_protected("csr", assemble(cols, rows, vals, n, 1),
                             "secded")]
    assert split[1].exec_kind == "split"
    for (jm, tm), devices in ((split, 0), (both("secded", n=500), 8)):
        jm2, tm2 = inject_both(jm, tm, "ANY", 1, 2)
        b = np.random.default_rng(1).random(tm.N)
        res = TorchBackend("secded").solve(tm2, b, 300, 1e-10,
                                           devices=devices)
        jres = jcreate("jnp", "secded").solve(jm2, b, 300, 1e-10,
                                              verbose=False, dtype="f64",
                                              devices=devices)
        assert res.corrected_count == jres.corrected_count == 1
        for n_ in tm.layout.word_names:
            np.testing.assert_array_equal(res.scrubbed.planes[n_],
                                          tm.planes[n_])
            np.testing.assert_array_equal(res.scrubbed.planes[n_],
                                          jres.scrubbed.planes[n_])


def test_lazy_checkpointed_solve(tmp_path):
    """tests/test_fused.py:559 on the port's plain loop of kernel B's
    lazy instance (CI 4, float32): segments of 3 verify at their
    boundaries, the mid-solve repair happens once, and x equals the
    one-shot live solve's on the clean matrix bit for bit; JAX's
    checkpointed solve of the same system in float32 gives the same
    iterations and stats, x within 1e-4."""
    jm, tm = both("secded", n=1024, blocks=1)
    jm2, tm2 = inject_both(jm, tm, "ANY", 1, 5)
    b = np.zeros(tm.R, np.float32)
    b[: tm.N] = np.random.default_rng(77).random(tm.N)
    cont = make_fused_continue(tm, "secded", 1e-8, check_interval=4)
    res = CheckpointedSolve(None, 1e-8, every=3,
                            path=str(tmp_path / "ck.npz"),
                            continue_fn=cont).run(
        make_matrix_device(tm2, F32, CPU), torch.tensor(b), 300)
    ref = make_fused_solver(tm, "secded", 300, 1e-8)(
        make_matrix_device(tm, F32, CPU), torch.tensor(b))
    assert res.stats.errcode == 0 and res.stats.corrected_count == 1
    assert res.iterations == ref.iterations
    assert torch.equal(res.x, ref.x)
    jres = jck.CheckpointedSolve(jmake_spmv(jm2, jnp.float32), 1e-8,
                                 every=3, path=str(tmp_path / "j.npz")).run(
        jmake_md(jm2, jnp.float32), jnp.asarray(b), 300)
    assert res.iterations == int(jres.iterations)
    assert tuple(res.stats) == tuple(int(v) for v in jres.stats)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x),
                               rtol=1e-4, atol=1e-5)


# --------------------------------------------------------------------------
# --devices: the sharded continue under CheckpointedSolve
# (tests/test_checkpoint_sharded.py)
# --------------------------------------------------------------------------

def _mesh():
    return default_mesh(NDEV, CPU)


def _put(tm, b, dtype=F32):
    md, bdev, _ = _device_put_sharded(tm, b, _mesh(), dtype)
    return md, bdev


def _runner(tm, path, every, dtype=F32, state_put=None):
    return CheckpointedSolve(
        None, 1e-7, every=every, path=str(path),
        continue_fn=make_sharded_continue(tm, _mesh(), 1e-7, dtype),
        state_put=state_put)


def _jax_straight(jm, b, max_itrs=200):
    """JAX's straight float32 solve of the system (the GSPMD program)."""
    return jcreate("jnp", jm.mode).solve(jm, b, max_itrs, 1e-7,
                                         verbose=False, dtype="f32",
                                         devices=NDEV)


def test_sharded_segmented_and_resumed_match_straight(tmp_path):
    """The single-device program on the mesh-padded planes (outside the
    kernel envelope): segmented and crash + resume (with state_put)
    equal the straight sharded solve bit for bit, and JAX's iterations."""
    jm, tm = both(n=512, blocks=2)
    assert not supports_shardmap(tm, F32, NDEV)
    b = np.random.default_rng(23).random(tm.N)
    md, bdev = _put(tm, b)
    straight = make_sharded_solver(tm, _mesh(), 200, 1e-7, F32)(md, bdev)
    assert straight.stats.errcode == 0
    seg = _runner(tm, tmp_path / "a.npz", 3).run(md, bdev, 200)
    assert seg.iterations == straight.iterations
    assert torch.equal(seg.x, straight.x)
    path = tmp_path / "b.npz"
    assert _runner(tm, path, 2).run(md, bdev, 4).iterations == 4
    dev = _mesh().devices[0]
    r2 = _runner(tm, path, 50, state_put=lambda v: v.to(dev)).run(
        md, bdev, 200, resume=True)
    assert r2.iterations == straight.iterations
    assert torch.equal(r2.x, straight.x)
    jres = _jax_straight(jm, b)
    assert r2.iterations == jres.iterations
    np.testing.assert_allclose(
        tm.from_exec_order(r2.x.numpy()[: tm.N]), jres.x, rtol=1e-4,
        atol=1e-5)


def test_sharded_fault_correction_across_segments(tmp_path):
    jm, tm = both(n=512, blocks=2)
    b = np.random.default_rng(23).random(tm.N)
    md, bdev = _put(tm, b)
    clean = make_sharded_solver(tm, _mesh(), 200, 1e-7, F32)(md, bdev)
    jm2, tm2 = inject_both(jm, tm, "ANY", 1, 7)
    md2, _ = _put(tm2, b)
    res = _runner(tm2, tmp_path / "c.npz", 3).run(md2, bdev, 200)
    assert res.stats.errcode == 0 and res.stats.corrected_count == 1
    assert torch.equal(res.x, clean.x)
    jres = _jax_straight(jm2, b)
    assert jres.corrected_count == 1 and res.iterations == jres.iterations


@pytest.mark.parametrize("inject", [False, True], ids=["clean", "fault"])
def test_shardmap_kernel_tier_checkpointed(tmp_path, inject):
    """Inside the kernel envelope (R a multiple of 1024 per shard): the
    per-shard kernels' plain versions under CheckpointedSolve, a crash
    after 4 iterations and a resume re-placed by state_put, bit for bit
    against the straight solve; a persistent fault corrects once per
    runner (the resumed process gets the still-faulty matrix), as in
    JAX's test."""
    jm, tm = both(n=1024 * NDEV - 64, blocks=1, row_align=1024 * NDEV)
    assert tm.exec_kind == "dia" and supports_shardmap(tm, F32, NDEV)
    b = np.random.default_rng(23).random(tm.N)
    md, bdev = _put(tm, b)
    straight = make_sharded_solver(tm, _mesh(), 100, 1e-7, F32)(md, bdev)
    assert straight.stats.errcode == 0
    if inject:
        jm, tm = inject_both(jm, tm, "ANY", 1, 13)
        md, _ = _put(tm, b)
    path = tmp_path / "d.npz"
    assert _runner(tm, path, 2).run(md, bdev, 4).iterations == 4
    devs = _mesh().devices
    r2 = _runner(tm, path, 50,
                 state_put=lambda v: ShardedVector.scatter(v, devs)).run(
        md, bdev, 100, resume=True)
    assert r2.stats.errcode == 0
    assert r2.stats.corrected_count == (2 if inject else 0)
    assert r2.iterations == straight.iterations
    assert torch.equal(r2.x, straight.x)
    jres = _jax_straight(jm, b, 100)
    assert r2.iterations == jres.iterations


# --------------------------------------------------------------------------
# The CLI: snapshots exchanged between -t jnp and -t torch
# --------------------------------------------------------------------------

def run(main, argv, capsys):
    try:
        code = main(argv)
    except SystemExit as e:
        code = e.code
    return code, capsys.readouterr().out


def contract_lines(out):
    return [ln.replace("jnp-", "T-").replace("torch-", "T-")
            for ln in out.splitlines()
            if not ln.startswith(("compile time", "time taken"))]


@pytest.fixture(scope="module")
def mtx(tmp_path_factory):
    from abft_sparse_cg_tpu_torch.utils.matgen import write_mm_triangle

    path = str(tmp_path_factory.mktemp("mtx") / "tri128.mtx")
    write_mm_triangle(path, *spd_tridiagonal(128))
    return path


@pytest.mark.parametrize("writer", ["jnp", "torch"])
@pytest.mark.parametrize("flags", [["-m", "secded", "-x"],
                                   ["-m", "none", "--devices", "8"]],
                         ids=["secded-x", "none-devices8"])
def test_cli_snapshot_resumes_in_the_other_package(mtx, tmp_path, writer,
                                                   flags, capsys):
    """A partial run (-i 4 --checkpoint P) on one target, then --resume
    on the other: stdout equal to a straight run's (JAX's), line for
    line, less the time lines and the target name."""
    mains = {"jnp": jcli.main_csr, "torch": cli.main_csr}
    reader = "torch" if writer == "jnp" else "jnp"
    path = str(tmp_path / "snap.npz")
    argv = ["-f", mtx, "-b", "4", "--seed", "5", "--dtype", "f64", *flags]
    code, _ = run(mains[writer], argv + ["-t", writer, "-i", "4",
                                         "--checkpoint", path], capsys)
    assert code == 0 and os.path.exists(path)
    code, out = run(mains[reader], argv + ["-t", reader, "--checkpoint",
                                           path, "--resume"], capsys)
    jcode, jout = run(jcli.main_csr, argv + ["-t", "jnp"], capsys)
    assert code == jcode == 0
    assert contract_lines(out) == contract_lines(jout)
