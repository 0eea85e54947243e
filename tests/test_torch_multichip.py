"""The row-sharded solve with per-shard residency, on CPU meshes.

  - the port's ``parallel.dryrun.dryrun_multichip`` at 4 shards against
    the JAX function itself (``__graft_entry__.dryrun_multichip`` on
    conftest.py's 8-device virtual mesh, its Pallas kernels in interpret
    mode), every solve captured: equal iterations and corrections, x
    within rtol 2e-5, atol 1e-7 in float32 (a split within JAX's split
    bound, rtol 2e-3, atol 5e-6; tests/test_sharded.py:348-352); at 8
    shards against the JAX function's recorded lines at 8 devices
    (MULTICHIP_r05.json), whose iterations it must equal;
  - residency: each shard's planes uploaded from the host straight onto
    its device equal those rows of the whole upload, and after the upload
    and after a solve with one repair every row-holding tensor (planes,
    x, r, p, w, M^-1, x_ext and the lazy snapshot) is one shard's: R_loc
    rows (R_loc + 2H for an x_ext) in storage of its own;
  - the exchange copies only edges: 2H rows into each interior shard per
    call, and no w is concatenated;
  - a --checkpoint snapshot written at one shard count resumes at
    another;
  - ShardedVector's arithmetic and reductions.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

import abft_sparse_cg_tpu.parallel.sharded as jsharded
from abft_sparse_cg_tpu_torch.backends.torch_backend import (
    TorchBackend,
    jacobi_minv,
)
from abft_sparse_cg_tpu_torch.formats import assemble, build_protected
from abft_sparse_cg_tpu_torch.inject import inject_bitflips
from abft_sparse_cg_tpu_torch.ops.spmv import make_matrix_device
from abft_sparse_cg_tpu_torch.parallel import dryrun, sharded_kernel
from abft_sparse_cg_tpu_torch.parallel.sharded import (
    ShardedDevice,
    _device_put_sharded,
    default_mesh,
    make_sharded_continue,
    shard_rows,
    upload_shards,
)
from abft_sparse_cg_tpu_torch.parallel.sharded_kernel import (
    _halo,
    make_shardmap_spmv,
    supports_shardmap,
)
from abft_sparse_cg_tpu_torch.parallel.vector import ShardedVector
from abft_sparse_cg_tpu_torch.solver import cg as tcg
from abft_sparse_cg_tpu_torch.utils.matgen import (
    shuffle_labels,
    spd_tridiagonal,
)

CPU = torch.device("cpu")
F32 = torch.float32
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(1)

# The JAX function's solves in the order it runs them: (label, index of
# the solve within the label).
JAX_ORDER = [
    "dia/secded/clean", "dia/secded/injected", "ell/sec8/clean",
    "split/secded/clean", "split/secded/injected",
    "shardmap-kernel/dia/secded", "shardmap-kernel/dia/secded",
    "shardmap-kernel/wideband/secded",
    "shardmap-kernel/split/secded", "shardmap-kernel/split/secded",
    "shardmap-kernel/highk129/secded",
    "shardmap-kernel/dia/secded/lazy-ci4",
    "shardmap-kernel/dia/secded/lazy-ci4",
]
LABELS = list(dict.fromkeys(JAX_ORDER))


def _jax_dryrun(n, monkeypatch):
    """The JAX function's solves, in order: ``solve_sharded``'s results
    and those of the functions it jits itself."""
    import __graft_entry__

    got, depth = [], [0]
    real_solve, real_jit = jsharded.solve_sharded, jax.jit

    def solve(*a, **k):
        depth[0] += 1
        try:
            res = real_solve(*a, **k)
        finally:
            depth[0] -= 1
        got.append(res)
        return res

    def jit(f, *a, **k):
        g = real_jit(f, *a, **k)

        def call(*args, **kw):
            res = g(*args, **kw)
            if depth[0] == 0 and hasattr(res, "rr_trace"):
                got.append(res)
            return res

        return call

    monkeypatch.setattr(jsharded, "solve_sharded", solve)
    monkeypatch.setattr(jax, "jit", jit)
    __graft_entry__.dryrun_multichip(n)
    monkeypatch.undo()
    return got


def _port_lines(n):
    lines = []
    out = dryrun.dryrun_multichip(n, CPU, echo=lines.append)
    return out, lines


def test_dryrun_matches_the_jax_function_at_4(monkeypatch):
    """Every solve of the ten configurations: iterations and corrections
    equal, x within the float32 bound; the port's own bit-equalities are
    its asserts."""
    out, lines = _port_lines(4)
    ref = _jax_dryrun(4, monkeypatch)
    got = [s for label in LABELS for s in out[label]]
    assert len(ref) == len(got) == len(JAX_ORDER)
    for label, r, g in zip(JAX_ORDER, ref, got):
        assert g["iterations"] == int(r.iterations), label
        assert g["corrected"] == int(r.stats.corrected_count), label
        tol = (dict(rtol=2e-3, atol=5e-6) if "split" in label
               else dict(rtol=2e-5, atol=1e-7))
        np.testing.assert_allclose(g["x"], np.asarray(r.x), **tol,
                                   err_msg=label)
    assert [ln.split(":")[0] for ln in lines] == [
        f"dryrun_multichip(4) {label}" for label in LABELS]


def test_dryrun_at_8_matches_the_recorded_jax_lines():
    """Ten lines under the JAX labels at 8 shards, each with its tier;
    the iterations each line reports equal the JAX function's at 8
    devices (MULTICHIP_r05.json)."""
    with open(os.path.join(REPO, "MULTICHIP_r05.json")) as f:
        rec = json.load(f)
    assert rec["n_devices"] == 8 and rec["ok"]
    want = {}
    for ln in rec["tail"].splitlines():
        label, msg = ln.split(": ", 1)
        want[label.split(" ", 1)[1]] = int(msg.split(" iterations")[0]
                                           .split()[-1])
    out, lines = _port_lines(8)
    assert list(want) == LABELS and list(out) == LABELS
    assert len(lines) == 10
    for label, ln in zip(LABELS, lines):
        assert ln.startswith(f"dryrun_multichip(8) {label}: ")
        assert out[label][-1]["iterations"] == want[label], label
        tier = out[label][-1]["tier"]
        assert ln.endswith(f"[{tier}]")
        assert tier.startswith("kernel tier" if "shardmap" in label
                               else "single-device program")


# ---- residency -------------------------------------------------------------

N_SHARDS = 4


def _mat(config, mode="secded"):
    """4096-row matrices of the kernel tier at 4 shards."""
    if config == "split":
        br, bc, bv, bn = dryrun._bordered(1024)
        m = build_protected("csr", assemble(bc, br, bv, bn, 1), mode,
                            row_align=4096)
        assert m.exec_kind == "split"
        return m
    rows, cols, vals, n = spd_tridiagonal(4096)
    kw = {}
    if config != "dia":
        kw["force_exec"] = "ell"
    if config == "ell-perm":
        rows, cols, vals, n = shuffle_labels(rows, cols, vals, n, seed=3)
    m = build_protected("csr", assemble(cols, rows, vals, n, 1), mode, **kw)
    assert m.exec_kind == ("dia" if config == "dia" else "ell")
    return m


def _own(t, rows, what):
    """``t`` holds ``rows`` rows (its last axis) in storage of its own."""
    assert t.shape[-1] == rows, (what, tuple(t.shape), rows)
    assert t.untyped_storage().nbytes() == t.numel() * t.element_size(), (
        what, "a view of a larger tensor")


def _check_shards(smd, R_loc, dev=CPU):
    assert isinstance(smd, ShardedDevice) and len(smd.shards) == N_SHARDS
    for s, md in enumerate(smd.shards):
        for name, t in md._asdict().items():
            if t is None:
                continue
            for i, tt in enumerate(t if name == "words" else (t,)):
                per = 8 if name in ("cksum", "fold_ck") else 1
                _own(tt, R_loc // per, f"shard {s} {name} {i}")
                assert tt.device == dev
        assert md.perm_pos is None


def _check_vector(v, R_loc, what):
    assert isinstance(v, ShardedVector), what
    assert len(v.parts) == N_SHARDS, what
    for s, p in enumerate(v.parts):
        _own(p, R_loc, f"{what} shard {s}")


# Constraints mode never reorders: a shuffled matrix keeps no band there.
UPLOADS = [(c, m) for c in ("dia", "ell", "ell-perm", "split")
           for m in ("secded", "constraints", "sec7")
           if (c, m) != ("ell-perm", "constraints")]


@pytest.mark.parametrize("config,mode", UPLOADS,
                         ids=[f"{c}-{m}" for c, m in UPLOADS])
def test_shard_upload_equals_the_rows_of_the_whole_upload(config, mode):
    m = _mat(config, mode)
    main = m.main if m.exec_kind == "split" else m
    assert supports_shardmap(main, F32, N_SHARDS)
    mesh = default_mesh(N_SHARDS, CPU)
    got = upload_shards(main, mesh, F32)
    want = shard_rows(make_matrix_device(main, F32, CPU), mesh)
    _check_shards(got, main.R // N_SHARDS)
    for s in range(N_SHARDS):
        for name, t in got.shards[s]._asdict().items():
            w = getattr(want[s], name)
            if name == "words":
                assert all(torch.equal(a, b) for a, b in zip(t, w))
            elif t is None or w is None:
                assert t is None and w is None, name
            else:
                assert torch.equal(t, w), (s, name)


@pytest.mark.parametrize("config", ["dia", "ell-perm", "split"])
def test_nothing_whole_stays_resident(config, monkeypatch):
    """Upload, then a lazy (CI 4) Jacobi solve with one repair: the
    planes, b, M^-1, and every x, r, p, w, x_ext and snapshot the loop
    makes are per-shard tensors; the returned planes too."""
    m = _mat(config)
    main = m.main if m.exec_kind == "split" else m
    R_loc = main.R // N_SHARDS
    H = _halo(main)
    mesh = default_mesh(N_SHARDS, CPU)
    b = np.random.default_rng(2).random(m.N)
    faulty = inject_bitflips(m, "ANY", 1, np.random.default_rng(4),
                             echo=lambda s: None)
    md, bdev, put = _device_put_sharded(faulty, b, mesh, F32)
    smd = md[0] if m.exec_kind == "split" else md
    _check_shards(smd, R_loc)
    _check_vector(bdev, R_loc, "b")
    minv = put(jacobi_minv(faulty, "jacobi"))
    _check_vector(minv, R_loc, "minv")

    seen = {"iterate": [], "snap": [], "ext": []}
    real_iterate, real_resolve = tcg._iterate, tcg._lazy_exit_resolve
    real_exchange = sharded_kernel.halo_exchange

    def iterate(x, r, p, rr, rz, w, minv=None, pw=None):
        seen["iterate"].append((x, r, p, w))
        return real_iterate(x, r, p, rr, rz, w, minv, pw)

    def resolve(md_, s1, snap, *a, **k):
        seen["snap"].append(snap)
        return real_resolve(md_, s1, snap, *a, **k)

    def exchange(x, halo, out=None):
        ext = real_exchange(x, halo, out)
        seen["ext"].append(ext)
        return ext

    monkeypatch.setattr(tcg, "_iterate", iterate)
    monkeypatch.setattr(tcg, "_lazy_exit_resolve", resolve)
    monkeypatch.setattr(sharded_kernel, "halo_exchange", exchange)
    cont = make_sharded_continue(faulty, mesh, 1e-6, F32, check_interval=4)
    state, md_out = cont(md, tcg.init_state(bdev, 300, minv), 300, minv)
    assert state.stats.errcode == 0 and state.stats.corrected_count == 1
    assert seen["iterate"] and seen["snap"] and seen["ext"]
    for k, vecs in enumerate(seen["iterate"]):
        for name, v in zip("xrpw", vecs):
            _check_vector(v, R_loc, f"iteration {k} {name}")
    for snap in seen["snap"]:
        for name in "xrp":
            _check_vector(getattr(snap, name), R_loc, f"snapshot {name}")
    for ext in seen["ext"]:
        assert len(ext) == N_SHARDS
        for e in ext:
            _own(e, R_loc + 2 * H, "x_ext")
    for name in "xrp":
        _check_vector(getattr(state, name), R_loc, f"final {name}")
    _check_shards(md_out[0] if m.exec_kind == "split" else md_out, R_loc)


@pytest.mark.parametrize("config", ["dia", "ell", "split"])
def test_exchange_copies_only_edges(config, monkeypatch):
    """Per sharded product, 2H rows cross into each interior shard (H
    into each end shard), each from its neighbour's rows; w stays on the
    shards and nothing is concatenated (a split's tail gathers p, its one
    all-gather)."""
    m = _mat(config)
    main = m.main if m.exec_kind == "split" else m
    R_loc, H = main.R // N_SHARDS, _halo(main)
    mesh = default_mesh(N_SHARDS, CPU)
    md, bdev, _ = _device_put_sharded(m, np.ones(m.N), mesh, F32)
    impl = make_shardmap_spmv(m, mesh)
    impl.fast_pw(md, bdev)
    copies, cats = [], []
    real_copy, real_cat = sharded_kernel.copy_edge, torch.cat

    def copy_edge(dst, src):
        copies.append((dst.untyped_storage().data_ptr(),
                       src.untyped_storage().data_ptr(), dst.shape[0]))
        real_copy(dst, src)

    def cat(ts, *a, **k):
        cats.append([t.shape[0] for t in ts])
        return real_cat(ts, *a, **k)

    monkeypatch.setattr(sharded_kernel, "copy_edge", copy_edge)
    monkeypatch.setattr(torch, "cat", cat)
    for _ in range(2):
        copies.clear()
        cats.clear()
        w, trig, pw = impl.fast_pw(md, bdev)
        per_dst = {}
        for dst, src, rows in copies:
            per_dst.setdefault(dst, []).append((src, rows))
        parts = [p.untyped_storage().data_ptr() for p in bdev.parts]
        assert [sum(r for _, r in v) for v in per_dst.values()] == [
            H, 2 * H, 2 * H, H]
        for s, v in enumerate(per_dst.values()):
            want = {parts[t] for t in (s - 1, s + 1) if 0 <= t < N_SHARDS}
            assert {src for src, _ in v} == want
        _check_vector(w, R_loc, "w")
        assert trig.dim() == 0 and pw.dim() == 0
        if config == "split":
            assert cats == [[R_loc] * N_SHARDS]      # p onto the first shard
        else:
            assert cats == []


# ---- --checkpoint across shard counts ---------------------------------------

def _built_for(shards, n=8000):
    """The 8,000-row tridiagonal as the CLI builds it for ``shards``
    (R aligned to 1024 rows per shard past one shard: 8,192 rows, else
    8,064), so that snapshots of two shard counts differ in zero pad rows
    too."""
    rows, cols, vals, n = spd_tridiagonal(n)
    m = build_protected("csr", assemble(cols, rows, vals, n, 1), "secded",
                        row_align=1024 * shards if shards > 1 else None)
    assert m.R == (8192 if shards > 1 else 8064)
    assert shards == 1 or supports_shardmap(m, F32, shards)
    return m


@pytest.mark.parametrize("written,resumed", [(8, 1), (8, 4), (1, 8), (4, 8)])
def test_snapshot_resumes_at_another_shard_count(tmp_path, written,
                                                 resumed):
    """A snapshot of a 4-iteration run at ``written`` shards resumes at
    ``resumed`` and lands on the straight ``resumed``-shard solve."""
    m = _built_for(resumed)
    b = np.random.default_rng(7).random(m.N)
    be = TorchBackend("secded")
    path = str(tmp_path / "s.npz")
    part = be.solve(_built_for(written), b, 4, 1e-6, dtype="f32",
                    devices=written, checkpoint=path, checkpoint_every=2)
    assert part.iterations == 4 and not part.failed
    res = be.solve(m, b, 300, 1e-6, dtype="f32", devices=resumed,
                   checkpoint=path, checkpoint_every=50, resume=True)
    straight = be.solve(m, b, 300, 1e-6, dtype="f32", devices=resumed,
                        reps=1)
    assert not res.failed and res.iterations == straight.iterations
    np.testing.assert_allclose(res.x, straight.x, rtol=2e-5, atol=1e-7)


# ---- ShardedVector ----------------------------------------------------------

def _sv(seed=0, n=4, rows=64, dtype=F32):
    v = torch.tensor(np.random.default_rng(seed).standard_normal(n * rows),
                     dtype=dtype)
    return v, ShardedVector.scatter(v, default_mesh(n, CPU).devices)


def test_sharded_vector_arithmetic_is_per_shard():
    x, xs = _sv(0)
    y, ys = _sv(1)
    a = torch.tensor(0.75)
    for got, want in ((xs + ys, x + y), (xs - ys, x - y), (xs * ys, x * y),
                      (a * xs, a * x), (xs * a, x * a),
                      (ys + a * xs, y + a * x), (2.0 - xs, 2.0 - x),
                      (torch.zeros_like(xs), torch.zeros_like(x)),
                      (torch.clone(xs), x)):
        assert isinstance(got, ShardedVector)
        assert torch.equal(got.cpu(), want)
    assert torch.equal(torch.isfinite(xs).cpu(), torch.isfinite(x))
    c = torch.clone(xs)
    assert all(p.data_ptr() != q.data_ptr() for p, q in zip(c.parts, xs.parts))


def test_sharded_vector_sum_is_shard_partials_in_order():
    x, xs = _sv(2, rows=1000)
    want = torch.sum(x[:1000])
    for s in range(1, 4):
        want = want + torch.sum(x[s * 1000:(s + 1) * 1000])
    got = torch.sum(xs * xs)
    assert got.dim() == 0 and got.device == CPU
    assert torch.equal(torch.sum(xs), want)
    torch.testing.assert_close(got, torch.sum(x * x), rtol=1e-5, atol=0)


def test_sharded_vector_gather_equal_and_refusals():
    x, xs = _sv(3)
    assert torch.equal(xs.cpu(), x) and np.array_equal(xs.numpy(), x.numpy())
    assert xs.shape == x.shape
    assert xs.dtype == F32 and xs.device == CPU
    assert torch.equal(xs, ShardedVector.scatter(x, xs.devices))
    assert not torch.equal(xs, xs + 1.0)
    with pytest.raises(TypeError):
        torch.dot(xs, xs)
    with pytest.raises(TypeError):
        xs + x                       # a whole vector never mixes in
    with pytest.raises(ValueError):
        ShardedVector.scatter(torch.zeros(10), xs.devices)
    with pytest.raises(ValueError):
        xs + _sv(3, n=2, rows=128)[1]
