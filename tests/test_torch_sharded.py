"""The port's row-sharded solve (parallel/) against the JAX package's.

On the 8-device virtual CPU mesh of conftest.py, with the 8192-row SPD
tridiagonal of tests/test_sharded.py::_kernel_mat (DIA; forced to ELL;
label-shuffled and forced to ELL under its RCM permutation), a wide-band
ELL matrix over 4 shards and a bordered split:

  - kernels A's and C's per-shard plain versions (``dia_fast_plain(...,
    halo=H)``, ``ell_fast_plain(..., halo=H, base=b)``) against the Pallas
    kernels' ``halo`` / ``with_base`` variants in interpret mode on the
    same x_ext, every mode, with and without detection: w and the
    trigger exact, pw within 1e-6 relative (summed in another order);
  - ``halo_exchange`` against the two ``lax.ppermute`` edges;
  - the sharded solve against JAX's shard_map solve and ``solve_sharded``:
    equal iterations, x within rtol 2e-5, atol 1e-7 in float32 (JAX's
    own bound, tests/test_sharded.py:270-284; a split's flat tail sums in
    kernel E's order, another than the segment sum's, and takes JAX's
    split bound, tests/test_sharded.py:350-353), within 1e-10 in float64;
  - faults in an interior and in a shard-boundary row, the lazy
    schedule, Jacobi, the envelope, and the out-of-window clamp of a
    corrupted gather index.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from abft_sparse_cg_tpu.backends import create as jcreate
from abft_sparse_cg_tpu.formats import assemble as jassemble
from abft_sparse_cg_tpu.formats import build_protected as jbuild
from abft_sparse_cg_tpu.ops.spmv import MatrixDevice as JMatrixDevice
from abft_sparse_cg_tpu.ops.spmv import make_matrix_device as jmake_md
from abft_sparse_cg_tpu.ops.spmv_pallas import _make_dia_fast, _make_ellb_fast
from abft_sparse_cg_tpu.parallel import sharded as jsharded
from abft_sparse_cg_tpu.parallel import sharded_kernel as jsk
from abft_sparse_cg_tpu.solver.cg import make_cg_solver as jmake_cg
from abft_sparse_cg_tpu.utils.matgen import (
    shuffle_labels,
    spd_tridiagonal,
    spd_wideband,
)
from abft_sparse_cg_tpu_torch.backends.cuda_backend import CudaBackend
from abft_sparse_cg_tpu_torch.backends.torch_backend import TorchBackend
from abft_sparse_cg_tpu_torch.formats import assemble, build_protected
from abft_sparse_cg_tpu_torch.inject import inject_bitflips
from abft_sparse_cg_tpu_torch.ops.spmv import make_matrix_device
from abft_sparse_cg_tpu_torch.ops.spmv_cuda import (
    dia_fast_halo,
    dia_fast_plain,
    dia_spec,
    ell_fast_halo,
    ell_fast_plain,
    ell_spec,
    product_spec,
)
from abft_sparse_cg_tpu_torch.parallel.sharded import (
    ShardedDevice,
    _device_put_sharded,
    default_mesh,
    make_sharded_solver,
    shard_rows,
    solve_sharded,
)
from abft_sparse_cg_tpu_torch.parallel.sharded_kernel import (
    _halo,
    halo_exchange,
    make_shardmap_spmv,
    supports_shardmap,
)
from abft_sparse_cg_tpu_torch.parallel.vector import ShardedVector

MODES = ["none", "constraints", "sed", "sec7", "sec8", "secded"]
CPU = torch.device("cpu")
F32 = torch.float32
torch.set_num_threads(1)


def _bordered(n=8000, dense_rows=(17, 900), spread=300):
    """tests/test_sharded.py::_bordered: a tridiagonal core and dense
    rows, which the build lays out as a bordered split."""
    rows, cols, vals, n = spd_tridiagonal(n)
    rows, cols, vals = list(rows), list(cols), list(vals)
    rng = np.random.default_rng(3)
    for r in dense_rows:
        targets = np.setdiff1d(rng.choice(n, size=spread, replace=False),
                               [r - 1, r, r + 1])
        for c in targets:
            rows.append(max(r, int(c)))
            cols.append(min(r, int(c)))
            vals.append(-0.01)
    rows, cols = np.array(rows), np.array(cols)
    vals = np.array(vals, dtype=float)
    deg = np.bincount(rows, minlength=n) + np.bincount(cols, minlength=n)
    diag = rows == cols
    vals[diag] = deg.astype(float)[rows[diag]] + 4.0
    return rows, cols, vals, n


# name -> (triplets, build kwargs, shards)
CONFIGS = {
    "dia": (lambda: spd_tridiagonal(8192), {}, 8),
    "ell": (lambda: spd_tridiagonal(8192), {"force_exec": "ell"}, 8),
    "ell-perm": (lambda: shuffle_labels(*spd_tridiagonal(8192), seed=3),
                 {"force_exec": "ell"}, 8),
    "wide-band": (lambda: spd_wideband(12288, 2500),
                  {"force_exec": "ell", "reorder": "none"}, 4),
    "split": (lambda: _bordered(), {"row_align": 8192}, 8),
}


def both(config, mode="secded"):
    """(JAX build, port build, shards) of a config."""
    make, kw, n = CONFIGS[config]
    rows, cols, vals, N = make()
    jm = jbuild("csr", jassemble(cols, rows, vals, N, 1), mode, **kw)
    tm = build_protected("csr", assemble(cols, rows, vals, N, 1), mode,
                         **kw)
    return jm, tm, n


def _exchange(x, mesh, H):
    """``halo_exchange`` of a whole vector ``x``, put on the shards of
    ``mesh`` first."""
    return halo_exchange(ShardedVector.scatter(x, mesh.devices), H)


def bvec(m, seed=2):
    return np.random.default_rng(seed).random(m.N)


def flip(m, row, word="value_lo", bit=3):
    """``m`` with one bit flipped in the first stored entry of exec row
    ``row`` (stored checksums kept, as an injection keeps them)."""
    slot = np.flatnonzero(m.ell_slot % m.R == row)[0]
    planes = {k: v.copy() for k, v in m.planes.items()}
    planes[word][slot] ^= np.uint32(1 << bit)
    return m.with_planes(planes)


# ---- per-shard kernels against the Pallas halo variants --------------------

def _jax_shard(jmd, s, R_loc):
    """Shard s of a JAX MatrixDevice, as the shard_map body sees it."""
    sl = slice(s * R_loc, (s + 1) * R_loc)
    c8 = slice(s * R_loc // 8, (s + 1) * R_loc // 8)
    opt = (lambda a, c: None if a is None else a[:, c])   # noqa: E731
    return JMatrixDevice(words=tuple(w[:, sl] for w in jmd.words),
                         ell_len=None, cksum=jmd.cksum[:, c8],
                         values=jmd.values[:, sl], gidx=opt(jmd.gidx, sl),
                         fold=opt(jmd.fold, sl), fold_ck=opt(jmd.fold_ck, c8))


@pytest.mark.parametrize("detect", [True, False], ids=["detect", "product"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("config", ["dia", "ell", "ell-perm"])
def test_shard_plain_matches_pallas_halo_kernels(config, mode, detect):
    """Every shard's w and trigger exact, pw within 1e-6, clean and with
    a fault in a shard-boundary row (in the next shard's halo)."""
    jm0, tm0, n = both(config, mode)
    if not jsk.supports_shardmap(jm0, jnp.float32, n):
        pytest.skip("outside the JAX envelope (constraints mode keeps the "
                    "shuffled labels: no RCM band)")
    R_loc, H = tm0.R // n, _halo(tm0)
    assert H == jsk._halo(jm0)
    local = jsk._LocalView(jm0, R_loc)
    if tm0.exec_kind == "dia":
        _, fast_pw = _make_dia_fast(local, mode, True, halo=H,
                                    detect=detect)
        kernel = jax.jit(fast_pw)
        spec = dia_spec(tm0, mode)
    else:
        _, fast_pw = _make_ellb_fast(local, mode, True, halo=True,
                                     with_base=True, detect=detect)
        kernel = jax.jit(fast_pw)
        spec = ell_spec(tm0, mode)
    if not detect:
        spec = product_spec(tm0, mode)
    mesh = default_mesh(n, CPU)
    x = np.random.default_rng(1).standard_normal(tm0.R).astype(np.float32)
    x_ext = _exchange(torch.tensor(x), mesh, H)
    cases = [("clean", jm0, tm0)]
    if mode != "none":
        # A col bit: in every detecting mode's signals, and (ECC byte
        # masked or not) the index stays inside the window.
        cases.append(("boundary fault", flip(jm0, 2 * R_loc - 1, "col"),
                      flip(tm0, 2 * R_loc - 1, "col")))
    for label, jm, tm in cases:
        jmd = jmake_md(jm, jnp.float32)
        shards = shard_rows(make_matrix_device(tm, F32, CPU), mesh)
        fired = False
        for s in range(n):
            xj = jnp.asarray(x_ext[s].numpy())
            if tm.exec_kind == "dia":
                jw, jt, jpw = kernel(_jax_shard(jmd, s, R_loc), xj)
                tw, tt, tpw = dia_fast_halo(shards[s], x_ext[s], spec, H)
            else:
                jw, jt, jpw = kernel(_jax_shard(jmd, s, R_loc), xj,
                                     s * R_loc)
                tw, tt, tpw = ell_fast_halo(shards[s], x_ext[s], spec, H,
                                            s * R_loc)
            np.testing.assert_array_equal(tw.numpy(), np.asarray(jw),
                                          err_msg=f"{label} shard {s}")
            assert bool(tt) == bool(jt), (label, s)
            np.testing.assert_allclose(float(tpw), float(jpw), rtol=1e-6)
            fired |= bool(tt)
            if bool(tt):
                assert s == 1, (label, s)   # the faulted row's own shard
        assert fired == (label != "clean" and detect), label


def test_halo_plain_reads_only_the_window():
    """The halo forms read x only through x_ext: rows of the neighbours
    past the halo do not reach a shard's w."""
    _, tm, n = both("dia")
    H, R_loc = _halo(tm), tm.R // n
    md = shard_rows(make_matrix_device(tm, F32, CPU), default_mesh(n, CPU))
    x = torch.ones(tm.R)
    ext = _exchange(x, default_mesh(n, CPU), H)[3]
    w = dia_fast_plain(md[3], ext, dia_spec(tm, "secded"), H)[0]
    x[: 3 * R_loc - H] = float("nan")
    x[4 * R_loc + H:] = float("nan")
    ext2 = _exchange(x, default_mesh(n, CPU), H)[3]
    assert torch.equal(dia_fast_plain(md[3], ext2, dia_spec(tm, "secded"),
                                      H)[0], w)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_halo_exchange_matches_ppermute_edges(n):
    """x_ext of every shard equals [ppermute(tail) | x_s | ppermute(head)]
    of the shard_map body (sharded_kernel.py:173-175): zeros at the
    global ends."""
    R_loc, H = 1024, 256
    x = np.random.default_rng(n).standard_normal(n * R_loc)
    mesh = jsharded.default_mesh(n)
    axis = mesh.axis_names[0]
    fwd = [(i, i + 1) for i in range(n - 1)]
    bwd = [(i + 1, i) for i in range(n - 1)]

    def body(xs):
        lo = jax.lax.ppermute(xs[R_loc - H:], axis, fwd)
        hi = jax.lax.ppermute(xs[:H], axis, bwd)
        return jnp.concatenate([lo, xs, hi])

    want = np.asarray(jax.shard_map(body, mesh=mesh, in_specs=P(axis),
                                    out_specs=P(axis))(jnp.asarray(x)))
    got = _exchange(torch.tensor(x), default_mesh(n, CPU), H)
    assert len(got) == n
    for s in range(n):
        np.testing.assert_array_equal(
            got[s].numpy(), want[s * (R_loc + 2 * H):(s + 1) * (R_loc + 2 * H)])
    assert not got[0][:H].any() and not got[-1][-H:].any()


# ---- the sharded solve -------------------------------------------------------

def _jax_shardmap_solve(jm, n, b, mode="secded", max_itrs=200, conv=1e-6):
    mesh = jsharded.default_mesh(n)
    impl = jsk.make_shardmap_spmv(jm, mesh, jnp.float32, mode,
                                  interpret=True)
    md, bdev, _ = jsharded._device_put_sharded(jm, b, mesh, jnp.float32)
    return jax.jit(jmake_cg(impl, max_itrs, conv))(md, bdev, None)


def _port_solve(tm, n, b, dtype=F32, max_itrs=200, conv=1e-6, **kw):
    mesh = default_mesh(n, CPU)
    md, bdev, _ = _device_put_sharded(tm, b, mesh, dtype)
    return make_sharded_solver(tm, mesh, max_itrs, conv, dtype, **kw)(
        md, bdev)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_sharded_solve_matches_jax_shardmap(config):
    jm, tm, n = both(config)
    assert supports_shardmap(tm, F32, n)
    b = bvec(tm)
    ref = _jax_shardmap_solve(jm, n, b)
    got = _port_solve(tm, n, b)
    assert got.stats.errcode == 0 and int(ref.stats.errcode) == 0
    assert got.iterations == int(ref.iterations)
    tol = (dict(rtol=2e-3, atol=5e-6) if config == "split"
           else dict(rtol=2e-5, atol=1e-7))
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), **tol)
    # solve_sharded takes the same tier, and gives the same numbers.
    again = solve_sharded(tm, b, 200, 1e-6, mesh=default_mesh(n, CPU))
    assert torch.equal(again.x, got.x)


@pytest.mark.parametrize("config", ["dia", "ell-perm", "split"])
def test_sharded_solve_f64_matches_jax_solve_sharded(config):
    """Float64 is outside the kernel envelope: the single-device program
    on the mesh-padded planes, against JAX's GSPMD ``solve_sharded``."""
    jm, tm, n = both(config)
    assert not supports_shardmap(tm, torch.float64, n)
    b = bvec(tm)
    ref = jsharded.solve_sharded(jm, b, 300, 1e-10,
                                 mesh=jsharded.default_mesh(n),
                                 dtype=jnp.float64)
    got = solve_sharded(tm, b, 300, 1e-10, mesh=default_mesh(n, CPU),
                        dtype=torch.float64)
    assert got.iterations == int(ref.iterations)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x),
                               rtol=1e-10, atol=1e-13)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("config", ["dia", "ell", "split"])
def test_torch_target_devices_matches_jax(config, dtype):
    """``-t torch`` with devices=8 (the kernel tier's plain versions in
    float32, the single-device program in float64) against the JAX
    ``jnp`` target's devices=8 solve."""
    jm, tm, n = both(config)
    b = bvec(tm)
    ref = jcreate("jnp", "secded").solve(jm, b, 200, 1e-6, verbose=False,
                                         dtype=dtype, devices=n)
    got = TorchBackend("secded").solve(tm, b, 200, 1e-6, dtype=dtype,
                                       devices=n)
    assert not got.failed and got.iterations == ref.iterations
    tol = (dict(rtol=1e-10, atol=1e-13) if dtype == "f64" else
           dict(rtol=2e-3, atol=5e-6) if config == "split" else
           dict(rtol=2e-5, atol=1e-7))
    np.testing.assert_allclose(got.x, ref.x, **tol)


@pytest.mark.parametrize("row", ["interior", "boundary"])
@pytest.mark.parametrize("config", ["dia", "ell-perm"])
def test_fault_in_a_shard_corrected_once(config, row):
    """A 1-bit fault in an interior row or in the last row of shard 1
    (the first halo row of shard 2) fires on its own shard, is corrected
    once on the whole planes, and the resumed solve equals the clean one
    bit for bit; the shard copies come back scrubbed."""
    jm, tm, n = both(config)
    R_loc = tm.R // n
    r = R_loc + R_loc // 2 if row == "interior" else 2 * R_loc - 1
    b = bvec(tm)
    clean = _port_solve(tm, n, b)
    got = _port_solve(flip(tm, r), n, b)
    assert got.stats.errcode == 0 and got.stats.corrected_count == 1
    assert got.iterations == clean.iterations
    assert torch.equal(got.x, clean.x)
    for s, shard in enumerate(got.md.shards):
        for w, cw in zip(shard.words, clean.md.shards[s].words):
            assert torch.equal(w, cw)
    ref = _jax_shardmap_solve(flip(jm, r), n, b)
    assert int(ref.stats.corrected_count) == 1
    assert int(ref.iterations) == got.iterations


def test_sed_fault_in_a_halo_row_fail_stops():
    jm, tm, n = both("dia", "sed")
    r = 3 * tm.R // n
    got = _port_solve(flip(tm, r), n, bvec(tm))
    assert got.stats.errcode == 1 and got.iterations == 0


@pytest.mark.parametrize("fault", [False, True], ids=["clean", "fault"])
@pytest.mark.parametrize("config", ["dia", "ell", "split"])
def test_lazy_schedule_equals_live(config, fault):
    """--check-interval 4 on the kernel tier: the detection-free
    per-shard products on unchecked iterations; a clean lazy solve equals
    the live one bit for bit, and a fault rolls back and is corrected."""
    _, tm, n = both(config)
    b = bvec(tm)
    live = _port_solve(tm, n, b)
    m = tm
    if fault and config == "split":
        m = inject_bitflips(tm, "ANY", 1, np.random.default_rng(4),
                            echo=lambda s: None)
    elif fault:
        m = flip(tm, tm.R // n)
    lazy = _port_solve(m, n, b, check_interval=4)
    assert lazy.stats.errcode == 0
    assert lazy.stats.corrected_count == int(fault)
    assert lazy.iterations == live.iterations
    assert torch.equal(lazy.x, live.x)


@pytest.mark.parametrize("config", ["dia", "ell"])
def test_jacobi_matches_single_device_and_jax(config):
    jm, tm, n = both(config)
    b = bvec(tm)
    ref1 = TorchBackend("secded").solve(tm, b, 200, 1e-6, dtype="f32",
                                        precond="jacobi")
    got = CudaBackend("secded", device=CPU).solve(
        tm, b, 200, 1e-6, dtype="f32", precond="jacobi", devices=n)
    assert not got.failed and got.iterations == ref1.iterations
    np.testing.assert_allclose(got.x, ref1.x, rtol=2e-5, atol=1e-7)
    ref64 = jcreate("jnp", "secded").solve(jm, b, 200, 1e-10,
                                           verbose=False, dtype="f64",
                                           precond="jacobi", devices=n)
    got64 = TorchBackend("secded").solve(tm, b, 200, 1e-10, dtype="f64",
                                         precond="jacobi", devices=n)
    assert got64.iterations == ref64.iterations
    np.testing.assert_allclose(got64.x, ref64.x, rtol=1e-10, atol=1e-13)


def test_shardmap_impl_full_and_constraints():
    """``full`` runs the oracle on the whole planes; constraints mode's
    structural check reports a bad index from any shard."""
    _, tm, n = both("dia", "constraints")
    mesh = default_mesh(n, CPU)
    md, bdev, _ = _device_put_sharded(tm, bvec(tm), mesh, F32)
    assert isinstance(md, ShardedDevice)
    impl = make_shardmap_spmv(tm, mesh, F32)
    w, st = impl.full(md, bdev)
    assert st.errcode == 0
    assert torch.equal(w.cpu(), dia_fast_plain(
        make_matrix_device(tm, F32, CPU), bdev.cpu(),
        dia_spec(tm, "constraints"))[0])
    bad = flip(tm, 5 * tm.R // n + 7, word="col", bit=22)
    mdb, _, _ = _device_put_sharded(bad, bvec(tm), mesh, F32)
    assert bool(impl.fast(mdb, bdev)[1])
    assert impl.full(mdb, bdev)[1].errcode != 0


# ---- routing ----------------------------------------------------------------

ENVELOPE = [(c, n, dt) for c in CONFIGS for n in (1, 2, 4, 8)
            for dt in ("f32", "f64")] + [("unaligned", 8, "f32"),
                                         ("flat", 4, "f32")]


@pytest.mark.parametrize("config,n,dtype", ENVELOPE,
                         ids=[f"{c}-{n}-{d}" for c, n, d in ENVELOPE])
def test_envelope_covers_jax(config, n, dtype):
    """The port takes the kernel tier wherever JAX's supports_shardmap
    holds, and uploads per-shard copies for it."""
    if config == "unaligned":
        rows, cols, vals, N = spd_tridiagonal(4000)
        jm = jbuild("csr", jassemble(cols, rows, vals, N, 1), "secded")
        tm = build_protected("csr", assemble(cols, rows, vals, N, 1),
                             "secded")
    elif config == "flat":
        rows, cols, vals, N = _bordered(2048)
        jm = jbuild("csr", jassemble(cols, rows, vals, N, 1), "secded",
                    split="none")
        tm = build_protected("csr", assemble(cols, rows, vals, N, 1),
                             "secded", split="none")
        assert tm.exec_kind == "flat"
    else:
        jm, tm, _ = both(config)
    jdt = jnp.float32 if dtype == "f32" else jnp.float64
    tdt = F32 if dtype == "f32" else torch.float64
    jax_ok = jsk.supports_shardmap(jm, jdt, n)
    assert supports_shardmap(tm, tdt, n) or not jax_ok
    if jax_ok:
        md = _device_put_sharded(tm, bvec(tm), default_mesh(n, CPU), tdt)[0]
        main = md[0] if tm.exec_kind == "split" else md
        assert isinstance(main, ShardedDevice) and len(main.shards) == n


def test_out_of_window_index_clamps_into_the_window():
    """A corrupted gather index (mode none: the raw col word) that leaves
    a shard's window reads the clamped window end, x_ext[-1] (the TPU
    kernel clamps into its window too); the single-device product reads
    x[R - 1] there, the decided divergence of ROADMAP.md queue 3.  Every
    other row equals the single-device product."""
    _, tm, n = both("ell", "none")
    R_loc, H = tm.R // n, _halo(tm)
    r = R_loc + 5                                # shard 1
    bad = flip(tm, r, word="col", bit=20)        # index + 2**20: past R
    mesh = default_mesh(n, CPU)
    md = make_matrix_device(bad, F32, CPU)
    shards = shard_rows(md, mesh)
    x = torch.tensor(np.random.default_rng(5).standard_normal(tm.R),
                     dtype=F32)
    ext = _exchange(x, mesh, H)
    spec = ell_spec(bad, "none")
    w_shard = ell_fast_plain(shards[1], ext[1], spec, H, R_loc)[0]
    w_single = ell_fast_plain(md, x, spec)[0][R_loc:2 * R_loc]
    k = int(np.flatnonzero(bad.ell_slot % bad.R == r)[0])
    slot = bad.ell_slot[k] // bad.R
    v = md.values[:, r]
    want = torch.zeros((), dtype=F32)
    got_single = torch.zeros((), dtype=F32)
    for j in range(int(md.ell_len[r])):
        col = int(bad.ell["col"][j, r])
        xs = ext[1][-1] if j == slot else x[col]
        want = want + v[j] * xs
        got_single = got_single + v[j] * x[min(col, tm.R - 1)]
    assert w_shard[5] == want and w_single[5] == got_single
    assert w_shard[5] != w_single[5]
    others = torch.arange(R_loc) != 5
    assert torch.equal(w_shard[others], w_single[others])
