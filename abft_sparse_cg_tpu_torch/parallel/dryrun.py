"""The multi-device dry run: ten row-sharded solves on a mesh.

Counterpart of ``__graft_entry__.py::dryrun_multichip`` (:54-327), with
its ten configurations, seeds and asserts, through the port's
parallel.sharded:

  1. dia/secded/clean and 2. dia/secded/injected (one correction, x equal
     to the clean x bit for bit);
  3. ell/sec8/clean (forced ELL);
  4. split/secded/clean and 5. split/secded/injected (a bordered split);
  6. shardmap-kernel/dia/secded: the kernel tier on an N that is not
     aligned to 1024 n (``row_align`` pads it), clean and with one
     correction, bit-equal;
  7. shardmap-kernel/wideband/secded: band 2500, forced ELL;
  8. shardmap-kernel/split/secded: the kernel tier's main part and the
     flat tail on the first shard's device, clean and corrected;
  9. shardmap-kernel/highk129/secded: ELL with K = 129;
  10. shardmap-kernel/dia/secded/lazy-ci4: the lazy schedule, its clean x
      equal to the live one and its corrected x to its clean one.

Every configuration asserts strict convergence (rr <= 1e-6) and no
error code, and prints one line under the JAX label with the tier that
ran it: the per-shard kernels (kernels A and C in their halo forms on a
card, their plain versions on the CPU) where the port's kernel envelope
(parallel.sharded_kernel.supports_shardmap) holds, else the
single-device program on the first shard's device.  The JAX function
runs configurations 1-5 through GSPMD; the port runs them, whose R is
not a multiple of 1024 n, on the first shard's device, as its
``solve_sharded`` runs any matrix outside the envelope.

    import torch
    from abft_sparse_cg_tpu_torch.parallel.dryrun import dryrun_multichip
    dryrun_multichip(4, torch.device("cuda", 0))   # 4 shards on one card
    dryrun_multichip(2)                            # one shard per card
"""

from __future__ import annotations

import numpy as np
import torch

from ..formats import assemble, build_protected
from ..inject import inject_bitflips
from ..utils.matgen import spd_denseband, spd_tridiagonal, spd_wideband
from .sharded import (
    _device_put_sharded,
    default_mesh,
    make_sharded_solver,
    solve_sharded,
)
from .sharded_kernel import _halo, supports_shardmap

__all__ = ["dryrun_multichip", "tier_of"]

F32 = torch.float32
MAX_ITRS = 100
CONV = 1e-6


def _where(mesh) -> str:
    devs = list(dict.fromkeys(map(str, mesh.devices)))
    if len(devs) == 1:
        return f"{mesh.size} shards on {devs[0]}"
    return f"{mesh.size} shards on {', '.join(devs)}"


def tier_of(mat, mesh) -> str:
    """Which tier a float32 solve of ``mat`` on ``mesh`` runs."""
    if supports_shardmap(mat, F32, mesh.size):
        main = mat.main if mat.exec_kind == "split" else mat
        kernel = "A" if main.exec_kind == "dia" else "C"
        tail = ("; flat tail by kernel E on the first shard's device"
                if mat.exec_kind == "split" else "")
        plain = (" (its plain version on the CPU)"
                 if mesh.devices[0].type == "cpu" else "")
        return (f"kernel tier: kernel {kernel}'s halo form{plain} per "
                f"shard, {_where(mesh)}, H {_halo(main)}{tail}")
    return (f"single-device program on {mesh.devices[0]}: outside the "
            "kernel envelope")


def _bordered(n, seed=8):
    """The tridiagonal core with two dense rows of __graft_entry__.py:
    118-131 (lower-triangle triplets)."""
    br, bc, bv, bn = spd_tridiagonal(n)
    br, bc, bv = list(br), list(bc), list(bv)
    rng = np.random.default_rng(seed)
    for r in (17, 500):
        for c in np.setdiff1d(rng.choice(bn, size=150, replace=False),
                              [r - 1, r, r + 1]):
            br.append(max(r, int(c)))
            bc.append(min(r, int(c)))
            bv.append(-0.01)
    br, bc = np.array(br), np.array(bc)
    bv = np.array(bv, dtype=float)
    deg = np.bincount(br, minlength=bn) + np.bincount(bc, minlength=bn)
    diag = br == bc
    bv[diag] = deg.astype(float)[br[diag]] + 4.0
    return br, bc, bv, bn


def _inject(mat, seed):
    return inject_bitflips(mat, "ANY", 1, np.random.default_rng(seed),
                           echo=lambda s: None)


def dryrun_multichip(n_devices: int, device=None, echo=print) -> dict:
    """The ten configurations on an ``n_devices``-shard mesh: one shard
    per CUDA card (``device`` None), or every shard on ``device``.
    Returns {label: [solve, ...]} in the JAX function's order (the clean
    solve before the corrected one where a configuration runs both),
    each solve a dict of ``iterations``, ``rr``, ``corrected``, ``x``
    (host, execution order) and ``tier``."""
    mesh = default_mesh(n_devices, device)
    if mesh.size != n_devices:
        raise ValueError(f"need {n_devices} devices, found {mesh.size}")
    out = {}

    def record(tag, mat, res, expect_corrected=0):
        itr, rr = int(res.iterations), float(res.rr)
        corrected = int(res.stats.corrected_count)
        assert res.stats.errcode == 0, (tag, tuple(res.stats))
        assert rr <= CONV, f"{tag}: did not converge (rr={rr:.3e}, itr={itr})"
        if expect_corrected is not None:
            assert corrected == expect_corrected, (
                f"{tag}: corrected {corrected} != {expect_corrected}")
        solve = dict(iterations=itr, rr=rr, corrected=corrected,
                     x=res.x.cpu().numpy(), tier=tier_of(mat, mesh))
        out.setdefault(tag, []).append(solve)
        return solve

    def show(tag, msg):
        echo(f"dryrun_multichip({n_devices}) {tag}: {msg} "
             f"[{out[tag][-1]['tier']}]")

    def run(mat, tag, expect_corrected=0):
        b = np.random.default_rng(1).random(mat.N)
        res = solve_sharded(mat, b, MAX_ITRS, CONV, mesh=mesh, dtype=F32)
        s = record(tag, mat, res, expect_corrected)
        msg = f"converged in {s['iterations']} iterations, rr={s['rr']:.3e}"
        if s["corrected"]:
            msg += f"; [ECC] corrected {s['corrected']} fault(s) mid-solve"
        show(tag, msg)
        return s

    def tier_solve(mat, b, ci=1):
        """The solve of __graft_entry__.py's shard_map configurations:
        solver.cg's loop (lazy with ``ci`` > 1) over the kernel tier on
        the mesh, or the single-device program outside its envelope."""
        md, bdev, _ = _device_put_sharded(mat, b, mesh, F32)
        return make_sharded_solver(mat, mesh, MAX_ITRS, CONV, F32,
                                   check_interval=ci)(md, bdev)

    rows, cols, vals, n = spd_tridiagonal(512)
    a = assemble(cols, rows, vals, n, max(4, n_devices))

    mat = build_protected("csr", a, "secded")
    assert mat.exec_kind == "dia"
    clean = run(mat, "dia/secded/clean")
    fixed = run(_inject(mat, 3), "dia/secded/injected", expect_corrected=1)
    assert np.array_equal(fixed["x"], clean["x"]), (
        "corrected solve must match the clean solve exactly")

    mell = build_protected("csr", a, "sec8", force_exec="ell")
    assert mell.exec_kind == "ell"
    run(mell, "ell/sec8/clean")

    br, bc, bv, bn = _bordered(1024)
    msplit = build_protected("csr", assemble(bc, br, bv, bn, 1), "secded")
    assert msplit.exec_kind == "split"
    clean_split = run(msplit, "split/secded/clean")
    fixed_split = run(_inject(msplit, 5), "split/secded/injected",
                      expect_corrected=1)
    assert np.array_equal(fixed_split["x"], clean_split["x"]), (
        "corrected split solve must match the clean solve exactly")

    # The kernel tier: R in 1024-row shards, N deliberately not aligned
    # (row_align pads it).
    kr, kc, kv, kn = spd_tridiagonal(1024 * n_devices - 100)
    mk = build_protected("csr", assemble(kc, kr, kv, kn, 1), "secded",
                         row_align=1024 * n_devices)
    assert mk.exec_kind == "dia" and mk.R == 1024 * n_devices
    tag = "shardmap-kernel/dia/secded"
    bk = np.random.default_rng(2).random(mk.N)
    res_clean = record(tag, mk, tier_solve(mk, bk))
    mk2 = _inject(mk, 9)
    res_f = record(tag, mk2, tier_solve(mk2, bk), expect_corrected=1)
    assert np.array_equal(res_f["x"], res_clean["x"])
    show(tag, f"converged in {res_f['iterations']} iterations with 1 "
         "mid-solve correction (per-shard kernel + halo exchange)")

    wr, wc, wv, nw = spd_wideband(3072 * n_devices, 2500)
    mw = build_protected("csr", assemble(wc, wr, wv, nw, 1), "secded",
                         reorder="none", force_exec="ell")
    assert mw.exec_kind == "ell" and mw.band > 1920
    tag = "shardmap-kernel/wideband/secded"
    resw = record(tag, mw, tier_solve(
        mw, np.random.default_rng(3).random(mw.N)))
    show(tag, f"converged in {resw['iterations']} iterations "
         f"(band={mw.band}, K={mw.K})")

    ms = build_protected("csr", assemble(bc, br, bv, bn, 1), "secded",
                         row_align=1024 * n_devices)
    assert ms.exec_kind == "split"
    tag = "shardmap-kernel/split/secded"
    bs = np.random.default_rng(4).random(ms.N)
    res_sc = record(tag, ms, tier_solve(ms, bs))
    ms2 = _inject(ms, 7)
    res_sf = record(tag, ms2, tier_solve(ms2, bs), expect_corrected=1)
    assert np.array_equal(res_sf["x"], res_sc["x"])
    show(tag, f"converged in {res_sf['iterations']} iterations with 1 "
         "mid-solve correction (kernel main + flat tail on the first "
         "shard's device)")

    hr, hc, hv, hn = spd_denseband(1024 * n_devices, 64)
    mh = build_protected("csr", assemble(hc, hr, hv, hn, 1), "secded",
                         reorder="none")
    assert mh.exec_kind == "ell" and mh.K == 129
    tag = "shardmap-kernel/highk129/secded"
    resh = record(tag, mh, tier_solve(
        mh, np.random.default_rng(6).random(mh.N)))
    show(tag, f"converged in {resh['iterations']} iterations (K=129 "
         "slots per shard)")

    tag = "shardmap-kernel/dia/secded/lazy-ci4"
    res_lc = record(tag, mk, tier_solve(mk, bk, ci=4))
    res_lf = record(tag, mk2, tier_solve(mk2, bk, ci=4),
                    expect_corrected=None)
    assert res_lf["corrected"] >= 1
    assert np.array_equal(res_lf["x"], res_lc["x"])
    assert np.array_equal(res_lc["x"], res_clean["x"])
    show(tag, f"converged in {res_lf['iterations']} iterations, fault "
         "caught at a lazy checkpoint and rolled back "
         f"({res_lf['corrected']} correction(s))")
    return out
