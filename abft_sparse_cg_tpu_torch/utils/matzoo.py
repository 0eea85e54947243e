"""Matrix zoo: structurally distinct SPD families, for validating the
layout routing against shapes the generators of utils.matgen do not
cover.

A copy of ``abft_sparse_cg_tpu.utils.matzoo``: the same generators give the
same matrices in both packages.  Every generator returns lower-triangle
0-based triplets ``(rows, cols, vals, n)`` with a strictly diagonally
dominant diagonal (degree-weighted + 4), hence SPD after the loader's
mirroring.  ``ZOO`` maps name -> (generator, predicted) where
``predicted`` is the routing the JAX package's build chooses (exec
kind, kernel-tier support, permutation); this package builds the
``dia`` and ``ell`` kinds and refuses the others (formats.protected).
"""

from __future__ import annotations

import numpy as np

__all__ = ["ZOO", "zoo_assembled"]


def _dominant(rows, cols, vals, n, slack=4.0):
    """Overwrite diagonal entries with |off-diagonal| row sums + slack
    (counting the mirrored upper triangle), guaranteeing SPD."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals, dtype=float)
    off = rows != cols
    absw = np.abs(vals[off])
    deg = (np.bincount(rows[off], weights=absw, minlength=n)
           + np.bincount(cols[off], weights=absw, minlength=n))
    diag = rows == cols
    vals = vals.copy()
    vals[diag] = deg[rows[diag]] + slack
    return rows, cols, vals, n


def _dedupe(rows, cols, vals, n):
    """Collapse duplicate (row, col) pairs (sum values)."""
    key = np.asarray(rows) * n + np.asarray(cols)
    uk, inv = np.unique(key, return_inverse=True)
    v = np.zeros(len(uk))
    np.add.at(v, inv, np.asarray(vals, float))
    return uk // n, uk % n, v, n


def graded_mesh_1d(n=81920, ratio=1.0002):
    """1-D FEM chain on a geometrically graded grid: element stiffness
    1/h_i with h_i = ratio**i — banded structure with coefficients
    spanning ~ratio**n, an ill-conditioned family (the f64-oracle
    smoke's stress case).  Routing: tridiagonal -> DIA."""
    i = np.arange(n)
    # log-spaced element sizes, normalized to keep values finite
    k = ratio ** (i % 60000)     # cap the dynamic range at ~4e5
    rows = np.concatenate([i, i[1:]])
    cols = np.concatenate([i, i[:-1] ])
    vals = np.concatenate([np.zeros(n), -k[1:]])
    return _dominant(rows, cols, vals, n, slack=1e-8)


def aniso_laplace_2d(side=286, eps=1e-3):
    """5-point Laplacian with anisotropic coupling (eps in x, 1 in y):
    cond ~ side^2 / eps — the ill-conditioned 2-D family.  Routing:
    two offset pairs + diagonal -> DIA."""
    n = side * side
    i = np.arange(n)
    rows = [i]
    cols = [i]
    vals = [np.zeros(n)]
    right = i[(i + 1) % side != 0]
    rows.append(right + 1), cols.append(right), vals.append(
        np.full(len(right), -eps))
    down = i[i + side < n]
    rows.append(down + side), cols.append(down), vals.append(
        np.full(len(down), -1.0))
    return _dominant(np.concatenate(rows), np.concatenate(cols),
                     np.concatenate(vals), n, slack=1e-6)


def powerlaw_graph(n=65536, seed=13):
    """Preferential-attachment graph Laplacian: a handful of early
    nodes accumulate power-law degrees (hubs), the bulk stays sparse —
    the social/contact-network shape.  Routing: hubs are degree
    outliers -> bordered split (banded-ish core + flat tail)."""
    rng = np.random.default_rng(seed)
    m = 2  # edges per new node
    # Approximate preferential attachment: targets drawn from a grown
    # endpoint pool (vectorized batches for speed).
    targets = [0, 1, 0, 2, 1, 2]
    rows, cols = [1, 2, 2], [0, 0, 1]
    pool = np.array(targets)
    for v in range(3, n):
        t = pool[rng.integers(0, len(pool), size=m)]
        t = np.unique(t % v)
        for u in t:
            rows.append(v), cols.append(int(u))
        if v % 4096 == 0:
            pool = np.concatenate([pool, np.array(rows[-8192:]),
                                   np.array(cols[-8192:])])
    rows, cols = np.array(rows), np.array(cols)
    rows, cols, vals, _ = _dedupe(
        np.concatenate([rows, np.arange(n)]),
        np.concatenate([cols, np.arange(n)]),
        np.concatenate([-np.ones(len(rows)), np.zeros(n)]), n)
    return _dominant(rows, cols, vals, n)


def band_plus_random(n=81920, band=48, frac=0.01, seed=17):
    """Banded core + ``frac`` of nnz as uniform long-range couplings —
    1% random matrix entries defeat every reordering (RCM band stays
    ~n), so the band-split composite is the only kernel route.
    Routing: split (banded main + flat out-of-band tail)."""
    rng = np.random.default_rng(seed)
    i = np.arange(n)
    rows = [i]
    cols = [i]
    vals = [np.zeros(n)]
    for d in (1, 2, band // 2, band):
        rows.append(i[d:]), cols.append(i[:-d]), vals.append(
            -np.ones(n - d) / d)
    base = sum(len(r) for r in rows)
    extra = int(frac * base)
    r = rng.integers(0, n, size=3 * extra)
    c = rng.integers(0, n, size=3 * extra)
    keep = np.abs(r - c) > band
    r, c = r[keep][:extra], c[keep][:extra]
    rows.append(np.maximum(r, c)), cols.append(np.minimum(r, c))
    vals.append(np.full(len(r), -0.1))
    rows, cols, vals, _ = _dedupe(np.concatenate(rows),
                                  np.concatenate(cols),
                                  np.concatenate(vals), n)
    return _dominant(rows, cols, vals, n)


def stencil27_shuffled(side=40, seed=23):
    """27-point 3-D stencil under a random node relabeling — the
    arbitrary-mesh-numbering case for a high-order stencil.  Routing:
    RCM recovers a ~side^2 band; 26 neighbors + diagonal stay one-per-
    offset-ish but the permutation breaks DIA -> permuted banded ELL."""
    n = side ** 3
    idx = lambda i, j, k: (i * side + j) * side + k  # noqa: E731
    I, J, K = np.meshgrid(np.arange(side), np.arange(side),
                          np.arange(side), indexing="ij")
    base = idx(I, J, K).ravel()
    rows, cols = [base], [base]
    vals = [np.zeros(n)]
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            for dk in (-1, 0, 1):
                if (di, dj, dk) <= (0, 0, 0):
                    continue
                Im, Jm, Km = I + di, J + dj, K + dk
                ok = ((0 <= Im) & (Im < side) & (0 <= Jm) & (Jm < side)
                      & (0 <= Km) & (Km < side))
                a = idx(I, J, K)[ok]
                b = idx(Im, Jm, Km)[ok]
                rows.append(np.maximum(a, b))
                cols.append(np.minimum(a, b))
                vals.append(np.full(ok.sum(), -1.0))
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    vals = np.concatenate(vals)
    from .matgen import shuffle_labels

    rows, cols, vals, n = shuffle_labels(rows, cols, vals, n, seed=seed)
    return _dominant(rows, cols, vals, n)


def dense_radius_3d(side=28, rx=2, ry=2, rz=3):
    """All neighbors within an anisotropic Chebyshev radius on a 3-D
    grid — (2rx+1)(2ry+1)(2rz+1) - 1 = 174 distinct offsets, one entry
    per offset per row: past the DIA offset cap -> the high-K ELL tier
    (K = 175), the higher-order-FEM shape."""
    n = side ** 3
    idx = lambda i, j, k: (i * side + j) * side + k  # noqa: E731
    I, J, K = np.meshgrid(np.arange(side), np.arange(side),
                          np.arange(side), indexing="ij")
    rows, cols, vals = [idx(I, J, K).ravel()], [idx(I, J, K).ravel()], [
        np.zeros(n)]
    for di in range(-rx, rx + 1):
        for dj in range(-ry, ry + 1):
            for dk in range(-rz, rz + 1):
                if (di, dj, dk) <= (0, 0, 0):
                    continue
                Im, Jm, Km = I + di, J + dj, K + dk
                ok = ((0 <= Im) & (Im < side) & (0 <= Jm) & (Jm < side)
                      & (0 <= Km) & (Km < side))
                a = idx(I, J, K)[ok]
                b = idx(Im, Jm, Km)[ok]
                rows.append(np.maximum(a, b))
                cols.append(np.minimum(a, b))
                vals.append(np.full(ok.sum(), -0.1))
    return _dominant(np.concatenate(rows), np.concatenate(cols),
                     np.concatenate(vals), n)


def bitreversal_banded(n=65536):
    """Tridiagonal chain relabeled by bit-reversal — the adversarial
    permutation (every neighbor lands far away; naive banded layouts
    see band ~ n/2).  Routing: RCM must recover the chain -> DIA with
    a permutation."""
    bits = int(np.log2(n))
    assert 1 << bits == n
    i = np.arange(n, dtype=np.uint64)
    rev = np.zeros(n, dtype=np.int64)
    t = i.copy()
    for _ in range(bits):
        rev = (rev << 1) | (t & 1).astype(np.int64)
        t >>= np.uint64(1)
    a, b = rev[:-1], rev[1:]
    rows = np.concatenate([np.arange(n), np.maximum(a, b)])
    cols = np.concatenate([np.arange(n), np.minimum(a, b)])
    vals = np.concatenate([np.zeros(n), -np.ones(n - 1)])
    return _dominant(rows, cols, vals, n)


def arrowhead(n=81920, k=3, seed=29):
    """Classic arrowhead: tridiagonal core + ``k`` fully dense
    rows/columns (global constraints / Lagrange multipliers).
    Routing: the dense indices are outliers -> bordered split with the
    span-window dense-tail plan."""
    rng = np.random.default_rng(seed)
    i = np.arange(n)
    rows = [i, i[1:]]
    cols = [i, i[:-1]]
    vals = [np.zeros(n), -np.ones(n - 1)]
    dense = rng.choice(np.arange(10, n - 10), size=k, replace=False)
    for r in dense:
        c = np.setdiff1d(np.arange(n), [r - 1, r, r + 1])
        rows.append(np.maximum(r, c))
        cols.append(np.minimum(r, c))
        vals.append(np.full(len(c), -1.0 / n))
    rows, cols, vals, _ = _dedupe(np.concatenate(rows),
                                  np.concatenate(cols),
                                  np.concatenate(vals), n)
    return _dominant(rows, cols, vals, n)


def periodic_3d(side=44):
    """7-point stencil on a 3-D torus: wrap couplings put offsets at
    ~side^2 distance — within DIA's offset list but past one chunk of
    megakernel halo (the big-offset mode's case).  Routing: DIA."""
    n = side ** 3
    idx = lambda i, j, k: (i * side + j) * side + k  # noqa: E731
    I, J, K = np.meshgrid(np.arange(side), np.arange(side),
                          np.arange(side), indexing="ij")
    rows, cols, vals = [idx(I, J, K).ravel()], [idx(I, J, K).ravel()], [
        np.zeros(n)]
    for d in ((1, 0, 0), (0, 1, 0), (0, 0, 1)):
        Im, Jm, Km = (I + d[0]) % side, (J + d[1]) % side, (K + d[2]) % side
        a = idx(I, J, K).ravel()
        b = idx(Im, Jm, Km).ravel()
        hi, lo = np.maximum(a, b), np.minimum(a, b)
        keep = hi != lo
        rows.append(hi[keep]), cols.append(lo[keep])
        vals.append(np.full(keep.sum(), -1.0))
    rows, cols, vals, _ = _dedupe(np.concatenate(rows),
                                  np.concatenate(cols),
                                  np.concatenate(vals), n)
    return _dominant(rows, cols, vals, n)


def blockdiag_random(n=81920, max_block=96, seed=31):
    """Dense diagonal blocks of random sizes (multiphysics contact
    clusters) chained by weak couplings: variable per-row degree up to
    ~max_block defeats DIA; band <= max_block keeps the windowed ELL
    kernel.  Routing: ELL, moderate K, narrow band."""
    rng = np.random.default_rng(seed)
    rows, cols, vals = [np.arange(n)], [np.arange(n)], [np.zeros(n)]
    start = 0
    while start < n:
        bs = int(rng.integers(4, max_block + 1))
        end = min(n, start + bs)
        b = np.arange(start, end)
        if len(b) > 1:
            rr, cc = np.meshgrid(b, b, indexing="ij")
            sel = rr > cc
            rows.append(rr[sel]), cols.append(cc[sel])
            vals.append(np.full(sel.sum(), -2.0 / bs))
        if end < n:
            rows.append(np.array([end])), cols.append(np.array([end - 1]))
            vals.append(np.array([-0.01]))
        start = end
    return _dominant(np.concatenate(rows), np.concatenate(cols),
                     np.concatenate(vals), n)


# name -> (generator, predicted routing)
# predicted: dict(kind=..., kernel=bool, perm=bool) — `kind` is the
# exec_kind build_protected must choose; `kernel` whether the compiled
# pallas tier carries it (supports() on the matrix or its main part);
# `perm` whether an RCM permutation is adopted.  VERIFIED empirically
# once, then pinned (tests/test_zoo_routing.py).
ZOO = {
    "graded-mesh-1d": (graded_mesh_1d,
                       dict(kind="dia", kernel=True, perm=False)),
    "aniso-laplace-2d": (aniso_laplace_2d,
                         dict(kind="dia", kernel=True, perm=False)),
    # Power-law/expander graphs have NO banded structure at any
    # ordering, and peeling the 11 hubs leaves a core that is still an
    # expander (try_split correctly declines: the core would be flat
    # too) — the honest routing is the entry-layout (flat) segment-sum
    # path, the one family with no compiled-kernel story yet.
    "powerlaw-graph": (powerlaw_graph,
                       # the Benes-route unstructured tier carries flat
                       # matrices in the JAX package
                       dict(kind="flat", kernel=True, perm=False)),
    "band+random-1pct": (band_plus_random,
                         dict(kind="split", kernel=True, perm=False)),
    # Post-RCM band 4681 is rolled-scan territory where the
    # Benes route wins (benes_beats_rolled) -> flat.
    "stencil27-shuffled": (stencil27_shuffled,
                           dict(kind="flat", kernel=True, perm=True)),
    "dense-radius-3d": (dense_radius_3d,
                        dict(kind="ell", kernel=True, perm=False)),
    # K=729 (> the 512-slot ELL envelope at every band): routing must
    # land on the flat/Benes tier (the high-K edge).  side=10 keeps
    # the padded slot grid inside that tier's validated M=2^20
    # envelope.
    "dense-radius-k729": (
        lambda: dense_radius_3d(side=10, rx=4, ry=4, rz=4),
        dict(kind="flat", kernel=True, perm=False)),
    "bitreversal-banded": (bitreversal_banded,
                           dict(kind="dia", kernel=True, perm=True)),
    "arrowhead": (arrowhead,
                  dict(kind="split", kernel=True, perm=False)),
    "periodic-3d": (periodic_3d,
                    dict(kind="dia", kernel=True, perm=False)),
    "blockdiag-random": (blockdiag_random,
                         dict(kind="ell", kernel=True, perm=False)),
}


def zoo_assembled(name, blocks=1):
    """Build one zoo matrix through the standard loader assembly."""
    from ..formats import assemble

    make, _pred = ZOO[name]
    rows, cols, vals, n = make()
    return assemble(np.asarray(cols), np.asarray(rows),
                    np.asarray(vals, float), n, blocks)
