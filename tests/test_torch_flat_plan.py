"""Kernel E's row-block plan and its summation order, on the CPU.

Kernel E (csrc/flat_spmv_detect.cu) runs one thread block per entry of
``ops.spmv.flat_row_blocks``: a run of rows whose slots fit one shared-
memory tile, or one long row streamed through the tile in chunks.  The
kernel needs the card; these tests hold what it relies on:

  - the plan covers every row and every slot exactly once, keeps each
    run within its slot and row caps, cuts every row above the tile into
    consecutive tile-sized chunks of its own (first and last flagged),
    and puts those chunks first;
  - a plain NumPy float32 replay of the kernel's schedule — products
    rounded once into the tile, a thread per short row running the
    butterfly's offsets below the warp's longest short row, a warp per
    wider row, lane sums carried from chunk to chunk of a long row — is
    bit-identical to ``ops.spmv.flat_product`` (the plain version kernel
    E is held to on the card), up to NaN payloads.

Inputs, small and seeded: powerlaw-graph at the zoo's size forced flat
(hub rows of up to 10,875 slots), dense-radius-k729, stencil27-shuffled
at side 16 forced flat under its RCM permutation (the gidx plane), and a
synthetic matrix with rows of 0, 1, 31, 32, 33, 64, 65, 1,000, 2,048,
2,049 and 4,100 slots beside random short ones; x holds -0.0, NaN and
infinities in the last test.  The default tile and a small one (64
slots, 16 rows) that makes most rows long or wide.
"""

import numpy as np
import pytest
import torch

from abft_sparse_cg_tpu_torch.formats import build_protected
from abft_sparse_cg_tpu_torch.ops.spmv import (
    FLAT_RUN_ROWS,
    FLAT_TILE,
    flat_product,
    flat_row_blocks,
    make_matrix_device,
    take_clamped,
)
from abft_sparse_cg_tpu_torch.ops.spmv_cuda import (
    ell_gather_plane,
    flat_spec,
)
from abft_sparse_cg_tpu_torch.utils.matgen import row_lengths_assembled
from abft_sparse_cg_tpu_torch.utils.matzoo import (
    stencil27_shuffled,
    zoo_assembled,
)

CPU = torch.device("cpu")
torch.set_num_threads(1)
F32 = np.float32
TILES = [(FLAT_TILE, FLAT_RUN_ROWS), (64, 16)]


def asm_of(shape):
    if shape == "powerlaw":
        return zoo_assembled("powerlaw-graph"), {"split": "none"}
    if shape == "k729":
        return zoo_assembled("dense-radius-k729"), {}
    if shape == "stencil27-rcm":
        from abft_sparse_cg_tpu_torch.formats import assemble

        rows, cols, vals, n = stencil27_shuffled(side=16)
        return assemble(cols, rows, vals, n, 1), {"force_exec": "flat"}
    return row_lengths_assembled(), {"force_exec": "flat"}


_MATS = {}


def flat_md(shape, mode="secded"):
    """(matrix, device planes) of a flat ``shape``, built once."""
    if (shape, mode) not in _MATS:
        asm, kw = asm_of(shape)
        m = build_protected("csr", asm, mode, **kw)
        assert m.exec_kind == "flat"
        _MATS[shape, mode] = m, make_matrix_device(m, torch.float32, CPU)
    return _MATS[shape, mode]


SHAPES = ["powerlaw", "k729", "stencil27-rcm", "rowlen"]


def butterfly_lane0(lanes):
    """Lane 0 of the XOR butterfly (16, 8, 4, 2, 1) over 32 lane sums."""
    lane = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        lanes = (lanes + lanes[lane ^ o]).astype(F32)
    return lanes[0]


def carry(lanes, t):
    """Lane l of a warp adds the products ``t``'s slots l, l + 32, ... to
    its running sum in turn (a long row's chunks are a multiple of 32
    slots, so the lanes carry on from chunk to chunk)."""
    for j0 in range(0, len(t), 32):
        seg = t[j0:j0 + 32]
        lanes[: len(seg)] = lanes[: len(seg)] + seg
    return lanes


def replay(values, gidx, row_ptr, plan, x, tile):
    """Kernel E's w, block by block, in NumPy float32."""
    R = x.shape[0]
    v = values.numpy()
    xs = x.numpy()
    g = take_clamped(torch.arange(R), gidx).numpy()
    ptr = row_ptr.numpy().astype(np.int64)
    w = np.full(R, np.nan, F32)

    def products(s, n):       # load_products: 0 + v * x, rounded once
        return (F32(0) + (v[s:s + n] * xs[g[s:s + n]]).astype(F32)
                ).astype(F32)

    chains = {}                                     # long row -> lanes
    for r0, r1, s0, s1 in plan.tolist():
        if r1 < 0:                                  # chain_chunk
            first, last = (-1 - r1) & 1, (-1 - r1) & 2
            assert first == (r0 not in chains)
            lanes = carry(chains.pop(r0, np.zeros(32, F32)),
                          products(s0, s1 - s0))
            if last:
                w[r0] = butterfly_lane0(lanes)
            else:
                chains[r0] = lanes
            continue
        t = products(s0, s1 - s0)                   # run_rows
        for c0 in range(r0, r1, 32):                # one warp's rows
            rows = np.arange(c0, min(c0 + 32, r1))
            s, n = ptr[rows] - s0, ptr[rows + 1] - ptr[rows]
            ns = np.where(n <= 32, n, 0)
            G = 1
            while G < ns.max():
                G *= 2
            L = np.zeros((len(rows), G), F32)
            for i, (si, k) in enumerate(zip(s, ns)):
                L[i, :k] = t[si:si + k]
            o = G // 2
            while o:                                # row_tree<G>
                L[:, :o] = L[:, :o] + L[:, o:2 * o]
                o //= 2
            out = L[:, 0].copy()
            for i in np.flatnonzero(n > 32):        # a warp per wide row
                out[i] = butterfly_lane0(carry(np.zeros(32, F32),
                                               t[s[i]:s[i] + n[i]]))
            w[rows] = out
    assert not chains
    return torch.from_numpy(w)


def same_bits(a, b):
    """Bit-identical, NaN payloads aside."""
    nan = torch.isnan(b)
    return (torch.equal(nan, torch.isnan(a))
            and torch.equal(a[~nan].view(torch.int32),
                            b[~nan].view(torch.int32)))


def row_ptr_of(shape):
    return flat_md(shape)[1].row_ptr.numpy()


@pytest.mark.parametrize("tile,run_rows", TILES)
@pytest.mark.parametrize("shape", SHAPES)
def test_plan_covers_rows_within_caps(shape, tile, run_rows):
    ptr = row_ptr_of(shape).astype(np.int64)
    R = len(ptr) - 1
    plan = flat_row_blocks(ptr, tile, run_rows)
    assert plan.dtype == np.int32 and plan.shape[1] == 4
    chunk = plan[:, 1] < 0
    runs, chunks = plan[~chunk], plan[chunk]
    # The chunks first; every block within the tile, runs within the row
    # cap, each carrying its slot range.
    assert not chunk[int(chunk.sum()):].any()
    assert np.all(plan[:, 3] - plan[:, 2] <= tile)
    assert np.all(chunks[:, 3] > chunks[:, 2])
    nrows = runs[:, 1] - runs[:, 0]
    assert np.all(nrows >= 1) and np.all(nrows <= run_rows)
    assert np.array_equal(runs[:, 2:], ptr[runs[:, :2]])
    # Every slot in exactly one block: sorted, the slot ranges tile
    # [0, nnz); every row in exactly one run or one row's chunks.
    by_slot = plan[np.lexsort((plan[:, 3], plan[:, 2]))]
    nonempty = by_slot[by_slot[:, 3] > by_slot[:, 2]]
    assert nonempty[0, 2] == 0 and nonempty[-1, 3] == ptr[-1]
    assert np.array_equal(nonempty[1:, 2], nonempty[:-1, 3])
    covered = np.zeros(R, np.int64)
    for r0, r1, _, _ in runs.tolist():
        covered[r0:r1] += 1
    long_rows = np.unique(chunks[:, 0])
    covered[long_rows] += 1
    assert np.all(covered == 1)
    # Exactly the rows above the tile are chunked: consecutive chunks in
    # slot order, the first and last flagged.
    lens = np.diff(ptr)
    assert long_rows.tolist() == np.flatnonzero(lens > tile).tolist()
    for r in long_rows:
        own = chunks[chunks[:, 0] == r]
        idx = np.flatnonzero(plan[:, 0] == r)
        idx = idx[plan[idx, 1] < 0]
        assert np.array_equal(idx, np.arange(idx[0], idx[0] + len(idx)))
        assert own[0, 2] == ptr[r] and own[-1, 3] == ptr[r + 1]
        assert np.array_equal(own[1:, 2], own[:-1, 3])
        flags = -1 - own[:, 1]
        assert np.array_equal(flags & 1, np.arange(len(own)) == 0)
        assert np.array_equal(flags & 2,
                              2 * (np.arange(len(own)) == len(own) - 1))
    # Greedy: a run stops only where the next row would break a cap.
    for r0, r1, _, _ in runs.tolist():
        if r1 < R and r1 - r0 < run_rows:
            assert ptr[r1 + 1] - ptr[r0] > tile


@pytest.mark.parametrize("shape", SHAPES)
def test_upload_holds_the_plan(shape):
    m, md = flat_md(shape)
    np.testing.assert_array_equal(md.flat_plan.numpy(),
                                  flat_row_blocks(md.row_ptr.numpy()))
    if shape in ("powerlaw", "rowlen"):   # the long-row path is taken
        lens = np.diff(md.row_ptr.numpy())
        assert lens.max() > FLAT_TILE


@pytest.mark.parametrize("tile,run_rows", TILES)
@pytest.mark.parametrize("shape", SHAPES)
def test_schedule_replay_is_bit_identical(shape, tile, run_rows):
    m, md = flat_md(shape)
    spec = flat_spec(m, "secded")
    g = ell_gather_plane(md, spec)
    x = torch.tensor(np.random.default_rng(3).standard_normal(m.R),
                     dtype=torch.float32)
    plan = flat_row_blocks(md.row_ptr.numpy(), tile, run_rows)
    want = flat_product(md.values, g, md.row_ptr, x)
    assert same_bits(replay(md.values, g, md.row_ptr, plan, x, tile), want)


@pytest.mark.parametrize("tile,run_rows", TILES)
def test_schedule_replay_signed_zeros_and_non_finite(tile, run_rows):
    """-0.0 products (their lane sums start at +0.0), NaN and infinities
    (inf - inf in a row's sum) go through the schedule as through the
    plain version."""
    m, md = flat_md("rowlen", "constraints")
    spec = flat_spec(m, "constraints")
    g = ell_gather_plane(md, spec)
    rng = np.random.default_rng(5)
    x = rng.standard_normal(m.R).astype(F32)
    pick = rng.permutation(m.R)
    x[pick[:200]] = -0.0
    x[pick[200:400]] = 0.0
    x[pick[400:410]] = np.nan
    x[pick[410:420]] = np.inf
    x[pick[420:430]] = -np.inf
    x = torch.from_numpy(x)
    plan = flat_row_blocks(md.row_ptr.numpy(), tile, run_rows)
    want = flat_product(md.values, g, md.row_ptr, x)
    with np.errstate(invalid="ignore"):     # inf - inf, as the kernel's
        got = replay(md.values, g, md.row_ptr, plan, x, tile)
    assert torch.isnan(want).any() and torch.isinf(want).any()
    assert same_bits(got, want)
    # A row whose products are all -0.0 sums to +0.0 in both.
    zero = want == 0
    assert zero.any() and not torch.signbit(want[zero]).any()
