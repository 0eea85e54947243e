"""The port's ECC tensor paths against the JAX package, bit for bit.

Codewords are built with the reference's NumPy encoder from seeded
random data; every 1-bit and every 2-bit flip pattern of a codeword is
checked through both packages' ``check_and_correct`` (the JAX one on jnp
arrays), and the value derivation and fold on adversarial bit patterns.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from abft_sparse_cg_tpu.ecc import codec as jcodec
from abft_sparse_cg_tpu.ecc.fold import fold_words as jfold_words
from abft_sparse_cg_tpu.ecc.layout import COO128, CSR96
from abft_sparse_cg_tpu.ecc.values import f64_to_planes
from abft_sparse_cg_tpu.ecc.values import planes_to_value as jplanes_to_value
from abft_sparse_cg_tpu_torch.ecc import codec
from abft_sparse_cg_tpu_torch.ecc.fold import fold_words
from abft_sparse_cg_tpu_torch.ecc.values import planes_to_value

# Small eager CPU tensors: one intra-op thread per process, so that
# parallel test workers do not oversubscribe the cores.
torch.set_num_threads(1)


def t64(a):
    """uint32 NumPy plane -> widened int64 tensor."""
    return codec.widen(codec.from_numpy_u32(a, "cpu"))


def u32(t):
    return codec.to_numpy_u32(t)


def clean_words(layout, n, seed):
    rng = np.random.default_rng(seed)
    vlo, vhi = f64_to_planes(rng.standard_normal(n) * 10.0)
    col = rng.integers(0, 1 << 24, n).astype(np.uint32)
    if layout is CSR96:
        return [vlo, vhi, col]
    row = rng.integers(0, 1 << 24, n).astype(np.uint32)
    return [col, row, vlo, vhi]


def flipped(layout, mode, seed):
    """Every 1-bit and every 2-bit flip pattern, one codeword each."""
    pats = ([(b,) for b in range(layout.total_bits)]
            + list(itertools.combinations(range(layout.total_bits), 2)))
    words = jcodec.encode(mode, clean_words(layout, len(pats), seed), layout)
    words = [w.copy() for w in words]
    for i, bits in enumerate(pats):
        for b in bits:
            w, bit = divmod(b, 32)
            words[w][i] ^= np.uint32(1 << bit)
    return words


@pytest.mark.parametrize("layout", [CSR96, COO128], ids=["csr96", "coo128"])
@pytest.mark.parametrize("mode", ["sed", "sec7", "sec8", "secded"])
def test_check_and_correct_every_1_and_2_bit_flip(layout, mode):
    words = flipped(layout, mode, seed=7)
    jw, jf = jcodec.check_and_correct(mode, [jnp.asarray(w) for w in words],
                                      layout)
    tw, tf = codec.check_and_correct(mode, [t64(w) for w in words], layout)
    for a, b in zip(jw, tw):
        np.testing.assert_array_equal(np.asarray(a), u32(b))
    for k in ("detected", "corrected", "double"):
        np.testing.assert_array_equal(np.asarray(jf[k]), tf[k].numpy(), k)
    np.testing.assert_array_equal(np.asarray(jf["corrected_bit"]),
                                  u32(tf["corrected_bit"]))


@pytest.mark.parametrize("layout", [CSR96, COO128], ids=["csr96", "coo128"])
@pytest.mark.parametrize("mode", ["none", "sed", "sec7", "sec8", "secded"])
def test_check_and_correct_np_every_1_and_2_bit_flip(layout, mode):
    """The NumPy host path (the Jacobi diagonal, the refinement residual)
    against the JAX codec's NumPy path: planes and flags, dtypes
    included."""
    words = flipped(layout, mode, seed=9)
    jw, jf = jcodec.check_and_correct(mode, words, layout)
    tw, tf = codec.check_and_correct_np(mode, words, layout)
    for a, b in zip(jw, tw):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    for k in jf:
        assert np.asarray(jf[k]).dtype == tf[k].dtype, k
        np.testing.assert_array_equal(np.asarray(jf[k]), tf[k], k)


@pytest.mark.parametrize("layout", [CSR96, COO128], ids=["csr96", "coo128"])
def test_parity_syndrome_decode_match(layout):
    words = flipped(layout, "sec7", seed=8)
    jw = [jnp.asarray(w) for w in words]
    tw = [t64(w) for w in words]
    np.testing.assert_array_equal(np.asarray(jcodec.overall_parity(jw)),
                                  u32(codec.overall_parity(tw)))
    jsyn = jcodec.syndrome(jw, layout)
    tsyn = codec.syndrome(tw, layout)
    np.testing.assert_array_equal(np.asarray(jsyn), u32(tsyn))
    nz = np.asarray(jsyn) != 0
    np.testing.assert_array_equal(
        np.asarray(jcodec.decode_flipped_bit(jsyn, layout))[nz],
        u32(codec.decode_flipped_bit(tsyn, layout))[nz])


def test_popcount_matches_numpy():
    a = np.random.default_rng(1).integers(0, 1 << 32, 4096,
                                          dtype=np.uint64).astype(np.uint32)
    a[:4] = [0, 1, 0xFFFFFFFF, 0x80000000]
    np.testing.assert_array_equal(u32(codec.popcount32(t64(a))),
                                  np.bitwise_count(a).astype(np.uint32))


def test_u32_round_trip():
    a = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], np.uint32)
    t = codec.from_numpy_u32(a, "cpu")
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(codec.to_numpy_u32(t), a)
    assert codec.widen(t).tolist() == [int(v) for v in a]


@pytest.mark.parametrize("nwords", [1, 2, 3, 4])
def test_fold_words_matches(nwords):
    rng = np.random.default_rng(nwords)
    planes = [rng.integers(0, 1 << 32, (3, 512), dtype=np.uint64)
              .astype(np.uint32) for _ in range(nwords)]
    want = jfold_words([jnp.asarray(p) for p in planes])
    got = fold_words([t64(p) for p in planes])
    np.testing.assert_array_equal(np.asarray(want), u32(got))


def special_values():
    f = np.finfo(np.float64)
    vals = [0.0, -0.0, 1.0, -1.5, 3.0e38, 3.5e38, -1e300, 1e-38, 1e-40,
            1e-46, f.tiny, f.tiny / 3, -f.tiny / 7, f.max, np.inf, -np.inf,
            np.nan, -np.nan, 1.0 + 2 ** -30, 1.0 - 2 ** -40, 4.0, -1.0,
            np.pi, 2.0 ** 127, 2.0 ** 128, 2.0 ** -126, 2.0 ** -127]
    rng = np.random.default_rng(2)
    bits = rng.integers(0, 1 << 64, 4096, dtype=np.uint64)
    rand = bits.view(np.float64)  # every class: NaN payloads, denormals
    lo, hi = f64_to_planes(np.concatenate([np.array(vals), rand]))
    # NaN with a payload only in the low 29 bits (truncated away by the
    # f32 mantissa): must stay NaN, not become inf.
    lo = np.concatenate([lo, np.array([1, 0x1FFFFFFF], np.uint32)])
    hi = np.concatenate([hi, np.array([0x7FF00000, 0xFFF00000], np.uint32)])
    return lo, hi


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_value_derivation_bit_exact(dtype):
    lo, hi = special_values()
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.float64, torch.float64))
    want = np.asarray(jplanes_to_value(jnp.asarray(lo), jnp.asarray(hi), jdt))
    got = planes_to_value(t64(lo), t64(hi), tdt).numpy()
    ibits = np.uint32 if dtype == "f32" else np.uint64
    np.testing.assert_array_equal(got.view(ibits), want.view(ibits))


def test_f32_derivation_truncates():
    """1 + 2**-24 + 2**-30 rounds up to 1 + 2**-23 in a cast, truncates
    to 1.0 here (the reference's conversion)."""
    v = 1.0 + 2.0 ** -24 + 2.0 ** -30
    lo, hi = f64_to_planes(np.array([v]))
    got = planes_to_value(t64(lo), t64(hi), torch.float32)
    assert float(got[0]) == 1.0
    assert float(torch.tensor(v, dtype=torch.float64).float()) != 1.0
