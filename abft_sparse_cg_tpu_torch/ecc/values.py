"""Binary64 bit-planes -> compute-dtype values, on tensors.

Counterpart of ``abft_sparse_cg_tpu.ecc.values`` (:44-98).  The float32
conversion is the reference's TRUNCATING one (round toward zero on the
mantissa, overflow to +/-inf, f32-underflow and binary64 denormals to
+/-0, NaN kept NaN) — not a rounding ``float64 -> float32`` cast, which
would make the f32 trajectories drift from the JAX ones.  The float64
path reassembles the exact bits.

Inputs are widened (int64, values in ``[0, 2**32)``) planes, see
``ecc.codec``.  ``f64_to_planes`` / ``planes_to_f64_np`` are the host-side
NumPy split and reassembly (copies of the JAX package's).
"""

from __future__ import annotations

import numpy as np
import torch

from .codec import MASK32

__all__ = ["f64_to_planes", "planes_to_f64_np", "planes_to_f32",
           "planes_to_f64", "planes_to_value"]


def f64_to_planes(values: np.ndarray):
    """Split float64 values into (lo, hi) uint32 planes."""
    bits = np.ascontiguousarray(values, dtype=np.float64).view(np.uint64)
    lo = (bits & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (bits >> np.uint64(32)).astype(np.uint32)
    return lo, hi


def planes_to_f64_np(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """Reassemble float64 values from uint32 planes."""
    bits = lo.astype(np.uint64) | (hi.astype(np.uint64) << np.uint64(32))
    return bits.view(np.float64)


def planes_to_f32(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    sign = hi >> 31
    exp11 = (hi >> 20) & 0x7FF
    # Top 23 mantissa bits of the 52-bit binary64 mantissa (truncating).
    mant23 = ((hi & 0xFFFFF) << 3) | (lo >> 29)
    exp8 = exp11 - 1023 + 127

    is_zero_or_denorm = exp11 == 0
    is_naninf = exp11 == 0x7FF
    overflow = exp8 >= 255
    underflow = exp8 <= 0

    f32_bits = (sign << 31) | (torch.clamp(exp8, 1, 254) << 23) | mant23
    inf_bits = (sign << 31) | 0x7F800000
    nan_bits = inf_bits | torch.where(mant23 == 0,
                                      torch.ones_like(mant23), mant23)
    zero_bits = sign << 31

    f32_bits = torch.where(overflow, inf_bits, f32_bits)
    f32_bits = torch.where(underflow, zero_bits, f32_bits)
    f32_bits = torch.where(is_zero_or_denorm, zero_bits, f32_bits)
    f32_bits = torch.where(is_naninf & (mant23 == 0), inf_bits, f32_bits)
    is_nan = is_naninf & ((mant23 != 0) | ((lo & 0x1FFFFFFF) != 0))
    f32_bits = torch.where(is_nan, nan_bits, f32_bits)
    return (f32_bits & MASK32).to(torch.int32).view(torch.float32)


def planes_to_f64(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    # hi << 32 wraps through the int64 sign bit: the bits are exact.
    return (lo | (hi << 32)).view(torch.float64)


def planes_to_value(lo, hi, dtype: torch.dtype) -> torch.Tensor:
    """Values from planes in the requested compute dtype."""
    if dtype == torch.float32:
        return planes_to_f32(lo, hi)
    if dtype == torch.float64:
        return planes_to_f64(lo, hi)
    raise ValueError(f"unsupported compute dtype: {dtype}")
