"""Device and compute-dtype policy of the three targets.

Replaces ``abft_sparse_cg_tpu.backends.base.default_dtype``: there the
platform JAX runs on decides; here the target does, and every function
of the package receives its ``torch.device`` explicitly (no global
default device is set anywhere).

  ====== ========= ====================================================
  target device    dtype ``auto``
  ====== ========= ====================================================
  torch  cpu       float64 (what ``jnp`` gives on the CPU with x64 on)
  cpu    cpu       float64 always (the native library's loop; ``--dtype``
                   is accepted and changes nothing, as on ``-t cpu``)
  cuda   cuda:0    float32 (the kernels are float32-only, as the
                   ``pallas`` target's are)
  ====== ========= ====================================================
"""

from __future__ import annotations

import torch

__all__ = ["target_device", "compute_dtype"]


def target_device(target: str) -> torch.device:
    if target in ("torch", "cpu"):
        return torch.device("cpu")
    if target == "cuda":
        return torch.device("cuda", 0)
    raise ValueError(f"unknown target {target!r}")


def compute_dtype(target: str, requested: str = "auto") -> torch.dtype:
    """Compute dtype for ``target`` under the CLI's ``--dtype`` value."""
    if requested in ("f32", "float32"):
        return torch.float32
    if requested in ("f64", "float64"):
        if target == "cuda":
            raise ValueError(
                "--dtype f64 is not supported on the cuda target (its "
                "kernels are float32-only); use -t torch for float64")
        return torch.float64
    if requested != "auto":
        raise ValueError(f"unknown dtype {requested!r}")
    return torch.float32 if target == "cuda" else torch.float64
