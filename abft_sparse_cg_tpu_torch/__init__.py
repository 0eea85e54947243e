"""abft_sparse_cg_tpu_torch — the ABFT-protected sparse CG solver on
PyTorch, with hand-written CUDA kernels for one NVIDIA H100.

The package mirrors the layout of ``abft_sparse_cg_tpu`` (the JAX/Pallas
reference, which stays as it is): every module here has its counterpart
at the same path there.  The NumPy host layer — matrix loading and the
protected layouts (``formats``), fault injection (``inject``), the
codeword layouts and the NumPy codec (``ecc.layout``/``ecc.codec``), the
matrix generators (``utils.matgen``/``utils.matzoo``) and the CLI
parser — is the port's own copy, tested byte-identical to the
reference's.  Nothing in this package imports ``jax`` or any module of
the JAX package.

Targets:

  ====== ===========================================================
  torch  plain PyTorch on the CPU (float64 by default): the port's
         correctness oracle, line-for-line comparable with ``-t jnp``
  cpu    the native C++/OpenMP library (native/abft_cg.cpp, float64,
         built at first use; backends.cpp_backend): stdout identical to
         ``bin/cg-csr -t cpu``
  cuda   the CUDA kernels of ``csrc/`` on ``cuda:0`` (float32):
         ``dia_spmv_detect``/``ell_spmv_detect`` (ops.spmv_cuda) and
         the whole-solve ``fused_cg_dia``/``fused_cg_ell``
         (solver.fused)
  ====== ===========================================================

Subpackages:
  ecc       codeword layouts, the codec (tensor and NumPy paths), value
            derivation, rotated fold
  formats   Matrix Market I/O, assembly, the DIA/ELL protected layouts
  ops       BLAS-1, the plain DIA/ELL SpMV with ABFT, the CUDA wrappers
  solver    CG (Python loops), the whole-solve fused CG wrapper, the
            segmented solve with snapshots (checkpoint) and pipelined CG
  parallel  the row-sharded solve over a mesh of shards
  backends  (target, mode) registry behind the CLI
  scrub     the offline verify-and-repair pass, and a solve's repaired
            planes as a host matrix
  tracing   the spans and counts of the host build and the solve path
  utils     matrix generators and the zoo of structural families
"""

__version__ = "0.1.0"
