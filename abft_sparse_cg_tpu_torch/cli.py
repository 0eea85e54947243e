"""Command-line interface of the port — the counterpart of cli.py:93-482.

Same flags, defaults, stdout lines and exit codes as the JAX CLI (the
parser below is a copy of its ``parse_arguments``, with ``cuda`` as
the default target where the JAX CLI has ``jnp``), so ``run_tests``
drives ``bin/cg-csr-torch`` and ``bin/cg-coo-torch`` (``main_csr``,
``main_coo``: the CSR96 and COO128 codewords) unchanged: the config
echo, the injection banner, ``[ECC]`` lines, ``iteration ... rr =``
lines, ``ran for``, ``time taken``, ``total error``.  Targets, in
``--list`` order: ``torch`` (plain PyTorch on the CPU, float64 by
default), ``cpu`` (the native C++/OpenMP library of native/abft_cg.cpp,
float64, built at first use; stdout identical to ``bin/cg-csr -t cpu``:
the reference's write-back onto copies of the planes, live only, its rr
and correction lines printed by the library as it runs) and ``cuda``
(the default: the kernels on the card, float32).  ``torch`` and ``cpu``
run only when asked for, as the tests do.  Without a card
``cuda-<mode>`` is not registered, so a run without ``-t`` prints "No
implementation found for cuda-<mode>" and exits 1; it never falls back
to the CPU.  ``main`` returns the exit code.

``-p jacobi``, ``--check-interval K`` (K > 1 or ``auto``) and
``--refine K`` reach the backend (cli.py:382-419): on ``cuda`` the Jacobi
and lazy instances of the whole-solve kernels, or the per-iteration
tier's lazy loop over the detection-free products; ``torch`` and
``cpu`` run Jacobi and refinement and, like ``-t jnp`` and ``-t cpu``
there, have no lazy schedule (they warn on stderr and run live).
``--quiet`` reaches the backend as ``verbose=False`` (the cpu target's
library then streams nothing).  ``--refine`` with ``--checkpoint`` is
refused, as in the JAX CLI.  ``--devices N`` row-shards the solve over N shards
(parallel.sharded), with R aligned at build time as cli.py:325-340 does:
on ``torch`` N shards on the CPU; on ``cuda`` one shard per card, each
holding its own rows of the planes and vectors, with only halo edges
copied between cards, and a host with fewer cards exits 1 with the JAX
message.  ``--checkpoint P``
(``--checkpoint-every N``, ``--resume``) segments the solve and
snapshots its state to P between segments (solver.checkpoint; the same
``.npz`` as the JAX CLI's), ``--solver pipelined`` runs
solver.pipelined, and ``--profile DIR`` writes a torch.profiler trace of
the solve into DIR (cli.py:375-418).  A solver option a route refuses
(``--checkpoint`` with pipelined, pipelined with ``-p jacobi``, more
shards than cards) prints "options unsupported for target '<t>': ..."
and exits 1, as there; ``-t cpu`` refuses ``--devices N``, ``--solver
pipelined`` and ``--checkpoint`` with the JAX cpu target's texts.
"""

from __future__ import annotations

import contextlib
import os
import sys

import numpy as np

__all__ = ["main", "main_csr", "main_coo", "parse_arguments"]

_USAGE_OPTIONS = """Options:
  -h  --help                  Print this message
  -b  --num-blocks      B     Number of times to block input matrix
  -c  --convergence     C     Convergence threshold
  -f  --matrix-file     M     Path to matrix-market format file
  -i  --iterations      I     Maximum number of iterations
  -l  --list                  List available implementations
  -m  --mode            MODE  ABFT mode
  -t  --target          TARG  Implementation target (default: cuda,
                              the kernels on the card; torch: plain
                              PyTorch on the CPU; cpu: the native
                              C++/OpenMP library, float64)
  -x  --inject-bitflip        Inject a random bit-flip into A
      --format          F     Storage format: csr | coo
      --seed            S     Seed b-vector and injector RNGs
      --dtype           D     Compute dtype: auto | f32 | f64
      --quiet                 Suppress per-iteration residual output
      --profile         DIR   Write a torch.profiler trace of the
                              solve to DIR/trace.json
      --devices         N     Row-shard the solve over N devices
                              (cuda: one shard per card, each
                              shard's rows on its own card)
      --solver          S     CG variant: standard | pipelined
                              (one reduction point per iteration;
                              no -p jacobi, no --checkpoint)
      --reps            N     Executions averaged into 'time taken'
                              (default: 10 on cuda, 1 on torch;
                              cpu: one run, its own clock)
      --refine          K     Mixed-precision refinement: up to K
                              rounds of f32 inner CG + binary64
                              true-residual restart (f64-level final
                              accuracy at f32 kernel speed)
      --check-interval  K     Lazy ABFT schedule: verify every K-th
                              iteration, snapshot-rollback on a
                              trigger (default 1 = live; 'auto' =
                              live on the whole-solve kernels, 32 on
                              the per-iteration tier; torch: live)
      --checkpoint      PATH  Segment the solve and snapshot CG state
                              to PATH (.npz) between segments
      --checkpoint-every N    Iterations per segment (default: 100)
      --resume                Resume from --checkpoint PATH if present
                              (a snapshot of bin/cg-csr or cg-coo too)
  -p  --precond         P     Preconditioner: none | jacobi

  The -l|--list argument will provide a list of tuples that describe
  which implementations are available to be passed to the
  -t|--target and -m|--mode arguments.

  The -x|--inject-bitflip argument optionally takes a number to
  control how many bits to flip, and either INDEX or VALUE to
  restrict the region of bits in the matrix element to target.
"""

DEFAULT_MATRIX = os.path.join(
    os.path.dirname(os.path.abspath(__file__)),
    "..", "matrices", "shallow_water1", "shallow_water1.mtx",
)


def _parse_double(s):
    try:
        return float(s)
    except ValueError:
        return -1.0


def _parse_int(s):
    try:
        v = int(s)
        return v
    except ValueError:
        return -1


def parse_arguments(argv, fmt):
    params = {
        "max_itrs": 1000,
        "conv_threshold": 0.001,
        "num_bit_flips": 0,
        "bitflip_kind": "ANY",
        "num_blocks": 25,
        "matrix_file": os.path.normpath(DEFAULT_MATRIX),
        "target": "cuda",
        "mode": "none",
        "fmt": fmt,
        "seed": None,
        "dtype": "auto",
        "quiet": False,
        "list": False,
        "profile": None,
        "precond": "none",
        "devices": 0,
        "solver": "standard",
        "reps": 0,
        "checkpoint": None,
        "checkpoint_every": 100,
        "resume": False,
    }
    i = 0
    n = len(argv)
    while i < n:
        a = argv[i]
        if a in ("--convergence", "-c"):
            i += 1
            if i >= n or (v := _parse_double(argv[i])) < 0:
                print("Invalid convergence threshold")
                raise SystemExit(1)
            params["conv_threshold"] = v
        elif a in ("--iterations", "-i"):
            i += 1
            if i >= n or (v := _parse_int(argv[i])) < 0:
                print("Invalid number of iterations")
                raise SystemExit(1)
            params["max_itrs"] = v
        elif a in ("--list", "-l"):
            params["list"] = True
        elif a in ("--num-blocks", "-b"):
            i += 1
            if i >= n or (v := _parse_int(argv[i])) < 1:
                print("Invalid number of blocks")
                raise SystemExit(1)
            params["num_blocks"] = v
        elif a in ("--matrix-file", "-f"):
            i += 1
            if i >= n:
                print("Matrix filename required")
                raise SystemExit(1)
            params["matrix_file"] = argv[i]
        elif a in ("--mode", "-m"):
            i += 1
            if i >= n:
                print("ABFT mode required")
                raise SystemExit(1)
            params["mode"] = argv[i]
        elif a in ("--target", "-t"):
            i += 1
            if i >= n:
                print("Implementation target required")
                raise SystemExit(1)
            params["target"] = argv[i]
        elif a in ("--inject-bitflip", "-x"):
            params["num_bit_flips"] = 1
            # Greedy optional sub-args, like the reference (cg.cpp:254-274).
            while i + 1 < n and not argv[i + 1].startswith("-"):
                i += 1
                if argv[i] == "INDEX":
                    params["bitflip_kind"] = "INDEX"
                elif argv[i] == "VALUE":
                    params["bitflip_kind"] = "VALUE"
                elif (v := _parse_int(argv[i])) >= 1:
                    params["num_bit_flips"] = v
                else:
                    print("Invalid bit-flip parameter")
                    raise SystemExit(1)
        elif a == "--format":
            i += 1
            if i >= n or argv[i] not in ("csr", "coo"):
                print("Invalid format (csr|coo)")
                raise SystemExit(1)
            params["fmt"] = argv[i]
        elif a == "--seed":
            i += 1
            if i >= n or (v := _parse_int(argv[i])) < 0:
                print("Invalid seed")
                raise SystemExit(1)
            params["seed"] = v
        elif a == "--dtype":
            i += 1
            if i >= n or argv[i] not in ("auto", "f32", "f64"):
                print("Invalid dtype (auto|f32|f64)")
                raise SystemExit(1)
            params["dtype"] = argv[i]
        elif a == "--quiet":
            params["quiet"] = True
        elif a == "--profile":
            i += 1
            if i >= n:
                print("Profile directory required")
                raise SystemExit(1)
            params["profile"] = argv[i]
        elif a == "--devices":
            i += 1
            if i >= n or (v := _parse_int(argv[i])) < 1:
                print("Invalid device count")
                raise SystemExit(1)
            params["devices"] = v
        elif a == "--solver":
            i += 1
            if i >= n or argv[i] not in ("standard", "pipelined"):
                print("Invalid solver (standard|pipelined)")
                raise SystemExit(1)
            params["solver"] = argv[i]
        elif a == "--reps":
            i += 1
            if i >= n or (v := _parse_int(argv[i])) < 1:
                print("Invalid rep count")
                raise SystemExit(1)
            params["reps"] = v
        elif a == "--checkpoint":
            i += 1
            if i >= n:
                print("Checkpoint path required")
                raise SystemExit(1)
            params["checkpoint"] = argv[i]
        elif a == "--checkpoint-every":
            i += 1
            if i >= n or (v := _parse_int(argv[i])) < 1:
                print("Invalid checkpoint interval")
                raise SystemExit(1)
            params["checkpoint_every"] = v
        elif a == "--resume":
            params["resume"] = True
        elif a == "--refine":
            i += 1
            if i >= n or (v := _parse_int(argv[i])) < 0:
                print("Invalid refine count")
                raise SystemExit(1)
            params["refine"] = v
        elif a == "--check-interval":
            i += 1
            if i < n and argv[i] == "auto":
                # Kept symbolic: the backend resolves it once the
                # matrix routes.
                params["check_interval"] = "auto"
            elif i >= n or (v := _parse_int(argv[i])) < 1:
                print("Invalid check interval")
                raise SystemExit(1)
            else:
                params["check_interval"] = v
        elif a in ("--precond", "-p"):
            i += 1
            if i >= n or argv[i] not in ("none", "jacobi"):
                print("Invalid preconditioner (none|jacobi)")
                raise SystemExit(1)
            params["precond"] = argv[i]
        elif a in ("--help", "-h"):
            exe = f"cg-{fmt}-torch"
            print(f"\nUsage: {exe} [OPTIONS]\n")
            print(_USAGE_OPTIONS)
            raise SystemExit(0)
        else:
            print(f"Unrecognized argument '{a}' (try '--help')")
            raise SystemExit(1)
        i += 1
    return params


@contextlib.contextmanager
def _profile(path, device):
    """``--profile DIR`` (cli.py:375-380, where jax.profiler.trace
    writes): a torch.profiler window around the solve, the card's
    activity too when the solve runs on one, whose Chrome trace is
    written into ``path`` (created if missing) as ``trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(path, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(path, "trace.json"))


def main(argv=None, fmt="csr") -> int:
    """Run the CLI; returns the exit code (argument errors and an unknown
    target-mode exit directly, as in the reference)."""
    if argv is None:
        import signal

        if hasattr(signal, "SIGPIPE"):
            signal.signal(signal.SIGPIPE, signal.SIG_DFL)
    argv = sys.argv[1:] if argv is None else argv
    return _main(parse_arguments(argv, fmt))


def _main(params):
    from .backends import create, list_contexts
    from .device import compute_dtype

    if params["list"]:
        list_contexts()
        return 0

    backend = create(params["target"], params["mode"])
    if params.get("refine") and params["checkpoint"]:
        # cli.py:387-389: the refinement's inner solves would share one
        # snapshot path, and a resume would replay a different rhs.
        print("--refine cannot be combined with --checkpoint/--resume")
        return 1
    try:
        compute_dtype(params["target"], params["dtype"])
    except ValueError as e:
        print(str(e))
        return 1

    from .formats import build_protected, load_matrix
    from .inject import inject_bitflips

    try:
        assembled = load_matrix(params["matrix_file"], params["num_blocks"])
    except FileNotFoundError:
        print(f"Failed to open '{params['matrix_file']}'")
        return 1
    except ValueError as e:
        print(str(e))
        return 1
    ra = None
    if params["devices"] and params["devices"] > 1:
        # Align the padded row count to the mesh at build time so the
        # sharded tiers stay available for any N (cli.py:325-340): the
        # kernel tier needs 1024 rows per shard (on cuda, the pallas
        # target's counterpart), the single-device program 8.
        import math

        ra = math.lcm((1024 if params["target"] == "cuda" else 8)
                      * params["devices"], 128)
    try:
        mat = build_protected(params["fmt"], assembled, params["mode"],
                              row_align=ra)
    except ValueError as e:
        # A matrix the build cannot take: one line, exit 1.
        print(str(e))
        return 1

    N, nnz = mat.N, mat.nnz
    block_size = N // params["num_blocks"]
    print()
    print(f"implementation        = {params['target']}-{params['mode']}")
    print(f"storage format        = {params['fmt']}")
    print(f"matrix size           = {N} x {N}")
    print(f"matrix block size     = {block_size} x {block_size}")
    print(f"number of non-zeros   = {nnz} ({nnz / (float(N) * N) * 100:.4f}%)")
    print(f"maximum iterations    = {params['max_itrs']}")
    print(f"convergence threshold = {params['conv_threshold']:g}")
    print()

    # b ~ U[0,1) and the injector RNG: the reference CLI's exact streams
    # (cli.py:363-371), so both packages see the same system and fault.
    seed = params["seed"]
    b = np.random.default_rng(12345 if seed is None else seed).random(N)
    if params["num_bit_flips"]:
        inj_rng = np.random.default_rng(None if seed is None else seed + 1)
        mat = inject_bitflips(mat, params["bitflip_kind"],
                              params["num_bit_flips"], inj_rng)

    # --checkpoint reaches the solve only when given (cli.py:391-398).
    extra = {}
    if params["checkpoint"]:
        extra = dict(checkpoint=params["checkpoint"],
                     checkpoint_every=params["checkpoint_every"],
                     resume=params["resume"])
    kw = dict(verbose=not params["quiet"], dtype=params["dtype"],
              precond=params["precond"],
              check_interval=params.get("check_interval"),
              devices=params["devices"], solver=params["solver"], **extra)
    profile_cm = (_profile(params["profile"], backend.device)
                  if params["profile"] else contextlib.nullcontext())
    with profile_cm:
        try:
            if params.get("refine"):
                # Mixed-precision refinement: inner solves on the target
                # plus binary64 true-residual restarts (backends.base.
                # solve_refined).
                res = backend.solve_refined(mat, b, params["max_itrs"],
                                            params["conv_threshold"],
                                            params["refine"], **kw)
            else:
                res = backend.solve(mat, b, params["max_itrs"],
                                    params["conv_threshold"],
                                    reps=params["reps"], **kw)
        except (TypeError, ValueError, NotImplementedError) as e:
            if not (params["devices"] or params["solver"] != "standard"
                    or params["checkpoint"]):
                raise
            # More shards than cards, a mesh this package does not run,
            # or a solver option the route refuses: one line, exit 1
            # (cli.py:409-418).
            print(f"options unsupported for target '{params['target']}': "
                  f"{e}")
            return 1

    # ABFT event messages print first (reference cg.cpp:97 runs before
    # the rr print at cg.cpp:117), then the per-iteration residuals.
    for msg in res.messages:
        print(msg)
    if not params["quiet"] and res.rr_trace is not None:
        shown = min(res.iterations, len(res.rr_trace))
        for i in range(shown):
            print(f"iteration {i:5d} :  rr = {res.rr_trace[i]:12.4f}")
        if shown < res.iterations:
            print(f"... ({res.iterations - shown} further iterations "
                  "untraced)")

    if res.failed:
        return 1

    print()
    print(f"ran for {res.iterations} iterations")
    print(f"\ncompile time = {res.compile_seconds * 1e3:7.2f} ms")
    print(f"\ntime taken = {res.solve_seconds * 1e3:7.2f} ms\n")

    # Verification: r = A@x vs b (reference cg.cpp:127-144).
    w, errcode, msgs = backend.spmv_once(mat, res.x, dtype=params["dtype"])
    if errcode != 0:
        for msg in msgs:
            if "corrected" not in msg:
                print(msg)
        return 1
    err = np.abs(b - w)
    print(f"total error = {np.sqrt(np.sum(err * err)):f}")
    print(f"max error   = {np.max(err):f}")
    print()
    return 0


def main_csr(argv=None) -> int:
    return main(argv, fmt="csr")


def main_coo(argv=None) -> int:
    return main(argv, fmt="coo")


if __name__ == "__main__":
    raise SystemExit(main())
