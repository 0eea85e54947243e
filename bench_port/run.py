"""The benchmark's command: one run of one cell of BENCHMARK.json.

    python3 bench_port/run.py --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for.  The last line of standard output is the result (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
the ``breakdown``, and last the ``checks``: each compared number beside
its limit); the last lines of standard error repeat the checks.  Without
the cards, or with JAX or the JAX package loaded, it prints no result
and exits nonzero.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    import torch

    from bench_port import harness

    cell = harness.find_cell(ROOT, args.workload)
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell.chips):
        print(f"{args.workload} needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           torch.device("cuda", 0), _T0)
    bad = harness.forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 3
    print(json.dumps(out.result), flush=True)
    for line in out.check_lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
