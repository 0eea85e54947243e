"""The readings that the limits of ``correct`` are set from, on the card.

    python3 bench_port/control.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9 --seconds 3 [--out FILE]

In one process, after one set-up of the cell: for each of ``--seeds``, a
short closed-loop window of the program at the cell's own size and load,
its sample judged against the float64 reference (the lower readings);
for each of ``--control-seeds``, the same window with the reference run
in bfloat16 in the program's place (the control, the upper readings).
One JSON line per window on standard output (and in ``--out``), then
the worst program reading and the best control reading of each number.
Under fault traffic both sides see the same faults, made in the
program's resident matrix, which the program repairs from window to
window and the control ignores.
The benchmark's own runs never run this.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control_solve(tri, config, device, dtype):
    """The reference in the program's place, in ``dtype``: an entry's
    ``solve(md, b) -> Answer``."""
    from bench_port import reference
    from bench_port.entry import Answer

    a = reference.assemble(tri, config["num_blocks"], device, dtype)

    def solve(md, b):
        sol = reference.cg(a, b, config["max_itrs"], config["conv"])
        return Answer(sol.x, sol.iterations, sol.rr, 0, 0, md=md)

    return solve


def windows(cell, seeds, control_seeds, seconds, device, emit):
    """Emit one record per window; return the records."""
    import importlib

    import torch

    from bench_port import compare, harness

    ent = importlib.import_module("bench_port.entry")
    cfg, mix = cell.config, cell.traffic
    tri = harness.triangle(cell)
    mat = ent.build(tri, cfg)
    md = ent.upload(mat, cfg, device)
    solve = ent.prepare(mat, cfg, mix, device)
    inject = ent.Injector(mat, cfg) if "fault_every" in mix else None
    del mat
    n = tri[3] * cfg["num_blocks"]
    nnz = harness.stored_entries(tri, cfg["num_blocks"])
    ctl = control_solve(tri, cfg, device, torch.bfloat16)

    def sync():
        ent.sync(device)

    out = []
    for side, fn, sds in (("program", solve, seeds),
                          ("control", ctl, control_seeds)):
        for seed in sds:
            rhs = harness.Rhs(seed, n, device)
            faults = (None if inject is None
                      else harness.Faults(mix, seed, nnz, inject))
            md = fn(md, rhs(-1)).md
            win, md = harness.closed_loop(fn, md, rhs, seconds,
                                          mix["sample"], seed, sync, faults)
            readings, _ = harness.judge(cell, tri, rhs, win.kept, device)
            worst = {k: max(r[k] for r in readings) for k in compare.NAMES}
            rec = {"cell": cell.name, "side": side, "seed": seed,
                   "requests": len(win.latencies), "compared": len(readings),
                   "bad_status": win.bad_status, **worst}
            emit(rec)
            out.append(rec)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from bench_port import compare, harness

    if not torch.cuda.is_available():
        print("control.py needs a CUDA card", file=sys.stderr)
        return 2
    cell = harness.find_cell(ROOT, args.workload)
    sink = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    def ints(s):
        return [int(v) for v in s.split(",") if v]

    try:
        recs = windows(cell, ints(args.seeds), ints(args.control_seeds),
                       args.seconds, torch.device("cuda", 0), emit)
    finally:
        if sink:
            sink.close()
    for k in compare.NAMES:
        lo = max(r[k] for r in recs if r["side"] == "program")
        hi = min(r[k] for r in recs if r["side"] == "control")
        print(f"{cell.name} {k}: program worst {lo!r}, control least {hi!r}, "
              f"limit {cell.config['limits'][k]!r}")
    print(f"{cell.name}: {time.perf_counter() - _T0:.1f} s in all")
    return 0


if __name__ == "__main__":
    sys.exit(main())
