#!/usr/bin/env python3
"""The SASS of kernels A-E in this tree against another checkout's.

    python3 scripts/torch_sass_diff.py DIR

Builds the five sources of abft_sparse_cg_tpu_torch/csrc (this tree's and
DIR's, with the port's nvcc flags, into build/torch_sass_diff/) and
compares every kernel instance the two trees share, instruction for
instruction (cuobjdump -sass, constant-bank offsets aside: the kernels'
parameter offsets move with any change to a parameter struct; a UMOV of
a parameter's address into a uniform register still shows).  An
instance is matched by its name with the signal-plane count of the
one-plane instances taken out (``<..., 1>``, ``<1>``): the instances that
gained a two-plane twin keep their name otherwise, so each CSR96 and
ECC-mode instance pairs with the other tree's.  Prints, per instance, its
instruction count and the lines that differ, and the instances found in
one tree only.  Needs nvcc and cuobjdump (a CUDA toolkit); no card.
"""

import argparse
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "torch_sass_diff")
SOURCES = ("dia_spmv_detect", "ell_spmv_detect", "flat_spmv_detect",
           "fused_cg_dia", "fused_cg_ell")


def sass_functions(so):
    """{demangled kernel name: its SASS} of a library (cuobjdump -sass),
    every constant-bank offset written as * (c[0x0][*], c[0x0][R1+*]):
    the kernels' parameter offsets move with any change to a parameter
    struct.  (The
    mangled names differ between checkouts: nvcc tags the anonymous
    namespace with a hash of the file.)"""
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from abft_sparse_cg_tpu_torch import _build
    from torch_tail_probe import demangle

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", so], capture_output=True,
                          text=True, check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\w+)", line)
        if m:
            name = m.group(1)
            out[name] = []
        elif name and re.search(r"/\*[0-9a-f]{4,}\*/", line):
            ins = re.sub(r"^\s*/\*[0-9a-f]+\*/\s*|\s*/\*\s*0x[0-9a-f]+\s*\*/"
                         r"\s*$", "", line)
            ins = ins.strip().rstrip(";").strip()
            out[name].append(re.sub(r"c\[0x0\]\[(R\w+\+)?0x[0-9a-f]+\]",
                                    r"c[0x0][\1*]", ins))
    return {demangle(k): "\n".join(v) for k, v in out.items()}


def one_plane_key(name):
    """An instance's name without the plane count 1 of its template
    arguments and without the return type that only a template's
    demangled name carries."""
    name = re.sub(r"^void ", "", name)
    name = re.sub(r", (\(int\))?1>", ">", name)
    return re.sub(r"<(\(int\))?1>", "", name)


def build(tree, tag):
    """{source: library path} of ``tree``'s csrc, compiled in parallel."""
    sys.path.insert(0, ROOT)
    from abft_sparse_cg_tpu_torch import _build

    csrc = os.path.join(tree, "abft_sparse_cg_tpu_torch", "csrc")
    os.makedirs(OUT, exist_ok=True)
    out = {n: os.path.join(OUT, f"{tag}_{n}.so") for n in SOURCES}

    def one(n):
        subprocess.run([_build._nvcc(), *_build._FLAGS, "-I", csrc, "-o",
                        out[n], os.path.join(csrc, f"{n}.cu")], check=True)

    with ThreadPoolExecutor(len(SOURCES)) as ex:
        list(ex.map(one, SOURCES))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", help="the checkout to compare against")
    args = ap.parse_args()
    with ThreadPoolExecutor(2) as ex:
        mine_f = ex.submit(build, ROOT, "this")
        theirs_f = ex.submit(build, os.path.abspath(args.other), "other")
        mine_so, theirs_so = mine_f.result(), theirs_f.result()
    same = differ = 0
    for n in SOURCES:
        mine = {one_plane_key(k): v
                for k, v in sass_functions(mine_so[n]).items()}
        theirs = {one_plane_key(k): v
                  for k, v in sass_functions(theirs_so[n]).items()}
        print(f"{n}: {len(mine)} instances here, {len(theirs)} in "
              f"{args.other}")
        for fn in sorted(mine):
            if fn not in theirs:
                print(f"  only here: {fn[:100]}")
                continue
            a, b = theirs[fn].splitlines(), mine[fn].splitlines()
            diff = [f"- {x}" for x in a if x not in b][:3] + [
                f"+ {x}" for x in b if x not in a][:3]
            ndiff = sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))
            same += ndiff == 0
            differ += ndiff != 0
            print(f"  {fn[:90]}: {len(b)} instructions ({len(a)} there), "
                  f"{ndiff} lines differ"
                  + "".join(f"\n      {d[:100]}" for d in diff))
        for fn in sorted(set(theirs) - set(mine)):
            print(f"  only in {args.other}: {fn[:100]}")
    print(f"shared instances: {same} identical, {differ} differ")


if __name__ == "__main__":
    main()
