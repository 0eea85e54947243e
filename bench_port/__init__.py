"""The benchmark of abft_sparse_cg_tpu_torch on one NVIDIA H100.

``python bench_port/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``, from the root of a checkout, runs one cell of
BENCHMARK.json: a closed loop of protected CG solves against a matrix
resident on the card, judged against the plain float64 CG of
``reference.py``.  Everything one configuration, traffic mix, matrix
family or metric needs sits in a file of its own, found by name:
``configs/<config>.json``, ``traffic/<mix>.json``,
``matrices/<family>.py`` and ``metrics/<metric>.py``.  The program is
imported in ``entry.py`` alone.
"""
