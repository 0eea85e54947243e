"""CPU tests of the benchmark: ``python -m pytest bench_port/tests``.

Tests that need a CUDA card carry the ``cuda`` marker and skip without
one (they decide inside the test).  ``tiny_root`` is a checkout root
whose BENCHMARK.json names the real cells over small copies of their
configurations, so that a whole run fits the CPU.
"""

import json
import os
import sys

import pytest
import torch

# One thread per process: with torch's default, each of several test
# workers spreads over every core, and a small run's solves crawl.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# Small copies of each family's parameters (and the solve's limit where
# a 50-iteration solve would converge to rounding at the small size).
SMALL = {
    "hpcg27": ({"nx": 12, "ny": 12, "nz": 12}, {"max_itrs": 20}),
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one")


def small_config(path):
    with open(path) as f:
        cfg = json.load(f)
    params, top = SMALL[cfg["matrix"]["family"]]
    cfg["matrix"]["params"].update(params)
    cfg.update(top)
    return cfg


@pytest.fixture
def tiny_root(tmp_path):
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    os.makedirs(tmp_path / "configs")
    for c in bench["configs"]:
        cfg = small_config(os.path.join(ROOT, c["file"]))
        c["file"] = f"configs/{c['name']}.json"
        with open(tmp_path / c["file"], "w") as f:
            json.dump(cfg, f)
    with open(tmp_path / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)
    return str(tmp_path)
