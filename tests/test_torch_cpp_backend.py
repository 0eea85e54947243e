"""The port's ``cpu`` target (backends/cpp_backend.py, the native
C++/OpenMP library built from native/abft_cg.cpp into build/) against
the JAX package's (the same source, byte-identical planes: x, the rr
trace and the iterations equal exactly, in one process, so at one
thread count) and against the port's ``-t torch`` in float64 (the JAX
test's tolerances); ABFT events under injected faults, the write-back
onto copies, the breakdown guard, the live stream, the refusals, and
the library's build (its place, its lock, a failing compiler)."""

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from abft_sparse_cg_tpu.backends import cpp_backend as jcpp
from abft_sparse_cg_tpu.formats import assemble as jassemble
from abft_sparse_cg_tpu.formats import build_protected as jbuild
from abft_sparse_cg_tpu.inject import inject_bitflips as jinject
from abft_sparse_cg_tpu_torch.backends import available, cpp_backend, create
from abft_sparse_cg_tpu_torch.backends import torch_backend
from abft_sparse_cg_tpu_torch.formats import assemble, build_protected
from abft_sparse_cg_tpu_torch.inject import inject_bitflips
from abft_sparse_cg_tpu_torch.ops.spmv import ERR_BREAKDOWN
from abft_sparse_cg_tpu_torch.utils.matgen import spd_tridiagonal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ["none", "constraints", "sed", "sec7", "sec8", "secded"]
RNG = np.random.default_rng(31)
torch.set_num_threads(1)


def pair(fmt, mode, n=96, blocks=3):
    """The same system as a port matrix and a JAX package matrix."""
    rows, cols, vals, n = spd_tridiagonal(n)
    return (build_protected(fmt, assemble(cols, rows, vals, n, blocks), mode),
            jbuild(fmt, jassemble(cols, rows, vals, n, blocks), mode))


def quiet(m, rng_seed, inject=inject_bitflips):
    return inject(m, "ANY", 1, np.random.default_rng(rng_seed),
                  echo=lambda s: None)


def test_cpu_target_registered_between_torch_and_cuda():
    targets = [t for t, _ in available()]
    assert [("cpu", m) for m in MODES] == [p for p in available()
                                          if p[0] == "cpu"]
    last_torch = max(i for i, t in enumerate(targets) if t == "torch")
    assert targets.index("cpu") == last_torch + 1
    if "cuda" in targets:
        assert targets.index("cuda") > targets.index("cpu")


@pytest.mark.parametrize("fmt", ["csr", "coo"])
@pytest.mark.parametrize("mode", MODES)
def test_solve_matches_jax_and_torch(fmt, mode):
    m, jm = pair(fmt, mode)
    b = RNG.random(m.N)
    rc = create("cpu", mode).solve(m, b, 500, 1e-10, verbose=False)
    rj = jcpp.CppBackend(mode).solve(jm, b, 500, 1e-10, verbose=False)
    rt = create("torch", mode).solve(m, b, 500, 1e-10, dtype="f64")
    assert rc.errcode == rj.errcode == rt.errcode == 0
    assert rc.iterations == rj.iterations == rt.iterations
    np.testing.assert_array_equal(rc.x, rj.x)
    np.testing.assert_array_equal(rc.rr_trace, rj.rr_trace)
    assert rc.rr == rj.rr
    np.testing.assert_allclose(rc.x, rt.x, rtol=1e-12)
    np.testing.assert_allclose(rc.rr_trace[: rc.iterations],
                               rt.rr_trace[: rt.iterations], rtol=1e-10)


@pytest.mark.parametrize("fmt", ["csr", "coo"])
def test_abft_events_match_jax_and_torch(fmt):
    b = None
    for mode in ("sed", "sec7", "sec8", "secded"):
        for seed in range(3):
            m, jm = pair(fmt, mode)
            if b is None:
                b = RNG.random(m.N)
            m2, jm2 = quiet(m, seed), quiet(jm, seed, jinject)
            rc = create("cpu", mode).solve(m2, b, 500, 1e-10, verbose=False)
            rj = jcpp.CppBackend(mode).solve(jm2, b, 500, 1e-10,
                                             verbose=False)
            rt = create("torch", mode).solve(m2, b, 500, 1e-10, dtype="f64")
            assert rc.errcode == rj.errcode == rt.errcode, (mode, seed)
            assert rc.messages == rj.messages == rt.messages, (mode, seed)
            assert rc.corrected_count == rj.corrected_count, (mode, seed)
            assert rc.iterations == rj.iterations, (mode, seed)
            np.testing.assert_array_equal(rc.x, rj.x)
            if rc.errcode == 0:
                np.testing.assert_allclose(rc.x, rt.x, rtol=1e-12)


@pytest.mark.parametrize("fmt", ["csr", "coo"])
def test_spmv_once_matches_jax(fmt):
    m, jm = pair(fmt, "secded")
    x = RNG.random(m.N)
    for seed in (None, 2):
        mm, jmm = (m, jm) if seed is None else (quiet(m, seed),
                                                quiet(jm, seed, jinject))
        w, code, msgs = create("cpu", "secded").spmv_once(mm, x)
        jw, jcode, jmsgs = jcpp.CppBackend("secded").spmv_once(jmm, x)
        np.testing.assert_array_equal(w, jw)
        assert (code, msgs) == (jcode, jmsgs)
        assert bool(msgs) == (seed is not None)


def test_writeback_scrubs_copies_not_the_callers_planes():
    """The library repairs the planes it is given in place (the
    reference's write-back), but those are copies: the caller's planes,
    exec layout and checksums stay as they were, and a second solve sees
    the fault again (and corrects it once per solve)."""
    m, _ = pair("csr", "sec8")
    b = RNG.random(m.N)
    m2 = quiet(m, 2)
    before = ({k: v.copy() for k, v in m2.planes.items()},
              {k: v.copy() for k, v in m2.ell.items()},
              m2.ell_cksum.copy(), m2.flat_cksum.copy())
    backend = create("cpu", "sec8")
    r1 = backend.solve(m2, b, 500, 1e-10, verbose=False,
                       want_scrubbed=True)
    assert r1.corrected_count == 1 and r1.scrubbed is None
    for k, v in before[0].items():
        np.testing.assert_array_equal(m2.planes[k], v)
    for k, v in before[1].items():
        np.testing.assert_array_equal(m2.ell[k], v)
    np.testing.assert_array_equal(m2.ell_cksum, before[2])
    np.testing.assert_array_equal(m2.flat_cksum, before[3])
    r2 = backend.solve(m2, b, 500, 1e-10, verbose=False)
    assert r2.corrected_count == 1 and r2.messages == r1.messages
    np.testing.assert_array_equal(r2.x, r1.x)


def test_native_breakdown_guard():
    """A = -I: ERR_BREAKDOWN from the native loop, the JAX message."""
    n = 32
    idx = np.arange(n)
    m = build_protected("csr", assemble(idx, idx, -np.ones(n), n, 1), "none")
    jm = jbuild("csr", jassemble(idx, idx, -np.ones(n), n, 1), "none")
    b = RNG.random(n)
    res = create("cpu", "none").solve(m, b, 100, 1e-10, verbose=False)
    jres = jcpp.CppBackend("none").solve(jm, b, 100, 1e-10, verbose=False)
    assert res.failed and res.errcode == ERR_BREAKDOWN
    assert res.messages == jres.messages
    assert any("breakdown" in s for s in res.messages)


def test_live_streaming_skips_duplicate_messages(capfd):
    """verbose=True: the native loop prints the rr lines and the
    correction line itself, to fd 1, after what Python printed before
    the call; the result then carries no second correction message and
    no trace to replay."""
    m, _ = pair("csr", "sec8")
    b = RNG.random(m.N)
    m2 = quiet(m, 2)
    print("before the solve")
    res = create("cpu", "sec8").solve(m2, b, 500, 1e-10, verbose=True)
    out = capfd.readouterr().out.splitlines()
    assert res.corrected_count == 1
    assert not any(s.startswith("[ECC] corrected") for s in res.messages)
    assert res.rr_trace is None
    assert out[0] == "before the solve"
    assert out[1].startswith("[ECC] corrected bit ")
    assert out[2:] == [f"iteration {i:5d} :  rr = {rr:12.4f}"
                       for i, rr in enumerate(create("cpu", "sec8").solve(
                           m2, b, 500, 1e-10, verbose=False).rr_trace[
                               : res.iterations])]


@pytest.mark.parametrize("kw", [dict(devices=2), dict(solver="pipelined"),
                                dict(checkpoint="snap.npz")],
                         ids=["devices", "pipelined", "checkpoint"])
def test_refusals_carry_the_jax_texts(kw):
    """What the CLI prints after "options unsupported for target
    'cpu': ": the JAX module's texts, and for a checkpoint the TypeError
    that its signature (which has none) makes Python raise."""
    m, jm = pair("csr", "secded")
    b = RNG.random(m.N)
    with pytest.raises((TypeError, ValueError)) as err:
        create("cpu", "secded").solve(m, b, 100, 1e-10, **kw)
    with pytest.raises((TypeError, ValueError)) as jerr:
        jcpp.CppBackend("secded").solve(jm, b, 100, 1e-10, **kw)
    assert type(err.value) is type(jerr.value)
    assert str(err.value) == str(jerr.value)


def test_check_interval_warns_and_runs_live(capsys, monkeypatch):
    monkeypatch.setattr(torch_backend, "_warned_live", set())
    m, _ = pair("coo", "secded")
    b = RNG.random(m.N)
    be = create("cpu", "secded")
    live = be.solve(m, b, 500, 1e-10, verbose=False)
    lazy = be.solve(m, b, 500, 1e-10, verbose=False, check_interval=4)
    err = capsys.readouterr().err
    assert ("warning: --check-interval has no lazy schedule on the cpu "
            "route; running the live detection schedule") in err
    np.testing.assert_array_equal(live.x, lazy.x)
    assert live.iterations == lazy.iterations


def test_library_is_the_ports_own_build():
    """Built from native/abft_cg.cpp into build/native_cpu/<hash>/,
    never the JAX package's native/libabft_cg.so; the digest follows
    the source."""
    lib = cpp_backend.load_library()
    path = cpp_backend.library_path()
    assert lib._name == path and os.path.exists(path)
    assert path.startswith(os.path.join(REPO, "build", "native_cpu") + os.sep)
    assert os.path.realpath(path) != os.path.realpath(jcpp._SO_PATH)
    assert not [f for f in os.listdir(os.path.dirname(path))
                if f.endswith(".tmp")]
    assert lib.abft_num_threads() >= 1


# One process of the lock test: import, wait for the start signal, load,
# solve one system, report whether this process compiled.
_LOADER = """
import os, sys, time
sys.path.insert(0, {repo!r})
import numpy as np
from abft_sparse_cg_tpu_torch.backends import cpp_backend as c
c.BUILD_DIR = sys.argv[1]
open(sys.argv[2], "w").close()
while not os.path.exists(sys.argv[3]):
    time.sleep(0.01)
lib = c.load_library()
from abft_sparse_cg_tpu_torch.formats import assemble, build_protected
from abft_sparse_cg_tpu_torch.utils.matgen import spd_tridiagonal
r, k, v, n = spd_tridiagonal(64)
m = build_protected("csr", assemble(k, r, v, n, 1), "secded")
res = c.CppBackend("secded").solve(m, np.ones(n), 200, 1e-10, verbose=False)
print(c.build_seconds() is not None, res.iterations, res.errcode,
      lib._name)
"""


def test_concurrent_first_use_builds_once_under_the_lock(tmp_path):
    """Two processes load the library at once into an empty build
    directory: one compiles, the other waits on the lock and loads the
    whole library; both solve, and no temporary file is left."""
    code = _LOADER.format(repo=REPO)
    go = tmp_path / "go"
    procs = []
    for i in range(2):
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code, str(tmp_path / "build"),
             str(tmp_path / f"ready{i}"), str(go)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    deadline = time.time() + 120
    while not all((tmp_path / f"ready{i}").exists() for i in range(2)):
        assert time.time() < deadline and all(p.poll() is None
                                              for p in procs)
        time.sleep(0.05)
    go.touch()
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    lines = [o.split() for o, _ in outs]
    assert sorted(ln[0] for ln in lines) == ["False", "True"]
    assert lines[0][1:] == lines[1][1:]
    assert lines[0][2] == "0" and int(lines[0][1]) > 0
    built = os.path.dirname(lines[0][3])
    assert sorted(os.listdir(built)) == [".lock", "libabft_cg.so"]


def test_failed_build_raises_with_the_compilers_stderr(tmp_path,
                                                       monkeypatch):
    bad = tmp_path / "abft_cg.cpp"
    bad.write_text("int abft_cg_solve( {\n")
    monkeypatch.setattr(cpp_backend, "SOURCE", str(bad))
    monkeypatch.setattr(cpp_backend, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(cpp_backend, "_LIB", None)
    with pytest.raises(RuntimeError, match="error") as err:
        cpp_backend.load_library()
    assert "building the cpu target's library failed" in str(err.value)
    assert "abft_cg.cpp" in str(err.value)
    assert cpp_backend._LIB is None


def test_a_failing_cxx_gives_way_to_gpp(tmp_path, monkeypatch, capsys):
    """A $CXX that cannot build the library (here one that always
    fails; on some hosts a compiler without OpenMP's link spec) is named
    on stderr, and g++ builds it."""
    monkeypatch.setenv("CXX", "false")
    monkeypatch.setattr(cpp_backend, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(cpp_backend, "_LIB", None)
    assert cpp_backend._compilers() == ["false", "g++"]
    lib = cpp_backend.load_library()
    assert lib.abft_num_threads() >= 1
    err = capsys.readouterr().err
    assert "built by g++ after 1 compiler(s) failed" in err
    assert "(false -O3 -march=native -fopenmp" in err


def test_not_registered_without_a_compiler(tmp_path):
    """No compiler, no ``cpu-<mode>``: the target is registered only
    where it can be built (the other targets are unchanged)."""
    code = ("import sys; sys.path.insert(0, sys.argv[1])\n"
            "from abft_sparse_cg_tpu_torch.backends import available\n"
            "print(sorted({t for t, _ in available()}))\n")
    env = dict(os.environ, CXX=os.path.join(REPO, "no-such-compiler"),
               PATH=str(tmp_path))
    p = subprocess.run([sys.executable, "-c", code, REPO], env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    assert "'cpu'" not in p.stdout and "'torch'" in p.stdout
