"""The port's sample ring (``runtime/ringbuffer.py`` over its own copy of
``native/ringbuffer.cpp``) on both backends: every case of
``tests/test_runtime_ring.py``, one operation sequence replayed through
the JAX package's ring and the port's with equal outputs and dropped
counts, and the native library's build into ``melspec_tpu_torch/_build/``
with nothing of ``melspec_tpu/`` built, loaded or changed. The native cases
skip where ``g++`` is missing."""

import hashlib
import json
import re
import shutil
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

from melspec_tpu.runtime import ringbuffer as jring
from melspec_tpu_torch.runtime import ringbuffer
from melspec_tpu_torch.runtime.ringbuffer import (SampleRing,
                                                  native_available, pop_many)

ROOT = Path(__file__).resolve().parents[1]
NO_GXX = "g++ not found: the native ring cannot be built on this host"


def _need_native():
    if shutil.which("g++") is None:
        pytest.skip(NO_GXX)
    assert native_available(), "g++ is present but the native ring failed"


@pytest.fixture(params=["native", "python"])
def backend(request):
    if request.param == "native":
        _need_native()
    return request.param


@pytest.fixture
def ring_cls(backend):
    return lambda cap: SampleRing(cap, force_python=backend == "python")


def test_backend_is_the_one_asked_for(ring_cls, backend):
    assert ring_cls(8).native == (backend == "native")


def test_fifo_order(ring_cls):
    ring = ring_cls(64)
    ring.push(np.arange(10, dtype=np.float32))
    np.testing.assert_array_equal(ring.pop(10),
                                  np.arange(10, dtype=np.float32))


def test_pop_empty(ring_cls):
    assert ring_cls(16).pop(4).size == 0


def test_wrap_around(ring_cls):
    ring = ring_cls(16)
    for rep in range(10):
        data = np.arange(rep * 7, rep * 7 + 7, dtype=np.float32)
        assert ring.push(data) == 7
        np.testing.assert_array_equal(ring.pop(7), data)


def test_push_rejects_when_full(ring_cls):
    ring = ring_cls(8)
    assert ring.push(np.arange(12, dtype=np.float32)) == ring.capacity
    assert ring.dropped == 0  # rejected, not destroyed
    np.testing.assert_array_equal(
        ring.pop(8), np.arange(ring.capacity, dtype=np.float32))


def test_push_overwrite_oldest(ring_cls):
    ring = ring_cls(8)
    ring.push(np.arange(8, dtype=np.float32))
    assert ring.push_overwrite(np.array([100.0, 101.0], np.float32)) == 2
    np.testing.assert_array_equal(
        ring.pop(8), np.array([2, 3, 4, 5, 6, 7, 100, 101], np.float32))


def test_overwrite_larger_than_capacity(ring_cls):
    ring = ring_cls(8)
    data = np.arange(20, dtype=np.float32)
    assert ring.push_overwrite(data) == 12
    np.testing.assert_array_equal(ring.pop(8), data[-8:])
    assert ring.dropped == 12


def test_len_and_capacity(ring_cls):
    ring = ring_cls(100)  # rounds to 128
    assert ring.capacity == 128
    ring.push(np.zeros(30, dtype=np.float32))
    assert len(ring) == 30
    ring.pop(10)
    assert len(ring) == 20


def test_pop_exact_all_or_nothing(ring_cls):
    r = ring_cls(64)
    r.push(np.arange(10, dtype=np.float32))
    assert not r.pop_exact(np.zeros(16, dtype=np.float32))
    assert len(r) == 10
    out8 = np.zeros(8, dtype=np.float32)
    assert r.pop_exact(out8)
    np.testing.assert_array_equal(out8, np.arange(8, dtype=np.float32))
    assert len(r) == 2
    with pytest.raises(ValueError, match="float32"):
        r.pop_exact(np.zeros(2, dtype=np.float64))


def test_pop_many_batched_drain(ring_cls):
    """One call drains every ready ring into its row; short rings and None
    slots leave their rows untouched. Returns ``ok [n] bool`` (JAX's
    contract)."""
    need = 12
    rings = [ring_cls(64), None, ring_cls(64), ring_cls(64)]
    rings[0].push(np.arange(need, dtype=np.float32))
    rings[2].push(np.arange(5, dtype=np.float32))  # too short
    rings[3].push(np.arange(100, 100 + need + 3, dtype=np.float32))
    out = np.full((4, need), -1.0, dtype=np.float32)
    ok = pop_many(rings, need, out)
    assert isinstance(ok, np.ndarray) and ok.dtype == bool
    assert ok.tolist() == [True, False, False, True]
    np.testing.assert_array_equal(out[0], np.arange(need, dtype=np.float32))
    np.testing.assert_array_equal(out[1], -np.ones(need, np.float32))
    np.testing.assert_array_equal(out[2], -np.ones(need, np.float32))
    np.testing.assert_array_equal(
        out[3], np.arange(100, 100 + need, dtype=np.float32))
    assert len(rings[2]) == 5 and len(rings[3]) == 3
    with pytest.raises(ValueError, match="C-contiguous"):
        pop_many(rings, need, np.zeros((4, need + 1), np.float32))


def test_pop_many_allocates_rows():
    """``pop_many`` no longer allocates its rows: ``out`` is required, as
    in the JAX package's signature, so a call without it raises
    ``TypeError`` and consumes nothing."""
    rings = [SampleRing(32, force_python=True), None]
    rings[0].push(np.arange(6, dtype=np.float32))
    with pytest.raises(TypeError):
        pop_many(rings, 6)
    with pytest.raises(TypeError):
        jring.pop_many(rings, 6)
    assert len(rings[0]) == 6


def test_pop_many_mixed_backends():
    _need_native()
    need = 6
    rings = [SampleRing(32), SampleRing(32, force_python=True)]
    for r in rings:
        r.push(np.arange(need, dtype=np.float32))
    out = np.zeros((2, need), dtype=np.float32)
    ok = pop_many(rings, need, out)
    assert ok.tolist() == [True, True]
    np.testing.assert_array_equal(out[0], out[1])


def _serve_drain(ring_mod, rings, need):
    """The serving tick's drain as ``examples/serve_streams.py`` writes it:
    ``ok = pop_many(rings, need, chunks)`` then ``ok[i]`` per slot."""
    chunks = np.zeros((len(rings), need), dtype=np.float32)
    ok = ring_mod.pop_many(rings, need, chunks)
    kept = [i for i, r in enumerate(rings) if r is not None and ok[i]]
    evicted = [i for i, r in enumerate(rings) if r is not None and not ok[i]]
    return np.asarray(ok).tolist(), kept, evicted, chunks.tolist()


@pytest.mark.parametrize("layout", ["python", "native", "mixed"])
def test_pop_many_drives_like_the_serving_tick(layout):
    """``ok[i]`` after ``ok = pop_many(rings, need, chunks)`` is each slot's
    flag, equal to JAX's on the same sequence, over Python rings, native
    rings (or a mix) and a ``None`` slot."""
    if layout != "python":
        _need_native()
        if not jring.native_available():
            pytest.skip("the JAX package's native ring is unavailable")

    def fleet(ring_mod):
        py = {"python": [True] * 3, "native": [False] * 3,
              "mixed": [False, True, False]}[layout]
        rings = [ring_mod.SampleRing(64, force_python=py[0]), None,
                 ring_mod.SampleRing(64, force_python=py[1]),
                 ring_mod.SampleRing(64, force_python=py[2])]
        log = []
        for step, fill in enumerate([(8, 3, 9), (0, 8, 7), (16, 1, 1)]):
            for r, n in zip([rings[0], rings[2], rings[3]], fill):
                r.push(np.arange(n, dtype=np.float32) + 100 * step)
            log.append(_serve_drain(ring_mod, rings, 8))
        return log

    got, want = fleet(ringbuffer), fleet(jring)
    assert got == want
    assert list(got[0][:3]) == [[True, False, False, True], [0, 3], [2]]


def test_concurrent_producer_consumer():
    """One producer thread and one consumer thread on the native ring:
    every sample accounted for, order preserved."""
    _need_native()
    ring = SampleRing(1 << 12)
    total = 200_000
    received = []

    def producer():
        sent = 0
        while sent < total:
            chunk = np.arange(sent, min(sent + 128, total), dtype=np.float32)
            sent += ring.push(chunk)

    def consumer():
        got = 0
        while got < total:
            out = ring.pop(256)
            if out.size:
                received.append(out)
                got += out.size

    threads = [threading.Thread(target=producer),
               threading.Thread(target=consumer)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    stream = np.concatenate(received)
    assert stream.size == total
    np.testing.assert_array_equal(stream, np.arange(total, dtype=np.float32))


def _replay(ring_mod, force_python: bool, pop_many_fn):
    """One seeded sequence of every operation; returns what it observed."""
    rng = np.random.default_rng(11)
    rings = [ring_mod.SampleRing(cap, force_python=force_python)
             for cap in (100, 64, 7)]
    log = [r.capacity for r in rings]
    base = 0.0
    for step in range(300):
        r = rings[step % 3]
        op = rng.integers(0, 5)
        n = int(rng.integers(0, 150))
        data = (base + np.arange(n)).astype(np.float32)
        base += n
        if op == 0:
            log.append(("push", r.push(data)))
        elif op == 1:
            log.append(("push_overwrite", r.push_overwrite(data)))
        elif op == 2:
            log.append(("pop", r.pop(n).tolist()))
        elif op == 3:
            out = np.zeros(n, dtype=np.float32)
            log.append(("pop_exact", r.pop_exact(out), out.tolist()))
        else:
            need = int(rng.integers(1, 40))
            out = np.full((4, need), -1.0, dtype=np.float32)
            ok = pop_many_fn([rings[0], None, rings[1], rings[2]], need, out)
            log.append(("pop_many", np.asarray(ok).tolist(), out.tolist()))
        log.append(("len", [len(x) for x in rings],
                    [x.dropped for x in rings]))
    return log


def test_sequence_equals_jax_ring(backend):
    """The same push / push_overwrite / pop / pop_exact / pop_many sequence
    through JAX's ring and the port's: equal outputs and dropped counts."""
    python = backend == "python"
    if not python and not jring.native_available():
        pytest.skip("the JAX package's native ring is unavailable")

    assert _replay(ringbuffer, python, pop_many) == \
        _replay(jring, python, jring.pop_many)


def _tree_digest(root: Path) -> str:
    h = hashlib.sha256()
    for p in sorted(root.rglob("*")):
        if p.is_file() and "__pycache__" not in p.parts and p.suffix != ".so":
            h.update(str(p.relative_to(root)).encode() + p.read_bytes())
    return h.hexdigest()


def test_native_library_builds_into_port_build_dir():
    """The library is the port's own build under ``melspec_tpu_torch/_build``
    (named by the digest of its source and flags); no ``melspec_tpu``
    module, library or file is imported, mapped or changed."""
    _need_native()
    code = (
        "import json, subprocess, sys\n"
        "calls = []\n"
        "run = subprocess.run\n"
        "def rec(args, *a, **k):\n"
        "    calls.append([list(map(str, args)), str(k.get('cwd'))])\n"
        "    return run(args, *a, **k)\n"
        "subprocess.run = rec\n"
        "import numpy as np\n"
        "from melspec_tpu_torch.runtime import ringbuffer as rb\n"
        "r = rb.SampleRing(64)\n"
        "r.push(np.arange(8)); assert r.pop(8).size == 8 and r.native\n"
        "maps = [ln.split()[-1] for ln in open('/proc/self/maps')\n"
        "        if 'melspec' in ln]\n"
        "mods = [m for m in sys.modules if m.split('.')[0] == 'melspec_tpu']\n"
        "print(json.dumps(dict(path=str(rb.library_path()), maps=maps,\n"
        "                      calls=calls, mods=mods)))\n"
    )
    jax_pkg = ROOT / "melspec_tpu"
    before = _tree_digest(jax_pkg)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    info = json.loads(res.stdout.strip().splitlines()[-1])
    path = Path(info["path"])
    assert path.parent == ROOT / "melspec_tpu_torch" / "_build"
    assert re.fullmatch(r"libmelspec_rb-[0-9a-f]{16}\.so", path.name)
    assert path.is_file() and str(path) in info["maps"]
    assert not [m for m in info["maps"] if "/melspec_tpu/" in m]
    assert info["mods"] == []
    for args, cwd in info["calls"]:  # a build, where one ran
        assert args[0] == "g++" and cwd == "None"
        assert Path(args[args.index("-o") + 1]).parent == path.parent
        assert not [a for a in args if "/melspec_tpu/" in a]
    assert _tree_digest(jax_pkg) == before
