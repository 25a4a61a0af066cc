"""ctypes binding for the native single-producer / single-consumer sample
ring (port of ``melspec_tpu.runtime.ringbuffer``), with a pure-Python
fallback where no C++ compiler is available.

The port keeps its own copy of the C++ source (``native/ringbuffer.cpp``).
At first use it compiles with ``g++ -O3 -std=c++17 -fPIC -Wall -Wextra
-shared`` into ``melspec_tpu_torch/_build/libmelspec_rb-<digest>.so``,
where ``<digest>`` hashes the source and the flags (as the CUDA kernels
are named, ``kernels/build.py``), so an edited source rebuilds and an
unchanged one is reused. Nothing is built at import time and nothing is
written beside the source. ``native_available()`` says which backend a
new ``SampleRing`` gets.

API: push (drop-newest), push_overwrite (overwrite-oldest with dropped
accounting), pop, pop_exact, and ``pop_many`` across a fleet of rings.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from collections import deque
from pathlib import Path
from typing import Optional

import numpy as np

from melspec_tpu_torch.kernels.build import BUILD_DIR

_SRC = Path(__file__).parent / "native" / "ringbuffer.cpp"
# the flags of the reference's runtime/native/Makefile
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared")
_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_failed = False


def library_path() -> Path:
    """Where the native ring's library is (or will be) built."""
    digest = hashlib.sha256(
        _SRC.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libmelspec_rb-{digest}.so"


def _build(so: Path) -> None:
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(_SRC)],
                   check=True, capture_output=True, timeout=120)
    os.replace(tmp, so)


def _load_library() -> Optional[ctypes.CDLL]:
    global _lib, _lib_failed
    with _lib_lock:
        if _lib is not None or _lib_failed:
            return _lib
        try:
            so = library_path()
            if not so.is_file():
                _build(so)
            lib = ctypes.CDLL(str(so))
            lib.msrb_create.restype = ctypes.c_void_p
            lib.msrb_create.argtypes = [ctypes.c_uint64]
            lib.msrb_destroy.argtypes = [ctypes.c_void_p]
            for name in ("msrb_capacity", "msrb_len", "msrb_dropped"):
                fn = getattr(lib, name)
                fn.restype = ctypes.c_uint64
                fn.argtypes = [ctypes.c_void_p]
            for name in ("msrb_push", "msrb_push_overwrite", "msrb_pop",
                         "msrb_pop_exact"):
                fn = getattr(lib, name)
                fn.restype = ctypes.c_uint64
                fn.argtypes = [
                    ctypes.c_void_p,
                    ctypes.POINTER(ctypes.c_float),
                    ctypes.c_uint64,
                ]
            lib.msrb_pop_many.restype = ctypes.c_uint64
            lib.msrb_pop_many.argtypes = [
                ctypes.POINTER(ctypes.c_void_p),
                ctypes.c_uint64,
                ctypes.c_uint64,
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_uint8),
            ]
        except (OSError, subprocess.SubprocessError):
            # no compiler (FileNotFoundError), a failed build or load: the
            # rings fall back to Python
            _lib_failed = True
            return None
        _lib = lib
        return _lib


def native_available() -> bool:
    """Whether a new ``SampleRing`` is backed by the native library
    (building it on the first call)."""
    return _load_library() is not None


class SampleRing:
    """Bounded float32 sample queue; capacity rounded up to a power of
    two. Thread-safe for one producer and one consumer (native), or under
    a lock (Python)."""

    def __init__(self, capacity: int, force_python: bool = False):
        self._lib = None if force_python else _load_library()
        if self._lib is not None:
            self._handle = self._lib.msrb_create(capacity)
            if not self._handle:
                raise MemoryError("failed to allocate native ring")
            self._capacity = int(self._lib.msrb_capacity(self._handle))
        else:
            self._capacity = max(2, 1 << (capacity - 1).bit_length())
            self._deque: "deque[float]" = deque()
            self._py_lock = threading.Lock()
            self._py_dropped = 0

    @property
    def native(self) -> bool:
        return self._lib is not None

    @property
    def capacity(self) -> int:
        return self._capacity

    def __len__(self) -> int:
        if self._lib is not None:
            return int(self._lib.msrb_len(self._handle))
        with self._py_lock:
            return len(self._deque)

    @property
    def dropped(self) -> int:
        if self._lib is not None:
            return int(self._lib.msrb_dropped(self._handle))
        with self._py_lock:
            return self._py_dropped

    def push(self, samples: np.ndarray) -> int:
        """Append samples, rejecting the excess when full; returns the
        number accepted (the caller may retry the rest)."""
        samples = np.ascontiguousarray(samples, dtype=np.float32)
        if self._lib is not None:
            ptr = samples.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
            return int(self._lib.msrb_push(self._handle, ptr, samples.size))
        with self._py_lock:
            take = min(self._capacity - len(self._deque), samples.size)
            self._deque.extend(samples[:take].tolist())
            return take

    def push_overwrite(self, samples: np.ndarray) -> int:
        """Append samples, overwriting the oldest when full; returns the
        number of samples dropped."""
        samples = np.ascontiguousarray(samples, dtype=np.float32)
        if self._lib is not None:
            ptr = samples.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
            return int(
                self._lib.msrb_push_overwrite(self._handle, ptr, samples.size))
        with self._py_lock:
            dropped = 0
            overflow = len(self._deque) + samples.size - self._capacity
            if overflow > 0:
                for _ in range(min(overflow, len(self._deque))):
                    self._deque.popleft()
                    dropped += 1
            if samples.size > self._capacity:
                dropped += samples.size - self._capacity
                samples = samples[-self._capacity:]
            self._deque.extend(samples.tolist())
            self._py_dropped += dropped
            return dropped

    def pop(self, n: int) -> np.ndarray:
        """Read up to ``n`` samples; returns what was available."""
        if self._lib is not None:
            out = np.empty(n, dtype=np.float32)
            ptr = out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
            got = int(self._lib.msrb_pop(self._handle, ptr, n))
            return out[:got]
        with self._py_lock:
            take = min(n, len(self._deque))
            return np.asarray([self._deque.popleft() for _ in range(take)],
                              dtype=np.float32)

    def pop_exact(self, out: np.ndarray) -> bool:
        """Pop exactly ``out.size`` samples into ``out`` (float32,
        C-contiguous), or nothing; returns whether the pop happened."""
        if out.dtype != np.float32 or not out.flags.c_contiguous:
            raise ValueError("out must be C-contiguous float32")
        if self._lib is not None:
            ptr = out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
            return bool(self._lib.msrb_pop_exact(self._handle, ptr,
                                                 out.size))
        with self._py_lock:
            if len(self._deque) < out.size:
                return False
            out[:] = [self._deque.popleft() for _ in range(out.size)]
            return True

    def __del__(self):
        lib = getattr(self, "_lib", None)
        handle = getattr(self, "_handle", None)
        if lib is not None and handle:
            lib.msrb_destroy(handle)


def pop_many(rings: "list[Optional[SampleRing]]", need: int,
             out: np.ndarray) -> np.ndarray:
    """Batched all-or-nothing drain across a fleet: for each non-None
    ``rings[j]`` pop exactly ``need`` samples into ``out[j]`` (the row is
    left untouched otherwise). Returns ``ok [n] bool``, as the JAX
    package's ``pop_many`` does; ``out`` must be C-contiguous float32
    ``[len(rings), need]`` (``ValueError`` otherwise).

    One native call per tick when every ring is native; mixed, None and
    Python rings take the per-entry path."""
    n = len(rings)
    if (out.dtype != np.float32 or not out.flags.c_contiguous
            or out.shape != (n, need)):
        raise ValueError(f"out must be C-contiguous float32 [{n}, {need}]")
    lib = _load_library()
    if lib is not None and all(r is None or r.native for r in rings):
        handles = (ctypes.c_void_p * n)(
            *[r._handle if r is not None else None for r in rings])
        ok = np.zeros(n, dtype=np.uint8)
        lib.msrb_pop_many(
            handles, n, need,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ok.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        return ok.astype(bool)
    ok = np.zeros(n, dtype=bool)
    for j, r in enumerate(rings):
        if r is not None:
            ok[j] = r.pop_exact(out[j])
    return ok
