"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into
``melspec_tpu_torch/_build/lib<name>-<digest>.so`` (a plain C interface,
bound with ``ctypes``), where ``<digest>`` hashes the source, the shared
``csrc/*.cuh`` headers and the flags, so an edited source rebuilds and an
unchanged one is reused. Nothing is
built at import time: the first launch of a kernel builds it. A failed
build raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclasses.dataclass(frozen=True)
class Built:
    """A loaded kernel library: the ``ctypes`` handle and the compiler's
    report (``-Xptxas -v``: registers, shared memory, spills; empty when
    an earlier build was reused)."""

    lib: ctypes.CDLL
    log: str


_loaded: Dict[str, Built] = {}


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else
    ``/usr/local/cuda/bin/nvcc``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(name: str) -> Path:
    # the digest covers the source, every shared header of csrc/ and the
    # flags: an edited header rebuilds the kernels that include it
    parts = [(CSRC_DIR / f"{name}.cu").read_bytes()]
    parts += [h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh"))]
    digest = hashlib.sha256(
        b"".join(parts) + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def load_all(names: Iterable[str]) -> Dict[str, Built]:
    """Build (in parallel: one ``nvcc`` per source, all started together)
    whatever is not built yet, then load every library."""
    names = list(dict.fromkeys(names))
    todo = [n for n in names if n not in _loaded]
    procs = {}
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for name in todo:
        so = _target(name)
        if so.is_file():
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, so)
    logs = {}
    for name, (proc, tmp, so) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                               f"(exit {proc.returncode}):\n{out}")
        os.replace(tmp, so)
        logs[name] = out
    for name in todo:
        _loaded[name] = Built(ctypes.CDLL(str(_target(name))),
                              logs.get(name, ""))
    return {n: _loaded[n] for n in names}


def load(name: str) -> Built:
    """Build ``csrc/<name>.cu`` if needed and load it."""
    return load_all([name])[name]
