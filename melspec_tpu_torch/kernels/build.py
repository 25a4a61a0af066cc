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

import contextlib
import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Sequence, Tuple

from melspec_tpu_torch.utils import profiling

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


def _nvcc(src: Path, out: Path) -> subprocess.Popen:
    return subprocess.Popen([find_nvcc(), *NVCC_FLAGS, "-o", str(out),
                             str(src)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(proc: subprocess.Popen, what: str) -> str:
    """Wait for an ``nvcc``; its report, or ``RuntimeError``."""
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {what} "
                           f"(exit {proc.returncode}):\n{out}")
    return out


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
    if todo:
        with profiling.span("setup.library", library=",".join(todo)) as sp:
            sp.set(built=_build_and_load(todo))
    return {n: _loaded[n] for n in names}


def _build_and_load(todo: list) -> bool:
    """Build the libraries of ``todo`` that are not built yet, then load
    each; whether ``nvcc`` ran."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        so = _target(name)
        if so.is_file():
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (_nvcc(CSRC_DIR / f"{name}.cu", tmp), tmp, so)
    logs = {}
    for name, (proc, tmp, so) in procs.items():
        logs[name] = _finish(proc, f"csrc/{name}.cu")
        os.replace(tmp, so)
    for name in todo:
        _loaded[name] = Built(ctypes.CDLL(str(_target(name))),
                              logs.get(name, ""))
    return bool(procs)


def load(name: str) -> Built:
    """Build ``csrc/<name>.cu`` if needed and load it."""
    return load_all([name])[name]


Edit = Tuple[str, str]


def edited(path: Path, edits: Sequence[Edit], what: str,
           text: str | None = None) -> str:
    """``path``'s text (or ``text``) with each ``(old, new)`` edit made in
    turn; raises ``ValueError`` unless each ``old`` occurs exactly once,
    so an edit of the device code that moves one fails loudly."""
    text = path.read_text() if text is None else text
    for old, new in edits:
        if text.count(old) != 1:
            raise ValueError(f"{what} matches {text.count(old)} places of "
                             f"{path.name}")
        text = text.replace(old, new)
    return text


def build_variants(probe: str, name: str,
                   variants: Dict[str, Dict[str, str]]) -> Dict[str, Path]:
    """Time probes: ``csrc/<name>.cu`` built once per variant (in
    parallel) under ``BUILD_DIR/<probe>/<variant>``, each from a copy of
    ``csrc/`` whose files ``variants[variant]`` (file name -> text)
    replaces. Returns each variant's library."""
    procs = {}
    for var, files in variants.items():
        d = BUILD_DIR / probe / var
        d.mkdir(parents=True, exist_ok=True)
        for src in [CSRC_DIR / f"{name}.cu", *CSRC_DIR.glob("*.cuh")]:
            (d / src.name).write_text(files.get(src.name, src.read_text()))
        so = d / f"lib{name}.so"
        procs[var] = (_nvcc(d / f"{name}.cu", so), so)
    for var, (proc, so) in procs.items():
        _finish(proc, f"variant {var} of csrc/{name}.cu")
    return {var: so for var, (_, so) in procs.items()}


@contextlib.contextmanager
def bound_to(module, so: Path, functions: Iterable[str]):
    """Within the block, ``module._bound()`` returns the library ``so``,
    its ``functions`` typed as the module's own library types them."""
    real = module._bound
    lib = ctypes.CDLL(str(so))
    for fn in functions:
        getattr(lib, fn).argtypes = getattr(real(), fn).argtypes
        getattr(lib, fn).restype = getattr(real(), fn).restype
    module._bound = lambda: lib
    try:
        yield lib
    finally:
        module._bound = real
