"""Find a cell's files by name: ``configs/<name>.json``,
``workloads/<name>.json`` and the modules ``traffic/<name>.py``,
``entries/<name>.py``, ``metrics/<name>.py`` and ``roofline/<name>.py``.
A name may hold dots (``device_idle_pct.offline``), so modules are loaded
from their path, not imported by name."""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType

ROOT = Path(__file__).resolve().parents[1]
KINDS = ("configs", "workloads", "traffic", "entries", "metrics",
         "roofline")
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")


def path_of(kind: str, name: str, root: Path = ROOT) -> Path:
    if kind not in KINDS:
        raise ValueError(f"no kind {kind!r}")
    if not NAME.fullmatch(name):
        raise ValueError(f"not a name: {name!r}")
    suffix = ".json" if kind in ("configs", "workloads") else ".py"
    path = root / kind / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"{kind}/{name}{suffix} does not exist")
    return path


def names(kind: str, root: Path = ROOT) -> list:
    suffix = ".json" if kind in ("configs", "workloads") else ".py"
    return sorted(p.name[: -len(suffix)]
                  for p in (root / kind).glob(f"*{suffix}")
                  if not p.name.startswith("_"))


def load_json(kind: str, name: str, root: Path = ROOT) -> dict:
    return json.loads(path_of(kind, name, root).read_text())


def load_module(kind: str, name: str, root: Path = ROOT) -> ModuleType:
    """The module ``<kind>/<name>.py``, loaded once a process under the
    name ``portbench_<kind>_<name>`` (dots and dashes as ``_``)."""
    path = path_of(kind, name, root)
    mod_name = "portbench_" + re.sub(r"[^A-Za-z0-9_]", "_", f"{kind}_{name}")
    mod = sys.modules.get(mod_name)
    if mod is not None and Path(mod.__file__) == path:
        return mod
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod
