"""A cell added as new files runs without an edit to any file that is
there: in a copy of the benchmark, a new workload file runs through the
harness in a fresh process, once with an existing traffic kind at another
batch and clip length, and once with a new traffic module of its own."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest

from portbench.lib import registry

SCRIPT = """
import json, sys, time, torch
sys.path[:0] = [sys.argv[1], sys.argv[2]]
from portbench import run
from portbench.lib import registry
assert str(registry.ROOT).startswith(sys.argv[1]), registry.ROOT
out = run.run_cell(sys.argv[3], 5, 0.5, False, torch.device("cpu"),
                   time.perf_counter())
print(json.dumps(out["result"]))
"""

# a new traffic kind: a fixed number of single-clip requests, one at a time,
# each waited for; written as a later change would add it
ONE_AT_A_TIME = '''
import time

from portbench.lib.device import sync
from portbench.lib.signals import generator, make


def prepare(sut, run):
    p = run.params
    n = int(round(p["clip_seconds"] * p["sample_rate"]))
    x = make(generator(run.seed, run.device), p["signal"], p["requests"], n,
             p["sample_rate"], run.device)
    sut.call(x[:1])
    sync(run.device)
    return {"x": x}


def drive(sut, load, run):
    x, lat, outs = load["x"], [], []
    for i in range(x.shape[0]):
        t = time.perf_counter()
        outs.append(sut.call(x[i : i + 1]))
        sync(run.device)
        lat.append(time.perf_counter() - t)
    return {"attempted": len(outs), "failed": 0,
            "metrics": {"request_max_ms": (1e3 * max(lat), "ms")},
            "inputs": [x[i : i + 1] for i in range(len(outs))],
            "outputs": outs, "notes": {}}
'''


def _same_kind(copy):
    cell = registry.load_json("workloads", "whisper-large-v3.offline-b64x30s")
    cell.update(name="whisper-large-v3.offline-b3x1s",
                params=dict(cell["params"], batch=3, clip_seconds=1.0))
    return cell, {}


def _new_kind(copy):
    cell = registry.load_json("workloads", "whisper-large-v3.offline-b64x30s")
    cell.update(name="whisper-large-v3.one-at-a-time", traffic="one_at_a_time",
                end_to_end=["setup_s", "request_max_ms"],
                params={"requests": 3, "batch": 1, "clip_seconds": 1.0,
                        "sample_rate": 16000, "trace_seconds": 0.2,
                        "signal": {"signal": "recorded",
                                   "file": "speech16k.npz",
                                   "gain_db": [-30, 0]}})
    return cell, {"traffic/one_at_a_time.py": ONE_AT_A_TIME}


@pytest.mark.parametrize("make_cell", [_same_kind, _new_kind])
def test_a_new_cell_in_new_files_runs_unedited(make_cell, tmp_path):
    copy = tmp_path / "portbench"
    shutil.copytree(registry.ROOT, copy,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(copy): p.read_bytes()
              for p in copy.rglob("*") if p.is_file()}
    cell, modules = make_cell(copy)
    added = {f"workloads/{cell['name']}.json": json.dumps(cell), **modules}
    for rel, text in added.items():
        assert not (copy / rel).exists(), rel
        (copy / rel).write_text(text)
    p = subprocess.run([sys.executable, "-c", SCRIPT, str(tmp_path),
                        str(registry.ROOT.parent), cell["name"]],
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["attempted"] >= 1, res
    assert list(res["metrics"]) == cell["end_to_end"]
    for rel, data in before.items():
        assert (copy / rel).read_bytes() == data, rel
