"""The result line holds the contract's keys and no other, with the
comparison's numbers last; without a card the benchmark exits without a
result."""

from __future__ import annotations

import json
import math
import subprocess
import sys

import pytest
import torch

from portbench.lib import registry
from portbench.tests.conftest import cells, run_cpu

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]
DEVICE = {"platform", "kind", "count", "memory_peak_bytes"}


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", cells())
def test_result_line_holds_only_the_contracts_keys(cell, trace):
    w = registry.load_json("workloads", cell)
    res = run_cpu(cell, trace=trace)["result"]
    line = json.loads(json.dumps(res))
    want = KEYS[:-1] + ["breakdown", "checks"] if trace else KEYS
    assert list(line) == want
    assert set(line["device"]) == DEVICE | ({"busy_s", "window_s"}
                                            if trace else set())
    assert set(line["checks"]) == set(w["limits"])
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    if trace:
        # a CPU run has no device operations: every reader stays silent
        assert line["metrics"] == {}
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert list(line["metrics"]) == w["end_to_end"]
        for m in line["metrics"].values():
            assert set(m) == {"value", "unit"} and m["value"] > 0
            assert math.isfinite(m["value"])


def test_without_a_card_there_is_no_result():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    cell = cells()[0]
    p = subprocess.run([sys.executable, str(registry.ROOT / "run.py"),
                        "--workload", cell, "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 2 and p.stdout == ""
