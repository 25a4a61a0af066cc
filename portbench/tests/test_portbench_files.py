"""Every file of the benchmark loads by its name, every cell names files
that exist, and ``BENCHMARK.json`` agrees with the cells' files."""

from __future__ import annotations

import json
import re

import pytest

from portbench.lib import registry

BENCH = registry.ROOT.parent / "BENCHMARK.json"
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")


@pytest.mark.parametrize("kind", registry.KINDS)
def test_every_file_loads_by_name(kind):
    names = registry.names(kind)
    assert names, kind
    for name in names:
        assert NAME.fullmatch(name), name
        if kind in ("configs", "workloads"):
            assert registry.load_json(kind, name)["name"] == name
        else:
            registry.load_module(kind, name)


@pytest.mark.parametrize("cell", registry.names("workloads"))
def test_cell_names_existing_files(cell):
    w = registry.load_json("workloads", cell)
    registry.load_json("configs", w["config"])
    registry.load_module("traffic", w["traffic"])
    entry = registry.load_module("entries", w["entry"])
    for f in ("build", "reference", "compare"):
        assert callable(getattr(entry, f)), f
    for m in w["per_layer"]:
        assert registry.load_module("metrics", m).UNIT
    assert "setup_s" in w["end_to_end"] and len(w["end_to_end"]) >= 2
    assert w["limits"] and all(v >= 0 for v in w["limits"].values())


@pytest.mark.parametrize("name", registry.names("traffic"))
def test_every_traffic_declares_its_tiny_sizes(name):
    tiny = getattr(registry.load_module("traffic", name), "TINY", None)
    assert isinstance(tiny, dict) and tiny, \
        f"traffic/{name}.py declares no TINY"


def test_unknown_names_are_refused():
    with pytest.raises(FileNotFoundError):
        registry.load_json("workloads", "no-such-cell")
    with pytest.raises(ValueError):
        registry.path_of("metrics", "../run")


def test_benchmark_json_matches_the_files():
    b = json.loads(BENCH.read_text())
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"]
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert registry.load_json("configs", c["name"])["source"] == \
            c["source"]
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert c["reduced"] == registry.load_json("configs",
                                                  c["name"])["reduced"]
    cells = {w["name"]: w for w in b["workloads"]}
    assert set(cells) <= set(registry.names("workloads"))
    metrics = {m["name"]: m for m in b["end_to_end"] + b["per_layer"]}
    for name, w in cells.items():
        f = registry.load_json("workloads", name)
        assert (w["config"], w["traffic"], w["chips"], w["why"]) == (
            f["config"], f["traffic"], f["chips"], f["why"])
        assert w["config"] in configs and len(w["why"]) <= 200
        reported = set(f["end_to_end"]) | set(f["per_layer"])
        for m in reported:
            assert m in metrics, m
            assert name in metrics[m].get("workloads", [name]), (m, name)
        for m in b["end_to_end"] + b["per_layer"]:
            if name in m.get("workloads", []):
                assert m["name"] in reported, (m["name"], name)
    for m in b["per_layer"]:
        assert registry.load_module("metrics", m["name"]).UNIT == m["unit"]
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.fullmatch(m["name"]) and re.fullmatch(
            r"[A-Za-z0-9_/%.\-]{1,16}", m["unit"])
