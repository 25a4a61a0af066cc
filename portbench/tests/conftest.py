"""Shared pieces of the benchmark's CPU tests: the cells, small sizes for
each traffic kind, and a run of a cell on the CPU (the program's plain
routes), which skips only the harness's look for a card."""

from __future__ import annotations

import time

import pytest
import torch

from portbench import run
from portbench.lib import registry

# small sizes by traffic kind; every other parameter is the cell's own
TINY = {
    "offline_batches": {"batch": 2, "clip_seconds": 1.0,
                        "trace_seconds": 0.2},
}
SEED = 2**31 + 977
SECONDS = 0.8
CPU = torch.device("cpu")


def cells() -> list:
    return registry.names("workloads")


def tiny(cell: str) -> dict:
    return TINY[registry.load_json("workloads", cell)["traffic"]]


def run_cpu(cell: str, trace: bool = False, control: bool = False,
            seed: int = SEED, seconds: float = SECONDS,
            overrides: dict | None = None) -> dict:
    return run.run_cell(cell, seed, seconds, trace, CPU, time.perf_counter(),
                        {**tiny(cell), **(overrides or {})}, control=control)


@pytest.fixture
def card():
    """The CUDA device, or a skip where this host has none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
