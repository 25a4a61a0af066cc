"""Shared pieces of the benchmark's CPU tests: the cells, their small
sizes (``TINY`` of the cell's traffic module), and a run of a cell on the
CPU (the program's plain routes), which skips only the harness's look for
a card."""

from __future__ import annotations

import time

import pytest
import torch

from portbench import run
from portbench.lib import registry

SEED = 2**31 + 977
SECONDS = 0.8
CPU = torch.device("cpu")


def cells() -> list:
    return registry.names("workloads")


def tiny(cell: str) -> dict:
    """The small sizes of ``cell``'s traffic module (``TINY``); every other
    parameter is the cell's own."""
    return registry.load_module(
        "traffic", registry.load_json("workloads", cell)["traffic"]).TINY


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
