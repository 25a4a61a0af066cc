"""On the card: each cell runs briefly through the harness and its
comparison holds. Skipped without a card (the ``card`` fixture decides,
never the import)."""

from __future__ import annotations

import time

import pytest

from portbench import run
from portbench.tests.conftest import cells


@pytest.mark.cuda
@pytest.mark.parametrize("cell", cells())
def test_cell_runs_correct_on_the_card(cell, card):
    out = run.run_cell(cell, 2**31 + 101, 2.0, False, card,
                       time.perf_counter())
    res = out["result"]
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["attempted"] > 0
