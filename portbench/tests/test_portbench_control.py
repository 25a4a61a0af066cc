"""The comparison fails what it must, on the CPU at small sizes:

- the control: the reference computed in TF32 put in the program's place
  fails at least one of each cell's limits;
- the faults, planted under a whole run (only the harness's look for a
  card is skipped): those that the cell's entry declares in its
  ``FAULTS``, ``(fault, key)`` pairs: ``half_batch`` (half of the batch
  left out) and ``altered`` (an answer, the output ``key`` of a dict,
  altered where it is produced). No cell runs across chips, so no
  exchange can be left out, and no cell carries state from call to
  call."""

from __future__ import annotations

import pytest
import torch

from portbench.lib import registry
from portbench.tests.conftest import cells, run_cpu


def _limits(cell: str) -> dict:
    return registry.load_json("workloads", cell)["limits"]


def _entry(cell: str):
    return registry.load_module(
        "entries", registry.load_json("workloads", cell)["entry"])


@pytest.mark.parametrize("cell", cells())
def test_the_control_fails_the_cells_limits(cell):
    out = run_cpu(cell, control=True)
    assert out["result"]["correct"]
    ctl, lim = out["notes"]["control"], _limits(cell)
    assert any(ctl[k] > lim[k] for k in lim), (ctl, lim)


class _Broken:
    """The program's Sut with its call broken by ``fault``."""

    def __init__(self, sut, fault: str, key: str | None):
        self._sut, self._fault, self._key = sut, fault, key

    def __getattr__(self, name):
        return getattr(self._sut, name)

    def call(self, x):
        if self._fault == "half_batch":
            h = x.shape[0] // 2
            out = self._sut.call(x[:h])
            twice = lambda t: torch.cat([t, t]) if (  # noqa: E731
                t.dim() and t.shape[0] == h) else t
            return ({k: twice(v) for k, v in out.items()}
                    if isinstance(out, dict) else twice(out))
        out = self._sut.call(x)
        if isinstance(out, dict):
            return dict(out, **{self._key: _alter(out[self._key])})
        return _alter(out)


def _alter(t: torch.Tensor) -> torch.Tensor:
    t = t.clone(memory_format=torch.contiguous_format)
    flat = t.view(-1)
    i = flat.numel() // 2
    if t.dtype == torch.bool:      # the whole VAD answer
        return ~t
    elif t.dtype == torch.uint8:
        flat[i] += 9
    else:
        flat[i] += 0.25
    return t


FAULT_KINDS = ("half_batch", "altered")


def _cases():
    """``(cell, fault, key)`` for each fault that each cell's entry
    declares; an entry without ``FAULTS`` gives none here and fails
    ``test_every_entry_declares_its_faults``."""
    out = []
    for cell in cells():
        faults = getattr(_entry(cell), "FAULTS", [])
        out += [(cell, fault, key) for fault, key in faults]
    return out


@pytest.mark.parametrize("name", registry.names("entries"))
def test_every_entry_declares_its_faults(name):
    faults = getattr(registry.load_module("entries", name), "FAULTS", None)
    assert faults, f"entries/{name}.py declares no FAULTS"
    for fault, key in faults:
        assert fault in FAULT_KINDS and (key is None or isinstance(key, str))


@pytest.mark.parametrize("cell,fault,key", _cases())
def test_a_broken_program_is_not_correct(cell, fault, key, monkeypatch):
    entry = _entry(cell)
    real = entry.build
    monkeypatch.setattr(entry, "build",
                        lambda *a: _Broken(real(*a), fault, key))
    # a count such as vad_flips has a limit for the cell's own size: give
    # the broken answer enough columns to exceed it in one checked call
    res = run_cpu(cell, overrides={"clip_seconds": 4.0} if key ==
                  "vad_smoothed" else None)["result"]
    assert not res["correct"], res["checks"]
