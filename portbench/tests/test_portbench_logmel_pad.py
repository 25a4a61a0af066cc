"""``logmel_pad_ms`` reads the program's ``logmel.pad`` stage: the mean
device ms a call over the traced window's calls; nothing where the
program records no such stage (a program without the span, or the CPU,
whose records carry no device time)."""

from __future__ import annotations

import types

import pytest

from portbench.lib import registry

VIEW = types.SimpleNamespace(window=(150, 400))


def _rec(name, call, start_ns, device_ms):
    return types.SimpleNamespace(name=name, call=call, start_ns=start_ns,
                                 device_ms=device_ms)


def _calls(device: bool, stages=("pad", "spectral")) -> list:
    """Three calls of ``BatchLogMel.compute``, the first before the
    window; device ms of stage i in call c: c + i / 10."""
    out = [_rec("setup.heads", 1, 5, None)]
    for c in (1, 2, 3):
        t0 = 100 * c
        out.append(_rec("logmel", c, t0, 10.0 * c if device else None))
        for i, s in enumerate(stages):
            out.append(_rec(f"logmel.{s}", c, t0 + i + 1,
                            c + i / 10 if device else None))
    return out


@pytest.fixture
def read(monkeypatch):
    from melspec_tpu_torch.utils import profiling

    reader = registry.load_module("metrics", "logmel_pad_ms")

    def with_records(recs):
        monkeypatch.setattr(profiling, "records", lambda: recs)
        return reader.read(VIEW)
    return with_records


def test_reads_the_pad_stages_mean_a_call(read):
    # calls 2 and 3 lie in the window: the pad, stage 0, reads c
    assert read(_calls(True)) == pytest.approx((2.0 + 3.0) / 2)


@pytest.mark.parametrize("recs", [
    pytest.param(_calls(False), id="no-device-time"),
    pytest.param(_calls(True, stages=("spectral",)), id="no-pad-stage"),
    pytest.param([], id="no-records"),
])
def test_is_null_without_the_stage(read, recs):
    assert read(recs) is None


def test_is_null_where_the_program_keeps_no_records(monkeypatch):
    from melspec_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "records")
    assert registry.load_module("metrics", "logmel_pad_ms").read(VIEW) is None
