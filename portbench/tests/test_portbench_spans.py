"""The span readers: the program's records whose host start lies in the
traced window, grouped by call, give each stage's mean device ms a call;
a record without a device time (the CPU's) gives nothing."""

from __future__ import annotations

import types

import pytest

from portbench.lib import registry, spans

STAGES = {"step_spectral_ms": ("frontend_step.spectral",),
          "step_nemo_ms": ("frontend_step.nemo",),
          "step_vad_quant_ms": ("frontend_step.vad", "frontend_step.quant")}


def _rec(name, call, start_ns, device_ms):
    return types.SimpleNamespace(name=name, call=call, start_ns=start_ns,
                                 device_ms=device_ms)


def _calls(device: bool) -> list:
    """Three calls of the step, the first before the window; device ms of
    stage i in call c: c + i / 10."""
    out = [_rec("setup.heads", 1, 5, None)]
    for c in (1, 2, 3):
        t0 = 100 * c
        out.append(_rec("frontend_step", c, t0, 10.0 * c if device else None))
        for i, s in enumerate(("spectral", "nemo", "vad", "quant")):
            out.append(_rec(f"frontend_step.{s}", c, t0 + i + 1,
                            c + i / 10 if device else None))
    return out


@pytest.fixture
def records(monkeypatch):
    from melspec_tpu_torch.utils import profiling

    def use(recs):
        monkeypatch.setattr(profiling, "records", lambda: recs)
    return use


VIEW = types.SimpleNamespace(window=(150, 400))


def test_calls_keeps_the_windows_records_by_call(records):
    records(_calls(True))
    got = spans.calls(VIEW)
    assert sorted(got) == [2, 3]
    assert all(len(v) == 5 for v in got.values())


@pytest.mark.parametrize("metric", sorted(STAGES))
def test_stage_metrics_read_the_mean_a_call(metric, records):
    records(_calls(True))
    # calls 2 and 3: stage i reads c + i / 10, summed over the metric's
    # stages within a call
    idx = [("spectral", "nemo", "vad", "quant").index(n.split(".")[1])
           for n in STAGES[metric]]
    want = sum(sum(c + i / 10 for i in idx) for c in (2, 3)) / 2
    got = registry.load_module("metrics", metric).read(VIEW)
    assert got == pytest.approx(want)


@pytest.mark.parametrize("metric", sorted(STAGES))
def test_stage_metrics_are_silent_without_device_times(metric, records):
    records(_calls(False))
    assert registry.load_module("metrics", metric).read(VIEW) is None
    records([])
    assert registry.load_module("metrics", metric).read(VIEW) is None


def test_nothing_where_the_program_keeps_no_records(monkeypatch):
    from melspec_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "records")
    assert spans.calls(VIEW) == {}
