"""The span of ``ops/batch_logmel.py::BatchLogMel.compute`` on the CPU:
traced, a call is the span ``logmel`` with its stages ``logmel.pad`` and
``logmel.spectral`` on every route, the call's K1 launches and those of a
magnitude head in its attrs; off, nothing is recorded; the frontend step,
which calls ``BatchLogMel._compute`` inside its own stage, records no span
of it and keeps its records' names and parents; and ``profiling.counters``
reads K1's magnitude launches."""

import numpy as np
import pytest
import torch

from melspec_tpu_torch.config import BatchLogMelConfig, DetectionSettings
from melspec_tpu_torch.kernels import sig_mel as k1
from melspec_tpu_torch.ops import batch_logmel
from melspec_tpu_torch.parallel.sharding import sharded_frontend_step
from melspec_tpu_torch.utils import profiling

CPU = torch.device("cpu")
TTS = BatchLogMelConfig(sample_rate=22050, n_fft=1024, win_length=1024,
                        hop_length=256, f_max=8000.0, center=False,
                        log_zero_guard=1e-5, pad_to=1, mag_power=1.0,
                        log_zero_guard_type="clamp", exact_pad=True)
CONFIGS = {"tts": TTS, "defaults": BatchLogMelConfig()}
STAGES = ["logmel.pad", "logmel.spectral"]
STEP = ["frontend_step", "frontend_step.spectral", "frontend_step.nemo",
        "frontend_step.vad", "frontend_step.quant"]


@pytest.fixture(autouse=True)
def fresh():
    """Each test starts with tracing off and no records."""
    profiling.disable()
    profiling.clear()
    yield
    profiling.disable()
    profiling.clear()


def _x() -> torch.Tensor:
    return torch.as_tensor(np.random.default_rng(0).normal(
        size=(2, 8000)).astype(np.float32) * 0.1)


def _ours(recs) -> list:
    return [r for r in recs if r.name == "logmel" or
            r.name.startswith("logmel.")]


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("impl", ["sig", "rdft", "fft", "hp"])
def test_a_call_is_the_span_and_its_stages(impl, config):
    f = batch_logmel.BatchLogMel(CONFIGS[config], fft_impl=impl, device=CPU)
    x = _x()
    want = f.compute(x)
    profiling.enable()
    got = f.compute(x)
    profiling.disable()
    assert torch.equal(got, want)
    recs = _ours(profiling.records())
    assert [r.name for r in recs] == ["logmel", *STAGES]
    top = recs[0]
    assert top.parent is None and top.call == top.id
    assert all(r.parent == top.id and r.call == top.id for r in recs[1:])
    assert recs[1].end_ns <= recs[2].start_ns
    assert top.start_ns <= recs[1].start_ns and recs[-1].end_ns <= top.end_ns
    # the plain version launches nothing
    assert (top.attrs["k1_launches"], top.attrs["magnitude_launches"]) == (
        0, 0)
    assert all(r.device_ms is None for r in recs)


@pytest.mark.parametrize("config, mags", [("tts", 1), ("defaults", 0)])
def test_the_attrs_count_the_calls_launches(config, mags, monkeypatch):
    """Where the call launches K1 (stood in for: the plain version, then
    the counters a launch of the head adds), the span's attrs hold that
    call's launches, and its magnitude launches for a magnitude head,
    nested in another span or not."""
    plain = batch_logmel.sig_mel

    def launch(samples, head, **kw):
        k1.launches += 1
        k1.magnitude_launches += int(head.magnitude)
        return plain(samples, head, **kw)

    monkeypatch.setattr(batch_logmel, "sig_mel", launch)
    monkeypatch.setattr(k1, "launches", 7)
    monkeypatch.setattr(k1, "magnitude_launches", 3)
    f = batch_logmel.BatchLogMel(CONFIGS[config], fft_impl="sig", device=CPU)
    profiling.enable()
    f.compute(_x())
    with profiling.span("outer"):
        f.compute(_x())
    spans = [r for r in profiling.records() if r.name == "logmel"]
    assert [(r.attrs["k1_launches"], r.attrs["magnitude_launches"])
            for r in spans] == [(1, mags), (1, mags)]
    assert spans[0].parent is None and spans[1].parent is not None
    assert profiling.counters()["sig_mel.magnitude_launches"] == 3 + 2 * mags


@pytest.mark.parametrize("impl", ["sig", "rdft"])
def test_off_records_nothing(impl, monkeypatch):
    def no_event(device):
        raise AssertionError("a timing event while tracing is off")

    monkeypatch.setattr(profiling, "_timed_event", no_event)
    batch_logmel.BatchLogMel(TTS, fft_impl=impl, device=CPU).compute(_x())
    assert _ours(profiling.records()) == []


def test_an_empty_call_records_the_span_alone():
    f = batch_logmel.BatchLogMel(TTS, fft_impl="sig", device=CPU)
    profiling.enable()
    out = f.compute(torch.zeros(2, 0))
    assert tuple(out.shape) == (2, 80, 0)
    assert [r.name for r in _ours(profiling.records())] == ["logmel"]


def test_the_step_records_no_logmel_span_and_keeps_its_own():
    """The frontend step calls ``BatchLogMel._compute`` in its stage
    ``frontend_step.nemo``: traced, its records are the step's five, with
    the names and parents they had, and no ``logmel`` record."""
    step = sharded_frontend_step(settings=DetectionSettings(), device="cpu")
    profiling.clear()           # the set-up spans of the step's build
    profiling.enable()
    step(_x())
    profiling.disable()
    recs = profiling.records()
    assert _ours(recs) == []
    assert [r.name for r in recs] == STEP
    top = recs[0]
    assert top.parent is None
    assert all(r.parent == top.id and r.call == top.id for r in recs[1:])


def test_counters_read_the_magnitude_launches():
    assert ("sig_mel", "magnitude_launches") in profiling.COUNTERS
    assert profiling.counters()["sig_mel.magnitude_launches"] == \
        k1.magnitude_launches
