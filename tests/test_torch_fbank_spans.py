"""The span of ``ops/fbank.py::Fbank.compute`` on the CPU: traced, a call
is the span ``fbank`` with its stages (``fbank.spectral`` and
``fbank.cmn`` on the ``"sig"`` route, ``fbank.plain`` on the others),
the call's K1 launches in its attrs; off, nothing is recorded; and the
callers of ``Fbank._compute`` (MFCC, the frontend step's unfused route)
record no span of it."""

import numpy as np
import pytest
import torch

from melspec_tpu_torch.config import FbankConfig, MfccConfig
from melspec_tpu_torch.kernels import sig_mel as k1
from melspec_tpu_torch.ops import fbank
from melspec_tpu_torch.ops.mfcc import Mfcc
from melspec_tpu_torch.utils import profiling

CPU = torch.device("cpu")
CFG = FbankConfig(apply_cmn=True)
STAGES = {"sig": ["fbank.spectral", "fbank.cmn"], "rdft": ["fbank.plain"]}


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
    return [r for r in recs if r.name == "fbank" or
            r.name.startswith("fbank.")]


@pytest.mark.parametrize("impl", sorted(STAGES))
def test_a_call_is_the_span_and_its_stages(impl):
    f = fbank.Fbank(CFG, fft_impl=impl, device=CPU)
    x = _x()
    want = f.compute(x)
    profiling.enable()
    got = f.compute(x)
    profiling.disable()
    assert torch.equal(got, want)
    recs = _ours(profiling.records())
    assert [r.name for r in recs] == ["fbank", *STAGES[impl]]
    top = recs[0]
    assert top.parent is None and top.call == top.id
    assert all(r.parent == top.id and r.call == top.id for r in recs[1:])
    for a, b in zip(recs[1:], recs[2:]):
        assert a.end_ns <= b.start_ns
    assert top.start_ns <= recs[1].start_ns and recs[-1].end_ns <= top.end_ns
    # the plain version launches nothing
    assert (top.attrs["k1_launches"], top.attrs["fft_launches"]) == (0, 0)
    assert all(r.device_ms is None for r in recs)


def test_the_attrs_count_the_calls_launches(monkeypatch):
    """Where the call launches K1 (stood in for: the plain version, then
    the counters a launch on the float64 FFT path adds), the span's attrs
    hold that call's launches, nested in another span or not."""
    plain = fbank.sig_mel

    def launch(*a, **kw):
        k1.launches += 1
        k1.fft_launches += 1
        return plain(*a, **kw)

    monkeypatch.setattr(fbank, "sig_mel", launch)
    monkeypatch.setattr(k1, "launches", 7)
    monkeypatch.setattr(k1, "fft_launches", 3)
    f = fbank.Fbank(CFG, fft_impl="sig", device=CPU)
    profiling.enable()
    f.compute(_x())
    with profiling.span("outer"):
        f.compute(_x())
    spans = [r for r in profiling.records() if r.name == "fbank"]
    assert [(r.attrs["k1_launches"], r.attrs["fft_launches"])
            for r in spans] == [(1, 1), (1, 1)]
    assert spans[0].parent is None and spans[1].parent is not None


@pytest.mark.parametrize("impl", sorted(STAGES))
def test_off_records_nothing(impl, monkeypatch):
    def no_event(device):
        raise AssertionError("a timing event while tracing is off")

    monkeypatch.setattr(profiling, "_timed_event", no_event)
    fbank.Fbank(CFG, fft_impl=impl, device=CPU).compute(_x())
    assert _ours(profiling.records()) == []


@pytest.mark.parametrize("impl", sorted(STAGES))
def test_compute_internals_record_no_span(impl):
    """MFCC and the frontend step call ``Fbank._compute``: traced, they
    record no ``fbank`` span or stage of it."""
    f = fbank.Fbank(CFG, fft_impl=impl, device=CPU)
    mfcc = Mfcc(MfccConfig(), fft_impl=impl, device=CPU)
    x = _x()
    profiling.enable()
    f._compute(x)
    mfcc.compute(x)
    profiling.disable()
    assert _ours(profiling.records()) == []
