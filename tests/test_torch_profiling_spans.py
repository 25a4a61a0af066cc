"""The port's spans (``melspec_tpu_torch/utils/profiling.py``) on the CPU:
off, a span is one shared no-op that records and keeps nothing; on
(``enable()`` or a running ``torch.profiler`` capture) its records carry
their parent, call id and self time on the profiler's own clock; the ring
is bounded and keeps the set-up records apart; the served paths and the
head builders open the spans that name them. The device events are
stood in for by host objects, as the CPU has no CUDA event."""

import collections
import contextlib
import tracemalloc

import numpy as np
import pytest
import torch

from melspec_tpu_torch.config import (BatchLogMelConfig, DetectionSettings,
                                      FbankConfig)
from melspec_tpu_torch.kernels import sig_mel, sig_multi
from melspec_tpu_torch.ops import batch_logmel, fbank, mel_kernel
from melspec_tpu_torch.ops import sig_multihead
from melspec_tpu_torch.ops.spectrogram import WhisperMelPipeline
from melspec_tpu_torch.parallel.sharding import sharded_frontend_step
from melspec_tpu_torch.utils import profiling

STAGES = ("frontend_step.spectral", "frontend_step.nemo",
          "frontend_step.vad", "frontend_step.quant")


@pytest.fixture(autouse=True)
def fresh():
    """Each test starts with tracing off and no records."""
    profiling.disable()
    profiling.clear()
    yield
    profiling.disable()
    profiling.clear()


@contextlib.contextmanager
def tracing_on(how: str):
    """Spans on through ``enable()`` or a CPU ``torch.profiler`` capture
    (yielding the capture, or None)."""
    if how == "enable":
        profiling.enable()
        try:
            yield None
        finally:
            profiling.disable()
    else:
        acts = [torch.profiler.ProfilerActivity.CPU]
        with torch.profiler.profile(activities=acts) as prof:
            yield prof


def test_off_span_is_shared_noop_and_keeps_nothing():
    a = profiling.span("frontend_step", "cpu")
    assert a is profiling.span("mel_batch", torch.device("cpu"), k=1)
    assert profiling.stages("cpu") is a and profiling.stages("cpu")("x") is a
    with a as entered:
        entered.set(anything=1)
    assert profiling.records() == []


def test_off_span_allocates_nothing():
    def loop(n):
        for _ in range(n):
            with profiling.span("frontend_step", "cpu"):
                stage = profiling.stages("cpu")
                with stage("frontend_step.spectral"):
                    pass

    loop(100)
    tracemalloc.start()
    try:
        before, _ = tracemalloc.get_traced_memory()
        tracemalloc.reset_peak()
        loop(10_000)
        after, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert after == before
    assert peak - before < 1024   # nothing a span, not even briefly kept
    assert profiling.records() == []


@pytest.mark.parametrize("how", ["enable", "profiler"])
def test_on_records_parent_call_and_self_time(how):
    a = torch.ones(64, 64)
    with tracing_on(how):
        with profiling.span("outer", "cpu", what="x"):
            with profiling.span("inner"):
                with profiling.span("leaf"):
                    a @ a
            with profiling.span("inner"):
                pass
        with profiling.span("second"):
            pass
    with profiling.span("after"):   # off again
        pass
    recs = profiling.records()
    assert [r.name for r in recs] == ["outer", "inner", "leaf", "inner",
                                      "second"]
    outer, in1, leaf, in2, second = recs
    assert outer.parent is None and outer.call == outer.id
    assert in1.parent == in2.parent == outer.id and leaf.parent == in1.id
    assert {r.call for r in (in1, leaf, in2)} == {outer.id}
    assert second.parent is None and second.call == second.id != outer.id
    assert all(r.device_ms is None for r in recs)
    assert outer.attrs["what"] == "x"
    # a top-level span counts the K1 / K2 launches inside it; others not
    assert outer.attrs["k1_launches"] == outer.attrs["k2_launches"] == 0
    assert "k1_launches" not in in1.attrs
    for r in recs:
        assert r.start_ns <= r.end_ns
    for child, parent in ((in1, outer), (in2, outer), (leaf, in1)):
        assert parent.start_ns <= child.start_ns <= child.end_ns \
            <= parent.end_ns
    s = profiling.summary()
    assert s["inner"]["count"] == 2 and s["outer"]["count"] == 1
    assert s["outer"]["self_ms"] == pytest.approx(
        outer.host_ms - in1.host_ms - in2.host_ms, abs=1e-9)
    assert s["inner"]["self_ms"] == pytest.approx(
        in1.host_ms - leaf.host_ms + in2.host_ms, abs=1e-9)
    assert s["leaf"]["self_ms"] == pytest.approx(leaf.host_ms, abs=1e-9)
    assert s["outer"]["device_ms"] is None


def test_spans_never_enter_the_profiler():
    a = torch.ones(32, 32)
    with tracing_on("profiler") as prof:
        with profiling.span("frontend_step", "cpu"):
            stage = profiling.stages("cpu")
            with stage("frontend_step.spectral"):
                a @ a
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert "aten::mm" in names
    assert not names & {"frontend_step", "frontend_step.spectral"}
    assert [r.name for r in profiling.records()] == [
        "frontend_step", "frontend_step.spectral"]


def test_span_shares_the_profilers_clock():
    """An ``aten::mm`` issued inside a span lies inside the span's
    ``[start, end]`` among the profiler's own events."""
    a = torch.randn(128, 128)
    with tracing_on("profiler") as prof:
        for _ in range(3):
            with profiling.span("mm"):
                a @ a
    spans = [(r.start_ns, r.end_ns) for r in profiling.records()]
    mms = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                 for e in prof.profiler.kineto_results.events()
                 if e.name() == "aten::mm")
    assert len(spans) == len(mms) == 3
    for (s0, s1), (m0, m1) in zip(spans, mms):
        assert s0 <= m0 <= m1 <= s1


def test_ring_is_bounded_and_keeps_setup_apart(monkeypatch):
    monkeypatch.setattr(profiling._state, "ring",
                        collections.deque(maxlen=8))
    for i in range(3):   # recorded whatever the state
        with profiling.span("setup.heads", head=f"h{i}"):
            pass
    profiling.enable()
    for i in range(20):
        with profiling.span("hot", i=i):
            pass
    recs = profiling.records()
    assert [r.attrs["head"] for r in recs if r.name == "setup.heads"] == [
        "h0", "h1", "h2"]
    assert [r.attrs["i"] for r in recs if r.name == "hot"] == list(
        range(12, 20))
    assert profiling.RING == 65_536
    profiling.clear()
    assert profiling.records() == []


class FakeEvent:
    """A timing event on the host: ``at`` is the ms at which it was
    recorded, ``done`` whether the device has passed it."""

    device = torch.device("cuda", 0)
    clock = 0.0

    def __init__(self):
        self.at, self.done = None, False

    def record(self):
        FakeEvent.clock += 1.5
        self.at, self.done = FakeEvent.clock, False

    def query(self) -> bool:
        return self.done

    def elapsed_time(self, end) -> float:
        assert self.done and end.done
        return end.at - self.at


@pytest.fixture
def fake_events(monkeypatch):
    """``profiling``'s CUDA events replaced by ``FakeEvent``, from the same
    pool; returns every event made."""
    made = []

    def timed(device):
        assert device == torch.device("cuda", 0)
        pool = profiling._state.pools[device.index]
        e = pool.pop() if pool else FakeEvent()
        if e not in made:
            made.append(e)
        e.record()
        return e

    monkeypatch.setattr(profiling, "_timed_event", timed)
    monkeypatch.setattr(profiling._state, "pools",
                        collections.defaultdict(list))
    return made


def test_stages_share_boundary_events_and_read_late(fake_events):
    profiling.enable()
    dev = torch.device("cuda", 0)
    with profiling.span("step", dev):
        stage = profiling.stages(dev)
        for name in ("step.a", "step.b", "step.c"):
            with stage(name):
                pass
    # one event at each boundary: step's two, the stages' four
    assert len(fake_events) == 6
    recs = profiling.records()   # no event has completed: nothing read
    assert all(r.device_ms is None for r in recs)
    for e in fake_events:
        e.done = True
    recs = {r.name: r for r in profiling.records()}
    assert [recs[n].device_ms for n in ("step.a", "step.b", "step.c")] == [
        1.5, 1.5, 1.5]
    assert recs["step"].device_ms == pytest.approx(7.5)
    s = profiling.summary()
    assert s["step.b"]["device_ms"] == 1.5 and s["step"]["count"] == 1
    # read and no span open: the events go back to the pool, once each
    pool = profiling._state.pools[0]
    assert sorted(map(id, pool)) == sorted(map(id, fake_events))
    with profiling.span("again", dev):
        pass
    assert len(fake_events) == 6   # taken from the pool


def test_event_read_before_next_stage_is_not_reused(fake_events):
    """A stage whose predecessor's events were read and pooled starts
    from an event of its own."""
    profiling.enable()
    dev = torch.device("cuda", 0)
    stage = profiling.stages(dev)
    with stage("s.a"):
        pass
    for e in fake_events:
        e.done = True
    profiling.records()
    with stage("s.b"):
        pass
    for e in fake_events:
        e.done = True
    a, b = profiling.records()
    assert a.device_ms == 1.5 and b.device_ms == 1.5


def test_top_level_span_counts_kernel_launches(monkeypatch):
    monkeypatch.setattr(sig_mel, "launches", 10)
    monkeypatch.setattr(sig_multi, "launches", 4)
    profiling.enable()
    with profiling.span("call"):
        with profiling.span("inner"):
            sig_mel.launches += 2
            sig_multi.launches += 1
    call, inner = profiling.records()
    assert (call.attrs["k1_launches"], call.attrs["k2_launches"]) == (2, 1)
    assert "k1_launches" not in inner.attrs
    c = profiling.counters()
    assert c["sig_mel.launches"] == 12 and c["sig_multi.launches"] == 5
    assert {"sig_mel.fft_launches", "sig_mel.factored_launches",
            "sig_mel.epilogue_launches.vad", "resample.launches.K4",
            "framed_mel.launches.K5", "load_probe.launches.flat_span"} \
        <= set(c)


def test_frontend_step_spans_its_four_stages():
    step = sharded_frontend_step(settings=DetectionSettings(), device="cpu")
    x = torch.as_tensor(np.random.default_rng(0).normal(
        size=(2, 8000)).astype(np.float32) * 0.1)
    step(x)                      # off: nothing
    assert not [r for r in profiling.records()
                if r.name.startswith("frontend_step")]
    profiling.clear()
    profiling.enable()
    out = step(x)
    profiling.disable()
    recs = profiling.records()
    assert [r.name for r in recs] == ["frontend_step", *STAGES]
    top = recs[0]
    assert top.parent is None and top.attrs["k2_launches"] == 0
    assert all(r.call == top.id and r.parent == top.id for r in recs[1:])
    for a, b in zip(recs[1:], recs[2:]):
        assert a.end_ns <= b.start_ns
    assert top.start_ns <= recs[1].start_ns and recs[-1].end_ns <= top.end_ns
    assert out["mel_q8_range"].shape == (1, 2)


def test_mel_batch_span_on_cpu():
    pipe = WhisperMelPipeline(400, 160, 80, 16000.0, device="cpu")
    x = torch.zeros(2, 4000)
    with tracing_on("profiler"):
        mel = pipe.mel_batch(x)
    (r,) = [r for r in profiling.records() if r.name == "mel_batch"]
    assert r.parent is None and r.device_ms is None
    assert tuple(mel.shape) == (2, 23, 80)


@pytest.mark.parametrize("head, build", [
    ("kaldi", lambda: fbank.sig_head(FbankConfig(apply_cmn=True))),
    ("nemo", lambda: batch_logmel.sig_head(BatchLogMelConfig())),
    ("nemo_fold", lambda: sig_multihead.nemo_fold_head(BatchLogMelConfig())),
    ("whisper", lambda: mel_kernel.sig_matrices(400, 128, 16000.0, 3, 2,
                                                torch.device("cpu"))),
    ("factored_dft", lambda: sig_mel.factored_dft(960, torch.device("cpu"))),
    ("fft_twiddles", lambda: sig_mel.fft_twiddles(torch.device("cpu"))),
])
def test_cold_head_build_records_setup_heads(head, build):
    """Tracing off: a cold build records one ``setup.heads`` span with its
    ``head``; a warm one (the cache's hit) records none."""
    builder = {"kaldi": fbank.sig_head, "nemo": batch_logmel.sig_head,
               "nemo_fold": sig_multihead.nemo_fold_head,
               "whisper": mel_kernel.sig_matrices,
               "factored_dft": sig_mel.factored_dft,
               "fft_twiddles": sig_mel.fft_twiddles}[head]
    builder.cache_clear()
    build()
    recs = [r for r in profiling.records() if r.name == "setup.heads"]
    assert [r.attrs["head"] for r in recs] == [head]
    assert recs[0].host_ms > 0 and recs[0].device_ms is None
    build()
    assert len([r for r in profiling.records()
                if r.name == "setup.heads"]) == 1


def test_routes_record_setup_route():
    from melspec_tpu_torch.parallel.sharding import frontend_route
    from melspec_tpu_torch.config import MelConfig

    frontend_route(MelConfig(), FbankConfig(apply_cmn=True), "cpu")
    batch_logmel.auto_fft_impl(BatchLogMelConfig(), torch.float32, "cpu")
    routes = [r.attrs["route"] for r in profiling.records()
              if r.name == "setup.route"]
    assert routes == ["frontend_route", "batch_logmel.auto_fft_impl"]
