"""The port's TEN-VAD harness on the vendored 30-file testset against the
published macro metrics (``tests/test_vad_eval.py``: balanced P 0.8751 /
R 0.8785 / F1 0.8566 / FPR 0.3946, high-F1 0.8165 / 0.9635 / 0.8769 /
0.6459) digit for digit, and against the JAX package's harness on the
same files: every file's frame counts (tp, fp, tn, fn) equal, so the
published 30-row table holds through the port as it does through JAX.
Both classify in float64 (the port's batched route on the CPU, JAX's with
x64 on); the mel is float32 in both."""

from pathlib import Path

import numpy as np
import pytest

from melspec_tpu.utils import vad_eval as jve
from melspec_tpu_torch.config import DetectionSettings
from melspec_tpu_torch.utils import vad_eval as ve

TESTSET = Path(__file__).resolve().parents[1] / "testdata" / "ten-vad"
PUBLISHED = {
    "balanced": (0.8751, 0.8785, 0.8566, 0.3946),
    "high-f1": (0.8165, 0.9635, 0.8769, 0.6459),
}


def _counts(rows):
    return [(r.path.name, r.metrics.tp, r.metrics.fp, r.metrics.tn,
             r.metrics.fn) for r in rows]


@pytest.fixture(scope="module", params=["balanced", "high-f1"])
def evaluated(request):
    name = request.param
    opts, settings = ve.preset(name)
    _, rows = ve.evaluate_testset(TESTSET, opts, settings, device="cpu")
    _, brows = ve.evaluate_testset_batched(TESTSET, opts, settings,
                                           device="cpu")
    _, jrows = jve.evaluate_testset(TESTSET, *jve.preset(name))
    return name, rows, brows, jrows


def test_macro_digits_match_published(evaluated):
    name, rows, brows, _ = evaluated
    for r in (rows, brows):
        assert len(r) == 30
        mm = ve.macro_metrics(r)
        got = tuple(round(mm[k], 4) for k in ("precision", "recall", "f1",
                                              "fpr"))
        assert got == PUBLISHED[name]


def test_per_file_counts_match_jax(evaluated):
    """Every file's tp / fp / tn / fn equal JAX's (whose per-file table
    the JAX tests pin to the published digits), in both evaluators."""
    _, rows, brows, jrows = evaluated
    assert _counts(rows) == _counts(jrows) == _counts(brows)
    for r, j in zip(rows, jrows):
        assert round(r.duration_s, 3) == round(j.duration_s, 3)


def test_presets_match_jax():
    for name in PUBLISHED:
        opts, settings = ve.preset(name)
        jopts, jsettings = jve.preset(name)
        assert vars(opts) == vars(jopts)
        assert settings == DetectionSettings(
            jsettings.min_energy, jsettings.min_y, jsettings.min_x,
            jsettings.min_mel)
    with pytest.raises(ValueError, match="unknown VAD preset"):
        ve.preset("nope")


def test_file_decisions_match_jax():
    """One file's post-processed decisions, time for time."""
    wav = sorted(TESTSET.glob("*.wav"))[3]
    samples, rate = ve.read_wav_mono(wav)
    labels = ve.read_labels(wav.with_suffix(".scv"))
    opts, settings = ve.preset("balanced")
    m, decisions = ve.evaluate_file(samples, rate, labels, opts, settings,
                                    device="cpu")
    jm, jdecisions = jve.evaluate_file(samples, rate, jve.read_labels(
        wav.with_suffix(".scv")), *jve.preset("balanced"))
    assert [(d.time_s, d.speech) for d in decisions] == \
        [(d.time_s, d.speech) for d in jdecisions]
    assert (m.tp, m.fp, m.tn, m.fn) == (jm.tp, jm.fp, jm.tn, jm.fn)
    short = ve.evaluate_file(samples[:600], rate, labels, opts, settings,
                             device="cpu")
    assert short[0].total == 0 and short[1] == []


def test_label_parsing_matches_jax():
    for wav in sorted(TESTSET.glob("*.scv"))[:5]:
        got = ve.read_labels(wav)
        want = jve.read_labels(wav)
        assert [(s.start, s.end, s.speech) for s in got] == \
            [(s.start, s.end, s.speech) for s in want]
        for t in np.linspace(0, got[-1].end + 0.5, 37):
            assert ve.label_at(got, float(t)) == jve.label_at(want, float(t))


def test_postprocessing_matches_jax_fuzz():
    """Segments, merging, the sequential and vectorized post-processing
    and the label mask against JAX's, over random decision streams and
    every post-processing knob."""
    rng = np.random.default_rng(11)
    hop_s = 160 / 16000.0
    for trial in range(30):
        n = int(rng.integers(1, 400))
        speech = rng.random(n) < rng.uniform(0.05, 0.9)
        times = np.round((np.arange(n) * hop_s + 0.0125) * 1000) / 1000.0
        kw = dict(min_speech_ms=int(rng.choice([0, 50, 150, 400])),
                  merge_gap_ms=int(rng.choice([0, 50, 150, 400])))
        opts, jopts = ve.EvalOptions(**kw), jve.EvalOptions(**kw)
        dec = [ve.TimedDecision(float(t), bool(s))
               for t, s in zip(times, speech)]
        jdec = [jve.TimedDecision(float(t), bool(s))
                for t, s in zip(times, speech)]
        segs = ve.decisions_to_segments(dec, hop_s)
        assert [(s.start, s.end) for s in segs] == [
            (s.start, s.end) for s in jve.decisions_to_segments(jdec, hop_s)]
        want = [d.speech for d in jve.postprocess_decisions(jdec, hop_s,
                                                            jopts)]
        assert [d.speech for d in ve.postprocess_decisions(
            dec, hop_s, opts)] == want, (trial, kw)
        got = ve._postprocess_mask(speech, times, hop_s, opts)
        assert [bool(g) for g in got] == want, (trial, kw)
        labels = []
        for _ in range(int(rng.integers(0, 6))):
            a = float(rng.uniform(0, times[-1] + 0.1))
            labels.append((a, a + float(rng.uniform(0, 1.5)),
                           bool(rng.random() < 0.7)))
        np.testing.assert_array_equal(
            ve._labels_mask([ve.LabelSegment(*s) for s in labels], times),
            jve._labels_mask([jve.LabelSegment(*s) for s in labels], times))
    merged = ve.merge_close_segments(
        [ve.LabelSegment(0.0, 1.0, True), ve.LabelSegment(1.05, 2.0, True),
         ve.LabelSegment(3.0, 4.0, True)], 0.1)
    assert [(s.start, s.end) for s in merged] == [(0.0, 2.0), (3.0, 4.0)]


def test_metrics_and_speed_match_jax():
    rng = np.random.default_rng(3)
    rows, jrows = [], []
    for i in range(6):
        tp, fp, tn, fn = (int(v) for v in rng.integers(0, 50, size=4))
        m, jm = ve.Metrics(tp, fp, tn, fn), jve.Metrics(tp, fp, tn, fn)
        for p, e in [(True, True), (False, True), (True, False)]:
            m.add(p, e)
            jm.add(p, e)
        rows.append(ve.FileResult(Path(f"{i}.wav"), 1.5 + i, 0.1 * i, m))
        jrows.append(jve.FileResult(Path(f"{i}.wav"), 1.5 + i, 0.1 * i, jm))
    assert ve.macro_metrics(rows) == jve.macro_metrics(jrows)
    assert ve.speed_metrics(rows) == jve.speed_metrics(jrows)
    assert ve.Metrics().f1 == 0.0 and ve.Metrics().fpr == 0.0


def test_batched_eval_handles_clip_shorter_than_window(tmp_path):
    """A clip shorter than the detector window gives an empty per-file
    result, as the sequential path does, and the long clip is still
    evaluated."""
    import shutil
    import struct

    src = sorted(TESTSET.glob("*.wav"))[0]
    shutil.copy(src, tmp_path / "long.wav")
    shutil.copy(src.with_suffix(".scv"), tmp_path / "long.scv")
    n = 600  # 2 frames < min_x = 5
    payload = struct.pack(f"<{n}h", *([0] * n))
    hdr = (b"RIFF" + struct.pack("<I", 36 + len(payload)) + b"WAVE"
           + b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, 16000, 32000, 2, 16)
           + b"data" + struct.pack("<I", len(payload)))
    (tmp_path / "short.wav").write_bytes(hdr + payload)
    (tmp_path / "short.scv").write_text("short.wav,0.0,0.05,0\n")
    total, rows = ve.evaluate_testset_batched(tmp_path, ve.EvalOptions(),
                                              DetectionSettings(),
                                              device="cpu")
    assert len(rows) == 2
    short = [r for r in rows if r.path.name == "short.wav"][0]
    assert short.metrics.total == 0 and total.total > 0
    with pytest.raises(FileNotFoundError):
        ve.evaluate_testset(tmp_path / "none", ve.EvalOptions(),
                            DetectionSettings(), device="cpu")
