"""TEN-VAD evaluation harness (port of ``melspec_tpu.utils.vad_eval``).

Library core of the reference's ``vad_ten_eval`` example
(``examples/vad_ten_eval/src/main.rs``): per-file STFT -> whisper mel ->
VAD decisions with timestamps, decision thresholds, segment post-processing
(merge gaps, drop short segments), frame-level metrics against ``.scv``
labels, micro + macro aggregation, and RTF/RTFx accounting.

Two evaluators, as in the JAX package:

- ``evaluate_testset``: per file, the mel on ``device`` and every windowed
  decision classified in float64 on the host
  (``ops.vad.streaming_decision_fields``);
- ``evaluate_testset_batched``: every clip zero-padded to one length and
  the mel + decision fields run as one batched device pass
  (``WhisperMelPipeline.mel_batch`` + ``streaming_decision_fields_batched``).
  On CUDA it takes the route the JAX package takes on an accelerator: the
  bf3 power (``fft_impl="bf3"``) and float32 classification; elsewhere the
  auto route and float64 classification.

Decisions, post-processing and metrics are the JAX module's, line for line.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from melspec_tpu_torch._device import resolve_device
from melspec_tpu_torch.config import DetectionSettings
from melspec_tpu_torch.io.wav import read_wav_mono
from melspec_tpu_torch.ops.framing import num_frames_batch
from melspec_tpu_torch.ops.spectrogram import (WhisperMelPipeline,
                                               compute_mel_spectrogram)
from melspec_tpu_torch.ops.vad import (streaming_decision_fields,
                                       streaming_decision_fields_batched)


def preset(name: str) -> Tuple["EvalOptions", DetectionSettings]:
    """The reference's two published TEN-VAD operating points
    (``doc/vad/README.md:73-76``), as ``(EvalOptions, DetectionSettings)``:

    - ``"balanced"`` (the default preset): min_energy=0.98 min_y=11
      min_x=5 min_mel=2 min_speech=150ms merge_gap=150ms -> macro
      P 0.8751 / R 0.8785 / F1 0.8566 / FPR 0.3946.
    - ``"high-f1"`` (recall-leaning sweep winner): min_energy=0.96
      min_y=8 min_x=5 min_mel=4 min_speech=200ms merge_gap=150ms ->
      macro P 0.8165 / R 0.9635 / F1 0.8769 / FPR 0.6459.
    """
    if name == "balanced":
        return EvalOptions(), DetectionSettings()
    if name == "high-f1":
        return (
            EvalOptions(min_speech_ms=200, merge_gap_ms=150),
            DetectionSettings(min_energy=0.96, min_y=8, min_x=5,
                              min_mel=4),
        )
    raise ValueError(f"unknown VAD preset {name!r}: balanced | high-f1")


@dataclasses.dataclass
class EvalOptions:
    fft_size: int = 400
    hop_size: int = 160
    n_mels: int = 80
    time_mode: str = "center"  # start | center | end
    min_leading_active_columns: int = 1
    min_active_columns: int = 1
    min_confidence: float = 0.0
    min_speech_ms: int = 150
    merge_gap_ms: int = 150


@dataclasses.dataclass
class LabelSegment:
    start: float
    end: float
    speech: bool


@dataclasses.dataclass
class TimedDecision:
    time_s: float
    speech: bool


@dataclasses.dataclass
class Metrics:
    tp: int = 0
    fp: int = 0
    tn: int = 0
    fn: int = 0

    def add(self, predicted: bool, expected: bool) -> None:
        if predicted and expected:
            self.tp += 1
        elif predicted and not expected:
            self.fp += 1
        elif not predicted and not expected:
            self.tn += 1
        else:
            self.fn += 1

    def merge(self, other: "Metrics") -> None:
        self.tp += other.tp
        self.fp += other.fp
        self.tn += other.tn
        self.fn += other.fn

    @property
    def total(self) -> int:
        return self.tp + self.fp + self.tn + self.fn

    @staticmethod
    def _ratio(num: int, den: int) -> float:
        return num / den if den else 0.0

    @property
    def precision(self) -> float:
        return self._ratio(self.tp, self.tp + self.fp)

    @property
    def recall(self) -> float:
        return self._ratio(self.tp, self.tp + self.fn)

    @property
    def f1(self) -> float:
        p, r = self.precision, self.recall
        return 2 * p * r / (p + r) if p + r else 0.0

    @property
    def accuracy(self) -> float:
        return self._ratio(self.tp + self.tn, self.total)

    @property
    def fpr(self) -> float:
        return self._ratio(self.fp, self.fp + self.tn)

    @property
    def fnr(self) -> float:
        return self._ratio(self.fn, self.fn + self.tp)


def read_labels(path: Path) -> List[LabelSegment]:
    """Parse a TEN-VAD ``.scv`` label file: ``name,start,end,flag,...``
    triplets (reference ``main.rs:305-322``)."""
    fields = path.read_text().strip().split(",")
    if len(fields) < 4 or (len(fields) - 1) % 3 != 0:
        raise ValueError(f"bad label file format: {path}")
    rest = fields[1:]
    return [LabelSegment(start=float(rest[i]), end=float(rest[i + 1]),
                         speech=int(rest[i + 2]) == 1)
            for i in range(0, len(rest), 3)]


def label_at(labels: Sequence[LabelSegment], time_s: float) -> bool:
    for seg in labels:
        if seg.start <= time_s < seg.end:
            return seg.speech
    return False


def decisions_to_segments(
    decisions: Sequence[TimedDecision], half_width_s: float
) -> List[LabelSegment]:
    out: List[LabelSegment] = []
    open_start: Optional[float] = None
    for d in decisions:
        if d.speech and open_start is None:
            open_start = max(d.time_s - half_width_s / 2.0, 0.0)
        elif not d.speech and open_start is not None:
            out.append(LabelSegment(
                open_start, max(d.time_s - half_width_s / 2.0, open_start),
                True))
            open_start = None
    if open_start is not None and decisions:
        out.append(LabelSegment(open_start,
                                decisions[-1].time_s + half_width_s / 2.0,
                                True))
    return out


def merge_close_segments(
    segments: Sequence[LabelSegment], merge_gap_s: float
) -> List[LabelSegment]:
    merged: List[LabelSegment] = []
    for seg in segments:
        if merged and seg.start - merged[-1].end <= merge_gap_s:
            merged[-1].end = max(merged[-1].end, seg.end)
        else:
            merged.append(LabelSegment(seg.start, seg.end, True))
    return merged


def _filter_segments(segments: List[LabelSegment],
                     opts: EvalOptions) -> List[LabelSegment]:
    """Merge close segments, then drop short ones, as the options say."""
    if opts.merge_gap_ms > 0:
        segments = merge_close_segments(segments, opts.merge_gap_ms / 1000.0)
    if opts.min_speech_ms > 0:
        min_s = opts.min_speech_ms / 1000.0
        segments = [s for s in segments if s.end - s.start >= min_s]
    return segments


def postprocess_decisions(
    decisions: List[TimedDecision], frame_period_s: float, opts: EvalOptions
) -> List[TimedDecision]:
    if not decisions or (opts.min_speech_ms == 0 and opts.merge_gap_ms == 0):
        return decisions
    segments = _filter_segments(
        decisions_to_segments(decisions, frame_period_s), opts)
    return [
        TimedDecision(
            d.time_s,
            any(s.start <= d.time_s < s.end for s in segments),
        )
        for d in decisions
    ]


def _postprocess_mask(
    speech: np.ndarray, times_s: np.ndarray, frame_period_s: float,
    opts: EvalOptions,
) -> np.ndarray:
    """Vectorized ``postprocess_decisions`` over a whole file's decisions:
    run-length segments -> merge -> min-length filter -> point-in-segment
    test, decision for decision the sequential helper's result."""
    n = speech.shape[0]
    if n == 0 or (opts.min_speech_ms == 0 and opts.merge_gap_ms == 0):
        return speech
    h2 = frame_period_s / 2.0
    s8 = speech.astype(np.int8)
    rise = np.flatnonzero(np.diff(s8) == 1) + 1      # False -> True
    fall = np.flatnonzero(np.diff(s8) == -1) + 1     # True -> False
    if speech[0]:
        rise = np.concatenate([[0], rise])
    starts = np.maximum(times_s[rise] - h2, 0.0)
    ends = np.empty_like(starts)
    n_closed = len(fall)
    ends[:n_closed] = np.maximum(times_s[fall] - h2, starts[:n_closed])
    if len(starts) > n_closed:  # trailing open segment
        ends[-1] = times_s[-1] + h2
    segments = _filter_segments(
        [LabelSegment(float(a), float(b), True) for a, b in zip(starts, ends)],
        opts)
    if not segments:
        return np.zeros(n, dtype=bool)
    seg_start = np.asarray([s.start for s in segments])
    seg_end = np.asarray([s.end for s in segments])
    # merged segments are sorted and disjoint: point-in-segment by bisect
    k = np.searchsorted(seg_start, times_s, side="right") - 1
    return (k >= 0) & (times_s < seg_end[np.maximum(k, 0)])


def _labels_mask(labels: Sequence[LabelSegment],
                 times_s: np.ndarray) -> np.ndarray:
    """Vectorized ``label_at`` (first-matching-segment semantics)."""
    expected = np.zeros(times_s.shape[0], dtype=bool)
    assigned = np.zeros_like(expected)
    for seg in labels:
        m = ~assigned & (times_s >= seg.start) & (times_s < seg.end)
        expected[m] = seg.speech
        assigned |= m
    return expected


def decision_times_s(n_dec: int, settings: DetectionSettings,
                     opts: EvalOptions, sample_rate: int) -> np.ndarray:
    """Timestamps (s) of decisions ``0 .. n_dec - 1``, decision ``i``
    being for frame ``min_x - 1 + i``, at the frame's start, center or end
    (``opts.time_mode``), rounded half away from zero to whole ms as the
    reference rounds them."""
    frame_idx = np.arange(settings.min_x - 1, settings.min_x - 1 + n_dec)
    sample_off = {"start": 0, "center": opts.fft_size // 2,
                  "end": opts.fft_size}[opts.time_mode]
    return np.floor((frame_idx * opts.hop_size + sample_off) / sample_rate
                    * 1000.0 + 0.5) / 1000.0


def speech_mask(fields: dict, n_dec: int, opts: EvalOptions) -> np.ndarray:
    """Per-decision speech flags from the decision fields' first ``n_dec``
    entries and the options' thresholds."""
    return (np.asarray(fields["active"][:n_dec], dtype=bool)
            & (np.asarray(fields["leading"][:n_dec])
               >= opts.min_leading_active_columns)
            & (np.asarray(fields["active_columns"][:n_dec])
               >= opts.min_active_columns)
            & (np.asarray(fields["confidence"][:n_dec])
               >= opts.min_confidence))


def _metrics(predicted: np.ndarray, expected: np.ndarray) -> Metrics:
    return Metrics(tp=int(np.sum(predicted & expected)),
                   fp=int(np.sum(predicted & ~expected)),
                   tn=int(np.sum(~predicted & ~expected)),
                   fn=int(np.sum(~predicted & expected)))


def evaluate_file(
    samples: np.ndarray,
    sample_rate: int,
    labels: Sequence[LabelSegment],
    opts: EvalOptions,
    settings: DetectionSettings,
    device=None,
) -> Tuple[Metrics, List[TimedDecision]]:
    """Frame decisions + metrics for one clip (reference
    ``main.rs:232-285``): the whisper mel on ``device`` (CUDA unless
    ``device="cpu"``), the decisions in float64 on the host."""
    n_frames = num_frames_batch(len(samples), opts.fft_size, opts.hop_size)
    if n_frames < settings.min_x:
        return Metrics(), []
    mel = compute_mel_spectrogram(
        np.asarray(samples, np.float32), opts.fft_size, opts.hop_size,
        opts.n_mels, float(sample_rate), device=device,
    ).T  # [n_mels, frames], per-frame whisper norm
    fields = streaming_decision_fields(mel.astype(np.float64), settings)
    n_dec = len(fields["active"])
    times_s = decision_times_s(n_dec, settings, opts, sample_rate)
    decisions = [TimedDecision(float(t), bool(s)) for t, s in
                 zip(times_s, speech_mask(fields, n_dec, opts))]
    decisions = postprocess_decisions(decisions, opts.hop_size / sample_rate,
                                      opts)
    times = np.asarray([d.time_s for d in decisions])
    predicted = np.asarray([d.speech for d in decisions])
    return _metrics(predicted, _labels_mask(labels, times)), decisions


@dataclasses.dataclass
class FileResult:
    path: Path
    duration_s: float
    wall_s: float
    metrics: Metrics


def _testset(testset: Path, max_files: Optional[int]) -> List[Path]:
    wavs = sorted(Path(testset).glob("*.wav"))
    if max_files is not None:
        wavs = wavs[:max_files]
    if not wavs:
        raise FileNotFoundError(f"no .wav files found in {testset}")
    return wavs


def evaluate_testset(
    testset: Path,
    opts: EvalOptions,
    settings: DetectionSettings,
    max_files: Optional[int] = None,
    on_decisions=None,
    device=None,
) -> Tuple[Metrics, List[FileResult]]:
    """Sequential per-file evaluation (``evaluate_file``).
    ``on_decisions(wav, rate, decisions)``, when given, is called once per
    file with the post-processed decisions."""
    total = Metrics()
    rows: List[FileResult] = []
    for wav in _testset(testset, max_files):
        labels = read_labels(wav.with_suffix(".scv"))
        samples, rate = read_wav_mono(wav)
        started = time.perf_counter()
        metrics, decisions = evaluate_file(samples, rate, labels, opts,
                                           settings, device=device)
        wall = time.perf_counter() - started
        total.merge(metrics)
        rows.append(FileResult(wav, len(samples) / rate, wall, metrics))
        if on_decisions is not None:
            on_decisions(wav, rate, decisions)
    return total, rows


def load_testset(testset: Path, max_files: Optional[int] = None) -> tuple:
    """``(wavs, clips, rate, labels)`` of a testset with one sample rate."""
    wavs = _testset(testset, max_files)
    clips, rates, labels = [], [], []
    for wav in wavs:
        samples, rate = read_wav_mono(wav)
        clips.append(samples)
        rates.append(rate)
        labels.append(read_labels(wav.with_suffix(".scv")))
    if len(set(rates)) != 1:
        raise ValueError("batched evaluation requires a uniform sample rate")
    return wavs, clips, rates[0], labels


def batch_clips(clips: Sequence[np.ndarray]) -> np.ndarray:
    """The clips zero-padded to one length, ``[files, max_len]`` float32.
    Exact: a kept frame reads only its clip's samples, and a kept
    decision only kept frames."""
    batch = np.zeros((len(clips), max(len(c) for c in clips)),
                     dtype=np.float32)
    for i, c in enumerate(clips):
        batch[i, : len(c)] = c
    return batch


def evaluate_testset_batched(
    testset: Path,
    opts: EvalOptions,
    settings: DetectionSettings,
    max_files: Optional[int] = None,
    warmup: bool = False,
    device=None,
) -> Tuple[Metrics, List[FileResult]]:
    """Whole-testset evaluation as one batched device pass on ``device``
    (CUDA unless ``device="cpu"``): the mel and the decision fields of
    every clip at once, then the per-file post-processing and metrics on
    the host. Per-file wall time is the pass's, attributed by duration,
    plus the file's own host time. On CUDA the mel takes the bf3 power and
    the fields classify in float32 (the JAX package's accelerator route);
    on the CPU the auto route and float64."""
    dev = resolve_device(device)
    wavs, clips, rate, labels_all = load_testset(testset, max_files)
    batch = batch_clips(clips)
    cuda = dev.type == "cuda"
    pipe = WhisperMelPipeline(opts.fft_size, opts.hop_size, opts.n_mels,
                              float(rate), fft_impl="bf3" if cuda else "auto",
                              device=dev)
    classify_dtype = torch.float32 if cuda else torch.float64

    def device_pass(x):
        mel = pipe.mel_batch(x)                     # [B, F, n_mels]
        fields = streaming_decision_fields_batched(
            mel.transpose(-1, -2).to(classify_dtype), settings)
        return {k: v.cpu().numpy() for k, v in fields.items()}

    x = torch.from_numpy(batch).to(dev)
    if warmup:
        device_pass(x)
    started = time.perf_counter()
    fields_all = device_pass(x)  # ends in the host copy of the fields
    wall_total = time.perf_counter() - started

    total = Metrics()
    rows: List[FileResult] = []
    durations = [len(c) / rate for c in clips]
    dur_sum = sum(durations)
    for i, wav in enumerate(wavs):
        t0 = time.perf_counter()
        n_frames = num_frames_batch(len(clips[i]), opts.fft_size,
                                    opts.hop_size)
        # the fields were computed for the padded width; the first n_dec
        # entries read only this file's real frames
        n_dec = n_frames - settings.min_x + 1
        if n_dec <= 0:
            # shorter than the detector window: no decisions, as the
            # sequential path
            rows.append(FileResult(wav, durations[i],
                                   time.perf_counter() - t0, Metrics()))
            continue
        fields = {k: v[i] for k, v in fields_all.items()}
        times_s = decision_times_s(n_dec, settings, opts, rate)
        speech_pp = _postprocess_mask(speech_mask(fields, n_dec, opts),
                                      times_s, opts.hop_size / rate, opts)
        metrics = _metrics(speech_pp, _labels_mask(labels_all[i], times_s))
        total.merge(metrics)
        attributed = (wall_total * durations[i] / dur_sum
                      + time.perf_counter() - t0)
        rows.append(FileResult(wav, durations[i], attributed, metrics))
    return total, rows


def macro_metrics(rows: Sequence[FileResult]) -> dict:
    n = len(rows)
    agg = {"precision": 0.0, "recall": 0.0, "f1": 0.0, "accuracy": 0.0,
           "fpr": 0.0, "fnr": 0.0}
    for row in rows:
        for key in agg:
            agg[key] += getattr(row.metrics, key)
    return {k: v / n for k, v in agg.items()}


def speed_metrics(rows: Sequence[FileResult]) -> dict:
    audio = sum(r.duration_s for r in rows)
    wall = sum(r.wall_s for r in rows)
    return {
        "audio_s": audio,
        "wall_s": wall,
        "rtf": wall / audio if audio else 0.0,
        "rtfx": audio / wall if wall else 0.0,
    }
