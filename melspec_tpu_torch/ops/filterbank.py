"""Mel filterbanks, built on the host in float64 (numpy copy of
``melspec_tpu.ops.filterbank``): Slaney/HTK (whisper, NeMo; within 1e-7
of librosa and of the whisper GGML filters,
``testdata/filterbanks_golden.npz``) and Kaldi's."""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np


def hz_to_mel(frequency: float, htk: bool = False) -> float:
    """Hz -> mel, Slaney (librosa default) or HTK variant."""
    if htk:
        return 2595.0 * np.log10(1.0 + frequency / 700.0)

    f_min = 0.0
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0

    if frequency >= min_log_hz:
        return min_log_mel + np.log(frequency / min_log_hz) / logstep
    return (frequency - f_min) / f_sp


def mel_to_hz(mel: float, htk: bool = False) -> float:
    """Mel -> Hz, Slaney or HTK variant."""
    if htk:
        return 700.0 * (10.0 ** (mel / 2595.0) - 1.0)

    f_min = 0.0
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0

    if mel >= min_log_mel:
        return min_log_hz * np.exp(logstep * (mel - min_log_mel))
    return f_min + f_sp * mel


def mels_to_hz(mels: np.ndarray, htk: bool = False) -> np.ndarray:
    """Vectorized mel -> Hz."""
    mels = np.asarray(mels, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    linear = f_sp * mels
    log = min_log_hz * np.exp(logstep * (mels - min_log_mel))
    return np.where(mels >= min_log_mel, log, linear)


def mel_frequencies(
    n_mels: int, fmin: float, fmax: float, htk: bool = False
) -> np.ndarray:
    """``n_mels`` frequencies evenly spaced on the mel scale."""
    min_mel = hz_to_mel(fmin, htk)
    max_mel = hz_to_mel(fmax, htk)
    mels = np.linspace(min_mel, max_mel, n_mels)
    return mels_to_hz(mels, htk)


def fft_frequencies(sr: float, n_fft: int) -> np.ndarray:
    """Center frequency of each rFFT bin."""
    step = sr / n_fft
    return step * np.arange(n_fft // 2 + 1, dtype=np.float64)


def mel_filterbank(
    sr: float,
    n_fft: int,
    n_mels: int,
    f_min: Optional[float] = None,
    f_max: Optional[float] = None,
    htk: bool = False,
    norm: bool = True,
) -> np.ndarray:
    """Slaney-style triangular mel filterbank ``[n_mels, n_fft//2+1]``
    (float64)."""
    fftfreqs = fft_frequencies(sr, n_fft)
    f_min = 0.0 if f_min is None else f_min
    f_max = sr / 2.0 if f_max is None else f_max
    mel_f = mel_frequencies(n_mels + 2, f_min, f_max, htk)

    fdiff = mel_f[1:] - mel_f[:-1]  # [n_mels+1]
    ramps = mel_f[:, None] - fftfreqs[None, :]  # [n_mels+2, bins]

    lower = -ramps[:n_mels] / fdiff[:n_mels, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.minimum(np.clip(lower, 0.0, 1.0), np.clip(upper, 0.0, 1.0))

    if norm:
        # Slaney normalization: approx constant energy per channel.
        enorm = 2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels])
        weights = weights * enorm[:, None]

    return weights


# the reference's name for the whisper filterbank (``mel`` in JAX's
# ``ops/filterbank.py``)
mel = mel_filterbank


def kaldi_hz_to_mel(hz: float) -> float:
    """Kaldi mel scale ``1127 ln(1 + hz/700)`` (``src/fbank.rs:303-307``)."""
    return 1127.0 * np.log(1.0 + hz / 700.0)


def kaldi_mel_to_hz(mel: float) -> float:
    """Inverse Kaldi mel scale (``src/fbank.rs:309-313``)."""
    return 700.0 * (np.exp(mel / 1127.0) - 1.0)


def kaldi_filterbank(
    sample_rate: float,
    fft_size: int,
    num_mel_bins: int,
    low_freq: float = 20.0,
    high_freq: float = 0.0,
) -> np.ndarray:
    """Kaldi-style mel filterbank ``[num_mel_bins, fft_size//2+1]``
    (float64): not area-normalized, rising edge on ``(left, center]``,
    falling on ``(center, right)`` (``src/fbank.rs:249-301``)."""
    if high_freq == 0.0:
        high_freq = sample_rate / 2.0
    num_fft_bins = fft_size // 2 + 1

    mel_low = kaldi_hz_to_mel(low_freq)
    mel_high = kaldi_hz_to_mel(high_freq)
    mel_points = mel_low + (mel_high - mel_low) * np.arange(
        num_mel_bins + 2, dtype=np.float64
    ) / (num_mel_bins + 1)
    hz_points = 700.0 * (np.exp(mel_points / 1127.0) - 1.0)

    freqs = np.arange(num_fft_bins, dtype=np.float64) * sample_rate / fft_size
    filters = np.zeros((num_mel_bins, num_fft_bins), dtype=np.float64)

    for m in range(num_mel_bins):
        left, center, right = hz_points[m], hz_points[m + 1], hz_points[m + 2]
        if center <= left or right <= center:
            continue  # degenerate filter
        rising = (freqs > left) & (freqs <= center)
        falling = (freqs > center) & (freqs < right)
        filters[m, rising] = (freqs[rising] - left) / (center - left)
        filters[m, falling] = (right - freqs[falling]) / (right - center)

    return filters


@dataclasses.dataclass(frozen=True)
class SparseFilterbankView:
    """Introspection view over a dense filterbank, the reference's
    ``SparseMelFilterbank`` metadata (``src/mel.rs:41-104``): nonzero
    ``(bin, weight)`` pairs per mel row. Compute always uses the dense
    matrix."""

    rows: Tuple[Tuple[Tuple[int, float], ...], ...]
    fft_bins: int

    @classmethod
    def from_dense(cls, filters: np.ndarray) -> "SparseFilterbankView":
        filters = np.asarray(filters)
        rows: List[Tuple[Tuple[int, float], ...]] = []
        for row in filters:
            nz = np.nonzero(row != 0.0)[0]
            rows.append(tuple((int(b), float(row[b])) for b in nz))
        return cls(rows=tuple(rows), fft_bins=int(filters.shape[1]))

    @property
    def n_mels(self) -> int:
        return len(self.rows)

    @property
    def non_zero_weights(self) -> int:
        return sum(len(r) for r in self.rows)

    @property
    def dense_weights(self) -> int:
        return self.n_mels * self.fft_bins

    def weights_for_mel(self, mel_idx: int) -> Tuple[Tuple[int, float], ...]:
        return self.rows[mel_idx]

