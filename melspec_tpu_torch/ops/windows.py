"""Analysis windows, built on the host in float64 (numpy copy of
``melspec_tpu.ops.windows``):

- periodic Hann over ``fft_size``: whisper (reference ``src/stft.rs``);
- symmetric Hann over ``win_length`` centered inside ``n_fft``: NeMo
  (``src/mel.rs:708-719``), denominator ``win_length - 1``;
- Povey over the frame length: Kaldi fbank (``src/fbank.rs:98-105``),
  ``(0.5 - 0.5 cos(2 pi i / (N-1)))**0.85``.
"""

from __future__ import annotations

import numpy as np


def hann_periodic(fft_size: int) -> np.ndarray:
    """Periodic Hann window of length ``fft_size`` (float64)."""
    i = np.arange(fft_size, dtype=np.float64)
    return 0.5 * (1.0 - np.cos(2.0 * np.pi * i / fft_size))


def hann_centered(n_fft: int, win_length: int) -> np.ndarray:
    """Symmetric Hann of ``win_length`` zero-centered inside ``n_fft``
    (float64); ``win_length <= 1`` gives all zeros."""
    window = np.zeros(n_fft, dtype=np.float64)
    if win_length <= 1:
        return window
    offset = (n_fft - win_length) // 2
    i = np.arange(win_length, dtype=np.float64)
    phase = 2.0 * np.pi * i / (win_length - 1.0)
    window[offset : offset + win_length] = 0.5 - 0.5 * np.cos(phase)
    return window


def hann_centered_f32(n_fft: int, win_length: int) -> np.ndarray:
    """The reference's float32 construction of the centered Hann
    (``src/mel.rs:708-719``), ``cos`` evaluated in float32."""
    window = np.zeros(n_fft, dtype=np.float32)
    if win_length <= 1:
        return window
    offset = (n_fft - win_length) // 2
    i = np.arange(win_length, dtype=np.float32)
    phase = ((np.float32(2.0) * np.float32(np.pi) * i)
             / np.float32(win_length - 1.0))
    window[offset : offset + win_length] = (
        np.float32(0.5) - np.float32(0.5) * np.cos(phase))
    return window


def povey(frame_length: int) -> np.ndarray:
    """Povey window (Kaldi): Hamming-like but zero at the edges
    (float64)."""
    i = np.arange(frame_length, dtype=np.float64)
    a = 2.0 * np.pi * i / (frame_length - 1.0)
    return np.power(0.5 - 0.5 * np.cos(a), 0.85)
