"""Whisper log-mel, Kaldi fbank and NeMo log-mel as plain tensor code.

Each takes ``x [B, T]`` (any device) and returns the features in the
precision's dtype. The DFT is a product of the frames with cosine and
sine tables built in float64, so that the control rounds exactly where a
lower-precision program would. Callers bound the batch: the frames are
materialised."""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.precision import dtype_of, matmul

F32_EPS = float(np.finfo(np.float32).eps)


# -- windows ---------------------------------------------------------------

def hann_periodic(n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.float64)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * i / n)


def hann_symmetric(n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.float64)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * i / (n - 1))


def povey(n: int) -> np.ndarray:
    """Kaldi's window: a Hann over ``n - 1`` raised to 0.85 (zero at both
    ends)."""
    return hann_symmetric(n) ** 0.85


# -- filterbanks -------------------------------------------------------------

def _slaney_hz_to_mel(f: np.ndarray) -> np.ndarray:
    f = np.asarray(f, dtype=np.float64)
    lin = f / (200.0 / 3.0)
    log = 15.0 + np.log(np.maximum(f, 1e-300) / 1000.0) / (np.log(6.4) / 27.0)
    return np.where(f >= 1000.0, log, lin)


def _slaney_mel_to_hz(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    lin = m * (200.0 / 3.0)
    log = 1000.0 * np.exp((np.log(6.4) / 27.0) * (m - 15.0))
    return np.where(m >= 15.0, log, lin)


def slaney_filters(sr: float, n_fft: int, n_mels: int, f_min: float = 0.0,
                   f_max: float | None = None) -> np.ndarray:
    """librosa's ``filters.mel(htk=False, norm="slaney")``: triangles in Hz
    between ``n_mels + 2`` points evenly spaced on the Slaney mel scale,
    each scaled by ``2 / (right - left)``; ``[n_mels, n_fft // 2 + 1]``."""
    f_max = sr / 2.0 if f_max is None else f_max
    edges = _slaney_mel_to_hz(np.linspace(_slaney_hz_to_mel(f_min),
                                          _slaney_hz_to_mel(f_max),
                                          n_mels + 2))
    freqs = np.arange(n_fft // 2 + 1, dtype=np.float64) * sr / n_fft
    lo, mid, hi = edges[:-2, None], edges[1:-1, None], edges[2:, None]
    up = (freqs[None, :] - lo) / (mid - lo)
    down = (hi - freqs[None, :]) / (hi - mid)
    tri = np.maximum(0.0, np.minimum(up, down))
    return tri * (2.0 / (edges[2:] - edges[:-2]))[:, None]


def kaldi_filters(sr: float, n_fft: int, n_bins: int, low: float,
                  high: float) -> np.ndarray:
    """Triangles over the FFT bins' frequencies in Hz, between ``n_bins + 2``
    points evenly spaced on the mel scale ``1127 ln(1 + f / 700)``: rising
    on ``(left, centre]``, falling on ``(centre, right)``, peak 1, no area
    normalisation; ``[n_bins, n_fft // 2 + 1]``."""
    high = sr / 2.0 if high <= 0.0 else high
    mel = lambda f: 1127.0 * math.log(1.0 + f / 700.0)  # noqa: E731
    pts = np.linspace(mel(low), mel(high), n_bins + 2)
    hz = 700.0 * (np.exp(pts / 1127.0) - 1.0)
    freqs = np.arange(n_fft // 2 + 1, dtype=np.float64) * sr / n_fft
    out = np.zeros((n_bins, freqs.size))
    for m in range(n_bins):
        left, centre, right = hz[m], hz[m + 1], hz[m + 2]
        rise = (freqs > left) & (freqs <= centre)
        fall = (freqs > centre) & (freqs < right)
        out[m, rise] = (freqs[rise] - left) / (centre - left)
        out[m, fall] = (right - freqs[fall]) / (right - centre)
    return out


# -- the spectral core -----------------------------------------------------

def dft_tables(n_fft: int, taps: int, first_tap: int, n_bins: int,
               window: np.ndarray) -> tuple:
    """Windowed cosine and sine tables ``[taps, n_bins]`` (float64) of an
    ``n_fft``-point DFT whose frame holds ``taps`` samples starting at
    position ``first_tap`` (zero elsewhere)."""
    n = np.arange(first_tap, first_tap + taps, dtype=np.float64)[:, None]
    k = np.arange(n_bins, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * ((n * k) % n_fft) / n_fft
    return window[:, None] * np.cos(ang), window[:, None] * np.sin(ang)


def power(frames: torch.Tensor, tables: tuple, precision: str
          ) -> torch.Tensor:
    dev = frames.device
    cos_t, sin_t = (torch.as_tensor(t, device=dev) for t in tables)
    re = matmul(frames, cos_t, precision)
    im = matmul(frames, sin_t, precision)
    return re * re + im * im


def frames_of(x: torch.Tensor, size: int, hop: int, n_frames: int,
              offset: int = 0) -> torch.Tensor:
    end = offset + (n_frames - 1) * hop + size
    if x.shape[-1] < end:
        raise ValueError(f"signal of {x.shape[-1]} samples, need {end}")
    return x[..., offset:end].unfold(-1, size, hop)


# -- the three frontends ---------------------------------------------------

def whisper_log_mel(x: torch.Tensor, fft: int, hop: int, n_mels: int,
                    sr: float, precision: str, offset: int = 0,
                    n_frames: int | None = None) -> torch.Tensor:
    """Frames of ``fft`` samples every ``hop`` from ``offset``, periodic
    Hann, power of DFT bins ``0 .. fft/2 - 1`` (the Nyquist bin has no
    weight), Slaney filters, ``log10(max(e, 1e-10))``, then per frame
    ``(max(v, max_frame - 8) + 4) / 4``; ``[B, F, n_mels]``."""
    dt = dtype_of(precision)
    if n_frames is None:
        n_frames = (x.shape[-1] - offset - fft) // hop + 1
    half = fft // 2
    fr = frames_of(x.to(dt), fft, hop, n_frames, offset)
    p = power(fr, dft_tables(fft, fft, 0, half, hann_periodic(fft)),
              precision)
    filt = torch.as_tensor(slaney_filters(sr, fft, n_mels)[:, :half].T,
                           device=x.device)
    logm = torch.log10(torch.clamp_min(matmul(p, filt, precision), 1e-10))
    top = logm.amax(dim=-1, keepdim=True)
    return (torch.maximum(logm, top - 8.0) + 4.0) / 4.0


def kaldi_fbank(x: torch.Tensor, cfg: dict, precision: str) -> torch.Tensor:
    """Kaldi's ``compute-fbank-feats`` with ``snip_edges``: frames of
    ``frame_length`` samples every ``frame_shift``; the frame's mean
    removed; preemphasis ``y[i] = d[i] - p d[i-1]``, ``y[0] = (1 - p)
    d[0]`` (the Povey window is 0 at 0, so the first sample carries no
    weight); Povey window; power over the ``fft_size // 2 + 1`` bins of the
    zero-padded frame; the triangles of ``kaldi_filters``; ``ln(max(e,
    float32 eps))``; with ``apply_cmn`` the mean over the clip's frames
    subtracted; ``[B, F, n_bins]``."""
    dt = dtype_of(precision)
    sr = float(cfg["sample_rate"])
    flen = int(round(cfg["frame_length_ms"] * sr / 1000.0))
    shift = int(round(cfg["frame_shift_ms"] * sr / 1000.0))
    n_fft = 1 << (flen - 1).bit_length()
    n_frames = (x.shape[-1] - flen) // shift + 1
    fr = frames_of(x.to(dt), flen, shift, n_frames)
    d = fr - fr.mean(dim=-1, keepdim=True)
    p = float(cfg["preemphasis"])
    if p > 0.0:
        d = torch.cat([d[..., :1] * (1.0 - p), d[..., 1:] - p * d[..., :-1]],
                      dim=-1)
    pw = power(d, dft_tables(n_fft, flen, 0, n_fft // 2 + 1, povey(flen)),
               precision)
    filt = torch.as_tensor(kaldi_filters(sr, n_fft, cfg["num_mel_bins"],
                                         cfg["low_freq"], cfg["high_freq"]).T,
                           device=x.device)
    feats = torch.log(torch.clamp_min(matmul(pw, filt, precision), F32_EPS))
    if cfg["apply_cmn"]:
        feats = feats - feats.mean(dim=-2, keepdim=True)
    return feats


def nemo_log_mel(x: torch.Tensor, cfg: dict, precision: str) -> torch.Tensor:
    """NeMo's ``AudioToMelSpectrogramPreprocessor``: preemphasis over the
    wave (``y[0] = x[0]``), ``n_fft // 2`` zeros on both sides, ``T // hop
    + 1`` frames of ``n_fft``, a symmetric Hann of ``win_length`` centred in
    the frame, power over ``n_fft // 2 + 1`` bins, Slaney filters, ``ln(e +
    guard)``, and with ``normalize == "per_feature"`` each feature's mean
    over the frames removed and divided by its standard deviation (``n -
    1`` in the denominator) plus 1e-5; ``[B, n_mels, F]``."""
    dt = dtype_of(precision)
    n_fft, win, hop = cfg["n_fft"], cfg["win_length"], cfg["hop_length"]
    x = x.to(dt)
    p = float(cfg["preemphasis"])
    if p:
        x = torch.cat([x[..., :1], x[..., 1:] - p * x[..., :-1]], dim=-1)
    n_frames = x.shape[-1] // hop + 1
    x = torch.nn.functional.pad(x, (n_fft // 2, n_fft // 2))
    first = (n_fft - win) // 2
    fr = frames_of(x, win, hop, n_frames, offset=first)
    pw = power(fr, dft_tables(n_fft, win, first, n_fft // 2 + 1,
                              hann_symmetric(win)), precision)
    filt = torch.as_tensor(slaney_filters(float(cfg["sample_rate"]), n_fft,
                                          cfg["n_mels"], cfg["f_min"],
                                          cfg["f_max"]).T, device=x.device)
    feats = torch.log(matmul(pw, filt, precision)
                      + float(cfg["log_zero_guard"])).transpose(-1, -2)
    if cfg["normalize"] == "per_feature":
        mean = feats.mean(dim=-1, keepdim=True)
        var = ((feats - mean) ** 2).sum(dim=-1, keepdim=True) / max(
            n_frames - 1, 1)
        feats = (feats - mean) / (torch.sqrt(var) + 1e-5)
    return feats
