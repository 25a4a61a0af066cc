"""Whisper-compatible batched log-mel spectrogram (port of
``melspec_tpu.ops.spectrogram``).

    frames -> window -> real DFT -> power -> filterbank -> log10
    -> whisper norm

Semantics kept from the reference: periodic Hann window; the projection
zeroes FFT bins >= fft_size/2; ``log10(max(energy, 1e-10))``; whisper norm
``(max(x, max-8)+4)/4`` with the max taken per frame.

``WhisperMelPipeline(fft_impl=...)``: ``"sig"`` runs kernel K1 (framing,
bf16 slice-pair DFT, projection, log and norm in one launch per batch
chunk); ``"rdft"`` (DFT as f32/f64 matmuls), ``"fft"``
(``torch.fft.rfft``), ``"hp"`` (the exact integer Ozaki split) and
``"bf3"`` (rounded-bf16 slice pairs; both ``ops/hp_dft.py``) run as plain
PyTorch. ``"auto"`` picks ``"fft"`` on the CPU and, on CUDA, ``"sig"``
where K1 takes the config (``auto_fft_impl``), else ``"bf3"``, as the JAX
package picks by backend.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from melspec_tpu_torch._device import resolve_device
from melspec_tpu_torch.kernels.sig_mel import k1_accepts
from melspec_tpu_torch.ops import dft, framing
from melspec_tpu_torch.ops.fastmath import log10_best
from melspec_tpu_torch.ops.filterbank import mel_filterbank
from melspec_tpu_torch.ops.hp_dft import bf3_rdft_power, hp_rdft_power
from melspec_tpu_torch.ops.mel_kernel import (sig_geometry, whisper_head,
                                              whisper_mel_sig)
from melspec_tpu_torch.ops.windows import hann_periodic

LOG10_FLOOR = 1e-10


def _frames_budget_bytes() -> int:
    """Device-memory budget for the materialized frames tensor."""
    return int(os.environ.get("MELSPEC_FRAMES_BUDGET_BYTES", 1 << 30))


def _sig_budget_bytes() -> int:
    """Budget for K1's real footprint: the input signal and the
    final-layout output (it materializes no frames tensor)."""
    return int(os.environ.get("MELSPEC_SIG_BUDGET_BYTES", 8 << 30))


def whisper_norm(log_mel: torch.Tensor, axis=None) -> torch.Tensor:
    """Whisper dynamic-range normalization ``(max(x, max-8)+4)/4``;
    ``axis=None`` over the whole array, else per slice along ``axis``."""
    if axis is None:
        mmax = log_mel.max() - 8.0
    else:
        mmax = log_mel.amax(dim=axis, keepdim=True) - 8.0
    return (torch.maximum(log_mel, mmax) + 4.0) / 4.0


def norm_mel(mel_spec) -> torch.Tensor:
    """Global-max whisper norm (reference ``norm_mel``)."""
    return whisper_norm(torch.as_tensor(mel_spec))


def norm_mel_vec(mel_spec) -> np.ndarray:
    """Float32 host variant (reference ``norm_mel_vec``): the global-max
    whisper norm as a numpy array."""
    return whisper_norm(torch.as_tensor(
        np.asarray(mel_spec, dtype=np.float32))).numpy()


def log_mel_spectrogram(fft_frame, mel_filters) -> np.ndarray:
    """One complex FFT frame through a dense filterbank: ``[n_mels, 1]`` of
    ``log10(max(energy, 1e-10))`` with bins >= ``len(fft)/2`` zeroed
    (host float64)."""
    fft_frame = np.asarray(fft_frame)
    mel_filters = np.asarray(mel_filters, dtype=np.float64)
    half = fft_frame.shape[-1] // 2
    power = np.abs(fft_frame[..., :half]) ** 2
    energy = mel_filters[:, :half] @ power
    return np.log10(np.maximum(energy, LOG10_FLOOR))[:, None]


def stft_frames(samples, fft_size: int, hop_size: int) -> np.ndarray:
    """Batch STFT returning raw complex FFT frames ``[n_frames, fft_size]``
    (the analogue of ``Spectrogram::compute_all_cpu``,
    ``src/stft.rs:89-115``): periodic Hann window, frame k starting at
    ``k*hop``, ``np.fft.fft`` of each. Host float64, complex128 ``(0,
    fft_size)`` where no frame fits; for feature pipelines use the device
    paths."""
    samples = np.asarray(samples, dtype=np.float64)
    nf = framing.num_frames_batch(len(samples), fft_size, hop_size)
    if nf <= 0:
        return np.zeros((0, fft_size), dtype=np.complex128)
    window = hann_periodic(fft_size)
    idx = np.arange(nf)[:, None] * hop_size + np.arange(fft_size)
    return np.fft.fft(samples[idx] * window, axis=-1)


class MelProjection:
    """Stateful FFT-frame -> normalized mel column projector (reference
    ``MelSpectrogram``): whisper norm per frame, host float64."""

    def __init__(self, fft_size: int, sampling_rate: float, n_mels: int):
        self.fft_size = fft_size
        self.filters = mel_filterbank(sampling_rate, fft_size, n_mels)

    def add(self, fft_frame) -> np.ndarray:
        log_mel = log_mel_spectrogram(fft_frame, self.filters)
        mmax = log_mel.max() - 8.0
        return (np.maximum(log_mel, mmax) + 4.0) / 4.0


def log_mel_from_power(power: torch.Tensor, filters_t: torch.Tensor,
                       dtype=torch.float32) -> torch.Tensor:
    """``log10(max(power @ filters_t, 1e-10))``; ``filters_t`` is
    ``[n_used_bins, n_mels]``."""
    energy = power.to(dtype) @ filters_t.to(dtype)
    return log10_best(torch.clamp_min(energy, LOG10_FLOOR), dtype)


def auto_fft_impl(fft_size: int, hop_size: int, n_mels: int,
                  sampling_rate: float, dtype, device) -> str:
    """``fft_impl="auto"`` on ``device``: ``"fft"`` on the CPU; on CUDA
    ``"sig"`` where the macro-row geometry applies, the dtype is float32
    and K1 takes the config's head (``k1_accepts``: 256, 512, 1024 or 2048
    DFT columns, a span within a block's shared memory in 128-, 64- or
    32-frame blocks, or the factored path's tables at the wide hops), else
    ``"bf3"``. The
    head is built on the CPU; no kernel runs."""
    if torch.device(device).type != "cuda":
        return "fft"
    off = framing.streaming_frame_offset(fft_size, hop_size)
    if sig_geometry(fft_size, hop_size, off) is None \
            or dtype != torch.float32:
        return "bf3"
    head = whisper_head(fft_size, n_mels, float(sampling_rate),
                        torch.device("cpu"))
    return "sig" if k1_accepts(head, hop=hop_size) else "bf3"


class WhisperMelPipeline:
    """Whisper log-mel frontend for one (fft, hop, n_mels, sr) config on
    one device.

    - ``mel_batch(samples)``: batch framing (frame k starts at ``k*hop``),
      ``[T]`` / ``[B, T]`` -> ``[n_frames, n_mels]`` /
      ``[B, n_frames, n_mels]``;
    - ``mel_streaming_equivalent(samples)``: the reference's streaming
      ring-buffer output (frames offset by ``ceil(fft/hop)*hop - fft``),
      feature-major ``[..., n_mels, n_frames]``.

    ``hp_n_slices`` / ``hp_max_pair_sum`` set the ``"hp"`` route's slice
    schedule. ``device=None`` means CUDA and raises where there is none.
    """

    def __init__(
        self,
        fft_size: int = 400,
        hop_size: int = 160,
        n_mels: int = 80,
        sampling_rate: float = 16000.0,
        dtype=torch.float32,
        fft_impl: str = "auto",
        device=None,
        hp_n_slices: int = 5,
        hp_max_pair_sum: int = 5,
    ):
        self.device = resolve_device(device)
        off = framing.streaming_frame_offset(fft_size, hop_size)
        if fft_impl == "auto":
            fft_impl = auto_fft_impl(fft_size, hop_size, n_mels,
                                     sampling_rate, dtype, self.device)
        if fft_impl not in ("rdft", "fft", "hp", "bf3", "sig"):
            raise ValueError(
                "fft_impl must be 'auto', 'rdft', 'fft', 'hp', 'bf3' or 'sig'"
            )
        if fft_impl == "sig":
            if sig_geometry(fft_size, hop_size, off) is None:
                raise ValueError(
                    "fft_impl='sig': no macro-row geometry for this "
                    "(fft, hop) — every standard speech config qualifies"
                )
            if dtype != torch.float32:
                raise ValueError("fft_impl='sig' is float32-only")
        self.hp_n_slices = hp_n_slices
        self.hp_max_pair_sum = hp_max_pair_sum
        self.fft_size = fft_size
        self.hop_size = hop_size
        self.n_mels = n_mels
        self.sampling_rate = sampling_rate
        self.dtype = dtype
        self.fft_impl = fft_impl

        self.half = fft_size // 2  # bins >= half are zeroed by the projection
        filters = mel_filterbank(sampling_rate, fft_size, n_mels)
        self._filters_np = filters
        self.filters_t = torch.as_tensor(filters[:, : self.half].T,
                                         dtype=dtype, device=self.device)
        self.window = torch.as_tensor(hann_periodic(fft_size), dtype=dtype,
                                      device=self.device)

    @property
    def filters(self) -> np.ndarray:
        """Dense float64 filterbank ``[n_mels, fft//2+1]``."""
        return self._filters_np

    def _power(self, frames: torch.Tensor) -> torch.Tensor:
        if self.fft_impl == "hp":
            # window folded into the sliced matrices (exact signal path)
            return hp_rdft_power(
                frames.to(torch.float32), self.fft_size, self.half,
                n_slices=self.hp_n_slices,
                max_pair_sum=self.hp_max_pair_sum, hann_windowed=True)
        if self.fft_impl == "bf3":
            return bf3_rdft_power(frames.to(torch.float32), self.fft_size,
                                  self.half, hann_windowed=True)
        xw = frames.to(self.dtype) * self.window
        if self.fft_impl == "rdft":
            return dft.rdft_power(xw, self.fft_size, self.half,
                                  dtype=self.dtype)
        spec = torch.fft.rfft(xw, dim=-1)[..., : self.half]
        return (spec.real ** 2 + spec.imag ** 2).to(self.dtype)

    def _log_mel_frames(self, frames: torch.Tensor) -> torch.Tensor:
        return log_mel_from_power(self._power(frames), self.filters_t,
                                  self.dtype)

    def _sig_mel(self, samples: torch.Tensor, streaming: bool) -> torch.Tensor:
        lead = samples.shape[:-1]
        x2 = samples.reshape((-1, samples.shape[-1])).to(torch.float32)
        out = whisper_mel_sig(
            x2, self.fft_size, self.hop_size, self.n_mels,
            self.sampling_rate, streaming=streaming, device=self.device,
        )
        return out.reshape(lead + out.shape[1:])

    def _mel_batch_one(self, samples: torch.Tensor) -> torch.Tensor:
        if self.fft_impl == "sig":
            return self._sig_mel(samples, streaming=False)
        nf = framing.num_frames_batch(samples.shape[-1], self.fft_size,
                                      self.hop_size)
        frames = framing.frame_signal(samples, self.fft_size, self.hop_size,
                                      nf)
        return whisper_norm(self._log_mel_frames(frames), axis=-1)

    def _as_input(self, samples) -> torch.Tensor:
        x = torch.as_tensor(samples, device=self.device)
        if not x.is_floating_point():
            x = x.to(self.dtype)
        return x

    def mel_batch(self, samples) -> torch.Tensor:
        """Whisper log-mel, batch framing. ``samples`` ``[T]`` or
        ``[B, T]`` -> ``[n_frames, n_mels]`` / ``[B, n_frames, n_mels]``.

        Large inputs run in budget-sized chunks: over the batch where one
        clip fits the budget, else over time at frame boundaries (chunks
        overlap by ``fft - hop`` samples and their outputs concatenate
        exactly). The budget is the frames tensor for the plain routes
        (``MELSPEC_FRAMES_BUDGET_BYTES``, default 1 GiB) and the input +
        output footprint for ``"sig"`` (``MELSPEC_SIG_BUDGET_BYTES``,
        default 8 GiB). With ``"sig"`` each chunk is one K1 launch."""
        samples = self._as_input(samples)
        nf = framing.num_frames_batch(samples.shape[-1], self.fft_size,
                                      self.hop_size)
        if nf == 0:
            return torch.zeros(samples.shape[:-1] + (0, self.n_mels),
                               dtype=self.dtype, device=self.device)
        k_pad = -(-self.fft_size // 128) * 128
        if self.fft_impl == "sig":
            budget = _sig_budget_bytes()
            per_clip = (samples.shape[-1] + nf * self.n_mels) * 4
        else:
            budget = _frames_budget_bytes()
            per_clip = nf * k_pad * 4
        b = samples.shape[0] if samples.dim() > 1 else 1
        if b * per_clip <= budget:
            return self._mel_batch_one(samples)
        if samples.dim() > 1 and per_clip <= budget:
            cb = max(1, int(budget // per_clip))
            out = torch.empty((b, nf, self.n_mels), dtype=self.dtype,
                              device=self.device)
            for i in range(0, b, cb):
                out[i : i + cb] = self._mel_batch_one(samples[i : i + cb])
            return out
        per_frame = ((self.hop_size + self.n_mels) * 4
                     if self.fft_impl == "sig" else k_pad * 4)
        cf = max(1, int(budget // per_frame))
        squeeze = samples.dim() == 1
        x = samples[None] if squeeze else samples
        outs = []
        for f0 in range(0, nf, cf):
            f1 = min(f0 + cf, nf)
            s0 = f0 * self.hop_size
            s1 = (f1 - 1) * self.hop_size + self.fft_size
            outs.append(self._mel_batch_one(x[:, s0:s1]))
        out = torch.cat(outs, dim=-2)
        return out[0] if squeeze else out

    def mel_streaming_equivalent(self, samples) -> torch.Tensor:
        """Whisper log-mel matching the streaming ring-buffer path;
        feature-major ``[..., n_mels, n_frames]``."""
        samples = self._as_input(samples)
        n = samples.shape[-1]
        nf = framing.num_frames_streaming(n, self.fft_size, self.hop_size)
        if nf == 0:
            return torch.zeros(samples.shape[:-1] + (self.n_mels, 0),
                               dtype=self.dtype, device=self.device)
        if self.fft_impl == "sig":
            return self._sig_mel(samples, streaming=True).transpose(-1, -2)
        offset = framing.streaming_frame_offset(self.fft_size, self.hop_size)
        usable = (n // self.hop_size) * self.hop_size
        frames = framing.frame_signal(samples[..., :usable], self.fft_size,
                                      self.hop_size, nf, offset=offset)
        normed = whisper_norm(self._log_mel_frames(frames), axis=-1)
        return normed.transpose(-1, -2)


@functools.lru_cache(maxsize=16)
def _cached_pipeline(fft_size: int, hop_size: int, n_mels: int,
                     sampling_rate: float, dtype: torch.dtype, fft_impl: str,
                     device: torch.device) -> WhisperMelPipeline:
    return WhisperMelPipeline(fft_size, hop_size, n_mels, sampling_rate,
                              dtype=dtype, fft_impl=fft_impl, device=device)


def compute_mel_spectrogram(samples, fft_size: int, hop_size: int,
                            n_mels: int, sampling_rate: float,
                            dtype=torch.float32, fft_impl: str = "auto",
                            device=None) -> np.ndarray:
    """Reference ``compute_mel_spectrogram_cpu``: ``[n_frames, n_mels]``
    float32 numpy, one whisper-normalized row per frame."""
    pipe = _cached_pipeline(fft_size, hop_size, n_mels, float(sampling_rate),
                            dtype, fft_impl, resolve_device(device))
    return pipe.mel_batch(samples).cpu().numpy().astype(np.float32)


def compute_streaming_mel(samples, fft_size: int, hop_size: int, n_mels: int,
                          sampling_rate: float, dtype=torch.float32,
                          fft_impl: str = "auto", device=None) -> np.ndarray:
    """The reference's streaming ring-buffer -> mel pipeline output,
    ``[n_mels, n_frames]`` float32 numpy."""
    pipe = _cached_pipeline(fft_size, hop_size, n_mels, float(sampling_rate),
                            dtype, fft_impl, resolve_device(device))
    return (pipe.mel_streaming_equivalent(samples).cpu().numpy()
            .astype(np.float32))
