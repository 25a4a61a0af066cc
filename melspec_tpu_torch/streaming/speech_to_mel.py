"""SpeechToMel: the embeddable streaming speech-frontend service (port of
``melspec_tpu.streaming.speech_to_mel``; reference ``src/wasm.rs:10-146``).

One object composing STFT + mel + VAD + 8-bit quantization for host
applications (websocket services, audio workers, RPC frontends):

- a full-resolution mel projection for output and a quarter-resolution
  one (``n_mels // 4`` filters) for the VAD (``src/wasm.rs:72-74``), as
  plain PyTorch on ``device`` (``None``: CUDA) in full float32 or float64;
- ``add(samples, vad=True)`` accumulates PCM to hop size and, once the
  overlap window fills, returns the reference's result object
  (``src/wasm.rs:95-145``): ``{ok, len, frame (uint8), min, max, idx, ms,
  va}``;
- ``frame`` is the *unnormalized* log10 mel column, quantized (the
  normalized quarter-resolution mel feeds only the VAD, which runs on the
  host in float64).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from melspec_tpu_torch._device import full_f32, resolve_device, to_host
from melspec_tpu_torch.config import DetectionSettings
from melspec_tpu_torch.ops import dft
from melspec_tpu_torch.ops.filterbank import mel_filterbank
from melspec_tpu_torch.ops.quant import quantize
from melspec_tpu_torch.ops.spectrogram import log_mel_from_power, whisper_norm
from melspec_tpu_torch.ops.windows import hann_periodic
from melspec_tpu_torch.streaming.vad import VoiceActivityDetector
from melspec_tpu_torch.utils.timing import duration_ms_for_n_frames


class SpeechToMel:
    def __init__(
        self,
        fft_size: int = 400,
        hop_size: int = 160,
        sampling_rate: float = 16000.0,
        n_mels: int = 80,
        settings: DetectionSettings = DetectionSettings(
            min_energy=1.0, min_y=3, min_x=3, min_mel=0
        ),
        dtype=torch.float32,
        device=None,
    ):
        self.device = resolve_device(device)
        self.fft_size = fft_size
        self.hop_size = hop_size
        self.sampling_rate = sampling_rate
        self.n_mels = n_mels
        self.dtype = dtype

        half = fft_size // 2
        filters = mel_filterbank(sampling_rate, fft_size, n_mels)
        filters_vad = mel_filterbank(sampling_rate, fft_size, n_mels // 4)

        def dev(a):
            return torch.as_tensor(a, dtype=dtype, device=self.device)

        self._filters_t = dev(filters[:, :half].T)
        self._filters_vad_t = dev(filters_vad[:, :half].T)
        self._window = dev(hann_periodic(fft_size))
        cos_m, msin_m = dft.rdft_matrices(fft_size, half)
        self._cos = dev(cos_m)
        self._msin = dev(msin_m)

        self._vad = VoiceActivityDetector(settings)
        self._hop_buf = np.zeros(fft_size, dtype=np.float32)
        self._seen = 0
        self._accumulated = np.zeros(0, dtype=np.float32)
        self._idx = 0

    def _step(self, buf: np.ndarray, with_vad: bool) -> tuple:
        """Log10 mel of one window (and the normalized quarter-resolution
        mel for the VAD), fetched in one device-to-host transfer."""
        xw = torch.as_tensor(buf, device=self.device).to(self.dtype) \
            * self._window
        with full_f32():
            re = xw @ self._cos
            im = xw @ self._msin
            power = re * re + im * im
            out = (log_mel_from_power(power, self._filters_t, self.dtype),)
            if with_vad:
                # the quarter-filterbank projection is dead work when the
                # caller disabled the VAD for this frame
                log_vad = log_mel_from_power(power, self._filters_vad_t,
                                             self.dtype)
                out += (whisper_norm(log_vad),)
        return to_host(*out)

    @property
    def pending(self) -> int:
        """Complete hops already buffered, each consumable by one
        ``get()`` call. Each call emits at most ONE frame, as in the
        reference's wasm binding; services pushing blocks larger than
        hop_size drain the backlog with ``while s.pending: s.get()``."""
        return int(self._accumulated.size) // self.hop_size

    def add(self, samples: np.ndarray, vad: bool = True) -> Dict:
        """Push PCM samples; returns the reference's result object with
        ``ok=False`` until a full hop and window are available. One hop is
        consumed per call (``src/wasm.rs:95-145``)."""
        result: Dict = {"ok": False}
        self._accumulated = np.concatenate(
            [self._accumulated, np.asarray(samples, np.float32)])
        if self._accumulated.size < self.hop_size:
            return result

        chunk = self._accumulated[: self.hop_size]
        self._accumulated = self._accumulated[self.hop_size:]
        result["len"] = int(chunk.size)

        self._hop_buf = np.concatenate([self._hop_buf[self.hop_size:], chunk])
        self._seen += chunk.size
        if self._seen >= self.fft_size:
            out = self._step(self._hop_buf, vad)
            quantized, qr = quantize(np.asarray(out[0], np.float32))
            result.update(
                ok=True,
                frame=quantized,
                min=qr.min,
                max=qr.max,
                idx=self._idx,
                ms=duration_ms_for_n_frames(
                    self.hop_size, self.sampling_rate, self._idx),
            )
            if vad:
                decision = self._vad.add(np.asarray(out[1], np.float64))
                if decision is not None:
                    result["va"] = decision
        self._idx += 1  # the reference advances idx per consumed hop
        return result

    def get(self, vad: bool = True) -> Dict:
        """Flush call with no new samples (reference ``src/wasm.rs:88-92``);
        ``vad`` defaults to True so drained frames keep feeding the
        detector's sliding window."""
        return self.add(np.zeros(0, dtype=np.float32), vad=vad)
