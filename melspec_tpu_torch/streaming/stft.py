"""Streaming overlap-and-save STFT with explicit carried state (port of
``melspec_tpu.streaming.stft``).

The state is ``StftState(hop_buf [fft], idx)``, threaded through pure
functions: one hop at a time (``push``, live audio) or many hops at once
(``push_many``, catch-up). Emission follows the reference's
``Spectrogram`` (``src/stft.rs:48-86``):

- a pushed chunk must be <= hop_size and is zero-padded up to it;
- the hop buffer shifts left by hop and the chunk lands at the end;
- a frame is emitted once ``idx >= fft_size``, so the first emitted frame
  covers samples ``[ceil(fft/hop)*hop - fft, ceil(fft/hop)*hop)`` with the
  front zero-filled, which is what the JFK golden encodes.

``StreamingMel`` runs as plain PyTorch on its device, as the JAX package
runs it outside any Pallas kernel: the real DFT as two matrix products
with the f64-built cos / -sin matrices, power, the filterbank product (all
in full float32 or float64, ``_device.full_f32``), ``log10_best`` and the
whisper norm per frame. ``StreamingStft`` is host numpy float64.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from melspec_tpu_torch._device import full_f32, resolve_device, to_host
from melspec_tpu_torch.config import MelConfig
from melspec_tpu_torch.ops import dft, framing
from melspec_tpu_torch.ops.fastmath import log10_best
from melspec_tpu_torch.ops.filterbank import mel_filterbank
from melspec_tpu_torch.ops.spectrogram import LOG10_FLOOR, whisper_norm
from melspec_tpu_torch.ops.windows import hann_periodic


class StftState(NamedTuple):
    """Carried streaming state; serializable with ``save_state``."""

    hop_buf: torch.Tensor  # [fft_size] samples, newest at the end
    idx: torch.Tensor      # scalar int64: samples pushed, saturating at fft


def state_from_arrays(hop_buf, idx, device=None) -> StftState:
    """``StftState`` on ``device`` (``None``: CUDA) from host arrays, as
    ``save_state`` of either package writes them: ``hop_buf`` keeps float64
    (else float32), ``idx`` (int32 or int64) becomes int64."""
    dev = resolve_device(device)
    buf = np.asarray(hop_buf)
    dtype = torch.float64 if buf.dtype == np.float64 else torch.float32
    return StftState(torch.tensor(buf, dtype=dtype, device=dev),
                     torch.tensor(int(np.asarray(idx)), dtype=torch.int64,
                                  device=dev))


def save_state(state: StftState, path) -> None:
    """Checkpoint streaming state to an ``.npz`` file (keys ``hop_buf``,
    ``idx``, as the JAX package writes them)."""
    hop_buf, idx = to_host(state.hop_buf, state.idx)
    np.savez(path, hop_buf=hop_buf, idx=idx)


def load_state(path, device=None) -> StftState:
    """Resume streaming state from a ``save_state`` file of either
    package, on ``device`` (``None``: CUDA)."""
    with np.load(path) as z:
        return state_from_arrays(z["hop_buf"], z["idx"], device)


class StreamingStft:
    """Overlap-and-save STFT emitting raw complex FFT frames (reference
    ``Spectrogram``, ``src/stft.rs:24-86``), host numpy float64."""

    def __init__(self, fft_size: int, hop_size: int):
        self.fft_size = fft_size
        self.hop_size = hop_size
        self._window = hann_periodic(fft_size)
        self._hop_buf = np.zeros(fft_size, dtype=np.float64)
        self._idx = 0

    def add(self, chunk: np.ndarray):
        """Push <= hop_size samples; returns the full-size complex FFT of
        the windowed buffer once ``fft_size`` samples have been seen."""
        chunk = np.asarray(chunk, dtype=np.float64)
        if chunk.size > self.hop_size:
            raise ValueError("chunk must be <= hop_size")
        true_len = chunk.size
        if chunk.size < self.hop_size:
            chunk = np.pad(chunk, (0, self.hop_size - chunk.size))
        self._hop_buf = np.concatenate([self._hop_buf[self.hop_size:], chunk])
        self._idx += true_len
        if self._idx < self.fft_size:
            return None
        return np.fft.fft(self._hop_buf * self._window)


class StreamingMel:
    """Whisper streaming mel with explicit state, on ``device`` (``None``:
    CUDA).

    - ``init()`` -> fresh state
    - ``push(state, chunk)`` -> ``(state, mel [n_mels] | None)``: one hop
    - ``push_many(state, chunks [n, hop])`` -> ``(state, mels [n, n_mels],
      valid [n])``: n hops as one framed computation
    """

    def __init__(self, config: MelConfig = MelConfig(), dtype=torch.float32,
                 device=None):
        self.device = resolve_device(device)
        self.config = config
        self.dtype = dtype
        fft, n_mels = config.fft_size, config.n_mels
        half = fft // 2
        filters = mel_filterbank(config.sampling_rate, fft, n_mels)
        self.filters_t = torch.as_tensor(filters[:, :half].T, dtype=dtype,
                                         device=self.device)
        self.window = torch.as_tensor(hann_periodic(fft), dtype=dtype,
                                      device=self.device)
        cos_m, msin_m = dft.rdft_matrices(fft, half)
        self.cos_m = torch.as_tensor(cos_m, dtype=dtype, device=self.device)
        self.msin_m = torch.as_tensor(msin_m, dtype=dtype,
                                      device=self.device)

    def init(self) -> StftState:
        return StftState(
            hop_buf=torch.zeros(self.config.fft_size, dtype=self.dtype,
                                device=self.device),
            idx=torch.zeros((), dtype=torch.int64, device=self.device),
        )

    def _mel(self, frames: torch.Tensor) -> torch.Tensor:
        """Normalized log-mel of ``[..., fft]`` frames, the whisper norm's
        max taken per frame."""
        xw = frames * self.window
        with full_f32():
            re = xw @ self.cos_m
            im = xw @ self.msin_m
            energy = (re * re + im * im) @ self.filters_t
        log_mel = log10_best(torch.clamp_min(energy, LOG10_FLOOR), self.dtype)
        return whisper_norm(log_mel, axis=-1)

    def _step(self, state: StftState, chunk: torch.Tensor, true_len: int):
        hop = self.config.hop_size
        fft = self.config.fft_size
        buf = torch.cat([state.hop_buf[hop:].to(self.dtype), chunk])
        # the reference counts samples in a wrapping u64; idx only feeds
        # `valid = idx >= fft`, so it saturates at fft instead
        idx = torch.clamp_max(state.idx + true_len, fft)
        return StftState(buf, idx), self._mel(buf), idx >= fft

    def _bulk(self, state: StftState, chunks: torch.Tensor):
        """n hops of overlap-and-save are exactly batch framing of
        ``concat(hop_buf, chunks)`` at offset ``hop``: frame j covers
        samples ``[j*hop, j*hop + fft)`` of that signal."""
        hop = self.config.hop_size
        fft = self.config.fft_size
        n = chunks.shape[0]
        signal = torch.cat([state.hop_buf.to(self.dtype), chunks.reshape(-1)])
        frames = framing.frame_signal(signal, fft, hop, n, offset=hop)
        mels = self._mel(frames)
        seen = state.idx + torch.arange(1, n + 1, device=self.device) * hop
        new_state = StftState(signal[n * hop:].clone(),
                              torch.clamp_max(seen[-1], fft))
        return new_state, mels, seen >= fft

    def push(self, state: StftState,
             chunk: np.ndarray) -> Tuple[StftState, Optional[np.ndarray]]:
        """Push <= hop_size samples (zero-padded to a full hop, like the
        reference's ``Spectrogram::add``); returns the new state and a mel
        column once the first window has filled. One device-to-host
        transfer."""
        hop = self.config.hop_size
        chunk = np.asarray(chunk, dtype=np.float32)
        if chunk.size > hop:
            raise ValueError("chunk must be <= hop_size")
        true_len = chunk.size
        if chunk.size < hop:
            chunk = np.pad(chunk, (0, hop - chunk.size))
        state, mel, valid = self._step(
            state, torch.as_tensor(chunk, device=self.device).to(self.dtype),
            true_len)
        mel, valid = to_host(mel, valid)
        return state, (mel if bool(valid) else None)

    def push_many(self, state: StftState, chunks, scan: bool = False
                  ) -> Tuple[StftState, np.ndarray, np.ndarray]:
        """Push ``[n, hop_size]`` chunks; returns ``(state, mels [n,
        n_mels], valid [n])`` as host arrays (one transfer). The default
        runs the n hops as one framed computation; ``scan=True`` runs them
        one hop at a time (the reference route, kept for differential
        testing)."""
        chunks = torch.as_tensor(chunks, dtype=self.dtype, device=self.device)
        if chunks.ndim != 2 or chunks.shape[1] != self.config.hop_size:
            raise ValueError("chunks must be [n, hop_size]")
        if chunks.shape[0] == 0:
            return (state, np.zeros((0, self.config.n_mels), np.float32),
                    np.zeros((0,), bool))
        if scan:
            mels, valids = [], []
            for chunk in chunks:
                state, mel, valid = self._step(state, chunk,
                                               self.config.hop_size)
                mels.append(mel)
                valids.append(valid)
            mels, valids = torch.stack(mels), torch.stack(valids)
        else:
            state, mels, valids = self._bulk(state, chunks)
        return (state, *to_host(mels, valids))
