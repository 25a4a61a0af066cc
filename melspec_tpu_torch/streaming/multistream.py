"""Streaming whisper mel over many concurrent audio streams (port of
``melspec_tpu.streaming.multistream``).

The carried state is batched (``hop_buf [S, fft]``, ``idx [S]``) and one
push advances every stream by ``H`` hops, masked per stream. ``H`` hops of
overlap-and-save are exactly batch framing of ``concat(hop_buf, chunks)``
at offset ``hop``, so a bulk push is one framed computation:

- ``fft_impl="rdft"``: windowed frames times the f64-built cos / -sin
  matrices in f32 ``torch.matmul`` (TF32 off), power, filterbank, log10,
  whisper norm;
- ``fft_impl="bf3"``: the rounded-bf16 slice-pair power of
  ``hp_dft.bf3_rdft_power`` with the window folded into the sliced
  matrices (plain PyTorch on every device), then the rdft route's
  filterbank, log10 and norm; per hop and in bulk;
- ``fft_impl="sig"``: kernel K1 (``kernels/sig_mel.py``) at
  ``offset=hop`` over the concat, ``n_frames=H``, bf2 mel numerics (the
  plain version on the CPU).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from melspec_tpu_torch._device import (full_f32, resolve_device,
                                       stream_mask, to_host)
from melspec_tpu_torch.config import MelConfig
from melspec_tpu_torch.kernels.sig_mel import sig_mel
from melspec_tpu_torch.ops import dft, framing
from melspec_tpu_torch.ops.filterbank import mel_filterbank
from melspec_tpu_torch.ops.hp_dft import bf3_rdft_power
from melspec_tpu_torch.ops.mel_kernel import sig_geometry, sig_matrices
from melspec_tpu_torch.ops.spectrogram import log_mel_from_power, whisper_norm
from melspec_tpu_torch.ops.windows import hann_periodic


class MultiStreamState(NamedTuple):
    hop_buf: torch.Tensor  # [S, fft_size]
    idx: torch.Tensor      # [S] int32 samples seen per stream (saturating)


class MultiStreamMel:
    """Whisper streaming mel for ``n_streams`` concurrent streams.

    - ``init()`` -> fresh state for all streams
    - ``push(state, chunks [S, hop], active [S])`` -> ``(state, mels [S,
      n_mels], valid [S])``: advances only the active streams; ``valid``
      marks streams whose overlap window has filled AND were active.
    - ``push_many(state, chunks [S, H, hop] or [S, H*hop], active)``: H
      hops in one bulk computation.
    - ``reset(state, mask [S])`` -> masked streams re-zeroed.
    """

    def __init__(self, config: MelConfig = MelConfig(), n_streams: int = 64,
                 dtype=torch.float32, fft_impl: str = "rdft", device=None):
        if fft_impl not in ("rdft", "bf3", "sig"):
            raise ValueError("fft_impl must be 'rdft', 'bf3' or 'sig'")
        self.device = resolve_device(device)
        self.config = config
        self.n_streams = n_streams
        self.dtype = dtype
        self.fft_impl = fft_impl
        fft, n_mels = config.fft_size, config.n_mels
        half = fft // 2
        self.half = half
        filters = mel_filterbank(config.sampling_rate, fft, n_mels)
        self.filters_t = torch.as_tensor(filters[:, :half].T, dtype=dtype,
                                         device=self.device)
        self.window = torch.as_tensor(hann_periodic(fft), dtype=dtype,
                                      device=self.device)
        cos_m, msin_m = dft.rdft_matrices(fft, half)
        self.cos_m = torch.as_tensor(cos_m, dtype=dtype, device=self.device)
        self.msin_m = torch.as_tensor(msin_m, dtype=dtype,
                                      device=self.device)
        if fft_impl == "sig":
            if dtype != torch.float32:
                raise ValueError("fft_impl='sig' is float32-only")
            if sig_geometry(fft, config.hop_size,
                            offset=config.hop_size) is None:
                raise ValueError(
                    "no macro-row geometry for this (fft, hop) — use "
                    "fft_impl='rdft' or 'bf3'"
                )
            self._sig = sig_matrices(fft, n_mels,
                                     float(config.sampling_rate), 3, 2,
                                     self.device)

    def _power(self, frames: torch.Tensor) -> torch.Tensor:
        """``|rfft|^2`` of RAW (unwindowed) frames ``[..., fft]`` over the
        first ``fft//2`` bins, per the configured route (rdft or bf3)."""
        if self.fft_impl == "bf3":
            return bf3_rdft_power(frames.to(torch.float32),
                                  self.config.fft_size, self.half,
                                  hann_windowed=True)
        xw = frames * self.window
        with full_f32():
            re = xw @ self.cos_m
            im = xw @ self.msin_m
        return re * re + im * im

    def init(self) -> MultiStreamState:
        return MultiStreamState(
            hop_buf=torch.zeros((self.n_streams, self.config.fft_size),
                                dtype=self.dtype, device=self.device),
            idx=torch.zeros(self.n_streams, dtype=torch.int32,
                            device=self.device),
        )

    def step(self, state: MultiStreamState, chunks: torch.Tensor,
             active: torch.Tensor):
        """One hop for every stream (``chunks [S, hop]``, tensors on the
        instance's device) -> ``(state, mels [S, n_mels], valid [S])``."""
        if self.fft_impl == "sig":
            # the fused kernel serves only the bulk path; serving rdft
            # numerics from a 'sig' instance here would let a scan-vs-bulk
            # differential compare two error classes
            raise NotImplementedError(
                "fft_impl='sig' supports only the bulk path "
                "(push_many(scan=False)); use 'rdft' or 'bf3' for "
                "per-hop/step/scan use"
            )
        hop = self.config.hop_size
        fft = self.config.fft_size
        shifted = torch.cat([state.hop_buf[:, hop:], chunks.to(self.dtype)],
                            dim=1)
        buf = torch.where(active[:, None], shifted, state.hop_buf)
        # saturating at fft_size (idx only feeds valid = idx >= fft), so a
        # long-lived slot never wraps negative
        idx = torch.clamp_max(
            state.idx + torch.where(active, hop, 0).to(state.idx.dtype), fft)
        log_mel = log_mel_from_power(self._power(buf), self.filters_t,
                                     self.dtype)
        mels = whisper_norm(log_mel, axis=-1)
        valid = active & (idx >= fft)
        return MultiStreamState(buf, idx), mels, valid

    def _flat_chunks(self, chunks: torch.Tensor):
        """``(flat [S, H*hop], H)`` of ``[S, H, hop]`` or flat chunks."""
        hop = self.config.hop_size
        if chunks.dim() == 3:
            s, h = chunks.shape[:2]
            return chunks.reshape(s, h * hop), h
        return chunks, chunks.shape[-1] // hop

    def _push_many(self, state: MultiStreamState, chunks: torch.Tensor,
                   active: torch.Tensor, log10: bool = False):
        """Bulk push of H hops: ``(state, log_mel, mels, valid)``;
        ``log_mel`` (the unnormalized log10 mel) only with ``log10=True``,
        which the sig route refuses (K1 normalizes in-kernel)."""
        hop = self.config.hop_size
        fft = self.config.fft_size
        chunks, h = self._flat_chunks(chunks)
        signal = torch.cat([state.hop_buf, chunks.to(self.dtype)], dim=1)
        log_mel = None
        if self.fft_impl == "sig":
            if log10:
                raise ValueError(
                    "log10 records need fft_impl 'rdft' or 'bf3' (the sig "
                    "kernel normalizes in-kernel)"
                )
            m = self._sig
            mels = sig_mel(
                signal, m.m_big, m.pair_i, m.mt_bf2, ks=3, n_frames=h,
                hop=hop, offset=hop, pack=fft, n_bins_pad=m.n_bins_pad,
                n_mels=self.config.n_mels, mel_precision="bf2",
            ).to(self.dtype)
        else:
            frames = framing.frame_signal(signal, fft, hop, h, offset=hop)
            log_mel = log_mel_from_power(self._power(frames),
                                         self.filters_t, self.dtype)
            mels = whisper_norm(log_mel, axis=-1)
        hops = torch.arange(1, h + 1, device=self.device,
                            dtype=state.idx.dtype) * hop
        valid = active[:, None] & ((state.idx[:, None] + hops[None, :])
                                   >= fft)
        new_buf = torch.where(active[:, None],
                              signal[:, h * hop : h * hop + fft],
                              state.hop_buf)
        new_idx = torch.where(
            active, torch.clamp_max(state.idx + h * hop, fft), state.idx)
        return MultiStreamState(new_buf, new_idx), log_mel, mels, valid

    def _push_many_scan(self, state: MultiStreamState, chunks: torch.Tensor,
                        active: torch.Tensor):
        """Per-hop reference path: ``step`` once per hop."""
        flat, h = self._flat_chunks(chunks)
        hop = self.config.hop_size
        mels, valid = [], []
        for t in range(h):
            state, m, v = self.step(state, flat[:, t * hop : (t + 1) * hop],
                                    active)
            mels.append(m)
            valid.append(v)
        return state, torch.stack(mels, dim=1), torch.stack(valid, dim=1)

    def _chunks(self, chunks) -> torch.Tensor:
        """Chunks on the device, copied synchronously: the caller may
        refill its host buffer as soon as the call returns."""
        return torch.as_tensor(chunks, dtype=self.dtype, device=self.device)

    def push_many(self, state: MultiStreamState, chunks, active=None,
                  scan: bool = False
                  ) -> Tuple[MultiStreamState, np.ndarray, np.ndarray]:
        """Push ``H`` hops per stream, ``[S, H, hop]`` or flat ``[S,
        H*hop]``; returns ``(state, mels [S, H, n_mels], valid [S, H])``
        (host arrays, one transfer). Inactive streams keep their state
        and emit only invalid frames."""
        chunks = self._chunks(chunks)
        hop = self.config.hop_size
        ok = (chunks.shape[0] == self.n_streams) and (
            (chunks.dim() == 3 and chunks.shape[2] == hop)
            or (chunks.dim() == 2 and chunks.shape[1] % hop == 0)
        )
        if not ok:
            raise ValueError(
                "chunks must be [n_streams, n_hops, hop_size] or flat "
                "[n_streams, n_hops*hop_size]")
        n_hops = (chunks.shape[1] if chunks.dim() == 3
                  else chunks.shape[1] // hop)
        if n_hops == 0:
            return (state,
                    np.zeros((self.n_streams, 0, self.config.n_mels),
                             np.float32),
                    np.zeros((self.n_streams, 0), bool))
        active = stream_mask(active, self.n_streams, self.device)
        if scan:
            state, mels, valid = self._push_many_scan(state, chunks, active)
        else:
            state, _, mels, valid = self._push_many(state, chunks, active)
        return (state, *to_host(mels, valid))

    def push(self, state: MultiStreamState, chunks, active=None
             ) -> Tuple[MultiStreamState, np.ndarray, np.ndarray]:
        chunks = self._chunks(chunks)
        if tuple(chunks.shape) != (self.n_streams, self.config.hop_size):
            raise ValueError("chunks must be [n_streams, hop_size]")
        state, mels, valid = self.step(
            state, chunks, stream_mask(active, self.n_streams, self.device))
        return (state, *to_host(mels, valid))

    def reset(self, state: MultiStreamState, mask) -> MultiStreamState:
        mask = stream_mask(mask, self.n_streams, self.device)
        return MultiStreamState(
            hop_buf=torch.where(mask[:, None], 0.0, state.hop_buf),
            idx=torch.where(mask, 0, state.idx),
        )
