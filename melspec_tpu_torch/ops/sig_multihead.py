"""Several frontends over one spectral pass, on kernel K2 (port of
``melspec_tpu.ops.sig_multihead``).

Frontends on the same frame grid (frame k at ``k*hop``) share the costly
first steps: reading the signal, framing it and the bf16 slice cascade.
K2 (``kernels/sig_multi.py``) does them once per tile and then runs each
frontend as a head with its own matrices, taps, power, projection and
output mode; head 0 (whisper) can carry the Sobel VAD epilogue.

- ``WhisperKaldiFused``: whisper log-mel + Kaldi log-fbank (+ VAD); the
  Kaldi head is N-packed (512 columns for its 257 bins).
- ``WhisperKaldiNemoFused``: the same plus NeMo log-mel, whose centered,
  preemphasized frame is folded into its matrices over the raw window.

Not carried over from the JAX classes: ``interpret`` (no interpret mode
for a CUDA kernel) and the TPU's flat / macro-row tiling. The VAD's
tile-boundary columns follow K2's own tile, ``sig_multi.TILE_FRAMES``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import numpy as np
import torch

from melspec_tpu_torch._device import as_signal, resolve_device
from melspec_tpu_torch.config import (BatchLogMelConfig, DetectionSettings,
                                      FbankConfig, MelConfig)
from melspec_tpu_torch.kernels import sig_multi
from melspec_tpu_torch.kernels.sig_mel import SigHead, vad_args
from melspec_tpu_torch.ops import framing
from melspec_tpu_torch.ops.batch_logmel import BatchLogMel, nemo_filters
from melspec_tpu_torch.ops.fbank import sig_head as kaldi_head
from melspec_tpu_torch.ops.mel_kernel import (_sig_frontend_matrices,
                                              bf2_stack, sig_geometry,
                                              whisper_head)
from melspec_tpu_torch.ops.vad import fix_raw
from melspec_tpu_torch.ops.windows import hann_centered

__all__ = ["WhisperKaldiFused", "WhisperKaldiNemoFused", "check_k2",
           "head_subset", "pair_heads"]

CPU = torch.device("cpu")


def head_subset(head: SigHead, blocks: Sequence[int]) -> SigHead:
    """The head contracting only the given K blocks (slice pairs) of
    ``head``: their rows of ``m_big``, in the given order, padded to a
    multiple of 128 rows. Less work for a consumer with a coarse bar: on
    the JFK clip the Kaldi head's low-order subset ``(0, 1, 3)`` costs
    0.304 max ln-output error (the JAX package's measurement), against
    the 0.0152 golden gate, so the frontends keep every block by
    default."""
    pack = head.pack
    rows = torch.cat([head.m_big[b * pack : (b + 1) * pack] for b in blocks])
    k_sub = -(-rows.shape[0] // 128) * 128
    rows = torch.nn.functional.pad(rows, (0, 0, 0, k_sub - rows.shape[0]))
    return dataclasses.replace(
        head, m_big=rows, pair_i=tuple(head.pair_i[b] for b in blocks))


def pair_heads(mel_config: MelConfig, fbank_config: FbankConfig,
               fbank_blocks: tuple | None = None) -> tuple:
    """The whisper and Kaldi heads of ``WhisperKaldiFused`` on the CPU,
    after its checks: one frame grid, the macro-row geometry, and Kaldi's
    sig-route conditions (power spectra, log output). Raises
    ``ValueError`` where the fused route does not apply."""
    mc, kc = mel_config, fbank_config
    if (mc.fft_size != kc.frame_length_samples
            or mc.hop_size != kc.frame_shift_samples):
        raise ValueError(
            "fused whisper+kaldi needs one frame grid: whisper "
            f"({mc.fft_size}, {mc.hop_size}) vs kaldi "
            f"({kc.frame_length_samples}, {kc.frame_shift_samples})"
        )
    if sig_geometry(mc.fft_size, mc.hop_size) is None:
        raise ValueError("no macro-row geometry for this frame grid")
    if not (kc.use_power and kc.use_log_fbank):
        raise ValueError("the fused Kaldi head computes log power fbank only")
    k_head = kaldi_head(kc)
    if fbank_blocks is not None:
        k_head = head_subset(k_head, fbank_blocks)
    return (whisper_head(mc.fft_size, mc.n_mels, mc.sampling_rate, CPU),
            k_head)


def check_k2(heads: Sequence[SigHead], hop: int, device) -> None:
    """Raise ``ValueError`` where ``device`` is CUDA and K2 does not take
    ``heads`` (``kernels/sig_multi.py::k2_accepts``), so that a caller
    such as ``sharded_frontend_step`` takes the per-frontend routes, as
    for a config without the fused route. On the CPU the plain version
    takes any heads."""
    if (torch.device(device).type == "cuda"
            and not sig_multi.k2_accepts(heads, hop=hop)):
        raise ValueError(
            "K2 does not take these heads (DFT width or shared memory); "
            "run the frontends separately")


class WhisperKaldiFused:
    """Whisper log-mel + Kaldi log-fbank (+ the Sobel VAD) over one
    shared spectral pass (one K2 launch).

    The two frontends must share a frame grid: whisper's ``(fft_size,
    hop_size)`` must equal Kaldi's ``(frame_length_samples,
    frame_shift_samples)``, as both defaults do (400/160 at 16 kHz).

    ``compute(samples)`` -> ``(mel [B, F, n_mels], fbank [B, F, bins])``;
    ``compute_with_vad(samples, settings)`` also returns the raw Sobel
    column activity ``[B, F-2]`` bool. ``matrices`` replaces the
    host-built heads ``(whisper, kaldi)``; ``device=None`` means CUDA."""

    def __init__(self, mel_config: MelConfig | None = None,
                 fbank_config: FbankConfig | None = None,
                 fbank_blocks: tuple | None = None, device=None,
                 matrices: Sequence[SigHead] | None = None):
        self.device = resolve_device(device)
        self.mel_config = mel_config or MelConfig()
        self.fbank_config = fbank_config or FbankConfig(apply_cmn=True)
        mc = self.mel_config
        heads = pair_heads(mc, self.fbank_config, fbank_blocks)
        if matrices is not None:
            heads = tuple(matrices)
        check_k2(heads, mc.hop_size, self.device)
        self.heads = tuple(h.to(self.device) for h in heads)

    def _signal(self, samples) -> torch.Tensor:
        x = as_signal(samples, self.device)
        return x[None] if x.dim() == 1 else x

    def _run(self, x: torch.Tensor, vad) -> tuple:
        mc = self.mel_config
        n_frames = framing.num_frames_batch(x.shape[-1], mc.fft_size,
                                            mc.hop_size)
        outs, counts = sig_multi.sig_multi(x, self.heads, ks=3,
                                           n_frames=n_frames,
                                           hop=mc.hop_size, vad=vad)
        return outs, counts, n_frames

    def _cmn(self, fbank: torch.Tensor) -> torch.Tensor:
        if self.fbank_config.apply_cmn:
            return fbank - fbank.mean(dim=-2, keepdim=True)
        return fbank

    def compute(self, samples) -> tuple:
        (mel, fbank), _, _ = self._run(self._signal(samples), None)
        return mel, self._cmn(fbank)

    def compute_with_vad(self, samples, settings: DetectionSettings) -> tuple:
        n_mels = self.mel_config.n_mels
        (mel, fbank), counts, n_frames = self._run(
            self._signal(samples), vad_args(settings, n_mels))
        raw = fix_raw(counts, mel, n_frames, max(n_frames - 2, 0), settings,
                      sig_multi.TILE_FRAMES)
        return mel, self._cmn(fbank), raw


@functools.lru_cache(maxsize=8)
def nemo_fold_head(config: BatchLogMelConfig) -> SigHead:
    """The NeMo head of the three-head pass, on the CPU: its 512-tap
    centered frame and the cross-frame preemphasis ``y[t] = x[t] -
    p*x[t-1]`` folded, as a banded rectangular ``[512, 513]`` preproc, into
    spectral rows over the RAW window; each K block keeps the ``win + 1``
    raw taps starting at the window flank ``(n_fft - win) // 2``."""
    n_fft, win, p = config.n_fft, config.win_length, float(config.preemphasis)
    pre_t = np.zeros((n_fft + 1, n_fft))
    pre_t[np.arange(1, n_fft + 1), np.arange(n_fft)] = 1.0
    pre_t[np.arange(n_fft), np.arange(n_fft)] += -p
    flank = (n_fft - win) // 2
    m_big, pair_i, mt, n_bins_pad, _, _, _ = _sig_frontend_matrices(
        n_fft, config.fft_bins, hann_centered(n_fft, win),
        nemo_filters(config), ks=3, km=3, cutoff=2, pack=win + 1,
        pack_off=flank, preproc=pre_t.T)
    return SigHead(m_big, pair_i, bf2_stack(mt), n_bins_pad, win + 1,
                   config.n_mels, pack_off=flank, out_mode="ln_guard",
                   guard=float(config.log_zero_guard))


class WhisperKaldiNemoFused(WhisperKaldiFused):
    """Whisper mel, Kaldi fbank and NeMo log-mel over ONE shared spectral
    pass (one K2 launch with three heads).

    The NeMo frame differs from the batch grid in two linear ways, both
    folded into its matrices over the raw window: the center pad (its
    512-tap frame starts ``n_fft // 2`` samples earlier) and the
    cross-frame preemphasis (one extra raw tap). The shared frame spans
    ``n_fft // 2 + 1 + fft_size`` raw samples (657 at the defaults; the
    signal is left-padded by 257 zeros, which also gives NeMo's center and
    preemphasis edges exactly): whisper and Kaldi contract window
    positions ``[257, 657)``, NeMo ``[56, 457)``. The kernel emits NeMo's
    centered frame count (``T // hop + 1``) for every head; whisper and
    Kaldi are cut back to the batch count.

    ``compute(samples)`` -> ``(mel, fbank, nemo_feats)`` with
    ``nemo_feats`` feature-major ``[B, bins, F']`` after the config's
    normalize / pad_to, as ``BatchLogMel.compute``; ``compute_with_vad``
    adds the raw Sobel activity. ``matrices`` replaces the three
    host-built heads."""

    def __init__(self, mel_config: MelConfig | None = None,
                 fbank_config: FbankConfig | None = None,
                 nemo_config: BatchLogMelConfig | None = None, device=None,
                 matrices: Sequence[SigHead] | None = None):
        super().__init__(mel_config, fbank_config, device=device)
        nc = nemo_config or BatchLogMelConfig()
        mc = self.mel_config
        if (int(nc.sample_rate) != int(mc.sampling_rate)
                or nc.hop_length != mc.hop_size or not nc.center):
            raise ValueError(
                "NeMo head needs the shared hop grid and center=True")
        self.nemo_config = nc
        # the feature epilogue (normalize / pad_to) and the filters
        self.nemo = BatchLogMel(nc, fft_impl="rdft", device=self.device)
        self._nemo_pad = nc.n_fft // 2 + 1  # 257 at the defaults
        if matrices is not None:
            self.heads = tuple(h.to(self.device) for h in matrices)
        else:
            # whisper / kaldi frame at +pad, NeMo's folded rows at the
            # window flank
            self.heads = tuple(dataclasses.replace(h,
                                                   pack_off=self._nemo_pad)
                               for h in self.heads) + (
                nemo_fold_head(nc).to(self.device),)
        check_k2(self.heads, mc.hop_size, self.device)

    def _run(self, x: torch.Tensor, vad) -> tuple:
        mc = self.mel_config
        t_real = x.shape[-1]
        n_frames = framing.num_frames_centered(t_real, mc.hop_size)
        x = torch.nn.functional.pad(x, (self._nemo_pad, 0))
        outs, counts = sig_multi.sig_multi(x, self.heads, ks=3,
                                           n_frames=n_frames,
                                           hop=mc.hop_size, vad=vad)
        return outs, counts, n_frames

    def _batch_frames(self, t: int) -> int:
        """Whisper's and Kaldi's frame count for ``t`` samples."""
        mc = self.mel_config
        return framing.num_frames_batch(t, mc.fft_size, mc.hop_size)

    def _finish(self, mel, fbank, nemo_raw, t: int) -> tuple:
        f_w = self._batch_frames(t)
        mel, fbank = mel[:, :f_w], fbank[:, :f_w]
        feats = nemo_raw.transpose(-1, -2)  # [B, bins, F']
        feats = self.nemo._norm_and_pad(feats, nemo_raw.shape[-2])
        return mel, self._cmn(fbank), feats

    def compute(self, samples) -> tuple:
        x = self._signal(samples)
        (mel, fbank, nemo_raw), _, _ = self._run(x, None)
        return self._finish(mel, fbank, nemo_raw, x.shape[-1])

    def compute_with_vad(self, samples, settings: DetectionSettings) -> tuple:
        x = self._signal(samples)
        (mel, fbank, nemo_raw), counts, n_frames = self._run(
            x, vad_args(settings, self.mel_config.n_mels))
        raw = fix_raw(counts, mel, n_frames,
                      max(self._batch_frames(x.shape[-1]) - 2, 0), settings,
                      sig_multi.TILE_FRAMES)
        mel, fbank, feats = self._finish(mel, fbank, nemo_raw, x.shape[-1])
        return mel, fbank, feats, raw
