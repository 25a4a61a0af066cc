"""NeMo/Parakeet-style batch log-mel frontend (port of
``melspec_tpu.ops.batch_logmel``).

The reference's ``BatchLogMelSpectrogram`` (``src/mel.rs:172-433``) as
batched tensor code over ``[..., T]``:

- optional preemphasis over the whole waveform ``y[n] = x[n] - c*x[n-1]``,
  ``y[0] = x[0]``;
- ``center=True`` zero-pads ``n_fft/2`` on both sides (zeros, not
  reflect); ``exact_pad`` (NeMo's) reflect-pads ``(n_fft - hop) // 2`` on
  both sides instead;
- ``len // hop + 1`` frames when centered, ``(len - n_fft) // hop + 1``
  otherwise (of the padded length under ``exact_pad``: ``len // hop``
  where ``n_fft - hop`` is even);
- symmetric Hann of ``win_length`` centered inside ``n_fft``;
- power (``mag_power`` 2) or magnitude (1) over all ``n_fft//2 + 1``
  bins, Slaney filterbank, ``ln(energy + guard)`` (``log_zero_guard_type``
  ``"add"``) or ``ln(max(energy, guard))`` (``"clamp"``);
- feature-major output ``[..., n_mels, padded_frames]`` with ``pad_to``
  column padding, and optional per-feature mean/std normalization over
  the valid frames (``max(valid - 1, 1)`` variance denominator, ``std +
  1e-5``).

``fft_impl``: ``"sig"`` runs kernel K1 in its ``ln_guard`` (or
``ln_floor``) mode over the N-packed 512-column head (a magnitude head
split into re|im halves), contracting only the ``win_length`` taps inside
the window (``pack_off = (n_fft - win) // 2``); ``"rdft"``, ``"fft"`` and
``"hp"`` (the exact Ozaki split with the window folded in,
``ops/hp_dft.py``) run as plain PyTorch; ``"auto"`` picks ``"sig"`` on
CUDA where the config qualifies and K1 takes its head
(``auto_fft_impl``), ``"rdft"`` otherwise.

Traced (``utils/profiling.py``), ``BatchLogMel.compute`` is the span
``logmel`` with its stages ``logmel.pad`` (the preemphasis and the centre
or exact pad) and ``logmel.spectral`` (the K1 launch or the plain body,
the transpose, the normalisation and ``pad_to``); ``_compute``, which the
frontend step calls inside its own stage, records neither.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from melspec_tpu_torch._device import full_f32, resolve_device
from melspec_tpu_torch.config import BatchLogMelConfig
from melspec_tpu_torch.kernels import sig_mel as k1
from melspec_tpu_torch.kernels.sig_mel import SigHead, k1_accepts, sig_mel
from melspec_tpu_torch.ops import dft, framing
from melspec_tpu_torch.ops.fastmath import ln_best
from melspec_tpu_torch.ops.filterbank import mel_filterbank
from melspec_tpu_torch.ops.hp_dft import hp_rdft_power_windowed
from melspec_tpu_torch.ops.mel_kernel import (_sig_frontend_matrices,
                                              bf2_stack, magnitude_matrices,
                                              sig_fft_head, sig_geometry)
from melspec_tpu_torch.ops.windows import hann_centered
from melspec_tpu_torch.utils import profiling


def pad_len(length: int, pad_to: int) -> int:
    """Round ``length`` up to a multiple of ``pad_to`` (0 = no padding)."""
    if pad_to == 0:
        return length
    return -(-length // pad_to) * pad_to


def nemo_filters(config: BatchLogMelConfig) -> np.ndarray:
    return mel_filterbank(float(config.sample_rate), config.n_fft,
                          config.n_mels, f_min=config.f_min,
                          f_max=config.effective_f_max, htk=config.htk,
                          norm=config.norm)


def out_mode(config: BatchLogMelConfig) -> str:
    """K1's ln mode of the config's guard: ``ln(e + guard)`` or
    ``ln(max(e, guard))``."""
    return "ln_floor" if config.log_zero_guard_type == "clamp" else "ln_guard"


@functools.lru_cache(maxsize=8)
@profiling.spanned("setup.heads", head="nemo")
def sig_head(config: BatchLogMelConfig) -> SigHead:
    """NeMo's K1 head on the CPU: centered frames are zero outside the
    ``win_length`` window, so each K block keeps only that interior
    (``pack = win``, ``pack_off = (n_fft - win) // 2``); ``npack="auto"``
    N-packs the 257-bin head into 512 columns; a magnitude head
    (``mag_power`` 1) is split into re|im halves (``magnitude_matrices``:
    512 and 512 at n_fft 1024, the columns past the filters' last bin
    zero); bf2 projection; ``ln(e + guard)``, or ``ln(max(e, guard))``
    under the clamp guard. Where K1's float64 FFT path can take it (n_fft
    1024: 22.05 to 40 kHz, NeMo's TTS mel among them; 2048: 44.1 / 48
    kHz), the head also carries its DFT size, the float64 window of its
    ``win_length`` taps and the projection in bin order
    (``sig_fft_head``)."""
    pack_off = (config.n_fft - config.win_length) // 2
    window = hann_centered(config.n_fft, config.win_length)
    filters = nemo_filters(config)
    kw = dict(ks=3, km=3, cutoff=2, pack=config.win_length, pack_off=pack_off)
    if config.magnitude:
        m_big, pair_i, mt, n_bins_pad = magnitude_matrices(
            config.n_fft, window, filters, **kw)
    else:
        m_big, pair_i, mt, n_bins_pad, _, _, _ = _sig_frontend_matrices(
            config.n_fft, config.fft_bins, window, filters, **kw)
    dft_size, fft = sig_fft_head(
        config.n_fft, window[pack_off : pack_off + config.win_length], mt)
    return SigHead(m_big, pair_i, bf2_stack(mt), n_bins_pad,
                   config.win_length, config.n_mels, pack_off=pack_off,
                   out_mode=out_mode(config),
                   guard=float(config.log_zero_guard), dft_size=dft_size,
                   fft=fft, magnitude=config.magnitude)


@profiling.spanned("setup.route", route="batch_logmel.auto_fft_impl")
def auto_fft_impl(config: BatchLogMelConfig, dtype, device) -> str:
    """``fft_impl="auto"`` on ``device``: ``"sig"`` on CUDA where the
    config qualifies (macro-row geometry, float32) and K1 takes its head
    (``k1_accepts``), else ``"rdft"``. The head is built on the CPU; no
    kernel runs."""
    eligible = (torch.device(device).type == "cuda"
                and sig_geometry(config.n_fft, config.hop_length) is not None
                and dtype == torch.float32)
    if eligible and k1_accepts(sig_head(config), hop=config.hop_length):
        return "sig"
    return "rdft"


class BatchLogMel:
    """NeMo-style frontend for one config on one device.

    ``compute(samples)`` takes ``[T]`` or ``[B, T]`` float32 and returns
    ``[..., n_mels, padded_frames]`` in the pipeline dtype. ``matrices``
    replaces the host-built K1 head of the ``"sig"`` route.
    ``device=None`` means CUDA."""

    def __init__(self, config: BatchLogMelConfig = BatchLogMelConfig(),
                 dtype=torch.float32, fft_impl: str = "auto", device=None,
                 matrices: SigHead | None = None):
        self.device = resolve_device(device)
        geom = sig_geometry(config.n_fft, config.hop_length)
        if fft_impl == "auto":
            fft_impl = auto_fft_impl(config, dtype, self.device)
        if fft_impl not in ("rdft", "fft", "hp", "sig"):
            raise ValueError(
                "fft_impl must be 'auto', 'rdft', 'fft', 'hp' or 'sig'"
            )
        if fft_impl == "sig":
            if geom is None:
                raise ValueError(
                    "fft_impl='sig': no macro-row geometry for this "
                    "(n_fft, hop_length)"
                )
            if dtype != torch.float32:
                raise ValueError("fft_impl='sig' is float32-only")
        self.config = config
        self.dtype = dtype
        self.fft_impl = fft_impl
        self.fft_bins = config.fft_bins

        filters = nemo_filters(config)
        self._filters_np = filters
        self.filters_t = torch.as_tensor(filters.T, dtype=dtype,
                                         device=self.device)
        self._window_np = hann_centered(config.n_fft, config.win_length)
        self.window = torch.as_tensor(self._window_np, dtype=dtype,
                                      device=self.device)
        self.sig_head = None
        if fft_impl == "sig":
            head = sig_head(config) if matrices is None else matrices
            with profiling.span("setup.heads", head="nemo", upload=True):
                self.sig_head = head.to(self.device)

    @property
    def filters(self) -> np.ndarray:
        return self._filters_np

    def num_frames(self, sample_len: int) -> int:
        cfg = self.config
        if cfg.center:
            return framing.num_frames_centered(sample_len, cfg.hop_length)
        if cfg.exact_pad:
            sample_len += 2 * cfg.exact_pad_amount
        return framing.num_frames_batch(sample_len, cfg.n_fft,
                                        cfg.hop_length)

    def _compute(self, x: torch.Tensor) -> torch.Tensor:
        """Features of ``x [..., T]`` (on the device, pipeline dtype)."""
        return self._spectral(*self._pad(x))

    def _pad(self, x: torch.Tensor) -> tuple:
        """``x [..., T]`` preemphasized and padded as the framing reads
        it, and its frame count."""
        cfg = self.config
        n = x.shape[-1]
        if cfg.preemphasis != 0.0:
            prev = torch.cat([x[..., :1] * 0.0, x[..., :-1]], dim=-1)
            x = x - cfg.preemphasis * prev  # y[0] = x[0]: prev[0] is 0
        valid = self.num_frames(n)
        if cfg.center:
            pad = cfg.n_fft // 2
            x = torch.nn.functional.pad(x, (pad, pad))
        elif cfg.exact_pad:
            # one reflect pad over every clip: as [rows, T] (reflect
            # padding takes a batch of rows)
            pad = cfg.exact_pad_amount
            x = torch.nn.functional.pad(
                x.reshape((-1, n)), (pad, pad), mode="reflect").reshape(
                    x.shape[:-1] + (n + 2 * pad,))
        # the framing needs this many samples
        needed = (valid - 1) * cfg.hop_length + cfg.n_fft
        if x.shape[-1] < needed:
            x = torch.nn.functional.pad(x, (0, needed - x.shape[-1]))
        return x, valid

    def _spectral(self, x: torch.Tensor, valid: int) -> torch.Tensor:
        """Features of the padded ``x`` (``_pad``) over ``valid`` frames."""
        cfg = self.config
        if self.fft_impl == "sig":
            # K1: framing, windowed rDFT, power (or magnitude),
            # filterbank and the guarded ln in one launch
            h = self.sig_head
            lead = x.shape[:-1]
            mel = sig_mel(x.reshape((-1, x.shape[-1])).to(torch.float32), h,
                          ks=3, n_frames=valid, hop=cfg.hop_length, offset=0)
            feats = mel.transpose(-1, -2).reshape(
                lead + (cfg.n_mels, valid)).to(self.dtype)
            return self._norm_and_pad(feats, valid)

        frames = framing.frame_signal(x, cfg.n_fft, cfg.hop_length, valid)
        with full_f32():
            if self.fft_impl == "hp":
                # the window folded into the sliced matrices
                power = hp_rdft_power_windowed(
                    frames.to(torch.float32), self._window_np, cfg.n_fft,
                    self.fft_bins).to(self.dtype)
            elif self.fft_impl == "rdft":
                power = dft.rdft_power(frames * self.window, cfg.n_fft,
                                       self.fft_bins, dtype=self.dtype)
            else:
                spec = torch.fft.rfft(frames * self.window, dim=-1)
                power = (spec.real ** 2 + spec.imag ** 2).to(self.dtype)
            if cfg.magnitude:
                power = torch.sqrt(power)
            energy = power @ self.filters_t
        if cfg.log_zero_guard_type == "clamp":
            energy = torch.clamp_min(energy, cfg.log_zero_guard)
        else:
            energy = energy + cfg.log_zero_guard
        feats = ln_best(energy, self.dtype)
        feats = feats.transpose(-1, -2)  # [..., n_mels, valid]
        return self._norm_and_pad(feats, valid)

    def _norm_and_pad(self, feats: torch.Tensor, valid: int) -> torch.Tensor:
        cfg = self.config
        if cfg.normalize_per_feature:
            mean = feats.mean(dim=-1, keepdim=True)
            denom = max(valid - 1, 1)
            var = ((feats - mean) ** 2).sum(dim=-1, keepdim=True) / denom
            std = torch.sqrt(var) + 1e-5
            feats = (feats - mean) / std
        padded = pad_len(valid, cfg.pad_to)
        if padded > valid:
            feats = torch.nn.functional.pad(feats, (0, padded - valid))
        return feats

    def compute(self, samples) -> torch.Tensor:
        """``samples [..., T]`` -> ``[..., n_mels, padded_frames]``.

        Traced (``utils/profiling.py``), a call is the span ``logmel``,
        with the attrs ``k1_launches`` and ``magnitude_launches`` (K1's
        launches in the call, and those of a magnitude head), and its
        stages ``logmel.pad`` and ``logmel.spectral``, which tile the
        features' work on the device. ``_compute``, which the frontend
        step calls, records neither."""
        with profiling.span("logmel", self.device) as sp:
            launches, mags = k1.launches, k1.magnitude_launches
            out = self._call(samples)
            sp.set(k1_launches=k1.launches - launches,
                   magnitude_launches=k1.magnitude_launches - mags)
            return out

    def _call(self, samples) -> torch.Tensor:
        x = torch.as_tensor(samples, device=self.device)
        if x.shape[-1] == 0:
            return torch.zeros(x.shape[:-1] + (self.config.n_mels, 0),
                               dtype=self.dtype, device=self.device)
        stage = profiling.stages(self.device)
        with stage("logmel.pad"):
            x, valid = self._pad(x.to(self.dtype))
        with stage("logmel.spectral"):
            return self._spectral(x, valid)

    def compute_flat(self, samples) -> tuple[np.ndarray, int, int]:
        """Flat row-major output and ``(rows, cols)``, the reference's
        ``compute_flat_with_scratch`` return (``src/mel.rs:321-385``)."""
        feats = self.compute(samples).cpu().numpy().astype(np.float32)
        rows, cols = feats.shape[-2], feats.shape[-1]
        return feats.reshape(feats.shape[:-2] + (rows * cols,)), rows, cols


def mel_tensor(frames: np.ndarray, n_mels: int):
    """Flat feature-major mel frames packaged for an ONNX-style ASR
    runtime: ``(features [1, n_mels, T] float32, lengths [1] int64)``
    (reference ``src/mel.rs:420-433``)."""
    frames = np.asarray(frames, dtype=np.float32).reshape(-1)
    num_frames = frames.size // n_mels
    audio = frames[: n_mels * num_frames].reshape(1, n_mels, num_frames)
    lengths = np.asarray([num_frames], dtype=np.int64)
    return audio, lengths


def run_asr_session(model, frames, n_mels: int,
                    audio_key: str = "audio_signal",
                    length_key: str = "length"):
    """Run an ONNX Runtime ASR session on packaged mel features:
    ``session.run(None, {audio_key: mel [1, n_mels, T] f32, length_key:
    [T] i64})``. ``model`` is a session (anything with ``.run(names,
    feeds)``) or a path to a ``.onnx`` model, for which ``onnxruntime`` is
    imported here; without it the call raises an ``ImportError`` that
    says what to install."""
    audio, lengths = mel_tensor(frames, n_mels)
    feeds = {audio_key: audio, length_key: lengths}
    if hasattr(model, "run"):
        return model.run(None, feeds)
    try:
        import onnxruntime as ort
    except ImportError as e:
        raise ImportError(
            "run_asr_session(path) needs the optional 'onnxruntime' "
            "package (pip install onnxruntime); alternatively pass an "
            "already-constructed session object"
        ) from e
    return ort.InferenceSession(str(model)).run(None, feeds)
