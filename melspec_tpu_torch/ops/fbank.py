"""Kaldi-compatible filterbank features (port of ``melspec_tpu.ops.fbank``).

The reference's ``Fbank`` (``src/fbank.rs``) as batched tensor code, with
its Kaldi edge cases kept exactly:

- frames of ``frame_length_samples`` every ``frame_shift_samples`` from the
  raw signal, ``1 + (len - frame_len) // shift`` frames;
- per-frame DC removal (subtract the frame mean);
- preemphasis on the DC-removed frame, ``y[i] = d[i] - p*d[i-1]``; the first
  sample uses the sample before the frame, re-centered with this frame's
  mean, and frame 0's first sample is left untouched;
- Povey window, zero pad to the next power of two, rFFT power (or
  magnitude), Kaldi filterbank, ``max(floor, e)`` with ``floor =
  energy_floor or f32 epsilon``, ``ln``;
- optional CMN: subtract the per-bin mean over time.

``fft_impl``: ``"sig"`` runs kernel K1 in its ``ln_floor`` mode with the
N-packed 512-column head (``use_power=False``: a magnitude head split into
re|im halves) and the whole per-frame preprocessing folded into its
matrices; ``"rdft"`` (DFT as matmuls), ``"fft"`` (``torch.fft``) and
``"hp"`` (the exact Ozaki split with the Povey window folded in,
``ops/hp_dft.py``) run as plain PyTorch; ``"auto"`` picks ``"sig"`` on
CUDA where the config qualifies and K1 takes its head
(``auto_fft_impl``), ``"rdft"`` otherwise.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from melspec_tpu_torch._device import full_f32, resolve_device
from melspec_tpu_torch.config import FbankConfig
from melspec_tpu_torch.kernels import sig_mel as k1
from melspec_tpu_torch.kernels.sig_mel import SigHead, k1_accepts, sig_mel
from melspec_tpu_torch.ops import dft, framing
from melspec_tpu_torch.ops.fastmath import ln_best
from melspec_tpu_torch.ops.filterbank import kaldi_filterbank
from melspec_tpu_torch.ops.hp_dft import hp_rdft_power_windowed
from melspec_tpu_torch.ops.mel_kernel import (_sig_frontend_matrices,
                                              bf2_stack, magnitude_matrices,
                                              sig_fft_head, sig_geometry)
from melspec_tpu_torch.ops.windows import povey
from melspec_tpu_torch.utils import profiling

F32_EPSILON = 1.1920929e-07


def kaldi_preproc_matrix(frame_len: int, preemphasis: float) -> np.ndarray:
    """The per-frame linear preprocessing as one ``[L, L]`` matrix: DC
    removal ``(I - 11^T/L)`` followed by in-frame preemphasis ``(I -
    p*S)`` (reference ``src/fbank.rs:163-181``; the cross-frame
    first-sample term is spectrally irrelevant because the Povey window
    has ``w[0] == 0`` exactly)."""
    n = frame_len
    p = np.eye(n)
    if preemphasis > 0.0:
        p[np.arange(1, n), np.arange(n - 1)] = -preemphasis
    return p @ (np.eye(n) - np.full((n, n), 1.0 / n))


def energy_floor(config: FbankConfig) -> float:
    return config.energy_floor if config.energy_floor > 0.0 else F32_EPSILON


@functools.lru_cache(maxsize=8)
@profiling.spanned("setup.heads", head="kaldi")
def sig_head(config: FbankConfig) -> SigHead:
    """Kaldi's K1 head on the CPU: window, DC removal and preemphasis
    folded into the spectral matrices (exact: all three are linear in the
    frame), the N-packed 512-column layout that ``npack="auto"`` picks for
    the 257-bin head (``use_power=False``: a magnitude head, split into
    re|im halves by ``magnitude_matrices``, 256 and 256 at n_fft 512), the bf2
    projection, ``ln(max(e, floor))``. Where
    K1's float64 FFT path can take it (n_fft 2048: 44.1 to 80 kHz), the
    head also carries its DFT size, the float64 Povey window, the
    preemphasis coefficient (that path removes the mean and preemphasizes
    per frame) and the projection in bin order (``sig_fft_head``).
    ``preemph`` is 0 for every ``p <= 0`` and for NaN, as in JAX."""
    n = config.frame_length_samples
    window = povey(n)
    filters = kaldi_filterbank(config.sample_rate, config.fft_size,
                               config.num_mel_bins, config.low_freq,
                               config.effective_high_freq)
    kw = dict(ks=3, km=3, cutoff=2, pack=n,
              preproc=kaldi_preproc_matrix(n, float(config.preemphasis)))
    if config.use_power:
        m_big, pair_i, mt, n_bins_pad, _, _, _ = _sig_frontend_matrices(
            config.fft_size, config.fft_size // 2 + 1, window, filters, **kw)
    else:
        m_big, pair_i, mt, n_bins_pad = magnitude_matrices(
            config.fft_size, window, filters, **kw)
    p = float(config.preemphasis)
    # JAX preemphasizes only where p > 0; any other p (NaN too) is DC
    # removal alone, which the FFT path reads from a coefficient of 0
    dft_size, fft = sig_fft_head(config.fft_size, window, mt,
                                 p if p > 0.0 else 0.0)
    return SigHead(m_big, pair_i, bf2_stack(mt), n_bins_pad, n,
                   config.num_mel_bins, out_mode="ln_floor",
                   guard=energy_floor(config), dft_size=dft_size, fft=fft,
                   magnitude=not config.use_power)


@profiling.spanned("setup.route", route="fbank.auto_fft_impl")
def auto_fft_impl(config: FbankConfig, dtype, device) -> str:
    """``fft_impl="auto"`` on ``device``: ``"sig"`` on CUDA where the
    config qualifies (macro-row geometry, log output, float32) and K1
    takes its head (``k1_accepts``; power or magnitude spectra), else
    ``"rdft"``. The head is built on the CPU; no kernel runs."""
    eligible = (torch.device(device).type == "cuda"
                and sig_geometry(config.frame_length_samples,
                                 config.frame_shift_samples) is not None
                and config.use_log_fbank and dtype == torch.float32)
    if eligible and k1_accepts(sig_head(config),
                               hop=config.frame_shift_samples):
        return "sig"
    return "rdft"


class Fbank:
    """Kaldi fbank extractor for one config on one device.

    ``compute(samples)`` takes ``[T]`` or ``[B, T]`` and returns
    ``[..., num_frames, num_mel_bins]`` in the pipeline dtype (frame-major,
    like the reference). ``matrices`` replaces the host-built K1 head of
    the ``"sig"`` route (for example with the JAX package's, through
    ``convert.from_jax_head``). ``device=None`` means CUDA."""

    def __init__(self, config: FbankConfig = FbankConfig(),
                 dtype=torch.float32, fft_impl: str = "auto", device=None,
                 matrices: SigHead | None = None):
        self.device = resolve_device(device)
        geom = sig_geometry(config.frame_length_samples,
                            config.frame_shift_samples)
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
                    "(frame_length, frame_shift)"
                )
            if not config.use_log_fbank:
                raise ValueError("fft_impl='sig' emits log-fbank only")
            if dtype != torch.float32:
                raise ValueError("fft_impl='sig' is float32-only")
        self.config = config
        self.dtype = dtype
        self.fft_impl = fft_impl

        self.frame_len = config.frame_length_samples
        self.frame_shift = config.frame_shift_samples
        self.fft_size = config.fft_size
        self.fft_bins = self.fft_size // 2 + 1

        filters = kaldi_filterbank(config.sample_rate, self.fft_size,
                                   config.num_mel_bins, config.low_freq,
                                   config.effective_high_freq)
        self._filters_np = filters
        self.filters_t = torch.as_tensor(filters.T, dtype=dtype,
                                         device=self.device)
        self._window_np = povey(self.frame_len)
        self.window = torch.as_tensor(self._window_np, dtype=dtype,
                                      device=self.device)
        self.sig_head = None
        if fft_impl == "sig":
            head = sig_head(config) if matrices is None else matrices
            with profiling.span("setup.heads", head="kaldi", upload=True):
                self.sig_head = head.to(self.device)

    @property
    def dense_filterbank(self) -> np.ndarray:
        """Dense float64 Kaldi filterbank (``src/fbank.rs:243-246``)."""
        return self._filters_np

    def num_frames(self, sample_len: int) -> int:
        return framing.num_frames_batch(sample_len, self.frame_len,
                                        self.frame_shift)

    def _compute(self, x: torch.Tensor) -> torch.Tensor:
        """Features of ``x [..., T]`` (already on the device, in the
        pipeline dtype) with at least one frame."""
        return self._cmn(self._spectral(x))

    def _cmn(self, feats: torch.Tensor) -> torch.Tensor:
        """With ``apply_cmn``, each bin's mean over the frames
        subtracted."""
        if self.config.apply_cmn:
            feats = feats - feats.mean(dim=-2, keepdim=True)
        return feats

    def _spectral(self, x: torch.Tensor) -> torch.Tensor:
        """``_compute`` before the CMN."""
        cfg = self.config
        n = x.shape[-1]
        nf = self.num_frames(n)
        floor = energy_floor(cfg)
        if self.fft_impl == "sig":
            # K1: DC removal, preemphasis and the Povey window folded
            # into the head's matrices (on the float64 FFT path, applied
            # per frame); ln(max(., floor)) in the kernel
            h = self.sig_head
            lead = x.shape[:-1]
            feats = sig_mel(x.reshape((-1, n)).to(torch.float32), h, ks=3,
                            n_frames=nf, hop=self.frame_shift, offset=0)
            return feats.reshape(lead + (nf, cfg.num_mel_bins)).to(
                self.dtype)

        frames = framing.frame_signal(x, self.frame_len, self.frame_shift,
                                      nf)
        mean = frames.mean(dim=-1, keepdim=True)
        d = frames - mean  # DC removal, [..., nf, frame_len]
        if cfg.preemphasis > 0.0:
            p = cfg.preemphasis
            # in-frame: y[i] = d[i] - p*d[i-1]
            shifted = torch.cat([d[..., :1], d[..., :-1]], dim=-1)
            y = d - p * shifted
            # first sample: frame k > 0 uses samples[start-1] re-centered
            # with frame k's mean; frame 0 keeps d[0] untouched
            prev = x[..., self.frame_shift - 1 :: self.frame_shift]
            prev = prev[..., : nf - 1]  # the sample before frame k >= 1
            first = d[..., 1:, 0] - p * (prev - mean[..., 1:, 0])
            y[..., 0] = torch.cat([d[..., :1, 0], first], dim=-1)
        else:
            y = d

        xw = y * self.window
        with full_f32():
            if self.fft_impl == "hp":
                # the Povey window folded into the sliced matrices
                power = hp_rdft_power_windowed(
                    y.to(torch.float32), self._window_np, self.fft_size,
                    self.fft_bins).to(self.dtype)
            elif self.fft_impl == "rdft":
                # the zero pad to fft_size is implicit: the rDFT matrices
                # are evaluated over the first frame_len samples only
                cos_m, msin_m = dft.rdft_matrices(self.fft_size,
                                                  self.fft_bins)
                cos_t = torch.as_tensor(cos_m[: self.frame_len],
                                        dtype=self.dtype, device=x.device)
                msin_t = torch.as_tensor(msin_m[: self.frame_len],
                                         dtype=self.dtype, device=x.device)
                re = xw @ cos_t
                im = xw @ msin_t
                power = re * re + im * im
            else:
                xp = torch.nn.functional.pad(
                    xw, (0, self.fft_size - self.frame_len))
                spec = torch.fft.rfft(xp, dim=-1)
                power = (spec.real ** 2 + spec.imag ** 2).to(self.dtype)
            if not cfg.use_power:
                power = torch.sqrt(power)
            energy = power @ self.filters_t
        energy = torch.clamp_min(energy, floor)
        # [..., nf, num_mel_bins]
        return ln_best(energy, self.dtype) if cfg.use_log_fbank else energy

    def compute(self, samples,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """``samples [..., T]`` -> ``[..., num_frames, num_mel_bins]``.
        With ``config.dither > 0`` and a ``generator`` (on the pipeline's
        device), Gaussian dither scaled by ``dither`` is added first.

        Traced (``utils/profiling.py``), a call is the span ``fbank``, with
        the attrs ``k1_launches`` and ``fft_launches`` (K1's launches in
        the call, and those on its float64 FFT path), and its stages,
        which tile the features' work on the device: on the ``"sig"``
        route ``fbank.spectral`` (the K1 launch) and ``fbank.cmn`` (the
        per-bin mean and its subtraction), on the others ``fbank.plain``.
        ``_compute``, which MFCC and the frontend step call, records
        neither."""
        with profiling.span("fbank", self.device) as sp:
            launches, fft = k1.launches, k1.fft_launches
            out = self._call(samples, generator)
            sp.set(k1_launches=k1.launches - launches,
                   fft_launches=k1.fft_launches - fft)
            return out

    def _call(self, samples, generator) -> torch.Tensor:
        x = torch.as_tensor(samples, device=self.device)
        if self.num_frames(x.shape[-1]) == 0:
            return torch.zeros(x.shape[:-1] + (0, self.config.num_mel_bins),
                               dtype=self.dtype, device=self.device)
        x = x.to(self.dtype)
        if self.config.dither > 0.0 and generator is not None:
            noise = torch.randn(x.shape, generator=generator,
                                dtype=self.dtype, device=self.device)
            x = x + self.config.dither * noise
        stage = profiling.stages(self.device)
        if self.fft_impl != "sig":
            with stage("fbank.plain"):
                return self._compute(x)
        with stage("fbank.spectral"):
            feats = self._spectral(x)
        with stage("fbank.cmn"):
            return self._cmn(feats)
