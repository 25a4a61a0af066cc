"""Kaldi-style MFCC: cepstra over the fbank pipeline (port of
``melspec_tpu.ops.mfcc``).

The orthonormal DCT-II (Kaldi's ``ComputeDctMatrix``: ``M[0, n] =
sqrt(1/N)``, ``M[k, n] = sqrt(2/N) cos(pi/N (n + 0.5) k)``) with the
cepstral lifter ``1 + 0.5 L sin(pi k / L)`` folded into its rows, applied
as one ``[n_mels, num_ceps]`` projection behind ``Fbank`` (``apply_cmn``
off: Kaldi's MFCC never mean-normalizes the fbank); optional CMN over the
cepstra.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from melspec_tpu_torch._device import full_f32
from melspec_tpu_torch.config import MfccConfig
from melspec_tpu_torch.ops.fbank import Fbank

__all__ = ["Mfcc", "cepstral_lifter_coeffs", "dct_matrix"]


def dct_matrix(num_ceps: int, n_mels: int) -> np.ndarray:
    """Orthonormal DCT-II rows ``[num_ceps, n_mels]`` (float64), Kaldi's
    ``ComputeDctMatrix`` normalization."""
    n = np.arange(n_mels, dtype=np.float64)
    k = np.arange(num_ceps, dtype=np.float64)[:, None]
    m = np.sqrt(2.0 / n_mels) * np.cos(np.pi / n_mels * (n + 0.5) * k)
    m[0] = np.sqrt(1.0 / n_mels)
    return m


def cepstral_lifter_coeffs(num_ceps: int, lifter: float) -> np.ndarray:
    """Kaldi's cepstral lifter ``1 + 0.5 L sin(pi k / L)`` (float64;
    all ones when ``lifter == 0``)."""
    if lifter == 0.0:
        return np.ones(num_ceps, dtype=np.float64)
    k = np.arange(num_ceps, dtype=np.float64)
    return 1.0 + 0.5 * lifter * np.sin(np.pi * k / lifter)


class Mfcc:
    """MFCC frontend: ``compute(samples [..., T])`` -> ``[..., num_frames,
    num_ceps]`` in the pipeline dtype. ``fft_impl`` and ``device`` go to
    the underlying :class:`Fbank` ("auto": kernel K1 on CUDA)."""

    def __init__(self, config: MfccConfig = MfccConfig(),
                 dtype=torch.float32, fft_impl: str = "auto", device=None):
        self.config = config
        self.dtype = dtype
        # MfccConfig validates this, but a duck-typed config must not
        # double the CMN
        fb_cfg = dataclasses.replace(config.fbank, apply_cmn=False)
        self._fbank = Fbank(fb_cfg, dtype=dtype, fft_impl=fft_impl,
                            device=device)
        self.device = self._fbank.device
        m = dct_matrix(config.num_ceps, fb_cfg.num_mel_bins)
        m = m * cepstral_lifter_coeffs(config.num_ceps,
                                       config.cepstral_lifter)[:, None]
        self._dct_t = torch.as_tensor(m.T, dtype=dtype, device=self.device)

    @property
    def fbank(self) -> Fbank:
        return self._fbank

    def compute(self, samples) -> torch.Tensor:
        x = torch.as_tensor(samples, device=self.device)
        if x.shape[-1] == 0:
            return torch.zeros(x.shape[:-1] + (0, self.config.num_ceps),
                               dtype=self.dtype, device=self.device)
        feats = self._fbank._compute(x.to(self.dtype))  # [..., F, n_mels]
        with full_f32():
            ceps = feats @ self._dct_t
        if self.config.apply_cmn:
            ceps = ceps - ceps.mean(dim=-2, keepdim=True)
        return ceps
