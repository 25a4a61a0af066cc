"""NeMo's TTS mel (``FilterbankFeatures`` as FastPitch and HiFi-GAN
configure it) as plain tensor code, on the helpers of ``features.py``.

``exact_pad``: the wave reflect-padded by ``(n_fft - hop) // 2`` samples
on each side and framed without centring, ``(T + 2 pad - n_fft) // hop +
1`` frames (``T // hop`` where ``n_fft - hop`` is even); a symmetric Hann
of ``win_length`` centred in the ``n_fft``-point frame; the magnitude
``sqrt(re^2 + im^2)`` of the ``n_fft // 2 + 1`` bins (``mag_power`` 1);
Slaney filters from ``f_min`` to ``f_max``; ``ln(max(e, guard))``
(``log_zero_guard_type`` clamp); ``[B, n_mels, F]``. With ``precision``
``"tf32"`` both products (the DFT and the filterbank) take TF32 operands
(``precision.py``), the control."""

from __future__ import annotations

import torch

from portbench.reference.features import (dft_tables, frames_of,
                                          hann_symmetric, slaney_filters)
from portbench.reference.precision import dtype_of, matmul


def tts_log_mel(x: torch.Tensor, cfg: dict, precision: str) -> torch.Tensor:
    """``x [B, T]`` (any device) -> ``[B, n_mels, F]`` in the precision's
    dtype, for ``cfg`` the configuration's ``nemo`` settings."""
    states = (cfg["mag_power"], cfg["log_zero_guard_type"], cfg["exact_pad"])
    if states != (1.0, "clamp", True):
        raise ValueError(f"tts_log_mel computes mag_power 1.0, the clamp "
                         f"guard and exact_pad; the configuration states "
                         f"{states}")
    dt = dtype_of(precision)
    n_fft, win, hop = cfg["n_fft"], cfg["win_length"], cfg["hop_length"]
    pad = (n_fft - hop) // 2
    x = torch.nn.functional.pad(x.to(dt), (pad, pad), mode="reflect")
    n_frames = (x.shape[-1] - n_fft) // hop + 1
    first = (n_fft - win) // 2
    fr = frames_of(x, win, hop, n_frames, offset=first)
    cos_t, sin_t = (torch.as_tensor(t, device=x.device) for t in dft_tables(
        n_fft, win, first, n_fft // 2 + 1, hann_symmetric(win)))
    re = matmul(fr, cos_t, precision)
    im = matmul(fr, sin_t, precision)
    mag = torch.sqrt(re * re + im * im)
    filt = torch.as_tensor(slaney_filters(float(cfg["sample_rate"]), n_fft,
                                          cfg["n_mels"], cfg["f_min"],
                                          cfg["f_max"]).T, device=x.device)
    energy = matmul(mag, filt, precision)
    return torch.log(torch.clamp_min(energy, float(cfg["log_zero_guard"]))
                     ).transpose(-1, -2)
