"""Real DFT as dense matmuls (port of ``melspec_tpu.ops.dft``).

The matrices are built once on the host in float64 and cast to the
pipeline dtype. A float32 ``torch.matmul`` runs in full float32 unless the
caller enables TF32 (``torch.backends.cuda.matmul.allow_tf32``), which is
the counterpart of the JAX package's ``Precision.HIGHEST`` default.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


@functools.lru_cache(maxsize=32)
def rdft_matrices(fft_size: int, n_bins: int) -> Tuple[np.ndarray, np.ndarray]:
    """``(cos, -sin)`` matrices ``[fft_size, n_bins]`` (float64):
    ``re = x @ cos``, ``im = x @ msin``, the ``numpy.fft.rfft`` layout for
    ``k < n_bins``."""
    n = np.arange(fft_size, dtype=np.float64)[:, None]
    k = np.arange(n_bins, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * k / fft_size
    return np.cos(ang), -np.sin(ang)


def rfft_via_matmul(
    frames: torch.Tensor,
    fft_size: int,
    n_bins: int,
    dtype=torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(re, im) of the rFFT over the first ``n_bins`` bins via matmuls."""
    cos_m, msin_m = rdft_matrices(fft_size, n_bins)
    frames = frames.to(dtype)
    cos_t = torch.as_tensor(cos_m, dtype=dtype, device=frames.device)
    msin_t = torch.as_tensor(msin_m, dtype=dtype, device=frames.device)
    return frames @ cos_t, frames @ msin_t


def rdft_power(
    frames: torch.Tensor,
    fft_size: int,
    n_bins: int,
    dtype=torch.float32,
) -> torch.Tensor:
    """Power spectrum ``|rfft(frames)|**2`` over the first ``n_bins`` bins.
    ``frames`` is ``[..., fft_size]``; returns ``[..., n_bins]``."""
    re, im = rfft_via_matmul(frames, fft_size, n_bins, dtype)
    return re * re + im * im
