"""Analysis windows, built on the host in float64 (numpy copy of
``melspec_tpu.ops.windows``; the NeMo and Kaldi windows come with their
frontends)."""

from __future__ import annotations

import numpy as np


def hann_periodic(fft_size: int) -> np.ndarray:
    """Periodic Hann window of length ``fft_size`` (float64)."""
    i = np.arange(fft_size, dtype=np.float64)
    return 0.5 * (1.0 - np.cos(2.0 * np.pi * i / fft_size))
