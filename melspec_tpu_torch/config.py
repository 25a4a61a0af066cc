"""Frontend configuration (a copy of ``melspec_tpu.config``'s
``MelConfig``, its named whisper configs and the VAD's
``DetectionSettings``; the port keeps its own copy so that it imports
nothing of the JAX package)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MelConfig:
    """Whisper-style mel config (reference ``src/config.rs:2-34``)."""

    fft_size: int = 400
    hop_size: int = 160
    n_mels: int = 80
    sampling_rate: float = 16000.0

    def __post_init__(self) -> None:
        if self.fft_size <= 0:
            raise ValueError("fft_size must be > 0")
        if self.hop_size <= 0:
            raise ValueError("hop_size must be > 0")
        if self.hop_size > self.fft_size:
            raise ValueError("hop_size must be <= fft_size")
        if self.n_mels <= 0:
            raise ValueError("n_mels must be > 0")
        if self.sampling_rate <= 0:
            raise ValueError("sampling_rate must be > 0")


# Current Whisper deployments (large-v3, large-v3-turbo) use 128 mel bins
# on the 400/160 grid; whisper <= v2 uses 80 (the MelConfig default).
WHISPER_LARGE_V3 = MelConfig(400, 160, 128, 16000.0)


@dataclasses.dataclass(frozen=True)
class DetectionSettings:
    """Sobel-edge VAD settings (reference ``src/vad.rs:5-81``).

    - ``min_energy``: squared-gradient threshold base; gradients with squared
      magnitude >= min_energy**2 count as edges.
    - ``min_y``: minimum number of mel rows a column's gradients must cross.
    - ``min_x``: sliding window width in frames for streaming decisions.
    - ``min_mel``: ignore mel rows below this index (low-frequency noise).
    """

    min_energy: float = 0.98
    min_y: int = 11
    min_x: int = 5
    min_mel: int = 2
