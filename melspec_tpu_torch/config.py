"""Frontend configuration (a copy of ``melspec_tpu.config``'s
``MelConfig``, its named whisper configs, the NeMo, Kaldi fbank and MFCC
configs, the VAD's ``DetectionSettings`` and its timestamps,
``VadFrameTiming`` / ``VoiceActivityTimestamps``; the port keeps its own
copy so that it imports nothing of the JAX package)."""

from __future__ import annotations

import dataclasses
import math
from typing import Optional


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
class BatchLogMelConfig:
    """NeMo/Parakeet-style batch log-mel config (reference
    ``src/mel.rs:189-208``, validation ``src/mel.rs:656-683``): 16 kHz,
    n_fft 512, win_length 400, hop 160, 80 mels, Slaney norm, center zero
    padding, natural log with a float32-epsilon guard.

    NeMo's ``FilterbankFeatures`` options beyond the reference's:
    ``mag_power`` 2.0 (power spectra) or 1.0 (magnitude, ``sqrt(re^2 +
    im^2)``, as NeMo's TTS configurations take); ``log_zero_guard_type``
    ``"add"`` (``ln(e + guard)``) or ``"clamp"`` (``ln(max(e, guard))``);
    ``exact_pad``: the wave reflect-padded by ``(n_fft - hop_length) //
    2`` on each side and framed without centring, ``T // hop_length``
    frames (NeMo's ``stft_pad_amount``), which excludes ``center``."""

    sample_rate: int = 16000
    n_fft: int = 512
    win_length: int = 400
    hop_length: int = 160
    n_mels: int = 80
    f_min: float = 0.0
    f_max: Optional[float] = None
    htk: bool = False
    norm: bool = True
    preemphasis: float = 0.0
    center: bool = True
    log_zero_guard: float = 1.1920929e-07  # f32 machine epsilon
    pad_to: int = 0
    normalize_per_feature: bool = False
    mag_power: float = 2.0
    log_zero_guard_type: str = "add"
    exact_pad: bool = False

    def __post_init__(self) -> None:
        if self.sample_rate <= 0:
            raise ValueError("sample_rate must be > 0")
        if self.n_fft <= 0:
            raise ValueError("n_fft must be > 0")
        if self.win_length <= 0:
            raise ValueError("win_length must be > 0")
        if self.win_length > self.n_fft:
            raise ValueError("win_length must be <= n_fft")
        if self.hop_length <= 0:
            raise ValueError("hop_length must be > 0")
        if self.n_mels <= 0:
            raise ValueError("n_mels must be > 0")
        if self.f_min < 0:
            raise ValueError("f_min must be >= 0")
        eff_max = (self.sample_rate / 2.0 if self.f_max is None
                   else self.f_max)
        if not self.f_min < eff_max <= self.sample_rate / 2.0:
            raise ValueError(
                f"need f_min < f_max <= Nyquist (got f_min={self.f_min}, "
                f"effective f_max={eff_max}, Nyquist={self.sample_rate / 2})"
            )
        if not math.isfinite(self.log_zero_guard) or self.log_zero_guard <= 0:
            raise ValueError("log_zero_guard must be finite and > 0")
        if self.mag_power not in (1.0, 2.0):
            raise ValueError(
                f"mag_power must be 1.0 or 2.0 (got {self.mag_power})")
        if self.log_zero_guard_type not in ("add", "clamp"):
            raise ValueError(
                f"log_zero_guard_type must be 'add' or 'clamp' (got "
                f"{self.log_zero_guard_type!r})")
        if self.exact_pad and self.center:
            raise ValueError("exact_pad excludes center: set center=False")

    @property
    def fft_bins(self) -> int:
        return self.n_fft // 2 + 1

    @property
    def magnitude(self) -> bool:
        """Whether the spectra are magnitudes (``mag_power`` 1)."""
        return self.mag_power == 1.0

    @property
    def exact_pad_amount(self) -> int:
        """Samples of reflect padding on each side under ``exact_pad``."""
        return (self.n_fft - self.hop_length) // 2

    @property
    def effective_f_max(self) -> float:
        return self.f_max if self.f_max is not None else self.sample_rate / 2.0


@dataclasses.dataclass(frozen=True)
class FbankConfig:
    """Kaldi-compatible fbank config (reference ``src/fbank.rs:24-82``)."""

    sample_rate: float = 16000.0
    num_mel_bins: int = 80
    frame_length_ms: float = 25.0
    frame_shift_ms: float = 10.0
    dither: float = 0.0
    energy_floor: float = 0.0  # 0 -> f32 epsilon internally, like kaldi
    use_energy: bool = False
    use_log_fbank: bool = True
    use_power: bool = True
    preemphasis: float = 0.97
    apply_cmn: bool = True
    low_freq: float = 20.0
    high_freq: float = 0.0  # 0 means Nyquist (src/fbank.rs:108-112)

    def __post_init__(self) -> None:
        if self.sample_rate <= 0:
            raise ValueError("sample_rate must be > 0")
        if self.num_mel_bins <= 0:
            raise ValueError("num_mel_bins must be > 0")
        if self.frame_length_ms <= 0 or self.frame_shift_ms <= 0:
            raise ValueError("frame lengths must be > 0 ms")
        eff_high = (self.sample_rate / 2.0 if self.high_freq == 0.0
                    else self.high_freq)
        if not 0 <= self.low_freq < eff_high <= self.sample_rate / 2.0:
            raise ValueError(
                f"need 0 <= low_freq < high_freq <= Nyquist (got "
                f"low={self.low_freq}, effective high={eff_high}, "
                f"Nyquist={self.sample_rate / 2})"
            )

    @property
    def frame_length_samples(self) -> int:
        return int(round((self.frame_length_ms / 1000.0) * self.sample_rate))

    @property
    def frame_shift_samples(self) -> int:
        return int(round((self.frame_shift_ms / 1000.0) * self.sample_rate))

    @property
    def fft_size(self) -> int:
        n = self.frame_length_samples
        size = 1
        while size < n:
            size <<= 1
        return size

    @property
    def effective_high_freq(self) -> float:
        return self.sample_rate / 2.0 if self.high_freq == 0.0 else self.high_freq


def _mfcc_fbank_default() -> "FbankConfig":
    # Kaldi MfccOptions defaults: 23 mel bins feed the DCT; MFCC never
    # mean-normalizes the fbank stage itself (CMN applies to the cepstra)
    return FbankConfig(num_mel_bins=23, apply_cmn=False)


@dataclasses.dataclass(frozen=True)
class MfccConfig:
    """Kaldi-style MFCC config: 13 cepstra from 23 mel bins, cepstral
    lifter 22.0 (Kaldi's ``MfccOptions``). ``fbank.apply_cmn`` must stay
    False (CMN applies to the cepstra); ``use_energy`` is not supported."""

    num_ceps: int = 13
    cepstral_lifter: float = 22.0
    apply_cmn: bool = True
    fbank: FbankConfig = dataclasses.field(
        default_factory=_mfcc_fbank_default)

    def __post_init__(self) -> None:
        if not 1 <= self.num_ceps <= self.fbank.num_mel_bins:
            raise ValueError(
                f"need 1 <= num_ceps <= num_mel_bins (got "
                f"{self.num_ceps} vs {self.fbank.num_mel_bins})")
        if self.cepstral_lifter < 0:
            raise ValueError("cepstral_lifter must be >= 0")
        if self.fbank.apply_cmn:
            raise ValueError(
                "MfccConfig.fbank.apply_cmn must be False: CMN applies "
                "to the cepstra (MfccConfig.apply_cmn), not the fbank")
        if self.fbank.use_energy:
            raise ValueError("use_energy is not supported for MFCC")


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


@dataclasses.dataclass(frozen=True)
class VadFrameTiming:
    """Maps STFT frame indices to start/center/end milliseconds
    (reference ``src/vad.rs:90-117``)."""

    fft_size: int
    hop_size: int
    sampling_rate: float

    def timestamps_for_frame(self, frame_index: int) -> "VoiceActivityTimestamps":
        start_sample = frame_index * self.hop_size
        center_sample = start_sample + self.fft_size // 2
        end_sample = start_sample + self.fft_size

        def to_ms(sample: int) -> int:
            # round half away from zero (Rust f64::round), not banker's
            return int(math.floor((sample / self.sampling_rate) * 1000.0 + 0.5))

        return VoiceActivityTimestamps(
            start_ms=to_ms(start_sample),
            center_ms=to_ms(center_sample),
            end_ms=to_ms(end_sample),
        )


@dataclasses.dataclass(frozen=True)
class VoiceActivityTimestamps:
    start_ms: int
    center_ms: int
    end_ms: int
