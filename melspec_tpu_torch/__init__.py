"""melspec_tpu_torch — the PyTorch + CUDA port of ``melspec_tpu``.

Whisper log-mel from raw ``[B, T]`` float32 audio, held against the JAX
package on identical inputs. The fused route runs kernel K1, written by
hand in CUDA C++ for Hopper (``csrc/sig_mel.cu``), built with ``nvcc`` at
its first launch; on the CPU the same functions run their plain PyTorch
versions. Every entry point takes ``device=None``, meaning CUDA: a host
without CUDA raises unless the caller asks for ``device="cpu"``.

The port imports ``torch`` and numpy, never ``jax`` and nothing of
``melspec_tpu``.
"""

__version__ = "0.1.0"

from melspec_tpu_torch.config import WHISPER_LARGE_V3, MelConfig
from melspec_tpu_torch.convert import from_jax_sig_matrices
from melspec_tpu_torch.io.wav import read_wav_f32le
from melspec_tpu_torch.ops.mel_kernel import (SigMatrices, whisper_mel_pallas,
                                              whisper_mel_sig)
from melspec_tpu_torch.ops.spectrogram import (WhisperMelPipeline,
                                               compute_mel_spectrogram,
                                               compute_streaming_mel,
                                               whisper_norm)

__all__ = [
    "MelConfig",
    "SigMatrices",
    "WHISPER_LARGE_V3",
    "WhisperMelPipeline",
    "__version__",
    "compute_mel_spectrogram",
    "compute_streaming_mel",
    "from_jax_sig_matrices",
    "read_wav_f32le",
    "whisper_mel_pallas",
    "whisper_mel_sig",
    "whisper_norm",
]
