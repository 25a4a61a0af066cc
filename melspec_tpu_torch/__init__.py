"""melspec_tpu_torch — the PyTorch + CUDA port of ``melspec_tpu``.

Whisper log-mel, Kaldi fbank, MFCC and NeMo log-mel from raw ``[B, T]``
float32 audio, the composite frontend step (whisper + Kaldi + VAD + NeMo
+ u8 in one call), the serving tick (ingest resampling -> streaming mel
-> streaming VAD -> u8 records for many streams at once), and the
model-free VAD with timestamps, the u8 wire records and the TGA
interchange format, with the TEN-VAD harness; held against the JAX
package on identical inputs. The kernels are written by hand in CUDA C++
for Hopper: K1 (``csrc/sig_mel.cu``, one frontend's fused features, with
the u8-record and Sobel VAD epilogues), K2 (``csrc/sig_multi.cu``,
several frontends over one staging of the signal), K3/K4
(``csrc/resample.cu``, the resampler), K5-K8 (``csrc/framed_ozaki.cu``,
the precision dial of ``whisper_mel_pallas``) and the probe P1
(``csrc/load_probe.cu``), each built with ``nvcc`` at its first launch;
on the CPU the same functions run their plain PyTorch versions. Every entry point takes
``device=None``, meaning CUDA: a host without CUDA raises unless the
caller asks for ``device="cpu"``.

The port imports ``torch`` and numpy, never ``jax`` and nothing of
``melspec_tpu``.
"""

__version__ = "0.1.0"

from melspec_tpu_torch.config import (WHISPER_LARGE_V3, BatchLogMelConfig,
                                      DetectionSettings, FbankConfig,
                                      MelConfig, MfccConfig, VadFrameTiming,
                                      VoiceActivityTimestamps)
from melspec_tpu_torch.convert import (from_jax_framed_matrices,
                                       from_jax_frontend_state,
                                       from_jax_head, from_jax_sig_matrices,
                                       from_jax_source_rate_state)
from melspec_tpu_torch.io.tga import (chunk_frames_into_strides,
                                      interleave_frames, load_tga_8bit,
                                      parse_tga_8bit, save_tga_8bit, tga_8bit,
                                      tga_8bit_data, to_array2)
from melspec_tpu_torch.io.wav import read_wav, read_wav_f32le, read_wav_mono
from melspec_tpu_torch.ops.batch_logmel import (BatchLogMel, mel_tensor,
                                                run_asr_session)
from melspec_tpu_torch.ops.fbank import Fbank
from melspec_tpu_torch.ops.mel_kernel import (FramedMatrices, SigHead,
                                              SigMatrices,
                                              whisper_mel_pallas,
                                              whisper_mel_quantized,
                                              whisper_mel_sig)
from melspec_tpu_torch.ops.mfcc import Mfcc
from melspec_tpu_torch.ops.quant import (QuantizationRange, dequantize,
                                         quantize, quantize_frames)
from melspec_tpu_torch.ops.resample import (StreamingResampler,
                                            resample_poly, validate_ratio)
from melspec_tpu_torch.ops.sig_multihead import (WhisperKaldiFused,
                                                 WhisperKaldiNemoFused)
from melspec_tpu_torch.ops.spectrogram import (WhisperMelPipeline,
                                               compute_mel_spectrogram,
                                               compute_streaming_mel,
                                               whisper_norm)
from melspec_tpu_torch.ops.vad import (EdgeInfo, VoiceActivity, as_image,
                                       streaming_decisions, vad_boundaries,
                                       vad_on)
from melspec_tpu_torch.parallel.sharding import sharded_frontend_step
from melspec_tpu_torch.streaming.multistream import MultiStreamMel
from melspec_tpu_torch.streaming.resample import MultiStreamResampler
from melspec_tpu_torch.streaming.serving import (MultiStreamFrontend,
                                                 MultiStreamVad,
                                                 SourceRateFrontend,
                                                 calibrate_fft_impl,
                                                 shared_frontend)
from melspec_tpu_torch.streaming.state_io import (load_stream_state,
                                                  save_stream_state)
from melspec_tpu_torch.streaming.vad import VoiceActivityDetector
from melspec_tpu_torch.utils.timing import (duration_ms_for_n_frames,
                                            format_milliseconds,
                                            n_frames_for_duration)

__all__ = [
    "BatchLogMel",
    "BatchLogMelConfig",
    "DetectionSettings",
    "EdgeInfo",
    "Fbank",
    "FbankConfig",
    "FramedMatrices",
    "MelConfig",
    "Mfcc",
    "MfccConfig",
    "MultiStreamFrontend",
    "MultiStreamMel",
    "MultiStreamResampler",
    "MultiStreamVad",
    "QuantizationRange",
    "SigHead",
    "SigMatrices",
    "SourceRateFrontend",
    "StreamingResampler",
    "VadFrameTiming",
    "VoiceActivity",
    "VoiceActivityDetector",
    "VoiceActivityTimestamps",
    "WHISPER_LARGE_V3",
    "WhisperKaldiFused",
    "WhisperKaldiNemoFused",
    "WhisperMelPipeline",
    "__version__",
    "as_image",
    "calibrate_fft_impl",
    "chunk_frames_into_strides",
    "compute_mel_spectrogram",
    "compute_streaming_mel",
    "dequantize",
    "duration_ms_for_n_frames",
    "format_milliseconds",
    "from_jax_framed_matrices",
    "from_jax_frontend_state",
    "from_jax_head",
    "from_jax_sig_matrices",
    "from_jax_source_rate_state",
    "interleave_frames",
    "load_stream_state",
    "load_tga_8bit",
    "mel_tensor",
    "n_frames_for_duration",
    "parse_tga_8bit",
    "quantize",
    "quantize_frames",
    "read_wav",
    "read_wav_f32le",
    "read_wav_mono",
    "resample_poly",
    "run_asr_session",
    "save_stream_state",
    "save_tga_8bit",
    "sharded_frontend_step",
    "shared_frontend",
    "streaming_decisions",
    "tga_8bit",
    "tga_8bit_data",
    "to_array2",
    "vad_boundaries",
    "vad_on",
    "validate_ratio",
    "whisper_mel_pallas",
    "whisper_mel_quantized",
    "whisper_mel_sig",
    "whisper_norm",
]
