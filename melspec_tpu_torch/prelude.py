"""Curated public API surface (port of ``melspec_tpu.prelude``; the
reference's ``src/prelude.rs:1-23``): the same 76 names, each the port's
counterpart.

Import everything a typical user needs::

    from melspec_tpu_torch.prelude import *
"""

from melspec_tpu_torch.config import (
    BatchLogMelConfig,
    DetectionSettings,
    FbankConfig,
    MelConfig,
    WHISPER_LARGE_V3,
    MfccConfig,
    VadFrameTiming,
    VoiceActivityTimestamps,
)
from melspec_tpu_torch.io.tga import (
    chunk_frames_into_strides,
    interleave_frames,
    load_tga_8bit,
    parse_tga_8bit,
    save_tga_8bit,
    tga_8bit,
    tga_8bit_data,
    to_array2,
)
from melspec_tpu_torch.io.wav import (load_audio, read_wav,
                                      read_wav_f32le, read_wav_mono)
from melspec_tpu_torch.ops.batch_logmel import (BatchLogMel, mel_tensor,
                                                run_asr_session)
from melspec_tpu_torch.ops.fbank import Fbank
from melspec_tpu_torch.ops.mfcc import Mfcc
from melspec_tpu_torch.ops.filterbank import (
    SparseFilterbankView,
    fft_frequencies,
    hz_to_mel,
    kaldi_filterbank,
    mel,
    mel_filterbank,
    mel_frequencies,
    mel_to_hz,
    mels_to_hz,
)
from melspec_tpu_torch.ops.mel_kernel import (whisper_mel_pallas,
                                              whisper_mel_quantized,
                                              whisper_mel_sig)
from melspec_tpu_torch.ops.quant import (
    QuantizationRange,
    dequantize,
    quantize,
)
from melspec_tpu_torch.ops.resample import (
    StreamingResampler,
    resample_poly,
    validate_ratio,
)
from melspec_tpu_torch.ops.spectrogram import (
    MelProjection,
    WhisperMelPipeline,
    compute_mel_spectrogram,
    compute_streaming_mel,
    log_mel_spectrogram,
    norm_mel,
    norm_mel_vec,
    whisper_norm,
)
from melspec_tpu_torch.ops.vad import (
    EdgeInfo,
    VoiceActivity,
    as_image,
    streaming_decisions,
    vad_boundaries,
    vad_on,
)
from melspec_tpu_torch.runtime import SampleRing
from melspec_tpu_torch.streaming.multistream import (MultiStreamMel,
                                                     MultiStreamState)
from melspec_tpu_torch.streaming.pipeline import RingBuffer
from melspec_tpu_torch.streaming.resample import MultiStreamResampler
from melspec_tpu_torch.streaming.serving import (MultiStreamFrontend,
                                                 MultiStreamVad,
                                                 SourceRateFrontend)
from melspec_tpu_torch.streaming.speech_to_mel import SpeechToMel
from melspec_tpu_torch.streaming.state_io import (load_stream_state,
                                                  save_stream_state)
from melspec_tpu_torch.streaming.stft import (StftState, StreamingMel,
                                              StreamingStft)
from melspec_tpu_torch.streaming.vad import VoiceActivityDetector
from melspec_tpu_torch.utils.instances import shared_instance
from melspec_tpu_torch.utils.timing import (
    duration_ms_for_n_frames,
    format_milliseconds,
    n_frames_for_duration,
)

__all__ = [
    "BatchLogMel",
    "BatchLogMelConfig",
    "DetectionSettings",
    "EdgeInfo",
    "Fbank",
    "Mfcc",
    "MfccConfig",
    "FbankConfig",
    "MelConfig",
    "WHISPER_LARGE_V3",
    "MelProjection",
    "MultiStreamFrontend",
    "MultiStreamMel",
    "MultiStreamResampler",
    "MultiStreamState",
    "MultiStreamVad",
    "SourceRateFrontend",
    "QuantizationRange",
    "RingBuffer",
    "SampleRing",
    "SparseFilterbankView",
    "SpeechToMel",
    "StftState",
    "StreamingMel",
    "StreamingResampler",
    "StreamingStft",
    "VadFrameTiming",
    "VoiceActivity",
    "VoiceActivityDetector",
    "VoiceActivityTimestamps",
    "WhisperMelPipeline",
    "as_image",
    "chunk_frames_into_strides",
    "compute_mel_spectrogram",
    "compute_streaming_mel",
    "dequantize",
    "duration_ms_for_n_frames",
    "fft_frequencies",
    "format_milliseconds",
    "hz_to_mel",
    "interleave_frames",
    "kaldi_filterbank",
    "load_tga_8bit",
    "load_audio",
    "load_stream_state",
    "log_mel_spectrogram",
    "mel",
    "mel_filterbank",
    "mel_frequencies",
    "mel_tensor",
    "run_asr_session",
    "mel_to_hz",
    "mels_to_hz",
    "n_frames_for_duration",
    "norm_mel",
    "norm_mel_vec",
    "parse_tga_8bit",
    "quantize",
    "read_wav",
    "read_wav_f32le",
    "read_wav_mono",
    "resample_poly",
    "validate_ratio",
    "save_stream_state",
    "shared_instance",
    "save_tga_8bit",
    "streaming_decisions",
    "tga_8bit",
    "tga_8bit_data",
    "to_array2",
    "vad_boundaries",
    "vad_on",
    "whisper_mel_pallas",
    "whisper_mel_quantized",
    "whisper_mel_sig",
    "whisper_norm",
]
