"""Broad config coverage in the port, held against the JAX package on the
same numpy inputs (mirror of ``tests/test_configs_broad.py``; its mesh
cases are mirrored by ``tests/test_torch_parallel*.py``): non-16 kHz
rates, 128 mels, odd fft/hop pairs, and the wide heads K1 takes in its
2048-column and 32-frame forms (2048/512 at 22.05 kHz, librosa's default
``n_fft`` / ``hop_length``; 1024/480 at 48 kHz, LAION-CLAP's STFT;
960/480 at 48 kHz).

Bars: the float64 pipelines 1e-9 from per-frame float64 numpy (JAX's),
the ``hp`` route 1e-6 from float64 (JAX's), K1's plain version (float64
DFT dot) 3e-5 from JAX's fused kernel in interpret mode (JAX's bar
against its bf3 pipeline), ``load_audio`` bit-equal to the port's own
``resample_poly`` and 1e-6 from JAX's (``tests/test_torch_prelude.py``'s
bar)."""

import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from melspec_tpu.io import wav as jwav
from melspec_tpu.ops import mel_kernel as jmk
from melspec_tpu.ops.spectrogram import WhisperMelPipeline as JaxPipeline
from melspec_tpu_torch.config import BatchLogMelConfig, FbankConfig
from melspec_tpu_torch.io import wav
from melspec_tpu_torch.kernels import sig_mel
from melspec_tpu_torch.ops import framing, mel_kernel
from melspec_tpu_torch.ops.filterbank import mel_filterbank
from melspec_tpu_torch.ops.resample import resample_poly
from melspec_tpu_torch.ops.spectrogram import WhisperMelPipeline
from melspec_tpu_torch.ops.windows import hann_periodic

CPU = "cpu"
BROAD = [
    (400, 160, 128, 16000.0),   # whisper large-v3
    (512, 128, 64, 8000.0),
    (1024, 256, 80, 22050.0),
    (960, 480, 40, 48000.0),
    (256, 96, 32, 16000.0),     # hop not a divisor of fft
]
# the heads K1 takes in its 2048-column and 32-frame forms, beside 960/480
WIDE = [
    (2048, 512, 128, 22050.0),  # librosa's default n_fft / hop_length
    (1024, 480, 64, 48000.0),   # LAION-CLAP's STFT geometry
]


def _naive(samples, fft, hop, n_mels, sr, k):
    window = hann_periodic(fft)
    filters = mel_filterbank(sr, fft, n_mels)
    half = fft // 2
    frame = samples[k * hop : k * hop + fft].astype(np.float64)
    power = np.abs(np.fft.fft(frame * window)[:half]) ** 2
    log_mel = np.log10(np.maximum(filters[:, :half] @ power, 1e-10))
    return (np.maximum(log_mel, log_mel.max() - 8.0) + 4.0) / 4.0


@pytest.mark.parametrize("fft,hop,n_mels,sr", BROAD)
def test_whisper_pipeline_any_config(fft, hop, n_mels, sr):
    """The float64 pipeline keeps the frame grid and matches per-frame
    float64 numpy and JAX's float64 pipeline at 1e-9."""
    rng = np.random.default_rng(0)
    samples = (rng.normal(size=int(sr)) * 0.2).astype(np.float32)
    pipe = WhisperMelPipeline(fft, hop, n_mels, sr, dtype=torch.float64,
                              device=CPU)
    got = pipe.mel_batch(samples).numpy()
    nf = framing.num_frames_batch(len(samples), fft, hop)
    assert got.shape == (nf, n_mels)
    for k in [0, nf // 2, nf - 1]:
        np.testing.assert_allclose(got[k], _naive(samples, fft, hop, n_mels,
                                                  sr, k), atol=1e-9)
    want = np.asarray(JaxPipeline(fft, hop, n_mels, sr,
                                  dtype=jnp.float64).mel_batch(samples))
    np.testing.assert_allclose(got, want, atol=1e-9)


@pytest.mark.parametrize("fft,hop", [(400, 160), (1024, 256), (960, 480)])
def test_hp_path_any_config(fft, hop):
    """The exact-integer ``hp`` route in float32 within 1e-6 of float64,
    and of JAX's ``hp`` route."""
    rng = np.random.default_rng(1)
    samples = (rng.normal(size=48000) * 0.2).astype(np.float32)
    a = WhisperMelPipeline(fft, hop, 80, 16000.0, dtype=torch.float64,
                           device=CPU).mel_batch(samples).numpy()
    b = WhisperMelPipeline(fft, hop, 80, 16000.0, dtype=torch.float32,
                           fft_impl="hp", device=CPU).mel_batch(
                               samples).numpy()
    assert np.abs(a - b).max() < 1e-6
    j = np.asarray(JaxPipeline(fft, hop, 80, 16000.0, dtype=jnp.float32,
                               fft_impl="hp").mel_batch(samples))
    assert np.abs(b - j).max() < 1e-6


@pytest.mark.parametrize("fft,hop,n_mels,sr", BROAD + WIDE)
def test_sig_kernel_any_config(fft, hop, n_mels, sr):
    """K1's route at every broad config and the wide heads: both packages
    take the config (``sig_geometry``), and the port's ``whisper_mel_sig``
    (K1's plain version here) is within 3e-5 of JAX's fused kernel in
    interpret mode, and of JAX's bf3 pipeline (the same-numerics
    reference of the JAX test)."""
    assert jmk.sig_geometry(fft, hop, 0) is not None
    assert mel_kernel.sig_geometry(fft, hop, 0) == jmk.sig_geometry(fft, hop,
                                                                    0)
    rng = np.random.default_rng(fft)
    samples = (rng.normal(size=int(sr)) * 0.2).astype(np.float32)
    got = mel_kernel.whisper_mel_sig(samples, fft, hop, n_mels, sr,
                                     device=CPU).numpy()
    want = np.asarray(jmk.whisper_mel_sig(samples, fft, hop, n_mels, sr,
                                          interpret=True))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=3e-5)
    bf3 = np.asarray(JaxPipeline(fft, hop, n_mels, sr, dtype=jnp.float32,
                                 fft_impl="bf3").mel_batch(samples))
    np.testing.assert_allclose(got, bf3, atol=3e-5)


@pytest.mark.parametrize("fft,hop,n_mels,sr", WIDE + [BROAD[3]])
def test_wide_heads_are_k1_shapes(fft, hop, n_mels, sr):
    """K1's shape check takes the wide whisper heads (1024 and 2048 split
    columns); K2's, which keeps to 1024 columns, refuses the 2048 one."""
    head = mel_kernel.whisper_head(fft, n_mels, sr, CPU)
    width = head.m_big.shape[1]
    assert width == (2048 if fft == 2048 else 1024)
    assert head.n_bins_pad == width // 2
    assert sig_mel.shape_refusal(width, head.n_bins_pad, head.mt.shape[1],
                                 "K1") is None
    from melspec_tpu_torch.kernels import sig_multi

    k2 = sig_mel.shape_refusal(width, head.n_bins_pad, head.mt.shape[1],
                               "K2", sig_multi.WIDTHS)
    assert (k2 is None) == (width <= 1024)


def test_shape_refusal_takes_2048_columns():
    assert sig_mel.shape_refusal(2048, 1024, 128, "K1") is None


def test_config_frequency_validation():
    """Descending mel grids fail at construction, as in JAX."""
    with pytest.raises(ValueError):
        BatchLogMelConfig(f_min=9000.0)       # > default Nyquist
    with pytest.raises(ValueError):
        BatchLogMelConfig(f_max=9000.0)       # > Nyquist
    with pytest.raises(ValueError):
        FbankConfig(low_freq=9000.0)
    with pytest.raises(ValueError):
        FbankConfig(frame_shift_ms=0.0)
    BatchLogMelConfig(f_min=20.0, f_max=7600.0)
    FbankConfig(low_freq=20.0, high_freq=7600.0)


def _wav_header(fmt, channels, rate, bits, payload):
    block = channels * bits // 8
    return (b"RIFF" + struct.pack("<I", 36 + len(payload)) + b"WAVE"
            + b"fmt " + struct.pack("<IHHIIHH", 16, fmt, channels, rate,
                                    rate * block, block, bits)
            + b"data" + struct.pack("<I", len(payload)))


def test_wav_reader_rejects_misdeclared_formats(tmp_path):
    """int16 PCM is not read as float32; a 24-bit file raises in both
    packages."""
    from pathlib import Path

    pcm16 = (Path(__file__).resolve().parents[1] / "testdata" / "ten-vad"
             / "testset-audio-01.wav")
    with pytest.raises(ValueError):
        wav.read_wav_f32le(pcm16)
    payload = b"\x00\x01\x02" * 300
    p = tmp_path / "pcm24.wav"
    p.write_bytes(_wav_header(1, 1, 16000, 24, payload) + payload)
    for mod in (wav, jwav):
        with pytest.raises(ValueError):
            mod.read_wav_mono(p)


def test_load_audio_resamples_to_target(tmp_path):
    """``load_audio`` resamples a 48 kHz file to the target: bit-equal to
    the port's ``resample_poly``, 1e-6 from JAX's ``load_audio``; native
    passthrough where the rates match or the target is None; a coprime
    pair raises."""
    t = np.arange(48000 * 2, dtype=np.float32) / 48000
    tone = (0.25 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    payload = tone.tobytes()
    p = tmp_path / "tone48k.wav"
    p.write_bytes(_wav_header(3, 1, 48000, 32, payload) + payload)

    got = wav.load_audio(p, device=CPU)
    want = resample_poly(tone, 1, 3, device=CPU).numpy().astype(np.float32)
    assert got.shape == want.shape == (32000,)
    np.testing.assert_array_equal(got, want)
    assert np.abs(got - jwav.load_audio(p)).max() <= 1e-6
    np.testing.assert_array_equal(wav.load_audio(p, target_rate=None), tone)
    np.testing.assert_array_equal(wav.load_audio(p, target_rate=48000), tone)
    with pytest.raises(ValueError, match="polyphase matrix"):
        wav.load_audio(p, target_rate=44101, device=CPU)


def test_load_audio_downmixes_stereo(tmp_path):
    """Stereo files downmix to the channel mean (bit-equal to JAX's);
    ``read_wav_mono`` still rejects them."""
    left = (0.2 * np.sin(np.arange(16000) / 30)).astype(np.float32)
    right = (0.1 * np.cos(np.arange(16000) / 17)).astype(np.float32)
    inter = np.empty(32000, np.float32)
    inter[0::2], inter[1::2] = left, right
    payload = inter.tobytes()
    p = tmp_path / "stereo.wav"
    p.write_bytes(_wav_header(3, 2, 16000, 32, payload) + payload)

    data, rate = wav.read_wav(p)
    assert data.shape == (16000, 2) and rate == 16000
    np.testing.assert_array_equal(data[:, 0], left)
    np.testing.assert_array_equal(data[:, 1], right)
    got = wav.load_audio(p, device=CPU)
    want = ((left.astype(np.float64) + right) / 2).astype(np.float32)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jwav.load_audio(p))
    with pytest.raises(ValueError, match="not mono"):
        wav.read_wav_mono(p)
