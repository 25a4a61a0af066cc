"""The direct FFT-frame API in the port (mirror of
``tests/test_direct_fft_api.py``), each contract also held against the
JAX package on the same inputs: ``MelProjection.add`` on a complex frame,
``log_mel_spectrogram`` zeroing the bins at and above fft/2,
``StreamingStft`` + ``MelProjection`` composing to the fused streaming
mel (float64, 1e-6 as in JAX; the JAX reference's own output is float32),
and the whisper-norm aliases."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import torch

from melspec_tpu.ops import spectrogram as jspec
from melspec_tpu_torch.io.wav import read_wav_f32le
from melspec_tpu_torch.ops.filterbank import mel_filterbank
from melspec_tpu_torch.ops.spectrogram import (MelProjection,
                                               compute_streaming_mel,
                                               log_mel_spectrogram, norm_mel,
                                               norm_mel_vec)
from melspec_tpu_torch.streaming.stft import StreamingStft

TESTDATA = Path(__file__).resolve().parents[1] / "testdata"


def test_direct_fft_to_mel_contract():
    proj = MelProjection(400, 16000.0, 80)
    fft_input = np.ones(400, dtype=np.complex128)
    out = proj.add(fft_input)
    assert out.shape == (80, 1)
    np.testing.assert_array_equal(
        out, jspec.MelProjection(400, 16000.0, 80).add(fft_input))


def test_log_mel_spectrogram_zeroes_high_bins():
    filters = mel_filterbank(16000.0, 400, 80)
    fft = np.zeros(400, dtype=np.complex128)
    fft[250] = 1000.0  # bin >= 200 must not contribute
    out = log_mel_spectrogram(fft, filters)
    assert np.allclose(out, np.log10(1e-10))
    np.testing.assert_array_equal(out, jspec.log_mel_spectrogram(fft,
                                                                 filters))


def test_streaming_stft_plus_projection_equals_fused():
    samples = read_wav_f32le(TESTDATA / "jfk_f32le.wav")[:16000]
    stft = StreamingStft(512, 160)
    proj = MelProjection(512, 16000.0, 80)
    cols = []
    for off in range(0, len(samples) - 159, 160):
        fft = stft.add(samples[off : off + 160])
        if fft is not None:
            cols.append(proj.add(fft))
    got = np.concatenate(cols, axis=1)
    want = compute_streaming_mel(samples, 512, 160, 80, 16000.0,
                                 dtype=torch.float64, device="cpu")
    assert got.shape == want.shape
    assert np.abs(got - want).max() < 1e-6
    jwant = np.asarray(jspec.compute_streaming_mel(
        samples, 512, 160, 80, 16000.0, dtype=jnp.float64))
    assert np.abs(got - jwant).max() < 1e-6


def test_norm_aliases():
    x = np.linspace(-20.0, 0.0, 80)
    g = norm_mel(x)
    v = norm_mel_vec(x)
    assert float(np.max(np.asarray(g))) == 1.0
    assert v.dtype == np.float32
    np.testing.assert_allclose(np.asarray(g, np.float32), v, atol=1e-6)
    np.testing.assert_allclose(np.asarray(g), np.asarray(jspec.norm_mel(x)),
                               atol=1e-12)
    np.testing.assert_array_equal(v, jspec.norm_mel_vec(x))
