"""Randomized differential tests of the port (mirror of
``tests/test_fuzz_differential.py``), each also held against the JAX
package on the same numpy inputs: JAX's six random configs (seed
``0xC0FFEE``, drawn in JAX's order) through the float64 pipeline against
per-frame float64 numpy at 1e-9; random images and settings through the
host VAD against the naive scalar Sobel of ``tests/test_vad.py`` and
JAX's, decision for decision; ``stft_frames`` bit-equal to JAX's and to
the streaming STFT's emission; the zero-frame cases; and the device
streaming VAD state against the frame-at-a-time detector under random
pushes, warm-up prefixes and resets.

JAX's test draws each signal from its module RNG while it runs, so its
inputs depend on the order the tests run in; here each case draws from a
seed of its own, and the configs and settings are JAX's."""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from melspec_tpu import config as jconfig
from melspec_tpu.ops import spectrogram as jspec
from melspec_tpu.ops import vad as jvad
from melspec_tpu.streaming import serving as jserving
from melspec_tpu_torch.config import DetectionSettings
from melspec_tpu_torch.io.wav import read_wav_f32le
from melspec_tpu_torch.ops import framing
from melspec_tpu_torch.ops.filterbank import mel_filterbank
from melspec_tpu_torch.ops.spectrogram import WhisperMelPipeline, stft_frames
from melspec_tpu_torch.ops.vad import streaming_decisions, vad_boundaries
from melspec_tpu_torch.ops.windows import hann_periodic
from melspec_tpu_torch.streaming.serving import MultiStreamVad
from melspec_tpu_torch.streaming.stft import StreamingStft
from melspec_tpu_torch.streaming.vad import VoiceActivityDetector
from tests.test_vad import naive_vad_boundaries

CPU = "cpu"
TESTDATA = Path(__file__).resolve().parents[1] / "testdata"

# JAX's module draws: its six pipeline configs, then its six VAD cases
_RNG = np.random.default_rng(0xC0FFEE)
CASES = []
for _ in range(6):
    fft = int(_RNG.choice([128, 256, 400, 512, 640]))
    hop = int(_RNG.integers(fft // 8, fft))
    n_mels = int(_RNG.choice([20, 40, 80]))
    sr = float(_RNG.choice([8000, 16000, 22050]))
    CASES.append((fft, hop, n_mels, sr))
VAD_CASES = []
for _ in range(6):
    VAD_CASES.append((
        float(_RNG.uniform(0.2, 1.5)),       # min_energy
        int(_RNG.integers(0, 12)),           # min_y
        int(_RNG.integers(3, 12)),           # min_x
        int(_RNG.integers(0, 5)),            # min_mel
        int(_RNG.integers(8, 30)),           # height
        int(_RNG.integers(10, 120)),         # width
    ))


def _activity(a):
    return None if a is None else dataclasses.asdict(a)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_whisper_pipeline_fuzz(case):
    fft, hop, n_mels, sr = CASES[case]
    rng = np.random.default_rng(case)
    n = int(rng.integers(fft + hop, 5 * fft + 7))
    samples = (rng.normal(size=n) * rng.uniform(0.01, 1.0)).astype(
        np.float32)
    got = WhisperMelPipeline(fft, hop, n_mels, sr, dtype=torch.float64,
                             device=CPU).mel_batch(samples).numpy()
    nf = framing.num_frames_batch(n, fft, hop)
    assert got.shape == (nf, n_mels)
    window = hann_periodic(fft)
    filters = mel_filterbank(sr, fft, n_mels)
    half = fft // 2
    for k in range(nf):
        frame = samples[k * hop : k * hop + fft].astype(np.float64)
        power = np.abs(np.fft.fft(frame * window)[:half]) ** 2
        log_mel = np.log10(np.maximum(filters[:, :half] @ power, 1e-10))
        want = (np.maximum(log_mel, log_mel.max() - 8.0) + 4.0) / 4.0
        np.testing.assert_allclose(got[k], want, atol=1e-9,
                                   err_msg=f"frame {k}")
    jax_mel = np.asarray(jspec.WhisperMelPipeline(
        fft, hop, n_mels, sr, dtype=jnp.float64).mel_batch(samples))
    np.testing.assert_allclose(got, jax_mel, atol=1e-9)


@pytest.mark.parametrize("case", range(len(VAD_CASES)))
def test_vad_boundaries_fuzz(case):
    """Random images x random settings: the port's classification equals
    the naive scalar Sobel and JAX's, decision for decision."""
    me, my, mx, mm, h, w = VAD_CASES[case]
    img = np.random.default_rng(100 + case).random((h, w)) * 3.0
    got = vad_boundaries(img, DetectionSettings(me, my, mx, mm))
    non, inter = naive_vad_boundaries(img, jconfig.DetectionSettings(
        me, my, mx, mm))
    assert got.intersected() == inter
    assert got.non_intersected() == non
    want = jvad.vad_boundaries(img, jconfig.DetectionSettings(me, my, mx,
                                                              mm))
    assert got.intersected() == want.intersected()
    assert got.non_intersected() == want.non_intersected()


@pytest.mark.parametrize("case", range(3))
def test_streaming_decisions_fuzz(case):
    """The vectorized streaming decisions equal the frame-at-a-time
    detector's, and JAX's."""
    me, my, mx, mm, h, w = VAD_CASES[case]
    img = np.random.default_rng(200 + case).random((h, max(w, mx + 2))) * 3.0
    settings = DetectionSettings(me, my, mx, mm)
    batched = streaming_decisions(img, settings)
    jbatched = jvad.streaming_decisions(img, jconfig.DetectionSettings(
        me, my, mx, mm))
    vad = VoiceActivityDetector(settings)
    for t in range(img.shape[1]):
        got = vad.add_activity(img[:, t : t + 1])
        assert (got is None) == (batched[t] is None)
        if got is not None:
            assert got == batched[t], f"frame {t}"
        assert _activity(batched[t]) == _activity(jbatched[t])


def test_stft_frames_matches_streaming_emission():
    """``stft_frames`` is bit-equal to JAX's; the per-hop streaming STFT
    agrees with directly computed frames at 1e-9 (its frames start at the
    streaming offset), and the batch frame grid is the batch count."""
    fft, hop = 400, 160
    samples = read_wav_f32le(TESTDATA / "jfk_f32le.wav")[:8000]
    batch = stft_frames(samples, fft, hop)
    want_batch = jspec.stft_frames(samples, fft, hop)
    assert batch.dtype == want_batch.dtype == np.complex128
    np.testing.assert_array_equal(batch, want_batch)

    stream = StreamingStft(fft, hop)
    offset = framing.streaming_frame_offset(fft, hop)
    got = []
    for off in range(0, len(samples) - hop + 1, hop):
        out = stream.add(samples[off : off + hop])
        if out is not None:
            got.append(out)
    assert got
    window = hann_periodic(fft)
    for k, frame in enumerate(got):
        start = offset + k * hop
        want = np.fft.fft(samples[start : start + fft].astype(np.float64)
                          * window)
        np.testing.assert_allclose(frame, want, atol=1e-9)
    assert batch.shape == (framing.num_frames_batch(len(samples), fft, hop),
                           fft)


@pytest.mark.parametrize("fft,hop,n", [(400, 160, 399), (512, 128, 0),
                                       (256, 96, 1000)])
def test_stft_frames_bit_equal_to_jax(fft, hop, n):
    """Random signals, and the zero-frame case (fewer samples than one
    frame): complex128 ``(0, fft)`` in both packages."""
    samples = (np.random.default_rng(n).normal(size=n) * 0.3).astype(
        np.float32)
    got = stft_frames(samples, fft, hop)
    want = jspec.stft_frames(samples, fft, hop)
    assert got.dtype == want.dtype == np.complex128
    assert got.shape == want.shape
    assert got.shape == (framing.num_frames_batch(n, fft, hop), fft)
    np.testing.assert_array_equal(got, want)


def test_frame_signal_zero_frames_is_empty():
    """``num_frames == 0`` gives an empty frame tensor, 1-D and batched."""
    out = framing.frame_signal(torch.zeros(300), 400, 160, 0)
    assert tuple(out.shape) == (0, 400)
    out2 = framing.frame_signal(torch.zeros((2, 300)), 400, 100, 0)
    assert tuple(out2.shape) == (2, 0, 400)


def test_fuzz_multistream_vad_protocol():
    """The device streaming-VAD state (``MultiStreamVad``) against the
    frame-at-a-time detector and JAX's ``MultiStreamVad``: random push
    widths, warm-up prefixes and stream resets; decisions equal at every
    frame."""
    rng = np.random.default_rng(42)
    s, m = 4, 24
    args = dict(min_energy=0.4, min_y=2, min_x=5, min_mel=1)
    settings = DetectionSettings(**args)
    vad = MultiStreamVad(settings, n_streams=s, n_mels=m, device=CPU)
    jv = jserving.MultiStreamVad(jconfig.DetectionSettings(**args),
                                 n_streams=s, n_mels=m)
    state, jstate = vad.init(), jv.init()
    hosts = [VoiceActivityDetector(settings) for _ in range(s)]
    seen = [0] * s
    for _ in range(25):
        h = int(rng.integers(1, 8))
        mels = (rng.normal(size=(s, h, m)) * 0.3
                + (rng.random((s, h, m)) < 0.1) * 2.0).astype(np.float32)
        valid = np.ones((s, h), dtype=bool)
        for i in range(s):
            if seen[i] == 0 and rng.random() < 0.6:
                valid[i, : int(rng.integers(0, h + 1))] = False
        state, va = vad.push(state, mels, valid)
        jstate, jva = jv.push(jstate, mels, valid)
        np.testing.assert_array_equal(va, np.asarray(jva))
        for i in range(s):
            for t in range(h):
                if not valid[i, t]:
                    assert not va[i, t]
                    continue
                seen[i] += 1
                want = hosts[i].add(mels[i, t][:, None])
                assert va[i, t] == bool(want), (i, t, seen[i])
        if rng.random() < 0.25:
            j = int(rng.integers(0, s))
            mask = np.zeros(s, dtype=bool)
            mask[j] = True
            state = vad.reset(state, mask)
            jstate = jv.reset(jstate, mask)
            hosts[j] = VoiceActivityDetector(settings)
            seen[j] = 0


def test_chip_smoke_drives_these_configs():
    """``chip_smoke.py``'s phase broad_configs drives JAX's fuzz configs
    (this file's draws) and the broad configs of
    ``tests/test_torch_configs_broad.py`` on the card."""
    import chip_smoke
    from tests.test_torch_configs_broad import BROAD

    assert chip_smoke.FUZZ_CONFIGS == CASES
    assert chip_smoke.BROAD_CONFIGS == BROAD
