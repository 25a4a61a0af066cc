"""The port's host VAD (boundaries, the streaming detector, the vectorized
streaming decisions, timestamps, images, timing helpers) against the JAX
package on the same numpy inputs: the reference's fixtures of
``tests/test_vad.py`` and random images. Both classify in float64 on the
host, so every decision, count and timestamp is held equal, and the
confidence equal as a float64 ratio. The batched decision fields' cases
of ``tests/test_vad_batched_device.py`` that no other file mirrors (the
degenerate refusal, float32 parity on JFK, a precomputed ``raw``) close
the file."""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from melspec_tpu import config as jconfig
from melspec_tpu.ops import vad as jvad
from melspec_tpu.streaming import vad as jsvad
from melspec_tpu.utils import timing as jtiming
from melspec_tpu_torch.config import DetectionSettings, VadFrameTiming
from melspec_tpu_torch.io.tga import load_tga_8bit, to_array2
from melspec_tpu_torch.ops import vad
from melspec_tpu_torch.streaming.vad import VoiceActivityDetector
from melspec_tpu_torch.utils import timing

TESTDATA = Path(__file__).resolve().parents[1] / "testdata"
BLANK_IDS = [21168, 23760, 41492, 41902, 63655, 7497, 39744]
SPEECH_IDS = [11648, 2889, 4694, 4901, 27125]
FIXTURES = [
    ((1.0, 3, 6, 0), "quantized_mel_golden.tga"),
    ((1.0, 10, 10, 0), "blank/frame_23760.tga"),
    ((1.0, 10, 10, 0), "speech/frame_27125.tga"),
    ((1.0, 6, 1, 0), "jfk_full_speech_chunk1_golden.tga"),
    ((0.98, 11, 5, 2), "quantized_mel_golden.tga"),
    ((0.98, 11, 5, 2), "jfk_full_speech_chunk1_golden.tga"),
]


def _img(name):
    return to_array2(load_tga_8bit(TESTDATA / name), 80)


def _both(args):
    return DetectionSettings(*args), jconfig.DetectionSettings(*args)


def _activity(a):
    """A VoiceActivity of either package as plain values."""
    return None if a is None else dataclasses.asdict(a)


@pytest.mark.parametrize("args,fixture", FIXTURES)
def test_vad_boundaries_match_jax(args, fixture):
    settings, jsettings = _both(args)
    img = _img(fixture)
    got = vad.vad_boundaries(img, settings)
    want = jvad.vad_boundaries(img, jsettings)
    assert got.intersected() == want.intersected(), fixture
    assert got.non_intersected() == want.non_intersected(), fixture
    assert got.gradient_positions == set()
    # a list of frames is the same image, concatenated on the time axis
    cols = [img[:, i : i + 7] for i in range(0, img.shape[1], 7)]
    assert vad.vad_boundaries(cols, settings).intersected() == \
        want.intersected()


def test_fixture_speech_detection():
    """The reference's on/off fixture assertions (``src/vad.rs:621-670``)."""
    settings = DetectionSettings(min_energy=1.0, min_y=10, min_x=10,
                                 min_mel=0)
    for fid in BLANK_IDS:
        edge = vad.vad_boundaries(_img(f"blank/frame_{fid}.tga"), settings)
        assert vad.vad_on(edge, 10) is False, f"blank {fid} misdetected"
    for fid in SPEECH_IDS:
        edge = vad.vad_boundaries(_img(f"speech/frame_{fid}.tga"), settings)
        assert vad.vad_on(edge, 10) is True, f"speech {fid} missed"


@pytest.mark.parametrize("args,fixture", FIXTURES)
def test_streaming_decisions_match_jax_and_loop(args, fixture):
    """The vectorized decisions equal JAX's and the port's own
    frame-by-frame detector, with timestamps."""
    settings, jsettings = _both(args)
    img = _img(fixture)[:, :300]
    timing_ = VadFrameTiming(400, 160, 16000.0)
    got = vad.streaming_decisions(img, settings, timing_)
    want = jvad.streaming_decisions(img, jsettings,
                                    jconfig.VadFrameTiming(400, 160, 16000.0))
    assert [_activity(a) for a in got] == [_activity(a) for a in want]
    det = VoiceActivityDetector(settings, timing_)
    loop = [det.add_activity(img[:, t : t + 1]) for t in range(img.shape[1])]
    assert loop == got


def test_streaming_protocol_matches_jax():
    settings, jsettings = _both((1.0, 3, 3, 0))
    img = _img("quantized_mel_golden.tga")
    port, ref = VoiceActivityDetector(settings), jsvad.VoiceActivityDetector(
        jsettings)
    outputs = [port.add(img[:, t : t + 1]) for t in range(img.shape[1])]
    assert outputs == [ref.add(img[:, t : t + 1])
                       for t in range(img.shape[1])]
    assert outputs[0] is None and outputs[1] is None
    assert all(o is not None for o in outputs[2:])


def test_streaming_timestamps():
    """Timestamp contract (reference ``tests/vad_regression.rs:233-266``):
    the first decision is for frame 2, at 20 / 33 / 45 ms."""
    settings = DetectionSettings(min_energy=1.0, min_y=3, min_x=3, min_mel=0)
    det = VoiceActivityDetector(settings, VadFrameTiming(400, 160, 16000.0))
    img = _img("quantized_mel_golden.tga")
    first = None
    for t in range(img.shape[1]):
        first = det.add_activity(img[:, t : t + 1])
        if first is not None:
            break
    assert first.frame_index == 2
    assert (first.timestamps.start_ms, first.timestamps.center_ms,
            first.timestamps.end_ms) == (20, 33, 45)


def test_readme_vad_timestamp_contract():
    """README contract: zero frames, default settings -> a decision with
    timestamps once min_x frames are buffered
    (``tests/readme_examples.rs:72-86``)."""
    settings = DetectionSettings()
    det = VoiceActivityDetector(settings, VadFrameTiming(400, 160, 16000.0))
    frame = np.zeros((80, 1))
    got = [det.add_activity(frame) for _ in range(settings.min_x + 1)]
    assert got[settings.min_x - 2] is None
    assert got[-1] is not None and got[-1].timestamps is not None


def test_buffer_overflow_keeps_decisions_stable():
    """Decisions identical long past the 128-frame drain point, in both
    packages."""
    settings, jsettings = _both((1.0, 2, 4, 0))
    img = np.random.default_rng(4).random((20, 300)) * 3.0
    det = VoiceActivityDetector(settings)
    loop = [det.add(img[:, t : t + 1]) for t in range(300)]
    batched = [None if b is None else b.active
               for b in vad.streaming_decisions(img, settings)]
    jdet = jsvad.VoiceActivityDetector(jsettings)
    assert loop == batched == [jdet.add(img[:, t : t + 1])
                               for t in range(300)]


@pytest.mark.parametrize("args", [(0.98, 11, 5, 2), (0.5, 3, 7, 1),
                                  (0.9, 4, 6, 1), (1.0, 2, 3, 0)])
def test_decision_fields_match_jax(args):
    settings, jsettings = _both(args)
    mel = np.random.default_rng(args[2]).random((40, 113)) * 3.0
    got = vad.streaming_decision_fields(mel, settings)
    want = jvad.streaming_decision_fields(mel, jsettings)
    assert got.keys() == want.keys()
    for key in got:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert vad.streaming_decision_fields(mel[:, :args[2] - 1],
                                         settings) is None
    flat = vad.streaming_decision_fields(mel[:2], settings)
    assert not flat["active"].any() and flat["confidence"].dtype == np.float64


def test_leading_and_vad_on_match_jax():
    rng = np.random.default_rng(9)
    for _ in range(50):
        cols = sorted(set(rng.integers(0, 12, size=rng.integers(0, 9))))
        edge = vad.EdgeInfo([], list(cols), set())
        jedge = jvad.EdgeInfo([], list(cols), set())
        assert vad.leading_active_columns(cols) == \
            jvad.leading_active_columns(cols)
        for n in (1, 2, 3, 5):
            assert vad.vad_on(edge, n) == jvad.vad_on(jedge, n)


def test_as_image_matches_jax(tmp_path):
    img = _img("speech/frame_27125.tga")
    edge = vad.vad_boundaries(img, DetectionSettings(1.0, 10, 10, 0))
    grads = {(3, 4), (10, 70), (500, 2)}
    rgb = vad.as_image(img, edge.non_intersected(), grads)
    assert rgb.shape == (80, img.shape[1], 3) and rgb.dtype == np.uint8
    np.testing.assert_array_equal(
        rgb, jvad.as_image(img, edge.non_intersected(), grads))
    np.testing.assert_array_equal(vad.as_image(-img, [], set()),
                                  jvad.as_image(-img, [], set()))
    vad.save_image(tmp_path / "vad.png", rgb)
    assert (tmp_path / "vad.png").stat().st_size > 0


def test_timing_helpers_match_jax():
    assert timing.format_milliseconds(3_725_042) == "01:02:05.042"
    for hop, rate in [(160, 16000.0), (256, 22050.0), (480, 48000.0)]:
        for ms in (0, 1, 999, 1000, 12345):
            assert timing.n_frames_for_duration(hop, rate, ms) == \
                jtiming.n_frames_for_duration(hop, rate, ms)
            assert timing.duration_ms_for_n_frames(hop, rate, ms) == \
                jtiming.duration_ms_for_n_frames(hop, rate, ms)
            assert timing.format_milliseconds(ms * 997) == \
                jtiming.format_milliseconds(ms * 997)
        t, jt = (VadFrameTiming(400, hop, rate),
                 jconfig.VadFrameTiming(400, hop, rate))
        for k in range(0, 2000, 37):
            assert dataclasses.asdict(t.timestamps_for_frame(k)) == \
                dataclasses.asdict(jt.timestamps_for_frame(k))


def test_batched_fields_rejects_degenerate():
    """Fewer frames than ``min_x``: no decision window, ValueError in both
    packages."""
    with pytest.raises(ValueError):
        vad.streaming_decision_fields_batched(
            torch.zeros((1, 40, 4)), DetectionSettings(min_x=6))
    with pytest.raises(ValueError):
        jvad.streaming_decision_fields_batched(
            jnp.zeros((1, 40, 4)), jconfig.DetectionSettings(min_x=6))


@pytest.mark.parametrize("args", [(1.0, 6, 6, 0), (0.98, 11, 5, 2)])
def test_batched_fields_f32_parity_jfk(args):
    """The eval path's dtype story on real speech: the port's float32 mel
    of JFK through the batched fields in float32 equals the sequential
    float64 host fields decision for decision, and JAX's batched fields
    on the same image."""
    from melspec_tpu_torch.io.wav import read_wav_f32le
    from melspec_tpu_torch.ops.spectrogram import WhisperMelPipeline

    settings, jsettings = _both(args)
    jfk = read_wav_f32le(TESTDATA / "jfk_f32le.wav")
    mel = WhisperMelPipeline(400, 160, 80, 16000.0,
                             device="cpu").mel_batch(jfk)
    img = mel.T.numpy()  # [n_mels, frames] float32
    want = vad.streaming_decision_fields(img.astype(np.float64), settings)
    got = vad.streaming_decision_fields_batched(torch.from_numpy(img)[None],
                                                settings)
    jgot = jvad.streaming_decision_fields_batched(jnp.asarray(img[None]),
                                                  jsettings)
    for k in ("active", "leading", "active_columns", "window_columns"):
        np.testing.assert_array_equal(got[k][0].numpy(), want[k],
                                      err_msg=k)
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(jgot[k]),
                                      err_msg=k)


def test_batched_fields_accept_precomputed_raw():
    """``raw=`` (a fused kernel's classification) gives the fields of the
    mel it classifies, as in JAX."""
    mels = np.random.default_rng(1).random((2, 30, 120)) * 3.0
    settings, jsettings = _both((0.9, 3, 6, 1))
    raw = vad.classify_columns(torch.from_numpy(mels), settings)
    base = vad.streaming_decision_fields_batched(torch.from_numpy(mels),
                                                 settings)
    via_raw = vad.streaming_decision_fields_batched(None, settings, raw=raw)
    jvia = jvad.streaming_decision_fields_batched(
        None, jsettings, raw=jvad.classify_columns(jnp.asarray(mels),
                                                   jsettings))
    assert base.keys() == via_raw.keys()
    for k in base:
        np.testing.assert_array_equal(base[k].numpy(), via_raw[k].numpy(),
                                      err_msg=k)
        np.testing.assert_array_equal(via_raw[k].numpy(),
                                      np.asarray(jvia[k]), err_msg=k)
