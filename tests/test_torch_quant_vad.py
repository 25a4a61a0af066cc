"""The port's u8 quantization and batched Sobel VAD against the JAX
package on the same numpy inputs: quantization bit for bit (0.5 ties and
constant frames included), VAD decisions as equal booleans."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from melspec_tpu import config as jconfig
from melspec_tpu.ops import quant as jquant
from melspec_tpu.ops import vad as jvad
from melspec_tpu.streaming import serving as jserving
from melspec_tpu_torch.config import DetectionSettings
from melspec_tpu_torch.ops import quant, vad
from melspec_tpu_torch.streaming.serving import MultiStreamVad

CPU = "cpu"
SETTINGS = [
    DetectionSettings(),
    DetectionSettings(min_energy=0.5, min_y=3, min_x=3, min_mel=0),
    DetectionSettings(min_energy=0.2, min_y=2, min_x=7, min_mel=5),
    DetectionSettings(min_y=0),
]


def _jsettings(s: DetectionSettings):
    return jconfig.DetectionSettings(s.min_energy, s.min_y, s.min_x,
                                     s.min_mel)


def _frames_with_ties():
    """Random frames, plus frames whose scaled values land exactly on and
    one ulp beside the .5 ties, and constant frames (NaN chain -> 0)."""
    rng = np.random.default_rng(0)
    frames = (rng.normal(size=(5, 7, 80)) * 2.0).astype(np.float32)
    frames[1, 3] = 0.625
    frames[4, 6] = -3.0
    frames[2, 0] = np.linspace(-1, 1, 80, dtype=np.float32)
    # lo = 0, hi = 255: scale 1, so these are the scaled values themselves
    tie = np.arange(80, dtype=np.float32) + np.float32(0.5)
    tie[0], tie[-1] = 0.0, 255.0
    frames[3, 0] = tie
    frames[3, 1] = np.nextafter(tie, np.float32(0.0))
    frames[3, 1, [0, -1]] = 0.0, 255.0
    frames[3, 2] = np.nextafter(tie, np.float32(300.0))
    frames[3, 2, [0, -1]] = 0.0, 255.0
    return frames


def test_settings_match_jax():
    assert DetectionSettings() == DetectionSettings(
        *[getattr(jconfig.DetectionSettings(), f)
          for f in ("min_energy", "min_y", "min_x", "min_mel")])


def test_quantize_frames_bit_exact_with_jax_and_host():
    frames = _frames_with_ties()
    q, lo, hi = quant.quantize_frames(torch.from_numpy(frames))
    jq, jlo, jhi = (np.asarray(a) for a in
                    jquant.quantize_frames_jnp(jnp.asarray(frames)))
    np.testing.assert_array_equal(q.numpy(), jq)
    np.testing.assert_array_equal(lo.numpy(), jlo)
    np.testing.assert_array_equal(hi.numpy(), jhi)
    assert (q[3, 0].numpy() == np.arange(80) + 1)[1:-1].all()  # ties up
    assert not q[1, 3].any() and not q[4, 6].any()  # constant frames
    for i in range(frames.shape[0]):
        for j in range(frames.shape[1]):
            want, rng = quant.quantize(frames[i, j])
            np.testing.assert_array_equal(q[i, j].numpy(), want)
            assert (lo[i, j].item(), hi[i, j].item()) == (rng.min, rng.max)


def test_quantize_frames_divides_like_jax():
    """scale = 255 / (hi - lo) is one IEEE division, as in JAX and the
    host quantizer: for this range, 255 * (1 / range) is one ulp off, and
    the value 0.0031842298 then rounds to 1 instead of 2."""
    bits = np.asarray([0, 1057657827, 995143299], np.uint32)
    frame = np.tile(bits.view(np.float32), (2, 1))
    q, lo, hi = quant.quantize_frames(torch.from_numpy(frame))
    jq, _, _ = jquant.quantize_frames_jnp(jnp.asarray(frame))
    want, _ = quant.quantize(frame[0])
    assert q[0].tolist() == want.tolist() == [0, 255, 2]
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))


def test_host_quantize_matches_jax():
    frames = _frames_with_ties()
    for frame in frames.reshape(-1, 80):
        got, rng = quant.quantize(frame)
        want, jrng = jquant.quantize(frame)
        np.testing.assert_array_equal(got, want)
        assert (rng.min, rng.max) == (jrng.min, jrng.max)
        np.testing.assert_array_equal(
            quant.dequantize(got, rng), jquant.dequantize(want, jrng))


def test_whole_tensor_quantize_matches_jax():
    frame = _frames_with_ties()[0]
    q, lo, hi = quant.quantize_tensor(torch.from_numpy(frame))
    jq, jlo, jhi = jquant.quantize_jnp(jnp.asarray(frame))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert lo.item() == float(jlo) and hi.item() == float(jhi)
    np.testing.assert_array_equal(
        quant.dequantize_tensor(q, lo, hi).numpy(),
        np.asarray(jquant.dequantize_jnp(jq, jlo, jhi)))


def _mel_like(rng, shape):
    """Speech-shaped mel values: smooth base + occasional sharp edges, so
    Sobel decisions take both outcomes."""
    base = rng.normal(size=shape) * 0.05
    edges = (rng.random(shape) < 0.08) * rng.normal(size=shape) * 3.0
    return (base + edges).astype(np.float32)


@pytest.mark.parametrize("settings", SETTINGS)
def test_classify_and_smooth_match_jax(settings):
    rng = np.random.default_rng(settings.min_x + settings.min_y)
    img = _mel_like(rng, (3, 32, 40))
    g2 = vad.sobel_gradient_sq(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(g2, np.asarray(jvad.sobel_gradient_sq(
        jnp.asarray(img))), rtol=1e-6, atol=0)
    raw = vad.classify_columns(torch.from_numpy(img), settings)
    jraw = np.asarray(jvad.classify_columns(jnp.asarray(img),
                                            _jsettings(settings)))
    np.testing.assert_array_equal(raw.numpy(), jraw)
    for window in (1, 4):
        np.testing.assert_array_equal(
            vad.smooth_mask(raw, window).numpy(),
            np.asarray(jvad.smooth_mask(jnp.asarray(jraw), window)))


@pytest.mark.parametrize("settings", SETTINGS[:3])
def test_batched_decision_fields_match_jax(settings):
    rng = np.random.default_rng(3 + settings.min_x)
    mels = _mel_like(rng, (4, 24, 17))
    got = vad.streaming_decision_fields_batched(torch.from_numpy(mels),
                                                settings)
    want = jvad.streaming_decision_fields_batched(jnp.asarray(mels),
                                                  _jsettings(settings))
    for key in ("active", "leading", "active_columns", "window_columns"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]), err_msg=key)
    np.testing.assert_allclose(got["confidence"].numpy(),
                               np.asarray(want["confidence"]), rtol=1e-6)
    with pytest.raises(ValueError, match="min_x"):
        vad.streaming_decision_fields_batched(
            torch.zeros(1, 24, settings.min_x - 1), settings)


@pytest.mark.parametrize("settings", SETTINGS[:3])
def test_multistream_vad_push_matches_jax(settings):
    """Equal decisions across warm-up, ragged validity prefixes, push
    widths, a stream sitting out a push, and a reset."""
    rng = np.random.default_rng(settings.min_x)
    s, m = 3, 32
    port = MultiStreamVad(settings, n_streams=s, n_mels=m, device=CPU)
    ref = jserving.MultiStreamVad(_jsettings(settings), n_streams=s,
                                  n_mels=m)
    pst, jst = port.init(), ref.init()
    for step, h in enumerate([1, 4, 2, 9, 1, 5]):
        mels = _mel_like(rng, (s, h, m))
        valid = np.ones((s, h), dtype=bool)
        lead = max(0, 2 - step)
        valid[0, :min(lead, h)] = False
        valid[1, :min(2 * lead, h)] = False
        if step == 2:
            valid[2, :] = False
        pst, va = port.push(pst, mels, valid)
        jst, jva = ref.push(jst, mels, valid)
        np.testing.assert_array_equal(va, jva, err_msg=f"push {step}")
        np.testing.assert_array_equal(pst.hist.numpy(), np.asarray(jst.hist))
        np.testing.assert_array_equal(pst.count.numpy(),
                                      np.asarray(jst.count))
        if step == 3:
            mask = np.asarray([False, True, False])
            pst, jst = port.reset(pst, mask), ref.reset(jst, mask)
    assert pst.count.dtype == torch.int32
    empty = port.push(pst, np.zeros((s, 0, m), np.float32),
                      np.zeros((s, 0), bool))[1]
    assert empty.shape == (s, 0)


def test_multistream_vad_validation_messages():
    port = MultiStreamVad(DetectionSettings(), 4, 80, device=CPU)
    with pytest.raises(ValueError, match="mels must be"):
        port.push(port.init(), np.zeros((3, 2, 80), np.float32),
                  np.ones((3, 2), bool))
    with pytest.raises(ValueError, match="min_x"):
        MultiStreamVad(DetectionSettings(min_x=2), 4, 80, device=CPU)
    with pytest.raises(ValueError, match="n_mels"):
        MultiStreamVad(DetectionSettings(), 4, 2, device=CPU)
