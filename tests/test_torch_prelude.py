"""The port's prelude mirrors ``melspec_tpu.prelude`` name for name, and
the host names it added for it (``load_audio``, ``iter_pcm_f32le``,
``norm_mel_vec``, ``mel``) against the JAX package's on the same inputs;
the profiling utilities' contract on the CPU.

Bars: the resampled ``load_audio`` 1e-6 (one float32 polyphase filter,
summed by XLA's convolution in one package and PyTorch's in the other;
measured below 1e-7); everything else equal."""

import io
import json
import wave

import numpy as np
import pytest
import torch

import melspec_tpu.prelude as jprelude
from melspec_tpu.io import wav as jwav
from melspec_tpu.ops import filterbank as jfb
from melspec_tpu.ops import spectrogram as jsp
import melspec_tpu_torch as mt
import melspec_tpu_torch.prelude as prelude
from melspec_tpu_torch.io import wav
from melspec_tpu_torch.ops import filterbank, spectrogram
from melspec_tpu_torch.utils import profiling


def test_prelude_names_equal_jax():
    assert set(prelude.__all__) == set(jprelude.__all__)
    assert len(prelude.__all__) == len(set(prelude.__all__)) == 76


@pytest.mark.parametrize("name", sorted(jprelude.__all__))
def test_prelude_name_is_the_ports(name):
    obj = getattr(prelude, name)
    assert getattr(mt, name) is obj
    module = getattr(obj, "__module__", None)
    assert module is None or not module.startswith("melspec_tpu.")


def _write_pcm16(path, rate, channels, seed, seconds=0.5):
    rng = np.random.default_rng(seed)
    data = (rng.normal(size=(int(rate * seconds), channels)) * 6000)
    data = np.clip(data, -32768, 32767).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(data.tobytes())


@pytest.mark.parametrize("rate,channels", [(16000, 1), (48000, 1),
                                           (48000, 2), (8000, 1)])
def test_load_audio_matches_jax(tmp_path, rate, channels):
    path = tmp_path / "a.wav"
    _write_pcm16(path, rate, channels, seed=rate + channels)
    got = wav.load_audio(path, 16000, device="cpu")
    want = np.asarray(jwav.load_audio(path, 16000))
    assert got.dtype == np.float32 and got.shape == want.shape
    assert got.shape == (8000,)
    if rate == 16000:
        np.testing.assert_array_equal(got, want)
    else:
        assert np.abs(got - want).max() <= 1e-6
    native = wav.load_audio(path, None)
    np.testing.assert_array_equal(native, np.asarray(jwav.load_audio(path,
                                                                     None)))


def test_load_audio_jfk_at_its_rate_touches_no_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    got = mt.load_audio("testdata/jfk_f32le.wav")  # 16 kHz: no resampling
    np.testing.assert_array_equal(got, mt.read_wav_f32le(
        "testdata/jfk_f32le.wav"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mt.load_audio("testdata/jfk_f32le.wav", 8000)


def test_load_audio_rejects_unsafe_ratio(tmp_path):
    path = tmp_path / "a.wav"
    _write_pcm16(path, 44099, 1, seed=0, seconds=0.01)
    with pytest.raises(ValueError, match="ratio"):
        wav.load_audio(path, 16000, device="cpu")


@pytest.mark.parametrize("chunk_bytes", [1, 3, 5, 7, 4096])
def test_iter_pcm_f32le_matches_jax(chunk_bytes):
    x = np.random.default_rng(0).normal(size=301).astype("<f4")
    raw = x.tobytes() + b"\x01\x02"  # a dangling partial float at EOF
    got = list(wav.iter_pcm_f32le(io.BytesIO(raw), chunk_bytes))
    want = list(jwav.iter_pcm_f32le(io.BytesIO(raw), chunk_bytes))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.concatenate(got), x)


def test_norm_mel_vec_matches_jax():
    m = np.random.default_rng(1).normal(size=(80, 13)) * 3 - 5
    got = spectrogram.norm_mel_vec(m)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(jsp.norm_mel_vec(m)))


def test_mel_alias_matches_jax():
    assert filterbank.mel is filterbank.mel_filterbank
    np.testing.assert_array_equal(filterbank.mel(16000.0, 400, 80),
                                  jfb.mel(16000.0, 400, 80))


def test_profiling_utils():
    with profiling.Timer() as t:
        sum(range(1000))
    assert t.seconds >= 0
    assert profiling.rtfx(10.0, 0.01) == 1000.0
    assert profiling.rtfx(10.0, 0.0) == 0.0
    assert profiling.benchmark(lambda x: x + 1, 1, iters=2, warmup=1) >= 0


def test_timer_block_on_cpu_tensors_needs_no_device(monkeypatch):
    def no_sync(*a):
        raise AssertionError("synchronized for a CPU tensor")

    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    value = {"a": (torch.ones(3), [torch.zeros(2)]), "b": 1}
    with profiling.Timer() as t:
        out = t.block_on(value)
    assert out is value and t.seconds >= 0


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(tmp_path / "trace") as prof:
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    files = list((tmp_path / "trace").glob("*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    assert prof.key_averages()
