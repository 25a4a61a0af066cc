"""The precision paths of ``ops/hp_dft.py`` (plain PyTorch on every
device), port vs JAX on the same numpy inputs: the slice builders bit for
bit; the power functions against JAX's at 1e-6 (hp, exact integer dots)
and 2e-5 (bf3, float32 sums of exact products) relative to each row's
peak, and hp against the float64 rFFT at JAX's own 2^-23; then the
routes they open in ``WhisperMelPipeline``, ``Fbank``, ``BatchLogMel`` and
``MultiStreamMel`` at the JAX tests' bars and goldens."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from melspec_tpu.config import BatchLogMelConfig as JBatchLogMelConfig
from melspec_tpu.config import FbankConfig as JFbankConfig
from melspec_tpu.config import MelConfig as JMelConfig
from melspec_tpu.ops import batch_logmel as jbl
from melspec_tpu.ops import fbank as jfbank
from melspec_tpu.ops import hp_dft as jhp
from melspec_tpu.ops import mel_kernel as jmk
from melspec_tpu.ops import spectrogram as jsp
from melspec_tpu.ops import windows as jwin
from melspec_tpu.streaming import multistream as jms
from melspec_tpu_torch.config import BatchLogMelConfig, FbankConfig, MelConfig
from melspec_tpu_torch.io.wav import read_wav_f32le
from melspec_tpu_torch.ops import batch_logmel, fbank, hp_dft, mel_kernel
from melspec_tpu_torch.ops import spectrogram
from melspec_tpu_torch.ops.filterbank import mel_filterbank
from melspec_tpu_torch.ops.windows import hann_periodic
from melspec_tpu_torch.streaming.multistream import MultiStreamMel

TESTDATA = Path(__file__).resolve().parents[1] / "testdata"
CPU = "cpu"
# the JAX package's bar between its float32 routes and its other routes
CROSS_ROUTE = 2e-4


def _bits(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.contiguous().view(torch.int16).numpy().view(np.uint16)
    return np.asarray(t).view(np.uint16)


def _frames(seed, shape, scale=0.3):
    return (np.random.default_rng(seed).normal(size=shape)
            * scale).astype(np.float32)


def _rel(got, want) -> float:
    """Largest error relative to each row's peak."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    peak = np.abs(want).max(axis=-1, keepdims=True)
    return float((np.abs(got - want) / np.maximum(peak, 1e-30)).max())


@pytest.fixture(scope="module")
def jfk():
    return read_wav_f32le(TESTDATA / "jfk_f32le.wav")


@pytest.mark.parametrize("fft,bins,n,windowed,frame_len", [
    (400, 200, 5, True, 0), (512, 256, 3, False, 0), (512, 257, 5, False, 400),
    (1024, 512, 4, True, 0)])
def test_matrix_slices_bit_equal(fft, bins, n, windowed, frame_len):
    got = hp_dft._dft_matrix_slices(fft, bins, n, windowed, frame_len)
    want = jhp._dft_matrix_slices(fft, bins, n, windowed, frame_len)
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    m = np.random.default_rng(n).uniform(-1, 1, size=(7, 9))
    for g, w in zip(hp_dft.matrix_slices(m, n), jhp.matrix_slices(m, n)):
        np.testing.assert_array_equal(g, w)


def test_windowed_with_frame_len_refused_as_in_jax():
    for mod in (hp_dft, jhp):
        with pytest.raises(ValueError, match="frame_len"):
            mod._dft_matrix_slices(512, 257, 5, True, 400)


@pytest.mark.parametrize("fft,bins,km,windowed,frame_len", [
    (400, 200, 3, True, 0), (512, 256, 2, False, 0), (512, 257, 3, True, 400)])
def test_bf3_planes_bit_equal(fft, bins, km, windowed, frame_len):
    got = hp_dft._bf3_matrix_planes(fft, bins, km, windowed, frame_len)
    want = jhp._bf3_matrix_planes(fft, bins, km, windowed, frame_len)
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        np.testing.assert_array_equal(_bits(g), _bits(w))


@pytest.mark.parametrize("n", [3, 4, 5])
def test_int8_slices_bit_equal(n):
    cw = mel_kernel._build_matrices(400, 80, 16000.0)[0]
    for g, w in zip(mel_kernel._matrix_slices_i8(cw, n),
                    jmk._matrix_slices_i8(cw, n)):
        assert g.dtype == w.dtype == np.int8
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("fft,bins,windowed", [(400, 200, True),
                                               (512, 256, False),
                                               (1024, 512, True)])
@pytest.mark.parametrize("ks,km,cutoff", [(3, 3, 2), (2, 2, 1), (4, 3, 2)])
def test_bf3_power_matches_jax(fft, bins, windowed, ks, km, cutoff):
    x = _frames(fft + ks, (2, 9, fft))
    got = hp_dft.bf3_rdft_power(torch.from_numpy(x), fft, bins, ks, km,
                                cutoff, hann_windowed=windowed)
    want = jhp.bf3_rdft_power(jnp.asarray(x), fft, bins, ks, km, cutoff,
                              hann_windowed=windowed)
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= 2e-5


@pytest.mark.parametrize("fft,bins,windowed", [(400, 200, True),
                                               (512, 256, False),
                                               (1024, 512, True)])
@pytest.mark.parametrize("n_slices,max_pair_sum", [(5, 5), (4, 4), (3, 2)])
def test_hp_power_matches_jax(fft, bins, windowed, n_slices, max_pair_sum):
    x = _frames(fft + n_slices, (2, 9, fft))
    x[0, 3] = 0.0  # a silent frame: the row scale's floor
    x[1, 4] *= 1e-6
    got = hp_dft.hp_rdft_power(torch.from_numpy(x), fft, bins, n_slices,
                               max_pair_sum, hann_windowed=windowed)
    want = jhp.hp_rdft_power(jnp.asarray(x), fft, bins, n_slices,
                             max_pair_sum, hann_windowed=windowed)
    assert tuple(got.shape) == want.shape
    assert _rel(got.numpy(), want) <= 1e-6


@pytest.mark.parametrize("window,fft,bins", [
    (jwin.povey(400), 512, 257), (jwin.hann_centered(512, 400), 512, 257),
    (jwin.povey(200), 256, 129)])
def test_hp_windowed_power_matches_jax(window, fft, bins):
    x = _frames(len(window), (3, 7, len(window)))
    got = hp_dft.hp_rdft_power_windowed(torch.from_numpy(x), window, fft,
                                        bins)
    want = jhp.hp_rdft_power_windowed(jnp.asarray(x), window, fft, bins)
    assert _rel(got.numpy(), want) <= 1e-6


def test_windowed_cache_is_bounded_and_keyed_on_bytes():
    hp_dft._windowed_cache.clear()
    x = torch.from_numpy(_frames(1, (2, 64)))
    outs = []
    for k in range(hp_dft._WINDOWED_CACHE_MAX + 4):
        w = np.hanning(64) * (1.0 + k / 64)
        outs.append(hp_dft.hp_rdft_power_windowed(x, w, 64, 33))
    assert len(hp_dft._windowed_cache) == hp_dft._WINDOWED_CACHE_MAX
    # the first window again (evicted): the same power, rebuilt
    again = hp_dft.hp_rdft_power_windowed(x, np.hanning(64), 64, 33)
    assert torch.equal(again, outs[0])


def test_hp_power_matches_f64_dft():
    """JAX's own bar (tests/test_spectrogram.py): quiet bins accurate in
    absolute terms down to ~2^-25 of the peak power."""
    frames = _frames(0, (16, 512))
    got = hp_dft.hp_rdft_power(torch.from_numpy(frames), 512, 256).numpy()
    spec = np.fft.rfft(frames.astype(np.float64), axis=-1)[:, :256]
    want = np.abs(spec) ** 2
    rel = np.abs(got - want) / want.max(axis=-1, keepdims=True)
    assert rel.max() < 2 ** -23


def test_row_scale_matches_jax_bit_ops():
    import jax

    x = np.array([[0.0, 0.0], [1.0, -0.5], [3e-39, 1e-40], [1e38, -3e38],
                  [0.75, 0.7499]], np.float32)
    got = hp_dft.pow2_row_scale(torch.from_numpy(x)).numpy()
    row = np.abs(x).max(axis=-1, keepdims=True)
    bits = jax.lax.bitcast_convert_type(jnp.maximum(row, 1e-38), jnp.int32)
    want = jax.lax.bitcast_convert_type(
        (jnp.minimum((bits >> 23) & 0xFF, 0xFD) + 1) << 23, jnp.float32)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_jfk_streaming_golden_hp_and_bf3(jfk):
    """tests/test_spectrogram.py's gates: hp <= 1e-6 (JAX measured
    2.4e-7), bf3 <= 1e-5 (4.5e-6) on the master golden."""
    golden = np.load(TESTDATA / "rust_jfk_golden.npy")
    for impl, gate in (("hp", 1e-6), ("bf3", 1e-5)):
        got = spectrogram.compute_streaming_mel(jfk, 512, 160, 80, 16000.0,
                                                fft_impl=impl, device=CPU)
        assert got.shape == golden.shape
        assert np.abs(got - golden).max() <= gate, impl


@pytest.mark.parametrize("fft,hop", [(400, 160), (1024, 256), (960, 480)])
def test_hp_path_any_config(fft, hop):
    """tests/test_configs_broad.py: the hp route within 1e-6 of float64."""
    x = _frames(1, (48000,), 0.2)
    f64 = spectrogram.WhisperMelPipeline(fft, hop, 80, 16000.0,
                                         dtype=torch.float64, device=CPU)
    hp = spectrogram.WhisperMelPipeline(fft, hop, 80, 16000.0,
                                        fft_impl="hp", device=CPU)
    a = f64.mel_batch(x).numpy()
    b = hp.mel_batch(x).numpy()
    assert np.abs(a - b).max() < 1e-6


def test_benched_config_bf3_vs_f64(jfk):
    """tests/test_spectrogram.py's benched config: 400/160/80, batch
    framing, against a local float64 reference at 1e-5."""
    fft, hop, n_mels, half = 400, 160, 80, 200
    x = jfk.astype(np.float64)
    nf = (len(x) - fft) // hop + 1
    idx = np.arange(nf)[:, None] * hop + np.arange(fft)
    fr = x[idx] * hann_periodic(fft)
    n = np.arange(fft)[:, None]
    k = np.arange(half)[None, :]
    re = fr @ np.cos(2 * np.pi * n * k / fft)
    im = fr @ (-np.sin(2 * np.pi * n * k / fft))
    e = (re * re + im * im) @ mel_filterbank(16000.0, fft, n_mels)[:, :half].T
    lm = np.log10(np.maximum(e, 1e-10))
    gold = (np.maximum(lm, lm.max(axis=1, keepdims=True) - 8.0) + 4.0) / 4.0
    pipe = spectrogram.WhisperMelPipeline(fft, hop, n_mels, 16000.0,
                                          fft_impl="bf3", device=CPU)
    got = pipe.mel_batch(jfk).numpy()
    assert got.shape == gold.shape
    assert np.abs(got - gold).max() <= 1e-5


@pytest.mark.parametrize("impl,tol", [("hp", 1e-6), ("bf3", 2e-5)])
def test_pipeline_routes_match_jax(impl, tol):
    x = _frames(9, (2, 7000), 0.2)
    port = spectrogram.WhisperMelPipeline(400, 160, 128, fft_impl=impl,
                                          hp_n_slices=4, hp_max_pair_sum=4,
                                          device=CPU)
    ref = jsp.WhisperMelPipeline(400, 160, 128, fft_impl=impl,
                                 hp_n_slices=4, hp_max_pair_sum=4)
    for a, b in [(port.mel_batch(x), ref.mel_batch(x)),
                 (port.mel_streaming_equivalent(x),
                  ref.mel_streaming_equivalent(x))]:
        assert a.shape == b.shape
        assert np.abs(a.numpy() - np.asarray(b)).max() <= tol


@pytest.mark.parametrize("kw", [{}, dict(apply_cmn=False),
                                dict(preemphasis=0.0, use_power=False),
                                dict(sample_rate=8000.0)])
def test_fbank_hp_route_matches_jax(kw):
    """``Fbank(fft_impl="hp")`` against JAX's ``"hp"`` route at the JAX
    cross-route bar ``tests/test_torch_fbank.py`` holds the f32 routes to,
    and against JAX's float64 rdft route there too."""
    x = _frames(3, (2, 16000))
    got = fbank.Fbank(FbankConfig(**kw), fft_impl="hp",
                      device=CPU).compute(x).numpy()
    want = np.asarray(jfbank.Fbank(JFbankConfig(**kw),
                                   fft_impl="hp").compute(x))
    f64 = np.asarray(jfbank.Fbank(JFbankConfig(**kw), dtype=jnp.float64,
                                  fft_impl="rdft").compute(x))
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= CROSS_ROUTE
    assert np.abs(got - f64).max() <= CROSS_ROUTE


@pytest.mark.parametrize("kw", [{}, dict(normalize_per_feature=True),
                                dict(preemphasis=0.97, pad_to=16),
                                dict(sample_rate=8000, n_fft=256,
                                     win_length=200, hop_length=80)])
def test_batch_logmel_hp_route_matches_jax(kw):
    x = _frames(4, (2, 9000))
    got = batch_logmel.BatchLogMel(BatchLogMelConfig(**kw), fft_impl="hp",
                                   device=CPU).compute(x).numpy()
    want = np.asarray(jbl.BatchLogMel(JBatchLogMelConfig(**kw),
                                      fft_impl="hp").compute(x))
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= CROSS_ROUTE


def test_multistream_bf3_matches_jax(jfk):
    """tests/test_multistream.py's bf3 case: bulk and scan agree, and the
    port's bulk and scan hold JAX's bf3 mels and the float64 rdft route."""
    h = 30
    chunks = np.stack([jfk[: h * 160].reshape(h, 160),
                       jfk[6400 : 6400 + h * 160].reshape(h, 160)])
    port = MultiStreamMel(MelConfig(400, 160, 80, 16000.0), 2,
                          fft_impl="bf3", device=CPU)
    ref = jms.MultiStreamMel(JMelConfig(400, 160, 80, 16000.0), 2,
                             fft_impl="bf3")
    f64 = MultiStreamMel(MelConfig(400, 160, 80, 16000.0), 2,
                         dtype=torch.float64, device=CPU)
    _, mb, vb = port.push_many(port.init(), chunks)
    _, ms, vs = port.push_many(port.init(), chunks, scan=True)
    _, mj, vj = ref.push_many(ref.init(), chunks)
    _, mr, vr = f64.push_many(f64.init(), chunks)
    np.testing.assert_array_equal(vb, vs)
    np.testing.assert_array_equal(vb, np.asarray(vj))
    np.testing.assert_array_equal(vb, vr)
    np.testing.assert_allclose(mb[vb], ms[vs], atol=1e-5)
    np.testing.assert_allclose(mb[vb], np.asarray(mj)[vb], atol=2e-5)
    np.testing.assert_allclose(mb[vb], mr[vr], atol=1e-5)
