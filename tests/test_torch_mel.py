"""The port's whisper log-mel (CPU, plain path) against the JAX package on
the same numpy inputs, and against the shared goldens at the JAX tests'
bars.

Tolerances: the sig route's plain version and JAX's interpret-mode kernel
share every rounding except the order in which the DFT dot sums its exact
bf16 products in f32 (JAX: XLA's dot; port: torch.matmul), so they agree
to the 1e-5 accuracy gate. The plain f32 routes ("fft", "rdft") differ in FFT /
matmul summation order; on white noise (no near-silent bins) that is
~1e-6 of output, held at 2e-5.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from melspec_tpu import config as jconfig
from melspec_tpu.io import wav as jwav
from melspec_tpu.ops import filterbank as jfb
from melspec_tpu.ops import mel_kernel as jmk
from melspec_tpu.ops import spectrogram as jsp
from melspec_tpu.ops import windows as jwin
from melspec_tpu_torch import config, read_wav_f32le
from melspec_tpu_torch.ops import filterbank, mel_kernel, spectrogram, windows

TESTDATA = Path(__file__).resolve().parents[1] / "testdata"
CPU = "cpu"


def _noise(seed, shape):
    return (np.random.default_rng(seed).normal(size=shape) * 0.2).astype(
        np.float32)


@pytest.mark.parametrize("n_mels", [80, 128])
@pytest.mark.parametrize("streaming", [False, True])
@pytest.mark.parametrize("shape", [(1, 16000), (3, 12345), (6000,)],
                         ids=["B1", "B3-ragged", "1-D"])
def test_sig_matches_jax_interpret(n_mels, streaming, shape):
    x = _noise(sum(shape) + n_mels, shape)
    want = np.asarray(jmk.whisper_mel_sig(x, 400, 160, n_mels, 16000.0,
                                          streaming=streaming,
                                          interpret=True))
    got = mel_kernel.whisper_mel_sig(x, 400, 160, n_mels, 16000.0,
                                     streaming=streaming, device=CPU).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5


@pytest.mark.parametrize("n_mels", [80, 128])
@pytest.mark.parametrize("streaming", [False, True])
def test_plain_f32_dot_matches_jax_interpret(n_mels, streaming):
    """K1's plain version as the card runs it (one f32 matmul) against JAX
    and against its own exact (float64) dot, at the 1e-5 gate."""
    from melspec_tpu_torch.kernels.sig_mel import sig_mel_reference
    from melspec_tpu_torch.ops import framing

    x = _noise(31 + n_mels, (3, 12345))
    want = np.asarray(jmk.whisper_mel_sig(x, 400, 160, n_mels, 16000.0,
                                          streaming=streaming,
                                          interpret=True))
    mats = mel_kernel.sig_matrices(400, n_mels, 16000.0, 3, 2,
                                   torch.device(CPU))
    offset = framing.streaming_frame_offset(400, 160) if streaming else 0
    nf = (framing.num_frames_streaming if streaming
          else framing.num_frames_batch)(12345, 400, 160)
    out = {dt: sig_mel_reference(
        torch.from_numpy(x), mats.head(400, n_mels), ks=3, n_frames=nf,
        hop=160, offset=offset, dot_dtype=dt).numpy()
        for dt in (torch.float32, torch.float64)}
    assert out[torch.float32].shape == want.shape
    assert np.abs(out[torch.float32] - want).max() <= 1e-5
    assert np.abs(out[torch.float32] - out[torch.float64]).max() <= 1e-5


@pytest.mark.parametrize("ks,cutoff,mel_precision", [
    (2, 1, "bf2"), (3, 2, "highest"),
])
def test_sig_schedules_match_jax(ks, cutoff, mel_precision):
    import jax

    x = _noise(7, (2, 8000))
    prec = "bf2" if mel_precision == "bf2" else jax.lax.Precision.HIGHEST
    want = np.asarray(jmk.whisper_mel_sig(x, 512, 160, 80, 16000.0,
                                          ks=ks, cutoff=cutoff,
                                          mel_precision=prec,
                                          interpret=True))
    got = mel_kernel.whisper_mel_sig(x, 512, 160, 80, 16000.0, ks=ks,
                                     cutoff=cutoff,
                                     mel_precision=mel_precision,
                                     device=CPU).numpy()
    assert np.abs(got - want).max() <= 1e-5


@pytest.mark.parametrize("streaming", [False, True])
def test_sig_zero_frame_clips(streaming):
    for x in (np.zeros(399, np.float32), np.zeros((3, 100), np.float32)):
        want = np.asarray(jmk.whisper_mel_sig(x, 400, 160, 80, 16000.0,
                                              streaming=streaming,
                                              interpret=True))
        got = mel_kernel.whisper_mel_sig(x, 400, 160, 80, 16000.0,
                                         streaming=streaming, device=CPU)
        assert tuple(got.shape) == want.shape


def test_sig_rejects_configs_jax_rejects():
    with pytest.raises(ValueError, match="geometry"):
        mel_kernel.whisper_mel_sig(np.zeros(9000, np.float32), 8000, 160,
                                   device=CPU)
    with pytest.raises(ValueError, match="mel_precision"):
        mel_kernel.whisper_mel_sig(np.zeros(9000, np.float32),
                                   mel_precision="f16", device=CPU)


def test_pallas_resolves_to_sig():
    x = _noise(8, (2, 5000))
    a = mel_kernel.whisper_mel_pallas(x, device=CPU)
    b = mel_kernel.whisper_mel_sig(x, device=CPU)
    assert torch.equal(a, b)


@pytest.mark.parametrize("kw,kernel", [
    (dict(impl="bf3"), "K5"), (dict(impl="hp8"), "K6"),
    (dict(impl="hp_bf16"), "K7"), (dict(hp=True), "K7"),
    (dict(impl="f32"), "K8"),
])
def test_pallas_unported_kernels_raise(kw, kernel):
    """Each framed ``impl`` runs its kernel (``kernel``) or, on the CPU, its
    plain version, held against JAX's kernel in interpret mode: K6/K7
    (exact DFTs) at 1e-6, K5/K8 at 2e-5."""
    from melspec_tpu_torch.kernels.framed_mel import KERNEL

    assert KERNEL[kw.get("impl", "hp_bf16")] == kernel
    x = _noise(21, (4000,))
    want = np.asarray(jmk.whisper_mel_pallas(x, interpret=True, **kw))
    got = mel_kernel.whisper_mel_pallas(x, device=CPU, **kw).numpy()
    assert got.shape == want.shape == (23, 80)
    tol = 1e-6 if kernel in ("K6", "K7") else 2e-5
    assert np.abs(got - want).max() <= tol


def _pipes(fft_impl, dtype):
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    return (spectrogram.WhisperMelPipeline(400, 160, 80, 16000.0,
                                           dtype=dtype, fft_impl=fft_impl,
                                           device=CPU),
            jsp.WhisperMelPipeline(400, 160, 80, 16000.0, dtype=jdt,
                                   fft_impl=fft_impl))


@pytest.mark.parametrize("fft_impl", ["fft", "rdft"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.float64, 1e-10)])
def test_pipeline_matches_jax(fft_impl, dtype, tol):
    port, ref = _pipes(fft_impl, dtype)
    x = _noise(9, (2, 7000)).astype(
        np.float64 if dtype == torch.float64 else np.float32)
    got = port.mel_batch(x).numpy()
    want = np.asarray(ref.mel_batch(x))
    assert got.shape == want.shape and np.abs(got - want).max() <= tol
    got = port.mel_streaming_equivalent(x).numpy()
    want = np.asarray(ref.mel_streaming_equivalent(x))
    assert got.shape == want.shape and np.abs(got - want).max() <= tol


def test_pipeline_sig_route_matches_jax_sig():
    x = _noise(10, (2, 7000))
    port = spectrogram.WhisperMelPipeline(400, 160, 128, fft_impl="sig",
                                          device=CPU)
    ref = jsp.WhisperMelPipeline(400, 160, 128, fft_impl="sig")
    for a, b in [(port.mel_batch(x), ref.mel_batch(x)),
                 (port.mel_streaming_equivalent(x),
                  ref.mel_streaming_equivalent(x))]:
        assert a.shape == b.shape
        assert np.abs(a.numpy() - np.asarray(b)).max() <= 1e-5


@pytest.mark.parametrize("fn", ["compute_mel_spectrogram",
                                "compute_streaming_mel"])
@pytest.mark.parametrize("fft_impl", ["fft", "rdft"])
def test_compute_functions_match_jax(fn, fft_impl):
    x = _noise(11, (9000,)).astype(np.float64)
    got = getattr(spectrogram, fn)(x, 512, 160, 80, 16000.0,
                                   dtype=torch.float64, fft_impl=fft_impl,
                                   device=CPU)
    want = getattr(jsp, fn)(x, 512, 160, 80, 16000.0, dtype=jnp.float64,
                            fft_impl=fft_impl)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-6


def test_pipeline_auto_and_unported_impls():
    """The CPU's auto route, the hp and bf3 routes against JAX's (hp at
    1e-6, bf3 at 2e-5), and the refusals."""
    assert spectrogram.WhisperMelPipeline(device=CPU).fft_impl == "fft"
    x = _noise(22, (2, 5000))
    for impl, tol in (("hp", 1e-6), ("bf3", 2e-5)):
        port = spectrogram.WhisperMelPipeline(fft_impl=impl, device=CPU)
        ref = jsp.WhisperMelPipeline(fft_impl=impl)
        assert np.abs(port.mel_batch(x).numpy()
                      - np.asarray(ref.mel_batch(x))).max() <= tol
    with pytest.raises(ValueError, match="float32-only"):
        spectrogram.WhisperMelPipeline(fft_impl="sig", dtype=torch.float64,
                                       device=CPU)
    with pytest.raises(ValueError, match="fft_impl must be"):
        spectrogram.WhisperMelPipeline(fft_impl="dct", device=CPU)


@pytest.mark.parametrize("fft_impl", ["sig", "fft"])
def test_mel_batch_chunking_is_exact(monkeypatch, fft_impl):
    """Batch chunks and, for a clip over the budget, time chunks at frame
    boundaries concatenate to the unchunked result."""
    pipe = spectrogram.WhisperMelPipeline(400, 160, 80, fft_impl=fft_impl,
                                          device=CPU)
    x = _noise(12, (3, 9000))
    whole = pipe.mel_batch(x)
    var = ("MELSPEC_SIG_BUDGET_BYTES" if fft_impl == "sig"
           else "MELSPEC_FRAMES_BUDGET_BYTES")
    per_clip = ((9000 + whole.shape[1] * 80) * 4 if fft_impl == "sig"
                else whole.shape[1] * 512 * 4)
    # bar 1e-6: CPU BLAS may block the f32 projection matmul differently
    # for another number of rows
    monkeypatch.setenv(var, str(per_clip))        # one clip per chunk
    np.testing.assert_allclose(pipe.mel_batch(x), whole, rtol=0, atol=1e-6)
    monkeypatch.setenv(var, str(per_clip // 5))   # time chunks
    np.testing.assert_allclose(pipe.mel_batch(x[0]), whole[0], rtol=0,
                               atol=1e-6)


def test_norms_and_projection_match_jax():
    lm = np.random.default_rng(13).normal(size=(4, 80)) * 3
    for axis in (None, -1):
        np.testing.assert_allclose(
            spectrogram.whisper_norm(torch.from_numpy(lm), axis=axis).numpy(),
            np.asarray(jsp.whisper_norm(jnp.asarray(lm), axis=axis)))
    np.testing.assert_allclose(spectrogram.norm_mel(lm).numpy(),
                               np.asarray(jsp.norm_mel(lm)))
    frame = np.fft.fft(np.random.default_rng(14).normal(size=400))
    np.testing.assert_array_equal(
        spectrogram.MelProjection(400, 16000.0, 80).add(frame),
        jsp.MelProjection(400, 16000.0, 80).add(frame))


def test_host_copies_match_jax():
    for args in [(16000.0, 400, 80), (16000.0, 512, 80), (16000.0, 400, 128),
                 (8000.0, 256, 40)]:
        np.testing.assert_array_equal(filterbank.mel_filterbank(*args),
                                      jfb.mel_filterbank(*args))
    np.testing.assert_array_equal(
        filterbank.mel_filterbank(16000.0, 400, 80, htk=True, norm=False),
        jfb.mel_filterbank(16000.0, 400, 80, htk=True, norm=False))
    for n in (400, 512):
        np.testing.assert_array_equal(windows.hann_periodic(n),
                                      jwin.hann_periodic(n))
    np.testing.assert_array_equal(
        read_wav_f32le(TESTDATA / "jfk_f32le.wav"),
        jwav.read_wav_f32le(TESTDATA / "jfk_f32le.wav"))
    assert config.WHISPER_LARGE_V3 == config.MelConfig(
        *[getattr(jconfig.WHISPER_LARGE_V3, f) for f in
          ("fft_size", "hop_size", "n_mels", "sampling_rate")])
    with pytest.raises(ValueError):
        config.MelConfig(hop_size=500)


@pytest.fixture(scope="module")
def jfk():
    return read_wav_f32le(TESTDATA / "jfk_f32le.wav")


def test_jfk_golden_sig(jfk):
    golden = np.load(TESTDATA / "rust_jfk_golden.npy")
    got = mel_kernel.whisper_mel_sig(jfk, 512, 160, 80, 16000.0,
                                     streaming=True, device=CPU).T.numpy()
    assert got.shape == golden.shape
    assert np.abs(got - golden).max() <= 1e-5


@pytest.mark.parametrize("fft_impl", ["rdft", "fft"])
def test_jfk_golden_f64(jfk, fft_impl):
    golden = np.load(TESTDATA / "rust_jfk_golden.npy")
    got = spectrogram.compute_streaming_mel(jfk, 512, 160, 80, 16000.0,
                                            dtype=torch.float64,
                                            fft_impl=fft_impl, device=CPU)
    assert got.shape == golden.shape
    assert np.abs(got - golden).max() <= 1e-6


@pytest.fixture(scope="module")
def synthetic():
    return np.load(TESTDATA / "synthetic_signal.npy")


def test_synthetic_whisper_golden_f64(synthetic):
    golden = np.load(TESTDATA / "synthetic_whisper_mel_golden.npy")
    got = spectrogram.compute_streaming_mel(synthetic, 400, 160, 80, 16000.0,
                                            dtype=torch.float64, device=CPU)
    assert np.abs(got - golden).max() <= 1e-6


def test_synthetic_whisper128_golden(synthetic):
    c = config.WHISPER_LARGE_V3
    golden = np.load(TESTDATA / "synthetic_whisper128_golden.npy")
    f64 = spectrogram.compute_streaming_mel(synthetic, c.fft_size,
                                            c.hop_size, c.n_mels,
                                            c.sampling_rate,
                                            dtype=torch.float64, device=CPU)
    assert np.abs(f64 - golden).max() <= 1e-6
    got = mel_kernel.whisper_mel_sig(synthetic, c.fft_size, c.hop_size,
                                     c.n_mels, c.sampling_rate,
                                     streaming=True, device=CPU).T.numpy()
    assert got.shape == golden.shape
    assert np.abs(got - golden).max() <= 2e-5
