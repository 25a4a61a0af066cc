"""Kaldi fbank, port vs JAX on the same numpy inputs: the Kaldi host
pieces (filterbank, Povey window, the preprocessing fold) bit for bit,
K1's Kaldi head bit-identical to JAX's, the float64 routes at
the JAX naive tests' 1e-9, the float32 and sig routes at the JAX
cross-route bar of 2e-4, and the goldens."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from melspec_tpu.config import FbankConfig as JFbankConfig
from melspec_tpu.ops import fbank as jfbank
from melspec_tpu.ops import filterbank as jfilt
from melspec_tpu.ops import mel_kernel as jmk
from melspec_tpu.ops import windows as jwin
from melspec_tpu_torch import convert
from melspec_tpu_torch.config import FbankConfig
from melspec_tpu_torch.io.wav import read_wav_f32le
from melspec_tpu_torch.kernels import sig_mel
from melspec_tpu_torch.ops import fbank, filterbank, mel_kernel, windows

TESTDATA = Path(__file__).resolve().parents[1] / "testdata"
# the JAX package's bar between its f32 / sig routes and its other routes
CROSS_ROUTE = 2e-4

CONFIGS = {
    "default": {},
    "no_cmn": dict(apply_cmn=False),
    "no_preemph_magnitude": dict(preemphasis=0.0, use_power=False),
    "linear_floor": dict(num_mel_bins=40, energy_floor=1e-6,
                         use_log_fbank=False),
}
SIG_CONFIGS = {"default": {}, "no_preemph": dict(preemphasis=0.0),
               "shift20": dict(frame_shift_ms=20.0)}


def _bits(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.contiguous().view(torch.int16).numpy().view(np.uint16)
    return np.asarray(t).view(np.uint16)


def _signal(seed, shape, scale=0.3):
    return (np.random.default_rng(seed).normal(size=shape)
            * scale).astype(np.float32)


@pytest.fixture(scope="module")
def jfk():
    return read_wav_f32le(TESTDATA / "jfk_f32le.wav")


@pytest.mark.parametrize("n", [400, 200, 512])
def test_povey_window_and_preproc_match_jax(n):
    np.testing.assert_array_equal(windows.povey(n), jwin.povey(n))
    for p in (0.97, 0.0):
        np.testing.assert_array_equal(fbank.kaldi_preproc_matrix(n, p),
                                      jfbank.kaldi_preproc_matrix(n, p))


@pytest.mark.parametrize("args", [(16000.0, 512, 80, 20.0, 0.0),
                                  (16000.0, 512, 40, 20.0, 7000.0),
                                  (8000.0, 256, 23, 0.0, 0.0)])
def test_kaldi_filterbank_matches_jax(args):
    np.testing.assert_array_equal(filterbank.kaldi_filterbank(*args),
                                  jfilt.kaldi_filterbank(*args))
    for hz in (0.0, 20.0, 1000.0, 7999.0):
        assert filterbank.kaldi_hz_to_mel(hz) == jfilt.kaldi_hz_to_mel(hz)
        assert filterbank.kaldi_mel_to_hz(hz) == jfilt.kaldi_mel_to_hz(hz)
    dense = filterbank.kaldi_filterbank(*args)
    got = filterbank.SparseFilterbankView.from_dense(dense)
    want = jfilt.SparseFilterbankView.from_dense(dense)
    assert (got.rows, got.fft_bins, got.non_zero_weights,
            got.dense_weights) == (want.rows, want.fft_bins,
                                   want.non_zero_weights, want.dense_weights)


def test_config_matches_jax():
    for kw in ({}, dict(frame_length_ms=20.0, sample_rate=8000.0),
               dict(frame_length_ms=32.0, high_freq=6000.0)):
        got, want = FbankConfig(**kw), JFbankConfig(**kw)
        assert (got.frame_length_samples, got.frame_shift_samples,
                got.fft_size, got.effective_high_freq) == (
            want.frame_length_samples, want.frame_shift_samples,
            want.fft_size, want.effective_high_freq)
    for bad in (dict(sample_rate=0), dict(num_mel_bins=0),
                dict(frame_shift_ms=0), dict(low_freq=9000.0),
                dict(high_freq=9000.0)):
        with pytest.raises(ValueError):
            JFbankConfig(**bad)
        with pytest.raises(ValueError):
            FbankConfig(**bad)


@pytest.mark.parametrize("name", sorted(SIG_CONFIGS))
def test_sig_head_bit_identical_to_jax(name):
    """K1's Kaldi head: the N-packed 512-column matrices with the DC +
    preemphasis fold, bit for bit the JAX Fbank's."""
    kw = SIG_CONFIGS[name]
    want = jfbank.Fbank(JFbankConfig(**kw), fft_impl="sig")
    head = fbank.sig_head(FbankConfig(**kw))
    np.testing.assert_array_equal(_bits(head.m_big), _bits(want._sig_m_big))
    np.testing.assert_array_equal(_bits(head.mt), _bits(want._sig_mt))
    assert head.pair_i == want._sig_pair_i
    assert want._sig_npack is True and head.n_bins_pad == 0
    assert head.m_big.shape[1] == 512 and head.pack == 400
    assert (head.out_mode, head.guard) == ("ln_floor", fbank.F32_EPSILON)


@pytest.mark.parametrize("npack", [True, False, "auto"])
def test_preproc_fold_bit_identical_to_jax(npack):
    cfg = JFbankConfig()
    n, fft = cfg.frame_length_samples, cfg.fft_size
    win = jwin.povey(n)
    filt = jfilt.kaldi_filterbank(16000.0, fft, 80, 20.0, 8000.0)
    pre = jfbank.kaldi_preproc_matrix(n, 0.97)
    want = jmk._sig_frontend_matrices(fft, fft // 2 + 1, win, filt, 3, 3, 2,
                                      pack=n, preproc=pre, npack=npack)
    got = mel_kernel._sig_frontend_matrices(fft, fft // 2 + 1, win, filt,
                                            3, 3, 2, pack=n, preproc=pre,
                                            npack=npack)
    np.testing.assert_array_equal(_bits(got[0]), _bits(want[0]))
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[2], want[2])
    assert got[3:] == want[3:]


@pytest.mark.parametrize("impl", ["rdft", "fft"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_float64_routes_match_jax(name, impl):
    kw = CONFIGS[name]
    x = _signal(5, 8000)
    want = np.asarray(jfbank.Fbank(JFbankConfig(**kw), dtype=jnp.float64)
                      .compute(x))
    got = fbank.Fbank(FbankConfig(**kw), dtype=torch.float64, fft_impl=impl,
                      device="cpu").compute(x).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-9)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_float32_rdft_in_jax_accuracy_class(name):
    """The f32 route against JAX's float64 result, at 2e-4 or JAX's own
    f32 route's distance from it on the same input, whichever is larger
    (relative to the value where the output is linear energy). Port and
    JAX f32 are not held to each other at 2e-4: the frame mean,
    preemphasis and DFT sums round in another order, and ln turns that
    into absolute error on quiet bins; here JAX's f32 route sits 4.3e-4
    from float64 and the port's 1.1e-4, 5.4e-4 apart."""
    kw = CONFIGS[name]
    x = _signal(6, (2, 9000))
    f64 = np.asarray(jfbank.Fbank(JFbankConfig(**kw), dtype=jnp.float64)
                     .compute(x))
    jax32 = np.asarray(jfbank.Fbank(JFbankConfig(**kw), dtype=jnp.float32,
                                    fft_impl="rdft").compute(x))
    got = fbank.Fbank(FbankConfig(**kw), fft_impl="rdft",
                      device="cpu").compute(x).numpy()
    assert got.shape == f64.shape and got.dtype == np.float32
    scale = (1.0 if FbankConfig(**kw).use_log_fbank
             else np.maximum(1.0, np.abs(f64)))
    bar = max(CROSS_ROUTE, float((np.abs(jax32 - f64) / scale).max()))
    assert float((np.abs(got - f64) / scale).max()) <= bar


@pytest.mark.parametrize("name", sorted(SIG_CONFIGS))
def test_sig_route_matches_jax_sig_route(name):
    """K1's plain version (float64 dot) against the JAX Pallas kernel in
    interpret mode, and against the JAX float64 route."""
    kw = SIG_CONFIGS[name]
    x = _signal(7, (2, 8000), 0.2)
    want = np.asarray(jfbank.Fbank(JFbankConfig(**kw), fft_impl="sig")
                      .compute(x))
    f64 = np.asarray(jfbank.Fbank(JFbankConfig(**kw), dtype=jnp.float64)
                     .compute(x))
    fb = fbank.Fbank(FbankConfig(**kw), fft_impl="sig", device="cpu")
    before = sig_mel.launches
    got = fb.compute(x).numpy()
    assert sig_mel.launches == before
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= CROSS_ROUTE
    assert np.abs(got - f64).max() <= CROSS_ROUTE


def test_jfk_gate_through_sig_route(jfk):
    """The kaldi_native_fbank golden through K1's plain version: the JAX
    package's measured 0.0152 gate."""
    with np.load(TESTDATA / "kaldi_native_fbank_jfk.npz") as npz:
        golden = npz["features"].T
    got = fbank.Fbank(FbankConfig(), fft_impl="sig",
                      device="cpu").compute(jfk).numpy()
    assert got.shape == golden.shape
    assert np.abs(got - golden).max() <= 0.0152
    rdft = fbank.Fbank(FbankConfig(), device="cpu").compute(jfk).numpy()
    assert np.abs(rdft - golden).max() < 0.05  # tests/test_fbank.py's bar


def test_synthetic_golden():
    golden = np.load(TESTDATA / "synthetic_fbank_golden.npy")
    sig = np.load(TESTDATA / "synthetic_signal.npy")
    got = fbank.Fbank(FbankConfig(), dtype=torch.float64,
                      device="cpu").compute(sig).numpy()
    assert np.abs(got - golden).max() <= 1e-6


def test_routes_and_validation():
    assert fbank.Fbank(device="cpu").fft_impl == "rdft"  # auto on the CPU
    x = _signal(23, (2, 8000))
    hp = fbank.Fbank(fft_impl="hp", device="cpu").compute(x).numpy()
    want = np.asarray(jfbank.Fbank(JFbankConfig(), fft_impl="hp").compute(x))
    assert np.abs(hp - want).max() <= CROSS_ROUTE
    # magnitude spectra take K1 on a split head (its plain version here)
    mag = fbank.Fbank(FbankConfig(use_power=False), fft_impl="sig",
                      device="cpu")
    assert mag.sig_head.magnitude and mag.sig_head.n_bins_pad == 256
    with pytest.raises(ValueError):
        fbank.Fbank(FbankConfig(use_log_fbank=False), fft_impl="sig",
                    device="cpu")
    with pytest.raises(ValueError):
        fbank.Fbank(dtype=torch.float64, fft_impl="sig", device="cpu")
    with pytest.raises(ValueError):
        fbank.Fbank(fft_impl="nope", device="cpu")


def test_batched_short_and_dither():
    fb = fbank.Fbank(FbankConfig(), dtype=torch.float64, device="cpu")
    batch = _signal(9, (2, 4000))
    got = fb.compute(batch)
    # the batched route multiplies [B * frames, taps] by the DFT matrix,
    # the 1-D route [frames, taps]: the CPU BLAS may pick another kernel,
    # and so another summation order, for the other row count (rows
    # differ by up to 6.7e-15 on some machines), so the pair is held to a
    # float64 bar, not to equality
    for i in range(2):
        assert (got[i] - fb.compute(batch[i])).abs().max() <= 1e-12
    assert tuple(fb.compute(np.zeros(100, np.float32)).shape) == (0, 80)
    dith = fbank.Fbank(FbankConfig(dither=1.0), device="cpu")
    plain = dith.compute(batch)
    assert torch.equal(plain, fbank.Fbank(device="cpu").compute(batch))
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    a, b = dith.compute(batch, generator=g1), dith.compute(batch,
                                                           generator=g2)
    assert torch.equal(a, b) and not torch.equal(a, plain)


def test_jax_matrices_carried_across():
    """JAX's Kaldi head through ``convert.from_jax_head`` drives the port's
    Fbank to its own output bit for bit."""
    jf = jfbank.Fbank(JFbankConfig(), fft_impl="sig")
    head = convert.from_jax_head(np.asarray(jf._sig_m_big), jf._sig_pair_i,
                                 np.asarray(jf._sig_mt), 0, 400, 0, 80,
                                 "ln_floor", fbank.F32_EPSILON)
    x = _signal(10, (2, 6000))
    a = fbank.Fbank(fft_impl="sig", device="cpu", matrices=head).compute(x)
    b = fbank.Fbank(fft_impl="sig", device="cpu").compute(x)
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="inconsistent"):
        convert.from_jax_head(np.asarray(jf._sig_m_big), jf._sig_pair_i,
                              np.asarray(jf._sig_mt), 256, 400, 0, 80)
