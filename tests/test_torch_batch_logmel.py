"""NeMo batch log-mel, port vs JAX on the same numpy inputs: windows,
filters and K1's NeMo head (N-packed, ``pack_off``) bit for bit, the
float64 routes at the JAX naive tests' 1e-9, the float32 and sig routes
at the JAX cross-route bar of 2e-4, the goldens and the ASR packaging."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from melspec_tpu.config import BatchLogMelConfig as JConfig
from melspec_tpu.ops import batch_logmel as jbl
from melspec_tpu.ops import windows as jwin
from melspec_tpu_torch import convert
from melspec_tpu_torch.config import BatchLogMelConfig
from melspec_tpu_torch.kernels import sig_mel
from melspec_tpu_torch.ops import batch_logmel as bl
from melspec_tpu_torch.ops import windows

TESTDATA = Path(__file__).resolve().parents[1] / "testdata"
CROSS_ROUTE = 2e-4

CONFIGS = {
    "default": {},
    "m128_preemph_norm": dict(n_mels=128, preemphasis=0.97,
                              log_zero_guard=2.0 ** -24,
                              normalize_per_feature=True),
    "uncentered_pad16": dict(center=False, pad_to=16),
    "win512_hop128": dict(win_length=512, hop_length=128),
}
SIG_CONFIGS = {"default": {},
               "m128_preemph_norm_pad": dict(n_mels=128, preemphasis=0.97,
                                             normalize_per_feature=True,
                                             pad_to=16),
               "uncentered": dict(center=False)}


def _bits(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.contiguous().view(torch.int16).numpy().view(np.uint16)
    return np.asarray(t).view(np.uint16)


def _signal(seed, shape, scale=0.2):
    return (np.random.default_rng(seed).normal(size=shape)
            * scale).astype(np.float32)


@pytest.mark.parametrize("n_fft,win", [(512, 400), (512, 512), (400, 1),
                                       (64, 33)])
def test_centered_hann_matches_jax(n_fft, win):
    np.testing.assert_array_equal(windows.hann_centered(n_fft, win),
                                  jwin.hann_centered(n_fft, win))
    np.testing.assert_array_equal(windows.hann_centered_f32(n_fft, win),
                                  jwin.hann_centered_f32(n_fft, win))


def test_config_matches_jax():
    for kw in CONFIGS.values():
        got, want = BatchLogMelConfig(**kw), JConfig(**kw)
        assert (got.fft_bins, got.effective_f_max) == (want.fft_bins,
                                                       want.effective_f_max)
    for bad in (dict(win_length=1024), dict(hop_length=0),
                dict(log_zero_guard=0.0), dict(f_min=9000.0),
                dict(n_mels=0)):
        with pytest.raises(ValueError):
            JConfig(**bad)
        with pytest.raises(ValueError):
            BatchLogMelConfig(**bad)


def test_filters_bit_identical_and_nemo_golden():
    got = bl.BatchLogMel(device="cpu").filters
    np.testing.assert_array_equal(got, jbl.BatchLogMel().filters)
    with np.load(TESTDATA / "nemo_mel_filters.npz") as npz:
        want = npz["banks"][0].astype(np.float64)  # [80, 257]
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-7  # tests/test_filterbank.py


@pytest.mark.parametrize("name", sorted(SIG_CONFIGS) + ["hop256"])
def test_sig_head_bit_identical_to_jax(name):
    """K1's NeMo head: the window's 400 taps at pack_off 56 of the
    centered 512-tap frame, N-packed into 512 columns."""
    kw = SIG_CONFIGS.get(name, dict(hop_length=256))
    want = jbl.BatchLogMel(JConfig(**kw), fft_impl="sig")
    head = bl.sig_head(BatchLogMelConfig(**kw))
    np.testing.assert_array_equal(_bits(head.m_big), _bits(want._sig_m_big))
    np.testing.assert_array_equal(_bits(head.mt), _bits(want._sig_mt))
    assert head.pair_i == want._sig_pair_i
    assert (head.pack, head.pack_off) == (want._sig_pack, want._sig_pack_off)
    assert want._sig_npack is True and head.n_bins_pad == 0
    assert head.out_mode == "ln_guard"


@pytest.mark.parametrize("impl", ["rdft", "fft"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_float64_routes_match_jax(name, impl):
    kw = CONFIGS[name]
    x = _signal(7, 9973)
    want = np.asarray(jbl.BatchLogMel(JConfig(**kw), dtype=jnp.float64)
                      .compute(x))
    got = bl.BatchLogMel(BatchLogMelConfig(**kw), dtype=torch.float64,
                         fft_impl=impl, device="cpu").compute(x).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-9)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_float32_rdft_in_jax_accuracy_class(name):
    """The f32 route against JAX's float64 result, at 2e-4 or JAX's own
    f32 route's distance from it on the same input, whichever is larger:
    the per-feature normalization divides by a small std, so two f32
    summation orders can sit 3e-4 apart there while both stay in class."""
    kw = CONFIGS[name]
    x = _signal(8, (2, 9000))
    f64 = np.asarray(jbl.BatchLogMel(JConfig(**kw), dtype=jnp.float64)
                     .compute(x))
    jax32 = np.asarray(jbl.BatchLogMel(JConfig(**kw), dtype=jnp.float32,
                                       fft_impl="rdft").compute(x))
    got = bl.BatchLogMel(BatchLogMelConfig(**kw), fft_impl="rdft",
                         device="cpu").compute(x).numpy()
    assert got.shape == f64.shape and got.dtype == np.float32
    bar = max(CROSS_ROUTE, float(np.abs(jax32 - f64).max()))
    assert np.abs(got - f64).max() <= bar


@pytest.mark.parametrize("name", sorted(SIG_CONFIGS))
def test_sig_route_matches_jax_sig_route(name):
    """K1's plain version (float64 dot) against the JAX Pallas kernel in
    interpret mode."""
    kw = SIG_CONFIGS[name]
    x = _signal(9, (2, 8000))
    want = np.asarray(jbl.BatchLogMel(JConfig(**kw), fft_impl="sig")
                      .compute(x))
    front = bl.BatchLogMel(BatchLogMelConfig(**kw), fft_impl="sig",
                           device="cpu")
    before = sig_mel.launches
    got = front.compute(x).numpy()
    assert sig_mel.launches == before
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= CROSS_ROUTE


def test_synthetic_golden():
    golden = np.load(TESTDATA / "synthetic_nemo_golden.npy")
    sig = np.load(TESTDATA / "synthetic_signal.npy")
    cfg = BatchLogMelConfig(n_mels=128, preemphasis=0.97,
                            normalize_per_feature=True)
    got = bl.BatchLogMel(cfg, dtype=torch.float64,
                         device="cpu").compute(sig).numpy()
    assert np.abs(got - golden).max() <= 1e-6


def test_shapes_batch_and_empty():
    cfg = BatchLogMelConfig(n_mels=128, preemphasis=0.97,
                            log_zero_guard=2.0 ** -24,
                            normalize_per_feature=True)
    front = bl.BatchLogMel(cfg, device="cpu")
    assert front.fft_impl == "rdft"  # auto on the CPU
    assert tuple(front.compute(np.zeros(16000, np.float32)).shape) == \
        (128, 101)
    assert tuple(bl.BatchLogMel(device="cpu").compute(
        np.zeros(0, np.float32)).shape) == (80, 0)
    f64 = bl.BatchLogMel(dtype=torch.float64, device="cpu")
    batch = _signal(3, (3, 4800), 1.0)
    got = f64.compute(batch)
    # batched and 1-D routes run the DFT product at other row counts, and
    # the CPU BLAS may sum them in another order (rows differ by up to
    # 6.7e-15 on some machines): a float64 bar, not equality
    for i in range(3):
        assert (got[i] - f64.compute(batch[i])).abs().max() <= 1e-12
    flat, rows, cols = f64.compute_flat(batch[0])
    want = jbl.BatchLogMel(dtype=jnp.float64).compute_flat(batch[0])
    assert (rows, cols) == want[1:]
    np.testing.assert_allclose(flat, want[0], atol=1e-6)
    hp = bl.BatchLogMel(cfg, fft_impl="hp", device="cpu").compute(batch)
    want = jbl.BatchLogMel(JConfig(
        n_mels=128, preemphasis=0.97, log_zero_guard=2.0 ** -24,
        normalize_per_feature=True), fft_impl="hp").compute(batch)
    assert np.abs(hp.numpy() - np.asarray(want)).max() <= CROSS_ROUTE
    with pytest.raises(ValueError):
        bl.BatchLogMel(dtype=torch.float64, fft_impl="sig", device="cpu")


def test_mel_tensor_and_asr_session():
    frames = np.arange(240, dtype=np.float32)
    for fn in (bl.mel_tensor, jbl.mel_tensor):
        audio, lengths = fn(frames, 80)
        assert audio.shape == (1, 80, 3) and lengths.tolist() == [3]
        assert audio.dtype == np.float32 and lengths.dtype == np.int64
    np.testing.assert_array_equal(bl.mel_tensor(frames, 80)[0],
                                  jbl.mel_tensor(frames, 80)[0])
    seen = {}

    class FakeSession:
        def run(self, output_names, feeds):
            seen.update(feeds)
            assert output_names is None
            return [feeds["audio_signal"].sum()]

    out = bl.run_asr_session(FakeSession(), frames, 80)
    assert seen["audio_signal"].shape == (1, 80, 3)
    assert seen["length"].tolist() == [3]
    np.testing.assert_allclose(out[0], frames.sum())
    try:
        import onnxruntime  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="onnxruntime"):
            bl.run_asr_session("/nonexistent/model.onnx", frames, 80)


def test_jax_matrices_carried_across():
    jf = jbl.BatchLogMel(JConfig(), fft_impl="sig")
    head = convert.from_jax_head(np.asarray(jf._sig_m_big), jf._sig_pair_i,
                                 np.asarray(jf._sig_mt), 0, jf._sig_pack,
                                 jf._sig_pack_off, 80, "ln_guard",
                                 JConfig().log_zero_guard)
    x = _signal(10, (2, 6000))
    a = bl.BatchLogMel(fft_impl="sig", device="cpu", matrices=head)
    b = bl.BatchLogMel(fft_impl="sig", device="cpu")
    assert torch.equal(a.compute(x), b.compute(x))
