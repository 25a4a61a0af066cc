"""K1's host-built matrices: the port's builders must give the JAX
package's bits exactly, and matrices carried across from JAX must drive
the port to the same output as its own."""

import numpy as np
import pytest
import torch

from melspec_tpu.ops import hp_dft as jhp
from melspec_tpu.ops import mel_kernel as jmk
from melspec_tpu_torch import convert
from melspec_tpu_torch.ops import hp_dft, mel_kernel
from melspec_tpu_torch.ops.filterbank import mel_filterbank
from melspec_tpu_torch.ops.windows import hann_periodic


def _bits(t) -> np.ndarray:
    """bf16 bit patterns of a torch tensor or a JAX/ml_dtypes array."""
    if isinstance(t, torch.Tensor):
        return t.contiguous().view(torch.int16).numpy().view(np.uint16)
    return np.asarray(t).view(np.uint16)


@pytest.mark.parametrize("fft,n_mels,ks,cutoff", [
    (400, 80, 3, 2), (400, 128, 3, 2), (512, 80, 3, 2), (400, 80, 2, 1),
])
def test_device_matrices_bit_identical_to_jax(fft, n_mels, ks, cutoff):
    want = jmk._sig_device_matrices(fft, n_mels, 16000.0, ks, ks, cutoff)
    got = mel_kernel._sig_device_matrices(fft, n_mels, 16000.0, ks, ks,
                                          cutoff)
    np.testing.assert_array_equal(_bits(got[0]), _bits(want[0]))  # m_big
    assert got[1] == want[1]  # pair_i
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(_bits(got[3]), _bits(want[3]))  # mt_bf2
    assert want[7] is False  # JAX picks the split layout here too
    assert tuple(got[4:]) == tuple(want[4:7])


def test_split_layout_at_fft320_bit_identical_to_jax():
    """Where JAX's "auto" would N-pack a whisper head (fft 320: 384
    columns < 2 * 256), the port's whisper matrices keep the split layout
    (the kernels take 512 columns), bit for bit JAX's ``npack=False``."""
    fb = mel_filterbank(16000.0, 320, 80)
    want = jmk._sig_frontend_matrices(320, 160, hann_periodic(320), fb,
                                      3, 3, 2, npack=False)
    got = mel_kernel._sig_frontend_matrices(320, 160, hann_periodic(320), fb,
                                            3, 3, 2, npack=False)
    np.testing.assert_array_equal(_bits(got[0]), _bits(want[0]))
    assert got[0].shape[1] == 512
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[2], want[2])
    assert got[3:7] == want[3:7]
    whisper = mel_kernel._sig_device_matrices(320, 80, 16000.0, 3, 3, 2)
    np.testing.assert_array_equal(_bits(whisper[0]), _bits(want[0]))
    assert whisper[4] == 256


def test_bf16_round_slices_match_ml_dtypes_double_rounding():
    """ml_dtypes rounds float64 -> bf16 through float32; values just off a
    bf16 halfway point tell the two roundings apart."""
    rng = np.random.default_rng(3)
    half = 1.0 + 2.0 ** -8
    mat = np.concatenate([
        rng.normal(size=4099) * 10.0 ** rng.integers(-6, 3, size=4099),
        [half + 2.0 ** -30, half - 2.0 ** -30, -half - 2.0 ** -40],
    ]).reshape(-1, 7)
    for got, want in zip(hp_dft.bf16_round_slices(mat, 3),
                         jhp.bf16_round_slices(mat, 3)):
        np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("fft,hop", [(400, 160), (512, 160), (400, 10),
                                     (2048, 512), (4096, 7), (8000, 160)])
@pytest.mark.parametrize("offset", [0, 80, 112])
def test_geometry_accepts_what_jax_accepts(fft, hop, offset):
    assert mel_kernel.sig_geometry(fft, hop, offset) == \
        jmk.sig_geometry(fft, hop, offset)


@pytest.mark.parametrize("fft", [400, 512, 25])
def test_packed_im_bins_match_jax(fft):
    assert mel_kernel.sig_packed_im_bins(fft, fft // 2) == \
        jmk.sig_packed_im_bins(fft, fft // 2)


@pytest.mark.parametrize("form", ["ml_dtypes", "uint16", "float32"])
def test_from_jax_matrices_round_trip(form):
    m_big, pair_i, mt, mt_bf2 = jmk._sig_device_matrices(
        400, 80, 16000.0, 3, 3, 2)[:4]

    def host(a):
        a = np.asarray(a)
        if form == "uint16":
            return a.view(np.uint16)
        if form == "float32":
            return a.astype(np.float32)
        return a

    mats = convert.from_jax_sig_matrices(host(m_big), pair_i,
                                         np.asarray(mt), host(mt_bf2))
    own = mel_kernel.sig_matrices(400, 80, 16000.0, 3, 2,
                                  torch.device("cpu"))
    np.testing.assert_array_equal(_bits(mats.m_big), _bits(own.m_big))
    np.testing.assert_array_equal(_bits(mats.mt_bf2), _bits(own.mt_bf2))
    assert torch.equal(mats.mt, own.mt)
    assert (mats.pair_i, mats.n_bins_pad) == (own.pair_i, own.n_bins_pad)

    x = (np.random.default_rng(4).normal(size=(2, 6000)) * 0.2).astype(
        np.float32)
    a = mel_kernel.whisper_mel_sig(x, device="cpu", matrices=mats)
    b = mel_kernel.whisper_mel_sig(x, device="cpu")
    assert torch.equal(a, b)


def test_from_jax_n_packed_set():
    """An N-packed JAX set (JAX packs its fft-320 whisper head into 384
    columns) converts with split point 0 and drives the plain version to
    the split layout's output within the bf2 projection's rounding."""
    m_big, pair_i, mt, mt_bf2, _, _, _, npack = jmk._sig_device_matrices(
        320, 80, 16000.0, 3, 3, 2)
    assert npack is True
    mats = convert.from_jax_sig_matrices(np.asarray(m_big), pair_i,
                                         np.asarray(mt), np.asarray(mt_bf2))
    assert mats.n_bins_pad == 0 and mats.m_big.shape[1] == 384
    np.testing.assert_array_equal(_bits(mats.m_big), _bits(m_big))
    x = (np.random.default_rng(5).normal(size=(2, 6000)) * 0.2).astype(
        np.float32)
    packed = mel_kernel.whisper_mel_sig(x, 320, 160, device="cpu",
                                        matrices=mats)
    split = mel_kernel.whisper_mel_sig(x, 320, 160, device="cpu")
    assert float((packed - split).abs().max()) <= 1e-5


def test_from_jax_rejects_inconsistent_shapes():
    m_big, pair_i, mt, mt_bf2 = jmk._sig_device_matrices(
        400, 80, 16000.0, 3, 3, 2)[:4]
    with pytest.raises(ValueError, match="inconsistent"):
        convert.from_jax_sig_matrices(np.asarray(m_big), pair_i,
                                      np.asarray(mt)[:100],
                                      np.asarray(mt_bf2))
    with pytest.raises(ValueError, match="not bf16"):
        convert.from_jax_sig_matrices(
            np.asarray(m_big).astype(np.float32) + np.float32(1e-4), pair_i,
            np.asarray(mt), np.asarray(mt_bf2))
