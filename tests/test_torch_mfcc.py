"""Kaldi-style MFCC, port vs JAX on the same numpy inputs: the DCT and
lifter bit for bit, the float64 route at 1e-9, and the float32 and sig
routes against JAX's."""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from melspec_tpu.config import FbankConfig as JFbankConfig
from melspec_tpu.config import MfccConfig as JMfccConfig
from melspec_tpu.ops import mfcc as jmfcc
from melspec_tpu_torch.config import FbankConfig, MfccConfig
from melspec_tpu_torch.io.wav import read_wav_f32le
from melspec_tpu_torch.ops import mfcc

TESTDATA = Path(__file__).resolve().parents[1] / "testdata"

CONFIGS = {
    "kaldi_default": ({}, {}),
    "ceps20_nolift_nocmn": (dict(num_ceps=20, cepstral_lifter=0.0,
                                 apply_cmn=False),
                            dict(num_mel_bins=40, apply_cmn=False)),
    "fbank80": ({}, dict(apply_cmn=False)),
}


def _configs(name):
    kw, fkw = CONFIGS[name]
    port = MfccConfig(**kw, fbank=FbankConfig(**fkw)) if fkw else \
        MfccConfig(**kw)
    jax_ = JMfccConfig(**kw, fbank=JFbankConfig(**fkw)) if fkw else \
        JMfccConfig(**kw)
    return port, jax_


@pytest.fixture(scope="module")
def speechish():
    rng = np.random.default_rng(21)
    t = np.arange(16000) / 16000.0
    x = (0.3 * np.sin(2 * np.pi * 220 * t) * (0.5 + 0.5 * np.sin(7 * t))
         + 0.05 * rng.normal(size=t.size))
    return x.astype(np.float32)


@pytest.mark.parametrize("num_ceps,n_mels,lifter", [(13, 23, 22.0),
                                                    (20, 40, 0.0),
                                                    (13, 80, 22.0)])
def test_dct_and_lifter_match_jax(num_ceps, n_mels, lifter):
    np.testing.assert_array_equal(mfcc.dct_matrix(num_ceps, n_mels),
                                  jmfcc.dct_matrix(num_ceps, n_mels))
    np.testing.assert_array_equal(
        mfcc.cepstral_lifter_coeffs(num_ceps, lifter),
        jmfcc.cepstral_lifter_coeffs(num_ceps, lifter))


def test_config_validation_matches_jax():
    for mk, fb in ((MfccConfig, FbankConfig), (JMfccConfig, JFbankConfig)):
        with pytest.raises(ValueError, match="num_ceps"):
            mk(num_ceps=30, fbank=fb(num_mel_bins=23, apply_cmn=False))
        with pytest.raises(ValueError, match="apply_cmn"):
            mk(fbank=fb(num_mel_bins=23, apply_cmn=True))
        with pytest.raises(ValueError, match="use_energy"):
            mk(fbank=fb(num_mel_bins=23, apply_cmn=False, use_energy=True))
        with pytest.raises(ValueError, match="lifter"):
            mk(cepstral_lifter=-1.0)
    assert MfccConfig().fbank == FbankConfig(num_mel_bins=23,
                                             apply_cmn=False)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_float64_route_matches_jax(speechish, name):
    port, jax_ = _configs(name)
    want = np.asarray(jmfcc.Mfcc(jax_, dtype=jnp.float64, fft_impl="rdft")
                      .compute(speechish))
    got = mfcc.Mfcc(port, dtype=torch.float64, fft_impl="rdft",
                    device="cpu").compute(speechish).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-9)


@pytest.mark.parametrize("impl", ["rdft", "sig"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_float32_and_sig_routes_match_jax(speechish, name, impl):
    """The cepstra are a lifted DCT of the fbank: the 2e-4 fbank bar times
    the largest row gain of the lifted DCT (its row norm times the
    lifter, at most 11.6 for L = 22), as the JAX MFCC tests carry the
    fbank gate through the lifter."""
    port, jax_ = _configs(name)
    x = np.stack([speechish, np.roll(speechish, 1000)])
    want = np.asarray(jmfcc.Mfcc(jax_, fft_impl=impl).compute(x))
    got = mfcc.Mfcc(port, fft_impl=impl, device="cpu").compute(x).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    m = mfcc.dct_matrix(port.num_ceps, port.fbank.num_mel_bins)
    lift = mfcc.cepstral_lifter_coeffs(port.num_ceps, port.cepstral_lifter)
    gain = float((np.abs(m).sum(axis=1) * lift).max())
    assert np.abs(got - want).max() <= 2e-4 * gain


def test_external_anchor_through_sig_route():
    """The JFK kaldi_native_fbank golden carried through the lifted DCT
    (tests/test_mfcc.py's anchor): the port's MFCC on the sig route must
    land within the bars the JAX test holds its own route to."""
    with np.load(TESTDATA / "kaldi_native_fbank_jfk.npz") as npz:
        gfb = npz["features"].T.astype(np.float64)
    jfk = read_wav_f32le(TESTDATA / "jfk_f32le.wav")
    cfg = MfccConfig(fbank=FbankConfig(apply_cmn=False))
    got = mfcc.Mfcc(cfg, fft_impl="sig", device="cpu").compute(jfk).numpy()
    m = mfcc.dct_matrix(13, 80) * mfcc.cepstral_lifter_coeffs(13, 22.0)[
        :, None]
    want = gfb @ m.T
    d = np.abs(got - want)
    assert got.shape == want.shape
    assert d.max() < 0.2 and d.mean() < 0.03


def test_batch_and_empty(speechish):
    m = mfcc.Mfcc(fft_impl="rdft", device="cpu")
    assert m.fbank.config == dataclasses.replace(MfccConfig().fbank,
                                                 apply_cmn=False)
    x = np.stack([speechish, np.roll(speechish, 1000)])
    out = m.compute(x)
    assert out.shape[0] == 2 and out.shape[2] == 13
    np.testing.assert_allclose(out[0].numpy(), m.compute(speechish).numpy(),
                               atol=1e-5)
    assert tuple(m.compute(np.zeros(0, np.float32)).shape) == (0, 13)
