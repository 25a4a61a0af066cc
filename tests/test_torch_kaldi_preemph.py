"""Kaldi fbank and MFCC with ``preemphasis <= 0`` (and NaN) on the sig
route, port vs JAX on the same numpy inputs, at 48, 64 and 80 kHz (n_fft
2048: the heads K1's float64 FFT path takes).

JAX preemphasizes only where ``p > 0`` (``kaldi_preproc_matrix``, its
rdft route); any other ``p``, NaN included, means DC removal alone. The
port's head hands the FFT path a coefficient of 0 there
(``fbank.sig_head``), the path's "DC removal alone", while ``FftHead``
still refuses a negative one (the kernel's "no preprocessing").

Bars: the port's float32 routes against its float64 rdft route (the
witness, itself within 1e-9 of JAX's float64 rdft) at ``max(2e-4, JAX's
own distance from it)``: JAX's float32 rdft lands up to 2.9e-4 from
float64 on noise at 80 kHz, so a bare 2e-4 against JAX would hold the
port to JAX's error. The FFT path's plain version on a ``p <= 0`` head
bit-equal to that on the ``p = 0`` head. MFCC: ``tests/test_torch_mfcc.py``'s
bar, 2e-4 times the lifted DCT's largest row gain, against JAX's MFCC."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from melspec_tpu.config import FbankConfig as JFbankConfig
from melspec_tpu.config import MfccConfig as JMfccConfig
from melspec_tpu.ops import fbank as jfbank
from melspec_tpu.ops import mfcc as jmfcc
from melspec_tpu_torch.config import FbankConfig, MfccConfig
from melspec_tpu_torch.kernels import sig_mel
from melspec_tpu_torch.ops import fbank, framing, mfcc

CPU = torch.device("cpu")
LN_BAR = 2e-4
RATES = (48000, 64000, 80000)
PREEMPHS = (-0.5, 0.0, float("nan"), 0.97)
AT_MOST_ZERO = (-0.5, float("nan"))


def _cfgs(sr, p):
    kw = dict(sample_rate=float(sr), preemphasis=p, apply_cmn=False)
    return FbankConfig(**kw), JFbankConfig(**kw)


def _signal(sr, p):
    """2 x 1 s of noise with a DC offset (which DC removal takes out)."""
    seed = sr + (7 if np.isnan(p) else int(100 * p) + 50)
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(2, sr)) * 0.2 + 0.3).astype(np.float32)


def _dist(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


@pytest.mark.parametrize("p", PREEMPHS)
@pytest.mark.parametrize("sr", RATES)
def test_fbank_routes_against_float64_and_jax(sr, p):
    """The port's ``"sig"`` (K1's plain version on the CPU) and
    ``"rdft"`` within ``max(2e-4, JAX's own distance)`` of the port's
    float64 rdft route, which lands within 1e-9 of JAX's; both shaped as
    JAX's float32 rdft route."""
    cfg, jcfg = _cfgs(sr, p)
    x = _signal(sr, p)
    jax32 = np.asarray(jfbank.Fbank(jcfg, fft_impl="rdft").compute(x))
    jax64 = np.asarray(jfbank.Fbank(jcfg, dtype=jnp.float64,
                                    fft_impl="rdft").compute(x))
    f64 = fbank.Fbank(cfg, dtype=torch.float64, fft_impl="rdft",
                      device=CPU).compute(x).numpy()
    assert f64.shape == jax32.shape == (2, 98, 80)
    assert _dist(f64, jax64) <= 1e-9
    bar = max(LN_BAR, _dist(jax32, f64))
    for impl in ("sig", "rdft"):
        got = fbank.Fbank(cfg, fft_impl=impl, device=CPU).compute(x).numpy()
        assert got.shape == jax32.shape and got.dtype == np.float32
        assert np.isfinite(got).all()
        assert _dist(got, f64) <= bar, impl


@pytest.mark.parametrize("p", PREEMPHS)
@pytest.mark.parametrize("sr", RATES)
def test_fft_head_coefficient(sr, p):
    """The head carries the FFT path and hands it JAX's meaning: ``p``
    where ``p > 0``, else 0 (DC removal alone), NaN included."""
    head = fbank.sig_head(_cfgs(sr, p)[0])
    assert head.dft_size == 2048 and head.fft is not None
    assert head.fft.preemph == (p if p > 0.0 else 0.0)


@pytest.mark.parametrize("p", AT_MOST_ZERO)
@pytest.mark.parametrize("sr", RATES)
def test_fft_plain_version_is_dc_removal_alone(sr, p):
    """The FFT path's plain version on the ``p <= 0`` (or NaN) head
    equals that on the ``p = 0`` head bit for bit, and the head's dense
    matrices equal the ``p = 0`` head's too."""
    head = fbank.sig_head(_cfgs(sr, p)[0])
    zero = fbank.sig_head(_cfgs(sr, 0.0)[0])
    assert torch.equal(head.m_big, zero.m_big)
    x = torch.from_numpy(_signal(sr, p))
    hop = int(sr // 100)
    nf = framing.num_frames_batch(x.shape[-1], head.pack, hop)

    def plain(h):
        return sig_mel.sig_mel_fft_reference(x, h, n_frames=nf, hop=hop,
                                             offset=0)

    got, want = plain(head), plain(zero)
    assert got.shape == (2, nf, 80) and bool(torch.isfinite(got).all())
    assert torch.equal(got, want)


@pytest.mark.parametrize("p", AT_MOST_ZERO)
@pytest.mark.parametrize("sr", RATES)
def test_auto_route_on_cuda_takes_sig(monkeypatch, sr, p):
    """``fbank.auto_fft_impl`` asked for CUDA builds the head and picks
    ``"sig"`` where K1 takes it (``k1_accepts`` stood in for: no kernel
    builds here); the ``FftHead`` guard still refuses a negative
    coefficient."""
    asked = []

    def accepts(head, hop):
        asked.append((head.fft.preemph, hop))
        return True

    monkeypatch.setattr(fbank, "k1_accepts", accepts)
    cfg = _cfgs(sr, p)[0]
    assert fbank.auto_fft_impl(cfg, torch.float32,
                               torch.device("cuda")) == "sig"
    assert asked == [(0.0, cfg.frame_shift_samples)]
    f = fbank.sig_head(cfg).fft
    with pytest.raises(ValueError, match="preemph"):
        dataclasses.replace(f, preemph=-0.5)


@pytest.mark.parametrize("p", AT_MOST_ZERO)
@pytest.mark.parametrize("sr", [48000, 80000])
def test_mfcc_sig_route(sr, p):
    """``Mfcc`` over a ``p <= 0`` fbank on the sig route computes, within
    ``tests/test_torch_mfcc.py``'s bar of JAX's MFCC (float32 rdft), and
    its float64 rdft route within 1e-9 of JAX's."""
    cfg = MfccConfig(fbank=_cfgs(sr, p)[0])
    jcfg = JMfccConfig(fbank=_cfgs(sr, p)[1])
    x = _signal(sr, p)
    got = mfcc.Mfcc(cfg, fft_impl="sig", device=CPU).compute(x).numpy()
    want = np.asarray(jmfcc.Mfcc(jcfg, fft_impl="rdft").compute(x))
    assert got.shape == want.shape == (2, 98, 13)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    m = mfcc.dct_matrix(cfg.num_ceps, cfg.fbank.num_mel_bins)
    lift = mfcc.cepstral_lifter_coeffs(cfg.num_ceps, cfg.cepstral_lifter)
    gain = float((np.abs(m).sum(axis=1) * lift).max())
    assert _dist(got, want) <= LN_BAR * gain
    f64 = mfcc.Mfcc(cfg, dtype=torch.float64, fft_impl="rdft",
                    device=CPU).compute(x).numpy()
    j64 = np.asarray(jmfcc.Mfcc(jcfg, dtype=jnp.float64,
                                fft_impl="rdft").compute(x))
    assert _dist(f64, j64) <= 1e-9
