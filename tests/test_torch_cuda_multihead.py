"""K2 and K1's ln modes on the card against their plain PyTorch versions.
Needs a CUDA device and nvcc; skipped elsewhere. On a machine with the
card (no JAX needed):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda_multihead.py
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from melspec_tpu_torch.config import (BatchLogMelConfig, DetectionSettings,
                                      FbankConfig, MelConfig)
from melspec_tpu_torch.io.wav import read_wav_f32le
from melspec_tpu_torch.kernels import sig_mel, sig_multi
from melspec_tpu_torch.ops import framing
from melspec_tpu_torch.ops.batch_logmel import BatchLogMel
from melspec_tpu_torch.ops.fbank import Fbank
from melspec_tpu_torch.ops.mel_kernel import whisper_mel_sig
from melspec_tpu_torch.ops.sig_multihead import (WhisperKaldiFused,
                                                 WhisperKaldiNemoFused)
from melspec_tpu_torch.ops.vad import classify_columns
from melspec_tpu_torch.parallel.sharding import sharded_frontend_step

pytestmark = pytest.mark.cuda

TESTDATA = Path(__file__).resolve().parents[1] / "testdata"
# the ln modes' bar against the exact result and the plain version: the
# JAX package's cross-route bar for its sig routes, raised to the f32
# floor measured on the same inputs (ln turns the relative error of a
# near-silent bin into absolute error)
LN_TOL = 2e-4
SETTINGS = DetectionSettings(min_energy=0.5, min_y=2, min_x=5, min_mel=0)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1 and K2 have no CPU mode)")
    return torch.device("cuda")


def _signal(dev, b, t, seed):
    return torch.from_numpy((np.random.default_rng(seed).normal(
        size=(b, t)) * 0.2).astype(np.float32)).to(dev)


def _held(got, x, head, *, n_frames, hop, offset=0):
    kw = dict(ks=3, n_frames=n_frames, hop=hop, offset=offset, **head.kw())
    want = sig_mel.sig_mel_reference(x, head.m_big, head.pair_i, head.mt,
                                     **kw)
    exact = sig_mel.sig_mel_reference(x, head.m_big, head.pair_i, head.mt,
                                      dot_dtype=torch.float64, **kw)
    assert got.shape == want.shape
    floor = float((want - exact).abs().max())
    bar = max(LN_TOL, floor)
    assert float((got - exact).abs().max()) <= bar
    assert float((got - want).abs().max()) <= bar + floor


@pytest.mark.parametrize("b,t", [(3, 9137), (1, 400), (2, 23 * 160 + 5)])
def test_k1_ln_floor_kaldi_matches_plain(dev, b, t):
    """Kaldi's N-packed head with the DC + preemphasis fold, ln_floor."""
    x = _signal(dev, b, t, t)
    fb = Fbank(FbankConfig(apply_cmn=False), fft_impl="sig", device=dev)
    before = sig_mel.launches
    got = fb.compute(x)
    torch.cuda.synchronize()
    assert sig_mel.launches == before + 1
    nf = fb.num_frames(t)
    _held(got, x, fb.sig_head, n_frames=nf, hop=fb.frame_shift)


@pytest.mark.parametrize("b,t", [(3, 9137), (2, 100)])
def test_k1_ln_guard_nemo_matches_plain(dev, b, t):
    """NeMo's N-packed 400-tap head at pack_off 56 of the centered
    frame, ln_guard."""
    cfg = BatchLogMelConfig()
    x = _signal(dev, b, t, t + 1)
    nemo = BatchLogMel(cfg, device=dev)
    assert nemo.fft_impl == "sig"
    before = sig_mel.launches
    got = nemo.compute(x)
    torch.cuda.synchronize()
    assert sig_mel.launches == before + 1
    pad = cfg.n_fft // 2
    xp = torch.nn.functional.pad(x, (pad, pad))
    nf = nemo.num_frames(t)
    want = sig_mel.sig_mel_reference(
        xp, nemo.sig_head.m_big, nemo.sig_head.pair_i, nemo.sig_head.mt,
        ks=3, n_frames=nf, hop=cfg.hop_length, offset=0,
        dot_dtype=torch.float64, **nemo.sig_head.kw())
    assert float((got.transpose(-1, -2) - want).abs().max()) <= LN_TOL


def test_kaldi_jfk_gate_through_k1_and_k2(dev):
    with np.load(TESTDATA / "kaldi_native_fbank_jfk.npz") as npz:
        golden = torch.from_numpy(npz["features"].T.copy()).to(dev)
    jfk = read_wav_f32le(TESTDATA / "jfk_f32le.wav")
    k1 = Fbank(FbankConfig(), fft_impl="sig", device=dev).compute(jfk)
    _, k2 = WhisperKaldiFused(device=dev).compute(jfk)
    assert k1.shape == golden.shape and k2.shape == (1,) + golden.shape
    assert float((k1 - golden).abs().max()) <= 0.0152
    assert float((k2[0] - golden).abs().max()) <= 0.0152


@pytest.mark.parametrize("n_mels", [80, 128])
def test_k2_two_heads_equal_k1(dev, n_mels):
    """Head 0 is K1's whisper output and head 1 K1's ln_floor Kaldi
    output bit for bit: the same matrices, block order and device code."""
    x = _signal(dev, 5, 16000 * 2 + 37, n_mels)
    fused = WhisperKaldiFused(MelConfig(400, 160, n_mels), device=dev)
    before = sig_multi.launches
    mel, fbank = fused.compute(x)
    torch.cuda.synchronize()
    assert sig_multi.launches == before + 1
    assert torch.equal(mel, whisper_mel_sig(x, 400, 160, n_mels,
                                            device=dev))
    assert torch.equal(fbank, Fbank(FbankConfig(), fft_impl="sig",
                                    device=dev).compute(x))


def test_k2_three_heads_equal_k1_and_hold_nemo(dev):
    x = _signal(dev, 5, 16000 * 2 + 37, 3)
    tri = WhisperKaldiNemoFused(device=dev)
    mel, fbank, nemo = tri.compute(x)
    assert torch.equal(mel, whisper_mel_sig(x, device=dev))
    assert torch.equal(fbank, Fbank(FbankConfig(), fft_impl="sig",
                                    device=dev).compute(x))
    f64 = BatchLogMel(dtype=torch.float64, fft_impl="rdft",
                      device=dev).compute(x.double())
    assert nemo.shape == f64.shape
    assert float((nemo.double() - f64).abs().max()) <= LN_TOL


@pytest.mark.parametrize("tri", [False, True])
def test_k2_vs_plain_and_vad_counts(dev, tri):
    """Every head against the plain version and the exact result; the VAD
    counts equal tile_vad_counts of the kernel's own head 0; the fixed
    raw activity equals classify_columns over >= 3 tiles, ragged T."""
    x = _signal(dev, 5, 160 * (3 * sig_multi.TILE_FRAMES + 11) + 77, 9)
    front = WhisperKaldiNemoFused(device=dev) if tri else \
        WhisperKaldiFused(device=dev)
    xin = (torch.nn.functional.pad(x, (front._nemo_pad, 0)) if tri else x)
    nf = (framing.num_frames_centered(x.shape[-1], 160) if tri
          else framing.num_frames_batch(x.shape[-1], 400, 160))
    vad = (sig_mel.vad_threshold(SETTINGS.min_energy), 0)
    outs, counts = sig_multi.sig_multi(xin, front.heads, ks=3, n_frames=nf,
                                       hop=160, vad=vad)
    torch.cuda.synchronize()
    for h, got in zip(front.heads, outs):
        _held(got, xin, h, n_frames=nf, hop=160)
    assert torch.equal(counts, sig_mel.tile_vad_counts(outs[0], *vad))
    res = front.compute_with_vad(x, SETTINGS)
    mel, raw = res[0], res[-1]
    assert torch.equal(raw, classify_columns(mel.transpose(-1, -2),
                                             SETTINGS))


def test_frontend_step_launches_k2_and_k1_once(dev):
    step = sharded_frontend_step(settings=SETTINGS, device=dev)
    x = _signal(dev, 4, 16000 * 3, 11)
    step(x)  # builds the kernels
    torch.cuda.synchronize()
    k1, k2 = sig_mel.launches, sig_multi.launches
    out = step(x)
    torch.cuda.synchronize()
    assert (sig_mel.launches - k1, sig_multi.launches - k2) == (1, 1)
    assert torch.isfinite(out["mel"]).all() and out["mel_q8"].dtype == \
        torch.uint8


def test_k2_refuses_what_it_does_not_take(dev):
    fused = WhisperKaldiFused(device=dev)
    x = torch.zeros(1, 4000, device=dev)
    with pytest.raises(ValueError, match="whisper head 0"):
        sig_multi.sig_multi(x, fused.heads[::-1], ks=3, n_frames=10, hop=160,
                            vad=(0.25, 0))
    with pytest.raises(NotImplementedError, match="shared memory"):
        sig_multi.sig_multi(x, fused.heads, ks=3, n_frames=10, hop=400)
