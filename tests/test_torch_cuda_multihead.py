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
    kw = dict(ks=3, n_frames=n_frames, hop=hop, offset=offset)
    want = sig_mel.sig_mel_reference(x, head, **kw)
    exact = sig_mel.sig_mel_reference(x, head, dot_dtype=torch.float64, **kw)
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
        xp, nemo.sig_head, ks=3, n_frames=nf, hop=cfg.hop_length, offset=0,
        dot_dtype=torch.float64)
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


def test_k2_8k_pair_equals_k1(dev):
    """The 8 kHz whisper + Kaldi pair (two 256-column heads) through K2:
    each head torch.equal to K1 on the same matrices, the VAD counts to
    tile_vad_counts of head 0, the fixed raw to classify_columns."""
    mc = MelConfig(200, 80, 80, 8000.0)
    kc = FbankConfig(sample_rate=8000.0, apply_cmn=False)
    x = _signal(dev, 5, 8000 * 3 + 37, 8)
    fused = WhisperKaldiFused(mc, kc, device=dev)
    before = sig_multi.launches
    mel, fbank = fused.compute(x)
    torch.cuda.synchronize()
    assert sig_multi.launches == before + 1
    assert torch.equal(mel, whisper_mel_sig(x, 200, 80, 80, 8000.0,
                                            device=dev))
    assert torch.equal(fbank, Fbank(kc, fft_impl="sig", device=dev)
                       .compute(x))
    nf = framing.num_frames_batch(x.shape[-1], 200, 80)
    vad = (sig_mel.vad_threshold(SETTINGS.min_energy), 0)
    outs, counts = sig_multi.sig_multi(x, fused.heads, ks=3, n_frames=nf,
                                       hop=80, vad=vad)
    assert torch.equal(counts, sig_mel.tile_vad_counts(outs[0], *vad))
    mel, _, raw = fused.compute_with_vad(x, SETTINGS)
    assert torch.equal(raw, classify_columns(mel.transpose(-1, -2),
                                             SETTINGS))


@pytest.mark.parametrize("h", [0, 1])
def test_k1_odd_pack_off_matches_plain(dev, h):
    """The NeMo tri-head's whisper and Kaldi heads read their taps at
    pack_off 257 (odd: the kernel assembles A fragments from 16-bit taps)
    and are held through K1 to K1's bars: whisper 1e-5, Kaldi LN_TOL,
    each raised to the f32 floor."""
    tri = WhisperKaldiNemoFused(device=dev)
    head = tri.heads[h]
    assert head.pack_off % 2 == 1
    x = _signal(dev, 3, 16000 * 2 + 37, 21 + h)
    xin = torch.nn.functional.pad(x, (tri._nemo_pad, 0))
    nf = framing.num_frames_centered(x.shape[-1], 160)
    kw = dict(ks=3, n_frames=nf, hop=160, offset=0)
    got = sig_mel.sig_mel(xin, head, **kw)
    want = sig_mel.sig_mel_reference(xin, head, **kw)
    exact = sig_mel.sig_mel_reference(xin, head, dot_dtype=torch.float64, **kw)
    floor = float((want - exact).abs().max())
    bar = max(1e-5 if h == 0 else LN_TOL, floor)
    assert float((got - exact).abs().max()) <= bar
    assert float((got - want).abs().max()) <= bar + floor


# (clips, samples): 133 clips of 198 frames (no multiple of 128; more
# blocks than the card's SMs), and 3 clips of 506 frames
K2_PIPE_SHAPES = [(133, 16000 * 2 + 37), (3, 16000 * 5 + 1234)]


def _k2_against_k1(x, front, *, tri):
    """K2's launch of ``front``'s heads with the VAD epilogue against K1's
    launch of each head (on the layout K1 takes for it, counted in
    ``sig_mel.pipelined_launches`` where pipelined): every output and the
    VAD counts bit for bit; returns K2's block layout and which heads K1
    walked pipelined."""
    xin = torch.nn.functional.pad(x, (front._nemo_pad, 0)) if tri else x
    nf = (framing.num_frames_centered(x.shape[-1], 160) if tri
          else framing.num_frames_batch(x.shape[-1], 400, 160))
    assert nf % 128
    vad = sig_mel.vad_args(SETTINGS, front.mel_config.n_mels)
    layout = sig_multi.block_layout(3, 160,
                                    *sig_multi._layout(front.heads))
    outs, counts = sig_multi.sig_multi(xin, front.heads, ks=3, n_frames=nf,
                                       hop=160, vad=vad)
    piped = [sig_mel.head_layout(h, 160).pipelined for h in front.heads]
    before = sig_mel.pipelined_launches
    for h, got in zip(front.heads, outs):
        k1 = sig_mel.sig_mel(xin, h, ks=3, n_frames=nf, hop=160, offset=0)
        assert torch.equal(got, k1)
    torch.cuda.synchronize()
    assert sig_mel.pipelined_launches == before + sum(piped)
    assert torch.equal(counts, sig_mel.tile_vad_counts(outs[0], *vad))
    return layout, piped


@pytest.mark.parametrize("shape", K2_PIPE_SHAPES)
def test_k2_pipelined_equals_k1_pipelined(dev, shape):
    """asr-trio's heads (whisper large-v3 + Kaldi 80, the VAD epilogue)
    on K2's pipelined walk equal K1's pipelined launches of each head."""
    x = _signal(dev, *shape, sum(shape) + 23)
    front = WhisperKaldiFused(MelConfig(400, 160, 128), device=dev)
    layout, piped = _k2_against_k1(x, front, tri=False)
    assert layout.pipelined and (layout.code, layout.slots) == (4, 4)
    assert piped == [True, True]


@pytest.mark.parametrize("shape", K2_PIPE_SHAPES)
def test_k2_nemo_fold_equals_k1_pipelined(dev, shape):
    """The NeMo-fold three heads, which K2 runs in 64-frame blocks (four
    ring slots beside their span do not fit), equal K1's launches of each
    head bit for bit, two of them on K1's pipelined walk (the Kaldi head
    at pack_off 257 misses its four slots by 192 bytes there too): the sum
    order is one."""
    x = _signal(dev, *shape, sum(shape) + 29)
    layout, piped = _k2_against_k1(x, WhisperKaldiNemoFused(device=dev),
                                   tri=True)
    assert not layout.pipelined and (layout.code, layout.frames) == (1, 64)
    assert piped == [True, False, True]


def test_k2_pipelined_launches_count_layout_4_only(dev):
    """``sig_multi.pipelined_launches`` rises by one a launch on layout 4
    (asr-trio's heads) and not on a 64-frame launch (the NeMo-fold
    set); ``launches`` by one each."""
    x = _signal(dev, 2, 16000 * 3, 31)
    for front, piped in ((WhisperKaldiFused(MelConfig(400, 160, 128),
                                            device=dev), 1),
                         (WhisperKaldiNemoFused(device=dev), 0)):
        before = (sig_multi.launches, sig_multi.pipelined_launches)
        front.compute_with_vad(x, SETTINGS)
        torch.cuda.synchronize()
        assert (sig_multi.launches, sig_multi.pipelined_launches) == (
            before[0] + 1, before[1] + piped)


def test_k2_layout_on_the_card(dev):
    """The built library's layout for the head sets of
    ``tests/test_torch_k2_pipe.py``: the code, frames, slots and shared
    memory its byte model gives."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "k2_pipe", Path(__file__).with_name("test_torch_k2_pipe.py"))
    k2_pipe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(k2_pipe)
    for name, (heads, hop) in k2_pipe._sets().items():
        got = sig_multi.block_layout(3, hop, *sig_multi._layout(heads))
        assert (got.code, got.frames, got.slots, got.smem) == \
            k2_pipe.LAYOUTS[name], name
