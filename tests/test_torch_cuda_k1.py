"""K1 on the card against its plain PyTorch version. Needs a CUDA device
and nvcc; skipped elsewhere. On a machine with the card (no JAX needed):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda_k1.py
"""

import numpy as np
import pytest
import torch

from melspec_tpu_torch.kernels import sig_mel
from melspec_tpu_torch.ops import framing, mel_kernel

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1 has no CPU mode)")
    return torch.device("cuda")


def _plain(x, mats, fft, hop, n_mels, streaming, precision,
           dot_dtype=torch.float32):
    offset = framing.streaming_frame_offset(fft, hop) if streaming else 0
    nf = (framing.num_frames_streaming(x.shape[-1], fft, hop) if streaming
          else framing.num_frames_batch(x.shape[-1], fft, hop))
    return sig_mel.sig_mel_reference(
        x, mats.m_big, mats.pair_i,
        mats.mt_bf2 if precision == "bf2" else mats.mt, ks=3, n_frames=nf,
        hop=hop, offset=offset, pack=fft, n_bins_pad=mats.n_bins_pad,
        n_mels=n_mels, mel_precision=precision, dot_dtype=dot_dtype)


@pytest.mark.parametrize("fft,hop,n_mels", [(400, 160, 80), (400, 160, 128),
                                            (512, 160, 80), (320, 80, 64)])
@pytest.mark.parametrize("streaming", [False, True])
@pytest.mark.parametrize("precision", ["bf2", "highest"])
def test_k1_matches_plain(dev, fft, hop, n_mels, streaming, precision):
    """Against the exact result (the plain version's DFT dot in float64)
    at the 1e-5 gate; against the plain version's f32 matmul at 1e-5 plus
    that version's own distance from the exact result. fft 320 runs the
    split layout with 160 of its 256 bins per half in use."""
    x = torch.from_numpy((np.random.default_rng(fft + n_mels).normal(
        size=(3, 9137)) * 0.2).astype(np.float32)).to(dev)
    mats = mel_kernel.sig_matrices(fft, n_mels, 16000.0, 3, 2, dev)
    before = sig_mel.launches
    got = mel_kernel.whisper_mel_sig(x, fft, hop, n_mels, 16000.0,
                                     streaming=streaming,
                                     mel_precision=precision, device=dev)
    torch.cuda.synchronize()
    assert sig_mel.launches == before + 1
    want = _plain(x, mats, fft, hop, n_mels, streaming, precision)
    exact = _plain(x, mats, fft, hop, n_mels, streaming, precision,
                   torch.float64)
    assert got.shape == want.shape
    floor = float((want - exact).abs().max())
    assert float((got - exact).abs().max()) <= 1e-5
    assert float((got - want).abs().max()) <= 1e-5 + floor


def test_mel_batch_launches_k1_once_per_chunk(dev, monkeypatch):
    """One launch per batch chunk, and chunked output equals one launch."""
    from melspec_tpu_torch.ops.spectrogram import WhisperMelPipeline

    x = torch.from_numpy((np.random.default_rng(5).normal(
        size=(4, 16000)) * 0.2).astype(np.float32)).to(dev)
    pipe = WhisperMelPipeline(400, 160, 128, device=dev)
    assert pipe.fft_impl == "sig"
    before = sig_mel.launches
    whole = pipe.mel_batch(x)
    assert sig_mel.launches == before + 1
    per_clip = (16000 + whole.shape[1] * 128) * 4
    monkeypatch.setenv("MELSPEC_SIG_BUDGET_BYTES", str(2 * per_clip))
    chunked = pipe.mel_batch(x)
    torch.cuda.synchronize()
    assert sig_mel.launches == before + 3
    assert torch.equal(chunked, whole)


def test_k1_zero_frames_launch_nothing(dev):
    before = sig_mel.launches
    out = mel_kernel.whisper_mel_sig(torch.zeros(2, 100, device=dev),
                                     device=dev)
    assert tuple(out.shape) == (2, 0, 80) and sig_mel.launches == before


def test_k1_rejects_what_it_does_not_take(dev):
    mats = mel_kernel.sig_matrices(400, 80, 16000.0, 3, 2, dev)
    x = torch.zeros(1, 4000, device=dev)
    kw = dict(ks=3, n_frames=1, hop=160, offset=0, pack=400,
              n_bins_pad=mats.n_bins_pad, n_mels=80)
    with pytest.raises(ValueError, match="mt must be"):
        sig_mel.sig_mel(x, mats.m_big, mats.pair_i, mats.mt, **kw)
    with pytest.raises(ValueError, match="float32"):
        sig_mel.sig_mel(x.double(), mats.m_big, mats.pair_i, mats.mt_bf2,
                        **kw)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_multistream_sig_route_matches_plain(dev, n_mels):
    """K1 on the serving tick's route: ``MultiStreamMel(fft_impl="sig")``
    frames ``concat(hop_buf, chunks)`` at offset = hop into H frames, with
    a carried window, masked streams and H past one block's 64 frames;
    held against the plain version and the exact result on that concat,
    with the bars of test_k1_matches_plain."""
    from melspec_tpu_torch.config import MelConfig
    from melspec_tpu_torch.streaming.multistream import MultiStreamMel

    s = 5
    mel = MultiStreamMel(MelConfig(400, 160, n_mels, 16000.0), s,
                         fft_impl="sig", device=dev)
    m = mel._sig
    rng = np.random.default_rng(n_mels)
    st = mel.init()
    for h in (4, 1, 70):
        x = torch.from_numpy((rng.normal(size=(s, h * 160)) * 0.2).astype(
            np.float32)).to(dev)
        active = torch.tensor([True, True, h != 1, True, False], device=dev)
        concat = torch.cat([st.hop_buf, x], dim=1)
        before = sig_mel.launches
        st, _, got, _ = mel._push_many(st, x, active)
        torch.cuda.synchronize()
        assert sig_mel.launches == before + 1
        kw = dict(ks=3, n_frames=h, hop=160, offset=160, pack=400,
                  n_bins_pad=m.n_bins_pad, n_mels=n_mels)
        want = sig_mel.sig_mel_reference(concat, m.m_big, m.pair_i,
                                         m.mt_bf2, **kw)
        exact = sig_mel.sig_mel_reference(concat, m.m_big, m.pair_i,
                                          m.mt_bf2, dot_dtype=torch.float64,
                                          **kw)
        assert got.shape == want.shape == (s, h, n_mels)
        floor = float((want - exact).abs().max())
        assert float((got - exact).abs().max()) <= 1e-5
        assert float((got - want).abs().max()) <= 1e-5 + floor


WIDTH_CONFIGS = [(200, 80, 80, 8000.0), (256, 96, 32, 16000.0),
                 (1024, 256, 80, 22050.0)]


@pytest.mark.parametrize("fft,hop,n_mels,sr", WIDTH_CONFIGS)
@pytest.mark.parametrize("streaming", [False, True])
def test_k1_matches_plain_at_256_and_1024_columns(dev, fft, hop, n_mels, sr,
                                                  streaming):
    """The whisper heads of 256 (fft 200, 256) and 1024 (fft 1024)
    columns, walked in column chunks, at test_k1_matches_plain's bars."""
    head = mel_kernel.whisper_head(fft, n_mels, sr, dev)
    assert head.m_big.shape[1] in (256, 1024)
    assert sig_mel.k1_accepts(head, hop=hop)
    x = torch.from_numpy((np.random.default_rng(fft + hop).normal(
        size=(3, int(sr) + 37)) * 0.2).astype(np.float32)).to(dev)
    before = sig_mel.launches
    got = mel_kernel.whisper_mel_sig(x, fft, hop, n_mels, sr,
                                     streaming=streaming, device=dev)
    torch.cuda.synchronize()
    assert sig_mel.launches == before + 1
    offset = framing.streaming_frame_offset(fft, hop) if streaming else 0
    kw = dict(ks=3, n_frames=got.shape[1], hop=hop, offset=offset,
              **head.kw())
    want = sig_mel.sig_mel_reference(x, head.m_big, head.pair_i, head.mt,
                                     **kw)
    exact = sig_mel.sig_mel_reference(x, head.m_big, head.pair_i, head.mt,
                                      dot_dtype=torch.float64, **kw)
    assert got.shape == want.shape
    floor = float((want - exact).abs().max())
    assert float((got - exact).abs().max()) <= max(1e-5, floor)
    assert float((got - want).abs().max()) <= max(1e-5, floor) + floor


@pytest.mark.parametrize("fft,hop,n_mels,sr", WIDTH_CONFIGS)
def test_jfk_gate_at_256_and_1024_columns(dev, fft, hop, n_mels, sr):
    """The JFK clip through K1 at the 256- and 1024-column heads, held to
    the golden gate's 1e-5 against the float64 route of the same config
    (there is no golden at these configs)."""
    from pathlib import Path

    from melspec_tpu_torch.io.wav import read_wav_f32le
    from melspec_tpu_torch.ops.spectrogram import WhisperMelPipeline

    root = Path(__file__).resolve().parents[1]
    jfk = torch.as_tensor(read_wav_f32le(root / "testdata/jfk_f32le.wav"),
                          device=dev)[None]
    got = mel_kernel.whisper_mel_sig(jfk, fft, hop, n_mels, sr, device=dev)
    want = WhisperMelPipeline(fft, hop, n_mels, sr, dtype=torch.float64,
                              fft_impl="rdft", device=dev).mel_batch(
                                  jfk.double())
    assert got.shape == want.shape
    assert float((got.double() - want).abs().max()) <= 1e-5
