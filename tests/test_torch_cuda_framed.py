"""K5-K8 on the card against their plain PyTorch versions (whisper
960/480/40 at 48 kHz too, in their 32-frame blocks), K6's and K7's
DFT power bit-equal to their plain versions', the JFK gates through the
kernels, the block layout per frame width, and the auto routes of the
heads that are not 512 columns wide.
Needs a CUDA
device and nvcc; skipped elsewhere. On a machine with the card (no JAX
needed):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda_framed.py
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from melspec_tpu_torch.config import BatchLogMelConfig, FbankConfig
from melspec_tpu_torch.io.wav import read_wav_f32le
from melspec_tpu_torch.kernels import framed_mel, framed_ozaki, sig_mel
from melspec_tpu_torch.ops import batch_logmel, fbank, mel_kernel
from melspec_tpu_torch.ops.batch_logmel import BatchLogMel
from melspec_tpu_torch.ops.fbank import Fbank
from melspec_tpu_torch.ops.spectrogram import WhisperMelPipeline

pytestmark = pytest.mark.cuda

TESTDATA = Path(__file__).resolve().parents[1] / "testdata"
# the Ozaki kernels' DFT is exact, and equal to their plain version's bit
# for bit; only the f32 projection's order differs
OZAKI_TOL = 1e-6
# K5 and K8 sum their bf16 products on the tensor cores, in another order
# than cuBLAS sums the plain version's float32 dot: against the exact
# result (float64 dot) at the 1e-5 gate raised to the plain version's own
# distance from it, against the plain version at that plus the same floor
# (K1's card bars)
GATE = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K5-K8 have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("impl", framed_mel.IMPLS)
@pytest.mark.parametrize("fft,hop,n_mels,sr", [
    (400, 160, 80, 16000.0), (400, 160, 128, 16000.0),
    (1024, 256, 80, 22050.0), (256, 96, 32, 16000.0),
    (960, 480, 40, 48000.0)])
@pytest.mark.parametrize("streaming", [False, True])
def test_kernel_matches_plain(dev, impl, fft, hop, n_mels, sr, streaming):
    """``whisper_mel_pallas`` launches the kernel once; its output against
    the plain version with an f32 dot and with the float64 dot."""
    x = torch.from_numpy((np.random.default_rng(fft + n_mels).normal(
        size=(3, 9137)) * 0.2).astype(np.float32)).to(dev)
    name = framed_mel.KERNEL[impl]
    before = dict(framed_mel.launches)
    k1_before = sig_mel.launches
    got = mel_kernel.whisper_mel_pallas(x, fft, hop, n_mels, sr,
                                        streaming=streaming, impl=impl,
                                        device=dev)
    torch.cuda.synchronize()
    assert framed_mel.launches[name] == before[name] + 1
    assert sig_mel.launches == k1_before
    ks, cutoff = mel_kernel.pallas_schedule(impl)
    mats = mel_kernel.framed_matrices(impl, fft, n_mels, sr, ks, cutoff, dev)
    fr, nf = mel_kernel.framed_input(x, fft, hop, streaming)
    want, exact = (framed_mel.framed_mel_reference(
        fr, mats, n_mels=n_mels, dot_dtype=dt)[: 3 * nf].reshape(got.shape)
        for dt in (torch.float32, torch.float64))
    assert got.shape == want.shape and torch.isfinite(got).all()
    floor = float((want - exact).abs().max())
    if impl in ("hp8", "hp_bf16"):
        assert floor == 0.0  # the f32 and float64 dots agree exactly
        assert float((got - want).abs().max()) <= OZAKI_TOL
    else:
        bar = max(GATE, floor)
        assert float((got - exact).abs().max()) <= bar
        assert float((got - want).abs().max()) <= bar + floor


@pytest.mark.parametrize("impl,kw,gate", [
    ("bf3", {}, 1e-5), ("hp8", {}, 2e-6), (None, {"hp": True}, 1e-6),
    ("f32", {}, 1e-5)])
def test_jfk_gates_through_the_kernels(dev, impl, kw, gate):
    golden = np.load(TESTDATA / "rust_jfk_golden.npy")
    jfk = read_wav_f32le(TESTDATA / "jfk_f32le.wav")
    got = mel_kernel.whisper_mel_pallas(jfk, 512, 160, 80, 16000.0,
                                        streaming=True, impl=impl,
                                        device=dev, **kw).T.cpu().numpy()
    assert got.shape == golden.shape
    assert np.abs(got - golden).max() <= gate


def test_zero_frames_and_1d(dev):
    before = dict(framed_mel.launches)
    out = mel_kernel.whisper_mel_pallas(torch.zeros(2, 100, device=dev),
                                        impl="bf3", device=dev)
    assert tuple(out.shape) == (2, 0, 80) and framed_mel.launches == before
    x = torch.from_numpy((np.random.default_rng(1).normal(size=6000)
                          * 0.2).astype(np.float32)).to(dev)
    one = mel_kernel.whisper_mel_pallas(x, impl="hp8", device=dev)
    two = mel_kernel.whisper_mel_pallas(x[None], impl="hp8", device=dev)
    assert torch.equal(one, two[0])


def test_refusals(dev):
    mats = mel_kernel.framed_matrices("bf3", 400, 80, 16000.0, 3, 2, dev)
    fr = torch.zeros(64, 512, device=dev)
    with pytest.raises(NotImplementedError, match="n_mels_pad"):
        framed_mel.framed_mel(fr, framed_mel.FramedMatrices(
            "bf3", mats.planes, torch.zeros(256, 384, device=dev), 3, 2),
            n_mels=300)
    with pytest.raises(ValueError, match="plane matrices"):
        framed_mel.framed_mel(fr, framed_mel.FramedMatrices(
            "bf3", tuple(p.float() for p in mats.planes), mats.mt, 3, 2),
            n_mels=80)
    with pytest.raises(ValueError, match="float32 frames"):
        framed_mel.framed_mel(fr.double(), mats, n_mels=80)
    for impl, ks in (("hp_bf16", 6), ("bf3", 3)):
        big = mel_kernel.framed_matrices(impl, 4096, 80, 16000.0, ks, ks,
                                         dev)
        with pytest.raises(NotImplementedError, match="shared memory"):
            framed_mel.framed_mel(torch.zeros(32, 4096, device=dev), big,
                                  n_mels=80)


@pytest.mark.parametrize("fft,hop,n_mels,sr", [
    (1024, 256, 80, 22050.0), (960, 480, 40, 48000.0),
    (256, 96, 32, 16000.0), (640, 160, 80, 16000.0)])
def test_auto_routes_take_k5_where_k1_refuses(dev, fft, hop, n_mels, sr):
    """The whisper configs whose heads are not 512 columns wide: where
    ``k1_accepts`` holds (256 and 1024 columns; 960/480 in K1's 32-frame
    blocks) the pipeline and ``whisper_mel_pallas(impl=None)`` take K1;
    where it does not (640/160: 768 columns, a width K1 does not take)
    the pipeline takes its bf3 power and ``whisper_mel_pallas`` K5; both
    hold their float64 results at 2e-5."""
    x = torch.from_numpy((np.random.default_rng(fft).normal(
        size=(2, int(sr))) * 0.2).astype(np.float32)).to(dev)
    k1 = sig_mel.k1_accepts(mel_kernel.whisper_head(fft, n_mels, sr, dev),
                            hop=hop)
    pipe = WhisperMelPipeline(fft, hop, n_mels, sr, device=dev)
    assert pipe.fft_impl == ("sig" if k1 else "bf3")
    f64 = WhisperMelPipeline(fft, hop, n_mels, sr, dtype=torch.float64,
                             fft_impl="rdft", device=dev)
    want = f64.mel_batch(x.double())
    assert float((pipe.mel_batch(x).double() - want).abs().max()) <= 2e-5
    before = (dict(framed_mel.launches), sig_mel.launches)
    got = mel_kernel.whisper_mel_pallas(x, fft, hop, n_mels, sr, device=dev)
    torch.cuda.synchronize()
    assert sig_mel.launches == before[1] + k1
    assert framed_mel.launches["K5"] == before[0]["K5"] + (not k1)
    assert float((got.double() - want).abs().max()) <= 2e-5


def test_auto_routes_of_8k_frontends(dev):
    """8 kHz Kaldi fbank and NeMo log-mel (256-column heads): K1 on the
    card where ``k1_accepts`` holds, else "rdft"; NeMo within 2e-4 of its
    float64 route, Kaldi within the JAX package's 2e-3 between its Kaldi
    hp route and float64 (tests/test_fbank.py)."""
    x = torch.from_numpy((np.random.default_rng(2).normal(
        size=(2, 16000)) * 0.2).astype(np.float32)).to(dev)
    fcfg = FbankConfig(sample_rate=8000.0)
    fb = Fbank(fcfg, device=dev)
    k1 = sig_mel.k1_accepts(fbank.sig_head(fcfg), hop=80)
    assert fb.fft_impl == ("sig" if k1 else "rdft")
    want = Fbank(fcfg, dtype=torch.float64, device=dev).compute(x.double())
    assert float((fb.compute(x).double() - want).abs().max()) <= 2e-3
    ncfg = BatchLogMelConfig(sample_rate=8000, n_fft=256, win_length=200,
                             hop_length=80)
    bl = BatchLogMel(ncfg, device=dev)
    k1 = sig_mel.k1_accepts(batch_logmel.sig_head(ncfg), hop=80)
    assert bl.fft_impl == ("sig" if k1 else "rdft")
    want = BatchLogMel(ncfg, dtype=torch.float64,
                       device=dev).compute(x.double())
    assert float((bl.compute(x).double() - want).abs().max()) <= 2e-4


@pytest.mark.parametrize("fft,hop,n_mels,sr", [
    (400, 160, 80, 16000.0), (400, 160, 128, 16000.0),
    (512, 160, 80, 16000.0), (200, 80, 80, 8000.0), (256, 96, 32, 16000.0),
    (1024, 256, 80, 22050.0)])
def test_k1_accepts_the_512_column_heads(dev, fft, hop, n_mels, sr):
    """K1 takes the 512-column whisper heads, and the 256- and
    1024-column ones of the 8 kHz, 256/96 and 22.05 kHz configs; the
    pipeline's auto route picks it."""
    head = mel_kernel.whisper_head(fft, n_mels, sr, dev)
    assert sig_mel.k1_accepts(head, hop=hop)
    assert WhisperMelPipeline(fft, hop, n_mels, sr,
                              device=dev).fft_impl == "sig"


@pytest.mark.parametrize("impl", framed_mel.OZAKI)
@pytest.mark.parametrize("fft,hop,n_mels,sr,sched", [
    (400, 160, 128, 16000.0, None), (1024, 256, 80, 22050.0, None),
    (256, 96, 32, 16000.0, None), (1024, 256, 80, 22050.0, (6, 6))])
@pytest.mark.parametrize("streaming", [False, True])
def test_ozaki_power_bit_equal(dev, impl, fft, hop, n_mels, sr, sched,
                               streaming):
    """K6's and K7's DFT power, written before the projection, is the
    plain version's two-float power bit for bit (float32 and float64
    dots) on a ragged frame count, in each block layout (64 frames at
    400 taps, 32 and 16 at 1024); the log-mel of the same launch is the
    counted launch's; these launches are not counted."""
    x = torch.from_numpy((np.random.default_rng(fft + 7).normal(
        size=(3, 9137)) * 0.2).astype(np.float32)).to(dev)
    ks, cutoff = sched or mel_kernel.pallas_schedule(impl)
    mats = mel_kernel.framed_matrices(impl, fft, n_mels, sr, ks, cutoff, dev)
    fr, nf = mel_kernel.framed_input(x, fft, hop, streaming)
    fr = fr[: 3 * nf]
    before = dict(framed_mel.launches)
    power, mel = framed_mel.ozaki_power(fr, mats, taps=fft)
    torch.cuda.synchronize()
    assert framed_mel.launches == before
    for dt in (torch.float32, torch.float64):
        want = framed_mel.ozaki_power_reference(fr, mats, dot_dtype=dt)
        assert torch.equal(power, want)
    got = framed_mel.framed_mel(fr, mats, n_mels=n_mels, taps=fft)
    assert torch.equal(mel[:, :n_mels], got)


@pytest.mark.parametrize("impl,fft,n_mels,ks,frames", [
    ("hp8", 400, 128, 4, 64), ("hp_bf16", 400, 128, 5, 64),
    ("hp8", 1024, 80, 4, 32), ("hp_bf16", 1024, 80, 5, 32),
    ("hp_bf16", 1024, 80, 6, 16),
    ("bf3", 400, 128, 3, 64), ("bf3", 400, 256, 3, 32),
    ("bf3", 512, 80, 3, 64), ("bf3", 960, 40, 3, 32),
    ("bf3", 1024, 80, 3, 32), ("bf3", 1024, 256, 6, 32),
    ("f32", 400, 128, 1, 64), ("f32", 512, 80, 1, 64),
    ("f32", 960, 40, 1, 32), ("f32", 1024, 80, 1, 32)])
def test_ozaki_block_frames(dev, impl, fft, n_mels, ks, frames):
    """The built library's block layout: 64 frames on the main path, 32
    at 1024 taps, 16 where six int8 slices of 1024 taps must fit; K5 and
    K8 stage the float32 frames whatever their slices: 64 frames up to 512
    taps at 128 mel columns, 32 at 960 and 1024 taps or 256 columns."""
    tile, smem = framed_ozaki.plan(impl, ks, fft, -(-n_mels // 128) * 128)
    assert tile == frames and smem <= sig_mel.MAX_SMEM_BYTES
