"""K1's magnitude heads on the card against their plain versions: each
walk (the pipelined 128-frame walk, layout 4; the 64-frame synchronous
walk, layout 1; its 32-frame blocks, layout 2; the float64 FFT path at
n_fft 2048) runs a split magnitude head, one launch counted as a
magnitude launch; NeMo's TTS mel (``nemo-tts-22k``) through
``BatchLogMel``'s auto route in 64-frame blocks, against the float64
reference, its span's stages tiling the call on the device; and the
refusals of an N-packed magnitude head and of K2. Needs a CUDA device and
nvcc; skipped elsewhere. On a machine with the card (no JAX needed):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda_magnitude.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from melspec_tpu_torch.config import BatchLogMelConfig, FbankConfig
from melspec_tpu_torch.kernels import sig_mel, sig_multi
from melspec_tpu_torch.ops import batch_logmel, fbank, framing, mel_kernel
from melspec_tpu_torch.ops.batch_logmel import BatchLogMel
from melspec_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda

TTS = BatchLogMelConfig(sample_rate=22050, n_fft=1024, win_length=1024,
                        hop_length=256, f_max=8000.0, center=False,
                        log_zero_guard=1e-5, pad_to=1, mag_power=1.0,
                        log_zero_guard_type="clamp", exact_pad=True)
TTS_NEMO = {"sample_rate": 22050, "n_fft": 1024, "win_length": 1024,
            "hop_length": 256, "n_mels": 80, "f_min": 0.0, "f_max": 8000.0,
            "mag_power": 1.0, "log_zero_guard_type": "clamp",
            "log_zero_guard": 1e-5, "exact_pad": True}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1 has no CPU mode)")
    profiling.disable()
    profiling.clear()
    yield torch.device("cuda")
    profiling.disable()
    profiling.clear()


def _noise(dev, seed, shape, scale=0.2):
    return torch.from_numpy((np.random.default_rng(seed).normal(
        size=shape) * scale).astype(np.float32)).to(dev)


def _heads():
    """``(name, head, hop, block frames)`` of a split magnitude head on
    each chunk walk: Kaldi fbank at 16 kHz (400 / 160, 256 | 256 columns)
    on the pipelined walk, NeMo's TTS head (1024 / 256, 512 | 512, 376
    live) in 64-frame blocks, NeMo at 22.05 kHz n_fft 2048 / 512 (1024 |
    1024) without its FFT description in 32-frame blocks."""
    wide = batch_logmel.sig_head(BatchLogMelConfig(
        sample_rate=22050, n_fft=2048, win_length=2048, hop_length=512,
        n_mels=128, mag_power=1.0))
    return [
        ("kaldi_16k", fbank.sig_head(FbankConfig(use_power=False,
                                                 apply_cmn=False)), 160, 128),
        ("nemo_tts", batch_logmel.sig_head(TTS), 256, 64),
        ("nemo_2048_512", dataclasses.replace(wide, fft=None, dft_size=0),
         512, 32),
    ]


@pytest.mark.parametrize("case", range(3),
                         ids=["kaldi_16k", "nemo_tts", "nemo_2048_512"])
def test_k1_magnitude_head_on_each_chunk_walk(dev, case):
    """Within 2e-4 (ln, the chunk walks' bar of ``test_torch_cuda_k1``) of
    the exact result (the plain version's float64 dot), and of the plain
    version's float32 dot plus its own distance from the exact result;
    one launch, counted as a magnitude launch, on the walk named."""
    _, head, hop, frames = _heads()[case]
    assert head.magnitude and head.n_bins_pad
    head = head.to(dev)
    assert sig_mel.head_layout(head, hop).frames == frames
    x = _noise(dev, 100 + case, (3, 3 * 22050 + 37))
    nf = framing.num_frames_batch(x.shape[-1], head.pack, hop)
    kw = dict(ks=3, n_frames=nf, hop=hop, offset=0)
    before = (sig_mel.launches, sig_mel.magnitude_launches,
              sig_mel.pipelined_launches)
    got = sig_mel.sig_mel(x, head, **kw)
    torch.cuda.synchronize()
    assert (sig_mel.launches, sig_mel.magnitude_launches,
            sig_mel.pipelined_launches) == (before[0] + 1, before[1] + 1,
                                            before[2] + int(frames == 128))
    want = sig_mel.sig_mel_reference(x, head, **kw)
    exact = sig_mel.sig_mel_reference(x, head, dot_dtype=torch.float64, **kw)
    floor = float((want - exact).abs().max())
    assert got.shape == exact.shape and bool(torch.isfinite(got).all())
    assert float((got - exact).abs().max()) <= 2e-4
    assert float((got - want).abs().max()) <= 2e-4 + floor


@pytest.mark.parametrize("kind", ["kaldi", "nemo"])
def test_k1_magnitude_head_on_the_fft_path(dev, kind):
    """Kaldi fbank (``use_power=False``) and NeMo log-mel (``mag_power``
    1) at 48 kHz, n_fft 2048, through the auto route: one launch on the
    float64 FFT path, counted as a magnitude launch, within 1e-5 of the
    path's plain version (the root taken in float64 before the one
    rounding) and within 2e-4 of the float64 rdft route."""
    if kind == "kaldi":
        cfg = FbankConfig(sample_rate=48000.0, use_power=False,
                          apply_cmn=False)
        front, f64 = (fbank.Fbank(cfg, device=dev),
                      fbank.Fbank(cfg, dtype=torch.float64, fft_impl="rdft",
                                  device=dev))
        hop = cfg.frame_shift_samples
    else:
        cfg = BatchLogMelConfig(sample_rate=48000, n_fft=2048,
                                win_length=1200, hop_length=480,
                                mag_power=1.0)
        front, f64 = (BatchLogMel(cfg, device=dev),
                      BatchLogMel(cfg, dtype=torch.float64, fft_impl="rdft",
                                  device=dev))
        hop = cfg.hop_length
    head = front.sig_head
    assert front.fft_impl == "sig" and head.fft is not None
    assert head.magnitude and head.n_bins_pad == 1024
    x = _noise(dev, 48, (3, 48000 // 2 + 37))
    before = (sig_mel.launches, sig_mel.fft_launches,
              sig_mel.magnitude_launches)
    got = front.compute(x)
    torch.cuda.synchronize()
    assert (sig_mel.launches, sig_mel.fft_launches,
            sig_mel.magnitude_launches) == tuple(b + 1 for b in before)
    truth = f64.compute(x.double())
    if kind == "nemo":
        got, truth = got.transpose(-1, -2), truth.transpose(-1, -2)
        sig = torch.nn.functional.pad(x, (1024, 1024))
        nf = framing.num_frames_centered(x.shape[-1], hop)
    else:
        sig, nf = x, framing.num_frames_batch(x.shape[-1], head.pack, hop)
    plain = sig_mel.sig_mel_fft_reference(sig, head, n_frames=nf, hop=hop,
                                          offset=0)
    assert float((got.double() - plain.double()).abs().max()) <= 1e-5
    assert float((got.double() - truth).abs().max()) <= 2e-4


def test_tts_mel_takes_k1_in_64_frame_blocks(dev):
    """NeMo's TTS mel at the cell's settings: ``"auto"`` takes ``"sig"``,
    K1 runs the split magnitude head in 64-frame blocks, one launch a
    call counted as a magnitude launch and on no other walk; the output
    holds ``T // 256`` frames within 1e-3 of the float64 reference on
    noise (K1's float32 DFT, the relative error of a frame's loudest bin
    on its quietest mels); the span's two stages read device time and
    tile the call."""
    from portbench.reference.nemo_tts import tts_log_mel

    f = BatchLogMel(TTS, device=dev)
    assert f.fft_impl == "sig"
    assert sig_mel.head_layout(f.sig_head, 256).frames == 64
    x = _noise(dev, 22, (4, 220_500), 0.1)
    want = f.compute(x)                   # warm: head, library
    torch.cuda.synchronize()
    walks = ("pipelined_launches", "factored_launches", "fft_launches")
    before = [getattr(sig_mel, w) for w in walks]
    counts = (sig_mel.launches, sig_mel.magnitude_launches)
    profiling.enable()
    for _ in range(3):
        got = f.compute(x)
    profiling.disable()
    torch.cuda.synchronize()
    assert torch.equal(got, want) and tuple(got.shape) == (4, 80, 861)
    assert (sig_mel.launches, sig_mel.magnitude_launches) == (
        counts[0] + 3, counts[1] + 3)
    assert [getattr(sig_mel, w) for w in walks] == before
    recs = profiling.records()
    calls = [r for r in recs if r.name == "logmel"]
    assert len(calls) == 3
    for call in calls:
        stages = [r for r in recs if r.parent == call.id]
        assert [r.name for r in stages] == ["logmel.pad", "logmel.spectral"]
        assert all(r.device_ms is not None and r.device_ms >= 0
                   for r in stages + [call])
        assert sum(r.device_ms for r in stages) <= call.device_ms * 1.001
        assert call.attrs["k1_launches"] == 1
        assert call.attrs["magnitude_launches"] == 1
    truth = tts_log_mel(x, TTS_NEMO, "float64")
    assert float((got.double() - truth).abs().max()) <= 1e-3


def test_k1_and_k2_refuse_what_they_do_not_compute(dev):
    """An N-packed magnitude head raises at K1's launch (its columns hold
    no bin's re^2 + im^2), and K2 refuses any magnitude head: neither
    quietly computes power."""
    x = torch.zeros(1, 4000, device=dev)
    packed = dataclasses.replace(
        batch_logmel.sig_head(BatchLogMelConfig()), magnitude=True).to(dev)
    assert not sig_mel.k1_accepts(packed, hop=160)
    with pytest.raises(NotImplementedError, match="N-packed"):
        sig_mel.sig_mel(x, packed, ks=3, n_frames=4, hop=160, offset=0)
    whisper = mel_kernel.whisper_head(400, 80, 16000.0, dev)
    kaldi = fbank.sig_head(FbankConfig(use_power=False)).to(dev)
    with pytest.raises(NotImplementedError, match="power spectra only"):
        sig_multi.sig_multi(x, (whisper, kaldi), ks=3, n_frames=4, hop=160)
