"""K1's u8-quant and Sobel VAD epilogues on the card against K1's own mel
and against their plain versions. Needs a CUDA device and nvcc; skipped
elsewhere. On a machine with the card (no JAX needed):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda_k1_epilogues.py

Bars: the quant records equal ``quantize_frames`` of K1's mel from
``whisper_mel_sig`` on the same input bit for bit (the epilogue runs the
same float32 expression tree on the same normalized values), and the VAD
raw equals ``classify_columns`` of K1's mel exactly, tile-boundary
columns included. Against the plain version (f32 dot) lo and hi hold the
mel's bar (1e-5 plus the plain version's own distance from the exact
float64 dot) and q one step.
"""

import numpy as np
import pytest
import torch

from melspec_tpu_torch.config import DetectionSettings
from melspec_tpu_torch.kernels import sig_mel
from melspec_tpu_torch.ops import framing, mel_kernel
from melspec_tpu_torch.ops.quant import quantize_frames
from melspec_tpu_torch.ops.vad import classify_columns

pytestmark = pytest.mark.cuda

TILE = sig_mel.TILE_FRAMES
EDGE_SETTINGS = [DetectionSettings(), DetectionSettings(min_y=0),
                 DetectionSettings(min_mel=200),
                 DetectionSettings(min_energy=0.1, min_y=1)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1 has no CPU mode)")
    return torch.device("cuda")


def _signal(seed, shape, dev, scale=0.2):
    return torch.from_numpy((np.random.default_rng(seed).normal(size=shape)
                             * scale).astype(np.float32)).to(dev)


def _samples(frames: int) -> int:
    return (frames - 1) * 160 + 400


@pytest.mark.parametrize("n_mels", [80, 128])
@pytest.mark.parametrize("streaming", [False, True])
@pytest.mark.parametrize("shape", [(1, 30 * 16000), (7, 48123), (3, 2000)])
def test_quantized_equals_quantize_frames_of_k1_mel(dev, n_mels, streaming,
                                                    shape):
    x = _signal(sum(shape) + n_mels, shape, dev)
    before = (sig_mel.launches, sig_mel.epilogue_launches["quant"])
    q, lo, hi = mel_kernel.whisper_mel_quantized(
        x, 400, 160, n_mels, streaming=streaming, device=dev)
    torch.cuda.synchronize()
    assert (sig_mel.launches, sig_mel.epilogue_launches["quant"]) == (
        before[0] + 1, before[1] + 1)
    mel = mel_kernel.whisper_mel_sig(x, 400, 160, n_mels,
                                     streaming=streaming, device=dev)
    wq, wlo, whi = quantize_frames(mel)
    assert q.dtype == torch.uint8 and q.shape == mel.shape
    assert torch.equal(q, wq)
    assert torch.equal(lo, wlo) and torch.equal(hi, whi)

    # against the plain version (f32 dot) and the exact one (float64 dot)
    head = mel_kernel.whisper_head(400, n_mels, 16000.0, dev)
    offset = framing.streaming_frame_offset(400, 160) if streaming else 0
    kw = dict(ks=3, n_frames=mel.shape[1], hop=160, offset=offset)
    pq, plo, phi = sig_mel.sig_mel_quantized_reference(x, head, **kw)
    _, elo, ehi = sig_mel.sig_mel_quantized_reference(
        x, head, dot_dtype=torch.float64, **kw)
    floor = float(torch.maximum((plo - elo).abs().max(),
                                (phi - ehi).abs().max()))
    assert float((lo - plo).abs().max()) <= 1e-5 + floor
    assert float((hi - phi).abs().max()) <= 1e-5 + floor
    assert int((q.int() - pq.int()).abs().max()) <= 1


def test_quantized_zero_input_and_short_clips(dev):
    q, lo, hi = mel_kernel.whisper_mel_quantized(
        torch.zeros((2, 8000), device=dev), device=dev)
    assert not q.any() and torch.equal(lo, hi)
    q, lo, hi = mel_kernel.whisper_mel_quantized(torch.zeros(100, device=dev),
                                                 device=dev)
    assert tuple(q.shape) == (0, 80) and tuple(lo.shape) == (0,)


@pytest.mark.parametrize("settings", EDGE_SETTINGS,
                         ids=["default", "min_y0", "min_mel200", "low_thr"])
@pytest.mark.parametrize("frames", [TILE, 2 * TILE, 2 * TILE + 1,
                                    2 * TILE + 2, 5 * TILE + 37])
def test_vad_raw_equals_classify_of_k1_mel(dev, settings, frames):
    """At clips of 64k, 64k + 1 and 64k + 2 frames and ragged ones, the
    boundary fix-up included; the mel is K1's whisper mel bit for bit."""
    x = _signal(frames, (3, _samples(frames)), dev, 0.3)
    before = (sig_mel.launches, sig_mel.epilogue_launches["vad"])
    mel, raw = mel_kernel.whisper_mel_vad_sig(x, settings, device=dev)
    torch.cuda.synchronize()
    assert (sig_mel.launches, sig_mel.epilogue_launches["vad"]) == (
        before[0] + 1, before[1] + 1)
    assert mel.shape[1] == frames and raw.shape == (3, frames - 2)
    assert torch.equal(mel, mel_kernel.whisper_mel_sig(x, device=dev))
    assert torch.equal(raw, classify_columns(mel.transpose(-1, -2),
                                             settings))


def test_vad_counts_equal_tile_counts(dev):
    """The epilogue's counts, boundary zeros included, equal the plain
    version's ``tile_vad_counts`` of K1's own mel."""
    settings = DetectionSettings(min_energy=0.5, min_y=3)
    x = _signal(7, (4, _samples(3 * TILE + 9)), dev, 0.3)
    head = mel_kernel.whisper_head(400, 128, 16000.0, dev)
    vad = (sig_mel.vad_threshold(settings.min_energy), settings.min_mel)
    mel, counts = sig_mel.sig_mel_vad(x, head, ks=3, n_frames=3 * TILE + 9,
                                      hop=160, offset=0, vad=vad)
    assert counts.dtype == torch.int32
    assert torch.equal(counts, sig_mel.tile_vad_counts(mel, *vad))
    assert bool(counts.any())


@pytest.mark.parametrize("streaming", [False, True])
def test_vad_streaming_and_short_clips(dev, streaming):
    x = _signal(3, 16000 * 4, dev, 0.3)
    for settings in EDGE_SETTINGS:
        mel, raw = mel_kernel.whisper_mel_vad_sig(
            x, settings, streaming=streaming, device=dev)
        assert torch.equal(raw, classify_columns(mel.T, settings))
    for n in (400, 560):  # one and two frames
        y = _signal(n, n, dev)
        mel, raw = mel_kernel.whisper_mel_vad_sig(y, DetectionSettings(),
                                                  device=dev)
        assert raw.shape == (0,)
        assert torch.equal(mel, mel_kernel.whisper_mel_sig(y, device=dev))
        assert float(mel.abs().max()) > 0.0
