"""K1's epilogues through the port's entry points on the CPU, where
``whisper_mel_quantized`` / ``whisper_mel_vad_sig`` run their plain
versions, against the JAX package's functions in interpret mode on the
same numpy inputs (as ``tests/test_mel_kernel.py`` and
``tests/test_vad_batched_device.py`` run them).

Tolerances: the two mels agree to the 1e-5 gate (the DFT dot's summation
order differs: float64 here, f32 in JAX's kernel), so lo and hi are held
at 1e-5 and q at one step. The epilogues' arithmetic itself is held bit
for bit: the port's ``quantize_frames`` of JAX's mel equals JAX's quant
epilogue, its ``tile_vad_counts`` of a tile equals JAX's
``_sig_vad_counts``, and the port's VAD raw equals ``classify_columns``
of its own mel exactly, tile-boundary columns included. Raw columns
against JAX's may flip where a gradient sits within 1e-5 of the
threshold: at most one per clip.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from melspec_tpu import config as jconfig
from melspec_tpu.io.wav import read_wav_f32le
from melspec_tpu.ops import mel_kernel as jmk
from melspec_tpu_torch.config import DetectionSettings
from melspec_tpu_torch.kernels import sig_mel, sig_multi
from melspec_tpu_torch.ops import mel_kernel
from melspec_tpu_torch.ops.quant import quantize_frames
from melspec_tpu_torch.ops.vad import (boundary_columns, classify_columns,
                                       fix_raw)

CPU = "cpu"
TILE = sig_mel.TILE_FRAMES
MEL_BAR = 1e-5
TESTDATA = Path(__file__).resolve().parents[1] / "testdata"
EDGE_SETTINGS = [dict(min_y=0), dict(min_mel=200),
                 dict(min_energy=0.1, min_y=1)]


def _noise(seed, shape, scale=0.2):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def _samples(frames: int) -> int:
    return (frames - 1) * 160 + 400


@pytest.fixture(scope="module")
def jfk():
    return read_wav_f32le(TESTDATA / "jfk_f32le.wav")


@pytest.mark.parametrize("b", [2, 8])
@pytest.mark.parametrize("n_mels", [80, 128])
def test_quantized_matches_jax(b, n_mels):
    x = (np.random.default_rng(11).normal(size=(b, 16000)) * 0.1).astype(
        np.float32)
    q, lo, hi = mel_kernel.whisper_mel_quantized(x, n_mels=n_mels,
                                                 device=CPU)
    jq, jlo, jhi = (np.asarray(a) for a in jmk.whisper_mel_quantized(
        x, n_mels=n_mels, interpret=True))
    assert q.dtype == torch.uint8 and tuple(q.shape) == jq.shape == (
        b, 98, n_mels)
    assert np.abs(lo.numpy() - jlo).max() <= MEL_BAR
    assert np.abs(hi.numpy() - jhi).max() <= MEL_BAR
    assert np.abs(q.numpy().astype(int) - jq.astype(int)).max() <= 1
    # the record of the port's own mel, bit for bit
    wq, wlo, whi = quantize_frames(mel_kernel.whisper_mel_sig(
        x, n_mels=n_mels, device=CPU))
    assert torch.equal(q, wq) and torch.equal(lo, wlo) and torch.equal(
        hi, whi)
    # the epilogue's arithmetic: the port's quantizer on JAX's mel gives
    # JAX's fused records exactly
    jmel = np.asarray(jmk.whisper_mel_sig(x, n_mels=n_mels, interpret=True))
    pq, plo, phi = quantize_frames(torch.tensor(jmel))
    np.testing.assert_array_equal(pq.numpy(), jq)
    np.testing.assert_array_equal(plo.numpy(), jlo)
    np.testing.assert_array_equal(phi.numpy(), jhi)


def test_quantized_plain_version_f32_dot_matches_jax():
    """The plain version as the card runs it (one f32 matmul)."""
    x = _noise(5, (3, 12345))
    mats = mel_kernel.sig_matrices(400, 80, 16000.0, 3, 2, torch.device(CPU))
    q, lo, hi = sig_mel.sig_mel_quantized_reference(
        torch.from_numpy(x), mats.m_big, mats.pair_i, mats.mt_bf2, ks=3,
        n_frames=75, hop=160, offset=0, pack=400, n_bins_pad=mats.n_bins_pad,
        n_mels=80)
    jq, jlo, jhi = (np.asarray(a) for a in jmk.whisper_mel_quantized(
        x, interpret=True))
    assert tuple(q.shape) == jq.shape
    assert np.abs(lo.numpy() - jlo).max() <= MEL_BAR
    assert np.abs(hi.numpy() - jhi).max() <= MEL_BAR
    assert np.abs(q.numpy().astype(int) - jq.astype(int)).max() <= 1


def test_quantized_degenerate_range():
    """Zero input: hi == lo, the NaN chain quantizes every value to 0."""
    q, lo, hi = mel_kernel.whisper_mel_quantized(
        np.zeros((1, 8000), np.float32), device=CPU)
    jq, jlo, jhi = jmk.whisper_mel_quantized(np.zeros((1, 8000), np.float32),
                                             interpret=True)
    assert not q.any() and torch.equal(lo, hi)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert np.abs(lo.numpy() - np.asarray(jlo)).max() <= MEL_BAR


@pytest.mark.parametrize("streaming", [False, True])
def test_quantized_geometry_and_squeeze(streaming):
    x = _noise(13, 640 * 129 + 7)
    q, lo, hi = mel_kernel.whisper_mel_quantized(x, streaming=streaming,
                                                 device=CPU)
    jq, jlo, jhi = (np.asarray(a) for a in jmk.whisper_mel_quantized(
        x, streaming=streaming, interpret=True))
    assert tuple(q.shape) == jq.shape and lo.dim() == 1
    assert np.abs(hi.numpy() - jhi).max() <= MEL_BAR
    assert np.abs(q.numpy().astype(int) - jq.astype(int)).max() <= 1
    q0, lo0, hi0 = mel_kernel.whisper_mel_quantized(np.zeros(100, np.float32),
                                                    streaming=streaming,
                                                    device=CPU)
    jq0 = jmk.whisper_mel_quantized(np.zeros(100, np.float32),
                                    streaming=streaming, interpret=True)[0]
    assert tuple(q0.shape) == jq0.shape == (0, 80) and tuple(lo0.shape) == (0,)
    with pytest.raises(ValueError, match="geometry"):
        mel_kernel.whisper_mel_quantized(x, 400, 7, 80, 16000.0, device=CPU)


def test_vad_sig_matches_jax(jfk):
    """JFK (1097 frames, 17 K1 tiles) and a random batch."""
    settings = DetectionSettings()
    js = jconfig.DetectionSettings()
    for x in (jfk, _noise(5, (3, 16000 * 12), 0.3)):
        mel, raw = mel_kernel.whisper_mel_vad_sig(x, settings, device=CPU)
        jmel, jraw = (np.asarray(a) for a in jmk.whisper_mel_vad_sig(
            x, js, interpret=True))
        assert tuple(mel.shape) == jmel.shape and tuple(raw.shape) == \
            jraw.shape
        assert np.abs(mel.numpy() - jmel).max() <= MEL_BAR
        assert torch.equal(raw, classify_columns(mel.transpose(-1, -2),
                                                 settings))
        flips = (raw.numpy() != jraw).reshape(-1, raw.shape[-1]).sum(-1)
        assert flips.max() <= 1
        assert torch.equal(mel, mel_kernel.whisper_mel_sig(x, device=CPU))


@pytest.mark.parametrize("kw", EDGE_SETTINGS,
                         ids=["min_y0", "min_mel200", "low_thr"])
def test_vad_streaming_and_edge_settings(jfk, kw):
    x = jfk[: 16000 * 4]
    mel, raw = mel_kernel.whisper_mel_vad_sig(x, DetectionSettings(**kw),
                                              streaming=True, device=CPU)
    jmel, jraw = (np.asarray(a) for a in jmk.whisper_mel_vad_sig(
        x, jconfig.DetectionSettings(**kw), streaming=True, interpret=True))
    assert np.abs(mel.numpy() - jmel).max() <= MEL_BAR
    assert torch.equal(raw, classify_columns(mel.T, DetectionSettings(**kw)))
    assert int((raw.numpy() != jraw).sum()) <= 1


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("extra", [0, 1, 2])
def test_vad_tile_boundary_fixup(k, extra):
    """Clips of 64k, 64k + 1 and 64k + 2 frames: the plain version's
    counts are 0 at every tile's last two frames, as the kernel's; the
    fix-up recomputes those columns, so raw equals classify_columns."""
    frames = k * TILE + extra
    x = _noise(frames, (2, _samples(frames)), 0.3)
    settings = DetectionSettings(min_energy=0.5, min_y=3)
    mel, raw = mel_kernel.whisper_mel_vad_sig(x, settings, device=CPU)
    assert mel.shape[1] == frames and raw.shape == (2, frames - 2)
    assert torch.equal(raw, classify_columns(mel.transpose(-1, -2),
                                             settings))
    bidx = boundary_columns(frames, frames - 2, TILE)
    assert bidx == [x for j in range(1, k + (extra > 0))
                    for x in (j * TILE - 2, j * TILE - 1) if x < frames - 2]
    if bidx:
        # the counts read 0 there; the fix-up recomputed active columns
        counts = sig_mel.tile_vad_counts(mel, sig_mel.vad_threshold(0.5), 2)
        assert not counts[:, bidx].any() and bool(raw[:, bidx].any())


def test_vad_fuzz_over_settings():
    rng = np.random.default_rng(7)
    frames = 3 * TILE + 1
    x = _noise(8, (2, _samples(frames)), 0.3)
    for _ in range(8):
        settings = DetectionSettings(
            min_energy=float(rng.uniform(0.05, 1.5)),
            min_y=int(rng.integers(0, 20)), min_x=5,
            min_mel=int(rng.integers(0, 90)))
        mel, raw = mel_kernel.whisper_mel_vad_sig(x, settings, device=CPU)
        assert torch.equal(raw, classify_columns(mel.transpose(-1, -2),
                                                 settings)), settings


def test_vad_short_clips_return_real_mel():
    settings = DetectionSettings()
    for n in (400, 600):  # 1 and 2 frames
        x = _noise(3 + n, n)
        mel, raw = mel_kernel.whisper_mel_vad_sig(x, settings, device=CPU)
        jmel = np.asarray(jmk.whisper_mel_vad_sig(
            x, jconfig.DetectionSettings(), interpret=True)[0])
        assert tuple(raw.shape) == (0,)
        assert torch.equal(mel, mel_kernel.whisper_mel_sig(x, device=CPU))
        assert np.abs(mel.numpy() - jmel).max() <= MEL_BAR
        assert float(mel.abs().max()) > 0.0
    mel, raw = mel_kernel.whisper_mel_vad_sig(np.zeros(100, np.float32),
                                              settings, device=CPU)
    assert tuple(mel.shape) == (0, 80) and tuple(raw.shape) == (0,)
    with pytest.raises(ValueError, match="n_mels >= 3"):
        mel_kernel.whisper_mel_vad_sig(_noise(1, 4000), settings, n_mels=2,
                                       device=CPU)
    with pytest.raises(ValueError, match="geometry"):
        mel_kernel.whisper_mel_vad_sig(_noise(1, 4000), settings, 400, 7,
                                       device=CPU)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_epilogue_arithmetic_matches_jax_tile_functions(n_mels):
    """One tile of whisper values through JAX's kernel-side epilogue
    functions and the port's plain versions of them: the Sobel counts of
    ``_sig_vad_counts`` and the records of ``_sig_quant_vals``."""
    x = _noise(n_mels, (1, _samples(TILE)), 0.3)
    mel = mel_kernel.whisper_mel_sig(x, n_mels=n_mels, device=CPU)[0]
    thr, start_y = sig_mel.vad_threshold(0.5), 2
    want = np.asarray(jmk._sig_vad_counts(jnp.asarray(mel.numpy()),
                                          (thr, start_y, 3), n_mels))[0]
    got = sig_mel.tile_vad_counts(mel[None], thr, start_y)[0]
    np.testing.assert_array_equal(got.numpy(), want)
    jq, jrng = (np.asarray(a) for a in jmk._sig_quant_vals(
        jnp.asarray(mel.numpy()), n_mels))
    q, lo, hi = quantize_frames(mel)
    np.testing.assert_array_equal(q.numpy(), jq)
    np.testing.assert_array_equal(lo.numpy(), jrng[0])
    np.testing.assert_array_equal(hi.numpy(), jrng[1])


@pytest.mark.parametrize("tile", [sig_mel.TILE_FRAMES, sig_multi.TILE_FRAMES,
                                  16])
def test_fix_raw_takes_the_kernels_tile(tile):
    """The shared fix-up recomputes exactly the columns of the tile it is
    given: counts that are right except at each tile's last two frames
    (where a kernel reads 0) give classify_columns' raw."""
    settings = DetectionSettings(min_energy=0.5, min_y=2)
    mel = torch.from_numpy(_noise(tile, (2, 5 * tile + 3, 32), 1.0))
    n = mel.shape[1]
    want = classify_columns(mel.transpose(-1, -2), settings)
    edge = torch.arange(n - 2) % tile >= tile - 2
    counts = torch.where(edge, 0, want.int() * settings.min_y)
    assert not torch.equal(counts >= settings.min_y, want)
    assert torch.equal(fix_raw(counts, mel, n, n - 2, settings, tile), want)
