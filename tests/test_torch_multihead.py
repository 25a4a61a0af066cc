"""Fused frontends on K2's plain version, port vs JAX (its Pallas kernel in
interpret mode) on the same numpy inputs: the whisper head equals the
port's single-head route bit for bit and JAX's within 2e-5, the Kaldi and
NeMo heads sit within 2e-4 of JAX's, the raw VAD equals
``classify_columns`` on the port's own mel at every tile-boundary column
of K2's tile, and the host matrices of every head are JAX's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from melspec_tpu.config import DetectionSettings as JSettings
from melspec_tpu.ops import sig_multihead as jmh
from melspec_tpu_torch import convert
from melspec_tpu_torch.config import (BatchLogMelConfig, DetectionSettings,
                                      FbankConfig, MelConfig)
from melspec_tpu_torch.kernels import sig_mel, sig_multi
from melspec_tpu_torch.ops import sig_multihead as mh
from melspec_tpu_torch.ops.batch_logmel import BatchLogMel
from melspec_tpu_torch.ops.mel_kernel import whisper_mel_sig
from melspec_tpu_torch.ops.vad import boundary_columns, classify_columns

TILE = sig_multi.TILE_FRAMES
# B = 5 and a ragged T spanning 3 tiles of K2 plus 11 frames
SHAPE = (5, 160 * (3 * TILE + 11) + 77)
SETTINGS = dict(min_energy=0.5, min_y=2, min_x=5, min_mel=0)
CROSS_ROUTE = 2e-4
WHISPER_BAR = 2e-5


def _bits(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.contiguous().view(torch.int16).numpy().view(np.uint16)
    return np.asarray(t).view(np.uint16)


@pytest.fixture(scope="module")
def x():
    return (np.random.default_rng(11).normal(size=SHAPE) * 0.2).astype(
        np.float32)


@pytest.fixture(scope="module")
def jax_pair():
    return jmh.WhisperKaldiFused(interpret=True)


@pytest.fixture(scope="module")
def jax_tri():
    return jmh.WhisperKaldiNemoFused(interpret=True)


@pytest.fixture(scope="module")
def pair_out(jax_pair, x):
    want = [np.asarray(a) for a in jax_pair.compute_with_vad(
        jnp.asarray(x), JSettings(**SETTINGS))]
    got = mh.WhisperKaldiFused(device="cpu").compute_with_vad(
        x, DetectionSettings(**SETTINGS))
    return got, want


@pytest.fixture(scope="module")
def tri_out(jax_tri, x):
    want = [np.asarray(a) for a in jax_tri.compute_with_vad(
        jnp.asarray(x), JSettings(**SETTINGS))]
    got = mh.WhisperKaldiNemoFused(device="cpu").compute_with_vad(
        x, DetectionSettings(**SETTINGS))
    return got, want


@pytest.fixture(scope="module")
def outs(pair_out, tri_out):
    return {"pair": pair_out, "tri": tri_out}


@pytest.mark.parametrize("which", ["pair", "tri"])
def test_whisper_head_equals_single_head_route(outs, x, which):
    got, _ = outs[which]
    assert torch.equal(got[0], whisper_mel_sig(x, device="cpu"))


@pytest.mark.parametrize("which", ["pair", "tri"])
def test_heads_match_jax(outs, which):
    got, want = outs[which]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got[:-1], want[:-1])):
        assert tuple(g.shape) == w.shape
        bar = WHISPER_BAR if i == 0 else CROSS_ROUTE
        assert np.abs(g.numpy() - w).max() <= bar, i


@pytest.mark.parametrize("which", ["pair", "tri"])
def test_raw_vad_equals_classify_columns(outs, which):
    got, want = outs[which]
    mel, raw = got[0], got[-1]
    assert raw.dtype == torch.bool and raw.shape == (SHAPE[0],
                                                     mel.shape[1] - 2)
    assert torch.equal(raw, classify_columns(mel.transpose(-1, -2),
                                             DetectionSettings(**SETTINGS)))
    # the columns K2 cannot classify itself: every tile boundary
    bidx = boundary_columns(mel.shape[1], mel.shape[1] - 2, TILE)
    assert len(bidx) == 6
    # against JAX: its own mel gives its own raw; the two mels differ
    # within 2e-5, which may flip a column at the threshold
    assert int((raw.numpy() != want[-1]).sum()) <= 1


def test_nemo_head_holds_float64(outs, x):
    (_, _, nemo, _), _ = outs["tri"]
    f64 = BatchLogMel(dtype=torch.float64, fft_impl="rdft",
                      device="cpu").compute(x.astype(np.float64))
    assert nemo.shape == f64.shape
    assert float((nemo.double() - f64).abs().max()) <= CROSS_ROUTE


@pytest.mark.parametrize("which", ["pair", "tri"])
def test_head_matrices_bit_identical_to_jax(jax_pair, jax_tri, which):
    jf = jax_pair if which == "pair" else jax_tri
    ours = (mh.WhisperKaldiFused(device="cpu") if which == "pair"
            else mh.WhisperKaldiNemoFused(device="cpu")).heads
    assert len(ours) == len(jf._mbs)
    packs = getattr(jf, "_packs", None)
    for h, (head, mb, mt) in enumerate(zip(ours, jf._mbs, jf._mts)):
        np.testing.assert_array_equal(_bits(head.m_big), _bits(mb))
        np.testing.assert_array_equal(_bits(head.mt), _bits(mt))
        spec = jf._heads[h]
        assert (head.n_bins_pad, head.n_mels, head.out_mode) == spec[1:4]
        assert head.pair_i == jf._pair_i
        if packs is not None:
            assert (head.pack, head.pack_off) == packs[h]


def test_plain_version_f32_dot_within_floor(x):
    """K2's plain version with the f32 dot (the kernel's arithmetic class)
    against its float64-dot version, and the VAD counts against
    tile_vad_counts of its own head 0."""
    fused = mh.WhisperKaldiFused(device="cpu")
    xt = torch.from_numpy(x)
    nf = (SHAPE[1] - 400) // 160 + 1
    vad = (sig_mel.vad_threshold(0.5), 0)
    f32, counts = sig_multi.sig_multi_reference(xt, fused.heads, ks=3,
                                                n_frames=nf, hop=160,
                                                vad=vad)
    exact, _ = sig_multi.sig_multi(xt, fused.heads, ks=3, n_frames=nf,
                                   hop=160)
    assert float((f32[0] - exact[0]).abs().max()) <= WHISPER_BAR
    assert float((f32[1] - exact[1]).abs().max()) <= CROSS_ROUTE
    assert torch.equal(counts, sig_mel.tile_vad_counts(f32[0], *vad))
    edge = torch.arange(nf) % TILE >= TILE - 2
    assert not counts[:, edge].any() and not counts[:, -2:].any()


def test_fbank_blocks_subset_matches_jax(x):
    """The Kaldi head over the slice-pair blocks (0, 1, 3) only."""
    jf = jmh.WhisperKaldiFused(interpret=True, fbank_blocks=(0, 1, 3))
    xs = x[:2, : 16000]
    want = np.asarray(jf.compute(jnp.asarray(xs))[1])
    port = mh.WhisperKaldiFused(device="cpu", fbank_blocks=(0, 1, 3))
    np.testing.assert_array_equal(_bits(port.heads[1].m_big),
                                  _bits(jf._mbs[1]))
    got = port.compute(xs)[1].numpy()
    assert np.abs(got - want).max() <= CROSS_ROUTE


def test_rejects_configs_jax_rejects():
    with pytest.raises(ValueError, match="one frame grid"):
        mh.WhisperKaldiFused(MelConfig(fft_size=512, hop_size=160),
                             FbankConfig(), device="cpu")
    with pytest.raises(ValueError):
        mh.WhisperKaldiFused(fbank_config=FbankConfig(use_power=False),
                             device="cpu")
    with pytest.raises(ValueError, match="center"):
        mh.WhisperKaldiNemoFused(nemo_config=BatchLogMelConfig(center=False),
                                 device="cpu")


def test_jax_matrices_carried_across(jax_tri, x):
    """The three JAX heads through ``convert.from_jax_head`` drive the
    port's three-head frontend to its own output bit for bit."""
    heads = []
    for h, (mb, mt) in enumerate(zip(jax_tri._mbs, jax_tri._mts)):
        n_cols, nbp, n_mels, mode, guard, _ = jax_tri._heads[h]
        pack, off = jax_tri._packs[h]
        heads.append(convert.from_jax_head(np.asarray(mb),
                                           jax_tri._pair_i, np.asarray(mt),
                                           nbp, pack, off, n_mels, mode,
                                           guard))
    xs = x[:2, :12000]
    a = mh.WhisperKaldiNemoFused(device="cpu", matrices=heads).compute(xs)
    b = mh.WhisperKaldiNemoFused(device="cpu").compute(xs)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
