"""The port's per-hop streaming STFT / mel (``streaming/stft.py``) and ring
pipeline (``streaming/pipeline.py``) on the CPU: every case of
``tests/test_streaming.py`` on the port, and the port against the JAX
package on the same seeded inputs.

Tolerances:
- float64, port vs JAX: 1e-12 (the CPU BLAS of each package sums in its
  own order; measured <= 1e-13);
- float32 bulk route, port vs JAX: 1e-5 (one f32 rounding class; measured
  8e-6 on JFK);
- float32 per-hop route: XLA's CPU vector-matrix product lands 3.5e-5 from
  the float64 result on JFK (hop 116, mel 71) where the port's lands 1.0e-5,
  so each package is held to the float64 result, the port at 1.5e-5 and
  the two within 1e-5 plus JAX's own distance (its f32 floor);
- the JFK golden: 1e-6 at float64 (JAX's bar);
- bulk vs per-hop (scan) at float64: 1e-12, states equal.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from melspec_tpu import config as jconfig
from melspec_tpu.streaming import pipeline as jpipe
from melspec_tpu.streaming import stft as jstft
from melspec_tpu_torch import convert
from melspec_tpu_torch.config import MelConfig
from melspec_tpu_torch.ops.spectrogram import compute_streaming_mel
from melspec_tpu_torch.streaming import stft
from melspec_tpu_torch.streaming.pipeline import RingBuffer
from melspec_tpu_torch.streaming.stft import StreamingMel, StreamingStft

CPU = "cpu"
JFK_CONFIG = (512, 160, 80, 16000.0)
F64 = (torch.float64, jnp.float64)
F32 = (torch.float32, jnp.float32)


def _noise(seed, n):
    return (np.random.default_rng(seed).normal(size=n) * 0.2).astype(
        np.float32)


def _pair(cfg, dtypes):
    tdt, jdt = dtypes
    return (StreamingMel(MelConfig(*cfg), dtype=tdt, device=CPU),
            jstft.StreamingMel(jconfig.MelConfig(*cfg), dtype=jdt))


def _chunks(samples, hop):
    n = len(samples) // hop
    return samples[: n * hop].reshape(n, hop)


def test_emission_timing():
    """Reference ``src/stft.rs:175-194``: fft=8, hop=4 — a 3-sample chunk
    emits nothing, a full hop after 7 samples emits nothing, the next hop
    emits."""
    mel = StreamingMel(MelConfig(fft_size=8, hop_size=4, n_mels=2,
                                 sampling_rate=16000.0), device=CPU)
    state = mel.init()
    state, out = mel.push(state, np.array([1.0, 2.0, 3.0], dtype=np.float32))
    assert out is None
    state, out = mel.push(state, np.array([1.0, 2.0, 3.0, 4.0], np.float32))
    assert out is None
    state, out = mel.push(state, np.array([1.0, 2.0, 3.0, 4.0], np.float32))
    assert out is not None and out.shape == (2,)


def test_jfk_golden_through_ringbuffer(testdata, jfk_samples):
    """Master regression: JFK in 32-sample pushes through the ring
    pipeline at float64, the full [80, 1097] matrix against the golden."""
    golden = np.load(testdata / "rust_jfk_golden.npy")
    rb = RingBuffer(MelConfig(*JFK_CONFIG), capacity=2048,
                    dtype=torch.float64, device=CPU)
    frames = []
    for off in range(0, len(jfk_samples), 32):
        rb.add_frame(jfk_samples[off : off + 32])
        mel = rb.maybe_mel()
        if mel is not None:
            frames.append(mel)
    got = np.concatenate(frames, axis=1)
    assert got.shape == golden.shape
    assert np.abs(got - golden).max() <= 1e-6


def test_drain_mels_bulk_equals_golden_and_per_hop(testdata, jfk_samples):
    golden = np.load(testdata / "rust_jfk_golden.npy")
    rb = RingBuffer(MelConfig(*JFK_CONFIG), capacity=1 << 22,
                    dtype=torch.float64, device=CPU)
    rb.add_frame(jfk_samples)
    got = np.concatenate(rb.drain_mels(), axis=1)
    assert got.shape == golden.shape
    assert np.abs(got - golden).max() <= 1e-6
    mel = StreamingMel(MelConfig(*JFK_CONFIG), dtype=torch.float64,
                       device=CPU)
    _, per_hop, valid = mel.push_many(
        mel.init(), _chunks(jfk_samples, 160), scan=True)
    assert np.abs(got - per_hop[valid].T).max() <= 1e-12


def test_scan_matches_batched_path(jfk_samples):
    """push_many equals the port's batched streaming-equivalent pipeline
    (float32 output, compared at float32 resolution as in JAX)."""
    samples = jfk_samples[:32000]
    mel = StreamingMel(MelConfig(400, 160, 80, 16000.0), dtype=torch.float64,
                       device=CPU)
    _, mels, valid = mel.push_many(mel.init(), _chunks(samples, 160))
    got = mels[valid].T
    want = compute_streaming_mel(samples, 400, 160, 80, 16000.0,
                                 dtype=torch.float64, device=CPU)
    assert got.shape == want.shape
    assert np.abs(got.astype(np.float32) - want).max() <= 1e-6


def test_short_chunk_zero_padding():
    """A short chunk is zero-padded to the hop and advances the sample
    counter by its true length (reference ``src/stft.rs:52-64``)."""
    mel = StreamingMel(MelConfig(8, 4, 2, 16000.0), device=CPU)
    state = mel.init()
    state, _ = mel.push(state, np.ones(4, dtype=np.float32))
    state, out = mel.push(state, np.ones(3, dtype=np.float32))
    assert out is None  # idx = 7 < 8
    assert int(state.idx) == 7
    np.testing.assert_array_equal(state.hop_buf.numpy(),
                                  [1, 1, 1, 1, 1, 1, 1, 0])
    state, out = mel.push(state, np.ones(4, dtype=np.float32))
    assert out is not None


def test_idx_saturates_at_fft():
    mel = StreamingMel(MelConfig(8, 4, 2, 16000.0), device=CPU)
    state = mel.init()
    for _ in range(5):
        state, _ = mel.push(state, np.ones(4, dtype=np.float32))
    assert int(state.idx) == 8 and state.idx.dtype == torch.int64
    state, _, valid = mel.push_many(state, np.ones((6, 4), np.float32))
    assert int(state.idx) == 8 and valid.all()


def test_checkpoint_resume(tmp_path, jfk_samples):
    """Streaming checkpoints mid-clip and resumes bit-identically."""
    mel = StreamingMel(MelConfig(400, 160, 80, 16000.0), dtype=torch.float64,
                       device=CPU)
    state = mel.init()
    outs_full = []
    for off in range(0, 16000, 160):
        state, out = mel.push(state, jfk_samples[off : off + 160])
        outs_full.append(out)

    state = mel.init()
    outs_ckpt = []
    for off in range(0, 8000, 160):
        state, out = mel.push(state, jfk_samples[off : off + 160])
        outs_ckpt.append(out)
    stft.save_state(state, tmp_path / "stream.npz")
    state = stft.load_state(tmp_path / "stream.npz", device=CPU)
    for off in range(8000, 16000, 160):
        state, out = mel.push(state, jfk_samples[off : off + 160])
        outs_ckpt.append(out)

    assert len(outs_full) == len(outs_ckpt)
    for a, b in zip(outs_full, outs_ckpt):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)


def test_state_is_serializable():
    mel = StreamingMel(MelConfig(400, 160, 80, 16000.0), device=CPU)
    state, _ = mel.push(mel.init(), np.ones(160, dtype=np.float32))
    buf, idx = state.hop_buf.numpy().copy(), state.idx.numpy().copy()
    restored = stft.StftState(torch.from_numpy(buf), torch.from_numpy(idx))
    state2, out2 = mel.push(restored, np.ones(160, dtype=np.float32))
    state3, out3 = mel.push(state, np.ones(160, dtype=np.float32))
    assert (out2 is None) == (out3 is None)
    np.testing.assert_array_equal(state2.hop_buf.numpy(),
                                  state3.hop_buf.numpy())


def test_push_many_bulk_matches_scan(jfk_samples):
    mel = StreamingMel(MelConfig(400, 160, 80, 16000.0), dtype=torch.float64,
                       device=CPU)
    chunks = jfk_samples[: 50 * 160].reshape(50, 160)
    s_b, m_b, v_b = mel.push_many(mel.init(), chunks)
    s_s, m_s, v_s = mel.push_many(mel.init(), chunks, scan=True)
    np.testing.assert_array_equal(v_b, v_s)
    np.testing.assert_allclose(m_b[v_b], m_s[v_s], rtol=0, atol=1e-12)
    np.testing.assert_array_equal(s_b.hop_buf.numpy(), s_s.hop_buf.numpy())
    assert int(s_b.idx) == int(s_s.idx)


def test_push_many_empty_batch_is_noop():
    mel = StreamingMel(MelConfig(400, 160, 80, 16000.0), device=CPU)
    state = mel.init()
    state2, mels, valid = mel.push_many(state, np.zeros((0, 160), np.float32))
    assert mels.shape == (0, 80) and valid.shape == (0,)
    assert state2 is state


@pytest.mark.parametrize("bad", [np.zeros((3, 161), np.float32),
                                 np.zeros(160, np.float32),
                                 np.zeros((2, 3, 160), np.float32)],
                         ids=["wide", "flat", "3d"])
def test_push_many_rejects_wrong_shape(bad):
    mel = StreamingMel(MelConfig(400, 160, 80, 16000.0), device=CPU)
    with pytest.raises(ValueError, match="hop_size"):
        mel.push_many(mel.init(), bad)


def test_push_rejects_chunk_longer_than_hop():
    mel = StreamingMel(MelConfig(400, 160, 80, 16000.0), device=CPU)
    with pytest.raises(ValueError, match="hop_size"):
        mel.push(mel.init(), np.zeros(161, np.float32))


def test_ring_buffer_rejects_capacity_below_hop():
    with pytest.raises(ValueError, match="capacity"):
        RingBuffer(MelConfig(400, 160, 80, 16000.0), capacity=100,
                   device=CPU)


@pytest.mark.parametrize("cfg", [(400, 160, 80, 16000.0), JFK_CONFIG,
                                 (400, 160, 128, 16000.0)],
                         ids=["whisper", "jfk", "large_v3"])
@pytest.mark.parametrize("scan", [False, True], ids=["bulk", "scan"])
def test_float64_matches_jax(cfg, scan):
    port, ref = _pair(cfg, F64)
    chunks = _chunks(_noise(1, 60 * cfg[1] + 37), cfg[1])
    s_p, m_p, v_p = port.push_many(port.init(), chunks, scan=scan)
    s_j, m_j, v_j = ref.push_many(ref.init(), chunks, scan=scan)
    np.testing.assert_array_equal(v_p, v_j)
    assert np.abs(m_p - np.asarray(m_j)).max() <= 1e-12
    np.testing.assert_array_equal(s_p.hop_buf.numpy(),
                                  np.asarray(s_j.hop_buf))
    assert int(s_p.idx) == int(s_j.idx)


@pytest.mark.parametrize("source", ["noise", "jfk"])
def test_float32_bulk_matches_jax(source, jfk_samples):
    samples = _noise(2, 16000 * 3) if source == "noise" else jfk_samples
    port, ref = _pair(JFK_CONFIG, F32)
    chunks = _chunks(samples, 160)
    _, m_p, v_p = port.push_many(port.init(), chunks)
    _, m_j, v_j = ref.push_many(ref.init(), chunks)
    np.testing.assert_array_equal(v_p, v_j)
    assert m_p.dtype == np.float32
    assert np.abs(m_p - np.asarray(m_j)).max() <= 1e-5


def test_float32_per_hop_against_jax_and_float64(jfk_samples):
    """Per-hop pushes (short chunks included) at float32: each package is
    held to the float64 result; the two within 1e-5 plus JAX's floor."""
    port, ref = _pair(JFK_CONFIG, F32)
    exact, _ = _pair(JFK_CONFIG, F64)
    sp, sj, se = port.init(), ref.init(), exact.init()
    got_p, got_j, got_e = [], [], []
    for i, off in enumerate(range(0, 300 * 160, 160)):
        chunk = jfk_samples[off : off + (160 if i % 7 else 123)]
        sp, mp = port.push(sp, chunk)
        sj, mj = ref.push(sj, chunk)
        se, me = exact.push(se, chunk)
        assert (mp is None) == (mj is None) == (me is None)
        if mp is not None:
            got_p.append(mp)
            got_j.append(np.asarray(mj))
            got_e.append(me)
    p, j, e = np.stack(got_p), np.stack(got_j), np.stack(got_e)
    port_floor = np.abs(p - e).max()
    jax_floor = np.abs(j - e).max()
    assert port_floor <= 1.5e-5, port_floor
    assert np.abs(p - j).max() <= 1e-5 + jax_floor


def test_push_matches_jax_per_hop_float64():
    """``push`` with short chunks, hop by hop, against JAX's: the same
    emissions, mels within 1e-12, the same carried state."""
    port, ref = _pair((400, 160, 80, 16000.0), F64)
    x = _noise(3, 40 * 160)
    sp, sj = port.init(), ref.init()
    off, i = 0, 0
    while off < len(x):
        n = (160, 37, 160, 1, 0)[i % 5]
        sp, mp = port.push(sp, x[off : off + n])
        sj, mj = ref.push(sj, x[off : off + n])
        assert (mp is None) == (mj is None)
        if mp is not None:
            assert np.abs(mp - np.asarray(mj)).max() <= 1e-12
        off, i = off + n, i + 1
    np.testing.assert_array_equal(sp.hop_buf.numpy(),
                                  np.asarray(sj.hop_buf))
    assert int(sp.idx) == int(sj.idx)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_state_files_cross_load(tmp_path, direction):
    """A state file written by either package resumes in the other."""
    cfg = (400, 160, 80, 16000.0)
    port, ref = _pair(cfg, F64)
    x = _chunks(_noise(4, 30 * 160), 160)
    path = tmp_path / "stream.npz"
    if direction == "jax_to_port":
        s, _, _ = ref.push_many(ref.init(), x[:3])
        jstft.save_state(s, path)
        s_p = stft.load_state(path, device=CPU)
        s_j = s
    else:
        s, _, _ = port.push_many(port.init(), x[:3])
        stft.save_state(s, path)
        s_j = jstft.load_state(path)
        s_p = s
    with np.load(path) as z:
        assert sorted(z.files) == ["hop_buf", "idx"]
    _, m_p, v_p = port.push_many(s_p, x[3:])
    _, m_j, v_j = ref.push_many(s_j, x[3:])
    np.testing.assert_array_equal(v_p, v_j)
    assert np.abs(m_p - np.asarray(m_j)).max() <= 1e-12


def test_from_jax_stft_state_takes_int32_idx():
    """JAX without x64 carries an int32 ``idx`` and float32 ``hop_buf``:
    the port's state takes it as int64 and continues as JAX does."""
    port, ref = _pair((400, 160, 80, 16000.0), F32)
    x = _chunks(_noise(5, 12 * 160), 160)
    s_j, _, _ = ref.push_many(ref.init(), x[:2])
    buf = np.asarray(s_j.hop_buf)
    s_p = convert.from_jax_stft_state(buf, np.int32(int(s_j.idx)),
                                      device=CPU)
    assert s_p.idx.dtype == torch.int64 and s_p.hop_buf.dtype == torch.float32
    _, m_p, v_p = port.push_many(s_p, x[2:])
    _, m_j, v_j = ref.push_many(s_j, x[2:])
    np.testing.assert_array_equal(v_p, v_j)
    assert np.abs(m_p - np.asarray(m_j)).max() <= 1e-5


def test_streaming_stft_bit_equal_to_jax():
    """``StreamingStft.add`` is host numpy float64 in both packages."""
    port, ref = StreamingStft(400, 160), jstft.StreamingStft(400, 160)
    x = _noise(6, 20 * 160)
    off = 0
    for n in [160, 100, 160, 160, 3, 160] * 3:
        a = port.add(x[off : off + n])
        b = ref.add(x[off : off + n])
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
        off += n
    with pytest.raises(ValueError):
        port.add(np.zeros(161))


def test_ring_buffer_matches_jax_ring_buffer():
    """The ring pipeline, one hop per call and drained in bulk, against
    JAX's on the same pushes (float64)."""
    cfg = (400, 160, 80, 16000.0)
    port = RingBuffer(MelConfig(*cfg), capacity=4096, dtype=torch.float64,
                      device=CPU)
    ref = jpipe.RingBuffer(jconfig.MelConfig(*cfg), capacity=4096,
                           dtype=jnp.float64)
    x = _noise(7, 40 * 160 + 77)
    got_p, got_j = [], []
    for off in range(0, 20 * 160, 96):
        assert port.add_frame(x[off : off + 96]) == \
            ref.add_frame(x[off : off + 96])
        a, b = port.maybe_mel(), ref.maybe_mel()
        assert (a is None) == (b is None)
        if a is not None:
            got_p.append(a)
            got_j.append(b)
    port.add_frame(x[20 * 160 :])
    ref.add_frame(x[20 * 160 :])
    got_p += port.drain_mels()
    got_j += ref.drain_mels()
    assert len(got_p) == len(got_j) > 0
    assert all(a.shape == (80, 1) for a in got_p)
    assert np.abs(np.concatenate(got_p, 1)
                  - np.concatenate(got_j, 1)).max() <= 1e-12
