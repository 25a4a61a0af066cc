"""K1's pipelined 128-frame walk on the CPU (it runs on the card only):
the host's stage stream of m_big and the bf2 projection's rows
(``kernels/sig_mel.py::pipe_index`` / ``pipe_stages``), decoded byte by
byte with the ring's layout of ``csrc/sig_pipe.cuh`` (a stage's 8-column
groups of 528 bytes, four core matrices of 8 rows x 16 bytes each, then
16 bytes of padding; the projection's pieces swizzled in 16-byte
groups), at whisper 400/160 with 80 and 128 mels and NeMo's ln head."""

import dataclasses

import numpy as np
import pytest
import torch

from melspec_tpu_torch.kernels import sig_mel
from melspec_tpu_torch.ops import mel_kernel
from melspec_tpu_torch.ops.batch_logmel import BatchLogMel

CPU = torch.device("cpu")
CORE_N = 528     # bytes between a stage's 8-column groups
CORE_K = 128     # bytes between its core matrices along the rows


def _head(which):
    if which == "nemo":
        return BatchLogMel(fft_impl="sig", device=CPU).sig_head
    return mel_kernel.whisper_head(400, int(which.split("_")[1]), 16000.0,
                                   CPU)


def _dims(head):
    return head.width, head.npow, head.n_mels_pad


def _decode(head):
    """Every value of the head's stream, by its byte offset read with the
    ring's layout: the source index that ``pipe_index`` gives it, and the
    index this decoding expects (m_big's row and column, mt's row and
    column, or the zero)."""
    width, npow, nmp = _dims(head)
    blocks = sig_mel.block_order(head.pair_i)
    idx = sig_mel.pipe_index(head.m_big.shape[0], width, npow, head.live,
                             blocks, head.pack, nmp, True).numpy()
    split = npow != width
    cp = 128 // (2 if split else 1)
    cpb = -(-head.pack // 32)
    steps = len(blocks) * cpb
    mt0 = head.m_big.shape[0] * width
    zero = mt0 + 3 * npow * nmp
    want = np.full(idx.shape, -1, dtype=np.int64)
    at = 0  # bytes
    for ch, (groups, live_in, kmax) in enumerate(
            sig_mel.pipe_plan(width, npow, head.live)):
        for s in range(steps):
            for g in range(groups):
                for k in range(4):
                    for r in range(8):
                        for c in range(8):
                            b = at + g * CORE_N + k * CORE_K + r * 16 + 2 * c
                            row = (s % cpb) * 32 + 8 * k + r
                            half = groups // 2
                            gi = g % half if split else g
                            col = ch * cp + 8 * gi + c + (
                                npow if split and g >= half else 0)
                            live = ch * cp + 8 * gi < head.live
                            ok = row < head.pack
                            want[b // 2] = (
                                (blocks[s // cpb][0] * head.pack + row)
                                * width + col if ok and live else zero)
                for b in range(at + g * CORE_N + 4 * CORE_K,
                               at + (g + 1) * CORE_N, 2):
                    want[b // 2] = zero
            at += groups * CORE_N
        for k0 in range(0, kmax, sig_mel.PIPE_ROWS):
            rows = min(sig_mel.PIPE_ROWS, kmax - k0)
            for stack in range(3):
                for r in range(rows):
                    for c in range(nmp):
                        b = at + r * nmp * 2 + (
                            ((c // 8) ^ (r % 8)) * 16) + (c % 8) * 2
                        want[b // 2] = mt0 + (
                            stack * npow + ch * cp + k0 + r) * nmp + c
                at += rows * nmp * 2
    assert 2 * idx.size == at
    return idx, want


@pytest.mark.parametrize("which", ["whisper_80", "whisper_128", "nemo"])
def test_stage_stream_lays_each_value_where_the_ring_reads_it(which):
    """Every bf16 value of the stream sits at the byte its stage, column
    group, core matrix, row and column give (the projection's rows at
    their swizzled 16-byte group), and every m_big value of a live column
    and a tap of each K block appears exactly once: none of a dead
    column, none past the taps."""
    head = _head(which)
    idx, want = _decode(head)
    assert (want >= 0).all()
    np.testing.assert_array_equal(idx, want)
    width, npow, _ = _dims(head)
    src = idx[idx < head.m_big.shape[0] * width]
    rows, cols = src // width, src % width
    power = cols % npow if npow != width else cols
    assert power.max() < head.live
    blocks = sig_mel.block_order(head.pair_i)
    n_live = head.live * (2 if npow != width else 1)
    assert src.size == len(blocks) * head.pack * n_live
    assert np.unique(src).size == src.size
    assert sorted(set((rows // head.pack).tolist())) == sorted(
        b for b, _ in blocks)


@pytest.mark.parametrize("which", ["whisper_80", "whisper_128", "nemo"])
def test_stage_stream_holds_the_head_values(which):
    """``pipe_stages`` gathers the head's m_big and mt by ``pipe_index``:
    the stream equals them value for value, zeros elsewhere."""
    head = _head(which)
    width, npow, nmp = _dims(head)
    stream = sig_mel.pipe_stages(head)
    idx = sig_mel.pipe_index(head.m_big.shape[0], width, npow, head.live,
                             sig_mel.block_order(head.pair_i), head.pack,
                             nmp, True)
    src = torch.cat([head.m_big.reshape(-1), head.mt.reshape(-1),
                     head.m_big.new_zeros(1)])
    assert stream.dtype == torch.bfloat16
    assert torch.equal(stream, src[idx])


@pytest.mark.parametrize("which, groups", [
    ("whisper_80", (16, 16, 16, 4)), ("whisper_128", (16, 16, 16, 4)),
    ("nemo", (16, 16, 16, 16))])
def test_pipe_plan_narrows_the_last_chunk(which, groups):
    """Whisper's fourth chunk holds 8 live power columns of 64 (``live``
    200): its stages keep 4 of the 16 column groups (2 re, 2 im), so a
    consumer runs m64n32k16 there; NeMo's 512 N-packed columns fill every
    chunk."""
    head = _head(which)
    width, npow, _ = _dims(head)
    plan = sig_mel.pipe_plan(width, npow, head.live)
    assert tuple(g for g, _, _ in plan) == groups
    assert sum(n for _, n, _ in plan) == head.live
    assert all(k % 16 == 0 and n <= k < n + 16 for _, n, k in plan)


@pytest.mark.parametrize("split, live_in, groups", [
    (True, 8, 4), (True, 16, 4), (True, 24, 16), (True, 64, 16),
    (False, 8, 4), (False, 32, 4), (False, 40, 16), (False, 128, 16)])
def test_pipe_groups(split, live_in, groups):
    assert sig_mel.pipe_groups(split, live_in) == groups


def test_stage_stream_of_other_block_counts_and_f32():
    """A head of three K blocks streams 39 stages a chunk, each of its
    blocks in the given order; the f32 projection ("highest") carries no
    projection rows, so the stream is its stages alone."""
    head = _head("whisper_80")
    width, npow, nmp = _dims(head)
    blocks = [(2, 0), (0, 1), (1, 2)]
    zero = head.m_big.shape[0] * width
    idx = sig_mel.pipe_index(head.m_big.shape[0], width, npow, head.live,
                             blocks, head.pack, nmp, False).numpy()
    stage = 16 * CORE_N // 2
    assert idx.size == 3 * 39 * stage + 39 * 4 * CORE_N // 2
    first = idx[:39 * stage].reshape(39, stage)
    real = first[first != zero]
    rows = real // width // head.pack
    assert list(dict.fromkeys(rows.tolist())) == [2, 0, 1]
    assert (real // width % head.pack < head.pack).all()


def test_stage_slot_keeps_one_stream_per_head(monkeypatch):
    """A head's ``StageSlot`` lays its stream out once and hands it to
    the head's later launches; a head of the other projection dtype gets
    its own beside it, and one with other matrices or fields (made by
    ``dataclasses.replace``) has it laid out anew. ``SigMatrices`` shares
    its slot with its heads and ``whisper_head``, and a copy on another
    device starts an empty one."""
    built = []

    def fake(head):
        built.append((head.mt.dtype, head.pack, head.live))
        return torch.zeros(1)

    monkeypatch.setattr(sig_mel, "stage_stream", fake)
    cached = mel_kernel.sig_matrices(400, 80, 16000.0, 3, 2, CPU)
    assert mel_kernel.whisper_head(400, 80, 16000.0, CPU).stages is \
        cached.stages
    # a private slot, so the cached matrices' stays as it was
    mats = dataclasses.replace(cached, stages=sig_mel.StageSlot())
    bf2, f32 = mats.head(400, 80), mats.head(400, 80, "highest")
    assert bf2.stages is mats.stages and f32.stages is mats.stages
    head = dataclasses.replace(_head("whisper_80"), stages=mats.stages)
    first = mats.stages.stream(bf2)
    assert head.stages.stream(head) is first
    assert mats.stages.stream(f32) is not first
    assert mats.stages.stream(mats.head(400, 80)) is first
    assert len(built) == 2
    mats.stages.stream(dataclasses.replace(bf2, m_big=bf2.m_big.clone()))
    mats.stages.stream(dataclasses.replace(bf2, live=bf2.live - 8))
    assert len(built) == 4
    assert mats.to(CPU) is mats
    assert head.to(torch.device("meta")).stages is not head.stages


def test_cpu_launch_takes_the_slot():
    """On the CPU the plain version runs and leaves the slot empty."""
    head = dataclasses.replace(_head("whisper_80"),
                               stages=sig_mel.StageSlot())
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(1, 16000)).astype(np.float32) * 0.2)
    kw = dict(ks=3, n_frames=98, hop=160, offset=0)
    got = sig_mel.sig_mel(x, head, **kw)
    want = sig_mel.sig_mel(
        x, dataclasses.replace(head, stages=sig_mel.StageSlot()), **kw)
    assert torch.equal(got, want)
    assert not head.stages._streams
