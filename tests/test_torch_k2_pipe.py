"""K2's pipelined 128-frame walk on the CPU (it runs on the card only):
each head's stage stream kept in the head's own ``StageSlot``, with the
bytes ``csrc/sig_pipe.cuh::pipe_bytes`` counts, and the block layout
rule of ``csrc/sig_multi.cu::layout`` (layout 4 with as many ring slots
as fit beside the span, up to 8, where four fit; else 64-frame blocks),
held by a byte model of the rule at the frontends' head sets.
``tests/test_torch_cuda_multihead.py::test_k2_layout_on_the_card`` holds
the built library to the same outcomes."""

import dataclasses
import re

import numpy as np
import pytest
import torch

from melspec_tpu_torch.config import FbankConfig, MelConfig, WHISPER_LARGE_V3
from melspec_tpu_torch.kernels import build, sig_mel, sig_multi
from melspec_tpu_torch.ops import mel_kernel
from melspec_tpu_torch.ops.batch_logmel import BatchLogMel
from melspec_tpu_torch.ops.sig_multihead import (WhisperKaldiFused,
                                                 WhisperKaldiNemoFused)

CPU = torch.device("cpu")
# the headers' constants the model below reads, each as the header states
# it (a change there fails test_model_constants_are_the_headers')
CONSTANTS = {
    "sig_common.cuh": ["constexpr long long kSmemLimit = 232448;",
                       "constexpr int kMaxBlocks = 16;",
                       "constexpr int kStaticSmem = 4 * 2 * kMaxBlocks;",
                       "constexpr unsigned kCoreN = 528;",
                       "constexpr int kChunk = 32;"],
    "sig_pipe.cuh": ["constexpr int kPipeMinSlots = 4;",
                     "constexpr int kPipeMaxSlots = 8;",
                     "constexpr int kPipeBarBytes = 2 * 8 * kPipeMaxSlots;",
                     "constexpr int kPipeSlot = Lay<0>::kStageBytes;"],
}
SMEM_LIMIT, STATIC, CORE_N = 232448, 4 * 2 * 16, 528
MIN_SLOTS, MAX_SLOTS, BARS = 4, 8, 2 * 8 * 8
SLOT = 128 // 8 * CORE_N  # a 128-column stage: 8,448 bytes


def _span_bytes(heads, hop, tile):
    """``span_bytes(3, make_span(hop, span_len(...)))``: the widest head's
    staged samples in hop-long segments padded to 8 mod 16, three bf16
    slices, rounded up to 16 bytes."""
    n = max((tile - 1) * hop + h.pack_off + -(-h.pack // 32) * 32
            for h in heads)
    stride = hop + ((8 - hop % 16) + 16) % 16
    return -(-2 * 3 * -(-n // hop) * stride // 16) * 16


def _cols(head, chunk):
    """A head's power columns of a chunk of ``chunk`` DFT columns."""
    return chunk if head.n_bins_pad == 0 else chunk // 2


def model(heads, hop):
    """``(code, frames, slots, smem)`` of K2's layout rule for
    ``heads`` at ``hop``: 128-frame blocks (code 4) where every head has
    at most 128 padded mel columns and the span, four slots, the tile
    region (any head's power tile [128][cols] or log tile [128][nmp], 4
    bytes a value) and the barriers fit, with as many slots as fit; else
    64-frame blocks (code 1: the span, the four-stage ring of 256-column
    stages and the widest power tile)."""
    nmp = max(h.mt.shape[1] for h in heads)
    tile = max(4 * 128 * max(_cols(h, 128), h.mt.shape[1]) for h in heads)
    fixed = _span_bytes(heads, hop, 128) + tile + BARS + STATIC
    if nmp <= 128 and fixed + MIN_SLOTS * SLOT <= SMEM_LIMIT:
        slots = min(MAX_SLOTS, (SMEM_LIMIT - fixed) // SLOT)
        return 4, 128, slots, fixed + slots * SLOT
    work = max(4 * 2 * SLOT + 4 * 64 * _cols(h, 256) for h in heads)
    return 1, 64, 0, _span_bytes(heads, hop, 64) + work + STATIC


def pipe_bytes(width, npow, live, n_blocks, pack, nmp, bf2):
    """``csrc/sig_pipe.cuh::pipe_bytes`` from ``sig_mel.pipe_plan``: per
    chunk its stages of the kept column groups, then (bf2) the three
    stacks of its projection rows."""
    steps = n_blocks * -(-pack // 32)
    return sum(steps * groups * CORE_N + (3 * kmax * nmp * 2 if bf2 else 0)
               for groups, _, kmax in sig_mel.pipe_plan(width, npow, live))


def _sets():
    return {
        "large_v3": (WhisperKaldiFused(WHISPER_LARGE_V3, device=CPU).heads,
                     160),
        "pair80": (WhisperKaldiFused(device=CPU).heads, 160),
        "nemo_fold": (WhisperKaldiNemoFused(device=CPU).heads, 160),
        "pair8k": (WhisperKaldiFused(
            MelConfig(200, 80, 80, 8000.0),
            FbankConfig(sample_rate=8000.0, apply_cmn=False),
            device=CPU).heads, 80),
        "whisper_128": ((mel_kernel.whisper_head(400, 128, 16000.0, CPU),),
                        160),
        "nemo": ((BatchLogMel(fft_impl="sig", device=CPU).sig_head,), 160),
        "whisper_256": ((mel_kernel.whisper_head(400, 256, 16000.0, CPU),),
                        160),
    }


@pytest.fixture(scope="module")
def sets():
    return _sets()


# (code, frames, slots, smem) of each head set: asr-trio's heads and the
# 80-mel pair fit the ring's four slots with 1,824 bytes to spare; the 8
# kHz pair's short span leaves room for all eight; the NeMo-fold three
# heads (whisper and Kaldi at pack_off 257) would need 232,640 bytes with
# four slots and take 64-frame blocks, as do 256 mel columns
LAYOUTS = {
    "large_v3": (4, 128, 4, 230624),
    "pair80": (4, 128, 4, 230624),
    "nemo_fold": (1, 64, 0, 201792),
    "pair8k": (4, 128, 8, 202016),
    "whisper_128": (4, 128, 4, 230624),
    "nemo": (4, 128, 4, 230624),
    "whisper_256": (1, 64, 0, 167008),
}


def test_model_constants_are_the_headers():
    for name, lines in CONSTANTS.items():
        text = (build.CSRC_DIR / name).read_text()
        for line in lines:
            assert line in text, (name, line)
    assert SLOT == 8448 and SLOT == sig_mel.PIPE_GROUP * 2 * 16


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_k2_layout_rule(sets, name):
    """Layout 4 and its slots, or 64-frame blocks, for each head set; the
    NeMo-fold set's 128-frame block misses by 192 bytes."""
    heads, hop = sets[name]
    assert model(heads, hop) == LAYOUTS[name]
    if name == "nemo_fold":
        fixed = _span_bytes(heads, hop, 128) + 4 * 128 * 128 + BARS + STATIC
        assert fixed + MIN_SLOTS * SLOT - SMEM_LIMIT == 192
        assert (SMEM_LIMIT - fixed) // SLOT == 3


class _Lib:
    """K1's library on the CPU: the stage stream's byte count by the
    model of ``pipe_bytes``."""

    def __init__(self):
        self.asked = []

    def melspec_sig_mel_pipe_bytes(self, *args):
        self.asked.append(args)
        return pipe_bytes(*args)


@pytest.mark.parametrize("name", ["large_v3", "pair80", "nemo_fold",
                                  "pair8k"])
def test_each_head_keeps_its_own_stream(monkeypatch, name):
    """``stage_streams`` lays each head's stream out into the head's own
    ``StageSlot`` (one slot a head, none shared between heads), with the
    bytes ``pipe_bytes`` gives and ``pipe_stages``' values, and a second
    launch takes the same tensors without laying them out again."""
    lib = _Lib()
    monkeypatch.setattr(sig_mel, "_bound", lambda: lib)
    heads, _ = _sets()[name]
    assert len({id(h.stages) for h in heads}) == len(heads)
    first = sig_multi.stage_streams(heads)
    assert len(lib.asked) == len(heads)
    for h, s in zip(heads, first):
        want = pipe_bytes(h.width, h.npow, h.live, len(h.pair_i), h.pack,
                          h.n_mels_pad, True)
        assert s.dtype == torch.bfloat16 and 2 * s.numel() == want
        assert h.stages._streams[torch.bfloat16][3] is s
        assert torch.equal(s, sig_mel.pipe_stages(h))
    again = sig_multi.stage_streams(heads)
    assert all(a is b for a, b in zip(first, again))
    assert len(lib.asked) == len(heads)


def test_stream_bytes_model_matches_the_k1_stream_layout():
    """The byte model of ``pipe_bytes`` is the length of ``pipe_index``'s
    stream, for the split whisper head and the N-packed NeMo head, with
    and without the bf2 projection's rows."""
    for head in (mel_kernel.whisper_head(400, 80, 16000.0, CPU),
                 BatchLogMel(fft_impl="sig", device=CPU).sig_head):
        width = head.m_big.shape[1]
        npow = head.n_bins_pad or width
        for bf2 in (True, False):
            idx = sig_mel.pipe_index(
                head.m_big.shape[0], width, npow, head.live,
                sig_mel.block_order(head.pair_i), head.pack,
                head.mt.shape[1], bf2)
            assert 2 * idx.numel() == pipe_bytes(
                width, npow, head.live, len(head.pair_i), head.pack,
                head.mt.shape[1], bf2)


def test_cpu_launch_counts_nothing_and_leaves_the_slots(sets):
    """On the CPU K2's plain version runs: no launch is counted, pipelined
    or not, and the heads' slots stay empty."""
    heads = tuple(dataclasses.replace(h, stages=sig_mel.StageSlot())
                  for h in sets["pair80"][0])
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(1, 8000)).astype(np.float32) * 0.2)
    before = (sig_multi.launches, sig_multi.pipelined_launches)
    outs, counts = sig_multi.sig_multi(x, heads, ks=3, n_frames=48, hop=160)
    assert (sig_multi.launches, sig_multi.pipelined_launches) == before
    assert counts is None and len(outs) == 2
    assert not any(h.stages._streams for h in heads)


def test_layout_named_tuple_reads_the_library(monkeypatch):
    """``block_layout`` hands the library's seven outputs back as a
    ``Layout``; ``pipelined`` is its 128-frame blocks."""

    class Lib:
        def melspec_sig_multi_layout(self, ks, hop, n, *ptrs):
            outs = ptrs[5:]
            for ref, v in zip(outs, (4, 128, 20736, 128, 4)):
                ref._obj.value = v
            return 230624

    monkeypatch.setattr(sig_multi, "_bound", lambda: Lib())
    got = sig_multi.block_layout(3, 160, [400, 400], [0, 0], [512, 512],
                                 [256, 512], [128, 128])
    assert got == (230624, 128, 20736, 128, 4, 4)
    assert got.pipelined and got.code == 4 and got.slots == 4
    assert not sig_multi.Layout(201792, 64, 10753, 256, 1, 0).pipelined


def test_k2_counter_is_read_with_the_others():
    from melspec_tpu_torch.utils import profiling

    assert ("sig_multi", "pipelined_launches") in profiling.COUNTERS
    assert "sig_multi.pipelined_launches" in profiling.counters()


def test_the_walks_texts_name_layout_4_for_k2():
    """K2's source launches layout 4 and 1 only: no kernel instantiates
    the synchronous walk in 128-frame blocks."""
    text = (build.CSRC_DIR / "sig_multi.cu").read_text()
    assert "sig_multi_kernel<4>" in text and "sig_multi_kernel<1>" in text
    assert "sig_multi_kernel<0>" not in text
    assert not re.search(r"run_head<0>", text)
    common = (build.CSRC_DIR / "sig_common.cuh").read_text()
    assert common.count(
        'static_assert(C == 1 || C == 2, "the synchronous walk\'s layouts")'
    ) == 5
