"""K1 and K2 at DFT widths other than 512 on the CPU: the sig route's
plain version against JAX's interpret-mode kernel at the 256- and
1024-column whisper heads (the 1e-5 gate of tests/test_torch_mel.py), and
the host side of the kernels' width walk: the shape check both kernels
apply, the live-column count the host builders give each head, and
``k2_accepts`` (its
shared-memory figure comes from the built kernel, so it is stubbed)."""

import dataclasses

import numpy as np
import pytest
import torch

from melspec_tpu.ops import mel_kernel as jmk
from melspec_tpu_torch.config import BatchLogMelConfig, FbankConfig
from melspec_tpu_torch.kernels import sig_mel, sig_multi
from melspec_tpu_torch.ops import batch_logmel, fbank, mel_kernel
from melspec_tpu_torch.ops.sig_multihead import nemo_fold_head

CPU = torch.device("cpu")
WIDTH_CONFIGS = [(200, 80, 80, 8000.0), (256, 96, 32, 16000.0),
                 (1024, 256, 80, 22050.0)]


@pytest.mark.parametrize("fft,hop,n_mels,sr", WIDTH_CONFIGS)
@pytest.mark.parametrize("streaming", [False, True])
def test_sig_matches_jax_at_256_and_1024_columns(fft, hop, n_mels, sr,
                                                 streaming):
    x = (np.random.default_rng(fft + hop).normal(size=(2, fft + 9 * hop + 5))
         * 0.2).astype(np.float32)
    want = np.asarray(jmk.whisper_mel_sig(x, fft, hop, n_mels, sr,
                                          streaming=streaming,
                                          interpret=True))
    got = mel_kernel.whisper_mel_sig(x, fft, hop, n_mels, sr,
                                     streaming=streaming, device=CPU).numpy()
    assert mel_kernel.whisper_head(fft, n_mels, sr, CPU).m_big.shape[1] in (
        256, 1024)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5


@pytest.mark.parametrize("head,live", [
    (lambda: mel_kernel.whisper_head(400, 80, 16000.0, CPU), 200),
    (lambda: mel_kernel.whisper_head(200, 80, 8000.0, CPU), 104),
    (lambda: mel_kernel.whisper_head(1024, 80, 22050.0, CPU), 512),
    (lambda: fbank.sig_head(FbankConfig()), 512),
    (lambda: fbank.sig_head(FbankConfig(sample_rate=8000.0)), 256),
    (lambda: batch_logmel.sig_head(BatchLogMelConfig()), 512)],
    ids=["whisper400", "whisper200", "whisper1024", "kaldi", "kaldi8k",
         "nemo"])
def test_live_columns(head, live):
    """Past the last power column whose DFT columns hold a nonzero value
    the kernels skip the walk: whisper's split heads end at their last
    projected bin (fft / 2, rounded up to 8), the N-packed heads use every
    column. The count is the first nonzero-free column, rounded up to 8."""
    h = head()
    assert sig_mel.live_columns(h.m_big, h.n_bins_pad) == live
    assert h.live == live
    nz = (h.m_big != 0).any(dim=0)
    if h.n_bins_pad:
        nz = nz[: h.n_bins_pad] | nz[h.n_bins_pad:]
    assert not nz[live:].any() and nz[live - 8 : live].any()


@pytest.mark.parametrize("build", [
    lambda: mel_kernel.whisper_head(400, 80, 16000.0, CPU),
    lambda: mel_kernel.whisper_head(200, 80, 8000.0, CPU, pack_off=3),
    lambda: mel_kernel.sig_matrices(400, 128, 16000.0, 3, 2, CPU),
    lambda: mel_kernel.sig_matrices(1024, 80, 22050.0, 3, 2, CPU),
    lambda: fbank.sig_head(FbankConfig()),
    lambda: fbank.sig_head(FbankConfig(sample_rate=8000.0)),
    lambda: batch_logmel.sig_head(BatchLogMelConfig()),
    lambda: nemo_fold_head(BatchLogMelConfig())],
    ids=["whisper400", "whisper200_off", "mats400", "mats1024", "kaldi",
         "kaldi8k", "nemo", "nemo_fold"])
def test_live_is_counted_once_where_the_head_is_built(build, monkeypatch):
    """Each host builder gives its head (or whisper matrices) the live
    count of its CPU matrix, and the head carries it to the device
    without a recount: the wrappers pass it to the kernels, so a launch
    reads nothing back from the card."""
    h = build()
    assert h.live == sig_mel.live_columns(h.m_big, h.n_bins_pad)
    assert 0 < h.live <= h.m_big.shape[1] and h.live % 8 == 0

    def recount(*args):
        raise AssertionError("live counted again")

    monkeypatch.setattr(sig_mel, "live_columns", recount)
    assert h.to(torch.device("meta")).live == h.live
    # the heads the wrappers launch carry it as they are made
    head = (dataclasses.replace(h, stages=sig_mel.StageSlot())
            if isinstance(h, sig_mel.SigHead) else h.head(h.dft_size, 80))
    assert head.live == h.live


def test_live_columns_follow_an_edit():
    m = torch.zeros(64, 512, dtype=torch.bfloat16)
    m[3, 10] = 1.0
    assert sig_mel.live_columns(m, 256) == 16
    assert sig_mel.live_columns(m, 0) == 16
    m[5, 256 + 100] = 1.0  # an im column: power column 100
    assert sig_mel.live_columns(m, 256) == 104
    assert sig_mel.live_columns(torch.zeros(8, 256, dtype=torch.bfloat16),
                                0) == 0


@pytest.mark.parametrize("width,split,nmp,ok", [
    (256, 128, 128, True), (256, 0, 128, True), (512, 256, 256, True),
    (512, 0, 128, True), (1024, 512, 128, True), (1024, 0, 256, True),
    (768, 384, 128, False), (512, 128, 128, False), (2048, 1024, 128, True),
    (2048, 0, 256, True), (512, 256, 384, False)])
def test_shape_refusal(width, split, nmp, ok):
    """K1 takes 256-, 512-, 1024- and 2048-column heads split at width / 2
    or N-packed, with at most 256 padded mel columns; K2 the same up to
    1024 columns."""
    refusal = sig_mel.shape_refusal(width, split, nmp, "K1")
    assert (refusal is None) == ok
    if not ok:
        assert "K1" in refusal
    k2 = sig_mel.shape_refusal(width, split, nmp, "K2", sig_multi.WIDTHS)
    assert (k2 is None) == (ok and width <= 1024)
    if k2 is not None:
        assert "K2" in k2


@pytest.mark.parametrize("smem,ok", [(100_000, True),
                                     (sig_mel.MAX_SMEM_BYTES + 1, False)])
def test_k2_accepts(monkeypatch, smem, ok):
    """``k2_accepts`` applies the launch's refusals: the head count, each
    head's shape and K2's shared-memory figure (stubbed here: it comes
    from the built kernel)."""
    calls = []

    def stub(*args):
        calls.append(args)
        return smem, 10_000

    monkeypatch.setattr(sig_multi, "_smem_bytes", stub)
    w = mel_kernel.whisper_head(200, 80, 8000.0, CPU)
    k = fbank.sig_head(FbankConfig(sample_rate=8000.0))
    assert sig_multi.k2_accepts((w, k), hop=80) == ok
    ks, hop, packs, pack_offs, widths, npows, nmps = calls[-1]
    assert (ks, hop, widths, npows, nmps) == (3, 80, [256, 256], [128, 256],
                                              [128, 128])
    assert not sig_multi.k2_accepts((w,) * 5, hop=80)
    wide = mel_kernel.whisper_head(600, 80, 24000.0, CPU)  # 768 columns
    n = len(calls)
    assert not sig_multi.k2_accepts((w, wide), hop=80)
    assert len(calls) == n  # refused by its width, before the figure
