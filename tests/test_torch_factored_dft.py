"""K1's factored wide-hop path on the CPU: its split table and route,
its host tables against a float64 DFT, a float64 model of the kernel's
data layout (``csrc/sig_factored.cuh``) against the plain version, and
the plain version ``sig_mel_factored_reference`` against ``np.fft`` power
and against JAX's fused kernel (Pallas in interpret mode, as
``tests/test_torch_configs_broad.py`` runs it). The kernel itself runs on
the card (``tests/test_torch_cuda_k1.py``, ``chip_smoke.py``'s phase
``wide_hops``).

Bars: the host tables within their float32 / three-slice bf16 rounding of
float64; the float64 model of the kernel's layout within 1e-6 of the
largest bin of the plain version's power with float64 dots (the model
twiddles in float64, the plain version in float32); the plain version's
power
within 1e-6 of the largest bin of ``np.fft.rfft`` in float64 (24-bit
operands, float32 sums); its whisper values within 2e-5 of the exact
float64-dot dense plain version (``AUTO_TOL``, the fused routes' bar
against float64) and within 3e-5 of JAX's fused kernel (the bar of
``test_torch_configs_broad.py::test_sig_kernel_any_config``)."""

import dataclasses

import numpy as np
import pytest
import torch

from melspec_tpu.ops import mel_kernel as jmk
from melspec_tpu_torch.config import BatchLogMelConfig, FbankConfig
from melspec_tpu_torch.kernels import sig_mel
from melspec_tpu_torch.ops import framing, mel_kernel
from melspec_tpu_torch.ops.batch_logmel import BatchLogMel
from melspec_tpu_torch.ops.fbank import Fbank
from melspec_tpu_torch.ops.windows import hann_periodic

CPU = torch.device("cpu")
WIDE = [(960, 480, 40, 48000.0), (1024, 480, 64, 48000.0),
        (2048, 512, 128, 22050.0)]
SPLITS = {960: (32, 30), 1024: (32, 32), 2048: (64, 32)}


def _signal(seed, b, t, scale=0.2):
    return (np.random.default_rng(seed).normal(size=(b, t))
            * scale).astype(np.float32)


@pytest.mark.parametrize("n,split", [(960, (32, 30)), (1024, (32, 32)),
                                     (2048, (64, 32)), (400, None),
                                     (512, None), (1792, None),
                                     (2047, None), (4096, None)])
def test_factored_split_table(n, split):
    """N = N1 x N2 with N1 32 or 64, 24 < N2 <= 32 and 16 N1 power
    columns (the head's split point): the three wide heads' splits, none
    for the others."""
    assert sig_mel.factored_split(n) == split


def test_block_order_is_the_factored_schedule():
    """The kernel's compiled pair order (f_pair_i, f_pair_j) is K1's
    block order for the whisper heads' pair_i."""
    order = sig_mel.block_order(sig_mel.FACTORED_PAIR_I)
    pi = sig_mel.FACTORED_PAIR_I
    assert [(pi.index(i) + j, i) for i, j in sig_mel.FACTORED_PAIRS] == [
        tuple(o) for o in order]
    assert mel_kernel.sig_matrices(1024, 64, 48000.0, 3, 2,
                                   CPU).pair_i == pi


def _route(head, ks=3):
    """The split ``head_layout`` hands the layout query (the query
    stubbed: it comes from the built kernel)."""
    splits = []

    def layout(*args):
        splits.append(args[-1])
        return sig_mel.Layout(100_000, 64, 1024, args[-1] is not None)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sig_mel, "block_layout", layout)
        sig_mel.head_layout(head, 480, ks)
    return splits[0]


@pytest.mark.parametrize("fft,hop,n_mels,sr", WIDE)
def test_wide_whisper_heads_take_the_factored_route(monkeypatch, fft, hop,
                                                   n_mels, sr):
    """The whisper head carries its DFT size, and the host hands its
    split to K1's layout query, for ``k1_accepts`` too (the query
    stubbed: it comes from the built kernel)."""
    head = mel_kernel.whisper_head(fft, n_mels, sr, CPU)
    assert head.dft_size == fft
    assert _route(head) == SPLITS[fft]
    calls = []

    def layout(*args):
        calls.append(args)
        return sig_mel.Layout(100_000, 64, 1024, True)

    monkeypatch.setattr(sig_mel, "block_layout", layout)
    assert sig_mel.k1_accepts(head, hop=hop)
    assert calls[-1][1] == hop and calls[-1][-1] == SPLITS[fft]


def test_other_heads_keep_the_chunk_walk():
    """No split for the heads whose matrix is not the Hann-windowed DFT
    (Kaldi fbank, NeMo log-mel, each with its preprocessing folded in:
    at n_fft 2048 they carry the float64 FFT path's description instead,
    ``tests/test_torch_factored_ln.py``, and without it keep the chunk
    walk), for another slice schedule, for a whisper head whose size has
    no split, or for matrices without a DFT size (``convert``'s)."""
    kaldi = Fbank(FbankConfig(sample_rate=48000.0, apply_cmn=False),
                  fft_impl="sig", device=CPU).sig_head
    nemo = BatchLogMel(BatchLogMelConfig(sample_rate=48000, n_fft=2048,
                                         win_length=1200, hop_length=480),
                       fft_impl="sig", device=CPU).sig_head
    assert kaldi.dft_size == 2048 and nemo.dft_size == 2048
    assert kaldi.fft is not None and nemo.fft is not None
    assert _route(dataclasses.replace(kaldi, fft=None)) is None
    assert _route(dataclasses.replace(nemo, fft=None)) is None
    two = mel_kernel.sig_matrices(1024, 64, 48000.0, 2, 1, CPU)
    assert _route(two.head(1024, 64), ks=2) is None
    assert _route(mel_kernel.whisper_head(400, 128, 16000.0, CPU)) is None
    assert _route(mel_kernel.whisper_head(1000, 80, 48000.0, CPU)) is None
    bare = mel_kernel.whisper_head(2048, 128, 22050.0, CPU)
    assert _route(sig_mel.SigHead(bare.m_big, bare.pair_i, bare.mt,
                                  bare.n_bins_pad, 2048, 128)) is None


class _Lib:
    """Stands in for the built K1 library's layout query: records its
    arguments and reports layout 3 where a split is given."""

    def __init__(self):
        self.calls = []

    def melspec_sig_mel_layout(self, *args):
        self.calls.append(args[:9])
        factored = args[7] != 0
        args[9]._obj.value = 3 if factored else 2
        args[10]._obj.value = 64 if factored else 32
        args[11]._obj.value = 1024 if factored else 256
        return 200_000


@pytest.mark.parametrize("fft,hop,n_mels,sr", WIDE)
def test_layout_query_and_vad_tile(monkeypatch, fft, hop, n_mels, sr):
    """``block_layout`` hands the library the split and reads its layout
    code; ``k1_vad_tile`` follows the launch's layout (``head_layout``):
    64 on the factored path, 32 in the chunk walk's 32-frame blocks (the
    same matrices without a DFT size), ``TILE_FRAMES`` on the CPU."""
    lib = _Lib()
    monkeypatch.setattr(sig_mel, "_bound", lambda: lib)
    head = mel_kernel.whisper_head(fft, n_mels, sr, CPU)
    cuda = torch.device("cuda")  # passed as a value: nothing runs on it
    assert sig_mel.k1_vad_tile(head, hop, cuda) == 64
    assert lib.calls[-1][1] == hop and lib.calls[-1][7:] == SPLITS[fft]
    bare = dataclasses.replace(head, dft_size=0)
    assert sig_mel.k1_vad_tile(bare, hop, cuda) == 32
    assert lib.calls[-1][7:] == (0, 0)
    assert sig_mel.k1_vad_tile(head, hop, CPU) == sig_mel.TILE_FRAMES
    lay = sig_mel.block_layout(3, hop, fft, 0, head.m_big.shape[1],
                               head.n_bins_pad, head.mt.shape[1],
                               SPLITS[fft])
    assert tuple(lay) == (200_000, 64, 1024, True) and lay.factored


@pytest.mark.parametrize("n", [960, 1024, 2048])
def test_host_tables_against_float64_dft(n):
    """Each table against its float64 definition: the window and the
    twiddles rounded once to float32, F1's and F2's three bf16 slices
    summing to the float64 DFT matrices within 2^-24 of their largest
    entry, F1's kernel layout a permutation of its bin-order rows, the
    row map a bijection of the chunk columns onto the bins."""
    n1, n2 = SPLITS[n]
    fac = sig_mel.factored_dft(n, CPU)
    assert torch.equal(fac.window, torch.as_tensor(hann_periodic(n),
                                                   dtype=torch.float32))
    k1 = np.arange(n1)
    ang = 2 * np.pi * np.outer(k1, np.arange(n2)) / n
    tw = fac.tw.numpy()
    np.testing.assert_array_equal(tw[:, :n2, 0], np.cos(ang).astype(
        np.float32))
    np.testing.assert_array_equal(tw[:, :n2, 1], np.sin(ang).astype(
        np.float32))
    assert not tw[:, n2:].any()
    ang1 = 2 * np.pi * np.outer(k1, k1) / n1
    want1 = np.concatenate([np.cos(ang1), -np.sin(ang1)])
    got1 = fac.f1_rows.double().sum(0).numpy()
    assert np.abs(got1 - want1).max() <= 2.0 ** -24
    for c in range(n1 // 32):
        for w in range(4):
            for h in range(2):
                for g in range(8):
                    assert torch.equal(
                        fac.f1[c, :, 16 * w + 8 * h + g],
                        fac.f1_rows[:, h * n1 + 32 * c + 8 * w + g])
    k2 = -(-n2 // 2)
    ang2 = 2 * np.pi * np.outer(np.arange(n2), np.arange(k2)) / n2
    got2 = fac.f2.double().sum(0).numpy()
    assert np.abs(got2[:n2, :k2] - np.cos(ang2)).max() <= 2.0 ** -24
    assert np.abs(got2[:n2, 16:16 + k2] - np.sin(ang2)).max() <= 2.0 ** -24
    assert not got2[n2:].any() and not got2[:, k2:16].any()
    assert sorted(fac.rowmap.tolist()) == list(range(16 * n1))


def _kernel_model(frame, fac):
    """The kernel's walk of one frame in float64 from its tables as it
    reads them (F1 in chunk layout, the twiddles as float4 pairs, F2, the
    power tile's column 16 r + k2 of each chunk) with the exact sums of
    the six slice pairs: the chunk power tiles, [n1 / 32, 512]."""
    n1, n2 = fac.n1, fac.n2
    x = frame * fac.window.double().numpy()
    b1 = np.zeros((n1, 32))
    b1[:, :n2] = x.reshape(n1, n2)
    xs = [s.double().numpy() for s in sig_mel.bf16_cascade(
        torch.as_tensor(b1, dtype=torch.float32), 3)]
    f1 = fac.f1.double().numpy()                       # [c, 3, 64, n1]
    tw = fac.tw.numpy().reshape(n1, 16, 4)             # (c, s, c, s)
    f2 = fac.f2.double().numpy()
    tiles = []
    for c in range(n1 // 32):
        d1 = sum(f1[c, j] @ xs[i] for i, j in sig_mel.FACTORED_PAIRS)
        rows = np.arange(64)
        k1 = 32 * c + 8 * (rows // 16) + rows % 8
        cs = np.empty((64, 32))
        sn = np.empty((64, 32))
        cs[:, 0::2], sn[:, 0::2] = tw[k1, :, 0], tw[k1, :, 1]
        cs[:, 1::2], sn[:, 1::2] = tw[k1, :, 2], tw[k1, :, 3]
        re = (rows % 16) < 8
        z = np.where(re[:, None], d1 * cs + np.roll(d1, -8, 0) * sn,
                     d1 * cs - np.roll(d1, 8, 0) * sn)
        zs = [s.double().numpy() for s in sig_mel.bf16_cascade(
            torch.as_tensor(z, dtype=torch.float32), 3)]
        d2 = sum(zs[i] @ f2[j] for i, j in sig_mel.FACTORED_PAIRS)
        tile = np.zeros(512)
        for r in range(32):
            w, g = divmod(r, 8)
            top, bot = d2[16 * w + g], d2[16 * w + 8 + g]
            xr = top[:16] + bot[16:]
            xi = bot[:16] - top[16:]
            tile[16 * r : 16 * r + 16] = xr * xr + xi * xi
        tiles.append(tile)
    return np.stack(tiles)


@pytest.mark.parametrize("n", [960, 1024, 2048])
def test_kernel_layout_model_matches_the_plain_power(n):
    """The float64 model of the kernel's layout, its chunk columns put
    back through the row map, within 1e-6 of the largest bin of the
    plain version's power with float64 dots (same slices and tables; the
    model twiddles in float64): the tables' layouts and the row map carry
    the plain version's math."""
    fac = sig_mel.factored_dft(n, CPU)
    x = _signal(n, 1, n)
    tiles = _kernel_model(x[0].astype(np.float64), fac)
    got = np.zeros(16 * fac.n1)
    got[fac.rowmap.numpy()] = tiles.reshape(-1)
    want = sig_mel.factored_power(torch.from_numpy(x), fac, n_frames=1,
                                  hop=n, offset=0,
                                  dot_dtype=torch.float64)[0, 0].numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("fft,hop,n_mels,sr", WIDE)
def test_factored_power_matches_rfft(fft, hop, n_mels, sr):
    """The plain version's power, float32 dots, within 1e-6 of the
    largest bin of the float64 ``np.fft.rfft`` power of the windowed
    frames, at bins below N / 2, on frames from the start, the middle and
    past the end of a clip (zero-padded)."""
    x = _signal(fft + 1, 2, int(0.25 * sr))
    nf = framing.num_frames_batch(x.shape[-1], fft, hop) + 1
    fac = sig_mel.factored_dft(fft, CPU)
    got = sig_mel.factored_power(torch.from_numpy(x), fac, n_frames=nf,
                                 hop=hop, offset=0).numpy()
    pad = np.pad(x.astype(np.float64), ((0, 0), (0, fft)))
    frames = np.stack([pad[:, k * hop : k * hop + fft] for k in range(nf)],
                      axis=1)
    want = np.abs(np.fft.rfft(frames * hann_periodic(fft))) ** 2
    half = fft // 2
    err = np.abs(got[..., :half] - want[..., :half]).max()
    assert err <= 1e-6 * want.max()


@pytest.mark.parametrize("fft,hop,n_mels,sr", WIDE)
@pytest.mark.parametrize("streaming", [False, True])
def test_factored_reference_against_exact_and_jax(fft, hop, n_mels, sr,
                                                  streaming):
    """``sig_mel_factored_reference`` on 2 clips of about 0.5 s: within
    2e-5 of the exact (float64-dot) dense plain version, batch and
    streaming framing, and (batch) within 3e-5 of JAX's
    ``whisper_mel_sig`` in interpret mode."""
    x = _signal(fft + hop, 2, int(0.5 * sr) + 37)
    mats = mel_kernel.sig_matrices(fft, n_mels, sr, 3, 2, CPU)
    t = x.shape[-1]
    offset, nf = ((framing.streaming_frame_offset(fft, hop),
                   framing.num_frames_streaming(t, fft, hop)) if streaming
                  else (0, framing.num_frames_batch(t, fft, hop)))
    xt = torch.from_numpy(x)
    head = mats.head(fft, n_mels)
    got = sig_mel.sig_mel_factored_reference(
        xt, head, n_frames=nf, hop=hop, offset=offset).numpy()
    exact = sig_mel.sig_mel_reference(
        xt, head, ks=3, n_frames=nf, hop=hop, offset=offset,
        dot_dtype=torch.float64).numpy()
    assert got.shape == (2, nf, n_mels)
    assert np.abs(got - exact).max() <= 2e-5
    if not streaming:
        want = np.asarray(jmk.whisper_mel_sig(x, fft, hop, n_mels, sr,
                                              interpret=True))
        np.testing.assert_allclose(got, want, atol=3e-5)


def test_highest_projection_of_the_plain_version():
    """With the float32 projection (``mel_precision="highest"``) the
    plain version stays within 2e-5 of the exact result."""
    fft, hop, n_mels, sr = WIDE[1]
    x = torch.from_numpy(_signal(3, 1, int(0.5 * sr)))
    mats = mel_kernel.sig_matrices(fft, n_mels, sr, 3, 2, CPU)
    nf = framing.num_frames_batch(x.shape[-1], fft, hop)
    head = mats.head(fft, n_mels, "highest")
    got = sig_mel.sig_mel_factored_reference(x, head, n_frames=nf, hop=hop,
                                             offset=0)
    exact = sig_mel.sig_mel_reference(x, head, ks=3, n_frames=nf, hop=hop,
                                      offset=0, dot_dtype=torch.float64)
    assert float((got - exact).abs().max()) <= 2e-5
