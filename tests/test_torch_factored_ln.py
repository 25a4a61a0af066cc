"""K1's float64 FFT path for the Kaldi fbank and NeMo log-mel heads at
n_fft 2048 (44.1, 48, 64 and 80 kHz) on the CPU: the route table, what
the heads carry for it (window, preprocessing, projection in bin order
and its runs of bins), a float64 model of the kernel's FFT (``csrc/sig_fft.cuh``:
1024 = 16 x 16 x 4, two radix-16 passes and the radix-4s, then the
real-input split) and of its exchanges' bank layout, and its plain
version ``sig_mel_fft_reference`` against a numpy float64 pipeline (on
noise, with a DC offset, on JFK resampled to each of those rates and on
high-passed noise) and against JAX's fused kernel (Pallas in interpret
mode). The kernel itself runs on the card (``tests/test_torch_cuda_k1.py``,
``chip_smoke.py``'s phase ``ln_fft``).

Bars: 2e-4 for the ln outputs, the noise bar of the ln heads in
``tests/test_torch_frontend_step.py`` (``BARS["nemo"]``, ``BARS["fbank"]``)
and the ln bar of ``chip_smoke.py`` (``LN_TOL``), against the float64
pipeline and against JAX; 1e-12 of the spectrum's largest value for the
FFT model against ``np.fft``; the projection's rows and runs bit for bit;
the Nyquist row of the filters at most ``sig_mel.NYQUIST_TOL`` (1e-12)."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from melspec_tpu.config import BatchLogMelConfig as JBatchLogMelConfig
from melspec_tpu.config import FbankConfig as JFbankConfig
from melspec_tpu.ops import batch_logmel as jbl
from melspec_tpu.ops import fbank as jfbank
from melspec_tpu_torch import convert
from melspec_tpu_torch.config import BatchLogMelConfig, FbankConfig
from melspec_tpu_torch.io.wav import read_wav_f32le
from melspec_tpu_torch.kernels import build, sig_mel
from melspec_tpu_torch.ops import batch_logmel, fbank, framing, mel_kernel
from melspec_tpu_torch.ops.filterbank import kaldi_filterbank
from melspec_tpu_torch.ops.windows import hann_centered, povey

CPU = torch.device("cpu")
LN_BAR = 2e-4
RATES = (16000, 22050, 44100, 48000, 64000, 80000)
# n_fft of NeMo's head at each rate (25 ms window, 10 ms hop)
NEMO_FFT = {16000: 512, 22050: 1024, 44100: 2048, 48000: 2048, 64000: 2048,
            80000: 2048}
# the rates whose Kaldi and NeMo heads take the float64 FFT path (n_fft
# 2048; at 64 and 80 kHz frames of 1600 and 2000 taps)
FFT_RATES = (44100, 48000, 64000, 80000)
FFT_SMEM = 60_000
TESTDATA = Path(__file__).resolve().parent.parent / "testdata"


def _kaldi_cfg(sr):
    return FbankConfig(sample_rate=float(sr), apply_cmn=False)


def _nemo_cfg(sr):
    return BatchLogMelConfig(sample_rate=sr, n_fft=NEMO_FFT[sr],
                             win_length=int(round(0.025 * sr)),
                             hop_length=int(round(0.01 * sr)))


def _head(kind, sr):
    if kind == "kaldi":
        cfg = _kaldi_cfg(sr)
        return fbank.sig_head(cfg), cfg.frame_shift_samples
    cfg = _nemo_cfg(sr)
    return batch_logmel.sig_head(cfg), cfg.hop_length


def _signal(seed, shape, dc=0.0):
    return (np.random.default_rng(seed).normal(size=shape) * 0.2
            + dc).astype(np.float32)


class _Lib:
    """Stands in for the built K1 library's layout queries: records their
    arguments, reports the 32-frame chunk walk where no split is given and
    ``FFT_SMEM`` bytes for the float64 FFT path."""

    def __init__(self):
        self.calls = []

    def melspec_sig_mel_layout(self, *args):
        self.calls.append(("layout", *args[:9]))
        args[9]._obj.value = 2
        args[10]._obj.value = 32
        args[11]._obj.value = 256
        return 200_000

    def melspec_sig_mel_fft_smem(self, n_mels, nnz):
        self.calls.append(("fft", n_mels, nnz))
        return FFT_SMEM


@pytest.mark.parametrize("kind", ["kaldi", "nemo"])
@pytest.mark.parametrize("sr", RATES)
def test_route_table(monkeypatch, kind, sr):
    """The route ``head_layout`` decides (the built library stood in
    for): the float64 FFT path for Kaldi and NeMo at n_fft 2048 (44.1,
    48, 64 and 80 kHz), its shared memory asked with the head's mel
    columns and run values; at 16 and 22.05 kHz (n_fft 512, 1024) the head carries no
    description and its dense layout is asked with no split. Never the
    tensor-core factored path (its split is for whisper heads), and the
    same for the launch, ``k1_accepts`` and ``k1_vad_tile``."""
    lib = _Lib()
    monkeypatch.setattr(sig_mel, "_bound", lambda: lib)
    head, hop = _head(kind, sr)
    on_fft = sr in FFT_RATES
    assert (head.dft_size, head.fft is not None) == (
        (2048, True) if on_fft else (0, False))
    lay = sig_mel.head_layout(head, hop)
    if on_fft:
        assert tuple(lay) == (FFT_SMEM, 1, 2048, False)
        assert lib.calls[-1] == ("fft", head.n_mels, head.fft.nnz)
    else:
        assert tuple(lay) == (200_000, 32, 256, False)
        assert lib.calls[-1][1:3] == (3, hop)
        assert lib.calls[-1][3:5] == (head.pack, head.pack_off)
        assert lib.calls[-1][8:10] == (0, 0)
    assert sig_mel.k1_accepts(head, hop=hop)
    assert sig_mel.k1_vad_tile(head, hop, torch.device("cuda")) == (
        1 if on_fft else 32)
    assert all(c[0] == ("fft" if on_fft else "layout") for c in lib.calls)


def test_convert_matrices_keep_the_chunk_walk(monkeypatch):
    """JAX's Kaldi head at 48 kHz through ``convert.from_jax_head``
    carries no DFT size and no FFT description, so K1 keeps its chunk
    walk for it (and it equals the port's own head's matrices bit for
    bit)."""
    jf = jfbank.Fbank(JFbankConfig(sample_rate=48000.0, apply_cmn=False),
                      fft_impl="sig")
    head = convert.from_jax_head(np.asarray(jf._sig_m_big), jf._sig_pair_i,
                                 np.asarray(jf._sig_mt), 0, 1200, 0, 80,
                                 "ln_floor", fbank.F32_EPSILON)
    own, _ = _head("kaldi", 48000)
    assert torch.equal(head.m_big, own.m_big) and torch.equal(head.mt,
                                                              own.mt)
    assert head.dft_size == 0 and head.fft is None
    lib = _Lib()
    monkeypatch.setattr(sig_mel, "_bound", lambda: lib)
    assert tuple(sig_mel.head_layout(head, 480)) == (200_000, 32, 256,
                                                     False)
    assert lib.calls[-1][0] == "layout" and lib.calls[-1][8:10] == (0, 0)


@pytest.mark.parametrize("kind", ["kaldi", "nemo"])
@pytest.mark.parametrize("sr", FFT_RATES)
def test_what_the_head_carries(kind, sr):
    """The FFT description: the DFT size, the float64 window of the pack
    taps (Povey, or the interior of NeMo's centred Hann at pack_off), the
    preprocessing (Kaldi's coefficient; none for NeMo)."""
    head, _ = _head(kind, sr)
    f = head.fft
    assert head.dft_size == 2048 and f is not None
    n = head.pack
    if kind == "kaldi":
        want = povey(n)
        assert head.pack_off == 0 and f.preemph == pytest.approx(0.97)
    else:
        cfg = _nemo_cfg(sr)
        want = hann_centered(2048, cfg.win_length)[
            head.pack_off : head.pack_off + n]
        assert head.pack_off == (2048 - n) // 2 and f.preemph is None
    assert f.window.dtype == torch.float64
    assert torch.equal(f.window, torch.as_tensor(want, dtype=torch.float64))
    moved = head.to(CPU)
    assert moved.fft.window.device == CPU and moved.fft.nnz == f.nnz


@pytest.mark.parametrize("kind", ["kaldi", "nemo"])
@pytest.mark.parametrize("sr", FFT_RATES)
def test_bin_order_projection_is_the_npacked_stack(kind, sr):
    """The bin-order bf2 stack (3 x 1024 rows) equals the N-packed
    stack's re rows of bins 0-1023 bit for bit (built from the same
    float64 filters, rounded once), and the Nyquist row of the filters,
    which the FFT path does not compute, is at most 1e-12."""
    head, _ = _head(kind, sr)
    f = head.fft
    npow, rows = 1024, head.mt.shape[0] // 3
    assert tuple(f.mt.shape) == (3 * npow, head.mt.shape[1])
    assert f.mt.dtype == head.mt.dtype == torch.bfloat16
    for s in range(3):
        assert torch.equal(f.mt[s * npow : (s + 1) * npow],
                           head.mt[s * rows : s * rows + npow])
    if kind == "kaldi":
        cfg = _kaldi_cfg(sr)
        filt = kaldi_filterbank(cfg.sample_rate, cfg.fft_size,
                                cfg.num_mel_bins, cfg.low_freq,
                                cfg.effective_high_freq)
    else:
        filt = batch_logmel.nemo_filters(_nemo_cfg(sr))
    assert np.abs(filt[:, npow]).max() <= sig_mel.NYQUIST_TOL


@pytest.mark.parametrize("kind", ["kaldi", "nemo"])
@pytest.mark.parametrize("sr", FFT_RATES)
def test_mel_runs_rebuild_the_projection(kind, sr):
    """Each mel column's run of bins (``mel_runs``: offsets, first bin,
    the F0 and F1 values) rebuilds the bin-order stack's F0 and F1
    columns bit for bit, zero outside the run; ``nnz`` is the runs'
    length in all."""
    f = _head(kind, sr)[0].fft
    half = 1024
    f0 = torch.zeros(half, f.mt.shape[1], dtype=torch.bfloat16)
    f1 = torch.zeros_like(f0)
    off, lo = f.mel_off.tolist(), f.mel_lo.tolist()
    for m in range(f.mt.shape[1]):
        n = off[m + 1] - off[m]
        f0[lo[m] : lo[m] + n, m] = f.f0[off[m] : off[m + 1]]
        f1[lo[m] : lo[m] + n, m] = f.f1[off[m] : off[m + 1]]
    assert torch.equal(f0, f.mt[:half]) and torch.equal(f1,
                                                        f.mt[half:2 * half])
    assert f.nnz == off[-1] == f.f0.numel() == f.f1.numel()


@pytest.mark.parametrize("n_mels", [128, 160])
def test_kaldi_heads_whose_nyquist_weight_is_rounding(n_mels):
    """Kaldi's top filter ends at Nyquist, so its weight there is the
    rounding noise of a zero: 1.2e-14 / 1.4e-14 at 80 kHz with 128 / 160
    mels, under ``NYQUIST_TOL``. Those heads take the FFT path too, and
    its plain version lands within 2e-4 of the port's float64 rdft
    ``Fbank`` on 2 clips of 0.1 s."""
    cfg = FbankConfig(sample_rate=80000.0, num_mel_bins=n_mels,
                      apply_cmn=False)
    filt = kaldi_filterbank(cfg.sample_rate, cfg.fft_size, n_mels,
                            cfg.low_freq, cfg.effective_high_freq)
    assert 1e-14 < np.abs(filt[:, 1024]).max() <= sig_mel.NYQUIST_TOL
    head = fbank.sig_head(cfg)
    assert head.dft_size == 2048 and head.fft is not None
    x = _signal(n_mels, (2, 8000))
    hop = cfg.frame_shift_samples
    nf = framing.num_frames_batch(x.shape[-1], head.pack, hop)
    got = sig_mel.sig_mel_fft_reference(torch.from_numpy(x), head,
                                        n_frames=nf, hop=hop, offset=0)
    want = fbank.Fbank(cfg, dtype=torch.float64, fft_impl="rdft",
                       device=CPU).compute(x)
    assert got.shape == want.shape == (2, nf, n_mels)
    assert float((got.double() - want).abs().max()) <= LN_BAR


def test_heads_the_fft_path_cannot_take(monkeypatch):
    """``sig_fft_head`` gives no description (the head keeps its chunk
    walk) for filters with weight at Nyquist, a DFT of other than 2048
    points or a window longer than it; ``FftHead`` refuses malformed
    fields, and ``head_layout`` a description that does not fit its head
    (``ValueError``: no head meant for the path takes another route)."""
    mt = np.zeros((1025, 128))
    mt[10, 0] = 1.0
    win = np.hanning(1200)
    assert mel_kernel.sig_fft_head(2048, win, mt)[0] == 2048
    bad = mt.copy()
    bad[1024, 3] = 1e-9
    assert mel_kernel.sig_fft_head(2048, win, bad) == (0, None)
    assert mel_kernel.sig_fft_head(1024, np.hanning(800), mt[:513]) == (
        0, None)
    assert mel_kernel.sig_fft_head(2048, np.hanning(2049), mt) == (0, None)
    head, _ = _head("kaldi", 48000)
    f = head.fft
    for kw in (dict(window=f.window.float()), dict(window=f.window[None]),
               dict(mt=f.mt[:-1]), dict(mt=f.mt.float()),
               dict(preemph=-0.5), dict(preemph=float("nan"))):
        with pytest.raises(ValueError):
            sig_mel.FftHead(**{**dict(window=f.window, preemph=f.preemph,
                                      mt=f.mt), **kw})
    monkeypatch.setattr(sig_mel, "_bound", _Lib)
    short = sig_mel.FftHead(f.window[:-1], f.preemph, f.mt)
    for broken in (dataclasses.replace(head, fft=short),
                   dataclasses.replace(head, dft_size=1024),
                   dataclasses.replace(head, out_mode="whisper"),
                   dataclasses.replace(head, pack_off=900),
                   dataclasses.replace(head, mt=head.mt.float()[:1536])):
        with pytest.raises(ValueError, match="float64 FFT path"):
            sig_mel.head_layout(broken, 480)


def test_kernel_constants():
    """The host's DFT size, the group's threads, the groups a block, the
    passes and the twiddle table's rows are the kernel's
    (``csrc/sig_fft.cuh``)."""
    text = (build.CSRC_DIR / "sig_fft.cuh").read_text()
    assert f"constexpr int kFftN = {sig_mel.FFT_N};" in text
    assert (f"constexpr int kFftGroupThreads = {sig_mel.FFT_GROUP_THREADS};"
            in text)
    assert f"constexpr int kFftGroups = {sig_mel.FFT_GROUPS};" in text
    r1, r2, r3 = sig_mel.FFT_RADICES
    assert r1 * r2 * r3 == sig_mel.FFT_N // 2
    assert sig_mel.FFT_GROUP_THREADS * r1 == sig_mel.FFT_N // 2
    rows = sig_mel.fft_twiddles(CPU).shape[0]
    assert rows == sig_mel.FFT_N // 8
    assert f"constexpr int kFftTw = {rows};" in text


# the kernel's exchange layouts (csrc/sig_fft.cuh: fft_at1, fft_at2), in
# complex doubles of the group's buffer, and pass 3's butterflies
AT1 = "return kFftGroupThreads * k1 + (t ^ (4 * (k1 & 1)));"
AT2 = "return kFftGroupThreads * c + 4 * k1 + (a ^ ((k1 >> 1) & 3));"
PASS3 = """  const int j = t & 7, u = t >> 3, v = u & 3;
  klo = j ? j : (u & 4) * 2;
  khi = j ? 16 - j : klo;
  if (j) {
    c[0] = u;
    c[1] = u + 8;
    c[2] = 15 - u;
    c[3] = 7 - u;
  } else if (u & 4) {
    c[0] = v;
    c[1] = v + 4;
    c[2] = 15 - v;
    c[3] = 11 - v;
  } else {
    c[0] = u ? u : 4;
    c[1] = u ? u + 4 : 0;
    c[2] = 16 - c[0];
    c[3] = u ? 12 - u : 8;
  }"""


def _at1(t, k1):
    return 64 * k1 + (t ^ (4 * (k1 & 1)))


def _at2(k1, a, c):
    return 64 * c + 4 * k1 + (a ^ ((k1 >> 1) & 3))


def _pass3(t):
    """``fft_pass3``: thread t's butterflies ``[(k1, c)] * 4`` of pass 3."""
    j, u, v = t & 7, t >> 3, (t >> 3) & 3
    klo = j if j else (u & 4) * 2
    khi = 16 - j if j else klo
    if j:
        c = [u, u + 8, 15 - u, 7 - u]
    elif u & 4:
        c = [v, v + 4, 15 - v, 11 - v]
    else:
        c0 = u if u else 4
        c = [c0, u + 4 if u else 0, 16 - c0, 12 - u if u else 8]
    return [(klo, c[0]), (klo, c[1]), (khi, c[2]), (khi, c[3])]


# thread 0's butterflies 1 and 3 (k1 0, c 0 and 8): the bins they give
# among themselves, each pair (Z[k], Z[1024 - k]) or one bin alone
SPECIAL = [(0, None), (512, None), (256, 768), (128, 896), (384, 640)]


def _split_pairs():
    """``[(k, 1024 - k or None)]``: the bins of every thread's split, in
    the kernel's order: its butterflies 0 and 1 (``Z[k] = v[4 b + d]``,
    ``k = k1 + 16 c + 256 d``) with their mirrors, thread 0's butterfly 1
    replaced by ``SPECIAL``."""
    out = []
    for t in range(64):
        for b, (k1, c) in enumerate(_pass3(t)[:2]):
            if t == 0 and b == 1:
                out += SPECIAL
            else:
                out += [(k1 + 16 * c + 256 * d, 1024 - k1 - 16 * c - 256 * d)
                        for d in range(4)]
    return out


def _exchanges():
    """Each access of the group's buffer in a frame: ``name -> [i, t]``,
    the place thread t reads or writes in its i-th access: exchange 1
    (thread t writes ``B[t][k1]``, thread (k1, a) = (t / 4, t mod 4) reads
    ``B[a + 4 b][k1]``), exchange 2 (thread (k1, a) writes ``C[k1,a][c]``,
    pass 3's thread reads ``C[k1,a][c]`` of its butterflies
    (``_pass3``)); then the Z each thread's butterflies give (``Z[k1 + 16
    c + 256 d]`` at ``v[4 b + d]``), which no exchange moves, and the bins
    whose power each writes."""
    t = np.arange(64)
    k1a, a = t >> 2, t & 3
    p3 = [_pass3(i) for i in range(64)]
    bins = [k for pair in _split_pairs() for k in pair if k is not None]
    return {
        "write_1": np.array([_at1(t, j) for j in range(16)]),
        "read_1": np.array([_at1(a + 4 * b, k1a) for b in range(16)]),
        "write_2": np.array([_at2(k1a, a, c) for c in range(16)]),
        "read_2": np.array([[_at2(*p3[i][n // 4][:1], n % 4,
                                  p3[i][n // 4][1]) for i in range(64)]
                            for n in range(16)]),
        "pass_3": np.array([[k1 + 16 * c + 256 * d for k1, c in p3[i]
                             for d in range(4)] for i in range(64)]).T,
        "power": np.array(bins).reshape(64, 16).T,
    }


@pytest.mark.parametrize("name", ["write_1", "read_1", "write_2", "read_2",
                                  "pass_3", "power"])
def test_exchange_layout(name):
    """Each exchange of the kernel's FFT covers the group's 1024 places
    once, and in every access no 8 consecutive threads (a quarter warp,
    which a 16-byte access serves at once) meet on one of the 8 16-byte
    bank groups twice: no bank conflict; pass 3's butterflies give each Z
    once, each beside its mirror ``Z[1024 - k]`` (``v[4 (b + 2) + 3 - d]``
    beside ``v[4 b + d]``; thread 0's butterflies 1 and 3 pair among
    themselves), so the split needs no exchange; the power is written once
    a bin. The layouts are the kernel's text."""
    text = (build.CSRC_DIR / "sig_fft.cuh").read_text()
    assert AT1 in text and AT2 in text and PASS3 in text
    at = _exchanges()[name]
    assert sorted(at.reshape(-1)) == list(range(1024))
    if name == "pass_3":
        for i in range(64):
            z = at[:, i].reshape(4, 4)
            mirror = (1024 - z[2:, ::-1]) % 1024
            assert (z[0] == mirror[0]).all()
            assert (z[1] == mirror[1]).all() == (i != 0)
        assert sorted(at[[4, 5, 6, 7, 12, 13, 14, 15], 0]) == sorted(
            k for pair in SPECIAL for k in pair if k is not None)
    elif name != "power":
        quarters = at.reshape(at.shape[0], 8, 8) % 8
        assert all(len(set(qq)) == 8 for row in quarters for qq in row)


def _fft4(v, axis):
    """The kernel's radix-4 (``fft4``) along ``axis`` of length 4."""
    v0, v1, v2, v3 = np.moveaxis(v, axis, 0)
    a0, a1, a2, a3 = v0 + v2, v0 - v2, v1 + v3, -1j * (v1 - v3)
    return np.moveaxis(np.stack([a0 + a2, a1 + a3, a0 - a2, a1 - a3]), 0,
                       axis)


def _fft16(v, axis):
    """The kernel's radix-16 in registers (``fft16``) along ``axis``:
    radix-4s over ``n2`` of ``n = n1 + 4 n2``, the twiddles ``W16^(n1
    k1)``, radix-4s over ``n1``; ``V[k1 + 4 k2]`` in natural order."""
    v = np.moveaxis(v, axis, -1)
    x = v.reshape(*v.shape[:-1], 4, 4)  # [n2, n1]
    y = _fft4(x, -2)  # [k1, n1]
    e = np.arange(4)[:, None] * np.arange(4)[None, :]
    y = y * np.exp(-2j * np.pi * e / 16)
    out = _fft4(y, -1).swapaxes(-1, -2)  # [k2, k1]
    return np.moveaxis(out.reshape(v.shape), -1, axis)


def _powers(w):
    """``[16, len(w)]``: the powers ``w^0 .. w^15`` of each base, each the
    previous times the base, as the kernel turns its values (``fft_turn``)."""
    out = [np.ones_like(w), w]
    for _ in range(14):
        out.append(out[-1] * w)
    return np.stack(out)


def _group_fft(y):
    """A float64 model of the kernel's FFT (``csrc/sig_fft.cuh``): the
    2048 real taps as 1024 complex values ``z[t + 64 n]``, pass 1's
    radix-16 over ``n`` turned by the powers of thread t's base
    ``W1024^t``, pass 2's radix-16 over ``b`` of ``t = a + 4 b`` turned by
    the powers of ``W64^a``, the radix-4s over ``a``, then the real-input
    split of the bins below 1024 in the kernel's pairs ``k``, ``1024 - k``
    (``_split_pairs``) with ``W2048^k = W2048^(k mod 256) W8^(k / 256)``
    (``fft_twiddles``; ``FFT_RADICES``)."""
    tab = sig_mel.fft_twiddles(CPU).numpy()
    tw = tab[:, 0] + 1j * tab[:, 1]
    z = y[..., 0::2] + 1j * y[..., 1::2]
    lead = z.shape[:-1]
    b = _fft16(z.reshape(*lead, 16, 64), -2)  # [k1, t]
    b = b * _powers(tw[2 * np.arange(64)])  # [k1, t]
    c = _fft16(b.reshape(*lead, 16, 16, 4), -2)  # [k1, c, a]
    c = c * _powers(tw[32 * np.arange(4)])  # [c, a]
    zz = _fft4(c, -1)  # [k1, c, d]: Z[k1 + 16 c + 256 d]
    zn = np.moveaxis(zz, (-3, -2, -1), (-1, -2, -3)).reshape(*lead, 1024)
    out = np.empty((*lead, 1024), dtype=complex)
    for k, kb in _split_pairs():
        # W2048^k: the table's W2048^(k1 + 16 c) times W8^d, or a constant
        w = np.exp(-2j * np.pi * k / 2048) if kb is None or k % 128 == 0 \
            else tw[k % 256] * np.exp(-2j * np.pi * (k // 256) / 8)
        za = zn[..., k]
        zb = za if kb is None else zn[..., kb]
        er, ei = 0.5 * (za.real + zb.real), 0.5 * (za.imag - zb.imag)
        orr, oi = 0.5 * (za.imag + zb.imag), 0.5 * (zb.real - za.real)
        tr, ti = w.real * orr - w.imag * oi, w.real * oi + w.imag * orr
        out[..., k] = (er + tr) + 1j * (ei + ti)
        if kb is not None:
            out[..., kb] = (er - tr) + 1j * (ti - ei)
    return out


def test_fft_model_against_numpy():
    """The kernel's FFT, modelled in float64 on frames of 1200 and 2048
    taps, equals ``np.fft.rfft`` on the bins below 1024 within 1e-12 of
    the spectrum's largest magnitude."""
    rng = np.random.default_rng(11)
    y = np.zeros((3, 2048))
    y[0, :1200] = rng.normal(size=1200)
    y[1] = rng.normal(size=2048)
    y[2, :1102] = rng.normal(size=1102) + 0.5
    got = _group_fft(y)
    want = np.fft.rfft(y)[..., :1024]
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def test_kaldi_taps_are_the_preproc_matrix():
    """``fft_taps`` with Kaldi's coefficient is the window times
    ``kaldi_preproc_matrix`` applied to each frame (DC removal, in-frame
    preemphasis, the first tap kept), in float64 within 1e-12; without
    one, the window times the taps."""
    x = torch.from_numpy(_signal(3, (2, 5000), 0.5))
    win = torch.as_tensor(povey(1200), dtype=torch.float64)
    kw = dict(n_frames=8, hop=480, start=7, window=win)
    got = sig_mel.fft_taps(x, preemph=0.97, **kw)
    frames = x.double()[:, 7 : 7 + 7 * 480 + 1200].unfold(-1, 1200, 480)
    pre = torch.as_tensor(fbank.kaldi_preproc_matrix(1200, 0.97))
    want = (frames @ pre.T) * win
    assert float((got - want).abs().max()) <= 1e-12
    plain = sig_mel.fft_taps(x, preemph=None, **kw)
    assert torch.equal(plain, frames * win)


def _numpy_pipeline(kind, sr, x):
    """float64 numpy: frames, (Kaldi) DC removal and in-frame
    preemphasis, the Povey or centred Hann window, ``rfft`` at 2048,
    power, the filters, ln."""
    x = x.astype(np.float64)
    if kind == "kaldi":
        cfg = _kaldi_cfg(sr)
        n, hop = cfg.frame_length_samples, cfg.frame_shift_samples
        nf = framing.num_frames_batch(x.shape[-1], n, hop)
        fr = np.stack([x[:, k * hop : k * hop + n] for k in range(nf)], 1)
        d = fr - fr.mean(-1, keepdims=True)
        y = d.copy()
        y[..., 1:] = d[..., 1:] - cfg.preemphasis * d[..., :-1]
        spec = np.fft.rfft(y * povey(n), n=2048)
        filt = kaldi_filterbank(cfg.sample_rate, 2048, cfg.num_mel_bins,
                                cfg.low_freq, cfg.effective_high_freq)
        e = (np.abs(spec) ** 2) @ filt.T
        return np.log(np.maximum(e, fbank.energy_floor(cfg)))
    cfg = _nemo_cfg(sr)
    hop = cfg.hop_length
    xp = np.pad(x, ((0, 0), (1024, 1024)))
    nf = framing.num_frames_centered(x.shape[-1], hop)
    fr = np.stack([xp[:, k * hop : k * hop + 2048] for k in range(nf)], 1)
    spec = np.fft.rfft(fr * hann_centered(2048, cfg.win_length))
    e = (np.abs(spec) ** 2) @ batch_logmel.nemo_filters(cfg).T
    return np.log(e + cfg.log_zero_guard)


def _fft_plain(kind, sr, x):
    head, hop = _head(kind, sr)
    xt = torch.from_numpy(x)
    if kind == "kaldi":
        nf = framing.num_frames_batch(x.shape[-1], head.pack, hop)
    else:
        nf = framing.num_frames_centered(x.shape[-1], hop)
        xt = torch.nn.functional.pad(xt, (1024, 1024))
    return sig_mel.sig_mel_fft_reference(xt, head, n_frames=nf, hop=hop,
                                         offset=0)


@pytest.mark.parametrize("kind", ["kaldi", "nemo"])
@pytest.mark.parametrize("sr", FFT_RATES)
@pytest.mark.parametrize("dc", [0.0, 0.5])
def test_plain_version_against_float64_numpy(kind, sr, dc):
    """The FFT path's plain version (float64 preprocessing, window and
    DFT, the power rounded once, the bf2 projection) within 2e-4 of the
    float64 numpy pipeline on 2 clips of 0.3 s, on noise and with a 0.5
    DC offset (which Kaldi's DC removal takes out per frame)."""
    x = _signal(sr + int(10 * dc), (2, int(0.3 * sr) + 37), dc)
    got = _fft_plain(kind, sr, x).numpy()
    want = _numpy_pipeline(kind, sr, x)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= LN_BAR


def _resampled_jfk(sr):
    """JFK (16 kHz) band-limited to ``sr`` by zero-padding its spectrum:
    nothing above 8 kHz, as upsampled speech."""
    x = read_wav_f32le(TESTDATA / "jfk_f32le.wav").astype(np.float64)
    n = int(round(len(x) * sr / 16000))
    return np.fft.irfft(np.fft.rfft(x), n) * (n / len(x))


def _high_passed(sr, n, seed):
    """White noise with every bin below 300 Hz removed."""
    spec = np.fft.rfft(np.random.default_rng(seed).normal(size=n) * 0.1)
    spec[: int(300 * n / sr)] = 0
    return np.fft.irfft(spec, n)


@pytest.mark.parametrize("kind", ["kaldi", "nemo"])
@pytest.mark.parametrize("sr", FFT_RATES)
@pytest.mark.parametrize("clip", ["jfk", "high_passed"])
def test_plain_version_on_real_and_tilted_clips(kind, sr, clip):
    """On JFK resampled to 44.1-80 kHz (an empty band above 8 kHz) and
    on noise high-passed at 300 Hz (empty low bins, which Kaldi's
    preemphasis lowers further), the FFT path's plain version stays within
    2e-4 of the float64 numpy pipeline on every bin: in float64 the
    spectrum's rounding does not reach the near-empty bins."""
    x = _resampled_jfk(sr)
    if clip == "high_passed":
        x = _high_passed(sr, len(x), sr)
    x = x[None].astype(np.float32)
    got = _fft_plain(kind, sr, x).numpy()
    want = _numpy_pipeline(kind, sr, x)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= LN_BAR


@pytest.mark.parametrize("kind", ["kaldi", "nemo"])
def test_plain_version_against_jax_sig_route(kind):
    """The FFT path's plain version within 2e-4 of JAX's ``Fbank`` /
    ``BatchLogMel`` on ``fft_impl="sig"`` (its fused Pallas kernel in
    interpret mode) at 48 kHz, on 2 clips of 0.25 s. (At 44.1 kHz JAX
    has no macro-row geometry, so no sig route.)"""
    x = _signal(77, (2, 12000))
    got = _fft_plain(kind, 48000, x).numpy()
    if kind == "kaldi":
        want = np.asarray(jfbank.Fbank(JFbankConfig(
            sample_rate=48000.0, apply_cmn=False), fft_impl="sig")
            .compute(x))
    else:
        c = _nemo_cfg(48000)
        want = np.asarray(jbl.BatchLogMel(JBatchLogMelConfig(
            sample_rate=48000, n_fft=2048, win_length=c.win_length,
            hop_length=c.hop_length), fft_impl="sig").compute(x))
        want = np.swapaxes(want, -1, -2)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= LN_BAR


@pytest.mark.parametrize("kind", ["kaldi", "nemo"])
@pytest.mark.parametrize("sr", [64000, 80000])
def test_plain_version_against_jax_sig_route_at_64_and_80k(kind, sr):
    """As ``test_plain_version_against_jax_sig_route``, at 64 and 80 kHz
    (frames of 1600 and 2000 taps inside the 2048-point DFT; hops 640 and
    800), on 2 clips of 0.1 s."""
    x = _signal(sr + 77, (2, sr // 10))
    got = _fft_plain(kind, sr, x).numpy()
    if kind == "kaldi":
        want = np.asarray(jfbank.Fbank(JFbankConfig(
            sample_rate=float(sr), apply_cmn=False), fft_impl="sig")
            .compute(x))
    else:
        c = _nemo_cfg(sr)
        want = np.asarray(jbl.BatchLogMel(JBatchLogMelConfig(
            sample_rate=sr, n_fft=2048, win_length=c.win_length,
            hop_length=c.hop_length), fft_impl="sig").compute(x))
        want = np.swapaxes(want, -1, -2)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= LN_BAR


@pytest.mark.parametrize("kind", ["kaldi", "nemo"])
def test_cpu_route_stays_the_dense_plain_version(kind):
    """On the CPU these heads keep ``sig_mel_reference`` with the float64
    dot (the route the CPU always took), whatever the card's route; no
    kernel launches."""
    x = torch.from_numpy(_signal(5, (2, 9000)))
    before = (sig_mel.launches, sig_mel.fft_launches)
    if kind == "kaldi":
        front = fbank.Fbank(_kaldi_cfg(48000), fft_impl="sig", device=CPU)
        got, sig, hop = front.compute(x), x, front.frame_shift
    else:
        cfg = _nemo_cfg(48000)
        front = batch_logmel.BatchLogMel(cfg, fft_impl="sig", device=CPU)
        got = front.compute(x).transpose(-1, -2)
        sig, hop = torch.nn.functional.pad(x, (1024, 1024)), cfg.hop_length
    want = sig_mel.sig_mel_reference(
        sig, front.sig_head, ks=3, n_frames=got.shape[1], hop=hop, offset=0,
        dot_dtype=torch.float64)
    assert torch.equal(got, want)
    assert (sig_mel.launches, sig_mel.fft_launches) == before
