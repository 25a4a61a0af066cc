"""K1's float64 FFT path for the Kaldi fbank and NeMo log-mel heads at
n_fft 1024 (22.05 to 40 kHz, NeMo's TTS mel among them) and 2048 (44.1,
48, 64 and 80 kHz) on the CPU: the route table, what the heads carry for
it (window, preprocessing, projection in bin order and its runs of
bins), float64 models of the kernel's two instances (``csrc/sig_fft.cuh``:
at 2048 points 1024 = 16 x 16 x 4, two radix-16 passes and the
radix-4s; at 1024 points a frame a warp, 512 = 16 x 16 x 2, the warp's
buffer simulated place by place; then the real-input split) and of
their exchanges' bank layouts, and its plain version
``sig_mel_fft_reference`` against a numpy float64 pipeline (on noise,
with a DC offset, on JFK resampled to each of those rates and on
high-passed noise), against ``torch.fft.rfft`` and the head's own chunk
walk's plain version at 1024 points, and against JAX's fused kernel
(Pallas in interpret mode). The kernel itself runs on the card
(``tests/test_torch_cuda_k1.py``, ``chip_smoke.py``'s phase ``ln_fft``).

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
# 1024 at 22.05 kHz, 2048 above; at 64 and 80 kHz frames of 1600 and 2000
# taps); the DFT's size at each is NEMO_FFT's (Kaldi's too)
FFT_RATES = (22050, 44100, 48000, 64000, 80000)
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

    def melspec_sig_mel_fft_smem(self, n, n_mels, nnz):
        self.calls.append(("fft", n, n_mels, nnz))
        return FFT_SMEM


@pytest.mark.parametrize("kind", ["kaldi", "nemo"])
@pytest.mark.parametrize("sr", RATES)
def test_route_table(monkeypatch, kind, sr):
    """The route ``head_layout`` decides (the built library stood in
    for): the float64 FFT path for Kaldi and NeMo at n_fft 1024 (22.05
    kHz) and 2048 (44.1, 48, 64 and 80 kHz), its shared memory asked of
    the instance of the head's size with the head's mel columns and run
    values; at 16 kHz (n_fft 512) the head carries no description and its
    dense layout is asked with no split. Never the tensor-core factored
    path (its split is for whisper heads), and the same for the launch,
    ``k1_accepts`` and ``k1_vad_tile``."""
    lib = _Lib()
    monkeypatch.setattr(sig_mel, "_bound", lambda: lib)
    head, hop = _head(kind, sr)
    on_fft = sr in FFT_RATES
    n = NEMO_FFT[sr]
    assert (head.dft_size, head.fft is not None) == (
        (n, True) if on_fft else (0, False))
    lay = sig_mel.head_layout(head, hop)
    if on_fft:
        assert head.fft.size == n
        assert tuple(lay) == (FFT_SMEM, 1, n, False)
        assert lib.calls[-1] == ("fft", n, head.n_mels, head.fft.nnz)
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
    f, size = head.fft, NEMO_FFT[sr]
    assert head.dft_size == size and f is not None and f.size == size
    n = head.pack
    if kind == "kaldi":
        want = povey(n)
        assert head.pack_off == 0 and f.preemph == pytest.approx(0.97)
    else:
        cfg = _nemo_cfg(sr)
        want = hann_centered(size, cfg.win_length)[
            head.pack_off : head.pack_off + n]
        assert head.pack_off == (size - n) // 2 and f.preemph is None
    assert f.window.dtype == torch.float64
    assert torch.equal(f.window, torch.as_tensor(want, dtype=torch.float64))
    moved = head.to(CPU)
    assert moved.fft.window.device == CPU and moved.fft.nnz == f.nnz


@pytest.mark.parametrize("kind", ["kaldi", "nemo"])
@pytest.mark.parametrize("sr", FFT_RATES)
def test_bin_order_projection_is_the_npacked_stack(kind, sr):
    """The bin-order bf2 stack (3 x n / 2 rows) equals the N-packed
    stack's re rows of the bins below n / 2 bit for bit (built from the
    same float64 filters, rounded once), and the Nyquist row of the
    filters, which the FFT path does not compute, is at most 1e-12."""
    head, _ = _head(kind, sr)
    f = head.fft
    npow, rows = NEMO_FFT[sr] // 2, head.mt.shape[0] // 3
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
    length in all, ``bins`` the first bin past every run."""
    f = _head(kind, sr)[0].fft
    half = NEMO_FFT[sr] // 2
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
    ends = [lo[m] + off[m + 1] - off[m] for m in range(f.mt.shape[1])]
    assert f.bins == max(ends) <= half
    assert not f.mt[f.bins : half].any()


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
    """``sig_fft_head`` gives a description at 1024 and 2048 points and
    none (the head keeps its chunk walk) for filters with weight at
    Nyquist, a DFT of other than 1024 or 2048 points (512: NeMo's and
    Kaldi's 16 kHz heads) or a window longer than it; ``FftHead`` refuses
    malformed fields, a projection of another size and a window longer
    than its DFT, and ``head_layout`` a description that does not fit its
    head (``ValueError``: no head meant for the path takes another route),
    among them a description of one size on a head of the other."""
    mt = np.zeros((1025, 128))
    mt[10, 0] = 1.0
    win = np.hanning(1200)
    assert mel_kernel.sig_fft_head(2048, win, mt)[0] == 2048
    bad = mt.copy()
    bad[1024, 3] = 1e-9
    assert mel_kernel.sig_fft_head(2048, win, bad) == (0, None)
    size, f1024 = mel_kernel.sig_fft_head(1024, np.hanning(800), mt[:513])
    assert size == 1024 and f1024.size == 1024 and f1024.bins == 11
    over = mt[:513].copy()
    over[512, 7] = 1e-9
    assert mel_kernel.sig_fft_head(1024, np.hanning(800), over) == (0, None)
    assert mel_kernel.sig_fft_head(512, np.hanning(400), mt[:257]) == (
        0, None)
    assert mel_kernel.sig_fft_head(2048, np.hanning(2049), mt) == (0, None)
    assert mel_kernel.sig_fft_head(1024, np.hanning(1025), mt[:513]) == (
        0, None)
    head, _ = _head("kaldi", 48000)
    f = head.fft
    for kw in (dict(window=f.window.float()), dict(window=f.window[None]),
               dict(mt=f.mt[:-1]), dict(mt=f.mt.float()),
               dict(mt=f.mt[:768 * 3]), dict(mt=f1024.mt),
               dict(preemph=-0.5), dict(preemph=float("nan"))):
        with pytest.raises(ValueError):
            sig_mel.FftHead(**{**dict(window=f.window, preemph=f.preemph,
                                      mt=f.mt), **kw})
    monkeypatch.setattr(sig_mel, "_bound", _Lib)
    short = sig_mel.FftHead(f.window[:-1], f.preemph, f.mt)
    tts, _ = _head("nemo", 22050)
    for broken in (dataclasses.replace(head, fft=short),
                   dataclasses.replace(head, dft_size=1024),
                   dataclasses.replace(tts, dft_size=2048),
                   dataclasses.replace(tts, fft=f),
                   dataclasses.replace(head, out_mode="whisper"),
                   dataclasses.replace(head, pack_off=900),
                   dataclasses.replace(tts, pack_off=600),
                   dataclasses.replace(head, mt=head.mt.float()[:1536])):
        with pytest.raises(ValueError, match="float64 FFT path"):
            sig_mel.head_layout(broken, 480)


@pytest.mark.parametrize("n", sig_mel.FFT_SIZES)
def test_kernel_constants(n):
    """For each DFT size, the host's group threads, groups a block, passes
    and twiddle table's rows are the kernel's size trait (``FftSize<n>``
    in ``csrc/sig_fft.cuh``)."""
    text = (build.CSRC_DIR / "sig_fft.cuh").read_text()
    start = text.index(f"template <>\nstruct FftSize<{n}> {{")
    trait = text[start : text.index("};", start)]
    threads, groups = sig_mel.FFT_GROUP_THREADS[n], sig_mel.FFT_GROUPS[n]
    assert f"static constexpr int kN = {n};" in trait
    assert f"static constexpr int kGroupThreads = {threads};" in trait
    assert f"static constexpr int kGroups = {groups};" in trait
    r1, r2, r3 = sig_mel.FFT_RADICES[n]
    assert r1 * r2 * r3 == n // 2
    assert threads * r1 == n // 2
    rows = sig_mel.fft_twiddles(n, CPU).shape[0]
    assert rows == sig_mel.FFT_TW
    assert f"static constexpr int kTw = {rows};" in trait


@pytest.mark.parametrize("n", sig_mel.FFT_SIZES)
def test_twiddle_table_per_size(n):
    """``fft_twiddles(n)``: ``Wn^e = exp(-2 pi i e / n)`` for ``e <
    256`` as float64 ``(cos, -sin)`` pairs, a table each size (the 1024
    table's W1024^e covers W512^t = W1024^(2 t), W32^a = W1024^(32 a) and
    the split's W1024^(k1 + 16 c)); no table for another size."""
    tab = sig_mel.fft_twiddles(n, CPU)
    assert tab.dtype == torch.float64 and tuple(tab.shape) == (256, 2)
    want = np.exp(-2j * np.pi * np.arange(256) / n)
    assert np.abs(tab[:, 0].numpy() + 1j * tab[:, 1].numpy()
                  - want).max() <= 1e-15
    other = sig_mel.fft_twiddles(3072 - n, CPU)
    assert not torch.equal(tab, other)
    with pytest.raises(ValueError, match="512-point"):
        sig_mel.fft_twiddles(512, CPU)


# the 2048 instance's exchange layouts (csrc/sig_fft.cuh: fft_at1,
# fft_at2), in complex doubles of the group's buffer, and pass 3's
# butterflies
AT1 = "return FftSize<2048>::kGroupThreads * k1 + (t ^ (4 * (k1 & 1)));"
AT2 = ("return FftSize<2048>::kGroupThreads * c + 4 * k1 + "
       "(a ^ ((k1 >> 1) & 3));")
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
    tab = sig_mel.fft_twiddles(2048, CPU).numpy()
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


# the 1024 instance's exchange layouts (csrc/sig_fft.cuh: fft512_at1,
# fft512_at2), in complex doubles of the warp's buffer, and pass 3's
# butterflies (fft512_pass3)
AT1_512 = "return 32 * k1 + (t ^ (2 * (k1 & 3)));"
AT2_512 = "return 32 * c + 2 * k1 + (a ^ ((k1 >> 2) & 1));"
PASS3_512 = """  const int j = t & 7, u = t >> 3;
  const bool k8 = !j && (u & 2);
  klo = j ? j : k8 ? 8 : 0;
  khi = j ? 16 - j : klo;
  m = (j || k8) ? 15 : 16;
  const int c0 = j ? u : k8 ? (u & 1) : u ? 1 : 2, cs = j ? 4 : 2;"""


def _at1_512(t, k1):
    return 32 * k1 + (t ^ (2 * (k1 & 3)))


def _at2_512(k1, a, c):
    return 32 * c + 2 * k1 + (a ^ ((k1 >> 2) & 1))


def _pass3_512(t):
    """``fft512_pass3``: lane t's butterflies ``[(k1, c)] * 8`` of pass
    3, four and their mirrors, as the kernel reads them (lane 0's fourth
    at c 0, the rest at ``c[b]``)."""
    j, u = t & 7, t >> 3
    k8 = not j and bool(u & 2)
    klo = j if j else 8 if k8 else 0
    khi = 16 - j if j else klo
    m = 15 if (j or k8) else 16
    c0 = u if j else (u & 1) if k8 else 1 if u else 2
    c = [c0 + (4 if j else 2) * b for b in range(4)]
    lo = [(klo, cb & (15 if t else 7)) for cb in c]
    return lo + [(khi, m - cb) for cb in c]


def _exchanges_512():
    """Each access of the warp's buffer in a frame, as ``_exchanges``:
    exchange 1 (lane t writes ``B[t][k1]``, lane (k1, a) = (t / 2, t mod
    2) reads ``B[a + 2 b][k1]``), exchange 2 (lane (k1, a) writes
    ``C[k1,a][c]``, pass 3's lane reads ``C[k1,0][c]`` and ``C[k1,1][c]``
    of its butterflies), and the Z each lane's butterflies give."""
    t = np.arange(32)
    k1a, a = t >> 1, t & 1
    p3 = [_pass3_512(i) for i in range(32)]
    return {
        "write_1": np.array([_at1_512(t, j) for j in range(16)]),
        "read_1": np.array([_at1_512(a + 2 * b, k1a) for b in range(16)]),
        "write_2": np.array([_at2_512(k1a, a, c) for c in range(16)]),
        "read_2": np.array([[_at2_512(p3[i][n // 2][0], n % 2,
                                      p3[i][n // 2][1]) for i in range(32)]
                            for n in range(16)]),
        "pass_3": np.array([[k1 + 16 * c + 256 * d for k1, c in p3[i]
                             for d in range(2)] for i in range(32)]).T,
    }


@pytest.mark.parametrize("name", ["write_1", "read_1", "write_2", "read_2",
                                  "pass_3"])
def test_exchange_layout_of_the_1024_instance(name):
    """The 1024 instance's exchanges each cover the warp's 512 places
    once, and in every access no 8 consecutive lanes (a quarter warp)
    meet on one of the 8 16-byte bank groups twice; pass 3's butterflies
    give each Z once, butterfly b + 4 the mirror ``Z[512 - k]`` of
    butterfly b's Z[k] with d turned over (lane 0's fourth pair, c 0 and
    8 of k1 0, each its own mirror). The layouts are the kernel's text."""
    text = (build.CSRC_DIR / "sig_fft.cuh").read_text()
    assert AT1_512 in text and AT2_512 in text and PASS3_512 in text
    at = _exchanges_512()[name]
    assert sorted(at.reshape(-1)) == list(range(512))
    if name == "pass_3":
        for i in range(32):
            z = at[:, i].reshape(8, 2)
            mirror = (512 - z[4:, ::-1]) % 512
            own = [3] if i == 0 else []
            for b in range(4):
                if b in own:
                    assert sorted(z[b]) == [0, 256]
                    assert sorted(z[b + 4]) == [128, 384]
                else:
                    assert (z[b] == mirror[b]).all()
    else:
        quarters = at.reshape(at.shape[0], 4, 8) % 8
        assert all(len(set(qq)) == 8 for row in quarters for qq in row)


def _warp_fft(y, bins=512):
    """A float64 model of the 1024 instance's frame walk on one frame of
    1024 real taps (``csrc/sig_fft.cuh::fft1024_frames``): lane t's points
    ``z[t + 32 n]``, pass 1's radix-16 turned by the powers of ``W512^t``
    into the warp's buffer at ``fft512_at1``, pass 2's radix-16 of lane
    (k1, a) turned by the powers of ``W32^a`` into the buffer at
    ``fft512_at2``, pass 3's radix-2s (``fft512_pass3``), then the split
    of each lane's pairs of bins k, 512 - k with ``W1024^k =
    W1024^(k1 + 16 c) W4^d`` from ``fft_twiddles(1024)``, lane 0's bins 0,
    256, 128 and 384, and no bin at or past ``bins`` (NaN there). Every
    place of the buffer is written once before it is read."""
    tab = sig_mel.fft_twiddles(1024, CPU).numpy()
    tw = tab[:, 0] + 1j * tab[:, 1]
    z = y[0::2] + 1j * y[1::2]

    def fft16(v, base):
        out = np.empty(16, complex)
        out[[4 * (k & 3) + (k >> 2) for k in range(16)]] = np.fft.fft(v)
        for k in range(1, 16):
            out[4 * (k & 3) + (k >> 2)] *= base ** k
        return out

    def at(k):
        return 4 * (k & 3) + (k >> 2)

    buf1 = np.full(512, np.nan, complex)
    for t in range(32):
        v = fft16(z[t + 32 * np.arange(16)], tw[2 * t])
        for k1 in range(16):
            buf1[_at1_512(t, k1)] = v[at(k1)]
    buf2 = np.full(512, np.nan, complex)
    for u in range(32):
        k1, a = u >> 1, u & 1
        v = fft16(buf1[[_at1_512(a + 2 * b, k1) for b in range(16)]],
                  tw[32 * a])
        for c in range(16):
            buf2[_at2_512(k1, a, c)] = v[at(c)]
    assert not np.isnan(buf2).any()
    out = np.full(512, np.nan + 0j)

    def put(za, zb, w, k):
        er, ei = 0.5 * (za.real + zb.real), 0.5 * (za.imag - zb.imag)
        orr, oi = 0.5 * (za.imag + zb.imag), 0.5 * (zb.real - za.real)
        tr, ti = w.real * orr - w.imag * oi, w.real * oi + w.imag * orr
        if k < bins:
            out[k] = (er + tr) + 1j * (ei + ti)
        if 512 - k < bins:
            out[512 - k] = (er - tr) + 1j * (ti - ei)

    for t in range(32):
        v = np.empty(16, complex)
        for b, (k1, c) in enumerate(_pass3_512(t)):
            x0, x1 = buf2[_at2_512(k1, 0, c)], buf2[_at2_512(k1, 1, c)]
            v[2 * b], v[2 * b + 1] = x0 + x1, x0 - x1
        for b in range(4 if t else 3):
            k1, c = _pass3_512(t)[b]
            k = k1 + 16 * c
            put(v[2 * b], v[2 * b + 9], tw[k], k)
            put(v[2 * b + 1], v[2 * b + 8], tw[k] * -1j, k + 256)
        if t == 0:
            if bins > 0:
                out[0] = v[6].real + v[6].imag
            if bins > 256:
                out[256] = v[7].real - 1j * v[7].imag
            put(v[14], v[15], np.exp(-0.25j * np.pi), 128)
    return out


@pytest.mark.parametrize("pack,bins", [(1024, 512), (551, 512), (800, 372),
                                       (1024, 200)])
def test_warp_fft_model_against_numpy(pack, bins):
    """The 1024 instance's walk, modelled in float64 on a frame of
    ``pack`` taps, equals ``np.fft.rfft`` on the bins below ``bins``
    within 1e-12 of the spectrum's largest magnitude and computes none
    at or past them (the TTS head's 372)."""
    y = np.zeros(1024)
    y[:pack] = np.random.default_rng(pack + bins).normal(size=pack) + 0.25
    got = _warp_fft(y, bins)
    want = np.fft.rfft(y)[:512]
    assert not np.isnan(got[:bins]).any() and np.isnan(got[bins:]).all()
    assert np.abs(got[:bins] - want[:bins]).max() <= 1e-12 * np.abs(
        want).max()


def _head_1024(name):
    """``(head, hop, signal the head reads of x)`` of the 1024-point
    heads: NeMo's power head at 22.05 kHz, NeMo's TTS magnitude head
    (``exact_pad``'s reflect pad of 384), Kaldi with preemphasis at 22.05
    and 32 kHz."""
    if name.startswith("kaldi"):
        cfg = _kaldi_cfg(22050 if name == "kaldi_22050" else 32000)
        return (fbank.sig_head(cfg), cfg.frame_shift_samples,
                lambda x: x)
    if name == "nemo_tts":
        cfg = BatchLogMelConfig(
            sample_rate=22050, n_fft=1024, win_length=1024, hop_length=256,
            f_max=8000.0, center=False, mag_power=1.0,
            log_zero_guard_type="clamp", log_zero_guard=1e-5,
            exact_pad=True)
        return (batch_logmel.sig_head(cfg), 256,
                lambda x: torch.nn.functional.pad(x[:, None], (384, 384),
                                                  mode="reflect")[:, 0])
    cfg = _nemo_cfg(22050)
    return (batch_logmel.sig_head(cfg), cfg.hop_length,
            lambda x: torch.nn.functional.pad(x, (512, 512)))


@pytest.mark.parametrize("name", ["nemo_22050", "nemo_tts", "kaldi_22050",
                                  "kaldi_32000"])
@pytest.mark.parametrize("clip", ["noise", "jfk"])
def test_plain_version_at_1024_against_rfft_and_the_chunk_walk(name, clip):
    """At 1024 points the FFT path's plain version takes the power (the
    TTS head: the magnitude) from ``torch.fft.rfft`` of the windowed,
    preprocessed taps in float64, rounded once: bit-equal to that power
    recomputed here, and within 2e-4 of the float64 pipeline
    (``rfft``, the head's float64 filters), and of the head's own chunk
    walk's plain version (``sig_mel_reference``, float64 dot) within 2e-4
    plus that version's own distance from the float64 pipeline (its bf16
    matrix slices round column by column: up to 2e-4 on Kaldi's
    preemphasized near-empty bins of JFK), on 2 clips of 0.4 s of noise or
    JFK resampled."""
    head, hop, framed = _head_1024(name)
    f = head.fft
    assert head.dft_size == f.size == 1024
    sr = 32000 if name == "kaldi_32000" else 22050
    n = int(0.4 * sr) + 37
    x = (_signal(sr, (2, n)) if clip == "noise" else np.stack(
        [_resampled_jfk(sr)[k * n : (k + 1) * n] for k in (1, 2)]).astype(
            np.float32))
    sig = framed(torch.from_numpy(x))
    nf = framing.num_frames_batch(sig.shape[-1], head.pack_off + head.pack,
                                  hop)
    kw = dict(n_frames=nf, hop=hop, offset=0)
    got = sig_mel.sig_mel_fft_reference(sig, head, **kw)
    y = sig_mel.fft_taps(sig, n_frames=nf, hop=hop, start=head.pack_off,
                         window=f.window, preemph=f.preemph)
    spec = torch.fft.rfft(y, n=1024)[..., :512]
    power = spec.abs() ** (1 if head.magnitude else 2)
    assert torch.equal(sig_mel.fft_power(
        sig, size=1024, pack_off=head.pack_off, window=f.window,
        preemph=f.preemph, magnitude=head.magnitude, **kw),
        power.to(torch.float32))
    if name.startswith("kaldi"):
        cfg = _kaldi_cfg(sr)
        filt = kaldi_filterbank(cfg.sample_rate, 1024, cfg.num_mel_bins,
                                cfg.low_freq, cfg.effective_high_freq)
    elif name == "nemo_tts":
        filt = mel_kernel.mel_filterbank(22050.0, 1024, 80, f_max=8000.0)
    else:
        filt = batch_logmel.nemo_filters(_nemo_cfg(22050))
    e = power @ torch.as_tensor(filt[:, :512].T)
    guard = sig_mel.clamped_guard(head.guard)
    want = torch.log(e + guard if head.out_mode == "ln_guard"
                     else torch.clamp(e, min=guard))
    dense = sig_mel.sig_mel_reference(sig, head, ks=3,
                                      dot_dtype=torch.float64, **kw)
    assert got.shape == want.shape == dense.shape == (2, nf, head.n_mels)
    assert float((got.double() - want).abs().max()) <= LN_BAR
    assert float((got - dense).abs().max()) <= LN_BAR + float(
        (dense.double() - want).abs().max())


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
    preemphasis, the Povey or centred Hann window, ``rfft`` at the rate's
    DFT size, power, the filters, ln."""
    x = x.astype(np.float64)
    size = NEMO_FFT[sr]
    if kind == "kaldi":
        cfg = _kaldi_cfg(sr)
        n, hop = cfg.frame_length_samples, cfg.frame_shift_samples
        nf = framing.num_frames_batch(x.shape[-1], n, hop)
        fr = np.stack([x[:, k * hop : k * hop + n] for k in range(nf)], 1)
        d = fr - fr.mean(-1, keepdims=True)
        y = d.copy()
        y[..., 1:] = d[..., 1:] - cfg.preemphasis * d[..., :-1]
        spec = np.fft.rfft(y * povey(n), n=size)
        filt = kaldi_filterbank(cfg.sample_rate, size, cfg.num_mel_bins,
                                cfg.low_freq, cfg.effective_high_freq)
        e = (np.abs(spec) ** 2) @ filt.T
        return np.log(np.maximum(e, fbank.energy_floor(cfg)))
    cfg = _nemo_cfg(sr)
    hop = cfg.hop_length
    xp = np.pad(x, ((0, 0), (size // 2, size // 2)))
    nf = framing.num_frames_centered(x.shape[-1], hop)
    fr = np.stack([xp[:, k * hop : k * hop + size] for k in range(nf)], 1)
    spec = np.fft.rfft(fr * hann_centered(size, cfg.win_length))
    e = (np.abs(spec) ** 2) @ batch_logmel.nemo_filters(cfg).T
    return np.log(e + cfg.log_zero_guard)


def _fft_plain(kind, sr, x):
    head, hop = _head(kind, sr)
    xt = torch.from_numpy(x)
    if kind == "kaldi":
        nf = framing.num_frames_batch(x.shape[-1], head.pack, hop)
    else:
        nf = framing.num_frames_centered(x.shape[-1], hop)
        xt = torch.nn.functional.pad(xt, (NEMO_FFT[sr] // 2,) * 2)
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
    """On JFK resampled to 22.05-80 kHz (an empty band above 8 kHz) and
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


@pytest.mark.parametrize("name", ["nemo_tts", "kaldi_22050"])
def test_design_bound_counts_the_1024_instance(name):
    """``chip_smoke.py::fft_work`` counts the 1024-point design's float64
    work a frame by hand: the taps (1 a tap, 5 with Kaldi's
    preprocessing), two passes of 32 radix-16s with their twiddles (162 +
    90 + 84 a thread) and 256 radix-2s of 4, the split's 14 a pair of its
    256 and 5 a live bin; in float32 6 a run value and 1 a mel."""
    import chip_smoke

    head, _, _ = _head_1024(name)
    f = head.fft
    taps = head.pack * (1 if f.preemph is None else 5)
    want = taps + 2 * 32 * (162 + 90 + 84) + 256 * 4 + 256 * 14 + f.bins * 5
    work = chip_smoke.fft_work(head, 10)
    assert work["flops_f64"] == 10 * want
    assert work["flops_f32"] == 10 * (6 * f.nnz + head.n_mels)
    if name == "nemo_tts":
        assert want == 28_996 and f.bins == 372
