"""K5's and K8's tensor-core launcher on the CPU (``kernels/framed_ozaki.py``,
schemes bf3 and f32): their bf16 ring tiles (a block per slice pair, N
contiguous, in tap order; K8's from ``bf16_slices`` of the float32
matrices) untiled and rebuilt in plain PyTorch into the kernels' sums
(each ring stage's 64 taps one sum, added into its scale group in
float32, the groups added largest first in float32), each stage's sum
taken exactly (float64 dot) and rounded once, as a tensor core without
rounding error would; held to the
plain versions and to JAX's Pallas kernels in interpret mode and to the
JFK gate; the figures that decided K8's design (3xTF32, emulated bit for
bit from a hand-worked ``tf32_rna`` table, misses the JFK gate; the
bf16 split holds it); the schedules, stage counts and L2 counts. The
kernels themselves run on the card (``tests/test_torch_cuda_framed.py``)."""

import struct
from pathlib import Path

import numpy as np
import pytest
import torch

from melspec_tpu.ops import mel_kernel as jmk
from melspec_tpu_torch.io.wav import read_wav_f32le
from melspec_tpu_torch.kernels import framed_mel, framed_ozaki
from melspec_tpu_torch.ops import mel_kernel
from melspec_tpu_torch.ops.hp_dft import bf16_round_slices

CPU = torch.device("cpu")
TESTDATA = Path(__file__).resolve().parents[1] / "testdata"
CONFIGS = [(400, 160, 80, 16000.0), (1024, 256, 80, 22050.0)]
# the rebuilt sums against the plain version with the float64 dot: both
# sum the same exact products; they differ by the float32 roundings of
# the pairs (plain) or the stages (rebuilt), a few ulp of a bin, which a
# bin 7-8 decades below its frame's peak turns into up to a few 1e-6 of
# log-mel (measured: below 3e-6)
TOL_EXACT = 1e-5
# against JAX's kernels in interpret mode: tests/test_torch_framed_mel.py's
# bar for the float32 schemes (float32 sums in another order)
TOL_JAX = 2e-5
JFK_GATE = 1e-5


def _f(bits: int) -> float:
    return struct.unpack("<f", struct.pack("<I", bits))[0]


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (10 fraction bits), to nearest with
    ties away from zero, as ``cvt.rna.tf32.f32`` (low 13 bits zero): the
    magnitude's bits plus half a unit of the kept last bit, cut; inf and
    NaN pass as they are. K8's first design (3xTF32) split with it."""
    b = x.to(torch.float32).contiguous().view(torch.int32)
    finite = (b & 0x7F800000) != 0x7F800000
    return torch.where(finite, (b + 0x1000) & -0x2000, b).view(torch.float32)


def tf32_split(x: torch.Tensor) -> tuple:
    """``(hi, lo)``: ``hi = tf32_rna(x)``, ``lo = tf32_rna(x - hi)``."""
    hi = tf32_rna(x)
    return hi, tf32_rna(x.to(torch.float32) - hi)


# (input bits, tf32_rna bits): nearest, ties away from zero, 10 fraction
# bits kept; worked by hand from the bit patterns
TF32_TABLE = [
    (0x3F800000, 0x3F800000),  # 1.0 is exact
    (0x3F800FFF, 0x3F800000),  # below half a unit: down
    (0x3F801000, 0x3F802000),  # 1 + 2^-11, a tie, even kept bit: away
    (0xBF801000, 0xBF802000),  # its negative: away from zero too
    (0x3F803000, 0x3F804000),  # a tie with an odd kept bit: away (= even)
    (0x3F801001, 0x3F802000),  # just above a tie: up
    (0x3FFFF000, 0x40000000),  # 2 - 2^-11: the carry runs into the exponent
    (0xC07FF800, 0xC0800000),  # -(4 - 2^-9): carry, negative
    (0x7F7FF000, 0x7F800000),  # half a unit below 2^128: rounds to inf
    (0x00001000, 0x00002000),  # subnormal tie: away
    (0x00000FFF, 0x00000000),  # subnormal below half: to +0
    (0x80000FFF, 0x80000000),  # ... and to -0 from below
    (0x007FF000, 0x00800000),  # largest subnormals round to the least normal
    (0x00000000, 0x00000000),  # +0
    (0x80000000, 0x80000000),  # -0 keeps its sign
    (0x7F800000, 0x7F800000),  # +inf
    (0xFF800000, 0xFF800000),  # -inf
]


def test_tf32_rna_table():
    x = torch.tensor([b for b, _ in TF32_TABLE], dtype=torch.int64).to(
        torch.int32).view(torch.float32)
    got = tf32_rna(x).view(torch.int32).tolist()
    want = torch.tensor([w for _, w in TF32_TABLE], dtype=torch.int64).to(
        torch.int32).tolist()
    assert got == want
    nan = tf32_rna(torch.tensor([float("nan")]))
    assert torch.isnan(nan).all()
    assert _f(0x3F802000) == 1 + 2 ** -10


def test_tf32_split_of_random_values():
    """hi and lo keep 10 fraction bits (low 13 bits zero), x - hi is
    exact, and hi + lo is within 2^-22 of x, relative."""
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=4096).astype(np.float32) * np.float32(3.7))
    hi, lo = tf32_split(x)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    r = x.double() - hi.double()
    assert torch.equal((x - hi).double(), r)
    err = (hi.double() + lo.double() - x.double()).abs()
    assert float((err / x.double().abs()).max()) <= 2.0 ** -22
    assert float((hi.double() - x.double()).abs().div(
        x.double().abs()).max()) <= 2.0 ** -11


def bf16_round_bits(x: torch.Tensor) -> torch.Tensor:
    """``csrc/framed_ozaki.cu::bf16_round``: a float32 rounded to bf16
    (nearest, ties to even) by integer operations on its bits."""
    b = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    r = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return torch.where(r >= 2 ** 31, r - 2 ** 32, r).to(torch.int32).view(
        torch.float32)


def test_bf16_round_by_integers_is_round_to_nearest_even():
    """The kernels' integer rounding of the residual cascade equals
    PyTorch's float32 -> bfloat16 rounding bit for bit: ties both ways,
    carries into the exponent, subnormals, +-0, the largest finites and
    noise across 40 binades."""
    table = [0x3F808000, 0x3F818000, 0x3F808001, 0x3F807FFF, 0xBF808000,
             0x3FFF8000, 0x007F8000, 0x00008000, 0x00018000, 0x80008000,
             0x00000000, 0x80000000, 0x7F7F0000, 0x7F7F7FFF, 0x3F800000]
    x = torch.tensor(table, dtype=torch.int64).to(torch.int32).view(
        torch.float32)
    rng = np.random.default_rng(5)
    noise = torch.from_numpy((rng.normal(size=100_000) * np.exp2(
        rng.integers(-20, 20, size=100_000))).astype(np.float32))
    for v in (x, noise):
        want = v.to(torch.bfloat16).to(torch.float32)
        assert torch.equal(bf16_round_bits(v).view(torch.int32),
                           want.view(torch.int32))


def _untile_n(tiles: torch.Tensor, nbp: int) -> torch.Tensor:
    """K5's ring tiles (N contiguous, 64 taps a stage) back to ``[blocks,
    2 (cos, sin), rows, nbp]``, written out independently of
    ``ring_tiles``: tile ``[warpgroup][cos | sin][8-bin group][tap][8
    bins]``, bin ``64 chunk + 32 warpgroup + 8 group + b``."""
    blocks, nc, st = tiles.shape[:3]
    x = tiles.reshape(blocks, nc, st, 2, 2, 4, 64, 8)
    x = x.permute(0, 4, 2, 6, 1, 3, 5, 7)
    return x.reshape(blocks, 2, st * 64, nbp)


def _frames(fft, hop, streaming, seed):
    x = torch.from_numpy((np.random.default_rng(seed).normal(
        size=(2, 7001)) * 0.2).astype(np.float32))
    fr, nf = mel_kernel.framed_input(x, fft, hop, streaming)
    return x, fr, nf


def tc_sums(fr: torch.Tensor, tiles: torch.Tensor, mats, taps: int):
    """K5's or K8's DFT from its ring tiles in the kernel's order: the
    frames' bf16 residual slices; per scale group its pairs in order, per
    pair its 64-tap ring stages, each stage's sum exact and rounded once
    to float32, added into the group in float32; the groups added largest
    scale first in float32 -> ``(re, im)``."""
    ks, cutoff = framed_ozaki.kernel_schedule(mats.impl, mats.ks,
                                              mats.cutoff)
    planes = _untile_n(tiles, mats.n_bins_pad).to(torch.float64)
    rows = planes.shape[2]
    stage = framed_ozaki.STAGE_TAPS[mats.impl]
    x = torch.nn.functional.pad(fr[:, :taps], (0, rows - taps))
    slices, r = [], x
    for _ in range(ks):
        s = r.to(torch.bfloat16).to(torch.float32)
        slices.append(s.double())
        r = r - s
    pairs = framed_ozaki.pair_table(ks, cutoff)
    out = []
    for comp in (0, 1):
        total = None
        for s in sorted({p[2] for p in pairs}):
            grp = None
            for k, (i, _, ps) in enumerate(pairs):
                if ps != s:
                    continue
                for k0 in range(0, taps, stage):
                    part = (slices[i][:, k0:k0 + stage]
                            @ planes[k, comp, k0:k0 + stage]).to(
                                torch.float32)
                    grp = part if grp is None else grp + part
            total = grp if total is None else total + grp
        out.append(total)
    return out


def _mel(re, im, mats, n_mels):
    return framed_mel._whisper(re * re + im * im, mats.mt)[:, :n_mels]


@pytest.mark.parametrize("fft,hop,n_mels,sr", CONFIGS)
@pytest.mark.parametrize("streaming", [False, True])
def test_k5_tables_rebuild_the_plain_version(fft, hop, n_mels, sr,
                                             streaming):
    ks, cutoff = mel_kernel.pallas_schedule("bf3")
    mats = mel_kernel.framed_matrices("bf3", fft, n_mels, sr, ks, cutoff,
                                      CPU)
    nbp = mats.n_bins_pad
    tiles = framed_ozaki.ring_tiles("bf3", mats.planes, ks, cutoff, nbp, fft)
    assert tiles.dtype == torch.bfloat16
    assert tiles.shape[-1] * 2 == framed_ozaki.TILE_BYTES
    planes = _untile_n(tiles, nbp)
    assert not planes[:, :, fft:].any()  # zero past the taps
    for k, (i, j, _) in enumerate(framed_ozaki.pair_table(ks, cutoff)):
        m = mats.planes[i]
        n_p = m.shape[1] // (2 * nbp)
        assert torch.equal(planes[k, 0, :fft], m[:fft, j * nbp:(j + 1) * nbp])
        assert torch.equal(planes[k, 1, :fft],
                           m[:fft, (n_p + j) * nbp:(n_p + j + 1) * nbp])
    x, fr, nf = _frames(fft, hop, streaming, seed=fft + 5)
    mel = _mel(*tc_sums(fr, tiles, mats, fft), mats, n_mels)
    exact = framed_mel.framed_mel_reference(fr, mats, n_mels=n_mels,
                                            dot_dtype=torch.float64)
    assert float((mel - exact).abs().max()) <= TOL_EXACT
    jax_mel = np.asarray(jmk.whisper_mel_pallas(
        x.numpy(), fft, hop, n_mels, sr, streaming=streaming, impl="bf3",
        interpret=True))
    assert np.abs(mel.reshape(jax_mel.shape).numpy() - jax_mel).max() \
        <= TOL_JAX


@pytest.mark.parametrize("fft,hop,n_mels,sr", CONFIGS)
@pytest.mark.parametrize("streaming", [False, True])
def test_k8_tables_rebuild_the_plain_version(fft, hop, n_mels, sr,
                                             streaming):
    """K8 on K5's walk: the float32 cos / sin matrices cut into three
    bf16 slices (as the JAX package cuts its float64 ones), the pairs i +
    j <= 2, held to the plain float32 version and JAX's f32 kernel."""
    mats = mel_kernel.framed_matrices("f32", fft, n_mels, sr, 1, 0, CPU)
    nbp = mats.n_bins_pad
    tiles = framed_ozaki.ring_tiles("f32", mats.planes, 1, 0, nbp, fft)
    assert tiles.dtype == torch.bfloat16
    pairs = framed_ozaki.schedule("f32", 1, 0)
    assert pairs == framed_ozaki.pair_table(3, 2)
    assert tiles.shape[:3] == (len(pairs), nbp // 64,
                               framed_ozaki.stages_per_pair("f32", fft))
    planes = _untile_n(tiles, nbp)
    assert not planes[:, :, fft:].any()
    for comp, m in enumerate(mats.planes):
        want = bf16_round_slices(m.double().numpy(), 3)
        got = framed_ozaki.bf16_slices(m, 3)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        for k, (_, j, _) in enumerate(pairs):
            assert torch.equal(planes[k, comp, :fft], want[j][:fft])
    x, fr, nf = _frames(fft, hop, streaming, seed=fft + 6)
    mel = _mel(*tc_sums(fr, tiles, mats, fft), mats, n_mels)
    exact = framed_mel.framed_mel_reference(fr, mats, n_mels=n_mels,
                                            dot_dtype=torch.float64)
    assert float((mel - exact).abs().max()) <= TOL_EXACT
    jax_mel = np.asarray(jmk.whisper_mel_pallas(
        x.numpy(), fft, hop, n_mels, sr, streaming=streaming, impl="f32",
        interpret=True))
    assert np.abs(mel.reshape(jax_mel.shape).numpy() - jax_mel).max() \
        <= TOL_JAX


def _jfk(impl):
    golden = np.load(TESTDATA / "rust_jfk_golden.npy")
    jfk = torch.from_numpy(read_wav_f32le(TESTDATA / "jfk_f32le.wav"))
    ks, cutoff = mel_kernel.pallas_schedule(impl)
    mats = mel_kernel.framed_matrices(impl, 512, 80, 16000.0, ks, cutoff,
                                      CPU)
    fr, nf = mel_kernel.framed_input(jfk[None], 512, 160, True)
    return golden, mats, fr


@pytest.mark.parametrize("impl", ["bf3", "f32"])
def test_rebuilt_sums_hold_the_jfk_gate(impl):
    """The tensor-core sums (each stage exact, rounded once) at 512/160/80
    on JFK, streaming framing, against the whisper.cpp-aligned golden at
    1e-5: the gate predicted before the card."""
    golden, mats, fr = _jfk(impl)
    tiles = mats.ring_tiles(512)
    got = _mel(*tc_sums(fr, tiles, mats, 512), mats, 80).T.numpy()
    assert got.shape == golden.shape
    assert np.abs(got - golden).max() <= JFK_GATE


def test_k8_design_3xtf32_misses_the_jfk_gate():
    """The figures that decided K8's design: 3xTF32 (lo . hi + hi . lo +
    hi . hi, every product and sum exact, one rounding) lands 1.19e-5
    from the JFK golden, over the 1e-5 gate; the tf32 split keeps 22
    bits of frame and matrix. The float32 DFT itself (float64 dot) and
    the bf16 split of K8's kernel (its stage sums) land 4.89e-6."""
    golden, mats, fr = _jfk("f32")
    cw, sw = mats.planes
    f_hi, f_lo = (p.double() for p in tf32_split(fr))

    def tf32x3(m):
        m_hi, m_lo = (p.double() for p in tf32_split(m))
        return (f_lo @ m_hi + f_hi @ m_lo + f_hi @ m_hi).to(torch.float32)

    def err(re, im):
        return float(np.abs(_mel(re, im, mats, 80).T.numpy()
                            - golden).max())

    e_tf32 = err(tf32x3(cw), tf32x3(sw))
    e_f32 = err(*((fr.double() @ m.double()).to(torch.float32)
                  for m in (cw, sw)))
    e_bf16 = err(*tc_sums(fr, mats.ring_tiles(512), mats, 512))
    assert e_tf32 > JFK_GATE >= max(e_f32, e_bf16)
    assert round(e_tf32, 7) == 1.19e-5 and round(e_bf16, 8) == 4.89e-6


@pytest.mark.parametrize("ks,cutoff", [(4, 4), (6, 10), (2, 1)])
def test_k5_tiles_follow_any_schedule(ks, cutoff):
    """``hp_n_slices`` / ``hp_max_pair_sum`` overrides: a block per kept
    pair, each the pair's plane as slice i's matrix holds it."""
    ks, cutoff = mel_kernel.pallas_schedule("bf3", ks, cutoff)
    mats = mel_kernel.framed_matrices("bf3", 256, 32, 16000.0, ks, cutoff,
                                      CPU)
    nbp = mats.n_bins_pad
    tiles = framed_ozaki.ring_tiles("bf3", mats.planes, ks, cutoff, nbp, 256)
    pairs = framed_ozaki.pair_table(ks, cutoff)
    assert tiles.shape[:3] == (len(pairs), nbp // 64, 4)
    planes = _untile_n(tiles, nbp)
    for k, (i, j, _) in enumerate(pairs):
        m = mats.planes[i]
        assert torch.equal(planes[k, 0, :256], m[:256, j * nbp:(j + 1) * nbp])


def test_schedules():
    assert framed_ozaki.kernel_schedule("f32", 1, 0) == (3, 2)
    assert framed_ozaki.kernel_schedule("bf3", 4, 3) == (4, 3)
    assert framed_ozaki.schedule("f32", 1, 0) == \
        framed_ozaki.schedule("bf3", 3, 2) == framed_ozaki.pair_table(3, 2)
    assert len(framed_ozaki.schedule("bf3", 3, 2)) == 6
    assert set(framed_ozaki.SCHEME) == set(framed_mel.IMPLS)
    assert framed_ozaki.SCHEME["f32"] == framed_ozaki.SCHEME["bf3"]
    assert framed_mel.KERNEL == framed_ozaki.KERNEL
    assert set(framed_ozaki.MMA) == set(framed_mel.IMPLS)


@pytest.mark.parametrize("impl,taps,stages", [
    ("bf3", 400, 7), ("bf3", 512, 8), ("bf3", 960, 15), ("bf3", 1024, 16),
    ("f32", 400, 7), ("f32", 1024, 16), ("bf3", 200, 4)])
def test_stages_and_l2_count(impl, taps, stages):
    assert framed_ozaki.stages_per_pair(impl, taps) == stages
    ks, cutoff = mel_kernel.pallas_schedule(impl)
    pairs = len(framed_ozaki.schedule(impl, ks, cutoff))
    got = framed_ozaki.l2_tile_bytes(impl, ks, cutoff, taps, 256, 191_872,
                                     64)
    assert got == 2998 * pairs * stages * 4 * framed_ozaki.TILE_BYTES


def test_main_path_l2_counts():
    """64 x 30 s at 400/160/128 in 64-frame blocks: K5 and K8 read 6 pairs
    x 7 stages of 16 KB tiles per chunk."""
    k5 = framed_ozaki.l2_tile_bytes("bf3", 3, 2, 400, 256, 191_872, 64)
    k8 = framed_ozaki.l2_tile_bytes("f32", 1, 0, 400, 256, 191_872, 64)
    assert k5 == k8 and round(k5 / 1e9, 2) == 8.25


def test_k8_refuses_other_schedules():
    mats = mel_kernel.framed_matrices("f32", 400, 80, 16000.0, 1, 0, CPU)
    fr = torch.zeros(64, 512)
    bad = framed_mel.FramedMatrices("f32", mats.planes, mats.mt, 2, 1)
    with pytest.raises(ValueError, match="one slice"):
        framed_mel._checked(fr, bad, n_mels=80, taps=400)
    framed_mel._checked(fr, mats, n_mels=80, taps=400)


def test_framed_input_passes_exactly_the_frames():
    """No frame-count padding: the kernels mask their ragged last block."""
    x = torch.zeros(3, 7001)
    fr, nf = mel_kernel.framed_input(x, 400, 160)
    assert fr.shape == (3 * nf, 512)
