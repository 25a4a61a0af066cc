"""K6 and K7's launcher on the CPU (``kernels/framed_ozaki.py``): its
host-side tables, the pair order and the ring tiles (K6's planes K-major,
K7's as float16 in their tap order, both zero past the taps), rebuilt
into K6's group-concatenated int32 sums and K7's per-pair float32 sums in
plain PyTorch, bit-equal to the DFT power of the plain versions and, as
log-mel, within 1e-6 of JAX's Pallas kernels in interpret mode; the
exactness bounds the kernels rest on; and the launcher's refusals. The
kernels themselves run on the card (``tests/test_torch_cuda_framed.py``).
"""

import numpy as np
import pytest
import torch

from melspec_tpu.ops import mel_kernel as jmk
from melspec_tpu_torch.kernels import framed_mel, framed_ozaki
from melspec_tpu_torch.ops import mel_kernel
from melspec_tpu_torch.ops.hp_dft import (_signal_slices, combine_groups,
                                          pow2_row_scale, two_float_power)

CPU = torch.device("cpu")
# K6 / K7 against JAX's kernels in interpret mode (tests/test_torch_
# framed_mel.py): their DFTs are exact integers; only the float32
# projection's order differs
TOL = 1e-6
CONFIGS = [(400, 160, 128, 16000.0), (1024, 256, 80, 22050.0)]
# K7's pairs are exact float32 integers up to this many taps (+-127 x
# +-128 per product, below 2^24 in any order; csrc/framed_ozaki.cu)
EXACT_TAPS = 1032


def _noise(seed, shape):
    return (np.random.default_rng(seed).normal(size=shape) * 0.2).astype(
        np.float32)


def _untile(impl: str, tiles: torch.Tensor, nbp: int) -> torch.Tensor:
    """The ring tiles back to ``[blocks, 2 (cos, sin), rows, nbp]`` in
    tap order: the inverse of ``ring_tiles``' layout, written out
    independently (column group ``G`` of a chunk: warpgroup ``G // 8``,
    cos for ``G % 8 < 4``, bins ``8 (G % 4)`` of its 32)."""
    blocks, nc, st = tiles.shape[:3]
    if impl == "hp8":
        x = tiles.reshape(blocks, nc, st, 2, 2, 4, 8, 8, 16)
        # [blk, chunk, stage, wg, comp, jj, kg, n8, kk]
        x = x.permute(0, 4, 2, 6, 8, 1, 3, 5, 7)
        return x.reshape(blocks, 2, st * 128, nbp)
    x = tiles.reshape(blocks, nc, st, 2, 2, 4, 64, 8)
    # [blk, chunk, stage, wg, comp, jj, row, col]
    x = x.permute(0, 4, 2, 6, 1, 3, 5, 7).reshape(blocks, 2, st * 64, nbp)
    order = torch.tensor(framed_ozaki.K7_TAP_ORDER)
    x = x.reshape(blocks, 2, -1, 16, nbp)
    out = torch.empty_like(x)
    out[:, :, :, order] = x  # position p holds tap order[p]
    return out.reshape(blocks, 2, st * 64, nbp)


def _frames(fft, hop, streaming, seed=3):
    x = torch.from_numpy(_noise(seed, (2, 7001)))
    fr, nf = mel_kernel.framed_input(x, fft, hop, streaming)
    return x, fr, nf


@pytest.mark.parametrize("ks,cutoff", [(4, 4), (5, 5), (3, 2), (6, 10),
                                       (1, 0), (6, 3)])
def test_pair_table_is_the_group_order(ks, cutoff):
    pairs = framed_ozaki.pair_table(ks, cutoff)
    want = sorted(((i + j, i, j) for i in range(ks) for j in range(ks)
                   if i + j <= cutoff))
    assert pairs == tuple((i, j, s) for s, i, j in want)
    # K6's plane widths (mel_kernel._hp8_plane_widths) hold exactly these
    widths = mel_kernel._hp8_plane_widths(ks, ks, cutoff)
    assert sum(widths) == len(pairs)


@pytest.mark.parametrize("fft,hop,n_mels,sr", CONFIGS)
@pytest.mark.parametrize("streaming", [False, True])
def test_k6_tables_rebuild_the_plain_power(fft, hop, n_mels, sr, streaming):
    """K6: each group's pairs concatenated along K (the slices against
    the untiled K-major planes, zero past the taps) in one int32 sum, then
    the plain version's combine and two-float power: bit-equal to
    ``hp8_power_reference``; as log-mel within 1e-6 of JAX's kernel."""
    ks, cutoff = mel_kernel.pallas_schedule("hp8")
    mats = mel_kernel.framed_matrices("hp8", fft, n_mels, sr, ks, cutoff,
                                      CPU)
    nbp = mats.n_bins_pad
    tiles = framed_ozaki.ring_tiles("hp8", mats.planes, ks, cutoff, nbp, fft)
    assert tiles.dtype == torch.int8
    assert tiles.shape[-1] == framed_ozaki.TILE_BYTES
    planes = _untile("hp8", tiles, nbp)
    rows = planes.shape[2]
    assert rows >= framed_ozaki.k_pad32(fft)
    assert not planes[:, :, fft:].any()  # zero past the taps
    x, fr, nf = _frames(fft, hop, streaming)
    sigma = pow2_row_scale(fr)
    slices = [torch.nn.functional.pad(t[:, :fft], (0, rows - fft))
              for t in _signal_slices(fr / sigma, ks)]
    pairs = framed_ozaki.pair_table(ks, cutoff)
    groups = {}
    for s in sorted({p[2] for p in pairs}):
        idx = [k for k, p in enumerate(pairs) if p[2] == s]
        a = torch.cat([slices[pairs[k][0]] for k in idx], dim=1).to(
            torch.int64)
        for comp in (0, 1):
            b = torch.cat([planes[k, comp] for k in idx], dim=0).to(
                torch.int64)
            acc = a @ b
            assert acc.abs().max() < 2 ** 31
            groups.setdefault(comp, {})[s] = acc.to(torch.int32).to(
                torch.float32)
    power = two_float_power(combine_groups(groups[0]),
                            combine_groups(groups[1]), sigma)
    want = framed_mel.ozaki_power_reference(fr, mats)
    assert torch.equal(power, want)
    mel = framed_mel._whisper(power, mats.mt)[: 2 * nf, :n_mels]
    jax_mel = np.asarray(jmk.whisper_mel_pallas(
        x.numpy(), fft, hop, n_mels, sr, streaming=streaming, impl="hp8",
        interpret=True))
    assert np.abs(mel.reshape(jax_mel.shape).numpy() - jax_mel).max() <= TOL


@pytest.mark.parametrize("fft,hop,n_mels,sr", CONFIGS)
@pytest.mark.parametrize("streaming", [False, True])
def test_k7_tables_rebuild_the_plain_power(fft, hop, n_mels, sr, streaming):
    """K7: every pair its own float32 dot of a slice against the untiled
    float16 plane (exact), the pairs of a group added in increasing i in
    float32, then combine and two-float power: bit-equal to
    ``hp_power_reference``; as log-mel within 1e-6 of JAX's kernel."""
    ks, cutoff = mel_kernel.pallas_schedule("hp_bf16")
    mats = mel_kernel.framed_matrices("hp_bf16", fft, n_mels, sr, ks, cutoff,
                                      CPU)
    nbp = mats.n_bins_pad
    tiles = framed_ozaki.ring_tiles("hp_bf16", mats.planes, ks, cutoff, nbp,
                                    fft)
    assert tiles.dtype == torch.float16
    assert tiles.shape[-1] * 2 == framed_ozaki.TILE_BYTES
    planes = _untile("hp_bf16", tiles, nbp).to(torch.float32)
    rows = planes.shape[2]
    assert not planes[:, :, fft:].any()
    for j in range(ks):  # the float16 planes are the bf16 planes
        for comp in (0, 1):
            assert torch.equal(planes[j, comp, :fft],
                               mats.planes[comp][:fft, j * nbp:(j + 1) * nbp]
                               .to(torch.float32))
    x, fr, nf = _frames(fft, hop, streaming, seed=4)
    sigma = pow2_row_scale(fr)
    slices = [torch.nn.functional.pad(t[:, :fft], (0, rows - fft))
              for t in _signal_slices(fr / sigma, ks)]
    groups = ({}, {})
    for i, j, s in framed_ozaki.pair_table(ks, cutoff):
        for comp in (0, 1):
            pair = slices[i] @ planes[j, comp]
            assert torch.equal(pair, (slices[i].double()
                                      @ planes[j, comp].double()).float())
            g = groups[comp]
            g[s] = pair if s not in g else g[s] + pair
    power = two_float_power(combine_groups(groups[0]),
                            combine_groups(groups[1]), sigma)
    want = framed_mel.ozaki_power_reference(fr, mats)
    assert torch.equal(power, want)
    mel = framed_mel._whisper(power, mats.mt)[: 2 * nf, :n_mels]
    jax_mel = np.asarray(jmk.whisper_mel_pallas(
        x.numpy(), fft, hop, n_mels, sr, streaming=streaming,
        impl="hp_bf16", interpret=True))
    assert np.abs(mel.reshape(jax_mel.shape).numpy() - jax_mel).max() <= TOL


@pytest.mark.parametrize("taps", [1024, EXACT_TAPS])
def test_worst_case_pair_is_exact_in_float32(taps):
    """K7's bound: slices of +-127 against plane values of +-128 sum
    below 2^24 over up to 1,032 taps, so a float32 dot (any order) is the
    exact integer; one tap more could pass 2^24."""
    a = torch.full((taps,), 127.0)
    b = torch.full((taps,), 128.0)
    exact = 127 * 128 * taps
    assert exact < 2 ** 24
    assert float(a @ b) == exact
    assert float((a.to(torch.float16) * b.to(torch.float16)).float().sum()) \
        == exact
    s = torch.zeros((), dtype=torch.float32)
    for v in (a * b).flip(0):  # the other order, one rounding per add
        s = s + v
    assert float(s) == exact
    assert 127 * 128 * EXACT_TAPS < 2 ** 24 < 127 * 128 * (EXACT_TAPS + 1)


def test_k6_group_sum_fits_int32():
    """K6's bound: a group of up to 6 pairs (ks 6) over 4,096 taps of
    +-127 x +-127 stays below 2^31."""
    assert 6 * 4096 * 127 * 127 < 2 ** 31
    a = torch.full((6 * 4096,), 127, dtype=torch.int32)
    assert int((a * a).sum()) == 6 * 4096 * 127 * 127


@pytest.mark.parametrize("impl,taps,stages", [
    ("hp8", 400, 4), ("hp8", 1024, 8), ("hp8", 256, 2),
    ("hp_bf16", 400, 7), ("hp_bf16", 1024, 16), ("hp_bf16", 256, 4)])
def test_stages_and_l2_count(impl, taps, stages):
    assert framed_ozaki.stages_per_pair(impl, taps) == stages
    ks, cutoff = mel_kernel.pallas_schedule(impl)
    pairs = len(framed_ozaki.pair_table(ks, cutoff))
    got = framed_ozaki.l2_tile_bytes(impl, ks, cutoff, taps, 256, 191_872,
                                     64)
    assert got == 2998 * pairs * stages * 4 * framed_ozaki.TILE_BYTES


def test_main_path_l2_counts():
    """The counts in csrc/framed_ozaki.cu's header: 64 x 30 s at
    400/160/128 in 64-frame blocks."""
    k7 = framed_ozaki.l2_tile_bytes("hp_bf16", 5, 5, 400, 256, 191_872, 64)
    k6 = framed_ozaki.l2_tile_bytes("hp8", 4, 4, 400, 256, 191_872, 64)
    assert round(k7 / 1e9, 1) == 26.1 and round(k6 / 1e9, 1) == 10.2


def test_k7_refuses_planes_float16_cannot_hold():
    mats = mel_kernel.framed_matrices("hp_bf16", 400, 80, 16000.0, 5, 5, CPU)
    cs, ss = mats.planes
    with pytest.raises(ValueError, match="float16"):
        framed_ozaki.ring_tiles("hp_bf16", (cs * 1024.0, ss), 5, 5, 256, 400)


def test_launcher_refusals(monkeypatch):
    mats = mel_kernel.framed_matrices("hp8", 400, 80, 16000.0, 4, 4, CPU)
    fr = torch.zeros(64, 512)
    with pytest.raises(ValueError, match="CUDA frames"):
        framed_mel.ozaki_power(fr, mats)
    bf3 = mel_kernel.framed_matrices("bf3", 400, 80, 16000.0, 3, 2, CPU)
    with pytest.raises(ValueError, match="hp8 / hp_bf16"):
        framed_mel.ozaki_power(fr, bf3)
    with pytest.raises(ValueError, match="impl must be one of"):
        framed_mel.ozaki_power_reference(fr, bf3)
    # what does not fit a block's shared memory is refused by name (the
    # figure comes from the built library, stubbed here)
    monkeypatch.setattr(framed_ozaki, "plan", lambda impl, ks, taps, nmp:
                        (0, 300_000))
    with pytest.raises(NotImplementedError, match="shared memory"):
        framed_ozaki.run(fr, "hp8", mats.ring_tiles(400), mats.mt, ks=4,
                         cutoff=4, n_mels=80, taps=400)
    # the shared checks of every framed kernel
    with pytest.raises(ValueError, match="signal slices"):
        framed_mel._checked(fr, framed_mel.FramedMatrices(
            "hp8", mats.planes, mats.mt, 7, 4), n_mels=80, taps=400)
    with pytest.raises(ValueError, match="float32 frames"):
        framed_mel._checked(fr.double(), mats, n_mels=80, taps=400)
