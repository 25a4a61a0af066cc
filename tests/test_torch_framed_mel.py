"""The precision dial on the CPU, port vs JAX on the same numpy inputs:
the host builders of K5-K8 bit for bit; the kernels' plain versions
(``kernels/framed_mel.py``) against JAX's Pallas kernels in interpret mode
at K6/K7 1e-6 (their DFTs are exact integers) and K5/K8 2e-5 (float32
sums in another order); the JFK gates of ``tests/test_mel_kernel.py``;
``whisper_mel_pallas`` as a whole at whisper large-v3 width; the
converted JAX matrices; and the auto routes' choice on a CUDA device,
which takes K1 only where K1 takes the config's head."""

from pathlib import Path

import numpy as np
import pytest
import torch

from melspec_tpu.ops import mel_kernel as jmk
from melspec_tpu_torch import convert
from melspec_tpu_torch.config import BatchLogMelConfig, FbankConfig
from melspec_tpu_torch.io.wav import read_wav_f32le
from melspec_tpu_torch.kernels import framed_mel, sig_mel
from melspec_tpu_torch.ops import batch_logmel, fbank, mel_kernel, spectrogram

TESTDATA = Path(__file__).resolve().parents[1] / "testdata"
CPU = "cpu"
IMPLS = ("bf3", "hp8", "hp_bf16", "f32")
# against JAX's kernel: the Ozaki schemes' DFTs are exact integers (only
# the float32 projection's order differs); bf3 and f32 sum float32 dots
# in another order
TOL = {"bf3": 2e-5, "hp8": 1e-6, "hp_bf16": 1e-6, "f32": 2e-5}
# tests/test_mel_kernel.py's JFK gates (f32: the fused route's 1e-5)
JFK_GATE = {"bf3": 1e-5, "hp8": 2e-6, "hp_bf16": 1e-6, "f32": 1e-5}


def _noise(seed, shape):
    return (np.random.default_rng(seed).normal(size=shape) * 0.2).astype(
        np.float32)


def _bits(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.contiguous().view(torch.int16).numpy().view(np.uint16)
    return np.asarray(t).view(np.uint16)


@pytest.fixture(scope="module")
def jfk():
    return read_wav_f32le(TESTDATA / "jfk_f32le.wav")


@pytest.mark.parametrize("fft,n_mels,sr", [(400, 80, 16000.0),
                                           (400, 128, 16000.0),
                                           (1024, 80, 22050.0)])
def test_host_builders_bit_equal(fft, n_mels, sr):
    for g, w in zip(mel_kernel._build_matrices(fft, n_mels, sr),
                    jmk._build_matrices(fft, n_mels, sr)):
        np.testing.assert_array_equal(g, w)
    for ks, km, cutoff in [(3, 3, 2), (4, 4, 4), (6, 3, 2)]:
        assert mel_kernel._hp8_plane_widths(ks, km, cutoff) == \
            jmk._hp8_plane_widths(ks, km, cutoff)
        got = mel_kernel._hp8_device_matrices(fft, n_mels, sr, ks, km, cutoff)
        want = jmk._hp8_device_matrices(fft, n_mels, sr, ks, km, cutoff)
        assert len(got[0]) == len(want[0])
        for g, w in zip(got[0], want[0]):
            assert g.dtype == torch.int8
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        assert got[2:] == want[2:]
        got = mel_kernel._bf3_device_matrices(fft, n_mels, sr, ks, km, cutoff)
        want = jmk._bf3_device_matrices(fft, n_mels, sr, ks, km, cutoff)
        for g, w in zip(got[0], want[0]):
            np.testing.assert_array_equal(_bits(g), _bits(w))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for n in (3, 5):
        got = mel_kernel._hp_device_matrices(fft, n_mels, sr, n)
        want = jmk._hp_device_matrices(fft, n_mels, sr, n)
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_array_equal(_bits(g), _bits(w))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        assert got[3:] == want[3:]
    got = mel_kernel._f32_device_matrices(fft, n_mels, sr)
    want = jmk._f32_device_matrices(fft, n_mels, sr)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[3:] == want[3:]


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("fft,hop,n_mels,sr", [(400, 160, 80, 16000.0),
                                               (1024, 256, 80, 22050.0)])
@pytest.mark.parametrize("streaming", [False, True])
def test_plain_versions_match_jax_interpret(impl, fft, hop, n_mels, sr,
                                            streaming):
    """A ragged batch, both framings: the CPU route (float64 DFT dot) and
    the plain version with the card's float32 dot against JAX."""
    x = _noise(fft + len(impl), (3, 7001))
    want = np.asarray(jmk.whisper_mel_pallas(x, fft, hop, n_mels, sr,
                                             streaming=streaming, impl=impl,
                                             interpret=True))
    got = mel_kernel.whisper_mel_pallas(x, fft, hop, n_mels, sr,
                                        streaming=streaming, impl=impl,
                                        device=CPU).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL[impl]
    ks, cutoff = mel_kernel.pallas_schedule(impl)
    mats = mel_kernel.framed_matrices(impl, fft, n_mels, sr, ks, cutoff,
                                      torch.device(CPU))
    fr, nf = mel_kernel.framed_input(torch.from_numpy(x), fft, hop,
                                     streaming)
    assert fr.shape[0] % mel_kernel.TILE_FRAMES == 0 and nf == want.shape[1]
    f32 = framed_mel.framed_mel_reference(fr, mats, n_mels=n_mels).numpy()
    assert np.abs(f32[: 3 * nf].reshape(want.shape) - want).max() <= TOL[impl]


@pytest.mark.parametrize("impl", IMPLS)
def test_zero_frame_clips_and_1d_input(impl):
    for x in (np.zeros(399, np.float32), np.zeros((3, 100), np.float32)):
        for streaming in (False, True):
            want = np.asarray(jmk.whisper_mel_pallas(
                x, streaming=streaming, impl=impl, interpret=True))
            got = mel_kernel.whisper_mel_pallas(x, streaming=streaming,
                                                impl=impl, device=CPU)
            assert tuple(got.shape) == want.shape
    x = _noise(5, (6000,))
    one = mel_kernel.whisper_mel_pallas(x, impl=impl, device=CPU)
    assert torch.equal(one, mel_kernel.whisper_mel_pallas(
        x[None], impl=impl, device=CPU)[0])
    assert tuple(one.shape) == (36, 80)


@pytest.mark.parametrize("impl", IMPLS)
def test_jfk_gates(jfk, impl):
    golden = np.load(TESTDATA / "rust_jfk_golden.npy")
    got = mel_kernel.whisper_mel_pallas(jfk, 512, 160, 80, 16000.0,
                                        streaming=True, impl=impl,
                                        device=CPU).T.numpy()
    assert got.shape == golden.shape
    assert np.abs(got - golden).max() <= JFK_GATE[impl]


def test_hp_true_is_hp_bf16_and_its_clamp_matches_jax():
    """tests/test_mel_kernel.py: slices past the pair budget are clamped
    away, so (5, 2) equals (3, 2) exactly, in both packages."""
    x = _noise(4, (8000,))
    a = mel_kernel.whisper_mel_pallas(x, hp=True, hp_n_slices=5,
                                      hp_max_pair_sum=2, device=CPU)
    b = mel_kernel.whisper_mel_pallas(x, hp=True, hp_n_slices=3,
                                      hp_max_pair_sum=2, device=CPU)
    assert torch.equal(a, b)
    want = np.asarray(jmk.whisper_mel_pallas(x, hp=True, hp_n_slices=5,
                                             hp_max_pair_sum=2,
                                             interpret=True))
    assert np.abs(a.numpy() - want).max() <= 1e-6
    assert torch.equal(mel_kernel.whisper_mel_pallas(x, hp=True, device=CPU),
                       mel_kernel.whisper_mel_pallas(x, impl="hp_bf16",
                                                     device=CPU))


@pytest.mark.parametrize("impl", IMPLS)
def test_slice_at_large_v3_width(impl):
    """The slice as a whole: two short clips at 400/160/128 through
    ``whisper_mel_pallas``, against JAX's same ``impl``."""
    x = _noise(11, (2, 24000))
    want = np.asarray(jmk.whisper_mel_pallas(x, 400, 160, 128, 16000.0,
                                             impl=impl, interpret=True))
    got = mel_kernel.whisper_mel_pallas(x, 400, 160, 128, 16000.0,
                                        impl=impl, device=CPU).numpy()
    assert got.shape == want.shape == (2, 148, 128)
    assert np.abs(got - want).max() <= TOL[impl]


@pytest.mark.parametrize("impl,kw", [
    ("bf3", {}), ("bf3", dict(hp_n_slices=2, hp_max_pair_sum=1)),
    ("hp8", {}), ("hp_bf16", {}), ("hp_bf16", dict(hp_n_slices=4)),
    ("f32", {})])
def test_jax_matrices_carried_across(impl, kw):
    builder = {"bf3": jmk._bf3_device_matrices,
               "hp8": jmk._hp8_device_matrices,
               "hp_bf16": jmk._hp_device_matrices,
               "f32": jmk._f32_device_matrices}[impl]
    ks, cutoff = mel_kernel.pallas_schedule(impl, kw.get("hp_n_slices"),
                                            kw.get("hp_max_pair_sum"))
    args = {"bf3": (ks, ks, cutoff), "hp8": (ks, ks, cutoff),
            "hp_bf16": (ks,), "f32": ()}[impl]
    jax_mats = builder(400, 80, 16000.0, *args)
    as_np = [tuple(np.asarray(m) for m in t) if isinstance(t, tuple)
             else (t if isinstance(t, int) else np.asarray(t))
             for t in jax_mats]
    got = convert.from_jax_framed_matrices(impl, *as_np, **kw)
    own = mel_kernel.framed_matrices(impl, 400, 80, 16000.0, ks, cutoff,
                                     torch.device(CPU))
    assert (got.impl, got.ks, got.cutoff) == (own.impl, own.ks, own.cutoff)
    assert torch.equal(got.mt, own.mt)
    for g, o in zip(got.planes, own.planes, strict=True):
        assert g.dtype == o.dtype and torch.equal(g, o)
    x = _noise(6, (2, 5000))
    assert torch.equal(
        mel_kernel.whisper_mel_pallas(x, impl=impl, device=CPU,
                                      matrices=got, **kw),
        mel_kernel.whisper_mel_pallas(x, impl=impl, device=CPU, **kw))


def test_refusals():
    x = _noise(7, (4000,))
    with pytest.raises(ValueError, match="impl must be"):
        mel_kernel.whisper_mel_pallas(x, impl="f16", device=CPU)
    mats = mel_kernel.framed_matrices("hp8", 400, 80, 16000.0, 4, 4,
                                      torch.device(CPU))
    with pytest.raises(ValueError, match="FramedMatrices of impl"):
        mel_kernel.whisper_mel_pallas(x, impl="bf3", matrices=mats,
                                      device=CPU)
    with pytest.raises(ValueError, match="impl must be one of"):
        framed_mel.framed_mel(torch.zeros(32, 512), mats.__class__(
            "bf2", mats.planes, mats.mt), n_mels=80)
    with pytest.raises(ValueError, match="'bf3', 'hp8'"):
        convert.from_jax_framed_matrices("sig", None, None)


class _Smem:
    """Stands in for K1's shared-memory figure, which comes from the built
    kernel library (it needs nvcc): a fixed figure, and the calls."""

    def __init__(self):
        self.calls = []
        self.bytes = 100_000

    def __call__(self, *args):
        self.calls.append(args)
        return self.bytes


@pytest.fixture
def stub_smem(monkeypatch):
    stub = _Smem()
    monkeypatch.setattr(sig_mel, "_smem_bytes", stub)
    return stub


CUDA = torch.device("cuda")  # passed as a value: nothing runs on it


@pytest.mark.parametrize("fft,hop,n_mels,sr,k1", [
    (1024, 256, 80, 22050.0, False), (960, 480, 40, 48000.0, False),
    (256, 96, 32, 16000.0, False), (400, 160, 128, 16000.0, True),
    (512, 160, 80, 16000.0, True)])
def test_auto_whisper_routes_on_cuda(stub_smem, fft, hop, n_mels, sr, k1):
    """On a CUDA device the pipeline and ``whisper_mel_pallas(impl=None)``
    take K1 exactly where ``k1_accepts`` holds for the config's head (the
    whisper configs of tests/test_configs_broad.py whose heads are 1024 or
    256 columns wide take bf3 / K5); on the CPU they keep JAX's choice."""
    head = mel_kernel.whisper_head(fft, n_mels, sr, torch.device(CPU))
    accepts = sig_mel.k1_accepts(head, hop=hop)
    assert accepts == k1
    # the width check alone refuses the others
    assert bool(stub_smem.calls) == k1
    want = "sig" if accepts else "bf3"
    assert spectrogram.auto_fft_impl(fft, hop, n_mels, sr, torch.float32,
                                     CUDA) == want
    assert mel_kernel.resolve_pallas_impl(fft, hop, n_mels, sr,
                                          device=CUDA) == want
    assert spectrogram.auto_fft_impl(fft, hop, n_mels, sr, torch.float32,
                                     torch.device(CPU)) == "fft"
    assert mel_kernel.resolve_pallas_impl(fft, hop, n_mels, sr,
                                          device=CPU) == "sig"
    stub_smem.bytes = sig_mel.MAX_SMEM_BYTES + 1  # K1's span would not fit
    assert spectrogram.auto_fft_impl(fft, hop, n_mels, sr, torch.float32,
                                     CUDA) == "bf3"


@pytest.mark.parametrize("name,kind,cfg,k1", [
    ("fbank_8k", "fbank", FbankConfig(sample_rate=8000.0), False),
    ("nemo_8k", "nemo", BatchLogMelConfig(sample_rate=8000, n_fft=256,
                                          win_length=200, hop_length=80),
     False),
    ("fbank", "fbank", FbankConfig(), True),
    ("nemo", "nemo", BatchLogMelConfig(), True)])
def test_auto_ln_routes_on_cuda(stub_smem, name, kind, cfg, k1):
    """Fbank (and so Mfcc) and BatchLogMel take K1 on CUDA exactly where
    ``k1_accepts`` holds for their head; 8 kHz (256-point heads) takes
    rdft."""
    mod = fbank if kind == "fbank" else batch_logmel
    head = mod.sig_head(cfg)
    hop = cfg.frame_shift_samples if kind == "fbank" else cfg.hop_length
    assert sig_mel.k1_accepts(head, hop=hop) == k1
    assert mod.auto_fft_impl(cfg, torch.float32, CUDA) == \
        ("sig" if k1 else "rdft")
    assert mod.auto_fft_impl(cfg, torch.float32, torch.device(CPU)) == "rdft"
