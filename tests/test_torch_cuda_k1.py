"""K1 on the card against its plain PyTorch version, at every head width
(256, 512, 1024, 2048 columns) and block layout (128 and 64 frames, and
the factored path of the wide hops 2048/512 at 22.05 kHz, 1024/480 and
960/480 at 48 kHz, also against its own plain version) and the float64
FFT path of Kaldi fbank and NeMo log-mel at n_fft 2048 (44.1, 48, 64 and
80 kHz; Kaldi at 48 kHz also with preemphasis <= 0, DC removal alone) and
at n_fft 1024 (22.05 and 32 kHz, power and magnitude: the 1024-point
instance, a frame a warp).
Needs a CUDA device and nvcc; skipped elsewhere. On a machine with the
card (no JAX needed):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda_k1.py

The card counterpart of each test of the JAX package's
``tests/test_tpu_compiled.py`` (its gates with the kernels compiled):

- ``test_sig_kernel_jfk_golden_compiled``: ``test_sig_jfk_golden`` here;
- ``test_bf3_kernel_jfk_golden_compiled``,
  ``test_hp8_kernel_jfk_golden_compiled``,
  ``test_hp_kernel_jfk_golden_compiled``:
  ``tests/test_torch_cuda_framed.py::test_jfk_gates_through_the_kernels``;
- ``test_sig_geometry_edges_compiled``: ``test_sig_geometry_edges``;
- ``test_flat_input_parity_compiled`` (a TPU framing mode the port does
  not have): ``test_batch_rows_equal_single_clips``, K1's framing of a
  batch against its framing of each clip alone, bit for bit;
- ``test_multihead_pair_parity_compiled``:
  ``tests/test_torch_cuda_multihead.py::test_k2_two_heads_equal_k1``;
- ``test_vad_fields_parity_compiled``: ``test_vad_fields_parity``;
- ``test_npack_fbank_golden_compiled``:
  ``tests/test_torch_cuda_multihead.py::test_kaldi_jfk_gate_through_k1_and_k2``;
- ``test_resample_parity_compiled``: ``test_resample_parity``;
- ``test_quantized_emission_parity_compiled``:
  ``tests/test_torch_cuda_k1_epilogues.py::test_quantized_equals_quantize_frames_of_k1_mel``;
- ``test_mfcc_external_anchor_compiled``: ``test_mfcc_external_anchor``;
- ``test_resample_pallas_kernel_parity_compiled``:
  ``test_resample_kernel_parity``.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from melspec_tpu_torch.kernels import framed_mel, sig_mel, sig_multi
from melspec_tpu_torch.ops import framing, mel_kernel

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1 has no CPU mode)")
    return torch.device("cuda")


def _plain(x, mats, fft, hop, n_mels, streaming, precision,
           dot_dtype=torch.float32):
    offset = framing.streaming_frame_offset(fft, hop) if streaming else 0
    nf = (framing.num_frames_streaming(x.shape[-1], fft, hop) if streaming
          else framing.num_frames_batch(x.shape[-1], fft, hop))
    return sig_mel.sig_mel_reference(
        x, mats.head(fft, n_mels, precision), ks=3, n_frames=nf, hop=hop,
        offset=offset, dot_dtype=dot_dtype)


@pytest.mark.parametrize("fft,hop,n_mels", [(400, 160, 80), (400, 160, 128),
                                            (512, 160, 80), (320, 80, 64)])
@pytest.mark.parametrize("streaming", [False, True])
@pytest.mark.parametrize("precision", ["bf2", "highest"])
def test_k1_matches_plain(dev, fft, hop, n_mels, streaming, precision):
    """Against the exact result (the plain version's DFT dot in float64)
    at the 1e-5 gate; against the plain version's f32 matmul at 1e-5 plus
    that version's own distance from the exact result. fft 320 runs the
    split layout with 160 of its 256 bins per half in use."""
    x = torch.from_numpy((np.random.default_rng(fft + n_mels).normal(
        size=(3, 9137)) * 0.2).astype(np.float32)).to(dev)
    mats = mel_kernel.sig_matrices(fft, n_mels, 16000.0, 3, 2, dev)
    before = sig_mel.launches
    got = mel_kernel.whisper_mel_sig(x, fft, hop, n_mels, 16000.0,
                                     streaming=streaming,
                                     mel_precision=precision, device=dev)
    torch.cuda.synchronize()
    assert sig_mel.launches == before + 1
    want = _plain(x, mats, fft, hop, n_mels, streaming, precision)
    exact = _plain(x, mats, fft, hop, n_mels, streaming, precision,
                   torch.float64)
    assert got.shape == want.shape
    floor = float((want - exact).abs().max())
    assert float((got - exact).abs().max()) <= 1e-5
    assert float((got - want).abs().max()) <= 1e-5 + floor


def test_mel_batch_launches_k1_once_per_chunk(dev, monkeypatch):
    """One launch per batch chunk, and chunked output equals one launch."""
    from melspec_tpu_torch.ops.spectrogram import WhisperMelPipeline

    x = torch.from_numpy((np.random.default_rng(5).normal(
        size=(4, 16000)) * 0.2).astype(np.float32)).to(dev)
    pipe = WhisperMelPipeline(400, 160, 128, device=dev)
    assert pipe.fft_impl == "sig"
    before = sig_mel.launches
    whole = pipe.mel_batch(x)
    assert sig_mel.launches == before + 1
    per_clip = (16000 + whole.shape[1] * 128) * 4
    monkeypatch.setenv("MELSPEC_SIG_BUDGET_BYTES", str(2 * per_clip))
    chunked = pipe.mel_batch(x)
    torch.cuda.synchronize()
    assert sig_mel.launches == before + 3
    assert torch.equal(chunked, whole)


def test_k1_zero_frames_launch_nothing(dev):
    before = sig_mel.launches
    out = mel_kernel.whisper_mel_sig(torch.zeros(2, 100, device=dev),
                                     device=dev)
    assert tuple(out.shape) == (2, 0, 80) and sig_mel.launches == before


def test_k1_rejects_what_it_does_not_take(dev):
    head = mel_kernel.whisper_head(400, 80, 16000.0, dev)
    x = torch.zeros(1, 4000, device=dev)
    kw = dict(ks=3, n_frames=1, hop=160, offset=0)
    # a float32 projection of the bf2 stack's rows
    f32 = dataclasses.replace(head, mt=head.mt.to(torch.float32))
    with pytest.raises(ValueError, match="mt must be"):
        sig_mel.sig_mel(x, f32, **kw)
    with pytest.raises(ValueError, match="float32"):
        sig_mel.sig_mel(x.double(), head, **kw)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_multistream_sig_route_matches_plain(dev, n_mels):
    """K1 on the serving tick's route: ``MultiStreamMel(fft_impl="sig")``
    frames ``concat(hop_buf, chunks)`` at offset = hop into H frames, with
    a carried window, masked streams and H past one block's 64 frames;
    held against the plain version and the exact result on that concat,
    with the bars of test_k1_matches_plain."""
    from melspec_tpu_torch.config import MelConfig
    from melspec_tpu_torch.streaming.multistream import MultiStreamMel

    s = 5
    mel = MultiStreamMel(MelConfig(400, 160, n_mels, 16000.0), s,
                         fft_impl="sig", device=dev)
    head = mel._sig
    rng = np.random.default_rng(n_mels)
    st = mel.init()
    for h in (4, 1, 70):
        x = torch.from_numpy((rng.normal(size=(s, h * 160)) * 0.2).astype(
            np.float32)).to(dev)
        active = torch.tensor([True, True, h != 1, True, False], device=dev)
        concat = torch.cat([st.hop_buf, x], dim=1)
        before = sig_mel.launches
        st, _, got, _ = mel._push_many(st, x, active)
        torch.cuda.synchronize()
        assert sig_mel.launches == before + 1
        kw = dict(ks=3, n_frames=h, hop=160, offset=160)
        want = sig_mel.sig_mel_reference(concat, head, **kw)
        exact = sig_mel.sig_mel_reference(concat, head,
                                          dot_dtype=torch.float64, **kw)
        assert got.shape == want.shape == (s, h, n_mels)
        floor = float((want - exact).abs().max())
        assert float((got - exact).abs().max()) <= 1e-5
        assert float((got - want).abs().max()) <= 1e-5 + floor


WIDTH_CONFIGS = [(200, 80, 80, 8000.0), (256, 96, 32, 16000.0),
                 (1024, 256, 80, 22050.0)]


@pytest.mark.parametrize("fft,hop,n_mels,sr", WIDTH_CONFIGS)
@pytest.mark.parametrize("streaming", [False, True])
def test_k1_matches_plain_at_256_and_1024_columns(dev, fft, hop, n_mels, sr,
                                                  streaming):
    """The whisper heads of 256 (fft 200, 256) and 1024 (fft 1024)
    columns, walked in column chunks, at test_k1_matches_plain's bars."""
    head = mel_kernel.whisper_head(fft, n_mels, sr, dev)
    assert head.m_big.shape[1] in (256, 1024)
    assert sig_mel.k1_accepts(head, hop=hop)
    x = torch.from_numpy((np.random.default_rng(fft + hop).normal(
        size=(3, int(sr) + 37)) * 0.2).astype(np.float32)).to(dev)
    before = sig_mel.launches
    got = mel_kernel.whisper_mel_sig(x, fft, hop, n_mels, sr,
                                     streaming=streaming, device=dev)
    torch.cuda.synchronize()
    assert sig_mel.launches == before + 1
    offset = framing.streaming_frame_offset(fft, hop) if streaming else 0
    kw = dict(ks=3, n_frames=got.shape[1], hop=hop, offset=offset)
    want = sig_mel.sig_mel_reference(x, head, **kw)
    exact = sig_mel.sig_mel_reference(x, head, dot_dtype=torch.float64, **kw)
    assert got.shape == want.shape
    floor = float((want - exact).abs().max())
    assert float((got - exact).abs().max()) <= max(1e-5, floor)
    assert float((got - want).abs().max()) <= max(1e-5, floor) + floor


@pytest.mark.parametrize("fft,hop,n_mels,sr", WIDTH_CONFIGS)
def test_jfk_gate_at_256_and_1024_columns(dev, fft, hop, n_mels, sr):
    """The JFK clip through K1 at the 256- and 1024-column heads, held to
    the golden gate's 1e-5 against the float64 route of the same config
    (there is no golden at these configs)."""
    from pathlib import Path

    from melspec_tpu_torch.io.wav import read_wav_f32le
    from melspec_tpu_torch.ops.spectrogram import WhisperMelPipeline

    root = Path(__file__).resolve().parents[1]
    jfk = torch.as_tensor(read_wav_f32le(root / "testdata/jfk_f32le.wav"),
                          device=dev)[None]
    got = mel_kernel.whisper_mel_sig(jfk, fft, hop, n_mels, sr, device=dev)
    want = WhisperMelPipeline(fft, hop, n_mels, sr, dtype=torch.float64,
                              fft_impl="rdft", device=dev).mel_batch(
                                  jfk.double())
    assert got.shape == want.shape
    assert float((got.double() - want).abs().max()) <= 1e-5


# the wide hops: K1's factored path (2048/512 also its 2048 columns)
WIDE_CONFIGS = [(2048, 512, 128, 22050.0), (1024, 480, 64, 48000.0),
                (960, 480, 40, 48000.0)]
ROOT = Path(__file__).resolve().parents[1]


def _jfk(dev):
    from melspec_tpu_torch.io.wav import read_wav_f32le

    return torch.as_tensor(read_wav_f32le(ROOT / "testdata/jfk_f32le.wav"),
                           device=dev)


def _noise(dev, seed, shape, scale=0.2):
    return torch.from_numpy((np.random.default_rng(seed).normal(
        size=shape) * scale).astype(np.float32)).to(dev)


@pytest.mark.parametrize("fft,hop,n_mels,sr", WIDE_CONFIGS)
def test_k1_takes_the_wide_heads_on_its_factored_path(dev, fft, hop,
                                                      n_mels, sr):
    """``k1_accepts`` holds, and the built kernel reports the factored
    layout (64-frame blocks, 1024 DFT columns a chunk) within a block's
    shared memory where the host gives the head's split, and the 32-frame
    chunk walk without it; the VAD tile is 64; K2, which keeps to 1024
    columns and its 128- and 64-frame blocks, refuses these heads."""
    head = mel_kernel.whisper_head(fft, n_mels, sr, dev)
    assert sig_mel.k1_accepts(head, hop=hop)
    smem, frames, cols, factored = sig_mel.head_layout(head, hop)
    assert (frames, cols, factored) == (64, 1024, True)
    assert smem <= sig_mel.MAX_SMEM_BYTES
    bare = dataclasses.replace(head, dft_size=0)
    assert tuple(sig_mel.head_layout(bare, hop))[1:] == (32, 256, False)
    assert sig_mel.k1_vad_tile(head, hop, dev) == 64
    assert not sig_multi.k2_accepts((head,), hop=hop)


@pytest.mark.parametrize("fft,hop,n_mels,sr", WIDE_CONFIGS)
@pytest.mark.parametrize("streaming", [False, True])
@pytest.mark.parametrize("precision", ["bf2", "highest"])
def test_k1_factored_matches_its_plain_version(dev, fft, hop, n_mels, sr,
                                               streaming, precision):
    """The factored path (one launch of it) against its plain version
    ``sig_mel_factored_reference`` and the exact result (float64-dot
    ``sig_mel_reference``), on three ragged clips that end inside a
    64-frame tile: within max(2e-5, floor) of exact and that plus the
    floor of the plain version, the floor being the plain version's
    distance from exact (the bars of chip_smoke.py's phase wide_hops)."""
    head = mel_kernel.sig_matrices(fft, n_mels, sr, 3, 2, dev).head(
        fft, n_mels, precision)
    x = _noise(dev, fft + hop + 1, (3, int(sr) + 37))
    before = sig_mel.factored_launches
    got = mel_kernel.whisper_mel_sig(x, fft, hop, n_mels, sr,
                                     streaming=streaming,
                                     mel_precision=precision, device=dev)
    torch.cuda.synchronize()
    assert sig_mel.factored_launches == before + 1
    offset = framing.streaming_frame_offset(fft, hop) if streaming else 0
    nf = got.shape[1]
    assert nf % 64
    plain = sig_mel.sig_mel_factored_reference(x, head, n_frames=nf,
                                               hop=hop, offset=offset)
    exact = sig_mel.sig_mel_reference(x, head, ks=3, n_frames=nf, hop=hop,
                                      offset=offset, dot_dtype=torch.float64)
    floor = float((plain - exact).abs().max())
    bar = max(2e-5, floor)
    assert float((got - exact).abs().max()) <= bar
    assert float((got - plain).abs().max()) <= bar + floor


@pytest.mark.parametrize("fft,hop,n_mels,sr", [(2048, 512, 200, 22050.0),
                                              (1024, 480, 160, 48000.0)])
def test_k1_factored_at_256_mel_columns(dev, fft, hop, n_mels, sr):
    """The factored path's kernels for heads of 256 padded mel columns
    (both splits) against its plain version and the exact result, at the
    bars of test_k1_factored_matches_its_plain_version."""
    head = mel_kernel.whisper_head(fft, n_mels, sr, dev)
    assert head.mt.shape[1] == 256
    x = _noise(dev, n_mels, (2, int(sr) + 5))
    before = sig_mel.factored_launches
    got = mel_kernel.whisper_mel_sig(x, fft, hop, n_mels, sr, device=dev)
    torch.cuda.synchronize()
    assert sig_mel.factored_launches == before + 1
    nf = got.shape[1]
    plain = sig_mel.sig_mel_factored_reference(x, head, n_frames=nf,
                                               hop=hop, offset=0)
    exact = sig_mel.sig_mel_reference(x, head, ks=3, n_frames=nf, hop=hop,
                                      offset=0, dot_dtype=torch.float64)
    floor = float((plain - exact).abs().max())
    bar = max(2e-5, floor)
    assert float((got - exact).abs().max()) <= bar
    assert float((got - plain).abs().max()) <= bar + floor


@pytest.mark.parametrize("which", ["whisper_2048_512_matrices",
                                   "kaldi_48k_matrices"])
def test_k1_chunk_walk_in_32_frame_blocks(dev, which):
    """The heads the factored path does not take keep the 32-frame chunk
    walk: a wide whisper head's matrices without their DFT size, and
    Kaldi fbank's at 48 kHz without their FFT description (its
    preprocessing folded into the matrix, as matrices from elsewhere
    come: ``convert``'s), each against the dense plain version at K1's
    bars, with no factored launch."""
    from melspec_tpu_torch.config import FbankConfig
    from melspec_tpu_torch.ops.fbank import sig_head

    if which == "kaldi_48k_matrices":
        cfg = FbankConfig(sample_rate=48000.0, apply_cmn=False)
        head = dataclasses.replace(sig_head(cfg), dft_size=0,
                                   fft=None).to(dev)
        hop, sr = cfg.frame_shift_samples, 48e3
    else:
        w = mel_kernel.whisper_head(2048, 128, 22050.0, dev)
        head = dataclasses.replace(w, dft_size=0)
        hop, sr = 512, 22050.0
    assert tuple(sig_mel.head_layout(head, hop))[1:] == (32, 256, False)
    x = _noise(dev, hop, (2, int(sr) + 11))
    nf = framing.num_frames_batch(x.shape[-1], head.pack, hop)
    kw = dict(ks=3, n_frames=nf, hop=hop, offset=0)
    before = (sig_mel.launches, sig_mel.factored_launches)
    got = sig_mel.sig_mel(x, head, **kw)
    torch.cuda.synchronize()
    assert (sig_mel.launches, sig_mel.factored_launches) == (
        before[0] + 1, before[1])
    want = sig_mel.sig_mel_reference(x, head, **kw)
    exact = sig_mel.sig_mel_reference(x, head, dot_dtype=torch.float64, **kw)
    tol = 1e-5 if head.out_mode == "whisper" else 2e-4
    floor = float((want - exact).abs().max())
    assert float((got - exact).abs().max()) <= max(tol, floor)
    assert float((got - want).abs().max()) <= max(tol, floor) + floor


def _ln_front(kind, sr, n_mels, dev, preemph=0.97):
    """Kaldi fbank (with ``preemph``) or NeMo log-mel (n_fft 2048) at
    ``sr`` with ``n_mels``: ``(head on dev, hop, entry point or None,
    float64 rdft entry point)``; at 44.1 kHz the entry points have no sig
    route (no macro-row geometry), so the head alone."""
    from melspec_tpu_torch.config import BatchLogMelConfig, FbankConfig
    from melspec_tpu_torch.ops import batch_logmel, fbank

    if kind == "kaldi":
        cfg = FbankConfig(sample_rate=float(sr), num_mel_bins=n_mels,
                          preemphasis=preemph, apply_cmn=False)
        cls, head, hop = (fbank.Fbank, fbank.sig_head(cfg),
                          cfg.frame_shift_samples)
    else:
        cfg = BatchLogMelConfig(sample_rate=sr, n_fft=2048, n_mels=n_mels,
                                win_length=sr // 40, hop_length=sr // 100)
        cls, head, hop = (batch_logmel.BatchLogMel,
                          batch_logmel.sig_head(cfg), cfg.hop_length)
    front = cls(cfg, device=dev) if sr != 44100 else None
    f64 = cls(cfg, dtype=torch.float64, fft_impl="rdft", device=dev)
    return head.to(dev), hop, front, f64


def _clip(kind_of_clip, sr, dev, seed):
    """Three clips of 0.7 s: noise, noise with a 0.5 DC offset, three
    stretches of JFK band-limited to ``sr`` (nothing above 8 kHz: upsampled
    speech) or noise high-passed at 300 Hz (empty low bins)."""
    from melspec_tpu_torch.io.wav import read_wav_f32le

    n = int(sr * 0.7) + 37
    rng = np.random.default_rng(seed)
    if kind_of_clip in ("noise", "dc"):
        x = rng.normal(size=(3, n)) * 0.2 + (0.5 * (kind_of_clip == "dc"))
    elif kind_of_clip == "jfk":
        j = read_wav_f32le(Path(__file__).resolve().parent.parent
                           / "testdata" / "jfk_f32le.wav").astype(np.float64)
        m = int(round(len(j) * sr / 16000))
        up = np.fft.irfft(np.fft.rfft(j), m) * (m / len(j))
        x = np.stack([up[k * sr : k * sr + n] for k in range(3)])
    else:
        spec = np.fft.rfft(rng.normal(size=(3, n)) * 0.1, axis=-1)
        spec[:, : int(300 * n / sr)] = 0
        x = np.fft.irfft(spec, n, axis=-1)
    return torch.from_numpy(x.astype(np.float32)).to(dev)


@pytest.mark.parametrize("kind", ["kaldi", "nemo"])
@pytest.mark.parametrize("sr", [48000, 44100, 64000, 80000])
@pytest.mark.parametrize("clip", ["noise", "dc", "jfk", "high_passed"])
@pytest.mark.parametrize("n_mels", [80, 160])
def test_k1_fft_ln_heads(dev, kind, sr, clip, n_mels):
    """Kaldi fbank and NeMo log-mel at n_fft 2048 on K1's float64 FFT
    path (one launch, counted as such; at 48, 64 and 80 kHz through the
    auto route of ``Fbank`` / ``BatchLogMel``, at 44.1 kHz through
    ``sig_mel`` on the head) on noise, a 0.5 DC offset, JFK and
    high-passed noise: within 1e-5 of the path's plain version (the same
    float64 power; the projection's sums in another order); within 2e-4
    (chip_smoke.py's ``LN_TOL``) of the float64 rdft route of the same
    entry point, an independent float64 pipeline; and within 2e-4 plus
    their own distance from it of the dense plain version (the JAX
    kernel's float32 numerics) and of the exact result (its float64
    dot)."""
    _held_fft_head(dev, *_ln_front(kind, sr, n_mels, dev), kind, sr, clip,
                   n_mels)


@pytest.mark.parametrize("preemph", [-0.5, 0.0])
@pytest.mark.parametrize("clip", ["noise", "dc", "jfk", "high_passed"])
def test_k1_fft_kaldi_preemph_at_most_zero(dev, preemph, clip):
    """Kaldi fbank at 48 kHz with ``preemphasis <= 0`` (DC removal alone,
    as in JAX) through ``Fbank``'s auto route on the FFT path, at
    ``test_k1_fft_ln_heads``'s bars, and p = -0.5 equal to p = 0 bit for
    bit."""
    front_args = _ln_front("kaldi", 48000, 80, dev, preemph)
    assert front_args[0].fft.preemph == 0.0
    got = _held_fft_head(dev, *front_args, "kaldi", 48000, clip, 80)
    zero = _ln_front("kaldi", 48000, 80, dev, 0.0)[2]
    assert torch.equal(got, zero.compute(_clip(clip, 48000, dev, 48080)))


def _held_fft_head(dev, head, hop, front, f64, kind, sr, clip, n_mels):
    """One launch of K1 on ``head``'s FFT path on ``clip``, through
    ``front`` (or ``sig_mel`` where it is None), held at
    ``test_k1_fft_ln_heads``'s bars; returns its output."""
    assert tuple(sig_mel.head_layout(head, hop))[1:] == (1, 2048, False)
    x = _clip(clip, sr, dev, sr + n_mels)
    sig = x if kind == "kaldi" else torch.nn.functional.pad(x, (1024, 1024))
    nf = (framing.num_frames_batch(x.shape[-1], head.pack, hop)
          if kind == "kaldi" else framing.num_frames_centered(x.shape[-1],
                                                               hop))
    kw = dict(ks=3, n_frames=nf, hop=hop, offset=0)
    before = (sig_mel.launches, sig_mel.fft_launches,
              sig_mel.factored_launches)
    if front is None:
        got = sig_mel.sig_mel(sig, head, **kw)
    else:
        assert front.fft_impl == "sig"
        got = front.compute(x)
        if kind == "nemo":
            got = got.transpose(-1, -2)
    torch.cuda.synchronize()
    assert (sig_mel.launches, sig_mel.fft_launches,
            sig_mel.factored_launches) == (before[0] + 1, before[1] + 1,
                                           before[2])
    assert got.shape == (3, nf, n_mels) and bool(torch.isfinite(got).all())
    plain = sig_mel.sig_mel_fft_reference(sig, head, n_frames=nf, hop=hop,
                                          offset=0)
    truth = f64.compute(x.double())
    if kind == "nemo":
        truth = truth.transpose(-1, -2)
    dense = sig_mel.sig_mel_reference(sig, head, **kw)
    exact = sig_mel.sig_mel_reference(sig, head, dot_dtype=torch.float64, **kw)

    def dist(a, b):
        return float((a.double() - b.double()).abs().max())

    assert dist(got, plain) <= 1e-5
    assert dist(got, truth) <= 2e-4
    for other in (dense, exact):
        assert dist(got, other) <= 2e-4 + dist(other, truth)
    return got


def _fft_frames(kind, head, hop, x):
    """``(signal K1 reads, frames a clip)`` of ``x`` for ``head``: Kaldi's
    frames inside the clip, NeMo's centred on the padded signal."""
    if kind == "kaldi":
        return x, framing.num_frames_batch(x.shape[-1], head.pack, hop)
    return (torch.nn.functional.pad(x, (1024, 1024)),
            framing.num_frames_centered(x.shape[-1], hop))


@pytest.mark.parametrize("kind", ["kaldi", "nemo"])
@pytest.mark.parametrize("case", ["ragged", "fewer_than_groups"])
def test_k1_fft_frame_counts(dev, kind, case):
    """K1's FFT path where the frames are no multiple of the frames a
    block holds (``FFT_GROUPS[2048]``, one a group: 3 clips whose frames leave a
    remainder) and where the batch holds fewer frames than the card has
    groups (one clip of 0.05 s), within 1e-5 of the path's plain version
    (``test_k1_fft_ln_heads``'s bar), one launch on the path."""
    head, hop, _, _ = _ln_front(kind, 48000, 80, dev)
    groups = sig_mel.FFT_GROUPS[2048]
    batch, n = (3, 48000 // 2 + 37) if case == "ragged" else (1, 2400)
    while case == "ragged" and batch * _fft_frames(
            kind, head, hop, torch.zeros(1, n))[1] % groups == 0:
        n += 97
    x = _noise(dev, n + batch, (batch, n))
    sig, nf = _fft_frames(kind, head, hop, x)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if case == "ragged":
        assert batch * nf % groups
    else:
        assert batch * nf < sms * groups
    before = (sig_mel.launches, sig_mel.fft_launches)
    got = sig_mel.sig_mel(sig, head, ks=3, n_frames=nf, hop=hop, offset=0)
    torch.cuda.synchronize()
    assert (sig_mel.launches, sig_mel.fft_launches) == (before[0] + 1,
                                                        before[1] + 1)
    plain = sig_mel.sig_mel_fft_reference(sig, head, n_frames=nf, hop=hop,
                                          offset=0)
    assert got.shape == (batch, nf, 80) and bool(torch.isfinite(got).all())
    assert float((got.double() - plain.double()).abs().max()) <= 1e-5


def _front_1024(kind, sr, magnitude, dev):
    """Kaldi fbank (preemphasis 0.97) or NeMo log-mel at n_fft 1024 (25 ms
    frames, 10 ms hop) at ``sr``, power or magnitude spectra: ``(head on
    dev, hop, entry point or None, float64 rdft entry point)``; at 22.05
    kHz (hops 220 / 221) the entry points have no macro-row geometry, so
    the head alone."""
    from melspec_tpu_torch.config import BatchLogMelConfig, FbankConfig
    from melspec_tpu_torch.ops import batch_logmel, fbank

    if kind == "kaldi":
        cfg = FbankConfig(sample_rate=float(sr), use_power=not magnitude,
                          apply_cmn=False)
        cls, head, hop = (fbank.Fbank, fbank.sig_head(cfg),
                          cfg.frame_shift_samples)
    else:
        cfg = BatchLogMelConfig(sample_rate=sr, n_fft=1024,
                                win_length=round(0.025 * sr),
                                hop_length=round(0.01 * sr),
                                mag_power=1.0 if magnitude else 2.0)
        cls, head, hop = (batch_logmel.BatchLogMel,
                          batch_logmel.sig_head(cfg), cfg.hop_length)
    front = cls(cfg, device=dev) if sr != 22050 else None
    f64 = cls(cfg, dtype=torch.float64, fft_impl="rdft", device=dev)
    return head.to(dev), hop, front, f64


@pytest.mark.parametrize("kind", ["kaldi", "nemo"])
@pytest.mark.parametrize("sr", [22050, 32000])
@pytest.mark.parametrize("magnitude", [False, True])
@pytest.mark.parametrize("clip", ["noise", "jfk"])
def test_k1_fft_1024_instance(dev, kind, sr, magnitude, clip):
    """Kaldi fbank and NeMo log-mel at n_fft 1024 (power and magnitude
    spectra) on the float64 FFT path's 1024-point instance, one launch
    counted as an FFT launch (and a magnitude launch where the head is
    one; at 32 kHz through the entry point's auto route, at 22.05 kHz
    through ``sig_mel`` on the head), on 3 clips of noise or JFK
    band-limited to ``sr`` whose frames (3 F in all) fill no whole block
    of ``FFT_GROUPS[1024]`` warps and whose last frame ends at the clip's
    last sample (NeMo: the centred pad's): within 1e-5 of the path's
    plain version, within 2e-4 of the float64 rdft route, and within 2e-4
    plus their own distance from it of the dense plain version and of the
    exact result."""
    head, hop, front, f64 = _front_1024(kind, sr, magnitude, dev)
    assert tuple(sig_mel.head_layout(head, hop))[1:] == (1, 1024, False)
    assert head.magnitude == magnitude and head.fft.size == 1024
    frames = 67
    assert 3 * frames % sig_mel.FFT_GROUPS[1024]
    n = (head.pack + hop * (frames - 1) if kind == "kaldi"
         else hop * (frames - 1))
    x = _clip(clip, sr, dev, sr + 1024 + magnitude)
    while x.shape[-1] < n:
        x = torch.cat([x, x], dim=-1)
    x = x[:, :n].contiguous()
    sig, nf = ((x, framing.num_frames_batch(n, head.pack, hop))
               if kind == "kaldi" else
               (torch.nn.functional.pad(x, (512, 512)),
                framing.num_frames_centered(n, hop)))
    assert nf == frames
    # the last frame's taps (Kaldi) or its DFT's span (NeMo) end where the
    # signal K1 reads ends
    assert hop * (nf - 1) + (head.pack if kind == "kaldi" else 1024) == (
        sig.shape[-1])
    kw = dict(ks=3, n_frames=nf, hop=hop, offset=0)
    before = (sig_mel.launches, sig_mel.fft_launches,
              sig_mel.magnitude_launches, sig_mel.factored_launches)
    if front is None:
        got = sig_mel.sig_mel(sig, head, **kw)
    else:
        assert front.fft_impl == "sig"
        got = front.compute(x)
        if kind == "nemo":
            got = got.transpose(-1, -2)
    torch.cuda.synchronize()
    assert (sig_mel.launches, sig_mel.fft_launches,
            sig_mel.magnitude_launches, sig_mel.factored_launches) == (
        before[0] + 1, before[1] + 1, before[2] + int(magnitude), before[3])
    assert got.shape == (3, nf, head.n_mels)
    assert bool(torch.isfinite(got).all())
    plain = sig_mel.sig_mel_fft_reference(sig, head, n_frames=nf, hop=hop,
                                          offset=0)
    truth = f64.compute(x.double())
    if kind == "nemo":
        truth = truth.transpose(-1, -2)
    dense = sig_mel.sig_mel_reference(sig, head, **kw)
    exact = sig_mel.sig_mel_reference(sig, head, dot_dtype=torch.float64, **kw)

    def dist(a, b):
        return float((a.double() - b.double()).abs().max())

    assert dist(got, plain) <= 1e-5
    assert dist(got, truth) <= 2e-4
    for other in (dense, exact):
        assert dist(got, other) <= 2e-4 + dist(other, truth)


@pytest.mark.parametrize("kind", ["kaldi", "nemo"])
def test_k1_fft_launches_bit_equal(dev, kind):
    """Two launches of K1's FFT path on the same input are equal bit for
    bit (each group's sums in a fixed order: no atomics, no order that
    depends on timing), on a batch whose frames spread over every group
    of the card."""
    head, hop, _, _ = _ln_front(kind, 48000, 80, dev)
    sig, nf = _fft_frames(kind, head, hop, _noise(dev, 5, (8, 48000 * 3)))
    kw = dict(ks=3, n_frames=nf, hop=hop, offset=0)
    first = sig_mel.sig_mel(sig, head, **kw)
    second = sig_mel.sig_mel(sig, head, **kw)
    assert torch.equal(first, second)


@pytest.mark.parametrize("kind", ["kaldi", "nemo"])
def test_k1_fft_ln_heads_raise_without_it(dev, kind, monkeypatch):
    """No fallback hides the float64 FFT path of the Kaldi and NeMo
    heads: where its launch fails, the call raises instead of taking the
    chunk walk or the composition."""
    head, hop, front, _ = _ln_front(kind, 48000, 80, dev)
    real = sig_mel._bound()

    class Failing:
        def __getattr__(self, name):
            return getattr(real, name)

        @staticmethod
        def melspec_sig_mel_fft(*args):
            return 1  # cudaErrorInvalidValue

    monkeypatch.setattr(sig_mel, "_bound", lambda: Failing())
    x = _noise(dev, 3, (2, 48000))
    before = sig_mel.launches
    with pytest.raises(RuntimeError, match="K1"):
        front.compute(x)
    assert sig_mel.launches == before


@pytest.mark.parametrize("fft,hop,n_mels,sr", WIDE_CONFIGS)
def test_k1_wide_heads_raise_without_the_factored_path(dev, fft, hop,
                                                       n_mels, sr,
                                                       monkeypatch):
    """No fallback hides the factored path: where its launch fails, the
    call raises instead of taking the 32-frame chunk walk or K5."""
    real = sig_mel._bound()

    class Failing:
        def __getattr__(self, name):
            return getattr(real, name)

        @staticmethod
        def melspec_sig_mel_factored(*args):
            return 1  # cudaErrorInvalidValue

    monkeypatch.setattr(sig_mel, "_bound", lambda: Failing())
    x = _noise(dev, fft, (2, int(sr)))
    before = sig_mel.launches
    with pytest.raises(RuntimeError, match="K1"):
        mel_kernel.whisper_mel_sig(x, fft, hop, n_mels, sr, device=dev)
    assert sig_mel.launches == before


@pytest.mark.parametrize("fft,hop,n_mels,sr", WIDE_CONFIGS)
@pytest.mark.parametrize("streaming", [False, True])
def test_k1_matches_plain_at_the_wide_heads(dev, fft, hop, n_mels, sr,
                                            streaming):
    """At test_k1_matches_plain_at_256_and_1024_columns's bars (the dense
    plain version's), on three ragged clips that end inside a 32-frame
    block, through the factored path."""
    head = mel_kernel.whisper_head(fft, n_mels, sr, dev)
    x = _noise(dev, fft + hop, (3, int(sr) + 37))
    before = sig_mel.launches
    got = mel_kernel.whisper_mel_sig(x, fft, hop, n_mels, sr,
                                     streaming=streaming, device=dev)
    torch.cuda.synchronize()
    assert sig_mel.launches == before + 1
    offset = framing.streaming_frame_offset(fft, hop) if streaming else 0
    kw = dict(ks=3, n_frames=got.shape[1], hop=hop, offset=offset)
    want = sig_mel.sig_mel_reference(x, head, **kw)
    exact = sig_mel.sig_mel_reference(x, head, dot_dtype=torch.float64, **kw)
    assert got.shape == want.shape and got.shape[1] % 32
    floor = float((want - exact).abs().max())
    assert float((got - exact).abs().max()) <= max(1e-5, floor)
    assert float((got - want).abs().max()) <= max(1e-5, floor) + floor


@pytest.mark.parametrize("fft,hop,n_mels,sr", WIDE_CONFIGS)
def test_jfk_gate_at_the_wide_heads(dev, fft, hop, n_mels, sr):
    """The JFK clip through K1 at the wide heads within 1e-5 of the
    float64 route of the same config, and within max(1e-5, floor) + floor
    of the factored plain version, the floor being that plain version's
    distance from the exact result (float64-dot ``sig_mel_reference``):
    the kernel computes its plain version's schedule, whatever that
    schedule's own distance from float64."""
    from melspec_tpu_torch.ops.spectrogram import WhisperMelPipeline

    jfk = _jfk(dev)[None]
    got = mel_kernel.whisper_mel_sig(jfk, fft, hop, n_mels, sr, device=dev)
    want = WhisperMelPipeline(fft, hop, n_mels, sr, dtype=torch.float64,
                              fft_impl="rdft", device=dev).mel_batch(
                                  jfk.double())
    assert got.shape == want.shape
    assert float((got.double() - want).abs().max()) <= 1e-5
    head = mel_kernel.whisper_head(fft, n_mels, sr, dev)
    nf = got.shape[1]
    plain = sig_mel.sig_mel_factored_reference(jfk, head, n_frames=nf,
                                               hop=hop, offset=0)
    exact = sig_mel.sig_mel_reference(jfk, head, ks=3, n_frames=nf, hop=hop,
                                      offset=0, dot_dtype=torch.float64)
    floor = float((plain - exact).abs().max())
    assert float((got - plain).abs().max()) <= max(1e-5, floor) + floor


@pytest.mark.parametrize("fft,hop,n_mels,sr", WIDE_CONFIGS)
@pytest.mark.parametrize("streaming", [False, True])
def test_wide_head_epilogues_are_exact(dev, fft, hop, n_mels, sr,
                                       streaming):
    """The VAD epilogue on the factored path: its mel is K1's, its raw
    equals ``classify_columns`` of that mel (the columns at every 64-frame
    boundary recomputed), its counts ``tile_vad_counts`` at the launch's
    tile (``k1_vad_tile``: 64); the u8 records equal ``quantize_frames``
    of K1's mel."""
    from melspec_tpu_torch.config import DetectionSettings
    from melspec_tpu_torch.ops.quant import quantize_frames
    from melspec_tpu_torch.ops.vad import classify_columns

    settings = DetectionSettings()
    x = _noise(dev, fft, (3, 2 * int(sr) + 11), 0.3)
    mel = mel_kernel.whisper_mel_sig(x, fft, hop, n_mels, sr,
                                     streaming=streaming, device=dev)
    before = dict(sig_mel.epilogue_launches)
    mel_v, raw = mel_kernel.whisper_mel_vad_sig(x, settings, fft, hop,
                                                n_mels, sr,
                                                streaming=streaming,
                                                device=dev)
    q = mel_kernel.whisper_mel_quantized(x, fft, hop, n_mels, sr,
                                         streaming=streaming, device=dev)
    torch.cuda.synchronize()
    assert sig_mel.epilogue_launches == {"quant": before["quant"] + 1,
                                         "vad": before["vad"] + 1}
    assert torch.equal(mel_v, mel)
    assert torch.equal(raw, classify_columns(mel.transpose(-1, -2),
                                             settings))
    for a, b in zip(q, quantize_frames(mel)):
        assert torch.equal(a, b)
    head = mel_kernel.whisper_head(fft, n_mels, sr, dev)
    vad = sig_mel.vad_args(settings, n_mels)
    offset = framing.streaming_frame_offset(fft, hop) if streaming else 0
    k_mel, counts = sig_mel.sig_mel_vad(x, head, ks=3, n_frames=mel.shape[1],
                                        hop=hop, offset=offset, vad=vad)
    tile = sig_mel.k1_vad_tile(head, hop, dev)
    assert tile == 64
    assert torch.equal(k_mel, mel)
    assert torch.equal(counts, sig_mel.tile_vad_counts(mel, *vad, tile))


@pytest.mark.parametrize("streaming", [False, True])
def test_chunk_walk_epilogues_are_exact(dev, streaming):
    """The epilogues in the chunk walk's 32-frame blocks, through the
    entry points at a whisper head with no factored split (1000/480 at
    48 kHz): the VAD route's raw equals
    ``classify_columns`` of K1's mel (the columns at every 32-frame
    boundary recomputed), K1's counts ``tile_vad_counts`` at tile 32, the
    u8 records ``quantize_frames`` of the mel; no factored launch."""
    from melspec_tpu_torch.config import DetectionSettings
    from melspec_tpu_torch.ops.quant import quantize_frames
    from melspec_tpu_torch.ops.vad import classify_columns

    fft, hop, n_mels, sr = 1000, 480, 80, 48000.0
    head = mel_kernel.whisper_head(fft, n_mels, sr, dev)
    assert tuple(sig_mel.head_layout(head, hop))[1:] == (32, 256, False)
    assert sig_mel.k1_vad_tile(head, hop, dev) == 32
    settings = DetectionSettings()
    x = _noise(dev, fft, (3, 2 * int(sr) + 11), 0.3)
    before = (sig_mel.factored_launches, dict(sig_mel.epilogue_launches))
    mel = mel_kernel.whisper_mel_sig(x, fft, hop, n_mels, sr,
                                     streaming=streaming, device=dev)
    mel_v, raw = mel_kernel.whisper_mel_vad_sig(x, settings, fft, hop,
                                                n_mels, sr,
                                                streaming=streaming,
                                                device=dev)
    q = mel_kernel.whisper_mel_quantized(x, fft, hop, n_mels, sr,
                                         streaming=streaming, device=dev)
    torch.cuda.synchronize()
    assert sig_mel.factored_launches == before[0]
    assert sig_mel.epilogue_launches == {"quant": before[1]["quant"] + 1,
                                         "vad": before[1]["vad"] + 1}
    assert mel.shape[1] > 64 and torch.equal(mel_v, mel)
    assert torch.equal(raw, classify_columns(mel.transpose(-1, -2),
                                             settings))
    for a, b in zip(q, quantize_frames(mel)):
        assert torch.equal(a, b)
    vad = sig_mel.vad_args(settings, n_mels)
    offset = framing.streaming_frame_offset(fft, hop) if streaming else 0
    k_mel, counts = sig_mel.sig_mel_vad(x, head, ks=3, n_frames=mel.shape[1],
                                        hop=hop, offset=offset, vad=vad)
    assert torch.equal(k_mel, mel)
    assert torch.equal(counts, sig_mel.tile_vad_counts(mel, *vad, 32))


@pytest.mark.parametrize("fft,hop,n_mels,sr", WIDE_CONFIGS)
def test_auto_routes_launch_k1_at_the_wide_heads(dev, fft, hop, n_mels,
                                                 sr):
    """``WhisperMelPipeline``'s and ``whisper_mel_pallas(impl=None)``'s
    auto routes take K1 at the wide heads: one K1 launch each, no K5."""
    from melspec_tpu_torch.ops.spectrogram import WhisperMelPipeline

    x = _noise(dev, 3, (2, int(sr)))
    pipe = WhisperMelPipeline(fft, hop, n_mels, sr, device=dev)
    assert pipe.fft_impl == "sig"
    assert mel_kernel.resolve_pallas_impl(fft, hop, n_mels, sr,
                                          device=dev) == "sig"
    before = (sig_mel.launches, dict(framed_mel.launches))
    a = pipe.mel_batch(x)
    b = mel_kernel.whisper_mel_pallas(x, fft, hop, n_mels, sr, device=dev)
    torch.cuda.synchronize()
    assert sig_mel.launches == before[0] + 2
    assert framed_mel.launches == before[1]
    assert torch.equal(a, b)


def test_sig_jfk_golden(dev):
    """The default route of ``whisper_mel_pallas`` at the master golden's
    config (512/160/80, streaming) is K1 and holds the 1e-5 bar."""
    golden = np.load(ROOT / "testdata/rust_jfk_golden.npy")
    before = sig_mel.launches
    got = mel_kernel.whisper_mel_pallas(_jfk(dev), 512, 160, 80, 16000.0,
                                        streaming=True, device=dev)
    torch.cuda.synchronize()
    assert sig_mel.launches == before + 1
    got = got.T.cpu().numpy()
    assert got.shape == golden.shape
    assert np.abs(got - golden).max() <= 1e-5


def _host_f64_whisper_mel(x: np.ndarray) -> np.ndarray:
    """The batch whisper mel (400/160/80) in float64 numpy."""
    from melspec_tpu_torch.ops.filterbank import mel_filterbank
    from melspec_tpu_torch.ops.windows import hann_periodic

    fft, hop, n_mels = 400, 160, 80
    nf = (len(x) - fft) // hop + 1
    idx = np.arange(nf)[:, None] * hop + np.arange(fft)
    frames = x.astype(np.float64)[idx] * hann_periodic(fft)
    spec = np.fft.rfft(frames, axis=-1)[:, : fft // 2]
    power = spec.real**2 + spec.imag**2
    filters = mel_filterbank(16000.0, fft, n_mels)[:, : fft // 2]
    log_mel = np.log10(np.maximum(power @ filters.T, 1e-10))
    mmax = log_mel.max(axis=-1, keepdims=True) - 8.0
    return (np.maximum(log_mel, mmax) + 4.0) / 4.0


@pytest.mark.parametrize("n", [640 * 129 + 7, 16000, 400, 160 * 127 + 400])
def test_sig_geometry_edges(dev, n):
    """Clip lengths around K1's block boundaries (a ragged last block, a
    single frame, exactly 128 frames) against float64 numpy at 1e-5."""
    x = (np.random.default_rng(3).normal(size=n) * 0.3).astype(np.float32)
    got = mel_kernel.whisper_mel_sig(x, 400, 160, 80, 16000.0,
                                     device=dev).cpu().numpy()
    ref = _host_f64_whisper_mel(x)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-5


def test_batch_rows_equal_single_clips(dev):
    """K1 frames a ``[B, T]`` batch in place: each clip's rows of one
    launch over 8 clips equal the launch over that clip alone, bit for
    bit (streaming, offset 80)."""
    x = _noise(dev, 2, (8, 5 * 16000), 0.1)
    rows = mel_kernel.whisper_mel_sig(x, streaming=True, device=dev)
    assert tuple(rows.shape) == (8, 498, 80)
    for i in range(8):
        one = mel_kernel.whisper_mel_sig(x[i : i + 1], streaming=True,
                                         device=dev)
        assert torch.equal(rows[i : i + 1], one)


def test_vad_fields_parity(dev):
    """The batched decision fields on K1's VAD raw equal the host float64
    fields of K1's mel, decision for decision (JFK, streaming)."""
    from melspec_tpu_torch.config import DetectionSettings
    from melspec_tpu_torch.ops.vad import (streaming_decision_fields,
                                           streaming_decision_fields_batched)

    settings = DetectionSettings()
    mel, raw = mel_kernel.whisper_mel_vad_sig(_jfk(dev)[None], settings,
                                              streaming=True, device=dev)
    got = streaming_decision_fields_batched(None, settings, raw=raw)
    img = mel.transpose(-1, -2)[0].double().cpu().numpy()
    want = streaming_decision_fields(img, settings)
    assert want is not None
    for k in ("active", "active_columns", "leading"):
        np.testing.assert_array_equal(got[k][0].cpu().numpy(), want[k])


@pytest.mark.parametrize("up,down", [(1, 3), (160, 441)])
def test_resample_parity(dev, up, down):
    """``resample_poly`` on the card against the float64 host polyphase
    resampler at 1e-5 x scale (48 k and 44.1 k to 16 k)."""
    from melspec_tpu_torch.ops.resample import (StreamingResampler,
                                                resample_poly)

    x = _jfk(dev).cpu().numpy()[: 16000 * 3]
    host = StreamingResampler(up, down, dtype=np.float64)
    ref = np.concatenate([host.push(x.astype(np.float64)), host.flush()])
    got = resample_poly(x, up, down, device=dev).cpu().numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("precision", ["highest", "bf3"])
@pytest.mark.parametrize("up,down", [(1, 3), (2, 1)])
def test_resample_kernel_parity(dev, precision, up, down):
    """K3 through ``MultiStreamResampler(impl="kernel")`` against the
    float64 host resampler after the warm-up prefix, at 1e-5 x scale."""
    from melspec_tpu_torch.kernels import resample as kres
    from melspec_tpu_torch.ops.resample import StreamingResampler
    from melspec_tpu_torch.streaming.resample import MultiStreamResampler

    n = down * 128 * 25
    x = np.tile(_jfk(dev).cpu().numpy()[:n], (8, 1))
    mr = MultiStreamResampler(up, down, 8, align=160, impl="kernel",
                              precision=precision, device=dev)
    before = sum(kres.launches.values())
    _, y = mr.push(mr.init(), x)
    assert sum(kres.launches.values()) == before + 1
    got = y[0, mr.spurious_out:]
    ref = StreamingResampler(up, down, dtype=np.float64).push(
        x[0].astype(np.float64))
    m = min(len(got), len(ref))
    assert m > 1000
    assert np.abs(got[:m] - ref[:m]).max() <= 1e-5 * np.abs(ref).max()


def test_mfcc_external_anchor(dev):
    """MFCC over K1's fbank route holds the kaldi_native_fbank anchor of
    tests/test_torch_mfcc.py (the lifted DCT-II of the vendored golden in
    float64)."""
    from melspec_tpu_torch.config import FbankConfig, MfccConfig
    from melspec_tpu_torch.ops.mfcc import (Mfcc, cepstral_lifter_coeffs,
                                            dct_matrix)

    with np.load(ROOT / "testdata/kaldi_native_fbank_jfk.npz") as npz:
        gfb = npz["features"].T.astype(np.float64)
    before = sig_mel.launches
    got = Mfcc(MfccConfig(fbank=FbankConfig(apply_cmn=False)),
               fft_impl="sig", device=dev).compute(_jfk(dev))
    torch.cuda.synchronize()
    assert sig_mel.launches == before + 1
    got = got.cpu().numpy()
    m = dct_matrix(13, 80) * cepstral_lifter_coeffs(13, 22.0)[:, None]
    want = gfb @ m.T
    d = np.abs(got - want)
    assert d.max() < 0.2 and d.mean() < 0.03
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.99999


def _pipe_heads(dev):
    """K1's heads on its pipelined 128-frame walk: whisper 400/160 at 80
    and 128 mels (split) and NeMo's ln head (512/400/80, N-packed, taps at
    ``pack_off`` 56)."""
    from melspec_tpu_torch.ops.batch_logmel import BatchLogMel

    return {"whisper_80": mel_kernel.whisper_head(400, 80, 16000.0, dev),
            "whisper_128": mel_kernel.whisper_head(400, 128, 16000.0, dev),
            "nemo": BatchLogMel(fft_impl="sig", device=dev).sig_head}


# (clips, samples): one clip of one tile; 133 clips of one tile (an odd
# tile count, more blocks than the card's SMs); a frame count that is no
# multiple of 128
PIPE_SHAPES = [(1, 16000 + 37), (133, 16000 + 37), (3, 16000 * 5 + 1234)]


@pytest.mark.parametrize("shape", PIPE_SHAPES)
@pytest.mark.parametrize("which", ["whisper_80", "whisper_128", "nemo"])
def test_k1_pipelined_equals_k2(dev, which, shape):
    """K1 on its pipelined walk equals K2's output of the same head (K2's
    own kernel, on the pipelined walk too, summing in the same order) bit
    for bit, at ragged shapes."""
    head = _pipe_heads(dev)[which]
    assert sig_mel.head_layout(head, 160).pipelined
    x = torch.from_numpy((np.random.default_rng(sum(shape)).normal(
        size=shape) * 0.2).astype(np.float32)).to(dev)
    nf = framing.num_frames_batch(shape[1], 400, 160)
    kw = dict(ks=3, n_frames=nf, hop=160, offset=0)
    before = (sig_mel.launches, sig_mel.pipelined_launches)
    k1 = sig_mel.sig_mel(x, head, **kw)
    (k2,), _ = sig_multi.sig_multi(x, [head], **kw)
    torch.cuda.synchronize()
    assert (sig_mel.launches, sig_mel.pipelined_launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(k1, k2)


@pytest.mark.parametrize("shape", PIPE_SHAPES)
def test_k1_pipelined_epilogues_equal_k2(dev, shape):
    """The VAD and quant epilogues on the pipelined walk: K1's mel and
    counts equal K2's (head 0 with the VAD epilogue), and K1's records
    equal ``quantize_frames`` of K2's mel, bit for bit."""
    from melspec_tpu_torch.config import DetectionSettings
    from melspec_tpu_torch.ops.quant import quantize_frames

    head = _pipe_heads(dev)["whisper_128"]
    x = torch.from_numpy((np.random.default_rng(sum(shape) + 1).normal(
        size=shape) * 0.2).astype(np.float32)).to(dev)
    nf = framing.num_frames_batch(shape[1], 400, 160)
    kw = dict(ks=3, n_frames=nf, hop=160, offset=0)
    vad = sig_mel.vad_args(DetectionSettings(), head.n_mels)
    before = sig_mel.pipelined_launches
    mel, counts = sig_mel.sig_mel_vad(x, head, vad=vad, **kw)
    q, lo, hi = sig_mel.sig_mel_quantized(x, head, **kw)
    (k2,), k2_counts = sig_multi.sig_multi(x, [head], vad=vad, **kw)
    torch.cuda.synchronize()
    assert sig_mel.pipelined_launches == before + 2
    assert torch.equal(mel, k2) and torch.equal(counts, k2_counts)
    wq, wlo, whi = quantize_frames(k2)
    assert torch.equal(q, wq) and torch.equal(lo, wlo)
    assert torch.equal(hi, whi)


def test_pipelined_launches_count_where_the_walk_runs(dev):
    """``sig_mel.pipelined_launches`` counts whisper 400/160/128's and
    NeMo 512/400/80's launches, which take the pipelined walk, and not a
    head of 256 mels, which keeps the 64-frame blocks."""
    from melspec_tpu_torch.ops.batch_logmel import BatchLogMel

    x = torch.from_numpy((np.random.default_rng(5).normal(
        size=(2, 16000 * 3)) * 0.2).astype(np.float32)).to(dev)
    for run in (lambda: mel_kernel.whisper_mel_sig(x, 400, 160, 128,
                                                  device=dev),
                lambda: BatchLogMel(fft_impl="sig", device=dev).compute(x)):
        before = (sig_mel.launches, sig_mel.pipelined_launches)
        run()
        assert (sig_mel.launches, sig_mel.pipelined_launches) == (
            before[0] + 1, before[1] + 1)
    wide = mel_kernel.whisper_head(400, 256, 16000.0, dev)
    assert not sig_mel.head_layout(wide, 160).pipelined
    assert sig_mel.head_layout(wide, 160).frames == 64
    before = (sig_mel.launches, sig_mel.pipelined_launches)
    mel_kernel.whisper_mel_sig(x, 400, 160, 256, device=dev)
    assert (sig_mel.launches, sig_mel.pipelined_launches) == (
        before[0] + 1, before[1])
