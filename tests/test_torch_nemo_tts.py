"""NeMo's TTS mel at the ``nemo-tts-22k`` configuration's settings
(``portbench/configs/nemo-tts-22k.json``: 22.05 kHz, 1024 / 1024 / 256,
80 Slaney mels to 8 kHz, the magnitude, ``ln(max(e, 1e-5))``,
``exact_pad``) against the benchmark's plain float64 reference
(``portbench/reference/nemo_tts.py``), on seeded noise and on the speech
tape resampled to 22.05 kHz (every bin above 8 kHz empty), 2 x 0.5 s
each, on every route of ``BatchLogMel``; the magnitude heads of K1's
plain versions against the float64 formula; the refusals that keep a
magnitude head off the walks that compute power alone; ``exact_pad``'s
frame counts; and the power heads as they were.

Tolerances (``TOLERANCE``), each from the arithmetic of its route:

- ``"sig"``, 4e-5: K1's plain version. The DFT dot sums exact bf16
  products in float64 (the route ``sig_mel`` takes on the CPU), the
  magnitude in float32, then the bf2 projection: the magnitude and the
  weights each as two bf16 slices, three of their four products, a
  relative error of about 2^-16, 1.5e-5 in the ln (1.4e-5 read), and
  float32's rounding of the ln besides.
- ``"rdft"`` and ``"fft"``, 1e-4: the DFT in float32 over 1024 taps,
  whose rounding, relative to a frame's loudest bin, reaches the ln of
  its quietest mels on speech (1.7e-5 and 6.7e-6 read).
- ``"hp"``, 1e-5: the exact Ozaki split of the windowed DFT, then
  float32 (1.1e-6 read).

The reference computed in TF32 (``portbench/reference/precision.py``: the
products' operands rounded to 10 mantissa bits), a precision below the
configuration's float32, lands beyond every tolerance (1.2e-3 on noise,
1.0e-2 on speech)."""

import dataclasses
import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from melspec_tpu_torch.config import BatchLogMelConfig, FbankConfig
from melspec_tpu_torch.kernels import sig_mel, sig_multi
from melspec_tpu_torch.ops import batch_logmel, fbank, mel_kernel
from melspec_tpu_torch.ops import sig_multihead
from melspec_tpu_torch.ops.batch_logmel import BatchLogMel
from melspec_tpu_torch.ops.windows import hann_centered
from portbench.lib.registry import load_module
from portbench.lib.signals import generator, speechlike
from portbench.reference import nemo_tts

CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parents[1]
CONFIG = ROOT / "portbench/configs/nemo-tts-22k.json"
TOLERANCE = {"sig": 4e-5, "rdft": 1e-4, "fft": 1e-4, "hp": 1e-5}
SEED = 2**31 + 22_050
CLIPS, SAMPLES = 2, 11_025          # 2 x 0.5 s at 22.05 kHz
# SHA-256 of the power heads (``_digest``) as the tree before the
# magnitude heads built them: NeMo's defaults, asr-trio's NeMo stage, the
# NeMo fold of K2's three heads, NeMo at 48 kHz (K1's float64 FFT path)
# and Kaldi's defaults
POWER_HEADS = {
    "nemo": "49cb5364f1c2e448a9044c7840942cd78073a996b957aa5cdb67355733577a31",
    "asr_trio_nemo":
        "e3485e8f3c51fc1b0a00832a49e46a09fdeb235c9e8cac16f14085209c8a7d00",
    "nemo_fold":
        "7e72eb03a4fd9aaaa8e2c521b5c784e1025bf7cd52eba2d1d7421e46c2cb2302",
    "nemo_48k":
        "e57cc62797458aff9f669b9cfc5b06f58e9984291318c55fc3aac09a4a90a0ea",
    "kaldi": "973c7f1fe93fd85d3dcf81bfb698ead766be3257038d3b09249a0a3f4200778a",
}


def _nemo() -> dict:
    return json.loads(CONFIG.read_text())["nemo"]


def _config(**kw) -> BatchLogMelConfig:
    n = _nemo()
    args = dict(sample_rate=n["sample_rate"], n_fft=n["n_fft"],
                win_length=n["win_length"], hop_length=n["hop_length"],
                n_mels=n["n_mels"], f_min=n["f_min"], f_max=n["f_max"],
                center=False, log_zero_guard=n["log_zero_guard"],
                pad_to=n["pad_to"], mag_power=n["mag_power"],
                log_zero_guard_type=n["log_zero_guard_type"],
                exact_pad=n["exact_pad"])
    return BatchLogMelConfig(**{**args, **kw})


def _signal(name: str) -> torch.Tensor:
    g = generator(SEED, CPU)
    if name == "noise":
        return speechlike(g, CLIPS, SAMPLES, 22050.0, CPU)
    traffic = load_module("traffic", "offline_batches_resampled")
    return traffic.recorded(g, CLIPS, SAMPLES, 22050.0, CPU,
                            "speech16k.npz", [-30, 0])


def _gap(got: torch.Tensor, want: torch.Tensor) -> float:
    assert tuple(got.shape) == tuple(want.shape)
    return float((got.double() - want.double()).abs().max())


def _digest(h) -> str:
    d = hashlib.sha256()
    for t in (h.m_big, h.mt):
        d.update((t.contiguous().view(torch.uint8)
                  if t.dtype == torch.bfloat16 else t).numpy().tobytes())
    d.update(repr((h.pair_i, h.n_bins_pad, h.pack, h.pack_off, h.n_mels,
                   h.out_mode, h.guard, h.live, h.dft_size)).encode())
    if h.fft is not None:
        for t in (h.fft.window, h.fft.mt.view(torch.uint8)):
            d.update(t.contiguous().numpy().tobytes())
    return d.hexdigest()


def _asr_trio_nemo() -> BatchLogMelConfig:
    n = json.loads((ROOT / "portbench/configs/asr-trio.json").read_text())[
        "frontends"]["nemo"]
    return BatchLogMelConfig(
        sample_rate=n["sample_rate"], n_fft=n["n_fft"],
        win_length=n["win_length"], hop_length=n["hop_length"],
        n_mels=n["n_mels"], f_min=float(n["f_min"]), f_max=n["f_max"],
        preemphasis=float(n["preemphasis"]), center=True,
        log_zero_guard=float(n["log_zero_guard"]), pad_to=n["pad_to"],
        normalize_per_feature=True)


def test_the_configuration_is_nemos_tts_mel():
    cfg = _config()
    assert (cfg.magnitude, cfg.exact_pad_amount) == (True, 384)
    head = batch_logmel.sig_head(cfg)
    # split into re|im halves of 512 bins (Nyquist weighs nothing), the
    # columns past 8 kHz zero: 372 bins carry weight, 376 live columns
    assert (head.width, head.n_bins_pad, head.live) == (1024, 512, 376)
    assert (head.magnitude, head.out_mode, head.guard) == (
        True, "ln_floor", 1e-5)
    # K1's float64 FFT path takes it at 1024 points, its power and root
    # computed for the 372 bins the filters reach
    assert (head.pack, head.pack_off, head.dft_size) == (1024, 0, 1024)
    assert (head.fft.size, head.fft.bins, head.fft.preemph) == (
        1024, 372, None)
    assert int((mel_kernel.mel_filterbank(22050.0, 1024, 80, f_max=8000.0)
                != 0).sum()) == 727


@pytest.mark.parametrize("signal", ["noise", "speech"])
@pytest.mark.parametrize("impl", sorted(TOLERANCE))
def test_tts_mel_against_the_float64_reference(impl, signal):
    x = _signal(signal)
    want = nemo_tts.tts_log_mel(x, _nemo(), "float64")
    got = BatchLogMel(_config(), fft_impl=impl, device=CPU).compute(x)
    assert got.dtype == torch.float32 and tuple(got.shape) == (
        CLIPS, 80, SAMPLES // 256)
    assert bool(torch.isfinite(got).all())
    assert _gap(got, want) <= TOLERANCE[impl]


@pytest.mark.parametrize("signal", ["noise", "speech"])
def test_the_reference_in_tf32_lands_beyond_the_tolerances(signal):
    x = _signal(signal)
    want = nemo_tts.tts_log_mel(x, _nemo(), "float64")
    tf32 = nemo_tts.tts_log_mel(x, _nemo(), "tf32")
    assert _gap(tf32, want) > max(TOLERANCE.values())


def test_the_reference_refuses_what_it_does_not_compute():
    with pytest.raises(ValueError, match="mag_power"):
        nemo_tts.tts_log_mel(torch.zeros(1, 4096), {**_nemo(), "mag_power":
                                                    2.0}, "float64")


def _formula(x: torch.Tensor, cfg: BatchLogMelConfig) -> torch.Tensor:
    """The magnitude head's function in float64, straight from its
    definition: frames of the padded signal, the window, the real DFT,
    ``|X|``, the filters, ``ln(max(e, guard))``; ``[B, F, n_mels]``."""
    xp = torch.nn.functional.pad(x.double(), (384, 384), mode="reflect")
    frames = xp.unfold(-1, 1024, 256) * torch.as_tensor(
        hann_centered(1024, 1024))
    mag = torch.fft.rfft(frames, dim=-1).abs()
    filt = torch.as_tensor(batch_logmel.nemo_filters(cfg).T)
    return torch.log(torch.clamp_min(mag @ filt, cfg.log_zero_guard))


@pytest.mark.parametrize("signal", ["noise", "speech"])
def test_k1_plain_magnitude_head_against_the_float64_formula(signal):
    """``sig_mel_reference`` on the split magnitude head (the float64 dot
    of exact bf16 products, as ``sig_mel`` runs it on the CPU; the float32
    dot of the JAX kernel's numerics) within the ``"sig"`` tolerance of
    the float64 formula."""
    cfg = _config()
    x = _signal(signal)
    head = batch_logmel.sig_head(cfg)
    xp = torch.nn.functional.pad(x, (384, 384), mode="reflect")
    want = _formula(x, cfg)
    for dot in (torch.float64, torch.float32):
        got = sig_mel.sig_mel_reference(xp, head, ks=3,
                                        n_frames=want.shape[1], hop=256,
                                        offset=0, dot_dtype=dot)
        assert _gap(got, want) <= TOLERANCE["sig"]


def test_the_magnitude_is_the_root_of_the_power():
    """A magnitude head's plain version projects the root of the power
    its power twin projects: with a projection that passes one bin
    through, the twin's output squared is the head's."""
    head = batch_logmel.sig_head(_config(log_zero_guard_type="add",
                                         log_zero_guard=1e-30))
    # the bf2 stack [F0; F1; F0] of a filter of weight 1 on bin 40 alone
    one = torch.zeros_like(head.mt)
    one[[40, 2 * 512 + 40], 0] = 1.0
    mag = dataclasses.replace(head, mt=one)
    power = dataclasses.replace(mag, magnitude=False)
    xp = torch.nn.functional.pad(_signal("noise"), (384, 384),
                                 mode="reflect")
    kw = dict(ks=3, n_frames=8, hop=256, offset=0, dot_dtype=torch.float64)
    m = sig_mel.sig_mel_reference(xp, mag, **kw)[..., 0].double()
    p = sig_mel.sig_mel_reference(xp, power, **kw)[..., 0].double()
    # each through the bf2 projection: about 2^-16 of the value, 1.5e-5
    # in each ln
    assert float((2 * m - p).abs().max()) < 1e-4


def test_the_fft_paths_plain_version_takes_the_root_in_float64():
    """NeMo's magnitude head at n_fft 2048 (48 kHz) carries the float64
    FFT path's description; its plain version projects ``|X|`` rounded
    once, in float64 against the formula's ``|X|`` before the bf2
    projection."""
    cfg = BatchLogMelConfig(sample_rate=48000, n_fft=2048, win_length=1200,
                            hop_length=480, mag_power=1.0)
    head = batch_logmel.sig_head(cfg)
    assert head.fft is not None and head.magnitude and head.n_bins_pad
    x = _signal("noise")
    kw = dict(size=2048, n_frames=8, hop=480, offset=0,
              pack_off=head.pack_off, window=head.fft.window, preemph=None)
    mag = sig_mel.fft_power(x, magnitude=True, **kw)
    power = sig_mel.fft_power(x, **kw)
    y = sig_mel.fft_taps(x, n_frames=8, hop=480, start=head.pack_off,
                         window=head.fft.window, preemph=None)
    exact = torch.fft.rfft(y, n=2048)[..., :1024].abs()
    assert torch.equal(mag, exact.to(torch.float32))
    assert float((mag.double() ** 2 / power.double() - 1).abs().max()) < 1e-6


def _packed_magnitude():
    """The N-packed power head of NeMo's defaults, marked magnitude."""
    return dataclasses.replace(batch_logmel.sig_head(BatchLogMelConfig()),
                               magnitude=True)


def test_k1_refuses_an_n_packed_magnitude_head():
    head = _packed_magnitude()
    assert head.n_bins_pad == 0
    assert sig_mel.magnitude_refusal(head) is not None
    assert not sig_mel.k1_accepts(head, hop=160)
    x = torch.zeros(1, 4000)
    with pytest.raises(NotImplementedError, match="N-packed"):
        sig_mel.check_head(x, head, ks=3, what="K1")
    with pytest.raises(NotImplementedError, match="N-packed"):
        sig_mel.sig_mel(x, head, ks=3, n_frames=4, hop=160, offset=0)


def test_k2_refuses_a_magnitude_head():
    whisper = mel_kernel.whisper_head(400, 80, 16000.0, CPU)
    kaldi = fbank.sig_head(FbankConfig(use_power=False))
    assert kaldi.magnitude and kaldi.n_bins_pad
    heads = (whisper, kaldi)
    assert sig_multi.magnitude_refusal(heads) is not None
    assert not sig_multi.k2_accepts(heads, hop=160)
    with pytest.raises(NotImplementedError, match="power spectra only"):
        sig_multi.sig_multi(torch.zeros(1, 4000), heads, ks=3, n_frames=4,
                            hop=160)
    with pytest.raises(ValueError, match="power spectra only"):
        sig_multihead.WhisperKaldiNemoFused(
            nemo_config=BatchLogMelConfig(mag_power=1.0), device=CPU)


def test_the_factored_path_refuses_a_magnitude_head():
    """A whisper wide-hop head takes the factored path; marked magnitude
    it keeps its chunk walk, and the factored plain version raises."""
    head = mel_kernel.whisper_head(2048, 128, 22050.0, CPU)
    assert sig_mel.factored_route(head, 3) is not None
    mag = dataclasses.replace(head, magnitude=True)
    assert sig_mel.factored_route(mag, 3) is None
    with pytest.raises(NotImplementedError, match="factored"):
        sig_mel.sig_mel_factored_reference(torch.zeros(1, 4096), mag,
                                           n_frames=1, hop=512, offset=0)


def test_the_auto_route_takes_k1_for_the_tts_head(monkeypatch):
    """``"auto"`` on CUDA takes ``"sig"`` for the TTS head and for Kaldi's
    magnitude spectra (K1's shape and magnitude checks run; its shared
    memory, which asks the built kernel, stood in for), and ``"rdft"``
    for a magnitude head K1 refuses."""
    monkeypatch.setattr(sig_mel, "_smem_bytes", lambda *a: 1024)
    assert batch_logmel.auto_fft_impl(_config(), torch.float32,
                                      "cuda") == "sig"
    assert fbank.auto_fft_impl(FbankConfig(use_power=False), torch.float32,
                               "cuda") == "sig"
    packed = _packed_magnitude()
    monkeypatch.setattr(batch_logmel, "sig_head", lambda cfg: packed)
    assert batch_logmel.auto_fft_impl(_config(), torch.float32,
                                      "cuda") == "rdft"


@pytest.mark.parametrize("n_fft,hop,samples", [
    (1024, 256, 220_500), (1024, 256, 11_025), (1024, 256, 1000),
    (512, 160, 8000), (400, 160, 4321), (1024, 255, 22_050)])
def test_exact_pad_frame_counts_follow_nemo(n_fft, hop, samples):
    """NeMo's ``exact_pad``: ``(T + 2 pad - n_fft) // hop + 1`` frames of
    the wave reflect-padded by ``pad = (n_fft - hop) // 2``, ``T // hop``
    where ``n_fft - hop`` is even; the output holds that many."""
    cfg = BatchLogMelConfig(n_fft=n_fft, win_length=min(n_fft, 400),
                            hop_length=hop, center=False, exact_pad=True)
    pad = (n_fft - hop) // 2
    want = (samples + 2 * pad - n_fft) // hop + 1
    if (n_fft - hop) % 2 == 0:
        assert want == samples // hop
    front = BatchLogMel(cfg, fft_impl="rdft", device=CPU)
    assert front.num_frames(samples) == want
    x = torch.zeros(1, samples) + 0.01
    assert tuple(front.compute(x).shape) == (1, 80, want)


def test_exact_pad_reflects_the_wave():
    """The pad is NeMo's reflection: features of the wave equal those of
    the reflect-padded wave framed with no pad."""
    x = _signal("noise")
    got = BatchLogMel(_config(), fft_impl="rdft", device=CPU).compute(x)
    xp = torch.nn.functional.pad(x, (384, 384), mode="reflect")
    plain = BatchLogMel(_config(exact_pad=False), fft_impl="rdft",
                        device=CPU).compute(xp)
    assert torch.equal(got, plain)


@pytest.mark.parametrize("kw, match", [
    (dict(mag_power=1.5), "mag_power"),
    (dict(log_zero_guard_type="max"), "log_zero_guard_type"),
    (dict(exact_pad=True, center=True), "exact_pad"),
])
def test_the_config_refuses_what_nemo_does_not_take(kw, match):
    with pytest.raises(ValueError, match=match):
        BatchLogMelConfig(**kw)


@pytest.mark.parametrize("guard", ["add", "clamp"])
@pytest.mark.parametrize("mag", [1.0, 2.0])
def test_every_route_honours_the_spectrum_and_the_guard(mag, guard):
    """At the defaults' 512 / 400 / 160 with each ``mag_power`` and guard
    type, the plain routes and K1's plain version agree with a float64
    run of the rdft route; K1 takes a split head for the magnitude."""
    cfg = BatchLogMelConfig(mag_power=mag, log_zero_guard_type=guard,
                            log_zero_guard=1e-5)
    x = _signal("speech")[:, :8000]
    want = BatchLogMel(cfg, dtype=torch.float64, fft_impl="rdft",
                       device=CPU).compute(x.double())
    for impl in ("sig", "rdft", "fft", "hp"):
        front = BatchLogMel(cfg, fft_impl=impl, device=CPU)
        assert _gap(front.compute(x), want) <= 1e-4, impl
    head = batch_logmel.sig_head(cfg)
    assert head.magnitude == (mag == 1.0)
    assert bool(head.n_bins_pad) == (mag == 1.0)
    assert head.out_mode == ("ln_floor" if guard == "clamp" else "ln_guard")


@pytest.mark.parametrize("name, build", [
    ("nemo", lambda: batch_logmel.sig_head(BatchLogMelConfig())),
    ("asr_trio_nemo", lambda: batch_logmel.sig_head(_asr_trio_nemo())),
    ("nemo_fold", lambda: sig_multihead.nemo_fold_head(BatchLogMelConfig())),
    ("nemo_48k", lambda: batch_logmel.sig_head(BatchLogMelConfig(
        sample_rate=48000, n_fft=2048, win_length=1200, hop_length=480))),
    ("kaldi", lambda: fbank.sig_head(FbankConfig())),
])
def test_the_power_heads_are_byte_identical(name, build):
    """The defaults (``mag_power`` 2, the add guard, no ``exact_pad``)
    build the power heads byte for byte as before the magnitude heads."""
    head = build()
    assert not head.magnitude
    assert _digest(head) == POWER_HEADS[name]


@pytest.mark.parametrize("rate", [16000.0, 48000.0])
def test_fbank_magnitude_on_k1_matches_the_plain_route(rate):
    """Kaldi fbank with ``use_power=False`` on the ``"sig"`` route (a split
    magnitude head; at 48 kHz on the float64 FFT path's plain version)
    against the float64 rdft route, within the ``"rdft"`` tolerance."""
    cfg = FbankConfig(sample_rate=rate, use_power=False)
    f = fbank.Fbank(cfg, fft_impl="sig", device=CPU)
    assert f.sig_head.magnitude and f.sig_head.n_bins_pad
    assert (f.sig_head.fft is not None) == (rate == 48000.0)
    x = torch.as_tensor(np.random.default_rng(int(rate)).normal(
        size=(2, int(rate) // 2)).astype(np.float32) * 0.1)
    want = fbank.Fbank(cfg, dtype=torch.float64, fft_impl="rdft",
                       device=CPU).compute(x.double())
    assert _gap(f.compute(x), want) <= TOLERANCE["rdft"]
