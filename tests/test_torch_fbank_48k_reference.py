"""Kaldi fbank at the ``kaldi-fbank-48k`` configuration's settings
(``portbench/configs/kaldi-fbank-48k.json``: 48 kHz, 1200 / 480, n_fft
2048, 80 bins, per-clip CMN) against the benchmark's plain float64
reference (``portbench/reference/features.py::kaldi_fbank``), on seeded
noise and on speech up-sampled to 48 kHz (every bin above 8 kHz empty),
2 x 0.5 s each.

Routes: ``"sig"``, K1's plain version of its float64 FFT path (the route
``"auto"`` takes on the card), and ``"rdft"`` (the route ``"auto"`` takes
on the CPU). Tolerances:

- ``"sig"``, 5e-5: the FFT and the power in float64, the power rounded
  once to float32, then the bf2 projection (the power and the weights
  each as two bf16 slices, three of their four products), relative
  error about 2^-16, 1.5e-5 in the ln; the CMN subtracts a mean that
  carries the same error, so twice that, 3.1e-5, and float32's rounding
  of the ln besides.
- ``"rdft"``, 3e-4: the DFT as a float32 matmul over 1200 taps, whose
  rounding, relative to a frame's loudest bin, reaches the ln of its
  quietest bins; JAX's float32 rdft route, the same arithmetic, lands up
  to 2.9e-4 from float64 at these n_fft 2048 heads
  (``tests/test_torch_kaldi_preemph.py``).

The reference computed in TF32 (``portbench/reference/precision.py``: the
products' operands rounded to 10 mantissa bits), a precision below the
configuration's float32, lands beyond both tolerances."""

import json
from pathlib import Path

import pytest
import torch

from melspec_tpu_torch.config import FbankConfig
from melspec_tpu_torch.ops.fbank import Fbank
from portbench.lib.signals import generator, recorded, speechlike
from portbench.reference import features

CPU = torch.device("cpu")
CONFIG = Path(__file__).resolve().parents[1] / (
    "portbench/configs/kaldi-fbank-48k.json")
TOLERANCE = {"sig": 5e-5, "rdft": 3e-4}
SEED = 2**31 + 48_000
CLIPS, SAMPLES = 2, 24_000          # 2 x 0.5 s at 48 kHz


def _kaldi() -> dict:
    return json.loads(CONFIG.read_text())["kaldi"]


def _fbank_config(k: dict) -> FbankConfig:
    return FbankConfig(
        sample_rate=float(k["sample_rate"]), num_mel_bins=k["num_mel_bins"],
        frame_length_ms=k["frame_length_ms"],
        frame_shift_ms=k["frame_shift_ms"], dither=k["dither"],
        energy_floor=k["energy_floor"], use_energy=k["use_energy"],
        use_log_fbank=k["use_log_fbank"], use_power=k["use_power"],
        preemphasis=k["preemphasis"], apply_cmn=k["apply_cmn"],
        low_freq=k["low_freq"], high_freq=k["high_freq"])


def _signal(name: str) -> torch.Tensor:
    g = generator(SEED, CPU)
    if name == "noise":
        return speechlike(g, CLIPS, SAMPLES, 48000.0, CPU)
    return recorded(g, CLIPS, SAMPLES, 48000.0, CPU, "speech16k.npz",
                    [-30, 0])


def _gap(got: torch.Tensor, want: torch.Tensor) -> float:
    assert tuple(got.shape) == tuple(want.shape)
    return float((got.double() - want.double()).abs().max())


def test_the_configuration_is_kaldis_at_48k():
    cfg = _fbank_config(_kaldi())
    assert (cfg.frame_length_samples, cfg.frame_shift_samples,
            cfg.fft_size) == (1200, 480, 2048)
    assert Fbank(cfg, fft_impl="sig", device=CPU).sig_head.fft is not None


@pytest.mark.parametrize("signal", ["noise", "speech"])
@pytest.mark.parametrize("impl", sorted(TOLERANCE))
def test_fbank_48k_against_the_float64_reference(impl, signal):
    k = _kaldi()
    x = _signal(signal)
    want = features.kaldi_fbank(x, k, "float64")
    got = Fbank(_fbank_config(k), fft_impl=impl, device=CPU).compute(x)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 48, 80)
    assert bool(torch.isfinite(got).all())
    assert _gap(got, want) <= TOLERANCE[impl]


@pytest.mark.parametrize("signal", ["noise", "speech"])
def test_the_reference_in_tf32_lands_beyond_the_tolerances(signal):
    k = _kaldi()
    x = _signal(signal)
    want = features.kaldi_fbank(x, k, "float64")
    tf32 = features.kaldi_fbank(x, k, "tf32")
    assert _gap(tf32, want) > max(TOLERANCE.values())
