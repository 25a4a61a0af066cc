"""The traffic kind ``offline_batches_resampled``: its speech is the tape
resampled by band-limited periodic interpolation, the tape up-sampled as
``lib/signals.py::upsampled`` does at a whole multiple and band-limited
at any other rate; its clips are ``signals.recorded``'s draws on that
tape; and it drives the loop of ``offline_batches.py``."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.lib import registry, signals
from portbench.tests.conftest import CPU, SEED

TRAFFIC = registry.load_module("traffic", "offline_batches_resampled")
FILE = "speech16k.npz"


def test_at_a_whole_multiple_it_is_the_upsampled_tape():
    assert torch.equal(TRAFFIC.resampled(FILE, 32000.0, CPU),
                       signals.upsampled(FILE, 2, CPU))


def test_at_22050_it_is_band_limited_to_the_tapes_nyquist():
    samples, rate = signals.tape(FILE)
    x = TRAFFIC.resampled(FILE, 22050.0, CPU).double()
    assert x.numel() == round(samples.size * 22050 / rate)
    spec = torch.fft.rfft(x).abs()
    edge = samples.size // 2 + 1        # the tape's Nyquist, 8 kHz
    # above 8 kHz only float32's rounding of the samples is left
    assert float(spec[edge:].max()) < 1e-4 * float(spec[:edge].max())
    # the resampled tape keeps the tape's energy (Parseval, up to the
    # factor of the rate)
    want = float((torch.as_tensor(samples, dtype=torch.float64)
                  / 32768.0).pow(2).mean())
    assert float(x.pow(2).mean()) == pytest.approx(want, rel=1e-5)


def test_it_refuses_a_rate_below_the_tapes():
    with pytest.raises(ValueError, match="or above"):
        TRAFFIC.resampled(FILE, 8000.0, CPU)


def test_clips_are_recordeds_draws_on_the_resampled_tape():
    """At the tape's own rate the clips are ``signals.recorded``'s to
    float32's rounding (the tape through a float64 rFFT and back): the
    same generator draws, the same cutting and gain."""
    kw = dict(file=FILE, gain_db=[-30, 0])
    got = TRAFFIC.recorded(signals.generator(SEED, CPU), 3, 4000, 16000.0,
                           CPU, **kw)
    want = signals.recorded(signals.generator(SEED, CPU), 3, 4000, 16000.0,
                            CPU, **kw)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_it_drives_the_offline_loop():
    base = registry.load_module("traffic", "offline_batches")
    assert TRAFFIC.drive is base.drive
    assert set(TRAFFIC.SIGNALS) == set(signals.SIGNALS)
    x = TRAFFIC.make(signals.generator(SEED, CPU), {"signal": "speechlike"},
                     2, 1000, 22050.0, CPU)
    y = signals.make(signals.generator(SEED, CPU), {"signal": "speechlike"},
                     2, 1000, 22050.0, CPU)
    assert torch.equal(x, y) and np.isfinite(x.numpy()).all()
