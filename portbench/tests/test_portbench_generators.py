"""The traffic repeats exactly for a seed and changes with it; speech at
a whole multiple of the tape's rate is the tape up-sampled, band-limited,
and at the tape's own rate the inputs are as they always were."""

from __future__ import annotations

import hashlib
import types

import numpy as np
import pytest
import torch

from portbench.lib import registry
from portbench.lib.signals import (generator, recorded, speechlike, tape,
                                   upsampled)
from portbench.tests.conftest import CPU, SEED, tiny


def test_speechlike_repeats_for_a_seed():
    a = speechlike(generator(SEED, CPU), 3, 12000, 16000.0, CPU, block=2)
    b = speechlike(generator(SEED, CPU), 3, 12000, 16000.0, CPU)
    c = speechlike(generator(SEED + 1, CPU), 3, 12000, 16000.0, CPU)
    assert torch.equal(a, b) and not torch.equal(a, c)
    # the level switches between 0.3 and 0.003 every 0.25 s
    loud = a.abs().reshape(3, -1, 400).amax(dim=-1)
    assert (loud > 0.1).any() and (loud < 0.05).any()


def test_recorded_repeats_for_a_seed_and_cuts_the_tape():
    def clips(seed, gain_db):
        return recorded(generator(seed, CPU), 5, 16000, 16000, CPU,
                        "speech16k.npz", gain_db, block=2)

    a, b, c = (clips(s, [-30, 0]) for s in (SEED, SEED, SEED + 1))
    assert torch.equal(a, b) and not torch.equal(a, c)
    samples, rate = tape("speech16k.npz")
    assert rate == 16000 and samples.dtype == np.int16
    # at 0 dB each clip is a stretch of the tape, taken round its end
    whole = clips(SEED, [0, 0])
    ring = np.concatenate([samples, samples[:16000]])
    for row in (whole.numpy() * 32768.0).astype(np.int16):
        at = np.flatnonzero(ring[:-16000] == row[0])
        for j in range(1, 64):
            at = at[ring[at + j] == row[j]]
        assert any(np.array_equal(ring[i : i + 16000], row) for i in at)
    # the same seed draws the same starts; the gain scales them alone
    quiet = clips(SEED, [-6, -6])
    assert torch.allclose(quiet, whole * 10 ** (-6 / 20), rtol=1e-6)
    with pytest.raises(ValueError):
        recorded(generator(SEED, CPU), 1, 10, 8000, CPU, "speech16k.npz",
                 [0, 0])
    with pytest.raises(ValueError):
        tape("../run.py")


def test_recorded_at_three_times_the_tapes_rate_is_the_tape_upsampled():
    samples, rate = tape("speech16k.npz")
    up = upsampled("speech16k.npz", 3, CPU)
    assert up.dtype == torch.float32 and up.numel() == 3 * samples.size
    # every third sample is the tape's, to float32 rounding
    back = up[::3].double() - torch.as_tensor(samples).double() / 32768.0
    assert back.abs().max() < 1e-7
    # a 48 kHz clip as long as the whole up-sampled tape, at 0 dB, holds
    # the tape once round from a seeded start: above 8 kHz its spectrum is
    # empty to float32 rounding (an energy share of 2.6e-16 there; a linear
    # interpolation of the tape leaves 1.6e-3, a step 1.5e-2)
    n = up.numel()
    clip = recorded(generator(SEED, CPU), 1, n, 3 * rate, CPU,
                    "speech16k.npz", [0, 0])[0]
    power = torch.fft.rfft(clip.double()).abs() ** 2
    high = power[n // 6 + 1 :].sum() / power.sum()
    assert high < 1e-12, float(high)
    with pytest.raises(ValueError):
        recorded(generator(SEED, CPU), 1, 10, 2.5 * rate, CPU,
                 "speech16k.npz", [0, 0])


# sha256 of the inputs that each cell's traffic makes at its tiny sizes
# from SEED, as the harness made them when ``recorded`` read the tape at
# its own rate only
INPUTS_16K = {
    "asr-trio.offline-b64x30s":
        "3ed6fd695d4082f1d84d1c8e2626d1a319ac6ee511d4742a7ad51d99243b1196",
    "whisper-large-v3.offline-b64x30s":
        "3ed6fd695d4082f1d84d1c8e2626d1a319ac6ee511d4742a7ad51d99243b1196",
}


@pytest.mark.parametrize("cell", sorted(INPUTS_16K))
def test_16k_inputs_are_bit_equal_to_before(cell):
    w = registry.load_json("workloads", cell)
    sut = _Sut()
    run = types.SimpleNamespace(seed=SEED, seconds=0.1, device=CPU,
                                params={**w["params"], **tiny(cell)},
                                tracer=None)
    registry.load_module("traffic", w["traffic"]).prepare(sut, run)
    h = hashlib.sha256()
    for x in sut.seen:
        h.update(x.numpy().tobytes())
    assert h.hexdigest() == INPUTS_16K[cell]


class _Sut:
    """Stands in for the program: records what it is handed."""

    def __init__(self):
        self.seen = []

    def call(self, x):
        self.seen.append(x.clone())
        return x


@pytest.mark.parametrize("cell", registry.names("workloads"))
def test_prepare_repeats_for_a_seed(cell):
    w = registry.load_json("workloads", cell)
    traffic = registry.load_module("traffic", w["traffic"])
    params = {**w["params"], **tiny(cell)}

    def prepared(seed):
        sut = _Sut()
        run = types.SimpleNamespace(seed=seed, seconds=0.1, device=CPU,
                                    params=params, tracer=None)
        load = traffic.prepare(sut, run)
        return sut.seen, load

    (s1, l1), (s2, l2), (s3, _) = prepared(SEED), prepared(SEED), \
        prepared(SEED + 7)
    assert len(s1) == len(s2) > 0
    for a, b, c in zip(s1, s2, s3):
        a, b, c = (torch.as_tensor(v) for v in (a, b, c))
        assert torch.equal(a, b) and not torch.equal(a, c)
    assert l1.keys() == l2.keys()
