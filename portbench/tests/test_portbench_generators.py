"""The traffic repeats exactly for a seed and changes with it."""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch

from portbench.lib import registry
from portbench.lib.signals import generator, recorded, speechlike, tape
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
