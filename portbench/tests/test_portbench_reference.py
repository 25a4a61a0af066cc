"""The reference agrees with the program's CPU routes at small sizes for
each entry, through the whole harness, on every signal of the ring (noise
and recorded speech); and its filterbanks agree with what the
configurations name (librosa's Slaney filterbank and Kaldi's triangles as
the program builds them)."""

from __future__ import annotations

import numpy as np
import pytest

from portbench.lib import registry
from portbench.reference import features
from portbench.tests.conftest import cells, run_cpu

# the program's plain CPU routes against the float64 reference; far
# under every cell's limit
CPU_BAR = 1e-4


@pytest.mark.parametrize("cell", cells())
def test_cpu_routes_agree_with_the_reference(cell):
    out = run_cpu(cell)
    checks = out["result"]["checks"]
    assert out["result"]["correct"], checks
    ring = len(registry.load_json("workloads", cell)["params"]["ring"])
    assert {c % ring for c in out["notes"]["checked_calls"]} == \
        set(range(ring))
    for name, c in checks.items():
        bar = 0 if "flips" in name else CPU_BAR
        assert c["value"] is not None and c["value"] <= bar, (name, c)


@pytest.mark.parametrize("args", [(16000.0, 400, 128, 0.0, None),
                                  (16000.0, 512, 80, 0.0, None),
                                  (16000.0, 400, 80, 0.0, None)])
def test_slaney_filters_match_the_program(args):
    from melspec_tpu_torch.ops.filterbank import mel_filterbank

    sr, n_fft, n_mels, f_min, f_max = args
    assert np.abs(features.slaney_filters(*args) - mel_filterbank(
        sr, n_fft, n_mels, f_min=f_min, f_max=f_max)).max() < 1e-12


def test_kaldi_filters_match_the_program():
    from melspec_tpu_torch.ops.filterbank import kaldi_filterbank

    assert np.abs(features.kaldi_filters(16000.0, 512, 80, 20.0, 0.0)
                  - kaldi_filterbank(16000.0, 512, 80, 20.0, 0.0)
                  ).max() < 1e-12
