"""P1, the signal-load probe, on the card: every mode's output equals its
plain version exactly. Needs a CUDA device and nvcc; skipped elsewhere.
On a machine with the card (no JAX needed):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda_load_probe.py
"""

import pytest
import torch

from melspec_tpu_torch.kernels import load_probe

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (P1 has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("batch,seconds", [(3, 1), (64, 30)])
def test_every_mode_exact(dev, batch, seconds):
    before = dict(load_probe.launches)
    results = load_probe.run(dev, batch=batch, seconds=seconds,
                             fail_fast=True)
    assert [r["mode"] for r in results] == list(load_probe.MODES)
    assert all(r["ok"] and r["max_abs_err"] == 0.0 for r in results)
    assert all(load_probe.launches[m] > before[m] for m in load_probe.MODES)


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("width", [5, 640, 643])
def test_rows_at_every_alignment(dev, offset, width):
    """Heads and tails of 4-byte copies around the 16-byte body, and rows
    shorter than one 16-byte copy."""
    x = torch.randn((2, 5000), device=dev)
    rows = (5000 - offset) // width
    got = load_probe.load_rows(x, offset=offset, rows=rows, width=width,
                               flat=True)
    assert torch.equal(got, load_probe.rows_reference(x, offset, rows,
                                                      width))


@pytest.mark.parametrize("offset", [0, 57])
@pytest.mark.parametrize("t", [10_000, 10_496, 65_537])
def test_spans_zero_past_the_clip(dev, offset, t):
    x = torch.randn((3, t), device=dev)
    span = load_probe.span_len(160, 400)
    count = load_probe.n_spans((t - offset - 400) // 160 + 1)
    got = load_probe.load_spans(x, offset=offset, hop=160, span=span,
                                count=count)
    assert torch.equal(got, load_probe.spans_reference(x, offset, 160, span,
                                                       count))
