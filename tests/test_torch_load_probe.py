"""P1's plain versions on the CPU (the card test is
``tests/test_torch_cuda_load_probe.py``): the spans are the samples K1
stages per 64-frame tile, read from the shared header's constants, and
both plain versions gather what a numpy loop gathers."""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from melspec_tpu_torch.kernels import load_probe, sig_mel

ROOT = Path(__file__).resolve().parents[1]


def test_span_len_is_the_headers():
    src = (ROOT / "melspec_tpu_torch/csrc/sig_common.cuh").read_text()
    chunk = int(re.search(r"kChunk = (\d+);", src).group(1))
    tile = sig_mel.TILE_FRAMES
    for hop, taps in [(160, 400), (80, 200), (256, 1024), (160, 401)]:
        want = (tile - 1) * hop + -(-taps // chunk) * chunk
        assert load_probe.span_len(hop, taps) == want
    assert load_probe.span_len(160, 400) == 10496
    assert load_probe.n_spans((30 * 16000 - 400) // 160 + 1) == 47


@pytest.mark.parametrize("offset", [0, 3, 57])
def test_plain_versions_gather_like_a_loop(offset):
    x = torch.from_numpy(np.random.default_rng(offset).normal(
        size=(2, 30000)).astype(np.float32))
    xn = x.numpy()
    span, step = load_probe.span_len(160, 400), 64 * 160
    count = load_probe.n_spans((30000 - offset - 400) // 160 + 1)
    got = load_probe.load_spans(x, offset=offset, hop=160, span=span,
                                count=count)
    assert tuple(got.shape) == (2, count, span)
    for b in range(2):
        for t in range(count):
            want = np.zeros(span, np.float32)
            seg = xn[b, offset + t * step : offset + t * step + span]
            want[: seg.size] = seg
            np.testing.assert_array_equal(got[b, t].numpy(), want)
    rows = load_probe.load_rows(x, offset=offset, rows=40, width=640,
                                flat=True)
    for r in (0, 17, 39):
        np.testing.assert_array_equal(
            rows[:, r].numpy(), xn[:, offset + r * 640 : offset + (r + 1) * 640])
    base = load_probe.load_rows(rows.contiguous(), offset=0, rows=40,
                                width=640, flat=False)
    assert torch.equal(base, rows)


def test_cli_refuses_without_cuda():
    code = ("import torch, sys\n"
            "torch.cuda.is_available = lambda: False\n"
            "from melspec_tpu_torch.kernels import load_probe\n"
            "sys.exit(load_probe.main())\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 1 and "CUDA is not available" in res.stderr
    assert res.stdout == ""
