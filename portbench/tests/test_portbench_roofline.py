"""The roofline counts at each cell's shapes: bytes and nominal FLOPs of
one launch, positive and finite, and the bound the larger of their two
times, whichever side binds (printed); and two launches counted by hand,
one bound by its bytes and one by its FLOPs."""

from __future__ import annotations

import math

import pytest

from portbench.lib import registry
from portbench.lib.roofline import bound_s
from portbench.reference import features
from portbench.tests.conftest import CPU


class _View:
    def __init__(self, shapes, ops):
        self.shapes, self.ops = shapes, ops

    def matching(self, names):
        return [o for o in self.ops if any(n in o[0] for n in names)]


def _shapes(cell: str) -> dict:
    w = registry.load_json("workloads", cell)
    cfg = registry.load_json("configs", w["config"])
    entry = registry.load_module("entries", w["entry"])
    return entry.build(cfg, w["params"], CPU).kernel_shapes(), w


@pytest.mark.parametrize("cell", registry.names("workloads"))
def test_the_bound_is_counted_at_the_cells_shapes(cell, capsys):
    shapes, w = _shapes(cell)
    assert shapes
    for kernel, shape in shapes.items():
        work = registry.load_module("roofline", kernel).work(shape)
        for side in ("bytes", "flops"):
            assert math.isfinite(work[side]) and work[side] > 0, (kernel,
                                                                  work)
        b = bound_s(work)
        assert b["s"] == max(b["bytes_s"], b["flops_s"])
        assert b[f"{b['binds']}_s"] == b["s"]
        with capsys.disabled():
            print(f"\n{cell} {kernel}: {work['bytes'] / 1e6:.3f} MB, "
                  f"{work['flops'] / 1e9:.4f} GFLOP nominal; bytes "
                  f"{b['bytes_s'] * 1e3:.5f} ms, flops "
                  f"{b['flops_s'] * 1e3:.5f} ms; {b['binds']} bind")


def test_cell_1_bound_matches_the_hand_count():
    shapes, _ = _shapes("whisper-large-v3.offline-b64x30s")
    work = registry.load_module("roofline", "k1").work(shapes["k1"])
    # 64 x 480,000 x 4 B of signal + 64 x 2,998 x 128 x 4 B of mel
    assert work["bytes"] == 64 * 480_000 * 4 + 64 * 2998 * 128 * 4
    assert abs(bound_s(work)["s"] * 1e3 - 0.066) < 0.001


def test_kaldi_48k_bound_matches_the_hand_count():
    """Kaldi fbank at 48 kHz on K1's float64 FFT path, 64 x 30 s: frames of
    1,200 samples every 480 (snip edges), n_fft 2048, 80 bins."""
    nnz = int((features.kaldi_filters(48000.0, 2048, 80, 20.0, 0.0)
               != 0).sum())
    t = 30 * 48_000
    frames = (t - 1200) // 480 + 1
    work = registry.load_module("roofline", "k1").work(
        {"batch": 64, "samples": t, "frames": frames, "n_fft": 2048,
         "n_mels": 80, "nnz": nnz})
    # 64 x 1,440,000 x 4 B of signal + 64 x 2,998 x 80 x 4 B of fbank
    assert frames == 2998 and work["bytes"] == 430_039_040
    # 191,872 frames x (2.5 n log2 n + 3 x 1,025 bins + 2 x nnz)
    assert abs(work["flops"] / 1e9 - 12.16) < 0.005
    b = bound_s(work)
    assert b["binds"] == "flops"
    assert abs(b["s"] * 1e3 - 0.1815) < 0.00005


def test_share_reads_the_kernels_time():
    from portbench.lib.roofline import share_pct

    shapes, _ = _shapes("whisper-large-v3.offline-b64x30s")
    bound = bound_s(registry.load_module("roofline", "k1").work(
        shapes["k1"]))["s"]
    ns = int(bound * 1e9 * 40)       # two launches at 2.5% of the bound
    ops = [("void sig_mel_kernel<1>(Params)", 0, ns),
           ("void sig_mel_kernel<1>(Params)", ns, 2 * ns),
           ("elementwise_kernel", 0, 5)]
    assert share_pct(_View(shapes, ops), "k1") == pytest.approx(2.5)
    assert share_pct(_View(shapes, ops[2:]), "k1") is None
    assert share_pct(_View({}, ops), "k1") is None
