"""The roofline counts at each cell's shapes: bytes and nominal FLOPs of
one launch, printed, and the bytes bind at every shape the cells launch."""

from __future__ import annotations

import pytest

from portbench.lib import registry
from portbench.lib.roofline import bound_s
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
def test_bytes_bind_at_the_cells_shapes(cell, capsys):
    shapes, w = _shapes(cell)
    assert shapes
    for kernel, shape in shapes.items():
        work = registry.load_module("roofline", kernel).work(shape)
        b = bound_s(work)
        with capsys.disabled():
            print(f"\n{cell} {kernel}: {work['bytes'] / 1e6:.3f} MB, "
                  f"{work['flops'] / 1e9:.4f} GFLOP nominal; bytes "
                  f"{b['bytes_s'] * 1e3:.5f} ms, flops "
                  f"{b['flops_s'] * 1e3:.5f} ms")
        assert b["binds"] == "bytes"


def test_cell_1_bound_matches_the_hand_count():
    shapes, _ = _shapes("whisper-large-v3.offline-b64x30s")
    work = registry.load_module("roofline", "k1").work(shapes["k1"])
    # 64 x 480,000 x 4 B of signal + 64 x 2,998 x 128 x 4 B of mel
    assert work["bytes"] == 64 * 480_000 * 4 + 64 * 2998 * 128 * 4
    assert abs(bound_s(work)["s"] * 1e3 - 0.066) < 0.001


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
