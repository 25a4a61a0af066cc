"""The cell ``nemo-tts-22k.offline-b64x10s``: its K1 launch counted by
hand (FLOPs bind, just: 0.0235 ms against 0.0221 ms of bytes), and its
entry's frames, filters and counters as the configuration states
them."""

from __future__ import annotations

from portbench.lib import registry
from portbench.lib.roofline import bound_s
from portbench.tests.conftest import CPU

CELL = "nemo-tts-22k.offline-b64x10s"


def _sut():
    w = registry.load_json("workloads", CELL)
    cfg = registry.load_json("configs", w["config"])
    return registry.load_module("entries", w["entry"]).build(
        cfg, w["params"], CPU)


def test_tts_bound_matches_the_hand_count():
    shape = _sut().kernel_shapes()["k1"]
    # 64 clips of 10 s at 22.05 kHz, 220,500 // 256 = 861 frames of 1024
    # taps, 727 nonzero Slaney weights below 8 kHz
    assert shape == {"batch": 64, "samples": 220_500, "frames": 861,
                     "n_fft": 1024, "n_mels": 80, "nnz": 727}
    work = registry.load_module("roofline", "k1").work(shape)
    assert work["bytes"] == 64 * 220_500 * 4 + 64 * 861 * 80 * 4
    # 2.5 n log2 n + 3 (n / 2 + 1) + 2 nnz a frame
    assert work["flops"] == 64 * 861 * (2.5 * 1024 * 10 + 3 * 513
                                         + 2 * 727)
    b = bound_s(work)
    assert b["binds"] == "flops"
    assert abs(b["flops_s"] * 1e3 - 0.0235) < 0.0001
    assert abs(b["bytes_s"] * 1e3 - 0.0221) < 0.0001


def test_the_entry_counts_k1_and_its_walks():
    sut = _sut()
    assert sut.route == {"fft_impl": "sig"}     # K1's plain version here
    assert set(sut.counters()) == {
        "K1", "sig_mel.magnitude_launches", "sig_mel.pipelined_launches",
        "sig_mel.factored_launches", "sig_mel.fft_launches"}
    head = sut.logmel.sig_head
    assert head.magnitude and head.out_mode == "ln_floor"
