"""Where K5-K8's time goes on the card: ``csrc/framed_ozaki.cu`` built
once as it is and once with each of five parts cut out (the tensor-core
DFT, the ring tiles' stream from L2, the projection, the frames' slicing
or staging, K5's / K8's cutting of each stage's A tile from the staged
frames) or with the ring laid out as K1 lays out its ring (16 bytes of
padding between column groups), each timed at the dial's launch (whisper
large-v3, 400/160/128, 64 x 30 s) and at 1024/256/80, 22.05 kHz, 64 x 30
s. A cut's output is not the function any more; its time only shows what
the part it removes costs, and where the parts overlap.

    python3 -m melspec_tpu_torch.kernels.ozaki_probe

prints one JSON line per variant and shape (its ms and the difference to
the full kernel) and exits non-zero without a card. The variants are text
edits of the source; each must match it exactly once, which a CPU test
checks, so an edit of the device code that moves one of them fails there
first.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from melspec_tpu_torch.kernels import build, framed_mel, framed_ozaki

SOURCE = build.CSRC_DIR / "framed_ozaki.cu"
# variant -> the (text, replacement) edits it makes
EDITS = {
    "no_dft_mma": [(
        "        wgmma_step<S>(acc, a[h], a_desc, desc, !(first && h == 0));",
        "        acc[h] += static_cast<Acc>(\n"
        "            (a[h][0] ^ a[h][3] ^ static_cast<unsigned>(desc ^ a_desc))"
        " & 1);")],
    "no_a_cut": [(
        "    cut_stage<T>(sat + slot * kABytes, sa, p.rs, p.taps, st * kATaps,\n"
        "                 p.pi[pr], tid);",
        "    (void)pr, (void)st, (void)slot;")],
    "no_tile_stream": [(
        "cp_async16(ring + slot * kStageBytes + 16 * v, src + 16 * v, true);",
        "cp_async16(ring + slot * kStageBytes + 16 * v, src + 16 * v, v < 0);")],
    "no_projection": [(
        "      for (int c = 0; c < piece; ++c) {",
        "      for (int c = 0; c < 0; ++c) {")],
    "no_slicing": [(
        "  for (int f = warp; f < T; f += kFT / 32) {",
        "  for (int f = warp; f < 0; f += kFT / 32) {")],
    "padded_ring": [
        ("constexpr unsigned kColBytes = 2 * kSteps * kCoreK;  // 1,024",
         "constexpr unsigned kColBytes = 2 * kSteps * kCoreK + 16;"),
        ("constexpr int kStageBytes = kGroups * kColBytes;     // 16,384: one tile",
         "constexpr int kStageBytes = kGroups * kColBytes;"),
        ("((blk * p.n_chunks + cb) * per_pair + st) * kStageBytes;",
         "((blk * p.n_chunks + cb) * per_pair + st) * 16384;"),
        ("cp_async16(ring + slot * kStageBytes + 16 * v, src + 16 * v, true);",
         "cp_async16(ring + slot * kStageBytes + (v >> 6) * kColBytes +\n"
         "                     16 * (v & 63), src + 16 * v, true);")],
}
B, SECONDS = 64, 30.0
FUNCTIONS = ("melspec_framed_ozaki", "melspec_framed_ozaki_plan",
             "melspec_cuda_error_string")
# (fft, hop, n_mels, sampling rate): the dial's main path, and the
# 1024-tap check shape of chip_smoke.py at full length
SHAPES = [(400, 160, 128, 16000.0), (1024, 256, 80, 22050.0)]


def variant_source(name: str, text: str | None = None) -> str:
    """``framed_ozaki.cu`` with variant ``name``'s edits (``"full"``: as
    it is); raises unless each edit's text occurs exactly once."""
    edits = [] if name == "full" else EDITS[name]
    return build.edited(SOURCE, edits, f"ozaki_probe edit of {name!r}",
                        text)


def run(dev: torch.device, timer) -> list:
    """Each variant's K5-K8 time at each shape (``timer(fn)`` -> ms)."""
    from melspec_tpu_torch.ops import mel_kernel

    rng = np.random.default_rng(0)
    cases = []
    for fft, hop, n_mels, sr in SHAPES:
        x = torch.from_numpy((rng.normal(size=(B, int(SECONDS * sr)))
                              * 0.2).astype(np.float32)).to(dev)
        fr, _ = mel_kernel.framed_input(x, fft, hop)
        for impl in framed_mel.IMPLS:
            ks, cutoff = mel_kernel.pallas_schedule(impl)
            mats = mel_kernel.framed_matrices(impl, fft, n_mels, sr, ks,
                                              cutoff, dev)
            cases.append((f"{framed_mel.KERNEL[impl]}_{fft}", fr, mats,
                          n_mels, fft))
    names = ["full", *EDITS]
    libs = build.build_variants("ozaki_probe", "framed_ozaki", {
        name: {SOURCE.name: variant_source(name)} for name in names})
    rows = []
    for name in names:
        with build.bound_to(framed_ozaki, libs[name], FUNCTIONS):
            for case, fr, mats, n_mels, taps in cases:
                rows.append(dict(
                    variant=name, case=case,
                    block_frames=framed_ozaki.plan(mats.impl, mats.ks, taps,
                                                   mats.mt.shape[1])[0],
                    ms=timer(lambda: framed_mel.framed_mel(
                        fr, mats, n_mels=n_mels, taps=taps))))
    full = {r["case"]: r["ms"] for r in rows if r["variant"] == "full"}
    for r in rows:
        r["saves_ms"] = full[r["case"]] - r["ms"]
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("ozaki_probe: CUDA is not available", file=sys.stderr)
        return 1
    from melspec_tpu_torch.utils.timing import device_time_ms

    for r in run(torch.device("cuda"), device_time_ms):
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
