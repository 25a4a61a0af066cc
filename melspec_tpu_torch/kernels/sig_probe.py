"""Where K1's time goes on the card: K1 built from ``csrc/`` once as it
is and once with each of the two largest parts of its chunk walk cut
out (the m_big stream through the cp.async ring, the DFT's wgmma's),
each timed on the batch path's launch (whisper large-v3, 400/160/128,
64 x 30 s). A cut's output is not the function any more; its time only
shows what the part it removes costs, and where the parts overlap.

    python3 -m melspec_tpu_torch.kernels.sig_probe

prints one JSON line per variant (its ms and the difference to the full
kernel), then K1 and K2 at the batch path's and the frontend step's
shapes, and K1 in its 64-frame layout (whisper 1024/256 at 22.05 kHz,
64 x 30 s), and exits non-zero without a card. The variants are text cuts of
``csrc/sig_common.cuh``; each must match the source exactly once, which
a CPU test checks, so an edit of the device code that moves one of them
fails there first.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from melspec_tpu_torch.kernels import build, sig_mel, sig_multi

HEADER = build.CSRC_DIR / "sig_common.cuh"
# variant -> (the text it cuts, what replaces it)
CUTS = {
    "no_m_big_stream": (
        "    if (nb < h.n_blocks) {",
        "    if (nb < 0) {"),
    "no_dft_mma": (
        "    wgmma_128(d, a[0], gmma_desc(st, kLbo, kSbo));\n"
        "    if (tt + 16 < h.pack)\n"
        "      wgmma_128(d, a[1], gmma_desc(st + 2 * kCoreK, kLbo, kSbo));",
        "    d[0] += __uint_as_float(a[0][0] ^ a[1][3] ^ st);"),
}
B, SECONDS = 64, 30.0
FUNCTIONS = ("melspec_sig_mel", "melspec_sig_mel_layout",
             "melspec_cuda_error_string")


def variant_source(name: str, text: str | None = None) -> str:
    """``sig_common.cuh`` with variant ``name``'s cut (``"full"``: as it
    is); raises unless the cut's text occurs exactly once."""
    cuts = [] if name == "full" else [CUTS[name]]
    return build.edited(HEADER, cuts, f"sig_probe cut {name!r}", text)


def run(dev: torch.device, timer) -> list:
    """Each variant's K1 time at the batch path's launch (``timer(fn)``
    -> ms), then K1 and K2 as they are."""
    from melspec_tpu_torch.config import WHISPER_LARGE_V3 as c
    from melspec_tpu_torch.config import DetectionSettings
    from melspec_tpu_torch.ops import framing, mel_kernel
    from melspec_tpu_torch.ops.batch_logmel import BatchLogMel
    from melspec_tpu_torch.ops.sig_multihead import WhisperKaldiFused

    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.normal(size=(B, int(SECONDS * 16000)))
                          * 0.2).astype(np.float32)).to(dev)
    head = mel_kernel.whisper_head(c.fft_size, c.n_mels, c.sampling_rate,
                                   dev)
    nf = framing.num_frames_batch(x.shape[-1], c.fft_size, c.hop_size)
    kw = dict(ks=3, n_frames=nf, hop=c.hop_size, offset=0, **head.kw())

    def k1():
        return sig_mel.sig_mel(x, head.m_big, head.pair_i, head.mt, **kw)

    names = ["full", *CUTS]
    libs = build.build_variants("sig_probe", "sig_mel", {
        name: {HEADER.name: variant_source(name)} for name in names})
    rows = []
    for name in names:
        with build.bound_to(sig_mel, libs[name], FUNCTIONS):
            rows.append(dict(variant=name, ms=timer(k1)))
    for r in rows:
        r["saves_ms"] = rows[0]["ms"] - r["ms"]
    fused = WhisperKaldiFused(c, device=dev)
    nemo = BatchLogMel(device=dev)
    wide = mel_kernel.whisper_head(1024, 80, 22050.0, dev)
    x22 = torch.from_numpy((rng.normal(size=(B, int(SECONDS * 22050)))
                            * 0.2).astype(np.float32)).to(dev)
    kw22 = dict(ks=3, n_frames=framing.num_frames_batch(x22.shape[-1], 1024,
                                                        256),
                hop=256, offset=0, **wide.kw())
    rows += [
        dict(variant="k1_whisper_128", ms=timer(k1)),
        dict(variant="k2_whisper_kaldi_vad", ms=timer(
            lambda: sig_multi.sig_multi(
                x, fused.heads, ks=3, n_frames=nf, hop=c.hop_size,
                vad=sig_mel.vad_args(DetectionSettings(), c.n_mels)))),
        dict(variant="k1_ln_guard_nemo", ms=timer(lambda: nemo.compute(x))),
        dict(variant="k1_whisper_1024_22k", ms=timer(
            lambda: sig_mel.sig_mel(x22, wide.m_big, wide.pair_i, wide.mt,
                                    **kw22)))]
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("sig_probe: CUDA is not available", file=sys.stderr)
        return 1
    from melspec_tpu_torch.utils.timing import device_time_ms

    for r in run(torch.device("cuda"), device_time_ms):
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
