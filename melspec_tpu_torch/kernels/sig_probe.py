"""Where K1's and K2's time goes on the card: each built from ``csrc/``
once as it is and once with each part of its chunk walks cut out, each
variant timed at 64 x 30 s. The pipelined 128-frame walk
(``csrc/sig_pipe.cuh``, ``PIPE_CUTS``: the producer's stage copy, the
consumers' A loads, their DFT ``wgmma``s, the projection) is timed on
K1's batch path's launch (whisper large-v3, 400/160/128), NeMo's ln head
(512/400/80, N-packed) and K2 at the frontend step's launch (whisper
large-v3 + Kaldi 80 + the VAD epilogue, ``k2_whisper_kaldi_vad``); the
synchronous walk that the 64- and 32-frame blocks keep
(``csrc/sig_common.cuh``, ``CUTS``: the m_big stream through the
cp.async ring, the DFT's wgmma's) on K1's 64-frame layout (whisper
1024/256 at 22.05 kHz). A cut's output is not the
function any more; its time only shows what the part it removes costs,
and where the parts overlap.

    python3 -m melspec_tpu_torch.kernels.sig_probe

prints one JSON line per variant (its ms and the difference to the full
kernel), then K1 and K2 at the batch path's and the frontend step's
shapes, and K1 in its 64-frame layout, and exits non-zero without a
card (K1's factored path of the wide hops is timed by chip_smoke.py's
phase wide_hops and the ``factored`` mode below). The variants are text
cuts of the headers; each must match its source exactly once, which a
CPU test checks, so an edit of the device code that moves one of them
fails there first.

    python3 -m melspec_tpu_torch.kernels.sig_probe factored

does the same for K1's factored path of the wide hops
(``csrc/sig_factored.cuh``; ``FACTORED_CUTS``: stage 1's and stage 2's
``wgmma``s, the next frame's taps or their load alone, the projection),
each variant timed
at 960/480/40, 1024/480/64 and 2048/512/128 on 64 x 30 s.

    python3 -m melspec_tpu_torch.kernels.sig_probe fft

does the same for K1's float64 FFT path of the Kaldi fbank and NeMo
log-mel heads (``csrc/sig_fft.cuh``). The 2048-point instance's cuts
(``FFT_CUTS``: the taps' load, Kaldi's frame mean (the group's shuffles
and warp words; its barrier stays, the buffer's guard), the
preprocessing and window a tap, the radix passes (both radix-16s and the
radix-4s; the twiddles and the exchanges stay), the split and power, the
projection, and every named barrier of the groups (timing only: the
exchanges then race)) are timed at both heads at 48 kHz (``LN_RATE``) on
64 x 30 s through ``Fbank`` / ``BatchLogMel``; the 1024-point instance's
(``FFT1024_CUTS``: the projection, the radix passes (both radix-16s and
the radix-2s), the split with the power, its root and halves, both
exchanges through the warp's buffer (their writes and reads; the passes
then run on registers alone), and the float64 root of a magnitude head)
on K1 alone (``sig_mel`` on the head) at NeMo's TTS head (``TTS``: 1024
/ 256, magnitude, 372 live bins, on the 64 x 10 s cell's reflect-padded
clips) and Kaldi's at 22.05 kHz (551 / 220, power, preemphasis).

    PYTHONPATH=<tree> python3 -P melspec_tpu_torch/kernels/sig_probe.py \
        dump <dir>
    python3 -m melspec_tpu_torch.kernels.sig_probe compare <dir>...

``dump`` drives K1 and K2 of the ``melspec_tpu_torch`` package on the
path through its public API only (so another checkout's package, an
earlier commit's, can be driven by this file) on inputs made from fixed
seeds: ``whisper_mel_sig`` at 400/160/128 and 1024/256/80 at 22.05 kHz
(batch and streaming, both projections), ``whisper_mel_vad_sig`` and
``whisper_mel_quantized`` at 400/160/128 and the fused whisper + Kaldi
step (K2), K2's other head sets (``K2_CASES``: whisper large-v3 + Kaldi
with the VAD, the NeMo-fold three heads, the 8 kHz pair, and 133 ragged
clips of the large-v3 pair on ``sig_multi`` itself), then the wide hops (``WIDE``: 960/480/40, 1024/480/64 at 48
kHz, 2048/512/128 at 22.05 kHz, batch and streaming, both projections,
and the VAD and quant routes; cases named ``wide_...``) and Kaldi fbank
and NeMo log-mel at 48, 64 and 80 kHz through ``Fbank`` / ``BatchLogMel``
(``ln_...``: the float64 FFT path since it takes them, the 32-frame
chunk walk before), then the heads at n_fft 1024 (``FFT1024_CASES``,
``fft1024_...``: NeMo's TTS mel, Kaldi power and magnitude and NeMo at 32
kHz, each through its entry point on the ``"sig"`` route: the float64
FFT path's 1024-point instance since it takes them, K1's chunk walks
before), each beside its entry point's float64 rdft route on the same
input. It writes each output's SHA-256 to ``<dir>/dump.json`` (and each
``ln_...`` and ``fft1024_...`` output to ``<dir>/<case>.npy``, with the
float64 route's to ``<dir>/<case>.ref.npy`` and whether K1's FFT path
ran the case); ``compare`` holds the hashes of every dump equal case by
case (bit-equal outputs), an ``ln_...`` case within ``LN_TOL`` of the
first dump's where they differ, an ``fft1024_...`` case not to another
dump but, in each dump where the FFT path ran it, within ``REF_TOL`` of
its own float64 route (the other dumps' distances are reported), and
exits non-zero where any case fails, as ``resample_probe.py``'s modes do
for K3/K4; a case that a dump lacks counts as differing.

    PYTHONPATH=<tree> python3 -P melspec_tpu_torch/kernels/sig_probe.py time

times K1 of that package, public API only as ``dump``, at the chunk-walk
layouts of the main path (``TIMED``: whisper 400/160/128, the batch
path's launch in 128-frame blocks, and 1024/256/80 at 22.05 kHz in
64-frame blocks) and K2 at the frontend step's launch
(``k2_whisper_kaldi_vad``) on 64 x 30 s, per call (``device_time_ms``, the host
path included) and per launch (``per_launch_ms``, back to back), and
prints one JSON line; run it for two trees in one call, alternating
which runs first, to compare them.
"""

from __future__ import annotations

import hashlib
import json
import sys
from pathlib import Path

import numpy as np
import torch

from melspec_tpu_torch.kernels import build, sig_mel, sig_multi

HEADER = build.CSRC_DIR / "sig_common.cuh"
# the synchronous walk's variant -> (the text it cuts, what replaces it)
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
PIPE = build.CSRC_DIR / "sig_pipe.cuh"
# the pipelined walk's variant -> (the text it cuts, what replaces it);
# the consumers still wait for and release every slot, so the ring keeps
# its order
PIPE_CUTS = {
    "no_stage_copy": (
        "    mbar_expect_tx(rg.full(rg.slot), bytes);\n"
        "    bulk_copy(rg.data(rg.slot), src, bytes, rg.full(rg.slot));\n",
        "    mbar_arrive(rg.full(rg.slot));\n"),
    "no_a_loads": (
        "          a[k][rw + 2 * hh] =\n"
        "              kFast ? lds32(e)\n",
        "          a[k][rw + 2 * hh] =\n"
        "              kFast ? e\n"),
    "no_consumer_mma": (
        "        wgmma_n<N>(d, a[u][0], gmma_desc(st, kLbo, kSbo));\n"
        "        wgmma_n<N>(d, a[u][1], gmma_desc(st + 2 * kCoreK, kLbo, "
        "kSbo));\n",
        "        d[0] += __uint_as_float(a[u][0][0] ^ a[u][1][3] ^ st);\n"),
    "no_projection": (
        "    for (int kk = 0; kk < rows; kk += 16) {",
        "    for (int kk = 0; kk < 0 * rows; kk += 16) {"),
}
FACTORED = build.CSRC_DIR / "sig_factored.cuh"
# K1's factored path: variant -> (the text it cuts, what replaces it)
FACTORED_CUTS = {
    "no_stage1_mma": (
        "      wgmma_32(d1, cc.a1[f_pair_j(p)][s],\n"
        "               gmma_desc(b1 + f_pair_i(p) * FStage<N1>::kSlice1 +\n"
        "                             s * 2 * kCoreK,\n"
        "                         kLbo, FStage<N1>::kSbo1));",
        "      d1[p] += __uint_as_float(cc.a1[f_pair_j(p)][s][0] ^ b1);"),
    "no_stage2_mma": (
        "      wgmma_32(d2, a2[f_pair_i(p)][s],\n"
        "               gmma_desc(b2 + f_pair_j(p) * kFB2Slice + s * 2 * "
        "kCoreK,\n                         kLbo, kFSbo2));",
        "      d2[p] += __uint_as_float(a2[f_pair_i(p)][s][0] ^ b2);"),
    "no_next_frame": (
        "  if (more) f_store<N1>(v, swin, b1p);", ""),
    "no_next_load": (
        "          f_load<N1>(xb, T,\n"
        "                     s_tile + static_cast<long long>(f0 + i + 1) * "
        "hop,\n                     f.n2, v);",
        "          v[0][0] = static_cast<float>(i);"),
    "no_projection": (
        "      if (h.bf2)\n"
        "        project_bf2<3, kNe>(h, ch, pb, work, en, f.rowmap);\n"
        "      else\n"
        "        project_f32<3, kNe>(h, ch, pb, en, f.rowmap);",
        "      en[0][0][0] += pb[ch];"),
}
FFT = build.CSRC_DIR / "sig_fft.cuh"
# K1's float64 FFT path: variant -> its (text, replacement) cuts
FFT_CUTS = {
    "no_load": [(
        "      fft_load<2048>(p.x + b * p.T + s, p.T - s, p.pack, t, xv);\n",
        "      for (int n = 0; n < kFftPoints; ++n) xv[n] = make_float2(n + g, "
        "t);\n")],
    "no_mean": [(
        "      for (int sh = 16; sh > 0; sh >>= 1)\n"
        "        part += __shfl_xor_sync(0xffffffffu, part, sh);\n"
        "      if (lane == 0) red[grp][warp] = part;\n", ""), (
        "      mean = (red[grp][0] + red[grp][1]) / p.pack;",
        "      mean = part;")],
    "no_preprocessing": [(
        "      v[n] = make_double2(w.x * d0, w.y * d1);", "")],
    "no_passes": [
        ("    // pass 1: the radix-16 over n in thread t, then W1024^(t k1)\n"
         "    fft16(v);\n", ""),
        ("      fft16(v);\n      fft_turn(v, stw[32 * a]);\n",
         "      fft_turn(v, stw[32 * a]);\n"),
        ("      fft4(v[4 * bq], v[4 * bq + 1], v[4 * bq + 2], v[4 * bq + 3]);\n",
         "")],
    "no_split": [(
        "  fft_split<kMag>(za, zb, w, lo, hi);\n",
        "  lo = static_cast<float>(za.x);\n  hi = static_cast<float>(zb.y);\n")],
    "no_projection": [(
        "#pragma unroll 1\n"
        "      for (int j = sub; j < n; j += kFftMelLanes) {\n"
        "        const float2 qq = pm[j];",
        "#pragma unroll 1\n"
        "      for (int j = sub; j < 0; j += kFftMelLanes) {\n"
        "        const float2 qq = pm[j];")],
    "no_group_syncs": [(
        '  asm volatile("bar.sync %0, %1;" ::"r"(grp + 1),\n'
        '               "n"(FftSize<2048>::kGroupThreads)\n'
        '               : "memory");', "")],
}
# the 1024-point instance's cuts, timed on K1 alone at its heads
FFT1024_CUTS = {
    "no_projection": [(
        "#pragma unroll 1\n"
        "      for (int j = sub; j < n; j += kFftMelLanes) {\n"
        "        const float2 hq = pm[j];",
        "#pragma unroll 1\n"
        "      for (int j = sub; j < 0; j += kFftMelLanes) {\n"
        "        const float2 hq = pm[j];")],
    "no_passes": [
        ("    // pass 1: the radix-16 over n in lane t, then W512^(t k1)\n"
         "    fft16(v);\n", ""),
        ("      fft16(v);\n      fft_turn(v, stw[32 * (u & 1)]);\n",
         "      fft_turn(v, stw[32 * (u & 1)]);\n"),
        ("        fft2(v[2 * bq], v[2 * bq + 1], buf[lo], buf[lo ^ 1]);\n"
         "        fft2(v[2 * bq + 8], v[2 * bq + 9], buf[hi], buf[hi ^ 1]);\n",
         "        v[2 * bq] = buf[lo];\n        v[2 * bq + 1] = buf[lo ^ 1];\n"
         "        v[2 * bq + 8] = buf[hi];\n"
         "        v[2 * bq + 9] = buf[hi ^ 1];\n")],
    "no_split": [(
        "  const double er = 0.5 * (za.x + zb.x), ei = 0.5 * (za.y - zb.y);\n"
        "  const double orr = 0.5 * (za.y + zb.y), oi = 0.5 * (zb.x - za.x);\n"
        "  const double tr = w.x * orr - w.y * oi, ti = w.x * oi + w.y * orr;\n"
        "  if (lo) pq[k] = bf2_halves(fft512_power<kMag>(er + tr, ei + ti));\n"
        "  if (hi) pq[kHalf - k] = bf2_halves(fft512_power<kMag>(er - tr, "
        "ti - ei));\n",
        "  if (lo) pq[k] = make_float2(za.x, w.y);\n"
        "  if (hi) pq[kHalf - k] = make_float2(zb.y, w.x);\n")],
    "no_exchanges": [
        ("        buf[fft512_at1(u, k1 & 3) + 32 * (k1 & ~3)] = "
         "v[fft16_at(k1)];\n", "        (void)u;\n"),
        ("        v[bb] = buf[fft512_at1(a + 2 * (bb & 3), k1) + 2 * "
         "(bb & ~3)];\n",
         "        v[bb] = make_double2(v[bb].y + k1, v[bb].x - a);\n"),
        ("#pragma unroll\n      for (int c = 0; c < kFftPoints; ++c) "
         "w[32 * c] = v[fft16_at(c)];\n", "      (void)w;\n"),
        ("        fft2(v[2 * bq], v[2 * bq + 1], buf[lo], buf[lo ^ 1]);\n"
         "        fft2(v[2 * bq + 8], v[2 * bq + 9], buf[hi], buf[hi ^ 1]);\n",
         "        fft2(v[2 * bq], v[2 * bq + 1], v[bq], make_double2(lo, hi));\n"
         "        fft2(v[2 * bq + 8], v[2 * bq + 9], v[15 - bq], v[bq + 4]);"
         "\n")],
    "no_root": [(
        "    return static_cast<float>(sqrt(re * re + im * im));",
        "    return static_cast<float>(re * re + im * im);")],
}
B, SECONDS = 64, 30.0
# the configs of mode time: K1's 128- and 64-frame chunk-walk layouts
TIMED = [(400, 160, 128, 16000.0), (1024, 256, 80, 22050.0)]
# the wide hops of dump (K1's factored path)
WIDE = [(960, 480, 40, 48000.0), (1024, 480, 64, 48000.0),
        (2048, 512, 128, 22050.0)]
# the Kaldi and NeMo heads of the FFT path (mode fft, dump): n_fft 2048,
# 25 ms frames, 10 ms hop at 48 kHz; dump also at 64 and 80 kHz (frames of
# 1600 and 2000 taps)
LN_RATE = 48000
LN_RATES = (48000, 64000, 80000)
# compare: the largest distance an ln case of the FFT path may read from
# another dump's (two designs of the float64 FFT: their sums in another
# order, the power rounded once to float32 either way)
LN_TOL = 2e-6
# NeMo's TTS mel (the cell nemo-tts-22k's settings)
TTS = dict(sample_rate=22050, n_fft=1024, win_length=1024, hop_length=256,
           f_max=8000.0, center=False, log_zero_guard=1e-5, mag_power=1.0,
           log_zero_guard_type="clamp", exact_pad=True)
# dump's heads at n_fft 1024: (case, entry point, config keywords, rate)
FFT1024_CASES = (
    ("fft1024_nemo_tts", "logmel", TTS, 22050),
    ("fft1024_kaldi_32000", "fbank", dict(sample_rate=32000.0,
                                          apply_cmn=False), 32000),
    ("fft1024_kaldi_mag_32000", "fbank", dict(
        sample_rate=32000.0, apply_cmn=False, use_power=False), 32000),
    ("fft1024_nemo_32000", "logmel", dict(sample_rate=32000, n_fft=1024,
                                          win_length=800, hop_length=320),
     32000))
# compare: the largest distance an fft1024 case may read from its float64
# rdft route where the FFT path ran it (chip_smoke.py's LN_TOL)
REF_TOL = 2e-4
FUNCTIONS = ("melspec_sig_mel", "melspec_sig_mel_factored",
             "melspec_sig_mel_fft", "melspec_sig_mel_fft_smem",
             "melspec_sig_mel_layout", "melspec_sig_mel_pipe_bytes",
             "melspec_cuda_error_string")
K2_FUNCTIONS = ("melspec_sig_multi", "melspec_sig_multi_layout",
                "melspec_cuda_error_string")
# dump's K2 cases beside k2_whisper_kaldi_vad
K2_CASES = ("k2_large_v3_kaldi_vad", "k2_nemo_fold_vad", "k2_8k_pair_vad",
            "k2_large_v3_133_ragged")


def cut_file(name: str):
    """The header that variant ``name`` cuts: ``sig_pipe.cuh`` for
    ``PIPE_CUTS``, else ``sig_common.cuh``."""
    return PIPE if name in PIPE_CUTS else HEADER


def variant_source(name: str, text: str | None = None) -> str:
    """``cut_file(name)`` with variant ``name``'s cut of ``CUTS`` or
    ``PIPE_CUTS`` (``"full"``: ``sig_common.cuh`` as it is); raises
    unless the cut's text occurs exactly once."""
    cuts = [] if name == "full" else [{**CUTS, **PIPE_CUTS}[name]]
    return build.edited(cut_file(name), cuts, f"sig_probe cut {name!r}",
                        text)


def factored_source(name: str, text: str | None = None) -> str:
    """``sig_factored.cuh`` with ``FACTORED_CUTS[name]`` made (``"full"``:
    as it is); raises unless the cut's text occurs exactly once."""
    cuts = [] if name == "full" else [FACTORED_CUTS[name]]
    return build.edited(FACTORED, cuts, f"sig_probe cut {name!r}", text)


def fft_source(name: str, text: str | None = None) -> str:
    """``sig_fft.cuh`` with ``FFT_CUTS[name]`` made, or
    ``FFT1024_CUTS[cut]`` for ``name`` ``"w1024_<cut>"`` (``"full"``: as
    it is); raises unless each cut's text occurs exactly once."""
    cuts = ([] if name == "full" else
            FFT1024_CUTS[name[len("w1024_"):]] if name.startswith("w1024_")
            else FFT_CUTS[name])
    return build.edited(FFT, cuts, f"sig_probe cut {name!r}", text)


def ln_fronts(dev: torch.device, rate: int = LN_RATE) -> dict:
    """Kaldi fbank and NeMo log-mel at ``rate`` on their sig routes
    (public API only)."""
    from melspec_tpu_torch.config import BatchLogMelConfig, FbankConfig
    from melspec_tpu_torch.ops.batch_logmel import BatchLogMel
    from melspec_tpu_torch.ops.fbank import Fbank

    return {"kaldi": Fbank(FbankConfig(sample_rate=float(rate),
                                       apply_cmn=False),
                           fft_impl="sig", device=dev),
            "nemo": BatchLogMel(BatchLogMelConfig(
                sample_rate=rate, n_fft=2048, win_length=rate // 40,
                hop_length=rate // 100), fft_impl="sig", device=dev)}


def fft1024_calls(dev: torch.device) -> dict:
    """K1 alone (``sig_mel`` on the head) at the 1024-point instance's
    heads on ``B`` x 10 s: NeMo's TTS head on the cell's reflect-padded
    clips, Kaldi's at 22.05 kHz (no entry point takes the sig route
    there)."""
    from melspec_tpu_torch.config import BatchLogMelConfig, FbankConfig
    from melspec_tpu_torch.ops import batch_logmel, fbank, framing

    rng = np.random.default_rng(1)
    x = torch.from_numpy((rng.normal(size=(B, 220500)) * 0.2).astype(
        np.float32)).to(dev)
    tts = batch_logmel.sig_head(BatchLogMelConfig(**TTS)).to(dev)
    padded = torch.nn.functional.pad(x[:, None], (384, 384),
                                     mode="reflect")[:, 0].contiguous()
    kaldi_cfg = FbankConfig(sample_rate=22050.0, apply_cmn=False)
    kaldi = fbank.sig_head(kaldi_cfg).to(dev)
    calls = {}
    for name, head, sig, hop in (
            ("nemo_tts", tts, padded, 256),
            ("kaldi_22050", kaldi, x, kaldi_cfg.frame_shift_samples)):
        kw = dict(ks=3, n_frames=framing.num_frames_batch(
            sig.shape[-1], head.pack_off + head.pack, hop), hop=hop,
            offset=0)
        calls[name] = (lambda s=sig, h=head, kw=kw: sig_mel.sig_mel(
            s, h, **kw))
    return calls


def run_fft(dev: torch.device, timer) -> list:
    """Each FFT-path variant's K1 time (``timer(fn)`` -> ms): the 2048
    instance's cuts through ``Fbank`` / ``BatchLogMel`` at ``LN_RATE`` on
    ``B`` x ``SECONDS``, the 1024 instance's (``w1024_...``) on K1 alone
    at ``fft1024_calls``; the full kernel at both."""
    x = torch.from_numpy((np.random.default_rng(0).normal(
        size=(B, int(SECONDS * LN_RATE))) * 0.2).astype(np.float32)).to(dev)
    calls = {name: (lambda f=front: f.compute(x))
             for name, front in ln_fronts(dev).items()}
    calls1024 = fft1024_calls(dev)
    cuts = {**FFT_CUTS, **{f"w1024_{k}": v for k, v in
                           FFT1024_CUTS.items()}}
    names = ["full", *cuts]
    libs = build.build_variants("sig_probe_fft", "sig_mel", {
        name: {FFT.name: fft_source(name)} for name in names})
    rows = []
    for name in names:
        timed = ({**calls, **calls1024} if name == "full" else
                 calls1024 if name.startswith("w1024_") else calls)
        with build.bound_to(sig_mel, libs[name], FUNCTIONS):
            rows.append(dict(variant=name, ms={k: timer(fn)
                                               for k, fn in timed.items()}))
    for r in rows:
        r["saves_ms"] = {k: rows[0]["ms"][k] - v for k, v in r["ms"].items()}
    return rows


def run_factored(dev: torch.device, timer) -> list:
    """Each factored variant's K1 time (``timer(fn)`` -> ms) at the three
    wide hops on ``B`` x ``SECONDS``."""
    from melspec_tpu_torch.ops import framing, mel_kernel

    rng = np.random.default_rng(0)
    calls = {}
    for fft, hop, n_mels, sr in WIDE:
        x = torch.from_numpy((rng.normal(size=(B, int(SECONDS * sr)))
                              * 0.2).astype(np.float32)).to(dev)
        head = mel_kernel.whisper_head(fft, n_mels, sr, dev)
        kw = dict(ks=3, n_frames=framing.num_frames_batch(x.shape[-1], fft,
                                                          hop),
                  hop=hop, offset=0)
        calls[f"{fft}_{hop}_{n_mels}"] = (
            lambda x=x, h=head, kw=kw: sig_mel.sig_mel(
                x, h, **kw))
    names = ["full", *FACTORED_CUTS]
    libs = build.build_variants("sig_probe_factored", "sig_mel", {
        name: {FACTORED.name: factored_source(name)} for name in names})
    rows = []
    for name in names:
        with build.bound_to(sig_mel, libs[name], FUNCTIONS):
            rows.append(dict(variant=name, ms={k: timer(fn)
                                               for k, fn in calls.items()}))
    for r in rows:
        r["saves_ms"] = {k: rows[0]["ms"][k] - v for k, v in r["ms"].items()}
    return rows


def k2_step(dev: torch.device, x: torch.Tensor):
    """K2 at the frontend step's launch on ``x`` (16 kHz): whisper
    large-v3 + Kaldi 80 with the VAD epilogue (public API only)."""
    from melspec_tpu_torch.config import WHISPER_LARGE_V3 as c
    from melspec_tpu_torch.config import DetectionSettings
    from melspec_tpu_torch.ops import framing
    from melspec_tpu_torch.ops.sig_multihead import WhisperKaldiFused

    fused = WhisperKaldiFused(c, device=dev)
    kw = dict(ks=3, n_frames=framing.num_frames_batch(
        x.shape[-1], c.fft_size, c.hop_size), hop=c.hop_size,
        vad=sig_mel.vad_args(DetectionSettings(), c.n_mels))
    return lambda: sig_multi.sig_multi(x, fused.heads, **kw)


def run(dev: torch.device, timer) -> list:
    """Each variant's time (``timer(fn)`` -> ms): the pipelined walk's at
    K1's batch path's launch, NeMo's and K2's frontend step launch, the
    synchronous walk's at K1's 1024/256/80; then K1 and K2 as they
    are."""
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
    kw = dict(ks=3, n_frames=nf, hop=c.hop_size, offset=0)
    nemo = BatchLogMel(device=dev)
    wide = mel_kernel.whisper_head(1024, 80, 22050.0, dev)
    x22 = torch.from_numpy((rng.normal(size=(B, int(SECONDS * 22050)))
                            * 0.2).astype(np.float32)).to(dev)
    kw22 = dict(ks=3, n_frames=framing.num_frames_batch(x22.shape[-1], 1024,
                                                        256),
                hop=256, offset=0)

    def k1():
        return sig_mel.sig_mel(x, head, **kw)

    def k1_22k():
        return sig_mel.sig_mel(x22, wide, **kw22)

    calls = {"whisper_400_160_128": k1, "nemo_512_400_80": (
        lambda: nemo.compute(x)), "whisper_1024_256_80": k1_22k}
    k2 = k2_step(dev, x)
    names = ["full", *PIPE_CUTS, *CUTS]
    variants = {name: {cut_file(name).name: variant_source(name)}
                for name in names}
    libs = build.build_variants("sig_probe", "sig_mel", variants)
    k2_libs = build.build_variants("sig_probe_k2", "sig_multi", {
        name: variants[name] for name in ["full", *PIPE_CUTS]})
    rows = []
    for name in names:
        timed = (["whisper_1024_256_80"] if name in CUTS else
                 ["whisper_400_160_128", "nemo_512_400_80"]
                 if name in PIPE_CUTS else list(calls))
        with build.bound_to(sig_mel, libs[name], FUNCTIONS):
            ms = {k: timer(calls[k]) for k in timed}
            if name in k2_libs:
                with build.bound_to(sig_multi, k2_libs[name],
                                    K2_FUNCTIONS):
                    ms["k2_whisper_kaldi_vad"] = timer(k2)
        rows.append(dict(variant=name, ms=ms))
    for r in rows:
        r["saves_ms"] = {k: rows[0]["ms"][k] - v for k, v in r["ms"].items()}
    fused = WhisperKaldiFused(c, device=dev)
    rows += [
        dict(variant="k1_whisper_128", ms=timer(k1)),
        dict(variant="k2_whisper_kaldi_vad", ms=timer(
            lambda: sig_multi.sig_multi(
                x, fused.heads, ks=3, n_frames=nf, hop=c.hop_size,
                vad=sig_mel.vad_args(DetectionSettings(), c.n_mels)))),
        dict(variant="k1_ln_guard_nemo", ms=timer(lambda: nemo.compute(x))),
        dict(variant="k1_whisper_1024_22k", ms=timer(
            lambda: sig_mel.sig_mel(x22, wide, **kw22)))]
    return rows


def time_main_path(dev: torch.device, timer) -> dict:
    """K1's time (``timer(fn)`` -> ms) at each ``TIMED`` config on ``B``
    x ``SECONDS``, through ``whisper_head`` and ``sig_mel`` (the public
    API, as ``dump``), and K2's at the frontend step's launch
    (``k2_step``) on the same 16 kHz signal."""
    from melspec_tpu_torch.ops import framing, mel_kernel

    rng = np.random.default_rng(0)
    ms = {}
    for fft, hop, n_mels, sr in TIMED:
        x = torch.from_numpy((rng.normal(size=(B, int(SECONDS * sr)))
                              * 0.2).astype(np.float32)).to(dev)
        head = mel_kernel.whisper_head(fft, n_mels, sr, dev)
        kw = dict(ks=3, n_frames=framing.num_frames_batch(x.shape[-1], fft,
                                                          hop),
                  hop=hop, offset=0)
        ms[f"{fft}_{hop}_{n_mels}"] = timer(
            lambda x=x, h=head, kw=kw: sig_mel.sig_mel(
                x, h, **kw))
        if sr == 16000.0:
            ms["k2_whisper_kaldi_vad"] = timer(k2_step(dev, x))
    return ms


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()


def dump_cases(dev: torch.device) -> list:
    """``(name, launch)`` for every case of ``dump``, inputs from fixed
    seeds; ``launch()`` returns a tuple of outputs. Public API only."""
    from melspec_tpu_torch.config import DetectionSettings
    from melspec_tpu_torch.ops import mel_kernel
    from melspec_tpu_torch.ops.sig_multihead import WhisperKaldiFused

    rng = np.random.default_rng(7)

    def signal(b, n):
        return torch.from_numpy((rng.normal(size=(b, n)) * 0.2).astype(
            np.float32)).to(dev)

    out = []
    for fft, hop, n_mels, sr in [(400, 160, 128, 16000.0),
                                 (1024, 256, 80, 22050.0)]:
        x = signal(8, int(10 * sr) + 37)
        for streaming in (False, True):
            for precision in ("bf2", "highest"):
                out.append((
                    f"sig_{fft}_{hop}_{n_mels}/{streaming}/{precision}",
                    lambda x=x, a=(fft, hop, n_mels, sr), s=streaming,
                    p=precision: (mel_kernel.whisper_mel_sig(
                        x, *a, streaming=s, mel_precision=p, device=dev),)))
    x = signal(8, 16000 * 10 + 37)
    settings = DetectionSettings()
    out.append(("vad_400_160_128", lambda: mel_kernel.whisper_mel_vad_sig(
        x, settings, 400, 160, 128, device=dev)))
    out.append(("quant_400_160_128", lambda: mel_kernel.whisper_mel_quantized(
        x, 400, 160, 128, device=dev)))
    fused = WhisperKaldiFused(device=dev)
    out.append(("k2_whisper_kaldi_vad",
                lambda: fused.compute_with_vad(x, settings)))
    out += k2_cases(dev, signal, settings)
    for fft, hop, n_mels, sr in WIDE:
        a = (fft, hop, n_mels, sr)
        xw = signal(4, int(10 * sr) + 37)
        for streaming in (False, True):
            for precision in ("bf2", "highest"):
                out.append((
                    f"wide_sig_{fft}_{hop}_{n_mels}/{streaming}/{precision}",
                    lambda x=xw, a=a, s=streaming, p=precision: (
                        mel_kernel.whisper_mel_sig(
                            x, *a, streaming=s, mel_precision=p,
                            device=dev),)))
        out.append((f"wide_vad_{fft}_{hop}_{n_mels}",
                    lambda x=xw, a=a: mel_kernel.whisper_mel_vad_sig(
                        x, settings, *a, device=dev)))
        out.append((f"wide_quant_{fft}_{hop}_{n_mels}",
                    lambda x=xw, a=a: mel_kernel.whisper_mel_quantized(
                        x, *a, device=dev)))
    for rate in LN_RATES:
        xl = signal(4, 10 * rate + 37)
        for name, front in ln_fronts(dev, rate).items():
            out.append((f"ln_{name}_{rate}",
                        lambda x=xl, f=front: (f.compute(x),)))
    for name, (front, f64), rate in fft1024_fronts(dev):
        xf = signal(4, 10 * rate + 37)
        out.append((name, lambda x=xf, f=front, r=f64: (
            f.compute(x), r.compute(x.double()))))
    return out


def fft1024_fronts(dev: torch.device) -> list:
    """``[(case, (entry point on "sig", its float64 rdft route), rate)]``
    of ``FFT1024_CASES`` (public API only)."""
    from melspec_tpu_torch.config import BatchLogMelConfig, FbankConfig
    from melspec_tpu_torch.ops.batch_logmel import BatchLogMel
    from melspec_tpu_torch.ops.fbank import Fbank

    out = []
    for name, entry, kw, rate in FFT1024_CASES:
        cls, cfg = ((BatchLogMel, BatchLogMelConfig(**kw)) if entry == "logmel"
                    else (Fbank, FbankConfig(**kw)))
        out.append((name, (cls(cfg, fft_impl="sig", device=dev),
                           cls(cfg, dtype=torch.float64, fft_impl="rdft",
                               device=dev)), rate))
    return out


def k2_cases(dev: torch.device, signal, settings) -> list:
    """``dump``'s ``K2_CASES`` (``signal(b, n)`` -> inputs from the
    dump's seed): whisper large-v3 + Kaldi with the VAD (the frontend
    step's heads), WhisperKaldiNemoFused's three heads with the VAD, the 8
    kHz whisper + Kaldi pair with the VAD, and the large-v3 pair with the
    VAD on 133 clips of 2 s + 37 samples (1,536 blocks, a frame count no
    multiple of 128) through ``sig_multi`` itself. Public API only."""
    from melspec_tpu_torch.config import WHISPER_LARGE_V3 as c
    from melspec_tpu_torch.config import FbankConfig, MelConfig
    from melspec_tpu_torch.ops import framing
    from melspec_tpu_torch.ops.sig_multihead import (WhisperKaldiFused,
                                                     WhisperKaldiNemoFused)

    large = WhisperKaldiFused(c, device=dev)
    tri = WhisperKaldiNemoFused(device=dev)
    pair8 = WhisperKaldiFused(MelConfig(200, 80, 80, 8000.0), FbankConfig(
        sample_rate=8000.0, apply_cmn=False), device=dev)
    x = signal(8, 16000 * 10 + 37)
    x8 = signal(8, 8000 * 10 + 37)
    x133 = signal(133, 16000 * 2 + 37)
    vad = sig_mel.vad_args(settings, c.n_mels)
    nf = framing.num_frames_batch(x133.shape[-1], c.fft_size, c.hop_size)
    launches = (
        lambda: large.compute_with_vad(x, settings),
        lambda: tri.compute_with_vad(x, settings),
        lambda: pair8.compute_with_vad(x8, settings),
        lambda: sig_multi.sig_multi(x133, large.heads, ks=3, n_frames=nf,
                                    hop=c.hop_size, vad=vad))
    return list(zip(K2_CASES, launches))


def _flat(outs) -> list:
    if isinstance(outs, torch.Tensor):
        return [outs]
    if isinstance(outs, dict):
        return [t for k in sorted(outs) for t in _flat(outs[k])]
    return [t for o in outs for t in _flat(o)]


def dump(out_dir: Path, dev: torch.device) -> dict:
    out_dir.mkdir(parents=True, exist_ok=True)
    rows = {}
    for name, launch in dump_cases(dev):
        ffts = sig_mel.fft_launches
        outs = _flat(launch())
        torch.cuda.synchronize()
        rows[name] = dict(sha256=[_digest(t) for t in outs],
                          shapes=[list(t.shape) for t in outs])
        if name.startswith(("ln_", "fft1024_")):
            np.save(out_dir / f"{name}.npy", outs[0].cpu().numpy())
        if name.startswith("fft1024_"):
            # the kernel's output alone is hashed; the float64 route's is
            # saved beside it
            rows[name] = dict(sha256=rows[name]["sha256"][:1],
                              shapes=rows[name]["shapes"][:1],
                              fft_path=sig_mel.fft_launches > ffts)
            np.save(out_dir / f"{name}.ref.npy", outs[1].cpu().numpy())
    import melspec_tpu_torch

    result = dict(package=str(Path(melspec_tpu_torch.__file__).parent),
                  device=torch.cuda.get_device_name(0), cases=rows)
    (out_dir / "dump.json").write_text(json.dumps(result, indent=1))
    return result


def ln_distance(dirs, name: str):
    """The largest distance of the ``ln_...`` case ``name``'s output in
    each dump from the first dump's (``None`` where a dump lacks it or the
    shapes differ)."""
    paths = [Path(d) / f"{name}.npy" for d in dirs]
    if not all(p.exists() for p in paths):
        return None
    outs = [np.load(p).astype(np.float64) for p in paths]
    if any(o.shape != outs[0].shape for o in outs):
        return None
    return max(float(np.abs(o - outs[0]).max()) for o in outs)


def ref_distances(dirs, dumps, name: str) -> list:
    """For each dump, ``(distance of the fft1024 case name's output from
    its float64 route, whether the FFT path ran it)``, or ``None`` where
    the dump lacks the case or its outputs."""
    out = []
    for d, dump in zip(dirs, dumps):
        got, ref = Path(d) / f"{name}.npy", Path(d) / f"{name}.ref.npy"
        case = dump["cases"].get(name)
        if case is None or not (got.exists() and ref.exists()):
            out.append(None)
            continue
        a, b = np.load(got).astype(np.float64), np.load(ref)
        out.append(None if a.shape != b.shape else (
            float(np.abs(a - b).max()), bool(case.get("fft_path"))))
    return out


def compare(dirs) -> int:
    """Every case bit-equal across the dumps, but an ``ln_...`` case of
    the float64 FFT path may differ by at most ``LN_TOL`` (its sums are
    float64 in another order where the kernel's FFT changed), and an
    ``fft1024_...`` case is held to its own float64 route instead: within
    ``REF_TOL`` in each dump where the FFT path ran it, and run there in
    one dump at least."""
    dumps = [json.loads((Path(d) / "dump.json").read_text()) for d in dirs]
    names = list(dict.fromkeys(n for d in dumps for n in d["cases"]))
    refs = {n: ref_distances(dirs, dumps, n) for n in names
            if n.startswith("fft1024_")}
    ref_fail = [n for n, r in refs.items()
                if None in r or not any(ran for _, ran in r)
                or any(ran and dist > REF_TOL for dist, ran in r)]
    unequal = [n for n in names if n not in refs
               and len({json.dumps(d["cases"].get(n, {}).get("sha256"))
                        for d in dumps}) != 1]
    within = {n: ln_distance(dirs, n) for n in unequal if n.startswith("ln_")}
    within = {n: d for n, d in within.items() if d is not None and d <= LN_TOL}
    differ = [n for n in unequal if n not in within] + ref_fail
    print(json.dumps(dict(dumps=[str(d) for d in dirs],
                          packages=[d["package"] for d in dumps],
                          n_cases=len(names),
                          n_equal=len(names) - len(refs) - len(unequal),
                          ln_within=within, ln_tol=LN_TOL,
                          fft1024_vs_f64=refs, ref_tol=REF_TOL,
                          differ=differ)), flush=True)
    return 1 if differ else 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("sig_probe: CUDA is not available", file=sys.stderr)
        return 1
    if argv[:1] == ["dump"] and len(argv) == 2:
        r = dump(Path(argv[1]), torch.device("cuda"))
        print(json.dumps(dict(package=r["package"], device=r["device"],
                              n_cases=len(r["cases"]))), flush=True)
        return 0
    if argv[:1] == ["compare"] and len(argv) >= 3:
        return compare(argv[1:])
    if argv not in ([], ["factored"], ["fft"], ["time"]):
        print(__doc__, file=sys.stderr)
        return 2
    from melspec_tpu_torch.utils.timing import device_time_ms, per_launch_ms

    if argv == ["time"]:
        import melspec_tpu_torch

        dev = torch.device("cuda")
        print(json.dumps(dict(
            package=str(Path(melspec_tpu_torch.__file__).parent),
            device=torch.cuda.get_device_name(0),
            ms=time_main_path(dev, device_time_ms),
            ms_per_launch=time_main_path(
                dev, lambda fn: per_launch_ms(fn, launches=50)))),
            flush=True)
        return 0

    probe = {"factored": run_factored, "fft": run_fft}.get(
        argv[0], run) if argv else run
    for r in probe(torch.device("cuda"), device_time_ms):
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
