#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from the sources in this checkout
(K1 ``csrc/sig_mel.cu``, K2 ``csrc/sig_multi.cu``, K3/K4
``csrc/resample.cu``, K5-K8 ``csrc/framed_ozaki.cu``, P1
``csrc/load_probe.cu``, one ``nvcc`` each, started together), holds each
against its plain PyTorch version on the card, checks the accuracy gates
through the kernels, and drives the port's main paths at full width,
with launch counts (zeroed just before each path, read just after) that
show each went through its kernels:

- the batch path: raw ``[B, T]`` audio -> whisper large-v3 log-mel through
  ``WhisperMelPipeline.mel_batch`` (K1);
- the serving tick: 256 streams of 48 kHz PCM -> resample -> streaming mel
  -> VAD -> u8 records through ``shared_frontend(..., input_rate=48000)``
  (K4, K3 on a 1-hop tick, K1 on the sig route), its frame grid held
  against a plain frontend fed float64 ``resample_poly`` audio and, on
  the sig route, every tick's K1 output (offset = hop) held against K1's
  plain version; then a 64-stream 8 kHz fleet (K4 upsampling) and a 256 x
  500-hop bulk tick for kernel times, with K3/K4 and the ``conv1d``
  yardstick timed per launch on the device (and per call) there, and at
  the 4-hop (K4) and 1-hop (K3) ticks' shapes and the 8 kHz fleet's
  4-hop tick (K4);
- the composite frontend step: 64 x 30 s through
  ``sharded_frontend_step`` at whisper large-v3 + Kaldi fbank + NeMo
  log-mel defaults (K2 with whisper, Kaldi and the VAD; K1 in ln_guard
  for NeMo), and 64 x 10 s at the JAX defaults, after K1's ln modes and
  K2 (two and three heads) are held against their plain versions, and K1
  at the 256- and 1024-column heads (whisper at 8 kHz, 256/96, 22.05 kHz,
  48 kHz where it fits; Kaldi and NeMo at 8 kHz) and K2 on the 8 kHz
  whisper + Kaldi pair against K1 (phase k1_widths);
- the precision dial: ``whisper_mel_pallas(x, 400, 160, 128, impl=...)``
  on 64 x 30 s for each of bf3 / hp8 / hp_bf16 / f32 (K5 / K6 / K7 / K8,
  one launch each, K1 none), after K5-K8 are held against their plain
  versions (float32 and float64 dots) on 64 ragged 10 s clips, on 8
  clips at 1024/256/80/22050 and on 8 clips at 960/480/40/48000 (the
  auto route's K5 where K1 refuses the head) and pass the JFK gates, and
  K6's and K7's
  DFT power equals their plain versions' bit for bit at both shapes and
  framings (phase ozaki_power); then the auto
  routes of the 256- and 1024-column heads (whisper 1024/256 at 22.05
  kHz through the pipeline and ``whisper_mel_pallas(impl=None)``, 8 kHz
  Kaldi fbank and NeMo log-mel), which take K1 wherever ``k1_accepts``
  holds, each held against its float64 and plain result;
- the VAD and wire-record path: after K1's quant and VAD epilogues are
  held against K1's own mel (records bit-equal to ``quantize_frames``, raw
  equal to ``classify_columns``, tile-boundary columns included) and
  their plain versions, 64 x 30 s through ``whisper_mel_vad_sig`` ->
  ``streaming_decision_fields_batched(raw=...)`` -> per-frame decisions
  with ``VadFrameTiming`` timestamps, and ``whisper_mel_quantized`` -> u8
  records -> TGA (K1 once with each epilogue), at 128 and 80 mels;
- the TEN-VAD eval: ``evaluate_testset_batched`` on the 30 vendored files
  in both presets, held to the published macro digits, and the same files
  through K1's VAD epilogue;
- P1, the signal-load probe (``load_probe.run``): flat rows and K1's
  spans copied through shared memory, each mode exact, with its GB/s.
- the live per-hop service, plain PyTorch as in the JAX package (phase
  ``live_stream``, no kernel of the port: K1-K8 and P1 read 0 launches):
  the native ``SampleRing`` built from the checkout, JFK through
  ``RingBuffer`` in 32-sample pushes against the golden, whisper
  large-v3 through ``StreamingMel.push`` / ``push_many`` against the
  CPU's float64 with the push latency and kernels per push,
  ``SpeechToMel`` against the CPU port's records, and a producer thread
  feeding a ``SampleRing`` that a consumer drains into ``SpeechToMel``.
- the example entry points (phase ``serve_streams``): the TCP
  ``StreamServer`` of ``melspec_tpu_torch/examples/serve_streams.py``
  with 256 concurrent ``stream_client`` threads of 48 kHz f32 PCM over
  loopback at whisper large-v3 on the sig route (K4 and K1 every tick),
  then 64 clients of 8 kHz s16le at 80 mels on rdft (K4 only), every
  client's records against the CPU's float64; one WebSocket client
  through ``BrowserBridge`` against a TCP client; and the CLIs
  (``mel_tga``, ``live_pipeline``, ``stream_asr_segments``,
  ``vad_ten_eval --batched``) by subprocess on their default device.
- the scale-out package (phase ``parallel``): the frontend step at 64 x
  30 s in a one-rank NCCL group (its all-reduce on the card) bit-equal to
  the step without a group; then two gloo ranks, processes of this script
  (``--parallel-worker``) both on the one card, each holding its block of
  ``sharded_frontend_step`` and ``sharded_whisper_mel`` against a one-rank
  run, ``sharded_serving(input_rate=48000, fft_impl="sig")`` over 128 of
  256 streams for 50 ticks against one rank (with a whole-fleet
  checkpoint at tick 25 resumed bit for bit) and ``multihost_frontend``
  over the 30 TEN-VAD wavs against one rank over every file; K2, K1 and K4
  counted on each rank.

Each phase prints one JSON line. Any failure raises and the script exits
non-zero without its last line; on success the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
It exits non-zero at once where CUDA is not available.
"""

from __future__ import annotations

import contextlib
import json
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from melspec_tpu_torch import (WHISPER_LARGE_V3, RingBuffer,  # noqa: E402
                               SampleRing, SpeechToMel, StreamingMel,
                               WhisperMelPipeline, compute_streaming_mel,
                               read_wav_f32le, whisper_mel_sig)
from melspec_tpu_torch.kernels import (build, framed_mel,  # noqa: E402
                                       framed_ozaki, load_probe, sig_mel,
                                       sig_multi)
from melspec_tpu_torch.kernels import resample as kres  # noqa: E402
from melspec_tpu_torch.config import (BatchLogMelConfig,  # noqa: E402
                                      DetectionSettings, FbankConfig,
                                      MelConfig, VadFrameTiming)
from melspec_tpu_torch.io.tga import (interleave_frames,  # noqa: E402
                                      parse_tga_8bit, tga_8bit_data,
                                      to_array2)
from melspec_tpu_torch.ops import batch_logmel  # noqa: E402
from melspec_tpu_torch.ops import framing, mel_kernel  # noqa: E402
from melspec_tpu_torch.ops.batch_logmel import BatchLogMel  # noqa: E402
from melspec_tpu_torch.ops.fbank import Fbank  # noqa: E402
from melspec_tpu_torch.ops.fbank import \
    sig_head as fbank_sig_head  # noqa: E402
from melspec_tpu_torch.ops.filterbank import (kaldi_filterbank,  # noqa: E402
                                              mel_filterbank)
from melspec_tpu_torch.ops.resample import (_phase_matrix,  # noqa: E402
                                            resample_poly)
from melspec_tpu_torch.ops.sig_multihead import (  # noqa: E402
    WhisperKaldiFused, WhisperKaldiNemoFused)
from melspec_tpu_torch.ops.quant import (dequantize_tensor,  # noqa: E402
                                         quantize_frames, quantize_tensor)
from melspec_tpu_torch.ops.vad import (  # noqa: E402
    boundary_columns, classify_columns, streaming_decision_fields_batched)
from melspec_tpu_torch.ops.windows import (hann_centered,  # noqa: E402
                                           hann_periodic, povey)
from melspec_tpu_torch.parallel import (  # noqa: E402
    make_mesh, multihost_frontend, sharded_frontend_step, sharded_serving,
    sharded_whisper_mel)
from melspec_tpu_torch.runtime import ringbuffer  # noqa: E402
from melspec_tpu_torch.streaming import multistream  # noqa: E402
from melspec_tpu_torch.streaming.resample import (  # noqa: E402
    MultiStreamResampler)
from melspec_tpu_torch.streaming.serving import (  # noqa: E402
    MultiStreamFrontend, SourceRateFrontend, calibrate_fft_impl,
    shared_frontend)
from melspec_tpu_torch.examples import serve_streams  # noqa: E402
from melspec_tpu_torch.examples.browser import server as ws_bridge  # noqa: E402
from melspec_tpu_torch.utils import vad_eval  # noqa: E402
from melspec_tpu_torch.utils.timing import (  # noqa: E402
    device_time_ms as time_ms, per_launch_ms)

TESTDATA = ROOT / "testdata"
# K1 is held against the exact result (its plain version with the DFT dot
# summed in float64) and against the plain version itself (one f32 matmul,
# in cuBLAS's order). On a mel bin 7-8 decades below its frame's peak any
# f32 summation order keeps an error of up to a few 1e-5, so the bars come
# from the f32 floor measured in this run, the plain version's largest
# distance from the exact result: K1 vs exact <= max(K1_TOL, floor), the
# JFK gate's 1e-5 where the floor is lower; K1 vs plain <= that + floor
K1_TOL = 1e-5
SEED = 0
# published peaks of one H100 SXM (NVIDIA data sheet, 700 W): dense bf16
# tensor-core rate and HBM3 bandwidth (P1's denominator)
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = load_probe.PEAK_HBM_BYTES
# and the float32 rate outside the tensor cores (K3/K4 "highest")
PEAK_F32_FLOPS = 67e12
K1_SOURCE = "melspec_tpu_torch/csrc/sig_mel.cu"
K1_REPLACES = "melspec_tpu/ops/mel_kernel.py:1547"
K2_SOURCE = "melspec_tpu_torch/csrc/sig_multi.cu"
K2_REPLACES = "melspec_tpu/ops/sig_multihead.py:151"
# K1's and K2's DFT instruction (csrc/sig_common.cuh::dft_chunk)
DFT_MMA = "wgmma m64n128k16"
FRAMED_SOURCE = "melspec_tpu_torch/csrc/framed_ozaki.cu"
# the framed kernels' frame widths whose block layout the kernels line
# reports: the dial's 400, the JFK gate's 512, 960 at 48 kHz, 1024
FRAMED_WIDTHS = (400, 512, 960, 1024)
FRAMED_REPLACES = {"K5": "melspec_tpu/ops/mel_kernel.py:467",
                   "K6": "melspec_tpu/ops/mel_kernel.py:314",
                   "K7": "melspec_tpu/ops/mel_kernel.py:2060",
                   "K8": "melspec_tpu/ops/mel_kernel.py:2104"}
# the dense int8 tensor-core rate of the same data sheet (K6's type)
PEAK_INT8_OPS = 1979e12
# the precision dial: the JFK gates of tests/test_mel_kernel.py through
# K5-K8 (K8: the fused route's 1e-5); K6 and K7 against their plain
# versions at 1e-6 (their DFTs are exact integers and equal the plain
# version's bit for bit; only the f32 projection's order differs); K5
# and K8 against the exact result (float64 dot) at max(1e-5, the f32
# floor measured in the run) and against the plain version at that plus
# the floor, as K1. The main path is 64 x 30 s at 400/160/128.
FRAMED_JFK = {"bf3": 1e-5, "hp8": 2e-6, "hp_bf16": 1e-6, "f32": 1e-5}
OZAKI_TOL = 1e-6
FRAMED_B, FRAMED_SECONDS = 64, 30.0
# the second check shape (planes of 512 bins, four chunks): 8 ragged 10 s
# clips at 22.05 kHz; the third, whisper 960/480/40 at 48 kHz (960 taps:
# 32-frame blocks), 8 ragged 10 s clips; the auto routes' clips are 30 s
# long
FRAMED_22K_B, FRAMED_22K_T = 8, 10 * 22050 + 37
FRAMED_48K_B, FRAMED_48K_T = 8, 10 * 48000 + 37
AUTO_SECONDS = 30
# the auto routes that K1 refuses, against their float64 routes: whisper
# mel at the fused routes' 2e-5, NeMo at LN_TOL; Kaldi fbank (its f32 rdft
# and hp routes) at the JAX package's bar between its Kaldi hp route and
# float64 (tests/test_fbank.py:124), with hp closer on average than rdft,
# as that test holds
AUTO_TOL = 2e-5
KALDI_F32_TOL = 2e-3
# the ln heads' (Kaldi, NeMo) bar against the exact result: the JAX
# package's cross-route bar, raised to the f32 floor measured in the run
# (ln turns the relative error of a near-silent bin into absolute error);
# against the plain version that bar plus the floor
LN_TOL = 2e-4
# the JFK gate of Kaldi fbank against kaldi_native_fbank (tests/test_fbank.py)
KALDI_JFK_GATE = 0.0152
# the composite frontend step: 64 clips of 30 s (whisper large-v3 + Kaldi +
# NeMo defaults), and of 10 s at the JAX defaults (80-mel whisper); K1's
# ln modes and K2 are held against their plain versions on 64 ragged 10 s
# clips (16 tiles of 64 frames)
STEP_B, STEP_SECONDS, STEP80_SECONDS = 64, 30.0, 10.0
CHECK_T = 10 * 16000 + 37
RS_SOURCE = "melspec_tpu_torch/csrc/resample.cu"
K3_REPLACES = "melspec_tpu/ops/resample.py:224"
K4_REPLACES = "melspec_tpu/ops/resample.py:396"
# K3/K4 bars: "highest" (the serving default) sums 61 / 21 taps of a
# 0.3-scale signal in f32, held at 2e-6 against the plain version and the
# float64 result; "bf3" against its plain version (same bf16 products,
# another f32 order) at 2e-6 and against the float64 result of the
# unsliced filter at 1e-5 x scale (the resampler tests' bar)
RS_TOL = 2e-6
RS_BF3_REL = 1e-5
# VAD decisions of a fleet that differ from the plain frontend's on the
# same frames: JAX's own budget is 1 per test for two separately computed
# mels; every earlier run of this script counted 0 of 44,008 (48 kHz)
# and 0 of 7,424 (8 kHz) per fleet
VA_FLIP_BUDGET = 2
# the serving path's sizes: a 48 kHz fleet of FLEET streams ticked FLEET_TICKS
# times with TICK_HOPS hops a tick, an 8 kHz fleet, and the bulk tick
FLEET, FLEET_TICKS, TICK_HOPS = 256, 50, 4
FLEET_8K, FLEET_8K_TICKS = 64, 30
BULK_HOPS = 500
# K1's epilogues: the quant records equal quantize_frames of K1's mel bit
# for bit and the VAD raw classify_columns of it exactly; against the
# plain version lo and hi hold K1's vs-plain bar and q one step. The VAD
# and wire-record path runs at 64 x 30 s; the TEN-VAD eval holds the
# reference's published macro digits (tests/test_vad_eval.py), which the
# port's batched route on the CPU also gives (bf3 power, float32 fields)
WIRE_B, WIRE_SECONDS = 64, 30.0
EDGE_SETTINGS = {"default": DetectionSettings(),
                 "min_y0": DetectionSettings(min_y=0),
                 "min_mel200": DetectionSettings(min_mel=200),
                 "low_thr": DetectionSettings(min_energy=0.1, min_y=1)}
TEN_VAD_DIGITS = {
    "balanced": dict(precision=0.8751, recall=0.8785, f1=0.8566, fpr=0.3946),
    "high-f1": dict(precision=0.8165, recall=0.9635, f1=0.8769, fpr=0.6459)}
P1_SOURCE = "melspec_tpu_torch/csrc/load_probe.cu"
P1_REPLACES = "tools/hbm_reshape_probe.py:47"
# Sobel gradient of one (frame, row): gx and gy 7 operations each, g2 3
SOBEL_OPS = 17
# K1 at the widths other than 512 (phase k1_widths): whisper configs of
# the JAX package's tests/test_configs_broad.py, and Kaldi and NeMo at 8
# kHz (256-column heads); all but 960/480 must be accepted, that one
# where its span fits a block's shared memory
WIDTH_B = 8
WIDTH_CONFIGS = [("whisper_8k", 200, 80, 80, 8000.0),
                 ("whisper_256_96", 256, 96, 32, 16000.0),
                 ("whisper_1024_256", 1024, 256, 80, 22050.0),
                 ("whisper_960_480", 960, 480, 40, 48000.0)]
WIDTH_MUST_ACCEPT = ("whisper_8k", "whisper_256_96", "whisper_1024_256")
NEMO_8K = BatchLogMelConfig(sample_rate=8000, n_fft=256, win_length=200,
                            hop_length=80)
# the live per-hop service (phase live_stream), plain PyTorch as in JAX:
# the JFK master regression through RingBuffer in 32-sample pushes at
# 512/160/80 (float64 at JAX's 1e-6 from the golden; float32 reported
# against its 1e-5 bar from the card's float64 run), bulk drain_mels
# against the per-hop frames (1e-12 at float64; two float32 floors at
# float32, reported; a miss of either float32 bar is logged in ROADMAP
# §3); whisper large-v3 at float32
# against the CPU's float64 result at AUTO_TOL, the bar of the other
# float32 whisper routes against float64 (the CPU's float32 lands 1.2e-5
# there); push latency over LIVE_TIMED hops after
# LIVE_WARMUP, kernels per push over LIVE_PROFILED pushes, bulk push_many
# on LIVE_BULK_HOPS hops (10 minutes at 16 kHz) held to the CPU on its
# first LIVE_HOLD_HOPS, scan=True on LIVE_SCAN_HOPS; SpeechToMel over JFK
# held to the CPU port's records as tests/test_torch_speech_to_mel.py
# holds them to JAX's (max 1e-5; min, the quietest bin, within
# LIVE_MIN_FLOOR of the CPU's float64; u8 at most one step apart on at
# most 0.1% of entries; VAD decisions equal). LIVE_MIN_FLOOR is the JAX
# package's own float32 distance there, 3.80e-3 on JFK (measured by
# tests/test_torch_speech_to_mel.py on the CPU; the port's CPU float32
# lands 1.25e-3): the card's float32 must be no further from float64 than
# the reference's float32 is
LIVE_JFK_CONFIG = MelConfig(512, 160, 80, 16000.0)
LIVE_GOLDEN_TOL = 1e-6
LIVE_F32_TOL = 1e-5
LIVE_BULK_TOL = {"float64": 1e-12, "float32": 2e-5}
LIVE_WIDTH_TOL = AUTO_TOL
LIVE_MIN_FLOOR = 3.8e-3
LIVE_WARMUP, LIVE_TIMED, LIVE_PROFILED = 50, 1000, 20
LIVE_BULK_HOPS, LIVE_HOLD_HOPS, LIVE_SCAN_HOPS = 60_000, 2000, 1000
LIVE_RING_BLOCK = 32
# the TCP serving server (phase serve_streams): run A, SERVE_A_CLIENTS
# clients of SERVE_SECONDS of 48 kHz f32 PCM over loopback into a
# StreamServer of as many slots at whisper large-v3 (sig, device
# resampling); run B, SERVE_B_CLIENTS clients of 8 kHz s16le at 80 mels
# (rdft, device resampling); each client writes SERVE_WRITE samples at a
# time. Records are held to the serving grid's bars against the CPU's
# float64 (resample_poly -> compute_streaming_mel -> quantizer): frame
# count and indices exact, u8 one step, VA_FLIP_BUDGET flips a fleet. The
# CLIs run by subprocess on their default device, mel_tga and
# stream_asr_segments on CLI_SECONDS of JFK
SERVE_A_CLIENTS, SERVE_B_CLIENTS, SERVE_SECONDS = 256, 64, 3.0
SERVE_HOPS, SERVE_WRITE, CLI_SECONDS = 4, 4096, 4.0


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def signal(rng, b: int, t: int, dev) -> torch.Tensor:
    return torch.from_numpy(
        (rng.normal(size=(b, t)) * 0.2).astype(np.float32)).to(dev)


def k1_grid(t: int, fft: int, hop: int, streaming: bool) -> tuple:
    """``(offset, n_frames)`` of the batch or streaming framing of ``t``
    samples."""
    if streaming:
        return (framing.streaming_frame_offset(fft, hop),
                framing.num_frames_streaming(t, fft, hop))
    return 0, framing.num_frames_batch(t, fft, hop)


def max_abs(a, b) -> float:
    return float((a - b).abs().max()) if a.numel() else 0.0


def held(got, x, head, nf, hop, offset=0) -> dict:
    """A kernel's output for one head (``SigHead``) against the head's
    plain version (f32 dot) and the exact result (float64 dot), on the
    same signal ``x`` framed at ``offset`` into ``nf`` frames."""
    kw = dict(ks=3, n_frames=nf, hop=hop, offset=offset, **head.kw())
    plain = sig_mel.sig_mel_reference(x, head.m_big, head.pair_i, head.mt,
                                      **kw)
    exact = sig_mel.sig_mel_reference(x, head.m_big, head.pair_i, head.mt,
                                      dot_dtype=torch.float64, **kw)
    torch.cuda.synchronize()
    if got.shape != plain.shape:
        raise AssertionError(f"shape {tuple(got.shape)} vs "
                             f"{tuple(plain.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{head.out_mode} output is not finite")
    return dict(mode=head.out_mode, vs_plain=max_abs(got, plain),
                vs_exact=max_abs(got, exact),
                plain_vs_exact=max_abs(plain, exact),
                n_over_tol_kernel=int(((got - exact).abs() > K1_TOL).sum()),
                n_over_tol_plain=int(((plain - exact).abs() > K1_TOL).sum()))


def compare(got, x, fft, hop, n_mels, offset, nf, dev) -> dict:
    """K1's whisper output (bf2, (ks, cutoff) = (3, 2)) held as above."""
    return held(got, x, mel_kernel.whisper_head(fft, n_mels, 16000.0, dev),
                nf, hop, offset)


def tolerances(rows) -> dict:
    """The bars for K1 from the f32 floor of ``rows``."""
    floor = max(r["plain_vs_exact"] for r in rows)
    bar = max(K1_TOL, floor)
    return dict(f32_floor=floor, vs_exact=bar, vs_plain=bar + floor)


def check(rows, bars: dict, what: str) -> None:
    for r in rows:
        for key in ("vs_exact", "vs_plain"):
            if r[key] > bars[key]:
                raise AssertionError(f"{what}: K1 {key} {r[key]} over its "
                                     f"bar {bars[key]}: {r}")


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    precision = torch.get_float32_matmul_precision()
    from torch.utils.cpp_extension import is_ninja_available

    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         float32_matmul_precision=precision, ninja=is_ninja_available())
    if precision != "highest":
        raise RuntimeError(f"float32 matmul precision is {precision!r}; the "
                           "plain yardstick needs 'highest'")
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    built = build.load_all(["sig_mel", "resample", "sig_multi",
                            "framed_ozaki", "load_probe"])
    seconds = time.perf_counter() - t0
    report = {name: [ln.strip() for ln in b.log.splitlines()
                     if ("registers" in ln or "spill" in ln
                         or "Compiling entry" in ln) and "C7519" not in ln]
              for name, b in built.items()}
    sass = tensor_core_sass(["sig_mel", "sig_multi", "framed_ozaki"])
    emit("build", kernels=sorted(built), seconds=round(seconds, 3),
         ptxas=report, ptxas_c7519=ptxas_c7519(built), sass=sass)
    # K1 and K2: the DFT on HGMMA, the bf2 projection on HMMA; K6 on int8
    # (IGMMA or IMMA), K7 on 16-bit floats (HGMMA or HMMA); K5 / K8 on
    # bf16 HGMMA
    need = {"sig_mel": [("HGMMA",), ("HMMA",)],
            "sig_multi": [("HGMMA",), ("HMMA",)],
            "K6": [("IGMMA", "IMMA")], "K7": [("HGMMA", "HMMA")],
            "K5": [("HGMMA_BF16",)], "K8": [("HGMMA_BF16",)]}
    missing = [(name, ops) for name, alts in need.items() for ops in alts
               if not any(sass[name][op]["count"] for op in ops)]
    if missing:
        raise AssertionError(f"no tensor-core instructions: {missing}")


def ptxas_c7519(built) -> dict:
    """Per library and kernel instance, the count of ptxas's C7519 lines
    ("warpgroup.arrive is injected ... to allow use of registers in
    GMMA": the compiler serialized wgmma's around register operands)."""
    out = {}
    for name, b in built.items():
        counts = {}
        for ln in b.log.splitlines():
            if "C7519" not in ln:
                continue
            m = re.search(
                r"in function '[^']*?\d+([a-z_]+_kernel(?:I\w*?E)?)E*vN", ln)
            fn = m.group(1) if m else "?"
            counts[fn] = counts.get(fn, 0) + 1
        out[name] = counts
    return out


def tensor_core_sass(names) -> dict:
    """Per built library, the count of its warpgroup (HGMMA, IGMMA) and
    warp (HMMA, IMMA) tensor-core instructions in ``cuobjdump -sass``,
    with one line of each, and of the HGMMA lines on bf16 operands
    (HGMMA_BF16); ``framed_ozaki`` is split by kernel (K6: the instances
    of scheme 0, K7: scheme 1, K5 and K8: scheme 2, which both launch)."""
    tool = Path(build.find_nvcc()).with_name("cuobjdump")
    ops = ("HGMMA", "HMMA", "IGMMA", "IMMA", "HGMMA_BF16")
    scheme = {"ozaki_kernelILi0E": "K6", "ozaki_kernelILi1E": "K7",
              "ozaki_kernelILi2E": "K5"}
    out = {}
    for name in names:
        sass = subprocess.run([str(tool), "-sass", str(build._target(name))],
                              capture_output=True, text=True, check=True,
                              timeout=300).stdout.splitlines()
        by = {}
        key = name
        for ln in sass:
            if "Function :" in ln and name == "framed_ozaki":
                key = next(k for s, k in scheme.items() if s in ln)
            for op in ops:
                hit = (" HGMMA." in ln and ".BF16" in ln
                       if op == "HGMMA_BF16" else f" {op}." in ln)
                if hit:
                    by.setdefault(key, {}).setdefault(op, []).append(
                        ln.split(";")[0].split("*/")[-1].strip())
        keys = ("K5", "K6", "K7") if name == "framed_ozaki" else (name,)
        for k in keys:
            found = by.get(k, {})
            out[k] = {op: dict(count=len(found.get(op, [])),
                               example=found.get(op, [None])[0])
                      for op in ops}
        if name == "framed_ozaki":
            out["K8"] = out["K5"]
    return out


def phase_k1_vs_plain(dev) -> dict:
    rng = np.random.default_rng(SEED)
    cases = [(1, 30 * 16000), (7, 48123), (64, 10 * 16000 + 37), (3, 399)]
    rows = []
    for fft, hop, n_mels in [(400, 160, 80), (400, 160, 128), (512, 160, 80)]:
        for streaming in (False, True):
            for b, t in cases:
                x = signal(rng, b, t, dev)
                got = whisper_mel_sig(x, fft, hop, n_mels, 16000.0,
                                      streaming=streaming, device=dev)
                errs = compare(got, x, fft, hop, n_mels,
                               *k1_grid(t, fft, hop, streaming), dev)
                rows.append(dict(config=[fft, hop, n_mels],
                                 streaming=streaming, shape=[b, t],
                                 out_shape=list(got.shape), **errs))
    bars = tolerances(rows)
    worst = {k: max(r[k] for r in rows)
             for k in ("vs_plain", "vs_exact", "plain_vs_exact")}
    emit("k1_vs_plain", bars=bars, max_abs_err=worst,
         n_over_tol_k1=sum(r["n_over_tol_kernel"] for r in rows),
         n_over_tol_plain=sum(r["n_over_tol_plain"] for r in rows),
         n_out=sum(int(np.prod(r["out_shape"])) for r in rows), cases=rows)
    check(rows, bars, "phase 3")
    return rows


def phase_gates(dev) -> None:
    jfk = read_wav_f32le(TESTDATA / "jfk_f32le.wav")
    golden = np.load(TESTDATA / "rust_jfk_golden.npy")
    got = whisper_mel_sig(jfk, 512, 160, 80, 16000.0, streaming=True,
                          device=dev).T.cpu().numpy()
    jfk_sig = float(np.abs(got - golden).max())
    synth = np.load(TESTDATA / "synthetic_signal.npy")
    g128 = np.load(TESTDATA / "synthetic_whisper128_golden.npy")
    c = WHISPER_LARGE_V3
    got = whisper_mel_sig(synth, c.fft_size, c.hop_size, c.n_mels,
                          c.sampling_rate, streaming=True,
                          device=dev).T.cpu().numpy()
    s128 = float(np.abs(got - g128).max())
    f64 = {}
    for impl in ("rdft", "fft"):
        got = compute_streaming_mel(jfk, 512, 160, 80, 16000.0,
                                    dtype=torch.float64, fft_impl=impl,
                                    device=dev)
        f64[impl] = float(np.abs(got - golden).max())
    gates = {"jfk_sig": (jfk_sig, 1e-5), "whisper128_sig": (s128, 2e-5),
             "jfk_f64_rdft": (f64["rdft"], 1e-6),
             "jfk_f64_fft": (f64["fft"], 1e-6)}
    emit("gates", **{k: {"max_abs_err": v, "bar": bar}
                     for k, (v, bar) in gates.items()})
    failed = [k for k, (v, bar) in gates.items() if not v <= bar]
    if failed:
        raise AssertionError(f"accuracy gates failed: {failed}")


def library_mel(x, fft, hop, n_mels):
    """The same function composed from library calls: cuFFT STFT, power,
    f32 matmul projection, log10, whisper norm (timed only)."""
    win = torch.as_tensor(hann_periodic(fft), dtype=torch.float32,
                          device=x.device)
    filt = torch.as_tensor(mel_filterbank(16000.0, fft, n_mels)[:, : fft // 2].T,
                           dtype=torch.float32, device=x.device)

    def run():
        spec = torch.stft(x, fft, hop, window=win, center=False,
                          return_complex=True)[:, : fft // 2]
        power = (spec.real ** 2 + spec.imag ** 2).transpose(1, 2)
        lg = torch.log10(torch.clamp_min(power @ filt, 1e-10))
        mx = lg.amax(dim=-1, keepdim=True)
        return (torch.maximum(lg, mx - 8.0) + 4.0) / 4.0

    return run


def phase_main_path(dev, rows) -> dict:
    rng = np.random.default_rng(SEED + 1)
    c = WHISPER_LARGE_V3
    b, seconds = 64, 30.0
    x = signal(rng, b, int(seconds * c.sampling_rate), dev)
    pipe = WhisperMelPipeline(c.fft_size, c.hop_size, c.n_mels,
                              c.sampling_rate, device=dev)
    if pipe.fft_impl != "sig":
        raise AssertionError(f"auto picked {pipe.fft_impl!r} on CUDA")

    sig_mel.launches = 0
    out = pipe.mel_batch(x)  # the main path, once
    torch.cuda.synchronize()
    launches = sig_mel.launches

    nf = framing.num_frames_batch(x.shape[-1], c.fft_size, c.hop_size)
    if tuple(out.shape) != (b, nf, c.n_mels):
        raise AssertionError(f"main path shape {tuple(out.shape)}")
    if not torch.isfinite(out).all():
        raise AssertionError("main path output is not finite")
    if launches < 1:
        raise AssertionError("the main path launched K1 no time")
    errs = compare(out, x, c.fft_size, c.hop_size, c.n_mels, 0, nf, dev)
    bars = tolerances(rows + [errs])
    check([errs], bars, "main path")

    mats = mel_kernel.sig_matrices(c.fft_size, c.n_mels, c.sampling_rate,
                                   3, 2, dev)
    kw = dict(ks=3, n_frames=nf, hop=c.hop_size, offset=0, pack=c.fft_size,
              n_bins_pad=mats.n_bins_pad, n_mels=c.n_mels,
              mel_precision="bf2", live=mats.live)
    pipe_ms = time_ms(lambda: pipe.mel_batch(x))
    k1_ms = time_ms(lambda: sig_mel.sig_mel(x, mats.m_big, mats.pair_i,
                                            mats.mt_bf2, **kw))
    plain_ms = time_ms(lambda: sig_mel.sig_mel_reference(
        x, mats.m_big, mats.pair_i, mats.mt_bf2, **kw))
    lib = library_mel(x, c.fft_size, c.hop_size, c.n_mels)
    lib_ms = time_ms(lib)
    lib_err = float((lib() - out).abs().max())

    frames = b * nf
    head = mel_kernel.whisper_head(c.fft_size, c.n_mels, c.sampling_rate, dev)
    flops = head_work(head, frames)
    layout = k1_layout(head, c.hop_size)
    l2 = dict(block_frames=layout[0], chunk_cols=layout[1],
              **l2_bytes_counted([head], c.hop_size, b, nf, layout))
    nbytes = (x.numel() * 4 + mats.m_big.numel() * 2
              + mats.mt_bf2.numel() * 2 + out.numel() * 4)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    audio_s = b * seconds
    emit("main_path", shape=[b, x.shape[-1]], n_mels=c.n_mels,
         out_shape=list(out.shape), launches=launches,
         max_abs_err=errs, bars=bars, pipeline_ms=pipe_ms, k1_ms=k1_ms,
         frames_per_s=frames / (pipe_ms / 1e3),
         x_real_time=audio_s / (pipe_ms / 1e3), plain_ms=plain_ms,
         library_composition_ms=lib_ms,
         library_composition_max_abs_vs_k1=lib_err,
         flops=flops, bytes=nbytes, bound_ops_ms=t_ops, bound_bytes_ms=t_bytes,
         share_of_bound=max(t_ops, t_bytes) / k1_ms, **l2)

    # the JAX bench's shape, for shape parity: 64 x 10 s at 80 mels
    x80 = signal(rng, 64, 10 * 16000, dev)
    pipe80 = WhisperMelPipeline(400, 160, 80, 16000.0, device=dev)
    ms80 = time_ms(lambda: pipe80.mel_batch(x80))
    nf80 = framing.num_frames_batch(x80.shape[-1], 400, 160)
    emit("main_path_80", shape=[64, x80.shape[-1]], pipeline_ms=ms80,
         frames_per_s=64 * nf80 / (ms80 / 1e3),
         x_real_time=64 * 10.0 / (ms80 / 1e3))
    return dict(launches=launches, errs=errs, ms=k1_ms, plain_ms=plain_ms,
                bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                library_composition_ms=lib_ms, **l2)


def rs_exact(sig, up, down, q):
    """The resampler's float64 result with the unsliced float64 filter."""
    g = torch.as_tensor(_phase_matrix(up, down, 5.0)[0], device=sig.device)
    k = g.shape[0]
    win = sig.double()[:, : (q - 1) * down + k].unfold(-1, k, down)
    return (win @ g).reshape(sig.shape[0], q * up)


def rs_failed(r) -> bool:
    exact_bar = (RS_TOL if r["precision"] == "highest"
                 else RS_BF3_REL * r["scale"])
    return (r["vs_plain"] > RS_TOL or r["vs_exact"] > exact_bar
            or r.get("k4_equal_k3") is False)


def phase_k3_k4_vs_plain(dev) -> list:
    """K3 against its plain version and the float64 result, K4 as
    ``torch.equal`` to K3 over the concat, at ratios 1/3 (48 kHz), 2/1
    (8 kHz) and 1/2 (32 kHz), both precisions, S in {1, 7, 256}, 1-hop and
    50-hop (multi-tile) chunks, with the serving state length L."""
    rng = np.random.default_rng(SEED + 2)
    rows = []
    for up, down in [(1, 3), (2, 1), (1, 2)]:
        hop_src = 160 * down // up
        for precision in ("highest", "bf3"):
            length = MultiStreamResampler(up, down, 1, align=160,
                                          impl="kernel", precision=precision,
                                          device=dev)._len
            g = kres.resample_matrices(up, down, 5.0, precision, dev)
            for s in (1, 7, 256):
                for hops in (1, 50):
                    n = hops * hop_src
                    q = n // down
                    buf = signal(rng, s, length, dev)
                    chunks = signal(rng, s, n, dev)
                    sig = torch.cat([buf, chunks], dim=1)
                    k3 = kres.resample(sig, up, down, q, precision=precision)
                    plain = kres.resample_reference(sig, g, up, down, q,
                                                    precision)
                    exact = rs_exact(sig, up, down, q)
                    torch.cuda.synchronize()
                    row = dict(ratio=[up, down], precision=precision,
                               streams=s, hops=hops, n=n, buf=length,
                               vs_plain=max_abs(k3, plain),
                               vs_exact=max_abs(k3.double(), exact),
                               plain_vs_exact=max_abs(plain.double(), exact),
                               scale=float(exact.abs().max()))
                    if kres.pair_eligible(length, n, up, down,
                                          precision=precision):
                        k4 = kres.resample_pair(buf, chunks, up, down, q,
                                                precision=precision)
                        row["k4_equal_k3"] = bool(torch.equal(k4, k3))
                    rows.append(row)
    n_k4 = sum("k4_equal_k3" in r for r in rows)
    worst = {k: max(r[k] for r in rows)
             for k in ("vs_plain", "vs_exact", "plain_vs_exact")}
    emit("k3_k4_vs_plain", bars=dict(vs_plain=RS_TOL, vs_exact_highest=RS_TOL,
                                     vs_exact_bf3_rel=RS_BF3_REL),
         max_abs_err=worst, n_cases=len(rows), n_k4_cases=n_k4,
         n_k4_equal=sum(r.get("k4_equal_k3", False) for r in rows),
         cases=rows)
    failed = [r for r in rows if rs_failed(r)]
    if failed or not n_k4:
        raise AssertionError(f"K3/K4 failed: {failed or 'no K4 case'}")
    return rows


def tick_device_ms(front, st, x: torch.Tensor, **kw) -> float:
    """Device time of one source-rate tick's work on device-resident
    chunks ``x`` (CUDA events; no host copy, no fetch)."""
    active = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)

    def tick():
        _, y = front.rs.step(st.rs, x, active)
        front.front._tick(st.fe, y, active)

    return time_ms(tick, **kw)


def zero_counts() -> None:
    sig_mel.launches = 0
    sig_mel.epilogue_launches.update(quant=0, vad=0)
    sig_multi.launches = 0
    kres.launches.update(K3=0, K4=0)
    framed_mel.launches.update(dict.fromkeys(framed_mel.launches, 0))
    load_probe.launches.update(dict.fromkeys(load_probe.launches, 0))


def read_counts() -> dict:
    return {"K1": sig_mel.launches, "K2": sig_multi.launches,
            **kres.launches, **framed_mel.launches,
            "K1_quant": sig_mel.epilogue_launches["quant"],
            "K1_vad": sig_mel.epilogue_launches["vad"],
            "P1": sum(load_probe.launches.values())}


def speechlike(rng, s: int, n: int, rate: int) -> np.ndarray:
    """White noise switched between 0.3 and 0.003 every 0.25 s (a random
    phase per stream), so the VAD sees edges and quiet stretches."""
    t = np.arange(n) / rate
    on = ((t[None, :] + rng.random((s, 1)) * 0.5) % 0.5) < 0.25
    x = rng.normal(size=(s, n)) * np.where(on, 0.3, 0.003)
    return x.astype(np.float32)


def check_k1_tick(front, st, x: torch.Tensor, active: torch.Tensor) -> dict:
    """K1 on the serving route at a tick's shapes: the tick's own
    resampler and mel code run again on the state ``st`` the tick started
    from, and K1's mels (offset = hop over ``concat(hop_buf, y)``,
    ``n_frames`` = hops) are held against the plain version and the
    exact result on that concat. These launches are not counted."""
    _, y = front.rs.step(st.rs, x, active)
    mel = front.front.mel
    c = mel.config
    signal = torch.cat([st.fe.mel.hop_buf, y], dim=1)
    got = mel._push_many(st.fe.mel, y, active)[2]
    return compare(got, signal, c.fft_size, c.hop_size, c.n_mels,
                   c.hop_size, y.shape[1] // c.hop_size, x.device)


def drive_fleet(dev, rate, s, fft_impl, ticks, hops, seed, sit_out=None,
                reset_at=None, reset_mask=None) -> dict:
    """Tick a source-rate fleet from ``shared_frontend`` (the path under
    test) beside a plain ``MultiStreamFrontend`` on the same mel route fed
    the same audio resampled on the host side by ``resample_poly`` in
    float64, with the same activity and resets; then hold the frame grid:
    per stream segment the first ``spurious_out / hop`` hops are invalid
    and every later hop's validity, q (within one step) and va (at most
    ``VA_FLIP_BUDGET`` flips) equal the plain frontend's that many hops
    earlier. On the sig route every tick's K1 output is also held against
    K1's plain version (``check_k1_tick``): the plain frontend runs K1
    too, so the grid alone does not witness K1."""
    c = WHISPER_LARGE_V3
    front = shared_frontend(c, s, input_rate=rate, fft_impl=fft_impl,
                            device=dev)
    plain = MultiStreamFrontend(c, s, fft_impl=fft_impl, device=dev)
    up, down, hop = front.rs.up, front.rs.down, c.hop_size
    n, n16 = hops * front.hop_src, hops * hop
    spur = front.rs.spurious_out // hop
    rng = np.random.default_rng(seed)
    n_seg = 1 if reset_at is None else 2
    src = [speechlike(rng, s, ticks * n, rate) for _ in range(n_seg)]
    y16 = [resample_poly(x.astype(np.float64), up, down, device=dev)
           .to(torch.float32).cpu().numpy() for x in src]
    seg, cur = np.zeros(s, int), np.zeros(s, int)
    st, pst = front.init(), plain.init()
    recs, wall, k1_rows = [], [], []
    launches = dict.fromkeys(read_counts(), 0)
    torch.cuda.synchronize()
    for t in range(ticks):
        if t == reset_at:
            st, pst = front.reset(st, reset_mask), plain.reset(pst, reset_mask)
            seg[reset_mask], cur[reset_mask] = 1, 0
        active = np.ones(s, bool)
        if sit_out is not None and t % 2:
            active[sit_out] = False
        chunk = np.zeros((s, n), np.float32)
        pchunk = np.zeros((s, n16), np.float32)
        for i in np.flatnonzero(active):
            chunk[i] = src[seg[i]][i, cur[i] * n : (cur[i] + 1) * n]
            pchunk[i] = y16[seg[i]][i, cur[i] * n16 : (cur[i] + 1) * n16]
        # counts zeroed just before the path's tick and read just after;
        # the plain frontend's and check_k1_tick's launches are not counted
        st0 = st
        zero_counts()
        t0 = time.perf_counter()
        st, q, lo, hi, va, valid = front.push_many(st, chunk, active)
        wall.append((time.perf_counter() - t0) * 1e3)
        for name, v in read_counts().items():
            launches[name] += v
        if fft_impl == "sig":
            k1_rows.append(check_k1_tick(
                front, st0, torch.as_tensor(chunk, device=dev),
                torch.as_tensor(active, device=dev)))
        pst, pq, _, _, pva, pvalid = plain.push_many(pst, pchunk, active)
        recs.append((active, seg.copy(), q, va, valid, pq, pva, pvalid))
        cur[active] += 1

    checked = flips = q_diff = 0
    grid_faults = []
    for i in range(s):
        for g in range(n_seg):
            rows = [r for r in recs if r[0][i] and r[1][i] == g]
            if not rows:
                continue
            gq, gva, gv, pq, pva, pv = (np.concatenate([r[k][i] for r in rows])
                                        for k in range(2, 8))
            m = len(gv)
            if gv[:spur].any() or not np.array_equal(gv[spur:],
                                                     pv[: m - spur]):
                grid_faults.append([i, g])
                continue
            v = gv[spur:]
            q_diff = max(q_diff, int(np.abs(
                gq[spur:][v].astype(int) - pq[: m - spur][v].astype(int)
            ).max(initial=0)))
            flips += int((gva[spur:][v] != pva[: m - spur][v]).sum())
            checked += int(v.sum())

    device_ms = tick_device_ms(front, st, torch.as_tensor(chunk, device=dev))
    wall_med = statistics.median(wall)
    out = dict(rate=rate, streams=s, fft_impl=fft_impl, ticks=ticks,
               hops=hops, ratio=[up, down], buf=front.rs._len,
               resample_precision=front.rs.precision,
               spurious_hops=spur, launches=launches,
               wall_ms_median=wall_med, wall_ms_max=max(wall),
               device_ms=device_ms,
               x_real_time=s * hops * hop / c.sampling_rate / (wall_med / 1e3),
               x_real_time_device=(s * hops * hop / c.sampling_rate
                                   / (device_ms / 1e3)),
               valid_checked=checked, q_max_diff=q_diff, va_flips=flips,
               va_flip_budget=VA_FLIP_BUDGET, grid_faults=grid_faults[:10],
               n_grid_faults=len(grid_faults))
    if k1_rows:
        out["k1_vs_plain"] = {k: max(r[k] for r in k1_rows)
                              for k in ("vs_plain", "vs_exact",
                                        "plain_vs_exact")}
    if (grid_faults or q_diff > 1 or flips > VA_FLIP_BUDGET
            or checked == 0):
        raise AssertionError(f"frame grid: {out}")
    return dict(out, state=st, last_chunk=chunk, k1_rows=k1_rows)


def phase_serving_path(dev, rows) -> tuple:
    """The serving tick at full width: WHISPER_LARGE_V3, 256 streams of 48
    kHz, 4 hops (1,920 source samples) a tick, 50 ticks on rdft then on
    sig; a quarter of the slots sit out alternate ticks and 8 slots are
    reset at tick 25. Then a 1-hop tick (K3), a 64-stream 8 kHz fleet (K4
    upsampling) and calibrate_fft_impl's pick. K1's serving-route rows
    are held to the bars of ``rows`` (phase 3's) and returned with the
    launch counts."""
    s = FLEET
    sit_out = np.arange(s) % 4 == 0
    resets = np.zeros(s, bool)
    resets[1 :: s // 8] = True
    counts, k1_rows = {}, []

    def k1_check(new_rows, what):
        bars = tolerances(rows + k1_rows + new_rows)
        check(new_rows, bars, what)
        k1_rows.extend(new_rows)

    for k, impl in enumerate(("rdft", "sig")):
        r = drive_fleet(dev, 48000, s, impl, FLEET_TICKS, TICK_HOPS,
                        SEED + 10 + k, sit_out, FLEET_TICKS // 2, resets)
        st, chunk, new_rows = (r.pop(k) for k in ("state", "last_chunk",
                                                  "k1_rows"))
        emit(f"serving_48k_{impl}", **r)
        k1_check(new_rows, f"serving 48 kHz {impl}")
        counts[f"48k_{impl}"] = r["launches"]
        if r["launches"]["K4"] < 1 or (impl == "sig"
                                       and r["launches"]["K1"] < 1):
            raise AssertionError(f"serving tick ({impl}) missed a kernel: "
                                 f"{r['launches']}")
    front = shared_frontend(WHISPER_LARGE_V3, s, input_rate=48000,
                            fft_impl="sig", device=dev)
    x1 = chunk[:, :front.hop_src]
    torch.cuda.synchronize()
    zero_counts()
    front.push_many(st, x1)
    counts["48k_1hop"] = read_counts()
    one = check_k1_tick(front, st, torch.as_tensor(x1, device=dev),
                        torch.ones(s, dtype=torch.bool, device=dev))
    emit("serving_48k_1hop", launches=counts["48k_1hop"],
         buf=front.rs._len, n=front.hop_src,
         k1_vs_plain={k: one[k] for k in ("vs_plain", "vs_exact",
                                         "plain_vs_exact")})
    k1_check([one], "serving 1-hop tick")
    if counts["48k_1hop"]["K3"] != 1 or counts["48k_1hop"]["K4"]:
        raise AssertionError(f"1-hop tick: {counts['48k_1hop']}")
    r = drive_fleet(dev, 8000, FLEET_8K, "sig", FLEET_8K_TICKS, TICK_HOPS,
                    SEED + 20)
    r.pop("state"), r.pop("last_chunk")
    new_rows = r.pop("k1_rows")
    emit("serving_8k_sig", **r)
    k1_check(new_rows, "serving 8 kHz sig")
    counts["8k_sig"] = r["launches"]
    if r["launches"]["K4"] < 1 or r["launches"]["K1"] < 1:
        raise AssertionError(f"8 kHz fleet: {r['launches']}")
    pick = calibrate_fft_impl(WHISPER_LARGE_V3, s, hops=TICK_HOPS,
                              input_rate=48000, device=dev)
    emit("calibrate_fft_impl", streams=s, hops=TICK_HOPS, input_rate=48000,
         pick=pick)
    return counts, k1_rows


def phase_serving_profile(dev) -> dict:
    """Where the serving tick's time goes: ``torch.profiler`` over 20
    ticks of the 256-stream 48 kHz fleet per route, device time by kernel
    (and copy) name against the host clock; the rest is the device's
    idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(SEED + 40)
    ticks = 20
    x = speechlike(rng, FLEET, ticks * TICK_HOPS * 480, 48000).reshape(
        FLEET, ticks, -1)
    out = {}
    for impl in ("rdft", "sig"):
        front = shared_frontend(WHISPER_LARGE_V3, FLEET, input_rate=48000,
                                fft_impl=impl, device=dev)
        st = front.push_many(front.init(), x[:, 0])[0]  # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for t in range(1, ticks):
                st = front.push_many(st, x[:, t])[0]
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / (ticks - 1)
        by_name = {}
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            by_name[e.key] = by_name.get(e.key, 0.0) + us / 1e3 / (ticks - 1)
        busy = sum(by_name.values())
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        # K3/K4 by name, whether or not they are in the top 10
        rs_ms = sum(v for k, v in by_name.items() if "resample_kernel" in k)
        out[impl] = dict(wall_ms_per_tick=wall, device_ms_per_tick=busy,
                         idle_share=1.0 - busy / wall if wall else None,
                         n_names=len(by_name),
                         resample_kernel_ms_per_tick=rs_ms,
                         resample_kernel_share=rs_ms / busy if busy else None,
                         top=[[k[:80], v, v / busy if busy else None]
                              for k, v in top])

    emit("serving_profile", streams=FLEET, hops=TICK_HOPS, ticks=ticks - 1,
         **out)
    return out


def rs_tick(dev, kernel, up, down, buf, x, prec) -> dict:
    """``kernel`` (K3 over the concat, or K4) at one serving tick's shape
    (``buf [S, L]``, chunks ``x [S, n]``): its output against the plain
    version, its device time per launch (``ms``) beside one call's
    (``call_ms``, the host path included), the plain version's, the
    ``conv1d`` call's per launch and per call, the bound and the tile."""
    s, n = x.shape
    q = n // down
    sig = torch.cat([buf, x], dim=1)
    g = kres.resample_matrices(up, down, 5.0, prec, dev)
    k = g.shape[-2]
    g32 = torch.as_tensor(_phase_matrix(up, down, 5.0)[0].T[:, None, :],
                          dtype=torch.float32, device=dev)
    lsig = sig[:, None, : (q - 1) * down + k]  # the q windows

    def launch():
        if kernel == "K4":
            return kres.resample_pair(buf, x, up, down, q, precision=prec)
        return kres.resample(sig, up, down, q, precision=prec)

    def library():
        return torch.nn.functional.conv1d(lsig, g32, stride=down)

    def plain():
        return kres.resample_reference(sig, g, up, down, q, prec)

    want = plain()
    err = max_abs(launch(), want)
    lib_err = max_abs(library().transpose(-1, -2).reshape(s, q * up), want)
    nb = ((buf.numel() + x.numel() + s * q * up) * 4
          + g.numel() * g.element_size())
    tb = nb / PEAK_HBM_BYTES * 1e3
    to = 2 * k * s * q * up / PEAK_F32_FLOPS * 1e3
    ms = per_launch_ms(launch)
    geo = kres.launch_tile(up, down, k, prec == "bf3", s, q,
                           x.device.index)
    return dict(
        kernel=kernel, ratio=[up, down], streams=s, shape=[list(buf.shape),
                                                           [s, n]],
        windows=q, vs_plain=err, library_vs_plain=lib_err, ms=ms,
        call_ms=time_ms(launch), plain_ms=time_ms(plain, reps=3, warmup=1),
        library_ms=per_launch_ms(library), library_call_ms=time_ms(library),
        bound_ms=max(tb, to), bound_by="bytes" if tb >= to else "operations",
        share_of_bound=max(tb, to) / ms,
        tile={f: getattr(geo, f) for f in ("threads", "r", "windows",
                                           "items", "grid")})


def phase_bulk(dev, rows) -> dict:
    """One 256 x 500-hop 48 kHz tick per route, then K4, K3 and K1 timed
    at its shapes beside their plain versions, the library call and
    their bounds; K3/K4 in the serving precision ("highest") and in bf3,
    per launch on the device and per call, and K1 on the serving route
    (offset = hop) held against its plain version and the exact result
    to the bars of ``rows``. Then K4 at the 4-hop tick's shape, K3 at the
    1-hop tick's and K4 at the 8 kHz fleet's 4-hop tick (64 streams, up
    2), where the serving paths launch them, each held against its plain
    version and timed as above beside ``conv1d``."""
    c = WHISPER_LARGE_V3
    s, hops, up, down = FLEET, BULK_HOPS, 1, 3
    rng = np.random.default_rng(SEED + 30)
    x = speechlike(rng, s, hops * 480, 48000)
    xdev = torch.as_tensor(x, device=dev)
    ticks = {}
    for impl in ("rdft", "sig"):
        front = shared_frontend(c, s, input_rate=48000, fft_impl=impl,
                                device=dev)
        st = front.init()
        front.push_many(st, x)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        front.push_many(st, x)
        wall = (time.perf_counter() - t0) * 1e3
        dev_ms = tick_device_ms(front, st, xdev, reps=5, warmup=1)
        ticks[impl] = dict(wall_ms=wall, device_ms=dev_ms,
                           x_real_time=s * hops / 100 / (wall / 1e3),
                           x_real_time_device=s * hops / 100 / (dev_ms / 1e3))

    prec = front.rs.precision
    length = front.rs._len
    q = hops * 480 // down
    buf = signal(rng, s, length, dev)
    sig = torch.cat([buf, xdev], dim=1)
    g = kres.resample_matrices(up, down, 5.0, prec, dev)
    k4 = kres.resample_pair(buf, xdev, up, down, q, precision=prec)
    k3 = kres.resample(sig, up, down, q, precision=prec)
    plain = kres.resample_reference(sig, g, up, down, q, prec)
    g32 = torch.as_tensor(_phase_matrix(up, down, 5.0)[0].T[:, None, :],
                          dtype=torch.float32, device=dev)
    lsig = sig[:, None, : (q - 1) * down + g32.shape[-1]]  # the q windows

    def library():
        return torch.nn.functional.conv1d(lsig, g32, stride=down)

    lib = library()[:, 0]
    torch.cuda.synchronize()
    errs = dict(k4_vs_plain=max_abs(k4, plain),
                k4_equal_k3=bool(torch.equal(k4, k3)),
                library_vs_k4=max_abs(lib, k4))
    del plain, lib
    timed = {
        "k4": lambda: kres.resample_pair(buf, xdev, up, down, q,
                                         precision=prec),
        "k4_bf3": lambda: kres.resample_pair(buf, xdev, up, down, q,
                                             precision="bf3"),
        "k3": lambda: kres.resample(sig, up, down, q, precision=prec),
        "k3_bf3": lambda: kres.resample(sig, up, down, q, precision="bf3"),
        "library": library}
    ms = {name: per_launch_ms(fn) for name, fn in timed.items()}
    call_ms = {name: time_ms(fn) for name, fn in timed.items()}
    plain_ms = dict(
        k3=time_ms(lambda: kres.resample_reference(
            sig, g, up, down, q, prec), reps=3, warmup=1),
        k4=time_ms(lambda: kres.resample_reference(
            torch.cat([buf, xdev], dim=1), g, up, down, q, prec),
            reps=3, warmup=1))
    k = g.shape[-2]
    outs = s * q * up
    nbytes = ((buf.numel() + xdev.numel() + outs) * 4
              + g.numel() * g.element_size())
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    t_ops = 2 * k * outs / PEAK_F32_FLOPS * 1e3
    # bf3's products are of bf16 values (the bound's type); the kernel
    # runs them as float32 FMAs, whose own figure is the SIMT one
    t_ops_bf3 = 2 * 3 * k * outs / PEAK_BF16_FLOPS * 1e3
    t_ops_bf3_simt = 2 * 3 * k * outs / PEAK_F32_FLOPS * 1e3
    geo = kres.launch_tile(up, down, k, prec == "bf3", s, q,
                           xdev.device.index)

    # the serving ticks: 4 and 1 hops of the 48 kHz fleet, 4 of the 8 kHz
    rs8 = MultiStreamResampler(2, 1, FLEET_8K, align=c.hop_size,
                               precision=prec, device=dev)
    # (contiguous chunks, as a tick's are: a strided slice would add a
    # copy to every launch)
    tick = {
        "k4_4hop": rs_tick(dev, "K4", up, down, buf,
                           xdev[:, : TICK_HOPS * 480].contiguous(), prec),
        "k3_1hop": rs_tick(dev, "K3", up, down, buf,
                           xdev[:, :480].contiguous(), prec),
        "k4_4hop_8k": rs_tick(
            dev, "K4", 2, 1, signal(rng, FLEET_8K, rs8._len, dev),
            signal(rng, FLEET_8K, TICK_HOPS * 80, dev), prec)}
    errs["tick_vs_plain"] = max(v["vs_plain"] for v in tick.values())

    # K1 at the serving tick's bulk shape: offset = hop over the concat
    mats = mel_kernel.sig_matrices(c.fft_size, c.n_mels, c.sampling_rate,
                                   3, 2, dev)
    mel_sig = torch.cat([torch.zeros(s, c.fft_size, device=dev),
                         k4[:, : hops * c.hop_size]], dim=1)

    def k1():
        return sig_mel.sig_mel(
            mel_sig, mats.m_big, mats.pair_i, mats.mt_bf2, ks=3,
            n_frames=hops, hop=c.hop_size, offset=c.hop_size,
            pack=c.fft_size, n_bins_pad=mats.n_bins_pad, n_mels=c.n_mels,
            live=mats.live)

    k1_errs = compare(k1(), mel_sig, c.fft_size, c.hop_size, c.n_mels,
                      c.hop_size, hops, dev)
    k1_ms = time_ms(k1, reps=5, warmup=1)
    out = dict(streams=s, hops=hops, ticks=ticks, precision=prec,
               shape_buf=[s, length], shape_chunks=list(xdev.shape),
               windows=q, errs=errs, ms=ms, call_ms=call_ms,
               plain_ms=plain_ms, bytes=nbytes, bound_bytes_ms=t_bytes,
               bound_ops_ms=t_ops, bound_ops_bf3_ms=t_ops_bf3,
               bound_ops_bf3_simt_ms=t_ops_bf3_simt,
               share_of_bound={n: max(t_bytes, t_ops) / ms[n]
                               for n in ("k3", "k4")},
               share_of_bound_bf3={n: max(t_bytes, t_ops_bf3) / ms[f"{n}_bf3"]
                                   for n in ("k3", "k4")},
               tile=geo._asdict(), k1_serving_ms=k1_ms,
               k1_serving_errs=k1_errs, tick=tick)
    emit("bulk_48k", **out)
    if (not errs["k4_equal_k3"]
            or max(errs["k4_vs_plain"], errs["tick_vs_plain"]) > RS_TOL):
        raise AssertionError(f"bulk tick: {errs}")
    check([k1_errs], tolerances(rows + [k1_errs]), "bulk tick K1")
    return dict(out, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def ln_bars(rows) -> dict:
    floor = max(r["plain_vs_exact"] for r in rows)
    bar = max(LN_TOL, floor)
    return dict(f32_floor=floor, vs_exact=bar, vs_plain=bar + floor)


def head_work(head, frames: int) -> int:
    """FLOPs of one head over ``frames`` frames, the function's work, not
    the layout's: the slice-pair blocks' taps against the DFT columns that
    are not identically zero, the power's re + im add of each bin that has
    an im column, then the projection's products (three per (bin, mel) in
    bf2) over the bins. Split columns: the bins are the nonzero re
    columns (the zero pad columns are not counted). N-packed: n_bins re
    columns, then n_bins - 2 im columns (no DC, no Nyquist); the second
    copy of a filter row that lets the add ride the projection is not
    counted."""
    nz = (head.m_big != 0).any(dim=0)
    dft_cols = int(nz.sum())
    bins = (int(nz[: head.n_bins_pad].sum()) if head.n_bins_pad
            else (dft_cols + 2) // 2)
    per = 3 if head.mel_precision == "bf2" else 1
    return frames * (2 * len(head.pair_i) * head.pack * dft_cols
                     + (dft_cols - bins) + 2 * per * bins * head.n_mels)


def bound(flops: int, nbytes: int) -> dict:
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return dict(flops=flops, bytes=nbytes, bound_ops_ms=t_ops,
                bound_bytes_ms=t_bytes, bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def head_bytes(heads, x, outs) -> int:
    return (x.numel() * 4 + sum(o.numel() * o.element_size() for o in outs)
            + sum(h.m_big.numel() * 2 + h.mt.numel() * h.mt.element_size()
                  for h in heads))


def l2_bytes_counted(heads, hop: int, batch: int, n_frames: int,
                     layout: tuple) -> dict:
    """The bytes one launch of K1 (one head) or K2 (several) requests
    from L2, counted from the kernels' loads (csrc/sig_common.cuh), not
    measured: per block of ``layout = (frames, chunk columns)``, its
    signal span (float32) and, per head, every live DFT column of every K
    block's taps (bf16; zero-filled rows and dead columns are not read)
    and the projection rows of each column chunk's live power columns
    (three bf16 stacks, or one float32 matrix)."""
    frames, cols = layout
    blocks = batch * -(-n_frames // frames)
    span = max((frames - 1) * hop + h.pack_off + -(-h.pack // 32) * 32
               for h in heads)
    per_block = span * 4
    for h in heads:
        split = h.n_bins_pad != 0
        cp = cols // 2 if split else cols
        per_block += len(h.pair_i) * h.pack * h.live * (2 if split else 1) * 2
        nmp = h.mt.shape[1]
        for c0 in range(0, h.live, cp):
            k = min(cp, h.live - c0)
            per_block += (3 * -(-k // 16) * 16 * nmp * 2
                          if h.mel_precision == "bf2" else k * nmp * 4)
    return dict(blocks=blocks, l2_bytes_counted_per_block=per_block,
                l2_bytes_counted=blocks * per_block)


def k1_layout(head, hop: int, ks: int = 3) -> tuple:
    """``(frames per block, DFT columns per chunk)`` of K1's layout for
    ``head`` (asks the kernel)."""
    width = head.m_big.shape[1]
    npow = width if head.n_bins_pad == 0 else head.n_bins_pad
    return sig_mel.block_layout(ks, hop, head.pack, head.pack_off, width,
                                npow, head.mt.shape[1])[1:]


def k2_layout(heads, hop: int, ks: int = 3) -> tuple:
    """As ``k1_layout``, for K2's heads."""
    layout = sig_multi.block_layout(ks, hop, *sig_multi._layout(heads))
    return layout[1], layout[3]


def library_nemo(x, cfg):
    """NeMo log-mel from library calls: cuFFT STFT (center, zero pad),
    power, f32 matmul projection, ln(e + guard) (timed only)."""
    win = torch.as_tensor(hann_centered(cfg.n_fft, cfg.win_length),
                          dtype=torch.float32, device=x.device)
    filt = torch.as_tensor(batch_logmel.nemo_filters(cfg).T,
                           dtype=torch.float32, device=x.device)

    def run():
        spec = torch.stft(x, cfg.n_fft, cfg.hop_length, window=win,
                          center=True, pad_mode="constant",
                          return_complex=True)
        power = (spec.real ** 2 + spec.imag ** 2).transpose(1, 2)
        return torch.log(power @ filt + cfg.log_zero_guard)

    return run


def library_kaldi(x, cfg):
    """Kaldi fbank from library calls: frames, DC removal, in-frame
    preemphasis (the cross-frame term meets the Povey window's zero),
    window, cuFFT rfft at fft_size, power, f32 matmul, ln(max(e, eps))
    (timed only)."""
    n, fft = cfg.frame_length_samples, cfg.fft_size
    win = torch.as_tensor(povey(n), dtype=torch.float32, device=x.device)
    filt = torch.as_tensor(kaldi_filterbank(cfg.sample_rate, fft,
                                            cfg.num_mel_bins).T,
                           dtype=torch.float32, device=x.device)

    def run():
        fr = x.unfold(-1, n, cfg.frame_shift_samples)
        d = fr - fr.mean(dim=-1, keepdim=True)
        y = torch.cat([d[..., :1], d[..., 1:] - 0.97 * d[..., :-1]], dim=-1)
        spec = torch.fft.rfft(y * win, n=fft)
        power = spec.real ** 2 + spec.imag ** 2
        return torch.log(torch.clamp_min(power @ filt, 1.1920929e-07))

    return run


def phase_k1_ln_modes(dev) -> dict:
    """K1's new modes against its plain version and the exact result:
    Kaldi (ln_floor, N-packed, DC + preemphasis fold) and NeMo (ln_guard,
    N-packed, 400 taps at pack_off 56 of the centered frame) at B up to
    64 and ragged T; the JFK Kaldi gate through K1; K1's times at 64 x 30
    s in both modes beside their plain versions, library compositions and
    bounds."""
    rng = np.random.default_rng(SEED + 50)
    kcfg, ncfg = FbankConfig(apply_cmn=False), BatchLogMelConfig()
    kaldi = Fbank(kcfg, fft_impl="sig", device=dev)
    nemo = BatchLogMel(ncfg, device=dev)
    if nemo.fft_impl != "sig":
        raise AssertionError(f"BatchLogMel auto picked {nemo.fft_impl!r}")
    pad = ncfg.n_fft // 2
    rows = []
    for b, t in [(STEP_B, CHECK_T), (7, 48123), (3, 399)]:
        x = signal(rng, b, t, dev)
        got = kaldi.compute(x)
        rows.append(dict(shape=[b, t], **held(
            got, x, kaldi.sig_head, kaldi.num_frames(t), kaldi.frame_shift)))
        got = nemo.compute(x).transpose(-1, -2)
        rows.append(dict(shape=[b, t], **held(
            got, torch.nn.functional.pad(x, (pad, pad)), nemo.sig_head,
            nemo.num_frames(t), ncfg.hop_length)))
    bars = ln_bars(rows)
    failed = [r for r in rows if r["vs_exact"] > bars["vs_exact"]
              or r["vs_plain"] > bars["vs_plain"]]

    jfk = read_wav_f32le(TESTDATA / "jfk_f32le.wav")
    with np.load(TESTDATA / "kaldi_native_fbank_jfk.npz") as npz:
        golden = torch.from_numpy(npz["features"].T.copy()).to(dev)
    jfk_k1 = max_abs(Fbank(FbankConfig(), fft_impl="sig",
                           device=dev).compute(jfk), golden)

    times = {}
    x = signal(rng, STEP_B, int(STEP_SECONDS * 16000), dev)
    xp = torch.nn.functional.pad(x, (pad, pad))
    for name, front, sig, nf, lib in (
            ("ln_guard_nemo", nemo, xp, nemo.num_frames(x.shape[-1]),
             library_nemo(x, ncfg)),
            ("ln_floor_kaldi", kaldi, x, kaldi.num_frames(x.shape[-1]),
             library_kaldi(x, kcfg))):
        h = front.sig_head
        kw = dict(ks=3, n_frames=nf, hop=160, offset=0, **h.kw())
        out = sig_mel.sig_mel(sig, h.m_big, h.pair_i, h.mt, **kw)
        times[name] = dict(
            shape=list(sig.shape), frames=STEP_B * nf,
            ms=time_ms(lambda: sig_mel.sig_mel(sig, h.m_big, h.pair_i, h.mt,
                                               **kw)),
            plain_ms=time_ms(lambda: sig_mel.sig_mel_reference(
                sig, h.m_big, h.pair_i, h.mt, **kw), reps=3, warmup=1),
            library_composition_ms=time_ms(lib),
            **bound(head_work(h, STEP_B * nf), head_bytes([h], sig, [out])))
    emit("k1_ln_modes", bars=bars, jfk_kaldi_k1=jfk_k1,
         jfk_gate=KALDI_JFK_GATE,
         max_abs_err={k: max(r[k] for r in rows)
                      for k in ("vs_plain", "vs_exact", "plain_vs_exact")},
         times=times, cases=rows)
    if failed or not jfk_k1 <= KALDI_JFK_GATE:
        raise AssertionError(f"K1 ln modes: {failed}, JFK {jfk_k1}")
    return dict(rows=rows, times=times)


def phase_k1_widths(dev, rows, ln_rows) -> dict:
    """K1 on the heads that are not 512 columns wide, at ``WIDTH_B``
    ragged clips of 10 s at each config's rate, through the entry points
    (``whisper_mel_sig`` batch and streaming, ``Fbank`` / ``BatchLogMel``
    on their sig route): whisper 200/80 at 8 kHz, 256/96, 1024/256 at
    22.05 kHz and 960/480 at 48 kHz, Kaldi fbank and NeMo log-mel at 8
    kHz, each against its plain version and the exact result at K1's bars
    (whisper) or the ln bars, where ``k1_accepts`` holds; a refused config
    is listed with its shared-memory figure. The JFK clip through each
    whisper config against its float64 route. Then K2 on the 8 kHz
    whisper + Kaldi pair, both heads ``torch.equal`` to K1 and the VAD
    counts to ``tile_vad_counts`` of head 0."""
    rng = np.random.default_rng(SEED + 55)
    jfk = read_wav_f32le(TESTDATA / "jfk_f32le.wav")
    cases, w_rows, l_rows, refused = [], [], [], {}
    for name, fft, hop, n_mels, sr in WIDTH_CONFIGS:
        head = mel_kernel.whisper_head(fft, n_mels, sr, dev)
        width = head.m_big.shape[1]
        layout = sig_mel.block_layout(3, hop, fft, 0, width,
                                      head.n_bins_pad, head.mt.shape[1])
        if not sig_mel.k1_accepts(head, hop=hop):
            refused[name] = dict(width=width, smem_bytes=layout[0],
                                 limit=sig_mel.MAX_SMEM_BYTES)
            continue
        t = int(10 * sr) + 37
        x = signal(rng, WIDTH_B, t, dev)
        for streaming in (False, True):
            got = whisper_mel_sig(x, fft, hop, n_mels, sr,
                                  streaming=streaming, device=dev)
            r = dict(name=name, width=width, block_frames=layout[1],
                     streaming=streaming, shape=[WIDTH_B, t],
                     **held(got, x, head, got.shape[1], hop,
                            k1_grid(t, fft, hop, streaming)[0]))
            cases.append(r)
            w_rows.append(r)
        f64 = WhisperMelPipeline(fft, hop, n_mels, sr, dtype=torch.float64,
                                 fft_impl="rdft", device=dev)
        xj = torch.as_tensor(jfk, device=dev)[None]
        cases[-1]["jfk_vs_f64"] = max_abs(
            whisper_mel_sig(xj, fft, hop, n_mels, sr, device=dev).double(),
            f64.mel_batch(xj.double()))
    for name, front in (
            ("kaldi_8k", Fbank(FbankConfig(sample_rate=8000.0,
                                           apply_cmn=False),
                               fft_impl="sig", device=dev)),
            ("nemo_8k", BatchLogMel(NEMO_8K, fft_impl="sig", device=dev))):
        h = front.sig_head
        t = 10 * 8000 + 37
        x = signal(rng, WIDTH_B, t, dev)
        nemo = name == "nemo_8k"
        got = front.compute(x)
        if nemo:
            got = got.transpose(-1, -2)
            x = torch.nn.functional.pad(x, (NEMO_8K.n_fft // 2,) * 2)
        r = dict(name=name, width=h.m_big.shape[1],
                 block_frames=k1_layout(h, 80)[0], shape=[WIDTH_B, t],
                 **held(got, x, h, front.num_frames(t), 80))
        cases.append(r)
        l_rows.append(r)
    wbars = tolerances(rows + w_rows)
    lbars = ln_bars(ln_rows + l_rows)

    # K2 on the 8 kHz pair against K1, bit for bit
    mc8 = MelConfig(200, 80, 80, 8000.0)
    kc8 = FbankConfig(sample_rate=8000.0, apply_cmn=False)
    fused = WhisperKaldiFused(mc8, kc8, device=dev)
    x = signal(rng, WIDTH_B, 10 * 8000 + 37, dev)
    nf = framing.num_frames_batch(x.shape[-1], 200, 80)
    vad = sig_mel.vad_args(DetectionSettings(), 80)
    outs, counts = sig_multi.sig_multi(x, fused.heads, ks=3, n_frames=nf,
                                       hop=80, vad=vad)
    k2 = dict(
        heads="whisper_kaldi_8k", block_frames=k2_layout(fused.heads, 80)[0],
        head0_equal_k1=bool(torch.equal(
            outs[0], whisper_mel_sig(x, 200, 80, 80, 8000.0, device=dev))),
        kaldi_equal_k1=bool(torch.equal(
            outs[1], Fbank(kc8, fft_impl="sig", device=dev).compute(x))),
        counts_equal=bool(torch.equal(
            counts, sig_mel.tile_vad_counts(outs[0], *vad))))
    emit("k1_widths", whisper_bars=wbars, ln_bars=lbars, refused=refused,
         k2_8k=k2, cases=cases)
    bad = [r["name"] for r in w_rows
           if r["vs_exact"] > wbars["vs_exact"]
           or r["vs_plain"] > wbars["vs_plain"]
           or r.get("jfk_vs_f64", 0.0) > K1_TOL]
    bad += [r["name"] for r in l_rows if r["vs_exact"] > lbars["vs_exact"]
            or r["vs_plain"] > lbars["vs_plain"]]
    bad += [n for n in WIDTH_MUST_ACCEPT if n in refused]
    if bad or not all(v for k, v in k2.items() if k.endswith("equal_k1")
                      or k == "counts_equal"):
        raise AssertionError(f"K1 widths: {bad}, K2 8 kHz {k2}")
    return dict(rows=w_rows, ln_rows=l_rows, refused=refused, k2=k2)


def phase_k2(dev, rows, ln_rows) -> dict:
    """K2 with two heads (whisper 80 and 128 mels + Kaldi) and three
    (+ NeMo) at 64 x 10 s (ragged, 16 tiles): whisper head 0 and the
    Kaldi head torch.equal to K1 on the same matrices (same device code
    and sum order), every head against the plain version and the exact
    result, the NeMo head within LN_TOL of a float64 BatchLogMel rdft,
    the VAD counts equal to tile_vad_counts of head 0 and the raw
    activity equal to classify_columns; the JFK Kaldi gate through K2."""
    rng = np.random.default_rng(SEED + 60)
    settings = DetectionSettings()
    b, t = STEP_B, CHECK_T
    x = signal(rng, b, t, dev)
    kaldi = Fbank(FbankConfig(apply_cmn=False), fft_impl="sig", device=dev)
    k1_kaldi = kaldi.compute(x)
    f64_nemo = BatchLogMel(dtype=torch.float64, fft_impl="rdft",
                           device=dev).compute(x.double())
    whisper_rows, head_rows, cases = [], [], []
    for name, front in (
            ("pair80", WhisperKaldiFused(device=dev)),
            ("pair128", WhisperKaldiFused(WHISPER_LARGE_V3, device=dev)),
            ("tri", WhisperKaldiNemoFused(device=dev))):
        tri = name == "tri"
        mc = front.mel_config
        xin = torch.nn.functional.pad(x, (front._nemo_pad, 0)) if tri else x
        nf = (framing.num_frames_centered(t, 160) if tri
              else framing.num_frames_batch(t, 400, 160))
        f_w = framing.num_frames_batch(t, 400, 160)
        vad = sig_mel.vad_args(settings, mc.n_mels)
        outs, counts = sig_multi.sig_multi(xin, front.heads, ks=3,
                                           n_frames=nf, hop=160, vad=vad)
        k1_mel = whisper_mel_sig(x, 400, 160, mc.n_mels, device=dev)
        case = dict(
            heads=name, shape=[b, t], frames=nf, tiles=-(-nf // 64),
            head0_equal_k1=bool(torch.equal(outs[0][:, :f_w], k1_mel)),
            kaldi_equal_k1=bool(torch.equal(outs[1][:, :f_w], k1_kaldi)),
            counts_equal=bool(torch.equal(
                counts, sig_mel.tile_vad_counts(outs[0], *vad))))
        for h, head in enumerate(front.heads):
            r = held(outs[h], xin, head, nf, 160)
            (whisper_rows if h == 0 else head_rows).append(r)
            case[f"head{h}"] = r
        res = front.compute_with_vad(x, settings)
        mel, raw = res[0], res[-1]
        case["raw_equal_classify"] = bool(torch.equal(
            raw, classify_columns(mel.transpose(-1, -2), settings)))
        case["raw_active_share"] = float(raw.float().mean())
        if tri:
            case["nemo_vs_f64"] = max_abs(res[2].double(), f64_nemo)
        cases.append(case)
    wbars = tolerances(rows + whisper_rows)
    lbars = ln_bars(ln_rows + head_rows)
    jfk = read_wav_f32le(TESTDATA / "jfk_f32le.wav")
    with np.load(TESTDATA / "kaldi_native_fbank_jfk.npz") as npz:
        golden = torch.from_numpy(npz["features"].T.copy()).to(dev)
    jfk_k2 = max_abs(WhisperKaldiFused(device=dev).compute(jfk)[1][0],
                     golden)
    emit("k2_vs_plain", whisper_bars=wbars, ln_bars=lbars,
         jfk_kaldi_k2=jfk_k2, jfk_gate=KALDI_JFK_GATE, cases=cases)
    check(whisper_rows, wbars, "K2 whisper head")
    bad = [c["heads"] for c in cases
           if not (c["head0_equal_k1"] and c["kaldi_equal_k1"]
                   and c["counts_equal"] and c["raw_equal_classify"])
           or c.get("nemo_vs_f64", 0.0) > LN_TOL]
    bad += [r for r in head_rows if r["vs_exact"] > lbars["vs_exact"]
            or r["vs_plain"] > lbars["vs_plain"]]
    if bad or not jfk_k2 <= KALDI_JFK_GATE:
        raise AssertionError(f"K2: {bad}, JFK {jfk_k2}")
    return dict(rows=whisper_rows, ln_rows=head_rows, wbars=wbars,
                lbars=lbars,
                max_abs_err=max(r["vs_plain"] for r in whisper_rows
                                + head_rows))


@contextlib.contextmanager
def plain_kernels(dot_dtype: torch.dtype = torch.float32):
    """Inside the block, the frontends call the plain versions of K1 and
    K2 and of K3 / K4 (on the concat) on CUDA tensors in place of the
    kernels, their dots summed in ``dot_dtype`` (float64: the exact
    result): K1 where NeMo (``batch_logmel``), the whisper pipeline
    (``mel_kernel``) and the stream mel (``multistream``) call it."""
    def k2(samples, heads, **kw):
        return sig_multi.sig_multi_reference(samples, heads,
                                             dot_dtype=dot_dtype, **kw)

    def k1(samples, m_big, pair_i, mt, **kw):
        return sig_mel.sig_mel_reference(samples, m_big, pair_i, mt,
                                         dot_dtype=dot_dtype, **kw)

    def k3_k4(name, a, b, g, g_host, up, down, q, precision):
        sig = a if b is None else torch.cat([a, b], dim=1)
        return kres.resample_reference(sig, g, up, down, q, precision,
                                       dot_dtype)

    with mock.patch.object(sig_multi, "sig_multi", k2), \
            mock.patch.object(batch_logmel, "sig_mel", k1), \
            mock.patch.object(mel_kernel, "sig_mel", k1), \
            mock.patch.object(multistream, "sig_mel", k1), \
            mock.patch.object(kres, "_launch", k3_k4):
        yield


def step_errs(res: dict, ref: dict, flips: int | None = None) -> dict:
    """A step's outputs (or a rank's block of them) against the same step
    on the plain versions: the largest differences, the VAD flips and the
    aggregates. ``flips`` is the whole batch's count of flips where
    ``res`` is one rank's block (the aggregates are the group's)."""
    block_flips = int((res["vad_smoothed"] != ref["vad_smoothed"]).sum())
    return dict(
        mel=max_abs(res["mel"], ref["mel"]),
        nemo=max_abs(res["nemo"], ref["nemo"]),
        fbank=max_abs(res["fbank"], ref["fbank"]),
        vad_flips=block_flips if flips is None else flips,
        block_flips=block_flips,
        active_diff=abs(int(res["vad_active_columns"])
                        - int(ref["vad_active_columns"])),
        total_equal=int(res["vad_total_columns"])
        == int(ref["vad_total_columns"]),
        q8_max_step=int((res["mel_q8"].int() - ref["mel_q8"].int())
                        .abs().max()),
        range=max_abs(res["mel_q8_range"], ref["mel_q8_range"]))


def step_errs_failed(errs: dict, wbar: float, lbar: float) -> bool:
    """The frontend step's bars against its plain version: whisper mel and
    the u8 range at K1's vs-plain bar ``wbar``, NeMo and Kaldi at the ln
    heads' ``lbar``, at most VA_FLIP_BUDGET flips (the active count off by
    no more), the total equal, q within one step."""
    return (errs["mel"] > wbar or max(errs["nemo"], errs["fbank"]) > lbar
            or errs["vad_flips"] > VA_FLIP_BUDGET
            or errs["block_flips"] > errs["vad_flips"]
            or errs["active_diff"] > errs["vad_flips"]
            or not errs["total_equal"] or errs["q8_max_step"] > 1
            or errs["range"] > wbar)


def plain_block(plain: dict, rows) -> dict:
    """One rank's rows of the one-rank plain step's outputs, the u8
    record quantized over those rows (as the rank quantizes its block)
    and the whole batch's aggregates."""
    block = {k: plain[k][rows] for k in ("mel", "nemo", "fbank",
                                         "vad_smoothed")}
    q, lo, hi = quantize_tensor(block["mel"])
    return dict(block, mel_q8=q, mel_q8_range=torch.stack([lo, hi])[None],
                vad_active_columns=plain["vad_active_columns"],
                vad_total_columns=plain["vad_total_columns"])


def library_multi(x, mc, kcfg, settings):
    """K2's function from library calls: the whisper composition, the
    Kaldi composition and classify_columns on the mel (timed only)."""
    mel = library_mel(x, mc.fft_size, mc.hop_size, mc.n_mels)
    kal = library_kaldi(x, kcfg)

    def run():
        m = mel()
        return m, kal(), classify_columns(m.transpose(-1, -2), settings)

    return run


def step_profile(step, x, calls: int = 3) -> dict:
    """Device busy time by kernel name under torch.profiler over
    ``calls`` step calls, against the host clock; the rest is the
    device's idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            step(x)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / calls
    by_name = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        by_name[e.key] = by_name.get(e.key, 0.0) + us / 1e3 / calls
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return dict(wall_ms_per_call=wall, device_ms_per_call=busy,
                idle_share=1.0 - busy / wall if wall else None,
                top=[[k[:80], v, v / busy if busy else None]
                     for k, v in top])


def phase_frontend_step(dev, k2: dict) -> dict:
    """The composite frontend step at full width through
    ``sharded_frontend_step``: 64 x 30 s at whisper large-v3 + Kaldi +
    NeMo defaults, then 64 x 10 s at the JAX defaults. Counts zeroed just
    before one call and read just after (K2 = 1, K1 = 1); every output
    held against the same step on the plain versions; median device time
    of 7 calls after 2 warm-ups (CUDA events), x real time, the idle
    share under torch.profiler; then K2 timed alone at the 30 s step's
    shape beside its plain version, the library composition and its
    bound."""
    rng = np.random.default_rng(SEED + 70)
    settings = DetectionSettings()
    out, counts = {}, {}
    for name, mc, seconds in (
            ("large_v3_30s", WHISPER_LARGE_V3, STEP_SECONDS),
            ("jax_defaults_10s", MelConfig(), STEP80_SECONDS)):
        step = sharded_frontend_step(settings=settings, mel_config=mc,
                                     device=dev)
        x = signal(rng, STEP_B, int(seconds * 16000), dev)
        torch.cuda.synchronize()
        zero_counts()
        res = step(x)  # the path, once
        torch.cuda.synchronize()
        c = read_counts()
        with plain_kernels():
            ref = step(x)
        torch.cuda.synchronize()
        nf = framing.num_frames_batch(x.shape[-1], 400, 160)
        shapes = {k: list(v.shape) for k, v in res.items()}
        want = {"mel": [STEP_B, nf, mc.n_mels],
                "nemo": [STEP_B, 80, x.shape[-1] // 160 + 1],
                "fbank": [STEP_B, nf, 80], "vad_smoothed": [STEP_B, nf - 2],
                "mel_q8": [STEP_B, nf, mc.n_mels], "mel_q8_range": [1, 2],
                "vad_active_columns": [], "vad_total_columns": []}
        errs = step_errs(res, ref)
        finite = all(bool(torch.isfinite(res[k]).all())
                     for k in ("mel", "nemo", "fbank"))
        ms = time_ms(lambda: step(x))
        prof = step_profile(step, x)
        out[name] = dict(shape=list(x.shape), n_mels=mc.n_mels,
                         launches=c, errs=errs, ms=ms,
                         x_real_time=STEP_B * seconds / (ms / 1e3),
                         profile=prof, active_share=float(
                             res["vad_smoothed"].float().mean()))
        counts[name] = c
        emit(f"frontend_step_{name}", **out[name])
        fails = []
        if c["K1"] != 1 or c["K2"] != 1:
            fails.append(f"launches {c}")
        if shapes != want:
            fails.append(f"shapes {shapes}")
        if not finite or step_errs_failed(errs, k2["wbars"]["vs_plain"],
                                          k2["lbars"]["vs_plain"]):
            fails.append(f"outputs {errs} finite={finite}")
        if fails:
            raise AssertionError(f"frontend step {name}: {fails}")

    # K2 alone at the 30 s step's shape: whisper large-v3 + Kaldi + VAD
    fused = WhisperKaldiFused(WHISPER_LARGE_V3, device=dev)
    x = signal(rng, STEP_B, int(STEP_SECONDS * 16000), dev)
    nf = framing.num_frames_batch(x.shape[-1], 400, 160)
    vad = sig_mel.vad_args(settings, WHISPER_LARGE_V3.n_mels)
    kw = dict(ks=3, n_frames=nf, hop=160, vad=vad)
    outs, cnt = sig_multi.sig_multi(x, fused.heads, **kw)
    flops = sum(head_work(h, STEP_B * nf) for h in fused.heads)
    layout = k2_layout(fused.heads, 160)
    lib = library_multi(x, WHISPER_LARGE_V3, FbankConfig(apply_cmn=False),
                        settings)
    k2_times = dict(
        shape=list(x.shape), frames=STEP_B * nf,
        ms=time_ms(lambda: sig_multi.sig_multi(x, fused.heads, **kw)),
        plain_ms=time_ms(lambda: sig_multi.sig_multi_reference(
            x, fused.heads, **kw), reps=3, warmup=1),
        library_composition_ms=time_ms(lib),
        **bound(flops, head_bytes(fused.heads, x, list(outs) + [cnt])),
        **dict(zip(("block_frames", "chunk_cols"), layout)),
        **l2_bytes_counted(fused.heads, 160, STEP_B, nf, layout))
    k2_times["share_of_bound"] = k2_times["bound_ms"] / k2_times["ms"]
    emit("k2_times", **k2_times)
    return dict(counts=counts, k2_times=k2_times, steps=out)


def framed_mats(impl: str, fft: int, n_mels: int, sr: float, dev):
    ks, cutoff = mel_kernel.pallas_schedule(impl)
    return mel_kernel.framed_matrices(impl, fft, n_mels, sr, ks, cutoff, dev)


def framed_held(got, fr, mats, n_mels: int) -> dict:
    """A framed kernel's output ``[B, n_frames, n_mels]`` against its plain
    version (f32 dot) and the exact result (float64 dot) on the same
    frames ``fr`` (``mel_kernel.framed_input``'s, padded rows dropped)."""
    rows = got.numel() // n_mels
    plain, exact = (framed_mel.framed_mel_reference(
        fr, mats, n_mels=n_mels, dot_dtype=dt)[:rows].reshape(got.shape)
        for dt in (torch.float32, torch.float64))
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{mats.impl} output is not finite")
    return dict(impl=mats.impl, vs_plain=max_abs(got, plain),
                vs_exact=max_abs(got, exact),
                plain_vs_exact=max_abs(plain, exact))


def framed_bars(rows) -> dict:
    """Each scheme's bars from the f32 floor of its ``rows``."""
    bars = {}
    for impl in framed_mel.IMPLS:
        floor = max(r["plain_vs_exact"] for r in rows if r["impl"] == impl)
        if impl in ("hp8", "hp_bf16"):
            bars[impl] = dict(f32_floor=floor, vs_exact=OZAKI_TOL,
                              vs_plain=OZAKI_TOL)
        else:
            bar = max(K1_TOL, floor)
            bars[impl] = dict(f32_floor=floor, vs_exact=bar,
                              vs_plain=bar + floor)
    return bars


def framed_check(rows, bars, what: str) -> None:
    for r in rows:
        b = bars[r["impl"]]
        if r["vs_exact"] > b["vs_exact"] or r["vs_plain"] > b["vs_plain"]:
            raise AssertionError(f"{what}: {r} over its bars {b}")
        if r["impl"] in ("hp8", "hp_bf16") and r["plain_vs_exact"]:
            raise AssertionError(f"{what}: the Ozaki plain version's f32 "
                                 f"and float64 dots differ: {r}")


def phase_framed_vs_plain(dev) -> list:
    """K5-K8 through ``whisper_mel_pallas`` against their plain versions
    (f32 and float64 dots) on 64 ragged 10 s clips at 400/160/128, 8
    clips at 1024/256/80/22050 (planes of 512 bins: four chunks) and 8 at
    960/480/40/48000 (the auto route's K5 where K1 refuses the head; 32
    frames a block), both framings; then the JFK gates through the
    kernels. These launches are not counted."""
    rng = np.random.default_rng(SEED + 80)
    rows = []
    for b, t, fft, hop, n_mels, sr in [
            (FRAMED_B, CHECK_T, 400, 160, 128, 16000.0),
            (FRAMED_22K_B, FRAMED_22K_T, 1024, 256, 80, 22050.0),
            (FRAMED_48K_B, FRAMED_48K_T, 960, 480, 40, 48000.0)]:
        x = signal(rng, b, t, dev)
        for streaming in (False, True):
            fr, _ = mel_kernel.framed_input(x, fft, hop, streaming)
            for impl in framed_mel.IMPLS:
                got = mel_kernel.whisper_mel_pallas(
                    x, fft, hop, n_mels, sr, streaming=streaming, impl=impl,
                    device=dev)
                rows.append(dict(config=[fft, hop, n_mels, sr], shape=[b, t],
                                 streaming=streaming, **framed_held(
                                     got, fr, framed_mats(impl, fft, n_mels,
                                                          sr, dev), n_mels)))
            del fr
    bars = framed_bars(rows)
    jfk = read_wav_f32le(TESTDATA / "jfk_f32le.wav")
    golden = np.load(TESTDATA / "rust_jfk_golden.npy")
    gates = {}
    for impl in framed_mel.IMPLS:
        got = mel_kernel.whisper_mel_pallas(jfk, 512, 160, 80, 16000.0,
                                            streaming=True, impl=impl,
                                            device=dev).T.cpu().numpy()
        gates[impl] = dict(max_abs_err=float(np.abs(got - golden).max()),
                           bar=FRAMED_JFK[impl])
    emit("framed_vs_plain", bars=bars, jfk_gates=gates,
         max_abs_err={impl: {k: max(r[k] for r in rows if r["impl"] == impl)
                             for k in ("vs_plain", "vs_exact",
                                       "plain_vs_exact")}
                      for impl in framed_mel.IMPLS}, cases=rows)
    framed_check(rows, bars, "framed vs plain")
    failed = [k for k, g in gates.items()
              if not g["max_abs_err"] <= g["bar"]]
    if failed:
        raise AssertionError(f"JFK gates through K5-K8 failed: {failed}")
    return rows


def phase_ozaki_power(dev) -> dict:
    """K6's and K7's DFT power, written by the kernel before its
    projection (``framed_mel.ozaki_power``), against their plain versions'
    ``two_float_power`` with the float32 and the float64 dot: ``torch.equal``
    on 64 ragged 10 s clips at 400/160/128 and 8 clips at 1024/256/80 at
    22.05 kHz, both framings. These launches are not counted."""
    rng = np.random.default_rng(SEED + 85)
    rows = []
    for b, t, fft, hop, n_mels, sr in [
            (FRAMED_B, CHECK_T, 400, 160, 128, 16000.0),
            (FRAMED_22K_B, FRAMED_22K_T, 1024, 256, 80, 22050.0)]:
        x = signal(rng, b, t, dev)
        for streaming in (False, True):
            fr, _ = mel_kernel.framed_input(x, fft, hop, streaming)
            for impl in framed_mel.OZAKI:
                mats = framed_mats(impl, fft, n_mels, sr, dev)
                got, _ = framed_mel.ozaki_power(fr, mats, taps=fft)
                row = dict(kernel=framed_mel.KERNEL[impl],
                           config=[fft, hop, n_mels, sr], shape=[b, t],
                           streaming=streaming, frames=fr.shape[0],
                           bins=got.shape[1])
                for name, dt in (("plain", torch.float32),
                                 ("f64_dot", torch.float64)):
                    want = framed_mel.ozaki_power_reference(fr, mats,
                                                            dot_dtype=dt)
                    torch.cuda.synchronize()
                    row[f"equal_{name}"] = bool(torch.equal(got, want))
                    row[f"n_differ_{name}"] = int((got != want).sum())
                rows.append(row)
            del fr
    emit("ozaki_power", cases=rows)
    failed = [r for r in rows if not (r["equal_plain"] and r["equal_f64_dot"])]
    if failed:
        raise AssertionError(f"K6 / K7 DFT power differs from the plain "
                             f"version: {failed}")
    return dict(cases=len(rows), equal=True)


def framed_work(mats, taps: int, n_mels: int, frames: int) -> dict:
    """Operations of one framed call over ``frames`` frames, the work of
    the kernel's scheme: each slice pair it runs (K8: the six bf16 pairs
    of its float32 DFT) over the taps against the DFT columns that are
    not identically zero, at the scheme's type (bf16 or int8), and the
    float32 DFT's single product as SIMT work (``dft_ops_f32``); then one
    re + im add per bin with an im column and the float32 projection over
    the bins."""
    cw, sw = mel_kernel._build_matrices(taps, n_mels, 16000.0)[:2]
    re_cols = int((cw != 0).any(axis=0).sum())
    im_cols = int((sw != 0).any(axis=0).sum())
    pairs = len(framed_ozaki.schedule(mats.impl, mats.ks, mats.cutoff))
    per_pair = frames * 2 * taps * (re_cols + im_cols)
    return dict(pairs=pairs, dft_ops=pairs * per_pair, dft_ops_f32=per_pair,
                f32_ops=frames * (im_cols + 2 * re_cols * n_mels))


def framed_bound(mats, fr, out, taps: int, n_mels: int) -> dict:
    """The larger of the operations over their type's peak and the bytes
    over HBM's; K8 also ``bound_simt_ms``, its float32 DFT as one product
    at the SIMT float32 rate (the bound of the earlier SIMT kernel)."""
    w = framed_work(mats, taps, n_mels, fr.shape[0])
    rate = PEAK_INT8_OPS if mats.impl == "hp8" else PEAK_BF16_FLOPS
    nbytes = (fr.numel() * 4 + out.numel() * 4 + mats.mt.numel() * 4
              + sum(m.numel() * m.element_size() for m in mats.planes))
    proj_ms = w["f32_ops"] / PEAK_F32_FLOPS * 1e3
    t_ops = w["dft_ops"] / rate * 1e3 + proj_ms
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    extra = {}
    if mats.impl == "f32":
        extra["bound_simt_ms"] = max(
            w["dft_ops_f32"] / PEAK_F32_FLOPS * 1e3 + proj_ms, t_bytes)
    return dict(w, bytes=nbytes, bound_ops_ms=t_ops, bound_bytes_ms=t_bytes,
                bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                **extra)


def phase_framed_main_path(dev, rows, k1_rows) -> dict:
    """The precision dial's main path at full width:
    ``whisper_mel_pallas(x, 400, 160, 128, impl=...)`` on 64 x 30 s for
    each framed impl, counts zeroed just before the call and read just
    after (that kernel 1, K1 0), the output held against the plain
    version and the exact result to the bars of ``rows`` and this run;
    then the kernel alone on the same frames (ms, CUDA events), the whole
    call, the plain version, the cuFFT + matmul composition and the
    bound. Then the auto routes of the 256- and 1024-column heads, at
    their own configs."""
    rng = np.random.default_rng(SEED + 90)
    c = WHISPER_LARGE_V3
    x = signal(rng, FRAMED_B, int(FRAMED_SECONDS * c.sampling_rate), dev)
    fr, nf = mel_kernel.framed_input(x, c.fft_size, c.hop_size)
    lib_ms = time_ms(library_mel(x, c.fft_size, c.hop_size, c.n_mels))
    out, counts, main_rows = {}, {}, []
    for impl in framed_mel.IMPLS:
        name = framed_mel.KERNEL[impl]
        torch.cuda.synchronize()
        zero_counts()
        got = mel_kernel.whisper_mel_pallas(x, c.fft_size, c.hop_size,
                                            c.n_mels, c.sampling_rate,
                                            impl=impl, device=dev)
        torch.cuda.synchronize()
        counts[impl] = cnt = read_counts()
        if tuple(got.shape) != (FRAMED_B, nf, c.n_mels):
            raise AssertionError(f"{impl}: shape {tuple(got.shape)}")
        mats = framed_mats(impl, c.fft_size, c.n_mels, c.sampling_rate, dev)
        errs = framed_held(got, fr, mats, c.n_mels)
        main_rows.append(errs)
        del got

        def kernel():
            return framed_mel.framed_mel(fr, mats, n_mels=c.n_mels,
                                         taps=c.fft_size)

        k_out = kernel()
        out[impl] = dict(
            kernel=name, shape=list(x.shape), frames=FRAMED_B * nf,
            launches=cnt, errs=errs, ms=time_ms(kernel),
            call_ms=time_ms(lambda: mel_kernel.whisper_mel_pallas(
                x, c.fft_size, c.hop_size, c.n_mels, c.sampling_rate,
                impl=impl, device=dev)),
            plain_ms=time_ms(lambda: framed_mel.framed_mel_reference(
                fr, mats, n_mels=c.n_mels), reps=3, warmup=1),
            library_composition_ms=lib_ms,
            **framed_bound(mats, fr, k_out, c.fft_size, c.n_mels))
        out[impl]["x_real_time"] = (FRAMED_B * FRAMED_SECONDS
                                    / (out[impl]["call_ms"] / 1e3))
        out[impl]["share_of_bound"] = out[impl]["bound_ms"] / out[impl]["ms"]
        # the built library's frames per block (here and at each width of
        # FRAMED_WIDTHS), and the ring-tile bytes its loads request from L2
        # (counted, not measured)
        frames = framed_ozaki.plan(impl, mats.ks, c.fft_size,
                                   mats.mt.shape[1])[0]
        out[impl].update(
            block_frames=frames,
            block_frames_by_taps={w: framed_ozaki.plan(
                impl, mats.ks, w, mats.mt.shape[1])[0]
                for w in FRAMED_WIDTHS},
            l2_bytes_counted=framed_ozaki.l2_tile_bytes(
                impl, mats.ks, mats.cutoff, c.fft_size, mats.n_bins_pad,
                fr.shape[0], frames))
        del k_out
        emit(f"framed_main_path_{impl}", **out[impl])
        others = [k for k in framed_mel.KERNEL.values() if k != name]
        if cnt[name] != 1 or cnt["K1"] or any(cnt[k] for k in others):
            raise AssertionError(f"{impl} main path launches: {cnt}")
    bars = framed_bars(rows + main_rows)
    framed_check(main_rows, bars, "framed main path")
    del fr
    auto, auto_counts = phase_framed_auto_routes(dev, rng, k1_rows)
    return dict(times=out, counts=counts, rows=main_rows, bars=bars,
                auto=auto, auto_counts=auto_counts)


def phase_framed_auto_routes(dev, rng, rows) -> tuple:
    """The auto routes of configs whose heads are not 512 columns wide,
    which K1 now takes wherever ``k1_accepts`` holds:
    ``WhisperMelPipeline(1024, 256, 80, 22050.0).mel_batch`` and
    ``whisper_mel_pallas(impl=None)`` on 64 x 30 s at 22.05 kHz,
    ``Fbank(FbankConfig(sample_rate=8000.0))`` and the 8 kHz
    ``BatchLogMel`` on 64 x 30 s at 8 kHz; counts zeroed before each call
    and read after it (K1 once where it accepts, else the old bf3 / rdft
    routes with no launch), each against its float64 route, K1 against its
    plain version and the exact result at the bars of ``rows``, and the 8
    kHz fbank's hp route (plain PyTorch) against float64 beside rdft."""
    res, counts = {}, {}
    x = signal(rng, FRAMED_B, AUTO_SECONDS * 22050, dev)
    head = mel_kernel.whisper_head(1024, 80, 22050.0, dev)
    k1_1024 = sig_mel.k1_accepts(head, hop=256)
    pipe = WhisperMelPipeline(1024, 256, 80, 22050.0, device=dev)
    f64 = WhisperMelPipeline(1024, 256, 80, 22050.0, dtype=torch.float64,
                             fft_impl="rdft", device=dev).mel_batch(x.double())
    zero_counts()
    got = pipe.mel_batch(x)
    torch.cuda.synchronize()
    counts["pipeline_1024"] = read_counts()
    res["pipeline_1024"] = dict(fft_impl=pipe.fft_impl,
                                vs_f64=max_abs(got.double(), f64))
    zero_counts()
    got = mel_kernel.whisper_mel_pallas(x, 1024, 256, 80, 22050.0,
                                        device=dev)
    torch.cuda.synchronize()
    counts["auto_1024"] = read_counts()
    nf = framing.num_frames_batch(x.shape[-1], 1024, 256)
    res["auto_1024"] = dict(held(got, x, head, nf, 256),
                            vs_f64=max_abs(got.double(), f64))
    del got, f64
    x8 = signal(rng, FRAMED_B, AUTO_SECONDS * 8000, dev)
    ncfg = BatchLogMelConfig(sample_rate=8000, n_fft=256, win_length=200,
                             hop_length=80)
    fcfg = FbankConfig(sample_rate=8000.0)
    heads8 = {"fbank_8k": fbank_sig_head(fcfg),
              "nemo_8k": batch_logmel.sig_head(ncfg)}
    for name, front, ref in (
            ("fbank_8k", Fbank(fcfg, device=dev),
             Fbank(fcfg, dtype=torch.float64, device=dev)),
            ("nemo_8k", BatchLogMel(ncfg, device=dev),
             BatchLogMel(ncfg, dtype=torch.float64, device=dev))):
        zero_counts()
        got = front.compute(x8)
        torch.cuda.synchronize()
        counts[name] = read_counts()
        want = ref.compute(x8.double())
        res[name] = dict(fft_impl=front.fft_impl, shape=list(got.shape),
                         k1_accepts=sig_mel.k1_accepts(heads8[name], hop=80),
                         vs_f64=max_abs(got.double(), want),
                         mean_vs_f64=float((got.double() - want).abs().mean()))
        if name == "fbank_8k":
            for impl in ("hp", "rdft"):
                other = Fbank(fcfg, fft_impl=impl,
                              device=dev).compute(x8).double()
                res[f"fbank_8k_{impl}"] = dict(
                    vs_f64=max_abs(other, want),
                    mean_vs_f64=float((other - want).abs().mean()))
    emit("framed_auto_routes", shape_22k=list(x.shape),
         shape_8k=list(x8.shape), launches=counts, bars=dict(
             whisper_vs_f64=AUTO_TOL, nemo_vs_f64=LN_TOL,
             kaldi_vs_f64=KALDI_F32_TOL, k1=tolerances(rows)),
         k1_accepts_1024=k1_1024, **res)
    fails = []
    k1_only = {"K1": 1}
    want_1024 = k1_only if k1_1024 else {}
    for key in ("pipeline_1024", "auto_1024"):
        if {k: v for k, v in counts[key].items() if v} != want_1024:
            fails.append(f"{key} launches {counts[key]}")
    if res["pipeline_1024"]["fft_impl"] != ("sig" if k1_1024 else "bf3"):
        fails.append("pipeline_1024 route")
    for key in ("fbank_8k", "nemo_8k"):
        k1 = res[key]["k1_accepts"]
        if (res[key]["fft_impl"] != ("sig" if k1 else "rdft")
                or {k: v for k, v in counts[key].items() if v}
                != (k1_only if k1 else {})):
            fails.append(f"{key} route {res[key]['fft_impl']} {counts[key]}")
    if max(res["pipeline_1024"]["vs_f64"],
           res["auto_1024"]["vs_f64"]) > AUTO_TOL:
        fails.append("whisper 1024 vs float64")
    kal, kal_hp = res["fbank_8k"], res["fbank_8k_hp"]
    if (max(kal["vs_f64"], kal_hp["vs_f64"]) > KALDI_F32_TOL
            or kal_hp["mean_vs_f64"] >= res["fbank_8k_rdft"]["mean_vs_f64"]
            or res["nemo_8k"]["vs_f64"] > LN_TOL):
        fails.append("8 kHz vs float64")
    if k1_1024:
        check([res["auto_1024"]], tolerances(rows + [res["auto_1024"]]),
              "auto K1 1024")
    if fails:
        raise AssertionError(f"auto routes: {fails}")
    return res, counts


def quant_held(q, lo, hi, x, mats, n_mels, offset, nf) -> dict:
    """K1's quant records against the plain version's (f32 dot) and the
    exact one's (float64 dot) on the same signal."""
    kw = dict(ks=3, n_frames=nf, hop=160, offset=offset, pack=400,
              n_bins_pad=mats.n_bins_pad, n_mels=n_mels, live=mats.live)
    pq, plo, phi = sig_mel.sig_mel_quantized_reference(
        x, mats.m_big, mats.pair_i, mats.mt_bf2, **kw)
    _, elo, ehi = sig_mel.sig_mel_quantized_reference(
        x, mats.m_big, mats.pair_i, mats.mt_bf2, dot_dtype=torch.float64,
        **kw)
    return dict(range_vs_plain=max(max_abs(lo, plo), max_abs(hi, phi)),
                range_plain_vs_exact=max(max_abs(plo, elo),
                                         max_abs(phi, ehi)),
                q_max_step=int((q.int() - pq.int()).abs().max())
                if q.numel() else 0)


def phase_k1_epilogues_vs_plain(dev, rows) -> dict:
    """K1's quant and VAD epilogues at 1, 7 and 64 clips and on JFK, fft
    400/160, 80 and 128 mels, batch and streaming framing: the quant
    records bit-equal to quantize_frames of K1's own mel from
    whisper_mel_sig on the same input and within K1's vs-plain bar (q one
    step) of the plain version; the VAD raw equal to classify_columns of
    K1's own mel in four settings (default and the three edge settings of
    tests/test_vad_batched_device.py), tile-boundary columns included,
    with the VAD route's mel equal to whisper_mel_sig's; zero input
    quantizes to zeros; clips of 1 and 2 frames return the real mel."""
    rng = np.random.default_rng(SEED + 100)
    jfk = torch.from_numpy(read_wav_f32le(TESTDATA / "jfk_f32le.wav"))[None]
    inputs = [("1x30s", signal(rng, 1, 30 * 16000, dev)),
              ("7xragged", signal(rng, 7, 48123, dev)),
              ("64x10s", signal(rng, STEP_B, CHECK_T, dev)),
              ("jfk", jfk.to(dev))]
    bar = tolerances(rows)["vs_plain"]
    cases, fails = [], []
    for n_mels in (80, 128):
        mats = mel_kernel.sig_matrices(400, n_mels, 16000.0, 3, 2, dev)
        for streaming in (False, True):
            for name, x in inputs:
                offset, nf = k1_grid(x.shape[-1], 400, 160, streaming)
                mel = whisper_mel_sig(x, 400, 160, n_mels,
                                      streaming=streaming, device=dev)
                q, lo, hi = mel_kernel.whisper_mel_quantized(
                    x, 400, 160, n_mels, streaming=streaming, device=dev)
                wq, wlo, whi = quantize_frames(mel)
                case = dict(input=name, shape=list(x.shape), n_mels=n_mels,
                            streaming=streaming, frames=nf,
                            quant_equal=bool(torch.equal(q, wq)
                                             and torch.equal(lo, wlo)
                                             and torch.equal(hi, whi)),
                            **quant_held(q, lo, hi, x, mats, n_mels, offset,
                                         nf))
                vad = {}
                for sname, settings in EDGE_SETTINGS.items():
                    vmel, raw = mel_kernel.whisper_mel_vad_sig(
                        x, settings, 400, 160, n_mels, streaming=streaming,
                        device=dev)
                    vad[sname] = dict(
                        mel_equal=bool(torch.equal(vmel, mel)),
                        raw_equal=bool(torch.equal(raw, classify_columns(
                            vmel.transpose(-1, -2), settings))),
                        active_share=float(raw.float().mean()))
                case["vad"] = vad
                case["boundary_columns"] = len(boundary_columns(
                    nf, max(nf - 2, 0), sig_mel.TILE_FRAMES))
                cases.append(case)
                if (not case["quant_equal"] or case["range_vs_plain"] > bar
                        or case["q_max_step"] > 1
                        or not all(v["mel_equal"] and v["raw_equal"]
                                   for v in vad.values())):
                    fails.append(case)
    q0, lo0, hi0 = mel_kernel.whisper_mel_quantized(
        torch.zeros((2, 8000), device=dev), device=dev)
    zero_ok = not bool(q0.any()) and bool(torch.equal(lo0, hi0))
    short = {}
    for n in (400, 560):  # one and two frames
        y = signal(rng, 3, n, dev)
        mel, raw = mel_kernel.whisper_mel_vad_sig(y, DetectionSettings(),
                                                  device=dev)
        want = whisper_mel_sig(y, device=dev)
        short[n] = dict(frames=mel.shape[1], raw_shape=list(raw.shape),
                        mel_equal=bool(torch.equal(mel, want)),
                        nonzero=bool(mel.abs().max() > 0))
    torch.cuda.synchronize()
    worst = dict(range_vs_plain=max(c["range_vs_plain"] for c in cases),
                 range_plain_vs_exact=max(c["range_plain_vs_exact"]
                                          for c in cases),
                 q_max_step=max(c["q_max_step"] for c in cases))
    emit("k1_epilogues_vs_plain", bar_range_vs_plain=bar, worst=worst,
         n_cases=len(cases), n_quant_equal=sum(c["quant_equal"]
                                                 for c in cases),
         n_vad_equal=sum(v["raw_equal"] for c in cases
                         for v in c["vad"].values()),
         zero_input_all_zero=zero_ok, short_clips=short, cases=cases)
    if (fails or not zero_ok
            or not all(v["mel_equal"] and v["nonzero"] and v["raw_shape"]
                       == [3, 0] for v in short.values())):
        raise AssertionError(f"K1 epilogues: {fails}, zero {zero_ok}, "
                             f"short {short}")
    return dict(worst=worst, bar=bar)


def epilogue_bound(head, x, frames: int, n_mels: int, epilogue) -> dict:
    """K1's whisper bound with an epilogue: the head's operations (plus the
    epilogue's float32 ones at the SIMT rate) against the bytes of the
    signal, the matrices and the route's outputs: the float mel (4 *
    n_mels a frame), the quant records (n_mels + 8) or the mel and the
    counts (4 * n_mels + 4)."""
    flops = head_work(head, frames)
    nbytes = (x.numel() * 4 + head.m_big.numel() * 2
              + head.mt.numel() * head.mt.element_size())
    f32_ops = 0
    if epilogue == "quant":
        nbytes += frames * (n_mels + 8)
        f32_ops = frames * (5 * n_mels + 1)
    else:
        nbytes += frames * 4 * n_mels
        if epilogue == "vad":
            nbytes += frames * 4
            f32_ops = frames * SOBEL_OPS * (n_mels - 2)
    t_ops = (flops / PEAK_BF16_FLOPS + f32_ops / PEAK_F32_FLOPS) * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return dict(flops=flops, f32_ops=f32_ops, bytes=nbytes,
                bound_ops_ms=t_ops, bound_bytes_ms=t_bytes,
                bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def phase_vad_wire_path(dev, rows) -> dict:
    """The VAD and wire-record path at full width, 64 x 30 s of speech-like
    audio at whisper large-v3 windows, 128 mels and then 80: counts zeroed
    just before and read just after one pass of whisper_mel_vad_sig ->
    streaming_decision_fields_batched(raw=...) -> per-frame decisions with
    VadFrameTiming timestamps, and whisper_mel_quantized -> records of
    clip 0 -> dequantized -> tga_8bit_data (K1 twice: once with each
    epilogue). Held: raw equal to classify_columns of the route's mel,
    records bit-equal to quantize_frames of it, the TGA blob parsing back
    within the two quantization steps. The VAD epilogue's error on this
    input: K1's counts against tile_vad_counts of the route's mel (exact)
    and that mel against the plain version's (K1's vs-plain bar). Then the
    ms of each call (CUDA events) beside whisper_mel_sig alone, and the
    kernel alone with each epilogue beside its bound."""
    rng = np.random.default_rng(SEED + 110)
    settings = DetectionSettings()
    timing = VadFrameTiming(400, 160, 16000.0)
    bar = tolerances(rows)["vs_plain"]
    out = {}
    for n_mels in (128, 80):
        x = torch.from_numpy(speechlike(rng, WIRE_B,
                                        int(WIRE_SECONDS * 16000),
                                        16000)).to(dev)
        torch.cuda.synchronize()
        zero_counts()
        mel, raw = mel_kernel.whisper_mel_vad_sig(x, settings, 400, 160,
                                                  n_mels, device=dev)
        fields = streaming_decision_fields_batched(None, settings, raw=raw)
        active = fields["active"].cpu().numpy()
        first = settings.min_x - 1
        stamps = [timing.timestamps_for_frame(first + i)
                  for i in range(active.shape[1])]
        q, lo, hi = mel_kernel.whisper_mel_quantized(x, 400, 160, n_mels,
                                                     device=dev)
        rec = dequantize_tensor(q[0], lo[0, :, None], hi[0, :, None])
        blob = tga_8bit_data(interleave_frames([rec.T.cpu().numpy()]),
                             n_mels)
        torch.cuda.synchronize()
        counts = read_counts()
        nf = mel.shape[1]
        img = to_array2(parse_tga_8bit(blob), n_mels)
        per_frame_step = float(((hi[0] - lo[0]) / 255.0).max())
        tga_step = float((img.max() - img.min()) / 255.0)
        tga_err = float(np.abs(img - mel[0].T.cpu().numpy()).max())
        wq, wlo, whi = quantize_frames(mel)
        checks = dict(
            raw_equal=bool(torch.equal(raw, classify_columns(
                mel.transpose(-1, -2), settings))),
            quant_equal=bool(torch.equal(q, wq) and torch.equal(lo, wlo)
                             and torch.equal(hi, whi)),
            mel_finite=bool(torch.isfinite(mel).all()),
            tga_bytes=len(blob), tga_width=int(img.shape[1]),
            tga_max_abs_vs_mel=tga_err,
            tga_bar=(per_frame_step + tga_step) / 2 + 1e-6,
            decisions=int(active.size),
            active_share=float(active.mean()),
            stamps_first=[stamps[0].start_ms, stamps[0].center_ms,
                          stamps[0].end_ms],
            stamps_last=[stamps[-1].start_ms, stamps[-1].center_ms,
                         stamps[-1].end_ms])
        mats = mel_kernel.sig_matrices(400, n_mels, 16000.0, 3, 2, dev)
        head = mel_kernel.whisper_head(400, n_mels, 16000.0, dev)
        kw = dict(ks=3, n_frames=nf, hop=160, offset=0, pack=400,
                  n_bins_pad=mats.n_bins_pad, n_mels=n_mels, live=mats.live)
        vad = sig_mel.vad_args(settings, n_mels)
        k_mel, k_counts = sig_mel.sig_mel_vad(
            x, mats.m_big, mats.pair_i, mats.mt_bf2, vad=vad, **kw)
        p_mel, p_counts = sig_mel.sig_mel_vad_reference(
            x, mats.m_big, mats.pair_i, mats.mt_bf2, vad=vad, **kw)
        torch.cuda.synchronize()
        vad_err = dict(
            route_mel_equal=bool(torch.equal(k_mel, mel)),
            counts_vs_own_mel=max_abs(
                k_counts, sig_mel.tile_vad_counts(mel, *vad)),
            mel_vs_plain=max_abs(mel, p_mel), bar_mel_vs_plain=bar,
            frames_counts_vs_plain=int((k_counts != p_counts).sum()))
        vad_err["max_abs_err"] = max(vad_err["counts_vs_own_mel"],
                                     vad_err["mel_vs_plain"])
        del k_mel, k_counts, p_mel, p_counts
        frames = WIRE_B * nf
        ms = dict(
            whisper_mel_sig=time_ms(lambda: whisper_mel_sig(
                x, 400, 160, n_mels, device=dev)),
            whisper_mel_vad_sig=time_ms(lambda: mel_kernel.whisper_mel_vad_sig(
                x, settings, 400, 160, n_mels, device=dev)),
            decision_fields=time_ms(lambda: streaming_decision_fields_batched(
                None, settings, raw=raw)),
            whisper_mel_quantized=time_ms(
                lambda: mel_kernel.whisper_mel_quantized(x, 400, 160, n_mels,
                                                         device=dev)),
            k1=time_ms(lambda: sig_mel.sig_mel(x, mats.m_big, mats.pair_i,
                                               mats.mt_bf2, **kw)),
            k1_vad=time_ms(lambda: sig_mel.sig_mel_vad(
                x, mats.m_big, mats.pair_i, mats.mt_bf2, vad=vad, **kw)),
            k1_quant=time_ms(lambda: sig_mel.sig_mel_quantized(
                x, mats.m_big, mats.pair_i, mats.mt_bf2, **kw)),
            plain_vad=time_ms(lambda: sig_mel.sig_mel_vad_reference(
                x, mats.m_big, mats.pair_i, mats.mt_bf2, vad=vad, **kw),
                reps=3, warmup=1),
            plain_quant=time_ms(lambda: sig_mel.sig_mel_quantized_reference(
                x, mats.m_big, mats.pair_i, mats.mt_bf2, **kw),
                reps=3, warmup=1))
        bounds = {e: epilogue_bound(head, x, frames, n_mels, e)
                  for e in (None, "quant", "vad")}
        out[n_mels] = dict(shape=list(x.shape), n_mels=n_mels, frames=frames,
                           launches=counts, checks=checks,
                           vad_err=vad_err, ms=ms,
                           x_real_time_vad=WIRE_B * WIRE_SECONDS
                           / (ms["whisper_mel_vad_sig"] / 1e3),
                           x_real_time_quant=WIRE_B * WIRE_SECONDS
                           / (ms["whisper_mel_quantized"] / 1e3),
                           bound={str(k): v for k, v in bounds.items()})
        emit(f"vad_wire_path_{n_mels}", **out[n_mels])
        if (counts["K1"] != 2 or counts["K1_quant"] != 1
                or counts["K1_vad"] != 1 or not checks["raw_equal"]
                or not checks["quant_equal"] or not checks["mel_finite"]
                or tga_err > checks["tga_bar"]
                or checks["tga_width"] != nf
                or not vad_err["route_mel_equal"]
                or vad_err["counts_vs_own_mel"] != 0
                or vad_err["mel_vs_plain"] > bar):
            raise AssertionError(f"VAD wire path {n_mels}: {counts} "
                                 f"{checks} {vad_err}")
    return out


def phase_ten_vad_eval(dev) -> dict:
    """The TEN-VAD eval on the card: evaluate_testset_batched over the 30
    vendored files in both presets (the bf3 power and float32 fields, one
    batched pass), its macro metrics held to the published digits, its
    wall time (host clock, warm) and RTFx. Then the same 30 files through
    K1's VAD epilogue (whisper_mel_vad_sig on the padded batch, one
    launch) and the decision fields: how many per-frame decisions differ
    from the eval route's, and the macro metrics they give (a
    measurement, not a gate)."""
    testset = TESTDATA / "ten-vad"
    wavs, clips, rate, labels = vad_eval.load_testset(testset)
    x = torch.from_numpy(vad_eval.batch_clips(clips)).to(dev)
    out = {}
    for name in ("balanced", "high-f1"):
        opts, settings = vad_eval.preset(name)
        zero_counts()
        t0 = time.perf_counter()
        total, rows = vad_eval.evaluate_testset_batched(
            testset, opts, settings, warmup=True, device=dev)
        wall_s = time.perf_counter() - t0
        counts = read_counts()
        mm = vad_eval.macro_metrics(rows)
        got = {k: round(mm[k], 4) for k in TEN_VAD_DIGITS[name]}

        def decisions(fields):
            masks = []
            for i, clip in enumerate(clips):
                n_dec = (framing.num_frames_batch(len(clip), 400, 160)
                         - settings.min_x + 1)
                masks.append(vad_eval.speech_mask(
                    {k: v[i] for k, v in fields.items()}, n_dec, opts))
            return masks

        pipe = WhisperMelPipeline(400, 160, opts.n_mels, float(rate),
                                  fft_impl="bf3", device=dev)
        eval_fields = streaming_decision_fields_batched(
            pipe.mel_batch(x).transpose(-1, -2), settings)
        zero_counts()
        _, raw = mel_kernel.whisper_mel_vad_sig(x, settings, 400, 160,
                                                opts.n_mels, device=dev)
        k1_fields = streaming_decision_fields_batched(None, settings,
                                                      raw=raw)
        k1_counts = read_counts()
        ev = decisions({k: v.cpu().numpy() for k, v in eval_fields.items()})
        k1 = decisions({k: v.cpu().numpy() for k, v in k1_fields.items()})
        k1_rows = []
        for i, wav in enumerate(wavs):
            times_s = vad_eval.decision_times_s(len(k1[i]), settings, opts,
                                                rate)
            pp = vad_eval._postprocess_mask(k1[i], times_s, 160 / rate, opts)
            k1_rows.append(vad_eval.FileResult(
                wav, 0.0, 0.0, vad_eval._metrics(
                    pp, vad_eval._labels_mask(labels[i], times_s))))
        k1_mm = vad_eval.macro_metrics(k1_rows)
        out[name] = dict(
            files=len(rows), macro={k: mm[k] for k in TEN_VAD_DIGITS[name]},
            published=TEN_VAD_DIGITS[name], launches=counts,
            wall_s=wall_s, speed=vad_eval.speed_metrics(rows),
            decisions=int(sum(len(m) for m in ev)),
            k1_vad_decisions_differing=int(sum(int((a != b).sum())
                                               for a, b in zip(ev, k1))),
            k1_vad_launches=k1_counts,
            k1_vad_macro={k: k1_mm[k] for k in TEN_VAD_DIGITS[name]})
        emit(f"ten_vad_eval_{name}", **out[name])
        if got != TEN_VAD_DIGITS[name] or len(rows) != 30:
            raise AssertionError(f"TEN-VAD {name}: {got} vs "
                                 f"{TEN_VAD_DIGITS[name]}")
    return out


def phase_load_probe(dev) -> dict:
    """P1, the signal-load probe, through its own entry point
    (load_probe.run at 64 x 30 s): counts zeroed just before and read
    just after; each mode exact, its GB/s against 3.35 TB/s."""
    torch.cuda.synchronize()
    zero_counts()
    results = load_probe.run(dev, fail_fast=True, timer=time_ms)
    counts = dict(load_probe.launches)
    emit("load_probe", launches=counts, modes=results)
    if not all(r["ok"] for r in results) or not all(counts.values()):
        raise AssertionError(f"P1: {results} {counts}")
    return dict(modes={r["mode"]: r for r in results}, counts=counts)


def jfk_through_ring(x: np.ndarray, dtype) -> tuple:
    """JFK through ``RingBuffer`` on the card: 32-sample pushes drained a
    hop at a time (``maybe_mel``), and the whole clip drained in bulk
    (``drain_mels``); both ``[80, frames]``."""
    rb = RingBuffer(LIVE_JFK_CONFIG, capacity=2048, dtype=dtype)
    if not rb._ring.native:
        raise AssertionError("RingBuffer took the Python ring on the card")
    frames = []
    for off in range(0, len(x), LIVE_RING_BLOCK):
        rb.add_frame(x[off : off + LIVE_RING_BLOCK])
        mel = rb.maybe_mel()
        if mel is not None:
            frames.append(mel)
    bulk = RingBuffer(LIVE_JFK_CONFIG, capacity=1 << 22, dtype=dtype)
    bulk.add_frame(x)
    return (np.concatenate(frames, axis=1),
            np.concatenate(bulk.drain_mels(), axis=1))


def stm_records(stm, x: np.ndarray) -> tuple:
    """SpeechToMel records of ``x`` pushed a hop at a time, with each
    call's host-clock ms."""
    recs, ms = [], []
    for off in range(0, len(x), 160):
        t0 = time.perf_counter()
        recs.append(stm.add(x[off : off + 160]))
        ms.append((time.perf_counter() - t0) * 1e3)
    return recs, ms


def records_held(got, ref) -> dict:
    """Two SpeechToMel record sequences: the same cadence (ok, idx, ms,
    len) and VAD decisions, else AssertionError; the largest min / max
    differences and the u8 entries apart."""
    if len(got) != len(ref):
        raise AssertionError(f"{len(got)} records vs {len(ref)}")
    d_min = d_max = 0.0
    apart = step = total = 0
    for a, b in zip(got, ref):
        keys = ("ok", "idx", "ms", "len", "va")
        if a.keys() != b.keys() or any(a.get(k) != b.get(k) for k in keys):
            raise AssertionError(f"records differ: {a} vs {b}")
        if not a["ok"]:
            continue
        d_min = max(d_min, abs(a["min"] - b["min"]))
        d_max = max(d_max, abs(a["max"] - b["max"]))
        d = np.abs(a["frame"].astype(int) - b["frame"].astype(int))
        apart += int((d > 0).sum())
        step = max(step, int(d.max()))
        total += d.size
    return dict(min=d_min, max=d_max, u8_apart=apart, u8_step=step,
                u8_total=total, ok=sum(r["ok"] for r in got))


def kernels_per_call(prof, calls: int) -> dict:
    """CUDA kernels and copies launched per call, from a profile of
    ``calls`` calls, with the device time per call and the top kernels."""
    from torch.autograd import DeviceType

    kernels = copies = 0
    us = 0.0
    by_name = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total", None)
        us += e.self_cuda_time_total if t is None else t
        if e.key.startswith(("Memcpy", "Memset")):
            copies += e.count
        else:
            kernels += e.count
            by_name[e.key[:60]] = e.count / calls
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return dict(kernels=kernels / calls, copies=copies / calls,
                device_ms=us / 1e3 / calls, top=top)


def phase_live_stream(dev) -> dict:
    """The live per-hop service (``StreamingMel``, ``RingBuffer`` on the
    native ``SampleRing``, ``SpeechToMel``), plain PyTorch as in the JAX
    package: no kernel of the port runs, so K1-K8 and P1 read 0 launches
    across the phase (counts zeroed just before, read just after)."""
    from melspec_tpu_torch.utils import profiling

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    zero_counts()
    out = {}
    sections = {}

    def lap(name):
        sections[name] = time.perf_counter() - t_phase - sum(
            sections.values())

    so = ringbuffer.library_path()
    reused = so.is_file()
    t0 = time.perf_counter()
    if not ringbuffer.native_available():
        raise AssertionError("the native ring did not build on the card")
    out["ring"] = dict(native=True, build_s=time.perf_counter() - t0,
                       reused=reused, library=so.name)

    # the JFK master regression at float64, and the float32 route
    x = read_wav_f32le(TESTDATA / "jfk_f32le.wav")
    golden = np.load(TESTDATA / "rust_jfk_golden.npy")
    hop64, bulk64 = jfk_through_ring(x, torch.float64)
    hop32, bulk32 = jfk_through_ring(x, torch.float32)
    for name, m in (("hop64", hop64), ("bulk64", bulk64), ("hop32", hop32),
                    ("bulk32", bulk32)):
        if m.shape != golden.shape or not np.isfinite(m).all():
            raise AssertionError(f"JFK {name}: {m.shape} vs {golden.shape}")
    jfk = dict(
        f64_vs_golden=float(np.abs(hop64 - golden).max()),
        f64_bulk_vs_golden=float(np.abs(bulk64 - golden).max()),
        f64_bulk_vs_hop=float(np.abs(bulk64 - hop64).max()),
        f32_vs_golden=float(np.abs(hop32 - golden).max()),
        f32_bulk_vs_golden=float(np.abs(bulk32 - golden).max()),
        f32_vs_f64=float(np.abs(hop32 - hop64).max()),
        f32_bulk_vs_f64=float(np.abs(bulk32 - hop64).max()),
        f32_bulk_vs_hop=float(np.abs(bulk32 - hop32).max()))
    # the float32 route's figures are held to their bars in the line, not
    # raised: its distance from float64 on JFK is the f32 floor of the
    # JAX package's own route (a miss is logged in ROADMAP §3)
    jfk.update(
        f32_n_over_bar=int((np.abs(hop32 - hop64) > LIVE_F32_TOL).sum()),
        f32_within_bar=max(jfk["f32_vs_f64"], jfk["f32_bulk_vs_f64"])
        <= LIVE_F32_TOL,
        f32_bulk_vs_hop_within_bar=jfk["f32_bulk_vs_hop"]
        <= LIVE_BULK_TOL["float32"])
    out["jfk"] = jfk
    if max(jfk["f64_vs_golden"], jfk["f64_bulk_vs_golden"]) \
            > LIVE_GOLDEN_TOL:
        raise AssertionError(f"JFK through RingBuffer at float64: {jfk}")
    if jfk["f64_bulk_vs_hop"] > LIVE_BULK_TOL["float64"]:
        raise AssertionError(f"drain_mels vs per-hop frames: {jfk}")
    lap("jfk")

    # whisper large-v3 at float32: per-hop latency and launches, bulk and
    # scan, each held to the CPU's float64 on the same seeded audio
    c = WHISPER_LARGE_V3
    hop = c.hop_size
    rng = np.random.default_rng(SEED)
    audio = speechlike(rng, 1, LIVE_BULK_HOPS * hop, int(c.sampling_rate))[0]
    chunks = audio.reshape(LIVE_BULK_HOPS, hop)
    cpu = StreamingMel(c, dtype=torch.float64, device="cpu")
    _, ref, ref_valid = cpu.push_many(cpu.init(), chunks[:LIVE_HOLD_HOPS])
    mel = StreamingMel(c)
    state = mel.init()
    per_hop, lat = [], []
    n_hops = LIVE_WARMUP + LIVE_TIMED
    for i in range(n_hops):
        t0 = time.perf_counter()
        state, m = mel.push(state, chunks[i])
        lat.append((time.perf_counter() - t0) * 1e3)
        per_hop.append(m)
    lat = np.asarray(lat[LIVE_WARMUP:])
    valid = [m is not None for m in per_hop]
    if valid != list(ref_valid[:n_hops]):
        raise AssertionError("push emissions differ from the CPU's")
    got = np.stack([m for m in per_hop if m is not None])
    width = dict(push_vs_cpu_f64=float(np.abs(
        got - ref[:n_hops][ref_valid[:n_hops]]).max()))
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.trace(tmp) as prof:
            for i in range(LIVE_PROFILED):
                state, _ = mel.push(state, chunks[n_hops + i])
        trace_bytes = sum(f.stat().st_size for f in Path(tmp).iterdir())
    launches = kernels_per_call(prof, LIVE_PROFILED)
    dchunks = torch.from_numpy(chunks).to(dev)
    s0 = mel.init()
    _, bulk, bulk_valid = mel.push_many(s0, dchunks)
    width["bulk_vs_cpu_f64"] = float(np.abs(
        bulk[:LIVE_HOLD_HOPS] - ref)[ref_valid].max())
    _, scan, scan_valid = mel.push_many(s0, dchunks[:LIVE_SCAN_HOPS],
                                        scan=True)
    if not (np.array_equal(bulk_valid[:LIVE_SCAN_HOPS], scan_valid)
            and np.array_equal(ref_valid, bulk_valid[:LIVE_HOLD_HOPS])):
        raise AssertionError("bulk / scan validity differ")
    width["scan_vs_cpu_f64"] = float(np.abs(
        scan - ref[:LIVE_SCAN_HOPS])[scan_valid].max())
    width["scan_vs_bulk"] = float(np.abs(
        scan - bulk[:LIVE_SCAN_HOPS])[scan_valid].max())
    if not np.isfinite(bulk).all() or bulk.shape != (LIVE_BULK_HOPS,
                                                     c.n_mels):
        raise AssertionError(f"bulk output {bulk.shape} not finite")
    if max(width["push_vs_cpu_f64"], width["bulk_vs_cpu_f64"],
           width["scan_vs_cpu_f64"]) > LIVE_WIDTH_TOL \
            or width["scan_vs_bulk"] > LIVE_BULK_TOL["float32"]:
        raise AssertionError(f"large-v3 streaming mel: {width}")
    bulk_ms = time_ms(lambda: mel._bulk(s0, dchunks), reps=5, warmup=1)
    bulk_call_ms = time_ms(lambda: mel.push_many(s0, dchunks), reps=5,
                           warmup=1)
    scan_ms = time_ms(lambda: mel.push_many(
        s0, dchunks[:LIVE_SCAN_HOPS], scan=True), reps=3, warmup=1)
    audio_s = LIVE_BULK_HOPS * hop / c.sampling_rate
    hop_ms = hop / c.sampling_rate * 1e3
    out["large_v3"] = dict(
        config=[c.fft_size, c.hop_size, c.n_mels, c.sampling_rate],
        bars=dict(vs_cpu_f64=LIVE_WIDTH_TOL,
                  scan_vs_bulk=LIVE_BULK_TOL["float32"]), **width,
        push_ms_median=float(np.median(lat)),
        push_ms_p99=float(np.percentile(lat, 99)), hop_period_ms=hop_ms,
        pushes_timed=int(lat.size), launches_per_push=launches,
        trace_bytes=trace_bytes,
        bulk_hops=LIVE_BULK_HOPS, bulk_frames_bytes=LIVE_BULK_HOPS
        * c.fft_size * 4, bulk_device_ms=bulk_ms,
        bulk_call_ms=bulk_call_ms, bulk_x_real_time=audio_s / bulk_ms * 1e3,
        bulk_call_x_real_time=audio_s / bulk_call_ms * 1e3,
        scan_hops=LIVE_SCAN_HOPS, scan_ms=scan_ms,
        scan_ms_per_hop=scan_ms / LIVE_SCAN_HOPS)

    lap("large_v3")

    # SpeechToMel at its defaults over JFK, held to the CPU port's records
    card, stm_ms = stm_records(SpeechToMel(), x)
    cpu32, _ = stm_records(SpeechToMel(device="cpu"), x)
    cpu64, _ = stm_records(SpeechToMel(dtype=torch.float64, device="cpu"),
                           x)
    vs32 = records_held(card, cpu32)
    vs64 = records_held(card, cpu64)
    stm = dict(vs_cpu_f32=vs32, min_vs_cpu_f64=vs64["min"],
               add_ms_median=float(np.median(stm_ms[5:])),
               add_ms_p99=float(np.percentile(stm_ms[5:], 99)),
               records=len(card), bars=dict(max=1e-5,
                                            min_vs_f64=LIVE_MIN_FLOOR))
    out["speech_to_mel"] = stm
    if vs32["max"] > 1e-5 or vs64["min"] > LIVE_MIN_FLOOR \
            or vs32["u8_step"] > 1 or vs32["u8_apart"] > vs32["u8_total"] \
            // 1000 or vs32["ok"] != len(x) // 160 - 2:
        raise AssertionError(f"SpeechToMel on the card: {stm}")

    lap("speech_to_mel")

    # two threads: a producer pushes JFK into a native SampleRing in
    # 32-sample blocks; a consumer drains whole hops into SpeechToMel
    ring = SampleRing(1 << 15)
    live = SpeechToMel()
    live_recs = []
    done = threading.Event()
    errors = []

    def producer():
        for off in range(0, len(x), LIVE_RING_BLOCK):
            rest = x[off : off + LIVE_RING_BLOCK]
            while rest.size:
                rest = rest[ring.push(rest):]
                if rest.size:
                    time.sleep(0.0005)
        done.set()

    def consumer():
        buf = np.empty(160, dtype=np.float32)
        try:
            while not (done.is_set() and len(ring) < 160):
                if ring.pop_exact(buf):
                    live_recs.append(live.add(buf.copy()))
                else:
                    time.sleep(0.0002)
        except Exception as e:  # raised again below, in the main thread
            errors.append(e)
            raise

    threads = [threading.Thread(target=producer),
               threading.Thread(target=consumer)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"live threads failed: {errors}")
    live_held = records_held(live_recs, card)
    out["two_threads"] = dict(
        records=len(live_recs), hops=len(x) // 160, dropped=ring.dropped,
        left=len(ring), wall_s=wall, x_real_time=len(x) / 16000.0 / wall,
        vs_single_thread=live_held)
    if ring.dropped or len(live_recs) != len(x) // 160 \
            or live_held["max"] or live_held["min"] \
            or live_held["u8_apart"]:
        raise AssertionError(f"two-thread live run: {out['two_threads']}")

    torch.cuda.synchronize()
    lap("two_threads")
    counts = read_counts()
    out["launches"] = counts
    out["seconds"] = time.perf_counter() - t_phase
    out["section_s"] = sections
    emit("live_stream", **out)
    if any(counts.values()):
        raise AssertionError(f"a port kernel launched on the live path: "
                             f"{counts}")
    return out

def ws_connect(port: int) -> "socket.socket":
    """A WebSocket client of the bridge: the upgrade, checked."""
    import socket

    sock = socket.create_connection(("127.0.0.1", port), timeout=60)
    key = "dGhlIHNhbXBsZSBub25jZQ=="
    sock.sendall((f"GET /ws HTTP/1.1\r\nHost: 127.0.0.1:{port}\r\n"
                  "Upgrade: websocket\r\nConnection: Upgrade\r\n"
                  f"Sec-WebSocket-Key: {key}\r\n"
                  "Sec-WebSocket-Version: 13\r\n\r\n").encode())
    resp = b""
    while b"\r\n\r\n" not in resp:
        chunk = sock.recv(1)  # byte by byte: no record frame swallowed
        if not chunk:
            raise AssertionError("bridge closed during the upgrade")
        resp += chunk
    if b" 101 " not in resp.split(b"\r\n", 1)[0] \
            or ws_bridge.ws_accept_key(key).encode() not in resp:
        raise AssertionError(f"bad upgrade: {resp!r}")
    return sock


def serve_reference(pcm: np.ndarray, rate: int, config: MelConfig,
                    settings: DetectionSettings) -> tuple:
    """What every client of a device-resampling server must receive, on
    the CPU in float64: ``resample_poly`` of its PCM to 16 kHz, then
    ``compute_streaming_mel`` (float64), then the per-frame quantizer and
    the streaming VAD decisions over the float32 mel. Returns ``(q [S, F,
    n_mels], lo, hi, va [S, F])`` numpy."""
    up, down = 16000 // np.gcd(16000, rate), rate // np.gcd(16000, rate)
    y = resample_poly(torch.from_numpy(pcm.astype(np.float64)), up, down,
                      device="cpu")
    mel = compute_streaming_mel(y.numpy(), config.fft_size, config.hop_size,
                                config.n_mels, config.sampling_rate,
                                dtype=torch.float64, device="cpu")
    mel = torch.from_numpy(mel)                     # [S, n_mels, F] f32
    q, lo, hi = quantize_frames(mel.transpose(-1, -2))
    fields = streaming_decision_fields_batched(mel.to(torch.float64),
                                               settings)
    va = torch.zeros(mel.shape[0], mel.shape[2], dtype=torch.bool)
    va[:, settings.min_x - 1:] = fields["active"]
    return q.numpy(), lo.numpy(), hi.numpy(), va.numpy()


def serve_run(dev, name, config, clients, rate, fmt, fft_impl, seed) -> dict:
    """One fleet through the TCP server: ``clients`` threads, each
    ``stream_client`` with SERVE_SECONDS of speech-like PCM at ``rate``
    (``fmt`` on the wire), into a ``StreamServer`` of as many slots that
    resamples on the device. Launch counts are zeroed just before the
    clients start and read just after the last finishes. Every client's
    records are held against ``serve_reference``."""
    settings = DetectionSettings()
    server = serve_streams.StreamServer(
        config=config, n_streams=clients, hops_per_tick=SERVE_HOPS,
        settings=settings, input_rate=rate, device_resample=True,
        fft_impl=fft_impl, pcm_format=fmt, device=dev)
    t0 = time.perf_counter()
    server.start()  # the warm push: the route's kernels are built here
    start_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    pcm = speechlike(rng, clients, int(SERVE_SECONDS * rate), rate)
    if fmt == "s16le":  # the client sends (and the server decodes) this
        pcm = np.clip(np.round(pcm * 32768.0), -32768, 32767) / 32768.0
        pcm = pcm.astype(np.float32)
    recs, errors = [None] * clients, []

    def client(i):
        try:
            recs[i] = serve_streams.stream_client(
                server.port, pcm[i], chunk=SERVE_WRITE, timeout=120,
                n_mels=config.n_mels, pcm_format=fmt)
        except Exception as e:  # raised again below, in the main thread
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(clients)]
    # host-clock seconds inside the tick's push_many (the device work and
    # its one fetch); the rest of the wall is sockets, rings and packing
    push = server.frontend.push_many
    in_push = []

    def timed_push(*a, **kw):
        t = time.perf_counter()
        try:
            return push(*a, **kw)
        finally:
            in_push.append(time.perf_counter() - t)

    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    with mock.patch.object(server.frontend, "push_many", timed_push):
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
    wall = time.perf_counter() - t0
    counts = read_counts()
    stats = server.stats()
    server.stop()
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"{name}: clients failed: {errors[:3]}")

    q, lo, hi, va = serve_reference(pcm, rate, config, settings)
    spur = server.frontend.rs.spurious_out // config.hop_size
    k = int(SERVE_SECONDS * rate) // server.ingest_hop
    n_want = framing.num_frames_streaming(k * config.hop_size,
                                          config.fft_size,
                                          config.hop_size) - spur
    d_lo = d_hi = 0.0
    q_step = flips = 0
    for i, r in enumerate(recs):
        if len(r) != n_want or [x[0] for x in r] != list(range(n_want)):
            raise AssertionError(f"{name}: client {i}: {len(r)} records, "
                                 f"want {n_want} in order")
        gq = np.stack([x[4] for x in r]).astype(int)
        q_step = max(q_step, int(np.abs(gq - q[i, :n_want]).max()))
        d_lo = max(d_lo, float(np.abs(np.asarray([x[2] for x in r])
                                      - lo[i, :n_want]).max()))
        d_hi = max(d_hi, float(np.abs(np.asarray([x[3] for x in r])
                                      - hi[i, :n_want]).max()))
        flips += int((np.asarray([x[1] for x in r]) != va[i, :n_want]).sum())
    n_recs = clients * n_want
    audio_s = clients * SERVE_SECONDS
    out = dict(clients=clients, rate=rate, pcm_format=fmt,
               fft_impl=server.fft_impl, n_mels=config.n_mels,
               hops_per_tick=SERVE_HOPS, seconds_per_client=SERVE_SECONDS,
               write_samples=SERVE_WRITE, start_s=start_s, wall_s=wall,
               records=n_recs, records_per_s=n_recs / wall,
               x_real_time=audio_s / wall, ticks=stats["ticks"],
               push_many_s=sum(in_push),
               push_many_ms_median=statistics.median(in_push) * 1e3,
               push_many_share=sum(in_push) / wall,
               frames_sent=stats["frames_sent"],
               clients_served=stats["clients_served"],
               backpressure_waits=stats["backpressure_waits"],
               ring_dropped=stats["ring_dropped"], launches=counts,
               spurious_hops=spur, q_max_step=q_step, lo_vs_f64=d_lo,
               hi_vs_f64=d_hi, va_flips=flips, va_checked=n_recs,
               va_flip_budget=VA_FLIP_BUDGET)
    if q_step > 1 or flips > VA_FLIP_BUDGET \
            or stats["frames_sent"] != n_recs \
            or stats["clients_served"] != clients \
            or stats["backpressure_waits"] or stats["ring_dropped"]:
        raise AssertionError(f"{name}: {out}")
    return out


def bridge_vs_tcp(dev) -> dict:
    """One WebSocket client through the port's ``BrowserBridge`` over a
    ``StreamServer`` on the card, against a TCP client of the same PCM
    (3 s of JFK, masked frames of odd sizes): the same bytes."""
    import socket

    pcm = read_wav_f32le(TESTDATA / "jfk_f32le.wav")[: 3 * 16000]
    raw = pcm.astype("<f4").tobytes()
    streams = serve_streams.StreamServer(n_streams=4, device=dev)
    streams.start()
    bridge = ws_bridge.BrowserBridge(stream_server=streams).start()
    try:
        tcp = socket.create_connection(("127.0.0.1", streams.port),
                                       timeout=60)
        tcp.sendall(raw)
        tcp.shutdown(socket.SHUT_WR)
        want = b""
        while True:
            d = tcp.recv(65536)
            if not d:
                break
            want += d
        tcp.close()
        ws = ws_connect(bridge.port)
        for off in range(0, len(raw), 31997):
            ws.sendall(ws_bridge.ws_encode_frame(raw[off : off + 31997],
                                                 mask=True))
        ws.sendall(ws_bridge.ws_encode_frame(b"", opcode=0x8, mask=True))
        got = b""
        while True:
            try:
                opcode, payload = ws_bridge.ws_read_frame(ws)
            except ConnectionError:
                break
            if opcode == 0x8:
                break
            if opcode == 0x2:
                got += payload
        ws.close()
    finally:
        bridge.stop()
        streams.stop()
    rec = serve_streams.HEADER.size + streams.config.n_mels
    out = dict(bytes=len(want), records=len(want) // rec,
               equal=got == want)
    if not want or len(want) % rec or got != want:
        raise AssertionError(f"bridge vs TCP: {out}, got {len(got)} bytes")
    return out


def run_clis(dev) -> dict:
    """The CLIs by subprocess, all started together, each on its default
    device (no ``--device``; on a CPU rehearsal ``--device cpu``), beside
    ``mel_tga --device cpu`` on the same PCM: each must exit 0 and write
    its output; ``mel_tga``'s TGA must equal the CPU run's within one u8
    step. ``waterfall`` is held on the CPU only (tests/
    test_torch_examples.py): PIL may be absent on the card's machine."""
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        pcm = tmp / "jfk.f32le"
        pcm.write_bytes(read_wav_f32le(TESTDATA / "jfk_f32le.wav")
                        [: int(CLI_SECONDS * 16000)].tobytes())
        flag = [] if dev.type == "cuda" else ["--device", "cpu"]
        mod = "melspec_tpu_torch.examples."
        jobs = {
            "mel_tga": ([mod + "mel_tga", "--out-dir", str(tmp / "card")]
                        + flag, pcm),
            "mel_tga_cpu": ([mod + "mel_tga", "--out-dir", str(tmp / "cpu"),
                             "--device", "cpu"], pcm),
            "live_pipeline": ([mod + "live_pipeline"] + flag, None),
            "stream_asr_segments": ([mod + "stream_asr_segments",
                                     "--out-dir", str(tmp / "segs")] + flag,
                                    pcm),
            "vad_ten_eval": ([mod + "vad_ten_eval", "--max-files", "2",
                              "--batched"] + flag, None),
        }
        t0 = time.perf_counter()
        procs = {}
        for name, (args, stdin) in jobs.items():
            fh = open(stdin, "rb") if stdin else subprocess.DEVNULL
            procs[name] = (subprocess.Popen(
                [sys.executable, "-m"] + args, cwd=ROOT, stdin=fh,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
                fh)
        res = {}
        try:
            for name, (p, fh) in procs.items():
                out, err = p.communicate(timeout=300)
                if fh is not subprocess.DEVNULL:
                    fh.close()
                res[name] = dict(rc=p.returncode, out=out, err=err)
        finally:
            for p, _ in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
        bad = {k: v["err"][-800:] for k, v in res.items() if v["rc"]}
        if bad:
            raise AssertionError(f"CLI runs failed: {bad}")
        card = sorted((tmp / "card").glob("*.tga"))
        cpu = sorted((tmp / "cpu").glob("*.tga"))
        segs = sorted((tmp / "segs").glob("*.tga"))
        tga_step = max(int(np.abs(
            parse_tga_8bit(a.read_bytes()).astype(int)
            - parse_tga_8bit(b.read_bytes()).astype(int)).max())
            for a, b in zip(card, cpu)) if card and len(card) == len(cpu) \
            else None
        out = dict(
            wall_s=wall, device=dev.type if flag else "default",
            mel_tga=dict(files=len(card), u8_max_step_vs_cpu=tga_step),
            live_pipeline=res["live_pipeline"]["out"].strip(),
            stream_asr_segments=dict(
                segments=len(segs),
                lines=len(res["stream_asr_segments"]["out"].splitlines())),
            vad_ten_eval=[ln for ln in res["vad_ten_eval"]["out"]
                          .splitlines() if ln.startswith(("macro:",
                                                          "speed:"))])
    if tga_step is None or tga_step > 1 or not segs \
            or "mel frames" not in out["live_pipeline"] \
            or len(out["vad_ten_eval"]) != 2:
        raise AssertionError(f"CLI outputs: {out}")
    return out


def phase_serve_streams(dev) -> dict:
    """The example entry points on the card: the TCP ``StreamServer``
    (``melspec_tpu_torch/examples/serve_streams.py``) behind its socket at
    full width, run A: SERVE_A_CLIENTS concurrent ``stream_client``
    threads of 48 kHz f32 PCM into a server at whisper large-v3 that
    resamples on the device and takes the sig route (K4 and K1 must
    launch, K2 and K5-K8 must not); run B: SERVE_B_CLIENTS clients of
    8 kHz s16le at 80 mels on the rdft route (K4 must launch, K1 must
    not). Each client's records against the CPU's float64. Then one
    WebSocket client through ``BrowserBridge`` against a TCP client, and
    the CLIs on their default device (``run_clis``; ``waterfall`` only in
    the CPU tests, since PIL may be absent here)."""
    t_phase = time.perf_counter()
    a = serve_run(dev, "run A", WHISPER_LARGE_V3, SERVE_A_CLIENTS, 48000,
                  "f32le", "sig", SEED + 40)
    b = serve_run(dev, "run B", MelConfig(400, 160, 80, 16000.0),
                  SERVE_B_CLIENTS, 8000, "s16le", "rdft", SEED + 41)
    out = dict(run_a=a, run_b=b, bridge=bridge_vs_tcp(dev),
               clis=run_clis(dev))
    out["seconds"] = time.perf_counter() - t_phase
    emit("serve_streams", **out)
    la, lb = a["launches"], b["launches"]
    quiet = ("K2", "K5", "K6", "K7", "K8")
    if la["K4"] < 1 or la["K1"] < 1 or any(la.get(k) for k in quiet) \
            or lb["K4"] < 1 or lb["K1"] or any(lb.get(k) for k in quiet):
        raise AssertionError(f"serve_streams launches: A {la}, B {lb}")
    return out


# phase parallel: the frontend step at PAR_B x PAR_SECONDS (whisper
# large-v3 + Kaldi + NeMo), first in a one-rank NCCL group against the
# ungrouped step, bit for bit; then PAR_WORLD gloo ranks (processes of this
# script, every one on cuda:0: NCCL refuses two ranks on one card), each
# holding its block of the step and of sharded_whisper_mel against a
# one-rank run, the 48 kHz sig serving tick (PAR_STREAMS streams, PAR_TICKS
# ticks of TICK_HOPS hops, a whole-fleet checkpoint at PAR_CKPT resumed bit
# for bit) against one rank at the JAX bars, and multihost_frontend over
# the TEN-VAD wavs (PAR_CLIP clips, PAR_LOCAL rows a rank, 80 mels) against
# one rank over every file. Where a block is not bit-equal to the one-rank
# run, the largest difference is held to tests/test_sharding.py's 1e-5
# (PAR_BAR; lo and hi of a tick too, tests/test_configs_broad.py). Every
# block is also held against the one-rank run on the plain versions of
# K1-K4 (plain_kernels, which launch no kernel) on the same inputs: the
# step's and multihost_frontend's at the frontend step's bars
# (step_errs_failed), the whisper rows at K1's vs-plain bar, the ticks at
# the JAX serving bars with lo and hi at K1's vs-plain bar; the bars are
# phase_k2's of this run, handed to the workers in a file, and for the
# TEN-VAD clips raised to their own f32 floor (clip_bars)
PAR_B, PAR_SECONDS, PAR_WORLD, PAR_BAR = 64, 30, 2, 1e-5
PAR_STREAMS, PAR_TICKS, PAR_CKPT = 256, 50, 25
PAR_CLIP, PAR_LOCAL, PAR_WORKER_S = 30 * 16000, 16, 240


def par_inputs(dev) -> torch.Tensor:
    """The step's input, the same in every process."""
    return signal(np.random.default_rng(SEED + 90), PAR_B,
                  PAR_SECONDS * 16000, dev)


def plain_run(fn, dot_dtype: torch.dtype = torch.float32):
    """``fn()`` on the plain versions; fails if a kernel launched."""
    torch.cuda.synchronize()
    zero_counts()
    with plain_kernels(dot_dtype):
        res = fn()
    torch.cuda.synchronize()
    launched = {k: v for k, v in read_counts().items() if v}
    if launched:
        raise AssertionError(f"the plain run launched {launched}")
    return res


def blocks_held(got: dict, want: dict) -> dict:
    """Per key: bit-equal, and the largest difference."""
    return {k: dict(equal=bool(torch.equal(got[k], want[k])),
                    max_abs=max_abs(got[k].double(), want[k].double()))
            for k in want}


def blocks_failed(held: dict) -> bool:
    """Not bit-equal to the one-rank run, and off by more than PAR_BAR or
    in an aggregate."""
    return not all(h["equal"] for h in held.values()) and (
        max(h["max_abs"] for h in held.values()) > PAR_BAR
        or any(not held[k]["equal"] for k in ("vad_active_columns",
                                              "vad_total_columns")))


def parallel_nccl(dev, bars: dict) -> dict:
    """The step in a one-rank NCCL group (the all-reduce of the two
    aggregates runs on the card) against the step without a group, and
    against the same step on the plain versions."""
    import torch.distributed as dist

    kw = dict(settings=DetectionSettings(), mel_config=WHISPER_LARGE_V3)
    x = par_inputs(dev)
    ungrouped = sharded_frontend_step(make_mesh(device=dev), **kw)
    want = ungrouped(x)
    plain = plain_run(lambda: ungrouped(x))
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(
            f"{tmp}/store", 1), rank=0, world_size=1)
        try:
            mesh = make_mesh()
            step = sharded_frontend_step(mesh, **kw)
            torch.cuda.synchronize()
            zero_counts()
            got = step(x)  # the path, once
            torch.cuda.synchronize()
            launches = read_counts()
            pair = torch.zeros(2, dtype=torch.int32, device=mesh.device)
            out = dict(backend=dist.get_backend(), device=str(mesh.device),
                       launches=launches, held=blocks_held(got, want),
                       vs_plain=step_errs(got, plain),
                       allreduce_ms=time_ms(lambda: dist.all_reduce(pair)),
                       step_ms=time_ms(lambda: step(x)),
                       ungrouped_ms=time_ms(lambda: ungrouped(x)))
        finally:
            dist.destroy_process_group()
    out["bit_equal"] = all(h["equal"] for h in out["held"].values())
    out["vs_plain_failed"] = step_errs_failed(out["vs_plain"], *bars)
    return out


def clip_bars(plain: dict, exact: dict, bars: tuple) -> tuple:
    """The step's bars (K1's vs-plain bar, the ln heads') raised, where
    the f32 floor on these inputs (the plain version's largest distance
    from the exact result) is higher, by phase_k2's rule: max(tol, floor)
    + floor. Real clips reach further below their frames' peaks than
    phase_k2's noise, and ln turns that into absolute error."""
    fw = max_abs(plain["mel"], exact["mel"])
    fl = max(max_abs(plain[k], exact[k]) for k in ("nemo", "fbank"))
    return (max(bars[0], max(K1_TOL, fw) + fw),
            max(bars[1], max(LN_TOL, fl) + fl))


def tick_held(got: list, want: list, bar: float) -> dict:
    """One tick against another run's at the JAX bars
    (tests/test_configs_broad.py): valid exact, q within one step, at most
    one VA flip, lo and hi within ``bar``; the counts that differ."""
    q, lo, hi, va, valid = got
    rq, rlo, rhi, rva, rvalid = want
    h = dict(valid_diff=int((valid != rvalid).sum()),
             q_diff=int((q != rq).sum()),
             q_max_step=int((q.int() - rq.int()).abs().max()),
             va_flips=int((va != rva).sum()),
             lo_max_abs=max_abs(lo, rlo), hi_max_abs=max_abs(hi, rhi))
    h["failed"] = bool(h["valid_diff"] or h["q_max_step"] > 1
                       or h["va_flips"] > 1
                       or max(h["lo_max_abs"], h["hi_max_abs"]) > bar)
    return h


def ticks_summary(held: list) -> dict:
    return dict(
        valid_diff=sum(h["valid_diff"] for h in held),
        q_diff=sum(h["q_diff"] for h in held),
        q_max_step=max(h["q_max_step"] for h in held),
        va_flips=sum(h["va_flips"] for h in held),
        va_flips_max_tick=max(h["va_flips"] for h in held),
        lo_max_abs=max(h["lo_max_abs"] for h in held),
        hi_max_abs=max(h["hi_max_abs"] for h in held),
        failed_ticks=[t for t, h in enumerate(held) if h["failed"]])


def parallel_rank(mesh, out_dir: Path, bars: tuple) -> dict:
    """What one gloo rank holds against one-rank runs in its own process
    (a mesh of this process alone: no collective), on the kernels and on
    their plain versions. ``bars`` is (K1's vs-plain bar, the ln heads')."""
    from melspec_tpu_torch.parallel.sharding import Mesh, _all_reduce_sum

    wbar, lbar = bars
    dev, out, counts = mesh.device, {}, {}
    solo = Mesh(None, mesh.axis, 1, 0, dev)
    rows = slice(mesh.rank * PAR_B // mesh.size,
                 (mesh.rank + 1) * PAR_B // mesh.size)

    def counted(name, fn):
        torch.cuda.synchronize()
        zero_counts()
        res = fn()
        torch.cuda.synchronize()
        counts[name] = read_counts()
        return res

    kw = dict(settings=DetectionSettings(), mel_config=WHISPER_LARGE_V3)
    x = par_inputs(dev)
    one_step = sharded_frontend_step(solo, **kw)
    one = one_step(x)
    plain = plain_run(lambda: one_step(x))
    flips = int((one["vad_smoothed"] != plain["vad_smoothed"]).sum())
    step = sharded_frontend_step(mesh, **kw)
    xb = x[rows].contiguous()
    got = counted("step", lambda: step(xb))
    out["step"] = blocks_held(got, plain_block(one, rows))
    out["step_vs_plain"] = step_errs(got, plain_block(plain, rows), flips)
    pair = torch.zeros(2, dtype=torch.int32, device=dev)
    out["step_ms"] = time_ms(lambda: step(xb))
    out["allreduce_ms"] = time_ms(lambda: _all_reduce_sum(mesh, pair))

    wm = sharded_whisper_mel(mesh, 400, 160, WHISPER_LARGE_V3.n_mels)
    one_wm = sharded_whisper_mel(solo, 400, 160, WHISPER_LARGE_V3.n_mels)
    ref = one_wm(x)
    ref_plain = plain_run(lambda: one_wm(x))
    mel = counted("whisper_mel", lambda: wm(xb))
    out["whisper_mel"] = dict(equal=bool(torch.equal(mel, ref[rows])),
                              max_abs=max_abs(mel, ref[rows]),
                              vs_plain=max_abs(mel, ref_plain[rows]))

    s, hop_src = PAR_STREAMS, 480
    chunks = torch.from_numpy(speechlike(
        np.random.default_rng(SEED + 91), s, PAR_TICKS * TICK_HOPS * hop_src,
        48000).reshape(s, PAR_TICKS, TICK_HOPS, hop_src)).to(dev)
    serve = dict(config=WHISPER_LARGE_V3, n_streams=s, input_rate=48000,
                 fft_impl="sig")
    _, init1, tick1 = sharded_serving(solo, **serve)

    def one_rank_ticks():
        st, ticks = init1(), []
        for t in range(PAR_TICKS):
            st, *o = tick1(st, chunks[:, t], None)
            ticks.append(o)
        return ticks

    ref_ticks = one_rank_ticks()
    plain_ticks = plain_run(one_rank_ticks)
    front, init_fn, tick_fn = sharded_serving(mesh, **serve)
    streams = slice(mesh.rank * s // mesh.size,
                    (mesh.rank + 1) * s // mesh.size)
    mine = chunks[streams]
    path = out_dir / "fleet.npz"
    warm = {}

    def fleet():
        st, ticks = init_fn(), []
        for t in range(PAR_TICKS):
            if t == PAR_CKPT:
                front.save_state(path, st)
                warm["state"] = st
            st, *o = tick_fn(st, mine[:, t], None)
            ticks.append(o)
        return ticks

    ticks = counted("serving", fleet)
    held = [tick_held(o, [r[streams] for r in want], PAR_BAR)
            for o, want in zip(ticks, ref_ticks)]
    held_plain = [tick_held(o, [r[streams] for r in want], wbar)
                  for o, want in zip(ticks, plain_ticks)]
    st = front.load_state(path)
    resumed = True
    for t in range(PAR_CKPT, PAR_TICKS):
        st, *o = tick_fn(st, mine[:, t], None)
        resumed &= all(torch.equal(a, b) for a, b in zip(o, ticks[t]))
    whole = SourceRateFrontend(WHISPER_LARGE_V3, s, input_rate=48000,
                               fft_impl="sig", device=dev).load_state(path)
    out["serving"] = dict(
        ticks=PAR_TICKS, streams=[streams.start, streams.stop],
        **ticks_summary(held),
        vs_plain=ticks_summary(held_plain),
        valid_frames=sum(int(o[4].sum()) for o in ticks),
        resumed_bit_equal=bool(resumed),
        whole_fleet_rows=int(whole.fe.mel.idx.shape[0]))
    # a steady-state 4-hop tick: from the state the fleet carried into
    # tick PAR_CKPT, on that tick's chunks (the tick returns a new state)
    out["tick_ms"] = time_ms(lambda: tick_fn(warm["state"],
                                             mine[:, PAR_CKPT], None))

    wavs = sorted((TESTDATA / "ten-vad").glob("*.wav"))

    def one_rank_files():
        return multihost_frontend(solo, wavs, PAR_CLIP,
                                  PAR_LOCAL * mesh.size)[0]

    ref = one_rank_files()
    ref_plain = plain_run(one_rank_files)
    mh_bars = clip_bars(ref_plain, plain_run(one_rank_files, torch.float64),
                        bars)
    mh, nv = counted("multihost", lambda: multihost_frontend(
        mesh, wavs, PAR_CLIP, PAR_LOCAL))
    mine_files = list(range(mesh.rank, len(wavs), mesh.size))  # a row each
    n = len(mine_files)
    # the rank's rows in the one-rank run: its files, then pad rows (the
    # one-rank run's rows past the last file are pad rows too)
    index = mine_files + [len(wavs)] * (PAR_LOCAL - n)
    mh_flips = int((ref["vad_smoothed"] != ref_plain["vad_smoothed"]).sum())
    out["multihost"] = dict(
        files=len(wavs), rows=n, real_rows=int((nv > 0).sum()),
        aggregates=[int(mh["vad_active_columns"]),
                    int(mh["vad_total_columns"])],
        one_rank=[int(ref["vad_active_columns"]),
                  int(ref["vad_total_columns"])],
        held=blocks_held(mh, plain_block(ref, index)),
        vs_plain=step_errs(mh, plain_block(ref_plain, index), mh_flips),
        bars=mh_bars)
    out["launches"] = counts
    out["launches_total"] = {k: sum(c[k] for c in counts.values())
                             for k in ("K1", "K2", "K3", "K4")}
    return out


def parallel_worker(rank: int, world: int, out_dir: Path) -> int:
    """One rank of phase parallel: a gloo group over a file store in
    ``out_dir``, the mesh's default device (cuda:{rank % cards}), the bars
    from ``out_dir/bars.json``, results into ``out_dir/rank{rank}.json``."""
    import datetime

    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bars = tuple(json.loads((out_dir / "bars.json").read_text()))
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/store",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_mesh()
        res = dict(rank=rank, world=world, device=str(mesh.device),
                   backend=dist.get_backend(),
                   **parallel_rank(mesh, out_dir, bars))
    finally:
        dist.destroy_process_group()
    (out_dir / f"rank{rank}.json").write_text(json.dumps(res))
    return 0


def parallel_gloo(bars: tuple) -> list:
    """PAR_WORLD workers of this script; fails if either fails."""
    with tempfile.TemporaryDirectory() as tmp:
        (Path(tmp) / "bars.json").write_text(json.dumps(list(bars)))
        procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()),
             "--parallel-worker", str(r), str(PAR_WORLD), tmp],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=str(ROOT)) for r in range(PAR_WORLD)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=PAR_WORKER_S)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        bad = [(r, p.returncode, log[-4000:])
               for r, (p, log) in enumerate(zip(procs, logs))
               if p.returncode != 0]
        if bad:
            raise AssertionError(f"parallel workers failed: {bad}")
        return [json.loads((Path(tmp) / f"rank{r}.json").read_text())
                for r in range(PAR_WORLD)]


def phase_parallel(dev, k2: dict) -> dict:
    """The scale-out package on the card (see PAR_B above). Fails unless
    the NCCL step is bit-equal to the ungrouped one with K2 and K1 one
    launch each, and every gloo rank launched K2, K1 and K4 and held its
    blocks against one rank: the step bit-equal (else within PAR_BAR,
    aggregates equal), sharded_whisper_mel bit-equal, the serving tick
    within the JAX bars (valid exact, q one step, at most one VA flip a
    tick, lo and hi within PAR_BAR), the checkpoint resumed bit for bit,
    multihost_frontend's blocks as the step's; and unless every block,
    the NCCL step's too, holds against the one-rank run on the plain
    versions (PAR_B's comment)."""
    bars = (k2["wbars"]["vs_plain"], k2["lbars"]["vs_plain"])
    t0 = time.perf_counter()
    nccl = parallel_nccl(dev, bars)
    emit("parallel_nccl", **nccl)
    t1 = time.perf_counter()
    ranks = parallel_gloo(bars)
    for r in ranks:
        emit("parallel_rank", **r)
    out = dict(nccl=nccl, ranks=ranks, nccl_seconds=t1 - t0,
               gloo_seconds=time.perf_counter() - t1,
               seconds=time.perf_counter() - t0)
    emit("parallel", seconds=out["seconds"],
         nccl_seconds=out["nccl_seconds"], gloo_seconds=out["gloo_seconds"],
         bars=dict(zip(("whisper_vs_plain", "ln_vs_plain"), bars)),
         step_ms={"ungrouped": nccl["ungrouped_ms"], "nccl": nccl["step_ms"],
                  **{f"rank{r['rank']}": r["step_ms"] for r in ranks}},
         tick_ms={f"rank{r['rank']}": r["tick_ms"] for r in ranks},
         allreduce_ms={"nccl": nccl["allreduce_ms"],
                       **{f"rank{r['rank']}": r["allreduce_ms"]
                          for r in ranks}},
         launches={f"rank{r['rank']}": r["launches_total"] for r in ranks})
    fails = []
    if (not nccl["bit_equal"] or nccl["vs_plain_failed"]
            or (nccl["launches"]["K1"], nccl["launches"]["K2"]) != (1, 1)):
        fails.append(f"nccl {nccl['launches']} {nccl['held']} "
                     f"vs plain {nccl['vs_plain']}")
    for r in ranks:
        c = r["launches"]
        if (c["step"]["K2"], c["step"]["K1"]) != (1, 1) \
                or c["whisper_mel"]["K1"] != 1 \
                or c["serving"]["K4"] < PAR_TICKS \
                or c["serving"]["K1"] < PAR_TICKS \
                or (c["multihost"]["K2"], c["multihost"]["K1"]) != (1, 1):
            fails.append(f"rank {r['rank']} launches {c}")
        if blocks_failed(r["step"]) \
                or step_errs_failed(r["step_vs_plain"], *bars):
            fails.append(f"rank {r['rank']} step {r['step']} "
                         f"vs plain {r['step_vs_plain']}")
        sv, wm, mh = r["serving"], r["whisper_mel"], r["multihost"]
        if (not wm["equal"] or wm["vs_plain"] > bars[0]
                or sv["failed_ticks"] or sv["vs_plain"]["failed_ticks"]
                or not sv["resumed_bit_equal"] or sv["valid_frames"] == 0
                or sv["whole_fleet_rows"] != PAR_STREAMS
                or mh["aggregates"] != mh["one_rank"]
                or blocks_failed(mh["held"])
                or step_errs_failed(mh["vs_plain"], *mh["bars"])):
            fails.append(f"rank {r['rank']}: whisper {wm}, serving {sv}, "
                         f"multihost {mh}")
    if fails:
        raise AssertionError(f"phase parallel: {fails}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--parallel-worker"]:
        return parallel_worker(int(sys.argv[2]), int(sys.argv[3]),
                               Path(sys.argv[4]))
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    smi = phase_device()
    phase_build()
    rows = phase_k1_vs_plain(dev)
    phase_gates(dev)
    main = phase_main_path(dev, rows)
    rows = rows + [main["errs"]]
    rs_rows = phase_k3_k4_vs_plain(dev)
    serving, serving_rows = phase_serving_path(dev, rows)
    rows = rows + serving_rows
    phase_serving_profile(dev)
    bulk = phase_bulk(dev, rows)
    rows = rows + [bulk["k1_serving_errs"]]
    ln = phase_k1_ln_modes(dev)
    k2 = phase_k2(dev, rows, ln["rows"])
    widths = phase_k1_widths(dev, rows, ln["rows"])
    front = phase_frontend_step(dev, k2)
    framed_rows = phase_framed_vs_plain(dev)
    ozaki_power = phase_ozaki_power(dev)
    dial = phase_framed_main_path(dev, framed_rows, rows)
    epi = phase_k1_epilogues_vs_plain(dev, rows)
    wire = phase_vad_wire_path(dev, rows)
    ten_vad = phase_ten_vad_eval(dev)
    probe = phase_load_probe(dev)
    phase_live_stream(dev)
    serve = phase_serve_streams(dev)
    par = phase_parallel(dev, k2)
    k1_rows = rows + widths["rows"] + [dial["auto"]["auto_1024"]]
    k1_ln_rows = ln["rows"] + widths["ln_rows"]
    vs_plain = max(r["vs_plain"] for r in k1_rows + k1_ln_rows)
    by_path = {"batch": {"K1": main["launches"]}, **serving,
               "frontend": front["counts"]["large_v3_30s"],
               "frontend_80": front["counts"]["jax_defaults_10s"],
               **{f"dial_{k}": v for k, v in dial["counts"].items()},
               **dial["auto_counts"],
               **{f"vad_wire_{k}": v["launches"] for k, v in wire.items()},
               **{f"ten_vad_{k}": v["launches"]
                  for k, v in ten_vad.items()},
               "load_probe": {"P1": sum(probe["counts"].values())}}
    serve_paths = {"serve_streams_sig_48k": serve["run_a"]["launches"],
                   "serve_streams_rdft_8k": serve["run_b"]["launches"]}
    par_paths = {"parallel_nccl": par["nccl"]["launches"],
                 **{f"parallel_gloo_rank{r['rank']}": r["launches_total"]
                    for r in par["ranks"]}}
    by_path.update(serve_paths, **par_paths)
    framed_all = framed_rows + dial["rows"]

    def launches(name):
        return sum(c.get(name, 0) for c in by_path.values())

    w128 = wire[128]
    epilogues = {e: dict(launches=launches(f"K1_{e}"),
                         ms=w128["ms"][f"k1_{e}"],
                         call_ms=w128["ms"][call],
                         whisper_ms=w128["ms"]["k1"],
                         plain_ms=w128["ms"][f"plain_{e}"],
                         bound_ms=w128["bound"][e]["bound_ms"],
                         bound_by=w128["bound"][e]["bound_by"],
                         shape=w128["shape"], n_mels=128)
                 for e, call in (("quant", "whisper_mel_quantized"),
                                 ("vad", "whisper_mel_vad_sig"))}
    epilogues["quant"]["max_abs_err"] = epi["worst"]["range_vs_plain"]
    epilogues["quant"]["q_max_step"] = epi["worst"]["q_max_step"]
    epilogues["vad"]["max_abs_err"] = max(w["vad_err"]["max_abs_err"]
                                          for w in wire.values())
    flat_span = probe["modes"]["flat_span"]
    rs_err = max(max(r["vs_plain"] for r in rs_rows),
                 bulk["errs"]["k4_vs_plain"], bulk["errs"]["tick_vs_plain"])
    common = dict(route="cuda", source=RS_SOURCE, max_abs_err=rs_err,
                  max_abs_vs_exact=max(r["vs_exact"] for r in rs_rows),
                  precision=bulk["precision"], bound_ms=bulk["bound_ms"],
                  bound_by=bulk["bound_by"],
                  library_ms=bulk["ms"]["library"],
                  library_call_ms=bulk["call_ms"]["library"],
                  shape=[bulk["shape_buf"], bulk["shape_chunks"]],
                  tile={f: bulk["tile"][f] for f in ("threads", "r",
                                                     "windows", "items",
                                                     "grid")})

    def rs_entry(name, key):
        return dict(common, name=name, launches=launches(name),
                    launches_by_path={k: by_path[k][name]
                                      for k in (*serving, *serve_paths,
                                                *par_paths)},
                    ms=bulk["ms"][key], call_ms=bulk["call_ms"][key],
                    share_of_bound=bulk["share_of_bound"][key],
                    ms_bf3=bulk["ms"][f"{key}_bf3"],
                    call_ms_bf3=bulk["call_ms"][f"{key}_bf3"],
                    share_of_bound_bf3=bulk["share_of_bound_bf3"][key],
                    plain_ms=bulk["plain_ms"][key],
                    **{f"tick_{t.split('_', 1)[1]}": v
                       for t, v in bulk["tick"].items()
                       if t.startswith(key)})
    print(json.dumps({"kernels": [{
        "name": "K1", "route": "cuda", "source": K1_SOURCE,
        "replaces": K1_REPLACES, "launches": launches("K1"),
        "launches_by_path": {k: v.get("K1", 0) for k, v in by_path.items()},
        "max_abs_err": vs_plain, "max_abs_vs_plain": vs_plain,
        "max_abs_vs_exact": max(r["vs_exact"]
                                for r in k1_rows + k1_ln_rows),
        "f32_floor": max(r["plain_vs_exact"] for r in k1_rows),
        "f32_floor_ln": max(r["plain_vs_exact"] for r in k1_ln_rows),
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "share_of_bound": main["bound_ms"] / main["ms"],
        "library_ms": None,
        "library_composition_ms": main["library_composition_ms"],
        **{k: main[k] for k in ("block_frames", "chunk_cols")},
        "dft_mma": DFT_MMA,
        "widths_refused": widths["refused"],
        "serving_bulk_ms": bulk["k1_serving_ms"],
        "ln_modes": {k: {f: v[f] for f in ("ms", "plain_ms", "bound_ms",
                                           "bound_by",
                                           "library_composition_ms")}
                     for k, v in ln["times"].items()},
        "epilogues": epilogues,
    }, {
        "name": "K2", "route": "cuda", "source": K2_SOURCE,
        "replaces": K2_REPLACES, "launches": launches("K2"),
        "launches_by_path": {k: v.get("K2", 0) for k, v in by_path.items()},
        "max_abs_err": k2["max_abs_err"],
        "ms": front["k2_times"]["ms"], "plain_ms": front["k2_times"]["plain_ms"],
        "bound_ms": front["k2_times"]["bound_ms"],
        "bound_by": front["k2_times"]["bound_by"], "library_ms": None,
        "library_composition_ms": front["k2_times"]["library_composition_ms"],
        "shape": front["k2_times"]["shape"],
        **{k: front["k2_times"][k] for k in ("share_of_bound",
                                             "block_frames", "chunk_cols")},
        "dft_mma": DFT_MMA,
    }, dict(rs_entry("K3", "k3"), replaces=K3_REPLACES),
        dict(rs_entry("K4", "k4"), replaces=K4_REPLACES,
             bound_ops_bf3_ms=bulk["bound_ops_bf3_ms"],
             bound_ops_bf3_simt_ms=bulk["bound_ops_bf3_simt_ms"])] + [{
        "name": t["kernel"], "route": "cuda", "source": FRAMED_SOURCE,
        "replaces": FRAMED_REPLACES[t["kernel"]], "impl": impl,
        "launches": launches(t["kernel"]),
        "launches_by_path": {k: v.get(t["kernel"], 0)
                             for k, v in by_path.items()
                             if v.get(t["kernel"], 0)},
        "max_abs_err": max(r["vs_plain"] for r in framed_all
                           if r["impl"] == impl),
        "max_abs_vs_plain": max(r["vs_plain"] for r in framed_all
                                if r["impl"] == impl),
        "max_abs_vs_exact": max(r["vs_exact"] for r in framed_all
                                if r["impl"] == impl),
        "f32_floor": dial["bars"][impl]["f32_floor"],
        "ms": t["ms"], "call_ms": t["call_ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": None,
        "library_composition_ms": t["library_composition_ms"],
        "shape": [t["frames"], 512],
        "dft_mma": framed_ozaki.MMA[impl],
        "block_frames": t["block_frames"],
        "block_frames_by_taps": t["block_frames_by_taps"],
        "share_of_bound": t["share_of_bound"],
        **({"power_bit_equal": ozaki_power["equal"]}
           if impl in framed_mel.OZAKI else {}),
        **({"bound_simt_ms": t["bound_simt_ms"]} if impl == "f32" else {}),
    } for impl, t in dial["times"].items()] + [{
        "name": "P1", "route": "cuda", "source": P1_SOURCE,
        "replaces": P1_REPLACES, "launches": launches("P1"),
        "launches_by_mode": probe["counts"],
        "max_abs_err": max(r["max_abs_err"]
                           for r in probe["modes"].values()),
        "ms": flat_span["ms"], "plain_ms": flat_span["plain_ms"],
        "bound_ms": flat_span["bound_ms"], "bound_by": "bytes",
        "library_ms": None, "shape": flat_span["shape"],
        "modes": {m: {f: r[f] for f in ("ms", "plain_ms", "gb_per_s",
                                        "share_of_peak", "bound_ms",
                                        "shape")}
                  for m, r in probe["modes"].items()},
    }]}), flush=True)
    emit("done", seconds=round(time.perf_counter() - t0, 1))
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
