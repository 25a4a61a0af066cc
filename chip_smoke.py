#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from the sources in this checkout,
holds each against its plain PyTorch version on the card, checks the
accuracy gates through the kernels, and drives the main path — raw
``[B, T]`` audio -> whisper large-v3 log-mel through
``WhisperMelPipeline.mel_batch`` — at full width, with launch counts that
show the path went through the kernels. Each phase prints one JSON line.
Any failure raises and the script exits non-zero without its last line;
on success the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
It exits non-zero at once where CUDA is not available.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from melspec_tpu_torch import (WHISPER_LARGE_V3, WhisperMelPipeline,  # noqa: E402
                               compute_streaming_mel, read_wav_f32le,
                               whisper_mel_sig)
from melspec_tpu_torch.kernels import build, sig_mel  # noqa: E402
from melspec_tpu_torch.ops import framing, mel_kernel  # noqa: E402
from melspec_tpu_torch.ops.filterbank import mel_filterbank  # noqa: E402
from melspec_tpu_torch.ops.windows import hann_periodic  # noqa: E402

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
# tensor-core rate and HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
K1_SOURCE = "melspec_tpu_torch/csrc/sig_mel.cu"
K1_REPLACES = "melspec_tpu/ops/mel_kernel.py:1547"


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def time_ms(fn, reps: int = 7, warmup: int = 2) -> float:
    """Median over ``reps`` runs of one call's device time (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def signal(rng, b: int, t: int, dev) -> torch.Tensor:
    return torch.from_numpy(
        (rng.normal(size=(b, t)) * 0.2).astype(np.float32)).to(dev)


def k1_plain(x, fft, hop, n_mels, streaming, dev, dot_dtype=torch.float32):
    """K1's plain version on the same inputs and matrices; with
    ``dot_dtype=torch.float64`` the exact result."""
    mats = mel_kernel.sig_matrices(fft, n_mels, 16000.0, 3, 2, dev)
    if streaming:
        offset = framing.streaming_frame_offset(fft, hop)
        nf = framing.num_frames_streaming(x.shape[-1], fft, hop)
    else:
        offset, nf = 0, framing.num_frames_batch(x.shape[-1], fft, hop)
    return sig_mel.sig_mel_reference(
        x, mats.m_big, mats.pair_i, mats.mt_bf2, ks=3, n_frames=nf,
        hop=hop, offset=offset, pack=fft, n_bins_pad=mats.n_bins_pad,
        n_mels=n_mels, mel_precision="bf2", dot_dtype=dot_dtype)


def max_abs(a, b) -> float:
    return float((a - b).abs().max()) if a.numel() else 0.0


def compare(got, x, fft, hop, n_mels, streaming, dev) -> dict:
    """K1's output against its plain version and the exact result."""
    plain = k1_plain(x, fft, hop, n_mels, streaming, dev)
    exact = k1_plain(x, fft, hop, n_mels, streaming, dev, torch.float64)
    torch.cuda.synchronize()
    if got.shape != plain.shape:
        raise AssertionError(f"shape {tuple(got.shape)} vs "
                             f"{tuple(plain.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError("K1 output is not finite")
    return dict(vs_plain=max_abs(got, plain), vs_exact=max_abs(got, exact),
                plain_vs_exact=max_abs(plain, exact),
                n_over_tol_k1=int(((got - exact).abs() > K1_TOL).sum()),
                n_over_tol_plain=int(((plain - exact).abs() > K1_TOL).sum()))


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
    built = build.load_all(["sig_mel"])
    seconds = time.perf_counter() - t0
    report = [ln.strip() for ln in built["sig_mel"].log.splitlines()
              if "registers" in ln or "spill" in ln]
    emit("build", kernels=sorted(built), seconds=round(seconds, 3),
         ptxas=report)


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
                errs = compare(got, x, fft, hop, n_mels, streaming, dev)
                rows.append(dict(config=[fft, hop, n_mels],
                                 streaming=streaming, shape=[b, t],
                                 out_shape=list(got.shape), **errs))
    bars = tolerances(rows)
    worst = {k: max(r[k] for r in rows)
             for k in ("vs_plain", "vs_exact", "plain_vs_exact")}
    emit("k1_vs_plain", bars=bars, max_abs_err=worst,
         n_over_tol_k1=sum(r["n_over_tol_k1"] for r in rows),
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
    errs = compare(out, x, c.fft_size, c.hop_size, c.n_mels, False, dev)
    bars = tolerances(rows + [errs])
    check([errs], bars, "main path")

    mats = mel_kernel.sig_matrices(c.fft_size, c.n_mels, c.sampling_rate,
                                   3, 2, dev)
    kw = dict(ks=3, n_frames=nf, hop=c.hop_size, offset=0, pack=c.fft_size,
              n_bins_pad=mats.n_bins_pad, n_mels=c.n_mels,
              mel_precision="bf2")
    pipe_ms = time_ms(lambda: pipe.mel_batch(x))
    k1_ms = time_ms(lambda: sig_mel.sig_mel(x, mats.m_big, mats.pair_i,
                                            mats.mt_bf2, **kw))
    plain_ms = time_ms(lambda: sig_mel.sig_mel_reference(
        x, mats.m_big, mats.pair_i, mats.mt_bf2, **kw))
    lib = library_mel(x, c.fft_size, c.hop_size, c.n_mels)
    lib_ms = time_ms(lib)
    lib_err = float((lib() - out).abs().max())

    # the function's work, not the kernel's: per frame, the slice-pair
    # blocks' taps against the n_bins re columns and the im columns that
    # are not identically zero, then the bf2 projection's three products
    # per (bin, mel); the zero pad columns K1 also multiplies are not counted
    frames = b * nf
    n_bins = c.fft_size // 2
    dft_cols = n_bins + len(mel_kernel.sig_packed_im_bins(c.fft_size,
                                                          n_bins))
    flops = frames * (2 * len(mats.pair_i) * c.fft_size * dft_cols
                      + 2 * 3 * n_bins * c.n_mels)
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
         flops=flops, bytes=nbytes, bound_ops_ms=t_ops, bound_bytes_ms=t_bytes)

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
                library_composition_ms=lib_ms)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    smi = phase_device()
    phase_build()
    rows = phase_k1_vs_plain(dev)
    phase_gates(dev)
    main = phase_main_path(dev, rows)
    rows = rows + [main["errs"]]
    vs_plain = max(r["vs_plain"] for r in rows)
    print(json.dumps({"kernels": [{
        "name": "K1", "route": "cuda", "source": K1_SOURCE,
        "replaces": K1_REPLACES, "launches": main["launches"],
        "max_abs_err": vs_plain, "max_abs_vs_plain": vs_plain,
        "max_abs_vs_exact": max(r["vs_exact"] for r in rows),
        "f32_floor": max(r["plain_vs_exact"] for r in rows),
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": None,
        "library_composition_ms": main["library_composition_ms"],
    }]}), flush=True)
    emit("done", seconds=round(time.perf_counter() - t0, 1))
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
