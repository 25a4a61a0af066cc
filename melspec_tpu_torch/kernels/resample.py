"""K3 and K4: polyphase resampling of many streams — the CUDA kernel
(``csrc/resample.cu``), its plain PyTorch version, the eligibility rule
and the wrappers that pick between kernel and plain version by the device
the signal lies on.

Replaces ``melspec_tpu/ops/resample.py::pallas_resample`` (K3, over a
signal ``[S, T]``) and ``::pallas_resample_pair`` (K4, over the virtual
``concat(buf [S, L], chunks [S, n])`` without building it). Both compute
``out[s, w*up + p] = sum_j x[s, w*down + j] * G[j, p]`` for ``w < q``,
with ``G`` the m = 1 phase matrix; ``precision="bf3"`` uses the bf16
slices ``x0 + x1`` and ``g0 + g1`` and drops ``x1*g1``. K4 over ``(buf,
chunks)`` is bit-identical to K3 over their concat.

``kernel_eligible`` and ``pair_eligible`` are the rules the launchers
themselves apply (a shape they reject raises there); the streaming
resampler asks the same functions to route a tick. The rules come from
the CUDA kernel's limits (the phase matrix and a tile's input span in one
block's shared memory), not from the TPU's lane and sublane tiling.
``launches`` counts kernel launches by name; nothing else adds to it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from melspec_tpu_torch.kernels import build
from melspec_tpu_torch.ops.hp_dft import bf16_round_slices
from melspec_tpu_torch.ops.resample import _phase_matrix

# dynamic shared memory a block may use on Hopper (227 KB)
MAX_SMEM_BYTES = 232448
# csrc/resample.cu's block: threads (kThreads), and windows per thread
# (kWindows, the length of a thread's accumulator array)
THREADS = 256
WINDOWS = 4

launches = {"K3": 0, "K4": 0}


def _bf3(precision: str) -> bool:
    if precision not in ("highest", "bf3"):
        raise ValueError("precision must be 'highest' or 'bf3'")
    return precision == "bf3"


def tile(up: int, down: int, k: int, bf3: bool) -> tuple:
    """``(groups, g_len, shared bytes)`` of the kernel's block, the one
    place its tiling is decided (the launcher passes it to the kernel):
    ``groups`` window groups of ``WINDOWS`` windows (one phase per
    thread), G in ``g_len`` floats (padded to 16 bytes), then the tile's
    input span of ``(groups * WINDOWS - 1) * down + k`` samples (bf3: its
    two bf16 slices, as floats)."""
    groups = max(1, THREADS // up)
    span = (groups * WINDOWS - 1) * down + k
    g_len = -(-k * up * (2 if bf3 else 1) // 4) * 4
    return groups, g_len, 4 * (g_len + span * (2 if bf3 else 1))


def kernel_eligible(up: int, down: int, beta: float = 5.0,
                    precision: str = "highest") -> bool:
    """Whether K3 (and K4) take this gcd-reduced ratio: the phase matrix
    and one tile's input span must fit a block's shared memory. 44.1 kHz
    -> 16 kHz (up 160, down 441) has a 493 x 160 matrix, 315 KB in
    float32, and does not."""
    k = _phase_matrix(up, down, beta)[0].shape[0]
    return tile(up, down, k, _bf3(precision))[2] <= MAX_SMEM_BYTES


def pair_eligible(buf_len: int, n: int, up: int, down: int,
                  beta: float = 5.0, precision: str = "highest") -> bool:
    """Whether K4 takes ``(buf [S, buf_len], chunks [S, n])``: a ratio K3
    takes, and a chunk at least as long as the carried buffer — the
    streaming step carries ``chunks[:, n - buf_len:]`` to the next tick,
    which exists only then (a 1-hop tick at 48 kHz, n = 480 < L = 510,
    takes K3 over the concat)."""
    return n >= buf_len and kernel_eligible(up, down, beta, precision)


@functools.lru_cache(maxsize=32)
def resample_matrices(up: int, down: int, beta: float, precision: str,
                      device: torch.device) -> torch.Tensor:
    """The phase matrix as the kernel takes it, on ``device``: f32
    ``[K, up]`` (highest) or the bf16 slices ``[2, K, up]`` = ``(g0,
    g1)`` (bf3), rounded float64 -> float32 -> bf16 as the JAX package's
    ``_kernel_gcat`` rounds them."""
    g64, _ = _phase_matrix(up, down, beta)
    if _bf3(precision):
        g0, g1 = bf16_round_slices(g64, 2)
        g = torch.stack([g0, g1])
    else:
        g = torch.as_tensor(g64, dtype=torch.float32)
    return g.to(device)


def resample_reference(sig: torch.Tensor, g: torch.Tensor, up: int,
                       down: int, q: int, precision: str = "highest",
                       dot_dtype: torch.dtype = torch.float32
                       ) -> torch.Tensor:
    """The plain version, on whatever device ``sig`` lies on: ``sig [S,
    T]`` f32 -> ``[S, q*up]`` f32. The ``q`` windows (``unfold``) in one
    matmul against ``G`` (``g`` from ``resample_matrices``), or for bf3
    ``[x0 | x0 | x1] @ [g0; g1; g0]`` as the JAX kernel's K-concat dot.
    ``dot_dtype=torch.float64`` sums the products exactly (for bf3 they
    are exact bf16 x bf16 products)."""
    s = sig.shape[0]
    if q <= 0:
        return sig.new_zeros((s, 0))
    k = g.shape[-2]
    win = sig.to(torch.float32)[:, : (q - 1) * down + k].unfold(-1, k, down)
    if _bf3(precision):
        x0 = win.to(torch.bfloat16)
        x1 = (win - x0.to(torch.float32)).to(torch.bfloat16)
        lhs = torch.cat([x0, x0, x1], dim=-1)
        rhs = torch.cat([g[0], g[1], g[0]], dim=0)
    else:
        lhs, rhs = win, g
    y = lhs.to(dot_dtype) @ rhs.to(dot_dtype)
    return y.to(torch.float32).reshape(s, q * up)


@functools.cache
def _bound() -> ctypes.CDLL:
    lib = build.load("resample").lib
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.melspec_resample.argtypes = [
        p, ll, p, ll, ll, ll,  # a, la, b, lb, n_streams, q
        i, i, i, p, i,         # up, down, k, g, bf3
        i, i, ll,              # groups, g_len, smem (from tile)
        p, p,                  # out, stream
    ]
    lib.melspec_resample.restype = ctypes.c_int
    lib.melspec_resample_error_string.argtypes = [ctypes.c_int]
    lib.melspec_resample_error_string.restype = ctypes.c_char_p
    return lib


def _launch(name: str, a: torch.Tensor, b, g: torch.Tensor, up: int,
            down: int, q: int, precision: str) -> torch.Tensor:
    dev = a.device
    bf3 = _bf3(precision)
    for t in (a, b):
        if t is not None and (t.dtype != torch.float32 or t.dim() != 2
                              or t.device != dev):
            raise ValueError(f"{name} takes [S, T] float32 signals on one "
                             "device")
    want = ((torch.bfloat16, 3) if bf3 else (torch.float32, 2))
    if (g.dtype, g.dim()) != want or g.device != dev or g.shape[-1] != up:
        raise ValueError(f"{name}: the phase matrix must come from "
                         "resample_matrices for this ratio and precision")
    k = g.shape[-2]
    s = a.shape[0]
    la = a.shape[1]
    lb = 0 if b is None else b.shape[1]
    if b is not None and b.shape[0] != s:
        raise ValueError("buf and chunks must share the stream axis")
    if q > 0 and (q - 1) * down + k > la + lb:
        raise ValueError(f"{name}: {q} windows need {(q - 1) * down + k} "
                         f"samples; the signal has {la + lb}")
    out = torch.empty((s, max(q, 0) * up), dtype=torch.float32, device=dev)
    if s == 0 or q <= 0:
        return out
    a = a.contiguous()
    b = None if b is None else b.contiguous()
    g = g.contiguous()
    groups, g_len, smem = tile(up, down, k, bf3)
    lib = _bound()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.melspec_resample(
            a.data_ptr(), la, None if b is None else b.data_ptr(), lb, s, q,
            up, down, k, g.data_ptr(), int(bf3), groups, g_len, smem,
            out.data_ptr(), stream)
    if rc != 0:
        msg = lib.melspec_resample_error_string(rc).decode()
        raise RuntimeError(f"{name} (resample) launch failed: {msg} ({rc})")
    launches[name] += 1
    return out


def _check_ratio(name: str, up: int, down: int, beta: float,
                 precision: str) -> None:
    if not kernel_eligible(up, down, beta, precision):
        raise ValueError(f"{name}: the {up}/{down} phase matrix does not "
                         "fit one block's shared memory; use the conv route")


def resample(sig: torch.Tensor, up: int, down: int, q: int,
             beta: float = 5.0, precision: str = "highest") -> torch.Tensor:
    """K3: ``q`` windows of ``sig [S, T]`` -> ``[S, q*up]``; the kernel on
    a CUDA signal, the plain version on a CPU one."""
    _check_ratio("K3", up, down, beta, precision)
    g = resample_matrices(up, down, float(beta), precision, sig.device)
    if sig.device.type == "cuda":
        return _launch("K3", sig, None, g, up, down, q, precision)
    if sig.device.type == "cpu":
        return resample_reference(sig, g, up, down, q, precision)
    raise ValueError(f"unsupported device {sig.device}")


def resample_pair(buf: torch.Tensor, chunks: torch.Tensor, up: int,
                  down: int, q: int, beta: float = 5.0,
                  precision: str = "highest") -> torch.Tensor:
    """K4: K3 over ``concat(buf, chunks)`` without building it on the
    card (on the CPU the plain version runs on the concat)."""
    if not pair_eligible(buf.shape[1], chunks.shape[1], up, down, beta,
                         precision):
        raise ValueError(
            f"K4 takes chunks at least as long as the carried buffer "
            f"({chunks.shape[1]} < {buf.shape[1]}) and a ratio K3 takes; "
            "use K3 over the concat or the conv route")
    g = resample_matrices(up, down, float(beta), precision, buf.device)
    if buf.device.type == "cuda":
        return _launch("K4", buf, chunks, g, up, down, q, precision)
    if buf.device.type == "cpu":
        return resample_reference(torch.cat([buf, chunks], dim=1), g, up,
                                  down, q, precision)
    raise ValueError(f"unsupported device {buf.device}")
