"""K3 and K4: polyphase resampling of many streams — the CUDA kernel
(``csrc/resample.cu``), its plain PyTorch version, the eligibility rule,
the tile geometry, and the wrappers that pick between kernel and plain
version by the device the signal lies on.

Replaces ``melspec_tpu/ops/resample.py::pallas_resample`` (K3, over a
signal ``[S, T]``) and ``::pallas_resample_pair`` (K4, over the virtual
``concat(buf [S, L], chunks [S, n])`` without building it). Both compute
``out[s, w*up + p] = sum_j x[s, w*down + j] * G[j, p]`` for ``w < q``,
with ``G`` the m = 1 phase matrix; ``precision="bf3"`` uses the bf16
slices ``x0 + x1`` and ``g0 + g1`` and drops ``x1*g1``. K4 over ``(buf,
chunks)`` is bit-identical to K3 over their concat.

``tile`` is the one place the kernel's geometry is decided (windows a
thread and a tile, block size, span buffers and their layout, shared
memory, items and grid); the launcher passes it to the kernel, which
checks it. ``kernel_eligible`` and ``pair_eligible`` are the rules the
launchers themselves apply (a shape they reject raises there); the
streaming resampler asks the same functions to route a tick and then
calls ``resample_routed``, which does not ask again. The rules come from
the CUDA kernel's limits (the phase matrix and a tile's input span in one
block's shared memory), not from the TPU's lane and sublane tiling.
``launches`` counts kernel launches by name; nothing else adds to it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from melspec_tpu_torch.kernels import build
from melspec_tpu_torch.ops.hp_dft import bf16_round_slices
from melspec_tpu_torch.ops.resample import _phase_matrix

# dynamic shared memory a block may use on Hopper (227 KB)
MAX_SMEM_BYTES = 232448
# csrc/resample.cu's register-tiled instances, by (up, down, K): the
# serving fleets' ratios 48 kHz, 8 kHz and 32 kHz -> 16 kHz, with TILED_R
# windows a thread (kTiledR); every other ratio runs the generic instance
# (one window a thread)
TILED = frozenset({(1, 3, 61), (2, 1, 21), (1, 2, 41)})
TILED_R = 8
# floats of G a tiled instance takes in its parameters (kMaxParamG)
MAX_PARAM_G = 128
# block sizes, largest first (kMaxThreads = 64); a shape keeps the
# largest block that still gives TILES_PER_SM tiles per SM. A persistent
# grid holds as many blocks per SM as one SM runs at once (the launcher
# asks the built kernel), RESIDENT_THREADS threads' worth where nobody
# asked (the kernel's __launch_bounds__(64, 8) allows at least that)
THREADS = (64, 32)
TILES_PER_SM = 4
RESIDENT_THREADS = 512
H100_SMS = 132
# a ratio whose G leaves no room for the preferred tiles: one buffer, no
# pad words, down to 4 windows a tile (the first version's smallest)
FALLBACK_WINDOWS = (32, 16, 8, 4)

launches = {"K3": 0, "K4": 0}


class Tile(NamedTuple):
    """One launch's geometry (``csrc/resample.cu``'s ``Launch``)."""

    threads: int  # a block's threads
    r: int        # windows a thread
    windows: int  # windows a tile (threads * r, or fewer in a fallback)
    nbuf: int     # span buffers: 2 lets the next item's copies overlap
    pad: int      # pad words after every r*down span samples
    span: int     # samples a tile reads: (windows - 1)*down + K
    stride: int   # floats of shared memory a span buffer takes
    g_len: int    # floats of G in shared memory (16-byte multiple; 0
    #               where G rides in the tiled kernel's parameters)
    smem: int     # bytes of dynamic shared memory
    tiles: int    # tiles a stream
    items: int    # (stream, tile) items
    grid: int     # blocks; block b walks items b, b + grid, ...


def _bf3(precision: str) -> bool:
    if precision not in ("highest", "bf3"):
        raise ValueError("precision must be 'highest' or 'bf3'")
    return precision == "bf3"


def slot(u: int, r: int, down: int, pad: int) -> int:
    """The shared-memory word of span sample ``u`` (``resample.cu::slot``):
    one pad word after every ``r*down`` samples, a thread's stride through
    the span, so that lanes read words an odd stride apart."""
    return u + u // (r * down) * pad


def _layout(up: int, down: int, k: int, bf3: bool, threads: int, r: int,
            windows: int, nbuf: int, pad: int) -> tuple:
    """``(span, stride, g_len, smem)`` of one candidate geometry. The
    generic instance (``r == 1``) keeps G and bf3's x1 slice in shared
    memory; the tiled ones take G in their parameters."""
    span = (windows - 1) * down + k
    stride = slot(span - 1, r, down, pad) + 1
    g_len = -(-k * up * (2 if bf3 else 1) // 4) * 4 if r == 1 else 0
    x_slices = 2 if bf3 and r == 1 else 1
    return span, stride, g_len, 4 * (g_len + nbuf * stride * x_slices)


def _candidates(up: int, down: int, k: int) -> tuple:
    """``(preferred, fallback)`` geometries ``(threads, r, windows, nbuf,
    pad)``, each list largest first."""
    r = TILED_R if (up, down, k) in TILED else 1
    pad = 1 - (r * down) % 2
    preferred = [(t, r, t * r, 2, pad) for t in THREADS]
    fallback = [(THREADS[-1], 1, w, 1, 0) for w in FALLBACK_WINDOWS]
    return preferred, fallback


@functools.lru_cache(maxsize=256)
def tile(up: int, down: int, k: int, bf3: bool, n_streams: int = 1,
         q: int = 1, n_sm: int = H100_SMS,
         blocks_per_sm: Optional[int] = None) -> Optional[Tile]:
    """The kernel's geometry for ``n_streams`` streams of ``q`` windows
    on a card of ``n_sm`` SMs, or None where no tile fits a block's shared
    memory. Of the preferred geometries that fit, the largest block that
    leaves ``TILES_PER_SM`` tiles per SM, else the smallest (a tick of a
    few hops); the fallbacks only where none fits. The grid is
    ``blocks_per_sm`` blocks per SM (``RESIDENT_THREADS`` threads' worth
    where it is not given), or one block per item where there are
    fewer."""
    preferred, fallback = _candidates(up, down, k)

    def fits(c):
        return _layout(up, down, k, bf3, *c)[3] <= MAX_SMEM_BYTES

    fit = [c for c in preferred if fits(c)]
    if fit:
        pick = next((c for c in fit
                     if n_streams * -(-q // c[2]) >= TILES_PER_SM * n_sm),
                    fit[-1])
    else:
        pick = next((c for c in fallback if fits(c)), None)
        if pick is None:
            return None
    threads, r, windows, nbuf, pad = pick
    span, stride, g_len, smem = _layout(up, down, k, bf3, *pick)
    tiles = -(-q // windows)
    items = n_streams * tiles
    per_sm = blocks_per_sm or max(1, RESIDENT_THREADS // threads)
    grid = min(items, n_sm * per_sm)
    return Tile(threads, r, windows, nbuf, pad, span, stride, g_len, smem,
                tiles, items, grid)


@functools.lru_cache(maxsize=64)
def kernel_eligible(up: int, down: int, beta: float = 5.0,
                    precision: str = "highest") -> bool:
    """Whether K3 (and K4) take this gcd-reduced ratio: the phase matrix
    and one tile's input span must fit a block's shared memory. 44.1 kHz
    -> 16 kHz (up 160, down 441) has a 493 x 160 matrix, 315 KB in
    float32, and does not."""
    k = _phase_matrix(up, down, beta)[0].shape[0]
    return tile(up, down, k, _bf3(precision)) is not None


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


@functools.lru_cache(maxsize=32)
def _host_matrices(up: int, down: int, beta: float,
                   precision: str) -> ctypes.Array:
    """``resample_matrices``' values as the tiled instances take them in
    their parameters: float32, ``K*up`` (highest) or g0 then g1 (bf3,
    bf16 values, exact in float32)."""
    g = resample_matrices(up, down, beta, precision, torch.device("cpu"))
    flat = g.to(torch.float32).reshape(-1).tolist()
    return (ctypes.c_float * len(flat))(*flat)


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


class _Launch(ctypes.Structure):
    """``csrc/resample.cu``'s ``struct Launch``: the call's shape and its
    ``Tile``."""

    _fields_ = ([(n, ctypes.c_longlong) for n in (
        "la", "lb", "n_streams", "q", "tiles", "items")]
        + [(n, ctypes.c_int) for n in (
            "up", "down", "k", "bf3", "threads", "r", "windows", "nbuf",
            "pad", "span", "stride", "g_len", "smem", "grid")])


def _launch_of(t: Tile, up, down, k, bf3, s, q, la, lb) -> _Launch:
    return _Launch(la, lb, s, q, t.tiles, t.items, up, down, k, int(bf3),
                   t.threads, t.r, t.windows, t.nbuf, t.pad, t.span,
                   t.stride, t.g_len, t.smem, t.grid)


@functools.lru_cache(maxsize=64)
def launch_tile(up: int, down: int, k: int, bf3: bool, s: int, q: int,
                device_index: int) -> Tile:
    """The geometry the launcher uses on CUDA device ``device_index``:
    ``tile`` with the grid sized by the built kernel's blocks per SM at
    that tile (its registers, threads and shared memory)."""
    n_sm = sm_count(device_index)
    t = tile(up, down, k, bf3, s, q, n_sm)
    if t is None:
        raise ValueError(f"the {up}/{down} phase matrix does not fit one "
                         "block's shared memory")
    lib = _bound()
    # any signal long enough for the q windows: the query reads no shape
    probe = _launch_of(t, up, down, k, bf3, s, q, (q - 1) * down + k, 0)
    with torch.cuda.device(device_index):
        per_sm = lib.melspec_resample_blocks_per_sm(ctypes.byref(probe))
    if per_sm <= 0:
        msg = lib.melspec_resample_error_string(-per_sm).decode()
        raise RuntimeError(f"resample: no block of {t} fits an SM: {msg}")
    return tile(up, down, k, bf3, s, q, n_sm, per_sm)


@functools.lru_cache(maxsize=64)
def _plan(up: int, down: int, k: int, bf3: bool, s: int, q: int, la: int,
          lb: int, device_index: int) -> _Launch:
    """One call's ``Launch``, built once per shape and device (the cache
    keeps it alive while the library reads it)."""
    t = launch_tile(up, down, k, bf3, s, q, device_index)
    return _launch_of(t, up, down, k, bf3, s, q, la, lb)


@functools.lru_cache(maxsize=16)
def sm_count(index: int) -> int:
    """The SMs of CUDA device ``index`` (``tile``'s ``n_sm``)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _bound() -> ctypes.CDLL:
    lib = build.load("resample").lib
    p = ctypes.c_void_p
    launch = ctypes.POINTER(_Launch)
    lib.melspec_resample.argtypes = [
        launch, p, p, p, p, p,  # launch, a, b, g, g_host, out
        p,                      # stream
    ]
    lib.melspec_resample.restype = ctypes.c_int
    lib.melspec_resample_blocks_per_sm.argtypes = [launch]
    lib.melspec_resample_blocks_per_sm.restype = ctypes.c_int
    lib.melspec_resample_error_string.argtypes = [ctypes.c_int]
    lib.melspec_resample_error_string.restype = ctypes.c_char_p
    return lib


def _launch(name: str, a: torch.Tensor, b, g: torch.Tensor, g_host,
            up: int, down: int, q: int, precision: str) -> torch.Tensor:
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
    plan = _plan(up, down, k, bf3, s, q, la, lb, dev.index)
    lib = _bound()
    args = (ctypes.byref(plan), a.data_ptr(),
            None if b is None else b.data_ptr(), g.data_ptr(), g_host,
            out.data_ptr())
    if dev.index == torch.cuda.current_device():
        rc = lib.melspec_resample(*args,
                                  torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(dev):
            rc = lib.melspec_resample(
                *args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        msg = lib.melspec_resample_error_string(rc).decode()
        raise RuntimeError(f"{name} (resample) launch failed: {msg} ({rc})")
    launches[name] += 1
    return out


def resample_routed(a: torch.Tensor, b: Optional[torch.Tensor], up: int,
                    down: int, q: int, beta: float = 5.0,
                    precision: str = "highest") -> torch.Tensor:
    """K4 over ``(a, b)``, or K3 over ``a`` where ``b`` is None, for a
    caller that has already asked ``pair_eligible`` / ``kernel_eligible``
    (the streaming step, once a tick): the kernel on a CUDA signal, the
    plain version (on the concat) on a CPU one."""
    g = resample_matrices(up, down, float(beta), precision, a.device)
    if a.device.type == "cuda":
        return _launch("K3" if b is None else "K4", a, b, g,
                       _host_matrices(up, down, float(beta), precision), up,
                       down, q, precision)
    if a.device.type == "cpu":
        sig = a if b is None else torch.cat([a, b], dim=1)
        return resample_reference(sig, g, up, down, q, precision)
    raise ValueError(f"unsupported device {a.device}")


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
    return resample_routed(sig, None, up, down, q, beta, precision)


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
    return resample_routed(buf, chunks, up, down, q, beta, precision)
