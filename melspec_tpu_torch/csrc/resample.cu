// K3 and K4 for Hopper (sm_90a): polyphase rational resampling of S
// streams, one launch for all of them.
//
// Replaces the TPU kernels melspec_tpu/ops/resample.py::pallas_resample
// (K3, over a signal [S, T]) and ::pallas_resample_pair (K4, over the
// virtual concat(buf [S, L], chunks [S, n]) that the streaming resampler
// would otherwise build). For stream s, window w < q and phase p < up:
//
//   out[s, w*up + p] = sum_{j < K} x[s, w*down + j] * G[j, p]
//
// with x the (virtual) signal and G the m = 1 phase matrix
// (melspec_tpu_torch/ops/resample.py::_phase_matrix), float32. Precision
// "bf3" forms x0 = bf16(x), x1 = bf16(x - x0) here and takes g0, g1 (the
// host's float64 -> float32 -> bf16 slices of G) and sums
// x0*g0 + x0*g1 + x1*g0 per tap; each product of two bf16 values is exact
// in float32. "highest" sums x*G in float32. Every output is one fmaf
// chain over the taps in order j = 0 .. K-1 from 0.0f, so the outputs do
// not depend on the tiling.
//
// K3 and K4 are one kernel: staging reads sample i of the virtual signal
// from `a` when i < la and from `b` otherwise. K3 passes the signal as
// `a` (la = T, lb = 0). The staged floats, and so every output, of K4
// over (buf, chunks) equal K3's over their concat bit for bit.
//
// What bounds it: bytes. Per output it reads `down / up` input samples
// and writes one value (48 kHz -> 16 kHz: 12 + 4 bytes) against 2K = 122
// FLOPs (366 in bf3): 7.6 FLOP a byte, under the H100's float32 balance
// without tensor cores (67 TFLOP/s over 3.35 TB/s, 20 FLOP a byte), so
// plain FMAs can outrun the bytes; a tensor-core (Toeplitz) form would pay
// for a banded matrix several times denser than the taps. With one
// shared-memory read an FMA, shared-memory traffic would bind the taps
// well before the bytes do. What the design does:
//
// - Register tiling. Thread t of a tile computes R = 8 consecutive
//   windows (all their `up` phases). Sample u of the thread's span serves
//   tap u - r*down of its window r, so each sample read from shared
//   memory feeds up to R*up FMAs, and is (bf3) cut into its slices once.
//   The serving ratios (1, 3), (2, 1), (1, 2) are template instances with
//   up, down and K fixed and the tap walk unrolled; their G rides in the
//   kernel's parameters, so the FMAs read it from the constant bank.
//   Every other ratio runs the generic instance (a thread a window, its
//   phases in turn, G in shared memory; bf3 cuts the span's slices in one
//   pass over shared memory).
// - No bank conflicts. Thread t's span starts at t*R*down; the span is
//   laid out with one pad word after every R*down samples where that is
//   even, so lanes read words an odd stride apart: conflict-free at
//   every down, (1, 2) included.
// - Asynchronous staging. A tile's span is copied by cp.async, 4 bytes a
//   lane (the state rows, [S, 510] at 48 kHz, are not 16-byte aligned;
//   nor is K3's concat; 16-byte copies would also break the pad words),
//   all of a tile's copies in flight before one wait. The copy loop runs
//   in three parts (from buf below la, from chunks, zero-fill past the
//   signal's end), a few integer operations a copy.
// - Tiles sized to the shape, and a persistent walk. The launcher
//   (kernels/resample.py::tile) picks 64- or 32-thread blocks so that a
//   tick of a few hops still has several tiles per SM, and a grid of as
//   many blocks as the SMs hold at once (the occupancy query below); each
//   block walks (stream, tile) items with the next item's span in flight
//   (a second buffer) while it computes this one.
// - Outputs leave as 16-byte stores of a thread's R*up contiguous values
//   where the row allows, else as scalars.
//
// Measured on an H100 80GB HBM3 at 700 W (PERF.md §6; the cuts of
// kernels/resample_probe.py): the span copies are the larger part of the
// time; without them the FMAs, reads and stores take about half of it.
//
// Plain C interface, built with nvcc and bound with ctypes
// (melspec_tpu_torch/kernels/resample.py). Every launch is followed by
// cudaGetLastError, and its code is returned. cudaFuncSetAttribute runs
// once per instance, device and larger shared-memory size.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

// One launch: the call's shape and kernels/resample.py::tile's geometry
// (the ctypes Structure `_Launch` there has the same fields in this
// order). Outside the anonymous namespace: the exported function takes it.
struct MelspecResampleLaunch {
  long long la, lb, n_streams, q, tiles, items;
  int up, down, k, bf3;
  int threads, r, windows, nbuf, pad, span, stride, g_len, smem, grid;
};

namespace {

using Launch = MelspecResampleLaunch;

constexpr int kMaxThreads = 64;
constexpr int kTiledR = 8;  // windows a thread in the tiled instances
// G of the tiled instances rides in the kernel's parameters (up to
// 2 * 61 floats: bf3 at 48 kHz), read as constant-bank FMA operands
constexpr int kMaxParamG = 128;

struct Params {
  const float* a;  // [S, la]
  const float* b;  // [S, lb]
  const void* g;   // f32 [K, up], or bf16 [2, K, up] (g0, g1)
  float* out;      // [S, q*up]
  long long la, lb, q, tiles, items;
  int up, down, k, windows, nbuf, pad, span, stride, g_len, vec;
  float gp[kMaxParamG];  // tiled instances: G, or g0 then g1, as floats
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile(
      "cp.async.ca.shared.global.L2::128B [%0], [%1], 4, %2;\n" ::"r"(d),
      "l"(src), "r"(valid ? 4 : 0)
      : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Shared-memory word of span sample u: one pad word after every `chunk`
// samples (chunk = R*down, a thread's stride through the span).
__device__ __forceinline__ int slot(int u, int chunk, int pad) {
  return u + (u / chunk) * pad;
}

// Issue the copies of item `it`'s span into `dst`; no wait. Span sample
// u (signal sample i0 + u) comes from `a` below na, from `b` below nv,
// and is zero-filled from nv on (past the signal's end): three loops, so
// that a copy costs a few integer operations beside its cp.async.
__device__ __forceinline__ void stage(const Params& p, long long it,
                                      float* dst, int chunk) {
  const long long s = it / p.tiles;
  const long long i0 = (it - s * p.tiles) * p.windows * p.down;
  const long long ea = p.la - i0, ev = p.la + p.lb - i0;
  const int na = ea <= 0 ? 0 : (ea >= p.span ? p.span : static_cast<int>(ea));
  const int nv = ev <= 0 ? 0 : (ev >= p.span ? p.span : static_cast<int>(ev));
  const float* pa = p.a + s * p.la + i0;           // u < na: pa[u]
  const float* pb = p.b + s * p.lb + (i0 - p.la);  // na <= u < nv: pb[u]
  // d = slot(u) = u + (u / chunk) * pad, kept with u's remainder r as u
  // steps by the block's threads
  const int step = blockDim.x;
  const int dstep = step + step / chunk * p.pad, rstep = step % chunk;
  int u = threadIdx.x;
  int r = u % chunk;
  int d = u + u / chunk * p.pad;
  auto next = [&] {
    u += step;
    d += dstep;
    r += rstep;
    if (r >= chunk) {
      r -= chunk;
      d += p.pad;
    }
  };
  for (; u < na; next()) cp_async4(dst + d, pa + u, true);
  for (; u < nv; next()) cp_async4(dst + d, pb + u, true);
  for (; u < p.span; next()) cp_async4(dst + d, p.out, false);  // no read
}

// The tiled instances: thread t takes windows w0 + t*R + r (r < R), every
// phase. Sample u of the thread's span (span index t*R*DOWN + u) is read
// from shared memory once, at the first tap that needs it, and (bf3) cut
// into its slices once.
template <int UP, int DOWN, int K, bool BF3>
__device__ __forceinline__ void compute_tiled(const Params& p,
                                              const float* sx, long long s,
                                              long long w0) {
  constexpr int R = kTiledR;
  constexpr int C = R * DOWN;
  constexpr int NG = (K + DOWN - 1) / DOWN;  // groups of DOWN taps
  constexpr int NX = (R - 1) * DOWN + K;     // samples a thread reads
  const int t = threadIdx.x;
  if (t * R >= p.windows) return;
  const float* xs = sx + t * (C + p.pad);
  float x0[NX], x1[NX];
  float acc[R][UP];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int ph = 0; ph < UP; ++ph) acc[r][ph] = 0.0f;

  auto load = [&](int u) {
    const float v = xs[u + (u / C) * p.pad];
    if (BF3) {
      x0[u] = bf16_round(v);
      x1[u] = bf16_round(__fsub_rn(v, x0[u]));
    } else {
      x0[u] = v;
    }
  };
#pragma unroll
  for (int u = 0; u < R * DOWN; ++u)
    if (u < NX) load(u);
#pragma unroll
  for (int m = 0; m < NG; ++m) {
    if (m > 0) {
      // the samples whose first tap is in group m
#pragma unroll
      for (int c = 0; c < DOWN; ++c)
        if ((m + R - 1) * DOWN + c < NX) load((m + R - 1) * DOWN + c);
    }
#pragma unroll
    for (int c = 0; c < DOWN; ++c) {
      const int j = m * DOWN + c;
      if (j < K) {
        float g0[UP], g1[UP];
#pragma unroll
        for (int ph = 0; ph < UP; ++ph) {
          g0[ph] = p.gp[j * UP + ph];
          if (BF3) g1[ph] = p.gp[K * UP + j * UP + ph];
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int u = (m + r) * DOWN + c;
#pragma unroll
          for (int ph = 0; ph < UP; ++ph) {
            if (BF3) {
              acc[r][ph] = fmaf(x0[u], g0[ph], acc[r][ph]);
              acc[r][ph] = fmaf(x0[u], g1[ph], acc[r][ph]);
              acc[r][ph] = fmaf(x1[u], g0[ph], acc[r][ph]);
            } else {
              acc[r][ph] = fmaf(x0[u], g0[ph], acc[r][ph]);
            }
          }
        }
      }
    }
  }

  const long long wb = w0 + static_cast<long long>(t) * R;
  float* o = p.out + (s * p.q + wb) * UP;
  if (p.vec && wb + R <= p.q) {
    // R*UP is a multiple of 4 and the launcher checked the alignment
#pragma unroll
    for (int v = 0; v < R * UP / 4; ++v) {
      const int e = 4 * v;
      reinterpret_cast<float4*>(o)[v] = make_float4(
          acc[e / UP][e % UP], acc[(e + 1) / UP][(e + 1) % UP],
          acc[(e + 2) / UP][(e + 2) % UP], acc[(e + 3) / UP][(e + 3) % UP]);
    }
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (wb + r < p.q) {
#pragma unroll
        for (int ph = 0; ph < UP; ++ph) o[r * UP + ph] = acc[r][ph];
      }
    }
  }
}

// The generic instance: any ratio, R = 1. Thread t takes window w0 + t,
// its phases in turn; its span starts at t*down (word t*(down + pad)).
// In bf3, sx holds the x0 slice and sx1 the x1 slice (cut by `cut`).
template <bool BF3>
__device__ __forceinline__ void compute_generic(const Params& p,
                                                const float* sx,
                                                const float* sx1,
                                                const float* sg, long long s,
                                                long long w0) {
  const int t = threadIdx.x;
  if (t >= p.windows) return;
  const long long w = w0 + t;
  const int step = p.down + p.pad;  // words between tap groups
  const int kg = p.k * p.up;
  for (int ph = 0; ph < p.up; ++ph) {
    float acc = 0.0f;
    int j = 0;
    for (int m = 0; j < p.k; ++m) {
      const int base = (t + m) * step;
      for (int c = 0; c < p.down && j < p.k; ++c, ++j) {
        const float g0 = sg[j * p.up + ph];
        if (BF3) {
          const float g1 = sg[kg + j * p.up + ph];
          const float x0 = sx[base + c];
          acc = fmaf(x0, g0, acc);
          acc = fmaf(x0, g1, acc);
          acc = fmaf(sx1[base + c], g0, acc);
        } else {
          acc = fmaf(sx[base + c], g0, acc);
        }
      }
    }
    if (w < p.q) p.out[(s * p.q + w) * p.up + ph] = acc;
  }
}

// bf3, generic instance: cut the staged span (the samples this thread
// copied) into x0 (in place) and x1.
__device__ __forceinline__ void cut(const Params& p, float* sx, float* sx1,
                                    int chunk) {
  for (int u = threadIdx.x; u < p.span; u += blockDim.x) {
    const int a = slot(u, chunk, p.pad);
    const float v = sx[a];
    const float x0 = bf16_round(v);
    sx[a] = x0;
    sx1[a] = bf16_round(__fsub_rn(v, x0));
  }
}

// UP = 0: the generic instance (up, down, K at run time).
template <int UP, int DOWN, int K, bool BF3>
__global__ void __launch_bounds__(kMaxThreads, 8)
    resample_kernel(const Params p) {
  constexpr bool kGeneric = UP == 0;
  extern __shared__ __align__(16) float smem[];
  float* sg = smem;  // G, or g0 then g1
  const int chunk = (kGeneric ? 1 : kTiledR) * (kGeneric ? p.down : DOWN);
  long long item = blockIdx.x;
  int buf = 0;
  if (item < p.items) stage(p, item, smem + p.g_len, chunk);
  cp_async_commit();
  if constexpr (kGeneric) {
    // G, issued while the first span is in flight
    const int kg = p.k * p.up;
    if (BF3) {
      const __nv_bfloat16* g = static_cast<const __nv_bfloat16*>(p.g);
      for (int i = threadIdx.x; i < 2 * kg; i += blockDim.x)
        sg[i] = __bfloat162float(g[i]);
    } else {
      const float* g = static_cast<const float*>(p.g);
      for (int i = threadIdx.x; i < kg; i += blockDim.x)
        sg[i] = __ldg(g + i);
    }
  }
  for (; item < p.items; item += gridDim.x) {
    const long long next = item + gridDim.x;
    if (p.nbuf == 2 && next < p.items)
      stage(p, next, smem + p.g_len + (buf ^ 1) * p.stride, chunk);
    cp_async_commit();
    cp_async_wait_prior();  // every group but the newest: this item's span
    float* sx = smem + p.g_len + buf * p.stride;
    float* sx1 = sx + p.nbuf * p.stride;
    if (kGeneric && BF3) cut(p, sx, sx1, chunk);
    __syncthreads();
    const long long s = item / p.tiles;
    const long long w0 = (item - s * p.tiles) * p.windows;
    if constexpr (kGeneric)
      compute_generic<BF3>(p, sx, sx1, sg, s, w0);
    else
      compute_tiled<UP, DOWN, K, BF3>(p, sx, s, w0);
    __syncthreads();  // the buffer is free for the next copies
    if (p.nbuf == 2) {
      buf ^= 1;
    } else if (next < p.items) {
      stage(p, next, smem + p.g_len, chunk);
      cp_async_commit();
    }
  }
}

using KernelFn = void (*)(const Params);

struct Instance {
  int up, down, k, r, bf3;
  KernelFn fn;
};

// The tiled instances (the serving fleets' ratios, K fixed by the ratio)
// and the generic one, in both precisions.
const Instance kInstances[] = {
    {1, 3, 61, kTiledR, 0, resample_kernel<1, 3, 61, false>},
    {1, 3, 61, kTiledR, 1, resample_kernel<1, 3, 61, true>},
    {2, 1, 21, kTiledR, 0, resample_kernel<2, 1, 21, false>},
    {2, 1, 21, kTiledR, 1, resample_kernel<2, 1, 21, true>},
    {1, 2, 41, kTiledR, 0, resample_kernel<1, 2, 41, false>},
    {1, 2, 41, kTiledR, 1, resample_kernel<1, 2, 41, true>},
    {0, 0, 0, 1, 0, resample_kernel<0, 0, 0, false>},
    {0, 0, 0, 1, 1, resample_kernel<0, 0, 0, true>},
};
constexpr int kNumInstances = sizeof(kInstances) / sizeof(kInstances[0]);
constexpr int kMaxDevices = 64;

int find_instance(const Launch& L) {
  for (int i = 0; i < kNumInstances; ++i) {
    const Instance& in = kInstances[i];
    if (in.bf3 != L.bf3 || in.r != L.r) continue;
    if (in.up == 0 || (in.up == L.up && in.down == L.down && in.k == L.k))
      return i;
  }
  return -1;
}

// The largest dynamic shared memory set so far, per instance and device.
std::mutex g_smem_mutex;
int g_smem_set[kNumInstances][kMaxDevices];

cudaError_t allow_smem(int inst, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(g_smem_mutex);
  if (g_smem_set[inst][dev] >= smem) return cudaSuccess;
  err = cudaFuncSetAttribute(kInstances[inst].fn,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err == cudaSuccess) g_smem_set[inst][dev] = smem;
  return err;
}

bool geometry_ok(const Launch& L) {
  const long long chunk = static_cast<long long>(L.r) * L.down;
  const long long span = static_cast<long long>(L.windows - 1) * L.down + L.k;
  const long long last = (span - 1) + (span - 1) / chunk * L.pad;
  const int x_slices = (L.bf3 && L.r == 1) ? 2 : 1;
  const int g_floats = L.k * L.up * (L.bf3 ? 2 : 1);
  return L.up > 0 && L.down > 0 && L.k > 0 && L.la >= 0 && L.lb >= 0 &&
         L.g_len >= 0 &&
         L.threads >= 32 && L.threads <= kMaxThreads && L.threads % 32 == 0 &&
         L.r >= 1 && L.windows >= 1 && L.windows % L.r == 0 &&
         L.windows <= L.threads * L.r &&
         (L.nbuf == 1 || L.nbuf == 2) && (L.pad == 0 || L.pad == 1) &&
         L.span == span && L.stride > last &&
         // G in shared memory (generic) or in the parameters (tiled)
         (L.r == 1 ? L.g_len >= g_floats : g_floats <= kMaxParamG) &&
         static_cast<long long>(L.smem) >=
             4LL * (L.g_len + static_cast<long long>(L.nbuf) * L.stride *
                                  x_slices) &&
         (L.q - 1) * L.down + L.k <= L.la + L.lb &&
         L.tiles == (L.q + L.windows - 1) / L.windows &&
         L.items == L.n_streams * L.tiles && L.grid >= 1 &&
         L.grid <= L.items;
}

// The instance that takes launch L, with its shared memory allowed; or
// the error.
cudaError_t prepare(const Launch& L, int* inst) {
  if (!geometry_ok(L)) return cudaErrorInvalidValue;
  *inst = find_instance(L);
  if (*inst < 0) return cudaErrorInvalidValue;
  return allow_smem(*inst, L.smem);
}

}  // namespace

extern "C" {

// One launch of K3 (b = nullptr, lb = 0) or K4 with the geometry of
// kernels/resample.py::tile, on `stream`: g is G on the device as
// resample_matrices builds it (the generic instance stages it), g_host
// the same values as floats, K*up (bf3: g0 then g1, 2*K*up), which the
// tiled instances take in their parameters. Returns 0 or the cudaError_t
// of the launch (cudaErrorInvalidValue for a geometry or shape the
// kernel does not take).
int melspec_resample(const MelspecResampleLaunch* L, const float* a,
                     const float* b, const void* g, const float* g_host,
                     float* out, void* stream) {
  if (L->n_streams <= 0 || L->q <= 0) return cudaSuccess;
  if ((L->lb > 0 && b == nullptr) || (L->r > 1 && g_host == nullptr))
    return cudaErrorInvalidValue;
  int inst = 0;
  cudaError_t err = prepare(*L, &inst);
  if (err != cudaSuccess) return err;
  Params p;
  p.a = a;
  p.b = b == nullptr ? a : b;
  p.g = g;
  p.out = out;
  p.la = L->la;
  p.lb = L->lb;
  p.q = L->q;
  p.tiles = L->tiles;
  p.items = L->items;
  p.up = L->up;
  p.down = L->down;
  p.k = L->k;
  p.windows = L->windows;
  p.nbuf = L->nbuf;
  p.pad = L->pad;
  p.span = L->span;
  p.stride = L->stride;
  p.g_len = L->g_len;
  p.vec = (L->q * L->up) % 4 == 0 && (L->r * L->up) % 4 == 0 &&
          (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  if (L->r > 1)
    for (int i = 0; i < L->k * L->up * (L->bf3 ? 2 : 1); ++i)
      p.gp[i] = g_host[i];
  kInstances[inst].fn<<<static_cast<unsigned>(L->grid), L->threads,
                        static_cast<size_t>(L->smem),
                        static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

// Blocks of launch L's geometry that one SM holds at once (its
// registers, threads and shared memory), for the persistent grid; or
// minus the cudaError_t.
int melspec_resample_blocks_per_sm(const MelspecResampleLaunch* L) {
  int inst = 0;
  cudaError_t err = prepare(*L, &inst);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, kInstances[inst].fn, L->threads, static_cast<size_t>(L->smem));
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

const char* melspec_resample_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
