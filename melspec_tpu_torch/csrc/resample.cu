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
// in float32. "highest" sums x*G in float32. Taps are summed in order
// j = 0 .. K-1 with fmaf.
//
// K3 and K4 are one kernel: the staging loop reads sample i of the
// virtual signal from `a` when i < la and from `b` otherwise. K3 passes
// the signal as `a` (la = T, lb = 0). The staged floats, and so every
// output, of K4 over (buf, chunks) equal K3's over their concat bit for
// bit.
//
// What bounds it: bytes. Per output it reads down input samples and
// writes one value (at 48 kHz -> 16 kHz: 12 + 4 bytes) against 2*K = 122
// FLOPs (366 in bf3), below the card's FLOP-per-byte balance. This first
// version: one 256-thread block per (stream, tile of windows); the
// tile's input span and G are staged once in shared memory, so device
// memory sees each input sample about once and each output once. Thread
// u takes phase u % up and WINDOWS windows of its tile, interleaved with
// the other threads' so that neighbouring threads read neighbouring
// windows (stride `down` in shared memory) and write neighbouring
// outputs. Each tap loads G once for all its windows.
//
// Plain C interface, built with nvcc and bound with ctypes
// (melspec_tpu_torch/kernels/resample.py). Every launch is followed by
// cudaGetLastError, and its code is returned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWindows = 4;  // windows per thread

struct Params {
  const float* a;  // [S, la]
  const float* b;  // [S, lb]
  long long la, lb, q;
  int up, down, k, bf3, groups, tq, span, g_len, tiles;
  const void* g;   // f32 [K, up], or bf16 [2, K, up] (g0, g1)
  float* out;      // [S, q*up]
};

__global__ void __launch_bounds__(kThreads) resample_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  float* sg = smem;              // G, or g0 then g1
  float* sx0 = smem + p.g_len;   // the span (bf3: its x0 slice)
  float* sx1 = sx0 + p.span;     // bf3: the x1 slice
  const long long s = blockIdx.x / p.tiles;
  const long long w0 = (blockIdx.x - s * p.tiles) * static_cast<long long>(p.tq);
  const int kg = p.k * p.up;

  if (p.bf3) {
    const __nv_bfloat16* g = static_cast<const __nv_bfloat16*>(p.g);
    for (int i = threadIdx.x; i < 2 * kg; i += kThreads)
      sg[i] = __bfloat162float(g[i]);
  } else {
    const float* g = static_cast<const float*>(p.g);
    for (int i = threadIdx.x; i < kg; i += kThreads) sg[i] = __ldg(g + i);
  }
  const float* ra = p.a + s * p.la;
  const float* rb = p.b + s * p.lb;
  const long long i0 = w0 * p.down;
  for (int u = threadIdx.x; u < p.span; u += kThreads) {
    const long long i = i0 + u;
    // past the signal's end: zero (only windows >= q, never written)
    const float v = i < p.la ? __ldg(ra + i)
                             : (i - p.la < p.lb ? __ldg(rb + (i - p.la)) : 0.0f);
    if (p.bf3) {
      const float x0 = __bfloat162float(__float2bfloat16_rn(v));
      sx0[u] = x0;
      sx1[u] = __bfloat162float(__float2bfloat16_rn(__fsub_rn(v, x0)));
    } else {
      sx0[u] = v;
    }
  }
  __syncthreads();

  const long long row = s * p.q * p.up;
  for (int u = threadIdx.x; u < p.groups * p.up; u += kThreads) {
    const int wg = u / p.up;
    const int ph = u - wg * p.up;
    float acc[kWindows];
#pragma unroll
    for (int r = 0; r < kWindows; ++r) acc[r] = 0.0f;
    const float* gcol = sg + ph;
    if (p.bf3) {
      const float* g1col = sg + kg + ph;
      for (int j = 0; j < p.k; ++j) {
        const float g0 = gcol[j * p.up];
        const float g1 = g1col[j * p.up];
#pragma unroll
        for (int r = 0; r < kWindows; ++r) {
          const int x = (wg + r * p.groups) * p.down + j;
          const float x0 = sx0[x];
          acc[r] = fmaf(x0, g0, acc[r]);
          acc[r] = fmaf(x0, g1, acc[r]);
          acc[r] = fmaf(sx1[x], g0, acc[r]);
        }
      }
    } else {
      for (int j = 0; j < p.k; ++j) {
        const float g = gcol[j * p.up];
#pragma unroll
        for (int r = 0; r < kWindows; ++r)
          acc[r] = fmaf(sx0[(wg + r * p.groups) * p.down + j], g, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kWindows; ++r) {
      const long long w = w0 + wg + r * p.groups;
      if (w < p.q) p.out[row + w * p.up + ph] = acc[r];
    }
  }
}

}  // namespace

extern "C" {

// The block's tiling comes from the caller (kernels/resample.py::tile,
// the one place it is decided): `groups` window groups of kWindows
// windows each, a staged span of (groups*kWindows - 1)*down + k samples,
// g_len floats of G and smem bytes in all. Returns 0 or the cudaError_t
// of the launch (cudaErrorInvalidValue for arguments the kernel does not
// take; the runtime refuses more shared memory than a block has).
int melspec_resample(const float* a, long long la, const float* b,
                     long long lb, long long n_streams, long long q, int up,
                     int down, int k, const void* g, int bf3, int groups,
                     int g_len, long long smem, float* out, void* stream) {
  if (n_streams <= 0 || q <= 0) return cudaSuccess;
  const int tq = groups * kWindows;
  const long long span = static_cast<long long>(tq - 1) * down + k;
  if (up <= 0 || down <= 0 || k <= 0 || groups <= 0 || la < 0 || lb < 0 ||
      (q - 1) * down + k > la + lb || g_len < k * up * (bf3 ? 2 : 1) ||
      smem < 4LL * (g_len + span * (bf3 ? 2 : 1)))
    return cudaErrorInvalidValue;
  const long long tiles = (q + tq - 1) / tq;
  const long long grid = n_streams * tiles;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  Params p;
  p.a = a;
  p.b = b;
  p.la = la;
  p.lb = lb;
  p.q = q;
  p.up = up;
  p.down = down;
  p.k = k;
  p.bf3 = bf3;
  p.groups = groups;
  p.tq = tq;
  p.span = static_cast<int>(span);
  p.g_len = g_len;
  p.tiles = static_cast<int>(tiles);
  p.g = g;
  p.out = out;
  cudaError_t err = cudaFuncSetAttribute(
      resample_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  resample_kernel<<<static_cast<unsigned>(grid), kThreads,
                    static_cast<size_t>(smem),
                    static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

const char* melspec_resample_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
