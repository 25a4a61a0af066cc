// P1 for Hopper (sm_90a): a probe of the port's signal-load path.
//
// Replaces tools/hbm_reshape_probe.py::run (its pallas_call), the TPU
// probe that asks whether a kernel can DMA macro-rows straight out of a
// flat [B, T] operand instead of a host-reshaped [B, R, W] one. The same
// question on Hopper concerns K1's and K2's own load: each block stages the
// overlapping span of one 64-frame tile, 63 * hop + the frame's taps in
// whole 32-row chunks (sig_common.cuh::span_len, stage_span), straight
// from flat [B, T] into shared memory. Each mode below is a copy through
// shared memory to an output that the caller checks for exact equality:
//   rows  (baseline): row r of clip b of a host-reshaped [B, R, W] tensor,
//         plain loads;
//   rows  (flat_rows): the same rows read from flat [B, T] at offset +
//         r * W, with cp.async 16-byte copies where source and shared
//         addresses are 16-byte aligned and 4-byte copies where not (the
//         shared buffer is shifted to the source's alignment, so only a
//         row's head and tail take 4-byte copies);
//   spans (flat_span): K1's spans, samples offset + t * 64 * hop + u for
//         u < span_len(hop, taps, 0), zero past the clip, as stage_span
//         reads them, staged with the same cp.async scheme.
//
// What bounds it: bytes. Each mode reads its input once and writes its
// output once; the launcher's caller divides those bytes by the kernel's
// time against the card's 3.35 TB/s.
//
// Plain C interface, built with nvcc and bound with ctypes
// (melspec_tpu_torch/kernels/load_probe.py). Every launch is followed by
// cudaGetLastError, and its code is returned.

#include "sig_common.cuh"

namespace {

constexpr int kProbeThreads = 256;

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Stage src[0, n) into the 16-byte aligned buffer buf with cp.async;
// returns where the n values start in buf (shifted by src's misalignment,
// 0..3 floats, so that the body moves in 16-byte copies).
__device__ __forceinline__ float* stage_async(const float* src, int n,
                                              float* buf) {
  const int mis = static_cast<int>(
      (reinterpret_cast<unsigned long long>(src) >> 2) & 3);
  float* dst = buf + mis;
  const int head = min((4 - mis) & 3, n);
  const int body = (n - head) / 4;
  const int tail0 = head + 4 * body;
  for (int u = threadIdx.x; u < head; u += blockDim.x)
    cp_async4(dst + u, src + u);
  for (int v = threadIdx.x; v < body; v += blockDim.x)
    cp_async16(dst + head + 4 * v, src + head + 4 * v);
  for (int u = tail0 + threadIdx.x; u < n; u += blockDim.x)
    cp_async4(dst + u, src + u);
  cp_async_wait_all();
  __syncthreads();
  return dst;
}

// One block per (clip, row): out[b, r, :W] = src[b * batch_stride + offset
// + r * W + :W], through shared memory.
__global__ void __launch_bounds__(kProbeThreads)
    rows_kernel(const float* src, long long batch_stride, long long offset,
                int W, int R, int async_copy, float* out) {
  extern __shared__ __align__(16) float sbuf[];
  const int b = blockIdx.x / R;
  const int r = blockIdx.x - b * R;
  const float* row = src + b * batch_stride + offset +
                     static_cast<long long>(r) * W;
  const float* s;
  if (async_copy) {
    s = stage_async(row, W, sbuf);
  } else {
    for (int u = threadIdx.x; u < W; u += blockDim.x) sbuf[u] = row[u];
    __syncthreads();
    s = sbuf;
  }
  float* o = out + (static_cast<long long>(b) * R + r) * W;
  for (int u = threadIdx.x; u < W; u += blockDim.x) o[u] = s[u];
}

// One block per (clip, tile): out[b, t, :span] = the samples offset + t *
// 64 * hop + u of clip b, zero past T, through shared memory.
__global__ void __launch_bounds__(kProbeThreads)
    spans_kernel(const float* x, long long T, int offset, int hop, int span,
                 int n_spans, float* out) {
  extern __shared__ __align__(16) float sbuf[];
  const int b = blockIdx.x / n_spans;
  const int t = blockIdx.x - b * n_spans;
  const long long s0 =
      offset + static_cast<long long>(t) * sigk::kTileFrames * hop;
  const long long avail = T - s0;
  const int n = static_cast<int>(avail < span ? (avail > 0 ? avail : 0)
                                              : span);
  const float* s = stage_async(x + b * T + s0, n, sbuf);
  float* o = out + (static_cast<long long>(b) * n_spans + t) * span;
  for (int u = threadIdx.x; u < span; u += blockDim.x)
    o[u] = u < n ? s[u] : 0.0f;
}

cudaError_t launch(const void* kernel, int grid, long long smem,
                   void** args, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernel(kernel, dim3(grid), dim3(kProbeThreads), args,
                         static_cast<size_t>(smem),
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows mode: baseline (async_copy 0, src a contiguous [B, R, W] tensor,
// batch_stride R * W, offset 0) or flat_rows (async_copy 1, src flat
// [B, T], batch_stride T). Returns 0 or the cudaError_t of the launch.
int melspec_load_probe_rows(const float* src, long long batch,
                            long long batch_stride, long long offset, int W,
                            int R, int async_copy, float* out, void* stream) {
  if (batch <= 0 || R <= 0) return cudaSuccess;
  if (W <= 0 || offset < 0 || batch_stride < offset + 1LL * R * W ||
      batch * R > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const long long smem = 4LL * (W + 4);
  if (smem > 232448) return cudaErrorInvalidValue;
  int grid = static_cast<int>(batch * R);
  void* args[] = {&src, &batch_stride, &offset, &W, &R, &async_copy, &out};
  return launch(reinterpret_cast<const void*>(rows_kernel), grid, smem, args,
                stream);
}

// Spans mode (flat_span) over flat [B, T]; out [B, n_spans, span].
int melspec_load_probe_spans(const float* x, long long batch, long long T,
                             int offset, int hop, int span, int n_spans,
                             float* out, void* stream) {
  if (batch <= 0 || n_spans <= 0) return cudaSuccess;
  if (T <= 0 || offset < 0 || hop <= 0 || span <= 0 ||
      batch * n_spans > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const long long smem = 4LL * (span + 4);
  if (smem > 232448) return cudaErrorInvalidValue;
  int grid = static_cast<int>(batch * n_spans);
  void* args[] = {&x, &T, &offset, &hop, &span, &n_spans, &out};
  return launch(reinterpret_cast<const void*>(spans_kernel), grid, smem, args,
                stream);
}

const char* melspec_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
