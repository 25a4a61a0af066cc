// K1's float64 FFT path: the ln heads (Kaldi fbank, NeMo log-mel) whose
// DFT has 2048 points (n_fft 2048: 44.1 and 48 kHz), one frame at a time
// per block of 256 threads, in float64 from the taps to the power.
//
// Why float64 and not the tensor-core two-stage DFT of sig_factored.cuh:
// an FFT's rounding error is relative to the frame's whole spectrum, not
// to the bin. The ln modes keep bins far below the frame's loudest (the
// empty band above 8 kHz of upsampled speech, the band a high-pass filter
// removed, Kaldi's preemphasized low bins), where every float32 rounding
// of the two-stage path (the windowed taps, stage 1's sums, the twiddle,
// stage 2's sums) swamps them on real clips (even the dense chunk walk,
// whose matrix rounds column by column, lands 4e-4 in ln from float64
// there: chip_smoke.py phase ln_fft). In float64 the FFT's error sits 29
// bits further down, so the power is exact to float32 on every bin, and
// an FFT of 2048 points is ~60 k operations a frame against the dense
// walk's 2 x 6 x 1200 x 2048.
//
// Per frame (frames split among the blocks in contiguous runs):
//   1. the pack taps from start + k*hop (zero past the clip) in float64:
//      y[i] = w[i] x[i] (NeMo), or Kaldi's DC removal and preemphasis
//      before the window, y[i] = w[i] (d[i] - p d[i-1]) with d = x - mean
//      and y[0] = w[0] d[0] (fbank.py::kaldi_preproc_matrix), the mean one
//      block reduction; zero from pack to 2048 (a frame at pack_off inside
//      the DFT starts at tap 0 here: a circular shift, the same power);
//   2. the 2048 real taps as 1024 complex values z[j] = y[2j] + i y[2j+1]
//      and their 1024-point FFT: five radix-4 Stockham passes between two
//      shared buffers, each thread one butterfly a pass (the first on the
//      taps in its registers: thread t stages z[t + 256 r]), the twiddles
//      W^e = exp(-2 pi i e / 2048) from host tables in shared memory, one
//      a pass in the order its butterflies read them (no bank conflicts);
//   3. the bins k < 1024: X[k] = (Z[k] + conj Z[-k]) / 2 - i W^k (Z[k] -
//      conj Z[-k]) / 2, the power |X[k]|^2 rounded once to float32 (the
//      Nyquist bin is not computed: the host checks its filter row);
//   4. the bf2 projection of each mel's run of bins, [p0 p0 p1] . [F0 F1
//      F0] with p0 = bf16(power), p1 = bf16(power - p0), float32 sums,
//      eight lanes a mel; ln(e + guard) or ln(max(e, guard)).

#pragma once

#include <cuda_bf16.h>

namespace sigk {

constexpr int kFftN = 2048;           // the DFT's points
constexpr int kFftHalf = kFftN / 2;   // the complex FFT's points, the bins
constexpr int kFftThreads = 256;
constexpr int kFftWarps = kFftThreads / 32;
constexpr int kFftTaps = kFftN / kFftThreads;  // taps a thread stages
constexpr int kFftMelLanes = 8;  // the lanes that sum one mel's run
// blocks resident on an SM: the register cap that lets them in
constexpr int kFftBlocksPerSm = 3;
// the twiddle tables: W^k for the bins k < 1024, then for each pass of
// Ns = 4, 16, 64, 256 points W^(r m 512 / Ns) at [(r - 1) Ns + m] for
// r = 1..3, m < Ns (kernels/sig_mel.py::fft_twiddles)
constexpr int kFftTw = kFftHalf + 3 * (4 + 16 + 64 + 256);
// a block's dynamic shared memory: the twiddle tables and two buffers of
// 1024 complex doubles, then the projection's runs (fft_smem)
constexpr int kFftSmem =
    (kFftTw + 2 * kFftHalf) * static_cast<int>(sizeof(double2));

struct Fft {
  const float* x;  // [batch, T]
  long long T, frames;  // frames: batch * n_frames
  int n_frames, hop, pack;
  long long start;        // the first tap of frame 0 (offset + pack_off)
  const double* window;   // [pack]
  const double2* tw;      // [kFftTw]: (cos, -sin)(2 pi e / 2048)
  double preemph;         // Kaldi's p; < 0: neither DC removal nor it
  const int* mel_off;     // [n_mels + 1]: mel m's run is f0/f1[off[m]..]
  const int* mel_lo;      // [n_mels]: the bin of its first value
  const __nv_bfloat16* f0;  // the bf2 filters F0, F1 of the runs
  const __nv_bfloat16* f1;
  int nnz;  // the runs' values in all, mel_off[n_mels_pad]
  int n_mels, out_mode;
  float guard;
  float* out;  // [batch, n_frames, n_mels]
};

__device__ __forceinline__ double2 c_mul(double2 a, double2 b) {
  return make_double2(fma(a.x, b.x, -a.y * b.y), fma(a.x, b.y, a.y * b.x));
}

// the pass of Ns points' twiddle table (kFftTw)
template <int Ns>
__host__ __device__ constexpr int fft_tw_at() {
  if constexpr (Ns <= 4)
    return kFftHalf;
  else
    return fft_tw_at<Ns / 4>() + 3 * (Ns / 4);
}

// the radix-4 butterfly j of a Stockham pass of the 1024-point FFT over
// sub-transforms of Ns points, on its inputs v0..v3 (turned): output r to
// dst[4 (j - j mod Ns) + j mod Ns + r Ns]
template <int Ns>
__device__ __forceinline__ void fft_butterfly(double2 v0, double2 v1,
                                              double2 v2, double2 v3,
                                              double2* dst, int j) {
  const int m = j & (Ns - 1);
  const double2 a0 = make_double2(v0.x + v2.x, v0.y + v2.y);
  const double2 a1 = make_double2(v0.x - v2.x, v0.y - v2.y);
  const double2 a2 = make_double2(v1.x + v3.x, v1.y + v3.y);
  // -i (v1 - v3)
  const double2 a3 = make_double2(v1.y - v3.y, v3.x - v1.x);
  const int o = 4 * (j - m) + m;
  dst[o] = make_double2(a0.x + a2.x, a0.y + a2.y);
  dst[o + Ns] = make_double2(a1.x + a3.x, a1.y + a3.y);
  dst[o + 2 * Ns] = make_double2(a0.x - a2.x, a0.y - a2.y);
  dst[o + 3 * Ns] = make_double2(a1.x - a3.x, a1.y - a3.y);
}

// one radix-4 Stockham pass of Ns > 1 points: butterfly j reads src[j +
// 256 r] and turns input r by exp(-2 pi i r (j mod Ns) / (4 Ns)) (the
// pass's table); after the passes Ns = 1, 4, 16, 64, 256 dst holds the
// transform in natural order
template <int Ns>
__device__ __forceinline__ void fft_pass(const double2* src, double2* dst,
                                         const double2* stw, int j) {
  constexpr int kQ = kFftHalf / 4;
  const double2* tw = stw + fft_tw_at<Ns>() + (j & (Ns - 1));
  fft_butterfly<Ns>(src[j], c_mul(src[j + kQ], tw[0]),
                    c_mul(src[j + 2 * kQ], tw[Ns]),
                    c_mul(src[j + 3 * kQ], tw[2 * Ns]), dst, j);
}

// the block's sum of one double a thread, in a fixed order (each warp by
// shuffles, then the warps' sums in order), returned to every thread
__device__ __forceinline__ double fft_block_sum(double v, double* red) {
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  double t = 0.0;
  for (int w = 0; w < kFftWarps; ++w) t += red[w];
  return t;
}

// the dynamic shared memory of a block for a projection of n_mels runs of
// nnz values in all
inline long long fft_smem(int n_mels, int nnz) {
  const long long runs = 4LL * (2 * n_mels + 1) + 4LL * nnz;
  return kFftSmem + (runs + 15) / 16 * 16;
}

// the tap of thread t's q-th staged value: the pairs 2t, 2t + 1 of z[t +
// 256 r], r = q / 2
__device__ __forceinline__ int fft_tap(int t, int q) {
  return 2 * t + 2 * kFftThreads * (q >> 1) + (q & 1);
}

// the taps of the frame whose first tap is xb[s] (a thread's kFftTaps at
// fft_tap, zero past pack and past the clip)
__device__ __forceinline__ void fft_load(const Fft& p, const float* xb,
                                         long long s, int t, double* xv) {
#pragma unroll
  for (int q = 0; q < kFftTaps; ++q) {
    const int i = fft_tap(t, q);
    xv[q] = (i < p.pack && s + i < p.T) ? static_cast<double>(__ldg(xb + s + i))
                                        : 0.0;
  }
}

__global__ void __launch_bounds__(kFftThreads, kFftBlocksPerSm)
    sig_mel_fft_kernel(const Fft p) {
  extern __shared__ __align__(16) unsigned char fft_smem_[];
  __shared__ double red[kFftWarps];
  // Kaldi: each warp's last tap of each pair slot, the sample before the
  // next warp's first (lane 31's z[t + 256 r].im, the tap 2t + 1 + 512 r)
  __shared__ double edge[kFftWarps][kFftTaps / 2];
  double2* stw = reinterpret_cast<double2*>(fft_smem_);
  double2* buf0 = stw + kFftTw;
  double2* buf1 = buf0 + kFftHalf;
  int* soff = reinterpret_cast<int*>(buf1 + kFftHalf);
  int* slo = soff + p.n_mels + 1;
  __nv_bfloat16* sf0 = reinterpret_cast<__nv_bfloat16*>(slo + p.n_mels);
  __nv_bfloat16* sf1 = sf0 + p.nnz;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  for (int e = t; e < kFftTw; e += kFftThreads) stw[e] = p.tw[e];
  for (int m = t; m <= p.n_mels; m += kFftThreads) soff[m] = p.mel_off[m];
  for (int m = t; m < p.n_mels; m += kFftThreads) slo[m] = p.mel_lo[m];
  for (int j = t; j < p.nnz; j += kFftThreads) {
    sf0[j] = p.f0[j];
    sf1[j] = p.f1[j];
  }
  // the window of this thread's taps, the same every frame
  double wv[kFftTaps];
#pragma unroll
  for (int q = 0; q < kFftTaps; ++q) {
    const int i = fft_tap(t, q);
    wv[q] = i < p.pack ? __ldg(p.window + i) : 0.0;
  }

  const long long per = (p.frames + gridDim.x - 1) / gridDim.x;
  const long long g0 = blockIdx.x * per;
  const long long g1 = g0 + per < p.frames ? g0 + per : p.frames;
  const bool kaldi = p.preemph >= 0.0;
  // clip b's frame kf, counted along the block's run of frames
  long long b = g0 / p.n_frames;
  int kf = static_cast<int>(g0 - b * p.n_frames);
  for (long long g = g0; g < g1; ++g) {
    double xv[kFftTaps];
    fft_load(p, p.x + b * p.T, p.start + static_cast<long long>(kf) * p.hop,
             t, xv);
    if (++kf == p.n_frames) {
      kf = 0;
      ++b;
    }
    double part = 0.0;
#pragma unroll
    for (int q = 0; q < kFftTaps; ++q) part += xv[q];
    __syncthreads();  // the previous frame is done with the buffers, red
    if (kaldi && lane == 31) {
#pragma unroll
      for (int r = 0; r < kFftTaps / 2; ++r) edge[warp][r] = xv[2 * r + 1];
    }
    const double mean = kaldi ? fft_block_sum(part, red) / p.pack : 0.0;
    double y[kFftTaps];
#pragma unroll
    for (int q = 0; q < kFftTaps; ++q) {
      double d = xv[q];
      if (kaldi) {
        // x[i - 1]: the pair's first tap, the neighbour lane's second, or
        // for lane 0 the previous warp's last (warp 0: the last warp's of
        // the slot before; tap 0 has none)
        const double up = __shfl_up_sync(0xffffffffu, xv[q | 1], 1);
        const int r = q >> 1;
        const double prev =
            (q & 1) ? xv[q - 1]
            : lane  ? up
            : warp  ? edge[warp - 1][r]
            : r     ? edge[kFftWarps - 1][r - 1]
                    : 0.0;
        d -= mean;
        if (fft_tap(t, q) > 0) d -= p.preemph * (prev - mean);
      }
      y[q] = wv[q] * d;
    }
    // pass 1 (Ns = 1, no twiddles) on the staged z[t + 256 r]
    fft_butterfly<1>(make_double2(y[0], y[1]), make_double2(y[2], y[3]),
                     make_double2(y[4], y[5]), make_double2(y[6], y[7]),
                     buf1, t);
    __syncthreads();
    fft_pass<4>(buf1, buf0, stw, t);
    __syncthreads();
    fft_pass<16>(buf0, buf1, stw, t);
    __syncthreads();
    fft_pass<64>(buf1, buf0, stw, t);
    __syncthreads();
    fft_pass<256>(buf0, buf1, stw, t);
    __syncthreads();
    // the bins from Z in buf1, their float32 power into buf0
    float* pw = reinterpret_cast<float*>(buf0);
#pragma unroll
    for (int r = 0; r < kFftHalf / kFftThreads; ++r) {
      const int k = t + r * kFftThreads;  // the bin
      const double2 zk = buf1[k], zn = buf1[(kFftHalf - k) & (kFftHalf - 1)];
      const double er = 0.5 * (zk.x + zn.x), ei = 0.5 * (zk.y - zn.y);
      const double orr = 0.5 * (zk.y + zn.y), oi = 0.5 * (zn.x - zk.x);
      const double2 w = stw[k];
      const double xr = er + (w.x * orr - w.y * oi);
      const double xi = ei + (w.x * oi + w.y * orr);
      pw[k] = static_cast<float>(xr * xr + xi * xi);
    }
    __syncthreads();
    constexpr int kGroups = kFftThreads / kFftMelLanes;
    const int sub = t % kFftMelLanes;
    for (int base = 0; base < p.n_mels; base += kGroups) {
      const int m = base + t / kFftMelLanes;
      const bool on = m < p.n_mels;
      const int o0 = on ? soff[m] : 0, n = on ? soff[m + 1] - o0 : 0;
      const float* pm = pw + (on ? slo[m] : 0);
      float e = 0.0f;
      for (int j = sub; j < n; j += kFftMelLanes) {
        const float pv0 = pm[j];
        const float q0 = __bfloat162float(__float2bfloat16_rn(pv0));
        const float q1 =
            __bfloat162float(__float2bfloat16_rn(__fsub_rn(pv0, q0)));
        const float a = __bfloat162float(sf0[o0 + j]);
        const float c = __bfloat162float(sf1[o0 + j]);
        e = __fmaf_rn(q0, a, e);
        e = __fmaf_rn(q0, c, e);
        e = __fmaf_rn(q1, a, e);
      }
      for (int sh = kFftMelLanes / 2; sh > 0; sh >>= 1)
        e = __fadd_rn(e, __shfl_xor_sync(0xffffffffu, e, sh));
      if (on && sub == 0)
        p.out[g * p.n_mels + m] = ln_accurate(
            p.out_mode == kLnGuard ? __fadd_rn(e, p.guard) : fmaxf(e, p.guard));
    }
  }
}

}  // namespace sigk
