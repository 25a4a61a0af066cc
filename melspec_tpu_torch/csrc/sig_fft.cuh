// K1's float64 FFT path: the ln heads (Kaldi fbank, NeMo log-mel) whose
// DFT has 2048 points (n_fft 2048: 44.1, 48, 64 and 80 kHz), in float64
// from the taps to the power.
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
// What bounds it on the card: the float64 units (64 operations a clock an
// SM) and the shared memory's 128 bytes a clock an SM, which every
// exchange of the FFT's values between threads goes through. So a frame
// belongs to a group of 64 threads (two warps) that holds its FFT in
// registers, 16 points a thread, and exchanges the values twice, each
// behind a named barrier of the group's 64 threads alone; a block of 256
// threads holds four groups, each walking its own contiguous run of frames
// (consecutive frames share most of their taps, which then come from L1),
// and two blocks an SM keep eight frames in flight. Nothing inside a
// frame's walk waits for the whole block: 7 barriers of the group a frame
// (Kaldi's mean the first), none of the block.
//
// Per frame, in group thread t < 64:
//   1. the taps 2j, 2j + 1 of z[j], j = t + 64 n for n < 16 (one 8-byte
//      load where aligned), from start + k*hop, zero past pack and past the
//      clip, in float64 (each converted once): y[i] = w[i] x[i] (NeMo), or
//      Kaldi's DC removal and preemphasis before the window, y[i] = w[i]
//      (d[i] - p d[i-1]) with d = x - mean and y[0] = w[0] d[0]
//      (fbank.py::kaldi_preproc_matrix): the mean the group's sum
//      (shuffles, then one word a warp), x[i - 1] of an even tap the
//      neighbour lane's odd tap (lane 0: the other warp's lane 31, through
//      the group's edge words); zero from pack to 2048 (a frame at pack_off
//      inside the DFT starts at tap 0 here: a circular shift, the same
//      power);
//   2. the 1024-point complex FFT of z[j] = y[2j] + i y[2j+1] as 1024 = 16 x
//      16 x 4 (kernels/sig_mel.py::FFT_RADICES): with j = t + 64 n and k =
//      k1 + 16 (c + 16 d),
//        B[t][k1]   = W1024^(t k1) sum_n W16^(n k1) z[t + 64 n]
//        C[k1,a][c] = W64^(a c) sum_b W16^(b c) B[a + 4 b][k1]
//        Z[k]       = sum_a W4^(a d) C[k1,a][c]
//      a radix-16 pass in registers (two radix-4 layers with the powers of
//      W16 as constants) in thread t, then one in thread (k1, a) = (t / 4,
//      t mod 4), then four radix-4s a thread (fft_pass3), which leave each
//      Z[k] beside its mirror Z[1024 - k] in one thread's registers; the
//      twiddles between passes the powers of one base a thread (W1024^t,
//      W64^a) from the host's table, in turn; each exchange through the
//      group's buffer in a layout that no 8 consecutive threads read or
//      write on one bank twice (fft_at1, fft_at2);
//   3. the bins k and 1024 - k from the registers Z[k], Z[1024 - k]: X[k] =
//      (Z[k] + conj Z[-k]) / 2 - i W2048^k (Z[k] - conj Z[-k]) / 2, the
//      power |X[k]|^2 (a magnitude head's |X[k]|, the root taken in
//      float64: the kernel's kMag instance) rounded once to float32 (the
//      Nyquist bin is not computed: the host checks its filter row);
//   4. the power's bf2 halves p0 = bf16(power), p1 = bf16(power - p0) by
//      bin through the buffer, and the bf2 projection of each mel's run of
//      bins, [p0 p0 p1] . [F0 F1 F0], float32 sums, eight lanes a mel; each
//      mel's sum through the buffer, then ln(e + guard) or ln(max(e,
//      guard)) a thread.
//
// The window (zero from pack to 2048) and the twiddle table sit in shared
// memory beside the groups' buffers; what is left of the SM's 256 KB is L1
// for the taps, which consecutive frames share.

#pragma once

#include <cuda_bf16.h>

namespace sigk {

constexpr int kFftN = 2048;           // the DFT's points
constexpr int kFftHalf = kFftN / 2;   // the complex FFT's points, the bins
constexpr int kFftGroupThreads = 64;  // the threads of one frame
constexpr int kFftGroups = 4;         // frames in flight a block
constexpr int kFftThreads = kFftGroupThreads * kFftGroups;
constexpr int kFftPoints = kFftHalf / kFftGroupThreads;  // a thread's 16
constexpr int kFftMelLanes = 8;  // the lanes that sum one mel's run
// blocks resident on an SM: the register cap (128) that lets them in
constexpr int kFftBlocksPerSm = 2;
// the twiddle table (kernels/sig_mel.py::fft_twiddles): W2048^e = (cos,
// -sin)(2 pi e / 2048) for e < 256: the bases a thread raises to the
// powers it needs (W1024^t = W2048^(2 t), W64^a = W2048^(32 a)) and the
// split's W2048^(k1 + 16 c)
constexpr int kFftTw = 256;
// a block's dynamic shared memory: the twiddle table, the window (2048
// float64 taps, zero from pack on) and a buffer of 1024 complex doubles a
// group, then the projection's runs (fft_smem)
constexpr int kFftSmem =
    (kFftTw + kFftN / 2 + kFftGroups * kFftHalf) *
    static_cast<int>(sizeof(double2));
// a block's static shared memory: each group's two warp sums and two warps'
// edge taps
constexpr int kFftStatic =
    kFftGroups * 2 * (1 + kFftPoints) * static_cast<int>(sizeof(double));

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

__device__ __forceinline__ double2 c_add(double2 a, double2 b) {
  return make_double2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ double2 c_sub(double2 a, double2 b) {
  return make_double2(a.x - b.x, a.y - b.y);
}

// the radix-4 DFT of v0..v3 in place: output r where input r was
__device__ __forceinline__ void fft4(double2& v0, double2& v1, double2& v2,
                                     double2& v3) {
  const double2 a0 = c_add(v0, v2), a1 = c_sub(v0, v2), a2 = c_add(v1, v3);
  const double2 d = c_sub(v1, v3);
  const double2 a3 = make_double2(d.y, -d.x);  // -i (v1 - v3)
  v0 = c_add(a0, a2);
  v1 = c_add(a1, a3);
  v2 = c_sub(a0, a2);
  v3 = c_sub(a1, a3);
}

constexpr double kCos8 = 0.92387953251128675613;  // cos(pi / 8)
constexpr double kSin8 = 0.38268343236508977173;  // sin(pi / 8)
constexpr double kHalf2 = 0.70710678118654752440;  // sqrt(1 / 2)

// a W16^E, the power of W16 = exp(-2 pi i / 16) a compile-time constant
template <int E>
__device__ __forceinline__ double2 w16(double2 a) {
  constexpr double c1 = kCos8, s1 = kSin8, h = kHalf2;
  static_assert(E == 1 || E == 2 || E == 3 || E == 4 || E == 6 || E == 9,
                "fft16's twiddles");
  if constexpr (E == 1)
    return c_mul(a, make_double2(c1, -s1));
  else if constexpr (E == 2)
    return make_double2(h * (a.x + a.y), h * (a.y - a.x));
  else if constexpr (E == 3)
    return c_mul(a, make_double2(s1, -c1));
  else if constexpr (E == 4)
    return make_double2(a.y, -a.x);
  else if constexpr (E == 6)
    return make_double2(h * (a.y - a.x), -(h * (a.x + a.y)));
  else
    return c_mul(a, make_double2(-c1, s1));
}

// where fft16 leaves output k: 16 = 4 x 4, the digits of k swapped
__host__ __device__ constexpr int fft16_at(int k) {
  return 4 * (k & 3) + (k >> 2);
}

// the 16-point DFT of v[n] in registers, V[k] = sum_n W16^(n k) v[n], left
// at v[fft16_at(k)]: radix-4s over n = n1 + 4 n2 for each n1, the twiddles
// W16^(n1 k1), radix-4s over n1 for each k1
__device__ __forceinline__ void fft16(double2 (&v)[kFftPoints]) {
#pragma unroll
  for (int n1 = 0; n1 < 4; ++n1) fft4(v[n1], v[n1 + 4], v[n1 + 8], v[n1 + 12]);
  v[5] = w16<1>(v[5]);
  v[6] = w16<2>(v[6]);
  v[7] = w16<3>(v[7]);
  v[9] = w16<2>(v[9]);
  v[10] = w16<4>(v[10]);
  v[11] = w16<6>(v[11]);
  v[13] = w16<3>(v[13]);
  v[14] = w16<6>(v[14]);
  v[15] = w16<9>(v[15]);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    fft4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
}

// v[fft16_at(k)] times w^k for k = 1..15, the powers of w in turn
__device__ __forceinline__ void fft_turn(double2 (&v)[kFftPoints], double2 w) {
  double2 wk = w;
#pragma unroll
  for (int k = 1; k < kFftPoints; ++k) {
    if (k > 1) wk = c_mul(wk, w);
    v[fft16_at(k)] = c_mul(v[fft16_at(k)], wk);
  }
}

// the buffer's place of B[t][k1] (exchange 1)
__device__ __forceinline__ int fft_at1(int t, int k1) {
  return kFftGroupThreads * k1 + (t ^ (4 * (k1 & 1)));
}

// the buffer's place of C[k1,a][c] (exchange 2)
__device__ __forceinline__ int fft_at2(int k1, int a, int c) {
  return kFftGroupThreads * c + 4 * k1 + (a ^ ((k1 >> 1) & 3));
}

// pass 3's butterflies of thread t = 8 u + j: for j = 1..7 (k1 j and 16 -
// j) c = u, u + 8 of k1 j and their mirrors 15 - u, 7 - u of k1 16 - j; for
// j = 0 and u >= 4 (k1 8, v = u - 4) c = v, v + 4 and 15 - v, 11 - v; for j =
// 0 and u < 4 (k1 0) c = u, u + 4 and 16 - u, 12 - u (u = 0: 4, 0 and 12,
// 8). Butterfly b + 2 holds the mirror Z[1024 - k] of butterfly b's Z[k]
// (thread 0's butterflies 1 and 3 their own), and 8 consecutive threads
// read exchange 2 on 8 banks (the k1 of each butterfly differ mod 8)
__device__ __forceinline__ void fft_pass3(int t, int& klo, int& khi,
                                          int (&c)[4]) {
  const int j = t & 7, u = t >> 3, v = u & 3;
  klo = j ? j : (u & 4) * 2;
  khi = j ? 16 - j : klo;
  if (j) {
    c[0] = u;
    c[1] = u + 8;
    c[2] = 15 - u;
    c[3] = 7 - u;
  } else if (u & 4) {
    c[0] = v;
    c[1] = v + 4;
    c[2] = 15 - v;
    c[3] = 11 - v;
  } else {
    c[0] = u ? u : 4;
    c[1] = u ? u + 4 : 0;
    c[2] = 16 - c[0];
    c[3] = u ? 12 - u : 8;
  }
}

// the thread's place in its group, read anew where an exchange's addresses
// are made from it, so that the compiler keeps none of them live across
// the frame (they would take registers the FFT holds)
__device__ __forceinline__ int group_thread() {
  unsigned tid;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(tid));
  return static_cast<int>(tid % kFftGroupThreads);
}

// the group's barrier: its 64 threads alone, named barrier 1 + grp
__device__ __forceinline__ void group_sync(int grp) {
  asm volatile("bar.sync %0, %1;" ::"r"(grp + 1), "n"(kFftGroupThreads)
               : "memory");
}

// the float32 power (kMag: magnitude) of bins k and 1024 - k from za =
// Z[k], zb = Z[1024 - k] and w = W2048^k: X[k] = E + W^k O, X[1024 - k] =
// conj(E - W^k O) with E = (za + conj zb) / 2, O = -i (za - conj zb) / 2
template <bool kMag>
__device__ __forceinline__ void fft_split(double2 za, double2 zb, double2 w,
                                          float& lo, float& hi) {
  const double er = 0.5 * (za.x + zb.x), ei = 0.5 * (za.y - zb.y);
  const double orr = 0.5 * (za.y + zb.y), oi = 0.5 * (zb.x - za.x);
  const double tr = w.x * orr - w.y * oi, ti = w.x * oi + w.y * orr;
  const double xr = er + tr, xi = ei + ti, yr = er - tr, yi = ti - ei;
  if constexpr (kMag) {
    lo = static_cast<float>(sqrt(xr * xr + xi * xi));
    hi = static_cast<float>(sqrt(yr * yr + yi * yi));
  } else {
    lo = static_cast<float>(xr * xr + xi * xi);
    hi = static_cast<float>(yr * yr + yi * yi);
  }
}

// the bf2 halves of a power, p0 = bf16(p) and p1 = bf16(p - p0), as floats
__device__ __forceinline__ float2 bf2_halves(float v) {
  const float h = __bfloat162float(__float2bfloat16_rn(v));
  return make_float2(h, __bfloat162float(__float2bfloat16_rn(__fsub_rn(v, h))));
}

// bins k and 1024 - k from za = Z[k], zb = Z[1024 - k] and w = W2048^k
// (fft_split), their power's bf2 halves into pq
template <bool kMag>
__device__ __forceinline__ void fft_put(double2 za, double2 zb, double2 w,
                                        float2* pq, int k) {
  float lo, hi;
  fft_split<kMag>(za, zb, w, lo, hi);
  pq[k] = bf2_halves(lo);
  pq[kFftHalf - k] = bf2_halves(hi);
}

// the dynamic shared memory of a block for a projection of n_mels runs of
// nnz values in all
inline long long fft_smem(int n_mels, int nnz) {
  const long long runs = 4LL * (2 * n_mels + 1) + 4LL * nnz;
  return kFftSmem + (runs + 15) / 16 * 16;
}

// thread t's taps 2j, 2j + 1 of z[j], j = t + 64 n, of the frame at xf
// with left taps of the clip from xf on: zero from pack and from left on
// (where the frame's 2048 taps lie inside the clip and xf is 8-byte
// aligned, as nearly every frame, one 8-byte load a pair)
__device__ __forceinline__ void fft_load(const float* xf, long long left,
                                         int pack, int t,
                                         float2 (&xv)[kFftPoints]) {
  if ((reinterpret_cast<uintptr_t>(xf) & 7) == 0 && left >= kFftN) {
#pragma unroll
    for (int n = 0; n < kFftPoints; ++n) {
      const int i = 2 * (t + kFftGroupThreads * n);
      float2 v = make_float2(0.0f, 0.0f);
      if (i < pack) v = __ldg(reinterpret_cast<const float2*>(xf + i));
      if (i + 1 >= pack) v.y = 0.0f;
      xv[n] = v;
    }
    return;
  }
  const long long lim = left < pack ? left : pack;
#pragma unroll
  for (int n = 0; n < kFftPoints; ++n) {
    const int i = 2 * (t + kFftGroupThreads * n);
    xv[n].x = i < lim ? __ldg(xf + i) : 0.0f;
    xv[n].y = i + 1 < lim ? __ldg(xf + i + 1) : 0.0f;
  }
}

// kMag: the magnitude heads' instance, else the power heads' (the host
// picks one a launch)
template <bool kMag>
__global__ void __launch_bounds__(kFftThreads, kFftBlocksPerSm)
    sig_mel_fft_kernel(const Fft p) {
  extern __shared__ __align__(16) unsigned char fft_smem_[];
  __shared__ double red[kFftGroups][2];
  // Kaldi: each warp's odd taps of lane 31, the sample before the other
  // warp's lane 0 (j = 32 + 64 n after j = 31 + 64 n; j = 64 n after 63 +
  // 64 (n - 1))
  __shared__ double edge[kFftGroups][2][kFftPoints];
  double2* stw = reinterpret_cast<double2*>(fft_smem_);
  double* swin = reinterpret_cast<double*>(stw + kFftTw);
  double2* bufs = stw + kFftTw + kFftN / 2;
  int* soff = reinterpret_cast<int*>(bufs + kFftGroups * kFftHalf);
  int* slo = soff + p.n_mels + 1;
  // the runs' filters, F0 and F1 of a value side by side
  __nv_bfloat162* sf = reinterpret_cast<__nv_bfloat162*>(slo + p.n_mels);
  for (int e = threadIdx.x; e < kFftTw; e += kFftThreads) stw[e] = p.tw[e];
  for (int i = threadIdx.x; i < kFftN; i += kFftThreads)
    swin[i] = i < p.pack ? p.window[i] : 0.0;
  for (int m = threadIdx.x; m <= p.n_mels; m += kFftThreads)
    soff[m] = p.mel_off[m];
  for (int m = threadIdx.x; m < p.n_mels; m += kFftThreads)
    slo[m] = p.mel_lo[m];
  for (int j = threadIdx.x; j < p.nnz; j += kFftThreads)
    sf[j] = __halves2bfloat162(p.f0[j], p.f1[j]);
  __syncthreads();  // the block's only barrier: the groups share the tables

  const int grp = threadIdx.x / kFftGroupThreads;
  const int t = threadIdx.x % kFftGroupThreads, lane = t & 31, warp = t >> 5;
  double2* buf = bufs + grp * kFftHalf;
  // the group's contiguous run of frames [g0, g1)
  const long long groups = static_cast<long long>(gridDim.x) * kFftGroups;
  const long long gid = static_cast<long long>(blockIdx.x) * kFftGroups + grp;
  const long long g0 = gid * p.frames / groups;
  const long long g1 = (gid + 1) * p.frames / groups;
  const bool kaldi = p.preemph >= 0.0;
  // clip b's frame kf, counted along the group's run of frames
  long long b = g0 / p.n_frames;
  int kf = static_cast<int>(g0 - b * p.n_frames);
  for (long long g = g0; g < g1; ++g) {
    const long long s = p.start + static_cast<long long>(kf) * p.hop;
    // the taps in float64, each converted once (the conversion runs at a
    // quarter of the float64 units' rate), then the windowed taps
    double2 v[kFftPoints];
    {
      float2 xv[kFftPoints];
      fft_load(p.x + b * p.T + s, p.T - s, p.pack, t, xv);
#pragma unroll
      for (int n = 0; n < kFftPoints; ++n)
        v[n] = make_double2(xv[n].x, xv[n].y);
    }
    if (++kf == p.n_frames) {
      kf = 0;
      ++b;
    }
    double mean = 0.0;
    if (kaldi) {
      double part = 0.0;
#pragma unroll
      for (int n = 0; n < kFftPoints; ++n) part += v[n].x + v[n].y;
      for (int sh = 16; sh > 0; sh >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, sh);
      if (lane == 0) red[grp][warp] = part;
      if (lane == 31) {
#pragma unroll
        for (int n = 0; n < kFftPoints; ++n) edge[grp][warp][n] = v[n].y;
      }
      // also: the group's previous frame is done with its buffer
      group_sync(grp);
      mean = (red[grp][0] + red[grp][1]) / p.pack;
    } else {
      group_sync(grp);  // the group's previous frame is done with its buffer
    }
#pragma unroll
    for (int n = 0; n < kFftPoints; ++n) {
      const int i = 2 * (t + kFftGroupThreads * n);
      const double2 w = reinterpret_cast<const double2*>(swin)[i >> 1];
      double d0 = v[n].x, d1 = v[n].y;
      if (kaldi) {
        // x[i - 1]: the neighbour lane's odd tap, for lane 0 the other
        // warp's lane 31 (warp 0: its previous n; tap 0 has none)
        const double up = __shfl_up_sync(0xffffffffu, v[n].y, 1);
        const double before = lane ? up
                              : warp ? edge[grp][0][n]
                              : n    ? edge[grp][1][n - 1]
                                     : 0.0;
        d0 -= mean;
        if (i > 0) d0 -= p.preemph * (before - mean);
        d1 -= mean;
        d1 -= p.preemph * (v[n].x - mean);
      }
      v[n] = make_double2(w.x * d0, w.y * d1);
    }
    // pass 1: the radix-16 over n in thread t, then W1024^(t k1)
    fft16(v);
    fft_turn(v, stw[2 * t]);
    {
      // fft_at1(t, k1) for k1 even and odd, the rest in immediates
      const int u = group_thread();
      double2* w0 = buf + fft_at1(u, 0);
      double2* w1 = buf + fft_at1(u, 1) - kFftGroupThreads;
#pragma unroll
      for (int k1 = 0; k1 < kFftPoints; ++k1)
        ((k1 & 1) ? w1 : w0)[kFftGroupThreads * k1] = v[fft16_at(k1)];
    }
    group_sync(grp);
    // pass 2: the radix-16 over b in thread (k1, a), then W64^(a c)
    {
      const int u = group_thread(), k1 = u >> 2, a = u & 3;
      // fft_at1(a + 4 b, k1) for b even and odd
      const double2* r0 = buf + fft_at1(a, k1);
      const double2* r1 = buf + fft_at1(a + 4, k1) - 4;
#pragma unroll
      for (int bb = 0; bb < kFftPoints; ++bb)
        v[bb] = ((bb & 1) ? r1 : r0)[4 * bb];
      fft16(v);
      fft_turn(v, stw[32 * a]);
      group_sync(grp);
      double2* w = buf + fft_at2(k1, a, 0);
#pragma unroll
      for (int c = 0; c < kFftPoints; ++c)
        w[kFftGroupThreads * c] = v[fft16_at(c)];
      group_sync(grp);
    }
    // pass 3: four radix-4s over a in thread t, butterfly b on (k1, c[b])
    // with k1 = klo for b < 2, khi else (fft_pass3): Z[k1 + 16 c + 256 d] at
    // v[4 b + d], and Z[1024 - k] of v[4 b + d] at v[4 (b + 2) + 3 - d]
    int klo, khi, c3[4];
    fft_pass3(group_thread(), klo, khi, c3);
#pragma unroll
    for (int bq = 0; bq < 4; ++bq) {
      // fft_at2(k1, a, c) = fft_at2(k1, 0, c) ^ a
      const int at = fft_at2(bq < 2 ? klo : khi, 0, c3[bq]);
#pragma unroll
      for (int a = 0; a < 4; ++a) v[4 * bq + a] = buf[at ^ a];
      fft4(v[4 * bq], v[4 * bq + 1], v[4 * bq + 2], v[4 * bq + 3]);
    }
    group_sync(grp);  // every thread is done reading exchange 2
    // the bins k = klo + 16 c[b] + 256 d (b < 2) and 1024 - k from the
    // registers, W2048^k = W2048^(klo + 16 c[b]) W8^d, their power's bf2
    // halves by bin through the buffer; thread 0's butterflies 1 and 3 (c 0
    // and 8 of k1 0: Z[256 d] and Z[128 + 256 d]) pair among themselves:
    // bins 0 and 512 alone, 256 and 768, 128 and 896, 384 and 640
    float2* pq = reinterpret_cast<float2*>(buf);
#pragma unroll
    for (int bq = 0; bq < 2; ++bq) {
      if (bq == 0 || t) {
        const int k = klo + 16 * c3[bq];
        const double2 w = stw[k];
        fft_put<kMag>(v[4 * bq], v[4 * bq + 11], w, pq, k);
        fft_put<kMag>(v[4 * bq + 1], v[4 * bq + 10], w16<2>(w), pq, k + 256);
        fft_put<kMag>(v[4 * bq + 2], v[4 * bq + 9], w16<4>(w), pq, k + 512);
        fft_put<kMag>(v[4 * bq + 3], v[4 * bq + 8], w16<6>(w), pq, k + 768);
      }
    }
    if (t == 0) {
      constexpr double c1 = kCos8, s1 = kSin8, h = kHalf2;
      float bin, unused;
      fft_split<kMag>(v[4], v[4], make_double2(1.0, 0.0), bin, unused);
      pq[0] = bf2_halves(bin);
      fft_split<kMag>(v[6], v[6], make_double2(0.0, -1.0), bin, unused);
      pq[kFftHalf / 2] = bf2_halves(bin);
      fft_put<kMag>(v[5], v[7], make_double2(h, -h), pq, 256);
      fft_put<kMag>(v[12], v[15], make_double2(c1, -s1), pq, 128);
      fft_put<kMag>(v[13], v[14], make_double2(s1, -c1), pq, 384);
    }
    group_sync(grp);
    // each mel's sum into the buffer past the halves, then its ln a thread
    float* se = reinterpret_cast<float*>(buf + kFftHalf / 2);
    constexpr int kMels = kFftGroupThreads / kFftMelLanes;  // at a time
    const int sub = t % kFftMelLanes;
    for (int base = 0; base < p.n_mels; base += kMels) {
      const int m = base + t / kFftMelLanes;
      const bool on = m < p.n_mels;
      const int o0 = on ? soff[m] : 0, n = on ? soff[m + 1] - o0 : 0;
      const float2* pm = pq + (on ? slo[m] : 0);
      float e = 0.0f;
      // most runs take one to four rounds: no unrolled body and remainder
#pragma unroll 1
      for (int j = sub; j < n; j += kFftMelLanes) {
        const float2 qq = pm[j];
        const __nv_bfloat162 ff = sf[o0 + j];
        const float a = __low2float(ff), c = __high2float(ff);
        e = __fmaf_rn(qq.x, a, e);
        e = __fmaf_rn(qq.x, c, e);
        e = __fmaf_rn(qq.y, a, e);
      }
      for (int sh = kFftMelLanes / 2; sh > 0; sh >>= 1)
        e = __fadd_rn(e, __shfl_xor_sync(0xffffffffu, e, sh));
      if (on && sub == 0) se[m] = e;
    }
    group_sync(grp);
    for (int m = t; m < p.n_mels; m += kFftGroupThreads) {
      const float e = se[m];
      p.out[g * p.n_mels + m] = ln_accurate(
          p.out_mode == kLnGuard ? __fadd_rn(e, p.guard) : fmaxf(e, p.guard));
    }
  }
}

}  // namespace sigk
