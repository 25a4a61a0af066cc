// K5-K8 for Hopper (sm_90a): whisper log-mel of pre-framed [n_rows, ld]
// float32 frames through one of four DFT schemes, one launch for all frames.
//
// Replaces the TPU kernels of melspec_tpu/ops/mel_kernel.py:
//   K8 _mel_tile_kernel (launched by _pallas_mel_frames): plain float32;
//   K5 _bf3_mel_tile_kernel (_pallas_bf3_mel_frames): rounded-bf16 slices;
//   K6 _hp8_mel_tile_kernel (_pallas_hp8_mel_frames): int8 Ozaki split;
//   K7 _hp_mel_tile_kernel (_pallas_hp_mel_frames): bf16-integer Ozaki.
// One template over the scheme; framing, power, projection and epilogue
// are shared. For frame n it computes:
//   1. the signal slices of its first `taps` samples: the frame itself
//      (f32); the bf16 residual cascade, each slice rounded to nearest even
//      (bf3); or, after the power-of-two row scale sigma = 2^(e+1) > max|x|
//      taken from the exponent bits (clamped at 0xFD), the 7-bit integer
//      slices t_i = trunc(128 r), r <- 128 r - t_i of r = x / sigma (Ozaki);
//   2. the slice pairs (i, j), i, j < ks, i + j <= cutoff: the dot of
//      signal slice i with matrix plane j over the taps, for the re (cos)
//      and im (-sin) columns. A product of two slice values is exact in
//      float32, and an Ozaki pair's dot is an exact integer (int32 for int8);
//   3. the same-scale groups s = i + j, each adding its pairs in increasing
//      i. bf3 sums the groups largest-first in float32. Ozaki scales group
//      s by 128^-(s+2) (exact) and chains the groups, largest first, through
//      two-sums into (hi, lo); power = ((hi_re^2 + hi_im^2) + 2 (hi_re lo_re
//      + hi_im lo_im)) sigma^2. f32 and bf3 take power = re^2 + im^2;
//   4. energy = power @ mt in float32, log10_accurate(max(energy, 1e-10)),
//      the whisper norm, out[n, :n_mels] (logs and norm: sig_common.cuh).
// Every compensated step is written with the _rn intrinsics, which nvcc
// never contracts into FMAs, in the JAX kernels' order; so an Ozaki
// scheme's DFT equals its plain PyTorch version bit for bit.
//
// What bounds it: operations. At whisper 400/160/128 a frame needs 2 * 400
// taps x 399 nonzero DFT columns per kept slice pair (6 for bf3, 13 for
// hp8 in int8, 19 for hp_bf16, 1 for f32) against 1.6 KB of frame in and
// 512 B of output: hundreds to thousands of operations per byte. This
// first version runs the pair dots as SIMT FMAs (int32 multiply-adds for
// int8). A block owns a tile of 32 frames (16 where shared memory is
// short) and every mel column, and keeps the tile's signal slices in
// shared memory for the whole launch. It walks the bins in chunks of 128:
// for each chunk it runs the pairs group by group, streaming the pair's
// plane columns (re and im) through shared memory 16 rows at a time with
// the next rows prefetched into registers; each thread holds 4 (2) frames
// x 4 bins x (re, im) of the pair, group and two-float sums in registers.
// The chunk's power then goes through shared memory into energy +=
// power_chunk @ mt[chunk], kept in shared memory until the epilogue.
// Nothing is sized to a fixed column count: fft 1024's 512-bin planes are
// four chunks. The tensor-core (mma / wgmma) version is later work.
//
// Plain C interface, built with nvcc and bound with ctypes
// (melspec_tpu_torch/kernels/framed_mel.py). Every launch is followed by
// cudaGetLastError, and its code is returned.

#include <type_traits>

#include "sig_common.cuh"

namespace {

using namespace sigk;

enum Scheme { kF32 = 0, kBf3 = 1, kInt8 = 2, kBf16Int = 3 };

constexpr int kFT = 256;         // threads per block
constexpr int kCB = 128;         // bins per chunk
constexpr int kCols = 2 * kCB;   // re | im columns of a staged plane row
constexpr int kKC = 16;          // plane rows staged per step
constexpr int kMaxS = 6;         // signal slices and matrix planes
constexpr int kMaxPairs = kMaxS * kMaxS;
constexpr int kMaxMelsPad = 256;
constexpr long long kMaxSmem = 232448;

struct Params {
  const float* frames;  // [n_rows, ld]
  long long n_rows;
  int ld, taps, kp;     // kp: taps rounded up to whole steps
  // signal slice i's matrix: plane j's re column c at re[i] + row * ldm[i]
  // + j * nbp + c, its im column at im[i] + ... (elements)
  const void* re[kMaxS];
  const void* im[kMaxS];
  int ldm[kMaxS];
  int nbp, n_chunks;
  int ks, n_pairs;
  // the kept pairs in group order: s = i + j ascending, i ascending
  unsigned char pi[kMaxPairs], pj[kMaxPairs], ps[kMaxPairs];
  const float* mt;      // [nbp, nmp]
  int n_mels, nmp;
  float* out;           // [n_rows, n_mels]
};

// per scheme: the staged signal slice (A), the plane element in device
// memory (G) and in shared memory (B), plane elements per 16-byte load
template <int S> struct Tr;
template <> struct Tr<kF32> {
  using A = float; using G = float; using B = float;
  static constexpr int kVec = 4;
};
template <> struct Tr<kBf3> {
  using A = __nv_bfloat16; using G = __nv_bfloat16; using B = float;
  static constexpr int kVec = 8;
};
template <> struct Tr<kInt8> {
  using A = signed char; using G = signed char; using B = int;
  static constexpr int kVec = 16;
};
template <> struct Tr<kBf16Int> {
  using A = signed char; using G = __nv_bfloat16; using B = float;
  static constexpr int kVec = 8;
};

__host__ __device__ inline int a_bytes(int scheme) {
  return scheme == kF32 ? 4 : scheme == kBf3 ? 2 : 1;
}

// shared memory of one block: the tile's slices, one staged step of plane
// rows (later the chunk's power tile), the energy tile
__host__ __device__ inline long long smem_bytes(int scheme, int ks, int kp,
                                                int nmp, int tile) {
  return align16(static_cast<long long>(a_bytes(scheme)) * ks * tile * kp) +
         4LL * kKC * kCols + 4LL * tile * nmp;
}

__device__ __forceinline__ void two_sum(float a, float b, float& s,
                                        float& err) {
  s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  err = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
}

// the sign-extended byte q of w
__device__ __forceinline__ int sbyte(unsigned w, int q) {
  return static_cast<int>(w << (24 - 8 * q)) >> 24;
}

template <int S, int FPW>
__global__ void __launch_bounds__(kFT, 1) framed_mel_kernel(const Params p) {
  using A = typename Tr<S>::A;
  using G = typename Tr<S>::G;
  using B = typename Tr<S>::B;
  using Acc = typename std::conditional<S == kInt8, int, float>::type;
  constexpr int kTile = 8 * FPW;
  constexpr int kVec = Tr<S>::kVec;
  constexpr int kVpr = kCols / kVec;  // 16-byte loads per staged row
  constexpr int kVpt = kKC * kVpr / kFT;
  constexpr bool kOzaki = S == kInt8 || S == kBf16Int;
  static_assert(kKC * kVpr % kFT == 0, "step split");
  static_assert(kTile * kCB <= kKC * kCols, "power tile fits the step");

  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int f0 = (tid >> 5) * FPW;  // this warp's frames in the tile
  const long long n0 = static_cast<long long>(blockIdx.x) * kTile;
  const long long slice_len = static_cast<long long>(kTile) * p.kp;
  A* sa = reinterpret_cast<A*>(smem);  // [ks][kTile][kp]
  unsigned char* work = smem + align16(sizeof(A) * p.ks * slice_len);
  B* sb = reinterpret_cast<B*>(work);          // [kKC][kCols]
  float* sp = reinterpret_cast<float*>(work);  // [kTile][kCB]
  float* se = reinterpret_cast<float*>(work + 4 * kKC * kCols);  // [kTile][nmp]

  // 1. this warp's frames: row scale, signal slices; energy rows zeroed
  float sigma[FPW];
#pragma unroll
  for (int f = 0; f < FPW; ++f) {
    const int row = f0 + f;
    const long long n = n0 + row;
    const bool live = n < p.n_rows;
    const float* x = p.frames + (live ? n : 0) * p.ld;
    sigma[f] = 1.0f;
    if constexpr (kOzaki) {
      float mx = 0.0f;
      if (live)
        for (int k = lane; k < p.taps; k += 32)
          mx = max_nan(mx, fabsf(__ldg(x + k)));
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = max_nan(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const int bits = __float_as_int(max_nan(mx, 1e-38f));
      sigma[f] = __int_as_float((min((bits >> 23) & 0xFF, 0xFD) + 1) << 23);
    }
    A* a = sa + static_cast<long long>(row) * p.kp;
    for (int k = lane; k < p.kp; k += 32) {
      const float v = (live && k < p.taps) ? __ldg(x + k) : 0.0f;
      if constexpr (S == kF32) {
        a[k] = v;
      } else if constexpr (S == kBf3) {
        float r = v;
        for (int i = 0; i < p.ks; ++i) {
          const __nv_bfloat16 h = __float2bfloat16_rn(r);
          a[i * slice_len + k] = h;
          r = __fsub_rn(r, __bfloat162float(h));
        }
      } else {
        float r = __fdiv_rn(v, sigma[f]);
        for (int i = 0; i < p.ks; ++i) {
          const float sc = __fmul_rn(r, 128.0f);
          const float t = truncf(sc);
          a[i * slice_len + k] = static_cast<signed char>(static_cast<int>(t));
          r = __fsub_rn(sc, t);
        }
      }
    }
    for (int m = lane; m < p.nmp; m += 32) se[row * p.nmp + m] = 0.0f;
  }

  // 2.-3. per chunk of bins, the pairs group by group
  const int nkc = p.kp / kKC;
  const int steps = p.n_chunks * p.n_pairs * nkc;
  uint4 pre[kVpt];
  auto fetch = [&](int t) {
    const int kc = t % nkc;
    const int q = t / nkc;
    const int pr = q % p.n_pairs;
    const int cb = q / p.n_pairs;
    const int i = p.pi[pr];
    const long long col0 = static_cast<long long>(p.pj[pr]) * p.nbp + cb * kCB;
#pragma unroll
    for (int v = 0; v < kVpt; ++v) {
      const int l = tid + v * kFT;
      const int r = l / kVpr;
      const int cv = l - r * kVpr;
      const int comp = cv >= kVpr / 2;
      const int col = (cv - comp * (kVpr / 2)) * kVec;
      const int k = kc * kKC + r;
      const G* src = static_cast<const G*>(comp ? p.im[i] : p.re[i]) +
                     static_cast<long long>(k) * p.ldm[i] + col0 + col;
      pre[v] = k < p.taps ? __ldg(reinterpret_cast<const uint4*>(src))
                          : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int v = 0; v < kVpt; ++v) {
      const int l = tid + v * kFT;
      const int r = l / kVpr;
      const int cv = l - r * kVpr;
      const int comp = cv >= kVpr / 2;
      const int col = (cv - comp * (kVpr / 2)) * kVec;
      B* dst = sb + r * kCols + comp * kCB + col;
      const uint4 u = pre[v];
      if constexpr (S == kF32) {
        *reinterpret_cast<float4*>(dst) =
            make_float4(__uint_as_float(u.x), __uint_as_float(u.y),
                        __uint_as_float(u.z), __uint_as_float(u.w));
      } else if constexpr (S == kInt8) {
        const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int q = 0; q < 4; ++q)
          reinterpret_cast<int4*>(dst)[q] =
              make_int4(sbyte(w[q], 0), sbyte(w[q], 1), sbyte(w[q], 2),
                        sbyte(w[q], 3));
      } else {
        // a bf16 is the high half of its float32: widening is exact
        float4* d = reinterpret_cast<float4*>(dst);
        d[0] = make_float4(bf16_lo(u.x), bf16_hi(u.x), bf16_lo(u.y),
                           bf16_hi(u.y));
        d[1] = make_float4(bf16_lo(u.z), bf16_hi(u.z), bf16_lo(u.w),
                           bf16_hi(u.w));
      }
    }
  };

  // thread's outputs: frames f0 + f, bins 4 * lane + e of the chunk, re
  // in [e], im in [4 + e]
  Acc acc[FPW][8];
  float grp[FPW][8], res[FPW][8], lo[FPW][8];
  fetch(0);
  for (int t = 0; t < steps; ++t) {
    const int kc = t % nkc;
    const int q = t / nkc;
    const int pr = q % p.n_pairs;
    const int cb = q / p.n_pairs;
    const int s = p.ps[pr];
    const bool group_first = pr == 0 || p.ps[pr - 1] != s;
    const bool group_last = pr + 1 == p.n_pairs || p.ps[pr + 1] != s;
    if (kc == 0 && (S != kInt8 || group_first)) {
#pragma unroll
      for (int f = 0; f < FPW; ++f)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[f][e] = Acc(0);
    }
    __syncthreads();  // the last step's rows (or power tile) are consumed
    stage();
    __syncthreads();
    if (t + 1 < steps) fetch(t + 1);

    const A* a0 = sa + p.pi[pr] * slice_len +
                  static_cast<long long>(f0) * p.kp + kc * kKC;
#pragma unroll 4
    for (int kk = 0; kk < kKC; ++kk) {
      Acc av[FPW];
#pragma unroll
      for (int f = 0; f < FPW; ++f) {
        const A raw = a0[f * p.kp + kk];
        if constexpr (S == kBf3) av[f] = __bfloat162float(raw);
        else av[f] = static_cast<Acc>(raw);
      }
      const B* br = sb + kk * kCols + 4 * lane;
      B bv[8];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        bv[e] = br[e];
        bv[4 + e] = br[kCB + e];
      }
#pragma unroll
      for (int f = 0; f < FPW; ++f)
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          if constexpr (S == kInt8) acc[f][e] += av[f] * bv[e];
          else acc[f][e] = fmaf(av[f], bv[e], acc[f][e]);
        }
    }
    if (kc + 1 < nkc) continue;

    // the pair is done: into its group (pairs in increasing i)
    if constexpr (S == kBf3 || S == kBf16Int) {
#pragma unroll
      for (int f = 0; f < FPW; ++f)
#pragma unroll
        for (int e = 0; e < 8; ++e)
          grp[f][e] = group_first ? acc[f][e] : __fadd_rn(grp[f][e], acc[f][e]);
    }
    if (!group_last) continue;

    // the group is done: into the sum, largest scale first
    const bool sum_first = s == p.ps[0];
    // 128^-(s+2), a power of two
    const float scale = __int_as_float((127 - 7 * (s + 2)) << 23);
#pragma unroll
    for (int f = 0; f < FPW; ++f)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if constexpr (S == kF32) {
          res[f][e] = acc[f][e];
        } else if constexpr (S == kBf3) {
          res[f][e] = sum_first ? grp[f][e] : __fadd_rn(res[f][e], grp[f][e]);
        } else {
          float g;
          if constexpr (S == kInt8) g = __int2float_rn(acc[f][e]);
          else g = grp[f][e];
          const float term = __fmul_rn(g, scale);
          if (sum_first) {
            res[f][e] = term;
            lo[f][e] = 0.0f;
          } else {
            float err;
            two_sum(res[f][e], term, res[f][e], err);
            lo[f][e] = __fadd_rn(lo[f][e], err);
          }
        }
      }
    if (pr + 1 < p.n_pairs) continue;

    // the chunk is done: its power through shared memory into the energy
    __syncthreads();  // every warp is done with the staged rows
#pragma unroll
    for (int f = 0; f < FPW; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pw;
        if constexpr (kOzaki) {
          float rh, rl, ih, il;
          two_sum(res[f][e], lo[f][e], rh, rl);
          two_sum(res[f][4 + e], lo[f][4 + e], ih, il);
          pw = __fadd_rn(__fadd_rn(__fmul_rn(rh, rh), __fmul_rn(ih, ih)),
                         __fmul_rn(2.0f, __fadd_rn(__fmul_rn(rh, rl),
                                                   __fmul_rn(ih, il))));
          pw = __fmul_rn(pw, __fmul_rn(sigma[f], sigma[f]));
        } else {
          pw = __fadd_rn(__fmul_rn(res[f][e], res[f][e]),
                         __fmul_rn(res[f][4 + e], res[f][4 + e]));
        }
        sp[(f0 + f) * kCB + 4 * lane + e] = pw;
      }
    __syncwarp();
    const int nq = p.nmp / 32;
    float en[FPW][kMaxMelsPad / 32];
#pragma unroll
    for (int f = 0; f < FPW; ++f)
#pragma unroll
      for (int m = 0; m < kMaxMelsPad / 32; ++m)
        if (m < nq) en[f][m] = se[(f0 + f) * p.nmp + lane + 32 * m];
    const float* g = p.mt + static_cast<long long>(cb) * kCB * p.nmp + lane;
    for (int c = 0; c < kCB; ++c) {
      float pw[FPW];
#pragma unroll
      for (int f = 0; f < FPW; ++f) pw[f] = sp[(f0 + f) * kCB + c];
#pragma unroll
      for (int m = 0; m < kMaxMelsPad / 32; ++m) {
        if (m >= nq) continue;
        const float w = __ldg(g + c * p.nmp + 32 * m);
#pragma unroll
        for (int f = 0; f < FPW; ++f) en[f][m] = fmaf(pw[f], w, en[f][m]);
      }
    }
#pragma unroll
    for (int f = 0; f < FPW; ++f)
#pragma unroll
      for (int m = 0; m < kMaxMelsPad / 32; ++m)
        if (m < nq) se[(f0 + f) * p.nmp + lane + 32 * m] = en[f][m];
  }

  // 4. logs, then the whisper norm of each of this warp's rows
  __syncwarp();
#pragma unroll
  for (int f = 0; f < FPW; ++f) {
    float* lg = se + (f0 + f) * p.nmp;
    for (int m = lane; m < p.nmp; m += 32)
      lg[m] = log10_accurate(max_nan(lg[m], kLogFloor));
  }
  __syncwarp();
#pragma unroll
  for (int f = 0; f < FPW; ++f) {
    const long long n = n0 + f0 + f;
    whisper_norm_row(se + (f0 + f) * p.nmp, p.nmp, p.n_mels,
                     n < p.n_rows ? p.out + n * p.n_mels : nullptr, false);
  }
}

int plan_tile(int scheme, int ks, int taps, int nmp, long long* smem) {
  const int kp = (taps + kKC - 1) / kKC * kKC;
  for (int tile = 32; tile >= 16; tile /= 2) {
    *smem = smem_bytes(scheme, ks, kp, nmp, tile);
    if (*smem <= kMaxSmem) return tile;
  }
  return 0;
}

template <int S, int FPW>
cudaError_t launch(const Params& p, long long smem, cudaStream_t stream) {
  const long long grid = (p.n_rows + 8 * FPW - 1) / (8 * FPW);
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      framed_mel_kernel<S, FPW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  framed_mel_kernel<S, FPW><<<static_cast<unsigned>(grid), kFT,
                              static_cast<size_t>(smem), stream>>>(p);
  return cudaGetLastError();
}

template <int S>
cudaError_t launch_scheme(const Params& p, int tile, long long smem,
                          cudaStream_t stream) {
  return tile == 32 ? launch<S, 4>(p, smem, stream)
                    : launch<S, 2>(p, smem, stream);
}

}  // namespace

extern "C" {

// The frames per block the launcher takes for these arguments (32 or 16;
// 0: none fits) and, in *smem, that tile's shared memory (the 16-frame
// tile's when none fits).
int melspec_framed_mel_plan(int scheme, int ks, int taps, int nmp,
                            long long* smem) {
  return plan_tile(scheme, ks, taps, nmp, smem);
}

// Returns 0 or the cudaError_t of the launch (cudaErrorInvalidValue for
// arguments the kernel does not take). re / im / ldm are host arrays of ks
// entries (see Params); ks signal slices meet as many matrix planes, and
// the pairs follow from (ks, cutoff).
int melspec_framed_mel(int scheme, const float* frames, long long n_rows,
                       int ld, int taps, const void* const* re,
                       const void* const* im, const int* ldm, int nbp,
                       int ks, int cutoff, const float* mt, int n_mels,
                       int nmp, float* out, void* stream) {
  if (n_rows <= 0) return cudaSuccess;
  if (scheme < kF32 || scheme > kBf16Int || ks < 1 || ks > kMaxS ||
      cutoff < 0 || taps < 1 || taps > ld || nbp < kCB || nbp % kCB != 0 ||
      nmp < 128 || nmp % 128 != 0 || nmp > kMaxMelsPad || n_mels < 1 ||
      n_mels > nmp || (scheme == kF32 && ks != 1))
    return cudaErrorInvalidValue;
  Params p;
  p.frames = frames;
  p.n_rows = n_rows;
  p.ld = ld;
  p.taps = taps;
  p.kp = (taps + kKC - 1) / kKC * kKC;
  const int gsize = scheme == kF32 ? 4 : scheme == kInt8 ? 1 : 2;
  for (int i = 0; i < kMaxS; ++i) {
    p.re[i] = i < ks ? re[i] : nullptr;
    p.im[i] = i < ks ? im[i] : nullptr;
    p.ldm[i] = i < ks ? ldm[i] : 0;
    if (i < ks && ((reinterpret_cast<uintptr_t>(re[i]) |
                    reinterpret_cast<uintptr_t>(im[i])) % 16 != 0 ||
                   (static_cast<long long>(ldm[i]) * gsize) % 16 != 0))
      return cudaErrorInvalidValue;
  }
  p.nbp = nbp;
  p.n_chunks = nbp / kCB;
  p.ks = ks;
  p.n_pairs = 0;
  for (int s = 0; s <= cutoff; ++s)
    for (int i = 0; i < ks; ++i) {
      const int j = s - i;
      if (j < 0 || j >= ks) continue;
      p.pi[p.n_pairs] = static_cast<unsigned char>(i);
      p.pj[p.n_pairs] = static_cast<unsigned char>(j);
      p.ps[p.n_pairs] = static_cast<unsigned char>(s);
      ++p.n_pairs;
    }
  p.mt = mt;
  p.n_mels = n_mels;
  p.nmp = nmp;
  p.out = out;
  long long smem = 0;
  const int tile = plan_tile(scheme, ks, taps, nmp, &smem);
  if (tile == 0) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (scheme) {
    case kF32: return launch_scheme<kF32>(p, tile, smem, st);
    case kBf3: return launch_scheme<kBf3>(p, tile, smem, st);
    case kInt8: return launch_scheme<kInt8>(p, tile, smem, st);
    default: return launch_scheme<kBf16Int>(p, tile, smem, st);
  }
}

const char* melspec_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
