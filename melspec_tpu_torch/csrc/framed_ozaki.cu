// K6 and K7 for Hopper (sm_90a): whisper log-mel of pre-framed [n_rows, ld]
// float32 frames through an Ozaki DFT on the tensor cores, one launch for
// all frames.
//
// Replaces the TPU kernels of melspec_tpu/ops/mel_kernel.py:
//   K6 _hp8_mel_tile_kernel (launched by _pallas_hp8_mel_frames): int8
//      slices and planes, the pairs of a scale summed in int32;
//   K7 _hp_mel_tile_kernel (_pallas_hp_mel_frames): 7-bit integer slices
//      against integer-valued bf16 planes, every pair its own float32 dot.
// For frame n it computes:
//   1. the power-of-two row scale sigma = 2^(e+1) > max|x| (exponent bits,
//      clamped at 0xFD) and the 7-bit integer signal slices t_i =
//      trunc(128 r), r <- 128 r - t_i of r = x / sigma, i < ks;
//   2. the slice pairs (i, j), i, j < ks, i + j <= cutoff, in group order
//      (s = i + j ascending, i ascending): the dot of slice i with matrix
//      plane j over the taps, for the re (cos) and im (-sin) columns, on
//      the tensor cores;
//        K7: wgmma m64n64k16 f16 x f16 -> float32, one accumulation per
//            pair. The planes are integers with |M| <= 128 and the slices
//            |t| <= 127, exact in float16 as in bf16 (the launcher checks
//            the planes), so every product is an integer <= 16,256 and, up
//            to 1,032 taps, every partial sum an integer below 2^24: exact
//            in float32 in any order, and the pair equals the plain
//            version's float32 dot bit for bit. Above 1,032 taps a pair
//            can pass 2^24 and round in the tensor core's order; only the
//            bar against the plain version (1e-6) holds there. A pair is
//            folded into its group with __fadd_rn in increasing i, as the
//            plain version adds them;
//        K6: wgmma m64n64k32 s8 x s8 -> int32, one accumulation per group:
//            the group's pairs follow one another along K (taps padded
//            with zeros to a multiple of 32), and an int32 sum of int8
//            products is exact in any order while pairs x taps x 127^2 <
//            2^31. Then __int2float_rn;
//   3. group s scaled by 128^-(s+2) (exact) and chained largest scale
//      first through two-sums into (hi, lo); power = ((hi_re^2 + hi_im^2)
//      + 2 (hi_re lo_re + hi_im lo_im)) sigma^2, every step an _rn
//      intrinsic (nvcc never contracts those), in ops/hp_dft.py's order:
//      the power equals the plain version's two_float_power bit for bit
//      (written to `power` when the caller asks, before the projection);
//   4. energy = power @ mt as float32 FMAs over the bins in ascending
//      order, log10_accurate(max(energy, 1e-10)), the whisper norm,
//      out[n, :n_mels] (sig_common.cuh), the order of the SIMT kernels
//      these replace, so their outputs are reproduced bit for bit too.
//
// What bounds it: operations. At whisper 400/160/128 a frame needs 2 x
// 400 taps x 399 nonzero DFT columns per kept pair (13 for K6 in int8, 19
// for K7 in 16-bit floats) against 1.6 KB of frame in and 512 B out.
// Behind the tensor cores, the planes' L2 reads: every block reads each
// pair's ring tiles once per chunk. The design:
//   - A block of 256 threads (two warpgroups) owns T frames (64; 32 or
//     16 where the slices do not fit) and every mel column. wgmma takes 64
//     rows: A rows past T are zero registers. At 400 taps T = 64 for both
//     kernels; 128 frames would halve the plane reads, but their slices
//     alone take 221 KB (K6: 4 x 128 x 432 B) and 276 KB (K7) of a
//     block's 232,448 B. The plane bytes a call reads from L2 at 64 x 30 s
//     (191,872 frames, 2,998 blocks of 64), counted from the tiles: K7 19
//     pairs x 7 stages x 16 KB x 4 chunks = 8.7 MB a block, 26.1 GB a
//     call; K6 13 x 4 x 16 KB x 4 = 3.4 MB a block, 10.2 GB a call.
//   - The tile's ks int8 slices stay in shared memory for the launch, a
//     frame's taps contiguous, rows of kp + 16 bytes (an odd number of 16
//     byte units: ldmatrix's 8 rows fall on distinct banks). One ldmatrix
//     x4 reads a warp's 16 frames x 32 taps: K6's k32 A fragment as it is;
//     K7's two k16 fragments, each int8 pair widened to f16x2 by integer
//     operations (exact), fragment positions 2q + e and 8 + 2q + e taking
//     taps 4q + e and 4q + 2 + e; the launcher orders the planes' rows the
//     same way (an exact sum does not depend on the order).
//   - The bins are walked in chunks of 64 (128 DFT columns); warpgroup w
//     takes bins [32 w, 32 w + 32) of a chunk as one m64n64 tile, its 32 re
//     columns beside their 32 im columns, so a thread holds a pair's (or
//     group's) re and im of the same bins. Per output K7 keeps the pair,
//     the group, hi and lo (128 registers a thread; ptxas spills a few
//     hundred bytes), K6 the group, hi and lo; 128-column tiles would not
//     fit.
//   - A chunk's planes stream through a 3-stage cp.async ring, stage t + 2
//     loading while stage t runs; a stage is four k steps (K7: 64 taps, K6:
//     128), one contiguous 16 KB tile of the launcher's ring tiles, already
//     in wgmma's no-swizzle core-matrix order (K7 N contiguous, read with
//     the transpose flag as K1 reads m_big; K6 K-major: 8-bit wgmma has no
//     transpose), copied as it is: a warp's 16-byte copies fill 512
//     contiguous bytes (16 bytes of padding between column groups, as K1
//     pads, measured 3-4% slower here). Each stage's wgmma's are waited
//     for before the next barrier: in development, overlapping them with
//     the next stage cost registers (K7 spilled more) and ran slower.
//   - After a chunk's last pair: the power into a tile over the ring, mt's
//     rows of the chunk staged beside it, energy += power @ mt[chunk] into
//     the energy tile in shared memory; after the last chunk, logs and the
//     whisper norm.
//
// Plain C interface, built with nvcc and bound with ctypes
// (melspec_tpu_torch/kernels/framed_ozaki.py). Every launch is followed by
// cudaGetLastError, and its code is returned.

#include <type_traits>

#include "sig_common.cuh"

namespace {

using namespace sigk;

enum Scheme { kHp8 = 0, kHpBf16 = 1 };

constexpr int kFT = 256;          // threads per block: two warpgroups
constexpr int kCB = 64;           // bins per chunk
constexpr int kWgBins = 32;       // bins per warpgroup: N = 64 (re | im)
constexpr int kSteps = 4;         // wgmma k steps a ring stage
constexpr int kSlots = 3;         // ring stages
constexpr int kAhead = kSlots - 1;
constexpr int kGroups = 2 * kCB / 8;  // column groups a stage
// a column group's core matrices (8 x 16 B) along K, 2 a k step: the
// stride between column groups (wgmma's SBO)
constexpr unsigned kColBytes = 2 * kSteps * kCoreK;  // 1,024
constexpr int kStageBytes = kGroups * kColBytes;     // 16,384: one tile
constexpr int kRingBytes = kSlots * kStageBytes;
// after a chunk, over the ring: the power tile [64 bins][<= 64 frames]
// and a piece of mt's rows
constexpr int kPowBytes = 4 * kCB * 64;
constexpr int kMtBytes = 32768;
static_assert(kPowBytes + kMtBytes <= kRingBytes, "power and mt fit");
constexpr int kMaxS = 6;
constexpr int kMaxPairs = kMaxS * kMaxS;
constexpr int kMaxMelsPad = 256;
constexpr long long kMaxSmem = 232448;

struct Params {
  const float* frames;  // [n_rows, ld]
  long long n_rows;
  int ld, taps;
  int kp;  // taps rounded up to 32: the slices' and K-major planes' taps
  int rs;  // bytes between two frames of a slice: kp + 16
  // the launcher's ring tiles [blocks][n_chunks][stages][kStageBytes]:
  // K7 a block per plane j (fp16), K6 a block per pair (int8), each tile
  // a ring stage's bytes (framed_ozaki.py)
  const void* tiles;
  int nbp, n_chunks;
  int ks, n_pairs;
  // the kept pairs in group order: s = i + j ascending, i ascending
  unsigned char pi[kMaxPairs], pj[kMaxPairs], ps[kMaxPairs];
  const float* mt;  // [nbp, nmp]
  int n_mels, nmp;
  float* out;    // [n_rows, n_mels]
  float* power;  // [n_rows, nbp] or null
};

__host__ __device__ inline long long smem_bytes(int ks, int kp, int nmp,
                                                int tile) {
  return kRingBytes + align16(static_cast<long long>(ks) * tile * (kp + 16)) +
         4LL * tile * nmp + 4LL * tile;
}

__device__ __forceinline__ void two_sum(float a, float b, float& s,
                                        float& err) {
  s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  err = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
}

template <class V>
__device__ __forceinline__ void hold32(V (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    if constexpr (std::is_same<V, int>::value)
      asm volatile("" : "+r"(d[i])::"memory");
    else
      asm volatile("" : "+f"(d[i])::"memory");
  }
}

// d[64 x 64] (+)= a (64 x 16 f16, this warp's 16 rows as the m16n8k16 A
// fragment) . B (16 x 64 f16, N contiguous, by desc), float32; d is
// overwritten where acc_in is 0
__device__ __forceinline__ void wgmma_f16(float (&d)[32],
                                           const unsigned (&a)[4],
                                           unsigned long long desc,
                                           int acc_in) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc_in));
}

// d[64 x 64] (+)= a (64 x 32 s8, the m16n8k32 A fragment) . B (32 x 64 s8,
// K-major, by desc), int32
__device__ __forceinline__ void wgmma_s8(int (&d)[32], const unsigned (&a)[4],
                                         unsigned long long desc,
                                         int acc_in) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc_in));
}

// two int8 taps of w (bytes 0, 1 with sel 0x7150; bytes 2, 3 with 0x7352)
// as f16x2, the first in the low half: each byte b goes into the low byte
// of its half with its sign bit flipped (b + 128) under the exponent of
// 1024, so the half reads 1024 + b + 128; subtracting 1152 leaves b (every
// step exact)
template <unsigned kSel>
__device__ __forceinline__ unsigned i8x2_f16x2(unsigned w) {
  const unsigned h = __byte_perm(w, 0x64006400u, kSel) ^ 0x00800080u;
  unsigned r;
  asm("sub.rn.f16x2 %0, %1, %2;\n" : "=r"(r) : "r"(h), "r"(0x64806480u));
  return r;
}

template <int S, int T>
__global__ void __launch_bounds__(kFT, 1) ozaki_kernel(const Params p) {
  constexpr bool k8 = S == kHp8;
  constexpr int FPW = T / 8;  // the projection's and epilogue's frames a warp
  constexpr int kStep = k8 ? 32 : 16;  // taps of one wgmma
  constexpr int kStage = kSteps * kStep;  // taps of a ring stage
  using Acc = typename std::conditional<k8, int, float>::type;

  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wg = warp >> 2;
  const int g = lane >> 2, q = lane & 3;
  const long long n0 = static_cast<long long>(blockIdx.x) * T;
  const long long slice_bytes = static_cast<long long>(T) * p.rs;
  const unsigned ring = smem_addr(smem);
  float* sp = reinterpret_cast<float*>(smem);  // [T][kCB], over the ring
  unsigned char* sa = smem + kRingBytes;        // [ks][T][rs]
  float* se = reinterpret_cast<float*>(sa + align16(p.ks * slice_bytes));
  float* ssig = se + T * p.nmp;                 // [T]

  // 1. row scale and slices of each frame, a warp per frame; energy
  // zeroed. A lane reads four taps at a time, 16-byte loads where the row
  // stride allows (the launcher aligns the frames); the first 512 taps
  // stay in registers between the row max and the slicing
  const bool vec = (p.ld & 3) == 0;
  auto taps4 = [&](const float* x, int k4) {
    float v[4];
    if (vec && k4 + 3 < p.taps) {
      const float4 u = __ldg(reinterpret_cast<const float4*>(x + k4));
      v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = k4 + e < p.taps ? __ldg(x + k4 + e) : 0.0f;
    }
    return make_float4(v[0], v[1], v[2], v[3]);
  };
  constexpr int kHeld = 4;  // float4's a lane keeps: 512 taps a frame
  for (int f = warp; f < T; f += kFT / 32) {
    const long long n = n0 + f;
    const bool live = n < p.n_rows;
    const float* x = p.frames + (live ? n : 0) * p.ld;
    float4 held[kHeld];
    float mx = 0.0f;
#pragma unroll
    for (int it = 0; it < kHeld; ++it) {
      const int k4 = 4 * lane + 128 * it;
      held[it] = live && k4 < p.taps ? taps4(x, k4) : make_float4(0, 0, 0, 0);
    }
#pragma unroll
    for (int it = 0; it < kHeld; ++it)
      mx = max_nan(max_nan(max_nan(mx, fabsf(held[it].x)),
                           max_nan(fabsf(held[it].y), fabsf(held[it].z))),
                   fabsf(held[it].w));
    if (live)
      for (int k4 = 4 * lane + 128 * kHeld; k4 < p.taps; k4 += 128) {
        const float4 v = taps4(x, k4);
        mx = max_nan(max_nan(max_nan(mx, fabsf(v.x)),
                             max_nan(fabsf(v.y), fabsf(v.z))),
                     fabsf(v.w));
      }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = max_nan(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const int bits = __float_as_int(max_nan(mx, 1e-38f));
    const float sigma =
        __int_as_float((min((bits >> 23) & 0xFF, 0xFD) + 1) << 23);
    if (lane == 0) ssig[f] = sigma;
    for (int it = 0, k4 = 4 * lane; k4 < p.kp; ++it, k4 += 128) {
      float4 v4;
      if (it < kHeld) {
#pragma unroll
        for (int u = 0; u < kHeld; ++u)
          if (u == it) v4 = held[u];
      } else {
        v4 = live && k4 < p.taps ? taps4(x, k4) : make_float4(0, 0, 0, 0);
      }
      const float v[4] = {v4.x, v4.y, v4.z, v4.w};
      unsigned w[kMaxS];
#pragma unroll
      for (int i = 0; i < kMaxS; ++i) w[i] = 0u;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float r = __fdiv_rn(v[e], sigma);
#pragma unroll
        for (int i = 0; i < kMaxS; ++i) {
          if (i >= p.ks) break;
          const float sc = __fmul_rn(r, 128.0f);
          const float t = truncf(sc);
          w[i] |= (static_cast<unsigned>(static_cast<int>(t)) & 0xFFu)
                  << (8 * e);
          r = __fsub_rn(sc, t);
        }
      }
#pragma unroll
      for (int i = 0; i < kMaxS; ++i) {
        if (i >= p.ks) break;
        *reinterpret_cast<unsigned*>(sa + i * slice_bytes + f * p.rs + k4) =
            w[i];
      }
    }
    for (int m = lane; m < p.nmp; m += 32) se[f * p.nmp + m] = 0.0f;
  }

  // 2.-3. the chunk walk: per chunk, the pairs in group order, each pair's
  // taps in ring stages
  const int k_end = k8 ? p.kp : p.taps;  // a k step at or past it is skipped
  const int per_pair = (k_end + kStage - 1) / kStage;
  const int n_steps = p.n_pairs * per_pair;
  // this thread's A rows (frames) and their byte offsets in a slice
  const int row0 = (warp & 3) * 16 + g;
  const bool ok0 = row0 < T, ok1 = row0 + 8 < T;
  // the row this lane addresses for ldmatrix: matrix lane / 8 holds rows
  // (lane / 8 odd: + 8) and taps (lane / 16: + 16) of the warp's 16 frames
  const int lrow = (warp & 3) * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
  const unsigned arow = (lrow < T ? lrow : 0) * p.rs + (lane >> 4) * 16;
  const unsigned sa_addr = smem_addr(sa);
  const unsigned wg_b = wg * (kGroups / 2) * kColBytes;  // its groups

  for (int cb = 0; cb < p.n_chunks; ++cb) {
    // copy stage t of this chunk, one contiguous tile, into ring slot
    // `slot` (a commit group in any case)
    auto fill = [&](int t, int slot) {
      if (t < n_steps) {
        const int pr = t / per_pair;
        const int st = t - pr * per_pair;
        const long long blk = k8 ? pr : p.pj[pr];
        const unsigned char* src =
            static_cast<const unsigned char*>(p.tiles) +
            ((blk * p.n_chunks + cb) * per_pair + st) * kStageBytes;
#pragma unroll
        for (int c = 0; c < kStageBytes / 16 / kFT; ++c) {
          const int v = tid + kFT * c;
          cp_async16(ring + slot * kStageBytes + 16 * v, src + 16 * v, true);
        }
      }
      cp_async_commit();
    };

    // d[4j + e]: n8 tile j of the warpgroup's columns (re tiles 0-3, their
    // im tiles 4-7), fragment e: row row0 + 8 (e >> 1), bin 8 (j & 3) + 2q
    // + (e & 1) of the warpgroup's 32
    Acc acc[32];
    float grp[32], hi[32], lo[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      acc[e] = Acc(0);
      grp[e] = hi[e] = lo[e] = 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kAhead; ++i) fill(i, i);

    // stage t: wait for it, refill the slot of t - 1 (whose wgmma's every
    // warpgroup has waited for), run its k steps, each with its A
    // fragments loaded from the slices just before; a pair (K7) or group
    // (K6) that ends here is folded
    for (int t = 0; t < n_steps; ++t) {
      cp_async_wait<kAhead - 1>();
      // the stage's copies, and the last chunk's power and mt tiles over
      // the ring, are ordered before the wgmma's read the ring
      fence_async_shared();
      __syncthreads();
      fill(t + kAhead, (t + kAhead) % kSlots);
      const int pr = t / per_pair;
      const int st = t - pr * per_pair;
      const int k0 = st * kStage;
      const int s = p.ps[pr];
      const bool g_first = pr == 0 || p.ps[pr - 1] != s;
      const bool g_last = pr + 1 == p.n_pairs || p.ps[pr + 1] != s;
      const bool first = st == 0 && (!k8 || g_first);
      const unsigned slice = sa_addr + p.pi[pr] * static_cast<unsigned>(
                                                      slice_bytes);
      const unsigned stg = ring + (t % kSlots) * kStageBytes + wg_b;
      // the stage's A fragments, then its wgmma's in one commit group; a
      // k step at or past the taps adds nothing and is skipped. One
      // ldmatrix x4 reads 16 frames x 32 taps: K6's k32 fragment as it is;
      // K7's two k16 steps, whose fragment positions 2q + e and 8 + 2q + e
      // take taps 4q + e and 4q + 2 + e (the ring tiles order the planes'
      // rows the same way; an exact sum does not depend on the order)
      unsigned a[kSteps][4];
#pragma unroll
      for (int h = 0; h < kSteps; h += k8 ? 1 : 2) {
        const int kb = k0 + h * kStep;
        if (kb >= k_end) break;
        unsigned r[4];
        ldsm_x4(r, slice + arow + kb);
        if constexpr (k8) {
          a[h][0] = ok0 ? r[0] : 0u;
          a[h][1] = ok1 ? r[1] : 0u;
          a[h][2] = ok0 ? r[2] : 0u;
          a[h][3] = ok1 ? r[3] : 0u;
        } else {
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const unsigned w0 = ok0 ? r[2 * u] : 0u;
            const unsigned w1 = ok1 ? r[2 * u + 1] : 0u;
            a[h + u][0] = i8x2_f16x2<0x7150>(w0);
            a[h + u][1] = i8x2_f16x2<0x7150>(w1);
            a[h + u][2] = i8x2_f16x2<0x7352>(w0);
            a[h + u][3] = i8x2_f16x2<0x7352>(w1);
          }
        }
      }
      hold32(acc);
      wg_fence();
#pragma unroll
      for (int h = 0; h < kSteps; ++h) {
        if (k0 + h * kStep >= k_end) break;
        const unsigned long long desc =
            gmma_desc(stg + 2 * h * kCoreK, kCoreK, kColBytes);
        if constexpr (k8) wgmma_s8(acc, a[h], desc, !(first && h == 0));
        else wgmma_f16(acc, a[h], desc, !(first && h == 0));
      }
      wg_commit();
      wg_wait<0>();
      hold32(acc);
      if (st + 1 < per_pair) continue;
      if constexpr (!k8) {
        // the pair is done: into its group (pairs in increasing i)
#pragma unroll
        for (int e = 0; e < 32; ++e)
          grp[e] = g_first ? acc[e] : __fadd_rn(grp[e], acc[e]);
      }
      if (!g_last) continue;
      // the group is done: into the sum, largest scale first
      const bool sum_first = s == p.ps[0];
      const float scale = __int_as_float((127 - 7 * (s + 2)) << 23);
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        float gv;
        if constexpr (k8) gv = __int2float_rn(acc[e]);
        else gv = grp[e];
        const float term = __fmul_rn(gv, scale);
        if (sum_first) {
          hi[e] = term;
          lo[e] = 0.0f;
        } else {
          float err;
          two_sum(hi[e], term, hi[e], err);
          lo[e] = __fadd_rn(lo[e], err);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // every warpgroup is done with the ring

    // the chunk's power, then energy += power @ mt[chunk] in pieces of
    // bins whose mt rows are staged over the ring
    const int piece = kMtBytes / (4 * p.nmp);  // bins: 64 (128 mels), 32
    for (int b0 = 0; b0 < kCB; b0 += piece) {
      for (int v = tid; v < piece * p.nmp / 4; v += kFT)
        cp_async16(ring + kPowBytes + 16 * v,
                   p.mt + static_cast<long long>(cb * kCB + b0) * p.nmp +
                       4 * v,
                   true);
      cp_async_commit();
      if (b0 == 0) {
        // into the power tile [bin][T] (and the caller's power)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = row0 + 8 * (e >> 1);
            if (row >= T) continue;
            const int bin = wg * kWgBins + 8 * j + 2 * q + (e & 1);
            const int re = 4 * j + e, im = 4 * (j + 4) + e;
            float rh, rl, ih, il;
            two_sum(hi[re], lo[re], rh, rl);
            two_sum(hi[im], lo[im], ih, il);
            float pw =
                __fadd_rn(__fadd_rn(__fmul_rn(rh, rh), __fmul_rn(ih, ih)),
                          __fmul_rn(2.0f, __fadd_rn(__fmul_rn(rh, rl),
                                                    __fmul_rn(ih, il))));
            const float sg = ssig[row];
            pw = __fmul_rn(pw, __fmul_rn(sg, sg));
            sp[bin * T + row] = pw;
            if (p.power && n0 + row < p.n_rows)
              p.power[(n0 + row) * p.nbp + cb * kCB + bin] = pw;
          }
      }
      cp_async_wait<0>();
      __syncthreads();
      // warp w's FPW frames, lane's mel columns 4 lane + 128 m + u, float32
      // FMAs over the bins in ascending order
      const int nq = p.nmp / 128;
      const float* smt = reinterpret_cast<const float*>(smem + kPowBytes);
      const int f0 = warp * FPW;
      float en[FPW][kMaxMelsPad / 128][4];
#pragma unroll
      for (int f = 0; f < FPW; ++f)
#pragma unroll
        for (int m = 0; m < kMaxMelsPad / 128; ++m)
          if (m < nq) {
            const float4 u = *reinterpret_cast<const float4*>(
                se + (f0 + f) * p.nmp + 4 * lane + 128 * m);
            en[f][m][0] = u.x, en[f][m][1] = u.y, en[f][m][2] = u.z,
            en[f][m][3] = u.w;
          }
      for (int c = 0; c < piece; ++c) {
        float pw[FPW];
        const float* pr = sp + (b0 + c) * T + f0;
        if constexpr (FPW % 4 == 0) {
#pragma unroll
          for (int f = 0; f < FPW; f += 4) {
            const float4 u = *reinterpret_cast<const float4*>(pr + f);
            pw[f] = u.x, pw[f + 1] = u.y, pw[f + 2] = u.z, pw[f + 3] = u.w;
          }
        } else {
#pragma unroll
          for (int f = 0; f < FPW; ++f) pw[f] = pr[f];
        }
#pragma unroll
        for (int m = 0; m < kMaxMelsPad / 128; ++m) {
          if (m >= nq) continue;
          const float4 u = *reinterpret_cast<const float4*>(
              smt + c * p.nmp + 4 * lane + 128 * m);
          const float w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
          for (int f = 0; f < FPW; ++f)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              en[f][m][e] = fmaf(pw[f], w[e], en[f][m][e]);
        }
      }
#pragma unroll
      for (int f = 0; f < FPW; ++f)
#pragma unroll
        for (int m = 0; m < kMaxMelsPad / 128; ++m)
          if (m < nq)
            *reinterpret_cast<float4*>(se + (f0 + f) * p.nmp + 4 * lane +
                                       128 * m) =
                make_float4(en[f][m][0], en[f][m][1], en[f][m][2],
                            en[f][m][3]);
      __syncthreads();  // the piece is read before the ring is reused
    }
  }

  // 4. logs, then the whisper norm of each of this warp's rows
#pragma unroll
  for (int f = 0; f < FPW; ++f) {
    float* lg = se + (warp * FPW + f) * p.nmp;
    for (int m = lane; m < p.nmp; m += 32)
      lg[m] = log10_accurate(max_nan(lg[m], kLogFloor));
  }
  __syncwarp();
#pragma unroll
  for (int f = 0; f < FPW; ++f) {
    const long long n = n0 + warp * FPW + f;
    whisper_norm_row(se + (warp * FPW + f) * p.nmp, p.nmp, p.n_mels,
                     n < p.n_rows ? p.out + n * p.n_mels : nullptr, false);
  }
}

int plan_tile(int ks, int taps, int nmp, long long* smem) {
  const int kp = (taps + 31) / 32 * 32;
  for (int tile = 64; tile >= 16; tile /= 2) {
    *smem = smem_bytes(ks, kp, nmp, tile);
    if (*smem <= kMaxSmem) return tile;
  }
  return 0;
}

template <int S, int T>
cudaError_t launch(const Params& p, long long smem, cudaStream_t stream) {
  const long long grid = (p.n_rows + T - 1) / T;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ozaki_kernel<S, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  ozaki_kernel<S, T><<<static_cast<unsigned>(grid), kFT,
                       static_cast<size_t>(smem), stream>>>(p);
  return cudaGetLastError();
}

template <int S>
cudaError_t launch_tile(const Params& p, int tile, long long smem,
                        cudaStream_t stream) {
  return tile == 64   ? launch<S, 64>(p, smem, stream)
         : tile == 32 ? launch<S, 32>(p, smem, stream)
                      : launch<S, 16>(p, smem, stream);
}

}  // namespace

extern "C" {

// The frames per block the launcher takes for these arguments (64, 32 or
// 16; 0: none fits) and, in *smem, that tile's shared memory (the 16-frame
// tile's when none fits). Both schemes keep int8 slices.
int melspec_framed_ozaki_plan(int ks, int taps, int nmp, long long* smem) {
  return plan_tile(ks, taps, nmp, smem);
}

// Returns 0 or the cudaError_t of the launch (cudaErrorInvalidValue for
// arguments the kernel does not take). tiles: the ring tiles of the
// scheme (Params), scheme 0 (K6) a block per pair of (ks, cutoff) in group
// order, scheme 1 (K7) a block per plane. power (optional) receives the
// DFT power [n_rows, nbp].
int melspec_framed_ozaki(int scheme, const float* frames, long long n_rows,
                         int ld, int taps, const void* tiles, int nbp,
                         int ks, int cutoff,
                         const float* mt, int n_mels, int nmp, float* out,
                         float* power, void* stream) {
  if (n_rows <= 0) return cudaSuccess;
  if (scheme < kHp8 || scheme > kHpBf16 || ks < 1 || ks > kMaxS ||
      cutoff < 0 || taps < 1 || taps > ld || nbp < kCB || nbp % kCB != 0 ||
      nmp < 128 || nmp % 128 != 0 || nmp > kMaxMelsPad || n_mels < 1 ||
      n_mels > nmp || reinterpret_cast<uintptr_t>(tiles) % 16 != 0)
    return cudaErrorInvalidValue;
  Params p;
  p.frames = frames;
  p.n_rows = n_rows;
  p.ld = ld;
  p.taps = taps;
  p.kp = (taps + 31) / 32 * 32;
  p.rs = p.kp + 16;
  p.tiles = tiles;
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
  p.power = power;
  long long smem = 0;
  const int tile = plan_tile(ks, taps, nmp, &smem);
  if (tile == 0) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return scheme == kHp8 ? launch_tile<kHp8>(p, tile, smem, st)
                        : launch_tile<kHpBf16>(p, tile, smem, st);
}

const char* melspec_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
