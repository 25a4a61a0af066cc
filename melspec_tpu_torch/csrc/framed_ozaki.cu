// K5-K8 for Hopper (sm_90a): whisper log-mel of pre-framed [n_rows, ld]
// float32 frames through one of the precision dial's four DFT schemes on
// the tensor cores, one launch for all frames. One ring walk, a template
// over the scheme.
//
// Replaces the TPU kernels of melspec_tpu/ops/mel_kernel.py:
//   K6 _hp8_mel_tile_kernel (launched by _pallas_hp8_mel_frames): int8
//      slices and planes, the pairs of a scale summed in int32;
//   K7 _hp_mel_tile_kernel (_pallas_hp_mel_frames): 7-bit integer slices
//      against integer-valued bf16 planes, every pair its own float32 dot;
//   K5 _bf3_mel_tile_kernel (_pallas_bf3_mel_frames): rounded-bf16
//      residual slices of frame and window-folded DFT, pairs i + j <=
//      cutoff, groups by scale summed largest first in float32;
//   K8 _mel_tile_kernel (_pallas_mel_frames): a float32 DFT at the TPU's
//      Precision.HIGHEST, here by the TPU's own algorithm for it: K5's
//      scheme (ks 3, cutoff 2) on three rounded-bf16 slices of the float32
//      matrices (the launcher cuts them, framed_ozaki.py).
// For frame n it computes:
//   1. the signal slices of its first `taps` samples:
//        K6 / K7: the power-of-two row scale sigma = 2^(e+1) > max|x|
//        (exponent bits, clamped at 0xFD) and the 7-bit integer slices
//        t_i = trunc(128 r), r <- 128 r - t_i of r = x / sigma, i < ks;
//        K5 / K8: the bf16 residual cascade, slice i = bf16_rn(r_i),
//        r_{i+1} = r_i - slice i (exact), r_0 = x;
//   2. the slice pairs (i, j), in group order (s = i + j ascending, i
//      ascending): the dot of signal slice i with matrix plane j over the
//      taps, for the re (cos) and im (-sin) columns, on the tensor cores;
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
//        K5 / K8: wgmma m64n64k16 bf16 x bf16 -> float32, A and B from
//            shared memory, a group's pairs one after another along K as
//            K6 runs them, each ring stage (64 taps) its own accumulation,
//            added into the group with __fadd_rn (a product of two bf16
//            values is exact in float32; the sum rounds in the tensor
//            core's order, so K5 and K8 are held to bars, not bit
//            equality; one accumulation per group drifted further from the
//            exact sum than the plain version's dot). 3xTF32 was the first
//            design for K8: its 22-bit split misses the JFK gate (1.19e-5
//            against 1e-5 in a float64 emulation,
//            tests/test_torch_framed_tc.py), the bf16 one holds it
//            (4.89e-6);
//   3. K6 / K7: group s scaled by 128^-(s+2) (exact) and chained largest
//      scale first through two-sums into (hi, lo); power = ((hi_re^2 +
//      hi_im^2) + 2 (hi_re lo_re + hi_im lo_im)) sigma^2, every step an _rn
//      intrinsic (nvcc never contracts those), in ops/hp_dft.py's order:
//      the power equals the plain version's two_float_power bit for bit
//      (written to `power` when the caller asks, before the projection).
//      K5 / K8: the groups added with __fadd_rn largest scale first; power
//      = re^2 + im^2;
//   4. energy = power @ mt as float32 FMAs over the bins in ascending
//      order, log10_accurate(max(energy, 1e-10)), the whisper norm,
//      out[n, :n_mels] (sig_common.cuh), the order of the plain versions'
//      epilogue.
//
// What bounds it: operations. At whisper 400/160/128 a frame needs 2 x
// 400 taps x 399 nonzero DFT columns per kept pair (13 for K6 in int8, 19
// for K7 and 6 for K5 and K8 in 16-bit floats) against 1.6 KB of frame in
// and 512 B out. Behind the tensor cores, the planes' L2 reads: every
// block reads each pair's ring tiles once per chunk. The design:
//   - A block of 256 threads (two warpgroups) owns T frames (64; 32 or
//     16 where they do not fit) and every mel column. wgmma takes 64
//     rows: A rows past T are zero registers; frames past n_rows are
//     zeros and are not stored (a ragged last block is masked).
//   - K6 / K7: the tile's ks int8 slices stay in shared memory for the
//     launch, a frame's taps contiguous, rows of kp + 16 bytes (an odd
//     number of 16 byte units: ldmatrix's 8 rows fall on distinct banks).
//     One ldmatrix x4 reads a warp's 16 frames x 32 taps: K6's k32 A
//     fragment as it is; K7's two k16 fragments, each int8 pair widened to
//     f16x2 by integer operations (exact), fragment positions 2q + e and 8
//     + 2q + e taking taps 4q + e and 4q + 2 + e; the launcher orders the
//     planes' rows the same way (an exact sum does not depend on the
//     order). 64 frames take 110-138 KB at 400 taps.
//   - K5 / K8: the tile's float32 frames stay in shared memory (rows of 4
//     kp + 16 bytes: 8 consecutive rows' 16-byte loads fall on distinct
//     banks). ks bf16 slices would take 6 bytes a tap at ks 3 and not fit
//     64 frames at 400 taps with the ring and the energy tile; the frames
//     take 4 (107,520 B at 400 taps, 132,096 at 512: 64-frame blocks; 960
//     and 1024 taps take 32). While a ring stage's wgmma's run, the whole
//     block cuts the next stage's slice (the residual cascade of its 64
//     taps, 16 values a thread) into the other half of a double-buffered
//     A tile (64 frames x 64 taps, K-major core matrices), which the next
//     stage's wgmma's read by descriptor: both warpgroups share one cut
//     (a first design cut A in registers per warpgroup, twice the work,
//     exposed before each stage's wgmma's, and ptxas serialized the
//     wgmma's around the register operands: 7.2 ms at 400 taps, 3.0 of
//     them the cut, ozaki_probe).
//   - The bins are walked in chunks of 64 (128 DFT columns); warpgroup w
//     takes bins [32 w, 32 w + 32) of a chunk as one m64n64 tile, its 32 re
//     columns beside their 32 im columns, so a thread holds a pair's (or
//     group's) re and im of the same bins. Per output K7 keeps the pair,
//     the group, hi and lo (128 registers a thread; ptxas spills a few
//     hundred bytes), K6 the group, hi and lo, K5 / K8 the stage, the
//     group and the sum; 128-column tiles would not fit.
//   - A chunk's planes stream through a 3-stage cp.async ring, stage t + 2
//     loading while stage t runs; a stage is four k steps (K6: 128 taps,
//     the others 64), one contiguous 16 KB tile of the launcher's ring
//     tiles, already in wgmma's no-swizzle core-matrix order (K7, K5, K8 N
//     contiguous, read with the transpose flag as K1 reads m_big; K6
//     K-major: 8-bit wgmma has no transpose), copied as it is: a warp's
//     16-byte copies fill 512 contiguous bytes (16 bytes of padding between
//     column groups, as K1 pads, measured 3-4% slower here). Each stage's
//     wgmma's are waited for before the next barrier: in development,
//     overlapping them with the next stage cost registers (K7 spilled
//     more) and ran slower.
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

// K5 and K8 are both kBf3 (K8 with its own ring tiles)
enum Scheme { kHp8 = 0, kHpBf16 = 1, kBf3 = 2 };

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
// K5 / K8: the A tile of a stage, 64 frames x 64 taps of bf16 as core
// matrices [8-frame group][8-tap core][8 frames][16 bytes], two of them
constexpr int kATaps = 64;
constexpr unsigned kARowGroup = kATaps / 8 * kCoreK;  // 1,024: A's SBO
constexpr int kABytes = 8 * kARowGroup;                // 8,192
constexpr int kMaxS = 6;
constexpr int kMaxPairs = kMaxS * kMaxS;
constexpr int kMaxMelsPad = 256;
constexpr long long kMaxSmem = 232448;

struct Params {
  const float* frames;  // [n_rows, ld]
  long long n_rows;
  int ld, taps;
  int kp;  // taps rounded up to 32: the slices' (frames') taps
  int rs;  // bytes between two frames of a slice (row_bytes)
  // the launcher's ring tiles [blocks][n_chunks][stages][kStageBytes]: a
  // block per plane j (K7 fp16) or per pair (K6 int8, K5 / K8 bf16), each
  // tile a ring stage's bytes (framed_ozaki.py)
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

__host__ __device__ inline bool int8_slices(int scheme) {
  return scheme == kHp8 || scheme == kHpBf16;
}

// a row of the tile's slices (K6 / K7) or frames (K5 / K8) in bytes
__host__ __device__ inline int row_bytes(int scheme, int kp) {
  return int8_slices(scheme) ? kp + 16 : 4 * kp + 16;
}

// the ring, K5's / K8's two A tiles, the slices or frames, the energy tile
// and the row scales
__host__ __device__ inline long long smem_bytes(int scheme, int ks, int kp,
                                                int nmp, int tile) {
  const bool i8 = int8_slices(scheme);
  const long long rows = static_cast<long long>(i8 ? ks : 1) * tile;
  return kRingBytes + (i8 ? 0 : 2 * kABytes) +
         align16(rows * row_bytes(scheme, kp)) + 4LL * tile * nmp +
         4LL * tile;
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

#define MELSPEC_WG_D32(C)                                                  \
  C(d[0]), C(d[1]), C(d[2]), C(d[3]), C(d[4]), C(d[5]), C(d[6]), C(d[7]), \
      C(d[8]), C(d[9]), C(d[10]), C(d[11]), C(d[12]), C(d[13]), C(d[14]), \
      C(d[15]), C(d[16]), C(d[17]), C(d[18]), C(d[19]), C(d[20]),         \
      C(d[21]), C(d[22]), C(d[23]), C(d[24]), C(d[25]), C(d[26]),         \
      C(d[27]), C(d[28]), C(d[29]), C(d[30]), C(d[31])
#define MELSPEC_WG_OPS                                                 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "  \
  "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p"
#define MELSPEC_WG_IN                                                   \
  "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc_in)

// d[64 x 64] (+)= A (64 x K) . B (K x 64 by desc), overwriting d where
// acc_in is 0; per scheme: K6 m64n64k32 s8 -> int32 (A in registers, this
// warp's 16 rows as the m16n8k32 A fragment; B K-major), K7 m64n64k16 f16
// -> float32 (A in registers; B N contiguous, the transpose flag), K5 / K8
// m64n64k16 bf16 -> float32 (A K-major by a_desc, B N contiguous)
template <int S, class V>
__device__ __forceinline__ void wgmma_step(V (&d)[32], const unsigned (&a)[4],
                                           unsigned long long a_desc,
                                           unsigned long long desc,
                                           int acc_in) {
  if constexpr (S == kHp8) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " MELSPEC_WG_OPS
        ";\n}\n"
        : MELSPEC_WG_D32("+r")
        : MELSPEC_WG_IN);
  } else if constexpr (S == kHpBf16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " MELSPEC_WG_OPS
        ", 1, 1, 1;\n}\n"
        : MELSPEC_WG_D32("+f")
        : MELSPEC_WG_IN);
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 1;\n}\n"
        : MELSPEC_WG_D32("+f")
        : "l"(a_desc), "l"(desc), "r"(acc_in));
  }
}

#undef MELSPEC_WG_D32
#undef MELSPEC_WG_OPS
#undef MELSPEC_WG_IN

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

// x rounded to bf16 (nearest, ties to even) as a float32, by integer
// operations on its bits (a carry runs into the exponent): as
// __float2bfloat16_rn for finite x, without the conversion unit's lower
// rate (tests/test_torch_framed_tc.py holds the formula to PyTorch's
// rounding)
__device__ __forceinline__ float bf16_round(float x) {
  const unsigned b = __float_as_uint(x);
  return __uint_as_float((b + 0x7FFFu + ((b >> 16) & 1u)) & 0xFFFF0000u);
}

// two float32 as bf16x2 (round to nearest even), the first in the low half
__device__ __forceinline__ unsigned bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// K5's / K8's A tile of one stage: slice i of taps [k0, k0 + 64) of the T
// staged frames (rows rs bytes apart), cut into the tile at a (core
// matrices [8-frame group][8-tap core][8 frames][16 bytes]). Thread tid
// cuts frame tid % 64, taps k0 + 16 (tid / 64) + [0, 16): 16 values, two
// core rows; a quarter warp's 16-byte loads and stores fall on distinct
// banks. Slice i is the residual after i bf16 slices (each subtraction
// exact), rounded to bf16; the 16 values go through the cascade level by
// level (16 independent chains: a cascade per value, one after another,
// left the cut latency-bound). Taps at or past `taps` are skipped (their k
// steps are), rows at or past T are left as they are (zero)
template <int T>
__device__ __forceinline__ void cut_stage(unsigned char* a,
                                          const unsigned char* frames,
                                          int rs, int taps, int k0, int i,
                                          int tid) {
  const int r = tid & 63, m = tid >> 6;
  const int kb = k0 + 16 * m;
  if (r >= T || kb >= taps) return;
  const float4* src = reinterpret_cast<const float4*>(frames + r * rs) +
                      kb / 4;
  float v[16];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const float4 f = src[u];
    v[4 * u] = f.x, v[4 * u + 1] = f.y, v[4 * u + 2] = f.z,
    v[4 * u + 3] = f.w;
  }
  for (int level = 0; level < i; ++level) {
#pragma unroll
    for (int e = 0; e < 16; ++e) v[e] = __fsub_rn(v[e], bf16_round(v[e]));
  }
  unsigned w[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) w[e] = bf16x2(v[2 * e], v[2 * e + 1]);
  unsigned char* dst = a + (r >> 3) * kARowGroup + 2 * m * kCoreK +
                       (r & 7) * 16;
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  *reinterpret_cast<uint4*>(dst + kCoreK) = make_uint4(w[4], w[5], w[6], w[7]);
}

template <int S, int T>
__global__ void __launch_bounds__(kFT, 1) ozaki_kernel(const Params p) {
  constexpr bool k8 = S == kHp8;
  constexpr bool kI8 = S != kBf3;  // int8 slices staged, or the frames
  constexpr int FPW = T / 8;  // the projection's and epilogue's frames a warp
  constexpr int kStep = k8 ? 32 : 16;     // taps of one wgmma
  constexpr int kStage = kSteps * kStep;  // taps of a ring stage
  // k steps one ldmatrix feeds (K7: two k16 steps from 32 int8 taps)
  constexpr int kLdSteps = S == kHpBf16 ? 2 : 1;
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
  // K5 / K8: two A tiles after the ring
  unsigned char* sat = smem + kRingBytes;
  // K6 / K7: [ks][T][rs] int8 slices; K5 / K8: [T][rs] float32 frames
  unsigned char* sa = sat + (kI8 ? 0 : 2 * kABytes);
  float* se = reinterpret_cast<float*>(
      sa + align16((kI8 ? p.ks : 1) * slice_bytes));
  float* ssig = se + T * p.nmp;                 // [T]

  // 1. per frame, a warp each: K6 / K7 its row scale and slices, K5 / K8
  // the frame itself (zero past the taps); energy zeroed. A lane reads four
  // taps at a time, 16-byte loads where the row stride allows (the
  // launcher aligns the frames); K6 / K7 keep the first 512 taps in
  // registers between the row max and the slicing
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
  if constexpr (!kI8) {
    for (int v = tid; v < 2 * kABytes / 16; v += kFT)
      reinterpret_cast<uint4*>(sat)[v] = make_uint4(0u, 0u, 0u, 0u);
  }
  for (int f = warp; f < T; f += kFT / 32) {
    const long long n = n0 + f;
    const bool live = n < p.n_rows;
    const float* x = p.frames + (live ? n : 0) * p.ld;
    if constexpr (!kI8) {
      // whole float4's of the taps by cp.async (zero-filled for frames past
      // n_rows), all in flight at once; the tail through registers
      const unsigned row = smem_addr(sa + f * p.rs);
      for (int k4 = 4 * lane; k4 < p.kp; k4 += 128) {
        if (vec && k4 + 3 < p.taps)
          cp_async16(row + 4 * k4, x + k4, live);
        else
          *reinterpret_cast<float4*>(sa + f * p.rs + 4 * k4) =
              live && k4 < p.taps ? taps4(x, k4) : make_float4(0, 0, 0, 0);
      }
    } else {
      float4 held[kHeld];
      float mx = 0.0f;
#pragma unroll
      for (int it = 0; it < kHeld; ++it) {
        const int k4 = 4 * lane + 128 * it;
        held[it] =
            live && k4 < p.taps ? taps4(x, k4) : make_float4(0, 0, 0, 0);
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
          *reinterpret_cast<unsigned*>(sa + i * slice_bytes + f * p.rs +
                                       k4) = w[i];
        }
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
  const unsigned sat_addr = smem_addr(sat);
  // K5 / K8: cut the A tile of stage st of pair pr (slice pi[pr]) into
  // tile `slot`; its stores are handed to the wgmma's by the fence and
  // barrier at the top of the step that reads them
  auto cut = [&](int pr, int st, int slot) {
    cut_stage<T>(sat + slot * kABytes, sa, p.rs, p.taps, st * kATaps,
                 p.pi[pr], tid);
  };
  if constexpr (!kI8) {
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();  // the A tiles are zeroed and the frames staged
    cut(0, 0, 0);
  }

  for (int cb = 0; cb < p.n_chunks; ++cb) {
    // copy the chunk's next stage (pair f_pr, stage f_st), one contiguous
    // tile, into ring slot `slot` (a commit group in any case)
    int f_pr = 0, f_st = 0;
    auto fill = [&](int slot) {
      if (f_pr < p.n_pairs) {
        const int pr = f_pr, st = f_st;
        if (++f_st == per_pair) f_st = 0, ++f_pr;
        const long long blk = S == kHpBf16 ? p.pj[pr] : pr;
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
    // + (e & 1) of the warpgroup's 32. hi: the sum (K5 / K8: the DFT
    // itself), lo its two-float tail, grp the group (K7, K5, K8)
    Acc acc[32];
    float grp[32], hi[32], lo[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      acc[e] = Acc(0);
      grp[e] = hi[e] = lo[e] = 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kAhead; ++i) fill(i);

    // stage t (stage st of pair pr): wait for it, refill the slot of t - 1
    // (whose wgmma's every warpgroup has waited for), run its k steps, each
    // with its A fragments loaded from the slices just before; a pair (K7)
    // or group that ends here is folded
    for (int t = 0, pr = 0, st = -1; t < n_steps; ++t) {
      if (++st == per_pair) st = 0, ++pr;
      cp_async_wait<kAhead - 1>();
      // the stage's copies, and the last chunk's power and mt tiles over
      // the ring, are ordered before the wgmma's read the ring
      fence_async_shared();
      __syncthreads();
      fill((t + kAhead) % kSlots);
      const int k0 = st * kStage;
      const int s = p.ps[pr];
      const bool g_first = pr == 0 || p.ps[pr - 1] != s;
      const bool g_last = pr + 1 == p.n_pairs || p.ps[pr + 1] != s;
      // the accumulator starts anew: K5 / K8 every stage, K7 every pair,
      // K6 every group
      const bool first =
          S == kBf3 || (st == 0 && (S == kHpBf16 || g_first));
      const int pi = p.pi[pr];
      const unsigned slice = sa_addr + pi * static_cast<unsigned>(
                                                slice_bytes);
      const unsigned stg = ring + (t % kSlots) * kStageBytes + wg_b;
      // K5 / K8: A tile (cb n_steps + t) % 2
      const int a_slot = (cb * n_steps + t) & 1;
      const unsigned a_tile = sat_addr + a_slot * kABytes;
      // the stage's A fragments, then its wgmma's in one commit group; a
      // k step at or past the taps adds nothing and is skipped. K5 / K8
      // read A from its tile. K6 / K7: one ldmatrix x4 reads 16 frames x 32
      // taps: K6's k32 fragment as it is; K7's two k16 steps, whose
      // fragment positions 2q + e and 8 + 2q + e take taps 4q + e and 4q +
      // 2 + e (the ring tiles order the planes' rows the same way; an exact
      // sum does not depend on the order)
      unsigned a[kSteps][4] = {};
#pragma unroll
      for (int h = 0; h < kSteps; h += kLdSteps) {
        const int kb = k0 + h * kStep;
        if (!kI8 || kb >= k_end) break;
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
        const unsigned long long a_desc =
            gmma_desc(a_tile + 2 * h * kCoreK, kCoreK, kARowGroup);
        const unsigned long long desc =
            gmma_desc(stg + 2 * h * kCoreK, kCoreK, kColBytes);
        wgmma_step<S>(acc, a[h], a_desc, desc, !(first && h == 0));
      }
      wg_commit();
      // K5 / K8: the next step's A tile while the wgmma's run (the other
      // tile: the last step's wgmma's, which read it, every warpgroup has
      // waited for before the barrier above)
      if constexpr (!kI8) {
        if (st + 1 < per_pair) cut(pr, st + 1, a_slot ^ 1);
        else if (pr + 1 < p.n_pairs) cut(pr + 1, 0, a_slot ^ 1);
        else if (cb + 1 < p.n_chunks) cut(0, 0, a_slot ^ 1);
      }
      wg_wait<0>();
      hold32(acc);
      if constexpr (S == kBf3) {
        // the stage's sum into its group, rounded to nearest: one tensor-
        // core sum of a whole group along K landed 3.7e-5 from the exact
        // result on noise where the plain version's float32 dot lands 2.0e-5
        // (stage sums: 1.3e-5)
#pragma unroll
        for (int e = 0; e < 32; ++e)
          grp[e] = st == 0 && g_first ? acc[e] : __fadd_rn(grp[e], acc[e]);
      }
      if (st + 1 < per_pair) continue;
      if constexpr (S == kHpBf16) {
        // the pair is done: into its group (pairs in increasing i)
#pragma unroll
        for (int e = 0; e < 32; ++e)
          grp[e] = g_first ? acc[e] : __fadd_rn(grp[e], acc[e]);
      }
      if (!g_last) continue;
      // the group is done: into the sum, largest scale first
      const bool sum_first = s == p.ps[0];
      if constexpr (!kI8) {
#pragma unroll
        for (int e = 0; e < 32; ++e)
          hi[e] = sum_first ? grp[e] : __fadd_rn(hi[e], grp[e]);
      } else {
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
            float pw;
            if constexpr (kI8) {
              float rh, rl, ih, il;
              two_sum(hi[re], lo[re], rh, rl);
              two_sum(hi[im], lo[im], ih, il);
              pw = __fadd_rn(
                  __fadd_rn(__fmul_rn(rh, rh), __fmul_rn(ih, ih)),
                  __fmul_rn(2.0f,
                            __fadd_rn(__fmul_rn(rh, rl), __fmul_rn(ih, il))));
              const float sg = ssig[row];
              pw = __fmul_rn(pw, __fmul_rn(sg, sg));
            } else {
              pw = __fadd_rn(__fmul_rn(hi[re], hi[re]),
                             __fmul_rn(hi[im], hi[im]));
            }
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

int plan_tile(int scheme, int ks, int taps, int nmp, long long* smem) {
  const int kp = (taps + 31) / 32 * 32;
  for (int tile = 64; tile >= 16; tile /= 2) {
    *smem = smem_bytes(scheme, ks, kp, nmp, tile);
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
// tile's when none fits).
int melspec_framed_ozaki_plan(int scheme, int ks, int taps, int nmp,
                              long long* smem) {
  return plan_tile(scheme, ks, taps, nmp, smem);
}

// Returns 0 or the cudaError_t of the launch (cudaErrorInvalidValue for
// arguments the kernel does not take). tiles: the ring tiles of the
// scheme (Params): scheme 0 (K6) and 2 (K5, K8) a block per pair of (ks,
// cutoff) in group order, scheme 1 (K7) a block per plane. power
// (optional) receives the DFT power [n_rows, nbp].
int melspec_framed_ozaki(int scheme, const float* frames, long long n_rows,
                         int ld, int taps, const void* tiles, int nbp,
                         int ks, int cutoff,
                         const float* mt, int n_mels, int nmp, float* out,
                         float* power, void* stream) {
  if (n_rows <= 0) return cudaSuccess;
  if (scheme < kHp8 || scheme > kBf3 || ks < 1 || ks > kMaxS ||
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
  p.rs = row_bytes(scheme, p.kp);
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
  const int tile = plan_tile(scheme, ks, taps, nmp, &smem);
  if (tile == 0) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (scheme) {
    case kHp8: return launch_tile<kHp8>(p, tile, smem, st);
    case kHpBf16: return launch_tile<kHpBf16>(p, tile, smem, st);
    default: return launch_tile<kBf3>(p, tile, smem, st);
  }
}

const char* melspec_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
