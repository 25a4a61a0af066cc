// K1's wide-hop path (sig_mel.cu, layout 3): a whisper head's windowed DFT
// as two small DFTs on the tensor cores, for the heads whose 128- and
// 64-frame spans do not fit a block (960/480, 1024/480, 2048/512).
//
// Replaces, for those heads, the chunk walk of sig_common.cuh in the TPU
// kernel melspec_tpu/ops/mel_kernel.py::_sig_mel_tile_kernel (launched by
// _pallas_sig_mel): the same function, frames from the raw signal ->
// windowed DFT power -> bf2 mel projection -> log10 -> whisper norm (and
// the u8 and VAD epilogues), by another algorithm. The dense DFT costs
// 12 N^2 FLOP a frame and reads all of m_big from L2 for every block;
// at N = 2048 its own operation bound is above the cuFFT + matmul
// composition. Here N = N1 x N2 (n = N2 n1 + n2, bin k = k1 + N1 k2):
//   1. stage 1, a real N1-point DFT over n1 for each n2: D1[k1 re/im, n2]
//      = F1[k1 re/im, n1] . xw[n1, n2] (wgmma m64n32k16: A = F1 from
//      registers, B = the windowed frame from shared memory);
//   2. the twiddle W_N^(n2 k1) in float32 registers: Z = D1 * W;
//   3. stage 2, a complex N2-point DFT over n2 for k2 < 16 only (the bins
//      k < N/2): D2[k1 re/im, c k2 | s k2] = Z[k1 re/im, n2] . F2[n2, c|s]
//      (wgmma m64n32k16: A = Z straight from stage 1's accumulators, as
//      FlashAttention-3 reuses S; B = F2 from shared memory). A thread
//      holds re(Z) and im(Z) of one k1 as rows g and g + 8 of its m16
//      tile, and the c and s columns of one k2 in n8 tiles t and t + 2,
//      so X = D2[re, c] + D2[im, s] + i (D2[im, c] - D2[re, s]) and its
//      power are formed in the thread, with no shuffle;
//   4. the power into the bf16 p0 | p1 tile the existing bf2 projection
//      reads, then the projection (mt rows through a row map: the tile
//      holds a chunk's bins in the order (k1, k2)), logs, norm and
//      epilogues of sig_common.cuh, unchanged.
// Each operand is cut into three bf16 slices and the pairs i + j <= 2
// are summed in K1's block order (smallest pair first) with float32
// accumulation, as the dense path does; the window (float32) multiplies
// each frame's taps before the cut, and the twiddle is a float32 table
// built in float64 on the host. N1 is 32 or 64 (a chunk is 32 k1 values,
// the 64 rows of a wgmma), N2 at most 32 (padded to 32 with zero rows
// and columns), so every chunk is 512 power columns: 960 = 32 x 30, 1024
// = 32 x 32, 2048 = 64 x 32 (two chunks).
//
// What bounds it: operations, 24 N (N1 + 32) FLOP a frame for the six
// pairs of both stages plus the projection, 7-11x fewer than the dense
// DFT at these widths. The stage matrices stay on chip for the block's
// life (F2 and the window in shared memory, F1 in registers, the
// twiddles read from L1 each frame); L2 serves only the frames' samples
// (each frame's N floats, read in order by a warp's lanes into registers
// while the previous frame is on the tensor cores) and the projection
// rows (3 x 512 x nmp bf16 a chunk of 64 frames). Blocks are persistent:
// one a SM, each walking tiles of 64 frames; a warpgroup takes 32 frames
// of a tile, one frame at a time through both stages. Measured on an
// H100 (kernels/sig_probe.py factored, each part cut out in turn), the
// time is spread over the projection, the next frame's taps (their load
// latency above all) and the two stages' wgmma's, no one of them most.

#pragma once

#include "sig_common.cuh"

namespace sigk {

constexpr int kFN2 = 32;          // stage 2's n2, padded
// the window's row of one n1 in shared memory: 32 taps padded to 36
// floats, so a read phase's 8 lanes (4 groups of 2 rows) hit distinct banks
constexpr int kFWinRow = 36;
constexpr int kFChunkPow = 512;   // power columns of a chunk: 32 k1 x 16 k2
constexpr int kFSlices = 3;
constexpr int kFPairs = 6;
constexpr int kFSbo2 = 4 * kCoreK + 16;  // B2: 32 K rows an 8-column group
constexpr int kFB2Slice = 4 * kFSbo2;
constexpr int kFB2Bytes = kFSlices * kFB2Slice;

// The pairs (i, j) of a signal-side slice i and a matrix slice j, i + j
// <= 2, in K1's block order for pair_i (0, 0, 0, 1, 1, 2): (0, 2), (1,
// 1), (2, 0), (0, 1), (1, 0), (0, 0) (a CPU test holds
// kernels/sig_mel.py::block_order to it).
__host__ __device__ constexpr int f_pair_i(int p) {
  return p == 1 || p == 4 ? 1 : (p == 2 ? 2 : 0);
}
__host__ __device__ constexpr int f_pair_j(int p) {
  return p == 0 ? 2 : (p == 1 || p == 3 ? 1 : 0);
}

// The factored head's host-built tables (kernels/sig_mel.py::
// factored_dft): N = n1 * n2 taps.
struct Factored {
  const float* window;      // [n] float32 periodic Hann
  const unsigned* f1;       // bf16 pairs of [n1 / 32][3][64][n1]: chunk c's
                            // rows 16 w + 8 h + g = re (h 0) / im (h 1) of
                            // k1 = 32 c + 8 w + g, slice j
  const float4* tw;         // [n1][16]: (cos, sin) of 2 pi n2 k1 / N at n2
                            // = 2 u, 2 u + 1 (zero past n2)
  const uint4* f2;          // bf16 [3][32 n2][32]: cos | sin 2 pi n2 k2 / n2
  const int* rowmap;        // [16 n1]: mt row of each chunk power column
  int n, n1, n2;
};

// B1 (one frame's windowed taps, three slices): [K = n1][N = 32 n2] as
// wgmma's core matrices, n1 / 8 along K (kCoreK apart), then 4 column
// groups of 8 n2 at f_sbo1 bytes (padded by 32: the 8 lanes of a store
// phase, 4 groups of 2 rows, land on distinct banks)
__host__ __device__ inline int f_sbo1(int n1) { return n1 * 16 + 32; }
__host__ __device__ inline int f_b1_bytes(int n1) {
  return kFSlices * 4 * f_sbo1(n1);
}

// A factored block's dynamic shared memory: the work region (the
// projection's ring and the chunk's power tile; the log tile after),
// B2, the window (as [n1][kFWinRow], zero past n2) and each warpgroup's
// B1
__host__ inline long long factored_bytes(int n1) {
  return Lay<3>::kRingBytes + 4LL * Lay<3>::kTile * kFChunkPow + kFB2Bytes +
         4LL * kFWinRow * n1 + 2LL * f_b1_bytes(n1);
}

// d[64 x 32] += a (64 x 16, the warp's m16 A fragment) . B (16 x 32 bf16,
// N contiguous, by desc); asynchronous until wg_wait
__device__ __forceinline__ void wgmma_32(float (&d)[16],
                                         const unsigned (&a)[4],
                                         unsigned long long desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %22, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, %21;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "n"(kTnspB), "r"(1));
}

__device__ __forceinline__ void wg_hold16(float (&d)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// barrier of one warpgroup's 128 threads (ids 1 and 2; 0 is
// __syncthreads)
__device__ __forceinline__ void wg_bar() {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + (threadIdx.x >> 7))
               : "memory");
}

// the three-slice bf16 cascade of v (round to nearest even, as astype):
// bit pattern of slice k in the low 16 bits of s[k]
__device__ __forceinline__ void cut3(float v, unsigned (&s)[kFSlices]) {
#pragma unroll
  for (int k = 0; k < kFSlices; ++k) {
    const __nv_bfloat16 h = __float2bfloat16_rn(v);
    s[k] = __bfloat16_as_ushort(h);
    v = __fsub_rn(v, __bfloat162float(h));
  }
}

template <int N1>
struct FStage {
  static constexpr int kSteps1 = N1 / 16;  // stage 1's k16 steps
  static constexpr int kGroups = N1 / 32;  // 8-tap groups of a thread
  static constexpr int kSbo1 = N1 * 16 + 32;
  static constexpr int kSlice1 = 4 * kSbo1;
};

// One frame's taps n = n2 n1 + 8 m + e (e < 8) of this thread's groups
// (group t + 128 u of its warpgroup: m = its index mod 4, n1 = the rest,
// so a warp reads its rows' taps in order), zero past the clip and past
// n2: samples s0 .. s0 + N - 1 of the clip xb of T samples. 16-byte
// loads where a group is whole and aligned, else 8-byte where aligned.
template <int N1>
__device__ __forceinline__ void f_load(const float* xb, long long T,
                                       long long s0, int n2,
                                       float (&v)[FStage<N1>::kGroups][8]) {
  const int t = threadIdx.x & 127;
#pragma unroll
  for (int u = 0; u < FStage<N1>::kGroups; ++u) {
    const int gi = t + 128 * u;
    const int m = gi & 3, n1 = gi >> 2;
    const long long at = s0 + static_cast<long long>(n2) * n1 + 8 * m;
    const int nv = n2 - 8 * m < 8 ? n2 - 8 * m : 8;
    const float* src = xb + at;
    const uintptr_t align = reinterpret_cast<uintptr_t>(src);
    if (nv == 8 && at + 7 < T && (align & 15) == 0) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(src));
      const float4 c = __ldg(reinterpret_cast<const float4*>(src) + 1);
      v[u][0] = a.x; v[u][1] = a.y; v[u][2] = a.z; v[u][3] = a.w;
      v[u][4] = c.x; v[u][5] = c.y; v[u][6] = c.z; v[u][7] = c.w;
    } else if (at + 7 < T && (align & 7) == 0) {
#pragma unroll
      for (int e = 0; e < 8; e += 2) {
        const float2 a = e < nv ? __ldg(reinterpret_cast<const float2*>(
                                      src + e))
                                : make_float2(0.0f, 0.0f);
        v[u][e] = a.x;
        v[u][e + 1] = e + 1 < nv ? a.y : 0.0f;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[u][e] = e < nv && at + e < T ? __ldg(src + e) : 0.0f;
    }
  }
}

// The loaded taps times the window (swin [n1][kFWinRow] float32, zero
// past n2: two 16-byte loads a group), cut into three bf16 slices, into B1: a
// thread stores one 16-byte core-matrix row a slice and group (a store
// phase's 8 lanes on distinct banks, f_sbo1)
template <int N1>
__device__ __forceinline__ void f_store(const float (&v)[FStage<N1>::kGroups]
                                                         [8],
                                        const float* swin,
                                        unsigned char* b1) {
  const int t = threadIdx.x & 127;
#pragma unroll
  for (int u = 0; u < FStage<N1>::kGroups; ++u) {
    const int gi = t + 128 * u;
    const int m = gi & 3, n1 = gi >> 2;
    const float4* wp = reinterpret_cast<const float4*>(swin +
                                                       kFWinRow * n1 + 8 * m);
    const float4 w0 = wp[0], w1 = wp[1];
    const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
    unsigned p[kFSlices][4] = {};
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float w = wv[e];
      unsigned s[kFSlices];
      cut3(__fmul_rn(v[u][e], w), s);
#pragma unroll
      for (int k = 0; k < kFSlices; ++k) p[k][e >> 1] |= s[k] << (16 * (e & 1));
    }
#pragma unroll
    for (int k = 0; k < kFSlices; ++k)
      *reinterpret_cast<uint4*>(b1 + k * FStage<N1>::kSlice1 +
                                m * FStage<N1>::kSbo1 + 16 * n1) =
          make_uint4(p[k][0], p[k][1], p[k][2], p[k][3]);
  }
}

// One chunk's constants: stage 1's A fragments in registers (F1's rows
// of this warp, three slices, each k16 step) and where this thread's
// twiddles are (k1 = 32 ch + 8 w + g; n2 = 8 j + 2 q + e), read each
// frame (from L1) while stage 1 runs, which keeps them out of the
// registers stage 2 needs
template <int N1>
struct FChunk {
  unsigned a1[kFSlices][FStage<N1>::kSteps1][4];
  const float4* tw;

  __device__ __forceinline__ void load(const Factored& f, int ch) {
    const int lane = threadIdx.x & 31;
    const int wl = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int j = 0; j < kFSlices; ++j) {
      // 32-bit words of slice j's rows 16 wl + g and 16 wl + 8 + g
      const unsigned* r0 =
          f.f1 + ((ch * kFSlices + j) * 64 + 16 * wl + g) * (N1 / 2);
      const unsigned* r1 = r0 + 8 * (N1 / 2);
#pragma unroll
      for (int s = 0; s < FStage<N1>::kSteps1; ++s) {
        a1[j][s][0] = __ldg(r0 + 8 * s + q);
        a1[j][s][1] = __ldg(r1 + 8 * s + q);
        a1[j][s][2] = __ldg(r0 + 8 * s + 4 + q);
        a1[j][s][3] = __ldg(r1 + 8 * s + 4 + q);
      }
    }
    tw = f.tw + (32 * ch + 8 * wl + g) * 16 + q;
  }
};

// One frame of this warpgroup through both stages (its windowed taps in
// B1 at b1), the power of its 512 chunk columns into row `row` of the
// power tile pb (bf16 p0 | p1, or float32). `next` (when more) stores
// the next frame's taps into B1 while stage 2 runs: stage 1, the only
// reader of B1, is done by then in every warp of the warpgroup.
template <int N1>
__device__ __forceinline__ void f_frame(const FChunk<N1>& cc, unsigned b1,
                                        unsigned b2, unsigned char* pb,
                                        int row, bool bf2, bool more,
                                        const float (&v)[FStage<N1>::kGroups]
                                                        [8],
                                        const float* swin,
                                        unsigned char* b1p) {
  const int lane = threadIdx.x & 31;
  const int wl = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, q = lane & 3;
  float d1[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) d1[i] = 0.0f;
  wg_hold16(d1);
  wg_fence();
#pragma unroll
  for (int p = 0; p < kFPairs; ++p)
#pragma unroll
    for (int s = 0; s < FStage<N1>::kSteps1; ++s)
      wgmma_32(d1, cc.a1[f_pair_j(p)][s],
               gmma_desc(b1 + f_pair_i(p) * FStage<N1>::kSlice1 +
                             s * 2 * kCoreK,
                         kLbo, FStage<N1>::kSbo1));
  wg_commit();
  float4 tw[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) tw[j] = __ldg(cc.tw + 4 * j);
  wg_wait<0>();
  wg_hold16(d1);

  // the twiddle, and Z cut into three slices as stage 2's A fragments:
  // step s2 (n2 16 s2 ..) takes n8 tiles 2 s2 (k 2q, a0 re / a1 im) and
  // 2 s2 + 1 (k 8 + 2q, a2 re / a3 im)
  unsigned a2[kFSlices][2][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    unsigned zr[kFSlices] = {}, zi[kFSlices] = {};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float yr = d1[4 * j + e], yi = d1[4 * j + 2 + e];
      const float c = e ? tw[j].z : tw[j].x, s = e ? tw[j].w : tw[j].y;
      unsigned sr[kFSlices], si[kFSlices];
      cut3(__fadd_rn(__fmul_rn(yr, c), __fmul_rn(yi, s)), sr);
      cut3(__fsub_rn(__fmul_rn(yi, c), __fmul_rn(yr, s)), si);
#pragma unroll
      for (int k = 0; k < kFSlices; ++k) {
        zr[k] |= sr[k] << (16 * e);
        zi[k] |= si[k] << (16 * e);
      }
    }
#pragma unroll
    for (int k = 0; k < kFSlices; ++k) {
      a2[k][j >> 1][2 * (j & 1)] = zr[k];
      a2[k][j >> 1][2 * (j & 1) + 1] = zi[k];
    }
  }

  float d2[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) d2[i] = 0.0f;
  wg_hold16(d2);
  wg_fence();
#pragma unroll
  for (int p = 0; p < kFPairs; ++p)
#pragma unroll
    for (int s = 0; s < 2; ++s)
      wgmma_32(d2, a2[f_pair_i(p)][s],
               gmma_desc(b2 + f_pair_j(p) * kFB2Slice + s * 2 * kCoreK,
                         kLbo, kFSbo2));
  wg_commit();
  if (more) f_store<N1>(v, swin, b1p);
  wg_wait<0>();
  wg_hold16(d2);

  // power of bins (k1, k2 = 8 t + 2 q + e) at chunk column 16 r + k2,
  // r = 8 wl + g: c columns in n8 tiles 0-1, s columns in tiles 2-3
  const int r = 8 * wl + g;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    float pw[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float xr = __fadd_rn(d2[4 * t + e], d2[4 * (t + 2) + 2 + e]);
      const float xi = __fsub_rn(d2[4 * t + 2 + e], d2[4 * (t + 2) + e]);
      pw[e] = __fadd_rn(__fmul_rn(xr, xr), __fmul_rn(xi, xi));
    }
    const int col = 16 * r + 8 * t + 2 * q;
    if (bf2) {
      unsigned w0 = 0, w1 = 0;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const __nv_bfloat16 q0 = __float2bfloat16_rn(pw[e]);
        const __nv_bfloat16 q1 =
            __float2bfloat16_rn(__fsub_rn(pw[e], __bfloat162float(q0)));
        w0 |= static_cast<unsigned>(__bfloat16_as_ushort(q0)) << (16 * e);
        w1 |= static_cast<unsigned>(__bfloat16_as_ushort(q1)) << (16 * e);
      }
      const int at = swz(row, kFChunkPow * 2, col);
      *reinterpret_cast<unsigned*>(pb + at) = w0;
      *reinterpret_cast<unsigned*>(pb + Lay<3>::kTile * kFChunkPow * 2 +
                                   at) = w1;
    } else {
      *reinterpret_cast<float2*>(reinterpret_cast<float*>(pb) +
                                 row * kFChunkPow + col) =
          make_float2(pw[0], pw[1]);
    }
  }
}

// zero this thread's power-tile entries of row `row` (a frame past the
// clip's last)
__device__ __forceinline__ void f_zero_row(unsigned char* pb, int row,
                                           bool bf2) {
  const int lane = threadIdx.x & 31;
  const int wl = (threadIdx.x >> 5) & 3;
  const int r = 8 * wl + (lane >> 2), q = lane & 3;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int col = 16 * r + 8 * t + 2 * q;
    if (bf2) {
      const int at = swz(row, kFChunkPow * 2, col);
      *reinterpret_cast<unsigned*>(pb + at) = 0u;
      *reinterpret_cast<unsigned*>(pb + Lay<3>::kTile * kFChunkPow * 2 +
                                   at) = 0u;
    } else {
      *reinterpret_cast<float2*>(reinterpret_cast<float*>(pb) +
                                 row * kFChunkPow + col) =
          make_float2(0.0f, 0.0f);
    }
  }
}

// Copy the block's constants to shared memory once: F2's three slices
// as wgmma's core matrices at b2 (element (n2, c) of slice j at j *
// kFB2Slice + (c / 8) * kFSbo2 + n2 * 16 + (c % 8) * 2) and the window
// as swin [n1][kFWinRow] (tap n2 n1 + c at n1 * kFWinRow + c, zero past
// n2). Barrier after.
__device__ __forceinline__ void f_constants(const Factored& f,
                                            unsigned char* b2, float* swin) {
  for (int v = threadIdx.x; v < kFSlices * kFN2 * 4; v += kThreads) {
    const int j = v / (kFN2 * 4), rem = v % (kFN2 * 4);
    const int n2 = rem / 4, cg = rem % 4;
    *reinterpret_cast<uint4*>(b2 + j * kFB2Slice + cg * kFSbo2 + n2 * 16) =
        __ldg(f.f2 + v);
  }
  for (int i = threadIdx.x; i < kFWinRow * f.n1; i += kThreads) {
    const int n1 = i / kFWinRow, c = i % kFWinRow;
    swin[i] = c < f.n2 ? __ldg(f.window + f.n2 * n1 + c) : 0.0f;
  }
  fence_async_shared();
  __syncthreads();
}

// One tile of 64 frames (k0 ..) of clip xb through the factored DFT, the
// projection and the output values (run_head's contract): warpgroup w
// takes frames 32 w .. 32 w + 31, those past n_frames get zero power.
// kNe: a warp's n8 tiles of the energy (nmp / 32; project_bf2).
template <int N1, int kNe>
__device__ __forceinline__ void run_factored(const Head& h, const Factored& f,
                                             const float* xb, long long T,
                                             long long s_tile, int hop,
                                             unsigned char* work,
                                             unsigned char* b2,
                                             const float* swin,
                                             unsigned char* b1, int b, int k0,
                                             int n_frames, bool keep_vals) {
  using L = Lay<3>;
  unsigned char* pb = work + L::kRingBytes;
  const int wg = threadIdx.x >> 7;
  const int f0 = 32 * wg;
  int live = n_frames - k0 - f0;
  live = live < 0 ? 0 : (live > 32 ? 32 : live);
  const unsigned sb1 = smem_addr(b1), sb2 = smem_addr(b2);
  head_tile<3, kNe>(h, work, b, k0, n_frames, keep_vals, [&](Frag& en) {
    for (int ch = 0; ch < N1 / 32; ++ch) {
      FChunk<N1> cc;
      cc.load(f, ch);
      float v[FStage<N1>::kGroups][8];
      if (live > 0) {
        f_load<N1>(xb, T, s_tile + static_cast<long long>(f0) * hop, f.n2,
                   v);
        f_store<N1>(v, swin, b1);
      }
      for (int i = 0; i < live; ++i) {
        fence_async_shared();
        wg_bar();  // this frame's B1, from every warp of the warpgroup
        const bool more = i + 1 < live;
        if (more)
          f_load<N1>(xb, T,
                     s_tile + static_cast<long long>(f0 + i + 1) * hop,
                     f.n2, v);
        f_frame<N1>(cc, sb1, sb2, pb, f0 + i, h.bf2, more, v, swin, b1);
      }
      for (int i = live; i < 32; ++i) f_zero_row(pb, f0 + i, h.bf2);
      __syncthreads();  // the chunk's power, from every warp
      if (h.bf2)
        project_bf2<3, kNe>(h, ch, pb, work, en, f.rowmap);
      else
        project_f32<3, kNe>(h, ch, pb, en, f.rowmap);
      __syncthreads();  // the power tile and the ring are free again
    }
  });
}

}  // namespace sigk
