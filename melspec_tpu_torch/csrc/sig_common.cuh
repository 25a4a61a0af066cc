// Device code shared by K1 (sig_mel.cu) and K2 (sig_multi.cu): the tile
// layouts, the accurate logarithms, the staging of a tile's signal span
// into bf16 slices, one head's run (slice-pair DFT and bf2 projection on
// the tensor cores, power, output values) and the two epilogues that read
// a whisper head's normalized tile (Sobel VAD counts, u8 wire records).
// Both kernels call the same functions in the same order, so a head of K2
// with K1's matrices and block order computes K1's output bit for bit,
// and the two count VAD edges with one piece of code. K5-K8
// (framed_ozaki.cu) take the copy and wgmma primitives, the logarithms
// and the whisper norm of a log row from here too.
//
// Replaces the TPU kernels' shared body (melspec_tpu/ops/mel_kernel.py::
// _sig_mel_tile_kernel: _sig_xcat, _sig_project, _sig_out_vals), whose
// DFT and projection are bf16 x bf16 -> f32 matrix-unit dots. Here they
// run on the tensor cores too: the DFT as wgmma m64n128k16, the bf2
// projection as mma.sync m16n8k16, both with float32 accumulation.
//
// What bounds it: operations (2.46 MFLOP of DFT a frame at whisper
// 400/160 against 640 bytes of new signal), then the L2 reads of m_big:
// every block reads each live column of every K block once, about 1.9 MB
// at 400/160 (6 blocks x 400 rows x 400 live of 512 columns x 2 bytes),
// whatever its frame count. The design:
//   - A block owns 128 frames of one clip (Lay<0>'s geometry: each of the
//     two warpgroups takes 64 frames and all 128 columns of a chunk;
//     walked only by the pipelined walk of sig_pipe.cuh, layout 4), or 64
//     (Lay<1>: each warpgroup takes all 64 frames and half of a 256-column
//     chunk) where the 128-frame span and the pipelined ring do not fit
//     in shared memory or a head has more than 128 padded mel columns, or
//     32 (Lay<2>: Lay<1>'s walk with rows 32-63 of each warpgroup's m64
//     tile held at zero) where neither fits (the wide hops: 960/480,
//     1024/480, 2048/512). The synchronous walk below (run_head) is
//     Lay<1>'s and Lay<2>'s.
//     Either way a k16 step of the DFT is one wgmma m64n128k16 per
//     warpgroup, A from registers, B from the ring by descriptor, and a
//     thread holds 64 float32 DFT accumulators; the larger tile halves the
//     m_big bytes per frame, and Lay<2> spends half its DFT work on the
//     zero rows. C = 3 (sig_factored.cuh) is the wide whisper heads'
//     two-stage DFT in 64-frame blocks; it shares the projection, the
//     outputs and the epilogues below, not the chunk walk.
//   - The tile's signal span is staged once as ks bf16 slices in shared
//     memory, cut into hop-long segments whose row stride is padded to 8
//     mod 16 elements: frame f's taps start in segment f, so the 8 frame
//     rows of an A fragment fall on 8 distinct bank groups. An A fragment
//     is read as 32-bit tap pairs where the hop and the head's pack_off
//     are even, else as 16-bit taps (the NeMo tri-head's pack_off of 257):
//     two compiled paths.
//   - The DFT columns are walked in chunks (128-frame blocks: 128
//     columns, Lay<1>: 256; split: half re columns with their im columns, each warpgroup's
//     re columns beside their im columns; N-packed: all single). A chunk's
//     m_big rows stream through a 4-stage cp.async ring of 32-row stages,
//     stored as wgmma's core matrices of 8 rows x 16 bytes, each warp's
//     copies laid out to land on distinct banks; the walk loads the next
//     step's A fragments while the current step's wgmma's run. Columns
//     past a head's live count, which the host passes, are not read.
//   - The chunk's power goes to shared memory as bf16 p0 | p1 (or
//     float32), and the bf2 projection [p0 | p0 | p1] @ [F0; F1; F0] of
//     its rows runs on mma.sync (kWM warp rows of 32 frames x kWN warp
//     columns), the projection rows staged through the same ring,
//     accumulating the energy [tile, nmp] in registers (64 floats a thread
//     at most) across chunks. The "highest" (f32)
//     projection stays float32 FMAs. Shared memory and registers do not
//     depend on the head's width: 256-, 512-, 1024- and 2048-column heads
//     differ in their chunk count only.
//   - After the last chunk: logs, the whisper norm or the ln modes, and
//     the epilogues on the normalized tile.
//   Sum order: every output sums the head's K blocks in the given order
//   and each block's taps in ascending k16 steps, then the projection's
//   power columns in ascending k16 steps, whatever the layout.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sigk {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// the tile of the VAD counts' zeros (the last two frames of every 64) and
// of P1's spans; the frames of a Lay<0> or Lay<1> block are a multiple of
// it, and a Lay<2> block counts on its own 32 frames (Lay::kVadTile)
constexpr int kTileFrames = 64;
constexpr int kChunk = 32;       // m_big rows per ring stage
constexpr int kMaxBlocks = 16;   // K blocks (slice pairs)
constexpr int kMaxSlices = 4;
constexpr int kMaxNmp = 256;
constexpr long long kSmemLimit = 232448;  // a block's shared memory
// a block's static shared memory: the shared copy of a head's block table
constexpr int kStaticSmem = 4 * 2 * kMaxBlocks;
// the DFT's wgmma: B (a ring stage) is N contiguous, stored as core
// matrices of 8 K rows x 8 columns (128 bytes), 4 along K (a 32-row
// stage) for each 8 columns; the 512 bytes of each 8 columns are padded
// to 528, so that neighbouring column groups start on different banks
constexpr int kTnspB = 1;
constexpr unsigned kCoreK = 128;  // bytes between core matrices along K
constexpr unsigned kCoreN = 528;  // bytes between core matrices along N
constexpr unsigned kLbo = kCoreK;
constexpr unsigned kSbo = kCoreN;

// The factored layout's ring for the projection rows (C = 3)
constexpr int kFactoredRing = 48 * 1024;

// The block layouts: C = 0 holds 128 frames (the geometry of layout 4,
// the pipelined walk of sig_pipe.cuh: no kernel walks C = 0 otherwise), C
// = 1 64, C = 2 32, C = 3 (the factored wide-hop path of
// sig_factored.cuh) 64, with chunks of 512 power columns (1024 DFT
// columns) and its own ring size. The DFT: warpgroup w takes frames [w *
// kWgFrames, + 64) and ring columns [w * kWgCols, + 128) of a chunk of
// kCols (Lay<0>: its own 64 frames and all 128 columns; Lay<1>: all 64
// frames and half of 256 columns; Lay<2>: Lay<1>'s split with only rows
// 0-31 of the m64 tile holding frames, so warps 2 and 3 of each
// warpgroup give zero A rows and store no power). The projection and the
// outputs: kWM warp rows of 32 frames x kWN warp columns. A ring stage
// holds 32 m_big rows of a chunk; the synchronous walk's cp.async ring
// (Lay<1>, Lay<2>) holds kSlots of them.
template <int C>
struct Lay {
  static constexpr int kWM = C == 0 ? 4 : (C == 2 ? 1 : 2);
  static constexpr int kSlots = 4;  // ring stages
  static constexpr int kWN = kWarps / kWM;
  static constexpr int kTile = 32 * kWM;            // frames per block
  // DFT columns per chunk
  static constexpr int kCols = C == 0 ? 128 : (C == 3 ? 1024 : 256);
  static constexpr int kWgFrames = C == 0 ? 64 : 0;
  static constexpr int kWgCols = C == 0 ? 0 : 128;
  static constexpr bool kMasked = C == 2;  // m64 rows 32-63 hold no frame
  static constexpr int kStageBytes = kCols / 8 * kCoreN;
  static constexpr int kRingBytes =
      C == 3 ? kFactoredRing : kSlots * kStageBytes;
  static constexpr int kMaxMels = 8 * 8 * kWN;  // energy: 8 n8 tiles a warp
  // the VAD counts' tile: the last two frames of each get 0
  static constexpr int kVadTile = kTile < kTileFrames ? kTile : kTileFrames;
};

// C = 4: Lay<0>'s tile walked by the warp-specialised pipeline of
// sig_pipe.cuh (K1's and K2's 128-frame blocks): the same frames, chunks
// and warp tiles, its own ring
template <>
struct Lay<4> : Lay<0> {};

// a barrier of the warps that compute the tile: the block's (C = 4: the
// eight warps beside the producer warp, named barrier 1)
template <int C>
__device__ __forceinline__ void sync_tile() {
  if constexpr (C == 4)
    asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
  else
    __syncthreads();
}

// whether this warp's 16 rows of its warpgroup's m64 tile hold frames
template <int C>
__device__ __forceinline__ bool rows_live() {
  return !Lay<C>::kMasked || ((threadIdx.x >> 5) & 3) < 2;
}

// ops/fastmath.py: _E_ROUND, float32(log10(2)), float32(ln(2)) and the
// Horner coefficients float32(scale * (2/7, 2/5, 2/3, 2)) with scale
// float32(1/ln 10) (log10) or 1 (ln); a CPU test holds these literals to
// the Python constants.
constexpr int kERound = 0x4AFB0D;
constexpr float kLog10Of2 = 0x1.344136p-2f;
constexpr float kC7 = 0x1.fc3fa6p-4f;
constexpr float kC5 = 0x1.63c628p-3f;
constexpr float kC3 = 0x1.287a76p-2f;
constexpr float kC1 = 0x1.bcb7b2p-1f;
constexpr float kLn2 = 0x1.62e43p-1f;
constexpr float kLnC7 = 0x1.24924ap-2f;
constexpr float kLnC5 = 0x1.99999ap-2f;
constexpr float kLnC3 = 0x1.555556p-1f;
constexpr float kLnC1 = 0x1.0p+1f;
constexpr float kLogFloor = 1e-10f;

// Whether the walks' power stages keep a magnitude head's root: K2
// (sig_multi.cu), whose heads are power heads, defines SIG_POWER_ONLY and
// keeps no magnitude code, which cost its pipelined walk 1-3% even where no
// head used it
#ifdef SIG_POWER_ONLY
constexpr bool kMagnitudeHeads = false;
#else
constexpr bool kMagnitudeHeads = true;
#endif

// output modes (ops/mel_kernel.py::_sig_out_vals): whisper log10 + norm,
// NeMo ln(e + guard), Kaldi ln(max(e, guard)); guard arrives clamped to
// the smallest normal float32
enum OutMode { kWhisper = 0, kLnGuard = 1, kLnFloor = 2 };

// One head: its K-stacked DFT matrix, the order its K blocks are summed
// in, the taps it contracts, its column layout, projection and output.
struct Head {
  const __nv_bfloat16* m_big;  // [K_tot, width]
  const int* blocks;           // [n_blocks][2]: K block, its signal slice
  const void* mt;              // bf16 [3*npow, nmp] (bf2) or f32 [npow, nmp]
  float* out;                  // [B, n_frames, n_mels]
  int n_blocks, pack, pack_off;
  int width;                   // DFT columns: 256, 512, 1024 or 2048
  int npow;                    // width / 2: split re|im halves; width: N-packed
  int live;                    // power columns [0, live) may be nonzero
  int n_mels, n_mels_pad, bf2, out_mode;
  float guard;
  int magnitude;  // split heads: sqrt(re^2 + im^2) in place of the power
};

__host__ __device__ inline long long align16(long long n) {
  return (n + 15) / 16 * 16;
}

// staged samples of a tile of `tile` frames: every head reads taps
// [pack_off, pack_off + pack) of each frame, rounded up to whole stages
__host__ __device__ inline int span_len(int tile, int hop, int pack,
                                        int pack_off) {
  return (tile - 1) * hop + pack_off + (pack + kChunk - 1) / kChunk * kChunk;
}

// The staged span: samples u = seg * hop + pos at element seg * stride +
// pos of each slice; the stride is the hop padded to 8 mod 16 elements
struct Span {
  int hop, stride, len;
  int slice;  // elements of one slice
};

__host__ __device__ inline Span make_span(int hop, int len) {
  Span s;
  s.hop = hop;
  s.stride = hop + ((8 - hop % 16) + 16) % 16;
  s.len = len;
  s.slice = (len + hop - 1) / hop * s.stride;
  return s;
}

__host__ __device__ inline long long span_bytes(int ks, const Span& s) {
  return align16(2LL * ks * s.slice);
}

// power columns of one chunk: all of its DFT columns (N-packed) or half
template <int C>
__host__ __device__ inline int chunk_pow(int width, int npow) {
  return npow == width ? Lay<C>::kCols : Lay<C>::kCols / 2;
}

// shared memory after the span in the synchronous walk's layouts (1, 2):
// the ring, then one chunk's power tile (bf16 p0 and p1, or float32: 4
// bytes a value either way); the log tile [tile][nmp] of the epilogue
// reuses both
template <int C>
__host__ __device__ inline long long work_bytes(int width, int npow) {
  static_assert(C == 1 || C == 2, "the synchronous walk's layouts");
  return Lay<C>::kRingBytes +
         4LL * Lay<C>::kTile * chunk_pow<C>(width, npow);
}

// the bf16 in the low / high half of a 32-bit word, widened to float32
__device__ __forceinline__ float bf16_lo(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}

// max that keeps a NaN, like jnp.maximum / torch.maximum
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// ops/fastmath.py::_decompose + _ln_mantissa, operation for operation
// (the _rn intrinsics keep nvcc from contracting into FMAs)
__device__ __forceinline__ float log_series(float x, float c7, float c5,
                                            float c3, float c1, float l2) {
  const int bits = __float_as_int(x);
  const int e = ((bits + kERound) >> 23) - 127;
  const float m = __int_as_float(bits - e * (1 << 23));
  const float t = __fdiv_rn(__fsub_rn(m, 1.0f), __fadd_rn(m, 1.0f));
  const float t2 = __fmul_rn(t, t);
  float p = __fadd_rn(__fmul_rn(t2, c7), c5);
  p = __fadd_rn(__fmul_rn(p, t2), c3);
  p = __fadd_rn(__fmul_rn(p, t2), c1);
  return __fadd_rn(__fmul_rn(static_cast<float>(e), l2), __fmul_rn(p, t));
}

// ops/fastmath.py::log10_accurate
__device__ __forceinline__ float log10_accurate(float x) {
  return log_series(x, kC7, kC5, kC3, kC1, kLog10Of2);
}

// ops/fastmath.py::ln_accurate
__device__ __forceinline__ float ln_accurate(float x) {
  return log_series(x, kLnC7, kLnC5, kLnC3, kLnC1, kLn2);
}

// ---- tensor-core and copy primitives (sm_80+ PTX) -------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !ok (src is then not read)
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
// orders this thread's earlier generic-proxy writes to shared memory
// (st.shared, cp.async) before async-proxy reads of the same bytes
// (wgmma's B by descriptor): every writer issues it before the barrier
// that hands the bytes to the wgmma's
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ unsigned lds32(unsigned addr) {
  unsigned v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}
__device__ __forceinline__ unsigned lds16(unsigned addr) {
  unsigned short v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(v) : "r"(addr));
  return v;
}

// c += a (16 x 16, row) . b (16 x 8, col), bf16 in, float32 accumulation
__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// byte offset of element col (bf16) of a swizzled row of row_bytes: the
// row's 16-byte groups are permuted by the row's low three bits
__device__ __forceinline__ int swz(int row, int row_bytes, int col) {
  return row * row_bytes + ((((col >> 3) ^ (row & 7))) << 4) + (col & 7) * 2;
}

// ---- warpgroup mma (sm_90a) for the DFT ------------------------------------

// The shared-memory matrix descriptor of wgmma for a no-swizzle layout of
// core matrices (8 rows x 16 bytes, 128 contiguous bytes): start address,
// then the byte offsets between core matrices along the leading and the
// strided dimension
__device__ __forceinline__ unsigned long long gmma_desc(unsigned addr,
                                                        unsigned lbo,
                                                        unsigned sbo) {
  return static_cast<unsigned long long>((addr & 0x3FFFF) >> 4) |
         static_cast<unsigned long long>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<unsigned long long>((sbo >> 4) & 0x3FFF) << 32;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of an accumulator across
// an asynchronous wgmma
__device__ __forceinline__ void wg_hold(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 128] += a (64 x 16: this warp's 16 rows in registers, as the
// m16n8k16 A fragment) . B (16 x 128 bf16 in shared memory, N contiguous,
// given by desc), float32 accumulation; asynchronous until wg_wait
__device__ __forceinline__ void wgmma_128(float (&d)[64],
                                          const unsigned (&a)[4],
                                          unsigned long long desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %70, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %69;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "n"(kTnspB), "r"(1));
}

// Stage samples s0 .. s0 + len - 1 of one clip and cascade them into ks
// bf16 slices (round to nearest even, as astype does; the cascade is
// elementwise, so cascading the span equals cascading each frame), in the
// segmented layout of Span. Samples past the clip read as zero. A thread
// loads four samples at a time (one 16-byte load where the span start is
// 16-byte aligned) and keeps four such loads in flight.
__device__ __forceinline__ void stage_span(const float* xb, long long T,
                                           long long s0, const Span& sp,
                                           int ks, __nv_bfloat16* sx) {
  const float* src = xb + s0;
  const bool vec = (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  for (int v0 = threadIdx.x; 4 * v0 < sp.len; v0 += 4 * kThreads) {
    float4 v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int u = 4 * (v0 + i * kThreads);
      if (vec && u + 3 < sp.len && s0 + u + 3 < T) {
        v[i] = __ldg(reinterpret_cast<const float4*>(src + u));
      } else {
        float w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          w[e] = u + e < sp.len && s0 + u + e < T ? __ldg(src + u + e)
                                                  : 0.0f;
        v[i] = make_float4(w[0], w[1], w[2], w[3]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int u = 4 * (v0 + i * kThreads);
      if (u >= sp.len) break;
      const float w[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
      const int seg = u / sp.hop;
      const int at = seg * sp.stride + (u - seg * sp.hop);
      if (u + 3 < sp.len && u + 3 - seg * sp.hop < sp.hop && (at & 3) == 0) {
        // the four samples in one segment, 8-byte aligned: one store of
        // four bf16 a slice
        float r[4] = {w[0], w[1], w[2], w[3]};
        for (int k = 0; k < ks; ++k) {
          unsigned p[2] = {0, 0};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const __nv_bfloat16 h = __float2bfloat16_rn(r[e]);
            p[e >> 1] |= static_cast<unsigned>(__bfloat16_as_ushort(h))
                         << (16 * (e & 1));
            r[e] = __fsub_rn(r[e], __bfloat162float(h));
          }
          *reinterpret_cast<uint2*>(sx + k * sp.slice + at) =
              make_uint2(p[0], p[1]);
        }
        continue;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (u + e >= sp.len) break;
        const int seg = (u + e) / sp.hop;
        const int at = seg * sp.stride + (u + e - seg * sp.hop);
        float r = w[e];
        for (int k = 0; k < ks; ++k) {
          const __nv_bfloat16 h = __float2bfloat16_rn(r);
          sx[k * sp.slice + at] = h;
          r = __fsub_rn(r, __bfloat162float(h));
        }
      }
    }
  }
}

// The whisper norm of one frame's log10 row lg[0, nmp) by one warp: the
// row max over every padded column (a pad column's log sits at the floor),
// then (max(v, max - 8) + 4) / 4 for the first n_mels columns, stored to o
// (unless null) and, with keep, back into lg.
__device__ __forceinline__ void whisper_norm_row(float* lg, int nmp,
                                                 int n_mels, float* o,
                                                 bool keep) {
  const int lane = threadIdx.x & 31;
  float mx = lg[lane];
  for (int m = lane + 32; m < nmp; m += 32) mx = max_nan(mx, lg[m]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = max_nan(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  const float lo = __fsub_rn(mx, 8.0f);
  for (int m = lane; m < n_mels; m += 32) {
    const float v = __fmul_rn(__fadd_rn(max_nan(lg[m], lo), 4.0f), 0.25f);
    if (o) o[m] = v;
    if (keep) lg[m] = v;
  }
}

// ---- one head -------------------------------------------------------------

// A head's register tiles: [m16 tile of the warp][n8 tile][fragment].
// Fragment e of an n8 tile sits at row g + 8 * (e >> 1), column 2q + (e &
// 1) of the tile (g = lane / 4, q = lane % 4).
using Frag = float[2][8][4];

__device__ __forceinline__ bool split_head(const Head& h) {
  return h.npow != h.width;
}

// The ring stages of one chunk: K block nb's rows t0 .. t0 + 31, the
// blocks in the head's order, as wgmma's core matrices (kCoreK, kCoreN).
// Columns past the live count and rows past the block's taps are
// zero-filled, not read. Ring column group G (8 columns) holds, split, the
// chunk's re group (G / 16) * 8 + G % 8 where G % 16 < 8, else the im
// group of that re group, so each warpgroup's 128 ring columns hold its re
// columns beside their im columns; N-packed, the chunk's group G. A warp's
// copies of one pass land on distinct banks: 8 rows x 4 column groups a
// pass (64 bytes of each row, four whole core matrices of the stage), a
// thread the same row of groups 8 apart.
template <int C>
struct Filler {
  static_assert(C == 1 || C == 2, "the synchronous walk's layouts");
  using L = Lay<C>;
  static constexpr int kGroups = L::kCols / 8;              // per ring row
  static constexpr int kPer = kChunk * kGroups / kThreads;  // passes: 4
  static constexpr int kPassBytes = 8 * kCoreN;
  const __nv_bfloat16* col;  // m_big column of this thread's first group
  // columns from it to its group of pass i: (i & 1) * col_odd + (i >> 1) *
  // col_hi (split: the im group, the next warpgroup's re group)
  int col_odd, col_hi;
  unsigned col_ok;  // bit i: pass i's group holds live columns
  int r0;           // the ring row of this thread
  unsigned dst0;    // its shared address in stage 0
  int nb, t0;       // the next stage to fill

  __device__ __forceinline__ Filler(const Head& h, int ch, unsigned ring) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int c = (warp >> 2) * 4 + (lane >> 3);
    r0 = (warp & 3) * 8 + (lane & 7);
    const bool split = split_head(h);
    const int pcol = (split ? ch * (L::kCols / 2) : ch * L::kCols) + c * 8;
    col = h.m_big + pcol;
    col_odd = split ? h.npow : 64;
    col_hi = split ? 64 : 128;
    col_ok = 0;
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      col_ok |= static_cast<unsigned>(
                    pcol + (split ? (i >> 1) * 64 : i * 64) < h.live) << i;
    dst0 = ring + c * kCoreN + r0 / 8 * kCoreK + (r0 % 8) * 16;
    nb = 0;
    t0 = 0;
  }

  // copy the next stage into ring slot `slot`, then step to the stage
  // after it; past the last block this copies nothing
  __device__ __forceinline__ void next(const Head& h, const int* tab,
                                       int slot) {
    if (nb < h.n_blocks) {
      const long long base =
          static_cast<long long>(tab[2 * nb] * h.pack + t0) * h.width;
      const bool row_ok = t0 + r0 < h.pack;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const bool ok = ((col_ok >> i) & 1) && row_ok;
        cp_async16(dst0 + slot * L::kStageBytes + i * kPassBytes,
                   ok ? col + (i & 1) * col_odd + (i >> 1) * col_hi + base +
                            static_cast<long long>(r0) * h.width
                      : h.m_big,
                   ok);
      }
      t0 += kChunk;
      if (t0 >= h.pack) {
        t0 = 0;
        ++nb;
      }
    }
    cp_async_commit();
  }
};

// this thread's A register (taps t, t + 1 of one frame row) at element e
// of the segmented span, pos = the tap's place in its segment
template <bool kFast>
__device__ __forceinline__ unsigned a_pair(unsigned xs, int e, int pos,
                                           const Span& sp) {
  if (kFast) return lds32(xs + 2 * e);
  const int e1 = pos + 1 < sp.hop ? e + 1 : e - pos + sp.stride;
  return lds16(xs + 2 * e) | (lds16(xs + 2 * e1) << 16);
}

// y[tile, chunk] = sum_blk x_{slice(blk)} . m_big[blk rows, chunk columns]
// over the head's blocks in the given order, taps ascending in k16 steps,
// bf16 wgmma with float32 accumulation. Each warpgroup takes the block's
// 64 frames (a warp 16 of them) and 128 ring columns of the chunk
// (Lay::kWgCols), so a k16 step is one m64n128k16 per warpgroup, A from
// registers (the warp's tap pairs of the segmented span: frame f of the
// tile reads slice taps at f * hop + pack_off), B from the ring stage by
// descriptor. d[4j + e] is n8 tile j of the warpgroup's columns, fragment
// e (as an mma tile). The ring is free again when this returns.
template <int C, bool kFast>
__device__ __forceinline__ void dft_chunk(const Head& h, const int* tab,
                                          int ch, unsigned sx,
                                          const Span& sp, unsigned ring,
                                          float (&d)[64]) {
  static_assert(C == 1 || C == 2, "the synchronous walk's layouts");
  using L = Lay<C>;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.0f;
  int roff[2];  // element offset of this thread's two frame rows
  roff[0] = ((warp & 3) * 16 + g) * sp.stride;
  roff[1] = roff[0] + 8 * sp.stride;
  const int cpb = (h.pack + kChunk - 1) / kChunk;  // stages per K block
  const int n_steps = h.n_blocks * cpb;
  // this warpgroup's columns in a ring stage
  const unsigned wg_cols = (warp >> 2) * (L::kWgCols / 8) * kCoreN;
  // Lay<2>: the rows past the tile read nothing and stay zero
  const bool live = rows_live<C>();

  __syncthreads();  // the ring and the span are ready for this chunk
  // stage s's wgmma's run while stage s + 1 is set up; stages up to s +
  // kSlots - 2 are in flight, and the fill of that stage reuses the slot
  // of stage s - 2, whose wgmma's every warpgroup has waited for before
  // the barrier. A alternates between two buffers: the next step's A is
  // loaded as soon as the wgmma's that read its buffer are done, while
  // this step's run
  constexpr int kAhead = L::kSlots - 2;
  Filler<C> fill(h, ch, ring);
#pragma unroll
  for (int i = 0; i < kAhead; ++i) fill.next(h, tab, i);
  unsigned xs = sx;
  int seg[2] = {0, 0}, pos[2] = {0, 0};
  int nb = 0, t0 = 0, s = 0;
  // the A fragments of the next step and its first tap row tt
  auto load = [&](unsigned (&a)[2][4], int& tt) {
    if (t0 == 0) {
      xs = sx + 2 * tab[2 * nb + 1] * sp.slice;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int t = h.pack_off + 2 * q + 8 * hh;
        seg[hh] = t / sp.hop;
        pos[hh] = t - seg[hh] * sp.hop;
      }
    }
    tt = t0;
    t0 += kChunk;
    if (t0 >= h.pack) {
      t0 = 0;
      ++nb;
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int dd = seg[hh] * sp.stride + pos[hh];
#pragma unroll
        for (int rw = 0; rw < 2; ++rw)
          a[k][rw + 2 * hh] =
              live ? a_pair<kFast>(xs, roff[rw] + dd, pos[hh], sp) : 0u;
        pos[hh] += 16;
        while (pos[hh] >= sp.hop) {
          pos[hh] -= sp.hop;
          ++seg[hh];
        }
      }
    }
  };
  auto step = [&](unsigned (&a)[2][4], int tt, unsigned (&next)[2][4],
                  int& tt_next) {
    cp_async_wait<kAhead - 1>();
    fence_async_shared();
    __syncthreads();  // stage s landed; stage s - 2's wgmma's are done
    fill.next(h, tab, (s + kAhead) % L::kSlots);
    const unsigned st = ring + (s % L::kSlots) * L::kStageBytes + wg_cols;
    wg_hold(d);
    wg_fence();
    wgmma_128(d, a[0], gmma_desc(st, kLbo, kSbo));
    if (tt + 16 < h.pack)
      wgmma_128(d, a[1], gmma_desc(st + 2 * kCoreK, kLbo, kSbo));
    wg_commit();
    wg_wait<1>();  // stage s - 1's wgmma's, and their A buffer, are done
    wg_hold(d);
    if (++s < n_steps) load(next, tt_next);
  };
  unsigned a0[2][4], a1[2][4];
  int tt0 = 0, tt1 = 0;
  if (n_steps > 0) load(a0, tt0);
  while (s < n_steps) {
    step(a0, tt0, a1, tt1);
    if (s < n_steps) step(a1, tt1, a0, tt0);
  }
  wg_wait<0>();
  wg_hold(d);
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring
}

// The chunk's power into shared memory: split re^2 + im^2 (a magnitude
// head: its sqrt, correctly rounded as torch.sqrt; the head's flag, read
// once, is uniform, and this branch a value kept the power heads' time
// where an instance a flag cost the 64-frame walk 1%), N-packed y^2 per
// column;
// bf2 as bf16 p0 = bf16(power) and p1 = bf16(power - p0), each
// [tile][cp] with swizzled rows, else float32 [tile][cp]. Tile j of d
// holds the warpgroup's power columns 8j .. 8j + 7 (split: re tiles 0-7,
// their im tiles 8-15).
template <int C>
__device__ __forceinline__ void store_power(const Head& h,
                                            const float (&d)[64],
                                            unsigned char* pb) {
  static_assert(C == 1 || C == 2, "the synchronous walk's layouts");
  using L = Lay<C>;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const bool split = split_head(h);
  const bool mag = kMagnitudeHeads && h.magnitude;
  const int cp = chunk_pow<C>(h.width, h.npow);
  const int wg = warp >> 2;
  const int col0 = wg * (split ? L::kWgCols / 2 : L::kWgCols);
  if (!rows_live<C>()) return;  // Lay<2>: zero rows, no frames
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if (split && j >= 8) continue;
    const int col = col0 + j * 8 + 2 * q;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = (warp & 3) * 16 + g + 8 * hh;
      float pw[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float y = d[4 * j + 2 * hh + e];
        if (split) {
          const float im = d[4 * (j + 8) + 2 * hh + e];
          pw[e] = __fadd_rn(__fmul_rn(y, y), __fmul_rn(im, im));
          if (mag) pw[e] = __fsqrt_rn(pw[e]);
        } else {
          pw[e] = __fmul_rn(y, y);
        }
      }
      if (h.bf2) {
        unsigned w0 = 0, w1 = 0;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const __nv_bfloat16 q0 = __float2bfloat16_rn(pw[e]);
          const __nv_bfloat16 q1 =
              __float2bfloat16_rn(__fsub_rn(pw[e], __bfloat162float(q0)));
          w0 |= static_cast<unsigned>(__bfloat16_as_ushort(q0)) << (16 * e);
          w1 |= static_cast<unsigned>(__bfloat16_as_ushort(q1)) << (16 * e);
        }
        const int at = swz(row, cp * 2, col);
        *reinterpret_cast<unsigned*>(pb + at) = w0;
        *reinterpret_cast<unsigned*>(pb + L::kTile * cp * 2 + at) = w1;
      } else {
        *reinterpret_cast<float2*>(
            reinterpret_cast<float*>(pb) + row * cp + col) =
            make_float2(pw[0], pw[1]);
      }
    }
  }
}

// mt's row of power column c of the head (rowmap: the factored layout's
// order of its power columns; null: the columns in order)
__device__ __forceinline__ int mt_row(const int* rowmap, int c) {
  return rowmap ? __ldg(rowmap + c) : c;
}

// en[tile, nmp] += [p0 | p0 | p1] @ [F0; F1; F0] over the chunk's live
// power rows: bf16 mma, the three row blocks of mt staged through the
// ring in pieces; per k16 step p0 . F0, p0 . F1, p1 . F0 in that order.
// Power column c of the head reads mt row mt_row(rowmap, c). kNe caps a
// warp's n8 tiles of the energy at compile time (8: any head; 4: at most
// 128 padded mel columns), so a caller that knows the head's width keeps
// the rest of en out of its registers.
template <int C, int kNe = 8>
__device__ __forceinline__ void project_bf2(const Head& h, int ch,
                                            const unsigned char* pb,
                                            unsigned char* ring, Frag& en,
                                            const int* rowmap = nullptr) {
  using L = Lay<C>;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp / L::kWN, wn = warp % L::kWN;
  const int cp = chunk_pow<C>(h.width, h.npow);
  const int nmp = h.n_mels_pad;
  const int ne = nmp / (8 * L::kWN);  // n8 tiles of a warp: 4 or 8
  // rows of each of the three stacks a piece holds
  const int rows_max = (L::kRingBytes / (6 * nmp)) & ~15;
  const int vec = nmp / 8;  // 16-byte groups of a row
  int kmax = h.live - ch * cp;
  kmax = kmax < cp ? kmax : cp;
  kmax = (kmax + 15) & ~15;
  const __nv_bfloat16* F = static_cast<const __nv_bfloat16*>(h.mt);
  const unsigned sring = smem_addr(ring);
  const unsigned p0 = smem_addr(pb);
  const unsigned p1 = p0 + L::kTile * cp * 2;
  const int mi = lane >> 3;
  const int lrow = (lane & 7) + ((mi & 1) << 3);
  for (int k0 = 0; k0 < kmax; k0 += rows_max) {
    const int rows = kmax - k0 < rows_max ? kmax - k0 : rows_max;
    for (int v = tid; v < 3 * rows * vec; v += kThreads) {
      const int rr = v / vec;
      const int c = v - rr * vec;
      const int s = rr / rows;
      const int r = rr - s * rows;
      const int srow = s * rows_max + r;
      cp_async16(sring + srow * nmp * 2 + ((c ^ (srow & 7)) << 4),
                 F + static_cast<long long>(
                         s * h.npow + mt_row(rowmap, ch * cp + k0 + r)) *
                         nmp + c * 8,
                 true);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int kk = 0; kk < rows; kk += 16) {
      unsigned a0[2][4], a1[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int at = swz(wm * 32 + m * 16 + lrow, cp * 2,
                           k0 + kk + ((mi >> 1) << 3));
        ldsm_x4(a0[m], p0 + at);
        ldsm_x4(a1[m], p1 + at);
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        if (2 * jj >= ne || 2 * jj >= kNe) break;
        const int n0 = wn * (nmp / L::kWN) + jj * 16;
        unsigned b[3][4];
#pragma unroll
        for (int s = 0; s < 3; ++s)
          ldsm_x4_t(b[s], sring + swz(s * rows_max + kk + lrow, nmp * 2,
                                      n0 + ((mi >> 1) << 3)));
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            mma(en[m][2 * jj + t], a0[m], b[0][2 * t], b[0][2 * t + 1]);
            mma(en[m][2 * jj + t], a0[m], b[1][2 * t], b[1][2 * t + 1]);
            mma(en[m][2 * jj + t], a1[m], b[2][2 * t], b[2][2 * t + 1]);
          }
      }
    }
    __syncthreads();  // the ring holds the next piece or chunk next
  }
}

// en += power @ mt (float32 [npow, nmp]) over the chunk's live power
// rows, float32 FMAs in ascending row order (mt rows and kNe as
// project_bf2's)
template <int C, int kNe = 8>
__device__ __forceinline__ void project_f32(const Head& h, int ch,
                                            const unsigned char* pb,
                                            Frag& en,
                                            const int* rowmap = nullptr) {
  using L = Lay<C>;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int wm = warp / L::kWN, wn = warp % L::kWN;
  const int cp = chunk_pow<C>(h.width, h.npow);
  const int nmp = h.n_mels_pad;
  const int ne = nmp / (8 * L::kWN);
  int kmax = h.live - ch * cp;
  kmax = kmax < cp ? kmax : cp;
  const float* F = static_cast<const float*>(h.mt);
  const float* P = reinterpret_cast<const float*>(pb);
  for (int c = 0; c < kmax; ++c) {
    float pa[2][2];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        pa[m][hh] = P[(wm * 32 + m * 16 + g + 8 * hh) * cp + c];
    const float* fr = F + static_cast<long long>(
                              mt_row(rowmap, ch * cp + c)) * nmp +
                      wn * (nmp / L::kWN) + 2 * q;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j >= ne || j >= kNe) break;
      const float f0 = __ldg(fr + 8 * j);
      const float f1 = __ldg(fr + 8 * j + 1);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        en[m][j][0] = fmaf(pa[m][0], f0, en[m][j][0]);
        en[m][j][1] = fmaf(pa[m][0], f1, en[m][j][1]);
        en[m][j][2] = fmaf(pa[m][1], f0, en[m][j][2]);
        en[m][j][3] = fmaf(pa[m][1], f1, en[m][j][3]);
      }
    }
  }
}

// One head's energy tile over the block's frames and its output values:
// en [tile, nmp] is zeroed, walk(en) adds the projection of each chunk of
// the head's power, then the values of the head's mode. Whisper:
// log10_accurate(max(e, 1e-10)) into the log tile [tile][nmp] at work, the
// row max over the padded mel columns, (max(v, max - 8) + 4) / 4; with
// keep_vals the normalized rows stay in the log tile for an epilogue that
// follows (after a barrier). ln modes: ln_accurate(e + guard) or
// ln_accurate(max(e, guard)) straight from the registers. kNe as
// project_bf2's. The chunk walk (run_head) and the factored path
// (sig_factored.cuh::run_factored) share it; en stays a local of this
// function, as it was of run_head before the factored path: passed to a
// function after the walk, it cost the chunk walk about 1% of its time
// at 400/160/128.
template <int C, int kNe = 8, class Walk>
__device__ __forceinline__ void head_tile(const Head& h, unsigned char* work,
                                          int b, int k0, int n_frames,
                                          bool keep_vals, Walk&& walk) {
  using L = Lay<C>;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int wm = warp / L::kWN, wn = warp % L::kWN;
  Frag en;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) en[m][j][e] = 0.0f;
  walk(en);
  const int nmp = h.n_mels_pad;
  const int ne = nmp / (8 * L::kWN);
  const int ncol = nmp / L::kWN;
  if (h.out_mode != kWhisper) {
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int k = k0 + wm * 32 + m * 16 + g + 8 * hh;
        if (k >= n_frames) continue;
        float* o = h.out + (static_cast<long long>(b) * n_frames + k) *
                               h.n_mels;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (j >= ne || j >= kNe) break;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = wn * ncol + j * 8 + 2 * q + e;
            if (col >= h.n_mels) continue;
            const float v = en[m][j][2 * hh + e];
            o[col] = ln_accurate(h.out_mode == kLnGuard
                                     ? __fadd_rn(v, h.guard)
                                     : max_nan(v, h.guard));
          }
        }
      }
    return;
  }
  // logs wait in shared memory until the row max is known
  sync_tile<C>();  // every warp is done with the ring and power tile
  float* slg = reinterpret_cast<float*>(work);
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = wm * 32 + m * 16 + g + 8 * hh;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j >= ne || j >= kNe) break;
        const int col = wn * ncol + j * 8 + 2 * q;
        *reinterpret_cast<float2*>(slg + row * nmp + col) = make_float2(
            log10_accurate(max_nan(en[m][j][2 * hh], kLogFloor)),
            log10_accurate(max_nan(en[m][j][2 * hh + 1], kLogFloor)));
      }
    }
  sync_tile<C>();
  // row max, whisper norm, store (a null h.out stores nothing: the quant
  // route writes records, not the float mel); a warp per tile / 8 rows
  for (int f = 0; f < L::kTile / kWarps; ++f) {
    const int row = warp * (L::kTile / kWarps) + f;
    const int k = k0 + row;
    whisper_norm_row(slg + row * nmp, nmp, h.n_mels,
                     k < n_frames && h.out
                         ? h.out + (static_cast<long long>(b) * n_frames + k) *
                                       h.n_mels
                         : nullptr,
                     keep_vals);
  }
}

// One head over the block's frames: the synchronous chunk walk of the 64-
// and 32-frame blocks, then the output values of the head's mode
// (head_tile). tab is a shared copy of the head's block table. (The
// 128-frame blocks walk on sig_pipe.cuh's pipeline: pipe_head.)
template <int C>
__device__ __forceinline__ void run_head(const Head& h, int* tab,
                                         const __nv_bfloat16* sx,
                                         const Span& sp, unsigned char* work,
                                         int b, int k0, int n_frames,
                                         bool keep_vals) {
  static_assert(C == 1 || C == 2, "the synchronous walk's layouts");
  using L = Lay<C>;
  // the walk's setup inside the lambda, after head_tile's: this order
  // keeps the chunk walk's time as it was before head_tile
  head_tile<C>(h, work, b, k0, n_frames, keep_vals, [&](Frag& en) {
    const int cp = chunk_pow<C>(h.width, h.npow);
    unsigned char* pb = work + L::kRingBytes;
    // the first chunk's barrier orders this copy before every use, and
    // every use of an earlier head's table before it
    if (threadIdx.x < 2 * h.n_blocks) tab[threadIdx.x] = __ldg(h.blocks +
                                                              threadIdx.x);
    const bool fast = ((sp.hop | h.pack_off) & 1) == 0;
    const int n_ch = (h.live + cp - 1) / cp;
    for (int ch = 0; ch < n_ch; ++ch) {
      float d[64];
      if (fast)
        dft_chunk<C, true>(h, tab, ch, smem_addr(sx), sp, smem_addr(work),
                           d);
      else
        dft_chunk<C, false>(h, tab, ch, smem_addr(sx), sp, smem_addr(work),
                            d);
      store_power<C>(h, d, pb);
      __syncthreads();  // the chunk's power, from every warp
      if (h.bf2)
        project_bf2<C>(h, ch, pb, work, en);
      else
        project_f32<C>(h, ch, pb, en);
    }
  });
}

// Sobel VAD counts of one block's tile (ops/mel_kernel.py::_sig_vad_counts)
// from the normalized whisper values v[x][y] = vals[x * nmp + y], x the
// tile's frame, y the mel row: per frame x the count of rows y in
// [start_y, n_mels - 2) whose 3x3 patch (frames x .. x+2, rows y .. y+2)
// has a squared gradient >= thr, written to counts[b * n_frames + k0 + x].
// The expression order is ops/vad.py::sobel_gradient_sq's, each operation
// rounded. The last two frames of every Lay::kVadTile (64, or 32 in a
// 32-frame block) get 0, and the caller recomputes them from the mel
// output; the clip's last two frames have no patch and get 0. One warp per
// frame, the rows over its lanes.
template <int C>
__device__ __forceinline__ void vad_counts(const float* vals, int nmp,
                                           int n_mels, int start_y,
                                           float thr, int b, int k0,
                                           int n_frames, int* counts) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int x = warp; x < Lay<C>::kTile; x += kWarps) {
    int cnt = 0;
    // a patch must lie inside a VAD tile and inside the clip
    constexpr int kVt = Lay<C>::kVadTile;
    if (x % kVt < kVt - 2 && k0 + x + 2 < n_frames) {
      const float* r0 = vals + x * nmp;
      const float* r1 = r0 + nmp;
      const float* r2 = r1 + nmp;
      for (int y = start_y + lane; y < n_mels - 2; y += 32) {
        const float gx = __fsub_rn(
            __fadd_rn(__fadd_rn(r2[y], __fmul_rn(2.0f, r2[y + 1])),
                      r2[y + 2]),
            __fadd_rn(__fadd_rn(r0[y], __fmul_rn(2.0f, r0[y + 1])),
                      r0[y + 2]));
        const float gy = __fsub_rn(
            __fadd_rn(__fadd_rn(r0[y + 2], __fmul_rn(2.0f, r1[y + 2])),
                      r2[y + 2]),
            __fadd_rn(__fadd_rn(r0[y], __fmul_rn(2.0f, r1[y])), r2[y]));
        const float g2 = __fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy));
        cnt += g2 >= thr;
      }
    }
    cnt = __reduce_add_sync(0xffffffffu, cnt);
    const int k = k0 + x;
    if (lane == 0 && k < n_frames)
      counts[static_cast<long long>(b) * n_frames + k] = cnt;
  }
}

// min / max that keep a NaN, like torch.amin / torch.amax
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || a != a) ? a : b;
}

// The u8 wire record of each of the tile's frames
// (ops/mel_kernel.py::_sig_quant_vals, default expression tree) from the
// normalized whisper values vals[x * nmp + m], m < n_mels: lo = min, hi =
// max over the frame's n_mels values, scale = 255 / (hi - lo), scaled =
// (v - lo) * scale, y = clamp(trunc(2 * scaled), 0, 511), q = min((y + 1)
// >> 1, 255). For scaled = k + f >= 0, trunc(2 * scaled) = 2k + (f >=
// 0.5) (the doubling is exact), so q is round-half-up, bit-equal to
// ops/quant.py::quantize_frames' floor / frac >= 0.5 / isnan / clip chain.
// Each operation is rounded to nearest (the _rn intrinsics; the build has
// no --use_fast_math, so the division is IEEE). trunc is __float2int_rz,
// PTX cvt.rzi.s32.f32, which saturates: +inf (a denormal range whose scale
// overflows) becomes INT_MAX, clamped to 511, q = 255 as the float clip
// gives. NaN (hi == lo: 0 * inf) is tested explicitly and gives q = 0,
// as the host's isnan -> 0 does. Writes q[b, k, :n_mels], lo[b, k],
// hi[b, k] for the tile's frames k < n_frames; one warp per frame.
template <int C>
__device__ __forceinline__ void quant_records(const float* vals, int nmp,
                                              int n_mels, int b, int k0,
                                              int n_frames, unsigned char* q,
                                              float* lo_out, float* hi_out) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int x = warp; x < Lay<C>::kTile; x += kWarps) {
    const int k = k0 + x;
    if (k >= n_frames) break;
    const float* v = vals + x * nmp;
    float lo = v[lane < n_mels ? lane : 0];
    float hi = lo;
    for (int m = lane + 32; m < n_mels; m += 32) {
      lo = min_nan(lo, v[m]);
      hi = max_nan(hi, v[m]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      lo = min_nan(lo, __shfl_xor_sync(0xffffffffu, lo, off));
      hi = max_nan(hi, __shfl_xor_sync(0xffffffffu, hi, off));
    }
    const float scale = __fdiv_rn(255.0f, __fsub_rn(hi, lo));
    const long long row = static_cast<long long>(b) * n_frames + k;
    unsigned char* qr = q + row * n_mels;
    for (int m = lane; m < n_mels; m += 32) {
      const float t = __fmul_rn(__fmul_rn(__fsub_rn(v[m], lo), scale), 2.0f);
      int y = t != t ? 0 : __float2int_rz(t);
      y = y < 0 ? 0 : (y > 511 ? 511 : y);
      const int qv = (y + 1) >> 1;
      qr[m] = static_cast<unsigned char>(qv < 255 ? qv : 255);
    }
    if (lane == 0) {
      lo_out[row] = lo;
      hi_out[row] = hi;
    }
  }
}

// The layout of a launch: C = 0 (128-frame blocks, which K1 and K2 walk
// as layout 4) where every head has at most Lay<0>::kMaxMels padded mel
// columns and the block's shared memory fits, else C = 1 (64-frame blocks) where it fits or max_layout is
// 1, else C = 2 (32-frame blocks). `need(c)` is the block's dynamic shared
// memory in layout c. Returns c and writes the block's shared memory in
// that layout (dynamic + static); a caller refuses the launch where it
// exceeds kSmemLimit. A head that fits in layout 0 or 1 keeps it.
template <class Need>
__host__ inline int pick_layout(int max_nmp, Need need, int max_layout,
                                long long* bytes) {
  if (max_nmp <= Lay<0>::kMaxMels) {
    *bytes = need(0) + kStaticSmem;
    if (*bytes <= kSmemLimit) return 0;
  }
  *bytes = need(1) + kStaticSmem;
  if (*bytes <= kSmemLimit || max_layout < 2) return 1;
  *bytes = need(2) + kStaticSmem;
  return 2;
}

// Whether the kernels take a head's column layout and projection: 256,
// 512, 1024 or 2048 DFT columns (at most max_width), split (npow = width
// / 2) or N-packed, a live count in multiples of 8, up to kMaxNmp padded
// mel columns
__host__ inline bool head_ok(int width, int npow, int live, int n_mels,
                             int n_mels_pad, int max_width) {
  return (width == 256 || width == 512 || width == 1024 || width == 2048) &&
         width <= max_width && (npow == width || npow == width / 2) &&
         live >= 0 && live <= npow && live % 8 == 0 && n_mels > 0 &&
         n_mels_pad % 128 == 0 && n_mels_pad <= kMaxNmp &&
         n_mels <= n_mels_pad;
}

// frames per block of layout c (4: as 0)
__host__ __device__ inline int layout_frames(int c) {
  return c == 0 || c == 4 ? Lay<0>::kTile
         : c == 1 ? Lay<1>::kTile
         : c == 2 ? Lay<2>::kTile
                  : Lay<3>::kTile;
}

// DFT columns per chunk of layout c
__host__ __device__ inline int layout_cols(int c) {
  return c == 0 || c == 4 ? Lay<0>::kCols
         : c == 1 ? Lay<1>::kCols
         : c == 2 ? Lay<2>::kCols
                  : Lay<3>::kCols;
}

// the VAD counts' tile of layout c
__host__ __device__ inline int layout_vad_tile(int c) {
  return c == 0 || c == 4 ? Lay<0>::kVadTile
         : c == 1 ? Lay<1>::kVadTile
         : c == 2 ? Lay<2>::kVadTile
                  : Lay<3>::kVadTile;
}

// work_bytes of layout c (1, 2: the synchronous walk's layouts)
__host__ inline long long layout_work_bytes(int c, int width, int npow) {
  return c == 1 ? work_bytes<1>(width, npow) : work_bytes<2>(width, npow);
}

}  // namespace sigk
