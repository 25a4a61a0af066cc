// Device code shared by K1 (sig_mel.cu) and K2 (sig_multi.cu): the tile
// geometry, the accurate logarithms, the staging of a tile's signal span
// into bf16 slices, the slice-pair DFT dot of one head, one head's
// epilogue (power, projection, output values) and the two epilogues that
// read a whisper head's normalized tile (Sobel VAD counts, u8 wire
// records). Both kernels call the same functions, so a head of K2 with
// K1's matrices and block order computes K1's output bit for bit, and the
// two count VAD edges with one piece of code. K5-K8 (framed_mel.cu) take
// the logarithms and the whisper norm of a log row from here too.
//
// One block owns 64 frames of one clip (8 warps x 8 frames). A head's DFT
// dot keeps a 64 x 512 tile of float32 accumulators in registers (each
// thread 8 frames x 16 columns: column 4*lane + 128*j + e), streaming its
// m_big rows through shared memory in chunks of 32 rows, the next chunk
// prefetched into registers while the current one is used.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sigk {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFramesPerWarp = 8;
constexpr int kTileFrames = kWarps * kFramesPerWarp;  // 64 frames per block
constexpr int kChunk = 32;      // rows of m_big staged per step
constexpr int kMaxBlocks = 16;  // K blocks (slice pairs)
constexpr int kMaxSlices = 4;
constexpr int kW = 512;         // DFT columns of a head
constexpr int kNG = kW / 128;   // groups of 128 columns

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

// output modes (ops/mel_kernel.py::_sig_out_vals): whisper log10 + norm,
// NeMo ln(e + guard), Kaldi ln(max(e, guard)); guard arrives clamped to
// the smallest normal float32
enum OutMode { kWhisper = 0, kLnGuard = 1, kLnFloor = 2 };

// One head: its K-stacked DFT matrix, the order its K blocks are summed
// in, the taps it contracts, its column layout, projection and output.
struct Head {
  const __nv_bfloat16* m_big;  // [K_tot, 512]
  const int* blocks;           // [n_blocks][2]: K block, its signal slice
  const void* mt;              // bf16 [3*npow, nmp] (bf2) or f32 [npow, nmp]
  float* out;                  // [B, n_frames, n_mels]
  int n_blocks, pack, pack_off;
  int npow;                    // 256: split re|im halves; 512: N-packed
  int n_mels, n_mels_pad, bf2, out_mode;
  float guard;
};

__host__ __device__ inline long long align16(long long n) {
  return (n + 15) / 16 * 16;
}

// staged samples of one tile: every head reads taps [pack_off, pack_off +
// pack) of each frame, rounded up to whole chunks
__host__ __device__ inline int span_len(int hop, int pack, int pack_off) {
  return (kTileFrames - 1) * hop + pack_off +
         (pack + kChunk - 1) / kChunk * kChunk;
}

// shared memory of one head's epilogue: its power tile, then its log tile
__host__ __device__ inline long long epilogue_bytes(int npow, int nmp) {
  return 4LL * kTileFrames * npow + 4LL * kTileFrames * nmp;
}

// the log tile [64][nmp] float32 of a head's epilogue
__device__ __forceinline__ float* log_tile(unsigned char* work, int npow) {
  return reinterpret_cast<float*>(work + 4LL * kTileFrames * npow);
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

// Stage samples s0 .. s0 + span - 1 of one clip and cascade them into ks
// bf16 slices sx[i * span + u] (round to nearest even, as astype does; the
// cascade is elementwise, so cascading the span equals cascading each
// frame). Samples past the clip read as zero.
__device__ __forceinline__ void stage_span(const float* xb, long long T,
                                           long long s0, int span, int ks,
                                           __nv_bfloat16* sx) {
  for (int u = threadIdx.x; u < span; u += kThreads) {
    const long long s = s0 + u;
    float r = s < T ? __ldg(xb + s) : 0.0f;
    for (int i = 0; i < ks; ++i) {
      const __nv_bfloat16 h = __float2bfloat16_rn(r);
      sx[i * span + u] = h;
      r = __fsub_rn(r, __bfloat162float(h));
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

using Acc = float[kFramesPerWarp][kNG * 4];

// y = sum_blk x_{slice(blk)} . m_big[blk*pack : (blk+1)*pack, :] over the
// head's blocks in the given order, float32 FMAs in a fixed order. Frame
// f0 + f of the tile reads slice taps at (f0 + f) * hop + pack_off. A
// product of two bf16 values is exact in float32. sb is the [32, 512]
// float32 chunk buffer; it is free again when this returns.
__device__ __forceinline__ void dft_dot(const Head& h,
                                        const __nv_bfloat16* sx, int span,
                                        int hop, int f0, float* sb,
                                        Acc& acc) {
  constexpr int kVecPerRow = kW / 8;  // 16-byte vectors per m_big row
  constexpr int kVecPerThread = kChunk * kVecPerRow / kThreads;
  static_assert(kChunk * kVecPerRow % kThreads == 0, "chunk split");
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int cpb = (h.pack + kChunk - 1) / kChunk;  // chunks per K block
  const int n_chunks = h.n_blocks * cpb;
  uint4 pre[kVecPerThread];
  auto fetch = [&](int c) {
    const int nb = c / cpb;
    const int blk = __ldg(h.blocks + 2 * nb);
    const int t0 = (c - nb * cpb) * kChunk;
#pragma unroll
    for (int v = 0; v < kVecPerThread; ++v) {
      const int idx = tid + v * kThreads;
      const int r = idx / kVecPerRow;
      const int cv = idx - r * kVecPerRow;
      const int row = t0 + r;
      pre[v] = row < h.pack
                   ? __ldg(reinterpret_cast<const uint4*>(
                               h.m_big + static_cast<long long>(
                                             blk * h.pack + row) * kW) + cv)
                   : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int v = 0; v < kVecPerThread; ++v) {
      const int idx = tid + v * kThreads;
      const int r = idx / kVecPerRow;
      const int cv = idx - r * kVecPerRow;
      // a bf16 is the high half of its float32: widening is exact
      const uint4 u = pre[v];
      float4* dst = reinterpret_cast<float4*>(sb + r * kW + cv * 8);
      dst[0] = make_float4(bf16_lo(u.x), bf16_hi(u.x),
                           bf16_lo(u.y), bf16_hi(u.y));
      dst[1] = make_float4(bf16_lo(u.z), bf16_hi(u.z),
                           bf16_lo(u.w), bf16_hi(u.w));
    }
  };

#pragma unroll
  for (int f = 0; f < kFramesPerWarp; ++f)
#pragma unroll
    for (int j = 0; j < kNG * 4; ++j) acc[f][j] = 0.0f;

  fetch(0);
  for (int c = 0; c < n_chunks; ++c) {
    __syncthreads();  // the span is staged; the last chunk is consumed
    stage();
    __syncthreads();
    if (c + 1 < n_chunks) fetch(c + 1);
    const int nb = c / cpb;
    const int t0 = (c - nb * cpb) * kChunk;
    const __nv_bfloat16* xs = sx + __ldg(h.blocks + 2 * nb + 1) * span +
                              f0 * hop + h.pack_off + t0;
#pragma unroll 2
    for (int kk = 0; kk < kChunk; ++kk) {
      float a[kFramesPerWarp];
#pragma unroll
      for (int f = 0; f < kFramesPerWarp; ++f)
        a[f] = __bfloat162float(xs[f * hop + kk]);
      const float4* brow = reinterpret_cast<const float4*>(sb + kk * kW);
#pragma unroll
      for (int j = 0; j < kNG; ++j) {
        const float4 bv = brow[lane + 32 * j];
#pragma unroll
        for (int f = 0; f < kFramesPerWarp; ++f) {
          acc[f][4 * j + 0] = fmaf(a[f], bv.x, acc[f][4 * j + 0]);
          acc[f][4 * j + 1] = fmaf(a[f], bv.y, acc[f][4 * j + 1]);
          acc[f][4 * j + 2] = fmaf(a[f], bv.z, acc[f][4 * j + 2]);
          acc[f][4 * j + 3] = fmaf(a[f], bv.w, acc[f][4 * j + 3]);
        }
      }
    }
  }
  __syncthreads();  // every warp is done with sb
}

// One head's epilogue for the tile's 64 frames, from the register tile:
// power (split: re^2 + im^2, re in columns [0, 256), im in [256, 512);
// N-packed: y^2 per column) into shared memory, as bf16 slices p0 =
// bf16(power), p1 = bf16(power - p0) for the bf2 projection [p0 | p0 | p1]
// @ [F0; F1; F0] or as float32 for the f32 one; then the output values of
// the head's mode. Whisper: log10_accurate(max(e, 1e-10)), the row max
// over the padded mel columns, (max(v, max - 8) + 4) / 4; with keep_vals
// the normalized row also stays in slg [64][nmp] for an epilogue that
// follows. Each warp writes and reads only its own 8 rows.
__device__ __forceinline__ void head_epilogue(const Head& h, const Acc& acc,
                                              unsigned char* work, int f0,
                                              int b, int k0, int n_frames,
                                              bool keep_vals) {
  const int lane = threadIdx.x & 31;
  const int np = h.npow;
  float* spf = reinterpret_cast<float*>(work);                 // [64][np]
  __nv_bfloat16* sp0 = reinterpret_cast<__nv_bfloat16*>(work);  // [64][np]
  __nv_bfloat16* sp1 = sp0 + kTileFrames * np;                  // [64][np]
  auto store = [&](int row, int col, const float (&pw)[4]) {
    if (h.bf2) {
      unsigned short h0[4], h1[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const __nv_bfloat16 q0 = __float2bfloat16_rn(pw[e]);
        const __nv_bfloat16 q1 =
            __float2bfloat16_rn(__fsub_rn(pw[e], __bfloat162float(q0)));
        h0[e] = __bfloat16_as_ushort(q0);
        h1[e] = __bfloat16_as_ushort(q1);
      }
      *reinterpret_cast<uint2*>(sp0 + row * np + col) =
          make_uint2(h0[0] | (unsigned(h0[1]) << 16),
                     h0[2] | (unsigned(h0[3]) << 16));
      *reinterpret_cast<uint2*>(sp1 + row * np + col) =
          make_uint2(h1[0] | (unsigned(h1[1]) << 16),
                     h1[2] | (unsigned(h1[3]) << 16));
    } else {
      *reinterpret_cast<float4*>(spf + row * np + col) =
          make_float4(pw[0], pw[1], pw[2], pw[3]);
    }
  };
#pragma unroll
  for (int f = 0; f < kFramesPerWarp; ++f) {
    const int row = f0 + f;
    if (np == kW) {
#pragma unroll
      for (int j = 0; j < kNG; ++j) {
        float pw[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pw[e] = __fmul_rn(acc[f][4 * j + e], acc[f][4 * j + e]);
        store(row, 4 * lane + 128 * j, pw);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kNG / 2; ++j) {
        float pw[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float re = acc[f][4 * j + e];
          const float im = acc[f][4 * (j + kNG / 2) + e];
          pw[e] = __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
        }
        store(row, 4 * lane + 128 * j, pw);
      }
    }
  }
  __syncwarp();

  // projection, 128 mel columns per pass
  const int nmp = h.n_mels_pad;
  float* slg = log_tile(work, np);
  for (int mb = 0; mb < nmp; mb += 128) {
    float en[kFramesPerWarp][4];
#pragma unroll
    for (int f = 0; f < kFramesPerWarp; ++f)
#pragma unroll
      for (int q = 0; q < 4; ++q) en[f][q] = 0.0f;
    if (h.bf2) {
      const __nv_bfloat16* F = static_cast<const __nv_bfloat16*>(h.mt);
      for (int c = 0; c < np; ++c) {
        float a0[kFramesPerWarp], a1[kFramesPerWarp];
#pragma unroll
        for (int f = 0; f < kFramesPerWarp; ++f) {
          a0[f] = __bfloat162float(sp0[(f0 + f) * np + c]);
          a1[f] = __bfloat162float(sp1[(f0 + f) * np + c]);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int m = mb + lane + 32 * q;
          const float g0 = __bfloat162float(F[c * nmp + m]);
          const float g1 = __bfloat162float(F[(np + c) * nmp + m]);
          const float g2 = __bfloat162float(F[(2 * np + c) * nmp + m]);
#pragma unroll
          for (int f = 0; f < kFramesPerWarp; ++f) {
            en[f][q] = fmaf(a0[f], g0, en[f][q]);
            en[f][q] = fmaf(a0[f], g1, en[f][q]);
            en[f][q] = fmaf(a1[f], g2, en[f][q]);
          }
        }
      }
    } else {
      const float* F = static_cast<const float*>(h.mt);
      for (int c = 0; c < np; ++c) {
        float a0[kFramesPerWarp];
#pragma unroll
        for (int f = 0; f < kFramesPerWarp; ++f)
          a0[f] = spf[(f0 + f) * np + c];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float g = F[c * nmp + mb + lane + 32 * q];
#pragma unroll
          for (int f = 0; f < kFramesPerWarp; ++f)
            en[f][q] = fmaf(a0[f], g, en[f][q]);
        }
      }
    }
    if (h.out_mode == kWhisper) {
      // logs wait in shared memory until the row max is known
#pragma unroll
      for (int f = 0; f < kFramesPerWarp; ++f)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          slg[(f0 + f) * nmp + mb + lane + 32 * q] =
              log10_accurate(max_nan(en[f][q], kLogFloor));
    } else {
#pragma unroll
      for (int f = 0; f < kFramesPerWarp; ++f) {
        const int k = k0 + f0 + f;
        if (k >= n_frames) continue;
        float* o = h.out +
                   (static_cast<long long>(b) * n_frames + k) * h.n_mels;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int m = mb + lane + 32 * q;
          if (m >= h.n_mels) continue;
          const float e = en[f][q];
          o[m] = ln_accurate(h.out_mode == kLnGuard
                                 ? __fadd_rn(e, h.guard)
                                 : max_nan(e, h.guard));
        }
      }
    }
  }
  if (h.out_mode != kWhisper) return;
  __syncwarp();

  // row max, whisper norm, store (a null h.out stores nothing: the quant
  // route writes records, not the float mel)
  for (int f = 0; f < kFramesPerWarp; ++f) {
    const int row = f0 + f;
    const int k = k0 + row;
    whisper_norm_row(slg + row * nmp, nmp, h.n_mels,
                     k < n_frames && h.out
                         ? h.out + (static_cast<long long>(b) * n_frames + k) *
                                       h.n_mels
                         : nullptr,
                     keep_vals);
  }
}

// Sobel VAD counts of one tile (ops/mel_kernel.py::_sig_vad_counts) from
// the normalized whisper values v[x][y] = vals[x * nmp + y], x the tile's
// frame, y the mel row: per frame x the count of rows y in [start_y,
// n_mels - 2) whose 3x3 patch (frames x .. x+2, rows y .. y+2) has a
// squared gradient >= thr, written to counts[b * n_frames + k0 + x]. The
// expression order is ops/vad.py::sobel_gradient_sq's, each operation
// rounded. The last two frames of a tile need the next tile: they get 0
// here and the caller recomputes them from the mel output; the clip's last
// two frames have no patch and get 0. One warp per frame, the rows over
// its lanes.
__device__ __forceinline__ void vad_counts(const float* vals, int nmp,
                                           int n_mels, int start_y,
                                           float thr, int b, int k0,
                                           int n_frames, int* counts) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int x = warp; x < kTileFrames; x += kWarps) {
    int cnt = 0;
    // a patch must lie inside the tile and inside the clip's frames
    if (x < kTileFrames - 2 && k0 + x + 2 < n_frames) {
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
__device__ __forceinline__ void quant_records(const float* vals, int nmp,
                                              int n_mels, int b, int k0,
                                              int n_frames, unsigned char* q,
                                              float* lo_out, float* hi_out) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int x = warp; x < kTileFrames; x += kWarps) {
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

}  // namespace sigk
