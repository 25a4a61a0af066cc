// K1 for Hopper (sm_90a): whisper log-mel straight from the raw [B, T]
// float32 signal, one launch for the whole batch.
//
// Replaces the TPU kernel melspec_tpu/ops/mel_kernel.py::_sig_mel_tile_kernel
// (launched by _pallas_sig_mel) in its whisper output mode. For clip b and
// frame k it computes:
//   1. the samples offset + k*hop ... + pack, staged once per tile of 64
//      frames as one overlapping span in shared memory;
//   2. the bf16 residual cascade x_0 .. x_{ks-1} of every staged sample
//      (round to nearest even, as astype does); it is elementwise, so
//      cascading the span equals cascading each frame;
//   3. y = sum_blk x_{pair_i[blk]} . m_big[blk*pack : (blk+1)*pack, :] with
//      float32 accumulation; a product of two bf16 values is exact in
//      float32, so any summation order gives the TPU kernel's numerics
//      class. The blocks run in the order the caller gives: smallest
//      slice pair (i + j) first, so the small terms accumulate while the
//      sum is still small and only the terms of block (0, 0) round at
//      full magnitude;
//   4. power = re^2 + im^2, re in columns [0, 256), im in [256, 512);
//   5. energy = [p0 | p0 | p1] @ [F0; F1; F0] with p0 = bf16(power),
//      p1 = bf16(power - p0) (mel_precision "bf2"), or power @ mt in f32;
//   6. log10_accurate(max(energy, 1e-10)), the row max over the padded mel
//      columns, and the whisper norm (max(v, max - 8) + 4) / 4;
//   7. out[b, k, :n_mels].
//
// What bounds it: operations. At whisper 400/160/128 the function needs
// 2*2400*399 + 2*3*200*128 FLOPs a frame (6 blocks of 400 taps against
// 200 re and 199 nonzero im columns, then the bf2 projection) against
// 4*160 bytes of new signal and 4*128 bytes of output, thousands of FLOPs
// per byte; the kernel also multiplies the zero pad columns of the 512.
// This first version runs the products as float32 FMAs on the SIMT cores:
// each thread holds an 8-frame x 16-column register tile of the 64 x 512
// block tile; m_big goes
// through shared memory in 32-row chunks, the next chunk prefetched into
// registers while the current one is used; the whole row of DFT columns
// stays in the block, so power, projection, row max and norm follow
// without a round trip through device memory. The tensor-core (wgmma)
// version is later work.
//
// Plain C interface, built with nvcc and bound with ctypes
// (melspec_tpu_torch/kernels/sig_mel.py). Every launch is followed by
// cudaGetLastError, and its code is returned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFramesPerWarp = 8;
constexpr int kTileFrames = kWarps * kFramesPerWarp;  // 64 frames per block
constexpr int kChunk = 32;      // rows of m_big staged per step
constexpr int kMaxBlocks = 16;  // K blocks (slice pairs)
constexpr int kMaxSlices = 4;
constexpr int kW = 512;        // DFT columns: re | im halves
constexpr int kNP = kW / 2;    // power columns
constexpr int kNG = kW / 128;  // groups of 128 columns

// ops/fastmath.py: _E_ROUND, float32(log10(2)) and the Horner
// coefficients float32(float32(1/ln 10) * (2/7, 2/5, 2/3, 2)); a CPU test
// holds these literals to the Python constants.
constexpr int kERound = 0x4AFB0D;
constexpr float kLog10Of2 = 0x1.344136p-2f;
constexpr float kC7 = 0x1.fc3fa6p-4f;
constexpr float kC5 = 0x1.63c628p-3f;
constexpr float kC3 = 0x1.287a76p-2f;
constexpr float kC1 = 0x1.bcb7b2p-1f;
constexpr float kLogFloor = 1e-10f;

struct Params {
  const float* x;             // [B, T]
  long long T;
  int n_frames, hop, offset, pack, ks, n_blocks, span, tiles;
  const __nv_bfloat16* m_big;  // [K_tot, 512]
  const int* blocks;          // [n_blocks][2]: K block, its signal slice,
                              // in the order they are summed
  const void* mt;             // bf16 [3*256, nmp] (bf2) or f32 [256, nmp]
  int n_mels, n_mels_pad, bf2;
  float* out;                 // [B, n_frames, n_mels]
};

__host__ __device__ inline long long align16(long long n) {
  return (n + 15) / 16 * 16;
}

__host__ __device__ inline int span_len(int hop, int pack) {
  return (kTileFrames - 1) * hop + (pack + kChunk - 1) / kChunk * kChunk;
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

// ops/fastmath.py::log10_accurate, operation for operation (the _rn
// intrinsics keep nvcc from contracting into FMAs)
__device__ __forceinline__ float log10_accurate(float x) {
  const int bits = __float_as_int(x);
  const int e = ((bits + kERound) >> 23) - 127;
  const float m = __int_as_float(bits - e * (1 << 23));
  const float t = __fdiv_rn(__fsub_rn(m, 1.0f), __fadd_rn(m, 1.0f));
  const float t2 = __fmul_rn(t, t);
  float p = __fadd_rn(__fmul_rn(t2, kC7), kC5);
  p = __fadd_rn(__fmul_rn(p, t2), kC3);
  p = __fadd_rn(__fmul_rn(p, t2), kC1);
  return __fadd_rn(__fmul_rn(static_cast<float>(e), kLog10Of2),
                   __fmul_rn(p, t));
}

__global__ void __launch_bounds__(kThreads, 1) sig_mel_kernel(const Params p) {
  constexpr int W = kW;
  constexpr int NP = kNP;
  constexpr int NG = kNG;
  constexpr int kVecPerRow = W / 8;          // 16-byte vectors per m_big row
  constexpr int kVecPerThread = kChunk * kVecPerRow / kThreads;
  static_assert(kChunk * kVecPerRow % kThreads == 0, "chunk split");

  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int b = blockIdx.x / p.tiles;
  const int k0 = (blockIdx.x - b * p.tiles) * kTileFrames;
  const int f0 = warp * kFramesPerWarp;  // this warp's frames in the tile

  // phase 1 layout: the span's ks bf16 slices, then one f32 m_big chunk
  __nv_bfloat16* sx = reinterpret_cast<__nv_bfloat16*>(smem);
  float* sb = reinterpret_cast<float*>(
      smem + align16(2LL * p.ks * p.span));

  // 1 + 2: stage the tile's span and cascade it into bf16 slices; samples
  // past the clip read as zero (they only reach frames that are not
  // written, or taps whose m_big rows are zero)
  const float* xb = p.x + static_cast<long long>(b) * p.T;
  const long long s0 = p.offset + static_cast<long long>(k0) * p.hop;
  for (int u = tid; u < p.span; u += kThreads) {
    const long long s = s0 + u;
    float r = s < p.T ? __ldg(xb + s) : 0.0f;
    for (int i = 0; i < p.ks; ++i) {
      const __nv_bfloat16 h = __float2bfloat16_rn(r);
      sx[i * p.span + u] = h;
      r = __fsub_rn(r, __bfloat162float(h));
    }
  }

  // 3: the slice-pair DFT dot
  const int cpb = (p.pack + kChunk - 1) / kChunk;  // chunks per K block
  const int n_chunks = p.n_blocks * cpb;
  uint4 pre[kVecPerThread];
  auto fetch = [&](int c) {
    const int nb = c / cpb;
    const int blk = __ldg(p.blocks + 2 * nb);
    const int t0 = (c - nb * cpb) * kChunk;
#pragma unroll
    for (int v = 0; v < kVecPerThread; ++v) {
      const int idx = tid + v * kThreads;
      const int r = idx / kVecPerRow;
      const int cv = idx - r * kVecPerRow;
      const int row = t0 + r;
      pre[v] = row < p.pack
                   ? __ldg(reinterpret_cast<const uint4*>(
                               p.m_big + static_cast<long long>(
                                             blk * p.pack + row) * W) + cv)
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
      float4* dst = reinterpret_cast<float4*>(sb + r * W + cv * 8);
      dst[0] = make_float4(bf16_lo(u.x), bf16_hi(u.x),
                           bf16_lo(u.y), bf16_hi(u.y));
      dst[1] = make_float4(bf16_lo(u.z), bf16_hi(u.z),
                           bf16_lo(u.w), bf16_hi(u.w));
    }
  };

  float acc[kFramesPerWarp][NG * 4];
#pragma unroll
  for (int f = 0; f < kFramesPerWarp; ++f)
#pragma unroll
    for (int j = 0; j < NG * 4; ++j) acc[f][j] = 0.0f;

  fetch(0);
  for (int c = 0; c < n_chunks; ++c) {
    __syncthreads();  // the span is staged; the last chunk is consumed
    stage();
    __syncthreads();
    if (c + 1 < n_chunks) fetch(c + 1);
    const int nb = c / cpb;
    const int t0 = (c - nb * cpb) * kChunk;
    const __nv_bfloat16* xs =
        sx + __ldg(p.blocks + 2 * nb + 1) * p.span + f0 * p.hop + t0;
#pragma unroll 2
    for (int kk = 0; kk < kChunk; ++kk) {
      float a[kFramesPerWarp];
#pragma unroll
      for (int f = 0; f < kFramesPerWarp; ++f)
        a[f] = __bfloat162float(xs[f * p.hop + kk]);
      const float4* brow = reinterpret_cast<const float4*>(sb + kk * W);
#pragma unroll
      for (int j = 0; j < NG; ++j) {
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
  __syncthreads();  // phase 2 reuses the shared memory of phase 1

  // 4: power from the register tile; thread column 4*lane + 128*j + e.
  // Each warp writes and later reads only its own 8 rows.
  float* spf = reinterpret_cast<float*>(smem);                 // [64][NP]
  __nv_bfloat16* sp0 = reinterpret_cast<__nv_bfloat16*>(smem);  // [64][NP]
  __nv_bfloat16* sp1 = sp0 + kTileFrames * NP;                  // [64][NP]
#pragma unroll
  for (int f = 0; f < kFramesPerWarp; ++f) {
    const int row = f0 + f;
#pragma unroll
    for (int j = 0; j < NG / 2; ++j) {
      float pw[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float re = acc[f][4 * j + e];
        const float im = acc[f][4 * (j + NG / 2) + e];
        pw[e] = __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
      }
      const int col = 4 * lane + 128 * j;
      if (p.bf2) {
        unsigned short h0[4], h1[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const __nv_bfloat16 q0 = __float2bfloat16_rn(pw[e]);
          const __nv_bfloat16 q1 =
              __float2bfloat16_rn(__fsub_rn(pw[e], __bfloat162float(q0)));
          h0[e] = __bfloat16_as_ushort(q0);
          h1[e] = __bfloat16_as_ushort(q1);
        }
        *reinterpret_cast<uint2*>(sp0 + row * NP + col) =
            make_uint2(h0[0] | (unsigned(h0[1]) << 16),
                       h0[2] | (unsigned(h0[3]) << 16));
        *reinterpret_cast<uint2*>(sp1 + row * NP + col) =
            make_uint2(h1[0] | (unsigned(h1[1]) << 16),
                       h1[2] | (unsigned(h1[3]) << 16));
      } else {
        *reinterpret_cast<float4*>(spf + row * NP + col) =
            make_float4(pw[0], pw[1], pw[2], pw[3]);
      }
    }
  }
  __syncwarp();

  // 5 + 6: projection and log, 128 mel columns per pass, logs kept in
  // shared memory until the row max is known
  const int nmp = p.n_mels_pad;
  float* slg = reinterpret_cast<float*>(smem + 4LL * kTileFrames * NP);
  for (int mb = 0; mb < nmp; mb += 128) {
    float en[kFramesPerWarp][4];
#pragma unroll
    for (int f = 0; f < kFramesPerWarp; ++f)
#pragma unroll
      for (int q = 0; q < 4; ++q) en[f][q] = 0.0f;
    if (p.bf2) {
      const __nv_bfloat16* F = static_cast<const __nv_bfloat16*>(p.mt);
      for (int c = 0; c < NP; ++c) {
        float a0[kFramesPerWarp], a1[kFramesPerWarp];
#pragma unroll
        for (int f = 0; f < kFramesPerWarp; ++f) {
          a0[f] = __bfloat162float(sp0[(f0 + f) * NP + c]);
          a1[f] = __bfloat162float(sp1[(f0 + f) * NP + c]);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int m = mb + lane + 32 * q;
          const float g0 = __bfloat162float(F[c * nmp + m]);
          const float g1 = __bfloat162float(F[(NP + c) * nmp + m]);
          const float g2 = __bfloat162float(F[(2 * NP + c) * nmp + m]);
#pragma unroll
          for (int f = 0; f < kFramesPerWarp; ++f) {
            en[f][q] = fmaf(a0[f], g0, en[f][q]);
            en[f][q] = fmaf(a0[f], g1, en[f][q]);
            en[f][q] = fmaf(a1[f], g2, en[f][q]);
          }
        }
      }
    } else {
      const float* F = static_cast<const float*>(p.mt);
      for (int c = 0; c < NP; ++c) {
        float a0[kFramesPerWarp];
#pragma unroll
        for (int f = 0; f < kFramesPerWarp; ++f)
          a0[f] = spf[(f0 + f) * NP + c];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float g = F[c * nmp + mb + lane + 32 * q];
#pragma unroll
          for (int f = 0; f < kFramesPerWarp; ++f)
            en[f][q] = fmaf(a0[f], g, en[f][q]);
        }
      }
    }
#pragma unroll
    for (int f = 0; f < kFramesPerWarp; ++f)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        slg[(f0 + f) * nmp + mb + lane + 32 * q] =
            log10_accurate(max_nan(en[f][q], kLogFloor));
  }
  __syncwarp();

  // 6 + 7: row max, whisper norm, store
  for (int f = 0; f < kFramesPerWarp; ++f) {
    const int row = f0 + f;
    const float* lg = slg + row * nmp;
    float mx = lg[lane];
    for (int m = lane + 32; m < nmp; m += 32) mx = max_nan(mx, lg[m]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = max_nan(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const int k = k0 + row;
    if (k < p.n_frames) {
      float* o = p.out + (static_cast<long long>(b) * p.n_frames + k) * p.n_mels;
      const float lo = __fsub_rn(mx, 8.0f);
      for (int m = lane; m < p.n_mels; m += 32)
        o[m] = __fmul_rn(__fadd_rn(max_nan(lg[m], lo), 4.0f), 0.25f);
    }
  }
}

long long smem_bytes(int ks, int hop, int pack, int n_mels_pad) {
  const long long phase1 =
      align16(2LL * ks * span_len(hop, pack)) + 4LL * kChunk * kW;
  const long long phase2 =
      4LL * kTileFrames * kNP + 4LL * kTileFrames * n_mels_pad;
  return phase1 > phase2 ? phase1 : phase2;
}

}  // namespace

extern "C" {

long long melspec_sig_mel_smem_bytes(int ks, int hop, int pack,
                                     int n_mels_pad) {
  return smem_bytes(ks, hop, pack, n_mels_pad);
}

// Returns 0 or the cudaError_t of the launch (cudaErrorInvalidValue for
// arguments the kernel does not take).
int melspec_sig_mel(const float* x, long long batch, long long T,
                    int n_frames, int hop, int offset, const void* m_big,
                    int W, int pack, const int* blocks, int n_blocks, int ks,
                    const void* mt, int n_mels, int n_mels_pad, int bf2,
                    float* out, void* stream) {
  if (batch <= 0 || n_frames <= 0) return cudaSuccess;
  if (hop <= 0 || pack <= 0 || offset < 0 || ks <= 0 || ks > kMaxSlices ||
      n_blocks <= 0 || n_blocks > kMaxBlocks || n_mels <= 0 ||
      n_mels_pad % 128 != 0 || n_mels > n_mels_pad || W != kW)
    return cudaErrorInvalidValue;
  const long long tiles = (n_frames + kTileFrames - 1) / kTileFrames;
  const long long grid = batch * tiles;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  Params p;
  p.x = x;
  p.T = T;
  p.n_frames = n_frames;
  p.hop = hop;
  p.offset = offset;
  p.pack = pack;
  p.ks = ks;
  p.n_blocks = n_blocks;
  p.span = span_len(hop, pack);
  p.tiles = static_cast<int>(tiles);
  p.m_big = static_cast<const __nv_bfloat16*>(m_big);
  p.blocks = blocks;
  p.mt = mt;
  p.n_mels = n_mels;
  p.n_mels_pad = n_mels_pad;
  p.bf2 = bf2;
  p.out = out;
  const long long smem = smem_bytes(ks, hop, pack, n_mels_pad);
  cudaError_t err = cudaFuncSetAttribute(
      sig_mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  sig_mel_kernel<<<static_cast<unsigned>(grid), kThreads,
                   static_cast<size_t>(smem),
                   static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

const char* melspec_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
