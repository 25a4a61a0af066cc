// K1 for Hopper (sm_90a): one frontend's features straight from the raw
// [B, T] float32 signal, one launch for the whole batch.
//
// Replaces the TPU kernel melspec_tpu/ops/mel_kernel.py::_sig_mel_tile_kernel
// (launched by _pallas_sig_mel) in its three output modes and with its two
// epilogues. For clip b and frame k it computes (device code in
// sig_common.cuh):
//   1. the samples offset + k*hop + pack_off ... + pack, staged once per
//      tile of 64 frames as one overlapping span in shared memory;
//   2. the bf16 residual cascade x_0 .. x_{ks-1} of every staged sample;
//   3. y = sum_blk x_{pair_i[blk]} . m_big[blk*pack : (blk+1)*pack, :] with
//      float32 accumulation; a product of two bf16 values is exact in
//      float32, so any summation order gives the TPU kernel's numerics
//      class. The blocks run in the order the caller gives: smallest
//      slice pair (i + j) first, so the small terms accumulate while the
//      sum is still small and only the terms of block (0, 0) round at
//      full magnitude;
//   4. power: re^2 + im^2 with re in columns [0, 256), im in [256, 512)
//      (split layout), or y^2 per column (N-packed: the re/im add rides
//      the projection, whose rows hold each filter row twice);
//   5. energy = [p0 | p0 | p1] @ [F0; F1; F0] with p0 = bf16(power),
//      p1 = bf16(power - p0) (mel_precision "bf2"), or power @ mt in f32;
//   6. whisper: log10_accurate(max(energy, 1e-10)), the row max over the
//      padded mel columns, the norm (max(v, max - 8) + 4) / 4;
//      ln_guard (NeMo): ln_accurate(energy + guard);
//      ln_floor (Kaldi): ln_accurate(max(energy, guard));
//   7. out[b, k, :n_mels];
//   8. optional epilogues of the whisper mode, on the tile's normalized
//      rows while they are still in shared memory: the u8 wire record
//      (quant_records: q[b, k, :n_mels] u8 and lo, hi [b, k] f32, with no
//      float mel written, n_mels + 8 bytes a frame instead of 4 * n_mels)
//      and the Sobel VAD counts (vad_counts, the code K2 runs: counts[b, k]
//      int32, 0 on the last two frames of each 64-frame tile, which the
//      wrapper recomputes). Both read the log tile the whisper norm leaves
//      in place, so they add no shared memory.
//
// What bounds it: operations. At whisper 400/160/128 the function needs
// 2*2400*399 + 2*3*200*128 FLOPs a frame (6 blocks of 400 taps against
// 200 re and 199 nonzero im columns, then the bf2 projection) against
// 4*160 bytes of new signal and 4*128 bytes of output, thousands of FLOPs
// per byte; the kernel also multiplies the zero pad columns of the 512.
// This first version runs the products as float32 FMAs on the SIMT cores:
// each thread holds an 8-frame x 16-column register tile of the 64 x 512
// block tile; m_big goes through shared memory in 32-row chunks, the next
// chunk prefetched into registers while the current one is used; the
// whole row of DFT columns stays in the block, so power, projection, log
// and norm follow without a round trip through device memory, and so do
// the epilogues: the quant route writes 1 + 8 / n_mels bytes per mel
// value where the whisper route writes 4. The tensor-core (wgmma) version
// is later work.
//
// Plain C interface, built with nvcc and bound with ctypes
// (melspec_tpu_torch/kernels/sig_mel.py). Every launch is followed by
// cudaGetLastError, and its code is returned.

#include "sig_common.cuh"

namespace {

using namespace sigk;

struct Params {
  const float* x;  // [B, T]
  long long T;
  int n_frames, hop, offset, ks, span, tiles;
  Head head;
  unsigned char* q;  // quant epilogue: [B, n_frames, n_mels] u8, or null
  float* lo;         // [B, n_frames] with q
  float* hi;
  int* vad;          // VAD epilogue: [B, n_frames] int32, or null
  float vad_thr;
  int vad_start_y;
};

__global__ void __launch_bounds__(kThreads, 1) sig_mel_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x / p.tiles;
  const int k0 = (blockIdx.x - b * p.tiles) * kTileFrames;
  const int f0 = warp * kFramesPerWarp;  // this warp's frames in the tile

  // layout: the span's ks bf16 slices, then one f32 m_big chunk; the
  // epilogue reuses all of it
  __nv_bfloat16* sx = reinterpret_cast<__nv_bfloat16*>(smem);
  float* sb = reinterpret_cast<float*>(smem + align16(2LL * p.ks * p.span));
  stage_span(p.x + static_cast<long long>(b) * p.T, p.T,
             p.offset + static_cast<long long>(k0) * p.hop, p.span, p.ks,
             sx);
  Acc acc;
  dft_dot(p.head, sx, p.span, p.hop, f0, sb, acc);
  const bool keep = p.q != nullptr || p.vad != nullptr;
  head_epilogue(p.head, acc, smem, f0, b, k0, p.n_frames, keep);
  if (!keep) return;
  __syncthreads();  // the tile's normalized rows, from every warp
  const float* vals = log_tile(smem, p.head.npow);
  if (p.q)
    quant_records(vals, p.head.n_mels_pad, p.head.n_mels, b, k0, p.n_frames,
                  p.q, p.lo, p.hi);
  if (p.vad)
    vad_counts(vals, p.head.n_mels_pad, p.head.n_mels, p.vad_start_y,
               p.vad_thr, b, k0, p.n_frames, p.vad);
}

// The epilogues read the log tile of phase 2 and add nothing to it.
long long smem_bytes(int ks, int span, int npow, int n_mels_pad) {
  const long long phase1 = align16(2LL * ks * span) + 4LL * kChunk * kW;
  const long long phase2 = epilogue_bytes(npow, n_mels_pad);
  return phase1 > phase2 ? phase1 : phase2;
}

}  // namespace

extern "C" {

long long melspec_sig_mel_smem_bytes(int ks, int hop, int pack, int pack_off,
                                     int npow, int n_mels_pad) {
  return smem_bytes(ks, span_len(hop, pack, pack_off), npow, n_mels_pad);
}

// Returns 0 or the cudaError_t of the launch (cudaErrorInvalidValue for
// arguments the kernel does not take). tile_frames is the caller's tile
// size and must be the kernel's. out may be null when q is given (the
// quant route writes no float mel); q (with lo, hi) and vad select the
// epilogues, both of the whisper mode only.
int melspec_sig_mel(const float* x, long long batch, long long T,
                    int n_frames, int hop, int offset, int tile_frames,
                    const void* m_big, int W, int pack, int pack_off,
                    const int* blocks, int n_blocks, int ks, int npow,
                    const void* mt, int n_mels, int n_mels_pad, int bf2,
                    int out_mode, float guard, float* out, unsigned char* q,
                    float* lo, float* hi, int* vad, float vad_thr,
                    int vad_start_y, void* stream) {
  if (batch <= 0 || n_frames <= 0) return cudaSuccess;
  if (hop <= 0 || pack <= 0 || offset < 0 || pack_off < 0 || ks <= 0 ||
      ks > kMaxSlices || n_blocks <= 0 || n_blocks > kMaxBlocks ||
      n_mels <= 0 || n_mels_pad % 128 != 0 || n_mels > n_mels_pad ||
      W != kW || (npow != kW && npow != kW / 2) ||
      tile_frames != kTileFrames || out_mode < kWhisper ||
      out_mode > kLnFloor)
    return cudaErrorInvalidValue;
  if ((out == nullptr && q == nullptr) ||
      (q != nullptr && (lo == nullptr || hi == nullptr)) ||
      ((q != nullptr || vad != nullptr) && out_mode != kWhisper) ||
      (vad != nullptr && (vad_start_y < 0 || n_mels < 3)))
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
  p.ks = ks;
  p.span = span_len(hop, pack, pack_off);
  p.tiles = static_cast<int>(tiles);
  p.head.m_big = static_cast<const __nv_bfloat16*>(m_big);
  p.head.blocks = blocks;
  p.head.mt = mt;
  p.head.out = out;
  p.head.n_blocks = n_blocks;
  p.head.pack = pack;
  p.head.pack_off = pack_off;
  p.head.npow = npow;
  p.head.n_mels = n_mels;
  p.head.n_mels_pad = n_mels_pad;
  p.head.bf2 = bf2;
  p.head.out_mode = out_mode;
  p.head.guard = guard;
  p.q = q;
  p.lo = lo;
  p.hi = hi;
  p.vad = vad;
  p.vad_thr = vad_thr;
  p.vad_start_y = vad_start_y;
  const long long smem = smem_bytes(ks, p.span, npow, n_mels_pad);
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
