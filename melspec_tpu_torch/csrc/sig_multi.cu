// K2 for Hopper (sm_90a): several frontends' features from ONE staging of
// the raw [B, T] float32 signal, one launch for the whole batch.
//
// Replaces the TPU kernel melspec_tpu/ops/sig_multihead.py::
// _sig_multi_tile_kernel (launched by _pallas_sig_multi). A block owns 64
// frames of one clip. It stages the tile's signal span and its bf16
// residual cascade once, in shared memory, and keeps them there while it
// runs each head in turn (device code in sig_common.cuh, shared with K1):
// the head's slice-pair DFT dot over its own taps [pack_off, pack_off +
// pack) of each frame and its own K blocks, its split or N-packed power,
// its bf2 or f32 projection and its output mode (whisper, ln_guard,
// ln_floor), written as one [B, n_frames, n_mels_h] float32 output per
// head. A head with K1's matrices and block order gives K1's output bit
// for bit. Head 0 (whisper) can carry the Sobel VAD epilogue
// (sig_common.cuh::vad_counts, K1's VAD epilogue too): per frame the count
// of mel rows with a squared gradient >= thr, int32 [B, n_frames], 0 on
// the last two frames of each tile, which the caller recomputes.
//
// What bounds it: operations, as for K1: each head's DFT dot is thousands
// of FLOPs per byte of signal and output. The staged slices persist across
// heads, so shared memory holds them plus the largest head's epilogue
// tiles (power [64][npow] and logs [64][nmp]): 223 KB for whisper + an
// N-packed Kaldi head + a NeMo head at hop 160 in 227 KB. Products run as
// float32 FMAs on the SIMT cores, as in K1.
//
// Plain C interface, built with nvcc and bound with ctypes
// (melspec_tpu_torch/kernels/sig_multi.py). Every launch is followed by
// cudaGetLastError, and its code is returned.

#include "sig_common.cuh"

namespace {

using namespace sigk;

constexpr int kMaxHeads = 4;

struct Params {
  const float* x;  // [B, T]
  long long T;
  int n_frames, hop, offset, ks, span, tiles, n_heads;
  long long work;  // byte offset of the dot / epilogue region
  Head heads[kMaxHeads];
  int* vad;        // [B, n_frames] or null
  float vad_thr;
  int vad_start_y;
};

__global__ void __launch_bounds__(kThreads, 1)
    sig_multi_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x / p.tiles;
  const int k0 = (blockIdx.x - b * p.tiles) * kTileFrames;
  const int f0 = warp * kFramesPerWarp;

  // layout: the span's ks bf16 slices, kept for every head, then the
  // work region: one head's f32 m_big chunk during its dot, its power
  // and log tiles during its epilogue
  __nv_bfloat16* sx = reinterpret_cast<__nv_bfloat16*>(smem);
  unsigned char* work = smem + p.work;
  stage_span(p.x + static_cast<long long>(b) * p.T, p.T,
             p.offset + static_cast<long long>(k0) * p.hop, p.span, p.ks,
             sx);
  for (int h = 0; h < p.n_heads; ++h) {
    const Head& hd = p.heads[h];
    const bool vad = h == 0 && p.vad != nullptr;
    Acc acc;
    dft_dot(hd, sx, p.span, p.hop, f0, reinterpret_cast<float*>(work), acc);
    head_epilogue(hd, acc, work, f0, b, k0, p.n_frames, vad);
    if (vad) {
      __syncthreads();  // the tile's normalized rows, from every warp
      vad_counts(log_tile(work, hd.npow), hd.n_mels_pad, hd.n_mels,
                 p.vad_start_y, p.vad_thr, b, k0, p.n_frames, p.vad);
    }
    // the next head's dot opens with a barrier before it writes work
  }
}

// The staged samples per tile (the widest head's pack_off + pack, in whole
// chunks) and the block's dynamic shared memory: the span's bf16 slices,
// then a work region that holds one m_big chunk or any head's epilogue.
long long layout(int ks, int hop, int n_heads, const int* packs,
                 const int* pack_offs, const int* npows,
                 const int* n_mels_pad, int* span) {
  int s = 0;
  long long work = 4LL * kChunk * kW;
  for (int h = 0; h < n_heads; ++h) {
    const int sh = span_len(hop, packs[h], pack_offs[h]);
    const long long eh = epilogue_bytes(npows[h], n_mels_pad[h]);
    s = sh > s ? sh : s;
    work = eh > work ? eh : work;
  }
  *span = s;
  return align16(2LL * ks * s) + work;
}

}  // namespace

extern "C" {

// The layout above for the heads' integer fields: returns the dynamic
// shared memory of one block and writes the staged span to *span.
long long melspec_sig_multi_smem_bytes(int ks, int hop, int n_heads,
                                       const int* packs,
                                       const int* pack_offs,
                                       const int* npows,
                                       const int* n_mels_pad, int* span) {
  return layout(ks, hop, n_heads, packs, pack_offs, npows, n_mels_pad, span);
}

// One launch of K2. Per head h: m_bigs[h] bf16 [K_tot_h, 512], blocks[h]
// int32 [n_blocks[h]][2], mts[h], outs[h] f32 [B, n_frames, n_mels[h]]
// and the integer fields of sig_common.cuh's Head; tile_frames must be
// the kernel's. Returns 0 or the cudaError_t of the launch
// (cudaErrorInvalidValue for arguments the kernel does not take).
int melspec_sig_multi(const float* x, long long batch, long long T,
                      int n_frames, int hop, int offset, int tile_frames,
                      int ks, int n_heads,
                      const void* const* m_bigs, const int* const* blocks,
                      const void* const* mts, float* const* outs,
                      const int* n_blocks, const int* packs,
                      const int* pack_offs, const int* npows,
                      const int* n_mels, const int* n_mels_pad,
                      const int* bf2, const int* out_modes,
                      const float* guards, int* vad, float vad_thr,
                      int vad_start_y, void* stream) {
  if (batch <= 0 || n_frames <= 0) return cudaSuccess;
  if (hop <= 0 || offset < 0 || ks <= 0 || ks > kMaxSlices ||
      n_heads <= 0 || n_heads > kMaxHeads || tile_frames != kTileFrames)
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
  p.tiles = static_cast<int>(tiles);
  p.n_heads = n_heads;
  for (int h = 0; h < n_heads; ++h) {
    Head& hd = p.heads[h];
    hd.m_big = static_cast<const __nv_bfloat16*>(m_bigs[h]);
    hd.blocks = blocks[h];
    hd.mt = mts[h];
    hd.out = outs[h];
    hd.n_blocks = n_blocks[h];
    hd.pack = packs[h];
    hd.pack_off = pack_offs[h];
    hd.npow = npows[h];
    hd.n_mels = n_mels[h];
    hd.n_mels_pad = n_mels_pad[h];
    hd.bf2 = bf2[h];
    hd.out_mode = out_modes[h];
    hd.guard = guards[h];
    if (hd.pack <= 0 || hd.pack_off < 0 || hd.n_blocks <= 0 ||
        hd.n_blocks > kMaxBlocks || hd.n_mels <= 0 ||
        hd.n_mels_pad % 128 != 0 || hd.n_mels > hd.n_mels_pad ||
        (hd.npow != kW && hd.npow != kW / 2) || hd.out_mode < kWhisper ||
        hd.out_mode > kLnFloor)
      return cudaErrorInvalidValue;
  }
  const long long smem = layout(ks, hop, n_heads, packs, pack_offs, npows,
                                n_mels_pad, &p.span);
  p.work = align16(2LL * ks * p.span);
  p.vad = vad;
  p.vad_thr = vad_thr;
  p.vad_start_y = vad_start_y;
  if (vad != nullptr && (p.heads[0].out_mode != kWhisper || vad_start_y < 0))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      sig_multi_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  sig_multi_kernel<<<static_cast<unsigned>(grid), kThreads,
                     static_cast<size_t>(smem),
                     static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

const char* melspec_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
