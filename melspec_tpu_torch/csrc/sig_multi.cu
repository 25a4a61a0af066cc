// K2 for Hopper (sm_90a): several frontends' features from ONE staging of
// the raw [B, T] float32 signal, one launch for the whole batch.
//
// Replaces the TPU kernel melspec_tpu/ops/sig_multihead.py::
// _sig_multi_tile_kernel (launched by _pallas_sig_multi). A block owns 128
// frames of one clip (64 where the span and the ring do not fit). It
// stages the tile's signal span and its bf16 residual cascade once, in
// shared memory, and keeps them there while it runs each head in turn
// (K1's code): the head's slice-pair DFT over
// its own taps [pack_off, pack_off + pack) of each frame and its own K
// blocks on the tensor cores (bf16 wgmma, float32 accumulation, its DFT
// columns walked in chunks), its
// split or N-packed power, its bf2 projection on the tensor cores (or
// "highest" in float32 FMAs) and its output mode (whisper, ln_guard,
// ln_floor), written as one [B, n_frames, n_mels_h] float32 output per
// head. A head with K1's matrices and block order gives K1's output bit
// for bit. Head 0 (whisper) can carry the Sobel VAD epilogue
// (sig_common.cuh::vad_counts, K1's VAD epilogue too): per frame the count
// of mel rows with a squared gradient >= thr, int32 [B, n_frames], 0 on
// the last two frames of each 64-frame tile, which the caller recomputes.
//
// What bounds it: operations, as for K1 (each head's DFT is thousands of
// FLOPs per byte of signal and output), then each head's m_big reads from
// L2, one pass per block. The walks:
//   - Layout 4 (128-frame blocks): each head's chunks on the
//     warp-specialised ring of sig_pipe.cuh, as K1's 128-frame blocks. A
//     producer warp brings every head's stage stream (the host lays each
//     out once, kept with the head) in head order through one ring; the
//     two consumer warpgroups walk each head with no block barrier inside
//     the walk, then run its projection, output mode and (head 0) the VAD
//     epilogue. Shared memory: the span, the ring (as many 8,448-byte
//     slots as fit, 4 to 8), one region for any head's power tile or log
//     tile (pipe_tile_bytes: the log tile never overlaps the ring, so the
//     producer runs on into the next head during an epilogue) and the
//     barriers: 230,624 bytes for whisper + an N-packed Kaldi head at hop
//     160, 4 slots.
//   - Layout 1 (64-frame blocks) where that does not fit: sig_common.cuh's
//     synchronous walk (run_head<1>), its cp.async ring and the widest
//     head's power tile as the work region every head reuses.
// The outputs are equal bit for bit in either: the sums keep one order.
//
// Plain C interface, built with nvcc and bound with ctypes
// (melspec_tpu_torch/kernels/sig_multi.py). Every launch is followed by
// cudaGetLastError, and its code is returned.

// K2's heads are power heads (the host refuses a magnitude head): its
// power stages keep no magnitude code (sig_common.cuh::kMagnitudeHeads)
#define SIG_POWER_ONLY 1
#include "sig_common.cuh"
#include "sig_pipe.cuh"

namespace {

using namespace sigk;

constexpr int kMaxHeads = 4;

struct Params {
  const float* x;  // [B, T]
  long long T;
  int n_frames, offset, ks, tiles, n_heads;
  Span span;
  long long work;  // byte offset of the work region
  Head heads[kMaxHeads];
  int* vad;        // [B, n_frames] or null
  float vad_thr;
  int vad_start_y;
  // layout 4: each head's stage stream (pipe_stages), the ring's slots
  // and the bytes of the tile region past them
  const unsigned char* stages[kMaxHeads];
  int slots;
  int tile;
};

// Layout 4 (sig_pipe.cuh): warps 0-7 stage the span once and walk each
// head, warp 8 brings every head's stages in, head after head, through
// one ring (warps 9-11 only hand their registers over). Shared memory
// past the span: the ring, the tile region (a head's power tile, then its
// log tile), the barriers.
__device__ __forceinline__ void pipe_block(const Params& p,
                                           unsigned char* smem, int* tab) {
  unsigned char* work = smem + p.work;
  unsigned char* vals = work + p.slots * kPipeSlot;
  Ring rg = pipe_ring(work, vals + p.tile, p.slots);
  if (pipe_producer()) {
    if (threadIdx.x == kThreads)
      for (int h = 0; h < p.n_heads; ++h)
        pipe_produce(p.heads[h], p.stages[h], rg);
    __syncwarp();
    return;
  }
  const int b = blockIdx.x / p.tiles;
  const int k0 = (blockIdx.x - b * p.tiles) * Lay<4>::kTile;
  __nv_bfloat16* sx = reinterpret_cast<__nv_bfloat16*>(smem);
  stage_span(p.x + static_cast<long long>(b) * p.T, p.T,
             p.offset + static_cast<long long>(k0) * p.span.hop, p.span,
             p.ks, sx);
  for (int h = 0; h < p.n_heads; ++h) {
    const Head& hd = p.heads[h];
    const bool vad = h == 0 && p.vad != nullptr;
    // the next head's walk opens with a barrier before it writes the tile
    // region, which this head's epilogue reads
    pipe_head(hd, tab, sx, p.span, work, vals, rg, b, k0, p.n_frames, vad);
    if (vad) {
      sync_tile<4>();  // the tile's normalized rows, from every warp
      vad_counts<4>(reinterpret_cast<const float*>(vals), hd.n_mels_pad,
                    hd.n_mels, p.vad_start_y, p.vad_thr, b, k0, p.n_frames,
                    p.vad);
    }
  }
}

// Layout 1: 64-frame blocks on sig_common.cuh's synchronous walk, the
// span's slices kept for every head, then the work region: one head's ring
// and power tile during its chunk walk, its log tile during its epilogue
__device__ __forceinline__ void sync_block(const Params& p,
                                           unsigned char* smem, int* tab) {
  const int b = blockIdx.x / p.tiles;
  const int k0 = (blockIdx.x - b * p.tiles) * Lay<1>::kTile;
  __nv_bfloat16* sx = reinterpret_cast<__nv_bfloat16*>(smem);
  unsigned char* work = smem + p.work;
  stage_span(p.x + static_cast<long long>(b) * p.T, p.T,
             p.offset + static_cast<long long>(k0) * p.span.hop, p.span,
             p.ks, sx);
  for (int h = 0; h < p.n_heads; ++h) {
    const Head& hd = p.heads[h];
    const bool vad = h == 0 && p.vad != nullptr;
    run_head<1>(hd, tab, sx, p.span, work, b, k0, p.n_frames, vad);
    if (vad) {
      __syncthreads();  // the tile's normalized rows, from every warp
      vad_counts<1>(reinterpret_cast<const float*>(work), hd.n_mels_pad,
                    hd.n_mels, p.vad_start_y, p.vad_thr, b, k0, p.n_frames,
                    p.vad);
    }
    // the next head's chunk walk opens with a barrier before it writes
    // the work region
  }
}

template <int C>
__global__ void __launch_bounds__(C == 4 ? kPipeThreads : kThreads, 1)
    sig_multi_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int tab[2 * kMaxBlocks];
  if constexpr (C == 4)
    pipe_block(p, smem, tab);
  else
    sync_block(p, smem, tab);
}

// The block layout (sig_common.cuh::pick_layout) for the heads' integer
// fields: the staged samples per tile (the widest head's pack_off + pack,
// in whole ring stages), then the work region. 128-frame blocks take
// layout 4 where the span, a ring of kPipeMinSlots slots, the tile region
// that holds any head's power or log tile, and the barriers fit, with as
// many slots as fit (up to kPipeMaxSlots); else 64-frame blocks (layout
// 1), whose work region holds the cp.async ring and any head's power tile
// (and so any head's log tile). Returns the layout's code, writes the
// span, the block's shared memory, the slots (0 in layout 1) and the tile
// region's bytes.
int layout(int ks, int hop, int n_heads, const int* packs,
           const int* pack_offs, const int* widths, const int* npows,
           const int* nmps, Span* span, long long* bytes, int* slots,
           long long* tile) {
  auto span_of = [&](int c) {
    int s = 0;
    for (int h = 0; h < n_heads; ++h) {
      const int sh = span_len(layout_frames(c), hop, packs[h], pack_offs[h]);
      s = sh > s ? sh : s;
    }
    return make_span(hop, s);
  };
  long long pipe_tile = 0;
  for (int h = 0; h < n_heads; ++h) {
    const long long th = pipe_tile_bytes(widths[h], npows[h], nmps[h]);
    pipe_tile = th > pipe_tile ? th : pipe_tile;
  }
  auto need = [&](int c) {
    if (c == 0)
      return span_bytes(ks, span_of(c)) +
             static_cast<long long>(kPipeMinSlots) * kPipeSlot + pipe_tile +
             kPipeBarBytes;
    long long work = 0;
    for (int h = 0; h < n_heads; ++h) {
      const long long wh = layout_work_bytes(c, widths[h], npows[h]);
      work = wh > work ? wh : work;
    }
    return span_bytes(ks, span_of(c)) + work;
  };
  int max_nmp = 0;
  for (int h = 0; h < n_heads; ++h)
    max_nmp = nmps[h] > max_nmp ? nmps[h] : max_nmp;
  // K2 keeps to the 128- and 64-frame layouts
  int c = pick_layout(max_nmp, need, 1, bytes);
  *span = span_of(c);
  *slots = 0;
  *tile = 0;
  if (c == 0) {
    const long long fixed =
        span_bytes(ks, *span) + pipe_tile + kPipeBarBytes + kStaticSmem;
    *slots = pipe_slots(fixed);
    *tile = pipe_tile;
    *bytes = fixed + static_cast<long long>(*slots) * kPipeSlot;
    c = 4;
  }
  return c;
}

}  // namespace

extern "C" {

// The layout above for the heads' integer fields: returns the shared
// memory of one block and writes its code (4: 128-frame blocks on the
// pipelined walk; 1: 64-frame blocks on the synchronous walk), its frames
// (128 or 64), the staged span's samples, the DFT columns of its chunks
// (128 or 256) and the pipelined walk's ring slots (0 in layout 1).
long long melspec_sig_multi_layout(int ks, int hop, int n_heads,
                                   const int* packs, const int* pack_offs,
                                   const int* widths, const int* npows,
                                   const int* nmps, int* code,
                                   int* block_frames, int* span_samples,
                                   int* chunk_cols, int* slots) {
  if (hop <= 0 || n_heads <= 0 || n_heads > kMaxHeads) return -1;
  Span s;
  long long bytes, tile;
  const int c = layout(ks, hop, n_heads, packs, pack_offs, widths, npows,
                       nmps, &s, &bytes, slots, &tile);
  *code = c;
  *block_frames = layout_frames(c);
  *span_samples = s.len;
  *chunk_cols = layout_cols(c);
  return bytes;
}

// One launch of K2. Per head h: m_bigs[h] bf16 [K_tot_h, widths[h]],
// blocks[h] int32 [n_blocks[h]][2], mts[h], outs[h] f32 [B, n_frames,
// n_mels[h]] and the integer fields of sig_common.cuh's Head (lives[h]:
// the power columns that may be nonzero); stages[h] the head's stage
// stream (melspec_sig_mel_pipe_bytes bytes, 16-byte aligned) where the
// layout is 4, else ignored (stages may be null); tile_frames is the tile
// of the VAD counts' zeros and must be the kernel's (64). Returns 0 or the
// cudaError_t of the launch (cudaErrorInvalidValue for arguments the
// kernel does not take).
int melspec_sig_multi(const float* x, long long batch, long long T,
                      int n_frames, int hop, int offset, int tile_frames,
                      int ks, int n_heads,
                      const void* const* m_bigs, const int* const* blocks,
                      const void* const* mts, float* const* outs,
                      const int* n_blocks, const int* packs,
                      const int* pack_offs, const int* widths,
                      const int* npows, const int* lives,
                      const int* n_mels, const int* n_mels_pad,
                      const int* bf2, const int* out_modes,
                      const float* guards, int* vad, float vad_thr,
                      int vad_start_y, const void* const* stages,
                      void* stream) {
  if (batch <= 0 || n_frames <= 0) return cudaSuccess;
  if (hop <= 0 || offset < 0 || ks <= 0 || ks > kMaxSlices ||
      n_heads <= 0 || n_heads > kMaxHeads || tile_frames != kTileFrames)
    return cudaErrorInvalidValue;
  Params p;
  for (int h = 0; h < n_heads; ++h) {
    Head& hd = p.heads[h];
    hd.m_big = static_cast<const __nv_bfloat16*>(m_bigs[h]);
    hd.blocks = blocks[h];
    hd.mt = mts[h];
    hd.out = outs[h];
    hd.n_blocks = n_blocks[h];
    hd.pack = packs[h];
    hd.pack_off = pack_offs[h];
    hd.width = widths[h];
    hd.npow = npows[h];
    hd.live = lives[h];
    hd.n_mels = n_mels[h];
    hd.n_mels_pad = n_mels_pad[h];
    hd.bf2 = bf2[h];
    hd.out_mode = out_modes[h];
    hd.guard = guards[h];
    hd.magnitude = 0;
    if (hd.pack <= 0 || hd.pack_off < 0 || hd.n_blocks <= 0 ||
        hd.n_blocks > kMaxBlocks ||
        !head_ok(hd.width, hd.npow, hd.live, hd.n_mels, hd.n_mels_pad,
                 1024) ||
        hd.out_mode < kWhisper || hd.out_mode > kLnFloor ||
        hd.out == nullptr ||
        (reinterpret_cast<uintptr_t>(hd.m_big) |
         reinterpret_cast<uintptr_t>(hd.mt)) % 16)
      return cudaErrorInvalidValue;
  }
  long long smem, tile;
  const int lay = layout(ks, hop, n_heads, packs, pack_offs, widths, npows,
                         n_mels_pad, &p.span, &smem, &p.slots, &tile);
  const int frames = layout_frames(lay);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  p.tile = static_cast<int>(tile);
  for (int h = 0; h < n_heads; ++h) {
    p.stages[h] = lay == 4 && stages != nullptr
                      ? static_cast<const unsigned char*>(stages[h])
                      : nullptr;
    if (lay == 4 && (p.stages[h] == nullptr ||
                     reinterpret_cast<uintptr_t>(p.stages[h]) % 16 != 0))
      return cudaErrorInvalidValue;
  }
  const long long tiles = (n_frames + frames - 1) / frames;
  const long long grid = batch * tiles;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  p.x = x;
  p.T = T;
  p.n_frames = n_frames;
  p.offset = offset;
  p.ks = ks;
  p.tiles = static_cast<int>(tiles);
  p.n_heads = n_heads;
  p.work = span_bytes(ks, p.span);
  p.vad = vad;
  p.vad_thr = vad_thr;
  p.vad_start_y = vad_start_y;
  if (vad != nullptr && (p.heads[0].out_mode != kWhisper || vad_start_y < 0))
    return cudaErrorInvalidValue;
  auto kernel = lay == 4 ? sig_multi_kernel<4> : sig_multi_kernel<1>;
  const long long dyn = smem - kStaticSmem;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(dyn));
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(grid), lay == 4 ? kPipeThreads : kThreads,
           static_cast<size_t>(dyn), static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

const char* melspec_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
