// K1 for Hopper (sm_90a): one frontend's features straight from the raw
// [B, T] float32 signal, one launch for the whole batch.
//
// Replaces the TPU kernel melspec_tpu/ops/mel_kernel.py::_sig_mel_tile_kernel
// (launched by _pallas_sig_mel) in its three output modes and with its two
// epilogues. For clip b and frame k it computes (device code in
// sig_common.cuh):
//   1. the samples offset + k*hop + pack_off ... + pack, staged once per
//      block of 128 (or 64, or 32) frames as one overlapping span in
//      shared memory;
//   2. the bf16 residual cascade x_0 .. x_{ks-1} of every staged sample;
//   3. y = sum_blk x_{pair_i[blk]} . m_big[blk*pack : (blk+1)*pack, :] on
//      the tensor cores (bf16 wgmma, float32 accumulation); a
//      product of two bf16 values is exact, so the TPU kernel's numerics
//      class holds. The blocks run in the order the caller gives:
//      smallest slice pair (i + j) first, so the small terms accumulate
//      while the sum is still small and only the terms of block (0, 0)
//      round at full magnitude;
//   4. power: re^2 + im^2 with re in columns [0, width/2), im in [width/2,
//      width) (split layout), or y^2 per column (N-packed: the re/im add
//      rides the projection, whose rows hold each filter row twice); a
//      magnitude head (split only) takes sqrt(re^2 + im^2) instead;
//   5. energy = [p0 | p0 | p1] @ [F0; F1; F0] with p0 = bf16(power),
//      p1 = bf16(power - p0) (mel_precision "bf2") on the tensor cores, or
//      power @ mt in float32 FMAs ("highest");
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
//      int32, 0 on the last two frames of each 64-frame tile (32-frame in
//      32-frame blocks), which the wrapper recomputes).
//
// What bounds it: operations. At whisper 400/160/128 the function needs
// 2*2400*399 + 2*3*200*128 FLOPs a frame (6 blocks of 400 taps against
// 200 re and 199 nonzero im columns, then the bf2 projection) against
// 4*160 bytes of new signal and 4*128 bytes of output, thousands of FLOPs
// per byte, for the bf16 tensor cores. Behind them, m_big's L2 reads: each
// block reads every live column of every K block once (1.9 MB at
// 400/160), so a launch over 64 x 30 s requests 3.3 GB from L2 in
// 128-frame blocks. The block layout (128 frames where the span fits,
// else 64, else 32 for the wide hops, whose 64-frame span does not fit:
// 960/480, 1024/480, 2048/512; wgmma m64n128k16 in each, the 32-frame
// block with half of its m64 rows at zero), the column-chunk walk with its
// 4-stage cp.async ring, the live-column count and the segmented span
// (sig_common.cuh) are the design's answers; the whole row of DFT columns
// stays in the block, so power, projection, log and norm follow without
// a round trip through device memory, and so do the epilogues. Shared
// memory: the span's slices, the ring (33 KB in 128-frame blocks, 66 KB
// in 64- and 32-frame blocks, whose chunks are twice as wide) and a power
// tile (32 KB split, 64 KB N-packed; half that in 32-frame blocks); the log
// tile reuses the last two.
//
// K1 walks its 128-frame blocks as layout 4: the chunk walk as a
// warp-specialised pipeline (sig_pipe.cuh), m_big brought in stage by
// stage by a producer warp from a stream the host lays out once a head,
// the consumers on mbarriers with no block barrier in the walk; the
// outputs are those of the synchronous walk's sum order bit for bit. A
// block takes 128 frames where that pipeline's ring of at least four
// slots and its barriers fit beside its span, else 64. No kernel keeps a
// synchronous 128-frame walk: K2 (sig_multi.cu) takes layout 4 too.
//
// The wide whisper heads (960/480, 1024/480, 2048/512: whisper heads whose
// 128- and 64-frame spans do not fit, and where the host gives the
// factored split) take layout 3 instead: the two-stage DFT of
// sig_factored.cuh in persistent 64-frame blocks
// (melspec_sig_mel_factored). The ln heads of a 2048-point DFT (Kaldi
// fbank and NeMo log-mel at 44.1 / 48 kHz), where the host hands their
// window, preprocessing and bin-order filters, take the float64 FFT of
// sig_fft.cuh instead (melspec_sig_mel_fft), one frame a group of 64
// threads, four groups a block.
// The 32-frame dense layout stays for the other heads that fold
// preprocessing into their matrix and for other slice schedules.
//
// Plain C interface, built with nvcc and bound with ctypes
// (melspec_tpu_torch/kernels/sig_mel.py). Every launch is followed by
// cudaGetLastError, and its code is returned.

#include "sig_common.cuh"
#include "sig_factored.cuh"
#include "sig_fft.cuh"
#include "sig_pipe.cuh"

namespace {

using namespace sigk;

struct Params {
  const float* x;  // [B, T]
  long long T;
  int n_frames, offset, ks, tiles;
  Span span;
  Head head;
  unsigned char* q;  // quant epilogue: [B, n_frames, n_mels] u8, or null
  float* lo;         // [B, n_frames] with q
  float* hi;
  int* vad;          // VAD epilogue: [B, n_frames] int32, or null
  float vad_thr;
  int vad_start_y;
  // the factored layout's clip count (its blocks are persistent); last,
  // so that the chunk-walk kernels read every other field where they did
  // before it was added
  long long batch;
  Pipe pipe;  // layout 4 (sig_pipe.cuh)
};

// Layout 4: Lay<0>'s tile on the warp-specialised pipeline of
// sig_pipe.cuh. Warps 0-7 stage the span and compute, warp 8 brings the
// stages in (warps 9-11 only hand their registers over).
__device__ __forceinline__ void pipe_block(const Params& p,
                                           unsigned char* smem, int* tab) {
  const int cp = chunk_pow<0>(p.head.width, p.head.npow);
  unsigned char* work = smem + span_bytes(p.ks, p.span);
  unsigned char* bars = work + p.pipe.slots * kPipeSlot +
                        4LL * Lay<0>::kTile * cp;
  Ring rg = pipe_ring(work, bars, p.pipe.slots);
  if (pipe_producer()) {
    if (threadIdx.x == kThreads) pipe_produce(p.head, p.pipe.stages, rg);
    __syncwarp();
  } else {
    const int b = blockIdx.x / p.tiles;
    const int k0 = (blockIdx.x - b * p.tiles) * Lay<0>::kTile;
    __nv_bfloat16* sx = reinterpret_cast<__nv_bfloat16*>(smem);
    stage_span(p.x + static_cast<long long>(b) * p.T, p.T,
               p.offset + static_cast<long long>(k0) * p.span.hop, p.span,
               p.ks, sx);
    const bool keep = p.q != nullptr || p.vad != nullptr;
    pipe_head(p.head, tab, sx, p.span, work, work, rg, b, k0, p.n_frames,
              keep);
    if (keep) {
      sync_tile<4>();  // the tile's normalized rows, from every warp
      const float* vals = reinterpret_cast<const float*>(work);
      if (p.q)
        quant_records<4>(vals, p.head.n_mels_pad, p.head.n_mels, b, k0,
                         p.n_frames, p.q, p.lo, p.hi);
      if (p.vad)
        vad_counts<4>(vals, p.head.n_mels_pad, p.head.n_mels,
                      p.vad_start_y, p.vad_thr, b, k0, p.n_frames, p.vad);
    }
  }
}

template <int C>
__global__ void __launch_bounds__(C == 4 ? kPipeThreads : kThreads, 1)
    sig_mel_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int tab[2 * kMaxBlocks];
  if constexpr (C == 4) {
    pipe_block(p, smem, tab);
  } else {
    const int b = blockIdx.x / p.tiles;
    const int k0 = (blockIdx.x - b * p.tiles) * Lay<C>::kTile;

    // layout: the span's ks bf16 slices, then the work region (ring and
    // power tile during the chunk walk, the log tile after it)
    __nv_bfloat16* sx = reinterpret_cast<__nv_bfloat16*>(smem);
    unsigned char* work = smem + span_bytes(p.ks, p.span);
    stage_span(p.x + static_cast<long long>(b) * p.T, p.T,
               p.offset + static_cast<long long>(k0) * p.span.hop, p.span,
               p.ks, sx);
    const bool keep = p.q != nullptr || p.vad != nullptr;
    run_head<C>(p.head, tab, sx, p.span, work, b, k0, p.n_frames, keep);
    if (!keep) return;
    __syncthreads();  // the tile's normalized rows, from every warp
    const float* vals = reinterpret_cast<const float*>(work);
    if (p.q)
      quant_records<C>(vals, p.head.n_mels_pad, p.head.n_mels, b, k0,
                        p.n_frames, p.q, p.lo, p.hi);
    if (p.vad)
      vad_counts<C>(vals, p.head.n_mels_pad, p.head.n_mels, p.vad_start_y,
                     p.vad_thr, b, k0, p.n_frames, p.vad);
  }
}

// The factored layout's kernel: persistent blocks over the tiles of 64
// frames (sig_factored.cuh), the stage-2 matrix and the window copied to
// shared memory once a block; kNe 4 for heads of 128 padded mel columns,
// 8 for 256
template <int N1, int kNe>
__global__ void __launch_bounds__(kThreads, 1)
    sig_mel_factored_kernel(const Params p, const Factored f) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* work = smem;
  unsigned char* b2 =
      work + Lay<3>::kRingBytes + 4 * Lay<3>::kTile * kFChunkPow;
  float* swin = reinterpret_cast<float*>(b2 + kFB2Bytes);
  unsigned char* b1 =
      reinterpret_cast<unsigned char*>(swin + kFWinRow * N1) +
      (threadIdx.x >> 7) * f_b1_bytes(N1);
  f_constants(f, b2, swin);
  const bool keep = p.q != nullptr || p.vad != nullptr;
  const long long total = p.batch * p.tiles;
  for (long long t = blockIdx.x; t < total; t += gridDim.x) {
    const int b = static_cast<int>(t / p.tiles);
    const int k0 = static_cast<int>(t - static_cast<long long>(b) * p.tiles) *
                   Lay<3>::kTile;
    __syncthreads();  // the previous tile's outputs are done with work
    run_factored<N1, kNe>(
        p.head, f, p.x + static_cast<long long>(b) * p.T, p.T,
        p.offset + static_cast<long long>(k0) * p.span.hop, p.span.hop, work,
        b2, swin, b1, b, k0, p.n_frames, keep);
    if (!keep) continue;
    __syncthreads();  // the tile's normalized rows, from every warp
    const float* vals = reinterpret_cast<const float*>(work);
    if (p.q)
      quant_records<3>(vals, p.head.n_mels_pad, p.head.n_mels, b, k0,
                       p.n_frames, p.q, p.lo, p.hi);
    if (p.vad)
      vad_counts<3>(vals, p.head.n_mels_pad, p.head.n_mels, p.vad_start_y,
                    p.vad_thr, b, k0, p.n_frames, p.vad);
  }
}

// The block layout of a launch (sig_common.cuh::pick_layout over the
// three chunk-walk layouts, 128-frame blocks needing the pipelined walk's
// ring of kPipeMinSlots slots), then layout 4 in place of 0 (as many
// slots as fit, up to kPipeMaxSlots: written to *slots), and layout 3 in
// place of 2 where the host gives the head's factored split n1 x n2 (n1 >
// 0): returns its code, writes its span (the chunk-walk layouts') and
// shared memory
int layout(int ks, int hop, int pack, int pack_off, int width, int npow,
           int n_mels_pad, int n1, int n2, Span* span, long long* bytes,
           int* slots = nullptr) {
  auto span_of = [&](int c) {
    return make_span(hop, span_len(layout_frames(c), hop, pack, pack_off));
  };
  auto need = [&](int c) {
    return span_bytes(ks, span_of(c)) +
           (c == 0 ? pipe_work_bytes(width, npow, kPipeMinSlots)
                   : layout_work_bytes(c, width, npow));
  };
  int c = pick_layout(n_mels_pad, need, 2, bytes);
  *span = span_of(c);
  if (c == 0) {
    const long long fixed =
        span_bytes(ks, *span) + pipe_work_bytes(width, npow, 0) + kStaticSmem;
    const int s = pipe_slots(fixed);
    c = 4;
    *bytes = fixed + static_cast<long long>(s) * kPipeSlot;
    if (slots) *slots = s;
  }
  if (c == 2 && n1 > 0) {
    c = 3;
    *bytes = factored_bytes(n1) + kStaticSmem;
    *span = make_span(hop, n1 * n2);
  }
  return c;
}

// the factored split K1 takes: n1 32 or 64, 25 <= n2 <= 32, the whisper
// head's split columns (npow = 16 n1: 32 k1 x 16 k2 a chunk)
bool factored_ok(int n1, int n2, int npow) {
  return (n1 == 32 || n1 == 64) && n2 > 24 && n2 <= kFN2 && npow == 16 * n1;
}

}  // namespace

extern "C" {

// The block layout K1 takes for a head: returns one block's shared memory
// and writes its code (1, 2: 64-, 32-frame chunk walk; 3: the factored
// DFT; 4: the 128-frame walk on the pipeline of sig_pipe.cuh) to *code,
// its frames (64, 32; 64; 128) to *block_frames
// and the DFT columns of its chunks (128 or 256; 1024) to *chunk_cols.
// n1 x n2 is the head's factored split, or n1 = 0 for a head the
// factored path does not take (the host decides which: whisper heads of
// the (3, 2) schedule). The launch applies the same function; the VAD
// epilogue's tile is min(64, block frames).
long long melspec_sig_mel_layout(int ks, int hop, int pack, int pack_off,
                                 int width, int npow, int n_mels_pad, int n1,
                                 int n2, int* code, int* block_frames,
                                 int* chunk_cols) {
  if (hop <= 0 || pack <= 0) return -1;
  if (n1 != 0 && (!factored_ok(n1, n2, npow) || pack != n1 * n2 ||
                  pack_off != 0 || width != 2 * npow))
    return -1;
  Span span;
  long long bytes;
  const int c = layout(ks, hop, pack, pack_off, width, npow, n_mels_pad, n1,
                       n2, &span, &bytes);
  *code = c;
  *block_frames = layout_frames(c);
  *chunk_cols = layout_cols(c);
  return bytes;
}

// The bytes of the head's stage stream that layout 4 reads in place of
// m_big (kernels/sig_mel.py::pipe_stages lays it out)
long long melspec_sig_mel_pipe_bytes(int width, int npow, int live,
                                     int n_blocks, int pack, int n_mels_pad,
                                     int bf2) {
  if (!head_ok(width, npow, live, 1, n_mels_pad, 2048) || n_blocks <= 0 ||
      pack <= 0)
    return -1;
  return pipe_bytes(width, npow, live, n_blocks, pack, n_mels_pad, bf2);
}

// Returns 0 or the cudaError_t of the launch (cudaErrorInvalidValue for
// arguments the kernel does not take). tile_frames is the caller's tile of
// the VAD counts' zeros and must be the launch layout's (64, or 32 in
// 32-frame blocks). stages is the head's stage stream where its layout is
// 4 (melspec_sig_mel_pipe_bytes bytes, 16-byte aligned), else ignored.
// live is
// the count of power columns that may be nonzero (a multiple of 8): the
// kernel skips the rest. out may be null when q is given (the quant route
// writes no float mel); q (with lo, hi) and vad select the epilogues, both
// of the whisper mode only. magnitude 1 takes each bin's sqrt(re^2 +
// im^2) in place of its power, for a split head (npow = width / 2) only.
int melspec_sig_mel(const float* x, long long batch, long long T,
                    int n_frames, int hop, int offset, int tile_frames,
                    const void* m_big, int width, int pack, int pack_off,
                    const int* blocks, int n_blocks, int ks, int npow,
                    int live, const void* mt, int n_mels, int n_mels_pad,
                    int bf2, int out_mode, float guard, int magnitude,
                    float* out,
                    unsigned char* q, float* lo, float* hi, int* vad,
                    float vad_thr, int vad_start_y, const void* stages,
                    void* stream) {
  if (batch <= 0 || n_frames <= 0) return cudaSuccess;
  if (hop <= 0 || pack <= 0 || offset < 0 || pack_off < 0 || ks <= 0 ||
      ks > kMaxSlices || n_blocks <= 0 || n_blocks > kMaxBlocks ||
      !head_ok(width, npow, live, n_mels, n_mels_pad, 2048) ||
      out_mode < kWhisper || out_mode > kLnFloor ||
      (magnitude != 0 && (magnitude != 1 || npow == width)))
    return cudaErrorInvalidValue;
  if ((out == nullptr && q == nullptr) ||
      (q != nullptr && (lo == nullptr || hi == nullptr)) ||
      ((q != nullptr || vad != nullptr) && out_mode != kWhisper) ||
      (vad != nullptr && (vad_start_y < 0 || n_mels < 3)))
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(m_big) | reinterpret_cast<uintptr_t>(mt)) %
      16)
    return cudaErrorInvalidValue;
  Params p;
  long long smem;
  int slots = 0;
  const int lay = layout(ks, hop, pack, pack_off, width, npow, n_mels_pad, 0,
                         0, &p.span, &smem, &slots);
  const int frames = layout_frames(lay);
  if (smem > kSmemLimit || tile_frames != layout_vad_tile(lay))
    return cudaErrorInvalidValue;
  if (lay == 4 && (stages == nullptr ||
                   reinterpret_cast<uintptr_t>(stages) % 16 != 0))
    return cudaErrorInvalidValue;
  const long long tiles = (n_frames + frames - 1) / frames;
  const long long grid = batch * tiles;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  p.x = x;
  p.batch = batch;
  p.T = T;
  p.n_frames = n_frames;
  p.offset = offset;
  p.ks = ks;
  p.tiles = static_cast<int>(tiles);
  p.head.m_big = static_cast<const __nv_bfloat16*>(m_big);
  p.head.blocks = blocks;
  p.head.mt = mt;
  p.head.out = out;
  p.head.n_blocks = n_blocks;
  p.head.pack = pack;
  p.head.pack_off = pack_off;
  p.head.width = width;
  p.head.npow = npow;
  p.head.live = live;
  p.head.n_mels = n_mels;
  p.head.n_mels_pad = n_mels_pad;
  p.head.bf2 = bf2;
  p.head.out_mode = out_mode;
  p.head.guard = guard;
  p.head.magnitude = magnitude;
  p.q = q;
  p.lo = lo;
  p.hi = hi;
  p.vad = vad;
  p.vad_thr = vad_thr;
  p.vad_start_y = vad_start_y;
  p.pipe.stages = static_cast<const unsigned char*>(stages);
  p.pipe.slots = slots;
  auto kernel = lay == 4   ? sig_mel_kernel<4>
                : lay == 1 ? sig_mel_kernel<1>
                           : sig_mel_kernel<2>;
  const long long dyn = smem - kStaticSmem;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(dyn));
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(grid), lay == 4 ? kPipeThreads : kThreads,
           static_cast<size_t>(dyn), static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

// K1's factored wide-hop path (layout 3) for a whisper head of N = n1 *
// n2 taps (periodic Hann window, split columns): the host-built tables of
// kernels/sig_mel.py::factored_dft (window float32 [n], f1, tw, f2,
// rowmap; see sig_factored.cuh::Factored), mt (bf2 stack [3 npow, nmp]
// or float32 [npow, nmp], npow = 16 n1, bins in order), and the outputs
// and epilogues of melspec_sig_mel (whisper mode). tile_frames must be
// 64. Returns 0 or the cudaError_t of the launch (cudaErrorInvalidValue
// for arguments the kernel does not take, or where the head's own layout
// would not be 32-frame blocks: every other head keeps its layout).
int melspec_sig_mel_factored(const float* x, long long batch, long long T,
                             int n_frames, int hop, int offset,
                             int tile_frames, int n1, int n2,
                             const float* window, const void* f1,
                             const void* tw, const void* f2,
                             const int* rowmap, const void* mt, int npow,
                             int n_mels, int n_mels_pad, int bf2, float* out,
                             unsigned char* q, float* lo, float* hi, int* vad,
                             float vad_thr, int vad_start_y, void* stream) {
  if (batch <= 0 || n_frames <= 0) return cudaSuccess;
  if (hop <= 0 || offset < 0 || !factored_ok(n1, n2, npow) ||
      !head_ok(2 * npow, npow, npow, n_mels, n_mels_pad, 2048))
    return cudaErrorInvalidValue;
  if ((out == nullptr && q == nullptr) ||
      (q != nullptr && (lo == nullptr || hi == nullptr)) ||
      (vad != nullptr && (vad_start_y < 0 || n_mels < 3)))
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(mt) | reinterpret_cast<uintptr_t>(f1) |
       reinterpret_cast<uintptr_t>(tw) | reinterpret_cast<uintptr_t>(f2)) %
      16)
    return cudaErrorInvalidValue;
  const int n = n1 * n2;
  Span span;
  long long smem;
  const int lay = layout(3, hop, n, 0, 2 * npow, npow, n_mels_pad, n1, n2,
                         &span, &smem);
  if (lay != 3 || smem > kSmemLimit || tile_frames != layout_vad_tile(lay))
    return cudaErrorInvalidValue;
  const long long tiles = (n_frames + Lay<3>::kTile - 1) / Lay<3>::kTile;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long total = batch * tiles;
  const long long grid = total < sms ? total : sms;
  Params p = {};
  p.x = x;
  p.batch = batch;
  p.T = T;
  p.n_frames = n_frames;
  p.offset = offset;
  p.ks = 3;
  p.tiles = static_cast<int>(tiles);
  p.span = span;
  p.head.mt = mt;
  p.head.out = out;
  p.head.n_blocks = kFPairs;
  p.head.pack = n;
  p.head.width = 2 * npow;
  p.head.npow = npow;
  p.head.live = npow;
  p.head.n_mels = n_mels;
  p.head.n_mels_pad = n_mels_pad;
  p.head.bf2 = bf2;
  p.head.out_mode = kWhisper;
  p.q = q;
  p.lo = lo;
  p.hi = hi;
  p.vad = vad;
  p.vad_thr = vad_thr;
  p.vad_start_y = vad_start_y;
  Factored f;
  f.window = window;
  f.f1 = static_cast<const unsigned*>(f1);
  f.tw = static_cast<const float4*>(tw);
  f.f2 = static_cast<const uint4*>(f2);
  f.rowmap = rowmap;
  f.n = n;
  f.n1 = n1;
  f.n2 = n2;
  const bool narrow = n_mels_pad <= 128;
  auto kernel = n1 == 32 ? (narrow ? sig_mel_factored_kernel<32, 4>
                                   : sig_mel_factored_kernel<32, 8>)
                         : (narrow ? sig_mel_factored_kernel<64, 4>
                                   : sig_mel_factored_kernel<64, 8>);
  const long long dyn = smem - kStaticSmem;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(dyn));
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(grid), kThreads, static_cast<size_t>(dyn),
           static_cast<cudaStream_t>(stream)>>>(p, f);
  return cudaGetLastError();
}

// K1's float64 FFT path (sig_fft.cuh) for an ln head whose frame is pack
// taps at pack_off inside a 2048-point DFT: window float64 [pack]; tw
// float64 pairs [kFftTw], (cos, -sin)(2 pi e / 2048) for e < kFftTw, the
// bases of the passes' and the split's twiddles
// (kernels/sig_mel.py::fft_twiddles); preemph Kaldi's
// coefficient (its DC removal and preemphasis before the window), or < 0
// for neither; each mel's run of bins (mel_off [n_mels + 1], mel_lo
// [n_mels]) and its bf2 filters f0, f1 (bf16, concatenated runs of nnz
// values in all, bins below 1024); out_mode 1 (ln(e + guard)) or 2
// (ln(max(e, guard))); magnitude 1 projects |X[k]| in place of |X[k]|^2
// (its own instance of the kernel); out [batch, n_frames, n_mels]. Returns
// 0 or the cudaError_t of the launch (cudaErrorInvalidValue for arguments
// the kernel does not take).
int melspec_sig_mel_fft(const float* x, long long batch, long long T,
                        int n_frames, int hop, int offset, int pack,
                        int pack_off, const double* window, const void* tw,
                        double preemph, const int* mel_off,
                        const int* mel_lo, const void* f0, const void* f1,
                        int nnz, int n_mels, int out_mode, float guard,
                        int magnitude, float* out, void* stream) {
  if (batch <= 0 || n_frames <= 0) return cudaSuccess;
  if (hop <= 0 || offset < 0 || pack <= 0 || pack_off < 0 ||
      pack + pack_off > kFftN || n_mels <= 0 || nnz < 0 || out == nullptr ||
      (out_mode != kLnGuard && out_mode != kLnFloor) || !(guard > 0.0f) ||
      (magnitude != 0 && magnitude != 1) ||
      reinterpret_cast<uintptr_t>(tw) % 16)
    return cudaErrorInvalidValue;
  const long long smem = fft_smem(n_mels, nnz);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  auto kernel = magnitude ? sig_mel_fft_kernel<true>
                          : sig_mel_fft_kernel<false>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kFftThreads, static_cast<size_t>(smem));
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  Fft p;
  p.x = x;
  p.T = T;
  p.frames = batch * n_frames;
  p.n_frames = n_frames;
  p.hop = hop;
  p.pack = pack;
  // the frame's first tap (pack_off: a circular shift of the DFT's frame,
  // which leaves its power as it is)
  p.start = static_cast<long long>(offset) + pack_off;
  p.window = window;
  p.tw = static_cast<const double2*>(tw);
  p.preemph = preemph;
  p.mel_off = mel_off;
  p.mel_lo = mel_lo;
  p.f0 = static_cast<const __nv_bfloat16*>(f0);
  p.f1 = static_cast<const __nv_bfloat16*>(f1);
  p.nnz = nnz;
  p.n_mels = n_mels;
  p.out_mode = out_mode;
  p.guard = guard;
  p.out = out;
  // every block resident at once, each group a run of frames, and no block
  // whose groups would all have none
  const long long blocks = static_cast<long long>(sms) * per_sm;
  const long long need = (p.frames + kFftGroups - 1) / kFftGroups;
  const long long grid = need < blocks ? need : blocks;
  kernel<<<static_cast<unsigned>(grid), kFftThreads,
           static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

// the shared memory of one block of the float64 FFT path for a projection
// of n_mels runs of nnz values in all
long long melspec_sig_mel_fft_smem(int n_mels, int nnz) {
  return fft_smem(n_mels, nnz) + kFftStatic;
}

const char* melspec_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
