// The 128-frame chunk walk as a warp-specialised pipeline (layout 4): the
// tile, chunks, sums and outputs of sig_common.cuh's chunk walk in
// 128-frame blocks, with m_big and the bf2 projection's rows brought in
// by a producer warp. K1 (sig_mel.cu) walks its one head on it; K2
// (sig_multi.cu) walks each of its heads on it in turn, through one ring,
// beside the span staged once for all of them. Lay<1> / Lay<2> and the
// factored and FFT paths keep their own walks and share nothing of this
// file beyond the copy and wgmma primitives.
//
// Why: in the synchronous walk every 32-row stage waits for its cp.async
// copies, then a block barrier, before all 256 threads issue the next
// copies and the wgmma's; that chain, not any one part of it, held the
// 128-frame walk at about 530 ns a stage against 140 ns of tensor-core
// work. The design:
//   - The host lays each head's m_big out once, stage by stage, in the
//     ring's own bytes (kernels/sig_mel.py::pipe_stages): each stage of a
//     chunk as wgmma's core matrices of 8 rows x 16 bytes, 528 bytes a
//     column group, only the groups that hold live columns (pipe_groups:
//     a chunk whose live columns fit 32 of its 128 keeps those, split re
//     groups first, then their im groups), then, for a bf2
//     projection, the chunk's mt rows in pieces of kPipeRows rows a stack,
//     swizzled as project_bf2 stages them. A stage is one contiguous
//     cp.async.bulk into a ring slot, completing on the slot's "full"
//     mbarrier.
//   - One producer warp (warp 8, of a warpgroup whose other warps only
//     hand their registers over) keeps the ring full, up to 8 slots where
//     shared memory allows, head after head; setmaxnreg gives the
//     producer warpgroup's registers to the consumers (232 a thread).
//   - The two consumer warpgroups (warps 0-7) wait on a
//     slot's "full" barrier, run its wgmma's (m64n128k16, or m64n32k16 on
//     a narrow chunk, A from registers, each
//     tap's place in the segmented span computed from the tap alone) and
//     release it on its "empty" barrier: no block barrier inside the walk.
//     The projection's pieces arrive through the same ring, ahead of the
//     chunk's power.
//   - K2's log tile lies past the ring (pipe_tile_bytes), so the producer
//     brings the next head's stages in while a head's epilogue runs.
// Two blocks a cluster sharing each stage by multicast were built and
// measured slower (PERF.md §6): the L2 stream does not hold the walk
// back, and the pair's barriers tie each block to the slower of the two.
// Sums: every output sums the head's K blocks in the given order and each
// block's taps in ascending k16 steps, then the projection's power columns
// in ascending k16 steps, as the synchronous walk of the other layouts
// does: K1's and K2's outputs are equal bit for bit, whichever layout
// each takes.

#pragma once

#include "sig_common.cuh"
#include "sig_factored.cuh"

namespace sigk {

// two consumer warpgroups and a producer warpgroup, whose warp 8 alone
// copies: with its registers handed over (setmaxnreg), a consumer thread
// has 232 of the SM's registers, as a 256-thread block's 255 would not
// leave room for the producer
constexpr int kPipeThreads = kThreads + 128;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kPipeSlot = Lay<0>::kStageBytes;  // a ring slot's bytes
constexpr int kPipeMinSlots = 4;
constexpr int kPipeMaxSlots = 8;
constexpr int kPipeRows = 32;  // mt rows of one stack a projection piece
// the full and the empty barrier of every slot
constexpr int kPipeBarBytes = 2 * 8 * kPipeMaxSlots;

// The pipelined walk's launch: the head's stage stream (pipe_stages) and
// the ring's slots
struct Pipe {
  const unsigned char* stages;
  int slots;
};

// 8-column groups of a chunk's stages: 4 where they hold its live columns
// (split: live re groups, each beside its im group), else all 16
__host__ __device__ inline int pipe_groups(bool split, int live_in) {
  return (live_in + 7) / 8 * (split ? 2 : 1) <= 4 ? 4 : 16;
}

// the live power columns of chunk ch and the projection rows it sums (a
// multiple of 16)
__host__ __device__ inline int pipe_live(int live, int cp, int ch) {
  const int n = live - ch * cp;
  return n < cp ? n : cp;
}
__host__ __device__ inline int pipe_kmax(int live, int cp, int ch) {
  return (pipe_live(live, cp, ch) + 15) & ~15;
}

// a chunk's stages: n_blocks K blocks of ceil(pack / 32) stages
__host__ __device__ inline int pipe_steps(int n_blocks, int pack) {
  return n_blocks * ((pack + kChunk - 1) / kChunk);
}

// The stage stream's bytes for a head: per chunk its pipe_steps stages of
// pipe_groups(...) * kCoreN bytes, then (bf2) three stacks of each piece's
// rows of nmp bf16
__host__ inline long long pipe_bytes(int width, int npow, int live,
                                     int n_blocks, int pack, int nmp,
                                     int bf2) {
  const bool split = npow != width;
  const int cp = chunk_pow<0>(width, npow);
  const int n_ch = (live + cp - 1) / cp;
  const long long steps = pipe_steps(n_blocks, pack);
  long long n = 0;
  for (int ch = 0; ch < n_ch; ++ch) {
    n += steps * pipe_groups(split, pipe_live(live, cp, ch)) * kCoreN;
    if (bf2) n += 3LL * pipe_kmax(live, cp, ch) * nmp * 2;
  }
  return n;
}

// The pipelined block's dynamic shared memory past the span: the ring,
// one chunk's power tile, the barriers
__host__ inline long long pipe_work_bytes(int width, int npow, int slots) {
  return static_cast<long long>(slots) * kPipeSlot +
         4LL * Lay<0>::kTile * chunk_pow<0>(width, npow) + kPipeBarBytes;
}

// K2's tile region past the ring for a head: its chunk's power tile or its
// log tile [tile][nmp], whichever is larger, so no head's epilogue
// writes the ring
__host__ inline long long pipe_tile_bytes(int width, int npow, int nmp) {
  const int cols = chunk_pow<0>(width, npow);
  return 4LL * Lay<0>::kTile * (cols > nmp ? cols : nmp);
}

// the ring's slots beside `fixed` bytes of a block's shared memory: as
// many as fit, up to kPipeMaxSlots
__host__ inline int pipe_slots(long long fixed) {
  const long long s = (kSmemLimit - fixed) / kPipeSlot;
  return static_cast<int>(s < kPipeMaxSlots ? s : kPipeMaxSlots);
}

// ---- mbarrier and bulk copy primitives (sm_90) ------------------------------

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
// until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// bytes global -> this block's shared memory, completing on bar
__device__ __forceinline__ void bulk_copy(unsigned dst, const void* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_n(float (&d)[N / 2],
                                        const unsigned (&a)[4],
                                        unsigned long long desc) {
  if constexpr (N == 128)
    wgmma_128(d, a, desc);
  else
    wgmma_32(d, a, desc);
}

template <int M>
__device__ __forceinline__ void hold(float (&d)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// ---- the ring ---------------------------------------------------------------

// A position in the ring (slot, phase) and its barriers: full[s] at bars +
// 8 s, empty[s] at bars + 8 (kPipeMaxSlots + s)
struct Ring {
  unsigned data0, bars;
  int slots, slot;
  unsigned phase;

  __device__ __forceinline__ unsigned full(int s) const { return bars + 8 * s; }
  __device__ __forceinline__ unsigned empty(int s) const {
    return bars + 8 * (kPipeMaxSlots + s);
  }
  __device__ __forceinline__ unsigned data(int s) const {
    return data0 + s * kPipeSlot;
  }
  __device__ __forceinline__ void advance() {
    if (++slot == slots) {
      slot = 0;
      phase ^= 1;
    }
  }
  // a consumer warp: slot s's bytes are read (wgmma's waited for,
  // ldmatrix done); one arrival on its empty barrier
  __device__ __forceinline__ void release(int s) const {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty(s));
  }
};

// The ring of `slots` slots at data, its barriers at bars, initialised by
// thread 0 (full: the producer's one arrival with its bytes; empty: one
// arrival a consumer warp) and seen by every thread of the block and by
// the bulk copies' completions; at its first slot
__device__ __forceinline__ Ring pipe_ring(unsigned char* data,
                                          unsigned char* bars, int slots) {
  Ring rg;
  rg.data0 = smem_addr(data);
  rg.bars = smem_addr(bars);
  rg.slots = slots;
  rg.slot = 0;
  rg.phase = 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < rg.slots; ++s) {
      mbar_init(rg.full(s), 1);
      mbar_init(rg.empty(s), kWarps);
    }
    // the barriers' initialisation, seen by the bulk copies' completions
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return rg;
}

// Whether this thread is of the producer warpgroup (warps 8-11), which
// hands its registers to the two consumer warpgroups; each side sets its
// own count (warpgroup-uniform, as setmaxnreg needs)
__device__ __forceinline__ bool pipe_producer() {
  if (threadIdx.x >= kThreads) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kProducerRegs));
    return true;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      kConsumerRegs));
  return false;
}

// The producer (one thread): every stage of the head's chunks in order,
// then (bf2) the chunk's projection pieces, each into the next slot once
// the consumers have released it; the ring goes on where it stops, for a
// next head
__device__ __forceinline__ void pipe_produce(const Head& h,
                                             const unsigned char* stages,
                                             Ring& rg) {
  const unsigned char* src = stages;
  auto put = [&](unsigned bytes) {
    mbar_wait(rg.empty(rg.slot), rg.phase ^ 1);
    mbar_expect_tx(rg.full(rg.slot), bytes);
    bulk_copy(rg.data(rg.slot), src, bytes, rg.full(rg.slot));
    src += bytes;
    rg.advance();
  };
  const bool split = split_head(h);
  const int cp = chunk_pow<0>(h.width, h.npow);
  const int n_ch = (h.live + cp - 1) / cp;
  const int n_steps = pipe_steps(h.n_blocks, h.pack);
  const int nmp = h.n_mels_pad;
  for (int ch = 0; ch < n_ch; ++ch) {
    const unsigned sb = pipe_groups(split, pipe_live(h.live, cp, ch)) * kCoreN;
    for (int i = 0; i < n_steps; ++i) put(sb);
    if (!h.bf2) continue;
    const int kmax = pipe_kmax(h.live, cp, ch);
    for (int k0 = 0; k0 < kmax; k0 += kPipeRows) {
      const int rows = kmax - k0 < kPipeRows ? kmax - k0 : kPipeRows;
      for (int s = 0; s < 3; ++s) put(rows * nmp * 2);
    }
  }
}

// y[tile, chunk] over the chunk's n_steps stages, as Lay<0>'s dft_chunk:
// warpgroup w takes frames [64 w, + 64), a warp 16 of them, and the
// chunk's N ring columns; a k16 step is one m64nNk16, A (the warp's tap
// pairs of the segmented span) from registers, B from the slot by
// descriptor. One stage's wgmma's stay in flight while the next stage's
// are issued; then the earlier stage's slot is released and its A buffer
// takes the stage after. The accumulators are touched by nothing but the
// wgmma's until the last wait.
template <int N, bool kFast>
__device__ __forceinline__ void pipe_dft(const Head& h, const int* tab,
                                         unsigned sx, const Span& sp,
                                         Ring& rg, float (&d)[N / 2]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) d[i] = 0.0f;
  int roff[2];  // element offset of this thread's two frame rows
  roff[0] = ((warp >> 2) * Lay<0>::kWgFrames + (warp & 3) * 16 + g) *
            sp.stride;
  roff[1] = roff[0] + 8 * sp.stride;
  const int n_steps = pipe_steps(h.n_blocks, h.pack);
  // tap t of a frame lies at element t + (t / hop) (stride - hop) past the
  // frame's first; t / hop as the high word of t (2^32 / hop + 1), exact
  // for t and hop below 2^16. Each of a stage's four offsets comes from
  // its own tap, so none waits for another.
  const unsigned magic =
      static_cast<unsigned>(0x100000000ULL / static_cast<unsigned>(sp.hop)) +
      1u;
  const int pad = sp.stride - sp.hop;
  auto off = [&](int t) {
    return t + static_cast<int>(__umulhi(static_cast<unsigned>(t), magic)) *
                   pad;
  };
  const int tq = h.pack_off + 2 * q;  // this thread's first tap
  unsigned xs = sx;
  int nb = 0, t0 = 0;
  // the A fragments of the next stage
  auto load = [&](unsigned (&a)[2][4]) {
    if (t0 == 0) xs = sx + 2 * tab[2 * nb + 1] * sp.slice;
    const int tt = t0;
    t0 += kChunk;
    if (t0 >= h.pack) {
      t0 = 0;
      ++nb;
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int t = tq + tt + 16 * k + 8 * hh;
        const int dd = off(t);
#pragma unroll
        for (int rw = 0; rw < 2; ++rw) {
          const unsigned e = xs + 2 * (roff[rw] + dd);
          a[k][rw + 2 * hh] =
              kFast ? lds32(e)
                    : lds16(e) | (lds16(xs + 2 * (roff[rw] + off(t + 1)))
                                  << 16);
        }
      }
    }
    // the second k16 step past the block's taps: zero A against the
    // stage's zero rows adds exact zeros, as Lay<0>'s skipped step adds
    // none
    if (tt + 16 >= h.pack) {
#pragma unroll
      for (int i = 0; i < 4; ++i) a[1][i] = 0u;
    }
  };
  // stage s: its wgmma's on A buffer s % 2; once stage s - 1's are done,
  // its slot is released and its buffer takes the A of stage s + 1
  unsigned a[2][2][4];
  load(a[0]);
  int s = 0;
  int rel = rg.slot;  // the slot of the oldest stage not released
  while (s < n_steps) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (s < n_steps) {
        mbar_wait(rg.full(rg.slot), rg.phase);
        const unsigned st = rg.data(rg.slot);
        wg_fence();
        wgmma_n<N>(d, a[u][0], gmma_desc(st, kLbo, kSbo));
        wgmma_n<N>(d, a[u][1], gmma_desc(st + 2 * kCoreK, kLbo, kSbo));
        wg_commit();
        wg_wait<1>();
        if (s > 0) {
          rg.release(rel);
          if (++rel == rg.slots) rel = 0;
        }
        rg.advance();
        if (++s < n_steps) load(a[u ^ 1]);
      }
    }
  }
  wg_wait<0>();
  hold(d);
  rg.release(rel);
}

// The chunk's power (a magnitude head: its sqrt) into the power tile as
// Lay<0>'s store_power, from the N / 8 accumulator tiles of a chunk of N
// ring columns (split: re tile j < N / 16 beside its im tile j + N / 16)
template <int N>
__device__ __forceinline__ void pipe_power(const Head& h,
                                           const float (&d)[N / 2],
                                           unsigned char* pb) {
  constexpr int kT = N / 8;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const bool split = split_head(h);
  const bool mag = kMagnitudeHeads && h.magnitude;
  const int cp = chunk_pow<0>(h.width, h.npow);
#pragma unroll
  for (int j = 0; j < kT; ++j) {
    if (split && j >= kT / 2) continue;
    const int col = j * 8 + 2 * q;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = (warp >> 2) * Lay<0>::kWgFrames + (warp & 3) * 16 + g +
                      8 * hh;
      float pw[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float y = d[4 * j + 2 * hh + e];
        if (split) {
          const float im = d[4 * (j + kT / 2) + 2 * hh + e];
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
        *reinterpret_cast<unsigned*>(pb + Lay<0>::kTile * cp * 2 + at) = w1;
      } else {
        *reinterpret_cast<float2*>(
            reinterpret_cast<float*>(pb) + row * cp + col) =
            make_float2(pw[0], pw[1]);
      }
    }
  }
}

// en[tile, nmp] += [p0 | p0 | p1] @ [F0; F1; F0] over the chunk's live
// power rows, as project_bf2: each piece's three stacks of kPipeRows rows
// arrive in three consecutive slots (swizzled by the host as project_bf2
// swizzles its staging); per k16 step p0 . F0, p0 . F1, p1 . F0
__device__ __forceinline__ void pipe_project(const Head& h, int ch,
                                             const unsigned char* pb,
                                             Ring& rg, Frag& en) {
  using L = Lay<0>;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = warp / L::kWN, wn = warp % L::kWN;
  const int cp = chunk_pow<0>(h.width, h.npow);
  const int nmp = h.n_mels_pad;
  const int ne = nmp / (8 * L::kWN);
  const int kmax = pipe_kmax(h.live, cp, ch);
  const unsigned p0 = smem_addr(pb);
  const unsigned p1 = p0 + L::kTile * cp * 2;
  const int mi = lane >> 3;
  const int lrow = (lane & 7) + ((mi & 1) << 3);
  for (int k0 = 0; k0 < kmax; k0 += kPipeRows) {
    const int rows = kmax - k0 < kPipeRows ? kmax - k0 : kPipeRows;
    int sl[3];
    unsigned st[3];
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      mbar_wait(rg.full(rg.slot), rg.phase);
      sl[s] = rg.slot;
      st[s] = rg.data(rg.slot);
      rg.advance();
    }
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
        if (2 * jj >= ne) break;
        const int n0 = wn * (nmp / L::kWN) + jj * 16;
        unsigned b[3][4];
#pragma unroll
        for (int s = 0; s < 3; ++s)
          ldsm_x4_t(b[s], st[s] + swz(kk + lrow, nmp * 2,
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
#pragma unroll
    for (int s = 0; s < 3; ++s) rg.release(sl[s]);
  }
}

// One chunk of the consumers at N ring columns: the DFT, the power, the
// projection
template <int N, bool kFast>
__device__ __forceinline__ void pipe_chunk(const Head& h, const int* tab,
                                           int ch, unsigned sx,
                                           const Span& sp, Ring& rg,
                                           unsigned char* pb, Frag& en) {
  float d[N / 2];
  pipe_dft<N, kFast>(h, tab, sx, sp, rg, d);
  sync_tile<4>();  // every warp is done with the last chunk's power
  pipe_power<N>(h, d, pb);
  sync_tile<4>();  // the chunk's power, from every warp
  if (h.bf2)
    pipe_project(h, ch, pb, rg, en);
  else
    project_f32<0>(h, ch, pb, en);
}

template <bool kFast>
__device__ __forceinline__ void pipe_chunk_n(int groups, const Head& h,
                                             const int* tab, int ch,
                                             unsigned sx, const Span& sp,
                                             Ring& rg, unsigned char* pb,
                                             Frag& en) {
  if (groups == 16)
    pipe_chunk<128, kFast>(h, tab, ch, sx, sp, rg, pb, en);
  else
    pipe_chunk<32, kFast>(h, tab, ch, sx, sp, rg, pb, en);
}

// One head over the block's frames on the pipelined walk, then its output
// values (head_tile), the log tile at vals: the consumers' part of
// run_head. tab is a shared copy of the head's block table; the ring goes
// on where the head leaves it.
__device__ __forceinline__ void pipe_head(const Head& h, int* tab,
                                          const __nv_bfloat16* sx,
                                          const Span& sp, unsigned char* work,
                                          unsigned char* vals, Ring& rg,
                                          int b, int k0, int n_frames,
                                          bool keep_vals) {
  head_tile<4>(h, vals, b, k0, n_frames, keep_vals, [&](Frag& en) {
    const bool split = split_head(h);
    const int cp = chunk_pow<0>(h.width, h.npow);
    unsigned char* pb = work + rg.slots * kPipeSlot;
    if (threadIdx.x < 2 * h.n_blocks)
      tab[threadIdx.x] = __ldg(h.blocks + threadIdx.x);
    sync_tile<4>();  // the table and the span
    const bool fast = ((sp.hop | h.pack_off) & 1) == 0;
    const int n_ch = (h.live + cp - 1) / cp;
    for (int ch = 0; ch < n_ch; ++ch) {
      const int groups = pipe_groups(split, pipe_live(h.live, cp, ch));
      if (fast)
        pipe_chunk_n<true>(groups, h, tab, ch, smem_addr(sx), sp, rg, pb,
                           en);
      else
        pipe_chunk_n<false>(groups, h, tab, ch, smem_addr(sx), sp, rg, pb,
                            en);
    }
  });
}

}  // namespace sigk
