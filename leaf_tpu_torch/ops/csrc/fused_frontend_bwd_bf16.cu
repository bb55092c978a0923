// Fused Gabor conv -> squared modulus -> Gaussian lowpass, backward, on
// Hopper's tensor cores in bf16 (x and OUT bf16, windows and dY f32, f32
// sums; the wrapper rounds d_bank to bf16).
//
// Replaces leaf_tpu/ops/fused_frontend.py:_bwd_kernel (:422, reached
// through _run_bwd_group :549 / pallas_call :574 from _fused_bwd :734)
// under bf16 compute, with the XLA glue around it (_fused_bwd's cotangent
// gather, _group_cotangent, _build_bwd_selectors, _fold_bwd_windows,
// _fold_toeplitz_grad). From the bf16 conv outputs saved by the forward
// (fused_frontend_bf16.cu, kSave), OUT = conv_out (B, 2F, T) [re | im],
// the output cotangent dY (B, n_frames, F) and the windows (F, 401) it
// computes, for 0 <= t < T, at the JAX op's rounding points (bf16(v) is
// v rounded to the nearest bf16):
//
//   S[b, t, c]      = OUT_re[b, c, t]^2 + OUT_im[b, c, t]^2            (f32)
//   dS[b, t, c]     = sum_f bf16(dY[b, f, c]) * bf16(win[c, t + 200 - 160 f])
//   d_win[c, k]    += sum_f bf16(dY[b, f, c]) * bf16(S[b, 160 f + k - 200, c])
//   dOUT[b, col, t] = bf16(2 * OUT[b, col, t] * dS[b, t, col mod F])
//   d_bank[j, col] += sum_t xpad[b, t + j] * dOUT[b, col, t]
//
// every product of bf16 values and every sum in f32, each in a fixed
// order (two launches are bit-equal). The waveform gradient is zero by
// the op's contract and is not computed.
//
// Bound. d_bank is a GEMM, M = 401 taps x N = 2F columns x K = B*T
// positions: 2 * B * T * 2F * 401 = 2.63e11 flops at B=256, T=16000,
// F=40, 0.27 ms at the H100's dense bf16 rate of 989 TFLOP/s (0.30 ms
// with the taps padded to 7 tiles of 64); dS, dOUT and d_win add ~3e9
// f32 flops on the CUDA cores (~0.04 ms). It reads ~0.67 GB (OUT, x,
// dY), ~0.20 ms at 3.35 TB/s: bound by tensor-core operations.
//
// Design. One block per SM over a contiguous range of the launch's
// (32-position window, batch row) chunks; three warpgroups hold the 7 tap
// tiles of 64 (3, 3 and 1) in f32 accumulators; eight producer warps (the
// four of warpgroup 3 and, beside its one tile, the four of warpgroup 2)
// form dOUT on the CUDA cores; a ring of 3 stages with full/empty
// mbarriers (one arrival per warp) between them. The accumulators are
// flushed into the block's partial every 64 chunks (2048 positions);
// deterministic split-K. Products are wgmma.mma_async m64n80k16 .bf16:
// A, the Hankel waveform tile A[j, k] = xpad[t0 + k + j], from registers
// (lds_pair reads the pairs that straddle a 32-bit word); B, the dOUT
// chunk in bf16, K-major, unswizzled (slabs of 8 positions 1296 bytes
// apart: 80 columns x 16 bytes + 16).
//
// The kernel this design replaced (the f32 kernel's schedule with bf16
// operands, 1.24 ms at B=256, T=16000, F=40) ran at 24 % of its bound.
// Its time, split on the card (PERF.md §6; clock() stamps in a copy, and
// copies with parts taken out): without its products it still
// took 0.95-1.00 ms, so its single producer warpgroup set the pace, about
// 2 000 cycles per chunk of which its channel loop took 1 160-1 234 (~16
// shared-memory operations per (position, channel), 6 of them a
// read-modify-write of the d_windows sums at taps that moved with every
// chunk) and its cp.async wait 524-549. The redesign, step by step:
//  - Window-major walk, d_windows in registers. Chunk i of the grid is
//    (window tc = i / B, row b = i % B): a block walks one 32-position
//    window t0 = 32 tc over consecutive rows, so a lane (a position t =
//    t0 + lane) keeps its frames and taps k0 > k1 > k2 through a run of
//    up to kRun rows (a run also ends at the batch end and at the end of
//    the block's range). The lane sums its d_windows terms for its
//    channels in registers, in row order, and adds them into the block's
//    sums in shared memory at the run's end (warp pw alone owns its
//    channels, and within a chunk no two lanes share a (channel, tap), so
//    the order of every f32 sum is fixed). Per (position, channel) the
//    producer makes 8 shared-memory operations instead of ~16: OUT re and
//    im, one 16-byte broadcast read of the channel's dY (rounded to bf16
//    once per chunk), three reads of a table of the bf16 windows (taps
//    -160..400, the negative ones zero) and the two dOUT stores. (The
//    windows in registers too, packed two to a register, did not fit: at
//    every register split tried ptxas spilled or serialized the wgmmas.)
//  - The CUDA-core work over eight warps: warpgroup 2, idle beside its
//    two products per chunk, owns 16 of the 40 channels, warpgroup 3 the
//    other 24; each warp reads a group of two channels before it writes
//    them, so that the reads overlap.
//  - Each chunk's products in flight: a consumer loads both k-steps' A
//    pairs P0..P4 per tile (k-step q = {P[2q], P[2q+1], P[2q+1],
//    P[2q+2]}) into distinct registers, issues the chunk's 2 x kMine
//    wgmmas back to back and waits once per chunk.
//  - Registers (setmaxnreg): 176 for the 3-tile warpgroups (C7512 at
//    168), 104 for warpgroup 2, 56 for warpgroup 3.
//  - Staging, one chunk ahead with cp.async: the bf16 OUT rows and the
//    bf16 waveform span in 16-byte pieces, the f32 dY in 4-byte pieces
//    when T % 8 == 0 and x and OUT are 16-byte aligned, else the bf16
//    values with 2-byte loads.
// The redesign ran at 1.19 ms (PERF.md §6): without products 1.04 ms, the
// producer still setting the pace. Measured and not kept, each at 1.19 to
// 1.27 ms: TMA for the staging, A from shared memory (the Hankel core
// matrices), products waited for one chunk later (wait_group 1), 3 to 5
// staged chunks in flight, 4 to 6 ring stages, row groups of 8 or 16 rows.
//  tests/test_torch_port_bwd_schedule.py replays the walk, the runs, the
//  d_windows terms and the flush intervals.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

// bf16_round, bf16_to_float, float_to_bf16, lds_pair, pair_sel, cp_async8,
// wgmma_bf16, and hopper_tf32.cuh's smem_u32, lds, cp_async4/16,
// b_desc_of, fence_acc
#include "hopper_bf16.cuh"

namespace {

constexpr int kTaps = 401;
constexpr int kHop = 160;
constexpr int kPadL = 200;
constexpr int kChans = 40;                 // channels per block
constexpr int kN = 2 * kChans;             // bank columns: re 0..39 | im 40..79
constexpr int kAcc = kN / 2;               // accumulator registers per tile
constexpr int kTiles = 7;                  // 64-tap tiles: 448 padded taps
constexpr int kConsumers = 3;              // warpgroups of 3, 3 and 1 tiles
constexpr int kChunk = 32;                 // positions per stage
constexpr int kKSteps = kChunk / 16;       // k16 steps per stage
constexpr int kPairs = 2 * kKSteps + 1;    // A pairs per tile and chunk
// Chunks between two flushes of the tensor-core accumulators into the
// block's partial (f32 adds, rounded to nearest): 2048 positions.
constexpr int kFlushChunks = 64;
// Rows of one window a lane sums its d_windows terms over in registers
// before it adds them into the block's sums.
constexpr int kRun = 32;
// producer warps: warp w of warpgroup 3 owns channels w + 4 r, r <
// kPerWarp3; warp w of warpgroup 2, which also holds tile 6, channels
// 4 kPerWarp3 + w + 4 r, r < kPerWarp2
constexpr int kPerWarp3 = 6, kPerWarp2 = 4;
constexpr int kProducerWarps = 8;
constexpr int kMaxPerWarp = kPerWarp3 > kPerWarp2 ? kPerWarp3 : kPerWarp2;
constexpr int kFrames = 4;                 // frames whose windows meet a chunk
// staged chunks: the producer copies chunk it + kSlots - 1 while it works
// on chunk it (more in flight measured slower)
constexpr int kSlots = 2;
constexpr int kGroup = 2;                  // producer channels per batch of reads
// registers per thread (setmaxnreg), from 128 at entry: the 3-tile
// consumers, warpgroup 2 (tile 6 and producer warps 4..7), warpgroup 3
constexpr int kRegs3 = 176, kRegs2 = 104, kRegsProducer = 56;
constexpr int kStages = 3;
// span + halo of a chunk (kChunk + 448 taps) and the pairs read past it,
// in bf16: 16-byte pieces of 8, one per producer thread of the first 64
constexpr int kXsLen = 512;
constexpr int kXsThreads = kXsLen / 8;
constexpr int kSlabBytes = kN * 16 + 16;   // 8 positions of B, padded
constexpr int kBBytes = (kChunk / 8) * kSlabBytes;
constexpr int kStageBytes = kBBytes + 2 * kXsLen;  // B, xs
constexpr int kWinFloats = kChans * kTaps;
// a row of bf16-rounded windows in shared memory: taps -160..400, the
// negative ones zero, so that a lane's tap k2 = k0 - 320 needs no test
constexpr int kWsRow = kHop + kTaps;
constexpr int kWsFloats = kChans * kWsRow;
constexpr int kProducerThreads = 32 * kProducerWarps;
constexpr int kConsumerThreads = 128 * kConsumers;
constexpr int kThreads = 512;
constexpr unsigned kSpinLimit = 1u << 22;  // a lost arrival traps, never hangs

static_assert(kXsLen >= kChunk + 64 * kTiles + 8 && kXsThreads <= 128,
              "one 16-byte piece per thread of producer warps 0 and 1");
static_assert(kStageBytes % 16 == 0 && kBBytes % 16 == 0,
              "stages and their waveform spans stay 16-byte aligned");
static_assert(kSlabBytes % 16 == 0, "wgmma descriptors address 16-byte units");
static_assert(kChunk == 32 && (kChunk - 1 + 2 * kPadL) / kHop + 1 <= kFrames,
              "a lane per position; the frames that meet a chunk fit a dY row");
static_assert(4 * (kPerWarp3 + kPerWarp2) == kChans && kMaxPerWarp * kFrames <= 32,
              "the producer warps own the 40 channels; a warp's dY entries fit its lanes");

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  for (unsigned spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (spin > kSpinLimit) __trap();
  }
}

struct Ring {
  uint8_t* stages;
  uint64_t* full;
  uint64_t* empty;
};

// Tiles [tile0, tile0 + kMine) of d_bank, held by one warpgroup in f32
// accumulators over the block's chunks and flushed (rows < 401) into the
// block's partial every kFlushChunks chunks and after the last.
template <int kMine>
struct Tiles {
  float acc[kMine][kAcc];
  uint32_t sel;   // lds_pair's selector: the pair's parity is gid's in every stage
  uint32_t xoff;  // byte offset in a stage of the word holding xs[p0]

  __device__ __forceinline__ void init(int tile0, uint32_t ring_u32) {
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int p0 = 64 * tile0 + 16 * warp + (lane >> 2) + 2 * (lane & 3);
    sel = pair_sel(ring_u32 + kBBytes + 2 * p0);
    xoff = kBBytes + ((2 * p0) & ~3);
#pragma unroll
    for (int m = 0; m < kMine; ++m) {
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[m][i] = 0.f;
    }
  }

  // chunk `it` of the block: wait for its stage, issue its 2 kMine
  // products back to back, wait for them once, release the stage
  __device__ __forceinline__ void step(const Ring& ring, uint32_t ring_u32,
                                       int it, int n_chunks, int tile0,
                                       float* __restrict__ db) {
    const int s = it % kStages;
    mbar_wait(&ring.full[s], (it / kStages) & 1);
    __syncwarp();  // the warpgroup is converged for wgmma
    // 32-bit shared addresses: one base register per operand, the rest
    // are immediate offsets
    const uint32_t st = ring_u32 + s * kStageBytes;
    const uint32_t xw = st + xoff;
    const uint32_t dlo = ((st & 0x3FFFF) >> 4) | ((kSlabBytes >> 4) << 16);

    // pairs P_i = xs[p + 8 i]; k-step q's A fragment is {P[2q],
    // P[2q + 1], P[2q + 1], P[2q + 2]}
    uint32_t pr[kMine][kPairs];
#pragma unroll
    for (int m = 0; m < kMine; ++m) {
#pragma unroll
      for (int i = 0; i < kPairs; ++i) pr[m][i] = lds_pair(xw + 128 * m + 16 * i, sel);
    }
#pragma unroll
    for (int m = 0; m < kMine; ++m) fence_acc(acc[m]);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int q = 0; q < kKSteps; ++q) {
      // k-step q reads positions 16q..16q+15: two slabs on
      const uint64_t desc = b_desc_of(dlo + 2 * q * (kSlabBytes >> 4));
#pragma unroll
      for (int m = 0; m < kMine; ++m) {
        const uint32_t a[4] = {pr[m][2 * q], pr[m][2 * q + 1], pr[m][2 * q + 1],
                               pr[m][2 * q + 2]};
        wgmma_bf16(acc[m], a, desc);
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int m = 0; m < kMine; ++m) fence_acc(acc[m]);
    __syncwarp();  // the warp's products are done: one arrival per warp
    if ((threadIdx.x & 31) == 0) mbar_arrive(&ring.empty[s]);
    if ((it + 1) % kFlushChunks == 0 || it + 1 == n_chunks) {
      // accumulator (i, h, e) of tile m: row 16 w + g + 8 h, column
      // 8 i + 2 tig + e; each thread owns its entries of the partial
      const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
      const int gid = lane >> 2, tig = lane & 3;
      const bool first = it < kFlushChunks;
#pragma unroll
      for (int m = 0; m < kMine; ++m) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = 64 * (tile0 + m) + 16 * warp + gid + 8 * h;
          if (j < kTaps) {
#pragma unroll
            for (int i = 0; i < kN / 8; ++i) {
              float2* d = reinterpret_cast<float2*>(db + (size_t)j * kN + 8 * i + 2 * tig);
              const float2 v = make_float2(acc[m][4 * i + 2 * h], acc[m][4 * i + 2 * h + 1]);
              if (first)
                *d = v;
              else  // no return value: a fire-and-forget reduction (RED)
                atomicAdd(d, v);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < kAcc; ++i) acc[m][i] = 0.f;
      }
    }
  }
};

// A consumer warpgroup of kMine tiles from tile0 on.
template <int kMine>
__device__ __forceinline__ void consume(const Ring& ring, int n_chunks,
                                        int tile0, float* __restrict__ db) {
  const uint32_t ring_u32 = smem_u32(ring.stages);
  Tiles<kMine> tiles;
  tiles.init(tile0, ring_u32);
  for (int it = 0; it < n_chunks; ++it) tiles.step(ring, ring_u32, it, n_chunks, tile0, db);
}

__device__ __forceinline__ void producer_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kProducerThreads) : "memory");
}

// What the producer warps stage for one chunk, one chunk ahead: the bf16
// OUT rows of the 40 channels (re 0..39 | im 40..79, 32 positions each;
// a warp copies and reads the rows of its own channels), the bf16
// waveform span xpad[t0 .. t0 + 512) (producer thread i < 64 copies and
// reads 8i .. 8i + 7) and, per warp, f32 dY of the <= 4 frames that meet
// the chunk for its channels, [r][frame - f_lo] so that one 16-byte read
// gives a channel's frames (rounded to bf16 in place before it is read).
// A warp reads what it copied after a __syncwarp.
struct Staged {
  uint16_t out[kN][kChunk];
  uint16_t x[kXsLen];
  float dy[kProducerWarps][kMaxPerWarp][kFrames];  // [pw][r][frame - f_lo]
};
static_assert(sizeof(Staged) % 16 == 0 && offsetof(Staged, x) % 16 == 0
              && offsetof(Staged, dy) % 16 == 0,
              "16-byte cp.async into Staged::x, 16-byte dY reads");

__device__ __forceinline__ int first_frame(int t) {  // first frame over t
  return t > kPadL ? (t - kPadL + kHop - 1) / kHop : 0;
}

// Stages chunk (row b, window t0) into `sg` for producer warp pw, which
// owns the kMy channels cw + 4 r (and the waveform span for producer
// threads < 64). Lane l copies the 16-byte pieces l, l + 32, ... of the
// warp's 2 kMy rows (row j = piece / 4: channel cw + 4 (j % kMy), re for
// j < kMy, im after) and dY entry l < 4 kMy (frame l / kMy, channel cw +
// 4 (l % kMy)). Channels >= n_live, positions >= T and frames > f_hi are
// staged as zero.
template <int kMy>
__device__ __forceinline__ void stage_chunk(
    Staged& sg, const uint16_t* __restrict__ xb, const uint16_t* __restrict__ ob,
    const float* __restrict__ dyb, int t0, int T, int F, int n_frames,
    int c0, int n_live, bool aligned, int pw, int cw, int lane) {
  const uint32_t out_u32 = smem_u32(&sg.out[0][0]);
#pragma unroll
  for (int k = 0; k < (2 * kMy * kChunk / 8 + 31) / 32; ++k) {
    const int piece = lane + 32 * k;
    if (piece >= 2 * kMy * kChunk / 8) break;
    const int j = piece >> 2, c = cw + 4 * (j % kMy);
    const int tp = t0 + 8 * (piece & 3);
    const uint16_t* row = ob + (size_t)((j / kMy) * F + c0 + c) * T;
    const int dst = ((j / kMy) * kChans + c) * kChunk + 8 * (piece & 3);
    if (aligned) {  // T % 8 == 0: each piece lies inside or outside [0, T)
      const bool live = c < n_live && tp < T;
      cp_async16(out_u32 + 2 * dst, reinterpret_cast<const float*>(live ? row + tp : ob),
                 live);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const bool live = c < n_live && tp + e < T;
        (&sg.out[0][0])[dst + e] = live ? __ldg(row + tp + e) : (uint16_t)0;
      }
    }
  }
  const int pt = 32 * pw + lane;
  if (pt < kXsThreads) {
    const int tt = t0 - kPadL + 8 * pt;  // xs[8 pt] = xpad[t0 + 8 pt]
    if (aligned) {
      const bool live = tt >= 0 && tt < T;
      cp_async16(smem_u32(&sg.x[8 * pt]),
                 reinterpret_cast<const float*>(live ? xb + tt : xb), live);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const bool live = tt + e >= 0 && tt + e < T;
        sg.x[8 * pt + e] = live ? __ldg(xb + tt + e) : (uint16_t)0;
      }
    }
  }
  if (lane < kMy * kFrames) {
    const int fr = lane / kMy, r = lane % kMy;
    const int f = first_frame(t0) + fr, c = cw + 4 * r;
    const int f_hi = min(n_frames - 1, (t0 + kChunk - 1 + kPadL) / kHop);
    const bool live = c < n_live && f <= f_hi;
    cp_async4(smem_u32(&sg.dy[pw][r][fr]), live ? dyb + (size_t)f * F + c0 + c : dyb,
              live);
  }
}

// A producer warpgroup: warps pw = 4 .. 7 (kTile) or 0 .. 3 stage x and
// dOUT (bf16) chunk by chunk and sum d_windows; lane = position in the
// chunk. Chunk i of the block is (window (chunk0 + i) / batch, row
// (chunk0 + i) % batch). With kTile (warpgroup 2) the warpgroup then
// runs tile 6's products on the chunk it has just staged.
template <bool kTile>
__device__ __forceinline__ void produce(
    const Ring& ring, Staged* sgs, float* __restrict__ dws, float* __restrict__ ws,
    const uint16_t* __restrict__ x, const uint16_t* __restrict__ conv_out,
    const float* __restrict__ windows, const float* __restrict__ d_out,
    float* __restrict__ dw, float* __restrict__ db, int chunk0, int n_chunks,
    int batch, int T, int F, int n_frames, int c0, int n_live, bool aligned) {
  constexpr int kMy = kTile ? kPerWarp2 : kPerWarp3;
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
  const int pw = (kTile ? 4 : 0) + w;
  const int cw = (kTile ? 4 * kPerWarp3 : 0) + w;  // channels cw + 4 r
  const int pt = 32 * pw + lane;  // 0 .. 255 over the producer warps

  const uint32_t ring_u32 = smem_u32(ring.stages);
  Tiles<1> tile;
  if (kTile) tile.init(kTiles - 1, ring_u32);

  // (row, window start) of the chunk being worked on and of the next one
  // to stage
  int b = chunk0 % batch, t0 = chunk0 / batch * kChunk;
  int bn = b, tn = t0;
  auto stage = [&](int slot) {
    stage_chunk<kMy>(sgs[slot], x + (size_t)bn * T, conv_out + (size_t)bn * 2 * F * T,
                     d_out + (size_t)bn * n_frames * F, tn, T, F, n_frames, c0,
                     n_live, aligned, pw, cw, lane);
    if (++bn == batch) { bn = 0; tn += kChunk; }
  };
  for (int i = 0; i < kSlots - 1; ++i) {  // one commit group per chunk
    if (i < n_chunks) stage(i);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int i = pt; i < kWinFloats; i += kProducerThreads) dws[i] = 0.f;
  // the windows of dS rounded to bf16 once, as the JAX op's selectors are
  for (int i = pt; i < kWsFloats; i += kProducerThreads) {
    const int c = i / kWsRow, k = i % kWsRow - kHop;
    ws[i] = c < n_live && k >= 0 ? bf16_round(windows[(size_t)(c0 + c) * kTaps + k]) : 0.f;
  }
  producer_sync();

  // the run's d_windows sums [r][tap k0, k1, k2]; a tap k2 < 0 has a zero
  // window and its sum is never added
  float dsum[kMy][3];
  int k0 = 0, fd = 0, rows = 0;
  for (int it = 0; it < n_chunks; ++it) {
    if (it == 0 || b == 0 || rows == kRun) {  // a run starts
      const int t = t0 + lane, fa = first_frame(t);
      k0 = t + kPadL - kHop * fa;
      fd = fa - first_frame(t0);  // the lane's first frame row in sg.dy
#pragma unroll
      for (int r = 0; r < kMy; ++r) dsum[r][0] = dsum[r][1] = dsum[r][2] = 0.f;
      rows = 0;
    }
    __syncwarp();  // every lane is done with the slot the next copy fills
    if (it + kSlots - 1 < n_chunks) stage((it + kSlots - 1) % kSlots);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group %0;\n" :: "n"(kSlots - 1) : "memory");
    Staged& sg = sgs[it % kSlots];
    if (lane < kMy * kFrames) {  // dY rounded to bf16 once, by its copier
      float* v = &sg.dy[pw][lane % kMy][lane / kMy];
      *v = bf16_round(*v);
    }
    __syncwarp();

    const int s = it % kStages;
    mbar_wait(&ring.empty[s], ((it / kStages) & 1) ^ 1);
    uint8_t* st = ring.stages + (size_t)s * kStageBytes;
    uint16_t* bsm = reinterpret_cast<uint16_t*>(st);
    if (pt < kXsThreads)
      reinterpret_cast<uint4*>(st + kBBytes)[pt] =
          reinterpret_cast<const uint4*>(sg.x)[pt];
    // B element (position k, column n) at element (k / 8) * kSlabBytes / 2 + 8 n + k % 8
    const int boff = (lane >> 3) * (kSlabBytes / 2) + (lane & 7);
    // kGroup channels at a time, a group's shared-memory reads before its
    // writes, so that the reads overlap (the compiler cannot move a read
    // of the staged slot above a write of the ring). A channel >= n_live
    // reads zeros (OUT and dY staged as zero) and writes zero dOUT columns.
#pragma unroll
    for (int r0 = 0; r0 < kMy; r0 += kGroup) {
      float re[kGroup], im[kGroup], dy[kGroup][3], w[kGroup][3];
#pragma unroll
      for (int j = 0; j < kGroup && r0 + j < kMy; ++j) {
        const int r = r0 + j, c = cw + 4 * r;
        re[j] = bf16_to_float(sg.out[c][lane]);
        im[j] = bf16_to_float(sg.out[kChans + c][lane]);
        const float4 d4 = *reinterpret_cast<const float4*>(&sg.dy[pw][r][0]);
        dy[j][0] = fd ? d4.y : d4.x;
        dy[j][1] = fd ? d4.z : d4.y;
        dy[j][2] = fd ? d4.w : d4.z;
        const float* wr = ws + c * kWsRow + kHop + k0;
        w[j][0] = wr[0];
        w[j][1] = wr[-kHop];
        w[j][2] = wr[-2 * kHop];
      }
#pragma unroll
      for (int j = 0; j < kGroup && r0 + j < kMy; ++j) {
        const int r = r0 + j, c = cw + 4 * r;
        const float sq = bf16_round(re[j] * re[j] + im[j] * im[j]);
        const float ds2 = 2.f * fmaf(dy[j][0], w[j][0],
                                     fmaf(dy[j][1], w[j][1], dy[j][2] * w[j][2]));
#pragma unroll
        for (int e = 0; e < 3; ++e) dsum[r][e] = fmaf(dy[j][e], sq, dsum[r][e]);
        bsm[boff + 8 * c] = float_to_bf16(re[j] * ds2);
        bsm[boff + 8 * (kChans + c)] = float_to_bf16(im[j] * ds2);
      }
    }
    // generic-proxy stores -> visible to wgmma's async proxy; then one
    // arrival per warp
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    if (lane == 0) mbar_arrive(&ring.full[s]);

    if (++rows == kRun || b + 1 == batch || it + 1 == n_chunks) {
      // the run ends: its sums into the block's, in run order (warp pw
      // alone touches channels cw + 4 r, each (channel, tap) from one lane)
#pragma unroll
      for (int r = 0; r < kMy; ++r) {
        float* row = dws + (cw + 4 * r) * kTaps;
        row[k0] += dsum[r][0];
        row[k0 - kHop] += dsum[r][1];
        if (k0 >= 2 * kHop) row[k0 - 2 * kHop] += dsum[r][2];
      }
    }
    if (++b == batch) { b = 0; t0 += kChunk; }
    if (kTile) tile.step(ring, ring_u32, it, n_chunks, kTiles - 1, db);
  }

  producer_sync();
  for (int i = pt; i < kWinFloats; i += kProducerThreads) dw[i] = dws[i];
}

__global__ void __launch_bounds__(kThreads, 1)
fused_bwd_bf16_kernel(const uint16_t* __restrict__ x,         // (B, T) bf16
                      const uint16_t* __restrict__ conv_out,  // (B, 2F, T) bf16 [re | im]
                      const float* __restrict__ windows,      // (F, 401)
                      const float* __restrict__ d_out,        // (B, n_frames, F)
                      float* __restrict__ dbank_part,         // (G, n_blocks, 401, 80)
                      float* __restrict__ dwin_part,          // (G, n_blocks, 40, 401)
                      int batch, int T, int F, int n_frames, int aligned) {
  extern __shared__ __align__(128) uint8_t smem[];
  Ring ring;
  ring.stages = smem;
  Staged* sgs = reinterpret_cast<Staged*>(smem + (size_t)kStages * kStageBytes);
  float* dws = reinterpret_cast<float*>(sgs + kSlots);
  float* ws = dws + kWinFloats;
  ring.full = reinterpret_cast<uint64_t*>(ws + kWsFloats);
  ring.empty = ring.full + kStages;

  const int g = blockIdx.y, c0 = g * kChans;
  const int n_live = min(kChans, F - c0);
  const int nch = (T + kChunk - 1) / kChunk;
  const long long work = (long long)batch * nch;
  const int chunk0 = (int)(work * blockIdx.x / gridDim.x);
  const int n_chunks = (int)(work * (blockIdx.x + 1) / gridDim.x) - chunk0;
  const size_t part = (size_t)g * gridDim.x + blockIdx.x;

  // zero the ring (columns of channels >= n_live are never written)
  for (int i = threadIdx.x; i < kStages * kStageBytes / 16; i += kThreads)
    reinterpret_cast<float4*>(smem)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&ring.full[s], kProducerThreads / 32);  // a warp arrives once
      mbar_init(&ring.empty[s], kConsumerThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  static_assert(2 * kRegs3 + kRegs2 + kRegsProducer <= 4 * 128,
                "setmaxnreg must not ask for more than the block holds");
  float* db = dbank_part + part * kTaps * kN;
  float* dw = dwin_part + part * kWinFloats;
  const int wg = threadIdx.x >> 7;
  if (wg == 3) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kRegsProducer));
    produce<false>(ring, sgs, dws, ws, x, conv_out, windows, d_out, dw, db, chunk0,
                   n_chunks, batch, T, F, n_frames, c0, n_live, aligned != 0);
  } else if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kRegs2));
    produce<true>(ring, sgs, dws, ws, x, conv_out, windows, d_out, dw, db, chunk0,
                  n_chunks, batch, T, F, n_frames, c0, n_live, aligned != 0);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kRegs3));
    consume<3>(ring, n_chunks, 3 * wg, db);
  }
}

constexpr size_t kSmemBytes = (size_t)kStages * kStageBytes + kSlots * sizeof(Staged)
                              + sizeof(float) * (kWinFloats + kWsFloats)  // d_win sums, windows
                              + 2 * kStages * sizeof(uint64_t);  // full, empty
static_assert(kSmemBytes <= 232448, "fits a block");

}  // namespace

// Launches the kernel on `stream` over an (n_blocks, ceil(F / 40)) grid.
// x and conv_out are device pointers to contiguous bf16 arrays, the rest
// to f32 ones, of the shapes noted on the kernel; the caller checks them
// and sizes the partials (n_blocks <= batch * ceil(T / 32)). Returns the
// CUDA error code of the launch (0 on success).
extern "C" int leaf_fused_bwd_bf16(const void* x, const void* conv_out,
                                   const void* windows, const void* d_out,
                                   void* dbank_part, void* dwin_part, int batch,
                                   int T, int F, int n_frames, int n_blocks,
                                   void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_bwd_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int aligned = T % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0
                      && reinterpret_cast<uintptr_t>(conv_out) % 16 == 0;
  const dim3 grid(n_blocks, (F + kChans - 1) / kChans);
  fused_bwd_bf16_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(conv_out),
      static_cast<const float*>(windows), static_cast<const float*>(d_out),
      static_cast<float*>(dbank_part), static_cast<float*>(dwin_part), batch,
      T, F, n_frames, aligned);
  return (int)cudaGetLastError();
}

// The kernel's dynamic shared memory per block, in bytes.
extern "C" int leaf_fused_bwd_bf16_smem_bytes() { return (int)kSmemBytes; }
