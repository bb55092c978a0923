// Fused Gabor conv -> squared modulus -> Gaussian lowpass, forward, on
// Hopper's tensor cores in bf16 (x and the bank bf16, windows f32, f32
// sums, out f32; the saving variant stores OUT in bf16).
//
// Replaces leaf_tpu/ops/fused_frontend.py:_fwd_kernel (:325, reached
// through _run_fwd_group :355 / pallas_call :384) under bf16 compute (x
// and bank.astype(x.dtype) bf16, the selectors f32) in both its variants:
// the primal one (save_out=False, kSave = false here) and the
// residual-saving one of the custom VJP (save_out=True, :336-342, from
// _fused_fwd :729; kSave = true), whose OUT blocks the JAX op writes at
// the compute dtype. It computes
//
//   out[b, f, c] = sum_k win[c, k] * S[b, 160 f + k - 200, c]
//   S[b, t, c]   = OUT_re[b, c, t]^2 + OUT_im[b, c, t]^2   for 0 <= t < T,
//   OUT[b, col, t] = sum_j xpad[b, t + j] bank[j, col]     (col: re | im)
//
// with bf16 products and f32 sums, S and the fold in f32 from the f32
// sums (OUT is rounded to bf16, to nearest even, only where it is
// stored), as the JAX op and the plain version (ops/fused_frontend.py)
// compute.
//
// Bound. OUT is a GEMM, M = B*T positions x N = 2F columns x K = 401
// taps: 2 * B * T * 2F * 401 = 2.63e11 flops at B=256, T=16000, F=40,
// 0.27 ms at the H100's dense bf16 rate of 989 TFLOP/s; |.|^2 and the
// lowpass add ~1.5e9 f32 flops on the CUDA cores (~0.02 ms): 0.285 ms.
// The saving variant also writes OUT, 2 * B * T * 2F * 2 bytes = 0.66 GB,
// ~0.20 ms at 3.35 TB/s. Both are bound by tensor-core operations.
//
// Design. An implicit GEMM, wgmma.mma_async m64n40k16 .bf16 with both
// operands in shared memory: 20 channels (40 columns, re/im interleaved
// so that S forms in registers) per block; taps padded 401 -> 416 (26
// k-steps, rows 401..415 zero). The kernel this design replaced had the
// f32 kernel's schedule; a split of its time on the card with clock64()
// stamps (PERF.md §6; cycles per block, primal / saving) gave products
// 44.5 / 35.0 % (one wait per k-step), the fold 43.2 / 35.7 % (latency:
// a warp walked ~5 items one after another, each ending in a 5-step
// shuffle chain), OUT's 2-byte stores 21.0 % of the saving variant, the
// per-block prologue 5.6 / 4.6 %. The redesign, step by step:
//  - Products kept in flight. A tile's 26 k-steps are issued back to
//    back and waited for once, in two groups of 13 with an accumulator
//    each (the first k-step of a group with scale-d 0, so no zeroing);
//    the two f32 sums are added once: the accumulator flush every 13
//    k-steps (208 taps) is kept. A comes from shared memory: the Hankel
//    tile A[t, j] = xs[t + j] of a chunk is 8 x 8 core matrices H_d[r][s]
//    = xs[8 d + r + s], and core matrix (a, c) of a tile is H_{a + c}, so
//    one 10.6 KB buffer with both descriptor strides at 128 bytes is the
//    whole A. (A from registers needs the 27 pairs of a group in flight:
//    with two accumulators and the fold beside them that spilled at 128
//    registers, and ptxas serialized the wgmmas, C7520.) Alone on an SM,
//    this wgmma takes 25.8 cycles (3.3 KB of operands at 128 bytes per
//    cycle; with A from registers 20.1), PERF.md §6.
//  - The CUDA-core work beside the products, as far as it pays: a fifth
//    warpgroup (the helpers) stages slot n + 2's waveform, builds slot
//    n + 1's Hankel matrices, stores slot n - 1's OUT and the out of a
//    finished item while the four product warpgroups run slot n. The
//    fold of slot n - 1 does not pay there: its shared-memory reads and
//    the wgmmas' operand reads slowed each other (the products' phase
//    took 6 800 cycles per chunk beside it, ~4 500 without it), so the
//    product warpgroups fold after their own products, a channel per
//    warp at a time, each lane summing its 8 positions per frame in
//    order and a 5-step butterfly adding the lanes; one writer per
//    (frame, channel) and chunk, chunks in order, so the result is
//    deterministic. S, OUT, the Hankel matrices and the waveform are
//    double-buffered in shared memory: one barrier per chunk.
//  - A persistent grid: one block per SM, blocks split evenly over the
//    channel groups; a block stages its group's bank and windows once
//    and walks its items (batch row, frame block) j = blockIdx.x,
//    blockIdx.x + gridDim.x, ... as one stream of chunks, an item's
//    first chunk following the last one of the item before.
//  - The saving variant stages each chunk's OUT tile in shared memory
//    (bf16, [column][position], 20 KB, double-buffered) and the helpers
//    store each column's owned positions with one cp.async.bulk copy
//    (16-byte aligned runs when T % 8 == 0, else 2-byte stores), waited
//    for (.read) only before the buffer is written again.
//  - Not taken: 40 channels per block (m64n80k16) would halve the A
//    reads per flop, but its bank (67 KB), windows (65 KB) and
//    double-buffered S (84 KB) do not fit a block's 227 KB.
//  - Ownership and tiles as the f32 kernel's: an item owns (batch row, up
//    to 25 frames, 20 channels), walks its S span (160 (frames - 1) + 404
//    positions from 160 f0 - 200) in 256-position chunks of four
//    64-position tiles, skips tiles that cannot hold a nonzero S, and
//    stores only the OUT positions it owns, [160 f0, 160 (f0 + frames per
//    item)) within [0, T): each once. tests/test_torch_port_fwd_schedule.py
//    replays the grid, the walk, its buffers, the fold and the stores.
//  - 640 threads; shared memory 133 KB primal, 175 KB saving.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

// bf16 pairs (lds_pair, pair_sel), wgmma_bf16, bulk copies, and
// hopper_tf32.cuh's smem_u32, lds, cp_async16, b_desc_of, fence_acc
#include "hopper_bf16.cuh"

namespace {

constexpr int kTaps = 401;
constexpr int kHop = 160;
constexpr int kPadL = 200;
constexpr int kK = 416;                    // taps padded to k-steps of 16
constexpr int kKSteps = kK / 16;           // 26
constexpr int kGroupSteps = 13;            // k-steps per product group and flush
constexpr int kChans = 20;                 // channels per block
constexpr int kN = 2 * kChans;             // bank columns, re/im interleaved
constexpr int kAcc = kN / 2;               // accumulator registers per tile
constexpr int kWarpgroups = 4;            // on the tensor cores
constexpr int kHelpers = 128;              // one warpgroup on the CUDA cores
constexpr int kHelperWarps = kHelpers / 32;
constexpr int kThreads = 128 * kWarpgroups + kHelpers;
constexpr int kWgSpan = 64;                // positions per warpgroup and chunk
constexpr int kChunk = kWgSpan * kWarpgroups;  // 256 positions
constexpr int kXsLen = kChunk + kK + 8;    // waveform samples a chunk stages
// Hankel core matrices of a chunk: H_d[r][s] = xs[8 d + r + s] (8 x 8
// bf16, 128 bytes) for d < kChunk / 8 + kK / 8 - 1
constexpr int kHankel = kChunk / 8 + kK / 8 - 1;   // 83
constexpr int kMaxFrames = 25;             // output frames per item, at most
constexpr int kWinLen = 404;               // window row; taps 401..403 zero
constexpr int kFoldFrames = 5;             // frames whose windows meet a chunk
constexpr int kSsPitch = kChunk + 8;       // S row pitch: conflict-free writes
constexpr int kOutPitch = kChunk + 8;      // OUT tile row (bf16), 528 bytes
constexpr int kSlabBytes = kN * 16 + 16;   // 8 taps of B, padded
constexpr int kBBytes = (kK / 8) * kSlabBytes;
constexpr int kBankBatch = 8;              // global loads in flight per thread
constexpr size_t kXsBytes = 2 * sizeof(uint16_t) * kXsLen;  // double buffer
constexpr size_t kHsBytes = 2 * 128 * kHankel;              // double buffer
constexpr size_t kSsBytes = 2 * sizeof(float) * kChans * kSsPitch;  // double
constexpr size_t kWsBytes = sizeof(float) * kChans * kWinLen;
constexpr size_t kSumBytes = 2 * sizeof(float) * kMaxFrames * kChans;  // double
constexpr size_t kOsBytes = 2 * sizeof(uint16_t) * kN * kOutPitch;  // double

constexpr size_t smem_bytes(bool save) {
  return kBBytes + kXsBytes + kHsBytes + kSsBytes + kWsBytes + kSumBytes
         + (save ? kOsBytes : 0);
}

static_assert(kKSteps % kGroupSteps == 0, "groups split the k-steps evenly");
static_assert(kXsLen % 8 == 0 && kChunk % 8 == 0, "16-byte waveform pieces");
static_assert(8 * kHankel + 8 <= kXsLen, "the Hankel rows read staged samples");
static_assert(kBBytes % 16 == 0 && kSlabBytes % 16 == 0,
              "wgmma descriptors address 16-byte units");
static_assert(kHsBytes % 128 == 0 && kBBytes % 16 == 0 && kXsBytes % 16 == 0
              && kSsBytes % 16 == 0 && kWsBytes % 16 == 0 && kSumBytes % 16 == 0,
              "128-byte aligned Hankel matrices and bank, 16-byte aligned rest");
static_assert(kSsPitch % 4 == 0 && kWinLen % 4 == 0 && kHop % 4 == 0
              && kWinLen >= kTaps, "16-byte fold reads");
static_assert((kChunk + kWinLen - 1) / kHop + 1 <= kFoldFrames,
              "frames that meet a chunk");
static_assert(kChunk == 2 * 4 * 32, "the fold: 2 x 4 positions per lane");
static_assert(kHelpers % 8 == 0, "a helper's Hankel rows share r = thread % 8");
static_assert((2 * kOutPitch) % 16 == 0, "bulk stores read 16-byte aligned rows");
static_assert(smem_bytes(true) <= 232448, "fits a block");

// An item: frame block fx of batch row b, as the per-item grid had it
// (a row's frames split evenly over the fewest blocks of <= kMaxFrames).
struct Item {
  int b, f0, frames;   // batch row, first frame, frames
  int s_lo;            // first S position its windows read
  int q_lo, q_hi;      // S positions (from s_lo) that can be nonzero
  int ch_lo, ch_hi;    // their chunks (of kChunk positions)
  int own_lo, own_hi;  // conv positions it stores (kSave): its hops in [0, T)
};

__device__ __forceinline__ Item item_at(int j, int n_fblocks, int per,
                                        int n_frames, int T) {
  Item it;
  it.b = j / n_fblocks;
  it.f0 = (j % n_fblocks) * per;
  it.frames = min(per, n_frames - it.f0);
  it.s_lo = it.f0 * kHop - kPadL;
  it.q_lo = max(0, -it.s_lo);
  it.q_hi = min(kHop * (it.frames - 1) + kWinLen, T - it.s_lo);
  it.ch_lo = it.q_lo / kChunk;
  it.ch_hi = (it.q_hi + kChunk - 1) / kChunk;
  it.own_lo = it.f0 * kHop;
  it.own_hi = min((it.f0 + per) * kHop, T);
  return it;
}

// A chunk of the block's walk: chunk ch of item j (j >= n_items: none)
struct Slot {
  int j, ch;
};

template <bool kSave>
__global__ void __launch_bounds__(kThreads, 1)
fused_fwd_bf16_kernel(const uint16_t* __restrict__ x,       // (B, T) bf16
                      const uint16_t* __restrict__ gabor,   // (401, 2F) bf16 [re | im]
                      const float* __restrict__ windows,    // (F, 401)
                      float* __restrict__ out,              // (B, n_frames, F)
                      uint16_t* __restrict__ conv_out,      // (B, 2F, T) bf16, kSave only
                      int batch, int T, int F, int n_frames,
                      int frames_per_block, int x_aligned, int out_bulk) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* at = smem;
  uint8_t* hs = at;  at += kHsBytes;                 // [2][kHankel][8][8] bf16
  uint16_t* bs = reinterpret_cast<uint16_t*>(at);  at += kBBytes;
  uint16_t* xraw = reinterpret_cast<uint16_t*>(at);  at += kXsBytes;  // [2][kXsLen]
  float* ss = reinterpret_cast<float*>(at);  at += kSsBytes;    // [2][c][pos]
  float* ws = reinterpret_cast<float*>(at);  at += kWsBytes;    // [c][tap]
  float* sums = reinterpret_cast<float*>(at);  at += kSumBytes;  // [2][frame][c]
  uint16_t* os = reinterpret_cast<uint16_t*>(at);  // [2][column][pos], kSave only

  const int tid = threadIdx.x;
  const int wg = tid >> 7;                  // 0..3: products; 4: helpers
  const bool helper = wg == kWarpgroups;    // warpgroup-uniform
  const int ht = tid - 128 * kWarpgroups;   // helper thread, if helper
  const int lane = tid & 31;
  const int c0 = blockIdx.y * kChans;
  const int n_live = min(kChans, F - c0);
  const int per = frames_per_block;
  const int n_fblocks = (n_frames + per - 1) / per;
  const int n_items = batch * n_fblocks;
  auto item = [&](int j) { return item_at(j, n_fblocks, per, n_frames, T); };
  // the slot after `s` in the walk: the item's next chunk, or the next
  // item's first
  auto next_slot = [&](Slot s) {
    if (s.j < n_items) {
      if (s.ch + 1 < item(s.j).ch_hi) return Slot{s.j, s.ch + 1};
      s.j += gridDim.x;
      if (s.j < n_items) return Slot{s.j, item(s.j).ch_lo};
    }
    return Slot{n_items, 0};
  };

  // Helpers: the waveform of slot s (xs[k] = xpad[s_lo + ch * kChunk +
  // k]) into half `buf` of the double buffer: one cp.async group, or
  // 2-byte loads
  auto stage_x = [&](Slot s, int buf) {
    const Item it = item(s.j);
    const uint16_t* xb = x + (size_t)it.b * T;
    const int t0 = it.s_lo - kPadL + s.ch * kChunk;  // a multiple of 8
    uint16_t* dst = xraw + buf * kXsLen;
    if (x_aligned) {  // each 16-byte piece lies inside or outside [0, T)
      const uint32_t d = smem_u32(dst);
      for (int i = ht; i < kXsLen / 8; i += kHelpers) {
        const int t = t0 + 8 * i;
        const bool live = t >= 0 && t < T;
        cp_async16(d + 16 * i, reinterpret_cast<const float*>(live ? xb + t : xb),
                   live);
      }
    } else {
      for (int i = ht; i < kXsLen; i += kHelpers) {
        const int t = t0 + i;
        dst[i] = t >= 0 && t < T ? __ldg(xb + t) : (uint16_t)0;
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  // Helpers: the Hankel core matrices of half `buf`'s waveform into half
  // `buf` of hs: row (d, r) = xs[8 d + r .. 8 d + r + 7], from five
  // 32-bit words (a funnel shift when r is odd); helper ht takes the
  // rows with r = ht % 8, two at a time.
  auto build_hankel = [&](int buf) {
    const uint32_t xw = smem_u32(xraw + buf * kXsLen);
    const uint32_t hw = smem_u32(hs + buf * (kHsBytes / 2));
    const int shift = 16 * (ht & 1);
#pragma unroll 2
    for (int i = ht; i < 8 * kHankel; i += kHelpers) {
      const uint32_t w = xw + 4 * (4 * (i >> 3) + ((i & 7) >> 1));
      uint32_t v[5];
#pragma unroll
      for (int k = 0; k < 5; ++k) v[k] = lds(w + 4 * k);
      uint32_t o[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) o[k] = __funnelshift_r(v[k], v[k + 1], shift);
      asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
                   :: "r"(hw + 16 * i), "r"(o[0]), "r"(o[1]), "r"(o[2]),
                      "r"(o[3]) : "memory");
    }
  };

  Slot cur{(int)blockIdx.x, item(blockIdx.x).ch_lo};  // blockIdx.x < n_items
  Slot nx1 = next_slot(cur);
  Slot nx2 = next_slot(nx1);
  if (helper) {
    stage_x(cur, 0);
    if (nx1.j < n_items) stage_x(nx1, 1);
  }

  // The bank (K-major, interleaved columns, zero past tap 401 and past
  // channel F), the windows (zero past tap 401) and the sums, once for
  // all the block's items, by all threads.
  for (int i0 = tid; i0 < kK * kN; i0 += kThreads * kBankBatch) {
    uint16_t v[kBankBatch];
#pragma unroll
    for (int u = 0; u < kBankBatch; ++u) {
      const int i = i0 + u * kThreads, j = i / kN, c = (i % kN) >> 1;
      v[u] = i < kK * kN && j < kTaps && c < n_live
                 ? __ldg(gabor + (size_t)j * 2 * F + (i & 1) * F + c0 + c)
                 : (uint16_t)0;
    }
#pragma unroll
    for (int u = 0; u < kBankBatch; ++u) {
      const int i = i0 + u * kThreads, j = i / kN, n = i % kN;
      if (i < kK * kN) bs[(j >> 3) * (kSlabBytes / 2) + 8 * n + (j & 7)] = v[u];
    }
  }
  for (int i0 = tid; i0 < kChans * kWinLen; i0 += kThreads * kBankBatch) {
    float v[kBankBatch];
#pragma unroll
    for (int u = 0; u < kBankBatch; ++u) {
      const int i = i0 + u * kThreads, c = i / kWinLen, k = i % kWinLen;
      v[u] = i < kChans * kWinLen && c < n_live && k < kTaps
                 ? __ldg(windows + (size_t)(c0 + c) * kTaps + k) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kBankBatch; ++u)
      if (i0 + u * kThreads < kChans * kWinLen) ws[i0 + u * kThreads] = v[u];
  }
  for (int i = tid; i < 2 * kMaxFrames * kChans; i += kThreads) sums[i] = 0.f;
  if (helper) {
    if (nx1.j < n_items) {
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
  }
  __syncthreads();
  if (helper) build_hankel(0);
  fence_proxy_async();  // the bank's and the Hankel's stores -> wgmma

  // Products: the bank's descriptor (start >> 4 | K-direction stride >>
  // 4; b_desc_of adds the N-direction stride, 128 bytes) and this
  // warpgroup's Hankel A in half 0: core matrix (a, c) of its tile is
  // H_{8 wg + a + c}, 128 bytes per step in either direction
  const uint32_t dbase = ((smem_u32(bs) & 0x3FFFF) >> 4) | ((kSlabBytes >> 4) << 16);
  const uint32_t abase = (((smem_u32(hs) + 128 * 8 * wg) & 0x3FFFF) >> 4)
                         | ((128 >> 4) << 16);
  // Helpers: OUT column n (re of channel n / 2 for even n, else im) is
  // stored by lane n / 4 of helper warp n % 4
  const int hwarp = ht >> 5;
  const int bulk_col = 4 * lane + hwarp;
  const bool bulk_lane = kSave && out_bulk && helper && bulk_col < 2 * n_live;

  // Fold slot s's S (half `sb`) into its item's window sums: (frame fl,
  // channel c) adds win[c, q - 160 fl] * S[q] over the chunk's q. Warp fw
  // of nfw takes channels fw, fw + nfw, ...; lane l the positions
  // q0 + 4 l + 128 h + 0..3 (h = 0, 1: conflict-free 16-byte reads),
  // whose S it reads once and whose window offsets o = q - 160 fl are
  // multiples of 4: per frame, the lane's eight products in order, then
  // a 5-step butterfly, and lane 0 adds the frame's sum. One writer per
  // (frame, channel) and chunk, chunks in order: deterministic.
  auto fold = [&](Slot s, int sb, int fw, int nfw) {
    const Item it = item(s.j);
    const int q0 = s.ch * kChunk;
    const int fa = q0 >= kWinLen ? (q0 - kWinLen) / kHop + 1 : 0;
    const int nf = min(it.frames - 1, (q0 + kChunk - 1) / kHop) - fa + 1;
    float* sum_it = sums + ((s.j / gridDim.x) & 1) * (kMaxFrames * kChans)
                    + fa * kChans;
    const int o0 = q0 + 4 * lane - kHop * fa;
    for (int c = fw; c < n_live; c += nfw) {
      const float* srow = ss + sb * (kChans * kSsPitch) + c * kSsPitch + 4 * lane;
      const float4 s0 = *reinterpret_cast<const float4*>(srow);
      const float4 s1 = *reinterpret_cast<const float4*>(srow + kChunk / 2);
      const float* wrow = ws + c * kWinLen;
      float part[kFoldFrames];
#pragma unroll
      for (int k = 0; k < kFoldFrames; ++k) {
        const int o = o0 - kHop * k, o1 = o + kChunk / 2;
        float p = 0.f;
        if (k < nf && o >= 0 && o <= kWinLen - 4) {
          const float4 w = *reinterpret_cast<const float4*>(wrow + o);
          p = fmaf(w.x, s0.x, p);
          p = fmaf(w.y, s0.y, p);
          p = fmaf(w.z, s0.z, p);
          p = fmaf(w.w, s0.w, p);
        }
        if (k < nf && o1 >= 0 && o1 <= kWinLen - 4) {
          const float4 w = *reinterpret_cast<const float4*>(wrow + o1);
          p = fmaf(w.x, s1.x, p);
          p = fmaf(w.y, s1.y, p);
          p = fmaf(w.z, s1.z, p);
          p = fmaf(w.w, s1.w, p);
        }
        part[k] = p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int k = 0; k < kFoldFrames; ++k)
          part[k] += __shfl_xor_sync(0xffffffffu, part[k], off);
      }
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < kFoldFrames; ++k)
          if (k < nf) sum_it[k * kChans + c] += part[k];
      }
    }
  };

  // Helpers: store the owned OUT positions of slot s from its tile (half
  // `sb`): one bulk copy per column of 16-byte runs, or, when T % 8 != 0,
  // 2-byte stores.
  auto store_out = [&](Slot s, int sb) {
    const Item it = item(s.j);
    const int t0 = it.s_lo + s.ch * kChunk;
    const int lo = max(it.own_lo, t0), hi = min(it.own_hi, t0 + kChunk);
    if (lo >= hi) return;
    const uint16_t* tile = os + sb * (kN * kOutPitch) + (lo - t0);
    uint16_t* row = conv_out + ((size_t)it.b * 2 * F + c0) * T + lo;
    if (out_bulk) {
      if (bulk_lane) {
        bulk_store(row + ((size_t)(bulk_col & 1) * F + (bulk_col >> 1)) * T,
                   smem_u32(tile + bulk_col * kOutPitch), 2 * (hi - lo));
        bulk_commit();
      }
    } else {
      const int len = hi - lo;
      for (int i = ht; i < 2 * n_live * len; i += kHelpers) {
        const int n = i / len, t = i % len;
        row[((size_t)(n & 1) * F + (n >> 1)) * T + t] = tile[n * kOutPitch + t];
      }
    }
  };

  // Helpers: item j's out from its sums, which are zeroed for the item
  // after next (each helper its own entries; a barrier orders them before
  // that item's folds)
  auto store_sums = [&](int j) {
    const Item it = item(j);
    float* sum_it = sums + ((j / gridDim.x) & 1) * (kMaxFrames * kChans);
    for (int i = ht; i < it.frames * kChans; i += kHelpers) {
      const int c = i % kChans;
      if (c < n_live)
        out[((size_t)it.b * n_frames + it.f0 + i / kChans) * F + c0 + c] = sum_it[i];
      sum_it[i] = 0.f;
    }
  };

  // The walk, one barrier per slot. Iteration n: the four product
  // warpgroups run slot n's products from Hankel half n & 1, two groups
  // of 13 k-steps issued back to back and waited for once, write its S
  // and OUT tiles to half n & 1, and then fold slot n - 1's S (half
  // n + 1 & 1); meanwhile the helpers stage slot n + 2's waveform (into
  // the half slot n's left), store the out of an item whose last fold
  // ran one iteration ago, store slot n - 1's OUT, and build slot n + 1's
  // Hankel matrices (half n + 1 & 1).
  Slot prev{n_items, 0};
  int done = -1;  // an item whose sums are complete, to store
  int n = 0;
  for (; cur.j < n_items; ++n) {
    const int buf = n & 1;
    if (helper) {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");  // slot n + 1's
      if (bulk_lane) bulk_wait_read();  // half buf's OUT tile is free
    }
    // slot n's Hankel matrices, slot n + 1's waveform and slot n - 1's S
    // and OUT tiles are written; the reads of half buf's waveform, S and
    // OUT are done
    __syncthreads();
    if (helper) {
      if (nx2.j < n_items) stage_x(nx2, buf);
      if (done >= 0) store_sums(done);
      if (kSave && prev.j < n_items) store_out(prev, buf ^ 1);
      if (nx1.j < n_items) build_hankel(buf ^ 1);
      fence_proxy_async();  // the Hankel matrices -> wgmma
    } else {
      const Item it = item(cur.j);
      const int q0 = cur.ch * kChunk;
      const int wq = q0 + kWgSpan * wg;  // this warpgroup's first position
      // warpgroup-uniform: the tile holds a position that can be nonzero
      const bool live = wq < it.q_hi && wq + kWgSpan > it.q_lo;
      float acc0[kAcc], acc1[kAcc];
      if (live) {
        // k-step q reads taps 16q..16q+15: two slabs of B, two Hankel
        // matrices on; each group of 13 sums into its own accumulator,
        // its first k-step with scale-d 0
        auto desc = [&](int q) {
          return b_desc_of(abase + buf * (kHsBytes / 2 >> 4) + 2 * q * (128 >> 4));
        };
        fence_acc(acc0);
        fence_acc(acc1);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll  // rolled, ptxas serializes the wgmmas
        for (int q = 0; q < kGroupSteps; ++q)
          wgmma_bf16_ss(acc0, desc(q), b_desc_of(dbase + 2 * q * (kSlabBytes >> 4)),
                        q != 0);
#pragma unroll
        for (int q = kGroupSteps; q < kKSteps; ++q)
          wgmma_bf16_ss(acc1, desc(q), b_desc_of(dbase + 2 * q * (kSlabBytes >> 4)),
                        q != kGroupSteps);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        fence_acc(acc0);
        fence_acc(acc1);
      } else {
#pragma unroll
        for (int i = 0; i < kAcc; ++i) acc0[i] = acc1[i] = 0.f;
      }

      // accumulator entry 4 j + 2 h + e: position r (below), column
      // 8 j + 2 tig + e = re (e = 0) or im (e = 1) of channel 4 j + tig
      const int warp = (tid >> 5) & 3, gid = lane >> 2, tig = lane & 3;
      float* sbuf = ss + buf * (kChans * kSsPitch);
      uint16_t* obuf = os + buf * (kN * kOutPitch);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = kWgSpan * wg + 16 * warp + gid + 8 * h;
        const int t = it.s_lo + q0 + r;
        const bool valid = live && t >= 0 && t < T;  // lowpass SAME padding
#pragma unroll
        for (int jj = 0; jj < kAcc / 4; ++jj) {
          // the flush: the two groups' f32 sums added once
          const float re = acc0[4 * jj + 2 * h] + acc1[4 * jj + 2 * h];
          const float im = acc0[4 * jj + 2 * h + 1] + acc1[4 * jj + 2 * h + 1];
          sbuf[(4 * jj + tig) * kSsPitch + r] = valid ? re * re + im * im : 0.f;
          if (kSave) {
            obuf[(8 * jj + 2 * tig) * kOutPitch + r] = float_to_bf16(re);
            obuf[(8 * jj + 2 * tig + 1) * kOutPitch + r] = float_to_bf16(im);
          }
        }
      }
      if (kSave) fence_proxy_async();  // the OUT tile -> the bulk copies
      // then slot n - 1's fold, out of the products' way
      if (prev.j < n_items) fold(prev, buf ^ 1, tid >> 5, 4 * kWarpgroups);
    }
    // slot n - 1 was its item's last: its sums are complete after the
    // next barrier
    done = prev.j < n_items && prev.j != cur.j ? prev.j : -1;
    prev = cur;
    cur = nx1;
    nx1 = nx2;
    nx2 = next_slot(nx2);
  }

  // the last slot's stores and fold, and the last two items' out
  __syncthreads();
  if (helper) {
    if (done >= 0) store_sums(done);
    if (kSave) store_out(prev, (n & 1) ^ 1);
    fold(prev, (n & 1) ^ 1, hwarp, kHelperWarps);
  }
  __syncthreads();
  if (helper) {
    store_sums(prev.j);
    if (bulk_lane) bulk_wait();
  }
}

}  // namespace

// Launch the primal (conv_out == nullptr) or the residual-saving kernel on
// `stream`. x, gabor and conv_out are device pointers to contiguous bf16
// arrays, windows and out to f32 ones, of the shapes noted on the kernel;
// the caller checks them. Returns the CUDA error code of the launch.
template <bool kSave>
static int launch_fwd(const void* x, const void* gabor, const void* windows,
                      void* out, void* conv_out, int batch, int T, int F,
                      int n_frames, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_fwd_bf16_kernel<kSave>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes(kSave));
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  // a row's frames split evenly over the fewest items of <= kMaxFrames
  const int n_fb = (n_frames + kMaxFrames - 1) / kMaxFrames;
  const int per = (n_frames + n_fb - 1) / n_fb;
  const int groups = (F + kChans - 1) / kChans;
  // one block per SM, each channel group's items over sms / groups blocks
  const long long items = (long long)batch * n_fb;
  const int per_group = (int)std::min<long long>(items, std::max(1, sms / groups));
  const int x_aligned = T % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int out_bulk = T % 8 == 0 && reinterpret_cast<uintptr_t>(conv_out) % 16 == 0;
  fused_fwd_bf16_kernel<kSave><<<dim3(per_group, groups), kThreads,
                                 smem_bytes(kSave), (cudaStream_t)stream>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(gabor),
      static_cast<const float*>(windows), static_cast<float*>(out),
      static_cast<uint16_t*>(conv_out), batch, T, F, n_frames, per, x_aligned,
      out_bulk);
  return (int)cudaGetLastError();
}

extern "C" int leaf_fused_fwd_bf16(const void* x, const void* gabor,
                                   const void* windows, void* out, int batch,
                                   int T, int F, int n_frames, void* stream) {
  return launch_fwd<false>(x, gabor, windows, out, nullptr, batch, T, F,
                           n_frames, stream);
}

// As leaf_fused_fwd_bf16, and also writes conv_out (B, 2F, T) in bf16.
extern "C" int leaf_fused_fwd_save_bf16(const void* x, const void* gabor,
                                        const void* windows, void* out,
                                        void* conv_out, int batch, int T, int F,
                                        int n_frames, void* stream) {
  return launch_fwd<true>(x, gabor, windows, out, conv_out, batch, T, F,
                          n_frames, stream);
}
