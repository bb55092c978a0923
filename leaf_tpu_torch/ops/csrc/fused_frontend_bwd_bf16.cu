// Fused Gabor conv -> squared modulus -> Gaussian lowpass, backward, on
// Hopper's tensor cores in bf16 (x and OUT bf16, windows and dY f32, f32
// sums; the wrapper rounds d_bank to bf16).
//
// Replaces leaf_tpu/ops/fused_frontend.py:_bwd_kernel under bf16 compute,
// with the XLA glue around it (_fused_bwd's cotangent gather,
// _group_cotangent, _build_bwd_selectors, _fold_bwd_windows,
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
// every product of bf16 values and every sum in f32. The waveform
// gradient is zero by the op's contract and is not computed.
//
// Bound. d_bank is a GEMM, M = 401 taps x N = 2F columns x K = B*T
// positions: 2 * B * T * 2F * 401 = 2.63e11 flops at B=256, T=16000,
// F=40, 0.27 ms at the H100's dense bf16 rate of 989 TFLOP/s (0.30 ms
// with the taps padded to 7 tiles of 64); dS, dOUT and d_win add ~3e9
// f32 flops on the CUDA cores (~0.04 ms). It reads ~0.67 GB (OUT, x,
// dY), ~0.20 ms at 3.35 TB/s: bound by tensor-core operations.
//
// Design: fused_frontend_bwd.cu's (one block per SM over a contiguous
// run of (batch row, 32-position chunk) pairs; three consumer warpgroups
// holding the 7 tap tiles of 64 in f32 accumulators, one producer
// warpgroup; a ring of 3 stages with full/empty mbarriers; accumulators
// flushed into the block's partial every 64 chunks; deterministic
// split-K), with bf16 operands:
//  - wgmma.mma_async m64n80k16 .bf16: 2 k-steps of 16 positions per chunk
//    and tile, one product each, where 3xTF32 issues 3 per k-step of 8.
//  - A, the Hankel waveform tile A[j, k] = xpad[t0 + k + j], from
//    registers: pairs at xs[p + 16q], xs[p + 16q + 8] (a1 = a2) and
//    xs[p + 16q + 16], p = tile row + 16 w + g + 2 i; k-step 1's a0 is
//    k-step 0's a3. lds_pair reads the pairs that straddle a word.
//  - B, the dOUT chunk in bf16, K-major, unswizzled: slabs of 8
//    positions 1296 bytes apart (80 columns x 16 bytes + 16).
//  - The producer stages, one chunk ahead, the bf16 OUT rows (8-byte
//    cp.async), the bf16 waveform span (16-byte cp.async) and the f32 dY
//    rows (4-byte cp.async) when T % 8 == 0 and x and OUT are 16-byte
//    aligned, else the bf16 values with 2-byte loads. It forms S and dS
//    in f32 from bf16 values (dY and the windows rounded to bf16, the
//    windows once as they are staged), adds bf16(dY) * bf16(S) into the
//    d_windows sums, and writes bf16(2 OUT dS) and the waveform span
//    into the ring.

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
// Chunks between two flushes of the tensor-core accumulators into the
// block's partial (f32 adds, rounded to nearest), as in the f32 kernel.
constexpr int kFlushChunks = 64;
constexpr int kGroup = 2;                  // producer channels per batch of reads
// registers per thread (setmaxnreg), from 128 at entry: the 3-tile
// consumers, the 1-tile consumer, the producer (the f32 kernel's split)
constexpr int kRegs3 = 176, kRegs1 = 96, kRegsProducer = 64;
constexpr int kStages = 3;
// span + halo of a chunk (kChunk + 448 taps) and the pairs read past it,
// in bf16: 16-byte pieces of 8, one per producer thread of the first 64
constexpr int kXsLen = 512;
constexpr int kXsThreads = kXsLen / 8;
constexpr int kSlabBytes = kN * 16 + 16;   // 8 positions of B, padded
constexpr int kBBytes = (kChunk / 8) * kSlabBytes;
constexpr int kStageBytes = kBBytes + 2 * kXsLen;  // B, xs
constexpr int kWinFloats = kChans * kTaps;
constexpr int kProducerThreads = 128;
constexpr int kConsumerThreads = 128 * kConsumers;
constexpr int kThreads = kConsumerThreads + kProducerThreads;
constexpr unsigned kSpinLimit = 1u << 22;  // a lost arrival traps, never hangs

static_assert(kXsLen >= kChunk + 64 * kTiles + 8 && kXsThreads <= kProducerThreads,
              "one 16-byte piece per producer thread");
static_assert(kStageBytes % 16 == 0 && kBBytes % 16 == 0,
              "stages and their waveform spans stay 16-byte aligned");
static_assert(kSlabBytes % 16 == 0, "wgmma descriptors address 16-byte units");

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

// A consumer warpgroup: tiles [tile0, tile0 + kMine) of d_bank over the
// block's chunks, flushed (rows < 401) into the block's partial every
// kFlushChunks chunks and after the last.
template <int kMine>
__device__ __forceinline__ void consume(const Ring& ring, int n_chunks,
                                        int tile0, float* __restrict__ db) {
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int p0 = 64 * tile0 + 16 * warp + gid + 2 * tig;

  float acc[kMine][kAcc];
#pragma unroll
  for (int m = 0; m < kMine; ++m) {
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[m][i] = 0.f;
  }

  // 32-bit shared addresses: one base register per operand, the rest
  // are immediate offsets. The pair's parity is gid's in every stage.
  const uint32_t ring_u32 = smem_u32(ring.stages);
  const uint32_t sel = pair_sel(ring_u32 + kBBytes + 2 * p0);
  for (int it = 0; it < n_chunks; ++it) {
    const int s = it % kStages;
    mbar_wait(&ring.full[s], (it / kStages) & 1);
    __syncwarp();  // the warpgroup is converged for wgmma
    const uint32_t st = ring_u32 + s * kStageBytes;
    const uint32_t xw = (st + kBBytes + 2 * p0) & ~3u;  // &xs[p0], a word
    const uint32_t dlo = ((st & 0x3FFFF) >> 4) | ((kSlabBytes >> 4) << 16);

    // A fragment of k-step q: pairs at {xs[p + 16q], xs[p + 16q + 8],
    // xs[p + 16q + 8], xs[p + 16q + 16]}; k-step 1 takes a3 -> a0 and
    // loads its two new pairs.
    uint32_t a[kMine][4];
#pragma unroll
    for (int m = 0; m < kMine; ++m) a[m][0] = lds_pair(xw + 128 * m, sel);
#pragma unroll 1  // as the f32 kernel's: unrolled, the wgmmas may serialize
    for (int q = 0; q < kKSteps; ++q) {
#pragma unroll
      for (int m = 0; m < kMine; ++m) {
        const uint32_t w = xw + 128 * m + 32 * q;
        if (q > 0) a[m][0] = a[m][3];
        a[m][1] = a[m][2] = lds_pair(w + 16, sel);
        a[m][3] = lds_pair(w + 32, sel);
      }
      // k-step q reads positions 16q..16q+15: two slabs on
      const uint64_t desc = b_desc_of(dlo + 2 * q * (kSlabBytes >> 4));
#pragma unroll
      for (int m = 0; m < kMine; ++m) fence_acc(acc[m]);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int m = 0; m < kMine; ++m) wgmma_bf16(acc[m], a[m], desc);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
      for (int m = 0; m < kMine; ++m) fence_acc(acc[m]);
    }
    mbar_arrive(&ring.empty[s]);
    if ((it + 1) % kFlushChunks == 0 || it + 1 == n_chunks) {
      // accumulator (i, h, e) of tile m: row 16 w + g + 8 h, column
      // 8 i + 2 tig + e; each thread owns its entries of the partial
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
}

__device__ __forceinline__ void producer_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kProducerThreads) : "memory");
}

// What the producer stages for one chunk, one chunk ahead: the bf16 OUT
// rows of its 40 channels (re 0..39 | im 40..79, 32 positions each; warp
// w copies and reads the 20 rows of channels w + 4 r), the bf16 waveform
// span xpad[t0 .. t0 + 512) (thread i < 64 copies and reads 8i .. 8i + 7)
// and, per warp, f32 dY of the <= 4 frames that meet the chunk for the
// warp's 10 channels. A warp reads its rows after a __syncwarp.
struct Staged {
  uint16_t out[kN][kChunk];
  uint16_t x[kXsLen];
  float dy[4][4][kChans / 4];  // [warp][frame - f_lo][r]
};
static_assert(sizeof(Staged) % 16 == 0 && offsetof(Staged, x) % 16 == 0,
              "16-byte cp.async into both Staged slots");

__device__ __forceinline__ int first_frame(int t) {  // first frame over t
  return t > kPadL ? (t - kPadL + kHop - 1) / kHop : 0;
}

// A lane's copies, fixed for the block: rows j = 4 k + lane / 8 of its
// warp's 20 (8 lanes of 4 positions per row), and dY entries lane and
// lane + 32 of the warp's 40 (frame i / 10, channel w + 4 (i % 10)).
struct CopyPlan {
  int row_off[5];     // OUT offset of row j: ((j / 10) F + c0 + w + 4 (j % 10)) T
  int row_dst[5];     // its element offset in Staged::out
  unsigned row_live;  // bit k: row k's channel is < n_live
  int dy_dst[2], dy_off[2];
  unsigned dy_live;   // bit e: entry e exists and its channel is < n_live
  int dy_fr[2];
};

__device__ __forceinline__ CopyPlan copy_plan(int warp, int lane, int T,
                                              int F, int c0, int n_live) {
  CopyPlan pl;
  pl.row_live = pl.dy_live = 0;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const int j = 4 * k + lane / 8, c = warp + 4 * (j % 10), h = j / 10;
    pl.row_off[k] = (h * F + c0 + c) * T;
    pl.row_dst[k] = (h * kChans + c) * kChunk + 4 * (lane & 7);
    if (c < n_live) pl.row_live |= 1u << k;
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int i = lane + 32 * e, fr = i / (kChans / 4), r = i % (kChans / 4);
    pl.dy_fr[e] = fr;
    pl.dy_dst[e] = (warp * 4 + fr) * (kChans / 4) + r;
    pl.dy_off[e] = c0 + warp + 4 * r;
    if (i < kChans && warp + 4 * r < n_live) pl.dy_live |= 1u << e;
  }
  return pl;
}

__device__ __forceinline__ void stage_chunk(
    Staged& sg, const CopyPlan& pl, const uint16_t* __restrict__ xb,
    const uint16_t* __restrict__ ob, const float* __restrict__ dyb, int t0,
    int T, int F, int n_frames, bool aligned, int tid) {
  const int lane = tid & 31;
  const uint32_t out_u32 = smem_u32(&sg.out[0][0]);
  const int tp = t0 + 4 * (lane & 7);
  const int tt = t0 - kPadL + 8 * tid;  // xs[8 tid] = xpad[t0 + 8 tid]
  if (aligned) {  // T % 8 == 0: each piece lies inside or outside [0, T)
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      const bool live = (pl.row_live >> k & 1) && tp < T;
      cp_async8(out_u32 + 2 * pl.row_dst[k], live ? ob + pl.row_off[k] + tp : ob,
                live);
    }
    if (tid < kXsThreads) {
      const bool live = tt >= 0 && tt < T;
      cp_async16(smem_u32(&sg.x[8 * tid]),
                 reinterpret_cast<const float*>(live ? xb + tt : xb), live);
    }
  } else {
#pragma unroll
    for (int k = 0; k < 5; ++k) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool live = (pl.row_live >> k & 1) && tp + e < T;
        (&sg.out[0][0])[pl.row_dst[k] + e] =
            live ? __ldg(ob + pl.row_off[k] + tp + e) : (uint16_t)0;
      }
    }
    if (tid < kXsThreads) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const bool live = tt + e >= 0 && tt + e < T;
        sg.x[8 * tid + e] = live ? __ldg(xb + tt + e) : (uint16_t)0;
      }
    }
  }
  const int f_lo = first_frame(t0);
  const int f_hi = min(n_frames - 1, (t0 + kChunk - 1 + kPadL) / kHop);
  const uint32_t dy_u32 = smem_u32(&sg.dy[0][0][0]);
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    if (e == 1 && lane >= kChans - 32) break;
    const int f = f_lo + pl.dy_fr[e];
    const bool live = (pl.dy_live >> e & 1) && f <= f_hi;
    cp_async4(dy_u32 + 4 * pl.dy_dst[e], live ? dyb + (size_t)f * F + pl.dy_off[e] : dyb,
              live);
  }
}

// The producer warpgroup: stages x and dOUT (bf16) chunk by chunk and
// sums d_windows; lane = position in the chunk, warp w owns channels
// w + 4 r.
__device__ __forceinline__ void produce(
    const Ring& ring, Staged* sgs, float* __restrict__ ws,
    float* __restrict__ dws, const uint16_t* __restrict__ x,
    const uint16_t* __restrict__ conv_out, const float* __restrict__ windows,
    const float* __restrict__ d_out, float* __restrict__ dw, int chunk0,
    int n_chunks, int nch, int T, int F, int n_frames, int c0, int n_live,
    bool aligned) {
  constexpr int kPerWarp = kChans / 4;
  const int tid = threadIdx.x - kConsumerThreads;
  const int warp = tid >> 5, lane = tid & 31;
  const CopyPlan pl = copy_plan(warp, lane, T, F, c0, n_live);

  // chunk `it` starts at position t0 of its row; (bn, tn) is the next
  // chunk to stage
  int t0 = (chunk0 % nch) * kChunk;
  int bn = chunk0 / nch, tn = t0;
  auto stage = [&](int slot) {
    stage_chunk(sgs[slot], pl, x + (size_t)bn * T, conv_out + (size_t)bn * 2 * F * T,
                d_out + (size_t)bn * n_frames * F, tn, T, F, n_frames, aligned, tid);
    tn += kChunk;
    if (tn >= T) { tn = 0; ++bn; }
  };
  stage(0);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  // the windows of dS rounded to bf16 once, as the JAX op's selectors are
  for (int i = tid; i < kWinFloats; i += kProducerThreads) {
    const int c = i / kTaps;
    ws[i] = c < n_live ? bf16_round(windows[(size_t)(c0 + c) * kTaps + i % kTaps]) : 0.f;
    dws[i] = 0.f;
  }
  producer_sync();

  for (int it = 0; it < n_chunks; ++it) {
    __syncwarp();  // every lane is done with the slot the next copy fills
    if (it + 1 < n_chunks) stage((it + 1) & 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncwarp();
    const Staged& sg = sgs[it & 1];
    const int t = t0 + lane;
    // position t meets frames fa, fa + 1 and (if k2 >= 0) fa + 2, at taps
    // k0 > k1 > k2; dY of a frame past the last is staged as zero
    const int fa = first_frame(t);
    const int k0 = t + kPadL - kHop * fa;
    const int k2 = k0 - 2 * kHop;
    const int fd = fa - first_frame(t0);  // frame row in sg.dy

    const int s = it % kStages;
    mbar_wait(&ring.empty[s], ((it / kStages) & 1) ^ 1);
    uint8_t* st = ring.stages + (size_t)s * kStageBytes;
    uint16_t* bsm = reinterpret_cast<uint16_t*>(st);
    if (tid < kXsThreads)
      reinterpret_cast<uint4*>(st + kBBytes)[tid] =
          reinterpret_cast<const uint4*>(sg.x)[tid];
    // B element (position k, column n) at element (k / 8) * kSlabBytes / 2 + 8 n + k % 8
    const int boff = (lane >> 3) * (kSlabBytes / 2) + (lane & 7);
    const int k1 = k0 - kHop, k2c = max(k2, 0);
    // kGroup channels at a time, every shared-memory read before any
    // write, so the compiler may overlap them. A channel >= n_live reads
    // zeros (OUT and dY staged as zero) and writes zero dOUT columns.
#pragma unroll
    for (int r0 = 0; r0 < kPerWarp; r0 += kGroup) {
      float re[kGroup], im[kGroup], dy[kGroup][3], w[kGroup][3], d[kGroup][3];
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        const int r = r0 + j, c = warp + 4 * r;
        re[j] = bf16_to_float(sg.out[c][lane]);
        im[j] = bf16_to_float(sg.out[kChans + c][lane]);
        dy[j][0] = bf16_round(sg.dy[warp][fd][r]);
        dy[j][1] = bf16_round(sg.dy[warp][fd + 1][r]);
        dy[j][2] = k2 >= 0 ? bf16_round(sg.dy[warp][fd + 2][r]) : 0.f;
        w[j][0] = ws[c * kTaps + k0];
        w[j][1] = ws[c * kTaps + k1];
        w[j][2] = ws[c * kTaps + k2c];
        d[j][0] = dws[c * kTaps + k0];
        d[j][1] = dws[c * kTaps + k1];
        d[j][2] = dws[c * kTaps + k2c];
      }
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        const int c = warp + 4 * (r0 + j);
        const float sq = bf16_round(re[j] * re[j] + im[j] * im[j]);
        const float ds = fmaf(dy[j][0], w[j][0], fmaf(dy[j][1], w[j][1], dy[j][2] * w[j][2]));
        dws[c * kTaps + k0] = fmaf(dy[j][0], sq, d[j][0]);
        dws[c * kTaps + k1] = fmaf(dy[j][1], sq, d[j][1]);
        if (k2 >= 0) dws[c * kTaps + k2] = fmaf(dy[j][2], sq, d[j][2]);
        bsm[boff + 8 * c] = float_to_bf16(2.f * re[j] * ds);
        bsm[boff + 8 * (kChans + c)] = float_to_bf16(2.f * im[j] * ds);
      }
    }
    // generic-proxy stores -> visible to wgmma's async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_arrive(&ring.full[s]);
    t0 += kChunk;
    if (t0 >= T) t0 = 0;
  }

  producer_sync();
  for (int i = tid; i < kWinFloats; i += kProducerThreads) dw[i] = dws[i];
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
  float* ws = reinterpret_cast<float*>(sgs + 2);
  float* dws = ws + kWinFloats;
  ring.full = reinterpret_cast<uint64_t*>(dws + kWinFloats);
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
      mbar_init(&ring.full[s], kProducerThreads);
      mbar_init(&ring.empty[s], kConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  static_assert(2 * kRegs3 + kRegs1 + kRegsProducer <= 4 * 128,
                "setmaxnreg must not ask for more than the block holds");
  float* db = dbank_part + part * kTaps * kN;
  const int wg = threadIdx.x >> 7;
  if (wg == kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kRegsProducer));
    produce(ring, sgs, ws, dws, x, conv_out, windows, d_out,
            dwin_part + part * kWinFloats, chunk0, n_chunks, nch, T, F,
            n_frames, c0, n_live, aligned != 0);
  } else if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kRegs1));
    consume<1>(ring, n_chunks, 6, db);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kRegs3));
    consume<3>(ring, n_chunks, 3 * wg, db);
  }
}

constexpr size_t kSmemBytes = (size_t)kStages * kStageBytes + 2 * sizeof(Staged)
                              + 2 * sizeof(float) * kWinFloats  // windows, d_win sums
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
