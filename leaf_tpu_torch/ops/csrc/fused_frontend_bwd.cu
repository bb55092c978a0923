// Fused Gabor conv -> squared modulus -> Gaussian lowpass, backward, on
// Hopper's tensor cores in 3xTF32 (f32 in, f32 out).
//
// Replaces leaf_tpu/ops/fused_frontend.py:_bwd_kernel together with the
// XLA glue around it (the slot-expanding cotangent gather of _fused_bwd,
// _group_cotangent, _build_bwd_selectors, _fold_bwd_windows,
// _fold_toeplitz_grad). From the conv outputs saved by the forward
// (fused_frontend.cu, kSave), OUT = conv_out (B, 2F, T) [re | im], the
// output cotangent dY (B, n_frames, F) and the windows (F, 401) it
// computes, for 0 <= t < T,
//
//   S[b, t, c]      = OUT_re[b, c, t]^2 + OUT_im[b, c, t]^2
//   dS[b, t, c]     = sum_f dY[b, f, c] * win[c, t + 200 - 160 f]    (<= 3 frames)
//   d_win[c, k]    += sum_f dY[b, f, c] * S[b, 160 f + k - 200, c]
//   dOUT[b, col, t] = 2 * OUT[b, col, t] * dS[b, t, col mod F]
//   d_bank[j, col] += sum_t xpad[b, t + j] * dOUT[b, col, t]
//
// The waveform gradient is zero by the op's contract and is not computed.
//
// Bound. d_bank is a GEMM, M = 401 taps x N = 2F columns x K = B*T
// positions: 2 * B * T * 2F * 401 = 2.63e11 flops at B=256, T=16000,
// F=40. In 3xTF32 that is three tensor-core products, 7.9e11 flops,
// 1.59 ms at the H100's dense TF32 rate of 494.7 TFLOP/s (1.78 ms with
// the taps padded to 7 tiles of 64); dS, dOUT and d_win add ~3e9 f32
// flops on the CUDA cores (~0.04 ms). It reads ~1.33 GB (OUT, x, dY),
// ~0.40 ms at 3.35 TB/s, so it is bound by tensor-core operations.
//
// Why 3xTF32 and not one TF32 product: a TF32 operand keeps 11 of f32's
// 24 significant bits, up to ~5e-4 relative per product. Emulated on the
// CPU (tests/test_torch_port_fused.py, B=2), one TF32 product reads
// 3.7e-5 - 4.2e-5 of the bank gradient's norm against the JAX op, ~300x
// the f32 plain version's 1.2e-7 and within 2.5x of the port's 1e-4
// gradient tolerance before the accumulator's own drift (below). Each
// operand a is split into hi = rna_tf32(a) and lo = rna_tf32(a - hi);
// hi*hi + hi*lo + lo*hi, summed in the f32 accumulator, keeps ~22 bits
// (the dropped lo*lo term is ~2^-22 of the product) and reads 1.3e-7,
// as f32 does.
//
// Design. An implicit GEMM: wgmma.mma_async m64n80k8 .tf32, with
//  - A, the Hankel waveform tile A[j, k] = xpad[t0 + k + j], from
//    registers. Thread (warp w, lane 4 g + i) of a warpgroup holds, for
//    its tap tile and k-step q, {xs[p + 8q], xs[p + 8q + 8], xs[p + 8q + 4],
//    xs[p + 8q + 12]} (p = tile row + 16 w + g + i), the m16n8k8 layout
//    per warp. wgmma wants four consecutive registers, so once k-step q
//    is done the fragment moves a1 -> a0, a3 -> a2 and loads two new
//    values: two loads per tile, split and step. The Toeplitz matrix
//    never exists.
//  - B, the dOUT chunk, from shared memory, K-major and unswizzled: 8
//    columns x 4 positions per 128-byte core matrix, slabs of 4
//    positions 1296 bytes apart (80 columns + 16 bytes of padding, so the
//    producer's stores of 32 consecutive positions of one column hit 32
//    banks). Columns are re 0..39 | im 40..79 of a group of 40 channels;
//    a narrower group leaves its columns zero.
//  - One block covers all 401 taps (7 tiles of 64; rows 401..447 read
//    the zero-padded waveform and are never written) and 40 channels,
//    so dS and dOUT are formed once per position. Three consumer
//    warpgroups hold tiles 0-2, 3-5 and 6 in f32 accumulators;
//    setmaxnreg gives them 176, 176 and 96 registers per thread and the
//    producer 64. Each issues 3 wgmmas per tile and k-step, then waits
//    for them; the three warpgroups' groups keep the tensor pipe busy in
//    turn. (The k-step loop stays rolled: unrolled, ptxas runs out of
//    registers and serializes every wgmma.)
//  - The wgmma accumulator's error grows in proportion to the positions
//    it adds: over the ~31k positions of a block at the flagship shape
//    d_bank missed the 1e-4 tolerance. So every 64 chunks each thread
//    adds its accumulators into the block's partial with f32 reductions
//    (RED, no return value; each entry has one owner, so the order is
//    fixed) and restarts them from zero: ~1.5e-5 of the norm at any B*T
//    (chip_smoke.py [parity-train]).
//  - Warpgroup 3 produces. One chunk ahead it stages with cp.async (16
//    bytes a copy when T % 4 == 0, else 4) the OUT rows of its 40
//    channels, the waveform span with its 448-tap halo and the dY rows
//    of the <= 4 frames that meet the chunk. Then, lane = position and
//    warp w owning channels w + 4 r, it forms S, dS and dOUT, adds
//    dY * S into the d_windows sums in shared memory on the CUDA cores,
//    splits x and dOUT into hi/lo and writes them into a ring of 3
//    stages, each signalled by a "full" and an "empty" mbarrier. A
//    (channel, tap) d_windows sum is only ever touched by the thread
//    whose lane is (tap - 200) mod 32, because chunks start at multiples
//    of 32 and frames 160 apart: no atomics and a fixed order.
//  - Deterministic split-K: the (batch row, chunk) list is cut into one
//    contiguous run per block (a chunk never crosses a row, so the halo
//    is per row; positions >= T carry a zero dOUT). Each block writes
//    one (401, 80) d_bank partial and one (40, 401) d_windows partial;
//    the wrapper sums them in a fixed order. The grid is one block per
//    SM across the channel groups.

#include <cuda_runtime.h>
#include <stdint.h>

// smem_u32, split_tf32, lds, cp_async4/16, b_desc_of, fence_acc, wgmma_tf32
#include "hopper_tf32.cuh"

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
constexpr int kKSteps = kChunk / 8;        // k8 steps per stage
// Chunks between two flushes of the tensor-core accumulators into the
// block's partial (f32 adds, rounded to nearest); see the header.
constexpr int kFlushChunks = 64;
constexpr int kGroup = 2;                  // producer channels per batch of reads
// registers per thread (setmaxnreg), from 128 at entry: the 3-tile
// consumers, the 1-tile consumer, the producer. Below these, ptxas
// serializes the wgmmas (one wait after each).
constexpr int kRegs3 = 176, kRegs1 = 96, kRegsProducer = 64;
constexpr int kStages = 3;
constexpr int kXsLen = 512;  // span + halo of a chunk (kChunk + 448 taps), 4 per producer thread
constexpr int kSlabBytes = kN * 16 + 16;   // 4 positions of B, padded
constexpr int kBBytes = (kChunk / 4) * kSlabBytes;
constexpr int kStageBytes = 2 * kBBytes + 2 * kXsLen * 4;  // B hi, B lo, xs hi, xs lo
constexpr int kWinFloats = kChans * kTaps;
constexpr size_t kSmemBytes = (size_t)kStages * kStageBytes
                              + 2 * (kN * kChunk + kXsLen + kChans * 4) * sizeof(float)
                              + 2 * sizeof(float) * kWinFloats  // windows, d_win sums
                              + 2 * kStages * sizeof(uint64_t);  // full, empty
constexpr int kProducerThreads = 128;
constexpr int kConsumerThreads = 128 * kConsumers;
constexpr int kThreads = kConsumerThreads + kProducerThreads;
constexpr unsigned kSpinLimit = 1u << 22;  // a lost arrival traps, never hangs

static_assert(kXsLen >= kChunk + 64 * kTiles && kXsLen == 4 * 128, "one 16-byte piece per producer thread");
static_assert(kStageBytes % 16 == 0, "stages must stay 16-byte aligned");
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
  const int p0 = 64 * tile0 + 16 * warp + gid + tig;

  float acc[kMine][kAcc];
#pragma unroll
  for (int m = 0; m < kMine; ++m) {
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[m][i] = 0.f;
  }

  // 32-bit shared addresses: one base register per operand, the rest
  // are immediate offsets
  const uint32_t ring_u32 = smem_u32(ring.stages);
  for (int it = 0; it < n_chunks; ++it) {
    const int s = it % kStages;
    mbar_wait(&ring.full[s], (it / kStages) & 1);
    __syncwarp();  // the warpgroup is converged for wgmma
    const uint32_t st = ring_u32 + s * kStageBytes;
    const uint32_t xa = st + 2 * kBBytes + 4 * p0;  // &xs_hi[p0]
    constexpr uint32_t kLo = 4 * kXsLen;           // xs_hi -> xs_lo
    const uint32_t dlo = ((st & 0x3FFFF) >> 4) | ((kSlabBytes >> 4) << 16);

    // A fragment of k-step q: {xs[p + 8q], xs[p + 8q + 8], xs[p + 8q + 4],
    // xs[p + 8q + 12]} (rows g, g + 8 x columns i, i + 4). wgmma takes it
    // as four consecutive registers; k-step q + 1 moves a1 -> a0 and
    // a3 -> a2 once q's group is done and loads two new values.
    uint32_t ah[kMine][4], al[kMine][4];
#pragma unroll
    for (int m = 0; m < kMine; ++m) {
      const uint32_t a = xa + 256 * m;
      ah[m][0] = lds(a); ah[m][2] = lds(a + 16);
      al[m][0] = lds(a + kLo); al[m][2] = lds(a + kLo + 16);
    }
#pragma unroll 1  // see the header: unrolled, the wgmmas serialize
    for (int q = 0; q < kKSteps; ++q) {
#pragma unroll
      for (int m = 0; m < kMine; ++m) {
        const uint32_t a = xa + 256 * m + 32 * (q + 1);
        if (q > 0) {
          ah[m][0] = ah[m][1]; ah[m][2] = ah[m][3];
          al[m][0] = al[m][1]; al[m][2] = al[m][3];
        }
        ah[m][1] = lds(a); ah[m][3] = lds(a + 16);
        al[m][1] = lds(a + kLo); al[m][3] = lds(a + kLo + 16);
      }
      // k-step q reads positions 8q..8q+7: two slabs on; B lo is kBBytes on
      const uint32_t dq = dlo + 2 * q * (kSlabBytes >> 4);
      const uint64_t dh = b_desc_of(dq), dl = b_desc_of(dq + (kBBytes >> 4));
#pragma unroll
      for (int m = 0; m < kMine; ++m) fence_acc(acc[m]);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int m = 0; m < kMine; ++m) {
        wgmma_tf32(acc[m], ah[m], dh);
        wgmma_tf32(acc[m], ah[m], dl);
        wgmma_tf32(acc[m], al[m], dh);
      }
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

// What the producer stages for one chunk with cp.async, one chunk ahead:
// the OUT rows of its 40 channels (re 0..39 | im 40..79, 32 positions
// each; warp w copies and reads the 20 rows of channels w + 4 r), the
// waveform span xpad[t0 .. t0 + 512) (thread i copies and reads
// 4i .. 4i + 3) and, per warp, dY of the <= 4 frames that meet the chunk
// for the warp's 10 channels. A warp reads its rows after a __syncwarp.
struct Staged {
  float out[kN][kChunk];
  float x[kXsLen];
  float dy[4][4][kChans / 4];  // [warp][frame - f_lo][r]
};
static_assert(sizeof(Staged) == (kN * kChunk + kXsLen + kChans * 4) * sizeof(float),
              "kSmemBytes counts two Staged slots");

__device__ __forceinline__ int first_frame(int t) {  // first frame over t
  return t > kPadL ? (t - kPadL + kHop - 1) / kHop : 0;
}

// A lane's copies, fixed for the block: rows j = 4 k + lane / 8 of its
// warp's 20 (8 lanes of 4 positions per row), and dY entries lane and
// lane + 32 of the warp's 40 (frame i / 10, channel w + 4 (i % 10)).
struct CopyPlan {
  int row_off[5];     // OUT offset of row j: ((j / 10) F + c0 + w + 4 (j % 10)) T
  int row_dst[5];     // its float offset in Staged::out
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
    Staged& sg, const CopyPlan& pl, const float* __restrict__ xb,
    const float* __restrict__ ob, const float* __restrict__ dyb, int t0,
    int T, int F, int n_frames, bool aligned, int tid) {
  const int lane = tid & 31;
  const uint32_t out_u32 = smem_u32(&sg.out[0][0]);
  const uint32_t x_u32 = smem_u32(&sg.x[4 * tid]);
  const int tp = t0 + 4 * (lane & 7);
  const int tt = t0 - kPadL + 4 * tid;  // xs[4 tid] = xpad[t0 + 4 tid]
  if (aligned) {  // T % 4 == 0: each 16-byte piece lies inside or outside [0, T)
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      const bool live = (pl.row_live >> k & 1) && tp < T;
      cp_async16(out_u32 + 4 * pl.row_dst[k], live ? ob + pl.row_off[k] + tp : ob,
                 live);
    }
    const bool live = tt >= 0 && tt < T;
    cp_async16(x_u32, live ? xb + tt : xb, live);
  } else {
#pragma unroll
    for (int k = 0; k < 5; ++k) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool live = (pl.row_live >> k & 1) && tp + e < T;
        cp_async4(out_u32 + 4 * (pl.row_dst[k] + e),
                  live ? ob + pl.row_off[k] + tp + e : ob, live);
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool live = tt + e >= 0 && tt + e < T;
      cp_async4(x_u32 + 4 * e, live ? xb + tt + e : xb, live);
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

// The producer warpgroup: stages x and dOUT (hi/lo) chunk by chunk and
// sums d_windows; lane = position in the chunk, warp w owns channels
// w + 4 r.
__device__ __forceinline__ void produce(
    const Ring& ring, Staged* sgs, float* __restrict__ ws,
    float* __restrict__ dws, const float* __restrict__ x,
    const float* __restrict__ conv_out, const float* __restrict__ windows,
    const float* __restrict__ d_out, float* __restrict__ dw, int chunk0,
    int n_chunks, int nch, int T, int F, int n_frames, int c0, int n_live) {
  constexpr int kPerWarp = kChans / 4;
  const int tid = threadIdx.x - kConsumerThreads;
  const int warp = tid >> 5, lane = tid & 31;
  const bool aligned = T % 4 == 0;
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
  for (int i = tid; i < kWinFloats; i += kProducerThreads) {
    const int c = i / kTaps;
    ws[i] = c < n_live ? windows[(size_t)(c0 + c) * kTaps + i % kTaps] : 0.f;
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
    float* bh = reinterpret_cast<float*>(st);
    float* bl = reinterpret_cast<float*>(st + kBBytes);
    float* xh = reinterpret_cast<float*>(st + 2 * kBBytes);
    float* xl = xh + kXsLen;
    {
      const float4 v = *reinterpret_cast<const float4*>(&sg.x[4 * tid]);
      float4 h, l;
      split_tf32(v.x, h.x, l.x);
      split_tf32(v.y, h.y, l.y);
      split_tf32(v.z, h.z, l.z);
      split_tf32(v.w, h.w, l.w);
      *reinterpret_cast<float4*>(&xh[4 * tid]) = h;
      *reinterpret_cast<float4*>(&xl[4 * tid]) = l;
    }
    // B element (position k, column n) at float (k / 4) * kSlabBytes / 4 + 4 n + k % 4
    const int boff = (lane >> 2) * (kSlabBytes / 4) + (lane & 3);
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
        re[j] = sg.out[c][lane];
        im[j] = sg.out[kChans + c][lane];
        dy[j][0] = sg.dy[warp][fd][r];
        dy[j][1] = sg.dy[warp][fd + 1][r];
        dy[j][2] = k2 >= 0 ? sg.dy[warp][fd + 2][r] : 0.f;
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
        const float sq = re[j] * re[j] + im[j] * im[j];
        const float ds = fmaf(dy[j][0], w[j][0], fmaf(dy[j][1], w[j][1], dy[j][2] * w[j][2]));
        dws[c * kTaps + k0] = fmaf(dy[j][0], sq, d[j][0]);
        dws[c * kTaps + k1] = fmaf(dy[j][1], sq, d[j][1]);
        if (k2 >= 0) dws[c * kTaps + k2] = fmaf(dy[j][2], sq, d[j][2]);
        split_tf32(2.f * re[j] * ds, bh[boff + 4 * c], bl[boff + 4 * c]);
        split_tf32(2.f * im[j] * ds, bh[boff + 4 * (kChans + c)],
                   bl[boff + 4 * (kChans + c)]);
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
fused_bwd_tf32x3_kernel(const float* __restrict__ x,         // (B, T)
                        const float* __restrict__ conv_out,  // (B, 2F, T) [re | im]
                        const float* __restrict__ windows,   // (F, 401)
                        const float* __restrict__ d_out,     // (B, n_frames, F)
                        float* __restrict__ dbank_part,      // (G, n_blocks, 401, 80)
                        float* __restrict__ dwin_part,       // (G, n_blocks, 40, 401)
                        int batch, int T, int F, int n_frames) {
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
            n_frames, c0, n_live);
  } else if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kRegs1));
    consume<1>(ring, n_chunks, 6, db);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kRegs3));
    consume<3>(ring, n_chunks, 3 * wg, db);
  }
}

}  // namespace

// Launches the kernel on `stream` over an (n_blocks, ceil(F / 40)) grid.
// All pointers are device pointers to contiguous f32 arrays of the shapes
// noted on the kernel; the caller checks them and sizes the partials
// (n_blocks <= batch * ceil(T / 32)). Returns the CUDA error code of the
// launch (0 on success).
extern "C" int leaf_fused_bwd_f32(const void* x, const void* conv_out,
                                  const void* windows, const void* d_out,
                                  void* dbank_part, void* dwin_part, int batch,
                                  int T, int F, int n_frames, int n_blocks,
                                  void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_bwd_tf32x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_blocks, (F + kChans - 1) / kChans);
  fused_bwd_tf32x3_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(conv_out),
      static_cast<const float*>(windows), static_cast<const float*>(d_out),
      static_cast<float*>(dbank_part), static_cast<float*>(dwin_part), batch,
      T, F, n_frames);
  return (int)cudaGetLastError();
}

