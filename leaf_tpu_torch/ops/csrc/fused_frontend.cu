// Fused Gabor conv -> squared modulus -> Gaussian lowpass, forward, on
// Hopper's tensor cores in 3xTF32 (f32 in, f32 out).
//
// Replaces leaf_tpu/ops/fused_frontend.py:_fwd_kernel in both its variants
// together with the XLA glue around it (_toeplitz_full, _build_selectors,
// _combine_partials): the primal one (save_out=False, kSave = false here)
// and the residual-saving one of the custom VJP (save_out=True, kSave =
// true), which also writes the conv outputs for the backward kernel
// (fused_frontend_bwd.cu). It computes, directly,
//
//   out[b, f, c] = sum_k win[c, k] * S[b, 160 f + k - 200, c]
//   S[b, t, c]   = OUT_re[b, c, t]^2 + OUT_im[b, c, t]^2   for 0 <= t < T,
//   OUT[b, col, t] = sum_j xpad[b, t + j] bank[j, col]     (col: re | im)
//
// S = 0 outside [0, T), xpad = x with 200 zeros in front (TF-SAME), taps
// j, k in [0, 401), stride 160. No Toeplitz operand, no slot selectors.
//
// Bound. OUT is a GEMM, M = B*T positions x N = 2F columns x K = 401
// taps: 2 * B * T * 2F * 401 = 2.63e11 flops at B=256, T=16000, F=40. In
// 3xTF32 that is three tensor-core products, 7.9e11 flops, 1.59 ms at the
// H100's dense TF32 rate of 494.7 TFLOP/s; |.|^2 and the lowpass add
// ~1.5e9 f32 flops on the CUDA cores (~0.02 ms): 1.61 ms in all. The
// inputs and out are ~17 MB; the saving variant also writes OUT,
// 2 * B * T * 2F * 4 bytes = 1.31 GB, ~0.39 ms at 3.35 TB/s. Both
// variants are bound by tensor-core operations.
//
// Why 3xTF32 and not one TF32 product: a TF32 operand keeps 11 of f32's
// 24 significant bits, up to ~5e-4 relative per product. Emulated on the
// CPU (tests/test_torch_port_fused.py, B=2), one TF32 product reads
// 4.7e-5 of out's norm against the JAX op, 3xTF32 3.0e-7. Each operand a
// is split into hi = rna_tf32(a) and lo = rna_tf32(a - hi); hi*hi +
// hi*lo + lo*hi, summed in f32, keeps ~22 bits (the dropped lo*lo term is
// ~2^-22 of the product).
//
// Design. An implicit GEMM: wgmma.mma_async m64n40k8 .tf32, with
//  - A, the Hankel waveform tile A[t, j] = xpad[t0 + t + j], from
//    registers, as in the backward: thread (warp w, lane 4 g + i) of a
//    warpgroup holds, for its 64-position tile and k-step q, {xs[p + 8q],
//    xs[p + 8q + 8], xs[p + 8q + 4], xs[p + 8q + 12]} (p = tile start +
//    16 w + g + i). The two new values of k-step q + 1 are loaded while
//    q's products run; once they are done the fragment moves a1 -> a0,
//    a3 -> a2 and takes them. The Toeplitz matrix never exists.
//  - B, the bank of the block's 20 channels, staged once per block, split
//    into hi and lo, in shared memory: K-major, unswizzled, taps padded
//    401 -> 408 (51 k-steps; rows 401..407 zero), slabs of 4 taps 656
//    bytes apart (40 columns + 16 bytes). Columns are interleaved, 2c = re
//    of channel c and 2c + 1 = im, so that accumulator entries e = 0, 1
//    of a thread are re and im of one channel and S forms in registers.
//    A channel past F has zero columns and is never stored. Bank hi + lo
//    take 134 KB; a block may hold 227 KB, so N = 80 (261 KB) does not fit.
//  - A block owns (batch row, up to 25 frames, 20 channels). The frames
//    of a row are split evenly over ceil(n_frames / 25) blocks (25 each at
//    T=16000). The block walks its S span (160 (frames - 1) + 404
//    positions from 160 f0 - 200) in 256-position chunks, four warpgroups
//    of one 64-position tile each; a warpgroup whose 64 positions all lie
//    outside [0, T) or past the span skips its products and writes S = 0.
//    At T=16000 the recomputed halo of neighbouring frame blocks plus
//    the rounding to 64 positions is 5.6 % of the conv work
//    (tests/test_torch_port_fwd_schedule.py replays this schedule).
//  - Per chunk: cp.async stages the next chunk's waveform (256 + 416
//    samples, zeros outside [0, T); 16-byte copies when T % 4 == 0 and x
//    is 16-byte aligned) into the other half of a double buffer while
//    this chunk is split into hi/lo and multiplied. Per tile and k-step a
//    warpgroup issues hi*hi, hi*lo and lo*hi into one f32 accumulator and
//    waits for them; the four warpgroups' groups keep the tensor pipe
//    busy in turn. The k-step loop is unrolled (rolled, ptxas serializes
//    the wgmmas: C7513). Every 17 k-steps (136 taps) the accumulator is added
//    into f32 registers and restarted: the tensor cores' accumulator
//    error grows with the terms it sums (the backward's finding), and OUT
//    is held elementwise.
//  - S goes to shared memory (zero outside [0, T)), and all 16 warps
//    fold the chunk into the block's (frame, channel) window sums on the
//    CUDA cores: one warp per (frame, channel), 16-byte reads of window
//    and S, a fixed-order butterfly sum, one writer per sum and chunk.
//    Every output is written by one block, so the result is deterministic.
//  - kSave: OUT (B, 2F, T) [re channels | im channels] is stored straight
//    from the accumulator; for one channel, lanes g = 0..7 hold 8
//    consecutive positions, one full 32-byte sector of the channel-major
//    row. Only positions the block OWNS are written, [160 f0, 160 (f0 +
//    frames per block)) clipped to [0, T), so the union over blocks is
//    exactly [0, T) and each position is written once.
//  - Shared memory: 200.0 KB, one block per SM; 512 threads. At B=256,
//    T=16000, F=40 the grid is 4 x 2 x 256 = 2048 blocks, 15.5 waves of
//    132.

#include <cuda_runtime.h>
#include <stdint.h>

// smem_u32, split_tf32, lds, cp_async4/16, b_desc_of, fence_acc, wgmma_tf32
#include "hopper_tf32.cuh"

namespace {

constexpr int kTaps = 401;
constexpr int kHop = 160;
constexpr int kPadL = 200;
constexpr int kK = 408;                    // taps padded to k-steps of 8
constexpr int kKSteps = kK / 8;            // 51
constexpr int kFlushSteps = 17;            // k-steps between accumulator flushes
constexpr int kChans = 20;                 // channels per block
constexpr int kN = 2 * kChans;             // bank columns, re/im interleaved
constexpr int kAcc = kN / 2;               // accumulator registers per tile
constexpr int kWarpgroups = 4;
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kWarps = kThreads / 32;
constexpr int kTilesPerWg = 1;             // 64-position tiles per warpgroup
constexpr int kWgSpan = 64 * kTilesPerWg;  // positions per warpgroup and chunk
constexpr int kChunk = kWgSpan * kWarpgroups;  // 256 positions
constexpr int kXsLen = kChunk + kK + 8;    // waveform samples a chunk stages
constexpr int kMaxFrames = 25;             // output frames per block, at most
constexpr int kWinLen = 404;               // window row; taps 401..403 zero
constexpr int kSsPitch = kChunk + 8;       // S row pitch: conflict-free writes
constexpr int kSlabBytes = kN * 16 + 16;   // 4 taps of B, padded
constexpr int kBBytes = (kK / 4) * kSlabBytes;
constexpr int kBankBatch = 8;              // global loads in flight per thread
constexpr size_t kSmemBytes =
    2 * (size_t)kBBytes                    // bank hi, lo
    + sizeof(float) * (4 * kXsLen          // waveform double buffer, hi, lo
                       + kChans * kSsPitch // S of one chunk, [channel][position]
                       + kChans * kWinLen  // windows, [channel][tap]
                       + kMaxFrames * kChans);  // window sums, [frame][channel]

static_assert(kKSteps % kFlushSteps == 0, "flushes split the k-steps evenly");
static_assert(kXsLen % 4 == 0 && kChunk % 4 == 0, "16-byte waveform pieces");
static_assert(kBBytes % 16 == 0 && kSlabBytes % 16 == 0,
              "wgmma descriptors address 16-byte units");
static_assert(kWinLen % 4 == 0 && kSsPitch % 4 == 0 && kWinLen >= kTaps,
              "16-byte fold reads");
static_assert(kSmemBytes <= 232448, "one block per SM");

template <bool kSave>
__global__ void __launch_bounds__(kThreads, 1)
fused_fwd_tf32x3_kernel(const float* __restrict__ x,        // (B, T)
                        const float* __restrict__ gabor,    // (401, 2F) [re | im]
                        const float* __restrict__ windows,  // (F, 401)
                        float* __restrict__ out,            // (B, n_frames, F)
                        float* __restrict__ conv_out,       // (B, 2F, T), kSave only
                        int T, int F, int n_frames, int frames_per_block,
                        int aligned) {
  extern __shared__ __align__(128) uint8_t smem[];
  float* bh = reinterpret_cast<float*>(smem);
  float* bl = reinterpret_cast<float*>(smem + kBBytes);
  float* xraw = reinterpret_cast<float*>(smem + 2 * kBBytes);  // [2][kXsLen]
  float* xh = xraw + 2 * kXsLen;
  float* xl = xh + kXsLen;
  float* ss = xl + kXsLen;
  float* ws = ss + kChans * kSsPitch;
  float* sums = ws + kChans * kWinLen;

  const int tid = threadIdx.x;
  const int f0 = blockIdx.x * frames_per_block;
  const int c0 = blockIdx.y * kChans;
  const int b = blockIdx.z;
  const int n_live = min(kChans, F - c0);
  const int frames_here = min(frames_per_block, n_frames - f0);
  const int s_lo = f0 * kHop - kPadL;  // first S position the windows read
  const int span = kHop * (frames_here - 1) + kWinLen;
  // S positions (relative to s_lo) that can be nonzero, and their chunks
  const int q_lo = max(0, -s_lo), q_hi = min(span, T - s_lo);
  const int ch_lo = q_lo / kChunk, ch_hi = (q_hi + kChunk - 1) / kChunk;
  // conv positions this block owns (kSave): its frames' hops, within [0, T)
  const int own_lo = f0 * kHop;
  const int own_hi = min((f0 + frames_per_block) * kHop, T);

  // waveform of chunk `ch` (xs[k] = xpad[s_lo + ch * kChunk + k]) into
  // half `buf` of the double buffer, as one cp.async group
  const float* xb = x + (size_t)b * T;
  auto stage_x = [&](int ch, int buf) {
    const int t0 = s_lo - kPadL + ch * kChunk;
    const uint32_t dst = smem_u32(xraw + buf * kXsLen);
    if (aligned) {  // each 16-byte piece lies inside or outside [0, T)
      for (int i = tid; i < kXsLen / 4; i += kThreads) {
        const int t = t0 + 4 * i;
        const bool live = t >= 0 && t < T;
        cp_async16(dst + 16 * i, live ? xb + t : xb, live);
      }
    } else {
      for (int i = tid; i < kXsLen; i += kThreads) {
        const int t = t0 + i;
        const bool live = t >= 0 && t < T;
        cp_async4(dst + 4 * i, live ? xb + t : xb, live);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  stage_x(ch_lo, 0);

  // The bank (hi/lo, K-major, interleaved columns, zero past tap 401 and
  // past channel F), the windows (zero past tap 401) and the sums.
  for (int i0 = tid; i0 < kK * kN; i0 += kThreads * kBankBatch) {
    float v[kBankBatch];
#pragma unroll
    for (int u = 0; u < kBankBatch; ++u) {
      const int i = i0 + u * kThreads, j = i / kN, c = (i % kN) >> 1;
      v[u] = i < kK * kN && j < kTaps && c < n_live
                 ? __ldg(gabor + (size_t)j * 2 * F + (i & 1) * F + c0 + c) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kBankBatch; ++u) {
      const int i = i0 + u * kThreads, j = i / kN, n = i % kN;
      if (i < kK * kN) {
        const int o = (j >> 2) * (kSlabBytes / 4) + 4 * n + (j & 3);
        split_tf32(v[u], bh[o], bl[o]);
      }
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
  for (int i = tid; i < kMaxFrames * kChans; i += kThreads) sums[i] = 0.f;
  // generic-proxy stores of the bank -> visible to wgmma's async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");

  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  // 32-bit shared addresses: this thread's A row in tile 0 of the
  // warpgroup, and the bank's descriptor (start >> 4 | slab stride >> 4)
  const uint32_t xa = smem_u32(xh) + 4 * (kWgSpan * wg + 16 * warp + gid + tig);
  constexpr uint32_t kLo = 4 * kXsLen;  // xh -> xl
  const uint32_t dbase = ((smem_u32(bh) & 0x3FFFF) >> 4) | ((kSlabBytes >> 4) << 16);

  for (int ch = ch_lo; ch < ch_hi; ++ch) {
    const int buf = (ch - ch_lo) & 1;
    if (ch + 1 < ch_hi) {
      stage_x(ch + 1, buf ^ 1);  // its half was split one chunk ago
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();  // this chunk's waveform landed; the last fold is done
    for (int i = tid; i < kXsLen / 4; i += kThreads) {
      const float4 v = reinterpret_cast<const float4*>(xraw + buf * kXsLen)[i];
      float4 h, l;
      split_tf32(v.x, h.x, l.x);
      split_tf32(v.y, h.y, l.y);
      split_tf32(v.z, h.z, l.z);
      split_tf32(v.w, h.w, l.w);
      reinterpret_cast<float4*>(xh)[i] = h;
      reinterpret_cast<float4*>(xl)[i] = l;
    }
    __syncthreads();

    const int q0 = ch * kChunk;
    const int wq = q0 + kWgSpan * wg;  // this warpgroup's first position
    const bool live = wq < q_hi && wq + kWgSpan > q_lo;  // warpgroup-uniform
    float tot[kTilesPerWg][kAcc];
#pragma unroll
    for (int m = 0; m < kTilesPerWg; ++m) {
#pragma unroll
      for (int i = 0; i < kAcc; ++i) tot[m][i] = 0.f;
    }
    if (live) {
      // A fragment of k-step q: {xs[p + 8q], xs[p + 8q + 8], xs[p + 8q + 4],
      // xs[p + 8q + 12]}. While q's group runs, the two new values of
      // q + 1 are loaded into spare registers; once it is done the
      // fragment moves a1 -> a0, a3 -> a2 and takes them.
      uint32_t ah[kTilesPerWg][4], al[kTilesPerWg][4];
#pragma unroll
      for (int m = 0; m < kTilesPerWg; ++m) {
        const uint32_t a = xa + 256 * m;
        ah[m][0] = lds(a); ah[m][2] = lds(a + 16);
        ah[m][1] = lds(a + 32); ah[m][3] = lds(a + 48);
        al[m][0] = lds(a + kLo); al[m][2] = lds(a + kLo + 16);
        al[m][1] = lds(a + kLo + 32); al[m][3] = lds(a + kLo + 48);
      }
      for (int s = 0; s < kKSteps / kFlushSteps; ++s) {
        float acc[kTilesPerWg][kAcc];
#pragma unroll
        for (int m = 0; m < kTilesPerWg; ++m) {
#pragma unroll
          for (int i = 0; i < kAcc; ++i) acc[m][i] = 0.f;
        }
#pragma unroll  // see the header: rolled, the wgmmas serialize
        for (int qq = 0; qq < kFlushSteps; ++qq) {
          const int q = s * kFlushSteps + qq;
          // k-step q reads taps 8q..8q+7: two slabs on; B lo is kBBytes on
          const uint32_t dq = dbase + 2 * q * (kSlabBytes >> 4);
          const uint64_t dh = b_desc_of(dq), dl = b_desc_of(dq + (kBBytes >> 4));
#pragma unroll
          for (int m = 0; m < kTilesPerWg; ++m) fence_acc(acc[m]);
          asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
          for (int m = 0; m < kTilesPerWg; ++m) wgmma_tf32(acc[m], ah[m], dh);
#pragma unroll
          for (int m = 0; m < kTilesPerWg; ++m) wgmma_tf32(acc[m], ah[m], dl);
#pragma unroll
          for (int m = 0; m < kTilesPerWg; ++m) wgmma_tf32(acc[m], al[m], dh);
          asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
          // {xs[p + 8q + 16], xs[p + 8q + 20]}: a1, a3 of k-step q + 1 (after
          // the last k-step, 8 staged samples past the taps, unused)
          uint32_t nh[kTilesPerWg][2], nl[kTilesPerWg][2];
#pragma unroll
          for (int m = 0; m < kTilesPerWg; ++m) {
            const uint32_t a = xa + 256 * m + 32 * (q + 2);
            nh[m][0] = lds(a); nh[m][1] = lds(a + 16);
            nl[m][0] = lds(a + kLo); nl[m][1] = lds(a + kLo + 16);
          }
          asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
          for (int m = 0; m < kTilesPerWg; ++m) {
            fence_acc(acc[m]);
            ah[m][0] = ah[m][1]; ah[m][2] = ah[m][3];
            al[m][0] = al[m][1]; al[m][2] = al[m][3];
            ah[m][1] = nh[m][0]; ah[m][3] = nh[m][1];
            al[m][1] = nl[m][0]; al[m][3] = nl[m][1];
          }
        }
#pragma unroll
        for (int m = 0; m < kTilesPerWg; ++m) {
#pragma unroll
          for (int i = 0; i < kAcc; ++i) tot[m][i] += acc[m][i];
        }
      }
    }

    // accumulator entry 4 j + 2 h + e of tile m: position r (below), column
    // 8 j + 2 tig + e = re (e = 0) or im (e = 1) of channel 4 j + tig
#pragma unroll
    for (int m = 0; m < kTilesPerWg; ++m) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = kWgSpan * wg + 64 * m + 16 * warp + gid + 8 * h;
        const int t = s_lo + q0 + r;
        const bool valid = live && t >= 0 && t < T;  // lowpass SAME padding
#pragma unroll
        for (int j = 0; j < kAcc / 4; ++j) {
          const float re = tot[m][4 * j + 2 * h], im = tot[m][4 * j + 2 * h + 1];
          ss[(4 * j + tig) * kSsPitch + r] = valid ? re * re + im * im : 0.f;
        }
        if (kSave && live && t >= own_lo && t < own_hi) {
          float* col = conv_out + (size_t)b * 2 * F * T + t;
#pragma unroll
          for (int j = 0; j < kAcc / 4; ++j) {
            const int c = 4 * j + tig;
            if (c < n_live) {
              col[(size_t)(c0 + c) * T] = tot[m][4 * j + 2 * h];
              col[(size_t)(F + c0 + c) * T] = tot[m][4 * j + 2 * h + 1];
            }
          }
        }
      }
    }
    __syncthreads();

    // Fold: (frame fl, channel c) sums win[c, q - 160 fl] * S[q] over the
    // chunk's q in [160 fl, 160 fl + 404); one warp per (fl, c).
    const int fa = q0 >= kWinLen ? (q0 - kWinLen) / kHop + 1 : 0;
    const int fb = min(frames_here - 1, (q0 + kChunk - 1) / kHop);
    const int n_items = (fb - fa + 1) * n_live;
    for (int it = tid >> 5; it < n_items; it += kWarps) {
      const int fl = fa + it / n_live, c = it % n_live;
      const int w0 = kHop * fl;
      const int lo = max(w0, q0), hi = min(w0 + kWinLen, q0 + kChunk);
      const float* wrow = ws + c * kWinLen - w0;
      const float* srow = ss + c * kSsPitch - q0;
      float sum = 0.f;
      for (int q = lo + 4 * lane; q < hi; q += 128) {
        const float4 w = *reinterpret_cast<const float4*>(wrow + q);
        const float4 v = *reinterpret_cast<const float4*>(srow + q);
        sum = fmaf(w.x, v.x, sum);
        sum = fmaf(w.y, v.y, sum);
        sum = fmaf(w.z, v.z, sum);
        sum = fmaf(w.w, v.w, sum);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) sums[fl * kChans + c] += sum;
    }
  }
  __syncthreads();

  for (int i = tid; i < frames_here * kChans; i += kThreads) {
    const int c = i % kChans;
    if (c < n_live) out[((size_t)b * n_frames + f0 + i / kChans) * F + c0 + c] = sums[i];
  }
}

}  // namespace

// Launch the primal (conv_out == nullptr) or the residual-saving kernel on
// `stream`. All pointers are device pointers to contiguous f32 arrays of
// the shapes noted on the kernel; the caller checks them. Returns the CUDA
// error code of the launch (0 on success).
template <bool kSave>
static int launch_fwd(const void* x, const void* gabor, const void* windows,
                      void* out, void* conv_out, int batch, int T, int F,
                      int n_frames, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_fwd_tf32x3_kernel<kSave>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  // a row's frames split evenly over the fewest blocks of <= kMaxFrames
  const int per = (n_frames + (n_frames + kMaxFrames - 1) / kMaxFrames - 1)
                  / ((n_frames + kMaxFrames - 1) / kMaxFrames);
  const int aligned = T % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const dim3 grid((n_frames + per - 1) / per, (F + kChans - 1) / kChans, batch);
  fused_fwd_tf32x3_kernel<kSave><<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(gabor),
      static_cast<const float*>(windows), static_cast<float*>(out),
      static_cast<float*>(conv_out), T, F, n_frames, per, aligned);
  return (int)cudaGetLastError();
}

extern "C" int leaf_fused_fwd_f32(const void* x, const void* gabor,
                                  const void* windows, void* out, int batch,
                                  int T, int F, int n_frames, void* stream) {
  return launch_fwd<false>(x, gabor, windows, out, nullptr, batch, T, F,
                           n_frames, stream);
}

// As leaf_fused_fwd_f32, and also writes conv_out (B, 2F, T).
extern "C" int leaf_fused_fwd_save_f32(const void* x, const void* gabor,
                                       const void* windows, void* out,
                                       void* conv_out, int batch, int T, int F,
                                       int n_frames, void* stream) {
  return launch_fwd<true>(x, gabor, windows, out, conv_out, batch, T, F,
                          n_frames, stream);
}
