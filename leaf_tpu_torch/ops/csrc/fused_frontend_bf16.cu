// Fused Gabor conv -> squared modulus -> Gaussian lowpass, forward, on
// Hopper's tensor cores in bf16 (x and the bank bf16, windows f32, f32
// sums, out f32; the saving variant stores OUT in bf16).
//
// Replaces leaf_tpu/ops/fused_frontend.py:_fwd_kernel under bf16 compute
// (x and bank.astype(x.dtype) bf16, the selectors f32) in both its
// variants: the primal one (save_out=False, kSave = false here) and the
// residual-saving one of the custom VJP (save_out=True, kSave = true),
// whose OUT blocks the JAX op writes at the compute dtype. It computes
//
//   out[b, f, c] = sum_k win[c, k] * S[b, 160 f + k - 200, c]
//   S[b, t, c]   = OUT_re[b, c, t]^2 + OUT_im[b, c, t]^2   for 0 <= t < T,
//   OUT[b, col, t] = sum_j xpad[b, t + j] bank[j, col]     (col: re | im)
//
// with bf16 products and f32 sums, S and the fold in f32 from the f32
// sums (OUT is rounded to bf16 only where it is stored), as the JAX op
// and the plain version (ops/fused_frontend.py) compute.
//
// Bound. OUT is a GEMM, M = B*T positions x N = 2F columns x K = 401
// taps: 2 * B * T * 2F * 401 = 2.63e11 flops at B=256, T=16000, F=40,
// 0.27 ms at the H100's dense bf16 rate of 989 TFLOP/s; |.|^2 and the
// lowpass add ~1.5e9 f32 flops on the CUDA cores (~0.02 ms). The saving
// variant also writes OUT, 2 * B * T * 2F * 2 bytes = 0.66 GB, ~0.20 ms
// at 3.35 TB/s. Both are bound by tensor-core operations.
//
// Design: fused_frontend.cu's (one 64-position tile per warpgroup, four
// warpgroups per 256-position chunk, the bank of the block's 20 channels
// in shared memory, the fold on the CUDA cores), with bf16 operands:
//  - wgmma.mma_async m64n40k16 .bf16: one product per k-step of 16 taps,
//    where 3xTF32 issues three per k-step of 8. Taps padded 401 -> 416
//    (26 k-steps; rows 401..415 zero).
//  - A, the Hankel waveform tile A[t, j] = xpad[t0 + t + j], from
//    registers: thread (warp w, lane 4 g + i) holds, for k-step q, the
//    pairs at xs[p + 16q], xs[p + 16q + 8] (a1 and a2: the Hankel
//    structure makes them equal) and xs[p + 16q + 16] (p = tile start +
//    16 w + g + 2 i). k-step q + 1's a0 is q's a3, so each k-step loads two
//    new pairs, while q's product runs. For odd g a pair straddles two
//    32-bit words: lds_pair reads both and permutes (hopper_bf16.cuh).
//    The wgmma reads the staged waveform directly: no split pass.
//  - B, the bank, bf16, K-major and unswizzled: slabs of 8 taps 656 bytes
//    apart (40 columns x 16 bytes + 16), columns interleaved re/im per
//    channel so that S forms in registers. 34 KB; with the waveform, S,
//    the windows and the sums the block holds 90 KB.
//  - The accumulator is added into f32 registers and restarted every 13
//    k-steps (208 taps), 2 flushes per tile, as the f32 kernel flushes
//    every 136 taps: the tensor cores' accumulator error grows with the
//    terms it sums. Nobody has measured whether bf16 needs it.
//  - The waveform chunk (256 + 440 samples) is staged with 16-byte
//    cp.async when T % 8 == 0 and x is 16-byte aligned, else with 2-byte
//    loads (a waveform that starts one element off its allocation).
//  - kSave: OUT (B, 2F, T) bf16 is stored from the accumulator, rounded
//    to nearest even; lanes g = 0..7 hold 8 consecutive positions of one
//    channel (16 bytes). Only the positions the block owns are written, so
//    every position is written once.
//  - 512 threads; the grid is fused_frontend.cu's (4 x 2 x 256 blocks at
//    B=256, T=16000, F=40), so tests/test_torch_port_fwd_schedule.py's
//    replay holds for both kernels.

#include <cuda_runtime.h>
#include <stdint.h>

// bf16_round, lds_pair, pair_sel, wgmma_bf16, and hopper_tf32.cuh's
// smem_u32, lds, cp_async16, b_desc_of, fence_acc
#include "hopper_bf16.cuh"

namespace {

constexpr int kTaps = 401;
constexpr int kHop = 160;
constexpr int kPadL = 200;
constexpr int kK = 416;                    // taps padded to k-steps of 16
constexpr int kKSteps = kK / 16;           // 26
constexpr int kFlushSteps = 13;            // k-steps between accumulator flushes
constexpr int kChans = 20;                 // channels per block
constexpr int kN = 2 * kChans;             // bank columns, re/im interleaved
constexpr int kAcc = kN / 2;               // accumulator registers per tile
constexpr int kWarpgroups = 4;
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kWarps = kThreads / 32;
constexpr int kWgSpan = 64;                // positions per warpgroup and chunk
constexpr int kChunk = kWgSpan * kWarpgroups;  // 256 positions
// samples a chunk stages: the 256 + 415 the products read, and the pairs
// loaded after the last k-step (unused), rounded up to 16-byte pieces
constexpr int kXsLen = kChunk + kK + 24;   // 696
constexpr int kMaxFrames = 25;             // output frames per block, at most
constexpr int kWinLen = 404;               // window row; taps 401..403 zero
constexpr int kSsPitch = kChunk + 8;       // S row pitch: conflict-free writes
constexpr int kSlabBytes = kN * 16 + 16;   // 8 taps of B, padded
constexpr int kBBytes = (kK / 8) * kSlabBytes;
constexpr int kBankBatch = 8;              // global loads in flight per thread
constexpr size_t kSmemBytes =
    (size_t)kBBytes                        // bank
    + 2 * sizeof(uint16_t) * kXsLen        // waveform double buffer
    + sizeof(float) * (kChans * kSsPitch   // S of one chunk, [channel][position]
                       + kChans * kWinLen  // windows, [channel][tap]
                       + kMaxFrames * kChans);  // window sums, [frame][channel]

static_assert(kKSteps % kFlushSteps == 0, "flushes split the k-steps evenly");
static_assert(kXsLen % 8 == 0 && kChunk % 8 == 0, "16-byte waveform pieces");
static_assert(kBBytes % 16 == 0 && kSlabBytes % 16 == 0,
              "wgmma descriptors address 16-byte units");
static_assert((2 * sizeof(uint16_t) * kXsLen) % 16 == 0, "S and windows 16-byte aligned");
static_assert(kWinLen % 4 == 0 && kSsPitch % 4 == 0 && kWinLen >= kTaps,
              "16-byte fold reads");
static_assert(kSmemBytes <= 232448, "fits a block");

template <bool kSave>
__global__ void __launch_bounds__(kThreads, 1)
fused_fwd_bf16_kernel(const uint16_t* __restrict__ x,       // (B, T) bf16
                      const uint16_t* __restrict__ gabor,   // (401, 2F) bf16 [re | im]
                      const float* __restrict__ windows,    // (F, 401)
                      float* __restrict__ out,              // (B, n_frames, F)
                      uint16_t* __restrict__ conv_out,      // (B, 2F, T) bf16, kSave only
                      int T, int F, int n_frames, int frames_per_block,
                      int aligned) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint16_t* bs = reinterpret_cast<uint16_t*>(smem);
  uint16_t* xraw = reinterpret_cast<uint16_t*>(smem + kBBytes);  // [2][kXsLen]
  float* ss = reinterpret_cast<float*>(xraw + 2 * kXsLen);
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
  // half `buf` of the double buffer: one cp.async group, or 2-byte loads
  const uint16_t* xb = x + (size_t)b * T;
  auto stage_x = [&](int ch, int buf) {
    const int t0 = s_lo - kPadL + ch * kChunk;  // a multiple of 8
    uint16_t* dst = xraw + buf * kXsLen;
    if (aligned) {  // each 16-byte piece lies inside or outside [0, T)
      const uint32_t d = smem_u32(dst);
      for (int i = tid; i < kXsLen / 8; i += kThreads) {
        const int t = t0 + 8 * i;
        const bool live = t >= 0 && t < T;
        cp_async16(d + 16 * i, reinterpret_cast<const float*>(live ? xb + t : xb),
                   live);
      }
    } else {
      for (int i = tid; i < kXsLen; i += kThreads) {
        const int t = t0 + i;
        dst[i] = t >= 0 && t < T ? __ldg(xb + t) : (uint16_t)0;
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  stage_x(ch_lo, 0);

  // The bank (K-major, interleaved columns, zero past tap 401 and past
  // channel F), the windows (zero past tap 401) and the sums.
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
  for (int i = tid; i < kMaxFrames * kChans; i += kThreads) sums[i] = 0.f;
  // generic-proxy stores of the bank -> visible to wgmma's async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");

  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  // this thread's first A pair in buffer 0 (byte address; buffer 1 is
  // 2 * kXsLen bytes on), its word and selector, and the bank descriptor
  // (start >> 4 | slab stride >> 4)
  const uint32_t xa = smem_u32(xraw) + 2 * (kWgSpan * wg + 16 * warp + gid + 2 * tig);
  const uint32_t sel = pair_sel(xa);
  const uint32_t dbase = ((smem_u32(bs) & 0x3FFFF) >> 4) | ((kSlabBytes >> 4) << 16);

  for (int ch = ch_lo; ch < ch_hi; ++ch) {
    const int buf = (ch - ch_lo) & 1;
    if (ch + 1 < ch_hi) {
      stage_x(ch + 1, buf ^ 1);  // its half was read one chunk ago
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();  // this chunk's waveform landed; the last fold is done

    const int q0 = ch * kChunk;
    const int wq = q0 + kWgSpan * wg;  // this warpgroup's first position
    const bool live = wq < q_hi && wq + kWgSpan > q_lo;  // warpgroup-uniform
    float tot[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) tot[i] = 0.f;
    if (live) {
      // A fragment of k-step q: pairs at {xs[p + 16q], xs[p + 16q + 8],
      // xs[p + 16q + 8], xs[p + 16q + 16]}. While q's product runs, the two
      // new pairs of q + 1 are loaded; once it is done a3 -> a0 and they
      // take a1 = a2 and a3.
      const uint32_t w = (xa + buf * 2 * kXsLen) & ~3u;
      uint32_t a[4];
      a[0] = lds_pair(w, sel);
      a[1] = a[2] = lds_pair(w + 16, sel);
      a[3] = lds_pair(w + 32, sel);
      for (int s = 0; s < kKSteps / kFlushSteps; ++s) {
        float acc[kAcc];
#pragma unroll
        for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
#pragma unroll  // as the f32 kernel's: rolled, the wgmmas may serialize
        for (int qq = 0; qq < kFlushSteps; ++qq) {
          const int q = s * kFlushSteps + qq;
          // k-step q reads taps 16q..16q+15: two slabs on
          const uint64_t desc = b_desc_of(dbase + 2 * q * (kSlabBytes >> 4));
          fence_acc(acc);
          asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
          wgmma_bf16(acc, a, desc);
          asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
          // pairs at xs[p + 16q + 24] and xs[p + 16q + 32]: a1 = a2 and a3
          // of k-step q + 1 (after the last k-step, staged but unused)
          const uint32_t n1 = lds_pair(w + 32 * q + 48, sel);
          const uint32_t n3 = lds_pair(w + 32 * q + 64, sel);
          asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
          fence_acc(acc);
          a[0] = a[3];
          a[1] = a[2] = n1;
          a[3] = n3;
        }
#pragma unroll
        for (int i = 0; i < kAcc; ++i) tot[i] += acc[i];
      }
    }

    // accumulator entry 4 j + 2 h + e: position r (below), column
    // 8 j + 2 tig + e = re (e = 0) or im (e = 1) of channel 4 j + tig
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = kWgSpan * wg + 16 * warp + gid + 8 * h;
      const int t = s_lo + q0 + r;
      const bool valid = live && t >= 0 && t < T;  // lowpass SAME padding
#pragma unroll
      for (int j = 0; j < kAcc / 4; ++j) {
        const float re = tot[4 * j + 2 * h], im = tot[4 * j + 2 * h + 1];
        ss[(4 * j + tig) * kSsPitch + r] = valid ? re * re + im * im : 0.f;
      }
      if (kSave && live && t >= own_lo && t < own_hi) {
        uint16_t* col = conv_out + (size_t)b * 2 * F * T + t;
#pragma unroll
        for (int j = 0; j < kAcc / 4; ++j) {
          const int c = 4 * j + tig;
          if (c < n_live) {
            col[(size_t)(c0 + c) * T] = float_to_bf16(tot[4 * j + 2 * h]);
            col[(size_t)(F + c0 + c) * T] = float_to_bf16(tot[4 * j + 2 * h + 1]);
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
        const float4 wv = *reinterpret_cast<const float4*>(wrow + q);
        const float4 v = *reinterpret_cast<const float4*>(srow + q);
        sum = fmaf(wv.x, v.x, sum);
        sum = fmaf(wv.y, v.y, sum);
        sum = fmaf(wv.z, v.z, sum);
        sum = fmaf(wv.w, v.w, sum);
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
// `stream`. x, gabor and conv_out are device pointers to contiguous bf16
// arrays, windows and out to f32 ones, of the shapes noted on the kernel;
// the caller checks them. Returns the CUDA error code of the launch.
template <bool kSave>
static int launch_fwd(const void* x, const void* gabor, const void* windows,
                      void* out, void* conv_out, int batch, int T, int F,
                      int n_frames, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_fwd_bf16_kernel<kSave>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  // a row's frames split evenly over the fewest blocks of <= kMaxFrames
  const int per = (n_frames + (n_frames + kMaxFrames - 1) / kMaxFrames - 1)
                  / ((n_frames + kMaxFrames - 1) / kMaxFrames);
  const int aligned = T % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const dim3 grid((n_frames + per - 1) / per, (F + kChans - 1) / kChans, batch);
  fused_fwd_bf16_kernel<kSave><<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(gabor),
      static_cast<const float*>(windows), static_cast<float*>(out),
      static_cast<uint16_t*>(conv_out), T, F, n_frames, per, aligned);
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
