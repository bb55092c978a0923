// Fused Gabor conv -> squared modulus -> Gaussian lowpass, forward, f32.
//
// Replaces leaf_tpu/ops/fused_frontend.py:_fwd_kernel in both its variants
// together with the XLA glue around it (_toeplitz_full, _build_selectors,
// _combine_partials): the primal one (save_out=False, kSave = false here)
// and the residual-saving one of the custom VJP (save_out=True, kSave =
// true), which also writes the conv outputs for the backward kernel
// (fused_frontend_bwd.cu). It computes, directly,
//
//   out[b, f, c] = sum_k win[c, k] * S[b, 160 f + k - 200, c]
//   S[b, t, c]   = (sum_j xpad[b, t + j] g_re[j, c])^2
//                + (sum_j xpad[b, t + j] g_im[j, c])^2     for 0 <= t < T,
//
// S = 0 outside [0, T), xpad = x with 200 zeros in front (TF-SAME), taps
// j, k in [0, 401), stride 160. No Toeplitz operand, no slot selectors.
//
// Bound: f32 operations. The 401-tap conv is 2 * B * T * 2F * 401 flops
// (2.6e11 at B=256, T=16000, F=40) against ~17 MB of inputs and outputs,
// so the H100's 67 TFLOP/s f32 (non-tensor) rate bounds it at ~3.9 ms,
// far above the ~5 us its bytes need. Design: the (B, T, 2F) conv output
// and the (B, T, F) squared modulus never reach device memory. One block
// owns (batch row, kFrames frames, kPairs channel pairs). It stages its
// waveform span with the 400-sample halo, its pairs' real and imaginary
// bank columns and its windows in shared memory, then walks the span in
// kChunk-position chunks: each thread keeps a kPosPerThread x kPairs
// register tile of both conv outputs over the 401 taps (bank values are
// shared-memory broadcasts, waveform reads are conflict-free), writes the
// chunk's S to shared memory, and the block folds the chunk into its
// frames' window sums. Neighbouring frame tiles recompute the 241 S
// positions their windows share (~12% extra conv work at kFrames = 20) so
// that no block depends on another and the sums are deterministic.
//
// kSave: the block also writes the conv outputs it computed to
// conv_out (B, 2F, T) [re channels | im channels], channel-major so that a
// warp's 32 consecutive positions of one channel are one 128-byte store.
// Only positions the block OWNS are written, [160 f0, 160 (f0 + kFrames))
// clipped to [0, T): the 241 shared positions that a neighbouring tile
// recomputes are written once, by one block, and the union over blocks is
// exactly [0, T). The writes add 2 * B * T * 2F * 4 bytes (1.31 GB at
// B=256, T=16000, F=40, ~0.4 ms at 3.35 TB/s) under the conv's ~3.9 ms of
// f32 operations; the JAX package's VJP saves rather than recomputes for
// the same reason (the backward would repeat the 2.6e11 conv operations).

#include <cuda_runtime.h>

namespace {

constexpr int kTaps = 401;
constexpr int kHop = 160;
constexpr int kPadL = 200;
constexpr int kPairs = 8;                               // channel pairs per block
constexpr int kThreads = 128;
constexpr int kPosPerThread = 4;
constexpr int kChunk = kThreads * kPosPerThread;        // 512 S positions per chunk
constexpr int kFrames = 20;                             // output frames per block
constexpr int kSpan = kHop * (kFrames - 1) + kTaps;     // S positions a full tile reads
constexpr int kChunks = (kSpan + kChunk - 1) / kChunk;
constexpr int kXsLen = kChunks * kChunk + kTaps - 1;    // staged waveform samples
constexpr int kSlots = kFrames * kPairs;                // (frame, pair) outputs per block
constexpr int kSlotsPerThread = (kSlots + kThreads - 1) / kThreads;

constexpr size_t kSmemBytes =
    sizeof(float) * (size_t)(kTaps * 2 * kPairs    // bank, [tap][re 0..7 | im 0..7]
                             + kChunk * kPairs     // S of one chunk, [position][pair]
                             + kPairs * kTaps      // windows, [pair][tap]
                             + kXsLen);            // waveform span + halo

template <bool kSave>
__global__ void __launch_bounds__(kThreads)
fused_fwd_f32_kernel(const float* __restrict__ x,        // (B, T)
                     const float* __restrict__ gabor,    // (401, 2F) [re | im]
                     const float* __restrict__ windows,  // (F, 401)
                     float* __restrict__ out,            // (B, n_frames, F)
                     float* __restrict__ conv_out,       // (B, 2F, T), kSave only
                     int T, int F, int n_frames) {
  extern __shared__ float4 smem[];
  float4* gs = smem;                                     // 4 float4 per tap
  float* ss = reinterpret_cast<float*>(gs + kTaps * 4);
  float* ws = ss + kChunk * kPairs;
  float* xs = ws + kPairs * kTaps;

  const int tid = threadIdx.x;
  const int f0 = blockIdx.x * kFrames;
  const int c0 = blockIdx.y * kPairs;
  const int b = blockIdx.z;
  const int s_lo = f0 * kHop - kPadL;  // first S position this block's windows read
  const int frames_here = min(kFrames, n_frames - f0);
  const int span = kHop * (frames_here - 1) + kTaps;
  // conv positions this block owns (kSave): its frames' hops, within [0, T)
  const int own_lo = f0 * kHop, own_hi = min((f0 + kFrames) * kHop, T);

  // Stage the bank (zero columns past F), the windows and the waveform.
  float* gsf = reinterpret_cast<float*>(gs);
  for (int i = tid; i < kTaps * 2 * kPairs; i += kThreads) {
    const int j = i / (2 * kPairs), col = i % (2 * kPairs);
    const int c = c0 + col % kPairs;
    gsf[i] = c < F ? gabor[(size_t)j * 2 * F + (col >= kPairs ? F : 0) + c] : 0.f;
  }
  for (int i = tid; i < kPairs * kTaps; i += kThreads) {
    const int c = c0 + i / kTaps;
    ws[i] = c < F ? windows[(size_t)c * kTaps + i % kTaps] : 0.f;
  }
  const float* xb = x + (size_t)b * T;
  for (int i = tid; i < kXsLen; i += kThreads) {
    const int t = s_lo - kPadL + i;  // xs[q + j] = xpad[s_lo + q + j]
    xs[i] = (t >= 0 && t < T) ? xb[t] : 0.f;
  }
  __syncthreads();

  float acc[kSlotsPerThread];
#pragma unroll
  for (int a = 0; a < kSlotsPerThread; ++a) acc[a] = 0.f;

  const int warp = tid >> 5, lane = tid & 31;
  const int q_thread = warp * 32 * kPosPerThread + lane;  // this thread's positions: + 32 p
  for (int q0 = 0; q0 < span; q0 += kChunk) {
    const int t0 = s_lo + q0;
    if (t0 + kChunk <= 0 || t0 >= T) continue;  // S is all zero here (block-uniform)

    float re[kPosPerThread][kPairs], im[kPosPerThread][kPairs];
#pragma unroll
    for (int p = 0; p < kPosPerThread; ++p) {
#pragma unroll
      for (int c = 0; c < kPairs; ++c) re[p][c] = im[p][c] = 0.f;
    }
    const float* xq = xs + q0 + q_thread;
#pragma unroll 4
    for (int j = 0; j < kTaps; ++j) {
      const float4 r0 = gs[4 * j], r1 = gs[4 * j + 1];
      const float4 i0 = gs[4 * j + 2], i1 = gs[4 * j + 3];
#pragma unroll
      for (int p = 0; p < kPosPerThread; ++p) {
        const float v = xq[32 * p + j];
        re[p][0] = fmaf(v, r0.x, re[p][0]);
        re[p][1] = fmaf(v, r0.y, re[p][1]);
        re[p][2] = fmaf(v, r0.z, re[p][2]);
        re[p][3] = fmaf(v, r0.w, re[p][3]);
        re[p][4] = fmaf(v, r1.x, re[p][4]);
        re[p][5] = fmaf(v, r1.y, re[p][5]);
        re[p][6] = fmaf(v, r1.z, re[p][6]);
        re[p][7] = fmaf(v, r1.w, re[p][7]);
        im[p][0] = fmaf(v, i0.x, im[p][0]);
        im[p][1] = fmaf(v, i0.y, im[p][1]);
        im[p][2] = fmaf(v, i0.z, im[p][2]);
        im[p][3] = fmaf(v, i0.w, im[p][3]);
        im[p][4] = fmaf(v, i1.x, im[p][4]);
        im[p][5] = fmaf(v, i1.y, im[p][5]);
        im[p][6] = fmaf(v, i1.z, im[p][6]);
        im[p][7] = fmaf(v, i1.w, im[p][7]);
      }
    }
#pragma unroll
    for (int p = 0; p < kPosPerThread; ++p) {
      const int q = q_thread + 32 * p;
      const bool valid = t0 + q >= 0 && t0 + q < T;  // lowpass SAME padding: S = 0 outside
#pragma unroll
      for (int c = 0; c < kPairs; ++c)
        ss[q * kPairs + c] = valid ? re[p][c] * re[p][c] + im[p][c] * im[p][c] : 0.f;
      if (kSave && t0 + q >= own_lo && t0 + q < own_hi) {
        float* col = conv_out + (size_t)b * 2 * F * T + t0 + q;
#pragma unroll
        for (int c = 0; c < kPairs; ++c) {
          if (c0 + c < F) {
            col[(size_t)(c0 + c) * T] = re[p][c];
            col[(size_t)(F + c0 + c) * T] = im[p][c];
          }
        }
      }
    }
    __syncthreads();

    // Fold this chunk into the window sums of the (frame, pair) slots.
#pragma unroll
    for (int a = 0; a < kSlotsPerThread; ++a) {
      const int slot = tid + a * kThreads;
      if (slot < frames_here * kPairs) {
        const int w0 = (slot / kPairs) * kHop;  // window start, relative to s_lo
        const int pc = slot % kPairs;
        const int lo = max(w0, q0), hi = min(w0 + kTaps, q0 + kChunk);
        const float* wrow = ws + pc * kTaps - w0;
        float sum = acc[a];
        for (int q = lo; q < hi; ++q) sum = fmaf(wrow[q], ss[(q - q0) * kPairs + pc], sum);
        acc[a] = sum;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int a = 0; a < kSlotsPerThread; ++a) {
    const int slot = tid + a * kThreads;
    const int c = c0 + slot % kPairs;
    if (slot < frames_here * kPairs && c < F)
      out[((size_t)b * n_frames + f0 + slot / kPairs) * F + c] = acc[a];
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
      fused_fwd_f32_kernel<kSave>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_frames + kFrames - 1) / kFrames, (F + kPairs - 1) / kPairs,
                  batch);
  fused_fwd_f32_kernel<kSave><<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(gabor),
      static_cast<const float*>(windows), static_cast<float*>(out),
      static_cast<float*>(conv_out), T, F, n_frames);
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
