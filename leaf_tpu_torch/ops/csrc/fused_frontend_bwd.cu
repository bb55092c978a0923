// Fused Gabor conv -> squared modulus -> Gaussian lowpass, backward, f32.
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
// per (batch row, position tile, 8-pair group) block, and writes the
// block's d_bank (401 x 16) and d_win (8 x 401) sums as partials; the
// wrapper adds the partials over rows and tiles (a fixed-order torch.sum,
// so the result is deterministic). The waveform gradient is zero by the
// op's contract and is not computed here.
//
// Bound: f32 operations. The d_bank correlation is 2 * B * T * 2F * 401
// flops (2.6e11 at B=256, T=16000, F=40), the same as the forward's conv;
// dS and d_win add ~1%. It reads OUT once (1.31 GB, ~0.4 ms at 3.35 TB/s)
// and dOUT never reaches device memory. Design: a block walks its tile
// in kChunk-position chunks. Per chunk it stages the waveform span with
// the 400-sample halo and the cotangent rows of the frames that touch the
// chunk, reads OUT (a warp takes 4 consecutive positions of 8 channels;
// the kernel is bound by operations, not by these reads), forms S and
// dOUT into shared memory, folds S
// into the d_win sums (one thread per tap k, so no two threads touch one
// sum), and then each thread adds the chunk's products into a register
// tile of 4 taps x 16 bank columns (taps j = tid + 128 p; only warp 0
// carries a 4th tap, j = 384 + lane < 401, so warps 1-3 run a 3-tap loop).
// dOUT values are shared-memory broadcasts, waveform reads are
// conflict-free, as in the forward.

#include <cuda_runtime.h>

namespace {

constexpr int kTaps = 401;
constexpr int kHop = 160;
constexpr int kPadL = 200;
constexpr int kPairs = 8;                       // channel pairs per block
constexpr int kCols = 2 * kPairs;               // bank columns per block: re 0..7 | im 0..7
constexpr int kThreads = 128;
constexpr int kTapSlots = 4;                    // taps per thread: tid + 128 p
constexpr int kChunk = 256;                     // positions per chunk
constexpr int kXsLen = kChunk + kThreads * kTapSlots;  // span + halo, padded to slot 3's reach
constexpr int kMaxFrames = (kChunk + kTaps - 2) / kHop + 2;  // frames touching a chunk
// S is kept channel-major with a padded row, kChunk + 4: the writes of
// thread (pair c, position q) fall on bank 4c + q (q < 4 within a warp)
// and the d_win reads of consecutive positions on consecutive banks.
constexpr int kSsStride = kChunk + 4;

constexpr size_t kSmemBytes =
    sizeof(float) * (size_t)(kChunk * kCols      // dOUT of one chunk, [position][col]
                             + kPairs * kSsStride  // S of one chunk, [pair][position]
                             + kPairs * kTaps    // windows, [pair][tap]
                             + kPairs * kTaps    // d_win sums, [pair][tap]
                             + kMaxFrames * kPairs  // dY rows of the chunk's frames
                             + kXsLen);          // waveform span + halo

// acc[p][col] += sum_{q < n} xs[q + j0 + 128 p] * dOUT[q][col], p < kSlots
template <int kSlots>
__device__ __forceinline__ void correlate_chunk(float (&acc)[kTapSlots][kCols],
                                                const float* __restrict__ xs,
                                                const float4* __restrict__ dos,
                                                int n, int j0) {
#pragma unroll 2
  for (int q = 0; q < n; ++q) {
    const float4 d0 = dos[4 * q], d1 = dos[4 * q + 1];
    const float4 d2 = dos[4 * q + 2], d3 = dos[4 * q + 3];
#pragma unroll
    for (int p = 0; p < kSlots; ++p) {
      const float v = xs[q + j0 + kThreads * p];
      acc[p][0] = fmaf(v, d0.x, acc[p][0]);
      acc[p][1] = fmaf(v, d0.y, acc[p][1]);
      acc[p][2] = fmaf(v, d0.z, acc[p][2]);
      acc[p][3] = fmaf(v, d0.w, acc[p][3]);
      acc[p][4] = fmaf(v, d1.x, acc[p][4]);
      acc[p][5] = fmaf(v, d1.y, acc[p][5]);
      acc[p][6] = fmaf(v, d1.z, acc[p][6]);
      acc[p][7] = fmaf(v, d1.w, acc[p][7]);
      acc[p][8] = fmaf(v, d2.x, acc[p][8]);
      acc[p][9] = fmaf(v, d2.y, acc[p][9]);
      acc[p][10] = fmaf(v, d2.z, acc[p][10]);
      acc[p][11] = fmaf(v, d2.w, acc[p][11]);
      acc[p][12] = fmaf(v, d3.x, acc[p][12]);
      acc[p][13] = fmaf(v, d3.y, acc[p][13]);
      acc[p][14] = fmaf(v, d3.z, acc[p][14]);
      acc[p][15] = fmaf(v, d3.w, acc[p][15]);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 4)
fused_bwd_f32_kernel(const float* __restrict__ x,          // (B, T)
                     const float* __restrict__ conv_out,   // (B, 2F, T) [re | im]
                     const float* __restrict__ windows,    // (F, 401)
                     const float* __restrict__ d_out,      // (B, n_frames, F)
                     float* __restrict__ dbank_part,       // (B, n_tiles, G, 401, 16)
                     float* __restrict__ dwin_part,        // (B, n_tiles, G, 8, 401)
                     int T, int F, int n_frames, int tile) {
  extern __shared__ float4 smem[];
  float4* dos = smem;                                        // 4 float4 per position
  float* ss = reinterpret_cast<float*>(dos + kChunk * 4);
  float* ws = ss + kPairs * kSsStride;
  float* dws = ws + kPairs * kTaps;
  float* dys = dws + kPairs * kTaps;
  float* xs = dys + kMaxFrames * kPairs;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int n_tiles = gridDim.x, n_groups = gridDim.y;
  const int tx = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int c0 = g * kPairs;
  const int tile_lo = tx * tile, tile_hi = min(tile_lo + tile, T);

  for (int i = tid; i < kPairs * kTaps; i += kThreads) {
    const int c = c0 + i / kTaps;
    ws[i] = c < F ? windows[(size_t)c * kTaps + i % kTaps] : 0.f;
    dws[i] = 0.f;
  }

  float acc[kTapSlots][kCols];
#pragma unroll
  for (int p = 0; p < kTapSlots; ++p) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[p][c] = 0.f;
  }

  const float* xb = x + (size_t)b * T;
  const float* ob = conv_out + (size_t)b * 2 * F * T;
  for (int t0 = tile_lo; t0 < tile_hi; t0 += kChunk) {
    const int n = min(kChunk, tile_hi - t0);
    // frames whose window [160 f - 200, 160 f + 200] meets [t0, t0 + n)
    const int f_lo = t0 > kPadL ? (t0 - kPadL + kHop - 1) / kHop : 0;
    const int f_hi = min(n_frames - 1, (t0 + n - 1 + kPadL) / kHop);
    for (int i = tid; i < kMaxFrames * kPairs; i += kThreads) {
      const int f = f_lo + i / kPairs, c = c0 + i % kPairs;
      dys[i] = (f <= f_hi && c < F) ? d_out[((size_t)b * n_frames + f) * F + c] : 0.f;
    }
    for (int i = tid; i < kXsLen; i += kThreads) {
      const int t = t0 - kPadL + i;  // xs[q + j] = xpad[t0 + q + j]
      xs[i] = (t >= 0 && t < T) ? xb[t] : 0.f;
    }
    __syncthreads();

    // S and dOUT of the chunk's positions; thread (pair c, positions
    // q = tid / 8 + 16 r): a warp reads 4 positions of 8 channels at once.
    {
      const int c = tid % kPairs;
      const bool live_c = c0 + c < F;
      float* dosf = reinterpret_cast<float*>(dos);
      for (int q = tid / kPairs; q < kChunk; q += kThreads / kPairs) {
        const int t = t0 + q;
        float re = 0.f, im = 0.f, ds = 0.f;
        if (q < n && live_c) {
          re = ob[(size_t)(c0 + c) * T + t];
          im = ob[(size_t)(F + c0 + c) * T + t];
          const int fa = max(f_lo, t > kPadL ? (t - kPadL + kHop - 1) / kHop : 0);
          const int fb = min(f_hi, (t + kPadL) / kHop);
          for (int f = fa; f <= fb; ++f)  // tap t + 200 - 160 f is in [0, 401)
            ds = fmaf(dys[(f - f_lo) * kPairs + c], ws[c * kTaps + t + kPadL - kHop * f], ds);
        }
        ss[c * kSsStride + q] = re * re + im * im;
        dosf[q * kCols + c] = 2.f * re * ds;
        dosf[q * kCols + kPairs + c] = 2.f * im * ds;
      }
    }
    __syncthreads();

    // d_win[c, k] += dY[f, c] * S[160 f + k - 200, c]; thread owns taps k.
    for (int f = f_lo; f <= f_hi; ++f) {
      for (int k = tid; k < kTaps; k += kThreads) {
        const int q = kHop * f + k - kPadL - t0;
        if (q >= 0 && q < n) {
#pragma unroll
          for (int c = 0; c < kPairs; ++c)
            dws[c * kTaps + k] = fmaf(dys[(f - f_lo) * kPairs + c], ss[c * kSsStride + q],
                                      dws[c * kTaps + k]);
        }
      }
    }

    // d_bank[j, col] += sum_q xpad[t0 + q + j] * dOUT[q][col]
    if (warp == 0)
      correlate_chunk<kTapSlots>(acc, xs, dos, n, tid);
    else
      correlate_chunk<kTapSlots - 1>(acc, xs, dos, n, tid);
    __syncthreads();
  }

  const size_t part = ((size_t)b * n_tiles + tx) * n_groups + g;
  float* db = dbank_part + part * kTaps * kCols;
#pragma unroll
  for (int p = 0; p < kTapSlots; ++p) {
    const int j = tid + kThreads * p;
    if (j < kTaps) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) db[j * kCols + c] = acc[p][c];
    }
  }
  float* dw = dwin_part + part * kPairs * kTaps;
  for (int i = tid; i < kPairs * kTaps; i += kThreads) dw[i] = dws[i];
}

}  // namespace

// Launches the kernel on `stream` over a (ceil(T / tile), ceil(F / 8), B)
// grid. All pointers are device pointers to contiguous f32 arrays of the
// shapes noted on the kernel; the caller checks them and sizes the
// partials. Returns the CUDA error code of the launch (0 on success).
extern "C" int leaf_fused_bwd_f32(const void* x, const void* conv_out,
                                  const void* windows, const void* d_out,
                                  void* dbank_part, void* dwin_part, int batch,
                                  int T, int F, int n_frames, int tile,
                                  void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_bwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + tile - 1) / tile, (F + kPairs - 1) / kPairs, batch);
  fused_bwd_f32_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(conv_out),
      static_cast<const float*>(windows), static_cast<const float*>(d_out),
      static_cast<float*>(dbank_part), static_cast<float*>(dwin_part), T, F,
      n_frames, tile);
  return (int)cudaGetLastError();
}
