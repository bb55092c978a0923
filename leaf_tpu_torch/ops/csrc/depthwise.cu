// Depthwise 2-D convolution with TF-SAME padding, NCHW float32: the forward,
// the input gradient and the weight gradient of EfficientNet's MBConv
// depthwise convolutions (leaf_tpu_torch/ops/depthwise.py binds them).
//
//   y[n, oh, ow] = sum_{i,j} w[c, i, j] * xpad[n, S oh + i, S ow + j]
//
// n = b C + c a (batch row, channel) plane, xpad = x with the TF-SAME pads
// (pt, pb) on H and (pl, pr) on W, zero there; k x k taps, stride S.
//
// Replaces no TPU kernel: the JAX package leaves the depthwise conv to XLA
// (flax nn.Conv with feature_group_count = C). On the H100 PyTorch runs an
// f32 depthwise conv through its native conv_depthwise2d kernels (cuDNN takes
// depthwise convs only in half precision), behind an F.pad copy. In the
// flagship train step (LEAF + EfficientNet-b0, B = 256, 16 depthwise sites,
// a 36.3 ms step) the native weight gradient took 5.07 ms a step and the
// input gradient 1.36 ms; with the forward and the pad copies and their
// backwards, 7.5-8 ms.
//
// Bound. Each pass reads its operands once and writes its result once: x
// and y (forward), dy and dx (input gradient), x and dy (weight gradient).
// At b0's 16 sites, B = 256, that is 348.8 MB of x and 228.0 MB of y a pass,
// ~0.17 ms at 3.35 TB/s; the arithmetic, 1.8 GFLOP a pass, takes ~0.03 ms on
// the f32 FMA units. Every pass is bound by device memory. The native weight
// gradient gives one block to each (channel, tap) and re-reads the channel's
// whole batch of x and dy in each: k^2 (9 or 25) reads of both, and only
// C k^2 blocks, too few for 132 SMs at the narrow sites.
//
// Design: every tensor is read once, in 16-byte loads, and written once.
//  - Tiles. A block owns P consecutive (b, c) planes, which NCHW lays out
//    as one contiguous run, or, for a plane larger than the tile budget
//    (AudioSet's 5 s clips give b0 a 32 x 250 stem output), a band of
//    rows of one plane, also contiguous. It zeroes its shared-memory tile,
//    copies the run into it with its halo (stage_in: 16-byte slots of the
//    run, each element placed at its padded position, so the TF-SAME pad
//    is the zero halo and no padded tensor exists), computes from shared
//    memory into a shared output tile and writes that run back with
//    16-byte stores (stage_out). P and the rows per tile come from the
//    shape (depthwise.py's plans): one algorithm for planes from 32 x 250
//    down to 4 x 2, with C from 32 to 1152.
//  - Forward (depthwise_fwd): 256 / P threads per plane, the plane's k^2
//    taps in registers, one output per thread at a time: k^2 shared loads
//    and FMAs, each output written once.
//  - Input gradient (depthwise_dgrad): the transposed conv as a gather. A
//    dx pixel at padded row u = ih + pt = S a + r (r < S) receives dy[a - m]
//    w[S m + r] for S m + r < k, and likewise on W. A thread owns a coarse
//    position (a, b) and computes the S^2 dx pixels that share it (their
//    parities), reading each of the ceil(k/S)^2 dy values once and each tap
//    once: only the dy positions that reach a pixel are read, and dx is
//    written once, nothing accumulated in device memory.
//  - Weight gradient (depthwise_wgrad): a block owns CT channels and a
//    chunk of the batch (CT and the chunk from the shape, so that the grid
//    is one wave of three blocks an SM at every site). For each batch row it stages
//    the CT planes of x (with halo) and of dy once; the 256 / CT threads of
//    a channel each accumulate all k^2 taps over their share of positions
//    in registers. Warp shuffles and one fixed-order pass over the warps
//    reduce them, and the block writes its partial (chunk, C, k, k).
//    depthwise_wgrad_sum adds the chunks in chunk order. No atomics: the
//    same operands give the same bits on every call, eager or replayed.
//    The k^2 sums cost registers: the kernel is held to 80 (three blocks an
//    SM, the staging one slot a thread a tensor), which on the H100 ran
//    8 % faster than two blocks of 98 registers, and four blocks spill.

#include <cuda_runtime.h>
#include <stdint.h>

namespace leaf_tpu_torch {

constexpr int kThreads = 256;
// shared memory a block may take without an opt-in attribute
constexpr int kMaxSmemBytes = 48 * 1024;

// n / d as one multiply-high, m = floor(2^32 / d) + 1: exact for n d < 2^32
struct Div {
  unsigned d, m;
};

inline Div make_div(unsigned d) {
  Div r;
  r.d = d;
  r.m = d <= 1 ? 0u : (unsigned)((1ull << 32) / d + 1);
  return r;
}

__device__ __forceinline__ Div make_div_device(unsigned d) {
  Div r;
  r.d = d;
  r.m = d <= 1 ? 0u : (unsigned)((1ull << 32) / d + 1);
  return r;
}

__device__ __forceinline__ unsigned divide(unsigned n, Div q) {
  return q.d == 1 ? n : __umulhi(n, q.m);
}

__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

// A staged operand: source planes of hs x ws floats; in shared memory
// [plane][rows][wp] with planes ps floats apart (ps = rows * wp made odd,
// so that the threads of a warp that read one position of 32 planes hit
// 32 banks), source row r at row r - row0, column c at c + col0.
struct Stage {
  int hs, ws, rows, wp, ps;
  Div d_plane, d_ws;  // by hs * ws and by ws
};

inline Stage make_stage(int hs, int ws, int rows, int wp) {
  Stage s;
  s.hs = hs;
  s.ws = ws;
  s.rows = rows;
  s.wp = wp;
  s.ps = rows * wp | 1;
  s.d_plane = make_div((unsigned)(hs * ws));
  s.d_ws = make_div((unsigned)ws);
  return s;
}

__device__ __forceinline__ void zero(float* sm, int n4) {
  float4* s = reinterpret_cast<float4*>(sm);
  for (int i = threadIdx.x; i < n4; i += kThreads)
    s[i] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// One copy into shared memory: rows [r_lo, r_hi) of np planes (np > 1:
// whole planes) from each of n_runs runs, run r at src + r * src_step,
// into sm + r * sm_step. A run is contiguous in src: it is read in aligned
// 16-byte slots (its first and last slots element by element).
struct Job {
  const float* src;
  long long src_step;
  float* sm;
  int sm_step, np, beg, end, row0, col0, per_run, n_slots;
  Div d_run;
  Stage g;
};

__device__ __forceinline__ Job make_job(const float* src, long long src_step,
                                        int n_runs, int np, int r_lo, int r_hi,
                                        int row0, int col0, const Stage& g,
                                        float* sm, int sm_step) {
  Job j;
  j.src = src;
  j.src_step = src_step;
  j.sm = sm;
  j.sm_step = sm_step;
  j.np = np;
  j.beg = r_lo * g.ws;
  j.end = max((np - 1) * g.hs * g.ws + r_hi * g.ws, j.beg);
  j.row0 = row0;
  j.col0 = col0;
  j.per_run = (j.end - j.beg + 6) >> 2;  // slots of a run, at most
  j.d_run = make_div_device((unsigned)j.per_run);
  j.n_slots = j.end > j.beg ? n_runs * j.per_run : 0;
  j.g = g;
  return j;
}

// Slots q0, q0 + 256, ... (kUnroll of them): their loads, all in flight
// before place_slots puts their elements at their padded positions.
template <int U>
struct Slots {
  float v[U][4];
  int e[U], run[U];
};

template <int U>
__device__ __forceinline__ void load_slots(const Job& j, int q0,
                                           Slots<U>& s) {
#pragma unroll
  for (int t = 0; t < U; ++t) {
    const int q = q0 + t * kThreads;
    s.run[t] = (int)divide((unsigned)q, j.d_run);
    const float* rs = j.src + s.run[t] * j.src_step;
    const int mis = (int)((reinterpret_cast<uintptr_t>(rs + j.beg) >> 2) & 3);
    s.e[t] = j.beg - mis + 4 * (q - s.run[t] * j.per_run);
    if (q >= j.n_slots || s.e[t] >= j.end) {
      s.e[t] = j.end;  // nothing to place
    } else if (s.e[t] >= j.beg && s.e[t] + 4 <= j.end) {
      const float4 x4 = __ldg(reinterpret_cast<const float4*>(rs + s.e[t]));
      s.v[t][0] = x4.x;
      s.v[t][1] = x4.y;
      s.v[t][2] = x4.z;
      s.v[t][3] = x4.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        s.v[t][i] = (s.e[t] + i >= j.beg && s.e[t] + i < j.end)
                        ? __ldg(rs + s.e[t] + i)
                        : 0.f;
    }
  }
}

template <int U>
__device__ __forceinline__ void place_slots(const Job& j, const Slots<U>& s) {
  const Stage& g = j.g;
#pragma unroll
  for (int t = 0; t < U; ++t) {
    float* rsm = j.sm + s.run[t] * j.sm_step;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int u = s.e[t] + i;
      if (u < j.beg || u >= j.end) continue;
      const unsigned p = j.np == 1 ? 0u : divide((unsigned)u, g.d_plane);
      const unsigned rem = (unsigned)u - p * (unsigned)(g.hs * g.ws);
      const unsigned r = divide(rem, g.d_ws);
      const int c = (int)(rem - r * (unsigned)g.ws);
      rsm[(int)p * g.ps + ((int)r - j.row0) * g.wp + c + j.col0] = s.v[t][i];
    }
  }
}

// Run one job: kUnroll slots a thread in flight at a time.
constexpr int kUnroll = 4;

__device__ void stage_in(const Job& j) {
  for (int q0 = threadIdx.x; q0 < j.n_slots; q0 += kThreads * kUnroll) {
    Slots<kUnroll> s;
    load_slots(j, q0, s);
    place_slots(j, s);
  }
}

// Run two jobs side by side (the weight gradient's x and dy): one slot of
// each in flight a thread before either is placed.
__device__ void stage_in(const Job& a, const Job& b) {
  constexpr int U = 1;
  const int n = max(a.n_slots, b.n_slots);
  for (int q0 = threadIdx.x; q0 < n; q0 += kThreads * U) {
    Slots<U> sa, sb;
    load_slots(a, q0, sa);
    load_slots(b, q0, sb);
    place_slots(a, sa);
    place_slots(b, sb);
  }
}

// Write the n floats of sm to the contiguous run at dst, in aligned 16-byte
// stores (the run's first and last slots element by element).
__device__ void stage_out(float* __restrict__ dst, int n, const float* sm) {
  const int mis = (int)((reinterpret_cast<uintptr_t>(dst) >> 2) & 3);
  const int n_slots = (n + mis + 3) >> 2;
  for (int q = threadIdx.x; q < n_slots; q += kThreads) {
    const int e = 4 * q - mis;
    if (e >= 0 && e + 4 <= n) {
      *reinterpret_cast<float4*>(dst + e) =
          make_float4(sm[e], sm[e + 1], sm[e + 2], sm[e + 3]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (e + i >= 0 && e + i < n) dst[e + i] = sm[e + i];
    }
  }
}

struct FwdArgs {
  const float* x;
  const float* w;
  float* y;
  int n_planes, C, H, W, OH, OW, pt, pl;
  int P, TH, n_th;  // planes per tile, output rows per tile, row tiles
  Stage in;         // x: H x W planes, rows (TH - 1) S + k, wp W + pl + pr
  Div d_ow;
};

template <int K, int S>
__global__ void __launch_bounds__(kThreads) depthwise_fwd(FwdArgs a) {
  extern __shared__ float4 smem[];
  float* sx = reinterpret_cast<float*>(smem);
  const int in_floats = round4(a.P * a.in.ps);
  float* sy = sx + in_floats;
  const int group = blockIdx.x / a.n_th, th = blockIdx.x - group * a.n_th;
  const int n0 = group * a.P;
  const int np = min(a.P, a.n_planes - n0);
  const int oh0 = th * a.TH, nrow = min(a.TH, a.OH - oh0);
  const int row0 = oh0 * S - a.pt;  // x row of the tile's first row
  const int tp = kThreads / a.P;    // threads per plane
  const int p = threadIdx.x / tp, lane = threadIdx.x - p * tp;
  // the plane's taps, loaded while the tile is staged
  float wk[K * K];
  const float* wc = a.w + ((unsigned)(n0 + min(p, np - 1)) % a.C) * (K * K);
#pragma unroll
  for (int i = 0; i < K * K; ++i) wk[i] = __ldg(wc + i);
  zero(sx, in_floats >> 2);
  __syncthreads();
  stage_in(make_job(a.x + (long long)n0 * a.H * a.W, 0, 1, np, max(row0, 0),
                    min(row0 + (nrow - 1) * S + K, a.H), row0, a.pl, a.in,
                    sx, 0));
  __syncthreads();
  const int n_out = nrow * a.OW;
  if (p < np) {
    const float* xs = sx + p * a.in.ps;
    float* ys = sy + p * n_out;
    for (int j = lane; j < n_out; j += tp) {
      const int oh = (int)divide((unsigned)j, a.d_ow), ow = j - oh * a.OW;
      const float* xw = xs + oh * S * a.in.wp + ow * S;
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < K; ++i)
#pragma unroll
        for (int jj = 0; jj < K; ++jj)
          acc = fmaf(wk[i * K + jj], xw[i * a.in.wp + jj], acc);
      ys[j] = acc;
    }
  }
  __syncthreads();
  stage_out(a.y + (long long)n0 * a.OH * a.OW + (long long)oh0 * a.OW,
            np * n_out, sy);
}

struct DgradArgs {
  const float* dy;
  const float* w;
  float* dx;
  int n_planes, C, H, W, pt, pl;
  int P, TA, n_ta;  // planes per tile, coarse rows per tile, row tiles
  int a_lo, n_a;    // first coarse row (pt / S) and coarse rows of a plane
  int b_lo, n_b;    // the same on W
  Stage in;         // dy: OH x OW planes, rows TA + M - 1, wp n_b + M - 1
  Div d_nb;
};

template <int K, int S>
__global__ void __launch_bounds__(kThreads) depthwise_dgrad(DgradArgs a) {
  constexpr int M = (K + S - 1) / S;  // dy rows (and columns) per parity
  extern __shared__ float4 smem[];
  float* sd = reinterpret_cast<float*>(smem);
  const int in_floats = round4(a.P * a.in.ps);
  float* sx = sd + in_floats;
  const int group = blockIdx.x / a.n_ta, ta = blockIdx.x - group * a.n_ta;
  const int n0 = group * a.P;
  const int np = min(a.P, a.n_planes - n0);
  const int a0 = a.a_lo + ta * a.TA;
  const int na = min(a.TA, a.a_lo + a.n_a - a0);
  const int row0 = a0 - (M - 1);  // dy row of the tile's first row
  const int dx_lo = max(a0 * S - a.pt, 0);
  const int dx_hi = min((a0 + na) * S - a.pt, a.H);
  const int tp = kThreads / a.P;
  const int p = threadIdx.x / tp, lane = threadIdx.x - p * tp;
  float wk[K * K];
  const float* wc = a.w + ((unsigned)(n0 + min(p, np - 1)) % a.C) * (K * K);
#pragma unroll
  for (int i = 0; i < K * K; ++i) wk[i] = __ldg(wc + i);
  zero(sd, in_floats >> 2);
  __syncthreads();
  stage_in(make_job(a.dy + (long long)n0 * a.in.hs * a.in.ws, 0, 1, np,
                    max(row0, 0), min(a0 + na, a.in.hs), row0, M - 1 - a.b_lo,
                    a.in, sd, 0));
  __syncthreads();
  const int n_rows = dx_hi - dx_lo;
  if (p < np) {
    const float* ds = sd + p * a.in.ps;
    float* xs = sx + p * n_rows * a.W;
    const int n_pos = na * a.n_b;
    for (int j = lane; j < n_pos; j += tp) {
      const int ar = (int)divide((unsigned)j, a.d_nb), bc = j - ar * a.n_b;
      // dy[a0 + ar - m][b_lo + bc - n] sits at (ar + M - 1 - m, bc + M - 1 - n)
      const float* dw = ds + (ar + M - 1) * a.in.wp + bc + M - 1;
      float acc[S][S];
#pragma unroll
      for (int rh = 0; rh < S; ++rh)
#pragma unroll
        for (int rw = 0; rw < S; ++rw) acc[rh][rw] = 0.f;
#pragma unroll
      for (int m = 0; m < M; ++m)
#pragma unroll
        for (int n = 0; n < M; ++n) {
          const float v = dw[-m * a.in.wp - n];
#pragma unroll
          for (int rh = 0; rh < S; ++rh)
#pragma unroll
            for (int rw = 0; rw < S; ++rw)
              if (S * m + rh < K && S * n + rw < K)
                acc[rh][rw] =
                    fmaf(wk[(S * m + rh) * K + S * n + rw], v, acc[rh][rw]);
        }
#pragma unroll
      for (int rh = 0; rh < S; ++rh)
#pragma unroll
        for (int rw = 0; rw < S; ++rw) {
          const int ih = (a0 + ar) * S + rh - a.pt;
          const int iw = (a.b_lo + bc) * S + rw - a.pl;
          if (ih >= dx_lo && ih < dx_hi && iw >= 0 && iw < a.W)
            xs[(ih - dx_lo) * a.W + iw] = acc[rh][rw];
        }
    }
  }
  __syncthreads();
  stage_out(a.dx + (long long)n0 * a.H * a.W + (long long)dx_lo * a.W,
            np * n_rows * a.W, sx);
}

struct WgradArgs {
  const float* x;
  const float* dy;
  float* partial;  // (chunks, C, K, K)
  int B, C, H, W, OH, OW, pt, pl;
  int CT, TC, n_ct;  // channels per tile, threads per channel, tiles
  int chunk, BS;     // batch rows per chunk, batch rows per stage
  int TR, n_tr;      // dy rows per stage, row tiles (n_tr > 1: CT = BS = 1)
  Stage in, out;     // x (padded, as the forward's) and dy
  Div d_ow;
};

template <int K, int S>
__global__ void __launch_bounds__(kThreads, 3) depthwise_wgrad(WgradArgs a) {
  extern __shared__ float4 smem[];
  float* sx = reinterpret_cast<float*>(smem);
  const int ct_tile = blockIdx.x % a.n_ct, ch = blockIdx.x / a.n_ct;
  const int c0 = ct_tile * a.CT, nc = min(a.CT, a.C - c0);
  const int b_beg = ch * a.chunk, b_end = min(a.B, b_beg + a.chunk);
  const int x_plane = a.in.ps, d_plane = a.out.ps;
  const int x_item = round4(a.CT * x_plane), d_item = a.CT * d_plane;
  float* sd = sx + a.BS * x_item;
  const int ct = threadIdx.x / a.TC, lane = threadIdx.x - ct * a.TC;
  float acc[K * K];
#pragma unroll
  for (int i = 0; i < K * K; ++i) acc[i] = 0.f;
  // whole planes: the x tile's halo is zeroed once and the stages only
  // write its interior; bands of rows: each band zeroes its tile
  if (a.n_tr == 1) zero(sx, (a.BS * x_item) >> 2);
  for (int b = b_beg; b < b_end; b += a.BS) {
    const int nb = min(a.BS, b_end - b);
    for (int tr = 0; tr < a.n_tr; ++tr) {
      const int oh0 = tr * a.TR, nrow = min(a.TR, a.OH - oh0);
      const int row0 = oh0 * S - a.pt;
      __syncthreads();  // the previous stage's products are done
      if (a.n_tr > 1) {
        zero(sx, (nb * x_item) >> 2);
        __syncthreads();
      }
      // the nb batch rows' runs of x and of dy, in one pass
      const long long n0 = (long long)b * a.C + c0;
      stage_in(make_job(a.x + n0 * a.H * a.W, (long long)a.C * a.H * a.W, nb,
                        nc, max(row0, 0), min(row0 + (nrow - 1) * S + K, a.H),
                        row0, a.pl, a.in, sx, x_item),
               make_job(a.dy + n0 * a.OH * a.OW, (long long)a.C * a.OH * a.OW,
                        nb, nc, oh0, oh0 + nrow, oh0, 0, a.out, sd, d_item));
      __syncthreads();
      if (ct < nc) {
        const int n_pos = nrow * a.OW;
        for (int q = 0; q < nb; ++q) {
          const float* xs = sx + q * x_item + ct * x_plane;
          const float* ds = sd + q * d_item + ct * d_plane;
          for (int j = lane; j < n_pos; j += a.TC) {
            const int oh = (int)divide((unsigned)j, a.d_ow), ow = j - oh * a.OW;
            const float d = ds[j];
            const float* xw = xs + oh * S * a.in.wp + ow * S;
#pragma unroll
            for (int i = 0; i < K; ++i)
#pragma unroll
              for (int jj = 0; jj < K; ++jj)
                acc[i * K + jj] = fmaf(d, xw[i * a.in.wp + jj], acc[i * K + jj]);
          }
        }
      }
    }
  }
  // a channel's TC lanes are consecutive threads: a butterfly inside each
  // group of min(TC, 32) lanes, then the warps of a channel in order
  const int width = min(a.TC, 32);
#pragma unroll
  for (int i = 0; i < K * K; ++i)
    for (int off = width >> 1; off > 0; off >>= 1)
      acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);
  float* out = a.partial + ((long long)ch * a.C + c0) * (K * K);
  if (a.TC <= 32) {
    if (lane == 0 && ct < nc) {
#pragma unroll
      for (int i = 0; i < K * K; ++i) out[ct * K * K + i] = acc[i];
    }
    return;
  }
  const int warps = a.TC >> 5;  // warps per channel
  __syncthreads();              // the last stage's reads of sx are done
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int i = 0; i < K * K; ++i) sx[(threadIdx.x >> 5) * K * K + i] = acc[i];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < nc * K * K; idx += kThreads) {
    const int cc = idx / (K * K), tap = idx - cc * K * K;
    float s = 0.f;
    for (int wi = 0; wi < warps; ++wi) s += sx[(cc * warps + wi) * K * K + tap];
    out[idx] = s;
  }
}

__global__ void __launch_bounds__(kThreads)
    depthwise_wgrad_sum(const float* __restrict__ partial,
                        float* __restrict__ dw, int n_chunks, int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int ch = 0; ch < n_chunks; ++ch) s += partial[(long long)ch * n + i];
  dw[i] = s;
}

// The (k, stride) pairs the kernels are built for.
#define LEAF_DW_DISPATCH(KERNEL, k, s, ...)                 \
  do {                                                      \
    if (k == 3 && s == 1) return KERNEL<3, 1>(__VA_ARGS__); \
    if (k == 3 && s == 2) return KERNEL<3, 2>(__VA_ARGS__); \
    if (k == 5 && s == 1) return KERNEL<5, 1>(__VA_ARGS__); \
    if (k == 5 && s == 2) return KERNEL<5, 2>(__VA_ARGS__); \
    return (int)cudaErrorInvalidValue;                      \
  } while (0)

template <int K, int S>
int launch_fwd(const FwdArgs& a, int blocks, int smem, cudaStream_t st) {
  depthwise_fwd<K, S><<<blocks, kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <int K, int S>
int launch_dgrad(const DgradArgs& a, int blocks, int smem, cudaStream_t st) {
  depthwise_dgrad<K, S><<<blocks, kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <int K, int S>
int launch_wgrad(const WgradArgs& a, int blocks, int smem, cudaStream_t st) {
  depthwise_wgrad<K, S><<<blocks, kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

inline int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }

}  // namespace leaf_tpu_torch

using namespace leaf_tpu_torch;

// y (B, C, OH, OW) from x (B, C, H, W) and w (C, 1, k, k), all contiguous
// f32; pads (pt, pb, pl, pr) TF-SAME; P planes or TH output rows a tile
// (depthwise.py's forward_plan). Returns the launch's CUDA error code
// (cudaErrorInvalidValue for a plan past 48 KB or an unbuilt (k, stride)).
extern "C" int leaf_depthwise_fwd_f32(const void* x, const void* w, void* y,
                                      int n_planes, int C, int H, int W,
                                      int k, int stride, int pt, int pb,
                                      int pl, int pr, int P, int TH,
                                      void* stream) {
  FwdArgs a;
  a.x = static_cast<const float*>(x);
  a.w = static_cast<const float*>(w);
  a.y = static_cast<float*>(y);
  a.n_planes = n_planes;
  a.C = C;
  a.H = H;
  a.W = W;
  a.OH = (H + pt + pb - k) / stride + 1;
  a.OW = (W + pl + pr - k) / stride + 1;
  a.pt = pt;
  a.pl = pl;
  a.P = P;
  a.TH = TH;
  a.n_th = ceil_div(a.OH, TH);
  if (P < 1 || kThreads % P || (P > 1 && a.n_th > 1))
    return (int)cudaErrorInvalidValue;
  a.in = make_stage(H, W, (TH - 1) * stride + k, W + pl + pr);
  a.d_ow = make_div((unsigned)a.OW);
  const int smem = 4 * (round4(P * a.in.ps) + P * TH * a.OW);
  if (smem > kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  const int blocks = ceil_div(n_planes, P) * a.n_th;
  LEAF_DW_DISPATCH(launch_fwd, k, stride, a, blocks, smem,
                   static_cast<cudaStream_t>(stream));
}

// dx (B, C, H, W) from dy (B, C, OH, OW) and w; TA coarse rows a tile
// (depthwise.py's dgrad_plan). Returns the launch's CUDA error code.
extern "C" int leaf_depthwise_dgrad_f32(const void* dy, const void* w,
                                        void* dx, int n_planes, int C, int H,
                                        int W, int k, int stride, int pt,
                                        int pb, int pl, int pr, int P, int TA,
                                        void* stream) {
  DgradArgs a;
  a.dy = static_cast<const float*>(dy);
  a.w = static_cast<const float*>(w);
  a.dx = static_cast<float*>(dx);
  a.n_planes = n_planes;
  a.C = C;
  a.H = H;
  a.W = W;
  a.pt = pt;
  a.pl = pl;
  const int OH = (H + pt + pb - k) / stride + 1;
  const int OW = (W + pl + pr - k) / stride + 1;
  const int M = (k + stride - 1) / stride;
  a.a_lo = pt / stride;
  a.n_a = (H - 1 + pt) / stride - a.a_lo + 1;
  a.b_lo = pl / stride;
  a.n_b = (W - 1 + pl) / stride - a.b_lo + 1;
  a.P = P;
  a.TA = TA;
  a.n_ta = ceil_div(a.n_a, TA);
  // the staged dy rows and columns must cover [0, OH) and [0, OW)
  if (P < 1 || kThreads % P || (P > 1 && a.n_ta > 1) || a.a_lo - M + 1 > 0 ||
      a.b_lo - M + 1 > 0 || a.a_lo + a.n_a < OH || a.b_lo + a.n_b < OW)
    return (int)cudaErrorInvalidValue;
  a.in = make_stage(OH, OW, TA + M - 1, a.n_b + M - 1);
  a.d_nb = make_div((unsigned)a.n_b);
  const int smem =
      4 * (round4(P * a.in.ps) + P * min(TA * stride, H) * W);
  if (smem > kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  const int blocks = ceil_div(n_planes, P) * a.n_ta;
  LEAF_DW_DISPATCH(launch_dgrad, k, stride, a, blocks, smem,
                   static_cast<cudaStream_t>(stream));
}

// dw (C, 1, k, k) from x and dy: depthwise_wgrad writes partial (n_chunks,
// C, k, k), n_chunks = ceil(B / chunk), then depthwise_wgrad_sum adds the
// chunks in order (depthwise.py's wgrad_plan: CT, chunk, BS, TR). Returns
// the first nonzero CUDA error code of the two launches.
extern "C" int leaf_depthwise_wgrad_f32(const void* x, const void* dy,
                                        void* partial, void* dw, int B, int C,
                                        int H, int W, int k, int stride,
                                        int pt, int pb, int pl, int pr, int CT,
                                        int chunk, int BS, int TR,
                                        void* stream) {
  WgradArgs a;
  a.x = static_cast<const float*>(x);
  a.dy = static_cast<const float*>(dy);
  a.partial = static_cast<float*>(partial);
  a.B = B;
  a.C = C;
  a.H = H;
  a.W = W;
  a.OH = (H + pt + pb - k) / stride + 1;
  a.OW = (W + pl + pr - k) / stride + 1;
  a.pt = pt;
  a.pl = pl;
  a.CT = CT;
  a.TC = CT >= 1 ? kThreads / CT : 0;
  a.n_ct = ceil_div(C, CT);
  a.chunk = chunk;
  a.BS = BS;
  a.TR = TR;
  a.n_tr = ceil_div(a.OH, TR);
  if (CT < 1 || kThreads % CT || chunk < 1 || BS < 1 ||
      (a.n_tr > 1 && (CT > 1 || BS > 1)))
    return (int)cudaErrorInvalidValue;
  a.in = make_stage(H, W, (TR - 1) * stride + k, W + pl + pr);
  a.out = make_stage(a.OH, a.OW, TR, a.OW);
  a.d_ow = make_div((unsigned)a.OW);
  // the block's final reduction reuses the tile (8 warps x k^2 floats)
  const int smem = 4 * max(BS * (round4(CT * a.in.ps) + CT * a.out.ps),
                           (kThreads / 32) * k * k);
  if (smem > kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  const int n_chunks = ceil_div(B, chunk);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = [&]() -> int {
    LEAF_DW_DISPATCH(launch_wgrad, k, stride, a, a.n_ct * n_chunks, smem, st);
  }();
  if (err) return err;
  const int n = C * k * k;
  depthwise_wgrad_sum<<<ceil_div(n, kThreads), kThreads, 0, st>>>(
      a.partial, static_cast<float*>(dw), n_chunks, n);
  return (int)cudaGetLastError();
}
