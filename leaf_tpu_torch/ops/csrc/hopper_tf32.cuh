// PTX helpers shared by the fused frontend's forward (fused_frontend.cu)
// and backward (fused_frontend_bwd.cu) kernels: 3xTF32 operand splits,
// shared-memory loads by 32-bit address, cp.async copies, and
// wgmma.mma_async .tf32 with A from registers and a K-major, unswizzled
// B operand in shared memory (sm_90a only).
//
// wgmma layouts used by both kernels (per warpgroup, warp w, lane 4 g + i):
//  - A (m64 x k8, registers a0..a3): rows 16 w + g and 16 w + g + 8,
//    columns i and i + 4, in the order (g, i), (g + 8, i), (g, i + 4),
//    (g + 8, i + 4): the m16n8k8 layout per warp.
//  - D (m64 x nN, N / 2 f32 registers): entry 4 j + 2 h + e is row
//    16 w + g + 8 h, column 8 j + 2 i + e.
//  - B (k8 x nN, descriptor): core matrices of 8 columns x 4 k-values
//    (16 bytes per column); the next 4 k-values are a slab further on,
//    the next 8 columns 128 bytes on.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t to_tf32(float a) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(a));
  return r;
}

// hi = rna_tf32(a), lo = rna_tf32(a - hi), as f32 bit patterns
__device__ __forceinline__ void split_tf32(float a, float& hi, float& lo) {
  const uint32_t h = to_tf32(a);
  hi = __uint_as_float(h);
  lo = __uint_as_float(to_tf32(a - hi));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src,
                                          bool valid) {
  // 4 bytes global -> shared; an invalid source fills zero (reads nothing)
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

// K-major, unswizzled B operand: core matrices of 8 columns x 16 bytes;
// the next 4 k-values (K) are one slab on, the next 8 columns (N) 128.
// `lo` holds the start address >> 4 and the slab stride >> 4 (bits 0-29).
__device__ __forceinline__ uint64_t b_desc_of(uint32_t lo) {
  return (uint64_t)lo | ((uint64_t)(128 >> 4) << 32);
}

__device__ __forceinline__ uint32_t lds(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// Keeps the compiler from moving accumulator reads or writes across the
// wgmma fence, commit and wait around it.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d[64 x 80] += A[64 x 8] (registers a0..a3) * B[8 x 80] (descriptor)
__device__ __forceinline__ void wgmma_tf32(float (&d)[40],
                                           const uint32_t (&a)[4],
                                           uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d[64 x 40] += A[64 x 8] (registers a0..a3) * B[8 x 40] (descriptor)
__device__ __forceinline__ void wgmma_tf32(float (&d)[20],
                                           const uint32_t (&a)[4],
                                           uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19}, "
      "{%20, %21, %22, %23}, %24, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

}  // namespace
