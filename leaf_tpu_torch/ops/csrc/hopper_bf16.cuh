// PTX helpers for the fused frontend's bf16 kernels (fused_frontend_bf16.cu
// and fused_frontend_bwd_bf16.cu): bf16 rounding, bf16 pairs read at any
// element, cp.async of 8 bytes, wgmma.mma_async .bf16 with a K-major,
// unswizzled B operand in shared memory and A from registers or from
// shared memory, and bulk copies from shared to global memory (sm_90a
// only). The f32 kernels' helpers (hopper_tf32.cuh) come along.
//
// wgmma layouts for bf16 (per warpgroup, warp w, lane 4 g + i):
//  - A (m64 x k16, registers a0..a3, each two bf16, the lower k in the
//    low half): rows 16 w + g and 16 w + g + 8, columns 2 i, 2 i + 1 and
//    2 i + 8, 2 i + 9, in the order (g, 2i), (g + 8, 2i), (g, 2i + 8),
//    (g + 8, 2i + 8): the m16n8k16 layout per warp.
//  - D as for .tf32 (hopper_tf32.cuh).
//  - B (k16 x nN, descriptor): core matrices of 8 columns x 8 k-values
//    (16 bytes per column); the next 8 k-values are a slab further on,
//    the next 8 columns 128 bytes on: b_desc_of as for .tf32.
//
// For a Hankel tile A[r, k] = xs[p + r + k] the pair of thread (g, i)
// starts at xs[p + 16 w + g + 2 i]: for odd g it straddles two 32-bit
// words. lds_pair reads both words and picks the pair with one byte
// permute, so every lane runs the same instructions.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_tf32.cuh"

namespace {

__device__ __forceinline__ float bf16_round(float a) {
  return __bfloat162float(__float2bfloat16_rn(a));
}

__device__ __forceinline__ float bf16_to_float(uint16_t bits) {
  return __uint_as_float((uint32_t)bits << 16);
}

__device__ __forceinline__ uint16_t float_to_bf16(float a) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(a));
}

// The selector that lds_pair needs for a pair starting at byte address
// `addr` (2-byte aligned): the low word as it is, or its high half and
// the next word's low half.
__device__ __forceinline__ uint32_t pair_sel(uint32_t addr) {
  return (addr & 2) ? 0x5432u : 0x3210u;
}

// Two consecutive bf16 at the 4-byte-aligned `word` (its pair's address
// rounded down) with selector `sel` from pair_sel.
__device__ __forceinline__ uint32_t lds_pair(uint32_t word, uint32_t sel) {
  return __byte_perm(lds(word), lds(word + 4), sel);
}

__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src,
                                          bool valid) {
  // 8 bytes global -> shared; an invalid source fills zero (reads nothing)
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 8 : 0) : "memory");
}

// d[64 x 80] += A[64 x 16] (registers a0..a3) * B[16 x 80] (descriptor)
__device__ __forceinline__ void wgmma_bf16(float (&d)[40],
                                           const uint32_t (&a)[4],
                                           uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 0;\n}\n"
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

// d[64 x 40] (+)= A[64 x 16] * B[16 x 40], both from K-major, unswizzled
// descriptors; with accumulate false, d = A * B (d's old values unread)
__device__ __forceinline__ void wgmma_bf16_ss(float (&d)[20], uint64_t a_desc,
                                              uint64_t b_desc,
                                              bool accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %22, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19}, "
      "%20, %21, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "l"(a_desc), "l"(b_desc), "r"((int)accumulate));
}

// Generic-proxy writes to shared memory -> visible to the async proxy
// (wgmma operands, bulk copies); each writing thread fences, then a
// barrier orders the fences before the async reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// `bytes` (a multiple of 16) from shared `src` to global `dst`, both
// 16-byte aligned, as a bulk copy of this thread's current bulk group
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
      :: "l"(dst), "r"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// until this thread's bulk copies have read their shared sources
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// until this thread's bulk copies are complete
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

}  // namespace
