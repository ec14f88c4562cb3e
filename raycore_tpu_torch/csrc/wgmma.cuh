// Hopper's warpgroup matrix multiply (wgmma) with both operands in shared
// memory: what the card probes P1 (gather_probe.cu, onehot) and P3
// (matmul_probe.cu, the tensor-core tiers) share.
//
// Operand layout. Every operand tile is K-major: one row per output row
// (A) or output column (B), the row's K values contiguous, W bytes a row
// (W = 128, 64 or 32; 32 bytes of K per wgmma), eight rows to a swizzle
// atom of 8 W bytes, atoms one after the other. The swizzle is the
// hardware's: the 16-byte chunk of a row is XORed with the row's place in
// its atom (bits 7.. of the address onto bits 4..), so that eight rows'
// chunk c land in eight different bank groups. A tile's base must sit on
// a multiple of 8 W bytes (the kernels align the dynamic shared memory to
// 1024). A thread that writes an operand writes byte `off` of the plain
// layout at `swizzle(off, W)`.
//
// Descriptor (PTX ISA, "matrix descriptor"): bits 0-13 the start address
// >> 4; 16-29 the leading byte offset >> 4 (unused by the swizzled K-major
// layouts, set to 1); 32-45 the stride byte offset >> 4, from one 8-row
// group to the next (8 W here); 62-63 the swizzle (1: 128 B, 2: 64 B,
// 3: 32 B). The k-th 32-byte step of a row starts 32 k bytes further on.
//
// Order of a product: writers of an operand tile fence it for the async
// proxy (proxy_fence) and meet at a barrier; the warpgroup then issues
// fence(), its mma_* calls, commit() and wait<N>(). The accumulators are
// the warpgroup's m64nN fragments: thread (warp w, lane l) of the
// warpgroup holds rows 16 w + l / 4 (d[4 i], d[4 i + 1]) and 16 w + l / 4 +
// 8 (d[4 i + 2], d[4 i + 3]) at columns 8 i + 2 (l % 4) + {0, 1}.
//
// Needs sm_90a.

#pragma once

#include <stdint.h>

namespace wg {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first byte at or after p whose shared-memory address is a multiple
// of 1024 (the dynamic allocation asks for 1024 bytes more).
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024u - (smem_addr(p) & 1023u)) & 1023u);
}

// Byte `off` of a W-byte-row K-major tile after the swizzle.
__device__ __forceinline__ uint32_t swizzle(uint32_t off, int W) {
  const uint32_t mask = static_cast<uint32_t>(W >> 4) - 1u;   // 7, 3 or 1
  return off ^ (((off >> 7) & mask) << 4);
}

// Descriptor of a K-major operand whose first row starts at shared
// address `saddr`, rows W bytes apart, 8-row groups 8 W apart.
__device__ __forceinline__ uint64_t desc(uint32_t saddr, int W) {
  const uint64_t layout = W == 128 ? 1u : W == 64 ? 2u : 3u;
  return static_cast<uint64_t>((saddr & 0x3FFFFu) >> 4)
         | (static_cast<uint64_t>(1) << 16)
         | (static_cast<uint64_t>((8 * W) >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Thread writes to shared memory made visible to the tensor cores' reads.
__device__ __forceinline__ void proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Named barriers (id 1-15; 0 is __syncthreads): `n` threads, a multiple
// of 32, meet; arrive does not wait.
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Keeps the compiler from moving accesses of the accumulators across an
// asynchronous product.
template <int R>
__device__ __forceinline__ void keep(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x N, float32) = A (64 x K) B (K x N) + (accumulate ? d : 0), A and
// B K-major in shared memory (descriptors da, db); K = 16 for bf16, 8 for
// tf32 (float32 values whose low 13 mantissa bits the hardware ignores).

__device__ __forceinline__ void mma_bf16_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate)
      : "memory");
}

__device__ __forceinline__ void mma_bf16_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate)
      : "memory");
}

__device__ __forceinline__ void mma_tf32_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate)
      : "memory");
}

__device__ __forceinline__ void mma_tf32_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate)
      : "memory");
}

}  // namespace wg
