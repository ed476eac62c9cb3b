// Building blocks of the fused-loss kernels for Hopper (sm_90a), shared by
// fused_loss.cu (forward) and fused_loss_bwd.cu (dU, dV): TF32 operand
// splitting, wgmma.mma_async wrappers and shared-memory descriptors, named
// barriers between a producer warpgroup and two consumer warpgroups, and
// cp.async loads into a swizzled landing tile.
//
// Tiles the tensor cores read are in the K-major canonical layout without
// swizzle: 8-row x 16-byte core matrices, each 128 contiguous bytes, at a
// stride of lbo along K and sbo along the rows (smem_desc).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tt_sm90 {

constexpr int kKD = 128;         // depth of a tile (float32 values a row)
constexpr int kConsumers = 256;  // two warpgroups multiply
constexpr int kProducers = 128;  // one warpgroup loads and splits
constexpr int kThreads = kConsumers + kProducers;

// x rounded to TF32's 10 mantissa bits, to nearest with ties away from
// zero: what cvt.rna.tf32.f32 gives for every finite x (half an ulp added
// to the magnitude, the low 13 bits cleared), in two integer operations
// where cvt also tests for NaN and infinity.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo to float32 accuracy, both TF32: lo.hi + hi.lo + hi.hi keeps
// a product at float32 accuracy (CUTLASS's "fast f32").
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// Shared-memory matrix descriptor: start, leading (K) and stride (row)
// byte offsets, no swizzle.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

// d (a 64 x 32 accumulator) += a (registers) . B (shared memory, desc).
__device__ __forceinline__ void wgmma_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d (a 64 x 64 accumulator) = a (registers) . B (shared memory, desc), plus
// d unless scale_d is 0.
__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// d (a 64 x 128 accumulator) += a (registers) . B (shared memory, desc).
__device__ __forceinline__ void wgmma_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d (a 64 x 32 accumulator) = A (shared memory, da) . B (shared memory,
// db), plus d unless scale_d is 0.
__device__ __forceinline__ void wgmma_n32_ss(float (&d)[16], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps a register's value in place across the asynchronous MMAs that
// read or write it (the compiler does not see them as pending).
__device__ __forceinline__ void pin(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void pin(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }

// Named barriers between the producer and the consumers (0 is
// __syncthreads).
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
constexpr int kBarFull = 1;      // + buffer: the split tiles are ready
constexpr int kBarEmpty = 3;     // + buffer: the consumers are done with them
constexpr int kBarProducer = 5;  // the producer warpgroup alone

// Generic-proxy writes to shared memory, made visible to the tensor cores.
__device__ __forceinline__ void fence_to_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// cp.async with zero fill: `ok` false copies no byte and writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const float* src, bool ok) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Waits until at most N of this thread's cp.async groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Float index of element (r, c) in a raw [rows][kKD] tile whose 16-byte
// chunks are XOR-swizzled by the row: reading one chunk column down 8
// rows, or one row's 4 fragment elements, hits distinct banks.
__device__ __forceinline__ int raw_at(int r, int c) {
  return r * kKD + (((c >> 2) ^ (r & 7)) << 2) + (c & 3);
}

// Rows [r0, r0 + kRows) and depth [k0, k0 + kKD) of M [n, D] into a raw
// swizzled tile, by the producer warpgroup (tid in [0, kProducers)); rows
// past n and depth past D are zero.
template <int kRows>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ M, int r0,
                                          int n, int D, int k0, bool vec16, int tid) {
  if (vec16) {
    constexpr int kPerRow = kKD / 4;
#pragma unroll 4
    for (int e = tid; e < kRows * kPerRow; e += kProducers) {
      const int r = e / kPerRow, c = (e % kPerRow) * 4;
      const int gr = r0 + r, gk = k0 + c;
      const bool ok = gr < n && gk < D;  // D % 4 == 0: the 4 floats are all in or all out
      cp_async16(dst + raw_at(r, c), ok ? M + (size_t)gr * D + gk : M, ok);
    }
  } else {
#pragma unroll 4
    for (int e = tid; e < kRows * kKD; e += kProducers) {
      const int r = e / kKD, c = e % kKD;
      const int gr = r0 + r, gk = k0 + c;
      const bool ok = gr < n && gk < D;
      cp_async4(dst + raw_at(r, c), ok ? M + (size_t)gr * D + gk : M, ok);
    }
  }
}

}  // namespace tt_sm90
