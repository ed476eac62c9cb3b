// Hopper (sm_90a) plumbing of the kernels that load their tiles by TMA,
// shared by search_prefilter.cu (bfloat16), search_prefilter_f32.cu
// (float32) and stream_attention.cu: the Tensor Memory Accelerator's tiled
// copies and the mbarriers they complete on, the shared-memory descriptor of
// a tile in the 128-byte swizzle, and on the host the tensor maps those
// copies read, the SM count and the kernels' shared-memory opt-in.
//
// A tile the TMA lands is rows of 128 bytes (64 bf16 or 32 float32), its
// 16-byte chunks permuted by the row (the 128-byte swizzle), 8-row groups
// (a swizzle atom) 1024 bytes apart.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tt_sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The box of `map` at element (x, y) (x along the depth) into shared memory
// at dst by the Tensor Memory Accelerator, completing on bar; elements past
// the tensor's edge arrive as zeros.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int x,
                                         int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(x), "r"(y)
      : "memory");
}

// The same from a three-dimensional map, at element (x, y, z).
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int x, int y, int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(x), "r"(y), "r"(z)
      : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Arrives on bar and sets the bytes its phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

constexpr int kSw128Sbo = 1024;  // bytes between 8-row groups of a swizzled tile

// Shared-memory matrix descriptor of a K-major operand in the 128-byte
// swizzle: start address, leading offset 16 (unused by this layout),
// stride 1024 between 8-row groups, layout 1 (SWIZZLE_128B). A k-step of 32
// bytes (16 bf16 or 8 float32) within a row starts 32 bytes further on.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)(16 >> 4) << 16) |
         ((uint64_t)(kSw128Sbo >> 4) << 32) | (1ull << 62);
}

// Host code. Its state (the SM counts, the encoder) is each library's own:
// static functions, so that two libraries loaded in one process share none.
// A kernel and the dynamic shared memory it may take:
struct SmemOptIn {
  const void* kernel;
  int bytes;
};

// Opt the kernels in to the shared memory they may take, and read the SM
// count, once a device.
template <int kCount>
static cudaError_t prepare(int dev, int& sms, const SmemOptIn (&kernels)[kCount]) {
  static int sm_count[64] = {};
  if (dev < 64 && sm_count[dev] > 0) {
    sms = sm_count[dev];
    return cudaSuccess;
  }
  cudaError_t err = cudaSuccess;
  for (int i = 0; i < kCount && err == cudaSuccess; ++i)
    err = cudaFuncSetAttribute(kernels[i].kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kernels[i].bytes);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < 64) sm_count[dev] = sms;
  return err;
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no link to
// libcuda), looked up once.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static cudaError_t encoder(EncodeTiled& fn) {
  static EncodeTiled found = nullptr;
  if (found == nullptr) {
    cudaDriverEntryPointQueryResult status;
    void* sym = nullptr;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &sym, cudaEnableDefault, &status);
    if (err != cudaSuccess) return err;
    if (status != cudaDriverEntryPointSuccess || sym == nullptr) return cudaErrorSymbolNotFound;
    found = reinterpret_cast<EncodeTiled>(sym);
  }
  fn = found;
  return cudaSuccess;
}

// A tensor map of a [rows, D] matrix of `dtype` (elem_bytes each) read in
// boxes of box_rows rows by box_depth deep, swizzled 128 bytes (the MMAs'
// and ldmatrix's layout); past its edges, zeros.
static cudaError_t tensor_map(CUtensorMap* map, CUtensorMapDataType dtype, int elem_bytes,
                              const void* ptr, int rows, int D, int box_depth, int box_rows) {
  EncodeTiled encode;
  const cudaError_t err = encoder(encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)D * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_depth, (cuuint32_t)box_rows};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult r = encode(map, dtype, 2, const_cast<void*>(ptr), dims, strides, box, steps,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A tensor map of a bfloat16 [n, h, d] view whose rows lie h_stride
// elements apart within a slot and n_stride apart between slots, read in
// boxes of box_rows slots by box_depth deep at one h, swizzled by the box's
// row of 2 box_depth bytes (128 or 32); past its edges, zeros.
static cudaError_t tensor_map_3d(CUtensorMap* map, const void* ptr, int n, int h, int d,
                                 long long h_stride, long long n_stride, int box_depth,
                                 int box_rows) {
  EncodeTiled encode;
  const cudaError_t err = encoder(encode);
  if (err != cudaSuccess) return err;
  const CUtensorMapSwizzle swizzle =
      box_depth == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)h, (cuuint64_t)n};
  const cuuint64_t strides[2] = {(cuuint64_t)h_stride * 2, (cuuint64_t)n_stride * 2};
  const cuuint32_t box[3] = {(cuuint32_t)box_depth, 1, (cuuint32_t)box_rows};
  const cuuint32_t steps[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
                            dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace tt_sm90
