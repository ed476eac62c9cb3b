// Block-maxima prefilter of the exact search over a float32 corpus, for
// Hopper (sm_90a): the scores S = Q . C^T of float32 query rows against
// float32 corpus rows at float32 accuracy, three TF32 passes on the tensor
// cores (lo.hi + hi.lo + hi.hi of operands split as sm90_tf32.cuh splits
// them), reduced in registers and never written to device memory whole.
//
// Replaces no TPU kernel. The JAX package's topk_mips_twopass
// (twotower_tpu/ops/topk.py) is XLA ops: a float32 product of each corpus
// chunk at Precision.HIGHEST, a max over each 64-row block, a top-k of the
// blocks, merged. The port ran the same ops (cuBLAS's float32 product on the
// SIMT units, then a pass over the scores it wrote); ops/prefilter_f32.py
// searches through the kernels here instead:
//   maxima      M[r, j] = max of S[r, c] over the corpus rows c of block j
//               (64 rows, the last one ragged), written [rows, nblk];
//   candidates  the 64 scores of each of the row's k blocks of largest
//               maximum (torch.topk over M in between), written
//               [rows, k, 64] in the order of the row's list of blocks.
// The candidates kernel scores the chosen blocks only: its grid is a list
// of (block, up to kN rows that chose it), built on the card by a sort of
// the rows' lists (prefilter_f32.py). Each of its work items runs, for its
// block, the very MMAs of the maxima kernel's tile of that block: the same
// instruction, the same 64 corpus rows in the same places, the same split
// of the same values, the same k-order, the rows' queries as the columns.
// An MMA's output element depends on its own row of A and column of B
// alone, so a kept score is, bit for bit, the score its block's maximum was
// taken over, and a row's scores do not depend on the rows launched beside
// it (the card's tests hold both).
//
// Bound on the H100 at c3_eval_exact's batch (4096 rows, N = 1,145,145
// corpus rows, D = 128): 2 rows N D = 1.20 TFLOP a launch, at float32
// accuracy three TF32 passes: 7.28 ms at 495/3 TFLOP/s; the bytes (the
// corpus read once, 586 MB; the maxima written once, 293 MB) 0.26 ms at
// 3.35 TB/s. It is bound by the tensor cores. What the design does about
// it:
// 1. The corpus as the MMAs' A operand, split in registers. A float32
//    corpus tile would take twice its bytes in shared memory as hi and lo
//    planes; here the TMA copies it raw (128 rows x 32 deep a stage, 16 KB,
//    swizzled 128 bytes) and each thread takes its A fragments with
//    ldmatrix (a b16 8x8 matrix is a float32 8x4 one: thread t gets row
//    t / 4, column t % 4, the TF32 fragment's element) and splits them into
//    hi and lo registers. The stage is released as soon as it is read, not
//    when the MMAs finish with it.
// 2. The query rows as B, split once. A block owns kN query rows (128, or
//    64 past a depth of 128), split into hi and lo planes in shared memory
//    (128 KB at most) before the stream starts, and streams the corpus past
//    them: each corpus byte it reads serves kN rows. The grid is (query
//    tiles, corpus slices) with the query tile fastest, so the blocks that
//    stream one slice run side by side and read it from L2 (32 tiles x 4
//    slices = 128 blocks, one an SM, at c3_eval_exact's batch).
// 3. One block of 64 corpus rows an MMA tile. Each of the two consumer
//    warpgroups owns one block of a stage: wgmma.mma_async m64nNk8 TF32, A
//    from registers, B from shared memory, three MMAs a k-step into one
//    float32 accumulator (lo.hi, hi.lo, then hi.hi: the small terms first),
//    the next stage's issued before the last one's finish (wait_group 1).
//    The second warpgroup starts two stages after the first, so that one's
//    epilogue runs beside the other's MMAs. Run back to back, the kernel
//    holds the H100 at its 700 W power cap (SM clock 1425-1725 MHz).
// 4. The epilogue in registers. A column's maximum over the tile's 64 rows:
//    two rows in a thread, three shuffles across the warp's 8 row groups,
//    then the 4 warps' through shared memory; only that is stored (1/64 of
//    the scores).
// Query rows past `rows` and depth past D are zero; corpus rows at or past
// n arrive as zeros and take no part in a maximum or a candidate (a
// candidate slot past n keeps the caller's -inf). D is a multiple of 8 up
// to 256, padded with zeros to 128 (four stages of 32), or past 128 to 256
// (eight): one instantiation a query tile.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_tf32.cuh"

namespace {

using namespace tt_sm90;

constexpr int kBlock = 64;              // corpus rows a block maximum covers: an MMA tile's rows
constexpr int kBC = 2 * kBlock;         // corpus rows a stage: one block a consumer warpgroup
constexpr int kChunk = 32;              // depth of a stage: 32 float32, 128 bytes a row
constexpr int kRowBytes = kChunk * 4;   // a swizzled row: 128 bytes
constexpr int kSbo = 8 * kRowBytes;     // 8-row groups (a swizzle atom) 1024 bytes apart
constexpr int kStageBytes = kBC * kRowBytes;  // 16 KB
constexpr int kStages = 5;              // corpus stages in the ring
constexpr int kConsumerThreads = 256;    // two consumer warpgroups
constexpr int kMaximaThreads = kConsumerThreads + 32;  // and one producer warp
constexpr int kCandThreads = 128;       // the candidates kernel: one warpgroup
constexpr int kMaxDepth = 256;
// The query planes: depth chunks x {hi, lo} x kN rows of 128 bytes, 128 KB
// at most (kN 128 to a depth of 128, kN 64 to 256).
constexpr int kPlanesMax = 2 * (kMaxDepth / kChunk) * 64 * kRowBytes;
// Each warp's column maxima of a tile, two tiles' worth: 64 kN bytes.
constexpr int kRedMax = 64 * 128;
constexpr int kMaximaSmemMax = 1024 + kPlanesMax + kStages * kStageBytes + kRedMax + 2 * kStages * 8;
constexpr int kCandSmemMax = 1024 + 4 * 128 * kRowBytes + 128 * 8;
// Named barriers (0 is __syncthreads): the consumers' planes are written;
// + warpgroup, its warps' column maxima are in shared memory; the first
// warpgroup's first two stages are issued.
constexpr int kBarPlanes = 1;
constexpr int kBarRed = 2;
constexpr int kBarStagger = 4;  // the second warpgroup's start

struct Args {
  const float* q;  // [rows, D]
  const float* c;  // [n, D] (rows at or past n are never read)
  int rows, n, D, nk;  // nk: depth chunks of 32, 4 or 8 (the query tile's kernel)
  int nblk, n_tiles, tiles_per_slice;
  float* maxima;  // [rows, nblk]
  // The candidates: the rows' (row, rank) pairs r k + i sorted by their
  // block, each block's first pair, and the work items (a block's pairs, kN
  // at a time) through each block and of each item.
  int k;
  const int64_t* order;       // [rows k]
  const int64_t* bounds;      // [nblk + 1]
  const int64_t* work_end;    // [nblk]
  const int64_t* work_block;  // [items]: the item's block, nblk for none
  float* cand;                // [rows, k, 64]
};

// The query rows a block owns: 128, or 64 past a depth of 128 (the planes
// then take as much room); 0 for a depth the kernels do not take.
__host__ __device__ constexpr int query_tile(int D) {
  return D < 8 || D > kMaxDepth || D % 8 != 0 ? 0 : D <= 128 ? 128 : 64;
}

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

// Four 8x8 b16 matrices from shared memory, lanes 8 m to 8 m + 7 naming
// matrix m's rows: r[m] is this thread's row lane / 4, word lane % 4 of it.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// Shared-memory matrix descriptor of a K-major operand in the 128-byte
// swizzle: start address, leading offset 16 (unused by this layout),
// stride 1024 between 8-row groups, layout 1 (SWIZZLE_128B). A k-step of 8
// float32 within a row of 32 starts 32 bytes further on.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)(16 >> 4) << 16) |
         ((uint64_t)(kSbo >> 4) << 32) | (1ull << 62);
}

// d (a 64 x 128 accumulator) = a (registers) . B (shared memory, desc),
// plus d unless scale_d is 0.
__device__ __forceinline__ void wgmma_n128_tf32(float (&d)[64], const uint32_t (&a)[4],
                                                uint64_t desc, int scale_d) {
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// d (a 64 x kN accumulator) = a (registers) . B (shared memory, desc), plus
// d unless scale_d is 0.
__device__ __forceinline__ void mma(float (&d)[64], const uint32_t (&a)[4], uint64_t desc,
                                    int scale_d) {
  wgmma_n128_tf32(d, a, desc, scale_d);
}
__device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                    int scale_d) {
  wgmma_n64(d, a, desc, scale_d);
}

// One depth chunk's MMAs over its query planes (hi at b_hi, lo after it):
// for each of its 4 k-steps, lo.hi, hi.lo and hi.hi, in that order, into
// acc; the chunk's first MMA overwrites acc unless keep. Both kernels run a
// tile's chunks through this one sequence, and no other instruction writes
// acc: the compiler then has no reason to wait for MMAs in flight.
template <int kN>
__device__ __forceinline__ void chunk_mmas(float (&acc)[kN / 2], const uint32_t (&hi)[4][4],
                                           const uint32_t (&lo)[4][4], const char* b_hi,
                                           int keep) {
  const char* b_lo = b_hi + kN * kRowBytes;
#pragma unroll
  for (int j = 0; j < kChunk / 8; ++j) {
    const uint64_t d_hi = sw128_desc(b_hi + 32 * j), d_lo = sw128_desc(b_lo + 32 * j);
    mma(acc, lo[j], d_hi, j == 0 ? keep : 1);
    mma(acc, hi[j], d_lo, 1);
    mma(acc, hi[j], d_hi, 1);
  }
}

// Rows j < kN of depth chunks [c0, c1) of the query planes from query row
// row_of(j) (negative: zeros): chunk c split into hi (plane 2 (c - c0))
// and lo (plane 2 (c - c0) + 1), 16-byte piece p of a row at p ^ (j & 7)
// (the 128-byte swizzle). Threads tid of nthreads share the pieces, a row's
// 8 a chunk side by side.
template <int kN, class RowOf>
__device__ __forceinline__ void fill_planes(char* planes, const Args& a, RowOf row_of, int c0,
                                            int c1, int tid, int nthreads) {
  const int pieces = (c1 - c0) * (kChunk / 4);
  for (int u = tid; u < kN * pieces; u += nthreads) {
    const int j = u / pieces, pc = u % pieces;
    const int c = pc >> 3, p = pc & 7, d = kChunk * c0 + 4 * pc;
    const long long r = row_of(j);
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r >= 0 && d < a.D)  // D % 8 == 0: the 4 floats are all in or all out
      x = __ldg(reinterpret_cast<const float4*>(a.q + (size_t)r * a.D + d));
    uint4 h, l;
    split(x.x, h.x, l.x);
    split(x.y, h.y, l.y);
    split(x.z, h.z, l.z);
    split(x.w, h.w, l.w);
    char* dst = planes + (size_t)(2 * c) * kN * kRowBytes + j * kRowBytes + ((p ^ (j & 7)) << 4);
    *reinterpret_cast<uint4*>(dst) = h;
    *reinterpret_cast<uint4*>(dst + kN * kRowBytes) = l;
  }
}

__device__ __forceinline__ void split4(const uint32_t (&raw)[4], uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split(__uint_as_float(raw[i]), hi[i], lo[i]);
}

__device__ __forceinline__ void pin_frag(uint32_t (&r)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) pin(r[j][i]);
}

template <int kN>
__device__ __forceinline__ void pin_acc(float (&acc)[kN / 2]) {
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) pin(acc[i]);
}

// The block maxima of the warpgroup's tile (corpus block blk, rows from
// crow0 = its first row + 16 warp + gq): element 4 jj + 2 h + e of the
// accumulator is row gq + 8 h of the warp's 16, column 8 jj + 2 tq + e.
// red: the warpgroup's [4 warps][kN] column maxima for this tile's parity.
template <int kN>
__device__ __forceinline__ void maxima_epilogue(const Args& a, const float (&acc)[kN / 2],
                                                float* red, int crow0, int blk, int q0) {
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const bool ok0 = crow0 < a.n, ok1 = crow0 + 8 < a.n;
#pragma unroll
  for (int jj = 0; jj < kN / 8; ++jj)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float m = fmaxf(ok0 ? acc[4 * jj + e] : -INFINITY, ok1 ? acc[4 * jj + 2 + e] : -INFINITY);
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 4));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 8));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 16));
      if (gq == 0) red[warp * kN + 8 * jj + 2 * tq + e] = m;
    }
  bar_sync(kBarRed + (threadIdx.x >> 7), 128);
  const int t = threadIdx.x & 127;
  if (t < kN && q0 + t < a.rows && blk < a.nblk) {
    const float m = fmaxf(fmaxf(red[t], red[kN + t]), fmaxf(red[2 * kN + t], red[3 * kN + t]));
    a.maxima[(size_t)(q0 + t) * a.nblk + blk] = m;
  }
}

// One stage of a consumer warpgroup, depth chunk c of a tile (parity P of
// the fragment registers): the warp's A fragments of its 16 corpus rows
// from the stage by ldmatrix, the stage released, split, the chunk's MMAs
// issued; then the previous stage's MMAs waited for, and at the tile's last
// chunk (kLast) this one's too and the tile's maxima.
template <int kN, int P, bool kLast>
__device__ __forceinline__ void maxima_stage(const Args& a, const char* planes, const char* ring,
                                             float* red, uint64_t* full, uint64_t* empty,
                                             int step, int c, int tile, int tile_begin, int q0,
                                             float (&acc)[kN / 2], uint32_t (&hi)[2][4][4],
                                             uint32_t (&lo)[2][4][4]) {
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int s = step % kStages;
  mbar_wait(full + s, (step / kStages) & 1);
  // Lane l names row l % 8 + 8 ((l / 8) & 1) of the warp's 16 in matrix
  // l / 8, pieces 2 j (matrices 0, 1) and 2 j + 1 (2, 3) of k-step j.
  const int row = 64 * wg + 16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1);
  const char* src = ring + s * kStageBytes + row * kRowBytes;
  uint32_t raw[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) ldmatrix_x4(raw[j], src + (((2 * j + (lane >> 4)) ^ (row & 7)) << 4));
  __syncwarp();
  if (lane == 0) mbar_arrive(empty + s);
#pragma unroll
  for (int j = 0; j < 4; ++j) split4(raw[j], hi[P][j], lo[P][j]);
  wgmma_fence();
  chunk_mmas<kN>(acc, hi[P], lo[P], planes + (size_t)(2 * c) * kN * kRowBytes, c > 0);
  wgmma_commit();
  wgmma_wait<1>();  // the previous stage's MMAs are done with its fragments
  pin_frag(hi[P ^ 1]);
  pin_frag(lo[P ^ 1]);
  if (kLast) {
    wgmma_wait<0>();
    pin_acc<kN>(acc);
    pin_frag(hi[P]);
    pin_frag(lo[P]);
    const int gq = lane >> 2;
    maxima_epilogue<kN>(a, acc, red + ((tile - tile_begin) & 1) * 8 * kN + wg * 4 * kN,
                        tile * kBC + 64 * wg + 16 * warp + gq, 2 * tile + wg, q0);
  }
}

// kNk depth chunks of 32 (a.nk, even): a tile's stages unrolled, so that
// the loop over tiles carries no MMA in flight (each tile ends in its
// epilogue's wait) and the compiler injects no wait of its own.
template <int kN, int kNk>
__device__ __forceinline__ void maxima_body(const Args& a, const CUtensorMap* cmap) {
  extern __shared__ __align__(1024) char smem_raw[];
  char* planes = smem_raw + (-smem_u32(smem_raw) & 1023);
  char* ring = planes + (size_t)kNk * 2 * kN * kRowBytes;
  float* red = reinterpret_cast<float*>(ring + kStages * kStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(red + 16 * kN);
  uint64_t* empty = full + kStages;

  const int tile_begin = blockIdx.y * a.tiles_per_slice;
  const int tile_end = min(tile_begin + a.tiles_per_slice, a.n_tiles);
  const int q0 = blockIdx.x * kN;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);   // the producer's arrival with the stage's bytes
      mbar_init(empty + s, 8);  // lane 0 of each consumer warp, once it has read the stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumerThreads) {
    // Producer: one thread keeps the ring's corpus stages coming, a box of
    // 128 rows by 32 deep each, while the consumers split the query rows.
    if (threadIdx.x != kConsumerThreads) return;
    const int nsteps = max(tile_end - tile_begin, 0) * kNk;
    for (int step = 0; step < nsteps; ++step) {
      const int s = step % kStages;
      if (step >= kStages) mbar_wait(empty + s, (step / kStages - 1) & 1);
      mbar_expect_tx(full + s, kStageBytes);
      tma_load(ring + s * kStageBytes, cmap, full + s, (step % kNk) * kChunk,
               (tile_begin + step / kNk) * kBC);
    }
    return;
  }

  fill_planes<kN>(
      planes, a, [&](int j) { return q0 + j < a.rows ? (long long)(q0 + j) : -1LL; }, 0, kNk,
      threadIdx.x, kConsumerThreads);
  fence_to_async_proxy();
  bar_sync(kBarPlanes, kConsumerThreads);

  // The second warpgroup starts two stages after the first, so that one's
  // epilogue runs beside the other's MMAs rather than both at once.
  const int wg = threadIdx.x >> 7;
  if (wg == 1 && tile_end > tile_begin) bar_sync(kBarStagger, kConsumerThreads);
  // Zeros before the first MMA, then written by the MMAs alone (a tile's
  // first overwrites it).
  float acc[kN / 2];
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) acc[i] = 0.f;
  uint32_t hi[2][4][4], lo[2][4][4];
  for (int tile = tile_begin; tile < tile_end; ++tile) {
    const int step0 = (tile - tile_begin) * kNk;
#pragma unroll
    for (int c = 0; c < kNk; c += 2) {
      maxima_stage<kN, 0, false>(a, planes, ring, red, full, empty, step0 + c, c, tile,
                                 tile_begin, q0, acc, hi, lo);
      if (c + 2 < kNk)
        maxima_stage<kN, 1, false>(a, planes, ring, red, full, empty, step0 + c + 1, c + 1,
                                   tile, tile_begin, q0, acc, hi, lo);
      else
        maxima_stage<kN, 1, true>(a, planes, ring, red, full, empty, step0 + c + 1, c + 1,
                                  tile, tile_begin, q0, acc, hi, lo);
      if (c == 0 && wg == 0 && tile == tile_begin) bar_arrive(kBarStagger, kConsumerThreads);
    }
  }
}

// One work item: block b's pairs [lo, lo + count) (count <= kN) as the
// columns, the block's 64 corpus rows as the rows, the maxima kernel's MMAs
// chunk by chunk, each score of a real corpus row stored at its pair's
// rank. A chunk's query planes (32 KB at most) are filled while the last
// chunk's MMAs run, two buffers taking turns, and its A fragments loaded
// (straight from the corpus, the elements ldmatrix hands the maxima
// kernel's thread) a chunk ahead: the loads' latency hides behind the
// MMAs, and three work items fit an SM.
template <int kN>
__device__ __forceinline__ void candidates_body(const Args& a) {
  extern __shared__ __align__(1024) char smem_raw[];
  constexpr int kBufBytes = 2 * kN * kRowBytes;  // a chunk's hi and lo planes
  char* bufs = smem_raw + (-smem_u32(smem_raw) & 1023);
  long long* pair = reinterpret_cast<long long*>(bufs + 2 * kBufBytes);
  const int w = blockIdx.x;
  const long long b = a.work_block[w];
  if (b >= a.nblk) return;
  const long long first = a.bounds[b], end = a.bounds[b + 1];
  const long long groups = (end - first + kN - 1) / kN;
  const long long lo0 = first + (w - (a.work_end[b] - groups)) * kN;
  const int count = (int)min((long long)kN, end - lo0);
  const int t = threadIdx.x;
  const int warp = t >> 5, lane = t & 31, gq = lane >> 2, tq = lane & 3;
  const long long crow0 = b * kBlock + 16 * warp + gq;  // and crow0 + 8
  auto row_of = [&](int j) { return pair[j] < 0 ? -1LL : pair[j] / a.k; };
  // Element i of k-step j of chunk c: row crow0 + 8 (i & 1), depth 32 c +
  // 8 j + tq + 4 (i >> 1).
  float raw[4][4];
  auto load_a = [&](int c) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const long long r = crow0 + 8 * (i & 1);
        const int d = kChunk * c + 8 * j + tq + 4 * (i >> 1);
        raw[j][i] = r < a.n && d < a.D ? __ldg(a.c + (size_t)r * a.D + d) : 0.f;
      }
  };
  load_a(0);
  if (t < kN) pair[t] = t < count ? a.order[lo0 + t] : -1;
  __syncthreads();
  fill_planes<kN>(bufs, a, row_of, 0, 1, t, kCandThreads);
  fence_to_async_proxy();
  __syncthreads();

  float acc[kN / 2];  // as the maxima kernel's
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) acc[i] = 0.f;
  uint32_t hi[4][4], lo[4][4];
  for (int c = 0; c < a.nk; ++c) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) split(raw[j][i], hi[j][i], lo[j][i]);
    wgmma_fence();
    chunk_mmas<kN>(acc, hi, lo, bufs + (c & 1) * kBufBytes, c > 0);
    wgmma_commit();
    if (c + 1 < a.nk) {
      load_a(c + 1);
      fill_planes<kN>(bufs + ((c + 1) & 1) * kBufBytes, a, row_of, c + 1, c + 2, t,
                      kCandThreads);
      fence_to_async_proxy();
    }
    wgmma_wait<0>();
    pin_acc<kN>(acc);
    pin_frag(hi);
    pin_frag(lo);
    __syncthreads();  // the next chunk's planes are written; this one's are free
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = 16 * warp + gq + 8 * h;
    if (b * kBlock + m >= a.n) continue;
#pragma unroll
    for (int jj = 0; jj < kN / 8; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * jj + 2 * tq + e;
        if (col < count) a.cand[(size_t)pair[col] * kBlock + m] = acc[4 * jj + 2 * h + e];
      }
  }
}

// By depth: up to 128 (the main path's 128), and past 128, 64 query rows a
// block.
__global__ void __launch_bounds__(kMaximaThreads, 1)
    prefilter_f32_maxima_kernel(const Args a, const __grid_constant__ CUtensorMap cmap) {
  maxima_body<128, 4>(a, &cmap);
}

__global__ void __launch_bounds__(kMaximaThreads, 1)
    prefilter_f32_maxima_deep_kernel(const Args a, const __grid_constant__ CUtensorMap cmap) {
  maxima_body<64, 8>(a, &cmap);
}

__global__ void __launch_bounds__(kCandThreads, 3) prefilter_f32_candidates_kernel(const Args a) {
  candidates_body<128>(a);
}

__global__ void __launch_bounds__(kCandThreads, 3)
    prefilter_f32_candidates_deep_kernel(const Args a) {
  candidates_body<64>(a);
}

// Opt the kernels in to the shared memory they may take, and read the SM
// count, once a device.
cudaError_t prepare(int dev, int& sms) {
  static int sm_count[64] = {};
  if (dev < 64 && sm_count[dev] > 0) {
    sms = sm_count[dev];
    return cudaSuccess;
  }
  const void* kernels[4] = {(const void*)prefilter_f32_maxima_kernel,
                            (const void*)prefilter_f32_maxima_deep_kernel,
                            (const void*)prefilter_f32_candidates_kernel,
                            (const void*)prefilter_f32_candidates_deep_kernel};
  const int smem[4] = {kMaximaSmemMax, kMaximaSmemMax, kCandSmemMax, kCandSmemMax};
  cudaError_t err = cudaSuccess;
  for (int i = 0; i < 4 && err == cudaSuccess; ++i)
    err = cudaFuncSetAttribute(kernels[i], cudaFuncAttributeMaxDynamicSharedMemorySize, smem[i]);
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

cudaError_t encoder(EncodeTiled& fn) {
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

// A tensor map of the [n, D] float32 corpus read in boxes of 128 rows by 32
// deep, swizzled 128 bytes (ldmatrix's conflict-free layout); past its
// edges, zeros.
cudaError_t corpus_map(CUtensorMap* map, const float* ptr, int n, int D) {
  EncodeTiled encode;
  const cudaError_t err = encoder(encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)n};
  const cuuint64_t strides[1] = {(cuuint64_t)D * 4};
  const cuuint32_t box[2] = {(cuuint32_t)kChunk, (cuuint32_t)kBC};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, (void*)ptr, dims, strides,
                            box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The shape's tiling, into a; the device's SM count. Queries and corpus
// 16-byte aligned (the TMA and the queries' 16-byte loads).
cudaError_t shape(Args& a, int& sms) {
  if (a.rows < 1 || a.n < 1 || query_tile(a.D) == 0 ||
      reinterpret_cast<uintptr_t>(a.q) % 16 != 0 || reinterpret_cast<uintptr_t>(a.c) % 16 != 0)
    return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = prepare(dev, sms);
  if (err != cudaSuccess) return err;
  a.nk = query_tile(a.D) == 128 ? 4 : 8;
  a.nblk = (a.n + kBlock - 1) / kBlock;
  a.n_tiles = (a.n + kBC - 1) / kBC;
  return cudaSuccess;
}

}  // namespace

// Plain C interface (loaded with ctypes). The launches run on the given
// stream, do not synchronise, and return the launch's error (0: none).
extern "C" {

// The query rows a maxima block owns, and the pairs a candidates work item
// takes, at depth dim: 128, 64 past a depth of 128, 0 where the kernels do
// not take the depth (a multiple of 8 up to 256).
int tt_prefilter_f32_query_tile(int dim) { return query_tile(dim); }

// maxima[rows, ceil(n / 64)]: each query row's maximum score over each
// 64-row block of the corpus's first n rows. The grid: query tiles by
// corpus slices, as many slices as fill the SMs at one block an SM (the
// shared memory allows no more), none empty.
int tt_prefilter_f32_maxima(const float* q, const float* c, int rows, int n, int dim,
                            float* maxima, void* stream) {
  Args a{};
  a.q = q;
  a.c = c;
  a.rows = rows;
  a.n = n;
  a.D = dim;
  a.maxima = maxima;
  int sms = 0;
  cudaError_t err = shape(a, sms);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap cmap;
  err = corpus_map(&cmap, c, n, dim);
  if (err != cudaSuccess) return (int)err;
  const int tile = query_tile(dim);
  const int q_tiles = (rows + tile - 1) / tile;
  int slices = max(1, min(sms / q_tiles, a.n_tiles));
  a.tiles_per_slice = (a.n_tiles + slices - 1) / slices;
  slices = (a.n_tiles + a.tiles_per_slice - 1) / a.tiles_per_slice;
  const dim3 grid((unsigned)q_tiles, (unsigned)slices);
  const int smem = 1024 + a.nk * 2 * tile * kRowBytes + kStages * kStageBytes + 64 * tile +
                   2 * kStages * 8;
  const cudaStream_t s = (cudaStream_t)stream;
  if (tile == 128)
    prefilter_f32_maxima_kernel<<<grid, kMaximaThreads, smem, s>>>(a, cmap);
  else
    prefilter_f32_maxima_deep_kernel<<<grid, kMaximaThreads, smem, s>>>(a, cmap);
  return (int)cudaGetLastError();
}

// cand[rows, k, 64]: for each query row and each of its k chosen blocks,
// the row's 64 scores of that block at the block's rank; slots past the
// corpus's n rows keep the caller's fill (-inf). The chosen blocks come as
// the host code sorts them (prefilter_f32.py): order[rows k], the pairs r k
// + i by block; bounds[nblk + 1], each block's first pair; work_end[nblk],
// the work items (ceil(pairs / tile) a block) through each block;
// work_block[items], each item's block (nblk: none).
int tt_prefilter_f32_candidates(const float* q, const float* c, int rows, int n, int dim, int k,
                                const long long* order, const long long* bounds,
                                const long long* work_end, const long long* work_block,
                                int items, float* cand, void* stream) {
  if (k < 1 || items < 1) return (int)cudaErrorInvalidValue;
  Args a{};
  a.q = q;
  a.c = c;
  a.rows = rows;
  a.n = n;
  a.D = dim;
  a.k = k;
  a.order = reinterpret_cast<const int64_t*>(order);
  a.bounds = reinterpret_cast<const int64_t*>(bounds);
  a.work_end = reinterpret_cast<const int64_t*>(work_end);
  a.work_block = reinterpret_cast<const int64_t*>(work_block);
  a.cand = cand;
  int sms = 0;
  cudaError_t err = shape(a, sms);
  if (err != cudaSuccess) return (int)err;
  const int tile = query_tile(dim);
  const int smem = 1024 + 4 * tile * kRowBytes + tile * 8;
  const cudaStream_t s = (cudaStream_t)stream;
  if (tile == 128)
    prefilter_f32_candidates_kernel<<<(unsigned)items, kCandThreads, smem, s>>>(a);
  else
    prefilter_f32_candidates_deep_kernel<<<(unsigned)items, kCandThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
