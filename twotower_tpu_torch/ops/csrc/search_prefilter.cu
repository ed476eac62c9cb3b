// Block-maxima prefilter of the approx search over a bfloat16 corpus, for
// Hopper (sm_90a): the scores S = Q . C^T of bfloat16 query rows against
// bfloat16 corpus rows, accumulated in float32 on the tensor cores, reduced
// in registers and never written to device memory whole.
//
// Replaces no TPU kernel. The JAX package's topk_mips_approx
// (twotower_tpu/ops/topk.py) is XLA ops: a product, then lax.approx_max_k,
// an exact top-k off the TPU. The port's search wrote the float32 scores of
// every 256-row query chunk against the whole corpus to device memory and
// radix-selected over all of them; ops/prefilter.py searches through the
// kernels here instead. Two of them share one body (body<kMode>):
//   maxima      M[r, j] = max of S[r, c] over the corpus rows c of block j
//               (64 rows, the last one ragged), written [rows, nblk];
//   candidates  the 64 scores of each of the row's k blocks of largest
//               maximum (torch.topk over M in between), written
//               [rows, k, 64] in the order of the row's list of blocks.
// A third, prefilter_ranks_kernel, turns that list into the rank of each
// chosen block and marks the corpus tiles each 64 query rows need; the
// candidates kernel skips the tiles none of a block's rows chose (for a few
// query rows, nearly all of them). Both launch the same grid over the same
// tiles, and every score is the same chain of MMAs in both, so a kept score
// is, bit for bit, the score its block's maximum was taken over.
//
// Bound on the H100 at c3_validate's batch (4096 rows, N = 1,145,145
// corpus rows, D = 128): 2 rows N D = 1.20 TFLOP a launch, 1.21 ms at the
// bfloat16 dense peak of 989 TFLOP/s; the bytes (the corpus read once, 293
// MB; the maxima written once, 293 MB) 0.18 ms at 3.35 TB/s. It is bound by
// the tensor cores. What the design does about it:
// 1. The tensor cores' full rate: wgmma.mma_async m64n128k16, bf16 operands
//    from shared memory in the K-major layout with the 128-byte swizzle
//    (rows of 64 bf16, 16-byte chunks permuted by the row), float32
//    accumulators.
// 2. Few bytes a FLOP. A block owns kBM = 256 query rows (two consumer
//    warpgroups of two 64-row MMA tiles), loaded into shared memory once
//    (up to 128 KB at D = 256), and streams the corpus past them: each
//    corpus byte it reads serves 256 rows. The grid is (query tiles, corpus
//    slices) with the query tile fastest, so the blocks that stream one
//    slice run side by side and read it from L2 (16 tiles x 8 slices = 128
//    blocks, one an SM, at c3_validate's batch).
// 3. Copies beside the MMAs. One producer thread has the Tensor Memory
//    Accelerator copy each 128-row x 64-deep corpus stage (16 KB, one box,
//    swizzled on the way) into a ring of kStages, each completing on its
//    mbarrier (a cp.async warp could not keep up: copies and MMAs then took
//    about as long as their sum). The consumers release a stage once the
//    MMAs that read it have finished (wgmma.wait_group 1), so the next
//    stage's MMAs are issued before the last one's complete.
// 4. The epilogue in registers. Each thread holds 2 rows x 32 columns of a
//    64 x 128 tile: 16 values a row and block, a max over them, and two
//    shuffles across the 4 lanes of a row give a block maximum; only that
//    is stored (1/64 of the scores). The candidates' epilogue stores a
//    row's block only where its rank says the row chose it; the ranks are
//    loaded before the tile's MMAs, so their latency hides behind them. It
//    takes no atomics: a candidates kernel that appended scores through
//    atomic counters ran 4 times slower than the maxima, a warpgroup waiting
//    on each atomic's round trip.
// Query rows past `rows` and depth past D are zero in shared memory; corpus
// rows at or past n arrive as zeros and take no part in a maximum or a
// candidate (a candidate slot past n keeps the caller's -inf). D is a
// multiple of 16 up to 256, padded to stages of 64 with zeros.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_tf32.cuh"
#include "sm90_tma.cuh"

namespace {

using namespace tt_sm90;

constexpr int kBlock = 64;     // corpus rows a block maximum covers
constexpr int kBN = 128;       // corpus rows a tile: two blocks
constexpr int kMTiles = 2;     // 64-row MMA tiles a consumer warpgroup owns
constexpr int kBM = 2 * 64 * kMTiles;  // query rows a block: 256
constexpr int kBK = 64;        // depth of a stage: 64 bf16, 128 bytes a row
constexpr int kStages = 6;     // corpus stages in the ring
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 32;  // two consumer warpgroups, one producer warp
constexpr int kRowBytes = kBK * 2;         // a swizzled row: 128 bytes
constexpr int kStageBytes = kBN * kRowBytes;   // 16 KB
constexpr int kAStageBytes = kBM * kRowBytes;  // the query rows at one depth stage: 32 KB
constexpr int kMaxDepthStages = 4;             // D <= 256
// The ring and the query rows, each stage 1024-byte aligned (the swizzle's
// atom), with room to align the base, and the barriers after them.
constexpr int kMaxSmem =
    1024 + kMaxDepthStages * kAStageBytes + kStages * kStageBytes + (2 * kStages + 1) * 8;
enum { kMaxima = 0, kCandidates = 1 };

struct Args {
  const uint16_t* q;  // [rows, D] bfloat16
  const uint16_t* c;  // [n, D] bfloat16 (rows at or past n are never read)
  int rows, n, D, nk;  // nk: depth stages, ceil(D / 64)
  int nblk, n_tiles, tiles_per_slice;
  float* maxima;          // [rows, nblk]
  const int64_t* chosen;  // [rows, k]: each row's blocks of largest maximum
  int k;
  int16_t* rank;          // [rows, rank_stride]: a block's place in the row's list, or -1
  int rank_stride;        // nblk rounded up to even: a tile's two ranks are one int32
  uint32_t* flags;        // [query tiles, n_tiles]: bit j, MMA tile j chose a block there
  float* cand;            // [rows, k, 64]
};

// d (a 64 x 128 float32 accumulator) = A (64 x 16 bf16, shared memory, da)
// . B (128 x 16 bf16, shared memory, db)^T, plus d unless scale_d is 0.
// Both operands K-major (no transpose).
__device__ __forceinline__ void wgmma_bf16_n128(float (&d)[64], uint64_t da, uint64_t db,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(da), "l"(db), "r"(scale_d));
}

// The candidates' flags word of this block's query tile and a corpus tile.
__device__ __forceinline__ uint32_t tile_flags(const Args& a, int tile) {
  return __ldg(a.flags + (size_t)blockIdx.x * a.n_tiles + tile);
}

// Element 4 j + 2 h + e of a 64 x 128 accumulator is row gq + 8 h of the
// warp's 16, column 8 j + 2 tq + e of the tile's 128; that column is a
// corpus row iff 8 j + e < lim.
__device__ __forceinline__ int col_limit(const Args& a, int col0) {
  return a.n - col0 - 2 * (threadIdx.x & 3);
}

// The block maxima of one 64-row MMA tile whose first row is row0, over the
// corpus tile from col0.
__device__ __forceinline__ void maxima_epilogue(const Args& a, const float (&acc)[64], int row0,
                                                int col0) {
  const int warp = (threadIdx.x >> 5) & 3, gq = (threadIdx.x & 31) >> 2;
  const int lim = col_limit(a, col0);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + 16 * warp + gq + 8 * h;
#pragma unroll
    for (int bl = 0; bl < kBN / kBlock; ++bl) {
      float m = -INFINITY;
#pragma unroll
      for (int j = 8 * bl; j < 8 * bl + 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (8 * j + e < lim) m = fmaxf(m, acc[4 * j + 2 * h + e]);
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      const int blk = col0 / kBlock + bl;
      if ((threadIdx.x & 3) == 0 && r < a.rows && blk < a.nblk)
        a.maxima[(size_t)r * a.nblk + blk] = m;
    }
  }
}

// The candidates of one 64-row MMA tile: each row's scores of each block of
// the tile that the row chose, at its rank (ranks: the pair of the row's
// two blocks here, loaded before the MMAs; -1 where not chosen).
__device__ __forceinline__ void candidates_epilogue(const Args& a, const float (&acc)[64],
                                                    const int (&ranks)[2], int row0, int col0) {
  const int warp = (threadIdx.x >> 5) & 3, gq = (threadIdx.x & 31) >> 2;
  const int tq = threadIdx.x & 3;
  const int lim = col_limit(a, col0);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + 16 * warp + gq + 8 * h;
#pragma unroll
    for (int bl = 0; bl < kBN / kBlock; ++bl) {
      const int rank = (int)(int16_t)(ranks[h] >> (16 * bl));  // the low half is block 2 t
      if (rank < 0) continue;
      float* out = a.cand + ((size_t)r * a.k + rank) * kBlock + 2 * tq;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int jj = 8 * bl + j;
        if (8 * jj + 1 < lim)
          *reinterpret_cast<float2*>(out + 8 * j) =
              make_float2(acc[4 * jj + 2 * h], acc[4 * jj + 2 * h + 1]);
        else if (8 * jj < lim)
          out[8 * j] = acc[4 * jj + 2 * h];
      }
    }
  }
}

// A consumer warpgroup with kM of its two MMA tiles holding real query rows
// (0: it only takes part in the ring's hand-over): both tiles' MMAs over
// each stage as it arrives, then the tile's epilogue. The candidates skip
// the corpus tiles whose flags word is 0, as the producer does, and load
// their rows' ranks there before the MMAs.
template <int kMode, int kM>
__device__ __forceinline__ void consume(const Args& a, const char* a_smem, const char* b_smem,
                                        uint64_t* full, uint64_t* empty, int tile_begin,
                                        int tile_end) {
  const int wg = threadIdx.x >> 7;
  const int row0 = blockIdx.x * kBM + 128 * wg;
  const bool signal = (threadIdx.x & 127) == 0;
  const int warp = (threadIdx.x >> 5) & 3, gq = (threadIdx.x & 31) >> 2;
  float acc[kMTiles][64];
  int ranks[kMTiles][2];
  int step = 0;
  for (int tile = tile_begin; tile < tile_end; ++tile) {
    if (kMode == kCandidates) {
      if (!tile_flags(a, tile)) continue;
#pragma unroll
      for (int mt = 0; mt < kM; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row0 + 64 * mt + 16 * warp + gq + 8 * h;
          ranks[mt][h] = r < a.rows ? __ldg(reinterpret_cast<const int*>(
                                          a.rank + (size_t)r * a.rank_stride + 2 * tile))
                                    : -1;
        }
    }
    for (int c = 0; c < a.nk; ++c, ++step) {
      const int s = step % kStages;
      mbar_wait(full + s, (step / kStages) & 1);
      if (kM > 0) {
#pragma unroll
        for (int mt = 0; mt < kM; ++mt)
#pragma unroll
          for (int i = 0; i < 64; ++i) pin(acc[mt][i]);
        wgmma_fence();
        const char* a_stage = a_smem + c * kAStageBytes + 128 * wg * kRowBytes;
#pragma unroll
        for (int j = 0; j < kBK / 16; ++j) {
          const uint64_t db = sw128_desc(b_smem + s * kStageBytes + 32 * j);
#pragma unroll
          for (int mt = 0; mt < kM; ++mt)
            wgmma_bf16_n128(acc[mt], sw128_desc(a_stage + 64 * mt * kRowBytes + 32 * j), db,
                            (c | j) != 0);
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's MMAs are done with it
      }
      if (c > 0 && signal) mbar_arrive(empty + (step - 1) % kStages);
    }
    if (kM > 0) {
      wgmma_wait<0>();
#pragma unroll
      for (int mt = 0; mt < kM; ++mt)
#pragma unroll
        for (int i = 0; i < 64; ++i) pin(acc[mt][i]);
    }
    if (signal) mbar_arrive(empty + (step - 1) % kStages);
#pragma unroll
    for (int mt = 0; mt < kM; ++mt) {
      if (kMode == kMaxima)
        maxima_epilogue(a, acc[mt], row0 + 64 * mt, tile * kBN);
      else
        candidates_epilogue(a, acc[mt], ranks[mt], row0 + 64 * mt, tile * kBN);
    }
  }
}

template <int kMode>
__device__ __forceinline__ void body(const Args& a, const CUtensorMap* qmap,
                                     const CUtensorMap* cmap) {
  extern __shared__ __align__(1024) char smem_raw[];
  char* a_smem = smem_raw + (-smem_u32(smem_raw) & 1023);
  char* b_smem = a_smem + a.nk * kAStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(b_smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  uint64_t* a_ready = empty + kStages;

  const int tile_begin = blockIdx.y * a.tiles_per_slice;
  const int tile_end = min(tile_begin + a.tiles_per_slice, a.n_tiles);
  const int q0 = blockIdx.x * kBM;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);   // the producer's arrival with the stage's bytes
      mbar_init(empty + s, 2);  // one thread of each consumer warpgroup
    }
    mbar_init(a_ready, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // Producer: one thread loads the block's query rows, a box of 256 rows a
    // depth stage, once, then the ring's corpus stages.
    if (threadIdx.x != kConsumers) return;
    mbar_expect_tx(a_ready, a.nk * kAStageBytes);
    for (int c = 0; c < a.nk; ++c) tma_load(a_smem + c * kAStageBytes, qmap, a_ready, c * kBK, q0);
    int step = 0;
    for (int tile = tile_begin; tile < tile_end; ++tile) {
      if (kMode == kCandidates && !tile_flags(a, tile)) continue;
      for (int c = 0; c < a.nk; ++c, ++step) {
        const int s = step % kStages;
        if (step >= kStages) mbar_wait(empty + s, (step / kStages - 1) & 1);
        mbar_expect_tx(full + s, kStageBytes);
        tma_load(b_smem + s * kStageBytes, cmap, full + s, c * kBK, tile * kBN);
      }
    }
    return;
  }

  mbar_wait(a_ready, 0);
  const int live = a.rows - (q0 + 128 * (threadIdx.x >> 7));  // the warpgroup's real rows
  if (live > 64)
    consume<kMode, 2>(a, a_smem, b_smem, full, empty, tile_begin, tile_end);
  else if (live > 0)
    consume<kMode, 1>(a, a_smem, b_smem, full, empty, tile_begin, tile_end);
  else
    consume<kMode, 0>(a, a_smem, b_smem, full, empty, tile_begin, tile_end);
}

__global__ void __launch_bounds__(kThreads, 1)
    prefilter_maxima_kernel(const Args a, const __grid_constant__ CUtensorMap qmap,
                            const __grid_constant__ CUtensorMap cmap) {
  body<kMaxima>(a, &qmap, &cmap);
}

__global__ void __launch_bounds__(kThreads, 1)
    prefilter_candidates_kernel(const Args a, const __grid_constant__ CUtensorMap qmap,
                                const __grid_constant__ CUtensorMap cmap) {
  body<kCandidates>(a, &qmap, &cmap);
}

// For each row r and each i < k: the rank i of the row's chosen block
// chosen[r, i], and the bit of its 64-row MMA tile in the flags word of its
// query tile and corpus tile (rank -1 and flags 0 beforehand).
__global__ void __launch_bounds__(256) prefilter_ranks_kernel(const Args a) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)a.rows * a.k) return;
  const int r = (int)(e / a.k), i = (int)(e % a.k);
  const int blk = (int)a.chosen[e];
  a.rank[(size_t)r * a.rank_stride + blk] = (int16_t)i;
  atomicOr(a.flags + (size_t)(r / kBM) * a.n_tiles + blk / 2, 1u << (r % kBM / 64));
}

// The shape's tiling, into a; the device's SM count.
cudaError_t shape(Args& a, int& sms) {
  if (a.rows < 1 || a.n < 1 || a.D < 16 || a.D > kMaxDepthStages * kBK || a.D % 16 != 0)
    return cudaErrorInvalidValue;
  // Both tiled kernels may take the most shared memory.
  const SmemOptIn opt_in[2] = {{(const void*)prefilter_maxima_kernel, kMaxSmem},
                               {(const void*)prefilter_candidates_kernel, kMaxSmem}};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = prepare(dev, sms, opt_in);
  if (err != cudaSuccess) return err;
  a.nk = (a.D + kBK - 1) / kBK;
  a.nblk = (a.n + kBlock - 1) / kBlock;
  a.n_tiles = (a.n + kBN - 1) / kBN;
  a.rank_stride = (a.nblk + 1) / 2 * 2;
  return cudaSuccess;
}

// The grid: query tiles by corpus slices, as many slices as fill the SMs at
// one block an SM (the shared memory allows no more), none empty.
cudaError_t launch(Args& a, int mode, cudaStream_t stream) {
  int sms = 0;
  cudaError_t err = shape(a, sms);
  if (err != cudaSuccess) return err;
  CUtensorMap qmap, cmap;
  // bfloat16 rows read in boxes of 64 deep: the query tile's rows, the
  // corpus tile's.
  err = tensor_map(&qmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a.q, a.rows, a.D, kBK, kBM);
  if (err == cudaSuccess)
    err = tensor_map(&cmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a.c, a.n, a.D, kBK, kBN);
  if (err != cudaSuccess) return err;
  const int q_tiles = (a.rows + kBM - 1) / kBM;
  int slices = max(1, min(sms / q_tiles, a.n_tiles));
  a.tiles_per_slice = (a.n_tiles + slices - 1) / slices;
  slices = (a.n_tiles + a.tiles_per_slice - 1) / a.tiles_per_slice;
  const dim3 grid((unsigned)q_tiles, (unsigned)slices);
  const int smem = 1024 + a.nk * kAStageBytes + kStages * kStageBytes + (2 * kStages + 1) * 8;
  if (mode == kMaxima) {
    prefilter_maxima_kernel<<<grid, kThreads, smem, stream>>>(a, qmap, cmap);
    return cudaGetLastError();
  }
  const long long pairs = (long long)a.rows * a.k;
  prefilter_ranks_kernel<<<(unsigned)((pairs + 255) / 256), 256, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  prefilter_candidates_kernel<<<grid, kThreads, smem, stream>>>(a, qmap, cmap);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes). The launches run on the given
// stream, do not synchronise, and return the launch's error (0: none).
extern "C" {

// maxima[rows, ceil(n / 64)]: each query row's maximum score over each
// 64-row block of the corpus's first n rows.
int tt_prefilter_maxima(const void* q, const void* c, int rows, int n, int dim, float* maxima,
                        void* stream) {
  Args a{};
  a.q = static_cast<const uint16_t*>(q);
  a.c = static_cast<const uint16_t*>(c);
  a.rows = rows;
  a.n = n;
  a.D = dim;
  a.maxima = maxima;
  return (int)launch(a, kMaxima, (cudaStream_t)stream);
}

// Sizes of the candidates' scratch for `rows` query rows over the corpus's
// first n rows: int16 ranks (filled with -1 by the caller) and 32-bit flags
// words (zeroed by the caller). Returns 0, or the error of a shape the
// kernels do not take.
int tt_prefilter_scratch(int rows, int n, int dim, long long* rank_len, long long* flag_words) {
  Args a{};
  a.rows = rows;
  a.n = n;
  a.D = dim;
  int sms = 0;
  const cudaError_t err = shape(a, sms);
  if (err != cudaSuccess) return (int)err;
  *rank_len = (long long)rows * a.rank_stride;
  *flag_words = (long long)((rows + kBM - 1) / kBM) * a.n_tiles;
  return 0;
}

// cand[rows, k, 64]: for each query row and each of its k chosen blocks
// (chosen[rows, k], distinct block indices below ceil(n / 64)) the row's 64
// scores of that block, in the list's order; slots past the corpus's n rows
// keep the caller's fill (-inf). rank and flags: the scratch of
// tt_prefilter_scratch, as the caller filled it.
int tt_prefilter_candidates(const void* q, const void* c, int rows, int n, int dim,
                            const long long* chosen, int k, short* rank, unsigned* flags,
                            float* cand, void* stream) {
  if (k < 1 || k > 32767) return (int)cudaErrorInvalidValue;
  Args a{};
  a.q = static_cast<const uint16_t*>(q);
  a.c = static_cast<const uint16_t*>(c);
  a.rows = rows;
  a.n = n;
  a.D = dim;
  a.chosen = reinterpret_cast<const int64_t*>(chosen);
  a.k = k;
  a.rank = rank;
  a.flags = flags;
  a.cand = cand;
  return (int)launch(a, kCandidates, (cudaStream_t)stream);
}

}  // extern "C"
