// Block attention over packed streams for the sequence tower's MLA, for
// Hopper (sm_90a): forward, and its backward as two kernels, dQ and dK/dV.
//
// Replaces no TPU kernel: the sequence tower (models/seq_tower.py) has no
// twin in the JAX package. Its attention wrote the block scores [S / W, h,
// W, 2 W] in bfloat16 and again in float32, scaled, masked, softmaxed and
// cast them in separate passes, expanded the one shared RoPE key to every
// head, copied each key block beside the block before it, and autograd ran
// the backward of every one of those passes; ops/attention.py launches the
// kernels here instead.
//
// A stream is S slots of users' windows laid end to end; pos[s] is a slot's
// place in its window, which holds at most W slots. Query q sees key k iff
// k <= q, k >= q - pos[q] and k >= (q / W - 1) W (the block before its own,
// as the plain version's blocks have it). Per head, with q = [q_nope | q_pe]
// and k = [k_nope | k_pe] (k_pe one [S, dr] for every head, as MLA has it):
//   forward  O = softmax(scale q k^T, masked) v, and lse per (head, query);
//   dQ       dS = P o (dP - D), dP = dO v^T, D = rowsum(dO o O);
//            dq = scale dS k; D is written for the dK/dV kernel;
//   dK/dV    dv = P^T dO, dk = scale dS^T q; dk_pe per head in float32,
//            summed over the heads by the caller in a fixed order.
// P is recomputed from lse in both backward kernels; no float atomics, so
// two launches give the same bits.
//
// Bound on the H100 at seq_dsv2lite_train's shape (S = 32,768, 16 heads,
// dn 128, dr 64, dv 128, W 64): the bytes. A layer's forward reads q,
// k_nope, v and k_pe and writes O and lse, 0.61 GB, 0.18 ms at 3.35 TB/s;
// its products over the blocks' 128 keys, 43 GFLOP, take 0.04 ms at 989
// TFLOP/s. The backward moves 1.2 GB. What the design does about it:
// 1. Each byte once. A block owns 64 queries of one head (forward, dQ) or
//    64 keys (dK/dV), and the Tensor Memory Accelerator loads its tiles
//    from the tensors as they lie: k_nope and v as strided views of
//    kv_b's output [S, h, dn + dv], k_pe from its [S, dr] without a copy
//    per head, the 64 + W rows of the other side at once (the block before
//    and its own), rows before the stream's start arriving as zeros. The
//    grid runs the blocks of one head side by side, so a tile read by two
//    neighbours comes from L2 the second time.
// 2. Nothing of size blocks x keys leaves the chip. S accumulates in float32
//    registers (wgmma bf16, from the TMA's swizzled tiles), is masked from
//    pos and softmaxed there; P in bfloat16 is the register A operand of
//    the next product, whose B is the tile read N-major (the transposed
//    descriptor), so no tile is transposed or copied.
// 3. Outputs in the layouts their readers take: O as [S, h dv] (the
//    o-projection's input), dq as [S, h, dn + dr] and dk_nope | dv as [S, h,
//    dn + dv] (the gradients of the projections' outputs).
// One warpgroup a block, all of its tiles loaded at once. Two forward blocks
// fit an SM, so the loads of one overlap the products of the other; the
// backward's blocks take 124 KB of shared memory, one an SM (at
// seq_dsv2lite_train's shape the forward runs at 60-68% of its bound, the
// backward at 33-34%). The kernels are instantiated for the shapes the card
// runs, (W, dn, dr, dv) = (64, 128, 64, 128) and (16, 32, 16, 32); a tile
// is cut into chunks of C = min(64, dn, dr, dv) columns, each row of a
// chunk 2 C bytes in the swizzle of that width.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_tf32.cuh"
#include "sm90_tma.cuh"

namespace {

using namespace tt_sm90;

constexpr int kThreads = 128;  // one warpgroup
constexpr int kM = 64;         // queries (forward, dQ) or keys (dK/dV) a block owns
constexpr float kLog2e = 1.4426950408889634f;

constexpr int cmin(int a, int b) { return a < b ? a : b; }
constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

template <int W, int DN, int DR, int DV>
struct Shape {
  static constexpr int kC = cmin(64, cmin(DN, cmin(DR, DV)));  // columns of a chunk
  static constexpr int kR = kM + W;  // rows of the other side: the block before and its own
  static constexpr int kNN = DN / kC, kNP = DR / kC, kNQ = kNN + kNP, kNV = DV / kC;
  static constexpr int kRowBytes = 2 * kC;
  static constexpr int kChunkM = round_up(kM * kRowBytes, 1024);  // a chunk of kM rows
  static constexpr int kChunkR = round_up(kR * kRowBytes, 1024);  // a chunk of kR rows
  static_assert(DN % kC == 0 && DR % kC == 0 && DV % kC == 0, "widths not chunked");
  static_assert((kC == 64 || kC == 16) && W % 16 == 0 && W <= 64, "shape not instantiated");
};

struct Args {
  const int* pos;     // [S] int32
  int n, heads;
  float scale;        // softmax scale
  __nv_bfloat16* out;        // [S, h dv]: forward's O; backward's O (read)
  float* lse;                // [h, S]
  const __nv_bfloat16* dout; // [S, h dv]
  float* delta;              // [h, S]: D, written by dQ, read by dK/dV
  __nv_bfloat16* dq;         // [S, h, dn + dr]
  __nv_bfloat16* dkv;        // [S, h, dn + dv]
  float* dkpe;               // [S, h, dr]
};

// d (64 x 128) = A (64 x 16, shared memory, da) . B (128 x 16, shared memory, db)^T,
// plus d unless scale_d is 0; both operands K-major.
__device__ __forceinline__ void mma_ss(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
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

// d (64 x 80) = A (64 x 16, shared memory, da) . B (80 x 16, shared memory, db)^T,
// plus d unless scale_d is 0; both operands K-major.
__device__ __forceinline__ void mma_ss(float (&d)[40], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, %40, %41, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64) = a (64 x 16, registers) . B (16 x 64, shared memory, db, N-major),
// plus d unless scale_d is 0.
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                       int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (64 x 16) = a (64 x 16, registers) . B (16 x 16, shared memory, db, N-major),
// plus d unless scale_d is 0.
__device__ __forceinline__ void mma_rs(float (&d)[8], const uint32_t (&a)[4], uint64_t db,
                                       int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// Shared-memory descriptor of a chunk of rows of kC bfloat16 (2 kC bytes,
// swizzled by that width), 8-row groups 16 kC bytes apart. Read K-major it
// is an MMA's A or B with the depth along the row (a k-step of 16 starts
// 32 bytes further on); read N-major (a B whose rows are the depth) a
// k-step of 16 rows starts 32 kC bytes further on.
template <int kC>
__device__ __forceinline__ uint64_t desc(const void* p) {
  constexpr uint64_t layout = kC == 64 ? 1 : 3;  // the 128- or the 32-byte swizzle
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(16 * kC >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The first key slot query q sees (its last is q itself).
template <int W>
__device__ __forceinline__ int first_key(const Args& a, int q) {
  return max(max(q - __ldg(a.pos + q), (q / W - 1) * W), 0);
}

// d = A (kM rows) . B (kR rows)^T over nc chunks: both tiles K-major.
template <int kC, int kR>
__device__ __forceinline__ void scores(float (&d)[kR / 2], const char* a, int a_chunk,
                                       const char* b, int b_chunk, int nc) {
#pragma unroll
  for (int i = 0; i < kR / 2; ++i) pin(d[i]);
  wgmma_fence();
  #pragma unroll
  for (int c = 0; c < nc; ++c)
#pragma unroll
    for (int j = 0; j < kC / 16; ++j)
      mma_ss(d, desc<kC>(a + c * a_chunk + 32 * j), desc<kC>(b + c * b_chunk + 32 * j),
             (c | j) != 0);
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < kR / 2; ++i) pin(d[i]);
}

// Element 4 j + 2 h + e of a 64 x N accumulator is row 16 warp + gq + 8 h,
// column 8 j + 2 tq + e; the A fragment of k-step kk is columns 16 kk to
// 16 kk + 15 of the same rows.
template <int kR>
__device__ __forceinline__ void to_fragments(uint32_t (&f)[kR / 16][4], const float (&d)[kR / 2]) {
#pragma unroll
  for (int kk = 0; kk < kR / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) f[kk][i] = pack_bf16(d[8 * kk + 2 * i], d[8 * kk + 2 * i + 1]);
}

// o[c] = f (kM x kR, registers) . chunk c of t (kR rows, read N-major), c < kNC.
template <int kC, int kR, int kNC>
__device__ __forceinline__ void times_tile(float (&o)[kNC][kC / 2], const uint32_t (&f)[kR / 16][4],
                                           const char* t, int chunk) {
#pragma unroll
  for (int c = 0; c < kNC; ++c)
#pragma unroll
    for (int i = 0; i < kC / 2; ++i) pin(o[c][i]);
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < kNC; ++c)
#pragma unroll
    for (int kk = 0; kk < kR / 16; ++kk)
      mma_rs(o[c], f[kk], desc<kC>(t + c * chunk + kk * 32 * kC), kk != 0);
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int c = 0; c < kNC; ++c)
#pragma unroll
    for (int i = 0; i < kC / 2; ++i) pin(o[c][i]);
}

// The first kNC chunks of a chunked 64-row accumulator as bfloat16 rows ld
// elements apart from base (row row0), rows at or past n left out.
template <int kC, int kNC, int kAll>
__device__ __forceinline__ void store_bf16(const float (&o)[kAll][kC / 2], __nv_bfloat16* base,
                                           size_t ld, int row0, int n) {
  const int warp = threadIdx.x >> 5, gq = (threadIdx.x & 31) >> 2, tq = threadIdx.x & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + 16 * warp + gq + 8 * h;
    if (r >= n) continue;
#pragma unroll
    for (int c = 0; c < kNC; ++c)
#pragma unroll
      for (int j = 0; j < kC / 8; ++j)
        *reinterpret_cast<uint32_t*>(base + r * ld + c * kC + 8 * j + 2 * tq) =
            pack_bf16(o[c][4 * j + 2 * h], o[c][4 * j + 2 * h + 1]);
  }
}

template <int W, int DN, int DR, int DV>
constexpr int fwd_smem() {
  using T = Shape<W, DN, DR, DV>;
  return 1024 + T::kNQ * (T::kChunkM + T::kChunkR) + T::kNV * T::kChunkR + 16;
}

// Forward: block (query block, head).
template <int W, int DN, int DR, int DV>
__global__ void __launch_bounds__(kThreads, 1)
    stream_attention_fwd_kernel(const Args a, const __grid_constant__ CUtensorMap qmap,
                                const __grid_constant__ CUtensorMap kvmap,
                                const __grid_constant__ CUtensorMap pemap) {
  using T = Shape<W, DN, DR, DV>;
  constexpr int kC = T::kC, kR = T::kR;
  extern __shared__ __align__(1024) char smem_raw[];
  char* q_s = smem_raw + (-smem_u32(smem_raw) & 1023);
  char* k_s = q_s + T::kNQ * T::kChunkM;
  char* v_s = k_s + T::kNQ * T::kChunkR;
  uint64_t* bar = reinterpret_cast<uint64_t*>(v_s + T::kNV * T::kChunkR);
  const int q0 = blockIdx.x * kM, head = blockIdx.y, k0 = q0 - W;
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_init(bar + 1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bar, T::kNQ * (kM + kR) * T::kRowBytes);
    for (int c = 0; c < T::kNQ; ++c) tma_load_3d(q_s + c * T::kChunkM, &qmap, bar, c * kC, head, q0);
    for (int c = 0; c < T::kNN; ++c) tma_load_3d(k_s + c * T::kChunkR, &kvmap, bar, c * kC, head, k0);
    for (int c = 0; c < T::kNP; ++c)
      tma_load_3d(k_s + (T::kNN + c) * T::kChunkR, &pemap, bar, c * kC, 0, k0);
    mbar_expect_tx(bar + 1, T::kNV * kR * T::kRowBytes);
    for (int c = 0; c < T::kNV; ++c)
      tma_load_3d(v_s + c * T::kChunkR, &kvmap, bar + 1, DN + c * kC, head, k0);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, gq = (threadIdx.x & 31) >> 2, tq = threadIdx.x & 3;
  int lo[2], hi[2];  // the row's keys: tile columns lo to hi
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + 16 * warp + gq + 8 * h;
    lo[h] = r < a.n ? first_key<W>(a, r) - k0 : 1;
    hi[h] = r < a.n ? r - k0 : 0;
  }
  mbar_wait(bar, 0);
  float s[kR / 2];
  scores<kC, kR>(s, q_s, T::kChunkM, k_s, T::kChunkR, T::kNQ);

  const float sl2 = a.scale * kLog2e;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < kR / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * tq + e;
        float& x = s[4 * j + 2 * h + e];
        x = col >= lo[h] && col <= hi[h] ? x * sl2 : -INFINITY;
        m[h] = fmaxf(m[h], x);
      }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 1));
    m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 2));
    if (m[h] == -INFINITY) m[h] = 0.f;  // a row past the stream: no key
  }
#pragma unroll
  for (int j = 0; j < kR / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * j + 2 * h + e];
        x = exp2f(x - m[h]);
        l[h] += x;
      }
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    inv[h] = l[h] > 0.f ? 1.f / l[h] : 0.f;
    const int r = q0 + 16 * warp + gq + 8 * h;
    if (tq == 0 && r < a.n) a.lse[(size_t)head * a.n + r] = (m[h] + log2f(l[h])) / kLog2e;
  }
#pragma unroll
  for (int j = 0; j < kR / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) s[4 * j + 2 * h + e] *= inv[h];
  uint32_t p[kR / 16][4];
  to_fragments<kR>(p, s);

  mbar_wait(bar + 1, 0);
  float o[T::kNV][kC / 2];
  times_tile<kC, kR, T::kNV>(o, p, v_s, T::kChunkR);
  store_bf16<kC, T::kNV>(o, a.out + head * DV, (size_t)a.heads * DV, q0, a.n);
}

template <int W, int DN, int DR, int DV>
constexpr int dq_smem() {
  using T = Shape<W, DN, DR, DV>;
  return 1024 + T::kNQ * (T::kChunkM + T::kChunkR) + T::kNV * (T::kChunkM + T::kChunkR) +
         kM * 4 + 16;
}

// dQ: block (query block, head); D of its queries first, from O and dO.
template <int W, int DN, int DR, int DV>
__global__ void __launch_bounds__(kThreads, 1)
    stream_attention_dq_kernel(const Args a, const __grid_constant__ CUtensorMap qmap,
                               const __grid_constant__ CUtensorMap kvmap,
                               const __grid_constant__ CUtensorMap pemap,
                               const __grid_constant__ CUtensorMap domap) {
  using T = Shape<W, DN, DR, DV>;
  constexpr int kC = T::kC, kR = T::kR;
  extern __shared__ __align__(1024) char smem_raw[];
  char* q_s = smem_raw + (-smem_u32(smem_raw) & 1023);
  char* k_s = q_s + T::kNQ * T::kChunkM;
  char* do_s = k_s + T::kNQ * T::kChunkR;
  char* v_s = do_s + T::kNV * T::kChunkM;
  float* d_s = reinterpret_cast<float*>(v_s + T::kNV * T::kChunkR);
  uint64_t* bar = reinterpret_cast<uint64_t*>(d_s + kM);
  const int q0 = blockIdx.x * kM, head = blockIdx.y, k0 = q0 - W;
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_init(bar + 1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bar, T::kNQ * (kM + kR) * T::kRowBytes);
    for (int c = 0; c < T::kNQ; ++c) tma_load_3d(q_s + c * T::kChunkM, &qmap, bar, c * kC, head, q0);
    for (int c = 0; c < T::kNN; ++c) tma_load_3d(k_s + c * T::kChunkR, &kvmap, bar, c * kC, head, k0);
    for (int c = 0; c < T::kNP; ++c)
      tma_load_3d(k_s + (T::kNN + c) * T::kChunkR, &pemap, bar, c * kC, 0, k0);
    mbar_expect_tx(bar + 1, T::kNV * (kM + kR) * T::kRowBytes);
    for (int c = 0; c < T::kNV; ++c) {
      tma_load_3d(do_s + c * T::kChunkM, &domap, bar + 1, c * kC, head, q0);
      tma_load_3d(v_s + c * T::kChunkR, &kvmap, bar + 1, DN + c * kC, head, k0);
    }
  }
  {  // D = rowsum(dO o O): two threads a row, DV / 2 columns each
    const int r = q0 + threadIdx.x / 2, half = threadIdx.x & 1;
    float acc = 0.f;
    if (r < a.n) {
      const size_t at = ((size_t)r * a.heads + head) * DV + half * (DV / 2);
      const uint4* o4 = reinterpret_cast<const uint4*>(a.out + at);
      const uint4* g4 = reinterpret_cast<const uint4*>(a.dout + at);
#pragma unroll
      for (int i = 0; i < DV / 16; ++i) {
        const uint4 ov = __ldg(o4 + i), gv = __ldg(g4 + i);
        const __nv_bfloat162* ob = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* gb = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 x = __bfloat1622float2(ob[e]), y = __bfloat1622float2(gb[e]);
          acc = fmaf(x.x, y.x, fmaf(x.y, y.y, acc));
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      d_s[threadIdx.x / 2] = acc;
      if (r < a.n) a.delta[(size_t)head * a.n + r] = acc;
    }
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, gq = (threadIdx.x & 31) >> 2, tq = threadIdx.x & 3;
  int lo[2], hi[2];
  float lse[2], dd[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rr = 16 * warp + gq + 8 * h, r = q0 + rr;
    const bool live = r < a.n;
    lo[h] = live ? first_key<W>(a, r) - k0 : 1;
    hi[h] = live ? r - k0 : 0;
    lse[h] = live ? a.lse[(size_t)head * a.n + r] * kLog2e : 0.f;
    dd[h] = d_s[rr];
  }
  mbar_wait(bar, 0);
  float s[kR / 2];
  scores<kC, kR>(s, q_s, T::kChunkM, k_s, T::kChunkR, T::kNQ);
  const float sl2 = a.scale * kLog2e;
#pragma unroll
  for (int j = 0; j < kR / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * tq + e;
        float& x = s[4 * j + 2 * h + e];
        x = col >= lo[h] && col <= hi[h] ? exp2f(x * sl2 - lse[h]) : 0.f;
      }
  mbar_wait(bar + 1, 0);
  float dp[kR / 2];
  scores<kC, kR>(dp, do_s, T::kChunkM, v_s, T::kChunkR, T::kNV);
#pragma unroll
  for (int j = 0; j < kR / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * h + e;
        s[i] = s[i] * (dp[i] - dd[h]) * a.scale;
      }
  uint32_t ds[kR / 16][4];
  to_fragments<kR>(ds, s);
  float g[T::kNQ][kC / 2];
  times_tile<kC, kR, T::kNQ>(g, ds, k_s, T::kChunkR);
  store_bf16<kC, T::kNQ>(g, a.dq + head * (DN + DR), (size_t)a.heads * (DN + DR), q0, a.n);
}

template <int W, int DN, int DR, int DV>
constexpr int dkv_smem() {
  using T = Shape<W, DN, DR, DV>;
  return 1024 + T::kNQ * (T::kChunkM + T::kChunkR) + T::kNV * (T::kChunkM + T::kChunkR) +
         3 * T::kR * 4 + 16;
}

// dK/dV: block (key block, head); its queries are the kR slots from its first key.
template <int W, int DN, int DR, int DV>
__global__ void __launch_bounds__(kThreads, 1)
    stream_attention_dkv_kernel(const Args a, const __grid_constant__ CUtensorMap qmap,
                                const __grid_constant__ CUtensorMap kvmap,
                                const __grid_constant__ CUtensorMap pemap,
                                const __grid_constant__ CUtensorMap domap) {
  using T = Shape<W, DN, DR, DV>;
  constexpr int kC = T::kC, kR = T::kR;
  extern __shared__ __align__(1024) char smem_raw[];
  char* k_s = smem_raw + (-smem_u32(smem_raw) & 1023);
  char* q_s = k_s + T::kNQ * T::kChunkM;
  char* v_s = q_s + T::kNQ * T::kChunkR;
  char* do_s = v_s + T::kNV * T::kChunkM;
  int* first_s = reinterpret_cast<int*>(do_s + T::kNV * T::kChunkR);  // a query's first key - k0
  float* lse_s = reinterpret_cast<float*>(first_s + kR);
  float* d_s = lse_s + kR;
  uint64_t* bar = reinterpret_cast<uint64_t*>(d_s + kR);
  const int k0 = blockIdx.x * kM, head = blockIdx.y;
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_init(bar + 1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bar, T::kNQ * (kM + kR) * T::kRowBytes);
    for (int c = 0; c < T::kNN; ++c) tma_load_3d(k_s + c * T::kChunkM, &kvmap, bar, c * kC, head, k0);
    for (int c = 0; c < T::kNP; ++c)
      tma_load_3d(k_s + (T::kNN + c) * T::kChunkM, &pemap, bar, c * kC, 0, k0);
    for (int c = 0; c < T::kNQ; ++c) tma_load_3d(q_s + c * T::kChunkR, &qmap, bar, c * kC, head, k0);
    mbar_expect_tx(bar + 1, T::kNV * (kM + kR) * T::kRowBytes);
    for (int c = 0; c < T::kNV; ++c) {
      tma_load_3d(v_s + c * T::kChunkM, &kvmap, bar + 1, DN + c * kC, head, k0);
      tma_load_3d(do_s + c * T::kChunkR, &domap, bar + 1, c * kC, head, k0);
    }
  }
  if (threadIdx.x < kR) {
    const int q = k0 + threadIdx.x;
    const bool live = q < a.n;
    first_s[threadIdx.x] = live ? first_key<W>(a, q) - k0 : 1 << 30;
    lse_s[threadIdx.x] = live ? a.lse[(size_t)head * a.n + q] * kLog2e : 0.f;
    d_s[threadIdx.x] = live ? a.delta[(size_t)head * a.n + q] : 0.f;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, gq = (threadIdx.x & 31) >> 2, tq = threadIdx.x & 3;
  mbar_wait(bar, 0);
  float s[kR / 2];  // S^T: keys by queries
  scores<kC, kR>(s, k_s, T::kChunkM, q_s, T::kChunkR, T::kNQ);
  const float sl2 = a.scale * kLog2e;
#pragma unroll
  for (int j = 0; j < kR / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = 16 * warp + gq + 8 * h, col = 8 * j + 2 * tq + e;
        float& x = s[4 * j + 2 * h + e];
        x = row >= first_s[col] && row <= col ? exp2f(x * sl2 - lse_s[col]) : 0.f;
      }
  uint32_t f[kR / 16][4];
  to_fragments<kR>(f, s);
  mbar_wait(bar + 1, 0);
  {
    float g[T::kNV][kC / 2];
    times_tile<kC, kR, T::kNV>(g, f, do_s, T::kChunkR);  // dv = P^T dO
    store_bf16<kC, T::kNV>(g, a.dkv + head * (DN + DV) + DN, (size_t)a.heads * (DN + DV), k0, a.n);
  }
  float dp[kR / 2];  // dP^T = v dO^T
  scores<kC, kR>(dp, v_s, T::kChunkM, do_s, T::kChunkR, T::kNV);
#pragma unroll
  for (int j = 0; j < kR / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float dd = d_s[8 * j + 2 * tq + e];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 4 * j + 2 * h + e;
        s[i] = s[i] * (dp[i] - dd) * a.scale;
      }
    }
  to_fragments<kR>(f, s);
  float g[T::kNQ][kC / 2];
  times_tile<kC, kR, T::kNQ>(g, f, q_s, T::kChunkR);  // dk = dS^T q
  const size_t ld = (size_t)a.heads * (DN + DV);
  store_bf16<kC, T::kNN>(g, a.dkv + head * (DN + DV), ld, k0, a.n);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = k0 + 16 * warp + gq + 8 * h;
    if (r >= a.n) continue;
    float* out = a.dkpe + ((size_t)r * a.heads + head) * DR + 2 * tq;
#pragma unroll
    for (int c = 0; c < T::kNP; ++c)
#pragma unroll
      for (int j = 0; j < kC / 8; ++j)
        *reinterpret_cast<float2*>(out + c * kC + 8 * j) =
            make_float2(g[T::kNN + c][4 * j + 2 * h], g[T::kNN + c][4 * j + 2 * h + 1]);
  }
}

// The tensor maps of q [S, h, dn + dr], kv [S, h, dn + dv], k_pe [S, dr]
// and dO [S, h dv], each in boxes of C deep and `rows` slots.
struct Maps {
  CUtensorMap q, kv, pe, dout;
};

template <int W, int DN, int DR, int DV>
cudaError_t make_maps(Maps& m, const void* q, const void* kv, const void* kpe, const void* dout,
                      int n, int heads, int q_rows, int k_rows) {
  using T = Shape<W, DN, DR, DV>;
  constexpr int kC = T::kC;
  cudaError_t err = tensor_map_3d(&m.q, q, n, heads, DN + DR, DN + DR,
                                  (long long)heads * (DN + DR), kC, q_rows);
  if (err == cudaSuccess)
    err = tensor_map_3d(&m.kv, kv, n, heads, DN + DV, DN + DV, (long long)heads * (DN + DV), kC,
                        k_rows);
  if (err == cudaSuccess) err = tensor_map_3d(&m.pe, kpe, n, 1, DR, DR, DR, kC, k_rows);
  if (err == cudaSuccess && dout != nullptr)
    err = tensor_map_3d(&m.dout, dout, n, heads, DV, DV, (long long)heads * DV, kC, q_rows);
  return err;
}

enum { kFwd = 0, kDq = 1, kDkv = 2 };

// Every instantiated kernel's shared-memory opt-in, once a device.
cudaError_t opt_in() {
  const SmemOptIn kernels[6] = {
      {(const void*)stream_attention_fwd_kernel<64, 128, 64, 128>, fwd_smem<64, 128, 64, 128>()},
      {(const void*)stream_attention_dq_kernel<64, 128, 64, 128>, dq_smem<64, 128, 64, 128>()},
      {(const void*)stream_attention_dkv_kernel<64, 128, 64, 128>, dkv_smem<64, 128, 64, 128>()},
      {(const void*)stream_attention_fwd_kernel<16, 32, 16, 32>, fwd_smem<16, 32, 16, 32>()},
      {(const void*)stream_attention_dq_kernel<16, 32, 16, 32>, dq_smem<16, 32, 16, 32>()},
      {(const void*)stream_attention_dkv_kernel<16, 32, 16, 32>, dkv_smem<16, 32, 16, 32>()},
  };
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = prepare(dev, sms, kernels);
  return err;
}

template <int W, int DN, int DR, int DV>
cudaError_t launch(int kind, const Args& a, const void* q, const void* kv, const void* kpe,
                   cudaStream_t stream) {
  using T = Shape<W, DN, DR, DV>;
  cudaError_t err = opt_in();
  if (err != cudaSuccess) return err;
  Maps m;
  const dim3 grid((unsigned)((a.n + kM - 1) / kM), (unsigned)a.heads);
  if (kind == kFwd) {
    err = make_maps<W, DN, DR, DV>(m, q, kv, kpe, nullptr, a.n, a.heads, kM, T::kR);
    if (err != cudaSuccess) return err;
    stream_attention_fwd_kernel<W, DN, DR, DV>
        <<<grid, kThreads, fwd_smem<W, DN, DR, DV>(), stream>>>(a, m.q, m.kv, m.pe);
  } else if (kind == kDq) {
    err = make_maps<W, DN, DR, DV>(m, q, kv, kpe, a.dout, a.n, a.heads, kM, T::kR);
    if (err != cudaSuccess) return err;
    stream_attention_dq_kernel<W, DN, DR, DV>
        <<<grid, kThreads, dq_smem<W, DN, DR, DV>(), stream>>>(a, m.q, m.kv, m.pe, m.dout);
  } else {
    err = make_maps<W, DN, DR, DV>(m, q, kv, kpe, a.dout, a.n, a.heads, T::kR, kM);
    if (err != cudaSuccess) return err;
    stream_attention_dkv_kernel<W, DN, DR, DV>
        <<<grid, kThreads, dkv_smem<W, DN, DR, DV>(), stream>>>(a, m.q, m.kv, m.pe, m.dout);
  }
  return cudaGetLastError();
}

cudaError_t dispatch(int kind, const Args& a, const void* q, const void* kv, const void* kpe,
                     int window, int dn, int dr, int dv, cudaStream_t stream) {
  if (a.n < 1 || a.heads < 1) return cudaErrorInvalidValue;
  if (window == 64 && dn == 128 && dr == 64 && dv == 128)
    return launch<64, 128, 64, 128>(kind, a, q, kv, kpe, stream);
  if (window == 16 && dn == 32 && dr == 16 && dv == 32)
    return launch<16, 32, 16, 32>(kind, a, q, kv, kpe, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C interface (loaded with ctypes). Every tensor is contiguous
// bfloat16 unless said otherwise; S slots, h heads. The launches run on the
// given stream, do not synchronise, and return the launch's error (0: none;
// an instantiation the shape does not match is cudaErrorInvalidValue).
extern "C" {

// out [S, h dv] and lse [h, S] (float32) of q [S, h, dn + dr], kv [S, h,
// dn + dv] (k_nope | v), k_pe [S, dr] and pos [S] (int32).
int tt_stream_attention_fwd(const void* q, const void* kv, const void* kpe, const int* pos,
                            int n, int heads, int window, int dn, int dr, int dv, float scale,
                            void* out, float* lse, void* stream) {
  Args a{};
  a.pos = pos;
  a.n = n;
  a.heads = heads;
  a.scale = scale;
  a.out = static_cast<__nv_bfloat16*>(out);
  a.lse = lse;
  return (int)dispatch(kFwd, a, q, kv, kpe, window, dn, dr, dv, (cudaStream_t)stream);
}

// dq [S, h, dn + dr] and delta [h, S] (float32, D) from the forward's out and
// lse and the gradient dout [S, h dv].
int tt_stream_attention_dq(const void* q, const void* kv, const void* kpe, const int* pos,
                           const void* out, const float* lse, const void* dout, int n,
                           int heads, int window, int dn, int dr, int dv, float scale, void* dq,
                           float* delta, void* stream) {
  Args a{};
  a.pos = pos;
  a.n = n;
  a.heads = heads;
  a.scale = scale;
  a.out = static_cast<__nv_bfloat16*>(const_cast<void*>(out));
  a.lse = const_cast<float*>(lse);
  a.dout = static_cast<const __nv_bfloat16*>(dout);
  a.dq = static_cast<__nv_bfloat16*>(dq);
  a.delta = delta;
  return (int)dispatch(kDq, a, q, kv, kpe, window, dn, dr, dv, (cudaStream_t)stream);
}

// dkv [S, h, dn + dv] (dk_nope | dv) and dkpe [S, h, dr] (float32, each
// head's share of dk_pe) from lse, delta (tt_stream_attention_dq's) and dout.
int tt_stream_attention_dkv(const void* q, const void* kv, const void* kpe, const int* pos,
                            const float* lse, const float* delta, const void* dout, int n,
                            int heads, int window, int dn, int dr, int dv, float scale,
                            void* dkv, float* dkpe, void* stream) {
  Args a{};
  a.pos = pos;
  a.n = n;
  a.heads = heads;
  a.scale = scale;
  a.lse = const_cast<float*>(lse);
  a.delta = const_cast<float*>(delta);
  a.dout = static_cast<const __nv_bfloat16*>(dout);
  a.dkv = static_cast<__nv_bfloat16*>(dkv);
  a.dkpe = dkpe;
  return (int)dispatch(kDkv, a, q, kv, kpe, window, dn, dr, dv, (cudaStream_t)stream);
}

}  // extern "C"
