// Fused in-batch sampled-softmax loss, backward, for Hopper (sm_90a): the
// row-parallel dU = dS . V and the column-parallel dV = dS^T . U, on tensor
// cores at float32 accuracy (3xTF32).
//
// Replaces the TPU kernel _bwd_call / _bwd_kernel
// (twotower_tpu/ops/pallas_kernels.py:167-265), which accumulated dV in a
// read-modify-write across its sequential grid. The forward kernel is in
// fused_loss.cu. For local user rows r at global row row_offset + r
// against all B item columns c:
//   S[r,c]  = (U[r] . V[c]) * inv_temp - cols[c], set to -1e9 where
//             ids[c] == ids[row_offset + r] and c != row_offset + r
//   P  = exp(S - lse) with the masked entries set to 0
//   dS = (P - [c == row_offset + r]) * g[r] * inv_temp
//   dU = dS . V   (R x D);   dV = dS^T . U   (B x D)
//
// Bound on the H100, each kernel, at R = B = 4096, D = 128: the S
// recompute plus one product, 4*R*B*D = 8.59 GFLOP. At float32 accuracy
// with three TF32 passes that is 25.8 GFLOP at 495 TFLOP/s = 0.052 ms (in
// plain float32 FMA at 67 TFLOP/s, 0.128 ms). The R*B = 16.8M exps take
// about 0.004 ms; the bytes (U, V, ids, cols, lse, g in, one [*, D] out,
// about 6 MB, resident in L2) about 0.002 ms. Operation-bound.
//
// One template body serves both kernels. A block owns kBM = 128 rows of
// its output (U rows for dU, V rows for dV) and streams kBN = 32-row tiles
// of the other operand; per tile it computes S' = owned . streamed^T (for
// dV the transposed S tile), turns it into dS' in registers and adds
// dS' . streamed to its output rows. The block is three warpgroups: a
// producer that loads each tile (cp.async) and splits it into shared
// memory, and two consumers of 64 rows each that multiply, handing buffers
// over through named barriers. What the design does about what held the
// first (SIMT) version back:
// 1. Tensor cores. Both products are wgmma.mma_async TF32 with float32
//    accumulation (m64n32k8 for S', m64n128k8 for the second product), A
//    from registers and B from shared memory. Each operand is split into
//    hi = rna(x) and lo = rna(x - hi), rna rounding to TF32 as
//    cvt.rna.tf32.f32 does (in two integer operations: see tf32_rna), and
//    the product is lo.hi + hi.lo + hi.hi (CUTLASS's "fast f32"): the
//    reference's tolerances hold where one TF32 pass misses them many
//    times over.
// 2. Shared-memory traffic. The producer splits each streamed tile once,
//    into hi and lo planes in the two K-major layouts the tensor cores read
//    themselves: B1 (streamed row, depth) for S' and B2 (depth, streamed
//    row) for the second product; no warp loads a B fragment. The owned
//    rows' A fragments come from a float32 tile whose 16-byte chunks are
//    XOR-swizzled by the row, and B2's core matrices are spaced so that the
//    split's transposed stores hit 32 banks: both are free of bank
//    conflicts. The S' accumulator becomes dS' in registers and is the A
//    operand of the second product as it stands: that product's K order
//    within each 8 rows is 0 2 4 6 1 3 5 7 (fragment columns t and t + 4
//    are accumulator columns 2t and 2t + 1), and B2 stores the streamed
//    rows in that order. dS' never touches shared memory.
// 3. Grid and overlap. 384 threads and 209.6 KB of shared memory a block
//    (two buffers of B1 2 x 16 KB, B2 2 x 16.1 KB and the tile's vectors;
//    the landing tile 16.4 KB; the owned tile 64 KB), one block an SM with
//    8 warps issuing MMAs while 4 split the next tile into the other
//    buffer. The streamed dimension is cut into slices so that (row tiles
//    x slices x depth chunks) fills the SMs (slices_for, from the shape
//    and the SM count); at B = 4096 that is 32 x 4 = 128 blocks on 132
//    SMs. Each slice writes a partial sum into scratch that the caller
//    allocates at the size tt_fused_loss_bwd_scratch gives, and
//    fused_loss_bwd_sum_slices adds the slices in a fixed order: the same
//    bits on every launch, with no atomics. (Adding the slices inside a
//    thread-block cluster instead, through distributed shared memory, was
//    slower: at 214 KB a block the card holds too few clusters of 4 at
//    once for the 32 row tiles, and 3 slices leave SMs idle.)
// 4. Copies. 16-byte cp.async into a landing tile; the producer loads the
//    next tile while the consumers multiply. Depth that is not a multiple
//    of 4 (rows not 16-byte aligned) takes 4-byte copies. Ragged rows,
//    columns and depth are zero-filled by the copy itself.
// 5. Epilogue. The owned rows' values (id, lse and g, or log q) sit in
//    registers for the block's life; the streamed columns' values travel
//    with their tile, so the (i, j) loop reads no global memory.
// What still holds it back (0.15 ms on the H100, about a third of the
// bound): every k-step of S' splits its own A fragments and issues three
// small register-sourced MMAs, and producer and consumers each take about
// as long a tile as the other, so neither waits but neither is fast.
// Depth wider than kKD: S' runs over depth chunks of kKD, each a step that
// also brings the owned rows' chunk (one buffer, two owned chunks in
// flight), ordered so that the chunk of the block's output columns
// (grid.z) comes last and its B2 serves the second product. The main path
// (D = 128) never takes that route.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_tf32.cuh"

namespace {

using namespace tt_sm90;  // kKD (depth of a tile; output columns a block), the block's warpgroups

constexpr int kBM = 128;                // owned rows a block: two consumer warpgroups
constexpr int kBN = 32;                 // streamed rows a tile
constexpr int kKSteps = kKD / 8;        // k-steps of the S product over a full chunk
constexpr int kSN = kBN / 8;            // k-steps of the second product
// Shared memory, in bytes. Tiles the tensor cores read are in the K-major
// canonical layout of sm90_tf32.cuh, at a stride of kLbo* along K and kSbo*
// along the rows.
constexpr int kOwnBytes = kBM * kKD * 4;  // owned rows, float32, 16-byte chunks swizzled
constexpr int kLbo1 = 128, kSbo1 = kKD / 4 * 128;  // B1: streamed rows x depth
constexpr int kB1Bytes = kBN * kKD * 4;
// B2: output column d x streamed row, one 16-byte step between the core
// matrices of successive K groups, so that a warp's 32 stores of one
// column hit 32 banks.
constexpr int kSbo2 = 128, kLbo2 = kKD / 8 * 128 + 16;
constexpr int kB2Bytes = (kBN / 4 - 1) * kLbo2 + kKD / 8 * 128;
constexpr int kRawBytes = kBN * kKD * 4;  // cp.async lands the streamed tile here
constexpr int kVecWords = 3 * kBN;        // a tile's per-column sub, g, id
constexpr int kSplitBytes = 2 * kB1Bytes + 2 * kB2Bytes;  // one tile's B1 and B2, hi and lo
constexpr int kBufBytes = kSplitBytes + kVecWords * 4;    // and its vectors
static_assert(kB2Bytes % 16 == 0, "planes start 16-byte aligned");

struct Args {
  const float* own;   // [n_own, D]: U for dU, V for dV
  const float* str;   // [n_str, D]: V for dU, U for dV
  const int* ids;     // [B]
  const float* cols;  // [B]
  const float* lse;   // [R]
  const float* g;     // [R]
  int n_own, n_str, D, row_offset;
  float inv_temp;
  float* out;         // [slices, n_own, D]: the output itself when slices == 1
  int tiles_per_slice, nchunks, vec16;
};

// The streamed columns' values for the tile at t0: sub (cols for dU, lse
// for dV), g (dV only) and the item id (ids[t] for dU, ids[row_offset + t]
// for dV). Zero past n_str.
template <bool kByColumn>
__device__ __forceinline__ void load_vecs(float* vec, const Args& a, int t0, int tid) {
  const int j = tid;
  if (j >= kBN) return;
  const int t = t0 + j;
  const bool ok = t < a.n_str;
  const int tc = ok ? t : 0;
  if (kByColumn) {
    cp_async4(vec + j, a.lse + tc, ok);
    cp_async4(vec + kBN + j, a.g + tc, ok);
    cp_async4(vec + 2 * kBN + j, a.ids + a.row_offset + tc, ok);
  } else {
    cp_async4(vec + j, a.cols + tc, ok);
    cp_async4(vec + 2 * kBN + j, a.ids + tc, ok);
  }
}

// The streamed tile, raw -> its hi and lo TF32 parts in the two layouts
// the tensor cores read: B1 (streamed row t, depth k) for the S product
// and B2 (depth d, streamed row t) for the second product, whose K order
// within each 8 rows is 0 2 4 6 1 3 5 7 (see bwd_body). A warp takes 32
// rows of one 16-byte chunk.
__device__ __forceinline__ void convert_tile(char* b1_hi, char* b1_lo, char* b2_hi, char* b2_lo,
                                             const float* raw, int tid) {
  static_assert(kBN == 32, "a warp converts one chunk column of the tile");
#pragma unroll 2
  for (int e = tid; e < kBN * kKD / 4; e += kProducers) {
    const int t = e % kBN, c = (e / kBN) * 4;
    const float4 x = *reinterpret_cast<const float4*>(raw + raw_at(t, c));
    uint4 hi, lo;
    split(x.x, hi.x, lo.x);
    split(x.y, hi.y, lo.y);
    split(x.z, hi.z, lo.z);
    split(x.w, hi.w, lo.w);
    const int o1 = (t >> 3) * kSbo1 + (c >> 2) * kLbo1 + (t & 7) * 16;
    *reinterpret_cast<uint4*>(b1_hi + o1) = hi;
    *reinterpret_cast<uint4*>(b1_lo + o1) = lo;
    const int kk = (t & ~7) + ((t & 7) >> 1) + 4 * (t & 1);  // K index of row t
    const int o2 = (c >> 3) * kSbo2 + (kk >> 2) * kLbo2 + (c & 7) * 16 + (kk & 3) * 4;
    const uint32_t h[4] = {hi.x, hi.y, hi.z, hi.w}, l[4] = {lo.x, lo.y, lo.z, lo.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // columns c + i: rows (c + i) & 7 of one core matrix
      *reinterpret_cast<uint32_t*>(b2_hi + o2 + i * 16) = h[i];
      *reinterpret_cast<uint32_t*>(b2_lo + o2 + i * 16) = l[i];
    }
  }
}

template <bool kByColumn>
__device__ __forceinline__ void bwd_body(const Args& a) {
  extern __shared__ __align__(128) char smem[];
  const int nchunks = a.nchunks;
  const bool multi = nchunks > 1;
  // One depth chunk: two sets of split tiles (with their vectors), so that
  // the producer splits the next tile while the consumers multiply this
  // one. Wider depth: one set, and two owned chunks in flight instead.
  const int nbuf = multi ? 1 : 2;
  float* str_raw = reinterpret_cast<float*>(smem + nbuf * kBufBytes);
  float* vec_land = str_raw + kRawBytes / 4;  // the next tile's vectors, as loaded
  float* own_raw = vec_land + kVecWords;      // the owned tile, or two chunks
  auto b1_hi = [&](int b) { return smem + b * kBufBytes; };
  auto b1_lo = [&](int b) { return b1_hi(b) + kB1Bytes; };
  auto b2_hi = [&](int b) { return b1_hi(b) + 2 * kB1Bytes; };
  auto b2_lo = [&](int b) { return b2_hi(b) + kB2Bytes; };
  auto vec_of = [&](int b) { return reinterpret_cast<float*>(b1_hi(b) + kSplitBytes); };

  const int a0 = blockIdx.x * kBM;
  const int slice = blockIdx.y;
  const int dc = blockIdx.z;  // output depth chunk
  const int n_tiles = (a.n_str + kBN - 1) / kBN;
  const int tile_begin = slice * a.tiles_per_slice;
  const int tile_end = min(tile_begin + a.tiles_per_slice, n_tiles);
  const int nsteps = max(tile_end - tile_begin, 0) * nchunks;

  // Step i: streamed tile tile_begin + i / nchunks at depth chunk
  // chunk_of(i); the block's output chunk dc comes last for each tile.
  auto chunk_of = [&](int step) { return (dc + 1 + step % nchunks) % nchunks; };
  auto own_of = [&](int step) { return own_raw + (multi ? (step & 1) * (kOwnBytes / 4) : 0); };

  if (threadIdx.x >= kConsumers) {
    // Producer: load each step's tiles with cp.async, split them into the
    // step's buffer once the consumers are done with it, hand it over.
    const int tid = threadIdx.x - kConsumers;
    auto issue = [&](int step) {
      const int k0 = chunk_of(step) * kKD;
      const int t0 = (tile_begin + step / nchunks) * kBN;
      if (multi) load_tile<kBM>(own_of(step), a.own, a0, a.n_own, a.D, k0, a.vec16, tid);
      load_tile<kBN>(str_raw, a.str, t0, a.n_str, a.D, k0, a.vec16, tid);
      load_vecs<kByColumn>(vec_land, a, t0, tid);
      cp_async_commit();
    };
    if (!multi) load_tile<kBM>(own_raw, a.own, a0, a.n_own, a.D, 0, a.vec16, tid);
    if (nsteps > 0) issue(0);
    for (int step = 0; step < nsteps; ++step) {
      const int b = step % nbuf;
      cp_async_wait_all();
      bar_sync(kBarProducer, kProducers);  // this step's raw tiles landed
      if (step >= nbuf) bar_sync(kBarEmpty + b, kThreads);
      convert_tile(b1_hi(b), b1_lo(b), b2_hi(b), b2_lo(b), str_raw, tid);
      if (tid < kVecWords) vec_of(b)[tid] = vec_land[tid];
      fence_to_async_proxy();
      bar_sync(kBarProducer, kProducers);  // the raw tiles are free
      bar_arrive(kBarFull + b, kThreads);
      if (step + 1 < nsteps) issue(step + 1);
    }
    for (int step = max(nsteps - nbuf, 0); step < nsteps; ++step)
      bar_sync(kBarEmpty + step % nbuf, kThreads);  // the consumers' last releases
    return;
  }

  // Consumers: two warpgroups, each 64 of the block's rows.
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;  // fragment row group
  const int tq = lane & 3;   // thread in group

  // The owned rows of this thread: local rows 16 warp + gq (+ 8).
  const int own_row = 16 * warp + gq;
  bool o_ok[2];
  int o_id[2], o_glob[2];
  float o_sub[2], o_fac[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int o = a0 + own_row + 8 * h;
    o_ok[h] = o < a.n_own;
    o_glob[h] = kByColumn ? o : a.row_offset + o;
    o_id[h] = o_ok[h] ? a.ids[o_glob[h]] : 0;
    if (kByColumn) {
      o_sub[h] = o_ok[h] ? a.cols[o] : 0.f;
      o_fac[h] = a.inv_temp;
    } else {
      o_sub[h] = o_ok[h] ? a.lse[o] : 0.f;
      o_fac[h] = o_ok[h] ? a.g[o] * a.inv_temp : 0.f;
    }
  }

  // Accumulators in the wgmma layout: element e of 8-column group j is
  // row gq + 8 (e / 2), column 8 j + 2 tq + e % 2 of the warp's 16 rows.
  float out[4 * kKD / 8];
#pragma unroll
  for (int i = 0; i < 4 * kKD / 8; ++i) out[i] = 0.f;
  float acc[4 * kBN / 8];
  const int out_w = min(kKD, a.D - dc * kKD);

  for (int step = 0; step < nsteps; ++step) {
    const int b = step % nbuf;
    bar_sync(kBarFull + b, kThreads);
    const int ci = step % nchunks;
    if (ci == 0) {
#pragma unroll
      for (int i = 0; i < 4 * kBN / 8; ++i) acc[i] = 0.f;
    }

    // S' += owned . streamed^T over this chunk: A (owned rows) from
    // registers, split per k-step into two buffers (the values are loaded
    // a k-step ahead), so that one k-step's split overlaps the previous
    // k-step's MMAs; B1 from shared memory. Three passes: lo.hi, hi.lo,
    // hi.hi.
    const float* own_t = own_of(step);
    const int ksteps = (min(kKD, a.D - chunk_of(step) * kKD) + 7) / 8;
    uint32_t a_hi[2][4], a_lo[2][4];
    float a_next[4];
    auto load_a = [&](int ks) {
      const int c = 8 * min(ks, kKSteps - 1) + tq;
      a_next[0] = own_t[raw_at(own_row, c)];
      a_next[1] = own_t[raw_at(own_row + 8, c)];
      a_next[2] = own_t[raw_at(own_row, c + 4)];
      a_next[3] = own_t[raw_at(own_row + 8, c + 4)];
    };
    load_a(0);
    auto s_kstep = [&](int ks, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
      for (int i = 0; i < 4; ++i) split(a_next[i], hi[i], lo[i]);
      load_a(ks + 1);
#pragma unroll
      for (int i = 0; i < 4 * kBN / 8; ++i) pin(acc[i]);
      wgmma_fence();
      const uint64_t d_hi = smem_desc(b1_hi(b) + ks * 2 * kLbo1, kLbo1, kSbo1);
      const uint64_t d_lo = smem_desc(b1_lo(b) + ks * 2 * kLbo1, kLbo1, kSbo1);
      wgmma_n32(acc, lo, d_hi);
      wgmma_n32(acc, hi, d_lo);
      wgmma_n32(acc, hi, d_hi);
      wgmma_commit();
      wgmma_wait<1>();  // the k-step before is done: its A buffer may be reused
    };
    for (int ks = 0; ks < ksteps; ks += 2) {
      s_kstep(ks, a_hi[0], a_lo[0]);
#pragma unroll
      for (int i = 0; i < 4; ++i) pin(a_hi[1][i]), pin(a_lo[1][i]);
      if (ks + 1 < ksteps) s_kstep(ks + 1, a_hi[1], a_lo[1]);
#pragma unroll
      for (int i = 0; i < 4; ++i) pin(a_hi[0][i]), pin(a_lo[0][i]);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 4 * kBN / 8; ++i) pin(acc[i]);
#pragma unroll
    for (int i = 0; i < 4; ++i) pin(a_hi[1][i]), pin(a_lo[1][i]);

    if (ci == nchunks - 1) {
      // dS' in place.
      const int t0 = (tile_begin + step / nchunks) * kBN;
      const float* vec = vec_of(b);
      const int* vid = reinterpret_cast<const int*>(vec + 2 * kBN);
#pragma unroll
      for (int i = 0; i < 4 * kBN / 8; ++i) {
        const int h = (i >> 1) & 1;
        const int j = 8 * (i >> 2) + 2 * tq + (i & 1);
        const int t = t0 + j;
        const float s_sub = vec[j];
        const int s_glob = kByColumn ? a.row_offset + t : t;
        const bool diag = s_glob == o_glob[h];
        // S = acc * inv_temp - log q (of the column), then minus the row's lse.
        const float sc = acc[i] * a.inv_temp - (kByColumn ? o_sub[h] : s_sub);
        float p = expf(sc - (kByColumn ? s_sub : o_sub[h]));
        if (vid[j] == o_id[h] && !diag) p = 0.f;
        const float fac = kByColumn ? vec[kBN + j] * a.inv_temp : o_fac[h];
        acc[i] = (t < a.n_str && o_ok[h]) ? (p - (diag ? 1.f : 0.f)) * fac : 0.f;
      }

      // out += dS' . streamed, A (dS') from registers, B2 from shared
      // memory. K runs over the tile's rows in the order 0 2 4 6 1 3 5 7
      // within each 8, which makes the A fragment of k-step n (columns t
      // and t + 4) the accumulator's 8-column group n (columns 2t and
      // 2t + 1): {acc[4n], acc[4n + 2], acc[4n + 1], acc[4n + 3]}.
      uint32_t ds_hi[kSN][4], ds_lo[kSN][4];
#pragma unroll
      for (int n = 0; n < kSN; ++n) {
        split(acc[4 * n + 0], ds_hi[n][0], ds_lo[n][0]);
        split(acc[4 * n + 2], ds_hi[n][1], ds_lo[n][1]);
        split(acc[4 * n + 1], ds_hi[n][2], ds_lo[n][2]);
        split(acc[4 * n + 3], ds_hi[n][3], ds_lo[n][3]);
      }
#pragma unroll
      for (int i = 0; i < 4 * kKD / 8; ++i) pin(out[i]);
      wgmma_fence();
#pragma unroll
      for (int n = 0; n < kSN; ++n) {
        const uint64_t d_hi = smem_desc(b2_hi(b) + n * 2 * kLbo2, kLbo2, kSbo2);
        const uint64_t d_lo = smem_desc(b2_lo(b) + n * 2 * kLbo2, kLbo2, kSbo2);
        wgmma_n128(out, ds_lo[n], d_hi);
        wgmma_n128(out, ds_hi[n], d_lo);
        wgmma_n128(out, ds_hi[n], d_hi);
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 4 * kKD / 8; ++i) pin(out[i]);
#pragma unroll
      for (int n = 0; n < kSN; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) pin(ds_hi[n][i]), pin(ds_lo[n][i]);
    }
    bar_arrive(kBarEmpty + b, kThreads);
  }

  float* dst = a.out + (size_t)slice * a.n_own * a.D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!o_ok[h]) continue;
    float* row = dst + (size_t)(a0 + own_row + 8 * h) * a.D + dc * kKD;
#pragma unroll
    for (int j = 0; j < kKD / 8; ++j) {
      const int d = 8 * j + 2 * tq;
      if (d < out_w) row[d] = out[4 * j + 2 * h];
      if (d + 1 < out_w) row[d + 1] = out[4 * j + 2 * h + 1];
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1) fused_loss_bwd_du_kernel(const Args a) {
  bwd_body<false>(a);
}

__global__ void __launch_bounds__(kThreads, 1) fused_loss_bwd_dv_kernel(const Args a) {
  bwd_body<true>(a);
}

// out[i] = sum over slices s = 0, 1, ... of part[s][i], in that order.
__global__ void __launch_bounds__(256)
fused_loss_bwd_sum_slices(const float* __restrict__ part, int slices, long long n,
                          float* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n4 = (n % 4 == 0) ? n / 4 : 0;  // float4 only when every slice is aligned
  const float4* p4 = reinterpret_cast<const float4*>(part);
  for (long long i = first; i < n4; i += stride) {
    float4 s = p4[i];
    for (int k = 1; k < slices; ++k) {
      const float4 v = p4[k * n4 + i];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    reinterpret_cast<float4*>(out)[i] = s;
  }
  for (long long i = 4 * n4 + first; i < n; i += stride) {
    float s = part[i];
    for (int k = 1; k < slices; ++k) s += part[k * n + i];
    out[i] = s;
  }
}

int chunks_for(int dim) { return (dim + kKD - 1) / kKD; }

size_t smem_bytes(int nchunks) {
  // Two buffers and one owned tile, or one buffer and two owned chunks
  // (see bwd_body).
  return (nchunks > 1 ? 1 : 2) * kBufBytes + kRawBytes + kVecWords * 4 +
         (nchunks > 1 ? 2 : 1) * kOwnBytes;
}

// Opt both kernels in to the shared memory they take, and read the SM
// count, once a device.
cudaError_t prepare(int dev, int& sms) {
  static int sm_count[64] = {};
  if (dev < 64 && sm_count[dev] > 0) {
    sms = sm_count[dev];
    return cudaSuccess;
  }
  const int most = (int)max(smem_bytes(1), smem_bytes(2));
  cudaError_t err = cudaFuncSetAttribute(fused_loss_bwd_du_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fused_loss_bwd_dv_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < 64) sm_count[dev] = sms;
  return err;
}

// Slices of the streamed tiles: as many as fill the SMs at one block an SM
// (the shared memory allows no more), no more than there are tiles, none
// empty.
int slices_for(int n_own, int n_str, int dim, int sms) {
  const long long blocks = (long long)((n_own + kBM - 1) / kBM) * chunks_for(dim);
  const int n_tiles = (n_str + kBN - 1) / kBN;
  const int slices = (int)max(1LL, min((long long)sms / blocks, (long long)n_tiles));
  const int per_slice = (n_tiles + slices - 1) / slices;
  return (n_tiles + per_slice - 1) / per_slice;
}

int launch(bool by_column, Args a, float* out, float* scratch, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = prepare(dev, sms);
  if (err != cudaSuccess) return (int)err;
  const int slices = slices_for(a.n_own, a.n_str, a.D, sms);
  if (slices > 1 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const int n_tiles = (a.n_str + kBN - 1) / kBN;
  a.nchunks = chunks_for(a.D);
  a.tiles_per_slice = (n_tiles + slices - 1) / slices;
  a.vec16 = a.D % 4 == 0 && reinterpret_cast<uintptr_t>(a.own) % 16 == 0 &&
            reinterpret_cast<uintptr_t>(a.str) % 16 == 0;
  a.out = slices > 1 ? scratch : out;
  const dim3 grid((unsigned)((a.n_own + kBM - 1) / kBM), (unsigned)slices, (unsigned)a.nchunks);
  const size_t smem = smem_bytes(a.nchunks);
  if (by_column)
    fused_loss_bwd_dv_kernel<<<grid, kThreads, smem, stream>>>(a);
  else
    fused_loss_bwd_du_kernel<<<grid, kThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || slices == 1) return (int)err;
  const long long n = (long long)a.n_own * a.D;
  const long long work = (n % 4 == 0) ? n / 4 : n;
  const unsigned blocks = (unsigned)(work < 4096LL * 256 ? (work + 255) / 256 : 4096);
  fused_loss_bwd_sum_slices<<<blocks, 256, 0, stream>>>(scratch, slices, n, out);
  return (int)cudaGetLastError();
}

Args make_args(const float* own, const float* str, const int* ids, const float* cols,
               const float* lse, const float* g, int n_own, int n_str, int dim, int row_offset,
               float inv_temp) {
  Args a{};
  a.own = own;
  a.str = str;
  a.ids = ids;
  a.cols = cols;
  a.lse = lse;
  a.g = g;
  a.n_own = n_own;
  a.n_str = n_str;
  a.D = dim;
  a.row_offset = row_offset;
  a.inv_temp = inv_temp;
  return a;
}

}  // namespace

// Plain C interface (loaded with ctypes). The launches run on the given
// stream, do not synchronise, and return cudaGetLastError().
extern "C" {

// Floats of float32 scratch that dU (own_rows = rows, str_rows = batch) or
// dV (own_rows = batch, str_rows = rows) at depth `dim` needs on the
// current device: its streamed rows are cut into slices whose partial sums
// go there (0: one slice, no scratch). The kernel's entry point decides the
// slices again by the same rule. Returns minus the CUDA error on failure.
long long tt_fused_loss_bwd_scratch(int own_rows, int str_rows, int dim) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = prepare(dev, sms);
  if (err != cudaSuccess) return -(long long)err;
  const int slices = slices_for(own_rows, str_rows, dim, sms);
  return slices > 1 ? (long long)slices * own_rows * dim : 0;
}

int tt_fused_loss_bwd_du(const float* u, const float* v, const int* ids, const float* cols,
                         const float* lse, const float* g, int rows, int batch, int dim,
                         int row_offset, float inv_temp, float* du, float* scratch,
                         void* stream) {
  const Args a = make_args(u, v, ids, cols, lse, g, rows, batch, dim, row_offset, inv_temp);
  return launch(false, a, du, scratch, (cudaStream_t)stream);
}

int tt_fused_loss_bwd_dv(const float* u, const float* v, const int* ids, const float* cols,
                         const float* lse, const float* g, int rows, int batch, int dim,
                         int row_offset, float inv_temp, float* dv, float* scratch,
                         void* stream) {
  const Args a = make_args(v, u, ids, cols, lse, g, batch, rows, dim, row_offset, inv_temp);
  return launch(true, a, dv, scratch, (cudaStream_t)stream);
}

}  // extern "C"
