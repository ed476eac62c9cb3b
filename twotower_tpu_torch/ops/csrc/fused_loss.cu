// Fused in-batch sampled-softmax loss for Hopper (sm_90a): the forward, on
// tensor cores at float32 accuracy (3xTF32). The backward (dU and dV) is in
// fused_loss_bwd.cu; the building blocks both share are in sm90_tf32.cuh.
//
// Replaces the TPU kernel _fwd_call / _fwd_kernel
// (twotower_tpu/ops/pallas_kernels.py:77-157). For local user rows r in
// [0, R) at global row row_offset + r against all B item columns c:
//   S[r,c]  = (U[r] . V[c]) * inv_temp - cols[c]
//             cols = per-column log q, plus 1e9 for zero-weight columns
//   S[r,c]  = -1e9 where ids[c] == ids[row_offset + r] and c != row_offset + r
//   lse[r]  = logsumexp_c S[r,c];  pos[r] = S[r, row_offset + r] (0 if outside)
//   loss = lse - pos;  correct = (pos >= max_c S[r,c])
// S never reaches device memory: each tile of it lives in registers.
//
// Bound on the H100 at R = B = 4096, D = 128: 2*R*B*D = 4.3 GFLOP, at
// float32 accuracy three TF32 passes, 12.9 GFLOP at 495 TFLOP/s = 0.026 ms
// (in plain float32 FMA at 67 TFLOP/s, 0.064 ms). The R*B = 16.8M exps
// take about 0.004 ms; the bytes (U, V, ids, cols in, four [R] vectors
// out, about 4 MB) 0.0013 ms. Operation-bound.
//
// A block owns kBM = 128 rows of U and streams kBN = 32-row tiles of V. It
// is three warpgroups: a producer that copies (cp.async) and splits the
// tiles, and two consumers of 64 owned rows each that multiply; named
// barriers hand two tile buffers over. What each choice does about the
// bound:
// 1. Tensor cores at float32 accuracy. S = U . V^T is wgmma.mma_async TF32
//    with float32 accumulation, both operands split into hi = rna(x) and
//    lo = rna(x - hi) (sm90_tf32.cuh), the product hi.hi + hi.lo + lo.hi:
//    one pass misses the forward's tolerance (rtol 1e-4) at every shape
//    checked, three keep it.
// 2. The owned rows are split once. They are the same for the whole column
//    stream, so each consumer splits its rows once, before the first tile:
//    hi into its A fragments (registers), lo into a shared plane (64 KB,
//    K-major) that its MMAs read through a descriptor. No k-step splits or
//    loads an A fragment again.
// 3. Two chains of MMAs a k-step. A tile's hi plane is followed by its lo
//    plane, so that the two are one 64-row B operand: hi_U . [hi_V; lo_V]
//    is one m64n64k8 (columns 0-31 hi.hi, 32-63 hi.lo, A from registers),
//    and lo_U . hi_V one m64n32k8 (A from shared memory) into an
//    accumulator of its own. The two chains do not wait on each other, and
//    only lo_U is read from shared memory a k-step, not hi_U too. Every k-step
//    of a depth chunk runs, also past D (the planes are zero there): with a
//    variable count, ptxas serialises the MMAs.
// 4. Overlap. The producer's copies run kAhead tiles ahead (each thread
//    splits only what it copied itself, so no producer barrier), and it
//    splits the next tile into the other buffer while the consumers
//    multiply this one. The consumers run unsynchronised, so that one's
//    epilogue can run beside the other's MMAs (making them take turns
//    gained nothing). The tile's cols and ids travel with it: the epilogue
//    reads no global memory.
// 5. Epilogue on the accumulator fragment. Each thread holds 2 rows x 8
//    columns of a tile: scale, log q, same-id mask and diagonal in
//    registers; its own online max and exp-sum a row, the exps as one FMA
//    and one MUFU.EX2 each (2^(x log2 e - m log2 e)); the 4 lanes of a row
//    merge theirs once, at the end (shfl_xor 1, 2).
// 6. A grid that fills the card, deterministically. Row tiles alone (32 at
//    R = 4096) cannot fill 132 SMs, so the columns are cut into slices from
//    the shape and the SM count (slices_for): 32 x 4 = 128 blocks, one an
//    SM. Each slice writes its rows' max, exp-sum and diagonal to scratch
//    (tt_fused_loss_fwd_scratch floats, allocated by the caller), and
//    fused_loss_fwd_merge_slices merges the slices in slice order: the same
//    bits on every launch, no atomics.
// What still holds it back (tools/fwd_ablate.py switches parts off): the
// MMAs alone take about 1.4 times the bound's tensor time, and the
// producer's copies and splits and the epilogue add about a third to that
// instead of hiding behind it (32 row tiles copy all of V from L2 32 times).
// Depth wider than kKD (D = 256, fused_loss_fwd_deep_kernel) accumulates S
// over depth chunks of a tile, the owned rows split again for every chunk;
// depth that is not a multiple of 4 takes 4-byte copies. The main path
// (D = 128) takes neither.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_tf32.cuh"

namespace {

using namespace tt_sm90;

constexpr int kBM = 128;  // owned rows a block: two consumer warpgroups
constexpr int kBN = 32;   // streamed rows (columns of S) a tile
constexpr int kKSteps = kKD / 8;  // k-steps of a depth chunk
constexpr float kNegInf = -1e9f;
constexpr float kLog2e = 1.4426950408889634f;
// Named barrier beside those of sm90_tf32.cuh: + warpgroup, its A_lo rows
// are written.
constexpr int kBarOwn = 6;
// Shared memory, in bytes: TF32 planes in the K-major layout of
// sm90_tf32.cuh, core matrices kLbo apart along K and 8-row groups kSbo
// apart.
constexpr int kLbo = 128, kSbo = kKD / 4 * 128;
constexpr int kOwnBytes = kBM * kKD * 4;  // the owned rows' lo plane
constexpr int kB1Bytes = kBN * kKD * 4;   // one plane of a streamed tile
constexpr int kBufBytes = 2 * kB1Bytes;   // hi rows 0-31, lo rows 32-63
constexpr int kVecWords = 2 * kBN;        // a tile's cols and ids
constexpr int kAhead = 3;                 // tiles the producer's copies run ahead
constexpr int kLandBytes = kBN * kKD * 4 + kVecWords * 4;  // a tile as copied, and its vectors
// [own lo][buffer 0][buffer 1][vectors 0, 1][kAhead landing tiles]
constexpr int kSmemBytes = kOwnBytes + 2 * kBufBytes + 2 * kVecWords * 4 + kAhead * kLandBytes;
// The producer's share of a tile: thread tid takes row 8 (tid / 32) +
// tid % 8 and the 16-byte chunks 4 j + tid % 32 / 8, j < kChunks; it
// copies them into its own slots of a landing tile and splits them from
// there, so that no other thread waits on its copies.
constexpr int kChunks = kBN * kKD / 4 / kProducers;
static_assert(kBN == 32 && kChunks == 8, "a quarter-warp takes 8 rows of 4 adjacent chunks");

struct Args {
  const float* u;     // [R, D]
  const float* v;     // [B, D]
  const int* ids;     // [B]
  const float* cols;  // [B]
  int R, B, D, row_offset;
  float inv_temp;
  float *loss, *lse, *correct, *pos;  // [R] each
  float* part;  // [slices][3][R]: each slice's row max, exp-sum, diagonal; null for one slice
  int tiles_per_slice, nchunks, vec16;
};

// loss, lse, correct and pos of row r from its max m, exp-sum l (relative
// to m) and diagonal score.
__device__ __forceinline__ void finish(const Args& a, int r, float m, float l, float pos) {
  const float lse = m + logf(l);
  a.loss[r] = lse - pos;
  a.lse[r] = lse;
  a.correct[r] = pos >= m ? 1.f : 0.f;
  a.pos[r] = pos;
}

// 2^x (MUFU.EX2): relative error about 2^-22, 0 for x = -inf.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The reference point of an exp-sum whose max is m: m itself, or 0 while
// nothing has been seen (every term is then exp(-inf) = 0).
__device__ __forceinline__ float exp_ref(float m) { return m == -INFINITY ? 0.f : m; }

// One depth chunk (kDeep false, the main path), or more: the owned rows'
// operands are then loaded again for every chunk.
template <bool kDeep>
__device__ __forceinline__ void fwd_body(const Args& a) {
  extern __shared__ __align__(128) char smem[];
  const int nchunks = kDeep ? a.nchunks : 1;
  char* own_lo = smem;
  auto buf = [&](int b) { return smem + kOwnBytes + b * kBufBytes; };
  float* vecs = reinterpret_cast<float*>(buf(2));
  auto vec_of = [&](int b) { return vecs + b * kVecWords; };

  const int a0 = blockIdx.x * kBM;
  const int slice = blockIdx.y;
  const int n_tiles = (a.B + kBN - 1) / kBN;
  const int tile_begin = slice * a.tiles_per_slice;
  const int tile_end = min(tile_begin + a.tiles_per_slice, n_tiles);
  const int nsteps = max(tile_end - tile_begin, 0) * nchunks;
  // Step i: streamed tile tile_begin + i / nchunks at depth chunk i % nchunks.
  auto t0_of = [&](int step) { return (tile_begin + step / nchunks) * kBN; };
  auto k0_of = [&](int step) { return step % nchunks * kKD; };

  if (threadIdx.x >= kConsumers) {
    // Producer: copy the tiles of the next kAhead steps into landing tiles
    // (cp.async) while the consumers multiply, split each into its step's
    // buffer once they are done with it, and hand it over. Each
    // quarter-warp reads 64 contiguous bytes of 8 rows and writes one
    // 128-byte core matrix a plane: no bank conflicts.
    const int tid = threadIdx.x - kConsumers;
    const int row = 8 * (tid >> 5) + (tid & 7);
    const int chunk = (tid & 31) >> 3;
    char* land = reinterpret_cast<char*>(vec_of(2));
    auto slot = [&](int step, int j) {  // this thread's chunk j of the step's landing tile
      return reinterpret_cast<float*>(land + step % kAhead * kLandBytes +
                                      (j * kProducers + tid) * 16);
    };
    auto slot_vec = [&](int step) {  // cols and ids, threads tid < kBN
      return reinterpret_cast<float*>(land + step % kAhead * kLandBytes + kBN * kKD * 4) + tid;
    };
    auto copy = [&](int step) {
      if (step < nsteps) {
        const int t = t0_of(step) + row, k0 = k0_of(step);
        const float* src = a.v + (size_t)min(t, a.B - 1) * a.D;
#pragma unroll
        for (int j = 0; j < kChunks; ++j) {
          const int k = k0 + 4 * (4 * j + chunk);
          float* dst = slot(step, j);
          if (a.vec16) {  // D % 4 == 0: the 4 floats are all in or all out
            const bool ok = t < a.B && k < a.D;
            cp_async16(dst, ok ? src + k : a.v, ok);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const bool ok = t < a.B && k + e < a.D;
              cp_async4(dst + e, ok ? src + k + e : a.v, ok);
            }
          }
        }
        if (tid < kBN) {
          const int c = t0_of(step) + tid;
          const bool ok = c < a.B;
          cp_async4(slot_vec(step), a.cols + (ok ? c : 0), ok);
          cp_async4(slot_vec(step) + kBN, a.ids + (ok ? c : 0), ok);
        }
      }
      cp_async_commit();  // one group a step, empty past the last
    };
#pragma unroll
    for (int step = 0; step < kAhead; ++step) copy(step);
    for (int step = 0; step < nsteps; ++step) {
      const int b = step % 2;
      cp_async_wait<kAhead - 1>();  // this thread's copies of the step landed
      if (step >= 2) bar_sync(kBarEmpty + b, kThreads);
#pragma unroll
      for (int j = 0; j < kChunks; ++j) {
        const float4 x = *reinterpret_cast<const float4*>(slot(step, j));
        uint4 h, l;
        split(x.x, h.x, l.x);
        split(x.y, h.y, l.y);
        split(x.z, h.z, l.z);
        split(x.w, h.w, l.w);
        const int o = (row >> 3) * kSbo + (4 * j + chunk) * kLbo + (row & 7) * 16;
        *reinterpret_cast<uint4*>(buf(b) + o) = h;
        *reinterpret_cast<uint4*>(buf(b) + kB1Bytes + o) = l;
      }
      if (tid < kBN) {
        vec_of(b)[tid] = slot_vec(step)[0];
        vec_of(b)[kBN + tid] = slot_vec(step)[kBN];
      }
      fence_to_async_proxy();
      bar_arrive(kBarFull + b, kThreads);
      copy(step + kAhead);  // into the landing tile just split
    }
    for (int step = max(nsteps - 2, 0); step < nsteps; ++step)
      bar_sync(kBarEmpty + step % 2, kThreads);  // the consumers' last releases
    return;
  }

  // Consumers: two warpgroups, each 64 of the block's rows.
  const int warp = threadIdx.x >> 5;
  const int wg = warp >> 2;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;  // fragment row group
  const int tq = lane & 3;   // thread in group
  const int own_row = 16 * warp + gq;  // local rows own_row and own_row + 8

  bool o_ok[2];
  int o_id[2], o_glob[2];
  float m[2], l[2], pos[2];  // this thread's running max, exp-sum and diagonal a row
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = a0 + own_row + 8 * h;
    o_ok[h] = r < a.R;
    o_glob[h] = a.row_offset + r;
    o_id[h] = o_ok[h] ? a.ids[o_glob[h]] : -1;
    m[h] = -INFINITY;
    l[h] = 0.f;
    pos[h] = 0.f;
  }

  // The owned rows of a depth chunk, split once: hi as this thread's A
  // fragments (k-step ks, element i: row own_row + 8 (i & 1), depth
  // k0 + 8 ks + tq + 4 (i >> 1)), lo into the warpgroup's rows of the
  // shared plane, which its MMAs read through a descriptor.
  uint32_t a_hi[kKSteps][4];
  auto load_own = [&](int k0) {
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int lr = own_row + 8 * (i & 1), k = 8 * ks + tq + 4 * (i >> 1);
        const int r = a0 + lr;
        const float x = (r < a.R && k0 + k < a.D) ? __ldg(a.u + (size_t)r * a.D + k0 + k) : 0.f;
        uint32_t lo;
        split(x, a_hi[ks][i], lo);
        *reinterpret_cast<uint32_t*>(own_lo + (lr >> 3) * kSbo + (k >> 2) * kLbo + (lr & 7) * 16 +
                                     (k & 3) * 4) = lo;
      }
    fence_to_async_proxy();
    bar_sync(kBarOwn + wg, 128);
  };
  const char* a_lo = own_lo + wg * 8 * kSbo;  // the warpgroup's 64 rows
  if (!kDeep) load_own(0);

  // A tile's S in two chains of MMAs that do not wait on each other:
  // hi_U . [hi_V; lo_V] (m64n64k8, A from registers; columns 0-31 hi.hi,
  // 32-63 hi.lo) into acc, and lo_U . hi_V (m64n32k8, A from shared
  // memory) into acc_lh; S is acc[0-15] + acc[16-31] + acc_lh.
  // Element e of 8-column group j is row gq + 8 (e / 2), column
  // 8 j + 2 tq + e % 2 of the warp's 16 rows. Every k-step of the chunk
  // runs, also past D (the planes are zero there): a fixed count keeps the
  // MMAs in flight back to back, where a variable one makes ptxas
  // serialise them.
  float acc[32], acc_lh[16];
  for (int step = 0; step < nsteps; ++step) {
    const int b = step % 2;
    const int ci = step % nchunks;
    if (kDeep) load_own(ci * kKD);
    bar_sync(kBarFull + b, kThreads);
#pragma unroll
    for (int i = 0; i < 32; ++i) pin(acc[i]);
#pragma unroll
    for (int i = 0; i < 16; ++i) pin(acc_lh[i]);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
      const int acc_on = ci != 0 || ks != 0;  // the first MMA of a tile overwrites
      const uint64_t d_b = smem_desc(buf(b) + ks * 2 * kLbo, kLbo, kSbo);
      wgmma_n64(acc, a_hi[ks], d_b, acc_on);
      wgmma_n32_ss(acc_lh, smem_desc(a_lo + ks * 2 * kLbo, kLbo, kSbo), d_b, acc_on);
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 32; ++i) pin(acc[i]);
#pragma unroll
    for (int i = 0; i < 16; ++i) pin(acc_lh[i]);
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks)
#pragma unroll
      for (int i = 0; i < 4; ++i) pin(a_hi[ks][i]);

    const bool last = ci == nchunks - 1;
    // This thread's 8 columns of the tile: 8 (jj / 2) + 2 tq + jj % 2.
    float vcol[8];
    int vid[8];
    if (last) {
      const float* vec = vec_of(b);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int j = 8 * (jj >> 1) + 2 * tq + (jj & 1);
        vcol[jj] = vec[j];
        vid[jj] = reinterpret_cast<const int*>(vec + kBN)[j];
      }
    }
    bar_arrive(kBarEmpty + b, kThreads);
    if (!last) continue;

    // Column 8 (jj / 2) + jj % 2 of this thread's numbering is tile column
    // 8 (jj / 2) + 2 tq + jj % 2. Per row: the diagonal's place in that
    // numbering, and the columns before B. exp(x - ref) is
    // 2^(x log2 e - ref log2 e): one FMA and one MUFU.EX2.
    const int base = t0_of(step) + 2 * tq;
    const int lim = a.B - base;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int diag = o_glob[h] - base;
      float s[8];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int i = 4 * (jj >> 1) + 2 * h + (jj & 1);
        const int off = 8 * (jj >> 1) + (jj & 1);
        float x = (acc[i] + acc[i + 16] + acc_lh[i]) * a.inv_temp - vcol[jj];
        if (vid[jj] == o_id[h] && off != diag) x = kNegInf;
        if (off == diag) pos[h] = x;  // one column of the whole row
        s[jj] = off < lim ? x : -INFINITY;  // columns past B take no part
      }
      const float tmax = fmaxf(fmaxf(fmaxf(s[0], s[1]), fmaxf(s[2], s[3])),
                               fmaxf(fmaxf(s[4], s[5]), fmaxf(s[6], s[7])));
      const float m_new = fmaxf(m[h], tmax);
      const float ref2 = exp_ref(m_new) * kLog2e;
      float e[8];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) e[jj] = ex2(fmaf(s[jj], kLog2e, -ref2));
      const float sum = ((e[0] + e[1]) + (e[2] + e[3])) + ((e[4] + e[5]) + (e[6] + e[7]));
      l[h] = fmaf(l[h], ex2(fmaf(m[h], kLog2e, -ref2)), sum);
      m[h] = m_new;
    }
  }

  // The 4 lanes of a row merge their max, exp-sum and diagonal.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mm = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 1));
    mm = fmaxf(mm, __shfl_xor_sync(0xffffffffu, mm, 2));
    float ll = l[h] * expf(m[h] - exp_ref(mm));
    ll += __shfl_xor_sync(0xffffffffu, ll, 1);
    ll += __shfl_xor_sync(0xffffffffu, ll, 2);
    float pp = pos[h] + __shfl_xor_sync(0xffffffffu, pos[h], 1);
    pp += __shfl_xor_sync(0xffffffffu, pp, 2);
    const int r = a0 + own_row + 8 * h;
    if (tq != 0 || !o_ok[h]) continue;
    if (a.part == nullptr) {
      finish(a, r, mm, ll, pp);
    } else {
      float* p = a.part + (size_t)slice * 3 * a.R + r;
      p[0] = mm;
      p[a.R] = ll;
      p[2 * a.R] = pp;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1) fused_loss_fwd_kernel(const Args a) {
  fwd_body<false>(a);
}

__global__ void __launch_bounds__(kThreads, 1) fused_loss_fwd_deep_kernel(const Args a) {
  fwd_body<true>(a);
}

// Row r's slices merged in slice order s = 0, 1, ...: max m = max_s m_s,
// exp-sum sum_s l_s exp(m_s - m), diagonal sum_s pos_s (one slice holds it).
__global__ void __launch_bounds__(256) fused_loss_fwd_merge_slices(const Args a, int slices) {
  for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < a.R; r += gridDim.x * blockDim.x) {
    const float* p = a.part + r;
    float m = -INFINITY;
    for (int s = 0; s < slices; ++s) m = fmaxf(m, p[(size_t)s * 3 * a.R]);
    const float ref = exp_ref(m);
    float l = 0.f, pos = 0.f;
    for (int s = 0; s < slices; ++s) {
      const float* ps = p + (size_t)s * 3 * a.R;
      l += ps[a.R] * expf(ps[0] - ref);
      pos += ps[2 * a.R];
    }
    finish(a, r, m, l, pos);
  }
}

// Opt both kernels in to the shared memory they take, and read the SM count,
// once a device.
cudaError_t prepare(int dev, int& sms) {
  static int sm_count[64] = {};
  if (dev < 64 && sm_count[dev] > 0) {
    sms = sm_count[dev];
    return cudaSuccess;
  }
  cudaError_t err = cudaFuncSetAttribute(fused_loss_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fused_loss_fwd_deep_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < 64) sm_count[dev] = sms;
  return err;
}

// Slices of the column tiles: as many as fill the SMs at one block an SM
// (the shared memory allows no more), no more than there are tiles, none
// empty.
int slices_for(int rows, int batch, int sms) {
  const int blocks = (rows + kBM - 1) / kBM;
  const int n_tiles = (batch + kBN - 1) / kBN;
  const int slices = max(1, min(sms / blocks, n_tiles));
  const int per_slice = (n_tiles + slices - 1) / slices;
  return (n_tiles + per_slice - 1) / per_slice;
}

}  // namespace

// Plain C interface (loaded with ctypes). The launches run on the given
// stream, do not synchronise, and return cudaGetLastError().
extern "C" {

// Floats of float32 scratch that the forward of `rows` rows against
// `batch` columns needs on the current device: its column tiles are cut
// into slices whose per-row statistics go there (0: one slice, no
// scratch). The kernel's entry point decides the slices again by the same
// rule. Returns minus the CUDA error on failure.
long long tt_fused_loss_fwd_scratch(int rows, int batch, int dim) {
  (void)dim;  // the slices depend on the rows and columns alone
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = prepare(dev, sms);
  if (err != cudaSuccess) return -(long long)err;
  const int slices = slices_for(rows, batch, sms);
  return slices > 1 ? 3LL * slices * rows : 0;
}

int tt_fused_loss_fwd(const float* u, const float* v, const int* ids, const float* cols,
                      int rows, int batch, int dim, int row_offset, float inv_temp,
                      float* loss, float* lse, float* correct, float* pos, float* scratch,
                      void* stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = prepare(dev, sms);
  if (err != cudaSuccess) return (int)err;
  const int slices = slices_for(rows, batch, sms);
  if (slices > 1 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  Args a{};
  a.u = u;
  a.v = v;
  a.ids = ids;
  a.cols = cols;
  a.R = rows;
  a.B = batch;
  a.D = dim;
  a.row_offset = row_offset;
  a.inv_temp = inv_temp;
  a.loss = loss;
  a.lse = lse;
  a.correct = correct;
  a.pos = pos;
  a.part = slices > 1 ? scratch : nullptr;
  const int n_tiles = (batch + kBN - 1) / kBN;
  a.tiles_per_slice = (n_tiles + slices - 1) / slices;
  a.nchunks = (dim + kKD - 1) / kKD;
  a.vec16 = dim % 4 == 0 && reinterpret_cast<uintptr_t>(u) % 16 == 0 &&
            reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((unsigned)((rows + kBM - 1) / kBM), (unsigned)slices);
  if (a.nchunks > 1)
    fused_loss_fwd_deep_kernel<<<grid, kThreads, kSmemBytes, s>>>(a);
  else
    fused_loss_fwd_kernel<<<grid, kThreads, kSmemBytes, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || slices == 1) return (int)err;
  const unsigned blocks = (unsigned)min((rows + 255) / 256, 4096);
  fused_loss_fwd_merge_slices<<<blocks, 256, 0, s>>>(a, slices);
  return (int)cudaGetLastError();
}

}  // extern "C"
