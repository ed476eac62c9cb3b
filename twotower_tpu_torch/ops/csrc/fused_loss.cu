// Fused in-batch sampled-softmax loss for Hopper (sm_90a): forward, and the
// backward as two deterministic kernels (dU row-parallel, dV column-parallel).
//
// Replaces the TPU kernels of twotower_tpu/ops/pallas_kernels.py:
//   fused_loss_fwd_kernel    <- _fwd_call / _fwd_kernel
//   fused_loss_bwd_du_kernel <- _bwd_call / _bwd_kernel (the dU output)
//   fused_loss_bwd_dv_kernel <- _bwd_call / _bwd_kernel (the dV output)
//
// What they compute, for local user rows r in [0, R) at global row
// row_offset + r against all B item columns c:
//   S[r,c]  = (U[r] . V[c]) * inv_temp - cols[c]
//             cols = per-column log q, plus 1e9 for zero-weight columns
//   S[r,c]  = -1e9 where ids[c] == ids[row_offset + r] and c != row_offset + r
//   lse[r]  = logsumexp_c S[r,c];  pos[r] = S[r, row_offset + r] (0 if outside)
//   loss = lse - pos;  correct = (pos >= max_c S[r,c])
// Backward, with g[r] the upstream gradient of loss[r]:
//   P  = exp(S - lse) with the masked entries set to 0
//   dS = (P - [c == row_offset + r]) * g[r] * inv_temp
//   dU = dS . V   (R x D);   dV = dS^T . U   (B x D)
//
// The S matrix never reaches device memory: every kernel recomputes its S
// tiles from U and V in shared memory and keeps them in registers.
//
// Bound on the H100 (float32 throughout, no TF32: the reference holds the
// loss to rtol 1e-4). Forward: 2*R*B*D flops and R*B exps; at B = R = 4096,
// D = 128 that is 4.3 GFLOP against 67 TFLOP/s of float32 FMA, 0.064 ms,
// while the bytes (U, V, ids, cols in, four [R] vectors out) are ~4 MB,
// 0.0013 ms: operation-bound. Backward: the dU and dV kernels each
// recompute S (2*R*B*D) and do one more product (2*R*B*D), 8*R*B*D flops in
// all, and 2*R*B exps: operation-bound too.
//
// Design against that bound, in this first version: a 32 x 64 tile of S per
// 256-thread block, 2 x 4 outputs per thread from a K-chunked shared-memory
// tiling (padded rows: no bank conflicts), an online max/sum across column
// tiles (forward), and for the backward a second shared-memory product of
// the dS tile with the streamed operand. The TPU kernel kept all of V in
// VMEM and accumulated dV across a sequential grid; here blocks run in
// parallel in no order, so dV has its own column-parallel kernel that loops
// over row tiles, and no atomics are used: results are deterministic.
// wgmma, TMA and pipelining are left for later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBM = 32;       // rows of the block's own operand per tile
constexpr int kBN = 64;       // rows of the streamed operand per tile
constexpr int kKC = 32;       // depth chunk of the S product
constexpr int kDC = 128;      // output width per block (grid.y covers D)
constexpr int kSC = 32;       // streamed rows per chunk of the second product
constexpr int kThreads = 256; // 16 x 16: ty = tid / 16, tx = tid % 16
constexpr int kMI = kBM / 16; // owned rows per thread (2)
constexpr int kNJ = kBN / 16; // streamed rows per thread (4)
constexpr int kDJ = kDC / 16; // output columns per thread (8)
constexpr float kNegInf = -1e9f;

struct STileSmem {
  float a[kBM][kKC + 1];
  float b[kBN][kKC + 1];
};

// acc[i][j] = A[a0 + ty + 16 i] . Bm[b0 + tx + 16 j] over the full depth D,
// with rows past na / nb and depth past D read as 0. Ends synchronised, so
// the caller may reuse the shared buffers.
__device__ __forceinline__ void s_tile(const float* __restrict__ A, int a0, int na,
                                       const float* __restrict__ Bm, int b0, int nb,
                                       int D, STileSmem& sm, float acc[kMI][kNJ]) {
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
#pragma unroll
  for (int i = 0; i < kMI; ++i)
#pragma unroll
    for (int j = 0; j < kNJ; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < D; k0 += kKC) {
    for (int e = tid; e < kBM * kKC; e += kThreads) {
      const int r = e / kKC, k = e % kKC;
      const int gr = a0 + r, gk = k0 + k;
      sm.a[r][k] = (gr < na && gk < D) ? A[(size_t)gr * D + gk] : 0.f;
    }
    for (int e = tid; e < kBN * kKC; e += kThreads) {
      const int r = e / kKC, k = e % kKC;
      const int gr = b0 + r, gk = k0 + k;
      sm.b[r][k] = (gr < nb && gk < D) ? Bm[(size_t)gr * D + gk] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kKC; ++k) {
      float a[kMI], b[kNJ];
#pragma unroll
      for (int i = 0; i < kMI; ++i) a[i] = sm.a[ty + 16 * i][k];
#pragma unroll
      for (int j = 0; j < kNJ; ++j) b[j] = sm.b[tx + 16 * j][k];
#pragma unroll
      for (int i = 0; i < kMI; ++i)
#pragma unroll
        for (int j = 0; j < kNJ; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// Reductions over the 16 lanes that share one ty (xor offsets below 16 stay
// inside the half-warp).
__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ---------------------------------------------------------------------------
// Forward: one block per kBM rows, streaming kBN-column tiles of V.
// Replaces _fwd_call / _fwd_kernel (twotower_tpu/ops/pallas_kernels.py:124).
// Bound: 2*R*B*D float32 FMA flops and R*B expf, operation-bound. Design: S
// stays in registers; the row max and sum are carried across column tiles
// (online logsumexp), so only four [R] vectors are written.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
fused_loss_fwd_kernel(const float* __restrict__ U, const float* __restrict__ V,
                      const int* __restrict__ ids, const float* __restrict__ cols,
                      int R, int B, int D, int row_offset, float inv_temp,
                      float* __restrict__ loss, float* __restrict__ lse_out,
                      float* __restrict__ correct, float* __restrict__ pos_out) {
  __shared__ STileSmem sm;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int a0 = blockIdx.x * kBM;

  int grow[kMI], myid[kMI];
  float m[kMI], l[kMI], pos[kMI];
#pragma unroll
  for (int i = 0; i < kMI; ++i) {
    const int r = a0 + ty + 16 * i;
    grow[i] = row_offset + r;
    myid[i] = (r < R) ? ids[grow[i]] : -1;
    m[i] = -INFINITY;
    l[i] = 0.f;
    pos[i] = 0.f;
  }

  float acc[kMI][kNJ];
  for (int b0 = 0; b0 < B; b0 += kBN) {
    s_tile(U, a0, R, V, b0, B, D, sm, acc);
#pragma unroll
    for (int i = 0; i < kMI; ++i) {
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        const int c = b0 + tx + 16 * j;
        float s = -INFINITY;  // columns past B take no part
        if (c < B) {
          s = acc[i][j] * inv_temp - cols[c];
          if (ids[c] == myid[i] && c != grow[i]) s = kNegInf;
          if (c == grow[i]) pos[i] += s;
        }
        acc[i][j] = s;
        tmax = fmaxf(tmax, s);
      }
      const float new_m = fmaxf(m[i], half_warp_max(tmax));
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kNJ; ++j)
        if (acc[i][j] != -INFINITY) psum += expf(acc[i][j] - new_m);
      l[i] = l[i] * expf(m[i] - new_m) + half_warp_sum(psum);
      m[i] = new_m;
    }
  }

#pragma unroll
  for (int i = 0; i < kMI; ++i) {
    const float p = half_warp_sum(pos[i]);
    const int r = a0 + ty + 16 * i;
    if (tx == 0 && r < R) {
      const float lse = m[i] + logf(l[i]);
      loss[r] = lse - p;
      lse_out[r] = lse;
      correct[r] = (p >= m[i]) ? 1.f : 0.f;
      pos_out[r] = p;
    }
  }
}

// ---------------------------------------------------------------------------
// Backward. One template, two kernels: kByColumn = false is the row-parallel
// dU kernel (owned operand U, streamed V); kByColumn = true is the
// column-parallel dV kernel (owned operand V, streamed U). Each block owns
// kBM rows of its output and kDC of its D columns (grid.y), loops over all
// tiles of the streamed operand, recomputes S, forms dS in shared memory
// and accumulates dS . streamed in registers.
// Both replace _bwd_call / _bwd_kernel (twotower_tpu/ops/pallas_kernels.py:
// 223), whose dV was a read-modify-write across a sequential grid. Bound,
// each: 4*R*B*D float32 FMA flops (S recompute + product) and R*B expf,
// operation-bound. Design: each output element has one owner block, so no
// atomics and a deterministic sum; the price is S computed twice.
// ---------------------------------------------------------------------------
template <bool kByColumn>
__device__ __forceinline__ void bwd_body(const float* __restrict__ U, const float* __restrict__ V,
                                         const int* __restrict__ ids,
                                         const float* __restrict__ cols,
                                         const float* __restrict__ lse,
                                         const float* __restrict__ g, int R, int B, int D,
                                         int row_offset, float inv_temp,
                                         float* __restrict__ out) {
  __shared__ STileSmem sm;
  __shared__ float ds_s[kBM][kBN + 1];
  __shared__ float st_s[kSC][kDC];

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int a0 = blockIdx.x * kBM;
  const int d0 = blockIdx.y * kDC;
  const float* own = kByColumn ? V : U;
  const float* str = kByColumn ? U : V;
  const int n_own = kByColumn ? B : R;
  const int n_str = kByColumn ? R : B;

  // Per owned row: its global index and item id; for dU also lse and g.
  int o_glob[kMI], o_id[kMI];
  float o_lse[kMI], o_g[kMI], o_col[kMI];
#pragma unroll
  for (int i = 0; i < kMI; ++i) {
    const int o = a0 + ty + 16 * i;
    const bool ok = o < n_own;
    o_glob[i] = kByColumn ? o : row_offset + o;
    o_id[i] = ok ? ids[o_glob[i]] : -1;
    o_lse[i] = (!kByColumn && ok) ? lse[o] : 0.f;
    o_g[i] = (!kByColumn && ok) ? g[o] : 0.f;
    o_col[i] = (kByColumn && ok) ? cols[o] : 0.f;
  }

  float out_acc[kMI][kDJ];
#pragma unroll
  for (int i = 0; i < kMI; ++i)
#pragma unroll
    for (int j = 0; j < kDJ; ++j) out_acc[i][j] = 0.f;

  float acc[kMI][kNJ];
  for (int b0 = 0; b0 < n_str; b0 += kBN) {
    s_tile(own, a0, n_own, str, b0, n_str, D, sm, acc);
#pragma unroll
    for (int i = 0; i < kMI; ++i) {
      const bool o_ok = a0 + ty + 16 * i < n_own;
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        const int t = b0 + tx + 16 * j;  // streamed index
        float ds = 0.f;
        if (o_ok && t < n_str) {
          // (row, column) of this S entry: global row index and column.
          int grow, col, row_id, col_id;
          float col_q, row_lse, row_g;
          if (kByColumn) {
            grow = row_offset + t;
            col = o_glob[i];
            row_id = ids[grow];
            col_id = o_id[i];
            col_q = o_col[i];
            row_lse = lse[t];
            row_g = g[t];
          } else {
            grow = o_glob[i];
            col = t;
            row_id = o_id[i];
            col_id = ids[t];
            col_q = cols[t];
            row_lse = o_lse[i];
            row_g = o_g[i];
          }
          const float s = acc[i][j] * inv_temp - col_q;
          const bool diag = col == grow;
          float p = expf(s - row_lse);
          if (col_id == row_id && !diag) p = 0.f;
          ds = (p - (diag ? 1.f : 0.f)) * row_g * inv_temp;
        }
        ds_s[ty + 16 * i][tx + 16 * j] = ds;
      }
    }
    // out[own, d0:d0+kDC] += ds_s . str[b0:b0+kBN, d0:d0+kDC], in chunks of
    // kSC streamed rows staged through shared memory.
    for (int c0 = 0; c0 < kBN; c0 += kSC) {
      for (int e = tid; e < kSC * kDC; e += kThreads) {
        const int r = e / kDC, d = e % kDC;
        const int gr = b0 + c0 + r, gd = d0 + d;
        st_s[r][d] = (gr < n_str && gd < D) ? str[(size_t)gr * D + gd] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int c = 0; c < kSC; ++c) {
        float a[kMI];
#pragma unroll
        for (int i = 0; i < kMI; ++i) a[i] = ds_s[ty + 16 * i][c0 + c];
#pragma unroll
        for (int j = 0; j < kDJ; ++j) {
          const float b = st_s[c][tx + 16 * j];
#pragma unroll
          for (int i = 0; i < kMI; ++i) out_acc[i][j] = fmaf(a[i], b, out_acc[i][j]);
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < kMI; ++i) {
    const int o = a0 + ty + 16 * i;
    if (o >= n_own) continue;
#pragma unroll
    for (int j = 0; j < kDJ; ++j) {
      const int d = d0 + tx + 16 * j;
      if (d < D) out[(size_t)o * D + d] = out_acc[i][j];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
fused_loss_bwd_du_kernel(const float* __restrict__ U, const float* __restrict__ V,
                         const int* __restrict__ ids, const float* __restrict__ cols,
                         const float* __restrict__ lse, const float* __restrict__ g, int R,
                         int B, int D, int row_offset, float inv_temp, float* __restrict__ du) {
  bwd_body<false>(U, V, ids, cols, lse, g, R, B, D, row_offset, inv_temp, du);
}

__global__ void __launch_bounds__(kThreads)
fused_loss_bwd_dv_kernel(const float* __restrict__ U, const float* __restrict__ V,
                         const int* __restrict__ ids, const float* __restrict__ cols,
                         const float* __restrict__ lse, const float* __restrict__ g, int R,
                         int B, int D, int row_offset, float inv_temp, float* __restrict__ dv) {
  bwd_body<true>(U, V, ids, cols, lse, g, R, B, D, row_offset, inv_temp, dv);
}

inline unsigned blocks_for(int n) { return (unsigned)((n + kBM - 1) / kBM); }
inline unsigned chunks_for(int d) { return (unsigned)((d + kDC - 1) / kDC); }

}  // namespace

// Plain C interface (loaded with ctypes). Each call launches on the given
// stream, does not synchronise, and returns cudaGetLastError().
extern "C" {

int tt_fused_loss_fwd(const float* u, const float* v, const int* ids, const float* cols,
                      int rows, int batch, int dim, int row_offset, float inv_temp,
                      float* loss, float* lse, float* correct, float* pos, void* stream) {
  fused_loss_fwd_kernel<<<blocks_for(rows), kThreads, 0, (cudaStream_t)stream>>>(
      u, v, ids, cols, rows, batch, dim, row_offset, inv_temp, loss, lse, correct, pos);
  return (int)cudaGetLastError();
}

int tt_fused_loss_bwd_du(const float* u, const float* v, const int* ids, const float* cols,
                         const float* lse, const float* g, int rows, int batch, int dim,
                         int row_offset, float inv_temp, float* du, void* stream) {
  dim3 grid(blocks_for(rows), chunks_for(dim));
  fused_loss_bwd_du_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      u, v, ids, cols, lse, g, rows, batch, dim, row_offset, inv_temp, du);
  return (int)cudaGetLastError();
}

int tt_fused_loss_bwd_dv(const float* u, const float* v, const int* ids, const float* cols,
                         const float* lse, const float* g, int rows, int batch, int dim,
                         int row_offset, float inv_temp, float* dv, void* stream) {
  dim3 grid(blocks_for(batch), chunks_for(dim));
  fused_loss_bwd_dv_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      u, v, ids, cols, lse, g, rows, batch, dim, row_offset, inv_temp, dv);
  return (int)cudaGetLastError();
}

}  // extern "C"
