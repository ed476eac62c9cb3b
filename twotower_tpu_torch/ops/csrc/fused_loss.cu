// Fused in-batch sampled-softmax loss for Hopper (sm_90a): the forward.
// The backward (dU and dV) is in fused_loss_bwd.cu.
//
// Replaces the TPU kernel of twotower_tpu/ops/pallas_kernels.py:
//   fused_loss_fwd_kernel    <- _fwd_call / _fwd_kernel
//
// What it computes, for local user rows r in [0, R) at global row
// row_offset + r against all B item columns c:
//   S[r,c]  = (U[r] . V[c]) * inv_temp - cols[c]
//             cols = per-column log q, plus 1e9 for zero-weight columns
//   S[r,c]  = -1e9 where ids[c] == ids[row_offset + r] and c != row_offset + r
//   lse[r]  = logsumexp_c S[r,c];  pos[r] = S[r, row_offset + r] (0 if outside)
//   loss = lse - pos;  correct = (pos >= max_c S[r,c])
//
// The S matrix never reaches device memory: the kernel computes its S
// tiles from U and V in shared memory and keeps them in registers.
//
// Bound on the H100: 2*R*B*D flops and R*B exps; at B = R = 4096, D = 128
// that is 4.3 GFLOP: 0.064 ms of float32 FMA at 67 TFLOP/s, or 0.026 ms at
// float32 accuracy on the tensor cores (three TF32 passes at 495 TFLOP/s),
// while the bytes (U, V, ids, cols in, four [R] vectors out) are ~4 MB,
// 0.0013 ms: operation-bound.
//
// Design, in this first version: a 32 x 64 tile of S per 256-thread block,
// 2 x 4 outputs per thread from a K-chunked shared-memory tiling (padded
// rows: no bank conflicts) in float32 FMA (no TF32), and an online max/sum
// across column tiles. Tensor cores, pipelining and a fuller grid are left
// for later work (fused_loss_bwd.cu shows the route).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBM = 32;       // rows of the block's own operand per tile
constexpr int kBN = 64;       // rows of the streamed operand per tile
constexpr int kKC = 32;       // depth chunk of the S product
constexpr int kThreads = 256; // 16 x 16: ty = tid / 16, tx = tid % 16
constexpr int kMI = kBM / 16; // owned rows per thread (2)
constexpr int kNJ = kBN / 16; // streamed rows per thread (4)
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

inline unsigned blocks_for(int n) { return (unsigned)((n + kBM - 1) / kBM); }

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

}  // extern "C"
