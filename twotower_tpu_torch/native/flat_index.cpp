// Native flat MIPS index: exact top-k inner-product search on the CPU (the
// PyTorch port's own copy of the JAX package's native/flat_index.cpp: the
// same search, and of its C ABI the two functions serving/cpu_index.py binds).
//
// For hosts without a GPU: exact (brute force), like the device's
// tpu_mips_exact search, so its results agree with the evaluation's.
//
// Design: queries parallelized over OpenMP threads; per query the corpus is
// streamed row by row with a bounded min-heap holding the running top-k.
// Inner loops are written so the compiler auto-vectorizes (contiguous
// fmadd reductions; -O3 -march=native -ffast-math).
//
// C ABI (ctypes, see serving/cpu_index.py):
//   flat_topk(corpus[n*d], n, d, queries[b*d], b, k,
//             out_scores[b*k], out_idx[b*k])
//   flat_index_num_threads()

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <utility>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

struct HeapEntry {
  float score;
  int32_t idx;
};

inline bool heap_less(const HeapEntry& a, const HeapEntry& b) {
  // Min-heap on score: heap[0] is the current k-th best.
  return a.score > b.score;
}

inline float dot(const float* __restrict a, const float* __restrict b, int d) {
  float acc = 0.0f;
  for (int j = 0; j < d; ++j) acc += a[j] * b[j];
  return acc;
}

}  // namespace

extern "C" {

// Exact top-k over the full corpus for a batch of queries.
// ABI precondition: 1 <= k <= n. out_scores/out_idx are caller-allocated
// with row stride k, so clamping k here would silently change the write
// stride under the caller; the Python binding (serving/cpu_index.py)
// validates the range before calling.
void flat_topk(const float* corpus, int32_t n, int32_t d, const float* queries,
               int32_t b, int32_t k, float* out_scores, int32_t* out_idx) {
#pragma omp parallel for schedule(dynamic, 1)
  for (int32_t q = 0; q < b; ++q) {
    const float* query = queries + static_cast<int64_t>(q) * d;
    std::vector<HeapEntry> heap;
    heap.reserve(k);
    // Seed the heap with the first k items.
    for (int32_t i = 0; i < k; ++i) {
      heap.push_back({dot(query, corpus + static_cast<int64_t>(i) * d, d), i});
    }
    std::make_heap(heap.begin(), heap.end(), heap_less);
    float threshold = heap.front().score;
    for (int32_t i = k; i < n; ++i) {
      float s = dot(query, corpus + static_cast<int64_t>(i) * d, d);
      if (s > threshold) {
        std::pop_heap(heap.begin(), heap.end(), heap_less);
        heap.back() = {s, i};
        std::push_heap(heap.begin(), heap.end(), heap_less);
        threshold = heap.front().score;
      }
    }
    // sort_heap with a ">" comparator yields descending score order.
    std::sort_heap(heap.begin(), heap.end(), heap_less);
    for (int32_t j = 0; j < k; ++j) {
      out_scores[static_cast<int64_t>(q) * k + j] = heap[j].score;
      out_idx[static_cast<int64_t>(q) * k + j] = heap[j].idx;
    }
  }
}

int32_t flat_index_num_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
