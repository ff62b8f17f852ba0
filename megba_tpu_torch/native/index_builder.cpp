// Host-side graph preprocessing — the native runtime's index builder.
//
// Role equivalent of the reference's HessianEntrance sparsity discovery
// (reference src/problem/base_problem.cpp:17-48), positionContainer
// construction (reference src/edge/base_edge.cpp:224-262, OpenMP there)
// and CSR skeleton build (reference
// src/linear_system/schur_LM_linear_system.cpp:20-84).  The port's
// segment plans (megba_tpu_torch/ops/segtiles.py) want (a) edges stably
// sorted by a vertex id (the camera-slot and point-slot orders of the
// CSR plans the CUDA reductions walk), and (b) block-sparsity statistics
// for planning.  All counting-sort based, O(nE + Nc + Np), no
// comparisons.

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Stable counting-sort permutation of edges by key index.
//   key      [n] int32 in [0, num_keys)
//   perm_out [n] int64: output order (perm_out[i] = original position of
//            the i-th edge in sorted order)
// Returns 0 on success.
int megba_sort_edges(const int32_t* key, int64_t n, int64_t num_keys,
                     int64_t* perm_out) {
  if (n < 0 || num_keys <= 0) return -1;
  std::vector<int64_t> counts(static_cast<size_t>(num_keys) + 1, 0);
  for (int64_t i = 0; i < n; ++i) {
    int32_t k = key[i];
    if (k < 0 || k >= num_keys) return -2;
    ++counts[static_cast<size_t>(k) + 1];
  }
  for (int64_t k = 0; k < num_keys; ++k) counts[k + 1] += counts[k];
  for (int64_t i = 0; i < n; ++i)
    perm_out[counts[static_cast<size_t>(key[i])]++] = i;
  return 0;
}

// Per-vertex edge counts (the segment sizes segment_sum will reduce) and
// block-sparsity statistics.  Outputs:
//   cam_counts [n_cam] int64, pt_counts [n_pt] int64
//   stats[0] = max camera degree, stats[1] = max point degree,
//   stats[2] = number of distinct (cam, pt) pairs (== nnz blocks of Hpl)
//              when edges are pre-sorted by camera (pairs grouped);
//              -1 if the input is not camera-sorted.
int megba_degree_stats(const int32_t* cam_idx, const int32_t* pt_idx,
                       int64_t n, int64_t n_cam, int64_t n_pt,
                       int64_t* cam_counts, int64_t* pt_counts,
                       int64_t* stats) {
  std::memset(cam_counts, 0, sizeof(int64_t) * static_cast<size_t>(n_cam));
  std::memset(pt_counts, 0, sizeof(int64_t) * static_cast<size_t>(n_pt));
  bool sorted = true;
  for (int64_t i = 0; i < n; ++i) {
    int32_t c = cam_idx[i], p = pt_idx[i];
    if (c < 0 || c >= n_cam || p < 0 || p >= n_pt) return -2;
    ++cam_counts[c];
    ++pt_counts[p];
    if (i > 0 && cam_idx[i] < cam_idx[i - 1]) sorted = false;
  }
  int64_t max_c = 0, max_p = 0;
  for (int64_t c = 0; c < n_cam; ++c)
    if (cam_counts[c] > max_c) max_c = cam_counts[c];
  for (int64_t p = 0; p < n_pt; ++p)
    if (pt_counts[p] > max_p) max_p = pt_counts[p];
  stats[0] = max_c;
  stats[1] = max_p;
  if (!sorted) {
    stats[2] = -1;
    return 0;
  }
  // Distinct (cam, pt) pairs within each camera group: sort each group's
  // point ids via a reusable seen-marker array.
  std::vector<int64_t> last_seen(static_cast<size_t>(n_pt), -1);
  int64_t nnz = 0;
  for (int64_t i = 0; i < n; ++i) {
    int32_t c = cam_idx[i], p = pt_idx[i];
    if (last_seen[p] != c) {
      last_seen[p] = c;
      ++nnz;
    }
  }
  stats[2] = nnz;
  return 0;
}

// Contiguous equal partition bounds for the edge axis over `world` shards
// (the arithmetic of the reference's MemoryPool::getItemNum,
// memory_pool.h:48-63, made explicit): bounds_out[w] = start of shard w,
// bounds_out[world] = padded total (n rounded up to a multiple of world).
int megba_partition_bounds(int64_t n, int64_t world, int64_t* bounds_out) {
  if (n < 0 || world <= 0) return -1;
  int64_t padded = ((n + world - 1) / world) * world;
  int64_t per = padded / world;
  for (int64_t w = 0; w <= world; ++w) bounds_out[w] = w * per;
  return 0;
}

}  // extern "C"
