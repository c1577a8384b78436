// Weighted bag sum of table rows for Hopper (sm_90a): the recsys EmbeddingBag.
//
//     out[b, :] = sum_{i : bags[i] == b} weights[i] * table[ids[i], :]
//
// Replaces repro/kernels/embedding_bag/embedding_bag.py::embedding_bag_pallas.
//
// Split of the work:
//   * Layout preparation (not this file): the wrapper's `segment_layout`
//     (kernels/segment_reduce/ref.py) stable-sorts the bag ids once per index
//     array, giving `perm` (lookups grouped by bag, in lookup order within each
//     bag; bags outside [0, n_bags) sorted last and dropped) and CSR `offsets`
//     [n_bags + 1]. It is the same layout segment_reduce.cu reads.
//   * The bag sums (this file): a group of T threads per bag (T the smallest
//     power of two >= D, at most 32, so a group never spans two warps), lanes
//     over the D columns. Each group walks its
//     bag's lookups in lookup order and, per column, adds the rounded product:
//     acc = acc + (w * row) from +0.0, then writes the row once. No atomics, no
//     fused multiply-add: the product is rounded before the add, as the
//     reference's take -> multiply -> segment_sum rounds it, so the result equals
//     repro.models.embedding.embedding_bag(mode="sum") on the CPU, the Pallas
//     kernel in interpret mode and the plain version in ref.py bit for bit. An
//     empty bag is +0.0; a dropped bag's lookups are never read.
//
// The TPU kernel kept a vocabulary shard resident in VMEM and fell back to XLA
// above an 8 MB budget. Nothing here is resident: every table, the 2^23-row item
// table included, is gathered from device memory row by row.
//
// What bounds it on this card: bytes. Each in-range lookup's id, weight and perm
// entry (12 bytes) and its 4 D-byte row are read once, and each output row is
// written once; one multiply and one add per element are far below the card's
// rates. Rows are 72 bytes at D = 18, not 16-byte aligned, so loads are 4-byte
// scalars (no float4); a random 72-byte row touches 3 32-byte sectors. Row
// offsets are computed in 64 bits. Splitting long bags, staging ids ahead of the
// row loads and packing several bags into a warp at small D are later work.
//
// Built with --fmad=false and without fast-math or ftz (kernels/_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <int T>
__global__ void __launch_bounds__(kThreads)
embedding_bag_kernel(int n_bags, int d, const float* __restrict__ table,
                     const int* __restrict__ ids, const float* __restrict__ weights,
                     const int* __restrict__ perm, const int* __restrict__ offsets,
                     float* __restrict__ out) {
  constexpr int kGroups = kThreads / T;
  const long long bag = static_cast<long long>(blockIdx.x) * kGroups + threadIdx.x / T;
  if (bag >= n_bags) return;
  const int lane = threadIdx.x % T;
  const int begin = offsets[bag];
  const int end = offsets[bag + 1];
  float* row = out + bag * d;
  for (int c = lane; c < d; c += T) {
    float acc = 0.0f;
#pragma unroll 4
    for (int j = begin; j < end; ++j) {
      const int i = perm[j];
      const long long id = ids[i];
      acc = __fadd_rn(acc, __fmul_rn(weights[i], table[id * d + c]));
    }
    row[c] = acc;
  }
}

template <int T>
void launch(int n_bags, int d, const float* table, const int* ids, const float* weights,
            const int* perm, const int* offsets, float* out, cudaStream_t st) {
  constexpr int kGroups = kThreads / T;
  const int blocks = static_cast<int>((static_cast<long long>(n_bags) + kGroups - 1) / kGroups);
  embedding_bag_kernel<T><<<blocks, kThreads, 0, st>>>(n_bags, d, table, ids, weights, perm,
                                                       offsets, out);
}

}  // namespace

extern "C" {

// out [n_bags, d] (row-major) = the weighted sum of the table rows [V, d]
// (row-major) looked up by each bag: bag b's lookups are
// perm[offsets[b] .. offsets[b + 1]), summed in that order; lookup i reads row
// ids[i] scaled by weights[i]. Returns cudaGetLastError().
int embedding_bag_run(int n_bags, int d, const float* table, const int* ids,
                      const float* weights, const int* perm, const int* offsets, float* out,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_bags <= 0 || d <= 0) return static_cast<int>(cudaGetLastError());
  if (d <= 1) launch<1>(n_bags, d, table, ids, weights, perm, offsets, out, st);
  else if (d <= 2) launch<2>(n_bags, d, table, ids, weights, perm, offsets, out, st);
  else if (d <= 4) launch<4>(n_bags, d, table, ids, weights, perm, offsets, out, st);
  else if (d <= 8) launch<8>(n_bags, d, table, ids, weights, perm, offsets, out, st);
  else if (d <= 16) launch<16>(n_bags, d, table, ids, weights, perm, offsets, out, st);
  else launch<32>(n_bags, d, table, ids, weights, perm, offsets, out, st);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
