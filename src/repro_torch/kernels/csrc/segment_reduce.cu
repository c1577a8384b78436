// Segmented row reduction for Hopper (sm_90a): GNN message aggregation.
//
//     out[v, :] = reduce_{e : seg[e] == v} data[e, :]     reduce in {sum, min, max}
//
// Replaces repro/kernels/segment_reduce/segment_reduce.py::segment_reduce_pallas.
//
// Split of the work:
//   * Layout preparation (not this file): the wrapper's `segment_layout`
//     stable-sorts seg once per index array and forward, giving `perm` (edge
//     ids grouped by segment, in edge order within each segment; ids outside
//     [0, n) sorted last and dropped) and CSR `offsets` [n + 1]. Like the
//     stable dst sort of the relax path's `make_block`, it is layout, not
//     the reduction.
//   * The reduction (this file): a group of T threads per segment (T the
//     smallest power of two >= D, at most 32, so a group never spans two
//     warps), lanes over the D columns. Each group walks its segment's edges
//     in edge order from the identity and writes the row once. No atomics:
//     +0.0 for sum (so a lone -0.0 sums to +0.0, as a scatter-add into zeros
//     does), +inf for min, -inf for max; an empty segment keeps its identity.
//     Because every (segment, column) is reduced in edge order, sums equal a
//     sequential scatter-add (jax.ops.segment_sum on the CPU, the Pallas
//     kernel in interpret mode and the plain version in ref.py) bit for bit.
//   * min/max order -0.0 below +0.0 and propagate NaN, as XLA's min/max do.
//
// What bounds it on this card: bytes. Each in-range edge's row (4 D bytes)
// and perm entry are read once and each output row is written once; one add
// or compare per element is far below the card's rates. Rows are gathered
// by perm, so each group reads T consecutive floats (128 bytes at T = 32)
// per edge. Hub splitting, cp.async/TMA staging of rows and fusing the
// gather of h[src] into the reduction are later work.
//
// Built with --fmad=false and without fast-math or ftz (kernels/_build.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

enum Reduce { SUM = 0, MIN = 1, MAX = 2 };

constexpr int kThreads = 256;

template <int R> __device__ __forceinline__ float identity() {
  if (R == SUM) return 0.0f;
  if (R == MIN) return INFINITY;
  return -INFINITY;
}

template <int R> __device__ __forceinline__ float combine(float acc, float x) {
  if (R == SUM) return __fadd_rn(acc, x);
  const bool neg = (__float_as_uint(x) >> 31) != 0;
  const bool nan = x != x;
  if (R == MIN) return (nan || x < acc || (x == acc && neg)) ? x : acc;
  return (nan || x > acc || (x == acc && !neg)) ? x : acc;
}

template <int R, int T>
__global__ void __launch_bounds__(kThreads)
segment_reduce_kernel(int n, int d, const float* __restrict__ data, const int* __restrict__ perm,
                      const int* __restrict__ offsets, float* __restrict__ out) {
  constexpr int kGroups = kThreads / T;
  const long long seg = static_cast<long long>(blockIdx.x) * kGroups + threadIdx.x / T;
  if (seg >= n) return;
  const int lane = threadIdx.x % T;
  const int begin = offsets[seg];
  const int end = offsets[seg + 1];
  float* row = out + seg * d;
  for (int c = lane; c < d; c += T) {
    float acc = identity<R>();
#pragma unroll 4
    for (int j = begin; j < end; ++j) {
      const long long e = perm[j];
      acc = combine<R>(acc, data[e * d + c]);
    }
    row[c] = acc;
  }
}

template <int R, int T>
void launch(int n, int d, const float* data, const int* perm, const int* offsets, float* out,
            cudaStream_t st) {
  constexpr int kGroups = kThreads / T;
  const int blocks = static_cast<int>((static_cast<long long>(n) + kGroups - 1) / kGroups);
  segment_reduce_kernel<R, T><<<blocks, kThreads, 0, st>>>(n, d, data, perm, offsets, out);
}

template <int R>
void launch_for_width(int n, int d, const float* data, const int* perm, const int* offsets,
                      float* out, cudaStream_t st) {
  if (d <= 1) launch<R, 1>(n, d, data, perm, offsets, out, st);
  else if (d <= 2) launch<R, 2>(n, d, data, perm, offsets, out, st);
  else if (d <= 4) launch<R, 4>(n, d, data, perm, offsets, out, st);
  else if (d <= 8) launch<R, 8>(n, d, data, perm, offsets, out, st);
  else if (d <= 16) launch<R, 16>(n, d, data, perm, offsets, out, st);
  else launch<R, 32>(n, d, data, perm, offsets, out, st);
}

}  // namespace

extern "C" {

// out [n, d] (row-major) = reduce over the edges of each segment of data [E, d]
// (row-major): segment s's edges are perm[offsets[s] .. offsets[s + 1]), in the
// order they are reduced. reduce: 0 sum, 1 min, 2 max. Returns cudaGetLastError().
int segment_reduce_run(int reduce, int n, int d, const float* data, const int* perm,
                       const int* offsets, float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || d <= 0) return static_cast<int>(cudaGetLastError());
  switch (reduce) {
    case SUM: launch_for_width<SUM>(n, d, data, perm, offsets, out, st); break;
    case MIN: launch_for_width<MIN>(n, d, data, perm, offsets, out, st); break;
    case MAX: launch_for_width<MAX>(n, d, data, perm, offsets, out, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
