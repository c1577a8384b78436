// Frontier-masked semiring edge relaxation for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of the relax path:
//   * repro/kernels/edge_relax/edge_relax.py::edge_relax_pallas
//     (one unmasked sweep: edge_relax_run below), and
//   * repro/kernels/edge_relax_multi/edge_relax_multi.py::relax_multi_pallas
//     (up to k frontier-masked sweeps with parent tracking and an early
//     exit: relax_multi_run below), with a lane axis added so a batch of
//     snapshots runs as one launch sequence.
//
// What bounds it on this card: bytes. Each sweep reads every edge once
// (src, dst, w: 12 bytes), gathers frontier[src] and values[src] at random
// and does one atomicMin per active edge on a per-vertex word; the
// arithmetic is one add, min, max or multiply per edge. State does not fit
// on chip: at N = 2^22 one lane's values, parent, frontier and packed
// best/winner words come to about 70 MB, more than the 50 MB L2 and far
// more than a block's shared memory, so it lives in device memory.
//
// Design:
//   * Scatter phase, one launch per edge block, grid (edge tiles, lanes).
//     A block shared by every lane has lane stride 0; a stacked per-lane
//     Delta block has stride E. Padding edges (dst == N) and inactive edges
//     are skipped. The candidate is mapped to an order-preserving u32 key
//     (inverted for max semirings, so atomicMin always picks the best);
//     with parents tracked one 64-bit atomicMin on (key << 32 | src) gives
//     the best value and the smallest winning src in one step. A plain read
//     of the current word first skips atomics that cannot win.
//   * Finish phase, once per sweep, grid (vertex tiles, lanes): decode the
//     best, apply the meet, set parent and frontier = improved, reset the
//     best word, and raise the lane's run flag for the next round if any
//     vertex improved. Block (0, lane) adds the round's per-block active
//     edge counts to the lane's f32 work in block order (the reference's
//     f32 grouping) and counts the sweep.
//   * The k rounds of a chunk are issued back to back with no host sync.
//     Round r of a lane runs only if flags[r][lane] != 0 and r < allowed;
//     rounds of a stopped lane return at once (the TPU's SMEM run flag).
//
// Weights lie in (0, 1], so no -0.0 or NaN reaches a key. The Viterbi
// product flushes results below FLT_MIN to zero, as the JAX reference does
// on the CPU; this file must not be built with --use_fast_math or -ftz.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

enum Op { MIN_PLUS = 0, MIN_PLUS_UNIT = 1, MAX_MIN = 2, MIN_MAX = 3, MAX_TIMES = 4 };

constexpr int kThreads = 256;
constexpr unsigned kNoWinner = 0x7fffffffu;

template <int OP> __device__ __forceinline__ bool is_min() {
  return OP == MIN_PLUS || OP == MIN_PLUS_UNIT || OP == MIN_MAX;
}

template <int OP> __device__ __forceinline__ float identity() {
  if (OP == MAX_MIN) return -INFINITY;
  if (OP == MAX_TIMES) return 0.0f;
  return INFINITY;
}

template <int OP> __device__ __forceinline__ float combine(float v, float w) {
  if (OP == MIN_PLUS) return __fadd_rn(v, w);
  if (OP == MIN_PLUS_UNIT) return __fadd_rn(v, 1.0f);
  if (OP == MAX_MIN) return fminf(v, w);
  if (OP == MIN_MAX) return fmaxf(v, w);
  const float r = __fmul_rn(v, w);
  return fabsf(r) < FLT_MIN ? copysignf(0.0f, r) : r;
}

// Order-preserving key: a smaller key is a better value.
template <int OP> __device__ __forceinline__ uint32_t to_key(float f) {
  const uint32_t b = __float_as_uint(f);
  const uint32_t k = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return is_min<OP>() ? k : ~k;
}

template <int OP> __device__ __forceinline__ float from_key(uint32_t k) {
  if (!is_min<OP>()) k = ~k;
  const uint32_t b = (k & 0x80000000u) ? (k & 0x7fffffffu) : ~k;
  return __uint_as_float(b);
}

template <int OP> __device__ __forceinline__ unsigned long long ident_packed() {
  return (static_cast<unsigned long long>(to_key<OP>(identity<OP>())) << 32) | kNoWinner;
}

// best[lane, v] = identity; flag0[lane] = any(frontier[lane, :]).
template <int OP, bool TRACK>
__global__ void __launch_bounds__(kThreads)
init_kernel(int n, const uint8_t* __restrict__ frontier, void* best, int* flag0) {
  const long long base = static_cast<long long>(blockIdx.y) * n;
  bool any = false;
  for (int v = blockIdx.x * blockDim.x + threadIdx.x; v < n; v += gridDim.x * blockDim.x) {
    if (TRACK) {
      static_cast<unsigned long long*>(best)[base + v] = ident_packed<OP>();
    } else {
      static_cast<uint32_t*>(best)[base + v] = to_key<OP>(identity<OP>());
    }
    if (frontier != nullptr) any |= frontier[base + v] != 0;
  }
  if (__syncthreads_or(any) && threadIdx.x == 0 && flag0 != nullptr) flag0[blockIdx.y] = 1;
}

template <int OP, bool TRACK>
__global__ void __launch_bounds__(kThreads)
scatter_kernel(int n, const float* __restrict__ values, const uint8_t* __restrict__ frontier,
               const int* __restrict__ src, const int* __restrict__ dst,
               const float* __restrict__ w, long long e_len, long long lane_stride,
               const int* __restrict__ run_flag, const int* __restrict__ allowed, int round,
               void* best, unsigned* counts, int count_stride, int count_index) {
  const int lane = blockIdx.y;
  if (run_flag != nullptr && (run_flag[lane] == 0 || round >= allowed[lane])) return;
  const long long vbase = static_cast<long long>(lane) * n;
  const long long ebase = static_cast<long long>(lane) * lane_stride;
  unsigned cnt = 0;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; e < e_len;
       e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int d = dst[ebase + e];
    if (d >= n) continue;  // padding edge: the sentinel segment
    const int u = src[ebase + e];
    if (frontier != nullptr && frontier[vbase + u] == 0) continue;
    ++cnt;
    const uint32_t key = to_key<OP>(combine<OP>(values[vbase + u], w[ebase + e]));
    if (TRACK) {
      unsigned long long* slot = static_cast<unsigned long long*>(best) + vbase + d;
      const unsigned long long packed = (static_cast<unsigned long long>(key) << 32) | static_cast<unsigned>(u);
      if (packed < *reinterpret_cast<volatile unsigned long long*>(slot)) atomicMin(slot, packed);
    } else {
      uint32_t* slot = static_cast<uint32_t*>(best) + vbase + d;
      if (key < *reinterpret_cast<volatile uint32_t*>(slot)) atomicMin(slot, key);
    }
  }
  if (counts != nullptr) {
    cnt = __reduce_add_sync(0xffffffffu, cnt);
    if ((threadIdx.x & 31) == 0 && cnt != 0)
      atomicAdd(counts + static_cast<long long>(lane) * count_stride + count_index, cnt);
  }
}

template <int OP, bool TRACK>
__global__ void __launch_bounds__(kThreads)
finish_kernel(int n, float* values, int* parent, uint8_t* frontier, void* best,
              const int* __restrict__ run_flag, int* next_flag, const int* __restrict__ allowed,
              int round, int* sweeps, float* work, unsigned* counts, int nblocks) {
  const int lane = blockIdx.y;
  if (run_flag[lane] == 0 || round >= allowed[lane]) return;
  const long long base = static_cast<long long>(lane) * n;
  bool any = false;
  for (int v = blockIdx.x * blockDim.x + threadIdx.x; v < n; v += gridDim.x * blockDim.x) {
    const long long i = base + v;
    uint32_t key;
    int winner = 0;
    if (TRACK) {
      unsigned long long* slot = static_cast<unsigned long long*>(best) + i;
      const unsigned long long p = *slot;
      key = static_cast<uint32_t>(p >> 32);
      winner = static_cast<int>(p & 0xffffffffull);
      *slot = ident_packed<OP>();
    } else {
      uint32_t* slot = static_cast<uint32_t*>(best) + i;
      key = *slot;
      *slot = to_key<OP>(identity<OP>());
    }
    const float b = from_key<OP>(key);
    const float old = values[i];
    const bool improved = is_min<OP>() ? (b < old) : (b > old);
    if (improved) {
      values[i] = b;
      if (TRACK) parent[i] = winner;
    }
    frontier[i] = improved ? 1 : 0;
    any |= improved;
  }
  if (__syncthreads_or(any) && threadIdx.x == 0) next_flag[lane] = 1;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    sweeps[lane] += 1;
    float sweep_work = 0.0f;
    unsigned* c = counts + static_cast<long long>(lane) * nblocks;
    for (int b = 0; b < nblocks; ++b) {
      sweep_work = __fadd_rn(sweep_work, __uint2float_rn(c[b]));
      c[b] = 0;
    }
    work[lane] = __fadd_rn(work[lane], sweep_work);
  }
}

template <int OP>
__global__ void __launch_bounds__(kThreads)
decode_kernel(int n, const uint32_t* __restrict__ best, float* out) {
  for (int v = blockIdx.x * blockDim.x + threadIdx.x; v < n; v += gridDim.x * blockDim.x)
    out[v] = from_key<OP>(best[v]);
}

inline int tiles(long long count, int cap) {
  long long t = (count + kThreads - 1) / kThreads;
  if (t < 1) t = 1;
  return static_cast<int>(t < cap ? t : cap);
}

constexpr int kVertexTiles = 1024;
constexpr int kEdgeTiles = 2048;

template <int OP, bool TRACK>
void launch_multi(int lanes, int n, int k, float* values, int* parent, uint8_t* frontier,
                  int nblocks, void* const* srcs, void* const* dsts, void* const* ws,
                  const long long* lens, const long long* strides, const int* allowed,
                  int* flags, int* sweeps, float* work, void* best, unsigned* counts,
                  cudaStream_t st) {
  const dim3 vgrid(tiles(n, kVertexTiles), lanes);
  init_kernel<OP, TRACK><<<vgrid, kThreads, 0, st>>>(n, frontier, best, flags);
  for (int r = 0; r < k; ++r) {
    const int* flag = flags + static_cast<long long>(r) * lanes;
    int* next = flags + static_cast<long long>(r + 1) * lanes;
    for (int b = 0; b < nblocks; ++b) {
      const dim3 egrid(tiles(lens[b], kEdgeTiles), lanes);
      scatter_kernel<OP, TRACK><<<egrid, kThreads, 0, st>>>(
          n, values, frontier, static_cast<const int*>(srcs[b]), static_cast<const int*>(dsts[b]),
          static_cast<const float*>(ws[b]), lens[b], strides[b], flag, allowed, r, best, counts,
          nblocks, b);
    }
    finish_kernel<OP, TRACK><<<vgrid, kThreads, 0, st>>>(n, values, parent, frontier, best, flag,
                                                          next, allowed, r, sweeps, work, counts,
                                                          nblocks);
  }
}

template <int OP>
void launch_single(int n, const float* values, const int* src, const int* dst, const float* w,
                   long long e_len, uint32_t* best, float* out, cudaStream_t st) {
  const int vt = tiles(n, kVertexTiles);
  init_kernel<OP, false><<<dim3(vt, 1), kThreads, 0, st>>>(n, nullptr, best, nullptr);
  scatter_kernel<OP, false><<<dim3(tiles(e_len, kEdgeTiles), 1), kThreads, 0, st>>>(
      n, values, nullptr, src, dst, w, e_len, 0, nullptr, nullptr, 0, best, nullptr, 0, 0);
  decode_kernel<OP><<<vt, kThreads, 0, st>>>(n, best, out);
}

}  // namespace

extern "C" {

// Up to k frontier-masked sweeps over `lanes` states of n vertices each,
// updating values/parent/frontier ([lanes, n], row-major) in place.
// Block b has lens[b] edges per lane and lane stride strides[b] (0 = shared).
// flags: (k + 1) * lanes ints, counts: lanes * nblocks, sweeps: lanes,
// work: lanes floats, all zeroed by the caller; best: lanes * n words of
// 8 bytes (track) or 4 bytes. Returns cudaGetLastError().
int relax_multi_run(int op, int track, int lanes, int n, int k, float* values, int* parent,
                    uint8_t* frontier, int nblocks, void* const* srcs, void* const* dsts,
                    void* const* ws, const long long* lens, const long long* strides,
                    const int* allowed, int* flags, int* sweeps, float* work, void* best,
                    unsigned* counts, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RELAX_MULTI_CASE(OPV)                                                                  \
  case OPV:                                                                                    \
    if (track)                                                                                 \
      launch_multi<OPV, true>(lanes, n, k, values, parent, frontier, nblocks, srcs, dsts, ws,  \
                              lens, strides, allowed, flags, sweeps, work, best, counts, st);  \
    else                                                                                       \
      launch_multi<OPV, false>(lanes, n, k, values, parent, frontier, nblocks, srcs, dsts, ws, \
                               lens, strides, allowed, flags, sweeps, work, best, counts, st); \
    break;
  switch (op) {
    RELAX_MULTI_CASE(MIN_PLUS)
    RELAX_MULTI_CASE(MIN_PLUS_UNIT)
    RELAX_MULTI_CASE(MAX_MIN)
    RELAX_MULTI_CASE(MIN_MAX)
    RELAX_MULTI_CASE(MAX_TIMES)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RELAX_MULTI_CASE
  return static_cast<int>(cudaGetLastError());
}

// One unmasked sweep: out[v] = reduce over dst[e] == v of combine(values[src[e]], w[e]),
// the identity where no edge lands. best: n words of scratch. Returns cudaGetLastError().
int edge_relax_run(int op, int n, const float* values, const int* src, const int* dst,
                   const float* w, long long e_len, uint32_t* best, float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (op) {
    case MIN_PLUS: launch_single<MIN_PLUS>(n, values, src, dst, w, e_len, best, out, st); break;
    case MIN_PLUS_UNIT: launch_single<MIN_PLUS_UNIT>(n, values, src, dst, w, e_len, best, out, st); break;
    case MAX_MIN: launch_single<MAX_MIN>(n, values, src, dst, w, e_len, best, out, st); break;
    case MIN_MAX: launch_single<MIN_MAX>(n, values, src, dst, w, e_len, best, out, st); break;
    case MAX_TIMES: launch_single<MAX_TIMES>(n, values, src, dst, w, e_len, best, out, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Shared by every source of the library (kernels/_build.py binds it once).
const char* kernels_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
