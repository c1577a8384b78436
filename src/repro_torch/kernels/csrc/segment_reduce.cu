// Segmented row reduction for Hopper (sm_90a): GNN message aggregation.
//
//     out[v, :] = reduce_{e : seg[e] == v} data[e, :]     reduce in {sum, min, max}
//
// Replaces repro/kernels/segment_reduce/segment_reduce.py::segment_reduce_pallas.
//
// The contract: every (segment, column) is reduced by one thread, in edge
// order, from the identity (+0.0 for sum, so a lone -0.0 sums to +0.0; +inf for
// min; -inf for max); an empty segment keeps its identity. Sums use __fadd_rn
// and the library is built with --fmad=false, without fast-math or ftz. min/max
// order -0.0 below +0.0 and propagate NaN, keeping the last NaN met, as XLA's
// min/max in a sequential scatter do. No atomics. So sums equal a sequential
// scatter-add (jax.ops.segment_sum on the CPU, the Pallas kernel in interpret
// mode and the plain version in ref.py) bit for bit. Partial sums added in
// parallel would round differently; what this kernel spreads over threads is
// the loads, the columns and the segments, never the adds of one sum.
//
// Layout (not this file): the wrapper's `segment_layout` stable-sorts the ids
// once per index array, giving `perm` (edge ids grouped by segment, in edge
// order within each segment; ids outside [0, n) sort last and are never read)
// and CSR `offsets` [n + 1].
//
// What bounds it on this card: bytes, and the way they are read. Each in-range
// edge's row (4 D bytes) and perm entry are read once and each output row is
// written once; one add or compare per element is far below the card's rates.
// But rows are gathered by perm, at random: on an H100 each costs at least one
// 64-byte access, and random accesses reach about 2 TB/s, not 3.35. So at D = 1
// a call takes about what PyTorch's own gather of the same rows by perm takes,
// and a hub's in-order chain of dependent adds (about 4 cycles each) sets the
// time of a call that holds one.
//
// The design, two kernels on the caller's stream:
//   1. Tiles (`segment_reduce_tiles`, `tile_start_kernel`). Segment s sits at
//      f(s) = offsets[s] + s on the merged stream of edges and segments. Tile
//      b holds the segments whose f falls in [b K, (b + 1) K), K = `cap`
//      (below); one thread per segment writes the tile's first segment and
//      first edge. A tile's segments before its last hold fewer than K edges,
//      so they fit one chunk of shared memory; its last segment may be a hub
//      of any length, and a run of empty segments is spread over tiles as
//      edges are. The starts depend only on the layout and the width, so the
//      wrapper keeps them in the layout: a layout's later calls at that width
//      are one launch.
//   2. Reduction (`segment_reduce_run`, `segment_reduce_kernel`), one
//      256-thread block per tile, launched as a programmatic dependent launch
//      so that after the tile kernel its blocks are set up while the tiles
//      are computed. It walks the tile's edges in chunks of K:
//      the tile's offsets and the chunk's perm entries are copied into shared
//      memory with cp.async, then every thread issues cp.async gathers of rows
//      (16-, 8- or 4-byte pieces, as D and the alignment allow) together with
//      the next chunk's perm entries, so thousands of loads are in flight and
//      no thread waits on a perm -> row chain. Then each thread takes
//      (segment, columns) pairs, walks that segment's rows in shared memory in
//      edge order and writes the outputs; consecutive threads write
//      consecutive outputs, so a run of empty segments is a flat, vectorised
//      fill of the identity. Every row and perm entry is read from device
//      memory once, whatever D. The first chunk holds all of the tile's
//      segments, later chunks only the hub, whose accumulators carry from
//      chunk to chunk through shared memory.
//   K fills kSmemBudget = 64 KB of shared memory with rows, two chunks of
//   perm entries, the tile's offsets and the hub's carry: three blocks to an
//   SM. On an H100 budgets of 24, 40, 80 and 96 KB ran the large cases of
//   chip_smoke.py's phase 5 slower. A small input gets a smaller K, so that
//   it still spreads over about 528 blocks (`tile_cap`). Widths whose chunk
//   of two rows does not fit in a block's shared memory (above
//   segment_reduce_max_width()) are refused.
//
// Built with --fmad=false and without fast-math or ftz (kernels/_build.py).

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

enum Reduce { SUM = 0, MIN = 1, MAX = 2 };

constexpr int kThreads = 256;
constexpr int kSmemBudget = 65536;
constexpr int kSmemMax = 232448;  // what one block may use on Hopper

template <int R> __device__ __forceinline__ float identity() {
  if (R == SUM) return 0.0f;
  if (R == MIN) return INFINITY;
  return -INFINITY;
}

// The running reduction of one (segment, column), in edge order.
//   sum: acc = __fadd_rn(acc, x) from +0.0.
//   min/max: the result takes x when x is NaN (the last NaN met is kept), or
//   when the result so far is not NaN and x orders before (min) or after (max)
//   it, -0.0 below +0.0. Floats are mapped to integer keys whose signed order
//   is that order (an involution on the bits), with every NaN mapped to the
//   key that wins (INT_MIN for min, INT_MAX for max; no other float has it),
//   so each step is one integer min/max; the last NaN's bits ride beside it.
template <int R> struct Acc {
  float sum;
  int key;
  float nan;

  static __device__ __forceinline__ int order_key(int bits) {
    return bits ^ ((bits >> 31) & 0x7fffffff);
  }
  static constexpr int kNanKey = R == MIN ? INT_MIN : INT_MAX;

  __device__ __forceinline__ void init(float v) {
    if (R == SUM) {
      sum = v;
    } else {
      const int b = __float_as_int(v);
      key = (b & 0x7fffffff) > 0x7f800000 ? kNanKey : order_key(b);
      nan = v;
    }
  }
  __device__ __forceinline__ void add(float x) {
    if (R == SUM) {
      sum = __fadd_rn(sum, x);
    } else {
      const int b = __float_as_int(x);
      const bool is_nan = (b & 0x7fffffff) > 0x7f800000;
      const int k = is_nan ? kNanKey : order_key(b);
      key = R == MIN ? min(key, k) : max(key, k);
      nan = is_nan ? x : nan;
    }
  }
  __device__ __forceinline__ float value() const {
    if (R == SUM) return sum;
    return key == kNanKey ? nan : __int_as_float(order_key(key));
  }
};

// V consecutive floats, moved as one 4-, 8- or 16-byte access.
template <int V> struct Vec {
  float x[V];
};

template <int V> __device__ __forceinline__ Vec<V> load_vec(const float* p) {
  Vec<V> v;
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v.x[0] = t.x; v.x[1] = t.y; v.x[2] = t.z; v.x[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v.x[0] = t.x; v.x[1] = t.y;
  } else {
    v.x[0] = *p;
  }
  return v;
}

template <int V> __device__ __forceinline__ void store_vec(float* p, const Vec<V>& v) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v.x[0], v.x[1], v.x[2], v.x[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v.x[0], v.x[1]);
  } else {
    *p = v.x[0];
  }
}

// Asynchronous copy of B (4, 8 or 16) bytes from device to shared memory.
template <int B> __device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (B == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src), "n"(B)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Edges (and segments) per chunk for width d: the chunk that fills the
// budget with its rows, two chunks of perm entries, the tile's offsets and
// the carry.
int chunk_cap(int d) {
  const long long cap = (kSmemBudget / 4 - 1 - static_cast<long long>(d)) / (d + 3);
  return cap < 2 ? 2 : static_cast<int>(cap);
}

// Edges (and segments) per tile, K: a full chunk, or less where the input is
// small, so that it still makes about kMinTiles tiles (four blocks on each of
// an H100's 132 SMs) and a few blocks do not walk long tiles while the other
// SMs idle; at least kMinCap.
constexpr long long kMinTiles = 4 * 132;
constexpr long long kMinCap = 32;
int tile_cap(int n, int e, int d) {
  const long long even = (static_cast<long long>(n) + e + kMinTiles - 1) / kMinTiles;
  const long long cap = even < kMinCap ? kMinCap : even;
  const int full = chunk_cap(d);
  return cap < full ? static_cast<int>(cap) : full;
}

size_t smem_bytes(int d, int cap) {
  return 4 * (static_cast<size_t>(cap) * (d + 3) + 1 + d);
}

long long tile_count(int n, int e, int cap) {
  return (static_cast<long long>(e) + n) / cap + 1;
}

// start[b] = the first segment s with offsets[s] + s >= b * cap, for b in
// [0, tiles] (n past the last segment), and start[tiles + 1 + b] =
// offsets[start[b]], the tile's first edge. One thread per s in [0, n].
__global__ void tile_start_kernel(int n, int cap, long long tiles, const int* __restrict__ offsets,
                                  int* __restrict__ start) {
  // let the reduction's blocks be scheduled now (they wait for this grid)
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const long long s = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (s > n) return;
  const int first = offsets[s];
  const long long lo = s == 0 ? 0 : (offsets[s - 1] + s - 1) / cap + 1;
  const long long hi = s == n ? tiles : (first + s) / cap;
  for (long long b = lo; b <= hi; ++b) {
    start[b] = static_cast<int>(s);
    start[tiles + 1 + b] = first;
  }
}

template <int R, int V>
__global__ void __launch_bounds__(kThreads)
segment_reduce_kernel(int d, int cap, int tiles, const float* __restrict__ data,
                      const int* __restrict__ perm, const int* __restrict__ offsets,
                      const int* __restrict__ start, float* __restrict__ out) {
  // launched while the stream's previous kernel (the tile kernel, when the
  // starts are new) may still run; wait for it
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int s0 = start[blockIdx.x];
  const int ns = start[blockIdx.x + 1] - s0;
  const int e0 = start[tiles + 1 + blockIdx.x];
  const int e1 = start[tiles + 2 + blockIdx.x];
  if (ns <= 0) return;
  extern __shared__ float4 smem[];
  float* rows = reinterpret_cast<float*>(smem);  // [cap, d]
  float* carry = rows + static_cast<size_t>(cap) * d;  // [d], the hub's accumulators
  int* pbuf = reinterpret_cast<int*>(carry + d);  // [2, cap], two chunks' perm entries
  int* offs = pbuf + 2 * cap;  // [ns + 1], the tile's offsets
  const int tid = threadIdx.x;
  const int dv = d / V;  // V-column groups per row
  for (int i = tid; i <= ns; i += kThreads) cp_async<4>(offs + i, offsets + s0 + i);
  for (int i = tid; i < min(cap, e1 - e0); i += kThreads) cp_async<4>(pbuf + i, perm + e0 + i);
  cp_async_wait_all();
  __syncthreads();

  int c0 = e0;
  bool first = true;
  int* pidx = pbuf;
  do {
    const int m = min(cap, e1 - c0);  // edges in this chunk
    const int c1 = c0 + m;
    // gather the chunk's rows: item i = (row j, column group q), stepped
    // without a division per item; and the next chunk's perm entries
    {
      int j = tid / dv, q = tid % dv;
      const int dj = kThreads / dv, dq = kThreads % dv;
      for (int i = tid; i < m * dv; i += kThreads) {
        cp_async<4 * V>(rows + j * d + q * V,
                        data + static_cast<long long>(pidx[j]) * d + q * V);
        j += dj;
        q += dq;
        if (q >= dv) { q -= dv; ++j; }
      }
      int* next = pidx == pbuf ? pbuf + cap : pbuf;
      for (int i = tid; i < min(cap, e1 - c1); i += kThreads) cp_async<4>(next + i, perm + c1 + i);
    }
    cp_async_wait_all();
    __syncthreads();

    // reduce: pair p = (segment lo + p / dr, column group p % dr) of VR
    // columns (V for sums, whose adds overlap; 1 for min/max, whose steps
    // are longer, so a hub's columns spread over more lanes); later chunks
    // hold only the tile's last segment
    constexpr int VR = R == SUM ? V : 1;
    const int dr = d / VR;
    const int lo = first ? 0 : ns - 1;
    int sl = lo + tid / dr, q = tid % dr;
    const int dj = kThreads / dr, dq = kThreads % dr;
    for (int p = tid; p < (ns - lo) * dr; p += kThreads) {
      const int a = offs[sl];
      const int b = offs[sl + 1];
      Acc<R> acc[VR];
      {
        const Vec<VR> from = a < c0 ? load_vec<VR>(carry + q * VR) : Vec<VR>{};
#pragma unroll
        for (int k = 0; k < VR; ++k) acc[k].init(a < c0 ? from.x[k] : identity<R>());
      }
      const float* r = rows + q * VR;
      const int jb = min(b, c1) - c0;
#pragma unroll 8
      for (int j = max(a, c0) - c0; j < jb; ++j) {
        const Vec<VR> x = load_vec<VR>(r + j * d);
#pragma unroll
        for (int k = 0; k < VR; ++k) acc[k].add(x.x[k]);
      }
      Vec<VR> res;
#pragma unroll
      for (int k = 0; k < VR; ++k) res.x[k] = acc[k].value();
      if (b > c1) {
        store_vec<VR>(carry + q * VR, res);
      } else {
        store_vec<VR>(out + static_cast<long long>(s0 + sl) * d + q * VR, res);
      }
      sl += dj;
      q += dq;
      if (q >= dr) { q -= dr; ++sl; }
    }
    __syncthreads();
    c0 = c1;
    first = false;
    pidx = pidx == pbuf ? pbuf + cap : pbuf;
  } while (c0 < e1);
}

template <int R, int V>
int launch(int d, long long tiles, int cap, const float* data, const int* perm,
           const int* offsets, const int* start, float* out, cudaStream_t st) {
  const size_t smem = smem_bytes(d, cap);
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    // above 48 KB a block needs the kernel's opt-in, once per device
    static unsigned long long opted_in = 0;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess && dev < 64 && !(opted_in >> dev & 1)) {
      err = cudaFuncSetAttribute(segment_reduce_kernel<R, V>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
      if (err == cudaSuccess) opted_in |= 1ull << dev;
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // programmatic dependent launch: after the tile kernel, the reduction's
  // blocks are set up while the tiles are computed and wait for them in
  // griddepcontrol.wait; after any other kernel it starts when that ends
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(tiles));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, segment_reduce_kernel<R, V>, d, cap,
                                             static_cast<int>(tiles), data, perm, offsets,
                                             start, out);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

template <int R>
int launch_for_width(int d, long long tiles, int cap, const float* data, const int* perm,
                     const int* offsets, const int* start, float* out, cudaStream_t st) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(data);
  if (d % 4 == 0 && a % 16 == 0)
    return launch<R, 4>(d, tiles, cap, data, perm, offsets, start, out, st);
  if (d % 2 == 0 && a % 8 == 0)
    return launch<R, 2>(d, tiles, cap, data, perm, offsets, start, out, st);
  return launch<R, 1>(d, tiles, cap, data, perm, offsets, start, out, st);
}

// The widest d whose chunk of two rows fits in a block's shared memory.
constexpr int kMaxWidth = (kSmemMax / 4 - 7) / 3;
static_assert(4 * (2 * (kMaxWidth + 3) + 1 + kMaxWidth) <= kSmemMax, "kMaxWidth");

}  // namespace

extern "C" {

// The widest rows segment_reduce_run takes: a chunk of two rows must fit in
// a block's shared memory.
int segment_reduce_max_width() { return kMaxWidth; }

// How many int32 the tile starts of segment_reduce_tiles take for n
// segments, e perm entries and width d (2 (tiles + 1)); -1 if d is above
// segment_reduce_max_width() or the count overflows int.
int segment_reduce_scratch(int n, int e, int d) {
  if (d > kMaxWidth) return -1;
  if (n <= 0 || d <= 0) return 1;
  const long long need = 2 * (tile_count(n, e, tile_cap(n, e, d)) + 1);
  return need > 0x7fffffff ? -1 : static_cast<int>(need);
}

// Writes into start (segment_reduce_scratch(n, e, d) int32) the tiles of the
// layout offsets [n + 1] over e perm entries at width d: each tile's first
// segment, then each tile's first edge. Returns cudaGetLastError().
int segment_reduce_tiles(int n, int e, int d, const int* offsets, int* start, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || d <= 0) return static_cast<int>(cudaGetLastError());
  if (d > kMaxWidth) return static_cast<int>(cudaErrorInvalidValue);
  const int cap = tile_cap(n, e, d);
  const long long tiles = tile_count(n, e, cap);
  const long long threads = static_cast<long long>(n) + 1;
  tile_start_kernel<<<static_cast<unsigned>((threads + kThreads - 1) / kThreads), kThreads, 0,
                      st>>>(n, cap, tiles, offsets, start);
  return static_cast<int>(cudaGetLastError());
}

// out [n, d] (row-major) = reduce over the edges of each segment of data [E, d]
// (row-major): segment s's edges are perm[offsets[s] .. offsets[s + 1]), in the
// order they are reduced; e is the length of perm. start holds the tiles that
// segment_reduce_tiles wrote for (offsets, e, d). reduce: 0 sum, 1 min, 2 max.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a width above
// segment_reduce_max_width().
int segment_reduce_run(int reduce, int n, int e, int d, const float* data, const int* perm,
                       const int* offsets, const int* start, float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || d <= 0) return static_cast<int>(cudaGetLastError());
  if (d > kMaxWidth) return static_cast<int>(cudaErrorInvalidValue);
  const int cap = tile_cap(n, e, d);
  const long long tiles = tile_count(n, e, cap);
  if (2 * (tiles + 1) > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  switch (reduce) {
    case SUM: return launch_for_width<SUM>(d, tiles, cap, data, perm, offsets, start, out, st);
    case MIN: return launch_for_width<MIN>(d, tiles, cap, data, perm, offsets, start, out, st);
    case MAX: return launch_for_width<MAX>(d, tiles, cap, data, perm, offsets, start, out, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
