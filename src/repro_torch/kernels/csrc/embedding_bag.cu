// Weighted bag sum of table rows for Hopper (sm_90a): the recsys EmbeddingBag.
//
//     out[b, :] = sum_{i : bags[i] == b} weights[i] * table[ids[i], :]
//
// Replaces repro/kernels/embedding_bag/embedding_bag.py::embedding_bag_pallas.
//
// The contract: every (bag, column) is summed by one thread, in lookup order,
// from +0.0: acc = __fadd_rn(acc, __fmul_rn(w, row)). The product is rounded
// before the add, as the reference's take -> multiply -> segment_sum rounds
// it, and the library is built with --fmad=false, without fast-math or ftz.
// No atomics, and a bag's sum is never split into partial sums. So the result
// equals repro.models.embedding.embedding_bag(mode="sum") on the CPU, the
// Pallas kernel in interpret mode and the plain version in ref.py bit for bit.
// An empty bag is +0.0; a dropped bag's lookups are never read.
//
// Layout (not this file): the wrapper's `segment_layout` stable-sorts the bag
// ids once per index array, giving `perm` (lookups grouped by bag, in lookup
// order within each bag; bags outside [0, n_bags) sorted last and dropped)
// and CSR `offsets` [n_bags + 1]. DIEN's bags are contiguous runs of the
// history (`contiguous_layout`): there perm is the identity, the wrapper
// passes a null perm and the kernel reads ids and weights directly.
//
// What bounds it on this card: bytes. Each in-range lookup's id and weight
// (and perm entry, where read) and its 4 D-byte row are read once, and each
// output row is written once; one multiply and one add per element are far
// below the card's rates. Rows are gathered at random: a 72-byte row (D = 18)
// touches three 32-byte sectors and two 64-byte pieces of device memory, so
// the card moves 96 to 128 bytes for every 72 it needs. What a call needs is
// many rows in flight at once.
//
// The design: one kernel, 256 threads a block. Block x takes a run of G
// consecutive bags (G from the mean bag length, so that a block holds about
// one chunk of lookups; at least 1, at most kMaxBags) and block y a slab of
// at most kMaxSlab columns. The run's lookups are one contiguous stretch of
// the layout, [offsets[s0], offsets[s0 + G]), walked in chunks of K lookups
// (K fills kSmemBudget of shared memory):
//   1. stage: the run's offsets, then the chunk's ids and weights (through
//      perm where there is one), are copied into shared memory with
//      coalesced cp.async, one lookup per thread;
//   2. gather: every thread issues cp.async copies of row pieces (16, 8 or 4
//      bytes, as D and the alignment allow) over the flattened (lookup,
//      column) pairs of the chunk, so all of a chunk's rows are in flight
//      together, and the next chunk's ids and weights with them: a bag of 100
//      lookups is two memory round trips, not 100 dependent ones, and a long
//      bag's gathers spread over all the block's warps;
//   3. sum: each thread takes (bag, column piece) pairs of the chunk's bags,
//      flattened, so at small D one warp sums several bags and no lane
//      idles; it walks the bag's rows in shared memory in lookup order,
//      reading kBatch rows and weights ahead of their adds, and writes the
//      output. A bag that crosses a chunk boundary (at most one per
//      boundary) carries its accumulators to the next chunk through shared
//      memory (two buffers, read one, write the other).
// A run of empty bags is a flat fill of +0.0 by the same pairs. Row offsets
// are computed in 64 bits (the 2^23-row item table).
//
// Built with --fmad=false and without fast-math or ftz (kernels/_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemBudget = 48 * 1024;  // bytes; no opt-in needed up to 48 KB
constexpr int kMaxBags = 512;           // bags per block
constexpr int kMaxSlab = 1024;          // columns per block
constexpr int kBatch = 8;               // lookups whose loads a summing thread overlaps
// blocks a large input is spread over at the least (four on each of an
// H100's 132 SMs), and the fewest lookups a block is given to reach them
constexpr long long kMinBlocks = 4 * 132;
constexpr long long kMinLookups = 32;

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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The chunk's ids and weights, lookups [c, c + m) of the layout, into sid and
// sw: through perm where there is one, else directly.
template <bool kPerm>
__device__ __forceinline__ void stage(int c, int m, const int* __restrict__ ids,
                                      const float* __restrict__ weights,
                                      const int* __restrict__ perm, int* sid, float* sw) {
  for (int j = threadIdx.x; j < m; j += kThreads) {
    const int i = kPerm ? perm[c + j] : c + j;
    cp_async<4>(sid + j, ids + i);
    cp_async<4>(sw + j, weights + i);
  }
}

template <int V, bool kPerm>
__global__ void __launch_bounds__(kThreads)
embedding_bag_kernel(int n_bags, int d, int slab, int cap, int bags_per_block,
                     const float* __restrict__ table, const int* __restrict__ ids,
                     const float* __restrict__ weights, const int* __restrict__ perm,
                     const int* __restrict__ offsets, float* __restrict__ out) {
  const long long s0 = static_cast<long long>(blockIdx.x) * bags_per_block;
  const int ns = static_cast<int>(min(static_cast<long long>(bags_per_block), n_bags - s0));
  const int col0 = blockIdx.y * slab;
  const int w = min(slab, d - col0);  // this block's columns
  extern __shared__ float4 smem[];
  float* rows = reinterpret_cast<float*>(smem);  // [cap, w], the chunk's rows
  float* carry = rows + static_cast<size_t>(cap) * w;  // [2, w], a crossing bag's sums
  int* sid = reinterpret_cast<int*>(carry + 2 * w);  // [2, cap], two chunks' ids
  float* sw = reinterpret_cast<float*>(sid + 2 * cap);  // [2, cap], and weights
  int* offs = reinterpret_cast<int*>(sw + 2 * cap);  // [ns + 1], the run's offsets
  const int tid = threadIdx.x;
  const int dv = w / V;  // V-column pieces per row

  for (int i = tid; i <= ns; i += kThreads) cp_async<4>(offs + i, offsets + s0 + i);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int e0 = offs[0];
  const int e1 = offs[ns];
  stage<kPerm>(e0, min(cap, e1 - e0), ids, weights, perm, sid, sw);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  int c0 = e0;
  int buf = 0;
  int sa = 0;  // the chunk's first bag
  do {
    const int m = min(cap, e1 - c0);  // lookups in this chunk
    const int c1 = c0 + m;
    // gather the chunk's rows: item i = (lookup j, piece q), stepped without
    // a division per item; then the next chunk's ids and weights
    {
      const int* id = sid + buf * cap;
      int j = tid / dv, q = tid % dv;
      const int dj = kThreads / dv, dq = kThreads % dv;
      for (int i = tid; i < m * dv; i += kThreads) {
        cp_async<4 * V>(rows + j * w + q * V,
                        table + static_cast<long long>(id[j]) * d + col0 + q * V);
        j += dj;
        q += dq;
        if (q >= dv) { q -= dv; ++j; }
      }
      cp_async_commit();
      stage<kPerm>(c1, min(cap, e1 - c1), ids, weights, perm, sid + (buf ^ 1) * cap,
                   sw + (buf ^ 1) * cap);
      cp_async_commit();
    }
    cp_async_wait<1>();  // the rows have landed; the next ids may be in flight
    __syncthreads();

    // the chunk's bags: [sa, sb), sb the first bag that starts at or after
    // c1 (every bag left, on the last chunk)
    const bool last = c1 >= e1;
    int sb = ns;
    if (!last) {
      int lo = sa + 1;
      while (lo < sb) {
        const int mid = (lo + sb) / 2;
        if (offs[mid] >= c1) sb = mid; else lo = mid + 1;
      }
    }
    // sum: pair p = (bag sa + p / dv, piece p % dv), in lookup order
    {
      const float* wj = sw + buf * cap;
      const float* cin = carry + buf * w;
      float* cout = carry + (buf ^ 1) * w;
      int sl = sa + tid / dv, q = tid % dv;
      const int dj = kThreads / dv, dq = kThreads % dv;
      for (int p = tid; p < (sb - sa) * dv; p += kThreads) {
        const int a = offs[sl];
        const int b = offs[sl + 1];
        Vec<V> acc = a < c0 ? load_vec<V>(cin + q * V) : Vec<V>{};
        const float* r = rows + q * V;
        const int jb = min(b, c1) - c0;
        int j = max(a, c0) - c0;
        // kBatch lookups' rows and weights are read from shared memory
        // first, so their loads overlap; then they are added in order
        for (; j + kBatch <= jb; j += kBatch) {
          Vec<V> x[kBatch];
          float wt[kBatch];
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            x[u] = load_vec<V>(r + (j + u) * w);
            wt[u] = wj[j + u];
          }
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
#pragma unroll
            for (int k = 0; k < V; ++k)
              acc.x[k] = __fadd_rn(acc.x[k], __fmul_rn(wt[u], x[u].x[k]));
          }
        }
        for (; j < jb; ++j) {
          const Vec<V> x = load_vec<V>(r + j * w);
          const float wt = wj[j];
#pragma unroll
          for (int k = 0; k < V; ++k) acc.x[k] = __fadd_rn(acc.x[k], __fmul_rn(wt, x.x[k]));
        }
        if (b > c1) {
          store_vec<V>(cout + q * V, acc);
        } else {
          store_vec<V>(out + (s0 + sl) * d + col0 + q * V, acc);
        }
        sl += dj;
        q += dq;
        if (q >= dv) { q -= dv; ++sl; }
      }
    }
    // the next chunk starts with the bag that crosses c1, if one does
    if (!last) sa = offs[sb] > c1 ? sb - 1 : sb;
    cp_async_wait<0>();
    __syncthreads();
    c0 = c1;
    buf ^= 1;
  } while (c0 < e1);
}

// Columns per block (a multiple of 4, at most kMaxSlab) for width d.
int slab_width(int d) {
  if (d <= kMaxSlab) return d;
  const int slabs = (d + kMaxSlab - 1) / kMaxSlab;
  return ((d + slabs - 1) / slabs + 3) / 4 * 4;
}

// Lookups per chunk at slab width w: the rows, two chunks of ids and
// weights, the carry and the offsets of kMaxBags bags fill kSmemBudget.
int chunk_cap(int w) { return (kSmemBudget / 4 - 2 * w - (kMaxBags + 1)) / (w + 4); }

template <int V, bool kPerm>
int launch(int n_bags, int d, long long lookups, const float* table, const int* ids,
           const float* weights, const int* perm, const int* offsets, float* out,
           cudaStream_t st) {
  const int slab = slab_width(d);
  const int cap = chunk_cap(slab);
  // bags per block: about `target` lookups at the mean bag length
  long long target = (lookups + kMinBlocks - 1) / kMinBlocks;
  target = target < kMinLookups ? kMinLookups : target;
  target = target > cap ? cap : target;
  long long g = lookups > 0 ? target * n_bags / lookups : kMaxBags;
  g = g < 1 ? 1 : (g > kMaxBags ? kMaxBags : g);
  const int bags = static_cast<int>(g);
  const size_t smem =
      4 * (static_cast<size_t>(cap) * slab + 2 * slab + 4 * static_cast<size_t>(cap) + bags + 1);
  const dim3 grid(static_cast<unsigned>((n_bags + g - 1) / g),
                  static_cast<unsigned>((d + slab - 1) / slab));
  embedding_bag_kernel<V, kPerm><<<grid, kThreads, smem, st>>>(
      n_bags, d, slab, cap, bags, table, ids, weights, perm, offsets, out);
  return static_cast<int>(cudaGetLastError());
}

template <bool kPerm>
int launch_for_width(int n_bags, int d, long long lookups, const float* table, const int* ids,
                     const float* weights, const int* perm, const int* offsets, float* out,
                     cudaStream_t st) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(table);
  if (d % 4 == 0 && a % 16 == 0)
    return launch<4, kPerm>(n_bags, d, lookups, table, ids, weights, perm, offsets, out, st);
  if (d % 2 == 0 && a % 8 == 0)
    return launch<2, kPerm>(n_bags, d, lookups, table, ids, weights, perm, offsets, out, st);
  return launch<1, kPerm>(n_bags, d, lookups, table, ids, weights, perm, offsets, out, st);
}

}  // namespace

extern "C" {

// out [n_bags, d] (row-major) = the weighted sum of the table rows [V, d]
// (row-major) looked up by each bag: bag b's lookups are
// perm[offsets[b] .. offsets[b + 1]) (the positions themselves where perm is
// null, the identity), summed in that order; lookup i reads row ids[i]
// scaled by weights[i]. lookups is the length of ids (it sets how many bags
// a block takes). Returns cudaGetLastError().
int embedding_bag_run(int n_bags, int d, long long lookups, const float* table, const int* ids,
                      const float* weights, const int* perm, const int* offsets, float* out,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_bags <= 0 || d <= 0) return static_cast<int>(cudaGetLastError());
  if (perm == nullptr)
    return launch_for_width<false>(n_bags, d, lookups, table, ids, weights, perm, offsets, out,
                                   st);
  return launch_for_width<true>(n_bags, d, lookups, table, ids, weights, perm, offsets, out, st);
}

}  // extern "C"
