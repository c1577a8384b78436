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
// What bounds it on this card: bytes. A sweep must read the src of every
// edge; only an edge whose src is on some lane's frontier needs its dst and
// w, a value gather per lane and one min per (dst, lane). Each sweep also
// reads and writes the lanes' state: at N = 2^22 one lane's values, parent,
// frontier and best words come to about 70 MB, more than the 50 MB L2, so
// it lives in device memory. The main path's sweeps mostly have sparse
// frontiers, so reading the edges and the state is most of the work.
//
// Design (it replaced one scatter launch per (edge tile, lane) that
// read src and dst of every edge once per lane, gathered a frontier byte
// per edge and lane and issued one atomic per active edge, all on clones
// of the caller's state made after an init pass over every best word):
//   * prepare (one pass over the caller's frontier): fills the best words
//     with the identity, lane-minor (best[v][lane], so one edge's lanes hit
//     one sector), and packs the frontier: a bitmap with one bit per
//     vertex on some running lane's frontier (512 KB at 2^22, read through
//     L1 and L2) and, with more than one lane, a word of lane bits per
//     vertex, in groups of 32 lanes. A lane that may not run (allowed 0)
//     gets no bits.
//   * scatter, one launch per edge block. Each thread reads four edges'
//     src in one 16-byte load and tests the bitmap; only for a frontier src
//     does it read dst, w and the lane bits. A block shared by every lane
//     is read once for all of them, the edge relaxed for every lane whose
//     bit is set; a stacked per-lane Delta block has grid y = lane and
//     reads its own row. For each lane the warp merges candidates for equal
//     dst before the atomic (__match_any_sync on dst, __reduce_min_sync on
//     the order-mapped key, then on src among the threads holding the
//     least key), so an R-MAT hub's in-edges in one warp cost one
//     atomicMin; a plain read of the word first skips atomics that cannot
//     win. With parents tracked the word is (key << 32 | src), so one
//     64-bit atomicMin keeps the best value and the smallest winning src.
//     Padding edges (dst == N, src 0) fail the dst test. Active edges are
//     counted per (lane, block).
//   * finish, once per round, four vertices per thread over all lanes (16-
//     byte accesses): decode the best, apply the meet, write fresh output
//     values, parents (when tracked) and frontier for every lane, copying a
//     lane that did not run in round 0; repack the frontier for the next
//     round and reset the best words it read (not after the last round);
//     raise the lane's run flag if it improved a vertex; add the round's
//     per-block counts, summed in block order, to the lane's f32 work (the
//     reference's f32 grouping). The work starts from the caller's value,
//     so a chunk can add each sweep to a running total, one at a time.
//     Only the best words of lanes that run are read. A round after the
//     first in which no lane runs returns at once: every lane's outputs
//     already hold its last round.
//   * The caller's tensors are only read: no clone, no in-place update.
//     The k rounds of a chunk are issued back to back with no host sync;
//     round r of a lane runs only if its frontier was not empty and
//     r < allowed[lane] (the TPU's SMEM run flag). The engine's fixpoint
//     sizes its chunks from the sweeps it has run (graph/engine.py), so
//     the prepare pass and the host's flag read come once a chunk; the
//     rounds past a chunk's last live one cost their launches (scatter
//     and finish both return at once) and no pass over the lanes' state.
//
// Weights lie in (0, 1], so no -0.0 or NaN reaches a key. The Viterbi
// product flushes results below FLT_MIN to zero, as the JAX reference does
// on the CPU; this file must not be built with --use_fast_math or -ftz.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

enum Op { MIN_PLUS = 0, MIN_PLUS_UNIT = 1, MAX_MIN = 2, MIN_MAX = 3, MAX_TIMES = 4 };

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNoWinner = 0x7fffffffu;
// per-lane shared arrays of one int: 48 KB, the default dynamic limit
constexpr int kMaxLanes = 12288;
constexpr int kVertexTiles = 1024;
constexpr int kEdgeTiles = 2048;
constexpr int kEdgesPerThread = 4;  // one 16-byte load of src per thread
// The finish pass holds 4 vertices' words, values and parents at once
// (about 95 registers a thread, 2 blocks of 256 threads on an SM). Capped
// at 64 registers (4 blocks) without parents and 80 (3 blocks) with them,
// where 64 spills, it ran 6-10% faster on an H100 on the main path's
// sweeps.
template <bool TRACK> constexpr int kFinishBlocksPerSM = TRACK ? 3 : 4;

template <bool TRACK>
using Best = typename std::conditional<TRACK, unsigned long long, uint32_t>::type;

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

// The identity best word: the identity's key (and no winner).
template <int OP, bool TRACK> __device__ __forceinline__ Best<TRACK> ident_word() {
  if constexpr (TRACK) {
    return (static_cast<unsigned long long>(to_key<OP>(identity<OP>())) << 32) | kNoWinner;
  } else {
    return to_key<OP>(identity<OP>());
  }
}

// Best words per 16-byte access, and that access.
template <bool TRACK> constexpr int kWordsPer16 = TRACK ? 2 : 4;

template <bool TRACK>
__device__ __forceinline__ void load16(const Best<TRACK>* at, Best<TRACK>* out) {
  if constexpr (TRACK) {
    const ulonglong2 q = *reinterpret_cast<const ulonglong2*>(at);
    out[0] = q.x;
    out[1] = q.y;
  } else {
    const uint4 q = *reinterpret_cast<const uint4*>(at);
    out[0] = q.x;
    out[1] = q.y;
    out[2] = q.z;
    out[3] = q.w;
  }
}

template <bool TRACK>
__device__ __forceinline__ void store16(Best<TRACK>* at, Best<TRACK> word) {
  if constexpr (TRACK) {
    *reinterpret_cast<ulonglong2*>(at) = make_ulonglong2(word, word);
  } else {
    *reinterpret_cast<uint4*>(at) = make_uint4(word, word, word, word);
  }
}

// The vertex passes (prepare, finish) take kVertsPerThread consecutive
// vertices per thread, each lane row's four entries in one vector access
// where n % 4 == 0 and the rows are aligned (else one entry at a time);
// m is how many of the four exist.
constexpr int kVertsPerThread = 4;

template <typename T> struct Quad;
template <> struct Quad<float> { using type = float4; };
template <> struct Quad<int> { using type = int4; };
template <> struct Quad<uint32_t> { using type = uint4; };
template <> struct Quad<uint8_t> { using type = uchar4; };

template <typename T>
__device__ __forceinline__ void load4(const T* p, bool vec, int m, T (&x)[4]) {
  if (vec && m == 4) {
    const typename Quad<T>::type q = *reinterpret_cast<const typename Quad<T>::type*>(p);
    x[0] = q.x;
    x[1] = q.y;
    x[2] = q.z;
    x[3] = q.w;
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) x[c] = c < m ? p[c] : T(0);
  }
}

template <typename T>
__device__ __forceinline__ void store4(T* p, bool vec, int m, const T (&x)[4]) {
  if (vec && m == 4) {
    typename Quad<T>::type q;
    q.x = x[0];
    q.y = x[1];
    q.z = x[2];
    q.w = x[3];
    *reinterpret_cast<typename Quad<T>::type*>(p) = q;
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (c < m) p[c] = x[c];
  }
}

static_assert(kEdgesPerThread == 4 && kVertsPerThread == 4, "load4 and store4 move 4 entries");

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Writes the vertex bitmap's words from each thread's 4 bits (bit c:
// vertex v0 + c): 8 neighbouring threads hold one word's 32 vertices.
// Returns whether the thread's word (or its group's) has a bit set.
__device__ __forceinline__ bool write_bitmap(uint32_t* bitmap, long long v0, int m, unsigned on,
                                             int wl) {
  uint32_t x = on << (4 * (wl & 7));
  x |= __shfl_xor_sync(kFull, x, 1);
  x |= __shfl_xor_sync(kFull, x, 2);
  x |= __shfl_xor_sync(kFull, x, 4);
  if ((wl & 7) == 0 && m > 0) bitmap[v0 >> 5] = x;
  return x != 0;
}

// Round 0's set-up, one pass: best[v][lane] = identity for every word; the
// packed frontier of the caller's frontier (bitmap: bit v set when v is on
// a lane's frontier and that lane may run, i.e. allowed > 0; fbits[g][v]:
// bit j for lane 32g + j, only with more than one lane); flags[lane] =
// any(frontier[lane]), flags[lanes] = any bit set.
template <int OP, bool TRACK>
__global__ void __launch_bounds__(kThreads)
prepare_kernel(int n, int lanes, const uint8_t* __restrict__ frontier,
               const int* __restrict__ allowed, Best<TRACK>* best, uint32_t* bitmap,
               uint32_t* fbits, int* flags) {
  extern __shared__ int s_lane[];  // bit 0: may run round 0; bit 1: frontier not empty
  for (int l = threadIdx.x; l < lanes; l += blockDim.x) s_lane[l] = allowed[l] > 0 ? 1 : 0;
  __syncthreads();
  const long long threads = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long words = static_cast<long long>(lanes) * n;
  const Best<TRACK> ident = ident_word<OP, TRACK>();
  constexpr int kW = kWordsPer16<TRACK>;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (long long i = first; i < words / kW; i += threads) store16<TRACK>(best + i * kW, ident);
  for (long long i = words / kW * kW + first; i < words; i += threads) best[i] = ident;
  const bool vec = n % 4 == 0 && aligned16(frontier) && (fbits == nullptr || aligned16(fbits));
  const int wl = threadIdx.x & 31;
  const int groups = (lanes + 31) >> 5;
  constexpr int kV = kVertsPerThread;
  bool any_bits = false;
  for (long long base = static_cast<long long>(blockIdx.x) * blockDim.x * kV; base < n;
       base += threads * kV) {
    const long long v0 = base + static_cast<long long>(threadIdx.x) * kV;
    const int m = v0 < n ? static_cast<int>(min(static_cast<long long>(kV), n - v0)) : 0;
    unsigned on = 0;  // bit c: vertex v0 + c is on a running lane's frontier
    for (int g = 0; g < groups; ++g) {
      uint32_t word[kV] = {0, 0, 0, 0};
      const int end = min(32, lanes - 32 * g);
      for (int j = 0; j < end; ++j) {
        const int l = 32 * g + j;
        uint8_t f[kV];
        load4(frontier + static_cast<long long>(l) * n + v0, vec, m, f);
        const bool some = (f[0] | f[1] | f[2] | f[3]) != 0;
        if (__any_sync(kFull, some) && wl == 0) atomicOr(&s_lane[l], 2);
        if (s_lane[l] & 1) {
#pragma unroll
          for (int c = 0; c < kV; ++c)
            if (f[c]) word[c] |= 1u << j;
        }
      }
      if (fbits != nullptr) store4(fbits + static_cast<long long>(g) * n + v0, vec, m, word);
#pragma unroll
      for (int c = 0; c < kV; ++c)
        if (word[c] != 0) on |= 1u << c;
    }
    any_bits |= write_bitmap(bitmap, v0, m, on, wl);
  }
  if (__syncthreads_or(any_bits) && threadIdx.x == 0) flags[lanes] = 1;
  for (int l = threadIdx.x; l < lanes; l += blockDim.x)
    if (s_lane[l] & 2) flags[l] = 1;
}

// One edge block's candidates for one round (see the header). MASKED:
// relax_multi (frontier bits, counts); otherwise edge_relax (every real
// edge, one lane, no counts). STACKED: grid y is the lane, which reads its
// own row of the block. flags points at this round's row. Each thread
// takes kEdgesPerThread consecutive edges, their src in one 16-byte load.
template <int OP, bool TRACK, bool MASKED, bool STACKED>
__global__ void __launch_bounds__(kThreads)
scatter_kernel(int n, int lanes, const float* __restrict__ values,
               const uint32_t* __restrict__ bitmap, const uint32_t* __restrict__ fbits,
               const int* __restrict__ src, const int* __restrict__ dst,
               const float* __restrict__ w, long long e_len, long long lane_stride,
               const int* __restrict__ flags, const int* __restrict__ allowed, int round,
               Best<TRACK>* best, unsigned* counts, int nblocks, int block_index) {
  extern __shared__ unsigned s_count[];  // active edges per lane
  const int own = STACKED ? static_cast<int>(blockIdx.y) : 0;
  const int counted = STACKED ? 1 : lanes;
  if (MASKED) {
    if (flags[lanes] == 0) return;  // no frontier bit anywhere this round
    if (STACKED && (flags[own] == 0 || round >= allowed[own])) return;
    for (int l = threadIdx.x; l < counted; l += blockDim.x) s_count[l] = 0;
    __syncthreads();
  }
  const int wl = threadIdx.x & 31;
  const unsigned me = 1u << wl;
  const long long ebase = STACKED ? static_cast<long long>(own) * lane_stride : 0;
  const int* srow = src + ebase;
  const int* drow = dst + ebase;
  const float* wrow = w + ebase;
  const bool aligned = aligned16(srow) && aligned16(drow) && aligned16(wrow);
  const int groups = (MASKED && !STACKED) ? (lanes + 31) >> 5 : 1;

  // Relax one edge (u -> d, weight wt; live: real and on some frontier)
  // for every lane whose bit is set; the whole warp calls it together.
  auto relax = [&](int u, int d, float wt, bool live) {
    for (int g = 0; g < groups; ++g) {
      uint32_t bits = 0;
      if (live) {
        if (!MASKED || lanes == 1) {
          bits = 1;
        } else if (STACKED) {
          bits = (fbits[static_cast<long long>(own >> 5) * n + u] >> (own & 31)) & 1u;
        } else {
          bits = fbits[static_cast<long long>(g) * n + u];
        }
      }
      uint32_t todo = __reduce_or_sync(kFull, bits);
      while (todo != 0) {
        const int j = __ffs(todo) - 1;
        todo &= todo - 1;
        const int lane = STACKED ? own : 32 * g + j;
        const bool has = ((bits >> j) & 1u) != 0;
        const unsigned act = __ballot_sync(kFull, has);
        if (MASKED && wl == 0) atomicAdd(&s_count[STACKED ? 0 : lane], __popc(act));
        if (!has) continue;
        const uint32_t key =
            to_key<OP>(combine<OP>(values[static_cast<long long>(lane) * n + u], wt));
        const unsigned peers = __popc(act) > 1 ? __match_any_sync(act, d) : me;
        uint32_t kmin = key, smin = static_cast<uint32_t>(u);
        if (peers != me) {
          kmin = __reduce_min_sync(peers, key);
          if (TRACK) smin = __reduce_min_sync(peers, key == kmin ? smin : 0xffffffffu);
        }
        if (wl != __ffs(peers) - 1) continue;
        Best<TRACK>* slot = best + static_cast<long long>(d) * lanes + lane;
        if constexpr (TRACK) {
          const unsigned long long packed = (static_cast<unsigned long long>(kmin) << 32) | smin;
          if (packed < *reinterpret_cast<volatile unsigned long long*>(slot)) atomicMin(slot, packed);
        } else {
          if (kmin < *reinterpret_cast<volatile uint32_t*>(slot)) atomicMin(slot, kmin);
        }
      }
    }
  };

  constexpr int kE = kEdgesPerThread;
  const long long span = static_cast<long long>(blockDim.x) * kE;
  const long long stride = static_cast<long long>(gridDim.x) * span;
  for (long long base = static_cast<long long>(blockIdx.x) * span; base < e_len; base += stride) {
    const long long e0 = base + static_cast<long long>(threadIdx.x) * kE;
    const int m = e0 < e_len ? static_cast<int>(min(static_cast<long long>(kE), e_len - e0)) : 0;
    int u[kE];
    load4(srow + e0, aligned, m, u);
    unsigned live = 0;  // bit c: edge e0 + c exists and its src is on a frontier
#pragma unroll
    for (int c = 0; c < kE; ++c)
      if (c < m && (!MASKED || ((bitmap[u[c] >> 5] >> (u[c] & 31)) & 1u) != 0)) live |= 1u << c;
    if (!__any_sync(kFull, live != 0)) continue;
    int d[kE];
    float wt[kE];
    if (live == (1u << kE) - 1) {
      load4(drow + e0, aligned, m, d);
      load4(wrow + e0, aligned, m, wt);
    } else {
#pragma unroll
      for (int c = 0; c < kE; ++c) {
        d[c] = n;
        wt[c] = 0.0f;
        if ((live >> c) & 1u) {
          d[c] = drow[e0 + c];
          wt[c] = wrow[e0 + c];
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kE; ++c) {
      const bool real = ((live >> c) & 1u) != 0 && d[c] < n;  // dst == n: padding
      if (__any_sync(kFull, real)) relax(u[c], d[c], wt[c], real);
    }
  }
  if (MASKED) {
    __syncthreads();
    for (int l = threadIdx.x; l < counted; l += blockDim.x)
      if (s_count[l] != 0)
        atomicAdd(counts + static_cast<long long>(STACKED ? own : l) * nblocks + block_index,
                  s_count[l]);
  }
}

// The end of round `round` (see the header). Round 0 reads the caller's
// state (vin, pin, fin); later rounds update the outputs in place.
template <int OP, bool TRACK>
__global__ void __launch_bounds__(kThreads, kFinishBlocksPerSM<TRACK>)
finish_kernel(int n, int lanes, int round, int k, const float* __restrict__ vin,
              const int* __restrict__ pin, const uint8_t* __restrict__ fin, float* vout,
              int* pout, uint8_t* fout, Best<TRACK>* best, uint32_t* bitmap, uint32_t* fbits,
              const int* __restrict__ flags, int* next_flags, const int* __restrict__ allowed,
              int* sweeps, float* work, unsigned* counts, int nblocks) {
  extern __shared__ int s_lane[];  // bit 0: runs now; bit 1: may run next; bit 2: improved
  bool runs = false;
  for (int l = threadIdx.x; l < lanes; l += blockDim.x) {
    s_lane[l] = ((flags[l] != 0 && round < allowed[l]) ? 1 : 0) | (round + 1 < allowed[l] ? 2 : 0);
    runs |= (s_lane[l] & 1) != 0;
  }
  // a dead round: the outputs hold every lane's last round, its run flags
  // stay 0, and so do those of the rounds after it
  if (!__syncthreads_or(runs) && round > 0) return;
  const bool last = round + 1 == k;
  const float* vcur = round == 0 ? vin : vout;
  const int* pcur = round == 0 ? pin : pout;
  const Best<TRACK> ident = ident_word<OP, TRACK>();
  constexpr int kW = kWordsPer16<TRACK>;
  constexpr int kV = kVertsPerThread;
  const bool bvec = lanes % kW == 0;  // a vertex's words in 16-byte loads
  bool vec = n % 4 == 0 && aligned16(vin) && aligned16(vout) && aligned16(fin) &&
             aligned16(fout) && (fbits == nullptr || aligned16(fbits));
  if constexpr (TRACK) vec = vec && aligned16(pin) && aligned16(pout);
  const int wl = threadIdx.x & 31;
  const int groups = (lanes + 31) >> 5;
  const long long threads = static_cast<long long>(gridDim.x) * blockDim.x;
  bool any_bits = false;
  for (long long base = static_cast<long long>(blockIdx.x) * blockDim.x * kV; base < n;
       base += threads * kV) {
    const long long v0 = base + static_cast<long long>(threadIdx.x) * kV;
    const int m = v0 < n ? static_cast<int>(min(static_cast<long long>(kV), n - v0)) : 0;
    unsigned on = 0;  // bit c: vertex v0 + c is on the next round's frontier
    for (int g = 0; g < groups; ++g) {
      uint32_t word[kV] = {0, 0, 0, 0};
      const int end = min(32, lanes - 32 * g);
      for (int j0 = 0; j0 < end; j0 += kW) {
        // vertex c's words of lanes 32g + j0 ... at at0 + c * lanes
        Best<TRACK>* at0 = best + v0 * lanes + 32 * g + j0;
        Best<TRACK> words[kV][kW];
        // the words of lanes that do not run stay at the identity: unread
        bool quad_runs = false;
#pragma unroll
        for (int cc = 0; cc < kW; ++cc)
          if (j0 + cc < end && (s_lane[32 * g + j0 + cc] & 1)) quad_runs = true;
        if (bvec && quad_runs) {
#pragma unroll
          for (int c = 0; c < kV; ++c)
            if (c < m) load16<TRACK>(at0 + c * lanes, words[c]);
        }
        unsigned touched = 0;  // bit c: a word of vertex c to reset
#pragma unroll
        for (int cc = 0; cc < kW; ++cc) {
          const int j = j0 + cc;
          if (j >= end) break;
          const int l = 32 * g + j;
          const int st = s_lane[l];
          const long long i0 = static_cast<long long>(l) * n + v0;
          unsigned improved = 0;  // bit c: vertex v0 + c improved
          if (m > 0 && (st & 1)) {
            float val[kV];
            int par[kV];
            uint8_t fr[kV];
            load4(vcur + i0, vec, m, val);
            if constexpr (TRACK) load4(pcur + i0, vec, m, par);
#pragma unroll
            for (int c = 0; c < kV; ++c) {
              fr[c] = 0;
              if (c >= m) continue;
              const Best<TRACK> p = bvec ? words[c][cc] : at0[c * lanes + cc];
              if (!last && p != ident) {
                touched |= 1u << c;
                if (!bvec) at0[c * lanes + cc] = ident;
              }
              uint32_t key;
              if constexpr (TRACK) {
                key = static_cast<uint32_t>(p >> 32);
              } else {
                key = p;
              }
              const float b = from_key<OP>(key);
              if (is_min<OP>() ? (b < val[c]) : (b > val[c])) {
                val[c] = b;
                if constexpr (TRACK) par[c] = static_cast<int>(p & 0xffffffffull);
                fr[c] = 1;
                improved |= 1u << c;
              }
            }
            store4(vout + i0, vec, m, val);
            if constexpr (TRACK) store4(pout + i0, vec, m, par);
            store4(fout + i0, vec, m, fr);
          } else if (m > 0 && round == 0) {  // a lane that does not run keeps its state
            float val[kV];
            uint8_t fr[kV];
            load4(vin + i0, vec, m, val);
            store4(vout + i0, vec, m, val);
            if constexpr (TRACK) {
              int par[kV];
              load4(pin + i0, vec, m, par);
              store4(pout + i0, vec, m, par);
            }
            load4(fin + i0, vec, m, fr);
            store4(fout + i0, vec, m, fr);
          }
          if ((st & 1) && __any_sync(kFull, improved != 0) && wl == 0) atomicOr(&s_lane[l], 4);
          if (st & 2) {
#pragma unroll
            for (int c = 0; c < kV; ++c)
              if ((improved >> c) & 1u) word[c] |= 1u << j;
          }
        }
        // a lane that did not run left its words at the identity
        if (bvec) {
#pragma unroll
          for (int c = 0; c < kV; ++c)
            if ((touched >> c) & 1u) store16<TRACK>(at0 + c * lanes, ident);
        }
      }
      if (!last && fbits != nullptr)
        store4(fbits + static_cast<long long>(g) * n + v0, vec, m, word);
#pragma unroll
      for (int c = 0; c < kV; ++c)
        if (word[c] != 0) on |= 1u << c;
    }
    if (!last) any_bits |= write_bitmap(bitmap, v0, m, on, wl);
  }
  if (__syncthreads_or(any_bits) && threadIdx.x == 0) next_flags[lanes] = 1;
  for (int l = threadIdx.x; l < lanes; l += blockDim.x)
    if (s_lane[l] & 4) next_flags[l] = 1;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    for (int l = 0; l < lanes; ++l) {
      if (!(s_lane[l] & 1)) continue;
      sweeps[l] += 1;
      float sweep_work = 0.0f;
      unsigned* c = counts + static_cast<long long>(l) * nblocks;
      for (int b = 0; b < nblocks; ++b) {
        sweep_work = __fadd_rn(sweep_work, __uint2float_rn(c[b]));
        c[b] = 0;
      }
      work[l] = __fadd_rn(work[l], sweep_work);
    }
  }
}

// edge_relax: out's words hold keys during the sweep.
template <int OP>
__global__ void __launch_bounds__(kThreads) fill_kernel(int n, uint32_t* out) {
  for (int v = blockIdx.x * blockDim.x + threadIdx.x; v < n; v += gridDim.x * blockDim.x)
    out[v] = to_key<OP>(identity<OP>());
}

template <int OP>
__global__ void __launch_bounds__(kThreads) decode_kernel(int n, float* out) {
  for (int v = blockIdx.x * blockDim.x + threadIdx.x; v < n; v += gridDim.x * blockDim.x)
    out[v] = from_key<OP>(__float_as_uint(out[v]));
}

inline int tiles(long long count, int cap) {
  long long t = (count + kThreads - 1) / kThreads;
  if (t < 1) t = 1;
  return static_cast<int>(t < cap ? t : cap);
}

template <int OP, bool TRACK>
void launch_multi(int lanes, int n, int k, const float* vin, const int* pin, const uint8_t* fin,
                  float* vout, int* pout, uint8_t* fout, int nblocks, void* const* srcs,
                  void* const* dsts, void* const* ws, const long long* lens,
                  const long long* strides, const int* allowed, int* flags, int* sweeps,
                  float* work, void* best_words, uint32_t* bitmap, uint32_t* fbits,
                  unsigned* counts, cudaStream_t st) {
  Best<TRACK>* best = static_cast<Best<TRACK>*>(best_words);
  const int vt = tiles((n + kVertsPerThread - 1) / kVertsPerThread, kVertexTiles);
  const size_t lane_smem = static_cast<size_t>(lanes) * sizeof(int);
  prepare_kernel<OP, TRACK><<<vt, kThreads, lane_smem, st>>>(n, lanes, fin, allowed, best, bitmap,
                                                            fbits, flags);
  for (int r = 0; r < k; ++r) {
    const int* flag = flags + static_cast<long long>(r) * (lanes + 1);
    int* next = flags + static_cast<long long>(r + 1) * (lanes + 1);
    const float* values = r == 0 ? vin : vout;
    for (int b = 0; b < nblocks; ++b) {
      const int* src = static_cast<const int*>(srcs[b]);
      const int* dst = static_cast<const int*>(dsts[b]);
      const float* w = static_cast<const float*>(ws[b]);
      const int et = tiles((lens[b] + kEdgesPerThread - 1) / kEdgesPerThread, kEdgeTiles);
      if (strides[b] == 0) {
        scatter_kernel<OP, TRACK, true, false><<<dim3(et, 1), kThreads, lane_smem, st>>>(
            n, lanes, values, bitmap, fbits, src, dst, w, lens[b], 0, flag, allowed, r, best,
            counts, nblocks, b);
      } else {
        scatter_kernel<OP, TRACK, true, true><<<dim3(et, lanes), kThreads, sizeof(unsigned), st>>>(
            n, lanes, values, bitmap, fbits, src, dst, w, lens[b], strides[b], flag, allowed, r,
            best, counts, nblocks, b);
      }
    }
    finish_kernel<OP, TRACK><<<vt, kThreads, lane_smem, st>>>(
        n, lanes, r, k, vin, pin, fin, vout, pout, fout, best, bitmap, fbits, flag, next, allowed,
        sweeps, work, counts, nblocks);
  }
}

template <int OP>
void launch_single(int n, const float* values, const int* src, const int* dst, const float* w,
                   long long e_len, float* out, cudaStream_t st) {
  const int vt = tiles(n, kVertexTiles);
  uint32_t* keys = reinterpret_cast<uint32_t*>(out);
  fill_kernel<OP><<<vt, kThreads, 0, st>>>(n, keys);
  const int et = tiles((e_len + kEdgesPerThread - 1) / kEdgesPerThread, kEdgeTiles);
  scatter_kernel<OP, false, false, false><<<dim3(et, 1), kThreads, 0, st>>>(
      n, 1, values, nullptr, nullptr, src, dst, w, e_len, 0, nullptr, nullptr, 0, keys, nullptr,
      0, 0);
  decode_kernel<OP><<<vt, kThreads, 0, st>>>(n, out);
}

}  // namespace

extern "C" {

// The most lanes relax_multi_run takes (its per-lane shared arrays).
int relax_multi_max_lanes() { return kMaxLanes; }

// Up to k frontier-masked sweeps over `lanes` states of n vertices each.
// Reads values/parent/frontier ([lanes, n], row-major; parent may be null
// when not tracked) and writes values_out/parent_out/frontier_out for
// every lane; the inputs are never written. Block b has lens[b] edges per
// lane and lane stride strides[b] (0 = shared). flags: (k + 1) * (lanes +
// 1) ints, counts: lanes * nblocks, sweeps: lanes, all zeroed by the
// caller; work: lanes floats, each lane's starting total; best: lanes * n words of 8 bytes (track) or 4;
// bitmap: ceil(n / 32) words; fbits: ceil(lanes / 32) * n words, or null
// with one lane. Returns cudaGetLastError().
int relax_multi_run(int op, int track, int lanes, int n, int k, const float* values,
                    const int* parent, const uint8_t* frontier, float* values_out,
                    int* parent_out, uint8_t* frontier_out, int nblocks, void* const* srcs,
                    void* const* dsts, void* const* ws, const long long* lens,
                    const long long* strides, const int* allowed, int* flags, int* sweeps,
                    float* work, void* best, uint32_t* bitmap, uint32_t* fbits,
                    unsigned* counts, void* stream) {
  if (lanes < 1 || lanes > kMaxLanes || (lanes > 1 && fbits == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RELAX_MULTI_CASE(OPV)                                                                   \
  case OPV:                                                                                     \
    if (track)                                                                                  \
      launch_multi<OPV, true>(lanes, n, k, values, parent, frontier, values_out, parent_out,    \
                              frontier_out, nblocks, srcs, dsts, ws, lens, strides, allowed,    \
                              flags, sweeps, work, best, bitmap, fbits, counts, st);            \
    else                                                                                        \
      launch_multi<OPV, false>(lanes, n, k, values, parent, frontier, values_out, parent_out,   \
                               frontier_out, nblocks, srcs, dsts, ws, lens, strides, allowed,   \
                               flags, sweeps, work, best, bitmap, fbits, counts, st);           \
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
// the identity where no edge lands. Returns cudaGetLastError().
int edge_relax_run(int op, int n, const float* values, const int* src, const int* dst,
                   const float* w, long long e_len, float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (op) {
    case MIN_PLUS: launch_single<MIN_PLUS>(n, values, src, dst, w, e_len, out, st); break;
    case MIN_PLUS_UNIT: launch_single<MIN_PLUS_UNIT>(n, values, src, dst, w, e_len, out, st); break;
    case MAX_MIN: launch_single<MAX_MIN>(n, values, src, dst, w, e_len, out, st); break;
    case MIN_MAX: launch_single<MIN_MAX>(n, values, src, dst, w, e_len, out, st); break;
    case MAX_TIMES: launch_single<MAX_TIMES>(n, values, src, dst, w, e_len, out, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Shared by every source of the library (kernels/_build.py binds it once).
const char* kernels_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
