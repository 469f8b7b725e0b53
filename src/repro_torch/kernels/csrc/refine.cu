// The refinement of the exact k-NN search, in two kernels.
//
// refine_topk: one round.  For every query, the squared distances to the
// members of the K leaves its priority queue hands out this round, folded
// into the query's carried top-k buffer.
//
// refine_search: every round of a search in one launch.  Each query runs
// its own rounds until its own stop (its next lower bound is not below
// its k-th best), which gives the buffer of the global loop: once a
// query's first slot of a round is dead, all its later slots are dead
// (the queue ascends, the k-th best never grows) and its buffer stays.
//
// Replace the Pallas kernels `_refine_kernel`, `_refine_kernel_dma` and
// `_refine_kernel_triton` of src/repro/kernels/refine.py (wrapper
// `refine_topk`), which compute one round in three structures, and their
// fold `_rank_select`; refine_search also takes the place of the
// `while_loop` of src/repro/core/search.py::search_plan_impl.
//
// Bound on this card: device memory, on the leaf bytes of the alive
// slots (alive slots * M * (L * sizeof(T) + 4)).  Each leaf row is used
// once per query, so the dot products (2 * L flops per row) cannot hide
// the reads; refine_topk's fold is O((k + 256)^2) compares on data
// already in shared memory, refine_search's O((k + n) log) a round.
//
// refine_topk's design (namespace `topk` below): a persistent grid of as
// many CTAs as the card holds at once, CTA b taking the rows b, b + grid,
// ..., a window of rows at a time.  For a window, the CTA reads every (row,
// slot)'s flag and leaf in one pass and lists the alive ones; a dead slot
// reads nothing, and a row with no alive slot copies its buffer.  The
// listed leaves (rows, then norms) and each row's query stream through a
// ring of shared-memory stages by 1-D bulk copies completing on mbarriers,
// a few chunks ahead across slots and rows, so a row's leaves are all in
// flight at once and the next row's land while this one folds.  The warps
// reduce q.x from shared memory (warp_d2): a lane reads 16 bytes of a row
// at a time (4 floats or 8 halves) at the stored width, and the warp
// reduces q.x in float32 by xor-shuffles, four rows at once.  d^2 =
// max((q_sq + |x|^2) - 2 q.x, 0), rounded step by step as the plain
// version writes it.  After a row's last chunk the CTA takes its K * M
// distances in union (slot, row) order, kThreads at a time, and folds
// those below the k-th best of the moment into the (ascending) buffer
// (fold); the others cannot enter.  The fold ranks the union of the k
// buffer slots and the n candidates:
//   rank(e) = #{f : d_f < d_e or (d_f == d_e and f < e)},
// with buffer slots before candidates, a permutation of 0..k+n-1, so the
// thread of an element of rank < k writes it to that slot.  Folds in
// union order give the ties of one fold over all K * M candidates, lower
// union index first, as `jax.lax.top_k` does, and a fold ranks at most
// k + kThreads elements, however many candidates pass a first round's
// empty buffer.
//
// refine_search's design (namespace `search` below): a persistent grid of
// thread-block clusters of C CTAs, each cluster pulling queries from an
// atomic counter, in the order of a schedule the wrapper gives (the heaviest
// first, so that no long query starts last).  A query's slot j goes to CTA j
// mod C.  Each CTA fetches its alive slots' leaves (rows, then their norms)
// with 1-D bulk copies into a ring of shared-memory stages, completing on
// mbarriers, ahead of use: a slot is fetched if its lower bound is below the
// k-th best of the moment, which can only fall, so an alive slot is always
// fetched and a prefetched slot found dead at its round's start is dropped
// unread.  The queue entries of the next rounds wait in shared memory, read a
// few rounds ahead.  The warps reduce q.x from shared memory through
// refine_topk's own code (warp_d2), so the distances, the buffers and the
// round counts are refine_topk's bit for bit.
//
// The fold is by selection and merge, O(k + n) where a pairwise rank is
// O((k + n)^2).  Each CTA lists its own candidates below the k-th best as
// 64-bit keys (distance bits, -0.0 as +0.0, then the union index, so keys
// order as the rank rule orders candidates) and sorts them (sort_keys):
// its run, of which only the first k can enter (a later key has k
// candidates before it).  After one cluster barrier every CTA gathers the
// C runs over distributed shared memory and merges them (a key's place:
// its place in its run plus the keys below it in the others).  Then
// merge_fold: buffer slot i goes to rank i + #{candidates below it}, the
// s-th candidate to s + #{buffer slots at or below it}, ranks below k
// written; the rank rule's ranks, so the same buffer bit for bit.  The
// buffer lives in one of two layouts (the wrapper picks by k):
//   whole: every CTA holds the buffer and folds it alike, so all take the
//     same stop with one cluster barrier a round;
//   spread: CTA c holds the slots [c S, (c + 1) S), S = ceil(k / C), and
//     folds its own slots and the candidates whose place falls in its
//     slice, writing each rank to the CTA that holds it; a second cluster
//     barrier ends the fold and every CTA reads the new k-th best from the
//     last slice.  A k whose double buffer (16 k bytes) outgrows one CTA
//     thus runs on a cluster.
// Candidates, runs and buffers are double-buffered by round parity or by
// the barriers, so no CTA overwrites what another still reads.
//
// Routes (the wrappers pick one from the shapes before any launch).
// refine_topk: the ring kernel above, or, where a row is not whole 16-byte
// pieces or the fixed parts and two one-row stages outgrow shared memory
// even at one CTA an SM, refine_general: a CTA a query row, its alive
// leaves staged through shared memory by 16-byte copies, rows read in the
// widest pieces their length allows (group_d2), one fold of the round by
// selection and merge over all K * M candidates, its lists in shared
// memory where they fit, else in global scratch.
// refine_search:
// search_kernel with the buffer whole (cta3 / cta2 / cta1: shared memory
// laid out for 3, 2 or 1 CTAs an SM) or spread (spread3 / spread2 /
// spread1; the first choice from k 1,536, refine_search.py's SPREAD_K),
// at the most CTAs an SM whose ring stages hold 16 leaf rows;
// or, where a row is not whole 16-byte pieces or neither layout fits
// even at one CTA an SM, search_general: one CTA a query, rows read where
// they lie in the same pieces, distances, keys and buffers in global
// scratch, the same
// sort_keys and merge_fold.  The general routes sum a row by one function
// (group_d2, a warp or fewer lanes a row, the same bits), so their two
// loops agree bit for bit with each other; the fast routes share
// warp_d2.

#include <algorithm>
#include <mutex>
#include <tuple>
#include <type_traits>
#include <vector>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

constexpr int kUnroll = 4;           // rows a warp reduces at once

// d^2 of the rows r1, r1 + kWarps, ... (kUnroll of them, those below n)
// of the rows at `rows`, each reduced by this warp: a lane sums q.x over
// its 16-byte pieces lane, lane + 32, ... in order, the warp adds the
// lanes by xor-shuffles, and lane 0 writes d^2 = max((q_sq + |x|^2) -
// 2 q.x, 0), rounded step by step as the plain version writes it, to
// out[r] (xn[r] holds |x|^2).  Both kernels take their distances from
// here, so they agree bit for bit.  Returns lane 0's least d^2.
template <typename T>
__device__ __forceinline__ float warp_d2(const T* rows, int L, int r1, int n,
                                         const float* q_s, float qsq,
                                         const float* xn, float* out,
                                         int lane) {
  constexpr int kVec = 16 / sizeof(T);           // values per 16-byte load
  const uint4* x = reinterpret_cast<const uint4*>(rows);
  float dot[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) dot[u] = 0.f;
  for (int c = lane; c < L / kVec; c += 32) {
    const float4* qv = reinterpret_cast<const float4*>(q_s + c * kVec);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r1 + u * kWarps >= n) break;
      const uint4 raw = x[(size_t)(r1 + u * kWarps) * (L / kVec) + c];
      const T* t = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < kVec / 4; ++i) {
        const float4 qq = qv[i];
        dot[u] += to_f32(t[4 * i]) * qq.x;
        dot[u] += to_f32(t[4 * i + 1]) * qq.y;
        dot[u] += to_f32(t[4 * i + 2]) * qq.z;
        dot[u] += to_f32(t[4 * i + 3]) * qq.w;
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      dot[u] += __shfl_xor_sync(0xffffffffu, dot[u], off);
  float least = 1e30f;
  if (lane == 0) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = r1 + u * kWarps;
      if (r >= n) break;
      const float s = __fadd_rn(qsq, xn[r]);
      out[r] = fmaxf(__fsub_rn(s, __fmul_rn(2.f, dot[u])), 0.f);
      least = fminf(least, out[r]);
    }
  }
  return least;
}

// The k smallest of the union [buffer (bd, be: k), candidates (cd, ce:
// n)] into nd, ne, by the rank rule above; the block's threads share the
// union's elements.
__device__ __forceinline__ void fold(const float* bd, const int* be,
                                     const float* cd, const int* ce, int k,
                                     int n, float* nd, int* ne, int tid) {
  const int U = k + n;
  for (int e = tid; e < U; e += kThreads) {
    const float de = e < k ? bd[e] : cd[e - k];
    int rank = 0;
    for (int f = 0; f < U; ++f) {
      const float df = f < k ? bd[f] : cd[f - k];
      rank += (df < de) | ((df == de) & (f < e));
    }
    if (rank < k) {
      nd[rank] = de;
      ne[rank] = e < k ? be[e] : ce[e - k];
    }
  }
}

// The bytes a general route reads a row's values in: the largest power
// of two, at most 16, dividing the row's bytes (L * sizeof(T)), so that
// on a 16-byte aligned base every row starts on a piece: 8 for bf16 rows
// of 100 (200 bytes), 4 for f32 rows of 235 (940 bytes).
template <typename T>
__host__ __device__ inline int piece_bytes(int L) {
  const int b = L * (int)sizeof(T);
  const int w = b & -b;
  return w < 16 ? w : 16;
}

// Value i of a piece read as 32-bit words (values in memory order, the
// low half of a word first for 16-bit types).
template <typename T>
__device__ __forceinline__ float piece_value(const uint32_t* w, int i) {
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(w[i]);
  } else {
    const unsigned short u =
        (unsigned short)((w[i / 2] >> (16 * (i % 2))) & 0xffffu);
    if constexpr (std::is_same<T, __half>::value)
      return __half2float(__ushort_as_half(u));
    else
      return __bfloat162float(__ushort_as_bfloat16(u));
  }
}

// q's values of piece p of a row read in pieces of kV values, as one load
// where kV is 2 or a multiple of 4 (W divides L * sizeof(T), so kV divides
// L and a 16-byte aligned q's row offset).
template <int kV>
__device__ __forceinline__ void piece_q(const float* q, int p,
                                        float (&qv)[kV]) {
  if constexpr (kV % 4 == 0) {
#pragma unroll
    for (int i = 0; i < kV; i += 4) {
      const float4 f = *reinterpret_cast<const float4*>(q + p * kV + i);
      qv[i] = f.x; qv[i + 1] = f.y; qv[i + 2] = f.z; qv[i + 3] = f.w;
    }
  } else if constexpr (kV == 2) {
    const float2 f = *reinterpret_cast<const float2*>(q + p * kV);
    qv[0] = f.x; qv[1] = f.y;
  } else {
    qv[0] = q[p];
  }
}

// dot + q.x over piece p of the row at x (an address aligned to W), one
// fused multiply-add a value, in order: the one sum step both general
// routes share.
template <typename T, int W>
__device__ __forceinline__ float piece_dot(const uint8_t* x, int p,
                                           const float (&qv)[W / sizeof(T)],
                                           float dot) {
  constexpr int kV = W / (int)sizeof(T);
  uint32_t w[W >= 4 ? W / 4 : 1];
  if constexpr (W == 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(x + 16 * p);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else if constexpr (W == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(x + 8 * p);
    w[0] = v.x; w[1] = v.y;
  } else if constexpr (W == 4) {
    w[0] = *reinterpret_cast<const uint32_t*>(x + 4 * p);
  } else {
    w[0] = *reinterpret_cast<const unsigned short*>(x + 2 * p);
  }
#pragma unroll
  for (int i = 0; i < kV; ++i) dot = __fmaf_rn(piece_value<T>(w, i), qv[i], dot);
  return dot;
}

// A lane's own slots added as a warp's xor-shuffles at distances H, H / 2,
// ..., 1 add them: d[s] += d[s + H] for s < H, then H / 2, ...  By
// template, so that every index is a constant and d stays in registers.
template <int H, int N>
__device__ __forceinline__ void add_slots(float (&d)[N]) {
  if constexpr (H > 0) {
#pragma unroll
    for (int s = 0; s < H; ++s) d[s] += d[s + H];
    add_slots<H / 2>(d);
  }
}

// d^2 of one row (at an address aligned to W, in global or shared
// memory, read in pieces of W bytes) by G lanes (G a power of two
// dividing 32, lane g of an aligned group of G).  The order is a warp's
// (G 32): lane s sums q.x over the values of pieces s, s + 32, ... in
// order, each piece's values in order (piece_dot), and the warp adds the
// lanes by xor-shuffles at distances 16, 8, ..., 1.  With G lanes the
// warp's lane s becomes slot s of lane s % G: lane g sums the pieces of
// slots g, g + G, ..., adds its own slots as the shuffles at distances 16
// .. G would, then the group shuffles at G / 2 .. 1.  The group's lane 0
// takes d^2 = max((q_sq + |x|^2) - 2 q.x, 0), rounded step by step as
// warp_d2 rounds it: the same bits at every G.  G 1 is a thread a row
// (no shuffles, 32 sums in flight).  Every lane of the warp calls it with
// the same L.
template <typename T, int W, int G>
__device__ __forceinline__ float group_d2(const T* row, int L,
                                          const float* q, float qsq,
                                          float xn, int g) {
  constexpr int kV = W / (int)sizeof(T);
  constexpr int kSlots = 32 / G;
  const int np = L / kV;
  const uint8_t* x = reinterpret_cast<const uint8_t*>(row);
  float dot[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) dot[s] = 0.f;
#pragma unroll 1   // unrolled, search_general<bf16> spilled (ptxas)
  for (int p0 = 0; p0 < np; p0 += 32) {
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int p = p0 + g + G * s;
      if (p < np) {
        float qv[kV];
        piece_q<kV>(q, p, qv);
        dot[s] = piece_dot<T, W>(x, p, qv, dot[s]);
      }
    }
  }
  add_slots<kSlots / 2>(dot);
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    dot[0] += __shfl_xor_sync(0xffffffffu, dot[0], off);
  return fmaxf(__fsub_rn(__fadd_rn(qsq, xn), __fmul_rn(2.f, dot[0])), 0.f);
}

// d^2 of one row by a warp (group_d2 at G 32 and the row's piece width,
// piece_bytes<T>(L)), valid in lane 0: search_general's distances.
template <typename T>
__device__ __forceinline__ float row_d2(const T* row, int L, const float* q,
                                        float qsq, float xn, int lane) {
  switch (piece_bytes<T>(L)) {
    case 16: return group_d2<T, 16, 32>(row, L, q, qsq, xn, lane);
    case 8: return group_d2<T, 8, 32>(row, L, q, qsq, xn, lane);
    case 4: return group_d2<T, 4, 32>(row, L, q, qsq, xn, lane);
    default: return group_d2<T, (int)sizeof(T), 32>(row, L, q, qsq, xn, lane);
  }
}

namespace search {

namespace cg = cooperative_groups;

// C = 8 CTAs a query (cut to the largest power of two dividing K), shared
// memory sized for 3 CTAs an SM: the fastest of C in {1, 2, 4, 8} and 1 to 3
// CTAs an SM on the main cell of chip_smoke.py (PERF.md).
constexpr int kCluster = 8;
constexpr int kBlocksPerSM = 3;
constexpr int kMaxStages = 4;
constexpr int kInfo = 4;             // rounds of queue entries in smem
constexpr int kMisc = 4;             // ints: query, counts by parity
constexpr int kSmemMax = 232448;     // what a block may take on sm_90
constexpr int kSmemSM = 233472;      // an SM's, 1 KB of it per block kept
constexpr float kBig = 1e30f;

// A candidate of a fold as one 64-bit key: its distance's bits on top
// (-0.0 as +0.0, so that the unsigned order of the bits is the float order
// of distances >= 0), then its union index u = slot * M + row, then the
// sign of a -0.0.  Keys are distinct and order as (d, u): the rank rule's
// order among candidates.  key_d gives the distance's own bits back.
__device__ __forceinline__ uint32_t dist_bits(float d) {
  const uint32_t b = __float_as_uint(d);
  return b == 0x80000000u ? 0u : b;
}
__device__ __forceinline__ uint64_t cand_key(float d, int u) {
  return ((uint64_t)dist_bits(d) << 32) | ((uint32_t)u << 1) |
         (__float_as_uint(d) >> 31);
}
__device__ __forceinline__ float key_d(uint64_t x) {
  return (x & 1) ? -0.f : __uint_as_float((uint32_t)(x >> 32));
}
__device__ __forceinline__ int key_u(uint64_t x) {
  return (int)((uint32_t)x >> 1);
}

// #{sorted keys a[0 .. n) below x}
__device__ __forceinline__ int keys_before(const uint64_t* a, int n,
                                           uint64_t x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// #{ascending floats b[0 .. n) at or below d}
__device__ __forceinline__ int floats_upto(const float* b, int n, float d) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (b[mid] <= d) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__host__ __device__ inline int pow2_at_least(int n) {
  int P = 1;
  while (P < n) P <<= 1;
  return P;
}

// Sorts the n distinct keys at a ascending, in place (a has room for the
// next power of two above n): up to kThreads by rank (a thread a key),
// above by a bitonic network.  Every thread calls it, after a barrier
// that completes a; it ends on one.  sort_keys_inline is the same code,
// inlined where it is called (the general kernels: a call there made
// ptxas spill around it).
__device__ __forceinline__ void sort_keys_inline(uint64_t* a, int n,
                                                 int tid) {
  if (n <= 1) return;
  if (n <= kThreads) {
    const uint64_t x = tid < n ? a[tid] : 0ull;
    int r = 0;
    if (tid < n)
      for (int f = 0; f < n; ++f) r += a[f] < x;
    __syncthreads();
    if (tid < n) a[r] = x;
    __syncthreads();
    return;
  }
  const int P = pow2_at_least(n);
  for (int i = n + tid; i < P; i += kThreads) a[i] = ~0ull;
  __syncthreads();
  for (int size = 2; size <= P; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = tid; t < P / 2; t += kThreads) {
        const int i = 2 * t - (t & (stride - 1)), j = i + stride;
        const uint64_t x = a[i], y = a[j];
        if ((x > y) == ((i & size) == 0)) {
          a[i] = y;
          a[j] = x;
        }
      }
      __syncthreads();
    }
}

__device__ void sort_keys(uint64_t* a, int n, int tid) {
  sort_keys_inline(a, n, tid);
}

// The fold by merge: the ascending buffer, spread in slices of S slots over
// CB CTAs (this CTA's, number br, the slots [i0, i0 + nb) at bd / be), and
// the n candidates below the k-th best, sorted as keys at gs (at most k of
// them: a later one has k candidates before it).  Buffer slot i goes to
// rank i + #{candidates below it}; the s-th candidate to rank s + #{buffer
// slots at or below it}, computed by the CTA whose slice holds the last of
// those slots (first[c]: slice c's first distance, INFINITY if it is
// empty; the first CTA if none is).  These are the rank rule's ranks,
// buffer slots before candidates at a tie, so put(p, d, e) receives each
// rank p < k once, from one CTA.  leaf_r: the round's leaves by slot.
template <typename Put>
__device__ __forceinline__ void merge_fold(
    const float* bd, const int* be, int i0, int nb, const uint64_t* gs,
    int n, const float* first, int CB, int br, const int* leaf_r, int M,
    int k, Put put, int tid) {
  for (int t = tid; t < nb; t += kThreads) {
    const float d = bd[t];
    const int p = i0 + t + keys_before(gs, n, (uint64_t)dist_bits(d) << 32);
    if (p < k) put(p, d, be[t]);
  }
  for (int s = tid; s < n; s += kThreads) {
    const uint64_t x = gs[s];
    const float d = key_d(x);
    if (CB > 1 && ((br > 0 && !(first[br] <= d)) ||
                   (br + 1 < CB && first[br + 1] <= d)))
      continue;                 // another CTA's slice takes it
    const int p = s + i0 + floats_upto(bd, nb, d);
    if (p < k) {
      const int u = key_u(x);
      put(p, d, leaf_r[u / M] * M + u % M);
    }
  }
}

// Lists the candidates below the k-th best among the n distances at cand
// (element e: slot slot_of(e), union index union_of(e)) as keys at out,
// counting them into *count (0 on entry).  Warp by warp in any order: the
// keys are sorted afterwards.
template <typename Alive, typename Union>
__device__ __forceinline__ void list_passing(const float* cand, int n,
                                             float kth, Alive alive,
                                             Union union_of, uint64_t* out,
                                             int* count, int tid) {
  const int lane = tid & 31;
  for (int e0 = 0; e0 < n; e0 += kThreads) {
    const int e = e0 + tid;
    bool ok = false;
    float d = 0.f;
    if (e < n && alive(e)) {
      d = cand[e];
      ok = d < kth;
    }
    const unsigned b = __ballot_sync(0xffffffffu, ok);
    int at = 0;
    if (lane == 0 && b) at = atomicAdd(count, __popc(b));
    at = __shfl_sync(0xffffffffu, at, 0);
    if (ok)
      out[at + __popc(b & ((1u << lane) - 1))] = cand_key(d, union_of(e));
  }
}

struct Params {
  const float* q;
  const float* q_sq;
  const void* series;
  const float* sq_norms;
  const int* order;
  const float* sorted_lb;
  float* out_d;
  int* out_e;
  int* rounds;
  int* alive;
  int* next_query;
  const int* schedule;   // the order in which queries are taken
  int Q, L, K, M, k, cols;
  float inv_eps;    // the stop rule's scale: a slot is alive while its
                    // lower bound is below kth * inv_eps (1.0f: exact)
  int J;            // own slots a round: K / C
  int spread;       // the buffer in slices over the cluster (else whole
                    // in every CTA)
  int S;            // buffer slots a CTA holds: ceil(k / C) spread, else k
  int P;            // keys a parity of the own candidates has room for
  int rows;         // leaf rows a stage holds
  int chunks;       // stages a leaf takes: ceil(M / rows)
  int stages;
  uint32_t stage_bytes, norm_off;
  uint32_t off_bar, off_misc, off_first, off_q, off_cand, off_keys, off_g,
      off_gs, off_bd, off_be, off_nd, off_ne, off_lb, off_leaf, off_ring;
};

// Registers for kBlocksPerSM CTAs an SM (80 a thread): unbounded, the
// fold's code took 128, which left the cta3 layout 2 CTAs an SM and the
// main cell 12 % slower (PERF.md).
template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
search_kernel(const Params p) {
  extern __shared__ __align__(128) uint8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* series = static_cast<const T*>(p.series);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + p.off_bar);
  // [0] the query, [1 + parity] own passing candidates
  int* misc = reinterpret_cast<int*>(smem + p.off_misc);
  float* first = reinterpret_cast<float*>(smem + p.off_first);  // [C]
  float* q_s = reinterpret_cast<float*>(smem + p.off_q);
  float* cand = reinterpret_cast<float*>(smem + p.off_cand);   // [J][M]
  // own passing candidates by round parity, sorted: the CTA's run
  uint64_t* keys = reinterpret_cast<uint64_t*>(smem + p.off_keys);
  uint64_t* gk = reinterpret_cast<uint64_t*>(smem + p.off_g);   // runs
  uint64_t* gs = reinterpret_cast<uint64_t*>(smem + p.off_gs);  // merged
  float* bd = reinterpret_cast<float*>(smem + p.off_bd);
  int* be = reinterpret_cast<int*>(smem + p.off_be);
  float* nd = reinterpret_cast<float*>(smem + p.off_nd);
  int* ne = reinterpret_cast<int*>(smem + p.off_ne);
  // the queue entries of rounds r .. r + kInfo - 1, round i at i % kInfo
  float* s_lb = reinterpret_cast<float*>(smem + p.off_lb);
  int* s_leaf = reinterpret_cast<int*>(smem + p.off_leaf);
  uint8_t* ring = smem + p.off_ring;
  // the buffer's slices: CB of them, this CTA's the br-th
  const int CB = p.spread ? C : 1, br = p.spread ? rank : 0;
  const int i0 = br * p.S, nb = max(0, min(p.S, p.k - i0));
  const int JM = p.J * p.M;

  if (tid == 0) {
    for (int i = 0; i < p.stages; ++i) sm90::mbar_init(&bar[i], 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();

  // rank pos < k of the new buffer to the CTA that holds it
  auto put = [&](int pos, float d, int e) {
    const int o = pos / p.S, at = pos - o * p.S;
    float* td = nd;
    int* te = ne;
    if (o != br) {
      td = cluster.map_shared_rank(nd, o);
      te = cluster.map_shared_rank(ne, o);
    }
    td[at] = d;
    te[at] = e;
  };

  const int cap = p.cols / p.K;
  const long long own_chunks = (long long)cap * p.J * p.chunks;
  long long fetched = 0;        // copies of earlier queries, all completed
  for (;;) {
    if (rank == 0 && tid == 0) {
      const int t = atomicAdd(p.next_query, 1);
      misc[0] = t < p.Q ? p.schedule[t] : p.Q;
    }
    cluster.sync();
    const int qi = *cluster.map_shared_rank(misc, 0);
    cluster.sync();             // read by all: rank 0 may move on
    if (qi >= p.Q) break;

    const float* lbrow = p.sorted_lb + (long long)qi * p.cols;
    const int* idrow = p.order + (long long)qi * p.cols;
    for (int i = tid; i < p.L; i += kThreads)
      q_s[i] = p.q[(long long)qi * p.L + i];
    for (int i = tid; i < nb; i += kThreads) {
      bd[i] = kBig;
      be[i] = 0;
    }
    for (int i = tid; i < kInfo * p.K; i += kThreads) {
      s_lb[i] = i < p.cols ? lbrow[i] : kBig;
      s_leaf[i] = i < p.cols ? idrow[i] : 0;
    }
    const float qsq = p.q_sq[qi];
    __syncthreads();

    float kth = kBig;           // the buffer's k-th best, in every thread
    // what a lower bound is tested against: kth * inv_eps, the float32
    // product repro forms (bsf_d[:, -1] * inv_eps); non-increasing as kth
    float bound = kth * p.inv_eps;
    long long issued = 0;       // own chunks issued: always a prefix
    bool dead = false;          // an own slot was dead when reached
    // Issue the own chunks before `upto` while their slot's lower bound
    // is below the bound of the moment; the first dead slot ends it.
    auto produce = [&](long long upto) {
      if (upto > own_chunks) upto = own_chunks;
      while (!dead && issued < upto) {
        const int s = (int)(issued / p.chunks), c = (int)(issued % p.chunks);
        // within kInfo rounds of the consumer's: upto <= its chunk + stages
        const int at = (s / p.J) % kInfo * p.K + rank + C * (s % p.J);
        if (c == 0 && !(s_lb[at] < bound)) {
          dead = true;
          break;
        }
        if (tid == 0) {
          const long long g = fetched + issued;
          uint64_t* b = &bar[g % p.stages];
          uint8_t* dst = ring + (size_t)(g % p.stages) * p.stage_bytes;
          const int r0 = c * p.rows, nr = min(p.rows, p.M - r0);
          const long long row0 = (long long)s_leaf[at] * p.M + r0;
          // the norms as a 16-byte aligned window around the rows'
          const long long w0 = row0 & ~3ll, w1 = (row0 + nr + 3) & ~3ll;
          const uint32_t xb = (uint32_t)(nr * p.L * sizeof(T));
          const uint32_t wb = (uint32_t)((w1 - w0) * 4);
          sm90::mbar_expect_tx(b, xb + wb);
          sm90::bulk_load(dst, series + row0 * p.L, xb, b);
          sm90::bulk_load(dst + p.norm_off, p.sq_norms + w0, wb, b);
        }
        ++issued;
      }
    };

    int r = 0, n_alive = 0;
    while (r < cap && s_lb[r % kInfo * p.K] < bound) {
      const int par = r & 1;
      const float* lb_r = s_lb + r % kInfo * p.K;
      const int* leaf_r = s_leaf + r % kInfo * p.K;
      uint64_t* own = keys + par * p.P;
      if (tid == 0) {
        for (int j = 0; j < p.K; ++j) n_alive += lb_r[j] < bound;
        // read by the others two barriers ago at the latest
        misc[1 + par] = 0;
      }
      // round r + kInfo's entry of slot tid, read meanwhile (any slots
      // past kThreads are read when they are stored)
      float nlb = kBig;
      int nid = 0;
      if (tid < p.K && r + kInfo < cap) {
        nlb = lbrow[(long long)(r + kInfo) * p.K + tid];
        nid = idrow[(long long)(r + kInfo) * p.K + tid];
      }
      if (tid == 0 && r + 16 < cap) {   // the queue's lines, ahead, in L2
        sm90::prefetch_l2(lbrow + (long long)(r + 16) * p.K);
        sm90::prefetch_l2(idrow + (long long)(r + 16) * p.K);
      }
      __syncthreads();

      for (int pp = 0; pp < p.J; ++pp) {
        const int j = rank + C * pp;
        const bool alive = lb_r[j] < bound;
        const long long first_row = (long long)leaf_r[j] * p.M;
        const long long s = (long long)r * p.J + pp;
        for (int c = 0; c < p.chunks; ++c) {
          const long long g = s * p.chunks + c;
          produce(g + p.stages);
          if (g < issued) {     // wait for it even if it died meanwhile
            const long long gg = fetched + g;
            sm90::mbar_wait(&bar[gg % p.stages],
                            (uint32_t)((gg / p.stages) & 1));
            if (alive) {
              const uint8_t* st =
                  ring + (size_t)(gg % p.stages) * p.stage_bytes;
              const int r0 = c * p.rows, nr = min(p.rows, p.M - r0);
              const float* xn = reinterpret_cast<const float*>(st + p.norm_off)
                                + ((first_row + r0) & 3);
              for (int r1 = warp; r1 < nr; r1 += kUnroll * kWarps)
                warp_d2<T>(reinterpret_cast<const T*>(st), p.L, r1, nr, q_s,
                           qsq, xn, cand + pp * p.M + r0, lane);
            }
          } else if (alive) {
            __trap();           // an alive slot is always issued
          }
          __syncthreads();      // the stage is free, the distances written
        }
      }

      // the own candidates below the k-th best, sorted: this CTA's run
      list_passing(
          cand, JM, kth,
          [&](int e) { return lb_r[rank + C * (e / p.M)] < bound; },
          [&](int e) { return (rank + C * (e / p.M)) * p.M + e % p.M; },
          own, &misc[1 + par], tid);
      __syncthreads();
      sort_keys(own, misc[1 + par], tid);
      cluster.sync();           // every CTA's run of round r is in
      // the runs' offsets in the gathered list, in every thread (lane c
      // reads run c's count, the warp scans them): a run's first k keys
      // (a later one has k candidates before it)
      int off[kCluster + 1];
      {
        int n = lane < C
                    ? min(*cluster.map_shared_rank(&misc[1 + par], lane), p.k)
                    : 0;
#pragma unroll
        for (int d = 1; d < kCluster; d <<= 1) {
          const int v = __shfl_up_sync(0xffffffffu, n, d);
          if (lane >= d) n += v;
        }
        off[0] = 0;
#pragma unroll
        for (int c = 0; c < kCluster; ++c)
          off[c + 1] = __shfl_sync(0xffffffffu, n, c);
      }
      const int tot = off[kCluster];   // the same in every CTA
      if (tot > 0) {
        if (CB > 1 && tid < C)
          first[tid] = min(p.S, p.k - tid * p.S) > 0
                           ? *cluster.map_shared_rank(bd, tid) : INFINITY;
        // the run of gathered key g, and where it starts
        auto run_of = [&](int g, int& start) {
          int c = 0;
          start = 0;
#pragma unroll
          for (int i = 1; i < kCluster; ++i)
            if (i < C && g >= off[i]) {
              c = i;
              start = off[i];
            }
          return c;
        };
        for (int g = tid; g < tot; g += kThreads) {
          int start = 0;
          const int c = run_of(g, start);
          gk[g] = cluster.map_shared_rank(own, c)[g - start];
        }
        __syncthreads();
        // the runs merged: a key's place is its place in its run plus the
        // keys below it in the others
        for (int g = tid; g < tot; g += kThreads) {
          int start = 0;
          const int c = run_of(g, start);
          const uint64_t x = gk[g];
          int at = g - start;
#pragma unroll
          for (int c2 = 0; c2 < kCluster; ++c2)
            if (c2 < C && c2 != c)
              at += keys_before(gk + off[c2], off[c2 + 1] - off[c2], x);
          gs[at] = x;
        }
        __syncthreads();
        merge_fold(bd, be, i0, nb, gs, min(tot, p.k), first, CB, br, leaf_r,
                   p.M, p.k, put, tid);
        if (CB > 1) cluster.sync(); else __syncthreads();
        float* td = bd; bd = nd; nd = td;   // every thread swaps alike
        int* te = be; be = ne; ne = te;
        const int o = (p.k - 1) / p.S, at = p.k - 1 - o * p.S;
        kth = o == br ? bd[at] : cluster.map_shared_rank(bd, o)[at];
        bound = kth * p.inv_eps;
      }
      __syncthreads();          // this round's entries are read
      for (int j = tid; j < p.K; j += kThreads) {
        const long long at = (long long)(r + kInfo) * p.K + j;
        const bool more = r + kInfo < cap;
        s_lb[r % kInfo * p.K + j] = j == tid ? nlb : more ? lbrow[at] : kBig;
        s_leaf[r % kInfo * p.K + j] = j == tid ? nid : more ? idrow[at] : 0;
      }
      __syncthreads();
      ++r;
    }

    // copies issued past the stop land before their stages are reused
    const long long used = min(issued, (long long)r * p.J * p.chunks);
    for (long long g = used; g < issued; ++g) {
      const long long gg = fetched + g;
      sm90::mbar_wait(&bar[gg % p.stages], (uint32_t)((gg / p.stages) & 1));
    }
    fetched += issued;
    if (CB > 1 || rank == 0)
      for (int i = tid; i < nb; i += kThreads) {
        p.out_d[(long long)qi * p.k + i0 + i] = bd[i];
        p.out_e[(long long)qi * p.k + i0 + i] = be[i];
      }
    if (rank == 0 && tid == 0) {
      p.rounds[qi] = r;
      p.alive[qi] = n_alive;
    }
    __syncthreads();
  }
}

inline uint32_t take(uint32_t& off, uint32_t bytes, uint32_t align) {
  off = (off + align - 1) / align * align;
  const uint32_t at = off;
  off += bytes;
  return at;
}

// The ring of a layout (refine_search's or refine_topk's), after its fixed
// parts at p.off_ring: stages of p.rows leaf rows of p.L values of `elem`
// bytes and their norms' window (rows + 6 floats at most), as many as fit
// beside `blocks` - 1 other CTAs on the SM, up to kMaxStages; a leaf that
// leaves no room for two stages is cut into chunks of p.rows rows.  Sets
// the ring's fields and *smem, the layout's bytes.
template <typename P>
inline cudaError_t place_ring(P& p, int blocks, int elem, size_t* smem) {
  const long long row_bytes = (long long)p.L * elem;
  const long long room =
      (long long)std::min(kSmemMax, kSmemSM / blocks - 1024) - p.off_ring;
  auto stage = [&](long long rows) {
    return rows * row_bytes + (rows + 9) / 4 * 16;
  };
  long long rows = p.M;
  while (rows > 1 && 2 * stage(rows) > room) rows = (rows + 1) / 2;
  if (room < 0 || 2 * stage(rows) > room) return cudaErrorInvalidValue;
  p.rows = (int)rows;
  p.chunks = (int)((p.M + rows - 1) / rows);
  p.stages = (int)std::min<long long>(kMaxStages, room / stage(rows));
  p.stage_bytes = (uint32_t)stage(rows);
  p.norm_off = (uint32_t)(rows * row_bytes);
  *smem = p.off_ring + (size_t)p.stages * p.stage_bytes;
  return cudaSuccess;
}

// Shared memory: the fixed parts, then place_ring's ring.  The runs of
// the C CTAs take at most min(K M, C min(J M, k)) keys together.
inline cudaError_t layout(Params& p, int C, int blocks, bool spread,
                          int elem, size_t* smem) {
  p.J = p.K / C;
  const long long JM = (long long)p.J * p.M;
  if ((long long)p.K * p.M >= (1ll << 30)) return cudaErrorInvalidValue;
  p.spread = spread;
  p.S = spread ? (p.k + C - 1) / C : p.k;
  p.P = pow2_at_least((int)JM);
  const long long runs = std::min<long long>(
      (long long)p.K * p.M, C * std::min<long long>(JM, p.k));
  if (16ll * p.P + 16 * runs + 16ll * p.S > kSmemMax)
    return cudaErrorInvalidValue;
  uint32_t off = 0;
  p.off_bar = take(off, 8 * kMaxStages, 8);
  p.off_misc = take(off, 4 * kMisc, 16);
  p.off_first = take(off, 4 * kCluster, 4);
  p.off_q = take(off, 4u * p.L, 16);
  p.off_cand = take(off, 4u * (uint32_t)JM, 16);
  p.off_keys = take(off, 16u * p.P, 16);
  p.off_g = take(off, 8u * (uint32_t)runs, 16);
  p.off_gs = take(off, 8u * (uint32_t)runs, 16);
  p.off_bd = take(off, 4u * p.S, 4);
  p.off_be = take(off, 4u * p.S, 4);
  p.off_nd = take(off, 4u * p.S, 4);
  p.off_ne = take(off, 4u * p.S, 4);
  p.off_lb = take(off, 4u * kInfo * p.K, 4);
  p.off_leaf = take(off, 4u * kInfo * p.K, 4);
  p.off_ring = take(off, 0, 128);
  return place_ring(p, blocks, elem, smem);
}

template <typename T>
cudaError_t launch(Params p, int C, int blocks, bool spread,
                   cudaStream_t stream) {
  size_t smem = 0;
  cudaError_t err = layout(p, C, blocks, spread, (int)sizeof(T), &smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(search_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, search_kernel<T>, &cfg);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  cfg.gridDim = dim3(C * std::min(clusters, p.Q));
  err = cudaLaunchKernelEx(&cfg, search_kernel<T>, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// Words of global scratch a CTA of the general route takes: the
// distances (K M, rounded up to an even count), the passing candidates'
// keys (2 words each, room for the power of two at or above K M) and both
// buffers (4 k); even, so that every CTA's keys stay 8-byte aligned.
inline long long general_words(int K, int M, int k) {
  const long long KM = (long long)K * M;
  long long P = 1;
  while (P < KM) P <<= 1;
  return (KM + 1) / 2 * 2 + 2 * P + (4 * (long long)k + 1) / 2 * 2;
}

// The general route: one CTA a query (no cluster), any L, alignment, k
// and K * M.  Rows are read from device memory where they lie, a warp a
// row, in the widest pieces their length allows (row_d2), and the
// distances, the passing candidates' keys and both buffers live in
// global scratch, `per` words a CTA; so shared memory bounds nothing.  A round runs as in search_kernel: every alive slot's
// distances, then, if one is below the k-th best, the passing candidates
// sorted as keys (sort_keys) and folded by merge_fold into the buffer,
// which stays ascending.  The rounds, the alive count and the buffer
// follow the rule of the fast routes and of refine_search_ref.
template <typename T>
__global__ void __launch_bounds__(kThreads) search_general(const Params p,
                                                           float* scratch,
                                                           long long per) {
  __shared__ int misc[2];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* series = static_cast<const T*>(p.series);
  const int KM = p.K * p.M;
  float* cand = scratch + (long long)blockIdx.x * per;     // K * M
  uint64_t* keys = reinterpret_cast<uint64_t*>(cand + (KM + 1) / 2 * 2);
  float* bd = reinterpret_cast<float*>(keys + pow2_at_least(KM));
  int* be = reinterpret_cast<int*>(bd + p.k);
  float* nd = bd + 2 * p.k;
  int* ne = reinterpret_cast<int*>(bd + 3 * p.k);
  const int cap = p.cols / p.K;

  for (;;) {
    if (tid == 0) {
      const int t = atomicAdd(p.next_query, 1);
      misc[0] = t < p.Q ? p.schedule[t] : p.Q;
    }
    __syncthreads();
    const int qi = misc[0];
    if (qi >= p.Q) break;
    const float* lbrow = p.sorted_lb + (long long)qi * p.cols;
    const int* idrow = p.order + (long long)qi * p.cols;
    const float* qr = p.q + (long long)qi * p.L;
    for (int i = tid; i < p.k; i += kThreads) {
      bd[i] = kBig;
      be[i] = 0;
    }
    const float qsq = p.q_sq[qi];
    __syncthreads();

    float kth = kBig, bound = kth * p.inv_eps;   // as in search_kernel
    int r = 0, n_alive = 0;
    while (r < cap && lbrow[(long long)r * p.K] < bound) {
      const float* lb_r = lbrow + (long long)r * p.K;
      const int* leaf_r = idrow + (long long)r * p.K;
      if (tid == 0) {
        for (int j = 0; j < p.K; ++j) n_alive += lb_r[j] < bound;
        misc[1] = 0;
      }
      bool any = false;
      for (int e = warp; e < KM; e += kWarps) {
        const int j = e / p.M;
        if (!(lb_r[j] < bound)) continue;        // uniform over the warp
        const long long x = (long long)leaf_r[j] * p.M + e % p.M;
        const float d = row_d2<T>(series + x * p.L, p.L, qr, qsq,
                                  p.sq_norms[x], lane);
        if (lane == 0) {
          cand[e] = d;
          any |= d < kth;
        }
      }
      if (__syncthreads_or(any)) {
        list_passing(
            cand, KM, kth, [&](int e) { return lb_r[e / p.M] < bound; },
            [](int e) { return e; }, keys, &misc[1], tid);
        __syncthreads();
        const int n = misc[1];
        sort_keys_inline(keys, n, tid);
        merge_fold(bd, be, 0, p.k, keys, min(n, p.k), nullptr, 1, 0, leaf_r,
                   p.M, p.k,
                   [&](int pos, float d, int e) {
                     nd[pos] = d;
                     ne[pos] = e;
                   },
                   tid);
        __syncthreads();
        float* td = bd; bd = nd; nd = td;   // every thread swaps alike
        int* te = be; be = ne; ne = te;
        kth = bd[p.k - 1];
        bound = kth * p.inv_eps;
      }
      __syncthreads();
      ++r;
    }

    for (int i = tid; i < p.k; i += kThreads) {
      p.out_d[(long long)qi * p.k + i] = bd[i];
      p.out_e[(long long)qi * p.k + i] = be[i];
    }
    if (tid == 0) {
      p.rounds[qi] = r;
      p.alive[qi] = n_alive;
    }
    __syncthreads();
  }
}

}  // namespace search

// refine_topk's general route: any L, alignment, k, K and M.  One block a
// query row.  Warp 0 lists the row's alive slots.  Where K whole leaves
// fit the room of kGStages stages (`all`: bf16 rows of 100 at K 8), every
// alive leaf is copied at once into a stage of its own and the block
// takes all their rows after one wait; else the leaves stream through
// kGStages stages of shared memory, a leaf in `chunks` pieces of `rows`
// rows, kGStages - 1 pieces ahead.  A piece is one byte range copied by
// 16-byte cp.async over the aligned blocks that cover it, none read past
// its last byte (the rows in the same place modulo 16, so that each row
// keeps the alignment its pieces need; the bytes before the first share
// its block), with the rows' norms beside them.  Staged rows are summed by
// groups of G lanes (group_d2: G = group_lanes, a thread a row where the
// rows outnumber the block's threads), with the bits of search_general's
// warp a row.  A row past a stage (more than kGStageMax bytes) is read
// where it lies, a warp a row (rows = 0).  Then one fold of the round over
// all K * M candidates, as search_general's: the candidates below the
// round's k-th best listed as keys (list_passing), the first k of them in
// order (select_keys: by warps, then among the kept, where k <= 32 and
// at most 512 pass; else sorted), and merged with the buffer
// (merge_fold) into out_d / out_e: the ranks of the rank rule, so the
// buffer of the round folded slot by slot, bit for bit.  The alive slots
// and their leaves, the query row, the distances and the keys live in
// shared memory where they fit in kGInner bytes (`inner`), else in global
// scratch, `per` words a row (general_topk_words).
constexpr int kGStages = 4;
constexpr int kGStageMax = 28 * 1024;    // 4 stages: 2 CTAs an SM
constexpr int kGInner = 48 * 1024;

// The first min(n, k) of the n distinct keys at a, ascending, in place;
// merge_fold reads only that prefix.  Where k <= 32 and n <= 2 kThreads
// (a thread two keys, i and i + kThreads): each warp ranks its 64 keys
// among themselves by shuffles and keeps those of rank below k (at most k
// a warp, at spare[warp k + rank], kWarps * 32 keys of room), then each
// kept key is ranked among the kept, a pass over kWarps k of them, and a
// key of rank below k goes to its place.  Else all n are sorted
// (sort_keys_inline).  Every thread calls it, after a barrier that
// completes a; it ends on one.
__device__ __forceinline__ void select_keys(uint64_t* a, int n, int k,
                                            uint64_t* spare, int tid) {
  if (k > 32 || n > 2 * kThreads) {
    search::sort_keys_inline(a, n, tid);
    return;
  }
  constexpr uint64_t kNone = ~0ull;      // above every key (d >= 0, no NaN)
  const int lane = tid & 31, warp = tid >> 5, t1 = tid + kThreads;
  const uint64_t x0 = tid < n ? a[tid] : kNone, x1 = t1 < n ? a[t1] : kNone;
  int r0 = 0, r1 = 0;
#pragma unroll 8
  for (int src = 0; src < 32; ++src) {
    const uint64_t y0 = __shfl_sync(0xffffffffu, x0, src);
    const uint64_t y1 = __shfl_sync(0xffffffffu, x1, src);
    r0 += (y0 < x0) + (y1 < x0);
    r1 += (y0 < x1) + (y1 < x1);
  }
  uint64_t* mine = spare + warp * k;
  if (lane < k) mine[lane] = kNone;
  __syncwarp();
  if (x0 != kNone && r0 < k) mine[r0] = x0;
  if (x1 != kNone && r1 < k) mine[r1] = x1;
  __syncthreads();
  const int m = kWarps * k;
  const uint64_t x = tid < m ? spare[tid] : kNone;
  if (x != kNone) {
    int r = 0;
#pragma unroll 4
    for (int f = 0; f < m; ++f) r += spare[f] < x;
    if (r < k) a[r] = x;
  }
  __syncthreads();
}

// The lanes a general route gives a staged row: the most of 32, 8, 4 and
// 1 that take `rows` rows at once within the block's threads (1 past
// them: a thread a row, in turns).
__host__ __device__ inline int group_lanes(int rows) {
  return rows * 32 <= kThreads ? 32
         : rows * 8 <= kThreads ? 8
         : rows * 4 <= kThreads ? 4 : 1;
}

// d^2 of n staged rows, G lanes a row (group_d2 at width W), kThreads / G
// rows at a time: at(i, row, xn) gives row i's values and norm, put(i,
// d^2) takes its distance.  Every thread calls it.
template <typename T, int W, int G, typename At, typename Put>
__device__ __forceinline__ void staged_d2_g(int n, int L, const float* q,
                                            float qsq, At at, Put put,
                                            int tid) {
  const int g = tid & (G - 1);
  for (int b = 0; b < n; b += kThreads / G) {     // uniform over the block
    const int i = b + tid / G;
    const T* rw;
    float xn;
    at(i < n ? i : n - 1, rw, xn);
    const float d = group_d2<T, W, G>(rw, L, q, qsq, xn, g);
    if (g == 0 && i < n) put(i, d);
  }
}

template <typename T, int W, typename At, typename Put>
__device__ __forceinline__ void staged_d2_w(int n, int G, int L,
                                            const float* q, float qsq, At at,
                                            Put put, int tid) {
  switch (G) {
    case 32: staged_d2_g<T, W, 32>(n, L, q, qsq, at, put, tid); break;
    case 8: staged_d2_g<T, W, 8>(n, L, q, qsq, at, put, tid); break;
    case 4: staged_d2_g<T, W, 4>(n, L, q, qsq, at, put, tid); break;
    default: staged_d2_g<T, W, 1>(n, L, q, qsq, at, put, tid); break;
  }
}

// staged_d2_g at the row's piece width and G = group_lanes's.
template <typename T, typename At, typename Put>
__device__ __forceinline__ void staged_d2(int n, int G, int L,
                                          const float* q, float qsq, At at,
                                          Put put, int tid) {
  switch (piece_bytes<T>(L)) {
    case 16: staged_d2_w<T, 16>(n, G, L, q, qsq, at, put, tid); break;
    case 8: staged_d2_w<T, 8>(n, G, L, q, qsq, at, put, tid); break;
    case 4: staged_d2_w<T, 4>(n, G, L, q, qsq, at, put, tid); break;
    default:
      staged_d2_w<T, (int)sizeof(T)>(n, G, L, q, qsq, at, put, tid);
      break;
  }
}

// The keys' room: the power of two at or above n, at least 2 (so that
// what follows them in shared memory stays 16-byte aligned).
__host__ __device__ inline long long pow2_ll(long long n) {
  long long P = 2;
  while (P < n) P <<= 1;
  return P;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) refine_general(
    const float* __restrict__ q, const float* __restrict__ q_sq,
    const T* __restrict__ series, const float* __restrict__ sq_norms,
    const int* __restrict__ leaf_ids, const uint8_t* __restrict__ alive,
    const float* __restrict__ bsf_d, const int* __restrict__ bsf_e,
    float* __restrict__ out_d, int* __restrict__ out_e, float* scratch,
    long long per, int L, int K, int M, int k, int rows, int chunks,
    int stage_bytes, int inner, int all) {
  extern __shared__ __align__(16) uint8_t smem_g[];
  __shared__ int misc[2];                // alive slots, passing candidates
  __shared__ uint64_t spare[kWarps * 32];  // select_keys' kept keys
  const int row = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long KM = (long long)K * M;
  // the alive slots and their leaves in order, the query row, the
  // distances and the keys: in shared memory (inner: [keys][q][distances]
  // [slots][leaves], then the stages) or in scratch
  int* slots = reinterpret_cast<int*>(scratch + (long long)row * per);
  int* leaves = slots + (K + 1) / 2 * 2;
  const float* qr = q + (long long)row * L;
  float* cand = reinterpret_cast<float*>(leaves) + (K + 1) / 2 * 2;
  uint64_t* keys = reinterpret_cast<uint64_t*>(cand + (KM + 1) / 2 * 2);
  uint8_t* stages = smem_g;
  if (inner) {
    keys = reinterpret_cast<uint64_t*>(smem_g);
    float* qs = reinterpret_cast<float*>(keys + pow2_ll(KM));
    for (int i = tid; i < L; i += kThreads) qs[i] = qr[i];
    qr = qs;
    cand = qs + (L + 3) / 4 * 4;
    slots = reinterpret_cast<int*>(cand + (KM + 3) / 4 * 4);
    leaves = slots + (K + 3) / 4 * 4;
    stages = reinterpret_cast<uint8_t*>(leaves + (K + 3) / 4 * 4);
  }
  const uint8_t* al = alive + (long long)row * K;
  const int* leaf_r = leaf_ids + (long long)row * K;
  const float qsq = q_sq[row];
  const long long rb = (long long)L * sizeof(T);   // a row's bytes
  const int norm_at = (int)((rows * rb + 32 + 15) / 16 * 16);
  const uint8_t* base = reinterpret_cast<const uint8_t*>(series);

  if (warp == 0) {                        // the alive slots, in order
    int n = 0;
    for (int b = 0; b < K; b += 32) {
      const bool a = b + lane < K && al[b + lane];
      const unsigned m = __ballot_sync(0xffffffffu, a);
      if (a) {
        const int at = n + __popc(m & ((1u << lane) - 1));
        slots[at] = b + lane;
        leaves[at] = leaf_r[b + lane];
      }
      n += __popc(m);
    }
    if (lane == 0) {
      misc[0] = n;
      misc[1] = 0;
    }
  }
  __syncthreads();
  const int na = misc[0];

  if (rows > 0 && !all) {
    const int items = na * chunks;        // (alive slot, piece of a leaf)
    const int group = group_lanes(rows);
    for (int it = 0; it < items + kGStages - 1; ++it) {
      // piece `it` into its stage, kGStages - 1 ahead of the one reduced
      // (a group every round, empty past the last piece)
      if (it < items) {
        const int c = it % chunks;
        const long long first =
            (long long)leaves[it / chunks] * M + (long long)c * rows;
        const int nr = min(rows, M - c * rows);
        const uint8_t* src = base + first * rb;
        const int off = (int)((uintptr_t)src & 15);
        const long long end = off + nr * rb;     // from src - off
        const uint32_t dst = sm90::smem_u32(stages + (it % kGStages) *
                                                     stage_bytes);
        // the blocks' bytes from the piece's first (the bytes before it
        // share its 16-byte block), none past its last; then the norms
        for (long long u = tid; 16 * u < end; u += kThreads)
          sm90::cp_async<16>(dst + 16 * (uint32_t)u, src - off + 16 * u,
                             (uint32_t)min(16ll, end - 16 * u));
        for (int r = tid; r < nr; r += kThreads)
          sm90::cp_async<4>(dst + norm_at + 4 * r, sq_norms + first + r, 4);
      }
      sm90::cp_async_commit();
      const int cur = it - (kGStages - 1);  // the piece to reduce now
      if (cur < 0) continue;
      sm90::cp_async_wait<kGStages - 1>();
      __syncthreads();                    // piece cur has landed
      const int c = cur % chunks, j = slots[cur / chunks];
      const long long first = (long long)leaves[cur / chunks] * M +
                              (long long)c * rows;
      const int nr = min(rows, M - c * rows);
      const int off = (int)((uintptr_t)(base + first * rb) & 15);
      const uint8_t* st = stages + (cur % kGStages) * stage_bytes;
      const float* xn = reinterpret_cast<const float*>(st + norm_at);
      float* cd = cand + (long long)j * M + c * rows;
      staged_d2<T>(
          nr, group, L, qr, qsq,
          [&](int r, const T*& rw, float& x) {
            rw = reinterpret_cast<const T*>(st + off + r * rb);
            x = xn[r];
          },
          [&](int r, float d) { cd[r] = d; }, tid);
      __syncthreads();                    // its stage may refill
    }
    sm90::cp_async_wait<0>();
  } else {
    if (rows > 0) {
      // every alive leaf into a stage of its own, then every row at once
      for (int i = 0; i < na; ++i) {
        const long long first = (long long)leaves[i] * M;
        const uint8_t* src = base + first * rb;
        const int off = (int)((uintptr_t)src & 15);
        const long long end = off + M * rb;       // from src - off
        const uint32_t dst = sm90::smem_u32(stages + i * stage_bytes);
        for (long long u = tid; 16 * u < end; u += kThreads)
          sm90::cp_async<16>(dst + 16 * (uint32_t)u, src - off + 16 * u,
                             (uint32_t)min(16ll, end - 16 * u));
        for (int r = tid; r < M; r += kThreads)
          sm90::cp_async<4>(dst + norm_at + 4 * r, sq_norms + first + r, 4);
      }
      sm90::cp_async_commit();
      sm90::cp_async_wait<0>();
    }
    __syncthreads();
    // staged rows by group_lanes' lanes; rows past a stage a warp each
    const int n_rows = na * M;
    staged_d2<T>(
        n_rows, rows > 0 ? group_lanes(n_rows) : 32, L, qr, qsq,
        [&](int e, const T*& rw, float& xn) {
          const int i = e / M, r = e - i * M;
          if (rows > 0) {
            const uint8_t* st = stages + i * stage_bytes;
            const int off = (int)((uintptr_t)(
                base + (long long)leaves[i] * M * rb) & 15);
            rw = reinterpret_cast<const T*>(st + off + r * rb);
            xn = reinterpret_cast<const float*>(st + norm_at)[r];
          } else {
            const long long x = (long long)leaves[i] * M + r;
            rw = series + x * L;
            xn = sq_norms[x];
          }
        },
        [&](int e, float d) { cand[slots[e / M] * M + e % M] = d; }, tid);
  }
  __syncthreads();

  const float* bd = bsf_d + (long long)row * k;
  const int* be = bsf_e + (long long)row * k;
  search::list_passing(
      cand, (int)KM, bd[k - 1], [&](int e) { return al[e / M] != 0; },
      [](int e) { return e; }, keys, &misc[1], tid);
  __syncthreads();
  const int n = misc[1];
  select_keys(keys, n, k, spare, tid);
  float* od = out_d + (long long)row * k;
  int* oe = out_e + (long long)row * k;
  search::merge_fold(bd, be, 0, k, keys, min(n, k), nullptr, 1, 0, leaf_r, M,
                     k,
                     [&](int pos, float d, int e) {
                       od[pos] = d;
                       oe[pos] = e;
                     },
                     tid);
}

// Words of global scratch a row of refine_general takes: its alive slots
// and their leaves (K each), the distances (K M) and the passing
// candidates' keys (2 words each, room for the power of two at or above
// K M, at least 2), each part even.
inline long long general_topk_words(int K, int M) {
  const long long KM = (long long)K * M;
  return 2 * ((K + 1) / 2 * 2) + (KM + 1) / 2 * 2 + 2 * pow2_ll(KM);
}

template <typename T>
cudaError_t launch_general(const float* q, const float* q_sq,
                           const void* series, const float* sq_norms,
                           const int* ids, const uint8_t* alive,
                           const float* bsf_d, const int* bsf_e,
                           float* out_d, int* out_e, float* scratch,
                           long long per, int Q, int L, int K, int M, int k,
                           cudaStream_t stream) {
  const long long KM = (long long)K * M;
  if (per < general_topk_words(K, M) || KM >= (1ll << 30))
    return cudaErrorInvalidValue;
  // a stage: a leaf's rows in the fewest pieces of at most kGStageMax
  // bytes (with 32 for the aligned blocks around them), then their norms;
  // none where a row alone passes it
  const long long rb = (long long)L * sizeof(T);
  int rows = 0, chunks = 0, stage = 0;
  if (rb + 32 + 16 <= kGStageMax) {
    const int most = (int)((kGStageMax - 48) / (rb + 4));
    chunks = (M + most - 1) / most;
    rows = (M + chunks - 1) / chunks;
    stage = (int)((rows * rb + 32 + 15) / 16 * 16 + (4 * rows + 15) / 16 * 16);
  }
  const long long in_bytes = 8 * pow2_ll(KM) + 4 * ((L + 3) / 4 * 4) +
                             4 * ((KM + 3) / 4 * 4) + 8 * ((K + 3) / 4 * 4);
  const int inner = in_bytes <= kGInner;
  // a stage for each slot where K whole leaves fit kGStages stages' room
  const int all = rows > 0 && chunks == 1 &&
                  (long long)K * stage <= (long long)kGStages * kGStageMax;
  const int smem = (int)(inner ? in_bytes : 0) +
                   (rows > 0 ? (all ? K : kGStages) * stage : 0);
  cudaError_t err = cudaFuncSetAttribute(
      refine_general<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  refine_general<T><<<Q, kThreads, smem, stream>>>(
      q, q_sq, static_cast<const T*>(series), sq_norms, ids, alive, bsf_d,
      bsf_e, out_d, out_e, scratch, per, L, K, M, k, rows, chunks, stage,
      inner, all);
  return cudaGetLastError();
}

namespace topk {

// refine_topk's ring route (see the top): shared memory for up to 4 CTAs
// an SM; a window holds kThreads (row, slot) entries (K, where K is more).
constexpr int kBlocksPerSM = 4;
using search::kMaxStages;
constexpr int kQRing = kMaxStages + 1;   // rows' queries in flight

struct Params {
  const float* q;
  const float* q_sq;
  const void* series;
  const float* sq_norms;
  const int* leaf_ids;
  const uint8_t* alive;
  const float* bsf_d;
  const int* bsf_e;
  float* out_d;
  int* out_e;
  int Q, L, K, M, k;
  int W;            // rows a window: kThreads / K, at least 1
  int rows;         // leaf rows a stage holds
  int chunks;       // stages a leaf takes: ceil(M / rows)
  int stages;
  int n_it;         // ceil(K * M / kThreads)
  uint32_t stage_bytes, norm_off;
  uint32_t off_bar, off_q, off_flag, off_leaf, off_slot, off_of, off_first,
      off_cnt, off_qs, off_lrow, off_wc, off_cand, off_bd, off_be, off_nd,
      off_ne, off_ld, off_le, off_ring;
};

// Exclusive prefix, over the CTA, of one 0/1 flag a thread: returns this
// thread's place and sets *total; wc holds kWarps + 1 ints.  Every thread
// calls it.
__device__ __forceinline__ int cta_place(bool f, int* wc, int tid,
                                         int* total) {
  const int lane = tid & 31, warp = tid >> 5;
  const unsigned b = __ballot_sync(0xffffffffu, f);
  if (lane == 0) wc[warp] = __popc(b);
  __syncthreads();
  if (tid == 0) {
    int run = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int n = wc[w];
      wc[w] = run;
      run += n;
    }
    wc[kWarps] = run;
  }
  __syncthreads();
  const int at = wc[warp] + __popc(b & ((1u << lane) - 1));
  *total = wc[kWarps];
  __syncthreads();              // wc may be reused
  return at;
}

// A persistent grid; CTA b takes rows b, b + grid, ..., a window of W
// rows at a time.  Per window: every (row, slot)'s flag and leaf in one
// pass, the alive ones listed in (row, slot) order; a row with no alive
// slot copies its buffer.  Then the chunks of the listed leaves stream
// through the ring, a few ahead, across slots and rows (a row's query with
// its first chunk, into a ring of its own); after a row's last chunk the
// CTA folds the row's candidates below the k-th best of the moment into its
// buffer, kThreads of them in union (slot, row) order at a time, while the
// next row's chunks land.
template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
topk_kernel(const Params p) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* series = static_cast<const T*>(p.series);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + p.off_bar);
  float* qr = reinterpret_cast<float*>(smem + p.off_q);   // [kQRing][L]
  int* w_flag = reinterpret_cast<int*>(smem + p.off_flag);  // [W][K]
  int* w_leaf = reinterpret_cast<int*>(smem + p.off_leaf);  // listed
  int* w_slot = reinterpret_cast<int*>(smem + p.off_slot);  // entries'
  int* w_of = reinterpret_cast<int*>(smem + p.off_of);      // (row i)
  int* w_first = reinterpret_cast<int*>(smem + p.off_first);  // [W]
  int* w_cnt = reinterpret_cast<int*>(smem + p.off_cnt);      // [W]
  int* w_qs = reinterpret_cast<int*>(smem + p.off_qs);  // [W]: q ring slot
  int* s_lrow = reinterpret_cast<int*>(smem + p.off_lrow);  // [K]: leaves
  int* wc = reinterpret_cast<int*>(smem + p.off_wc);
  float* cand = reinterpret_cast<float*>(smem + p.off_cand);  // [K][M]
  float* bd = reinterpret_cast<float*>(smem + p.off_bd);
  int* be = reinterpret_cast<int*>(smem + p.off_be);
  float* nd = reinterpret_cast<float*>(smem + p.off_nd);
  int* ne = reinterpret_cast<int*>(smem + p.off_ne);
  float* ld = reinterpret_cast<float*>(smem + p.off_ld);  // passing cands
  int* le = reinterpret_cast<int*>(smem + p.off_le);      // [kThreads]
  uint8_t* ring = smem + p.off_ring;
  const int G = gridDim.x;

  if (tid == 0) {
    for (int i = 0; i < p.stages; ++i) sm90::mbar_init(&bar[i], 1);
    sm90::fence_barrier_init();
  }
  long long base = 0;           // chunks of earlier windows, all consumed
  int seq = 0;                  // rows streamed in earlier windows
  for (int w0 = blockIdx.x; w0 < p.Q; w0 += G * p.W) {
    // the window's (row, slot) entries t = i K + j, row w0 + i G, in
    // passes of kThreads; the alive ones listed in that order
    int n_listed = 0;
    for (int t0 = 0; t0 < p.W * p.K; t0 += kThreads) {
      const int t = t0 + tid, i = t / p.K, j = t % p.K;
      const int row = w0 + i * G;
      const bool in = t < p.W * p.K && row < p.Q;
      const long long e = (long long)row * p.K + j;
      const int leaf = in ? p.leaf_ids[e] : 0;
      const bool f = in && p.alive[e] != 0;
      if (t < p.W * p.K) w_flag[t] = f;
      int n = 0;
      const int at = n_listed + cta_place(f, wc, tid, &n);
      if (f) {
        w_leaf[at] = leaf;
        w_slot[at] = j;
        w_of[at] = i;
      }
      if (in && j == 0) w_first[i] = at;
      n_listed += n;
    }
    // the rows' counts; the rows with one, numbered
    const bool has = tid < p.W && w0 + tid * G < p.Q;
    __syncthreads();
    int cnt = 0;
    if (has) {
      const int last = tid + 1 < p.W && w0 + (tid + 1) * G < p.Q
                           ? w_first[tid + 1] : n_listed;
      cnt = last - w_first[tid];
      w_cnt[tid] = cnt;
    }
    int n_rows = 0;
    const int rs = cta_place(has && cnt > 0, wc, tid, &n_rows);
    if (has && cnt > 0) w_qs[tid] = (seq + rs) % kQRing;
    // rows with no alive slot: their buffers as they are
    if (has && cnt == 0) {
      const long long kr = (long long)(w0 + tid * G) * p.k;
      for (int t = 0; t < p.k; ++t) {
        p.out_d[kr + t] = p.bsf_d[kr + t];
        p.out_e[kr + t] = p.bsf_e[kr + t];
      }
    }
    __syncthreads();

    // the chunks of the listed leaves, in order, through the ring
    const long long NG = (long long)n_listed * p.chunks;
    auto issue = [&](long long g) {       // thread 0
      const int a = (int)(g / p.chunks), c = (int)(g % p.chunks);
      const long long gg = base + g;
      uint64_t* b = &bar[gg % p.stages];
      uint8_t* dst = ring + (size_t)(gg % p.stages) * p.stage_bytes;
      const int r0 = c * p.rows, nr = min(p.rows, p.M - r0);
      const long long row0 = (long long)w_leaf[a] * p.M + r0;
      // the norms as a 16-byte aligned window around the rows'
      const long long lo = row0 & ~3ll, hi = (row0 + nr + 3) & ~3ll;
      const uint32_t xb = (uint32_t)(nr * p.L * sizeof(T));
      const uint32_t nb = (uint32_t)((hi - lo) * 4);
      const int ri = w_of[a];
      const bool with_q = c == 0 && a == w_first[ri];
      const uint32_t qb = with_q ? (uint32_t)(p.L * 4) : 0u;
      sm90::mbar_expect_tx(b, xb + nb + qb);
      sm90::bulk_load(dst, series + row0 * p.L, xb, b);
      sm90::bulk_load(dst + p.norm_off, p.sq_norms + lo, nb, b);
      if (with_q)
        sm90::bulk_load(qr + (size_t)w_qs[ri] * p.L,
                        p.q + (long long)(w0 + ri * G) * p.L, qb, b);
    };
    if (tid == 0)
      for (long long g = 0; g < NG && g < p.stages; ++g) issue(g);
    long long g = 0;            // the next chunk to consume
    for (int ri = 0; ri < p.W; ++ri) {
      const int r = w0 + ri * G;
      if (r >= p.Q) break;
      const int n = w_cnt[ri];
      if (n == 0) continue;
      const long long kr = (long long)r * p.k;
      // the buffer's loads wait beside the copies' (read at the fold)
      for (int t = tid; t < p.k; t += kThreads) {
        bd[t] = p.bsf_d[kr + t];
        be[t] = p.bsf_e[kr + t];
      }
      for (int a = w_first[ri] + tid; a < w_first[ri] + n; a += kThreads)
        s_lrow[w_slot[a]] = w_leaf[a];
      const float qsq = p.q_sq[r];
      const float* q_s = qr + (size_t)w_qs[ri] * p.L;
      for (int a = w_first[ri]; a < w_first[ri] + n; ++a) {
        const long long first = (long long)w_leaf[a] * p.M;
        float* out = cand + w_slot[a] * p.M;
        for (int c = 0; c < p.chunks; ++c, ++g) {
          const long long gg = base + g;
          sm90::mbar_wait(&bar[gg % p.stages],
                          (uint32_t)((gg / p.stages) & 1));
          const uint8_t* st = ring + (size_t)(gg % p.stages) * p.stage_bytes;
          const int r0 = c * p.rows, nr = min(p.rows, p.M - r0);
          const float* xn = reinterpret_cast<const float*>(st + p.norm_off)
                            + ((first + r0) & 3);
          for (int r1 = warp; r1 < nr; r1 += kUnroll * kWarps)
            warp_d2<T>(reinterpret_cast<const T*>(st), p.L, r1, nr, q_s,
                       qsq, xn, out + r0, lane);
          __syncthreads();      // the stage is free, the distances written
          if (tid == 0 && g + p.stages < NG) issue(g + p.stages);
        }
      }
      // the row's candidates in union (slot, row) order, kThreads at a
      // time: those below the k-th best of the moment folded in (fold),
      // so a fold never ranks more than k + kThreads elements
      const int* fl = w_flag + ri * p.K;
      for (int it = 0; it < p.n_it; ++it) {
        const float kth = bd[p.k - 1];
        const int e2 = it * kThreads + tid;
        bool ok = false;
        float d = 0.f;
        if (e2 < p.K * p.M && fl[e2 / p.M]) {
          d = cand[e2];
          ok = d < kth;
        }
        int n_pass = 0;
        const int place = cta_place(ok, wc, tid, &n_pass);
        if (n_pass == 0) continue;      // uniform over the CTA
        if (ok) {
          ld[place] = d;
          le[place] = s_lrow[e2 / p.M] * p.M + e2 % p.M;
        }
        __syncthreads();
        fold(bd, be, ld, le, p.k, n_pass, nd, ne, tid);
        __syncthreads();
        float* td = bd; bd = nd; nd = td;   // every thread swaps alike
        int* te = be; be = ne; ne = te;
      }
      for (int t = tid; t < p.k; t += kThreads) {
        p.out_d[kr + t] = bd[t];
        p.out_e[kr + t] = be[t];
      }
      __syncthreads();          // the buffers, cand and the lists are free
    }
    base += NG;
    seq += n_rows;
    __syncthreads();            // the window's lists are read
  }
}

// Shared memory: the fixed parts, then search::place_ring's ring.
inline cudaError_t layout(Params& p, int blocks, int elem, size_t* smem) {
  using search::take;
  p.W = std::max(1, kThreads / p.K);
  p.n_it = (p.K * p.M + kThreads - 1) / kThreads;
  const uint32_t n_ent = (uint32_t)std::max(kThreads, p.K);
  uint32_t off = 0;
  p.off_bar = take(off, 8 * kMaxStages, 8);
  p.off_q = take(off, 4u * kQRing * p.L, 16);
  p.off_flag = take(off, 4u * n_ent, 4);
  p.off_leaf = take(off, 4u * n_ent, 4);
  p.off_slot = take(off, 4u * n_ent, 4);
  p.off_of = take(off, 4u * n_ent, 4);
  p.off_first = take(off, 4u * p.W, 4);
  p.off_cnt = take(off, 4u * p.W, 4);
  p.off_qs = take(off, 4u * p.W, 4);
  p.off_lrow = take(off, 4u * p.K, 4);
  p.off_wc = take(off, 4u * (kWarps + 1), 4);
  p.off_cand = take(off, 4u * p.K * p.M, 16);
  p.off_bd = take(off, 4u * p.k, 4);
  p.off_be = take(off, 4u * p.k, 4);
  p.off_nd = take(off, 4u * p.k, 4);
  p.off_ne = take(off, 4u * p.k, 4);
  p.off_ld = take(off, 4u * kThreads, 4);
  p.off_le = take(off, 4u * kThreads, 4);
  p.off_ring = take(off, 0, 128);
  return search::place_ring(p, blocks, elem, smem);
}

// The card's SMs, and once a (device, shared memory size) the kernel's
// shared memory limit raised to at least that size and the CTAs an SM
// holds with it.  Cached, so a round's launch pays only the launch.
template <typename T>
cudaError_t card(size_t smem, int* sms, int* per_sm) {
  static std::mutex mu;
  static std::vector<std::tuple<int, size_t, int>> known;  // dev, smem, n
  static size_t raised[64] = {};
  static int count[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (count[dev] == 0) {
    err = cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return err;
  }
  *sms = count[dev];
  if (smem == 0) return cudaSuccess;
  for (const auto& e : known)
    if (std::get<0>(e) == dev && std::get<1>(e) == smem) {
      *per_sm = std::get<2>(e);
      return cudaSuccess;
    }
  if (smem > raised[dev]) {
    err = cudaFuncSetAttribute(topk_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    raised[dev] = smem;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, topk_kernel<T>,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  if (*per_sm < 1) return cudaErrorInvalidConfiguration;
  known.emplace_back(dev, smem, *per_sm);
  return cudaSuccess;
}

// Shared memory laid out for as many CTAs an SM as the rows need to be all
// in flight at once (Q / SMs, rounded up, at most kBlocksPerSM), else the
// most below that fit: fewer CTAs an SM give each more stages in flight.
// A grid of as many CTAs as the card then holds, at most one a row.
template <typename T>
cudaError_t launch(Params p, cudaStream_t stream) {
  int sms = 0, per_sm = 0;
  cudaError_t err = card<T>(0, &sms, &per_sm);
  if (err != cudaSuccess) return err;
  const int want = (int)std::min<long long>(
      kBlocksPerSM, std::max<long long>(1, ((long long)p.Q + sms - 1) / sms));
  size_t smem = 0;
  err = cudaErrorInvalidValue;
  for (int blocks = want; blocks >= 1; --blocks) {
    err = layout(p, blocks, (int)sizeof(T), &smem);
    if (err == cudaSuccess) break;
  }
  if (err != cudaSuccess) return err;
  err = card<T>(smem, &sms, &per_sm);
  if (err != cudaSuccess) return err;
  const int grid = (int)std::min<long long>((long long)per_sm * sms, p.Q);
  topk_kernel<T><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace topk

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  route 0 (the ring route,
// topk_kernel): L * sizeof(dtype) a multiple of 16, the series, q and
// sq_norms 16-byte aligned, sq_norms a multiple of 4 entries, and
// topk::layout fitting at 4, 3, 2 or 1 CTAs an SM; route 1 (general): any
// shape, with scratch of Q general_topk_words(K, M) float32 words (a
// 16-byte aligned base, series' too).  The wrapper checks.
extern "C" int refine_topk(const void* q, const void* q_sq,
                           const void* series, int dtype,
                           const void* sq_norms, const void* leaf_ids,
                           const void* alive, const void* bsf_d,
                           const void* bsf_e, void* out_d, void* out_e,
                           int Q, int L, int K, int M, int k, int route,
                           void* scratch, void* stream) {
  if (Q == 0) return 0;
  const float* qf = static_cast<const float*>(q);
  const float* qs = static_cast<const float*>(q_sq);
  const float* xn = static_cast<const float*>(sq_norms);
  const int* ids = static_cast<const int*>(leaf_ids);
  const uint8_t* al = static_cast<const uint8_t*>(alive);
  const float* bd = static_cast<const float*>(bsf_d);
  const int* be = static_cast<const int*>(bsf_e);
  float* od = static_cast<float*>(out_d);
  int* oe = static_cast<int*>(out_e);
  float* sc = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 0) {
    if (K < 1) return (int)cudaErrorInvalidValue;
    topk::Params p = {};
    p.q = qf;
    p.q_sq = qs;
    p.series = series;
    p.sq_norms = xn;
    p.leaf_ids = ids;
    p.alive = al;
    p.bsf_d = bd;
    p.bsf_e = be;
    p.out_d = od;
    p.out_e = oe;
    p.Q = Q;
    p.L = L;
    p.K = K;
    p.M = M;
    p.k = k;
    switch (dtype) {
      case 0: return (int)topk::launch<float>(p, s);
      case 1: return (int)topk::launch<__nv_bfloat16>(p, s);
      case 2: return (int)topk::launch<__half>(p, s);
    }
  } else if (route == 1 && sc != nullptr) {
    const long long per = general_topk_words(K, M);
    switch (dtype) {
      case 0: return launch_general<float>(qf, qs, series, xn, ids, al, bd,
                                           be, od, oe, sc, per, Q, L, K, M,
                                           k, s);
      case 1: return launch_general<__nv_bfloat16>(qf, qs, series, xn, ids,
                                                   al, bd, be, od, oe, sc,
                                                   per, Q, L, K, M, k, s);
      case 2: return launch_general<__half>(qf, qs, series, xn, ids, al, bd,
                                            be, od, oe, sc, per, Q, L, K, M,
                                            k, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* refine_topk_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Every refinement round of a search: q (Q, L) f32, q_sq (Q,), series
// (n, L) of `dtype`, sq_norms (a multiple of 4 entries), order /
// sorted_lb (Q, cols) with cols = rounds * K; schedule (Q,) int32, a
// permutation of 0..Q-1; out_d / out_e (Q, k), rounds and alive (Q,)
// int32; counter one int32 set to 0; inv_eps the stop rule's scale
// 1/(1+eps)^2 (1.0f: the exact search): a slot is alive while its lower
// bound lies below the k-th best times inv_eps, candidates still fold
// against the k-th best itself.
// route 0: search_kernel, clusters of C CTAs a query, the buffer whole in
// every CTA, its shared memory laid out for `ctas` (3, 2 or 1) CTAs an SM;
// route 2: the same with the buffer in slices over the cluster (C > 1);
// both with L * sizeof(dtype) a multiple of 16 and series, q and sq_norms
// 16-byte aligned.  route 1: search_general over `ctas` CTAs, each with
// `per` words of `scratch`.
// The wrapper checks the shapes and picks the route.
extern "C" int refine_search(const void* q, const void* q_sq,
                             const void* series, int dtype,
                             const void* sq_norms, const void* order,
                             const void* sorted_lb, const void* schedule,
                             void* out_d, void* out_e, void* rounds,
                             void* alive, void* counter, int Q,
                             int L, int K, int M, int k, int cols,
                             float inv_eps, int route, int ctas,
                             void* scratch, long long per, void* stream) {
  if (Q == 0) return 0;
  if (K < 1 || cols % K || ctas < 1) return (int)cudaErrorInvalidValue;
  search::Params p = {};
  p.q = static_cast<const float*>(q);
  p.q_sq = static_cast<const float*>(q_sq);
  p.series = series;
  p.sq_norms = static_cast<const float*>(sq_norms);
  p.order = static_cast<const int*>(order);
  p.sorted_lb = static_cast<const float*>(sorted_lb);
  p.out_d = static_cast<float*>(out_d);
  p.out_e = static_cast<int*>(out_e);
  p.rounds = static_cast<int*>(rounds);
  p.alive = static_cast<int*>(alive);
  p.next_query = static_cast<int*>(counter);
  p.schedule = static_cast<const int*>(schedule);
  p.Q = Q;
  p.L = L;
  p.K = K;
  p.M = M;
  p.k = k;
  p.cols = cols;
  p.inv_eps = inv_eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 0 || route == 2) {
    if (ctas > search::kBlocksPerSM) return (int)cudaErrorInvalidValue;
    int C = search::kCluster;
    while (K % C) C /= 2;
    const bool spread = route == 2;
    if (spread && C == 1) return (int)cudaErrorInvalidValue;
    switch (dtype) {
      case 0: return (int)search::launch<float>(p, C, ctas, spread, s);
      case 1:
        return (int)search::launch<__nv_bfloat16>(p, C, ctas, spread, s);
      case 2: return (int)search::launch<__half>(p, C, ctas, spread, s);
    }
  } else if (route == 1) {
    if (scratch == nullptr || per < search::general_words(K, M, k) ||
        (long long)K * M >= (1ll << 30))
      return (int)cudaErrorInvalidValue;
    float* sc = static_cast<float*>(scratch);
    switch (dtype) {
      case 0:
        search::search_general<float><<<ctas, kThreads, 0, s>>>(p, sc, per);
        return (int)cudaGetLastError();
      case 1:
        search::search_general<__nv_bfloat16><<<ctas, kThreads, 0, s>>>(
            p, sc, per);
        return (int)cudaGetLastError();
      case 2:
        search::search_general<__half><<<ctas, kThreads, 0, s>>>(p, sc, per);
        return (int)cudaGetLastError();
    }
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* refine_search_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
