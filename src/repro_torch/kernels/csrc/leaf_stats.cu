// The index build's two per-leaf passes over the key-sorted order:
//
// leaf_stats: for each leaf of M sorted rows, the min and max of every
// segment's PAA value and symbol over the leaf's rows, and from them the
// leaf's per-segment [lo, hi] region for the chosen lower bound; a leaf
// with no row gets the empty region [+inf, +inf] and leaf_valid false.
//
// leaf_gather: the materialize pass, writing each sorted row's series (in
// the storage type), PAA, symbols, squared norm and id through the order.
//
// No Pallas kernel stands behind either: repro computes both inside its
// jitted build (`leaf_stats_blocks` and the gathers of
// src/repro/core/index.py and src/repro/core/builder.py).  On the card
// the index builder (core/builder.py) runs both once for each part of its
// leaf_stats and materialize phases, where the plain versions took some
// 25 and 5 small launches a part; `build_index` runs leaf_stats once.
//
// Bound on this card: device memory and latency.  leaf_stats reads each
// row's order entry (8 bytes), PAA (4 w bytes) and symbols (w bytes) once
// and writes 8 w + 1 bytes a leaf; min, max and a table lookup a value
// are far below the SMs' rate.  A part of the builder is a few thousand
// rows, so there one launch's latency is the cost.  leaf_gather copies
// each row once.
//
// leaf_stats: one thread a (leaf, segment).  It walks the leaf's rows in
// order, reading its segment's PAA value and symbol through the order;
// the w threads of a leaf read w neighbouring values of one row.  min and
// max are exact whatever their order, and the region is a lookup in the
// padded breakpoint table, so the result equals the plain version's bit
// for bit.  NaN propagates as in torch's amin/amax.  Regions:
//   paabox  [min PAA, max PAA];
//   symbox  [pad[min sym], pad[max sym + 1]];
//   prefix  the common prefix of min sym and max sym: with
//           sh = bit_length(lo ^ hi) and base = (lo >> sh) << sh,
//           [pad[base], pad[base + 2^sh]].
//
// leaf_gather: one warp a row.  The series row goes in units of U bytes
// (16 where every row base is 16-byte aligned, else 8, 4 or 2: the
// wrapper picks U from the row's bytes and the bases), the PAA and
// symbols one value a lane, the norm and the id from lane 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || a < b) ? a : b;       // a if a is NaN or smaller
}
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || a > b) ? a : b;
}

template <int kBound>   // 0 prefix, 1 symbox, 2 paabox
__global__ void stats_kernel(const float* __restrict__ paa,
                             const uint8_t* __restrict__ words,
                             const long long* __restrict__ order,
                             long long n, int W, int M, int bits,
                             long long leaf0, long long g,
                             const float* __restrict__ pad,
                             float* __restrict__ lo_out,
                             float* __restrict__ hi_out,
                             bool* __restrict__ valid_out) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= g * W) return;
  const long long li = t / W;             // leaf within the range
  const int s = (int)(t - li * W);
  const long long r0 = (leaf0 + li) * M;
  const long long r1 = min(r0 + M, n);
  const float inf = __int_as_float(0x7f800000);
  float plo = inf, phi = -inf;
  int slo = (1 << bits) - 1, shi = 0;
#pragma unroll 4
  for (long long r = r0; r < r1; ++r) {
    const long long src = order[r] * W + s;
    const float p = paa[src];
    const int sym = words[src];
    plo = min_nan(p, plo);
    phi = max_nan(p, phi);
    slo = min(slo, sym);
    shi = max(shi, sym);
  }
  float lo = inf, hi = inf;
  const bool valid = r0 < n;
  if (valid) {
    if (kBound == 2) {
      lo = plo;
      hi = phi;
    } else if (kBound == 1) {
      lo = pad[slo];
      hi = pad[shi + 1];
    } else {
      const int sh = 32 - __clz(slo ^ shi);
      const int base = (slo >> sh) << sh;
      lo = pad[base];
      hi = pad[base + (1 << sh)];
    }
  }
  lo_out[t] = lo;
  hi_out[t] = hi;
  if (s == 0) valid_out[li] = valid;
}

template <typename U>
__global__ void gather_kernel(const long long* __restrict__ order,
                              long long r0, long long m,
                              const char* __restrict__ series, int row_units,
                              const float* __restrict__ paa,
                              const uint8_t* __restrict__ words,
                              const float* __restrict__ sqn,
                              const int* __restrict__ perm_src, int W,
                              char* __restrict__ o_series,
                              float* __restrict__ o_paa,
                              uint8_t* __restrict__ o_words,
                              float* __restrict__ o_sqn,
                              int* __restrict__ o_perm) {
  const long long i = (long long)blockIdx.x * (kThreads / 32) +
                      (threadIdx.x >> 5);
  if (i >= m) return;
  const int lane = threadIdx.x & 31;
  const long long r = r0 + i;             // the sorted row
  const long long src = order[r];
  const U* a = reinterpret_cast<const U*>(series) + src * row_units;
  U* b = reinterpret_cast<U*>(o_series) + r * row_units;
  for (int u = lane; u < row_units; u += 32) b[u] = a[u];
  for (int s = lane; s < W; s += 32) {
    o_paa[r * W + s] = paa[src * W + s];
    o_words[r * W + s] = words[src * W + s];
  }
  if (lane == 0) {
    o_sqn[r] = sqn[src];
    o_perm[r] = perm_src != nullptr ? perm_src[src] : (int)src;
  }
}

template <typename U>
int gather(const long long* order, long long r0, long long m,
           const void* series, int row_bytes, const void* paa,
           const void* words, const void* sqn, const void* perm_src, int W,
           void* o_series, void* o_paa, void* o_words, void* o_sqn,
           void* o_perm, cudaStream_t st) {
  const unsigned blocks = (unsigned)((m + kThreads / 32 - 1) /
                                     (kThreads / 32));
  gather_kernel<U><<<blocks, kThreads, 0, st>>>(
      order, r0, m, static_cast<const char*>(series),
      row_bytes / (int)sizeof(U), static_cast<const float*>(paa),
      static_cast<const uint8_t*>(words), static_cast<const float*>(sqn),
      static_cast<const int*>(perm_src), W, static_cast<char*>(o_series),
      static_cast<float*>(o_paa), static_cast<uint8_t*>(o_words),
      static_cast<float*>(o_sqn), static_cast<int*>(o_perm));
  return (int)cudaGetLastError();
}

}  // namespace

// bound: 0 prefix, 1 symbox, 2 paabox.  Leaves [leaf0, leaf0 + g): leaf l
// holds sorted rows [l * M, (l + 1) * M), row r being source row order[r],
// and rows >= n padding.  lo/hi (g, W) and valid (g,) are written from
// their bases; pad is the padded breakpoint table (2^bits + 1 floats).
extern "C" int leaf_stats(const void* paa, const void* words,
                          const void* order, long long n, int W, int M,
                          int bits, int bound, long long leaf0, long long g,
                          const void* pad, void* lo, void* hi, void* valid,
                          void* stream) {
  if (g == 0) return 0;
  const unsigned blocks = (unsigned)((g * W + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(paa);
  const uint8_t* w = static_cast<const uint8_t*>(words);
  const long long* o = static_cast<const long long*>(order);
  const float* tb = static_cast<const float*>(pad);
  float* l = static_cast<float*>(lo);
  float* h = static_cast<float*>(hi);
  bool* v = static_cast<bool*>(valid);
  switch (bound) {
    case 0: stats_kernel<0><<<blocks, kThreads, 0, st>>>(
        p, w, o, n, W, M, bits, leaf0, g, tb, l, h, v); break;
    case 1: stats_kernel<1><<<blocks, kThreads, 0, st>>>(
        p, w, o, n, W, M, bits, leaf0, g, tb, l, h, v); break;
    case 2: stats_kernel<2><<<blocks, kThreads, 0, st>>>(
        p, w, o, n, W, M, bits, leaf0, g, tb, l, h, v); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Sorted rows [r0, r0 + m): out row r takes source row order[r].  The
// series rows are row_bytes long, copied in units of unit bytes (2, 4, 8
// or 16, dividing row_bytes, with every base aligned to it); perm_src
// (int32) or, where null, the source row itself gives the id.
extern "C" int leaf_gather(const void* order, long long r0, long long m,
                           const void* series, int row_bytes, int unit,
                           const void* paa, const void* words,
                           const void* sqn, const void* perm_src, int W,
                           void* o_series, void* o_paa, void* o_words,
                           void* o_sqn, void* o_perm, void* stream) {
  if (m == 0) return 0;
  const long long* o = static_cast<const long long*>(order);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (unit) {
    case 16: return gather<uint4>(o, r0, m, series, row_bytes, paa, words,
                                  sqn, perm_src, W, o_series, o_paa,
                                  o_words, o_sqn, o_perm, st);
    case 8: return gather<uint2>(o, r0, m, series, row_bytes, paa, words,
                                 sqn, perm_src, W, o_series, o_paa, o_words,
                                 o_sqn, o_perm, st);
    case 4: return gather<uint32_t>(o, r0, m, series, row_bytes, paa, words,
                                    sqn, perm_src, W, o_series, o_paa,
                                    o_words, o_sqn, o_perm, st);
    case 2: return gather<uint16_t>(o, r0, m, series, row_bytes, paa, words,
                                    sqn, perm_src, W, o_series, o_paa,
                                    o_words, o_sqn, o_perm, st);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* leaf_stats_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" const char* leaf_gather_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
