// Exact DTW 1-NN search under a Sakoe-Chiba band of radius r:
//
// dtw_lb_keogh: the squared LB_Keogh of each query of a group against
// each series of the collection, (Qg, N).
// dtw_search:   the whole refinement of every query of a group in one
// launch: candidates in ascending-bound order, round_k a round, the loop
// of rounds on the device, each candidate's banded DTW pruned against the
// best-so-far at its round's start.
// dtw_scan:     the banded DTW of each query against every series, with
// the first-index argmin (the brute force).
//
// No Pallas kernel stands behind these: repro's DTW is plain jnp
// (src/repro/core/dtw.py: lb_keogh, dtw_band, search_dtw,
// search_dtw_bruteforce), a lax.scan DP per candidate under lax.map.  As
// torch operations a DP row is 2r + 1 dependent small operations, so the
// port runs the DP here.
//
// Bound on this card: the SMs' f32 rate.  A DP cell is a subtract, a
// multiply, two mins and an add (five f32 instructions, the multiply and
// the add kept apart: __fmul_rn / __fadd_rn, because nvcc would contract
// them into an FMA and change the bits against the plain version); a
// series of L = 256 is 1 KB against L (2r + 1) cells.  An LB_Keogh point
// is two subtracts, two maxes and an FMA a query; the group's queries
// share each read of a series, so with 32 queries the pass is bound by
// the f32 rate, not by the collection's bytes.
//
// The DP.  Cell (i, c = i - r + k) of the band, offset k in [0, 2r]:
//   d = (q[i] - x[c])^2,  cur[k] = d + min(prev[k], prev[k + 1], cur[k-1])
// with prev[k] = cost[i-1, i-1-r+k] (diag) and prev[k+1] (up), BIG = 1e30
// for a cell outside [0, L), and row 0 the running sum from column 0, as
// repro's dtw_band computes it; min is exact, so the result equals the
// plain version (kernels/ref.py dtw_band_ref) bit for bit.  Two layouts:
// - one thread a (query, candidate) pair (dtw_scan, and dtw_search's
//   general route): each thread walks the rows of its pair in order; the
//   band of the previous row lives in registers (a template instance for
//   each r <= 16: 2 (2r + 1) registers for the band and the series window)
//   or, for r > 16, in shared memory, one column of it a thread.  A warp's
//   32 threads run 32 pairs in step, so the left-to-right chain of a row
//   never serialises a warp, but a pair takes L (2r + 1) cells in series.
// - a wavefront over r + 1 lanes of a warp a pair (dtw_search's band
//   route, dtw_wave): cell (i, k) reads only cells of the wavefronts
//   t - 1 and t - 2, t = 2i + k, so lane l holds offsets 2l and 2l + 1 and
//   forms one row's two cells a step, its neighbours' cells coming by a
//   shuffle a cell: a pair takes L + r steps, and a warp runs 32 / (r + 1)
//   pairs side by side.  The series is staged in shared memory first.
//
// dtw_lb_keogh: each block first builds the group's envelopes (rolling
// min and max of each query over +-r) in shared memory; then each warp
// takes ROWS series at a time, a lane holding every 32nd value of each,
// and for each query sums e^2 (e the excursion outside the envelope) in
// its lanes and across the warp by shuffles.  Lane g keeps query g's sum,
// so a group holds at most 32 queries (the wrapper splits larger ones).
//
// dtw_search, band route (r <= 16): a cluster of 8 CTAs a query computes 8
// rounds at once, CTA u round u's candidates whose bound lies below the
// best-so-far of the iteration's start, 32 / (r + 1) pairs a warp (a warp
// with no candidate taken skips the DP; the taken ones are a prefix of the
// round, the bounds ascending), each pair's series copied into shared
// memory with cp.async and its next candidate brought into L2 meanwhile.
// Then every CTA applies the 8 rounds in order, exactly as one round after
// another: the rounds run the DP of more candidates (those a lower
// best-so-far prunes) but answer the same.  General route: one block a
// query, a thread a candidate.  A round's first minimum is one 64-bit min
// over (d bits << 32 | position) (the float's bits, non-negative, order as
// the floats); it updates the best-so-far, and the next round's first bound
// decides the stop.
//
// dtw_scan: one thread a (query, series) pair, q in shared memory; the
// pair's (d^2 bits << 32 | series) goes through a warp min to one
// 64-bit atomicMin a warp, which gives the least distance and, among
// equal ones, the first series.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 1e30f;
constexpr size_t kWaveSmem = 200 * 1024;   // a band-route CTA's, at most
constexpr int kSpec = 8;     // rounds a band-route iteration computes at once
constexpr int kLbThreads = 256;
constexpr int kScanThreads = 128;
constexpr int kScanThreadsGeneral = 64;

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" :: "l"(p));
}

__device__ __forceinline__ float cell_d(float qi, float xc) {
  const float t = __fsub_rn(qi, xc);
  return __fmul_rn(t, t);
}

// ------------------------------------------------------------ the DP
// Squared banded DTW of the query in shared memory qs (L) against the
// series x (L, global): the band in registers, radius R.
template <int R>
__device__ float dtw_band_regs(const float* __restrict__ qs,
                               const float* __restrict__ x, int L) {
  constexpr int W = 2 * R + 1;
  float band[W];
  float xw[W];                     // xw[k] = x[i - R + k] of the row i
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const int c = k - R;
    xw[k] = (c >= 0 && c < L) ? __ldg(x + c) : 0.f;
  }
  {                                // row 0: the running sum from column 0
    const float qi = qs[0];
    float left = kBig;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const int c = k - R;
      float v = kBig;
      if (c >= 0 && c < L) {
        const float d = cell_d(qi, xw[k]);
        v = (c == 0) ? d : __fadd_rn(d, left);
      }
      band[k] = v;
      left = v;
    }
  }
  float nxt = (1 + R < L) ? __ldg(x + 1 + R) : 0.f;
  for (int i = 1; i < L; ++i) {
#pragma unroll
    for (int k = 0; k < W - 1; ++k) xw[k] = xw[k + 1];
    xw[W - 1] = nxt;
    nxt = (i + 1 + R < L) ? __ldg(x + i + 1 + R) : 0.f;
    const float qi = qs[i];
    float left = kBig;
    if (i >= R && i + R < L) {     // every column of the row is in [0, L)
#pragma unroll
      for (int k = 0; k < W; ++k) {
        const float up = (k + 1 < W) ? band[k + 1] : kBig;
        const float m = fminf(fminf(band[k], up), left);
        left = __fadd_rn(cell_d(qi, xw[k]), m);
        band[k] = left;
      }
    } else {
#pragma unroll
      for (int k = 0; k < W; ++k) {
        const int c = i - R + k;
        const float up = (k + 1 < W) ? band[k + 1] : kBig;
        float v = kBig;
        if (c >= 0 && c < L) {
          const float m = fminf(fminf(band[k], up), left);
          v = __fadd_rn(cell_d(qi, xw[k]), m);
        }
        band[k] = v;
        left = v;
      }
    }
  }
  return band[R];
}

// The same with the band in shared memory: band[k * stride] is this
// thread's column k (stride = the block's threads), any radius.
__device__ float dtw_band_smem(const float* __restrict__ qs,
                               const float* __restrict__ x, int L, int R,
                               float* band, int stride) {
  const int W = 2 * R + 1;
  {
    const float qi = qs[0];
    float left = kBig;
    for (int k = 0; k < W; ++k) {
      const int c = k - R;
      float v = kBig;
      if (c >= 0 && c < L) {
        const float d = cell_d(qi, __ldg(x + c));
        v = (c == 0) ? d : __fadd_rn(d, left);
      }
      band[k * stride] = v;
      left = v;
    }
  }
  for (int i = 1; i < L; ++i) {
    const float qi = qs[i];
    float left = kBig;
    float diag = band[0];
    for (int k = 0; k < W; ++k) {
      const int c = i - R + k;
      const float up = (k + 1 < W) ? band[(k + 1) * stride] : kBig;
      float v = kBig;
      if (c >= 0 && c < L) {
        const float m = fminf(fminf(diag, up), left);
        v = __fadd_rn(cell_d(qi, __ldg(x + c)), m);
      }
      band[k * stride] = v;
      left = v;
      diag = up;
    }
  }
  return band[R * stride];
}

// R >= 0: the band route of radius R; R < 0: the general route, radius r.
template <int R>
__device__ __forceinline__ float dtw_pair(const float* qs, const float* x,
                                          int L, int r, float* band,
                                          int stride) {
  if constexpr (R >= 0) {
    return dtw_band_regs<R>(qs, x, L);
  } else {
    return dtw_band_smem(qs, x, L, r, band, stride);
  }
}

// The band route of dtw_search: one pair's banded DTW swept as a wavefront
// over H = R + 1 lanes of a warp (see the top).  Lane ll of the pair holds
// band offsets 2 ll (even) and 2 ll + 1 (odd); at step s it forms row i =
// s - ll, the even cell, then the odd one.  Cell (i, k) reads (i, k - 1)
// (left), (i - 1, k + 1) (up) and (i - 1, k) (diag), so:
//   even, k = 2 ll:  diag and up are the lane's own cells of step s - 1;
//                    left is lane ll - 1's odd cell of step s - 1 (a shuffle
//                    from the lane below, which wraps lane 0 to lane 31);
//   odd, k = 2 ll + 1: diag is the lane's own odd cell of step s - 1; left
//                    is its even cell of this step; up is lane ll + 1's even
//                    cell of this step (a shuffle from the lane above).
// A cell outside the band or the matrix has d = BIG, so its value is BIG or
// more, and a cell inside always reads a finite neighbour, which the min
// keeps: the values inside equal dtw_band_ref's, whose outside cells are
// BIG.  Offset 2R + 1, the odd cell of lane R, lies outside, and so do all
// cells of a lane not in a live pair; so a pair reads nothing of its
// neighbours but BIG.  Cell (0, 0), offset R, reads a diag of 0: d + 0 =
// d.  Each cell is the same __fsub_rn, __fmul_rn, exact mins and __fadd_rn
// on the same operands as dtw_band_ref's, so the order changes no bit.
// Returns cell (L - 1, R) in lane R / 2 of the pair; calls after_ramp()
// once the first R + 1 steps are issued.
template <int R, typename F>
__device__ __forceinline__ float dtw_wave(const float* __restrict__ qs,
                                          const float* __restrict__ xr,
                                          int L, int ll, int lane, bool live,
                                          F&& after_ramp) {
  constexpr bool kEvenFirst = R % 2 == 0;    // (0, 0) in the even cell
  const bool odd_ok = live && ll < R;
  const bool first_lane = ll == R / 2;
  const int from = (lane + 31) & 31;
  float e = kBig, o = kBig, res = kBig;
  // steps where a cell of a live lane may lie outside the matrix: before
  // every lane has reached row 1 and column 0, and from column L - 1 on
  const int a = min(R + 1, L + R), b = max(a, L - 1);
  auto edge = [&](int s) {
    const int i = s - ll, c = s + ll - R;
    const bool row = live && (unsigned)i < (unsigned)L;
    const bool in_e = row && (unsigned)c < (unsigned)L;
    const bool in_o = row && odd_ok && (unsigned)(c + 1) < (unsigned)L;
    const float qi = row ? qs[i] : 0.f;
    const float de = in_e ? cell_d(qi, xr[c]) : kBig;
    const float dd = in_o ? cell_d(qi, xr[c + 1]) : kBig;
    const bool first = i == 0 && first_lane;
    const float ze = (first && kEvenFirst) ? 0.f : e;
    const float zo = (first && !kEvenFirst) ? 0.f : o;
    const float left = __shfl_sync(0xffffffffu, o, from);
    const float ve = __fadd_rn(de, fminf(fminf(ze, o), left));
    const float up = __shfl_down_sync(0xffffffffu, ve, 1);
    const float vo = __fadd_rn(dd, fminf(fminf(zo, ve), up));
    if (i == L - 1) res = kEvenFirst ? ve : vo;
    e = ve;
    o = vo;
  };
  int s = 0;
  for (; s < a; ++s) edge(s);
  after_ramp();
  // rows 1 .. L - 2 of every lane, columns 0 .. L - 1: no test a cell
#pragma unroll 4
  for (; s < b; ++s) {
    const int i = s - ll, c = s + ll - R;
    const float qi = qs[i];
    const float de = live ? cell_d(qi, xr[c]) : kBig;
    const float dd = odd_ok ? cell_d(qi, xr[c + 1]) : kBig;
    const float left = __shfl_sync(0xffffffffu, o, from);
    const float ve = __fadd_rn(de, fminf(fminf(e, o), left));
    const float up = __shfl_down_sync(0xffffffffu, ve, 1);
    const float vo = __fadd_rn(dd, fminf(fminf(o, ve), up));
    e = ve;
    o = vo;
  }
  for (; s < L + R; ++s) edge(s);
  return res;
}

// Copy L floats from src to dst (shared) with 4-byte cp.async, the lanes
// of a pair taking every H-th value; cp_wait() waits for them.
__device__ __forceinline__ void cp_row(float* dst, const float* src, int L,
                                       int ll, int H) {
  for (int c = ll; c < L; c += H)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
                 :: "r"(static_cast<unsigned>(__cvta_generic_to_shared(
                        dst + c))), "l"(src + c)
                 : "memory");
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

__device__ __forceinline__ unsigned long long warp_min_u64(
    unsigned long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long w = __shfl_xor_sync(0xffffffffu, v, o);
    v = w < v ? w : v;
  }
  return v;
}

__device__ __forceinline__ unsigned long long pack(float d, unsigned idx) {
  return (static_cast<unsigned long long>(__float_as_uint(d)) << 32) | idx;
}

// ------------------------------------------------------------- kernels
// Squared LB_Keogh: out[g * N + n] for the Qg <= 32 queries of q (Qg, L).
// Lane j holds values j, j + 32, ... of a series, NV of them (L <= 32 NV);
// a warp takes ROWS series at a time.
template <int NV, int ROWS>
__global__ void __launch_bounds__(kLbThreads)
lb_keogh_kernel(const float* __restrict__ q, const float* __restrict__ x,
                long long N, int L, int Qg, int R, float* __restrict__ out) {
  extern __shared__ float sm[];
  float* lo = sm;                  // (Qg, L)
  float* hi = sm + Qg * L;
  for (int e = threadIdx.x; e < Qg * L; e += blockDim.x) {
    const int g = e / L, j = e - g * L;
    const int a = j - R < 0 ? 0 : j - R;
    const int b = j + R > L - 1 ? L - 1 : j + R;
    float mn = __int_as_float(0x7f800000), mx = -mn;
    for (int t = a; t <= b; ++t) {
      const float v = q[g * L + t];
      mn = fminf(mn, v);
      mx = fmaxf(mx, v);
    }
    lo[e] = mn;
    hi[e] = mx;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * (blockDim.x >> 5);
  for (long long r0 = ((long long)blockIdx.x * (blockDim.x >> 5)
                       + (threadIdx.x >> 5)) * ROWS;
       r0 < N; r0 += warps * ROWS) {
    float xv[ROWS][NV];
#pragma unroll
    for (int rr = 0; rr < ROWS; ++rr) {
#pragma unroll
      for (int t = 0; t < NV; ++t) {
        const int j = lane + 32 * t;
        xv[rr][t] = (r0 + rr < N && j < L)
                        ? __ldg(x + (r0 + rr) * L + j) : 0.f;
      }
    }
    float res[ROWS];
#pragma unroll
    for (int rr = 0; rr < ROWS; ++rr) res[rr] = 0.f;
    for (int g = 0; g < Qg; ++g) {
      float s[ROWS];
#pragma unroll
      for (int rr = 0; rr < ROWS; ++rr) s[rr] = 0.f;
#pragma unroll
      for (int t = 0; t < NV; ++t) {
        const int j = lane + 32 * t;
        if (j < L) {
          const float l = lo[g * L + j], h = hi[g * L + j];
#pragma unroll
          for (int rr = 0; rr < ROWS; ++rr) {
            const float e = fmaxf(fmaxf(xv[rr][t] - h, l - xv[rr][t]), 0.f);
            s[rr] = fmaf(e, e, s[rr]);
          }
        }
      }
#pragma unroll
      for (int rr = 0; rr < ROWS; ++rr) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          s[rr] += __shfl_xor_sync(0xffffffffu, s[rr], o);
        if (lane == g) res[rr] = s[rr];
      }
    }
    if (lane < Qg) {
#pragma unroll
      for (int rr = 0; rr < ROWS; ++rr)
        if (r0 + rr < N) out[(long long)lane * N + r0 + rr] = res[rr];
    }
  }
}

// dtw_search's general route: the refinement of query blockIdx.x of the
// group, a thread a candidate, its band in shared memory (see the top).
__global__ void search_general(const float* __restrict__ q,
                              const float* __restrict__ x, long long N,
                              int L, int r, int round_k,
                              const float* __restrict__ slb,
                              const long long* __restrict__ order,
                              float* bsf_out, int* best_out,
                              int* rounds_out, int* refined_out) {
  extern __shared__ float sm[];
  float* qs = sm;                                  // L
  float* band = sm + L;                            // (2r + 1, threads)
  __shared__ unsigned long long wkey[32];
  __shared__ float s_bsf;
  __shared__ int s_go;
  const int g = blockIdx.x, tid = threadIdx.x;
  for (int j = tid; j < L; j += blockDim.x) qs[j] = q[(long long)g * L + j];
  const float* lb = slb + (long long)g * N;
  const long long* ord = order + (long long)g * N;
  const long long end = (N + round_k - 1) / round_k * round_k;
  float bsf = kBig;
  long long best = -1;
  int rounds = 0, refined = 0;
  if (tid == 0) {
    s_bsf = kBig;
    s_go = end > 0 && lb[0] < kBig;
  }
  __syncthreads();
  long long cursor = 0;
  while (s_go) {
    bsf = s_bsf;
    const long long pos = cursor + tid;
    const bool real = tid < round_k && pos < N;
    const float b = real ? lb[pos] : kBig;
    const bool take = b < bsf;
    float d = kBig;
    if (take) {
      d = dtw_band_smem(qs, x + ord[pos] * L, L, r, band + tid, blockDim.x);
    }
    const int n_take = __syncthreads_count(take);
    const unsigned long long key = warp_min_u64(pack(d, tid));
    if ((tid & 31) == 0) wkey[tid >> 5] = key;
    __syncthreads();
    if (tid == 0) {
      unsigned long long m = wkey[0];
      for (int w = 1; w < (int)(blockDim.x >> 5); ++w)
        m = wkey[w] < m ? wkey[w] : m;
      const float dmin = __uint_as_float((unsigned)(m >> 32));
      if (dmin < bsf) {
        bsf = dmin;
        best = ord[cursor + (unsigned)(m & 0xffffffffu)];
      }
      ++rounds;
      refined += n_take;
      s_bsf = bsf;
      s_go = cursor + round_k < end && lb[cursor + round_k] < bsf;
    }
    cursor += round_k;
    __syncthreads();
  }
  if (tid == 0) {
    bsf_out[g] = bsf;
    best_out[g] = (int)best;
    rounds_out[g] = rounds;
    refined_out[g] = refined;
  }
}

// dtw_search's band route (see the top): the refinement of query
// blockIdx.x / kSpec of the group by a cluster of kSpec CTAs.  An iteration
// computes kSpec rounds at once: CTA u the candidates of round u whose bound
// lies below the best-so-far of the iteration's start (those of the round
// itself and perhaps more: the best-so-far only falls), its warps P = 32 /
// (R + 1) pairs each (dtw_wave).  After one cluster barrier, warp 0 of every
// CTA applies the kSpec rounds in order as the loop of single rounds does:
// the stop before each, the candidates below the best-so-far of the moment,
// their first minimum; so the best-so-far, the id, the rounds and the
// candidates refined are that loop's in every CTA.  Distances and bounds are
// double-buffered by iteration parity, so no CTA overwrites what another
// still reads.  Each pair's next candidate (its bound and id read during
// this iteration) is brought into L2 once the DP has begun.
template <int R>
__global__ void __launch_bounds__(1024)
wave_kernel(const float* __restrict__ q, const float* __restrict__ x,
            long long N, int L, int round_k, const float* __restrict__ slb,
            const long long* __restrict__ order, float* bsf_out,
            int* best_out, int* rounds_out, int* refined_out) {
  constexpr int H = R + 1, P = 32 / H;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  extern __shared__ float sm[];
  float* qs = sm;                        // L
  float* rd = qs + L;                    // [2][round_k]: distances (BIG:
  float* rl = rd + 2 * round_k;          // not computed) and bounds
  float* xs = rl + 2 * round_k;          // (warps * P, L): the pairs' rows
  __shared__ float s_nlb[2];             // CTA 0: the next iteration's first
  __shared__ float s_bsf;                // bound
  __shared__ int s_go;
  const int g = blockIdx.x / kSpec, tid = threadIdx.x, lane = tid & 31;
  const int warp = tid >> 5, warps = blockDim.x >> 5;
  // the lane's pair in the warp (P: none) and its lane in the pair
  const int slot = lane / H, ll = lane - slot * H;
  float* xrow = xs + (long long)(warp * P + min(slot, P - 1)) * L;
  for (int j = tid; j < L; j += blockDim.x) qs[j] = q[(long long)g * L + j];
  const float* lb = slb + (long long)g * N;
  const long long* ord = order + (long long)g * N;
  const long long end = (N + round_k - 1) / round_k * round_k;
  const long long step = (long long)kSpec * round_k;
  const bool one_batch = warps * P >= round_k;
  float bsf = kBig;
  long long best = -1;
  int rounds = 0, refined = 0, par = 0;
  bool go = end > 0 && lb[0] < kBig;
  float cb = kBig;                       // one batch: this pair's candidate
  long long co = 0;                      // (bound, id), read an iteration
  bool carried = false;                  // ahead
  long long cursor = 0;
  __syncthreads();
  while (go) {
    float* my_d = rd + par * round_k;
    float* my_l = rl + par * round_k;
    for (int base = 0; base < round_k; base += warps * P) {
      const int j = base + warp * P + slot;    // the pair's candidate
      const bool mine = slot < P && j < round_k;
      const long long pos = cursor + (long long)rank * round_k + j;
      const bool real = mine && pos < N;
      float b = kBig;
      long long o = 0;
      if (carried) {
        b = cb;
        o = co;
      } else if (real) {
        b = lb[pos];
        o = ord[pos];
      }
      const bool take = b < bsf;
      const long long nxt = pos + step;        // its next iteration's
      const bool more = mine && nxt < N;
      const float nb = more ? lb[nxt] : kBig;
      const long long no = more ? ord[nxt] : 0;
      auto ahead = [&] {
        if (nb < bsf) {
          const float* nrow = x + no * L;
          for (int c = 32 * ll; c < L; c += 32 * H) prefetch_l2(nrow + c);
          if (ll == 0) prefetch_l2(nrow + L - 1);
        }
      };
      float d = kBig;
      if (__any_sync(0xffffffffu, take)) {
        if (take) cp_row(xrow, x + o * L, L, ll, H);
        cp_wait();
        __syncwarp();
        d = dtw_wave<R>(qs, xrow, L, ll, lane, take, ahead);
        __syncwarp();           // the rows are read: the next batch may copy
      } else {
        ahead();
      }
      if (mine && ll == R / 2) {               // the pair's result lane
        my_d[j] = take ? d : kBig;
        my_l[j] = b;
        if (rank == 0 && j == 0) s_nlb[par] = nb;
      }
      carried = one_batch;
      cb = nb;
      co = no;
    }
    cluster.sync();             // every CTA's round of the iteration is in
    if (warp == 0) {
      // the first candidate of each round, read ahead of the rounds
      float dv[kSpec], lv[kSpec];
#pragma unroll
      for (int u = 0; u < kSpec; ++u) {
        const bool in = lane < round_k;
        dv[u] = in ? cluster.map_shared_rank(rd, u)[par * round_k + lane]
                   : kBig;
        lv[u] = in ? cluster.map_shared_rank(rl, u)[par * round_k + lane]
                   : kBig;
      }
      const float nlb = cluster.map_shared_rank(s_nlb, 0)[par];
      bool on = true;
#pragma unroll
      for (int u = 0; u < kSpec; ++u) {
        const long long cu = cursor + (long long)u * round_k;
        const float first = __shfl_sync(0xffffffffu, lv[u], 0);
        if (u > 0) on = on && cu < end && first < bsf;   // the stop before
        if (on) {
          unsigned long long key = ~0ull;
          int nt = 0;
          for (int j0 = 0; j0 < round_k; j0 += 32) {
            const int j = j0 + lane;
            float dj = dv[u], lj = lv[u];
            if (j0 > 0 && j < round_k) {
              dj = cluster.map_shared_rank(rd, u)[par * round_k + j];
              lj = cluster.map_shared_rank(rl, u)[par * round_k + j];
            }
            const bool t = j < round_k && lj < bsf;
            const unsigned long long kj =
                j < round_k ? pack(t ? dj : kBig, (unsigned)j) : ~0ull;
            key = kj < key ? kj : key;
            nt += __popc(__ballot_sync(0xffffffffu, t));
          }
          key = warp_min_u64(key);
          const float dmin = __uint_as_float((unsigned)(key >> 32));
          if (dmin < bsf) {
            bsf = dmin;
            if (rank == 0 && lane == 0)
              best = ord[cu + (unsigned)(key & 0xffffffffu)];
          }
          ++rounds;
          refined += nt;
        }
      }
      // the stop before the next iteration's first round
      const long long nc = cursor + step;
      on = on && nc < end && nlb < bsf;
      if (lane == 0) {
        s_bsf = bsf;
        s_go = on;
      }
    }
    __syncthreads();
    bsf = s_bsf;
    go = s_go;
    cursor += step;
    par ^= 1;
  }
  cluster.sync();               // no CTA leaves while another reads it
  if (rank == 0 && tid == 0) {
    bsf_out[g] = bsf;
    best_out[g] = (int)best;
    rounds_out[g] = rounds;
    refined_out[g] = refined;
  }
}

// Query blockIdx.y against series blockIdx.x * blockDim.x + threadIdx.x.
template <int R>
__global__ void scan_kernel(const float* __restrict__ q,
                            const float* __restrict__ x, long long N, int L,
                            int r, unsigned long long* keys) {
  extern __shared__ float sm[];
  float* qs = sm;
  float* band = sm + L;
  const int g = blockIdx.y, tid = threadIdx.x;
  for (int j = tid; j < L; j += blockDim.x) qs[j] = q[(long long)g * L + j];
  __syncthreads();
  const long long n = (long long)blockIdx.x * blockDim.x + tid;
  unsigned long long key = ~0ull;
  if (n < N) {
    key = pack(dtw_pair<R>(qs, x + n * L, L, r, band + tid, blockDim.x),
               (unsigned)n);
  }
  key = warp_min_u64(key);
  if ((tid & 31) == 0 && key != ~0ull) atomicMin(keys + g, key);
}

int general_launch(const float* q, const float* x, long long N, int L,
                   int r, int Qg, int round_k, int threads, const float* slb,
                   const long long* order, float* bsf, int* best, int* rounds,
                   int* refined, cudaStream_t st) {
  const size_t smem = sizeof(float) * (L + (2 * r + 1) * threads);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        search_general, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  search_general<<<Qg, threads, smem, st>>>(q, x, N, L, r, round_k, slb,
                                            order, bsf, best, rounds,
                                            refined);
  return (int)cudaGetLastError();
}

// The band route: clusters of kSpec CTAs a query, `threads` / 32 warps a
// CTA (the wrapper's band_threads), the query, the rounds' distances and
// bounds and the pairs' rows within kWaveSmem.
template <int R>
int wave_launch(const float* q, const float* x, long long N, int L, int r,
                int Qg, int round_k, int threads, const float* slb,
                const long long* order, float* bsf, int* best, int* rounds,
                int* refined, cudaStream_t st) {
  constexpr int P = 32 / (R + 1);
  const size_t smem = sizeof(float) * ((size_t)L + 4 * (size_t)round_k
                                       + (size_t)threads / 32 * P * L);
  if (smem > kWaveSmem) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      wave_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kSpec;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)Qg * kSpec);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, wave_kernel<R>, q, x, N, L, round_k, slb,
                         order, bsf, best, rounds, refined);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

template <int R>
int scan_launch(const float* q, const float* x, long long N, int L, int r,
                int Q, unsigned long long* keys, cudaStream_t st) {
  const int threads = R < 0 ? kScanThreadsGeneral : kScanThreads;
  const size_t smem = sizeof(float) * (L + (R < 0 ? (2 * r + 1) * threads
                                                  : 0));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        scan_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)((N + threads - 1) / threads), (unsigned)Q);
  scan_kernel<R><<<grid, threads, smem, st>>>(q, x, N, L, r, keys);
  return (int)cudaGetLastError();
}

// One case a band radius: the band route's template instances.
#define DTW_BAND_CASES(F, ...) \
  case 0: return F<0>(__VA_ARGS__);   case 1: return F<1>(__VA_ARGS__);   \
  case 2: return F<2>(__VA_ARGS__);   case 3: return F<3>(__VA_ARGS__);   \
  case 4: return F<4>(__VA_ARGS__);   case 5: return F<5>(__VA_ARGS__);   \
  case 6: return F<6>(__VA_ARGS__);   case 7: return F<7>(__VA_ARGS__);   \
  case 8: return F<8>(__VA_ARGS__);   case 9: return F<9>(__VA_ARGS__);   \
  case 10: return F<10>(__VA_ARGS__); case 11: return F<11>(__VA_ARGS__); \
  case 12: return F<12>(__VA_ARGS__); case 13: return F<13>(__VA_ARGS__); \
  case 14: return F<14>(__VA_ARGS__); case 15: return F<15>(__VA_ARGS__); \
  case 16: return F<16>(__VA_ARGS__);

}  // namespace

// route: 0 "l256" (L in (224, 256], 4 series a warp), 1 "general"
// (L <= 1024).  q (Qg <= 32, L), x (N, L), out (Qg, N), all float32.
extern "C" int dtw_lb_keogh(const void* q, const void* x, long long N, int L,
                            int Qg, int r, int route, void* out,
                            void* stream) {
  if (N == 0 || Qg == 0) return 0;
  if (Qg > 32 || L < 1 || L > 1024 || r < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(float) * 2 * Qg * L;
  const int rows = route == 0 ? 4 : 1;
  const long long warps_needed = (N + rows - 1) / rows;
  long long blocks = (warps_needed + kLbThreads / 32 - 1) / (kLbThreads / 32);
  if (blocks > 132 * 8) blocks = 132 * 8;
  const float* qq = static_cast<const float*>(q);
  const float* xx = static_cast<const float*>(x);
  float* o = static_cast<float*>(out);
  cudaError_t e = cudaSuccess;
  if (route == 0) {
    if (L <= 224 || L > 256) return (int)cudaErrorInvalidValue;
    e = cudaFuncSetAttribute(lb_keogh_kernel<8, 4>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    lb_keogh_kernel<8, 4><<<(unsigned)blocks, kLbThreads, smem, st>>>(
        qq, xx, N, L, Qg, r, o);
  } else {
    e = cudaFuncSetAttribute(lb_keogh_kernel<32, 1>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    lb_keogh_kernel<32, 1><<<(unsigned)blocks, kLbThreads, smem, st>>>(
        qq, xx, N, L, Qg, r, o);
  }
  return (int)cudaGetLastError();
}

// The refinement of each query g < Qg: candidates order[g, :] (int64)
// with ascending bounds slb[g, :], round_k (<= 1024) a round.  Writes bsf
// (squared), best (-1: none taken), rounds and refined, one each a query.
// route: 0 the band route (r <= 16; `threads` from the wrapper's
// band_threads), 1 the general one (any r; `threads` round_k rounded up to
// a warp).
extern "C" int dtw_search(const void* q, const void* x, long long N, int L,
                          int r, int Qg, int round_k, int threads, int route,
                          const void* slb, const void* order, void* bsf,
                          void* best, void* rounds, void* refined,
                          void* stream) {
  if (Qg == 0) return 0;
  if (r < 0 || round_k < 1 || round_k > 1024 || threads < 32
      || threads > 1024 || threads % 32 || (route == 0 && r > 16)
      || (route != 0 && round_k > threads))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qq = static_cast<const float*>(q);
  const float* xx = static_cast<const float*>(x);
  const float* lb = static_cast<const float*>(slb);
  const long long* od = static_cast<const long long*>(order);
  float* b = static_cast<float*>(bsf);
  int* bi = static_cast<int*>(best);
  int* ro = static_cast<int*>(rounds);
  int* rf = static_cast<int*>(refined);
  if (route == 0) switch (r) {
    DTW_BAND_CASES(wave_launch, qq, xx, N, L, r, Qg, round_k, threads, lb,
                   od, b, bi, ro, rf, st)
  }
  return general_launch(qq, xx, N, L, r, Qg, round_k, threads, lb, od, b, bi,
                        ro, rf, st);
}

// keys (Q,) uint64, each all ones on entry: min over series n of
// (bits of the squared DTW of query g and series n) << 32 | n.  route as
// dtw_search's.
extern "C" int dtw_scan(const void* q, const void* x, long long N, int L,
                        int r, int Q, int route, void* keys, void* stream) {
  if (N == 0 || Q == 0) return 0;
  if (r < 0 || N > 0xffffffffll || (route == 0 && r > 16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qq = static_cast<const float*>(q);
  const float* xx = static_cast<const float*>(x);
  unsigned long long* k = static_cast<unsigned long long*>(keys);
  if (route == 0) switch (r) {
    DTW_BAND_CASES(scan_launch, qq, xx, N, L, r, Q, k, st)
  }
  return scan_launch<-1>(qq, xx, N, L, r, Q, k, st);
}

extern "C" const char* dtw_lb_keogh_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" const char* dtw_search_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" const char* dtw_scan_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
