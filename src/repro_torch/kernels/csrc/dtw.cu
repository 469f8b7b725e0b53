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
// The DP: one thread a (query, candidate) pair.  Each thread walks the
// rows of its pair in order; the band of the previous row lives in
// registers (the "band" route, a template instance for each r <= 16:
// 2 (2r + 1) registers for the band and the series window) or, for
// r > 16, in shared memory, one column of it a thread (the "general"
// route).  A warp's 32 threads run 32 pairs in step, so the left-to-right
// chain of a row (each cell needs its left neighbour) never serialises a
// warp, and no lane waits for another.  Cell (i, c = i - r + k):
//   d = (q[i] - x[c])^2,  cur[k] = d + min(prev[k], prev[k + 1], cur[k-1])
// with prev[k] = cost[i-1, i-1-r+k] (diag) and prev[k+1] (up), BIG = 1e30
// for a cell outside [0, L), and row 0 the running sum from column 0, as
// repro's dtw_band computes it; min is exact, so the result equals the
// plain version (kernels/ref.py dtw_band_ref) bit for bit.
//
// dtw_lb_keogh: each block first builds the group's envelopes (rolling
// min and max of each query over +-r) in shared memory; then each warp
// takes ROWS series at a time, a lane holding every 32nd value of each,
// and for each query sums e^2 (e the excursion outside the envelope) in
// its lanes and across the warp by shuffles.  Lane g keeps query g's sum,
// so a group holds at most 32 queries (the wrapper splits larger ones).
//
// dtw_search: one block a query, a thread a candidate of the round.  The
// block reduces (d, position) to the round's first minimum with one
// 64-bit min (the float's bits, non-negative, order as the floats),
// updates the best-so-far, and thread 0 reads the next round's first
// bound for the stop.
//
// dtw_scan: one thread a (query, series) pair, q in shared memory; the
// pair's (d^2 bits << 32 | series) goes through a warp min to one
// 64-bit atomicMin a warp, which gives the least distance and, among
// equal ones, the first series.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 1e30f;
constexpr int kLbThreads = 256;
constexpr int kScanThreads = 128;
constexpr int kScanThreadsGeneral = 64;

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

// The refinement of query blockIdx.x of the group (see the top).
template <int R>
__global__ void search_kernel(const float* __restrict__ q,
                              const float* __restrict__ x, long long N,
                              int L, int r, int round_k,
                              const float* __restrict__ slb,
                              const long long* __restrict__ order,
                              float* bsf_out, int* best_out,
                              int* rounds_out, int* refined_out) {
  extern __shared__ float sm[];
  float* qs = sm;                                  // L
  float* band = sm + L;                            // general route
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
      d = dtw_pair<R>(qs, x + ord[pos] * L, L, r, band + tid, blockDim.x);
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

template <int R>
int search_launch(const float* q, const float* x, long long N, int L, int r,
                  int Qg, int round_k, int threads, const float* slb,
                  const long long* order, float* bsf, int* best, int* rounds,
                  int* refined, cudaStream_t st) {
  const size_t smem = sizeof(float) * (L + (R < 0 ? (2 * r + 1) * threads
                                                  : 0));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        search_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  search_kernel<R><<<Qg, threads, smem, st>>>(q, x, N, L, r, round_k, slb,
                                              order, bsf, best, rounds,
                                              refined);
  return (int)cudaGetLastError();
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
// with ascending bounds slb[g, :], round_k (<= 1024) a round, `threads`
// (round_k rounded up to a warp) a block.  Writes bsf (squared), best
// (-1: none taken), rounds and refined, one each a query.  route: 0 the
// band route (r <= 16), 1 the general one (any r).
extern "C" int dtw_search(const void* q, const void* x, long long N, int L,
                          int r, int Qg, int round_k, int threads, int route,
                          const void* slb, const void* order, void* bsf,
                          void* best, void* rounds, void* refined,
                          void* stream) {
  if (Qg == 0) return 0;
  if (r < 0 || round_k < 1 || round_k > threads || threads > 1024
      || threads % 32 || (route == 0 && r > 16))
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
    DTW_BAND_CASES(search_launch, qq, xx, N, L, r, Qg, round_k, threads, lb,
                   od, b, bi, ro, rf, st)
  }
  return search_launch<-1>(qq, xx, N, L, r, Qg, round_k, threads, lb, od, b,
                           bi, ro, rf, st);
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
