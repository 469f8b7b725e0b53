// Batched lower-bound (MINDIST) distances of every query PAA to every
// leaf region: out[q, l] = L/w * sum_s (max(lo - q, 0) + max(q - hi, 0))^2.
//
// Replaces the Pallas kernel `_lb_kernel` of
// src/repro/kernels/lb_distance.py (wrapper `lb_distance`).
//
// Bound on this card: the operations.  Each (query, leaf, segment) term
// takes five float32 instructions that are not two-flop FMAs (two
// subtractions, two max, one FMA: d = max(max(lo - q, q - hi), 0), then
// acc = fma(d, d, acc)), so the count is Q * NL * w * 5 instructions at
// 132 SMs x 128 lanes x 1.98 GHz; the (Q, NL) float32 output at the
// memory rate comes second.  For lo <= hi the max form equals the sum
// form bit for bit: at most one of lo - q and q - hi is positive.
//
// Two routes.  tiled (route 0, w in {4, 8, 16}): a block owns a tile of
// kTQ = 128 queries by kTL = 256 leaves and stages the tile's query values
// and its leaves' lo/hi edges in shared memory, each transposed to one
// row per segment.  Thread (r, c) computes queries 32 r .. 32 r + 31
// against leaves 4 c .. 4 c + 3, eight queries at a time with their 32
// sums in registers: for each segment it reads the four leaves' edges
// with one 16-byte load each and the eight query values with two 16-byte
// loads that every thread of the warp shares, so a term costs the five
// instructions and 1/8 of a shared-memory load.  Each group's outputs go
// out as one 16-byte streaming store a query row (scalar stores where
// NL % 4 != 0) before the next group is summed, so the 268 MB of output
// at the main cell's shape drain while the SMs compute; at 80 registers
// three blocks share an SM.  looped (route 1, any w): a tile of kLQ = 32
// queries by 256 leaves, with w a runtime loop: thread t reads leaf t's
// edges one segment at a time from memory and adds each segment's term
// to the 32 queries' sums held in registers (the queries' values are read
// by all threads at once, a broadcast).  Both add the terms in segment
// order, so they give the same bits.
// Edges are clamped to +-1e30 as the JAX wrapper does; an invalid leaf
// (lo = hi = +inf) then gives (1e30)^2, which rounds to +inf in float32,
// the value the plain version gives.

#include <cuda_runtime.h>

namespace {

constexpr int kTL = 256;                 // leaves per block
constexpr int kTQ = 128;                 // queries per block, tiled route
constexpr int kLQ = 32;                  // queries per block, looped route
constexpr int kThreads = 256;
constexpr int kRowQ = 32;                // queries a thread, tiled route
constexpr int kGroupQ = 8;               // ... summed and stored at a time
constexpr int kColL = 4;                 // leaves a thread, tiled route
constexpr int kPadL = kTL + 4;           // a staged edge row; 16-byte rows
constexpr float kBig = 1e30f;

__device__ __forceinline__ float clamp_edge(float v) {
  return fminf(fmaxf(v, -kBig), kBig);
}

template <int W, bool kVec>  // kVec: NL % 4 == 0, rows 16-byte aligned
__global__ void __launch_bounds__(kThreads, 3)
lb_kernel(const float* __restrict__ q_paa, const float* __restrict__ lo,
          const float* __restrict__ hi, float* __restrict__ out, int Q,
          long long NL, float scale) {
  __shared__ __align__(16) float q_s[W][kTQ];
  __shared__ __align__(16) float lo_s[W][kPadL];
  __shared__ __align__(16) float hi_s[W][kPadL];

  const long long l0 = (long long)blockIdx.x * kTL;
  const int q0 = blockIdx.y * kTQ;
  const int t = threadIdx.x;

  // the leaves' rows, 16 bytes at a time, transposed into the tile
  for (int e = t; e < kTL * W / 4; e += kThreads) {
    const int l = e / (W / 4), c = e % (W / 4);
    float4 a = make_float4(kBig, kBig, kBig, kBig), b = a;
    if (l0 + l < NL) {
      a = reinterpret_cast<const float4*>(lo + (l0 + l) * W)[c];
      b = reinterpret_cast<const float4*>(hi + (l0 + l) * W)[c];
    }
    lo_s[4 * c][l] = clamp_edge(a.x);
    lo_s[4 * c + 1][l] = clamp_edge(a.y);
    lo_s[4 * c + 2][l] = clamp_edge(a.z);
    lo_s[4 * c + 3][l] = clamp_edge(a.w);
    hi_s[4 * c][l] = clamp_edge(b.x);
    hi_s[4 * c + 1][l] = clamp_edge(b.y);
    hi_s[4 * c + 2][l] = clamp_edge(b.z);
    hi_s[4 * c + 3][l] = clamp_edge(b.w);
  }
  for (int e = t; e < kTQ * W; e += kThreads) {
    const int qi = e / W, s = e % W;
    q_s[s][qi] = q0 + qi < Q ? q_paa[(long long)(q0 + qi) * W + s] : 0.f;
  }
  __syncthreads();

  const int c = t % (kTL / kColL), r = t / (kTL / kColL);
  const long long l = l0 + kColL * c;
#pragma unroll 1
  for (int g = 0; g < kRowQ / kGroupQ; ++g) {
    const int qb = kRowQ * r + kGroupQ * g;     // the group's first query
    float acc[kGroupQ][kColL];
#pragma unroll
    for (int i = 0; i < kGroupQ; ++i)
#pragma unroll
      for (int j = 0; j < kColL; ++j) acc[i][j] = 0.f;
#pragma unroll 2
    for (int s = 0; s < W; ++s) {
      const float4 a = *reinterpret_cast<const float4*>(&lo_s[s][kColL * c]);
      const float4 b = *reinterpret_cast<const float4*>(&hi_s[s][kColL * c]);
      const float lv[kColL] = {a.x, a.y, a.z, a.w};
      const float hv[kColL] = {b.x, b.y, b.z, b.w};
      float qv[kGroupQ];
#pragma unroll
      for (int k = 0; k < kGroupQ / 4; ++k) {
        const float4 v =
            *reinterpret_cast<const float4*>(&q_s[s][qb + 4 * k]);
        qv[4 * k] = v.x;
        qv[4 * k + 1] = v.y;
        qv[4 * k + 2] = v.z;
        qv[4 * k + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < kGroupQ; ++i)
#pragma unroll
        for (int j = 0; j < kColL; ++j) {
          const float d = fmaxf(fmaxf(lv[j] - qv[i], qv[i] - hv[j]), 0.f);
          acc[i][j] = fmaf(d, d, acc[i][j]);
        }
    }
    if (l < NL) {
#pragma unroll
      for (int i = 0; i < kGroupQ; ++i) {
        const int q = q0 + qb + i;
        if (q < Q) {
          float* o = out + (long long)q * NL + l;
          if (kVec) {
            __stcs(reinterpret_cast<float4*>(o),
                   make_float4(acc[i][0] * scale, acc[i][1] * scale,
                               acc[i][2] * scale, acc[i][3] * scale));
          } else {
#pragma unroll
            for (int j = 0; j < kColL; ++j)
              if (l + j < NL) __stcs(o + j, acc[i][j] * scale);
          }
        }
      }
    }
  }
}

__global__ void lb_looped(const float* __restrict__ q_paa,
                          const float* __restrict__ lo,
                          const float* __restrict__ hi,
                          float* __restrict__ out, int Q, long long NL,
                          int W, float scale) {
  const long long l = (long long)blockIdx.x * kTL + threadIdx.x;
  const int q0 = blockIdx.y * kLQ;
  if (l >= NL) return;
  const int nq = min(kLQ, Q - q0);
  const float* qp = q_paa + (long long)q0 * W;
  float acc[kLQ];
#pragma unroll
  for (int qi = 0; qi < kLQ; ++qi) acc[qi] = 0.f;
  for (int s = 0; s < W; ++s) {
    const float a = clamp_edge(lo[l * W + s]);
    const float b = clamp_edge(hi[l * W + s]);
#pragma unroll
    for (int qi = 0; qi < kLQ; ++qi) {
      if (qi < nq) {
        const float qs = qp[qi * W + s];
        const float d = fmaxf(a - qs, 0.f) + fmaxf(qs - b, 0.f);
        acc[qi] += d * d;
      }
    }
  }
#pragma unroll
  for (int qi = 0; qi < kLQ; ++qi)
    if (qi < nq) out[(long long)(q0 + qi) * NL + l] = acc[qi] * scale;
}

// The grid's y dimension takes 65,535 query tiles: more go in launches of
// as many (`tile` queries each), each on its slice of the queries and of
// out.
constexpr int kMaxTiles = 65535;

template <int W>
cudaError_t launch(const float* q, const float* lo, const float* hi,
                   float* out, int Q, long long NL, float scale,
                   cudaStream_t stream) {
  for (int q0 = 0; q0 < Q; q0 += kMaxTiles * kTQ) {
    const int nq = Q - q0 < kMaxTiles * kTQ ? Q - q0 : kMaxTiles * kTQ;
    dim3 grid((unsigned)((NL + kTL - 1) / kTL),
              (unsigned)((nq + kTQ - 1) / kTQ));
    const float* qs = q + (long long)q0 * W;
    float* os = out + (long long)q0 * NL;
    if (NL % 4 == 0)
      lb_kernel<W, true><<<grid, kThreads, 0, stream>>>(qs, lo, hi, os, nq,
                                                         NL, scale);
    else
      lb_kernel<W, false><<<grid, kThreads, 0, stream>>>(qs, lo, hi, os, nq,
                                                          NL, scale);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// route 0 (tiled) takes W (segments) in {4, 8, 16}: at 32 the staged tile
// would outgrow the 48 KB of static shared memory; route 1 (looped) takes
// any W >= 1.  q_paa, leaf_lo and leaf_hi are 16-byte aligned (the
// wrapper's tensors are fresh or realigned).  The wrapper checks the
// shapes.
extern "C" int lb_distance(const void* q_paa, const void* leaf_lo,
                           const void* leaf_hi, void* out, int Q,
                           long long NL, int W, float scale, int route,
                           void* stream) {
  if (Q == 0 || NL == 0) return 0;
  const float* q = static_cast<const float*>(q_paa);
  const float* lo = static_cast<const float*>(leaf_lo);
  const float* hi = static_cast<const float*>(leaf_hi);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1 && W >= 1) {
    for (int q0 = 0; q0 < Q; q0 += kMaxTiles * kLQ) {
      const int nq = Q - q0 < kMaxTiles * kLQ ? Q - q0 : kMaxTiles * kLQ;
      dim3 grid((unsigned)((NL + kTL - 1) / kTL),
                (unsigned)((nq + kLQ - 1) / kLQ));
      lb_looped<<<grid, kTL, 0, s>>>(q + (long long)q0 * W, lo, hi,
                                     o + (long long)q0 * NL, nq, NL, W,
                                     scale);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    return 0;
  }
  if (route == 0) {
    switch (W) {
      case 4: return launch<4>(q, lo, hi, o, Q, NL, scale, s);
      case 8: return launch<8>(q, lo, hi, o, Q, NL, scale, s);
      case 16: return launch<16>(q, lo, hi, o, Q, NL, scale, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* lb_distance_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
