// Batched lower-bound (MINDIST) distances of every query PAA to every
// leaf region: out[q, l] = L/w * sum_s (max(lo - q, 0) + max(q - hi, 0))^2.
//
// Replaces the Pallas kernel `_lb_kernel` of
// src/repro/kernels/lb_distance.py (wrapper `lb_distance`).
//
// Bound on this card: the operations.  Each (query, leaf, segment) term
// takes five float32 instructions (two subtractions, two max, one FMA)
// that are not two-flop FMAs, so the count is Q * NL * w * 5 instructions
// at 132 SMs x 128 lanes x 1.98 GHz; the (Q, NL) float32 output at the
// memory rate comes second.
//
// Two routes.  tiled (route 0, w in {4, 8, 16}): a block owns a tile of
// kTQ queries by kTL leaves.  It stages the tile's query rows and its
// leaves' lo/hi rows in shared memory (the lo/hi rows transposed, one
// padded row per segment, so neither the coalesced fill nor the
// per-thread reads conflict on banks).  Thread t keeps leaf t's 2 * w
// edges in registers with w unrolled, then walks the kTQ queries; for
// each query the block's threads write kTL consecutive floats of one
// output row, so writes are coalesced along NL.  looped (route 1, any
// w): the same tile, with w a runtime loop: thread t reads leaf t's
// edges one segment at a time from memory and adds each segment's term
// to the kTQ queries' sums held in registers (the queries' values are
// read by all threads at once, a broadcast).  Both add the terms in
// segment order.
// Edges are clamped to +-1e30 as the JAX wrapper does; an invalid leaf
// (lo = hi = +inf) then gives (1e30)^2, which rounds to +inf in float32,
// the value the plain version gives.

#include <cuda_runtime.h>

namespace {

constexpr int kTL = 256;                 // leaves per block = threads
constexpr int kTQ = 32;                  // queries per block
constexpr float kBig = 1e30f;

__device__ __forceinline__ float clamp_edge(float v) {
  return fminf(fmaxf(v, -kBig), kBig);
}

template <int W>
__global__ void lb_kernel(const float* __restrict__ q_paa,
                          const float* __restrict__ lo,
                          const float* __restrict__ hi,
                          float* __restrict__ out, int Q, long long NL,
                          float scale) {
  __shared__ float q_s[kTQ][W];
  __shared__ float lo_s[W][kTL + 1];
  __shared__ float hi_s[W][kTL + 1];

  const long long l0 = (long long)blockIdx.x * kTL;
  const int q0 = blockIdx.y * kTQ;
  const int t = threadIdx.x;

  for (int e = t; e < kTL * W; e += kTL) {     // coalesced fill, transposed
    const int l = e / W, s = e % W;
    const bool in = l0 + l < NL;
    const float a = in ? lo[(l0 + l) * W + s] : kBig;
    const float b = in ? hi[(l0 + l) * W + s] : kBig;
    lo_s[s][l] = clamp_edge(a);
    hi_s[s][l] = clamp_edge(b);
  }
  for (int e = t; e < kTQ * W; e += kTL) {
    const int qi = e / W, s = e % W;
    q_s[qi][s] = q0 + qi < Q ? q_paa[(long long)(q0 + qi) * W + s] : 0.f;
  }
  __syncthreads();

  const long long l = l0 + t;
  if (l >= NL) return;
  float lo_r[W], hi_r[W];
#pragma unroll
  for (int s = 0; s < W; ++s) { lo_r[s] = lo_s[s][t]; hi_r[s] = hi_s[s][t]; }

  const int nq = min(kTQ, Q - q0);
  for (int qi = 0; qi < nq; ++qi) {
    float acc = 0.f;
#pragma unroll
    for (int s = 0; s < W; ++s) {
      const float qs = q_s[qi][s];
      const float d = fmaxf(lo_r[s] - qs, 0.f) + fmaxf(qs - hi_r[s], 0.f);
      acc += d * d;
    }
    out[(long long)(q0 + qi) * NL + l] = acc * scale;
  }
}

__global__ void lb_looped(const float* __restrict__ q_paa,
                          const float* __restrict__ lo,
                          const float* __restrict__ hi,
                          float* __restrict__ out, int Q, long long NL,
                          int W, float scale) {
  const long long l = (long long)blockIdx.x * kTL + threadIdx.x;
  const int q0 = blockIdx.y * kTQ;
  if (l >= NL) return;
  const int nq = min(kTQ, Q - q0);
  const float* qp = q_paa + (long long)q0 * W;
  float acc[kTQ];
#pragma unroll
  for (int qi = 0; qi < kTQ; ++qi) acc[qi] = 0.f;
  for (int s = 0; s < W; ++s) {
    const float a = clamp_edge(lo[l * W + s]);
    const float b = clamp_edge(hi[l * W + s]);
#pragma unroll
    for (int qi = 0; qi < kTQ; ++qi) {
      if (qi < nq) {
        const float qs = qp[qi * W + s];
        const float d = fmaxf(a - qs, 0.f) + fmaxf(qs - b, 0.f);
        acc[qi] += d * d;
      }
    }
  }
#pragma unroll
  for (int qi = 0; qi < kTQ; ++qi)
    if (qi < nq) out[(long long)(q0 + qi) * NL + l] = acc[qi] * scale;
}

template <int W>
cudaError_t launch(const float* q, const float* lo, const float* hi,
                   float* out, int Q, long long NL, float scale,
                   cudaStream_t stream) {
  dim3 grid((unsigned)((NL + kTL - 1) / kTL), (unsigned)((Q + kTQ - 1) / kTQ));
  lb_kernel<W><<<grid, kTL, 0, stream>>>(q, lo, hi, out, Q, NL, scale);
  return cudaGetLastError();
}

}  // namespace

// route 0 (tiled) takes W (segments) in {4, 8, 16}: at 32 the staged tile
// would outgrow the 48 KB of static shared memory; route 1 (looped) takes
// any W >= 1.  The wrapper checks the shapes.
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
    dim3 grid((unsigned)((NL + kTL - 1) / kTL),
              (unsigned)((Q + kTQ - 1) / kTQ));
    lb_looped<<<grid, kTL, 0, s>>>(q, lo, hi, o, Q, NL, W, scale);
    return (int)cudaGetLastError();
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
