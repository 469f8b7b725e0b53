// iSAX summarization: optional z-normalization, PAA means over w segments
// and the symbol of each PAA value, in one pass over each series.
//
// Replaces the Pallas kernel `_summarize_kernel` of
// src/repro/kernels/isax_summarize.py (wrapper `summarize`).
//
// Bound on this card: device memory.  Each series is read once
// (n * L * sizeof(T) bytes) and reduced to w floats and w symbols; the
// arithmetic (L adds, w binary searches over <= 255 breakpoints) is far
// below what the SMs do in the time the bytes take to arrive.
//
// Design: one warp per series.  Lane l holds the VPT = L / 32 consecutive
// values [l * VPT, (l + 1) * VPT) and loads them with 16-byte loads, so a
// warp reads its row as one contiguous run.  A segment of seg = L / w
// values spans seg / VPT lanes, whose partial sums meet by xor-shuffles
// (or, for short segments, lies inside one lane).  The breakpoint table
// sits in shared memory; the symbol is the number of breakpoints <= the
// PAA value (upper bound by binary search), which is what
// searchsorted(side="right") returns in the plain version.  The Pallas
// kernel counts breakpoints strictly below the value instead; the two
// differ only for a PAA value equal to a breakpoint (0.0 is one, at
// 8 bits), and the port follows the plain version.  The last block's
// rows past n are masked here; nothing is padded.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                 // rows per block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, int VPT>
__device__ __forceinline__ void load_row(const T* row, int lane, float* v) {
  constexpr int kPer16 = 16 / sizeof(T);  // values per 16-byte load
  static_assert(VPT % kPer16 == 0, "lane slice must be whole 16-byte loads");
  const uint4* src = reinterpret_cast<const uint4*>(row + lane * VPT);
#pragma unroll
  for (int c = 0; c < VPT / kPer16; ++c) {
    uint4 raw = src[c];
    const T* t = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < kPer16; ++i) v[c * kPer16 + i] = to_f32(t[i]);
  }
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

__device__ __forceinline__ int upper_bound(const float* bp, int nbp, float p) {
  int lo = 0, hi = nbp;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (bp[mid] <= p) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <typename T, int VPT>
__global__ void summarize_kernel(const T* __restrict__ x,
                                 const float* __restrict__ bp, int nbp,
                                 float* __restrict__ paa,
                                 int* __restrict__ words, long long n,
                                 int W, int znorm) {
  __shared__ float bp_s[256];
  for (int i = threadIdx.x; i < nbp; i += blockDim.x) bp_s[i] = bp[i];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n) return;                   // ragged last block
  constexpr int L = 32 * VPT;
  float v[VPT];
  load_row<T, VPT>(x + row * L, lane, v);

  if (znorm) {                            // E[x^2] - mu^2, as the TPU kernel
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int i = 0; i < VPT; ++i) { s += v[i]; ss += v[i] * v[i]; }
    s = warp_sum(s);
    ss = warp_sum(ss);
    const float mu = s / L;
    const float var = ss / L - mu * mu;
    const float sd = sqrtf(fmaxf(var, 0.f)) + 1e-8f;
#pragma unroll
    for (int i = 0; i < VPT; ++i) v[i] = (v[i] - mu) / sd;
  }

  const int seg = L / W;
  if (seg >= VPT) {                       // a segment spans G = seg / VPT lanes
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < VPT; ++i) s += v[i];
    const int G = seg / VPT;
    for (int off = G >> 1; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane % G == 0) {
      const int sgi = lane / G;
      const float p = s / seg;
      paa[row * W + sgi] = p;
      words[row * W + sgi] = upper_bound(bp_s, nbp, p);
    }
  } else {                                // VPT / seg segments in one lane
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {         // constant indices keep v in registers
      s += v[i];
      if ((i + 1) % seg == 0) {
        const int sgi = lane * (VPT / seg) + i / seg;
        const float p = s / seg;
        paa[row * W + sgi] = p;
        words[row * W + sgi] = upper_bound(bp_s, nbp, p);
        s = 0.f;
      }
    }
  }
}

template <typename T, int VPT>
cudaError_t launch(const void* x, const float* bp, int nbp, float* paa,
                   int* words, long long n, int W, int znorm,
                   cudaStream_t stream) {
  const long long blocks = (n + kWarps - 1) / kWarps;
  summarize_kernel<T, VPT><<<(unsigned)blocks, 32 * kWarps, 0, stream>>>(
      static_cast<const T*>(x), bp, nbp, paa, words, n, W, znorm);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  L = 32 * VPT with VPT in {4, 8, 16, 32}
// for float32 and {8, 16, 32} for bfloat16; the wrapper checks the shapes.
extern "C" int isax_summarize(const void* x, int dtype, const void* bp,
                              int nbp, void* paa, void* words, long long n,
                              int L, int W, int znorm, void* stream) {
  if (n == 0) return 0;
  const float* b = static_cast<const float*>(bp);
  float* p = static_cast<float*>(paa);
  int* w = static_cast<int*>(words);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vpt = L / 32;
  if (dtype == 0) {
    switch (vpt) {
      case 4: return launch<float, 4>(x, b, nbp, p, w, n, W, znorm, s);
      case 8: return launch<float, 8>(x, b, nbp, p, w, n, W, znorm, s);
      case 16: return launch<float, 16>(x, b, nbp, p, w, n, W, znorm, s);
      case 32: return launch<float, 32>(x, b, nbp, p, w, n, W, znorm, s);
    }
  } else if (dtype == 1) {
    switch (vpt) {
      case 8: return launch<__nv_bfloat16, 8>(x, b, nbp, p, w, n, W, znorm, s);
      case 16: return launch<__nv_bfloat16, 16>(x, b, nbp, p, w, n, W, znorm, s);
      case 32: return launch<__nv_bfloat16, 32>(x, b, nbp, p, w, n, W, znorm, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* isax_summarize_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
