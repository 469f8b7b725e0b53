// iSAX summarization: optional z-normalization, PAA means over w segments
// and the symbol of each PAA value, in one pass over each series; on
// request also the series as float32 (normalized if asked) and its
// squared norm, which is what the index build stores.
//
// Replaces the Pallas kernel `_summarize_kernel` of
// src/repro/kernels/isax_summarize.py (wrapper `summarize`).
//
// Bound on this card: device memory.  Each series is read once
// (n * L * sizeof(T) bytes) and reduced to w floats and w symbols; the
// arithmetic (L adds, w binary searches over <= 255 breakpoints) is far
// below what the SMs do in the time the bytes take to arrive.
//
// Two routes.  A row's results depend only on the route and never on how
// many rows a launch holds or which rows lie beside it (the index builder
// summarizes parts of 2048 rows, the one-shot build all rows at once, and
// the two must store the same bits):
//
// lanes (route 0): one warp a row.  Lane l holds the VPT = L / 32
// consecutive values [l * VPT, (l + 1) * VPT) and loads them with 16-byte
// loads, so a warp reads its row as one contiguous run.  A segment of
// seg = L / w values spans seg / VPT lanes, whose partial sums meet by
// xor-shuffles (or, for short segments, lies inside one lane).  It takes
// L = 32 * VPT with VPT in {4, 8, 16, 32} (float32) or {8, 16, 32}
// (bfloat16), and segments that map onto lanes; the wrapper's `route`
// decides.
//
// strided (route 1): any L and w.  A group of G lanes takes a row, G the
// power of two >= min(w, 32); lane g owns segments g, g + G, ... and sums
// each one serially, so every statistic is a fixed-order sum of the
// lanes' serial partials met by a G-lane xor tree, whatever the shapes.
// A block of 256 threads takes R = 4 * 256 / G rows, four a group (fewer
// where R rows of L floats outgrow 47 KB), which are one contiguous span
// of R * L values:
// the block stages it in shared memory as float32 with 16-byte loads
// (where the span's base is 16-byte aligned; the wrapper aligns the
// tensor's base and R * L * sizeof(T) is a multiple of 16 for R >= 8),
// the groups read their rows from there, write the normalized values back
// in place, and the block writes the span out as 16-byte stores.  So the
// input is read once from memory and the series written once, however
// short the segments.  A row longer than the stage (L > 12,032) is read
// from memory by its group directly, value by value.
//
// z-normalization comes in two forms: znorm 1 is the TPU kernel's
// one-pass E[x^2] - mu^2; znorm 2 is the two-pass form of
// `isax.znormalize` (the mean, then the mean squared deviation), which
// the build uses.  Either divides by (sd + 1e-8).
//
// The breakpoint table sits in shared memory; the symbol is the number
// of breakpoints <= the PAA value (upper bound by binary search), which
// is what searchsorted(side="right") returns in the plain version.  The
// Pallas kernel counts breakpoints strictly below the value instead; the
// two differ only for a PAA value equal to a breakpoint (0.0 is one, at
// 8 bits), and the port follows the plain version.  The last block's rows
// past n are masked here; nothing is padded.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                 // rows per block
constexpr float kEps = 1e-8f;

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

struct Out {
  float* paa;
  int* words;
  float* xout;      // (n, L) float32 series, or null
  float* sqn;       // (n,) squared norms, or null (set with xout)
};

template <typename T, int VPT>
__global__ void summarize_kernel(const T* __restrict__ x,
                                 const float* __restrict__ bp, int nbp,
                                 Out o, long long n, int W, int znorm) {
  __shared__ float bp_s[256];
  for (int i = threadIdx.x; i < nbp; i += blockDim.x) bp_s[i] = bp[i];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n) return;                   // ragged last block
  constexpr int L = 32 * VPT;
  float v[VPT];
  load_row<T, VPT>(x + row * L, lane, v);

  if (znorm == 1) {                       // E[x^2] - mu^2, as the TPU kernel
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int i = 0; i < VPT; ++i) { s += v[i]; ss += v[i] * v[i]; }
    s = warp_sum(s);
    ss = warp_sum(ss);
    const float mu = s / L;
    const float var = ss / L - mu * mu;
    const float sd = sqrtf(fmaxf(var, 0.f)) + kEps;
#pragma unroll
    for (int i = 0; i < VPT; ++i) v[i] = (v[i] - mu) / sd;
  } else if (znorm == 2) {                // the mean, then the deviations
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < VPT; ++i) s += v[i];
    const float mu = warp_sum(s) / L;
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const float d = v[i] - mu;
      ss += d * d;
    }
    const float sd = sqrtf(warp_sum(ss) / L) + kEps;
#pragma unroll
    for (int i = 0; i < VPT; ++i) v[i] = (v[i] - mu) / sd;
  }

  if (o.xout != nullptr) {
    float4* dst = reinterpret_cast<float4*>(o.xout + row * L + lane * VPT);
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < VPT; i += 4) {
      dst[i / 4] = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
      sq += v[i] * v[i];
      sq += v[i + 1] * v[i + 1];
      sq += v[i + 2] * v[i + 2];
      sq += v[i + 3] * v[i + 3];
    }
    sq = warp_sum(sq);
    if (lane == 0) o.sqn[row] = sq;
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
      o.paa[row * W + sgi] = p;
      o.words[row * W + sgi] = upper_bound(bp_s, nbp, p);
    }
  } else {                                // VPT / seg segments in one lane
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {         // constant indices keep v in registers
      s += v[i];
      if ((i + 1) % seg == 0) {
        const int sgi = lane * (VPT / seg) + i / seg;
        const float p = s / seg;
        o.paa[row * W + sgi] = p;
        o.words[row * W + sgi] = upper_bound(bp_s, nbp, p);
        s = 0.f;
      }
    }
  }
}

constexpr int kThreads = 256;
constexpr int kStageFloats = (48 * 1024 - 1024) / 4;   // the span's room
constexpr int kRowsPerGroup = 4;         // strided route: rows a lane group

// xor tree over the G lanes of a group (G a power of two, mask the group)
__device__ __forceinline__ float group_sum(float s, int G, unsigned mask) {
  for (int off = G >> 1; off > 0; off >>= 1)
    s += __shfl_xor_sync(mask, s, off);
  return s;
}

// count values of src into the stage as float32: 16 bytes a load where
// src is 16-byte aligned, one value a load otherwise
template <typename T>
__device__ __forceinline__ void stage_in(const T* src, int count,
                                         float* tile) {
  constexpr int kPer = 16 / sizeof(T);
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int nvec = count / kPer;
    for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
      const uint4 raw = reinterpret_cast<const uint4*>(src)[i];
      const T* t = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int k = 0; k < kPer; k += 4)
        reinterpret_cast<float4*>(tile + i * kPer)[k / 4] = make_float4(
            to_f32(t[k]), to_f32(t[k + 1]), to_f32(t[k + 2]),
            to_f32(t[k + 3]));
    }
    done = nvec * kPer;
  }
  for (int i = done + threadIdx.x; i < count; i += blockDim.x)
    tile[i] = to_f32(src[i]);
}

// count floats of the stage out to dst, 16 bytes a store where aligned
__device__ __forceinline__ void stage_out(const float* tile, int count,
                                          float* dst) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    const int nvec = count / 4;
    for (int i = threadIdx.x; i < nvec; i += blockDim.x)
      reinterpret_cast<float4*>(dst)[i] =
          reinterpret_cast<const float4*>(tile)[i];
    done = nvec * 4;
  }
  for (int i = done + threadIdx.x; i < count; i += blockDim.x)
    dst[i] = tile[i];
}

template <typename T, bool kStaged>
__global__ void __launch_bounds__(kThreads)
summarize_strided(const T* __restrict__ x, const float* __restrict__ bp,
                  int nbp, Out o, long long n, int L, int W, int G, int R,
                  int znorm) {
  extern __shared__ __align__(16) float tile[];   // R * L staged values
  __shared__ float bp_s[256];
  for (int i = threadIdx.x; i < nbp; i += blockDim.x) bp_s[i] = bp[i];
  const long long row0 = (long long)blockIdx.x * R;
  const int rows = (int)min((long long)R, n - row0);
  if (kStaged) stage_in(x + row0 * L, rows * L, tile);
  __syncthreads();

  const int grp = threadIdx.x / G, g = threadIdx.x % G;
  const int lane = threadIdx.x & 31;
  const unsigned mask =
      G == 32 ? 0xffffffffu : ((1u << G) - 1) << (lane & ~(G - 1));
  for (int rr = grp; rr < rows; rr += kThreads / G) {
    const long long row = row0 + rr;
    float* v = tile + rr * L;             // the staged row
    const T* r = x + row * L;             // the row in memory
    auto get = [&](int j) { return kStaged ? v[j] : to_f32(r[j]); };
    const int seg = L / W;
    float mu = 0.f, sd = 1.f;
    if (znorm == 1) {                     // E[x^2] - mu^2, as the TPU kernel
      float s = 0.f, ss = 0.f;
      for (int sg = g; sg < W; sg += G)
        for (int j = sg * seg; j < (sg + 1) * seg; ++j) {
          const float a = get(j);
          s += a;
          ss += a * a;
        }
      mu = group_sum(s, G, mask) / L;
      sd = sqrtf(fmaxf(group_sum(ss, G, mask) / L - mu * mu, 0.f)) + kEps;
    } else if (znorm == 2) {              // the mean, then the deviations
      float s = 0.f;
      for (int sg = g; sg < W; sg += G)
        for (int j = sg * seg; j < (sg + 1) * seg; ++j) s += get(j);
      mu = group_sum(s, G, mask) / L;
      float ss = 0.f;
      for (int sg = g; sg < W; sg += G)
        for (int j = sg * seg; j < (sg + 1) * seg; ++j) {
          const float d = get(j) - mu;
          ss += d * d;
        }
      sd = sqrtf(group_sum(ss, G, mask) / L) + kEps;
    }
    float sq = 0.f;
    for (int sg = g; sg < W; sg += G) {
      float ps = 0.f;
      for (int j = sg * seg; j < (sg + 1) * seg; ++j) {
        float a = get(j);
        if (znorm) a = (a - mu) / sd;
        ps += a;
        sq += a * a;
        if (o.xout != nullptr) {
          if (kStaged) v[j] = a; else o.xout[row * L + j] = a;
        }
      }
      const float p = ps / seg;
      o.paa[row * W + sg] = p;
      o.words[row * W + sg] = upper_bound(bp_s, nbp, p);
    }
    if (o.xout != nullptr) {
      sq = group_sum(sq, G, mask);
      if (g == 0) o.sqn[row] = sq;
    }
  }
  if (kStaged && o.xout != nullptr) {
    __syncthreads();
    stage_out(tile, rows * L, o.xout + row0 * L);
  }
}

inline unsigned blocks_for(long long n) {
  return (unsigned)((n + kWarps - 1) / kWarps);
}

template <typename T, int VPT>
cudaError_t launch(const void* x, const float* bp, int nbp, Out o,
                   long long n, int W, int znorm, cudaStream_t stream) {
  summarize_kernel<T, VPT><<<blocks_for(n), 32 * kWarps, 0, stream>>>(
      static_cast<const T*>(x), bp, nbp, o, n, W, znorm);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_lanes(const void* x, const float* bp, int nbp, Out o,
                         long long n, int L, int W, int znorm,
                         cudaStream_t s) {
  switch (L / 32) {
    case 4:
      if constexpr (sizeof(T) == 4)
        return launch<T, 4>(x, bp, nbp, o, n, W, znorm, s);
      break;
    case 8: return launch<T, 8>(x, bp, nbp, o, n, W, znorm, s);
    case 16: return launch<T, 16>(x, bp, nbp, o, n, W, znorm, s);
    case 32: return launch<T, 32>(x, bp, nbp, o, n, W, znorm, s);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_strided(const void* x, const float* bp, int nbp, Out o,
                           long long n, int L, int W, int znorm,
                           cudaStream_t stream) {
  int G = 1;                              // lanes a row
  while (G < W && G < 32) G <<= 1;
  int R = kRowsPerGroup * kThreads / G;   // rows a block
  const bool staged = L <= kStageFloats;
  if (staged) R = min(R, kStageFloats / L);
  const unsigned blocks = (unsigned)((n + R - 1) / R);
  const T* xt = static_cast<const T*>(x);
  if (staged)
    summarize_strided<T, true><<<blocks, kThreads,
                                 (size_t)R * L * sizeof(float), stream>>>(
        xt, bp, nbp, o, n, L, W, G, R, znorm);
  else
    summarize_strided<T, false><<<blocks, kThreads, 0, stream>>>(
        xt, bp, nbp, o, n, L, W, G, R, znorm);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  route 0 (lanes): L = 32 * VPT with
// VPT in {4, 8, 16, 32} for float32 and {8, 16, 32} for bfloat16, x
// 16-byte aligned, segments that map onto lanes; route 1 (strided): any
// L divisible by W.  znorm: 0 none, 1 one-pass, 2 two-pass.  xout and sqn
// are both null or both (n, L) / (n,) float32.  The wrapper checks.
extern "C" int isax_summarize(const void* x, int dtype, const void* bp,
                              int nbp, void* paa, void* words, void* xout,
                              void* sqn, long long n, int L, int W,
                              int znorm, int route, void* stream) {
  if (n == 0) return 0;
  const float* b = static_cast<const float*>(bp);
  Out o = {static_cast<float*>(paa), static_cast<int*>(words),
           static_cast<float*>(xout), static_cast<float*>(sqn)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 0) {
    if (dtype == 0) return launch_lanes<float>(x, b, nbp, o, n, L, W, znorm, s);
    if (dtype == 1)
      return launch_lanes<__nv_bfloat16>(x, b, nbp, o, n, L, W, znorm, s);
  } else if (route == 1) {
    if (dtype == 0)
      return launch_strided<float>(x, b, nbp, o, n, L, W, znorm, s);
    if (dtype == 1)
      return launch_strided<__nv_bfloat16>(x, b, nbp, o, n, L, W, znorm, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* isax_summarize_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
