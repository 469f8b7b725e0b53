// Causal and/or sliding-window softmax attention with grouped KV heads:
//   o[b, h, t] = softmax_s(mask(q[b, h, t] . k[b, h // G, s] * dh^-0.5))
//                . v[b, h // G, s],          G = Hq / Hkv,
// with masked scores set to the finite -1e30, so that a query row that
// sees no key gets the mean of V over all S keys.  float32 or bfloat16
// in, the output in the input's type; all arithmetic in float32.
//
// Replaces the Pallas kernel `_flash_kernel` of
// src/repro/kernels/flash_attention.py (wrapper `flash_attention`).
//
// Bound on this card: operations.  At B = 1, Hq = 32, Hkv = 8,
// T = S = 4096, dh = 128, bf16, causal, the 4 * dh flops of each of the
// 8.4e6 visible (query, key) pairs per head make 1.37e11 operations,
// 0.139 ms at the 989 TFLOP/s bf16 tensor peak; the 84 MB of Q, K, V and
// O take 0.025 ms.  This kernel does those operations as float32 FMAs
// outside the tensor cores (67 TFLOP/s), so its own floor is 2.05 ms.
//
// Design: the TPU kernel holds a head's whole (S, dh) K and V in VMEM;
// here a block of 256 threads owns kBQ = 64 query rows of one head and
// streams kBKV = 64-key tiles of K and V of the KV head h // G through
// shared memory, with an online softmax: a running max m and sum l per
// row in float32, O accumulated in float32 registers and rescaled by
// exp(m_old - m_new) when the max grows.  Q and K tiles are stored
// transposed so that each thread reads float4 columns for its 4 x 4
// block of scores; the 16 threads of a row group meet by shuffles for
// the row max and sum; P goes through shared memory (transposed) into
// the P.V product, where a thread owns 4 rows x dh/16 columns of O.
// Keys past S score -inf and so count for nothing; masked keys score
// -1e30 exactly as in the plain version.  Tiles outside every row's
// visible range are skipped, unless a row of the block sees no key:
// then every tile is visited, so that row averages all of V.  Blocks
// start with the last query blocks, which have the most causal work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;            // query rows per block
constexpr int kBKV = 64;           // keys per tile
constexpr int kThreads = 256;      // 16 row groups x 16 threads
constexpr int kLd = 64 + 4;        // padded row of a transposed tile
constexpr float kNegInf = -1e30f;  // the mask value of repro and ref.py

__device__ __forceinline__ void unpack(const uint4& raw, float* out, float) {
  const float* f = reinterpret_cast<const float*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = f[i];
}

__device__ __forceinline__ void unpack(const uint4& raw, float* out,
                                       __nv_bfloat16) {
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = __bfloat162float(h[i]);
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Copy rows [r0, r0 + 64) of a (rows_n, DH) matrix into shared memory as
// float32, transposed (dst[d * kLd + row]) or not (dst[row * (DH + 4) + d]);
// rows >= rows_n read as zeros.
template <typename T, int DH, bool kTranspose>
__device__ __forceinline__ void load_tile(const T* __restrict__ m,
                                          long long r0, long long rows_n,
                                          float* dst, int tid) {
  constexpr int kPer = 16 / sizeof(T);
  constexpr int kChunks = DH / kPer;               // 16-byte loads per row
  for (int e = tid; e < 64 * kChunks; e += kThreads) {
    const int row = e / kChunks, c = (e % kChunks) * kPer;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + row < rows_n)
      raw = *reinterpret_cast<const uint4*>(m + (r0 + row) * DH + c);
    float v[kPer];
    unpack(raw, v, T());
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (kTranspose) dst[(c + j) * kLd + row] = v[j];
      else dst[row * (DH + 4) + c + j] = v[j];
    }
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int Hq, int Hkv,
             int Tq, int S, int causal, int window, float scale) {
  constexpr int kCpt = DH / 16;                    // O columns per thread
  extern __shared__ __align__(16) float smem[];
  float* q_t = smem;                               // [DH][kLd]
  float* k_t = q_t + DH * kLd;                     // [DH][kLd]
  float* v_s = k_t + DH * kLd;                     // [kBKV][DH + 4]
  float* p_t = v_s + kBKV * (DH + 4);              // [kBKV][kLd]
  __shared__ int any_empty;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int qb = gridDim.x - 1 - blockIdx.x;       // heaviest blocks first
  const int q0 = qb * kBQ;
  const int bh = blockIdx.y;                       // b * Hq + h
  const int b = bh / Hq, h = bh % Hq;
  const int kvh = b * Hkv + h / (Hq / Hkv);
  const T* qp = q + (long long)bh * Tq * DH;
  const T* kp = k + (long long)kvh * S * DH;
  const T* vp = v + (long long)kvh * S * DH;

  // the visible keys of row r are [lo(r), hi(r)]; both grow with r
  const int q_last = min(q0 + kBQ, Tq) - 1;
  if (tid == 0) any_empty = 0;
  __syncthreads();
  if (tid < kBQ && q0 + tid <= q_last) {
    const int r = q0 + tid;
    const int lo = window > 0 ? max(0, r - window + 1) : 0;
    const int hi = causal ? min(S - 1, r) : S - 1;
    if (lo > hi) any_empty = 1;
  }
  load_tile<T, DH, true>(qp, q0, Tq, q_t, tid);
  __syncthreads();
  const int n_tiles = (S + kBKV - 1) / kBKV;
  int t_begin = 0, t_end = n_tiles;
  if (!any_empty) {
    const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
    const int k_hi = causal ? min(S - 1, q_last) : S - 1;
    t_begin = k_lo / kBKV;
    t_end = k_hi / kBKV + 1;
  }

  float m[4], l[4], acc[4][kCpt];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCpt; ++c) acc[i][c] = 0.f;
  }

  for (int tile = t_begin; tile < t_end; ++tile) {
    const int k0 = tile * kBKV;
    __syncthreads();                     // the last tile's P.V is done
    load_tile<T, DH, true>(kp, k0, S, k_t, tid);
    load_tile<T, DH, false>(vp, k0, S, v_s, tid);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(q_t + d * kLd + ty * 4);
      const float4 bb = *reinterpret_cast<const float4*>(k_t + d * kLd + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx * 4 + j;
        float x = __fmul_rn(s[i][j], scale);
        if (kpos >= S) x = -INFINITY;
        else if ((causal && r < kpos) || (window > 0 && kpos <= r - window))
          x = kNegInf;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[i][j] = expf(s[i][j] - m_new);
        sum += p[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCpt; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(p_t + (tx * 4 + j) * kLd + ty * 4) =
          make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBKV; ++j) {
      const float4 pv = *reinterpret_cast<const float4*>(p_t + j * kLd + ty * 4);
      const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
      const float* vr = v_s + j * (DH + 4) + tx * kCpt;
      float vv[kCpt];
#pragma unroll
      for (int c = 0; c < kCpt; ++c) vv[c] = vr[c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < kCpt; ++c) acc[i][c] = fmaf(pr[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= Tq) continue;
    T* orow = o + ((long long)bh * Tq + r) * DH + tx * kCpt;
#pragma unroll
    for (int c = 0; c < kCpt; ++c) store_out(orow + c, acc[i][c] / l[i]);
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Hq, int Hkv, int Tq, int S, int causal,
                   int window, float scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (2 * (size_t)DH * kLd + (size_t)kBKV * (DH + 4) +
                       (size_t)kBKV * kLd);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)((Tq + kBQ - 1) / kBQ), (unsigned)(B * Hq));
  flash_kernel<T, DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Hq, Hkv, Tq, S, causal,
      window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dh(const void* q, const void* k, const void* v, void* o,
                      int B, int Hq, int Hkv, int Tq, int S, int dh,
                      int causal, int window, float scale,
                      cudaStream_t stream) {
  switch (dh) {
    case 32: return launch<T, 32>(q, k, v, o, B, Hq, Hkv, Tq, S, causal,
                                  window, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, Hq, Hkv, Tq, S, causal,
                                  window, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, Hq, Hkv, Tq, S, causal,
                                    window, scale, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o alike); dh in
// {32, 64, 128}; Hq a multiple of Hkv; tensors contiguous and 16-byte
// aligned (the wrapper checks).  window 0 means no window.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int dtype, int B, int Hq, int Hkv,
                               int Tq, int S, int dh, int causal, int window,
                               float scale, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv || Tq <= 0 || S <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_dh<float>(q, k, v, o, B, Hq, Hkv, Tq, S, dh,
                                         causal, window, scale, s);
    case 1: return (int)launch_dh<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, Tq,
                                                 S, dh, causal, window,
                                                 scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
