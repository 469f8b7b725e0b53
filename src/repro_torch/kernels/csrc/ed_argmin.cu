// Exact 1-NN scan: for every query, the least squared Euclidean distance
// to any candidate and that candidate's index,
//   d^2 = max(|q|^2 + |x|^2 - 2 q.x, 0) in float32,
// ties to the lowest index.
//
// Replaces the Pallas kernel `_ed_kernel` of
// src/repro/kernels/ed_argmin.py (wrapper `ed_argmin`).
//
// Bound on this card: operations.  At Q = 256 queries, N = 2^24
// candidates and L = 256, the 2 * Q * N * L = 2.2e12 float32 operations
// take 32.8 ms at 67 TFLOP/s, and reading the 16 GiB of candidates takes
// 5.1 ms at 3.35 TB/s.  The TF32 tensor cores would keep about three
// decimal digits of q.x, too few for d^2 of z-normalized rows at rtol
// 1e-4, so the products are float32 FMAs.
//
// Design: the TPU kernel walks candidate blocks on a sequential grid axis
// and carries (min, argmin) in its output tile.  Here a block owns a tile
// of kBQ queries and loops over a contiguous range of candidate tiles of
// kBN rows; the ranges split the candidates so that about two blocks run
// on every SM.  Per candidate tile, slices of kBK columns of the query
// and candidate tiles are staged transposed in shared memory (two
// buffers, the next slice loaded into registers while the current one is
// used), and each of the 256 threads accumulates an 8 x 8 tile of q.x in
// registers.  |q|^2 is summed once per block, |x|^2 from the slices as
// they are loaded; candidates are read once per tile at their stored
// width (float32 or bfloat16, 16 bytes a load).  Each thread keeps, per
// query row, the least key
//   (float_bits(d^2) << 32) | index,
// which for d^2 >= 0 (the clamp turns -0.0 into +0.0) orders by least
// d^2, then lowest index: the JAX tie rule.  Threads of a row combine
// their keys by shuffles and one 64-bit atomicMin per query and block
// merges the blocks in whatever order they run.  A last small kernel
// unpacks the keys.  Ragged Q and N are masked, not padded; row offsets
// are 64-bit (2^24 x 256 elements is 2^32).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 128;           // queries per block
constexpr int kBN = 128;           // candidates per tile
constexpr int kBK = 16;            // columns per staged slice
constexpr int kThreads = 256;      // 16 x 16, each an 8 x 8 output tile
constexpr int kLd = kBQ + 4;       // padded row of a transposed slice

// One thread's share of a (128 x kBK) slice of candidates: 2 float4 of
// float32 rows, or 1 uint4 (8 values) of bfloat16 rows.
template <typename T> struct Slice;

template <> struct Slice<float> {
  static constexpr int kLoads = 2;
  static constexpr int kPerLoad = 4;
  static constexpr int kLanesPerRow = kBK / 4;   // 4 threads share a row
  uint4 raw[kLoads];
};

template <> struct Slice<__nv_bfloat16> {
  static constexpr int kLoads = 1;
  static constexpr int kPerLoad = 8;
  static constexpr int kLanesPerRow = kBK / 8;   // 2 threads share a row
  uint4 raw[kLoads];
};

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

// Load slice k0 of rows [r0, r0 + 128) of a (rows, L) matrix into
// registers; rows >= rows_n and columns >= L read as zeros.
template <typename T>
__device__ __forceinline__ void load_slice(const T* __restrict__ m,
                                           long long r0, long long rows_n,
                                           int L, int k0, int tid,
                                           Slice<T>& s) {
  using S = Slice<T>;
#pragma unroll
  for (int i = 0; i < S::kLoads; ++i) {
    const int e = tid + i * kThreads;
    const int row = e / S::kLanesPerRow;
    const int col = k0 + (e % S::kLanesPerRow) * S::kPerLoad;
    if (r0 + row < rows_n && col < L)
      s.raw[i] = *reinterpret_cast<const uint4*>(m + (r0 + row) * L + col);
    else
      s.raw[i] = make_uint4(0u, 0u, 0u, 0u);
  }
}

// Store a slice transposed into dst[kBK][kLd] and, unless sq is null, add
// each value's square to this thread's partial row norms sq[i].
template <typename T>
__device__ __forceinline__ void store_slice(const Slice<T>& s, int tid,
                                            float (*dst)[kLd], float* sq) {
  using S = Slice<T>;
#pragma unroll
  for (int i = 0; i < S::kLoads; ++i) {
    const int e = tid + i * kThreads;
    const int row = e / S::kLanesPerRow;
    const int c = (e % S::kLanesPerRow) * S::kPerLoad;
    float v[S::kPerLoad];
    unpack(s.raw[i], v, T());
#pragma unroll
    for (int j = 0; j < S::kPerLoad; ++j) {
      dst[c + j][row] = v[j];
      if (sq != nullptr) sq[i] = fmaf(v[j], v[j], sq[i]);
    }
  }
}

__device__ __forceinline__ unsigned long long umin64(unsigned long long a,
                                                     unsigned long long b) {
  return a < b ? a : b;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ed_argmin_kernel(const float* __restrict__ q, const T* __restrict__ xs,
                 unsigned long long* __restrict__ keys, int Q, long long N,
                 int L, long long tiles_per_block) {
  using S = Slice<T>;
  __shared__ __align__(16) float q_s[2][kBK][kLd];
  __shared__ __align__(16) float x_s[2][kBK][kLd];
  __shared__ float qq_s[kBQ];
  __shared__ float xx_s[kBN];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * kBQ;
  const long long n_tiles = (N + kBN - 1) / kBN;
  const long long t_begin = (long long)blockIdx.y * tiles_per_block;
  const long long t_end = min(n_tiles, t_begin + tiles_per_block);

  {  // |q|^2 of the block's queries: two threads per row, then a shuffle
    const int row = tid / 2;
    float acc = 0.f;
    if (q0 + row < Q) {
      const float* qr = q + (long long)(q0 + row) * L;
      for (int c = (tid & 1) * 4; c < L; c += 8) {
        const float4 v = *reinterpret_cast<const float4*>(qr + c);
        acc = fmaf(v.x, v.x, acc);
        acc = fmaf(v.y, v.y, acc);
        acc = fmaf(v.z, v.z, acc);
        acc = fmaf(v.w, v.w, acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if ((tid & 1) == 0) qq_s[row] = acc;
  }

  unsigned long long best[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) best[i] = ~0ull;

  const int n_slices = (L + kBK - 1) / kBK;
  for (long long tile = t_begin; tile < t_end; ++tile) {
    const long long n0 = tile * kBN;
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    float sq[S::kLoads];
#pragma unroll
    for (int i = 0; i < S::kLoads; ++i) sq[i] = 0.f;

    Slice<float> qreg;
    Slice<T> xreg;
    load_slice<float>(q, q0, Q, L, 0, tid, qreg);
    load_slice<T>(xs, n0, N, L, 0, tid, xreg);
    store_slice<float>(qreg, tid, q_s[0], nullptr);
    store_slice<T>(xreg, tid, x_s[0], sq);
    __syncthreads();

    for (int s = 0; s < n_slices; ++s) {
      const int cur = s & 1;
      const bool more = s + 1 < n_slices;
      if (more) {
        load_slice<float>(q, q0, Q, L, (s + 1) * kBK, tid, qreg);
        load_slice<T>(xs, n0, N, L, (s + 1) * kBK, tid, xreg);
      }
#pragma unroll
      for (int k = 0; k < kBK; ++k) {
        const float4 a0 = *reinterpret_cast<const float4*>(&q_s[cur][k][ty * 4]);
        const float4 a1 =
            *reinterpret_cast<const float4*>(&q_s[cur][k][64 + ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&x_s[cur][k][tx * 4]);
        const float4 b1 =
            *reinterpret_cast<const float4*>(&x_s[cur][k][64 + tx * 4]);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      if (more) {
        store_slice<float>(qreg, tid, q_s[cur ^ 1], nullptr);
        store_slice<T>(xreg, tid, x_s[cur ^ 1], sq);
      }
      __syncthreads();
    }

    // |x|^2 of the tile's rows: the threads that loaded a row meet
#pragma unroll
    for (int i = 0; i < S::kLoads; ++i) {
      float v = sq[i];
#pragma unroll
      for (int off = 1; off < S::kLanesPerRow; off <<= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      const int e = tid + i * kThreads;
      if (e % S::kLanesPerRow == 0) xx_s[e / S::kLanesPerRow] = v;
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = (j < 4 ? 0 : 64) + tx * 4 + (j & 3);
      const long long n = n0 + c;
      if (n >= N) continue;
      const float xx = xx_s[c];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = (i < 4 ? 0 : 64) + ty * 4 + (i & 3);
        // rounded step by step as the plain version writes it
        float d = __fsub_rn(__fadd_rn(qq_s[r], xx), __fmul_rn(2.f, acc[i][j]));
        d = d > 0.f ? d : 0.f;                        // and -0.0 -> +0.0
        const unsigned long long key =
            ((unsigned long long)__float_as_uint(d) << 32) |
            (unsigned long long)(unsigned)n;
        best[i] = umin64(best[i], key);
      }
    }
    // xx_s is rewritten only after the next tile's slice barriers
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    unsigned long long v = best[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      v = umin64(v, __shfl_xor_sync(0xffffffffu, v, off));
    const int r = (i < 4 ? 0 : 64) + ty * 4 + (i & 3);
    if (tx == 0 && q0 + r < Q && v != ~0ull) atomicMin(&keys[q0 + r], v);
  }
}

__global__ void unpack_kernel(const unsigned long long* __restrict__ keys,
                              float* __restrict__ d, int* __restrict__ idx,
                              int Q) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Q) return;
  const unsigned long long k = keys[i];
  d[i] = __uint_as_float((unsigned)(k >> 32));
  idx[i] = (int)(unsigned)(k & 0xffffffffull);
}

template <typename T>
cudaError_t launch(const float* q, const void* xs, unsigned long long* keys,
                   float* d, int* idx, int Q, long long N, int L,
                   cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(keys, 0xff, sizeof(unsigned long long) * Q, stream);
  if (err != cudaSuccess) return err;
  const int q_tiles = (Q + kBQ - 1) / kBQ;
  const long long n_tiles = (N + kBN - 1) / kBN;
  // about two blocks per SM in all, each over a contiguous candidate range
  long long ranges = (2LL * sms + q_tiles - 1) / q_tiles;
  if (ranges > n_tiles) ranges = n_tiles;
  if (ranges < 1) ranges = 1;
  const long long per = (n_tiles + ranges - 1) / ranges;
  ranges = (n_tiles + per - 1) / per;
  dim3 grid((unsigned)q_tiles, (unsigned)ranges);
  ed_argmin_kernel<T><<<grid, kThreads, 0, stream>>>(
      q, static_cast<const T*>(xs), keys, Q, N, L, per);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  unpack_kernel<<<(Q + 255) / 256, 256, 0, stream>>>(keys, d, idx, Q);
  return cudaGetLastError();
}

}  // namespace

// dtype of xs: 0 = float32, 1 = bfloat16; q is float32.  L must be a
// multiple of 8 and q, xs 16-byte aligned (the wrapper checks); keys is
// (Q,) 64-bit scratch.  Q >= 1 and N >= 1.
extern "C" int ed_argmin(const void* q, const void* xs, int dtype, void* keys,
                         void* out_d, void* out_idx, int Q, long long N,
                         int L, void* stream) {
  if (Q <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  const float* qf = static_cast<const float*>(q);
  unsigned long long* k = static_cast<unsigned long long*>(keys);
  float* d = static_cast<float*>(out_d);
  int* i = static_cast<int*>(out_idx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch<float>(qf, xs, k, d, i, Q, N, L, s);
    case 1: return (int)launch<__nv_bfloat16>(qf, xs, k, d, i, Q, N, L, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* ed_argmin_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
