// One refinement round of the exact k-NN search: for every query, the
// squared distances to the members of the K leaves its priority queue
// hands out this round, folded into the query's carried top-k buffer.
//
// Replaces the Pallas kernels `_refine_kernel`, `_refine_kernel_dma` and
// `_refine_kernel_triton` of src/repro/kernels/refine.py (wrapper
// `refine_topk`), which compute one function in three structures, and
// their fold `_rank_select`.
//
// Bound on this card: device memory, on the leaf bytes of the alive
// slots (alive slots * M * L * sizeof(T)).  Each leaf row is used once
// per query, so the dot products (2 * L flops per row) cannot hide the
// reads; the fold is O((k + M)^2) compares on data already in shared
// memory.
//
// Design: one block per query row walks that row's K slots in turn.  The
// query, its norm and the (k) buffer stay in shared memory.  A dead slot
// reads nothing.  For an alive slot the block's warps take the leaf's M
// rows; a lane reads 16 bytes of a row at a time (4 floats or 8 halves)
// at the stored width, and the warp reduces q.x in float32 by
// xor-shuffles.  d^2 = max((q_sq + |x|^2) - 2 q.x, 0), rounded step by
// step as the plain version writes it.  The fold ranks the union of the
// k buffer slots and the M candidates:
//   rank(e) = #{f : d_f < d_e or (d_f == d_e and f < e)},
// with buffer slots before candidates, a permutation of 0..k+M-1, so the
// thread of an element of rank < k writes it to that slot.  Folding the
// slots one after another gives the ties of one global fold over all
// K * M candidates, lower union index first, as `jax.lax.top_k` does.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T>
__global__ void refine_kernel(const float* __restrict__ q,
                              const float* __restrict__ q_sq,
                              const T* __restrict__ series,
                              const float* __restrict__ sq_norms,
                              const int* __restrict__ leaf_ids,
                              const uint8_t* __restrict__ alive,
                              const float* __restrict__ bsf_d,
                              const int* __restrict__ bsf_e,
                              float* __restrict__ out_d,
                              int* __restrict__ out_e,
                              int L, int K, int M, int k) {
  extern __shared__ float smem[];
  float* q_s = smem;                              // L
  float* cand_d = q_s + L;                        // M
  float* bd = cand_d + M;                         // the buffer: k + k
  int* be = reinterpret_cast<int*>(cand_d + M + k);
  float* nd = cand_d + M + 2 * k;                 // the next buffer
  int* ne = reinterpret_cast<int*>(cand_d + M + 3 * k);

  const int row = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < L; i += kThreads) q_s[i] = q[(long long)row * L + i];
  for (int i = tid; i < k; i += kThreads) {
    bd[i] = bsf_d[(long long)row * k + i];
    be[i] = bsf_e[(long long)row * k + i];
  }
  const float qsq = q_sq[row];
  __syncthreads();

  constexpr int kVec = 16 / sizeof(T);           // values per 16-byte load
  const int U = k + M;
  for (int j = 0; j < K; ++j) {
    if (!alive[(long long)row * K + j]) continue;  // uniform over the block
    const long long first = (long long)leaf_ids[(long long)row * K + j] * M;

    for (int r = warp; r < M; r += kWarps) {
      const uint4* x = reinterpret_cast<const uint4*>(series + (first + r) * L);
      float dot = 0.f;
      for (int c = lane; c < L / kVec; c += 32) {
        const uint4 raw = x[c];
        const T* t = reinterpret_cast<const T*>(&raw);
        const float4* qv = reinterpret_cast<const float4*>(q_s + c * kVec);
#pragma unroll
        for (int i = 0; i < kVec / 4; ++i) {
          const float4 qq = qv[i];
          dot += to_f32(t[4 * i]) * qq.x;
          dot += to_f32(t[4 * i + 1]) * qq.y;
          dot += to_f32(t[4 * i + 2]) * qq.z;
          dot += to_f32(t[4 * i + 3]) * qq.w;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      if (lane == 0) {
        const float s = __fadd_rn(qsq, sq_norms[first + r]);
        cand_d[r] = fmaxf(__fsub_rn(s, __fmul_rn(2.f, dot)), 0.f);
      }
    }
    __syncthreads();

    for (int e = tid; e < U; e += kThreads) {
      const float de = e < k ? bd[e] : cand_d[e - k];
      int rank = 0;
      for (int f = 0; f < U; ++f) {
        const float df = f < k ? bd[f] : cand_d[f - k];
        rank += (df < de) | ((df == de) & (f < e));
      }
      if (rank < k) {
        nd[rank] = de;
        ne[rank] = e < k ? be[e] : (int)(first + (e - k));
      }
    }
    float* td = bd; bd = nd; nd = td;       // every thread swaps alike
    int* te = be; be = ne; ne = te;
    __syncthreads();
  }

  for (int i = tid; i < k; i += kThreads) {
    out_d[(long long)row * k + i] = bd[i];
    out_e[(long long)row * k + i] = be[i];
  }
}

template <typename T>
cudaError_t launch(const float* q, const float* q_sq, const void* series,
                   const float* sq_norms, const int* ids, const uint8_t* alive,
                   const float* bsf_d, const int* bsf_e, float* out_d,
                   int* out_e, int Q, int L, int K, int M, int k,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)L + M + 4 * (size_t)k);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        refine_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  refine_kernel<T><<<Q, kThreads, smem, stream>>>(
      q, q_sq, static_cast<const T*>(series), sq_norms, ids, alive, bsf_d,
      bsf_e, out_d, out_e, L, K, M, k);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  L must be a multiple of
// 16 / sizeof(dtype) and the series 16-byte aligned; the wrapper checks.
extern "C" int refine_topk(const void* q, const void* q_sq,
                           const void* series, int dtype,
                           const void* sq_norms, const void* leaf_ids,
                           const void* alive, const void* bsf_d,
                           const void* bsf_e, void* out_d, void* out_e,
                           int Q, int L, int K, int M, int k, void* stream) {
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(qf, qs, series, xn, ids, al, bd, be, od, oe,
                                 Q, L, K, M, k, s);
    case 1: return launch<__nv_bfloat16>(qf, qs, series, xn, ids, al, bd, be,
                                         od, oe, Q, L, K, M, k, s);
    case 2: return launch<__half>(qf, qs, series, xn, ids, al, bd, be, od, oe,
                                  Q, L, K, M, k, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* refine_topk_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
