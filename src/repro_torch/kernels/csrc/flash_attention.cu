// Causal and/or sliding-window softmax attention with grouped KV heads:
//   o[b, h, t] = softmax_s(mask(q[b, h, t] . k[b, h // G, s] * dh^-0.5))
//                . v[b, h // G, s],          G = Hq / Hkv,
// with masked scores set to the finite -1e30, so that a query row that
// sees no key gets the mean of V over all S keys.  float32 or bfloat16
// in, the output in the input's type.
//
// Replaces the Pallas kernel `_flash_kernel` of
// src/repro/kernels/flash_attention.py (wrapper `flash_attention`).
//
// Two routes, by dtype:
//
// * bfloat16: `tc::flash_tc_kernel`, on the tensor cores (wgmma, TMA).
//   Bound on this card: operations.  At B = 1, Hq = 32, Hkv = 8,
//   T = S = 4096, dh = 128, causal, the 4 * dh flops of each of the 8.4e6
//   visible (query, key) pairs per head make 1.37e11 operations, 0.139 ms
//   at the 989 TFLOP/s bf16 tensor peak; the 84 MB of Q, K, V and O take
//   0.025 ms.  This kernel carries P at float32 accuracy as two bf16
//   operands, P = P_hi + P_lo, so it does 6 * dh flops per pair: its own
//   floor is 0.208 ms.  Why: the check holds a bf16 output to the float32
//   plain version at 2^-8 |o| + 2e-5, and the output's own rounding takes
//   up to 2^-9 |o| of that.  Rounding P to bf16 (as repro's TPU kernel
//   does) errs by 2^-9 relative per term, which is more than the rest
//   where the terms of an output cancel; P_hi + P_lo errs by ~2^-17.
//   Design: a block owns 128 query rows of one head; warpgroups 0 and 1
//   each own 64 of them, warpgroup 2 is the producer, whose one thread
//   keeps TMA loads of 128-key K and V tiles of the KV head h // G in a
//   two-stage ring in shared memory (mbarriers for full and empty).  Per
//   round a consumer warpgroup issues S_i = Q.K_i^T as wgmma from shared
//   memory (f32 accumulators) and then O += P_hi.V + P_lo.V of the last
//   round as wgmma with P from registers and V from shared memory (V's
//   rows are the k of that product: the MN-major form).  It runs the
//   mask, max, exp and sum of S_i's online softmax while that P.V is
//   still on the tensor cores (the exponentials as single SFU
//   instructions), and only then rescales O by exp2(m_old - m_new) and
//   splits the new P.  The two warpgroups take
//   turns to issue (named barriers), so that one's softmax overlaps the
//   other's products.  Keys past S score -inf, masked keys -1e30, as in
//   the plain version; the mask is applied only to tiles that cross an
//   edge.  Tiles outside every row's visible range are skipped unless a
//   row of the block sees no key; blocks start with the last query
//   blocks, which have the most causal work.  The producer warpgroup
//   gives its registers to the consumers (setmaxnreg).
//
// * float32: `simt::flash_kernel`, float32 FMAs outside the tensor cores.
//   The check holds it at 2e-5, which neither bf16 operands nor a single
//   tf32 product reach.  A block of 256 threads owns 64 query rows of one
//   head and streams 64-key tiles of K and V through shared memory with
//   the same online softmax: Q and K tiles transposed so that each thread
//   reads float4 columns for its 4 x 4 block of scores, the 16 threads of
//   a row group meeting by shuffles for the row max and sum, P through
//   shared memory (transposed) into the P.V product, where a thread owns
//   4 rows x dh/16 columns of O.  Its floor at the shape above would be
//   2.05 ms (the same 1.37e11 flops at 67 TFLOP/s).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace simt {

constexpr int kBQ = 64;            // query rows per block
constexpr int kBKV = 64;           // keys per tile
constexpr int kThreads = 256;      // 16 row groups x 16 threads
constexpr int kLd = 64 + 4;        // padded row of a transposed tile
constexpr float kNegInf = -1e30f;  // the mask value of repro and ref.py

// Copy rows [r0, r0 + 64) of a (rows_n, DH) matrix into shared memory as
// float32, transposed (dst[d * kLd + row]) or not (dst[row * (DH + 4) + d]);
// rows >= rows_n read as zeros.
template <int DH, bool kTranspose>
__device__ __forceinline__ void load_tile(const float* __restrict__ m,
                                          long long r0, long long rows_n,
                                          float* dst, int tid) {
  constexpr int kChunks = DH / 4;                 // 16-byte loads per row
  for (int e = tid; e < 64 * kChunks; e += kThreads) {
    const int row = e / kChunks, c = (e % kChunks) * 4;
    float4 raw = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + row < rows_n)
      raw = *reinterpret_cast<const float4*>(m + (r0 + row) * DH + c);
    const float v[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (kTranspose) dst[(c + j) * kLd + row] = v[j];
      else dst[row * (DH + 4) + c + j] = v[j];
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o, int Hq,
             int Hkv, int Tq, int S, int causal, int window,
             float scale) {
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
  const float* qp = q + (long long)bh * Tq * DH;
  const float* kp = k + (long long)kvh * S * DH;
  const float* vp = v + (long long)kvh * S * DH;

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
  load_tile<DH, true>(qp, q0, Tq, q_t, tid);
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
    load_tile<DH, true>(kp, k0, S, k_t, tid);
    load_tile<DH, false>(vp, k0, S, v_s, tid);
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
    float* orow = o + ((long long)bh * Tq + r) * DH + tx * kCpt;
#pragma unroll
    for (int c = 0; c < kCpt; ++c) orow[c] = acc[i][c] / l[i];
  }
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Hq, int Hkv, int Tq, int S, int causal,
                   int window, float scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (2 * (size_t)DH * kLd + (size_t)kBKV * (DH + 4) +
                       (size_t)kBKV * kLd);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)((Tq + kBQ - 1) / kBQ), (unsigned)(B * Hq));
  flash_kernel<DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Hq, Hkv, Tq, S,
      causal, window, scale);
  return cudaGetLastError();
}


}  // namespace simt

namespace tc {

using namespace sm90;

constexpr int kBM = 128;           // query rows per block
constexpr int kBN = 128;           // keys per K/V tile
constexpr int kStages = 2;         // K/V tiles in flight
constexpr int kThreads = 384;      // warpgroups 0, 1 consume, 2 loads
constexpr int kConsumers = 256;
constexpr int kTurn = 2;           // named barriers 2, 3: whose turn to issue
constexpr float kNegInf = -1e30f;  // the mask value of repro and ref.py
constexpr float kLog2e = 1.4426950408889634f;

// A (rows x DH) bf16 tile in shared memory, as TMA writes it: kPieces
// column pieces of kSpan bytes per row, each (rows x kSpan) and swizzled.
template <int DH>
struct Tile {
  static constexpr int kSpan = DH * 2 < 128 ? DH * 2 : 128;
  static constexpr int kPieces = DH * 2 / kSpan;       // 2 for dh 128
  static constexpr int kPieceElems = kSpan / 2;
  static constexpr int kSteps = kSpan / 32;            // k16 steps a piece
  static constexpr uint32_t kSwizzle = kSpan == 128 ? 1u : 2u;
  static constexpr int kQPiece = kBM * kSpan;
  static constexpr int kKVPiece = kBN * kSpan;
  static constexpr int kQBytes = kQPiece * kPieces;
  static constexpr int kKVBytes = kKVPiece * kPieces;
  static constexpr int kBars = 1 + 3 * kStages;
  static constexpr int kSmem =
      1024 + kQBytes + 2 * kStages * kKVBytes + 8 * kBars;
};

// O (64 x DH) += P (64 x 16, registers) . V (16 x DH, shared, MN-major)
template <int DH>
__device__ __forceinline__ void pv_mma(float (&o)[DH / 2],
                                       const uint32_t (&a)[4], uint64_t dv);
template <>
__device__ __forceinline__ void pv_mma<32>(float (&o)[16],
                                           const uint32_t (&a)[4],
                                           uint64_t dv) {
  wgmma_m64n32k16_rs_bf16_mn(o, a, dv);
}
template <>
__device__ __forceinline__ void pv_mma<64>(float (&o)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t dv) {
  wgmma_m64n64k16_rs_bf16_mn(o, a, dv);
}
template <>
__device__ __forceinline__ void pv_mma<128>(float (&o)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t dv) {
  wgmma_m64n128k16_rs_bf16_mn(o, a, dv);
}

// 2^x on the SFU in one instruction; a subnormal result is flushed to
// zero (a weight below 2^-126 of the row's largest adds nothing to a
// float32 sum).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// (a, b) -> bf16x2 hi = rn(a, b) and lo = rn((a, b) - hi), a in the low half
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap map_q,
                const __grid_constant__ CUtensorMap map_k,
                const __grid_constant__ CUtensorMap map_v,
                __nv_bfloat16* __restrict__ o, int Hq, int Hkv, int Tq, int S,
                int causal, int window, float scale_log2) {
  using C = Tile<DH>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = align1024(smem_raw);
  uint8_t* k_s = q_s + C::kQBytes;                  // [kStages][kKVBytes]
  uint8_t* v_s = k_s + kStages * C::kKVBytes;       // [kStages][kKVBytes]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(v_s + kStages * C::kKVBytes);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* empty = v_full + kStages;

  const int qb = gridDim.x - 1 - blockIdx.x;       // heaviest blocks first
  const int q0 = qb * kBM;
  const int bh = blockIdx.y;                       // b * Hq + h
  const int kvh = (bh / Hq) * Hkv + (bh % Hq) / (Hq / Hkv);

  // Row r sees keys [lo(r), hi(r)]; both grow with r, and so does
  // lo(r) - hi(r), so a row of the block sees no key iff its last does.
  const int q_last = min(q0 + kBM, Tq) - 1;
  const int lo_last = window > 0 ? max(0, q_last - window + 1) : 0;
  const int hi_last = causal ? min(S - 1, q_last) : S - 1;
  int t_begin = 0, t_end = (S + kBN - 1) / kBN;
  if (lo_last <= hi_last) {
    t_begin = (window > 0 ? max(0, q0 - window + 1) : 0) / kBN;
    t_end = hi_last / kBN + 1;
  }

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {                 // the producer
    regs_dec<40>();
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(q_full, C::kQBytes);
      for (int p = 0; p < C::kPieces; ++p)
        tma_load_3d(q_s + p * C::kQPiece, &map_q, q_full,
                    p * C::kPieceElems, q0, bh);
      int stage = 0;
      uint32_t phase = 0;
      for (int t = t_begin; t < t_end; ++t) {
        mbar_wait(&empty[stage], phase ^ 1);
        uint8_t* kd = k_s + stage * C::kKVBytes;
        uint8_t* vd = v_s + stage * C::kKVBytes;
        mbar_expect_tx(&k_full[stage], C::kKVBytes);
        for (int p = 0; p < C::kPieces; ++p)
          tma_load_3d(kd + p * C::kKVPiece, &map_k, &k_full[stage],
                      p * C::kPieceElems, t * kBN, kvh);
        mbar_expect_tx(&v_full[stage], C::kKVBytes);
        for (int p = 0; p < C::kPieces; ++p)
          tma_load_3d(vd + p * C::kKVPiece, &map_v, &v_full[stage],
                      p * C::kPieceElems, t * kBN, kvh);
        if (++stage == kStages) { stage = 0; phase ^= 1; }
      }
    }
  } else {                                         // the consumers
    regs_inc<232>();
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t4 = lane % 4;
    const int wr_lo = q0 + wg * 64;                // this warpgroup's rows
    const int row0 = wr_lo + warp * 16 + g, row1 = row0 + 8;
    const uint32_t q_base = smem_u32(q_s) + wg * 64 * C::kSpan;

    float acc[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    mbar_wait(q_full, 0);

    // Round i issues S_i = Q.K_i^T and then P_{i-1}.V_{i-1} (P of the last
    // round's softmax), and runs the max, exp and sum of S_i's softmax
    // while that P.V is still on the tensor cores; only the rescale of O
    // and the new P wait for it.  The two warpgroups take turns to issue
    // (named barriers kTurn + wg, 256 threads each), so that one's softmax
    // overlaps the other's products.  The first round has no P.V and the
    // last no S: the loop is peeled so that no wgmma lies on a divergent
    // path (which would serialize them).
    uint32_t p_hi[kBN / 16][4], p_lo[kBN / 16][4];
    float s[kBN / 2];
    float alpha0 = 1.f, alpha1 = 1.f;
    int stage = 0, pv_stage = 0;
    uint32_t phase = 0, pv_phase = 0;
    // s <- exp2(s * scale_log2 - m), masked, with m, l and alpha updated
    auto exponentiate = [&](int tile) {
      // s[4j + e]: row row0 (e < 2) or row1, key k0 + 8j + 2 t4 + (e & 1)
      const int k0 = tile * kBN;
      const bool edge = k0 + kBN > S || (causal && k0 + kBN - 1 > wr_lo) ||
                        (window > 0 && k0 <= wr_lo + 63 - window);
      float mx0 = -INFINITY, mx1 = -INFINITY;
      if (edge) {
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e < 2 ? row0 : row1;
            const int kpos = k0 + 8 * j + 2 * t4 + (e & 1);
            float x = s[4 * j + e] * scale_log2;
            if (kpos >= S) x = -INFINITY;
            else if ((causal && r < kpos) || (window > 0 && kpos <= r - window))
              x = kNegInf;
            s[4 * j + e] = x;
            if (e < 2) mx0 = fmaxf(mx0, x);
            else mx1 = fmaxf(mx1, x);
          }
      } else {                 // scaled in the exponent's FMA below
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (e < 2) mx0 = fmaxf(mx0, s[4 * j + e]);
            else mx1 = fmaxf(mx1, s[4 * j + e]);
          }
        mx0 *= scale_log2;
        mx1 *= scale_log2;
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      alpha0 = exp2_ftz(m0 - mn0);
      alpha1 = exp2_ftz(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      const float c = edge ? 1.f : scale_log2;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p =
              exp2_ftz(fmaf(s[4 * j + e], c, e < 2 ? -mn0 : -mn1));
          s[4 * j + e] = p;
          if (e < 2) sum0 += p;
          else sum1 += p;
        }
      l0 = l0 * alpha0 + sum0;               // this thread's share of l
      l1 = l1 * alpha1 + sum1;
    };
    // O, which holds the rounds before this one at the old max, rescaled;
    // then P as the A operand of k16 step kk: keys k0 + 16 kk + [0, 16)
    auto rescale_and_split = [&]() {
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        acc[4 * j] *= alpha0;
        acc[4 * j + 1] *= alpha0;
        acc[4 * j + 2] *= alpha1;
        acc[4 * j + 3] *= alpha1;
      }
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          split2(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1], p_hi[kk][i],
                 p_lo[kk][i]);
    };
    auto issue_s = [&]() {
      const uint32_t k_base = smem_u32(k_s + stage * C::kKVBytes);
#pragma unroll
      for (int ks = 0; ks < DH / 16; ++ks) {
        const int p = ks / C::kSteps, off = (ks % C::kSteps) * 32;
        wgmma_m64n128k16_ss_bf16(
            s,
            make_desc(q_base + p * C::kQPiece + off, 16, 8 * C::kSpan,
                      C::kSwizzle),
            make_desc(k_base + p * C::kKVPiece + off, 16, 8 * C::kSpan,
                      C::kSwizzle),
            ks > 0);
      }
      wgmma_commit();
    };
    auto issue_pv = [&]() {
      const uint32_t v_base = smem_u32(v_s + pv_stage * C::kKVBytes);
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) {
        const uint64_t dv = make_desc(v_base + kk * 16 * C::kSpan,
                                      C::kKVPiece, 8 * C::kSpan, C::kSwizzle);
        pv_mma<DH>(acc, p_hi[kk], dv);
        pv_mma<DH>(acc, p_lo[kk], dv);
      }
      wgmma_commit();
    };
    auto my_turn = [&]() { named_sync(kTurn + wg, kConsumers); };
    auto their_turn = [&]() {
      named_arrive(kTurn + (wg ^ 1), kConsumers);
    };
    auto next_stage = [&]() {
      if (++stage == kStages) { stage = 0; phase ^= 1; }
    };
    auto release_pv = [&]() {
      mbar_arrive(&empty[pv_stage]);
      if (++pv_stage == kStages) { pv_stage = 0; pv_phase ^= 1; }
    };

    if (wg == 1) their_turn();          // warpgroup 0 issues first
    mbar_wait(&k_full[stage], phase);
    my_turn();
    fence_operands(s);
    wgmma_fence();
    issue_s();
    their_turn();
    wgmma_wait<0>();
    fence_operands(s);
    exponentiate(t_begin);
    rescale_and_split();
    next_stage();
    for (int tile = t_begin + 1; tile < t_end; ++tile) {
      mbar_wait(&k_full[stage], phase);
      mbar_wait(&v_full[pv_stage], pv_phase);
      my_turn();
      fence_operands(acc);
      fence_operands(s);
      wgmma_fence();
      issue_s();
      issue_pv();
      their_turn();
      wgmma_wait<1>();                   // S_i is done, P.V may run on
      fence_operands(s);
      exponentiate(tile);
      wgmma_wait<0>();
      fence_operands(acc);
      release_pv();
      rescale_and_split();
      next_stage();
    }
    mbar_wait(&v_full[pv_stage], pv_phase);
    my_turn();
    fence_operands(acc);
    wgmma_fence();
    issue_pv();
    if (wg == 0) their_turn();          // warpgroup 1 leaves no turn behind
    wgmma_wait<0>();
    fence_operands(acc);
    release_pv();

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    __nv_bfloat16* o0 = o + ((long long)bh * Tq + row0) * DH + 2 * t4;
    __nv_bfloat16* o1 = o0 + 8 * DH;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      if (row0 < Tq)
        *reinterpret_cast<__nv_bfloat162*>(o0 + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
      if (row1 < Tq)
        *reinterpret_cast<__nv_bfloat162*>(o1 + 8 * j) = __floats2bfloat162_rn(
            acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
    }
  }
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Hq, int Hkv, int Tq, int S, int causal,
                   int window, float scale, cudaStream_t stream) {
  using C = Tile<DH>;
  const CUtensorMapSwizzle swizzle = C::kSpan == 128
                                         ? CU_TENSOR_MAP_SWIZZLE_128B
                                         : CU_TENSOR_MAP_SWIZZLE_64B;
  const cuuint64_t dq[3] = {DH, (cuuint64_t)Tq, (cuuint64_t)B * Hq};
  const cuuint64_t dkv[3] = {DH, (cuuint64_t)S, (cuuint64_t)B * Hkv};
  const cuuint32_t bq[3] = {C::kPieceElems, kBM, 1};
  const cuuint32_t bkv[3] = {C::kPieceElems, kBN, 1};
  CUtensorMap mq, mk, mv;
  cudaError_t err;
  if ((err = make_map(&mq, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, q, 3, dq, bq,
                      swizzle)) != cudaSuccess ||
      (err = make_map(&mk, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, k, 3, dkv,
                      bkv, swizzle)) != cudaSuccess ||
      (err = make_map(&mv, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, v, 3, dkv,
                      bkv, swizzle)) != cudaSuccess)
    return err;
  err = cudaFuncSetAttribute(flash_tc_kernel<DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::kSmem);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)((Tq + kBM - 1) / kBM), (unsigned)(B * Hq));
  flash_tc_kernel<DH><<<grid, kThreads, C::kSmem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), Hq, Hkv, Tq, S, causal,
      window, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace tc

namespace {

// dtype 1 (bfloat16) takes the tensor cores, dtype 0 (float32) the FMAs.
template <int DH>
cudaError_t launch_route(int dtype, const void* q, const void* k,
                         const void* v, void* o, int B, int Hq, int Hkv,
                         int Tq, int S, int causal, int window, float scale,
                         cudaStream_t stream) {
  if (dtype == 1)
    return tc::launch<DH>(q, k, v, o, B, Hq, Hkv, Tq, S, causal, window,
                          scale, stream);
  return simt::launch<DH>(q, k, v, o, B, Hq, Hkv, Tq, S, causal, window,
                          scale, stream);
}

}  // namespace

// dtype: 0 = float32 (the FMA route), 1 = bfloat16 (the tensor-core
// route); q, k, v and o alike.  dh in {32, 64, 128}; Hq a multiple of Hkv;
// tensors contiguous and 16-byte aligned (the wrapper checks).  window 0
// means no window.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int dtype, int B, int Hq, int Hkv,
                               int Tq, int S, int dh, int causal, int window,
                               float scale, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv || Tq <= 0 || S <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  switch (dh) {
    case 32: return (int)launch_route<32>(dtype, q, k, v, o, B, Hq, Hkv, Tq,
                                          S, causal, window, scale, s);
    case 64: return (int)launch_route<64>(dtype, q, k, v, o, B, Hq, Hkv, Tq,
                                          S, causal, window, scale, s);
    case 128: return (int)launch_route<128>(dtype, q, k, v, o, B, Hq, Hkv,
                                            Tq, S, causal, window, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
