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
// Routes, by dtype and head width: bfloat16 takes the tensor cores in
// instances of width 32, 64, 96, 128 and 256 that take every narrower dh
// (padded with zeros in shared memory), past 256, to 512, in instances of
// width 320, 384, 448 and 512 whose blocks each compute one half of O's
// columns (wgmma's N is at most 256), the scores for both, and past 512
// in chunks of O of 192 or 256 columns whose scores are taken over dh in
// 64-column pieces (chunk::).  A bfloat16 row that is not whole 16-byte
// pieces (dh % 8 != 0), which TMA cannot stride over, takes the staged
// route: `pad_rows` first copies q, k and v into rows padded to 16-byte
// pieces, and TMA reads the copies.  float32 takes the FMAs to dh 128
// (instances 32 to 128) and past 256 (halves to 512, chunks of 320
// columns past it), and the tensor cores from 129 to 256 (`tf256`, three
// TF32 products a term).  The grid's x dimension is the head b * Hq + h
// (any B Hq), its y dimension the query block (the float32 halves and
// chunks: see simt::half_kernel).
//
// Why a padded copy, for attention: a producer that wrote the tiles
// itself (cp.async into the swizzled layout, or one bulk copy of the rows
// and a layout pass through shared memory) took over twice the TMA
// route's device time on the same inputs on an H100; without the layout
// pass's shared-memory stores it matched TMA, so the cost lies in the
// consumers' wgmma reading tiles the generic proxy wrote.  The copies
// cost one read and one write of q, k and v (about 5 MB at dh 100, T
// 1024, Hq 8).  The scan (ed_argmin.cu) reads its staged tiles with
// ld.shared, and stages them itself.
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
//   where the terms of an output cancel; P_hi + P_lo errs by ~2^-16
//   (P_hi is P's upper half, P_lo the rest rounded: split2).
//   Design: a block owns 128 query rows of one head; warpgroups 0 and 1
//   each own 64 of them, warpgroup 2 is the producer, whose one thread
//   keeps TMA loads of K and V tiles of the KV head h // G in a two-stage
//   ring in shared memory (mbarriers for full and empty).  Per round a
//   consumer warpgroup issues S_i = Q.K_i^T as wgmma from shared memory
//   (f32 accumulators) and then O += P_hi.V + P_lo.V of the last round as
//   wgmma with P from registers and V from shared memory (V's rows are the
//   k of that product: the MN-major form).  It runs the mask, max, exp
//   and sum of S_i's online softmax while that P.V is still on the tensor
//   cores (the exponentials as single SFU instructions), and only then
//   rescales O and splits the new P.  On tiles of 64 keys or fewer O and l
//   share a stale row max, which moves only where a tile's max passes it
//   by more than 8 (log2 units): P <= 2^8, exact in real arithmetic, and
//   most tiles after the first skip the rescale of O (`online::Rows`; on
//   the H100 7 % off dh 320 and 512, where at 128-key tiles the vote and
//   branch it takes cost more than they save).  The two warpgroups take
//   turns to issue (named barriers), so that one's softmax overlaps the
//   other's products.
//   Keys past S score -inf, masked keys -1e30, as in the plain version;
//   the mask is applied only to tiles that cross an edge.  Tiles outside
//   every row's visible range are skipped unless a row of the block sees
//   no key; blocks start with the last query blocks, which have the most
//   causal work.  The producer warpgroup gives its registers to the
//   consumers (setmaxnreg).  Key tiles: 128 keys to dh 128, 64 at 256
//   (Gemma 7B's width: 2 stages of 64-key K and V tiles beside Q take 192
//   KB, and a 64 x 256 f32 O tile 128 registers a thread beside S's and
//   P's 64), 32 for the halves past 256.
//
// * float32 from dh 129 to 256: `tf::flash_tf_kernel`, on the tensor
//   cores in TF32.  The check holds it at 2e-5, which a single tf32
//   product (10 mantissa bits, ~2^-11 a term) misses; three keep float32's
//   accuracy (3xTF32, as ed_argmin.cu): with x = x_hi + x_lo, x_hi =
//   tf32(x), a.b = a_hi.b_hi + a_hi.b_lo + a_lo.b_hi up to ~2^-21
//   relative, for S = Q.K^T and for O += P.V.  Bound: operations, 12 dh
//   flops a pair at the 495 TFLOP/s tf32 peak; at B 1, Hq 8, Hkv 2, T =
//   S = 1024, dh 256, causal, 0.026 ms (as float32 FMAs the same products
//   at 4 dh flops a pair would take 0.064 ms at 67 TFLOP/s).  TF32 wgmma
//   reads shared-memory operands K-major only, and V is MN-major for P.V,
//   so a first small kernel (`split_kv`) writes K_hi, K_lo (keys x dh)
//   and V^T_hi, V^T_lo (dh x keys) into scratch, rows of whole 16-byte
//   pieces for TMA; it permutes the keys of V^T within each group of 8 so
//   that the S accumulator's fragments are P's A fragments as they lie.
//   Design: a block owns 64 query rows of one head; Q lives in shared
//   memory (64 KB) and each consumer thread splits its A fragments from
//   it in registers.  Warpgroups 0 and 1 take alternate key tiles of 64
//   (split-K inside the block: half the rows a block of 128 would have,
//   so the heaviest causal block's work halves), each with its own ring
//   of 16 KB stages that one producer thread keeps filled by TMA: K by 32
//   columns of dh (hi and lo), V^T by 16 keys (hi, then lo).  The same
//   online softmax as the bfloat16 kernel's; at the end warpgroup 1
//   hands its O, max and sum to warpgroup 0 through shared memory, which
//   merges and writes the rows.
//
// * float32 to dh 128 and past 256: `simt::flash_kernel` and
//   `simt::half_kernel`, float32 FMAs outside the tensor cores.  A block
//   of 256 threads owns 64 query rows of one head and streams 64-key
//   tiles of K and V through shared memory with the same online softmax:
//   Q and K tiles transposed so that each thread reads float4 columns for
//   its 4 x 4 block of scores, the 16 threads of a row group meeting by
//   shuffles for the row max and sum, P through shared memory
//   (transposed) into the P.V product, where a thread owns 4 rows x dh/16
//   columns of O.  Bound: the float32 FMA rate; its products at granite's
//   shape would take 2.05 ms (1.37e11 flops at 67 TFLOP/s).  Past 256,
//   `half_kernel` computes O in chunks of columns (two to dh 640).
//
// * bfloat16 past dh 512: `chunk::chunk_kernel` (tensor cores, TMA; O in
//   chunks of at most 256 columns, the scores over dh in 64-column pieces;
//   see there).  float32 past dh 512: `tfc::tfc_kernel` (tf::'s products
//   over chunks of O; see there) where dh % 4 == 0, else
//   `simt::half_kernel`.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"


// query blocks a launch: the grid's y dimension takes at most 65,535, so a
// longer T goes in launches of as many, each told its first block (qb0)
constexpr int kMaxQBlocks = 65535;

namespace simt {

constexpr int kBQ = 64;            // query rows per block
constexpr int kBKV = 64;           // keys per tile
constexpr int kThreads = 256;      // 16 row groups x 16 threads
constexpr int kLd = 64 + 4;        // padded row of a transposed tile
constexpr float kNegInf = -1e30f;  // the mask value of repro and ref.py

// Copy rows [r0, r0 + 64) of a (rows_n, dh) matrix into shared memory as
// float32 rows of DH >= dh, transposed (dst[d * kLd + row]) or not
// (dst[row * (DH + 4) + d]); rows >= rows_n and columns >= dh read as
// zeros.  kVec: dh % 4 == 0, 16-byte loads; else value by value.
template <int DH, bool kTranspose, bool kVec>
__device__ __forceinline__ void load_tile(const float* __restrict__ m,
                                          long long r0, long long rows_n,
                                          int dh, float* dst, int tid) {
  if (!kVec) {
    for (int e = tid; e < 64 * DH; e += kThreads) {
      const int row = e / DH, c = e % DH;
      const float v =
          r0 + row < rows_n && c < dh ? m[(r0 + row) * dh + c] : 0.f;
      if (kTranspose) dst[c * kLd + row] = v;
      else dst[row * (DH + 4) + c] = v;
    }
    return;
  }
  constexpr int kChunks = DH / 4;                 // 16-byte loads per row
  for (int e = tid; e < 64 * kChunks; e += kThreads) {
    const int row = e / kChunks, c = (e % kChunks) * 4;
    float4 raw = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + row < rows_n && c < dh)
      raw = *reinterpret_cast<const float4*>(m + (r0 + row) * dh + c);
    const float v[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (kTranspose) dst[(c + j) * kLd + row] = v[j];
      else dst[row * (DH + 4) + c + j] = v[j];
    }
  }
}

// The instance of width DH takes any dh <= DH (kVec: a multiple of 4):
// the columns past dh are zeros in shared memory, which change neither
// Q.K^T nor the written columns of O.  Block (x, y): head b * Hq + h = x
// (any B Hq), query block qb0 + gridDim.y - 1 - y.
template <int DH, bool kVec>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o, int Hq,
             int Hkv, int Tq, int S, int dh, int causal, int window,
             float scale, int qb0) {
  constexpr int kCpt = DH / 16;                    // O columns per thread
  extern __shared__ __align__(16) float smem[];
  float* q_t = smem;                               // [DH][kLd]
  float* k_t = q_t + DH * kLd;                     // [DH][kLd]
  float* v_s = k_t + DH * kLd;                     // [kBKV][DH + 4]
  float* p_t = v_s + kBKV * (DH + 4);              // [kBKV][kLd]
  __shared__ int any_empty;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int qb = qb0 + gridDim.y - 1 - blockIdx.y;  // heaviest blocks first
  const int q0 = qb * kBQ;
  const int bh = blockIdx.x;                       // b * Hq + h
  const int b = bh / Hq, h = bh % Hq;
  const int kvh = b * Hkv + h / (Hq / Hkv);
  const float* qp = q + (long long)bh * Tq * dh;
  const float* kp = k + (long long)kvh * S * dh;
  const float* vp = v + (long long)kvh * S * dh;

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
  load_tile<DH, true, kVec>(qp, q0, Tq, dh, q_t, tid);
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
    load_tile<DH, true, kVec>(kp, k0, S, dh, k_t, tid);
    load_tile<DH, false, kVec>(vp, k0, S, dh, v_s, tid);
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
    float* orow = o + ((long long)bh * Tq + r) * dh + tx * kCpt;
#pragma unroll
    for (int c = 0; c < kCpt; ++c)
      if (tx * kCpt + c < dh) orow[c] = acc[i][c] / l[i];
  }
}

template <int DH, bool kVec>
cudaError_t launch_vec(const void* q, const void* k, const void* v, void* o,
                       int B, int Hq, int Hkv, int Tq, int S, int dh,
                       int causal, int window, float scale,
                       cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (2 * (size_t)DH * kLd + (size_t)kBKV * (DH + 4) +
                       (size_t)kBKV * kLd);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<DH, kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  for (int hi = (Tq + kBQ - 1) / kBQ; hi > 0; hi -= kMaxQBlocks) {
    const int n = hi < kMaxQBlocks ? hi : kMaxQBlocks;
    dim3 grid((unsigned)((long long)B * Hq), (unsigned)n);
    flash_kernel<DH, kVec><<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), Hq, Hkv, Tq,
        S, dh, causal, window, scale, hi - n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Hq, int Hkv, int Tq, int S, int dh, int causal,
                   int window, float scale, cudaStream_t stream) {
  return dh % 4 == 0
             ? launch_vec<DH, true>(q, k, v, o, B, Hq, Hkv, Tq, S, dh,
                                    causal, window, scale, stream)
             : launch_vec<DH, false>(q, k, v, o, B, Hq, Hkv, Tq, S, dh,
                                     causal, window, scale, stream);
}

// float32 past dh 256: O in chunks of DV columns, a block each, all
// computing the whole scores (as the bfloat16 halves and chunks do): two
// halves to dh 512 (DV = dh / 2 rounded up to an instance: 160 to 256),
// past it, where a row is not whole 16-byte pieces (tfc:: takes the
// others), max(2, ceil(dh / 320)) chunks of 320 (wider chunks spill: at
// 384 to 512 columns a thread's O passed its 255 registers).  The transposed tiles of
// flash_kernel would not fit (Q and K of 64 rows at dh 320 are 87 KB
// each), so a block streams the scores' columns:
// kHC = 64 columns of the block's 64 query rows and of a 64-key tile a
// chunk, both row-major (rows of kHLd = 68 floats, 4 words past a
// multiple of 32, so that the 16 key rows a warp reads fall in distinct
// banks), then the tile's V (64 x DV) for P.V, all by cp.async (16-byte
// copies where dh % 4 == 0, else 4-byte ones; zeros past dh, T and S) in
// a pipeline of stages: each tile's chunks, then its P.V; the next
// stage's copies fly while a stage computes (two chunk buffers; V and P
// one each).  Thread (tx, ty) owns query rows 4 ty .. 4 ty + 3 against
// keys tx + 16 j (the scores), and O's columns 2 tx + 32 g, + 1 (P.V,
// P through shared memory as in flash_kernel): every read of a chunk, V
// and P is conflict-free.  A block takes a pair of query blocks, the
// i-th heaviest and the i-th lightest under a causal mask, so that every
// block has about the same number of tiles (the grid's x: the pairs,
// the chunks of O and the heads, one launch for any T).  Every product
// and sum is float32 (expf, as the plain version).
constexpr int kHC = 64;            // score columns a chunk
constexpr int kHLd = kHC + 4;      // a chunk's row, in floats

template <int DV>
struct Half {
  static constexpr int kDV = DV;                   // O columns a block
  static constexpr int kG = kDV / 32;              // float2 columns a thread
  static constexpr int kChunk = 64 * kHLd;         // floats of a chunk
  static constexpr int kSmem = 4 * (4 * kChunk + 64 * kDV + kBKV * kLd);
};

// Rows [r0, r0 + 64) of a (rows_n, dh) matrix, columns [c0, c0 + W), into
// dst (rows of `ld` floats) by cp.async: zeros past rows_n and dh.
template <int W, bool kVec>
__device__ __forceinline__ void copy_rows(float* dst, int ld,
                                          const float* __restrict__ m,
                                          long long r0, long long rows_n,
                                          int dh, int c0, int tid) {
  constexpr int kVals = kVec ? 4 : 1;
  constexpr int kPer = W / kVals;                  // copies a row
  const uint32_t base = sm90::smem_u32(dst);
#pragma unroll 8
  for (int u = tid; u < 64 * kPer; u += kThreads) {
    const int row = u / kPer, col = (u % kPer) * kVals;
    const bool ok = r0 + row < rows_n && c0 + col < dh;
    const float* src = ok ? m + (r0 + row) * dh + c0 + col : m;
    sm90::cp_async<4 * kVals>(base + 4 * (row * ld + col), src,
                              ok ? 4 * kVals : 0);
  }
}

template <int DV, bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
half_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, float* __restrict__ o, int Hq,
            int Hkv, int Tq, int S, int dh, int causal, int window,
            float scale, int chunks) {
  using H = Half<DV>;
  constexpr int kG = H::kG;
  extern __shared__ __align__(16) float smem[];
  float* qk = smem;                        // [2][Q chunk, K chunk]
  float* v_s = qk + 4 * H::kChunk;         // [kBKV][kDV]
  float* p_t = v_s + kBKV * H::kDV;        // [kBKV][kLd]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int nqb = (Tq + kBQ - 1) / kBQ;
  const int pairs = (nqb + 1) / 2;
  const int pair = blockIdx.x % pairs;
  const int half = (blockIdx.x / pairs) % chunks;  // O's chunk
  const int bh = blockIdx.x / pairs / chunks;      // b * Hq + h
  const int kvh = (bh / Hq) * Hkv + (bh % Hq) / (Hq / Hkv);
  const int c0 = half * H::kDV;
  const float* qp = q + (long long)bh * Tq * dh;
  const float* kp = k + (long long)kvh * S * dh;
  const float* vp = v + (long long)kvh * S * dh;
  const int nc = (dh + kHC - 1) / kHC;             // chunks a tile

  for (int part = 0; part < 2; ++part) {
    const int qb = part == 0 ? nqb - 1 - pair : pair;
    if (part == 1 && qb >= nqb - 1 - pair) break;  // the middle block
    const int q0 = qb * kBQ;
    // a row of the block sees no key iff its last does (see tc::)
    const int q_last = min(q0 + kBQ, Tq) - 1;
    const int lo_last = window > 0 ? max(0, q_last - window + 1) : 0;
    const int hi_last = causal ? min(S - 1, q_last) : S - 1;
    int t_begin = 0, t_end = (S + kBKV - 1) / kBKV;
    if (lo_last <= hi_last) {
      t_begin = (window > 0 ? max(0, q0 - window + 1) : 0) / kBKV;
      t_end = hi_last / kBKV + 1;
    }
    const int total = (t_end - t_begin) * (nc + 1);
    // stage st: tile t_begin + st / (nc + 1); its chunk st % (nc + 1), or
    // its P.V where that is nc; chunk buffers alternate chunk by chunk
    auto issue = [&](int st) {
      if (st < total) {
        const int tile = t_begin + st / (nc + 1), c = st % (nc + 1);
        const long long k0 = (long long)tile * kBKV;
        if (c < nc) {
          float* buf = qk + ((tile - t_begin) * nc + c) % 2 * 2 * H::kChunk;
          copy_rows<kHC, kVec>(buf, kHLd, qp, q0, Tq, dh, c * kHC, tid);
          copy_rows<kHC, kVec>(buf + H::kChunk, kHLd, kp, k0, S, dh,
                               c * kHC, tid);
        } else {
          copy_rows<H::kDV, kVec>(v_s, H::kDV, vp, k0, S, dh, c0, tid);
        }
      }
      sm90::cp_async_commit();
    };

    float m[4], l[4], acc[4][2 * kG], s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m[i] = -INFINITY;
      l[i] = 0.f;
#pragma unroll
      for (int c = 0; c < 2 * kG; ++c) acc[i][c] = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    }
    issue(0);
    for (int st = 0; st < total; ++st) {
      sm90::cp_async_wait<0>();
      __syncthreads();                   // stage st landed; st - 1 is done
      issue(st + 1);
      const int tile = t_begin + st / (nc + 1), c = st % (nc + 1);
      const int k0 = tile * kBKV;
      if (c < nc) {                      // 32 columns of the scores
        const float* qc =
            qk + ((tile - t_begin) * nc + c) % 2 * 2 * H::kChunk;
        const float* kc = qc + H::kChunk;
#pragma unroll
        for (int d = 0; d < kHC; d += 4) {
          float4 a[4], b[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            a[i] = *reinterpret_cast<const float4*>(qc + (4 * ty + i) * kHLd
                                                    + d);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            b[j] = *reinterpret_cast<const float4*>(kc + (tx + 16 * j) * kHLd
                                                    + d);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
              s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
              s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
              s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
            }
        }
        if (c + 1 < nc) continue;
        // the tile's scores are whole: the online softmax, P to p_t
        float p[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = q0 + 4 * ty + i;
          float mx = -INFINITY;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int kpos = k0 + tx + 16 * j;
            float x = __fmul_rn(s[i][j], scale);
            if (kpos >= S) x = -INFINITY;
            else if ((causal && r < kpos) ||
                     (window > 0 && kpos <= r - window))
              x = kNegInf;
            p[i][j] = x;
            mx = fmaxf(mx, x);
            s[i][j] = 0.f;
          }
#pragma unroll
          for (int off = 8; off > 0; off >>= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
          const float m_new = fmaxf(m[i], mx);
          const float alpha = expf(m[i] - m_new);
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            p[i][j] = expf(p[i][j] - m_new);
            sum += p[i][j];
          }
#pragma unroll
          for (int off = 8; off > 0; off >>= 1)
            sum += __shfl_xor_sync(0xffffffffu, sum, off);
          l[i] = l[i] * alpha + sum;
          m[i] = m_new;
#pragma unroll
          for (int cc = 0; cc < 2 * kG; ++cc) acc[i][cc] *= alpha;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
          *reinterpret_cast<float4*>(p_t + (tx + 16 * j) * kLd + 4 * ty) =
              make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
      } else {                           // O += P . V
#pragma unroll 4
        for (int j = 0; j < kBKV; ++j) {
          const float4 pv =
              *reinterpret_cast<const float4*>(p_t + j * kLd + 4 * ty);
          const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
          for (int g = 0; g < kG; ++g) {
            const float2 vv = *reinterpret_cast<const float2*>(
                v_s + j * H::kDV + 2 * tx + 32 * g);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              acc[i][2 * g] = fmaf(pr[i], vv.x, acc[i][2 * g]);
              acc[i][2 * g + 1] = fmaf(pr[i], vv.y, acc[i][2 * g + 1]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + 4 * ty + i;
      if (r >= Tq) continue;
      float* orow = o + ((long long)bh * Tq + r) * dh + c0;
#pragma unroll
      for (int g = 0; g < kG; ++g)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 2 * tx + 32 * g + e;
          if (c0 + col < dh) orow[col] = acc[i][2 * g + e] / l[i];
        }
    }
    __syncthreads();                     // the buffers pass to the next part
  }
}

// O in `chunks` chunks of DV columns (ceil(dh / DV)), one launch.
template <int DV>
cudaError_t launch_half(const void* q, const void* k, const void* v,
                        void* o, int B, int Hq, int Hkv, int Tq, int S,
                        int dh, int causal, int window, float scale,
                        cudaStream_t stream) {
  const int chunks = (dh + DV - 1) / DV;
  const long long blocks =
      (long long)B * Hq * chunks * (((Tq + kBQ - 1) / kBQ + 1) / 2);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  auto kernel = dh % 4 == 0 ? half_kernel<DV, true> : half_kernel<DV, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Half<DV>::kSmem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, kThreads, Half<DV>::kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Hq, Hkv, Tq, S,
      dh, causal, window, scale, chunks);
  return cudaGetLastError();
}

}  // namespace simt

// ------------------------------------------------------ online softmax
// The online softmax of the tensor-core kernels (tc, tf), on a score tile
// that a wgmma accumulator holds: a thread's two rows (row0, and row1 =
// row0 + 8), s[4j + e] the score of row (e < 2 ? row0 : row1) and key k0 +
// 8j + 2 t4 + (e & 1), t4 = lane % 4 (the quad of lanes that share a row).
namespace online {

constexpr float kNegInf = -1e30f;  // the mask value of repro and ref.py
constexpr float kLog2e = 1.4426950408889634f;
// A row's max moves only where a tile's passes it by more than this (log2
// units): every P is then at most 2^8
constexpr float kLazy = 8.f;

// 2^x on the SFU in one instruction; a subnormal result is flushed to
// zero (a weight below 2^-126 of the row's largest adds nothing to a
// float32 sum).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A thread's two rows: the max m that O and l are scaled to, this
// thread's share of l, and the factor that rescales O at the last tile.
// O and l share a stale max: m moves only where a tile's max exceeds it by
// more than kLazy, so that most tiles after the first leave O as it is;
// in real arithmetic the result is the same for any m both carry.
struct Rows {
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float alpha0 = 1.f, alpha1 = 1.f;

  // s (BN keys from k0) scaled into log2 units by scale_log2 and masked
  // (keys past S -inf, masked keys -1e30, as the plain version; only on a
  // tile that crosses S, the diagonal or the window's start for rows
  // r_lo .. r_lo + 63), then p = exp2(x - m) left in s, alpha0 / alpha1
  // (1 where m stayed) and l updated.  A tile that is not `live` leaves
  // p = 0 and m, l as they were (by selects: a round a consumer runs only
  // to keep its loop's count uniform).  Returns whether any row of the
  // warp moved its max: only then must the caller rescale O by alpha.
  template <int BN>
  __device__ __forceinline__ bool tile(float (&s)[BN / 2], int k0, int r_lo,
                                       int row0, int row1, int t4, int S,
                                       int causal, int window,
                                       float scale_log2, bool live = true,
                                       float lazy = kLazy) {
    const bool edge = k0 + BN > S || (causal && k0 + BN - 1 > r_lo) ||
                      (window > 0 && k0 <= r_lo + 63 - window);
    float mx0 = -INFINITY, mx1 = -INFINITY;
    if (edge) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
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
    } else {                   // scaled in the exponent's FMA below
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
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
    // a tile's max is finite or -1e30 (every tile run holds a key < S),
    // so the first live tile always moves m off -inf
    const float mn0 = live && mx0 > m0 + lazy ? mx0 : m0;
    const float mn1 = live && mx1 > m1 + lazy ? mx1 : m1;
    const bool moved = __any_sync(0xffffffffu, mn0 != m0 || mn1 != m1);
    alpha0 = mn0 == m0 ? 1.f : exp2_ftz(m0 - mn0);
    alpha1 = mn1 == m1 ? 1.f : exp2_ftz(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    const float c = edge ? 1.f : scale_log2;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2_ftz(fmaf(s[4 * j + e], c, e < 2 ? -mn0 : -mn1));
        s[4 * j + e] = live ? p : 0.f;
        if (e < 2) sum0 += s[4 * j + e];
        else sum1 += s[4 * j + e];
      }
    l0 = l0 * alpha0 + sum0;               // this thread's share of l
    l1 = l1 * alpha1 + sum1;
    return moved;
  }

  // O (64 x 2N accumulators, the same row layout) by alpha
  template <int N>
  __device__ __forceinline__ void rescale(float (&acc)[N]) const {
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
      acc[4 * j] *= alpha0;
      acc[4 * j + 1] *= alpha0;
      acc[4 * j + 2] *= alpha1;
      acc[4 * j + 3] *= alpha1;
    }
  }

  // l of each row: the four lanes of the quad meet
  __device__ __forceinline__ void sum_quad() {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
  }
};

}  // namespace online

// x, hidden from the compiler: a value computed from it inside a loop is
// not hoisted out of the loop (as 64-bit descriptors that would each hold
// two registers for the whole loop)
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  uint32_t y;
  asm volatile("mov.b32 %0, %1;" : "=r"(y) : "r"(x));
  return y;
}

namespace tc {

using namespace sm90;
using namespace online;

constexpr int kBM = 128;           // query rows per block
constexpr int kStages = 2;         // K/V tiles in flight
constexpr int kThreads = 384;      // warpgroups 0, 1 consume, 2 loads
constexpr int kConsumers = 256;
constexpr int kTurn = 2;           // named barriers 2, 3: whose turn to issue

// The tiles of the instance (DK, DV): Q and K rows of DK bf16 values, V
// and O rows of DV (DK, or half of it past 256: a block then computes one
// half of O's columns, grid z, each half taking all of Q.K^T), in shared
// memory as TMA writes them: column pieces of kSpan (Q, K) or kVSpan (V)
// bytes a row (128, or 64 where the row is not a multiple of 128 bytes),
// each (rows x span) and swizzled.  Key tiles of kBN rows: 128 to DK
// 128; past it two stages of 128-key K and V tiles would pass the block's
// shared memory, and a 64 x 256 f32 O tile takes 128 registers a thread
// beside S's and P's: 64 at DK 256 (Gemma 7B's width; 192 KB of tiles,
// and the consumers take 240 registers, the producer 24), 32 for the
// halves (Q alone takes up to 128 KB there).
template <int DK, int DV = DK>
struct Tile {
  static constexpr int kBN = DK == 256 && DV == 256 ? 64
                             : DK > 128              ? 32
                                                     : 128;
  static constexpr uint32_t kConsumerRegs = kBN == 64 ? 240 : 232;
  static constexpr uint32_t kProducerRegs = kBN == 64 ? 24 : 40;
  // the stale max (online::Rows) where a tile is 64 keys or fewer, whose
  // rescale of O costs most a key; at 128 keys the vote and branch it
  // takes cost more than the rescale they skip (measured on the H100)
  static constexpr bool kLazy = kBN <= 64;
  static constexpr int kSpan = DK * 2 % 128 == 0 ? 128 : 64;
  static constexpr int kPieces = DK * 2 / kSpan;       // 2 for dh 128
  static constexpr int kPieceElems = kSpan / 2;
  static constexpr int kSteps = kSpan / 32;            // k16 steps a piece
  static constexpr uint32_t kSwizzle = kSpan == 128 ? 1u : 2u;
  static constexpr int kVSpan = DV * 2 % 128 == 0 ? 128 : 64;
  static constexpr int kVPieces = DV * 2 / kVSpan;
  static constexpr int kVPieceElems = kVSpan / 2;
  static constexpr uint32_t kVSwizzle = kVSpan == 128 ? 1u : 2u;
  static constexpr int kQPiece = kBM * kSpan;
  static constexpr int kKPiece = kBN * kSpan;
  static constexpr int kVPiece = kBN * kVSpan;
  static constexpr int kQBytes = kQPiece * kPieces;
  static constexpr int kKBytes = kKPiece * kPieces;
  static constexpr int kVBytes = kVPiece * kVPieces;
  static constexpr int kBars = 1 + 4 * kStages;
  static constexpr int kSmem =
      1024 + kQBytes + kStages * (kKBytes + kVBytes) + 8 * kBars;
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
__device__ __forceinline__ void pv_mma<96>(float (&o)[48],
                                           const uint32_t (&a)[4],
                                           uint64_t dv) {
  wgmma_m64n96k16_rs_bf16_mn(o, a, dv);
}
template <>
__device__ __forceinline__ void pv_mma<160>(float (&o)[80],
                                            const uint32_t (&a)[4],
                                            uint64_t dv) {
  wgmma_m64n160k16_rs_bf16_mn(o, a, dv);
}
template <>
__device__ __forceinline__ void pv_mma<192>(float (&o)[96],
                                            const uint32_t (&a)[4],
                                            uint64_t dv) {
  wgmma_m64n192k16_rs_bf16_mn(o, a, dv);
}
template <>
__device__ __forceinline__ void pv_mma<224>(float (&o)[112],
                                            const uint32_t (&a)[4],
                                            uint64_t dv) {
  wgmma_m64n224k16_rs_bf16_mn(o, a, dv);
}
template <>
__device__ __forceinline__ void pv_mma<128>(float (&o)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t dv) {
  wgmma_m64n128k16_rs_bf16_mn(o, a, dv);
}
template <>
__device__ __forceinline__ void pv_mma<256>(float (&o)[128],
                                            const uint32_t (&a)[4],
                                            uint64_t dv) {
  wgmma_m64n256k16_rs_bf16_mn(o, a, dv);
}

// S (64 x BN, f32) (+)= Q (64 x 16, shared) . K (BN x 16, shared)^T
template <int BN>
__device__ __forceinline__ void qk_mma(float (&s)[BN / 2], uint64_t da,
                                       uint64_t db, int accumulate);
template <>
__device__ __forceinline__ void qk_mma<32>(float (&s)[16], uint64_t da,
                                           uint64_t db, int accumulate) {
  wgmma_m64n32k16_ss_bf16(s, da, db, accumulate);
}
template <>
__device__ __forceinline__ void qk_mma<64>(float (&s)[32], uint64_t da,
                                           uint64_t db, int accumulate) {
  wgmma_m64n64k16_ss_bf16(s, da, db, accumulate);
}
template <>
__device__ __forceinline__ void qk_mma<128>(float (&s)[64], uint64_t da,
                                            uint64_t db, int accumulate) {
  wgmma_m64n128k16_ss_bf16(s, da, db, accumulate);
}

// (a, b) -> the bf16x2 A operands P_hi and P_lo, a in the low half of
// each: hi the upper halves of a and b (one PRMT), whose float32 values
// are a and b with the lower 16 bits cleared, so that lo = rn((a, b) -
// hi) rounds remainders float32 holds exactly: one conversion (F2FP) a
// pair, where rounding hi too took two and hi back to float32 between
// them; |error| <= 2^-16 p (2^-17 with hi rounded), far inside the check
// (the CPU model: tests/test_torch_attention.py _attention_bf16_p).
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  const uint32_t ua = __float_as_uint(a), ub = __float_as_uint(b);
  hi = __byte_perm(ua, ub, 0x7632);
  const __nv_bfloat162 l = __floats2bfloat162_rn(
      a - __uint_as_float(ua & 0xffff0000u),
      b - __uint_as_float(ub & 0xffff0000u));
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// The instance (DK, DV) takes any dh <= DK: the maps are dh wide and
// their boxes DK (DV for V), so TMA fills the columns past dh with zeros,
// which change neither Q.K^T nor the written columns of O.  The maps' rows
// are those of q, k and v, or (the staged route, dh not a multiple of 8)
// of their copies with rows padded to 16-byte pieces (pad_rows).  Block
// (x, y, z): head b * Hq + h = x (any B Hq), query block y, O's columns z
// DV .. (z + 1) DV - 1.
template <int DK, int DV = DK>
__global__ void __launch_bounds__(kThreads, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap map_q,
                const __grid_constant__ CUtensorMap map_k,
                const __grid_constant__ CUtensorMap map_v,
                __nv_bfloat16* __restrict__ o, int Hq, int Hkv, int Tq, int S,
                int dh, int causal, int window, float scale_log2, int qb0) {
  using C = Tile<DK, DV>;
  constexpr int kBN = C::kBN;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = align1024(smem_raw);
  uint8_t* k_s = q_s + C::kQBytes;                  // [kStages][kKBytes]
  uint8_t* v_s = k_s + kStages * C::kKBytes;        // [kStages][kVBytes]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(v_s + kStages * C::kVBytes);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* k_empty = v_full + kStages;
  uint64_t* v_empty = k_empty + kStages;

  const int qb = qb0 + gridDim.y - 1 - blockIdx.y;  // heaviest blocks first
  const int q0 = qb * kBM;
  const int bh = blockIdx.x;                       // b * Hq + h
  const int kvh = (bh / Hq) * Hkv + (bh % Hq) / (Hq / Hkv);
  const int c0 = blockIdx.z * DV;                  // O's first column here

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
      mbar_init(&k_empty[s], kConsumers);
      mbar_init(&v_empty[s], kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {                 // the producer
    regs_dec<C::kProducerRegs>();
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(q_full, C::kQBytes);
      for (int p = 0; p < C::kPieces; ++p)
        tma_load_3d(q_s + p * C::kQPiece, &map_q, q_full,
                    p * C::kPieceElems, q0, bh);
      int stage = 0;
      uint32_t phase = 0;
      for (int t = t_begin; t < t_end; ++t) {
        uint8_t* kd = k_s + stage * C::kKBytes;
        uint8_t* vd = v_s + stage * C::kVBytes;
        mbar_wait(&k_empty[stage], phase ^ 1);
        mbar_expect_tx(&k_full[stage], C::kKBytes);
        for (int p = 0; p < C::kPieces; ++p)
          tma_load_3d(kd + p * C::kKPiece, &map_k, &k_full[stage],
                      p * C::kPieceElems, t * kBN, kvh);
        mbar_wait(&v_empty[stage], phase ^ 1);
        mbar_expect_tx(&v_full[stage], C::kVBytes);
        for (int p = 0; p < C::kVPieces; ++p)
          tma_load_3d(vd + p * C::kVPiece, &map_v, &v_full[stage],
                      c0 + p * C::kVPieceElems, t * kBN, kvh);
        if (++stage == kStages) { stage = 0; phase ^= 1; }
      }
    }
  } else {                                         // the consumers
    regs_inc<C::kConsumerRegs>();
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t4 = lane % 4;
    const int wr_lo = q0 + wg * 64;                // this warpgroup's rows
    const int row0 = wr_lo + warp * 16 + g, row1 = row0 + 8;
    const uint32_t q_base = smem_u32(q_s) + wg * 64 * C::kSpan;

    float acc[DV / 2];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
    Rows rows;
    mbar_wait(q_full, 0);

    // Round i issues S_i = Q.K_i^T and then P_{i-1}.V_{i-1} (P of the last
    // round's softmax), and runs the max, exp and sum of S_i's softmax
    // while that P.V is still on the tensor cores; only the rescale of O
    // (where a row's max moved) and the new P wait for it.  The two
    // warpgroups take turns to issue (named barriers kTurn + wg, 256
    // threads each), so that one's softmax overlaps the other's products.
    // The first round has no P.V and the last no S: the loop is peeled so
    // that no wgmma lies on a divergent path (which would serialize them).
    uint32_t p_hi[kBN / 16][4], p_lo[kBN / 16][4];
    float s[kBN / 2];
    bool moved = false;
    int stage = 0, pv_stage = 0;
    uint32_t phase = 0, pv_phase = 0;
    // s <- exp2(s * scale_log2 - m), masked, with m, l and alpha updated
    // (m moving with every larger max where the tiles are 128 keys)
    auto exponentiate = [&](int tile) {
      moved = rows.tile<kBN>(s, tile * kBN, wr_lo, row0, row1, t4, S, causal,
                             window, scale_log2, true,
                             C::kLazy ? kLazy : 0.f);
    };
    // O, which holds the rounds before this one at the old max, rescaled
    // (on narrow tiles only where a row's max moved); then P as the A
    // operand of k16 step kk: keys k0 + 16 kk + [0, 16)
    auto rescale_and_split = [&]() {
      if (moved || !C::kLazy) rows.rescale(acc);
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          split2(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1], p_hi[kk][i],
                 p_lo[kk][i]);
    };
    auto issue_s = [&]() {
      const uint32_t k_base = smem_u32(k_s + stage * C::kKBytes);
      // each step's descriptor is the base's plus its offset (>> 4); at
      // 64-key tiles Q's base is opaque, or the 16 descriptors would stay
      // live across the loop, where registers are short (elsewhere they
      // may)
      const uint64_t qd = make_desc(C::kBN == 64 ? opaque(q_base) : q_base,
                                    16, 8 * C::kSpan, C::kSwizzle);
      const uint64_t kd = make_desc(k_base, 16, 8 * C::kSpan, C::kSwizzle);
#pragma unroll
      for (int ks = 0; ks < DK / 16; ++ks) {
        const int p = ks / C::kSteps, off = (ks % C::kSteps) * 32;
        qk_mma<kBN>(s, qd + ((p * C::kQPiece + off) >> 4),
                    kd + ((p * C::kKPiece + off) >> 4), ks > 0);
      }
      wgmma_commit();
    };
    auto issue_pv = [&]() {
      const uint32_t v_base = smem_u32(v_s + pv_stage * C::kVBytes);
      const uint64_t dv0 = make_desc(v_base, C::kVPiece, 8 * C::kVSpan,
                                     C::kVSwizzle);
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) {
        const uint64_t dv = dv0 + (kk * 16 * C::kVSpan >> 4);
        pv_mma<DV>(acc, p_hi[kk], dv);
        pv_mma<DV>(acc, p_lo[kk], dv);
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
      mbar_arrive(&v_empty[pv_stage]);
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
    mbar_arrive(&k_empty[stage]);       // K_i is read: its stage may refill
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
      mbar_arrive(&k_empty[stage]);
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

    rows.sum_quad();
    const float inv0 = 1.f / rows.l0, inv1 = 1.f / rows.l1;
    __nv_bfloat16* o0 = o + ((long long)bh * Tq + row0) * dh + c0 + 2 * t4;
    __nv_bfloat16* o1 = o0 + 8 * dh;
    // columns c0 + 8 j + 2 t4 and the next: a bf16x2 store where both lie
    // inside dh and dh is even (4-byte aligned); else value by value
    auto store = [&](__nv_bfloat16* p, float a, float b, int left) {
      if (left >= 2 && dh % 2 == 0) {
        *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
      } else {
        if (left >= 1) p[0] = __float2bfloat16_rn(a);
        if (left >= 2) p[1] = __float2bfloat16_rn(b);
      }
    };
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      if (c0 + 8 * j >= dh) break;                 // padded columns
      const int left = dh - (c0 + 8 * j + 2 * t4);
      if (row0 < Tq)
        store(o0 + 8 * j, acc[4 * j] * inv0, acc[4 * j + 1] * inv0, left);
      if (row1 < Tq)
        store(o1 + 8 * j, acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1,
              left);
    }
  }
}

// The staged route's copies of q, k and v (rows, dh), one launch, each
// row padded to ld = dh rounded up to 8 values: a row of whole 16-byte
// pieces that TMA takes.  The copies lie back to back in `out` (q's
// rows_q rows, then k's and v's rows_kv each), so row R of them is row R
// of the three inputs in that order.  A thread writes 16-byte pieces
// (consecutive threads, consecutive pieces), each read by load16 (the
// widest loads the row's alignment allows; no read past the values' own
// 16-byte blocks).  The pad's values are never read: the maps stop at dh.
__global__ void pad_rows(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         __nv_bfloat16* __restrict__ out, long long rows_q,
                         long long rows_kv, int dh, int ld) {
  const int per = ld / 8;                          // pieces a row
  const long long pieces = (rows_q + 2 * rows_kv) * per;
  for (long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       u < pieces; u += (long long)gridDim.x * blockDim.x) {
    const long long r = u / per;
    const int col = (int)(u % per) * 8;
    const int valid = (dh - col) * 2;
    const __nv_bfloat16* src =
        r < rows_q ? q + r * dh
                   : r < rows_q + rows_kv ? k + (r - rows_q) * dh
                                          : v + (r - rows_q - rows_kv) * dh;
    *reinterpret_cast<uint4*>(out + r * ld + col) =
        load16(reinterpret_cast<const uint8_t*>(src + col),
               valid > 16 ? 16 : valid);
  }
}

// q, k, v: the rows the maps read, ld elements apart (dh, or the staged
// route's padded copies); o: (B, Hq, T, dh).
template <int DK, int DV = DK>
cudaError_t launch(const void* q, const void* k, const void* v, int ld,
                   void* o, int B, int Hq, int Hkv, int Tq, int S, int dh,
                   int causal, int window, float scale, cudaStream_t stream) {
  using C = Tile<DK, DV>;
  auto swizzle = [](int span) {
    return span == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                       : CU_TENSOR_MAP_SWIZZLE_64B;
  };
  const cuuint64_t dq[3] = {(cuuint64_t)dh, (cuuint64_t)Tq,
                            (cuuint64_t)B * Hq};
  const cuuint64_t dkv[3] = {(cuuint64_t)dh, (cuuint64_t)S,
                             (cuuint64_t)B * Hkv};
  const cuuint32_t bq[3] = {C::kPieceElems, kBM, 1};
  const cuuint32_t bk[3] = {C::kPieceElems, C::kBN, 1};
  const cuuint32_t bv[3] = {C::kVPieceElems, C::kBN, 1};
  CUtensorMap mq, mk, mv;
  cudaError_t err;
  if ((err = make_map(&mq, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, q, 3, dq, bq,
                      swizzle(C::kSpan), ld)) != cudaSuccess ||
      (err = make_map(&mk, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, k, 3, dkv,
                      bk, swizzle(C::kSpan), ld)) != cudaSuccess ||
      (err = make_map(&mv, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, v, 3, dkv,
                      bv, swizzle(C::kVSpan), ld)) != cudaSuccess)
    return err;
  err = cudaFuncSetAttribute(flash_tc_kernel<DK, DV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::kSmem);
  if (err != cudaSuccess) return err;
  for (int hi = (Tq + kBM - 1) / kBM; hi > 0; hi -= kMaxQBlocks) {
    const int n = hi < kMaxQBlocks ? hi : kMaxQBlocks;
    dim3 grid((unsigned)((long long)B * Hq), (unsigned)n,
              (unsigned)((dh + DV - 1) / DV));
    flash_tc_kernel<DK, DV><<<grid, kThreads, C::kSmem, stream>>>(
        mq, mk, mv, static_cast<__nv_bfloat16*>(o), Hq, Hkv, Tq, S, dh,
        causal, window, scale * kLog2e, hi - n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The staged route: pad q, k, v into scratch, then the instance on the
// copies.
template <int DK, int DV = DK>
cudaError_t launch_staged(const void* q, const void* k, const void* v,
                          void* scratch, void* o, int B, int Hq, int Hkv,
                          int Tq, int S, int dh, int causal, int window,
                          float scale, cudaStream_t stream) {
  const int ld = (dh + 7) / 8 * 8;
  const long long rows_q = (long long)B * Hq * Tq;
  const long long rows_kv = (long long)B * Hkv * S;
  const long long pieces = (rows_q + 2 * rows_kv) * (ld / 8);
  const long long blocks = (pieces + 255) / 256;
  auto* out = static_cast<__nv_bfloat16*>(scratch);
  pad_rows<<<(unsigned)(blocks < 8192 ? blocks : 8192), 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), out, rows_q, rows_kv, dh, ld);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch<DK, DV>(out, out + rows_q * ld, out + (rows_q + rows_kv) * ld,
                        ld, o, B, Hq, Hkv, Tq, S, dh, causal, window, scale,
                        stream);
}

}  // namespace tc

namespace tf {

using namespace sm90;
using namespace online;

constexpr int kDH = 256;           // the instance's width: any dh <= 256
constexpr int kBM = 64;            // query rows a block, both consumers'
constexpr int kBN = 64;            // keys a tile
constexpr int kThreads = 384;      // warpgroups 0, 1 consume, 2 loads
constexpr int kConsumers = 256;
constexpr int kRing = 5;           // stages of each consumer's ring
constexpr int kStage = 16384;      // bytes a stage
constexpr int kKCols = 32;         // dh columns a K stage (hi, then lo)
constexpr int kVKeys = 16;         // keys a V stage (hi or lo)
constexpr int kKPiece = kBN * kKCols * 4;          // K_hi (or K_lo) of one
constexpr int kQBytes = kBM * kDH * 4;
constexpr int kSmem = 1024 + kQBytes + 2 * kRing * kStage + 2 * 2 * kRing * 8;
static_assert(2 * kKPiece == kStage && kVKeys * kDH * 4 == kStage, "");

// The padded copies of K and V that the tensor cores read, for `heads`
// KV heads of S rows: K_hi and K_lo (heads, S, dhp), dhp = dh rounded up
// to 4 (rows of whole 16-byte pieces; columns dh .. dhp - 1 zeros), and
// V^T_hi and V^T_lo (heads, dh, sp), sp = S rounded up to 8, the keys of
// each group of 8 in the order 0, 2, 4, 6, 1, 3, 5, 7 (keys past S zeros):
// the S accumulator gives a thread keys 2 t4 and 2 t4 + 1 of each group of
// 8, which are the keys t4 and t4 + 4 of the tf32 A fragment once V^T's
// keys are so permuted (the same permutation of the contraction index in
// both operands changes nothing of P.V).  hi = tf32_rna(x), lo = x - hi.
// A block of 256 threads takes 32 keys x 32 columns through shared memory
// (coalesced reads of K and V, and of V^T's writes).
__device__ __forceinline__ int key_at(int l) {     // V^T position -> key
  return (l & ~7) | ((l & 7) < 4 ? 2 * (l & 3) : 2 * (l & 3) + 1);
}

__global__ void split_kv(const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ khi,
                         float* __restrict__ klo, float* __restrict__ vhi,
                         float* __restrict__ vlo, int heads, int S, int dh,
                         int dhp, int sp) {
  __shared__ float tile[32][33];
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const int k0 = blockIdx.x * 32, d0 = blockIdx.y * 32;
  for (int h = blockIdx.z; h < heads; h += gridDim.z) {
    const long long kv0 = (long long)h * S;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = k0 + ty + 8 * i, d = d0 + tx;
      const bool in = key < S && d < dh;
      if (key < S && d < dhp) {
        const float x = in ? k[(kv0 + key) * dh + d] : 0.f;
        const float hi = __uint_as_float(tf32_rna(x));
        khi[(kv0 + key) * dhp + d] = hi;
        klo[(kv0 + key) * dhp + d] = x - hi;
      }
      tile[ty + 8 * i][tx] = in ? v[(kv0 + key) * dh + d] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int d = d0 + ty + 8 * i, col = k0 + tx;
      if (d < dh && col < sp) {
        const float x = tile[key_at(tx)][ty + 8 * i];
        const float hi = __uint_as_float(tf32_rna(x));
        const long long at = ((long long)h * dh + d) * sp + col;
        vhi[at] = hi;
        vlo[at] = x - hi;
      }
    }
    __syncthreads();
  }
}

// Q's tile in shared memory: row r in 64 16-byte units, unit 4 G + t (G
// the group of 16 dh columns, t < 4) holding columns 16 G + t, + 4, + 8
// and + 12 (a thread's A values of the group's two k8 steps: one 16-byte
// load a row) and stored at unit (4 G + t) ^ (4 (r & 1)), so that the
// loads of a quarter warp (rows g, g + 1, every t) fall in distinct banks.
__device__ __forceinline__ int q_unit(int r, int G, int t) {
  return r * (kDH / 4) + ((4 * G + t) ^ ((r & 1) << 2));
}

// (a0..a3) -> tf32 hi = rna(a) and lo = a - hi (the tensor core reads lo
// truncated to tf32)
__device__ __forceinline__ void split4(float a0, float a1, float a2,
                                       float a3, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  const float a[4] = {a0, a1, a2, a3};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    hi[i] = tf32_rna(a[i]);
    lo[i] = __float_as_uint(a[i] - __uint_as_float(hi[i]));
  }
}

// The instance takes any dh <= 256: Q's columns past dh are zeros in
// shared memory, K's past dhp TMA fills with zeros, V^T has dh rows (its
// box of 256 rows is zero-filled past them).  Block (x, y): head b * Hq +
// h = x (any B Hq), query block qb0 + gridDim.y - 1 - y.  Consumer
// warpgroup w takes the key tiles t_begin + w, + 2, ..., fed by producer
// thread kConsumers + 32 w through ring w.
__global__ void __launch_bounds__(kThreads, 1)
flash_tf_kernel(const __grid_constant__ CUtensorMap map_kh,
                const __grid_constant__ CUtensorMap map_kl,
                const __grid_constant__ CUtensorMap map_vh,
                const __grid_constant__ CUtensorMap map_vl,
                const float* __restrict__ q, float* __restrict__ o, int Hq,
                int Hkv, int Tq, int S, int dh, int causal, int window,
                float scale_log2, int qb0) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align1024(smem_raw);
  float* q_s = reinterpret_cast<float*>(base);
  uint8_t* rings = base + kQBytes;                 // [2][kRing][kStage]
  uint64_t* bars = reinterpret_cast<uint64_t*>(rings + 2 * kRing * kStage);

  const int qb = qb0 + gridDim.y - 1 - blockIdx.y;  // heaviest blocks first
  const int q0 = qb * kBM;
  const int bh = blockIdx.x;                       // b * Hq + h
  const int kvh = (bh / Hq) * Hkv + (bh % Hq) / (Hq / Hkv);

  // a row of the block sees no key iff its last does (see tc::)
  const int q_last = min(q0 + kBM, Tq) - 1;
  const int lo_last = window > 0 ? max(0, q_last - window + 1) : 0;
  const int hi_last = causal ? min(S - 1, q_last) : S - 1;
  int t_begin = 0, t_end = (S + kBN - 1) / kBN;
  if (lo_last <= hi_last) {
    t_begin = (window > 0 ? max(0, q0 - window + 1) : 0) / kBN;
    t_end = hi_last / kBN + 1;
  }

  // consumer w takes tiles t_begin + w, + 2, ...; both run as many rounds
  // (a count uniform over the block: a wgmma inside a loop whose count
  // differs by warpgroup lies on a path ptxas takes for divergent, and
  // it serializes them)
  const int rounds = (t_end - t_begin + 1) / 2;

  // ring w: full barriers bars[2 w kRing ..], empty ones the next kRing
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2 * kRing; ++i) {
      mbar_init(&bars[i / kRing * 2 * kRing + i % kRing], 1);
      mbar_init(&bars[i / kRing * 2 * kRing + kRing + i % kRing], 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {                 // the producers
    regs_dec<40>();
    const int w = (threadIdx.x - kConsumers) / 32;
    if (w < 2 && threadIdx.x % 32 == 0) {
      uint8_t* ring = rings + w * kRing * kStage;
      uint64_t* full = bars + 2 * w * kRing;
      uint64_t* empty = full + kRing;
      int stage = 0;
      uint32_t phase = 0;
      for (int it = 0; it < rounds; ++it) {
        // past the last tile (warpgroup 1 when the count is odd) the last
        // again, which that round does not count
        const int t = min(t_begin + 2 * it + w, t_end - 1);
        // K by 32 columns of dh (hi, lo), then V^T by 16 keys (hi, lo)
        for (int c = 0; c < kDH / kKCols + 2 * kBN / kVKeys; ++c) {
          uint8_t* dst = ring + stage * kStage;
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], kStage);
          if (c < kDH / kKCols) {
            tma_load_3d(dst, &map_kh, &full[stage], c * kKCols, t * kBN,
                        kvh);
            tma_load_3d(dst + kKPiece, &map_kl, &full[stage], c * kKCols,
                        t * kBN, kvh);
          } else {
            const int j = c - kDH / kKCols;
            tma_load_3d(dst, j % 2 ? &map_vl : &map_vh, &full[stage],
                        t * kBN + j / 2 * kVKeys, 0, kvh);
          }
          if (++stage == kRing) { stage = 0; phase ^= 1; }
        }
      }
    }
    return;
  }

  // the consumers
  regs_inc<232>();
  const int tid = threadIdx.x;
  {
    const float* qp = q + ((long long)bh * Tq + q0) * dh;
    const int rows_n = min(kBM, Tq - q0);
#pragma unroll 16
    for (int e = tid; e < kBM * kDH; e += kConsumers) {
      const int r = e / kDH, d = e % kDH;
      q_s[4 * q_unit(r, d / 16, d % 4) + d % 16 / 4] =
          r < rows_n && d < dh ? qp[(long long)r * dh + d] : 0.f;
    }
  }
  named_sync(1, kConsumers);

  const int wg = tid / 128;
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int r0 = warp * 16 + g, r1 = r0 + 8;        // the tile's rows
  const int row0 = q0 + r0, row1 = q0 + r1;
  const float4* q4 = reinterpret_cast<const float4*>(q_s);
  // q_unit(r0, G, t4) = q_unit(r0, G % 2, t4) + 8 (G / 2)
  const float4* q_even = q4 + q_unit(r0, 0, t4);
  const float4* q_odd = q4 + q_unit(r0, 1, t4);
  uint8_t* ring = rings + wg * kRing * kStage;
  uint64_t* full = bars + 2 * wg * kRing;
  uint64_t* empty = full + kRing;
  int stage = 0, last = 0;
  uint32_t phase = 0;
  auto next_stage = [&]() {
    last = stage;
    if (++stage == kRing) { stage = 0; phase ^= 1; }
  };

  float acc[kDH / 2];
#pragma unroll
  for (int i = 0; i < kDH / 2; ++i) acc[i] = 0.f;
  float s[kBN / 2];
  Rows rows;
  // Each group of wgmmas is committed on its own; after the next group
  // is issued, a wait leaves it alone in flight, so that the A registers
  // of the one before are free again and a stage is released once the
  // last group reading it is done.
  for (int it = 0; it < rounds; ++it) {
    const int tile = t_begin + 2 * it + wg;
    // S = Q.K^T: a K stage is two groups of 16 dh columns, each two k8
    // steps of three products (Q_hi.K_hi + Q_lo.K_hi + Q_hi.K_lo)
#pragma unroll
    for (int c = 0; c < kDH / kKCols; ++c) {
      mbar_wait_warp(&full[stage], phase);
      const uint32_t kb = smem_u32(ring + stage * kStage);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int G = 2 * c + h;
        // rows r0 and r0 + 8 at unit 4 G + t4: one of two bases (the
        // swizzle flips G's low bit) and a constant offset, so that no
        // address of the 16 groups stays live across the loop
        const float4* qg = (G & 1 ? q_odd : q_even) + 8 * (G / 2);
        const float4 x0 = qg[0], x1 = qg[8 * (kDH / 4)];
        uint32_t ah[2][4], al[2][4];
        split4(x0.x, x1.x, x0.y, x1.y, ah[0], al[0]);   // columns 16 G ..
        split4(x0.z, x1.z, x0.w, x1.w, ah[1], al[1]);   // 16 G + 8 ..
        fence_operands(s);
        wgmma_fence();
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ks = 2 * h + e;                    // k8 step of the stage
          const uint64_t dk0 = make_desc(kb, 16, 1024, 1);
          const uint64_t dkh = dk0 + (32 * ks >> 4);
          const uint64_t dkl = dk0 + ((kKPiece + 32 * ks) >> 4);
          wgmma_m64n64k8_rs_tf32(s, ah[e], dkh, c > 0 || h > 0 || e > 0);
          wgmma_m64n64k8_rs_tf32(s, al[e], dkh, 1);
          wgmma_m64n64k8_rs_tf32(s, ah[e], dkl, 1);
        }
        wgmma_commit();
        wgmma_wait<1>();
        if (h == 0 && c > 0) mbar_arrive(&empty[last]);
      }
      next_stage();
    }
    wgmma_wait<0>();
    fence_operands(s);
    mbar_arrive(&empty[last]);

    if (rows.tile<kBN>(s, min(tile, t_end - 1) * kBN, q0, row0, row1, t4, S,
                       causal, window, scale_log2, tile < t_end))
      rows.rescale(acc);

    // O += P.V: per 16 keys, the V^T_hi stage (P_hi and P_lo), then the
    // V^T_lo stage (P_hi); A of k8 slice kk is P at keys 8 kk + 2 t4 and
    // + 1, which V^T's permuted keys put at t4 and t4 + 4
#pragma unroll
    for (int j = 0; j < kBN / kVKeys; ++j) {
      uint32_t ph[2][4], pl[2][4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kk = 2 * j + e;
        split4(s[4 * kk], s[4 * kk + 2], s[4 * kk + 1], s[4 * kk + 3], ph[e],
               pl[e]);
      }
#pragma unroll
      for (int part = 0; part < 2; ++part) {           // V^T_hi, V^T_lo
        mbar_wait_warp(&full[stage], phase);
        const uint32_t vb = smem_u32(ring + stage * kStage);
        fence_operands(acc);
        wgmma_fence();
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const uint64_t dv = make_desc(vb, 16, 512, 2) + (32 * e >> 4);
          wgmma_m64n256k8_rs_tf32(acc, ph[e], dv, 1);
          if (part == 0) wgmma_m64n256k8_rs_tf32(acc, pl[e], dv, 1);
        }
        wgmma_commit();
        wgmma_wait<1>();
        if (j > 0 || part > 0) mbar_arrive(&empty[last]);
        next_stage();
      }
    }
    wgmma_wait<0>();
    fence_operands(acc);
    mbar_arrive(&empty[last]);
  }

  // Warpgroup 1 hands its O, max and l to warpgroup 0 through ring 1,
  // whose stages it alone read and whose copies have all landed.
  rows.sum_quad();
  float* xo = reinterpret_cast<float*>(rings + kRing * kStage);
  float4* xm = reinterpret_cast<float4*>(xo + 128 * (kDH / 2));
  const int i = tid % 128;
  if (wg == 1) {
#pragma unroll
    for (int e = 0; e < kDH / 2; ++e) xo[e * 128 + i] = acc[e];
    xm[i] = make_float4(rows.m0, rows.m1, rows.l0, rows.l1);
    named_arrive(2, kConsumers);
    return;
  }
  named_sync(2, kConsumers);
  // warpgroup 1 took no tile where its max is -inf: its weight is 0
  const float4 x = xm[i];
  const float m0 = fmaxf(rows.m0, x.x), m1 = fmaxf(rows.m1, x.y);
  const float a0 = exp2_ftz(rows.m0 - m0), a1 = exp2_ftz(rows.m1 - m1);
  const float b0 = exp2_ftz(x.x - m0), b1 = exp2_ftz(x.y - m1);
  const float inv0 = 1.f / (rows.l0 * a0 + x.z * b0);
  const float inv1 = 1.f / (rows.l1 * a1 + x.w * b1);
  float* o0 = o + ((long long)bh * Tq + row0) * dh + 2 * t4;
  float* o1 = o0 + 8 * dh;
  // columns 8 j + 2 t4 and the next: one 8-byte store where both lie
  // inside dh and dh is even (8-byte aligned); else value by value
  auto store = [&](float* p, float u, float w, int left) {
    if (left >= 2 && dh % 2 == 0) {
      *reinterpret_cast<float2*>(p) = make_float2(u, w);
    } else {
      if (left >= 1) p[0] = u;
      if (left >= 2) p[1] = w;
    }
  };
#pragma unroll
  for (int j = 0; j < kDH / 8; ++j) {
    if (8 * j >= dh) break;                        // padded columns
    const int left = dh - (8 * j + 2 * t4);
    const float* y = xo + 4 * j * 128 + i;
    if (row0 < Tq)
      store(o0 + 8 * j, (acc[4 * j] * a0 + y[0] * b0) * inv0,
            (acc[4 * j + 1] * a0 + y[128] * b0) * inv0, left);
    if (row1 < Tq)
      store(o1 + 8 * j, (acc[4 * j + 2] * a1 + y[256] * b1) * inv1,
            (acc[4 * j + 3] * a1 + y[384] * b1) * inv1, left);
  }
}

// q, k, v: (B, Hq, Tq, dh) and (B, Hkv, S, dh) float32; scratch: the
// padded copies, 2 B Hkv (S dhp + dh sp) floats (split_kv); o like q.
cudaError_t launch(const float* q, const float* k, const float* v,
                   float* scratch, float* o, int B, int Hq, int Hkv, int Tq,
                   int S, int dh, int causal, int window, float scale,
                   cudaStream_t stream) {
  const int dhp = (dh + 3) / 4 * 4, sp = (S + 7) / 8 * 8;
  const int heads = B * Hkv;
  float* khi = scratch;
  float* klo = khi + (long long)heads * S * dhp;
  float* vhi = klo + (long long)heads * S * dhp;
  float* vlo = vhi + (long long)heads * dh * sp;
  const dim3 pgrid((unsigned)((sp + 31) / 32), (unsigned)((dhp + 31) / 32),
                   (unsigned)(heads < 65535 ? heads : 65535));
  split_kv<<<pgrid, 256, 0, stream>>>(k, v, khi, klo, vhi, vlo, heads, S, dh,
                                      dhp, sp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const cuuint64_t dk[3] = {(cuuint64_t)dhp, (cuuint64_t)S,
                            (cuuint64_t)heads};
  const cuuint64_t dv[3] = {(cuuint64_t)sp, (cuuint64_t)dh,
                            (cuuint64_t)heads};
  const cuuint32_t bk[3] = {kKCols, kBN, 1};
  const cuuint32_t bv[3] = {kVKeys, kDH, 1};
  CUtensorMap mkh, mkl, mvh, mvl;
  if ((err = make_map(&mkh, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, khi, 3, dk,
                      bk, CU_TENSOR_MAP_SWIZZLE_128B)) != cudaSuccess ||
      (err = make_map(&mkl, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, klo, 3, dk,
                      bk, CU_TENSOR_MAP_SWIZZLE_128B)) != cudaSuccess ||
      (err = make_map(&mvh, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, vhi, 3, dv,
                      bv, CU_TENSOR_MAP_SWIZZLE_64B)) != cudaSuccess ||
      (err = make_map(&mvl, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, vlo, 3, dv,
                      bv, CU_TENSOR_MAP_SWIZZLE_64B)) != cudaSuccess)
    return err;
  err = cudaFuncSetAttribute(flash_tf_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmem);
  if (err != cudaSuccess) return err;
  for (int hi = (Tq + kBM - 1) / kBM; hi > 0; hi -= kMaxQBlocks) {
    const int n = hi < kMaxQBlocks ? hi : kMaxQBlocks;
    dim3 grid((unsigned)((long long)B * Hq), (unsigned)n);
    flash_tf_kernel<<<grid, kThreads, kSmem, stream>>>(
        mkh, mkl, mvh, mvl, q, o, Hq, Hkv, Tq, S, dh, causal, window,
        scale * kLog2e, hi - n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace tf

namespace chunk {

using namespace sm90;
using namespace online;

// The bfloat16 route past dh 512 ("tcc<DV>", "stagedc<DV>"): O in chunks
// of DV = 192 or 256 columns (wgmma's N is at most 256; grid z), each
// chunk's blocks computing all of Q.K^T over dh, in pieces of 64 columns
// (128 bytes, one 128-byte swizzle span) like a GEMM's main loop, so that
// no tile holds a whole row of dh.  A block owns 64 query rows of one
// head; warpgroups 0 and 1 take alternate key tiles of 64 (as tf::, so
// that the 64 rows' Q is shared), each from its own ring: kKStages stages
// of one K piece (64 keys x 64 columns, with the Q piece of the same
// columns where Q is streamed) and one stage of the tile's V (64 keys x
// DV), which producer thread kConsumers + 32 w keeps filled by TMA.  Q
// lives in shared memory whole (ceil(dh / 64) pieces of 8 KB, loaded once)
// where the layout fits (to dh 704 at DV 256, 832 at 192), else each
// stage carries its Q piece again (kStreamQ: any dh, Q read again from L2
// for every key tile).  Per tile a consumer issues S (+)= Q_p.K_p^T piece
// by piece, freeing each stage once the next piece's wgmma is issued,
// then the online softmax of tf:: and tc:: (the stale max, kLazy), P as
// P_hi + P_lo (split2) and O += P.V as wgmma with P from registers; that
// P.V runs on while the next tile's first piece is issued.  At the end
// warpgroup 1 hands its O, max and sum to warpgroup 0 through its ring,
// which merges and writes the chunk's columns.  Bound: operations, as
// tc::; this route's own floor counts the scores once a chunk and P.V
// twice (P_hi, P_lo): flash_attention_floors in launch/roofline.py.
constexpr int kBM = 64;            // query rows a block, both consumers'
constexpr int kBN = 64;            // keys a tile
constexpr int kPC = 64;            // columns a piece: 128 bytes of bf16
constexpr int kThreads = 384;      // warpgroups 0, 1 consume, 2 loads
constexpr int kConsumers = 256;
constexpr int kKStages = 4;        // K-piece stages of a consumer's ring
constexpr int kPiece = kBN * kPC * 2;   // 8 KB: a box of 64 rows x 64 columns
constexpr int kHandOver = 128 * 16;     // warpgroup 1's max and sum
constexpr int kBarsPerRing = 2 * kKStages + 2;
constexpr int kSmemMax = 232448;   // what a block may take on sm_90
static_assert(kBM == kBN, "a Q piece and a K piece share one TMA box");

template <int DV, bool kStreamQ>
struct Layout {
  static constexpr int kSStage = (kStreamQ ? 2 : 1) * kPiece;
  static constexpr int kVStage = DV / kPC * kPiece;
  static constexpr int kRing = kKStages * kSStage + kVStage;
  static_assert(kRing >= 128 * (DV / 2) * 4, "the hand-over of O fits");
  static constexpr uint32_t kConsumerRegs = 232;
  static constexpr uint32_t kProducerRegs = 40;
  // bytes a block takes at head width dh: [Q][ring 0][ring 1][max, sum]
  // [barriers], after up to 1 KB of alignment
  static int smem(int dh) {
    const int q = kStreamQ ? 0 : (dh + kPC - 1) / kPC * kPiece;
    return 1024 + q + 2 * kRing + kHandOver + 8 * (2 * kBarsPerRing + 1);
  }
};

// Block (x, y, z): head b * Hq + h = x (any B Hq), query block qb0 +
// gridDim.y - 1 - y, O's columns z DV .. (z + 1) DV - 1.  The maps read
// q, k, v (or the staged route's padded copies) in boxes of 64 columns by
// 64 rows, zeros past dh, T and S.
template <int DV, bool kStreamQ>
__global__ void __launch_bounds__(kThreads, 1)
chunk_kernel(const __grid_constant__ CUtensorMap map_q,
             const __grid_constant__ CUtensorMap map_k,
             const __grid_constant__ CUtensorMap map_v,
             __nv_bfloat16* __restrict__ o, int Hq, int Hkv, int Tq, int S,
             int dh, int causal, int window, float scale_log2, int qb0) {
  using C = Layout<DV, kStreamQ>;
  const int nP = (dh + kPC - 1) / kPC;             // pieces of dh
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = align1024(smem_raw);
  uint8_t* rings = q_s + (kStreamQ ? 0 : nP * kPiece);
  float4* xm = reinterpret_cast<float4*>(rings + 2 * C::kRing);
  uint64_t* bars = reinterpret_cast<uint64_t*>(rings + 2 * C::kRing +
                                               kHandOver);
  uint64_t* q_full = bars + 2 * kBarsPerRing;

  const int qb = qb0 + gridDim.y - 1 - blockIdx.y;  // heaviest blocks first
  const int q0 = qb * kBM;
  const int bh = blockIdx.x;                       // b * Hq + h
  const int kvh = (bh / Hq) * Hkv + (bh % Hq) / (Hq / Hkv);
  const int c0 = blockIdx.z * DV;                  // O's first column here

  // a row of the block sees no key iff its last does (see tc::)
  const int q_last = min(q0 + kBM, Tq) - 1;
  const int lo_last = window > 0 ? max(0, q_last - window + 1) : 0;
  const int hi_last = causal ? min(S - 1, q_last) : S - 1;
  int t_begin = 0, t_end = (S + kBN - 1) / kBN;
  if (lo_last <= hi_last) {
    t_begin = (window > 0 ? max(0, q0 - window + 1) : 0) / kBN;
    t_end = hi_last / kBN + 1;
  }
  // consumer w takes tiles t_begin + w, + 2, ...; both run as many rounds
  // (a count uniform over the block, as in tf::)
  const int rounds = (t_end - t_begin + 1) / 2;

  // ring w: full[kKStages], empty[kKStages], v_full, v_empty from
  // bars + w kBarsPerRing
  if (threadIdx.x == 0) {
    for (int w = 0; w < 2; ++w) {
      uint64_t* b = bars + w * kBarsPerRing;
      for (int s = 0; s < kKStages; ++s) {
        mbar_init(&b[s], 1);
        mbar_init(&b[kKStages + s], 128);
      }
      mbar_init(&b[2 * kKStages], 1);
      mbar_init(&b[2 * kKStages + 1], 128);
    }
    mbar_init(q_full, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {                 // the producers
    regs_dec<C::kProducerRegs>();
    const int w = (threadIdx.x - kConsumers) / 32;
    if (w < 2 && threadIdx.x % 32 == 0) {
      uint8_t* ring = rings + w * C::kRing;
      uint64_t* full = bars + w * kBarsPerRing;
      if (!kStreamQ && w == 0) {
        mbar_expect_tx(q_full, nP * kPiece);
        for (int p = 0; p < nP; ++p)
          tma_load_3d(q_s + p * kPiece, &map_q, q_full, p * kPC, q0, bh);
      }
      int stage = 0;
      uint32_t phase = 0, v_phase = 0;
      for (int it = 0; it < rounds; ++it) {
        // past the last tile (warpgroup 1 when the count is odd) the last
        // again, which that round does not count
        const int t = min(t_begin + 2 * it + w, t_end - 1);
        for (int p = 0; p < nP; ++p) {
          uint8_t* dst = ring + stage * C::kSStage;
          mbar_wait(&full[kKStages + stage], phase ^ 1);
          mbar_expect_tx(&full[stage], C::kSStage);
          tma_load_3d(dst, &map_k, &full[stage], p * kPC, t * kBN, kvh);
          if (kStreamQ)
            tma_load_3d(dst + kPiece, &map_q, &full[stage], p * kPC, q0, bh);
          if (++stage == kKStages) { stage = 0; phase ^= 1; }
        }
        uint8_t* vd = ring + kKStages * C::kSStage;
        mbar_wait(&full[2 * kKStages + 1], v_phase ^ 1);
        mbar_expect_tx(&full[2 * kKStages], C::kVStage);
        for (int c = 0; c < DV / kPC; ++c)
          tma_load_3d(vd + c * kPiece, &map_v, &full[2 * kKStages],
                      c0 + c * kPC, t * kBN, kvh);
        v_phase ^= 1;
      }
    }
    return;
  }

  // the consumers
  regs_inc<C::kConsumerRegs>();
  const int tid = threadIdx.x, wg = tid / 128;
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  uint8_t* ring = rings + wg * C::kRing;
  uint64_t* full = bars + wg * kBarsPerRing;
  uint64_t* empty = full + kKStages;
  uint64_t* v_full = full + 2 * kKStages;
  uint64_t* v_empty = v_full + 1;
  const uint32_t ring_u32 = smem_u32(ring), q_u32 = smem_u32(q_s);
  const uint64_t dv0 = make_desc(ring_u32 + kKStages * C::kSStage, kPiece,
                                 8 * 128, 1);

  float acc[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
  float s[kBN / 2];
  uint32_t p_hi[kBN / 16][4], p_lo[kBN / 16][4];
  Rows rows;
  if (!kStreamQ) mbar_wait_warp(q_full, 0);
  int stage = 0, last = 0;
  uint32_t phase = 0, v_phase = 0;
  for (int it = 0; it < rounds; ++it) {
    const int tile = t_begin + 2 * it + wg;
    // S = Q.K^T, a piece of 64 columns of dh a stage; after a piece is
    // issued the one before it is done (its stage freed), and at the
    // first piece the last tile's P.V (its V stage freed)
    for (int p = 0; p < nP; ++p) {
      mbar_wait_warp(&full[stage], phase);
      const uint32_t sb = ring_u32 + stage * C::kSStage;
      const uint64_t da = make_desc(kStreamQ ? sb + kPiece
                                             : q_u32 + p * kPiece,
                                    16, 8 * 128, 1);
      const uint64_t db = make_desc(sb, 16, 8 * 128, 1);
      fence_operands(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kPC / 16; ++kk)
        tc::qk_mma<kBN>(s, da + (32 * kk >> 4), db + (32 * kk >> 4),
                        p > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<1>();
      if (p > 0) {
        mbar_arrive(&empty[last]);
      } else if (it > 0) {
        fence_operands(acc);
        mbar_arrive(v_empty);
      }
      last = stage;
      if (++stage == kKStages) { stage = 0; phase ^= 1; }
    }
    wgmma_wait<0>();
    fence_operands(s);
    mbar_arrive(&empty[last]);

    if (rows.tile<kBN>(s, min(tile, t_end - 1) * kBN, q0, row0, row1, t4, S,
                       causal, window, scale_log2, tile < t_end))
      rows.rescale(acc);
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        tc::split2(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1], p_hi[kk][i],
                   p_lo[kk][i]);

    // O += P_hi.V + P_lo.V: V's rows are the k of the product (MN-major)
    mbar_wait_warp(v_full, v_phase);
    v_phase ^= 1;
    fence_operands(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      const uint64_t dv = dv0 + (kk * 16 * 128 >> 4);
      tc::pv_mma<DV>(acc, p_hi[kk], dv);
      tc::pv_mma<DV>(acc, p_lo[kk], dv);
    }
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_operands(acc);

  // Warpgroup 1 hands its O, max and l to warpgroup 0 through ring 1,
  // whose stages it alone read and whose copies have all landed.
  rows.sum_quad();
  float* xo = reinterpret_cast<float*>(rings + C::kRing);
  const int i = tid % 128;
  if (wg == 1) {
#pragma unroll
    for (int e = 0; e < DV / 2; ++e) xo[e * 128 + i] = acc[e];
    xm[i] = make_float4(rows.m0, rows.m1, rows.l0, rows.l1);
    named_arrive(2, kConsumers);
    return;
  }
  named_sync(2, kConsumers);
  // warpgroup 1 took no tile where its max is -inf: its weight is 0
  const float4 x = xm[i];
  const float m0 = fmaxf(rows.m0, x.x), m1 = fmaxf(rows.m1, x.y);
  const float a0 = exp2_ftz(rows.m0 - m0), a1 = exp2_ftz(rows.m1 - m1);
  const float b0 = exp2_ftz(x.x - m0), b1 = exp2_ftz(x.y - m1);
  const float inv0 = 1.f / (rows.l0 * a0 + x.z * b0);
  const float inv1 = 1.f / (rows.l1 * a1 + x.w * b1);
  __nv_bfloat16* o0 = o + ((long long)bh * Tq + row0) * dh + c0 + 2 * t4;
  __nv_bfloat16* o1 = o0 + 8 * dh;
  // columns c0 + 8 j + 2 t4 and the next: a bf16x2 store where both lie
  // inside dh and dh is even (4-byte aligned); else value by value
  auto store = [&](__nv_bfloat16* p, float u, float w, int left) {
    if (left >= 2 && dh % 2 == 0) {
      *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(u, w);
    } else {
      if (left >= 1) p[0] = __float2bfloat16_rn(u);
      if (left >= 2) p[1] = __float2bfloat16_rn(w);
    }
  };
#pragma unroll
  for (int j = 0; j < DV / 8; ++j) {
    if (c0 + 8 * j >= dh) break;                   // padded columns
    const int left = dh - (c0 + 8 * j + 2 * t4);
    const float* y = xo + 4 * j * 128 + i;
    if (row0 < Tq)
      store(o0 + 8 * j, (acc[4 * j] * a0 + y[0] * b0) * inv0,
            (acc[4 * j + 1] * a0 + y[128] * b0) * inv0, left);
    if (row1 < Tq)
      store(o1 + 8 * j, (acc[4 * j + 2] * a1 + y[256] * b1) * inv1,
            (acc[4 * j + 3] * a1 + y[384] * b1) * inv1, left);
  }
}

// q, k, v: the rows the maps read, ld elements apart (dh, or the staged
// route's padded copies); o: (B, Hq, T, dh).  Q lives in shared memory
// whole where that layout fits (stream_q 0), else is streamed beside K.
template <int DV, bool kStreamQ>
cudaError_t launch_as(const void* q, const void* k, const void* v, int ld,
                      void* o, int B, int Hq, int Hkv, int Tq, int S, int dh,
                      int causal, int window, float scale,
                      cudaStream_t stream) {
  using C = Layout<DV, kStreamQ>;
  const int smem = C::smem(dh);
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  const cuuint64_t dq[3] = {(cuuint64_t)dh, (cuuint64_t)Tq,
                            (cuuint64_t)B * Hq};
  const cuuint64_t dkv[3] = {(cuuint64_t)dh, (cuuint64_t)S,
                             (cuuint64_t)B * Hkv};
  const cuuint32_t box[3] = {kPC, kBN, 1};
  CUtensorMap mq, mk, mv;
  cudaError_t err;
  if ((err = make_map(&mq, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, q, 3, dq, box,
                      CU_TENSOR_MAP_SWIZZLE_128B, ld)) != cudaSuccess ||
      (err = make_map(&mk, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, k, 3, dkv,
                      box, CU_TENSOR_MAP_SWIZZLE_128B, ld)) != cudaSuccess ||
      (err = make_map(&mv, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, v, 3, dkv,
                      box, CU_TENSOR_MAP_SWIZZLE_128B, ld)) != cudaSuccess)
    return err;
  err = cudaFuncSetAttribute(chunk_kernel<DV, kStreamQ>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const int chunks = (dh + DV - 1) / DV;
  for (int hi = (Tq + kBM - 1) / kBM; hi > 0; hi -= kMaxQBlocks) {
    const int n = hi < kMaxQBlocks ? hi : kMaxQBlocks;
    dim3 grid((unsigned)((long long)B * Hq), (unsigned)n, (unsigned)chunks);
    chunk_kernel<DV, kStreamQ><<<grid, kThreads, smem, stream>>>(
        mq, mk, mv, static_cast<__nv_bfloat16*>(o), Hq, Hkv, Tq, S, dh,
        causal, window, scale * kLog2e, hi - n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <int DV>
cudaError_t launch(const void* q, const void* k, const void* v, int ld,
                   void* o, int B, int Hq, int Hkv, int Tq, int S, int dh,
                   int causal, int window, float scale, int stream_q,
                   cudaStream_t stream) {
  if (!stream_q && Layout<DV, false>::smem(dh) <= kSmemMax)
    return launch_as<DV, false>(q, k, v, ld, o, B, Hq, Hkv, Tq, S, dh,
                                causal, window, scale, stream);
  return launch_as<DV, true>(q, k, v, ld, o, B, Hq, Hkv, Tq, S, dh, causal,
                             window, scale, stream);
}

// The staged route: q, k, v padded into scratch (tc::pad_rows), then the
// chunks on the copies.
template <int DV>
cudaError_t launch_staged(const void* q, const void* k, const void* v,
                          void* scratch, void* o, int B, int Hq, int Hkv,
                          int Tq, int S, int dh, int causal, int window,
                          float scale, int stream_q, cudaStream_t stream) {
  const int ld = (dh + 7) / 8 * 8;
  const long long rows_q = (long long)B * Hq * Tq;
  const long long rows_kv = (long long)B * Hkv * S;
  const long long pieces = (rows_q + 2 * rows_kv) * (ld / 8);
  const long long blocks = (pieces + 255) / 256;
  auto* out = static_cast<__nv_bfloat16*>(scratch);
  tc::pad_rows<<<(unsigned)(blocks < 8192 ? blocks : 8192), 256, 0,
                 stream>>>(static_cast<const __nv_bfloat16*>(q),
                           static_cast<const __nv_bfloat16*>(k),
                           static_cast<const __nv_bfloat16*>(v), out, rows_q,
                           rows_kv, dh, ld);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch<DV>(out, out + rows_q * ld, out + (rows_q + rows_kv) * ld, ld,
                    o, B, Hq, Hkv, Tq, S, dh, causal, window, scale, stream_q,
                    stream);
}

}  // namespace chunk

namespace tfc {

using namespace sm90;
using namespace online;

// The float32 route past dh 512 where a row is whole 16-byte pieces
// ("tfc<DV>"): the tensor cores in TF32, three products a term (as tf::),
// with O in chunks of DV = 192 or 256 columns (grid z), each chunk's
// blocks computing all of Q.K^T.  tf::split_kv first copies K and V into
// K_hi, K_lo and V^T_hi, V^T_lo (keys permuted in groups of 8); Q is read
// as it is.  A block owns 128 query rows of one head, 64 a consumer
// warpgroup, both on every key tile of 64 (as tc::, so that a stage of K
// serves both); one producer thread keeps a ring of kStages stages filled
// by TMA: per tile ceil(dh / 32) stages of Q (128 rows) and K_hi, K_lo
// (64 keys) over 32 columns of dh, then 4 stages of V^T_hi and V^T_lo (16
// keys, the chunk's DV rows).  A consumer splits its A fragments of Q
// from the stage into hi and lo (split4) and issues S (+)= Q_hi.K_hi +
// Q_lo.K_hi + Q_hi.K_lo, four k8 steps a stage, each stage freed once the
// next is issued; then the online softmax (the stale max), and O +=
// P_hi.V_hi + P_lo.V_hi + P_hi.V_lo with P from registers.  Bound:
// operations at the TF32 rate; this route's own floor counts the scores
// once a chunk.  The stages of Q and K (32 KB a tile column) are read
// from L2 again for every key tile and chunk.
constexpr int kBM = 128;           // query rows a block: 64 a consumer
constexpr int kBN = 64;            // keys a tile
constexpr int kThreads = 384;      // warpgroups 0, 1 consume, 2 loads
constexpr int kConsumers = 256;
constexpr int kStages = 6;
constexpr int kStage = 32768;      // bytes a stage
constexpr int kKCols = 32;         // dh columns an S stage
constexpr int kVKeys = 16;         // keys a V stage
constexpr int kQPiece = kBM * kKCols * 4;          // 16 KB
constexpr int kKPiece = kBN * kKCols * 4;          // 8 KB: K_hi or K_lo
constexpr int kSmem = 1024 + kStages * kStage + 2 * kStages * 8;
static_assert(kQPiece + 2 * kKPiece == kStage, "an S stage");

template <int DV> struct PV;
template <> struct PV<192> {
  static __device__ __forceinline__ void mma(float (&o)[96],
                                             const uint32_t (&a)[4],
                                             uint64_t d) {
    wgmma_m64n192k8_rs_tf32(o, a, d, 1);
  }
};
template <> struct PV<256> {
  static __device__ __forceinline__ void mma(float (&o)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t d) {
    wgmma_m64n256k8_rs_tf32(o, a, d, 1);
  }
};

// Block (x, y, z): head b * Hq + h = x (any B Hq), query block qb0 +
// gridDim.y - 1 - y, O's columns z DV .. (z + 1) DV - 1.  dh % 4 == 0 (Q's
// rows are TMA's).
template <int DV>
__global__ void __launch_bounds__(kThreads, 1)
tfc_kernel(const __grid_constant__ CUtensorMap map_q,
           const __grid_constant__ CUtensorMap map_kh,
           const __grid_constant__ CUtensorMap map_kl,
           const __grid_constant__ CUtensorMap map_vh,
           const __grid_constant__ CUtensorMap map_vl,
           float* __restrict__ o, int Hq, int Hkv, int Tq, int S, int dh,
           int causal, int window, float scale_log2, int qb0) {
  static_assert(2 * DV * kVKeys * 4 <= kStage, "a V stage");
  constexpr int kVHalf = DV * kVKeys * 4;          // V^T_hi (or _lo)
  const int nC = (dh + kKCols - 1) / kKCols;       // S stages a tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStage);
  uint64_t* empty = full + kStages;

  const int qb = qb0 + gridDim.y - 1 - blockIdx.y;  // heaviest blocks first
  const int q0 = qb * kBM;
  const int bh = blockIdx.x;                       // b * Hq + h
  const int kvh = (bh / Hq) * Hkv + (bh % Hq) / (Hq / Hkv);
  const int c0 = blockIdx.z * DV;                  // O's first column here

  // a row of the block sees no key iff its last does (see tc::)
  const int q_last = min(q0 + kBM, Tq) - 1;
  const int lo_last = window > 0 ? max(0, q_last - window + 1) : 0;
  const int hi_last = causal ? min(S - 1, q_last) : S - 1;
  int t_begin = 0, t_end = (S + kBN - 1) / kBN;
  if (lo_last <= hi_last) {
    t_begin = (window > 0 ? max(0, q0 - window + 1) : 0) / kBN;
    t_end = hi_last / kBN + 1;
  }

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {                 // the producer
    regs_dec<40>();
    if (threadIdx.x == kConsumers) {
      int stage = 0;
      uint32_t phase = 0;
      auto next = [&](uint32_t bytes) {
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_expect_tx(&full[stage], bytes);
        return ring + stage * kStage;
      };
      auto advance = [&]() {
        if (++stage == kStages) { stage = 0; phase ^= 1; }
      };
      for (int t = t_begin; t < t_end; ++t) {
        for (int c = 0; c < nC; ++c) {
          uint8_t* dst = next(kStage);
          tma_load_3d(dst, &map_q, &full[stage], c * kKCols, q0, bh);
          tma_load_3d(dst + kQPiece, &map_kh, &full[stage], c * kKCols,
                      t * kBN, kvh);
          tma_load_3d(dst + kQPiece + kKPiece, &map_kl, &full[stage],
                      c * kKCols, t * kBN, kvh);
          advance();
        }
        for (int j = 0; j < kBN / kVKeys; ++j) {
          uint8_t* dst = next(2 * kVHalf);
          tma_load_3d(dst, &map_vh, &full[stage], t * kBN + j * kVKeys, c0,
                      kvh);
          tma_load_3d(dst + kVHalf, &map_vl, &full[stage],
                      t * kBN + j * kVKeys, c0, kvh);
          advance();
        }
      }
    }
    return;
  }

  // the consumers
  regs_inc<232>();
  const int tid = threadIdx.x, wg = tid / 128;
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int wr_lo = q0 + wg * 64;                  // this warpgroup's rows
  const int r0 = wg * 64 + warp * 16 + g;          // its row in a Q stage
  const int row0 = q0 + r0, row1 = row0 + 8;
  const uint32_t ring_u32 = smem_u32(ring);
  // Q (r, c) of a stage: row r of 128 bytes, its 16-byte unit c / 4
  // swizzled by r % 8 (TMA's 128-byte swizzle); rows r0 and r0 + 8 share
  // the swizzle
  const float* q_lane = reinterpret_cast<const float*>(ring) + r0 * kKCols +
                        t4;
  auto q_at = [&](const float* qs, int unit, int row8) {
    return qs[row8 * 8 * kKCols + ((unit ^ (g & 7)) << 2)];
  };

  float acc[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
  float s[kBN / 2];
  Rows rows;
  int stage = 0, last = 0;
  uint32_t phase = 0;
  auto next_stage = [&]() {
    last = stage;
    if (++stage == kStages) { stage = 0; phase ^= 1; }
  };
  for (int tile = t_begin; tile < t_end; ++tile) {
    // S = Q.K^T: a stage is 32 columns of dh, two groups of two k8 steps
    // of three products each (as tf::); a wait leaves one group in
    // flight, so that a stage is freed once the group after its last is
    // issued
    for (int c = 0; c < nC; ++c) {
      mbar_wait_warp(&full[stage], phase);
      const float* qs = q_lane + stage * (kStage / 4);
      const uint32_t kb = ring_u32 + stage * kStage + kQPiece;
#pragma unroll
      for (int h = 0; h < 2; ++h) {      // two groups of two k8 steps
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int u = 4 * h + 2 * e;   // the step's first 16-byte unit
          tf::split4(q_at(qs, u, 0), q_at(qs, u, 1), q_at(qs, u + 1, 0),
                     q_at(qs, u + 1, 1), ah[e], al[e]);
        }
        fence_operands(s);
        wgmma_fence();
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ks = 2 * h + e;      // k8 step of the stage
          const uint64_t dkh = make_desc(kb, 16, 1024, 1) + (32 * ks >> 4);
          const uint64_t dkl = make_desc(kb + kKPiece, 16, 1024, 1) +
                               (32 * ks >> 4);
          wgmma_m64n64k8_rs_tf32(s, ah[e], dkh, c > 0 || ks > 0);
          wgmma_m64n64k8_rs_tf32(s, al[e], dkh, 1);
          wgmma_m64n64k8_rs_tf32(s, ah[e], dkl, 1);
        }
        wgmma_commit();
        wgmma_wait<1>();
        if (h == 0 && c > 0) mbar_arrive(&empty[last]);
      }
      next_stage();
    }
    wgmma_wait<0>();
    fence_operands(s);
    mbar_arrive(&empty[last]);

    if (rows.tile<kBN>(s, tile * kBN, wr_lo, row0, row1, t4, S, causal,
                       window, scale_log2))
      rows.rescale(acc);

    // O += P.V: per 16 keys a stage of V^T_hi and V^T_lo; A of k8 slice
    // kk is P at keys 8 kk + 2 t4 and + 1, which V^T's permuted keys put
    // at t4 and t4 + 4
#pragma unroll
    for (int j = 0; j < kBN / kVKeys; ++j) {
      uint32_t ph[2][4], pl[2][4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kk = 2 * j + e;
        tf::split4(s[4 * kk], s[4 * kk + 2], s[4 * kk + 1], s[4 * kk + 3],
                   ph[e], pl[e]);
      }
      mbar_wait_warp(&full[stage], phase);
      const uint32_t vb = ring_u32 + stage * kStage;
      fence_operands(acc);
      wgmma_fence();
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const uint64_t dvh = make_desc(vb, 16, 512, 2) + (32 * e >> 4);
        const uint64_t dvl = make_desc(vb + kVHalf, 16, 512, 2) +
                             (32 * e >> 4);
        PV<DV>::mma(acc, ph[e], dvh);
        PV<DV>::mma(acc, pl[e], dvh);
        PV<DV>::mma(acc, ph[e], dvl);
      }
      wgmma_commit();
      wgmma_wait<1>();
      if (j > 0) mbar_arrive(&empty[last]);
      next_stage();
    }
    wgmma_wait<0>();
    fence_operands(acc);
    mbar_arrive(&empty[last]);
  }

  rows.sum_quad();
  const float inv0 = 1.f / rows.l0, inv1 = 1.f / rows.l1;
  float* o0 = o + ((long long)bh * Tq + row0) * dh + c0 + 2 * t4;
  float* o1 = o0 + 8 * dh;
  // columns c0 + 8 j + 2 t4 and the next: one 8-byte store (dh % 4 == 0)
#pragma unroll
  for (int j = 0; j < DV / 8; ++j) {
    if (c0 + 8 * j >= dh) break;                   // padded columns
    if (row0 < Tq)
      *reinterpret_cast<float2*>(o0 + 8 * j) =
          make_float2(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
    if (row1 < Tq)
      *reinterpret_cast<float2*>(o1 + 8 * j) =
          make_float2(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
  }
}

// q, k, v: (B, Hq, Tq, dh) and (B, Hkv, S, dh) float32, dh % 4 == 0;
// scratch: split_kv's copies (tf::launch's); o like q.
template <int DV>
cudaError_t launch(const float* q, const float* k, const float* v,
                   float* scratch, float* o, int B, int Hq, int Hkv, int Tq,
                   int S, int dh, int causal, int window, float scale,
                   cudaStream_t stream) {
  if (dh % 4) return cudaErrorInvalidValue;
  const int dhp = dh, sp = (S + 7) / 8 * 8;
  const int heads = B * Hkv;
  float* khi = scratch;
  float* klo = khi + (long long)heads * S * dhp;
  float* vhi = klo + (long long)heads * S * dhp;
  float* vlo = vhi + (long long)heads * dh * sp;
  const dim3 pgrid((unsigned)((sp + 31) / 32), (unsigned)((dhp + 31) / 32),
                   (unsigned)(heads < 65535 ? heads : 65535));
  tf::split_kv<<<pgrid, 256, 0, stream>>>(k, v, khi, klo, vhi, vlo, heads, S,
                                          dh, dhp, sp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const cuuint64_t dq[3] = {(cuuint64_t)dh, (cuuint64_t)Tq,
                            (cuuint64_t)B * Hq};
  const cuuint64_t dk[3] = {(cuuint64_t)dhp, (cuuint64_t)S,
                            (cuuint64_t)heads};
  const cuuint64_t dv[3] = {(cuuint64_t)sp, (cuuint64_t)dh,
                            (cuuint64_t)heads};
  const cuuint32_t bq[3] = {kKCols, kBM, 1};
  const cuuint32_t bk[3] = {kKCols, kBN, 1};
  const cuuint32_t bv[3] = {kVKeys, DV, 1};
  CUtensorMap mq, mkh, mkl, mvh, mvl;
  if ((err = make_map(&mq, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, q, 3, dq, bq,
                      CU_TENSOR_MAP_SWIZZLE_128B)) != cudaSuccess ||
      (err = make_map(&mkh, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, khi, 3, dk,
                      bk, CU_TENSOR_MAP_SWIZZLE_128B)) != cudaSuccess ||
      (err = make_map(&mkl, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, klo, 3, dk,
                      bk, CU_TENSOR_MAP_SWIZZLE_128B)) != cudaSuccess ||
      (err = make_map(&mvh, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, vhi, 3, dv,
                      bv, CU_TENSOR_MAP_SWIZZLE_64B)) != cudaSuccess ||
      (err = make_map(&mvl, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, vlo, 3, dv,
                      bv, CU_TENSOR_MAP_SWIZZLE_64B)) != cudaSuccess)
    return err;
  err = cudaFuncSetAttribute(tfc_kernel<DV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmem);
  if (err != cudaSuccess) return err;
  const int chunks = (dh + DV - 1) / DV;
  for (int hi = (Tq + kBM - 1) / kBM; hi > 0; hi -= kMaxQBlocks) {
    const int n = hi < kMaxQBlocks ? hi : kMaxQBlocks;
    dim3 grid((unsigned)((long long)B * Hq), (unsigned)n, (unsigned)chunks);
    tfc_kernel<DV><<<grid, kThreads, kSmem, stream>>>(
        mq, mkh, mkl, mvh, mvl, o, Hq, Hkv, Tq, S, dh, causal, window,
        scale * kLog2e, hi - n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace tfc

namespace {

// dtype 1 (bfloat16) takes the tensor cores (scratch: the staged route's
// padded copies, or null), dtype 0 (float32) the FMAs to 128 and the
// tensor cores in TF32 at 256 (scratch: split_kv's copies); the instance
// of width DH takes dh <= DH.
template <int DH>
cudaError_t launch_route(int dtype, const void* q, const void* k,
                         const void* v, void* scratch, void* o, int B, int Hq,
                         int Hkv, int Tq, int S, int dh, int causal,
                         int window, float scale, cudaStream_t stream) {
  if (dtype == 1)
    return scratch ? tc::launch_staged<DH>(q, k, v, scratch, o, B, Hq, Hkv,
                                           Tq, S, dh, causal, window, scale,
                                           stream)
                   : tc::launch<DH>(q, k, v, dh, o, B, Hq, Hkv, Tq, S, dh,
                                    causal, window, scale, stream);
  if constexpr (DH == tf::kDH)
    return tf::launch(static_cast<const float*>(q),
                      static_cast<const float*>(k),
                      static_cast<const float*>(v),
                      static_cast<float*>(scratch), static_cast<float*>(o), B,
                      Hq, Hkv, Tq, S, dh, causal, window, scale, stream);
  else
    return simt::launch<DH>(q, k, v, o, B, Hq, Hkv, Tq, S, dh, causal,
                            window, scale, stream);
}

// The instances past 256, O's columns in two halves: the tensor cores
// (bfloat16) or the FMAs (float32, simt::launch_half at DV = DH / 2).
template <int DH>
cudaError_t launch_halves(int dtype, const void* q, const void* k,
                          const void* v, void* scratch, void* o, int B,
                          int Hq, int Hkv, int Tq, int S, int dh, int causal,
                          int window, float scale, cudaStream_t stream) {
  if (dtype == 1)
    return scratch
               ? tc::launch_staged<DH, DH / 2>(q, k, v, scratch, o, B, Hq,
                                               Hkv, Tq, S, dh, causal,
                                               window, scale, stream)
               : tc::launch<DH, DH / 2>(q, k, v, dh, o, B, Hq, Hkv, Tq, S,
                                        dh, causal, window, scale, stream);
  return simt::launch_half<DH / 2>(q, k, v, o, B, Hq, Hkv, Tq, S, dh, causal,
                                   window, scale, stream);
}

// Past dh 512, O in chunks of DV columns: bfloat16 on the tensor cores
// (chunk::, DV 192 or 256; scratch: the staged route's copies, or null),
// float32 on them in TF32 (tfc::, DV 192 or 256, dh % 4 == 0; scratch:
// split_kv's copies) or on the FMAs (simt::launch_half, DV 320).
template <int DV>
cudaError_t launch_chunks(int dtype, const void* q, const void* k,
                          const void* v, void* scratch, void* o, int B,
                          int Hq, int Hkv, int Tq, int S, int dh, int causal,
                          int window, float scale, int stream_q,
                          cudaStream_t stream) {
  if constexpr (DV <= 256) {
    if (dtype == 0)
      return scratch ? tfc::launch<DV>(static_cast<const float*>(q),
                                       static_cast<const float*>(k),
                                       static_cast<const float*>(v),
                                       static_cast<float*>(scratch),
                                       static_cast<float*>(o), B, Hq, Hkv, Tq,
                                       S, dh, causal, window, scale, stream)
                     : cudaErrorInvalidValue;
    return scratch ? chunk::launch_staged<DV>(q, k, v, scratch, o, B, Hq, Hkv,
                                              Tq, S, dh, causal, window, scale,
                                              stream_q, stream)
                   : chunk::launch<DV>(q, k, v, dh, o, B, Hq, Hkv, Tq, S, dh,
                                       causal, window, scale, stream_q,
                                       stream);
  } else {
    if (dtype != 0 || scratch) return cudaErrorInvalidValue;
    return simt::launch_half<DV>(q, k, v, o, B, Hq, Hkv, Tq, S, dh, causal,
                                 window, scale, stream);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; q, k, v and o alike.  chunks 0: inst
// is the padded instance, dh <= inst: 32, 64, 96, 128 or 256 (the tensor
// cores for bfloat16; for float32 the FMAs to 128, at 256 the tensor
// cores in TF32), or 320, 384, 448 or 512 (O in two halves of columns, a
// block each).  chunks 1 (dh past 512): O in chunks of inst columns, any
// dh: bfloat16 192 or 256 (chunk::, Q in shared memory where it fits;
// chunks 2: Q streamed beside K at any dh), float32 192 or 256 (tfc::,
// dh % 4 == 0, scratch split_kv's copies as at inst 256) or 320
// (simt::half_kernel, any dh).  scratch (bfloat16): null, TMA on q, k and v (dh a
// multiple of 8); else the staged route, any dh: (B Hq T + 2 B Hkv S) (dh
// rounded up to 8) bfloat16 values for the padded copies.  scratch
// (float32): null but at 256, where it is split_kv's 2 B Hkv (S dhp + dh
// sp) floats (dhp = dh rounded up to 4, sp = S rounded up to 8).  A
// float32 FMA instance reads 16-byte pieces where dh % 4 == 0, else
// values.  Hq a multiple of Hkv; tensors contiguous and 16-byte aligned
// (the wrapper checks).  window 0 means no window.  Any B Hq and any T:
// blocks of 128 query rows on the bfloat16 tensor cores (64 in chunks),
// 64 in TF32 (128 in chunks) and on the FMAs, the heads on the grid's x and the query
// blocks on its y, which takes 65,535 of them (more go in launches of as
// many, the last blocks, the heaviest under a causal mask, first); the
// float32 halves and chunks put (head, chunk, pair of query blocks) on
// the grid's x, one launch.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, void* scratch, int dtype, int B,
                               int Hq, int Hkv, int Tq, int S, int dh,
                               int inst, int chunks, int causal, int window,
                               float scale, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv || Tq <= 0 || S <= 0
      || dh <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (dtype == 1 && !scratch && dh % 8) return (int)cudaErrorInvalidValue;
  if (chunks) {
    if (chunks > 2 || (chunks == 2 && dtype != 1))
      return (int)cudaErrorInvalidValue;
    const int sq = chunks == 2;
    switch (inst) {
      case 192: return (int)launch_chunks<192>(dtype, q, k, v, scratch, o, B,
                                               Hq, Hkv, Tq, S, dh, causal,
                                               window, scale, sq, s);
      case 256: return (int)launch_chunks<256>(dtype, q, k, v, scratch, o, B,
                                               Hq, Hkv, Tq, S, dh, causal,
                                               window, scale, sq, s);
      case 320: return (int)launch_chunks<320>(dtype, q, k, v, scratch, o, B,
                                               Hq, Hkv, Tq, S, dh, causal,
                                               window, scale, sq, s);
    }
    return (int)cudaErrorInvalidValue;
  }
  if (dh > inst || (dtype == 0 && (scratch != nullptr) != (inst == tf::kDH)))
    return (int)cudaErrorInvalidValue;
  switch (inst) {
    case 32: return (int)launch_route<32>(dtype, q, k, v, scratch, o, B, Hq,
                                          Hkv, Tq, S, dh, causal, window,
                                          scale, s);
    case 64: return (int)launch_route<64>(dtype, q, k, v, scratch, o, B, Hq,
                                          Hkv, Tq, S, dh, causal, window,
                                          scale, s);
    case 96: return (int)launch_route<96>(dtype, q, k, v, scratch, o, B, Hq,
                                          Hkv, Tq, S, dh, causal, window,
                                          scale, s);
    case 128: return (int)launch_route<128>(dtype, q, k, v, scratch, o, B,
                                            Hq, Hkv, Tq, S, dh, causal,
                                            window, scale, s);
    case 256: return (int)launch_route<256>(dtype, q, k, v, scratch, o, B,
                                            Hq, Hkv, Tq, S, dh, causal,
                                            window, scale, s);
    case 320: return (int)launch_halves<320>(dtype, q, k, v, scratch, o, B,
                                             Hq, Hkv, Tq, S, dh, causal,
                                             window, scale, s);
    case 384: return (int)launch_halves<384>(dtype, q, k, v, scratch, o, B,
                                             Hq, Hkv, Tq, S, dh, causal,
                                             window, scale, s);
    case 448: return (int)launch_halves<448>(dtype, q, k, v, scratch, o, B,
                                             Hq, Hkv, Tq, S, dh, causal,
                                             window, scale, s);
    case 512: return (int)launch_halves<512>(dtype, q, k, v, scratch, o, B,
                                             Hq, Hkv, Tq, S, dh, causal,
                                             window, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
