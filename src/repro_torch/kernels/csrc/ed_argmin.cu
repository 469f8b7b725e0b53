// Exact 1-NN scan: for every query, the least squared Euclidean distance
// to any candidate and that candidate's index,
//   d^2 = max(|q|^2 + |x|^2 - 2 q.x, 0) in float32,
// ties to the lowest index.
//
// Replaces the Pallas kernel `_ed_kernel` of
// src/repro/kernels/ed_argmin.py (wrapper `ed_argmin`).
//
// Bound on this card: operations, at the accuracy the check asks for,
// for every L and either route.
// d^2 of two z-normalized rows of 256 cancels |q|^2 + |x|^2 = 512 down to
// d^2, so q.x must keep about seven digits.  One TF32 product keeps about
// three (a 10-bit mantissa): too few for rtol 1e-4.  Three TF32 products
// keep float32's: with a = a_hi + a_lo, a_hi = tf32(a), a_lo = tf32(a -
// a_hi), q.x = q_hi.x_hi + q_hi.x_lo + q_lo.x_hi up to ~2^-21 relative
// (3xTF32).  At Q = 256 queries, N = 2^24 candidates and L = 256 the
// 3 * 2 * Q * N * L = 6.6e12 operations take 13.3 ms at the 495 TFLOP/s
// TF32 tensor peak; reading the 16 GiB of candidates takes 5.1 ms at
// 3.35 TB/s.  (As float32 FMAs outside the tensor cores the same product
// would take 32.8 ms at 67 TFLOP/s.)  Candidates stored in bfloat16 are
// exact in TF32, so they need x_hi alone: two products.
//
// Design: the TPU kernel walks candidate blocks on a sequential grid axis
// and carries (min, argmin) in its output tile.  Here a block owns a
// group of kBQ = 256 queries and a contiguous range of candidate tiles of
// kBM = 128 rows (about one block per SM).  A first small kernel splits
// the queries into q_hi and q_lo (scratch from the wrapper, rows padded
// with zeros to a whole number of kKC-column chunks, so that their TMA
// maps always have 16-byte strides) and sums |q|^2.  In the main kernel
// warpgroup 2 is the producer: it keeps kKC = 32-column chunks of the
// candidate tile and of q_hi and q_lo in a two-stage ring in shared
// memory (mbarriers for full and empty).  Warpgroups 0 and 1 each own 64
// candidates of the tile: per chunk they read their candidates' values
// from shared memory into the wgmma's A registers, split them into x_hi
// and x_lo there, and run wgmma m64n256k8 with the queries as B (K-major
// in shared memory, as stored), all three products into one float32
// accumulator.  The same values give |x|^2.  The epilogue forms, per
// (candidate, query), the key
//   (float_bits(d^2) << 32) | index,
// which for d^2 >= 0 (the clamp turns -0.0 into +0.0) orders by least
// d^2, then lowest index: the JAX tie rule.  A thread holds two
// candidates for 64 queries; it keeps the lesser key of the two, then
// three halving shuffle rounds over the eight lanes that share its
// queries leave each lane the least of its warp's 16 candidates for 8
// queries, kept across tiles in registers; one 64-bit atomicMin per
// (query, warp) at the end merges warps and blocks in whatever order they
// run.  A last small kernel unpacks the keys.  Identical rows give
// identical d^2 (the duplicated-row check): every candidate's products,
// |x|^2 and d^2 go through the same instructions in the same order,
// wherever it lies.  A ragged N is masked: rows past N arrive as zeros
// and never form a key.  A ragged Q pads the scratch with zero rows,
// whose keys are never written.
//
// Two loaders fill the same ring, in the same layout, for the same
// consumers (route, by the candidates' rows):
// * "tensor" (route 0): rows of whole 16-byte pieces (L a multiple of 4
//   in float32, of 8 in bfloat16) on a 16-byte aligned base.  One thread
//   keeps TMA loads in flight, boxes of kKC x kBM whose columns past L
//   (and rows past N) TMA fills with zeros (L 100 reads 4 chunks of 32).
// * "staged" (route 1): any other L or base.  TMA cannot take a row
//   whose stride is not a multiple of 16 bytes, and a padded copy of the
//   candidates would double their memory (16 GiB at the main cell), so
//   the producer warpgroup's 128 threads write each chunk themselves, in
//   16-byte units (consecutive threads, consecutive units of a row: one
//   coalesced read a warp) each at the byte TMA's 128- or 64-byte
//   swizzle would put it (XChunk::kSpan), so the consumers read it as
//   before.  A unit goes by cp.async pieces as wide as its row's
//   alignment allows (copy16: one 16-byte copy on an aligned row, else
//   two of 8 or four of 4; zeros past L and N by a source size short of
//   the piece), so that a whole chunk is in flight at once; a cp.async
//   costs about the same whatever its width, so rows of narrower pieces
//   cost more (at L 235 half the rows go in 4-byte pieces).  A bfloat16
//   row that is not 4-byte aligned is read by 2-byte loads and stored by
//   st.shared.  Each thread arrives on the chunk's full barrier once its copies land
//   (cp.async.mbarrier.arrive.noinc, after a wait where it stored
//   itself: 128 arrivals, beside the one thread that arms the queries'
//   TMA bytes).  The consumers read the candidates with ld.shared, the
//   generic proxy these writes are in, so no proxy fence is needed.
// The queries keep TMA on both.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kBM = 128;           // candidates per tile
constexpr int kBQ = 256;           // queries per block: the wgmma's N
constexpr int kKC = 32;            // columns per chunk
constexpr int kStages = 2;         // chunks in flight
constexpr int kThreads = 384;      // warpgroups 0, 1 consume, 2 loads
constexpr int kConsumers = 256;
constexpr int kQChunk = kBQ * kKC * 4;   // bytes of q_hi (or q_lo) a chunk

// A (kBM x kKC) chunk of candidates as TMA writes it: rows of kSpan bytes
// with the 16-byte chunks swizzled by the row's 128-byte line.
template <typename T>
struct XChunk {
  static constexpr int kSpan = kKC * (int)sizeof(T);      // 128 or 64
  static constexpr uint32_t kMask = kSpan == 128 ? 7u : 3u;
  static constexpr int kBytes = kBM * kSpan;
  static constexpr bool kSplit = sizeof(T) == 4;  // bf16 is exact in tf32
  static constexpr int kSmem =
      1024 + kStages * (kBytes + 2 * kQChunk) + 4 * kBQ + 16 * kStages;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ float x_at(const uint8_t* chunk, int row,
                                      int col) {
  return to_float(*reinterpret_cast<const T*>(
      chunk + swizzled(row * XChunk<T>::kSpan + col * (int)sizeof(T),
                       XChunk<T>::kMask)));
}

__device__ __forceinline__ unsigned long long umin64(unsigned long long a,
                                                     unsigned long long b) {
  return a < b ? a : b;
}

// The lanes whose mask bit is set keep the upper half of k[0, kN), the
// others the lower half, each the least of its own and its partner's.
template <int kN, int kMask>
__device__ __forceinline__ void fold_half(unsigned long long (&k)[64],
                                          bool upper) {
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) {
    const unsigned long long send = upper ? k[i] : k[i + kN / 2];
    const unsigned long long keep = upper ? k[i + kN / 2] : k[i];
    k[i] = umin64(keep, __shfl_xor_sync(0xffffffffu, send, kMask));
  }
}

// q (Q, L) -> q_hi, q_lo (Qpad, Lp) tf32 values and |q|^2 (Qpad), Lp = L
// rounded up to kKC; rows past Q and columns past L are zeros.  One block
// of 128 threads per row.
__global__ void split_queries(const float* __restrict__ q,
                              float* __restrict__ qh, float* __restrict__ ql,
                              float* __restrict__ qq, int Q, int L, int Lp) {
  __shared__ float part[4];
  const int row = blockIdx.x;
  float acc = 0.f;
  for (int c = threadIdx.x; c < Lp; c += blockDim.x) {
    const float v = row < Q && c < L ? q[(long long)row * L + c] : 0.f;
    const float hi = __uint_as_float(tf32_rna(v));
    qh[(long long)row * Lp + c] = hi;
    ql[(long long)row * Lp + c] = __uint_as_float(tf32_rna(v - hi));
    acc = fmaf(v, v, acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = acc;
  __syncthreads();
  if (threadIdx.x == 0) qq[row] = (part[0] + part[1]) + (part[2] + part[3]);
}

// The staged loader: producer thread pt's (0..127) share of the (kBM x
// kKC) chunk of candidate rows [n0, n0 + kBM) and columns [c0, c0 + kKC),
// zeros past N and L.  Unit i of the thread, u = pt + 128 i, is the
// 16-byte piece u % P of row u / P (P = kSpan / 16 a row: consecutive
// threads, consecutive bytes), copied by copy16 (cp.async pieces as wide
// as the row's alignment allows, the whole chunk in flight at once) to
// the bytes TMA's swizzle gives it (x_at reads it there).  Returns
// whether any unit was stored synchronously (a bfloat16 row not 4-byte
// aligned).
template <typename T>
__device__ __forceinline__ bool stage_chunk(uint8_t* dst, const T* xs,
                                            long long n0, int c0, int N,
                                            int L, int pt) {
  using X = XChunk<T>;
  constexpr int kPer = X::kSpan / 16;              // pieces a row
  constexpr int kVals = 16 / (int)sizeof(T);
  constexpr int kEach = kBM * kPer / 128;          // pieces a thread
  const uint32_t base = smem_u32(dst);
  bool sync = false;
#pragma unroll
  for (int i = 0; i < kEach; ++i) {
    const int u = pt + 128 * i, row = u / kPer, col = u % kPer * kVals;
    const int valid = n0 + row < N ? (L - c0 - col) * (int)sizeof(T) : 0;
    sync |= copy16(base + swizzled(row * X::kSpan + u % kPer * 16, X::kMask),
                   reinterpret_cast<const uint8_t*>(
                       xs + (n0 + row) * L + c0 + col),
                   valid > 16 ? 16 : valid, xs);
  }
  return sync;
}

// kStaged: the staged route (stage_chunk, from xs); else the tensor route
// (TMA reads the candidates through map_x).
template <typename T, bool kStaged>
__global__ void __launch_bounds__(kThreads, 1)
ed_tc_kernel(const __grid_constant__ CUtensorMap map_x,
             const __grid_constant__ CUtensorMap map_qh,
             const __grid_constant__ CUtensorMap map_ql,
             const T* __restrict__ xs, const float* __restrict__ qq,
             unsigned long long* __restrict__ keys,
             int Q, int N, int L, int tiles_per_block) {
  using X = XChunk<T>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* x_s = align1024(smem_raw);               // [kStages][X::kBytes]
  uint8_t* qh_s = x_s + kStages * X::kBytes;        // [kStages][kQChunk]
  uint8_t* ql_s = qh_s + kStages * kQChunk;
  float* qq_s = reinterpret_cast<float*>(ql_s + kStages * kQChunk);
  uint64_t* full = reinterpret_cast<uint64_t*>(qq_s + kBQ);
  uint64_t* empty = full + kStages;

  const int q0 = blockIdx.x * kBQ;
  const int n_tiles = (N + kBM - 1) / kBM;
  const int t_begin = blockIdx.y * tiles_per_block;
  const int t_end = min(n_tiles, t_begin + tiles_per_block);
  const int n_chunks = (L + kKC - 1) / kKC;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      // staged: one arrival a producer thread, and the queries' TMA bytes
      mbar_init(&full[s], kStaged ? 1 + kThreads - kConsumers : 1);
      mbar_init(&empty[s], kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {                 // the producer
    regs_dec<kStaged ? 56 : 40>();
    if constexpr (kStaged) {                       // staged: all 128
      const int pt = threadIdx.x - kConsumers;
      int stage = 0;
      uint32_t phase = 0;
      for (int t = t_begin; t < t_end; ++t)
        for (int c = 0; c < n_chunks; ++c) {
          mbar_wait(&empty[stage], phase ^ 1);
          if (pt == 0) {
            mbar_expect_tx(&full[stage], 2 * kQChunk);
            tma_load_2d(qh_s + stage * kQChunk, &map_qh, &full[stage],
                        c * kKC, q0);
            tma_load_2d(ql_s + stage * kQChunk, &map_ql, &full[stage],
                        c * kKC, q0);
          }
          if (stage_chunk<T>(x_s + stage * X::kBytes, xs, (long long)t * kBM,
                             c * kKC, N, L, pt)) {
            // a thread that stored some pieces itself may have copies in
            // flight too: commit and wait for them all, then arrive (the
            // arrive releases the st.shared)
            cp_async_commit();
            cp_async_wait<0>();
            mbar_arrive(&full[stage]);
          } else {
            cp_async_arrive(&full[stage]);       // once its copies land
          }
          if (++stage == kStages) { stage = 0; phase ^= 1; }
        }
    } else if (threadIdx.x == kConsumers) {        // TMA: one thread
      int stage = 0;
      uint32_t phase = 0;
      for (int t = t_begin; t < t_end; ++t)
        for (int c = 0; c < n_chunks; ++c) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], X::kBytes + 2 * kQChunk);
          tma_load_2d(x_s + stage * X::kBytes, &map_x, &full[stage],
                      c * kKC, t * kBM);
          tma_load_2d(qh_s + stage * kQChunk, &map_qh, &full[stage],
                      c * kKC, q0);
          tma_load_2d(ql_s + stage * kQChunk, &map_ql, &full[stage],
                      c * kKC, q0);
          if (++stage == kStages) { stage = 0; phase ^= 1; }
        }
    }
  } else {                                         // the consumers
    regs_inc<kStaged ? 224 : 232>();
    qq_s[threadIdx.x] = qq[q0 + threadIdx.x];
    named_sync(1, kConsumers);
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t4 = lane % 4;
    const int r0 = wg * 64 + warp * 16 + g, r1 = r0 + 8;   // tile rows

    unsigned long long best[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) best[i] = ~0ull;

    int stage = 0;
    uint32_t phase = 0;
    for (int tile = t_begin; tile < t_end; ++tile) {
      float acc[128];
      float xx0 = 0.f, xx1 = 0.f;
      for (int c = 0; c < n_chunks; ++c) {
        mbar_wait(&full[stage], phase);
        const uint8_t* xc = x_s + stage * X::kBytes;
        // A of k8 step s: rows r0, r1 and columns 8s + t4, 8s + t4 + 4
        uint32_t a_hi[kKC / 8][4], a_lo[kKC / 8][4];
#pragma unroll
        for (int s = 0; s < kKC / 8; ++s) {
          const float v[4] = {x_at<T>(xc, r0, 8 * s + t4),
                              x_at<T>(xc, r1, 8 * s + t4),
                              x_at<T>(xc, r0, 8 * s + t4 + 4),
                              x_at<T>(xc, r1, 8 * s + t4 + 4)};
          xx0 = fmaf(v[0], v[0], xx0);
          xx0 = fmaf(v[2], v[2], xx0);
          xx1 = fmaf(v[1], v[1], xx1);
          xx1 = fmaf(v[3], v[3], xx1);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            a_hi[s][i] = tf32_rna(v[i]);
            a_lo[s][i] = X::kSplit
                             ? tf32_rna(v[i] - __uint_as_float(a_hi[s][i]))
                             : 0u;
          }
        }
        const uint32_t qh_base = smem_u32(qh_s + stage * kQChunk);
        const uint32_t ql_base = smem_u32(ql_s + stage * kQChunk);
        fence_operands(acc);
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < kKC / 8; ++s) {
          const uint64_t dh = make_desc(qh_base + 32 * s, 16, 1024, 1);
          const uint64_t dl = make_desc(ql_base + 32 * s, 16, 1024, 1);
          wgmma_m64n256k8_rs_tf32(acc, a_hi[s], dh, c > 0 || s > 0);
          if (X::kSplit) wgmma_m64n256k8_rs_tf32(acc, a_lo[s], dh, 1);
          wgmma_m64n256k8_rs_tf32(acc, a_hi[s], dl, 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_operands(acc);
        mbar_arrive(&empty[stage]);
        if (++stage == kStages) { stage = 0; phase ^= 1; }
      }

      // |x|^2 of rows r0 and r1: the four lanes of a row meet
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        xx0 += __shfl_xor_sync(0xffffffffu, xx0, off);
        xx1 += __shfl_xor_sync(0xffffffffu, xx1, off);
      }
      // acc[4j + e]: row r0 (e < 2) or r1, query q0 + 8j + 2 t4 + (e & 1);
      // k[2j + e] keeps the lesser key of the two rows
      const int n0 = tile * kBM + r0, n1 = n0 + 8;
      unsigned long long k[64];
#pragma unroll
      for (int j = 0; j < 32; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float qv = qq_s[8 * j + 2 * t4 + e];
          // rounded step by step as the plain version writes it
          float d0 = __fsub_rn(__fadd_rn(qv, xx0),
                               __fmul_rn(2.f, acc[4 * j + e]));
          float d1 = __fsub_rn(__fadd_rn(qv, xx1),
                               __fmul_rn(2.f, acc[4 * j + 2 + e]));
          d0 = d0 > 0.f ? d0 : 0.f;                  // and -0.0 -> +0.0
          d1 = d1 > 0.f ? d1 : 0.f;
          const unsigned long long k0 =
              n0 < N ? ((unsigned long long)__float_as_uint(d0) << 32) |
                           (unsigned)n0
                     : ~0ull;
          const unsigned long long k1 =
              n1 < N ? ((unsigned long long)__float_as_uint(d1) << 32) |
                           (unsigned)n1
                     : ~0ull;
          k[2 * j + e] = umin64(k0, k1);
        }
      // lanes 4g + t4 share their queries across g: three halving rounds
      fold_half<64, 4>(k, lane & 4);
      fold_half<32, 8>(k, lane & 8);
      fold_half<16, 16>(k, lane & 16);
#pragma unroll
      for (int i = 0; i < 8; ++i) best[i] = umin64(best[i], k[i]);
    }

    // best[i] holds index base + i of k, i.e. query
    // q0 + 8 ((base + i) >> 1) + 2 t4 + ((base + i) & 1)
    const int base = 32 * (g & 1) + 16 * ((g >> 1) & 1) + 8 * ((g >> 2) & 1);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int qi = q0 + 8 * ((base + i) >> 1) + 2 * t4 + ((base + i) & 1);
      if (qi < Q && best[i] != ~0ull) atomicMin(&keys[qi], best[i]);
    }
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

// kStaged as ed_tc_kernel's.
template <typename T, bool kStaged>
cudaError_t launch(const float* q, const void* xs, float* scratch,
                   unsigned long long* keys, float* d, int* idx, int Q, int N,
                   int L, cudaStream_t stream) {
  using X = XChunk<T>;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int q_groups = (Q + kBQ - 1) / kBQ;
  const int q_pad = q_groups * kBQ;
  const int lp = (L + kKC - 1) / kKC * kKC;
  float* qh = scratch;
  float* ql = qh + (size_t)q_pad * lp;
  float* qq = ql + (size_t)q_pad * lp;

  const cuuint64_t dx[2] = {(cuuint64_t)L, (cuuint64_t)N};
  const cuuint64_t dq[2] = {(cuuint64_t)lp, (cuuint64_t)q_pad};
  const cuuint32_t bx[2] = {kKC, kBM};
  const cuuint32_t bq[2] = {kKC, kBQ};
  CUtensorMap mx{}, mqh, mql;                      // mx: the tensor route's
  if ((!kStaged &&
       (err = make_map(&mx,
                       sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                      : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                       sizeof(T), xs, 2, dx, bx,
                       X::kSpan == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                       : CU_TENSOR_MAP_SWIZZLE_64B)) !=
           cudaSuccess) ||
      (err = make_map(&mqh, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, qh, 2, dq, bq,
                      CU_TENSOR_MAP_SWIZZLE_128B)) != cudaSuccess ||
      (err = make_map(&mql, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, ql, 2, dq, bq,
                      CU_TENSOR_MAP_SWIZZLE_128B)) != cudaSuccess)
    return err;
  err = cudaFuncSetAttribute(ed_tc_kernel<T, kStaged>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             X::kSmem);
  if (err != cudaSuccess) return err;

  err = cudaMemsetAsync(keys, 0xff, sizeof(unsigned long long) * Q, stream);
  if (err != cudaSuccess) return err;
  split_queries<<<q_pad, 128, 0, stream>>>(q, qh, ql, qq, Q, L, lp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // about one block per SM, each over a contiguous range of tiles
  const int n_tiles = (N + kBM - 1) / kBM;
  int ranges = sms / q_groups;
  ranges = ranges < 1 ? 1 : (ranges > n_tiles ? n_tiles : ranges);
  const int per = (n_tiles + ranges - 1) / ranges;
  ranges = (n_tiles + per - 1) / per;
  dim3 grid((unsigned)q_groups, (unsigned)ranges);
  ed_tc_kernel<T, kStaged><<<grid, kThreads, X::kSmem, stream>>>(
      mx, mqh, mql, static_cast<const T*>(xs), qq, keys, Q, N, L, per);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  unpack_kernel<<<(Q + 255) / 256, 256, 0, stream>>>(keys, d, idx, Q);
  return cudaGetLastError();
}

}  // namespace

// dtype of xs: 0 = float32, 1 = bfloat16; q is float32 (any alignment:
// the kernel reads it into scratch).  route 0 (tensor, TMA): L * the
// element size a multiple of 16 and xs 16-byte aligned; route 1 (staged,
// cp.async): any L and alignment.  N < 2^31 (the wrapper checks); scratch
// is 2 * Qpad * Lp + Qpad floats with Qpad = Q rounded up to 256 and Lp =
// L rounded up to 32; keys is (Q,) 64-bit.  Q >= 1 and N >= 1.
extern "C" int ed_argmin(const void* q, const void* xs, int dtype,
                         void* scratch, void* keys, void* out_d,
                         void* out_idx, int Q, int N, int L, int route,
                         void* stream) {
  if (Q <= 0 || N <= 0 || L <= 0 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  const float* qf = static_cast<const float*>(q);
  float* sc = static_cast<float*>(scratch);
  unsigned long long* k = static_cast<unsigned long long*>(keys);
  float* d = static_cast<float*>(out_d);
  int* i = static_cast<int*>(out_idx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int elem = dtype == 0 ? 4 : 2;
  if (route == 0) {
    if ((long long)L * elem % 16 || reinterpret_cast<uintptr_t>(xs) % 16)
      return (int)cudaErrorInvalidValue;
    return dtype == 0
               ? (int)launch<float, false>(qf, xs, sc, k, d, i, Q, N, L, s)
               : (int)launch<__nv_bfloat16, false>(qf, xs, sc, k, d, i, Q, N,
                                                   L, s);
  }
  if (route != 1) return (int)cudaErrorInvalidValue;
  return dtype == 0
             ? (int)launch<float, true>(qf, xs, sc, k, d, i, Q, N, L, s)
             : (int)launch<__nv_bfloat16, true>(qf, xs, sc, k, d, i, Q, N, L,
                                                s);
}

extern "C" const char* ed_argmin_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
