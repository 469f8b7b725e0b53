// Exact DTW 1-NN search under a Sakoe-Chiba band of radius r:
//
// dtw_lb_keogh: the squared LB_Keogh of each query of a group against
// each series of the collection, (Qg, N).
// dtw_search:   the whole refinement of every query of a group in one
// launch: candidates in ascending-bound order, round_k a round, the loop
// of rounds on the device, each candidate's banded DTW pruned against the
// best-so-far at its round's start.
// dtw_scan:     the banded DTW of each query against every series, with
// the first-index argmin (the brute force).
//
// No Pallas kernel stands behind these: repro's DTW is plain jnp
// (src/repro/core/dtw.py: lb_keogh, dtw_band, search_dtw,
// search_dtw_bruteforce), a lax.scan DP per candidate under lax.map.  As
// torch operations a DP row is 2r + 1 dependent small operations, so the
// port runs the DP here.
//
// Bound on this card: the SMs' issue rate.  A DP cell is a subtract, a
// multiply, two mins and an add (five f32 instructions, the multiply and
// the add kept apart: __fmul_rn / __fadd_rn, because nvcc would contract
// them into an FMA and change the bits against the plain version); a
// series of L = 256 is 1 KB against L (2r + 1) cells.  An LB_Keogh point
// is a max, a min, a subtract and an FMA a query (e = x - min(max(x, lo),
// hi), e^2 with the bits of max(x - hi, lo - x, 0)^2, as a CPU test holds);
// the group's queries share each read of a series, so with 32 queries the
// pass is bound by the issue rate (the two mins take the ALU pipe, half
// the lanes of the FMA pipes, so four instructions a point fill both), not
// by the collection's bytes.
//
// The DP.  Cell (i, c = i - r + k) of the band, offset k in [0, 2r]:
//   d = (q[i] - x[c])^2,  cur[k] = d + min(prev[k], prev[k + 1], cur[k-1])
// with prev[k] = cost[i-1, i-1-r+k] (diag) and prev[k+1] (up), BIG = 1e30
// for a cell outside [0, L), and row 0 the running sum from column 0, as
// repro's dtw_band computes it; min is exact, so the result equals the
// plain version (kernels/ref.py dtw_band_ref) bit for bit.  Three layouts:
// - one thread a (query, candidate) pair (dtw_scan's band route, r <= 16):
//   each thread walks the rows of its pair in order, the band of the
//   previous row in registers (a template instance for each r: 2 (2r + 1)
//   registers for the band and the series window).  A warp's 32 threads
//   run 32 pairs in step, so the left-to-right chain of a row never
//   serialises a warp, but a pair takes L (2r + 1) cells in series.
// - a wavefront over the lanes of a warp a pair (dtw_search's wave
//   routes, r <= 127, dtw_wave; dtw_scan's wave route, r <= 255,
//   scan_pair): cell (i, k) reads only cells of the wavefronts t - 1 and
//   t - 2, t = 2i + k.  Lane l holds C offsets, C l .. C l + C - 1, and at
//   step s forms row s - l's C cells left to right, its neighbours' cells
//   coming by two shuffles a step (wave_cells): a pair takes about L + r /
//   C steps over H = ceil((2r + 1) / C) lanes, and a warp runs 32 / H
//   pairs side by side.  C is the template, r a runtime argument: 2, 4 or
//   8 (r <= 31, 63, 127) for dtw_search (and 16, r <= 255, past L 1,024),
//   16 (r <= 255) for dtw_scan, and past L 1,024 16 to 24 by radius.  The
//   series is staged in shared memory first, or goes through a ring of
//   columns past L 1,024.
// - strips of rows a pair, a warp a strip (strip_dp): every r and L, past
//   the wave routes' radii (r > 127 at L <= 1,024, r > 255 above) and
//   round_k 1,024.  A pair's rows in strips of 32 K (K rows a lane), each
//   swept column by column as a skewed wavefront over the lanes, a strip
//   handing its last row to the next: in dtw_scan's chain route through a
//   warp's own shared memory (a warp runs a pair's strips in order), in
//   dtw_search's spread route through the shared memory of the CTA whose
//   warps run a pair's strips, and in the diag routes of both kernels (the
//   default where a pair's row passes shared memory, or the scan's pairs
//   are too few to fill the card) through device scratch, a pair's strips
//   on many warps of many SMs at once (see "the diag routes" and "the
//   chain and spread routes" below).

// dtw_lb_keogh: each block first builds the group's envelopes (rolling
// min and max of each query over +-r) in shared memory, (lo, hi) side by
// side a point.  A lane then owns 4 whole series (consecutive lanes,
// consecutive series) and walks their points 4 at a time, the next 4 of
// each series read into registers (one 16-byte load a series, or four
// 4-byte ones where L % 4 != 0) while these are summed: for each query,
// two 16-byte loads of the envelope that every lane of the warp reads at
// once (a broadcast) serve 4 points x 4 series, and each (query, series)
// sum stays in one register: no sum crosses a lane, and the stores of a
// query's 32 x 4 bounds are coalesced.  G query slots (8, 16, 24 or 32, a
// template) hold a launch's queries; one kernel serves every L: past 1,024
// points the wrapper sums a series in column chunks of 800, a launch each,
// every chunk's envelopes in shared memory and each lane's sums going on
// from those the last chunk stored (the same adds in the same order).
//
// dtw_search, wave routes: a cluster of 8 CTAs a query computes 8
// rounds at once, CTA u round u's candidates whose bound lies below the
// best-so-far of the iteration's start, 32 / H pairs a warp (a warp with
// no candidate taken skips the DP; the taken ones are a prefix of the
// round, the bounds ascending), each pair's series copied into shared
// memory with cp.async and its next candidate brought into L2 meanwhile.
// Then every CTA applies the 8 rounds in order, exactly as one round after
// another: the rounds run the DP of more candidates (those a lower
// best-so-far prunes) but answer the same.  A round's first minimum is
// one 64-bit min over (d bits << 32 | position) (the float's bits,
// non-negative, order as the floats); it updates the best-so-far, and the
// next round's first bound decides the stop.  Past the wave routes' radii
// (r > 127, and r > 255 past L 1,024) and round_k 1,024 the spread route
// takes the search: strips of rows, up to kSpec rounds at once over a
// query's CTAs (see "the chain and spread routes").  Past L 1,024 the
// wave routes' pairs keep a ring of columns in place of the whole row
// (dtw_wave's RING; ring16 too, r <= 255), and a query past kStageL points
// is read from device memory, so no route's shared memory grows with L
// but the strips' rows (the diag route, which keeps them in device
// scratch, takes over past them).
//
// dtw_scan, band route: one thread a (query, series) pair, q in shared
// memory (to kStageL points); the pair's (d^2 bits << 32 | series) goes
// through a warp min to one 64-bit atomicMin a warp, which gives the
// least distance and, among equal ones, the first series.  The grid's y
// dimension takes 65,535 queries a launch (any Q, in launches).  Past r
// 255 the chain route (a warp a pair, strips of rows) takes the scan.
//
// dtw_scan, wave route (scan_wave_kernel): throughput, not latency: Q x N
// pairs of one length, every pair's whole band computed (the brute force
// is the search's oracle, so it abandons nothing), so the goal is f32
// issue slots spent on cells.  A warp takes tiles of P = 32 / H series
// in turn, stages a tile in shared memory (16-byte cp.async), and runs it
// against every query of the CTA's chunk (at most 32, their rows in
// shared memory), so the collection leaves device memory once a chunk;
// where the tiles are too few to fill the card, the chunks are smaller
// and the CTAs take (chunk, tiles) units in turn;
// the next tile is brought into L2 meanwhile (a tile's DP, chunk x L
// steps of ~5C + 6 instructions, dwarfs its copy of P L floats, so one
// buffer does).  A step of a lane is C cells of
// five f32 instructions each against two shuffles, one shared load of the
// query and one of the series: the lane's columns move by one a step, so
// it keeps them in a window of C registers, loads one new column a step,
// and, its steps unrolled by C, rotates the window without moves.  No
// cell is tested against the matrix's edges: the series' rows are staged
// with a value on both sides (and the query's rows with one of the other
// sign) whose squared difference from any value overflows, so a cell past
// an edge costs infinity (no less than BIG, and never the min of a cell
// inside); a pair starts at the step of its cell (0, 0) with that cell's
// diag 0, all earlier cells lying outside.  Cells past the band (the
// pair's top lane, from its cell ML = 2r + 1 - C (H - 1) on, a template)
// read BIG as the left of cell ML and the up of the last cell, so they
// stay BIG or more.  Each (warp, query) keeps its least key in a register
// across its tiles: one 64-bit atomicMin a warp a query.  Past L 1,024
// (scan_ring_kernel) a pair's series goes through a ring of columns and the
// queries come from device memory, the same cells in the same order, at C
// cells a lane chosen by radius (kernels/dtw.py scan_ring_cells: of the
// even widths 16 to 24, the one that puts the largest share of the warp's
// lane cells on band cells, the narrowest on ties): at 16 alone, r 135
// took H = 17 lanes a pair and left 15 of 32 idle, where 18 cells give H
// = 16 and P = 2.  A cell's instructions are the same at every width, so
// its bits are too; each width is C / 2 template instances (ML).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

namespace {

constexpr float kBig = 1e30f;
constexpr size_t kWaveSmem = 200 * 1024;   // a wavefront CTA's, at most
constexpr int kSpec = 8;     // rounds a wavefront iteration computes at once
constexpr int kLbThreads = 256;
// series a lane of dtw_lb_keogh: 4 holds 32 x 4 sums in ~200 registers
// (one block of 8 warps an SM); 2 gives 16 warps but two envelope loads
// where 4 takes one, and was no faster on an H100
constexpr int kLbSeries = 4;
// dtw_scan's wave route: the staged rows' ends hold -kPoison, the query
// rows' +kPoison, so a cell past an edge has (q - x)^2 = infinity
constexpr float kPoison = 1e20f;
constexpr int kScanWaveThreads = 512;      // the scan wave route's CTA
constexpr int kRingChunk = 32;   // columns a ring fill copies (RING)
// the longest series the wave routes stage whole; past it, the ring routes
// (kernels/dtw.py WHOLE_L)
constexpr int kWholeL = 1024;
constexpr int kMaxRoundK = 1024;  // the wave routes' round (MAX_ROUND_K)
// the longest query a kernel stages in shared memory (64
// KB); a longer one is read from device memory, a value a row
constexpr int kStageL = 16384;

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" :: "l"(p));
}

// Copy L floats from src to dst (shared) with 4-byte cp.async, the lanes
// of a pair taking every H-th value; cp_wait() waits for them.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               :: "r"(static_cast<unsigned>(__cvta_generic_to_shared(dst))),
                  "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(static_cast<unsigned>(__cvta_generic_to_shared(dst))),
                  "l"(src) : "memory");
}

__device__ __forceinline__ void cp_row(float* dst, const float* src, int L,
                                       int ll, int H) {
  for (int c = ll; c < L; c += H) cp_async4(dst + c, src + c);
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

__device__ __forceinline__ float cell_d(float qi, float xc) {
  const float t = __fsub_rn(qi, xc);
  return __fmul_rn(t, t);
}

// ------------------------------------------------------------ the DP
// Squared banded DTW of the query in shared memory qs (L) against the
// series x (L, global): the band in registers, radius R.
template <int R>
__device__ float dtw_band_regs(const float* __restrict__ qs,
                               const float* __restrict__ x, int L) {
  constexpr int W = 2 * R + 1;
  float band[W];
  float xw[W];                     // xw[k] = x[i - R + k] of the row i
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const int c = k - R;
    xw[k] = (c >= 0 && c < L) ? __ldg(x + c) : 0.f;
  }
  {                                // row 0: the running sum from column 0
    const float qi = qs[0];
    float left = kBig;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const int c = k - R;
      float v = kBig;
      if (c >= 0 && c < L) {
        const float d = cell_d(qi, xw[k]);
        v = (c == 0) ? d : __fadd_rn(d, left);
      }
      band[k] = v;
      left = v;
    }
  }
  float nxt = (1 + R < L) ? __ldg(x + 1 + R) : 0.f;
  for (int i = 1; i < L; ++i) {
#pragma unroll
    for (int k = 0; k < W - 1; ++k) xw[k] = xw[k + 1];
    xw[W - 1] = nxt;
    nxt = (i + 1 + R < L) ? __ldg(x + i + 1 + R) : 0.f;
    const float qi = qs[i];
    float left = kBig;
    if (i >= R && i + R < L) {     // every column of the row is in [0, L)
#pragma unroll
      for (int k = 0; k < W; ++k) {
        const float up = (k + 1 < W) ? band[k + 1] : kBig;
        const float m = fminf(fminf(band[k], up), left);
        left = __fadd_rn(cell_d(qi, xw[k]), m);
        band[k] = left;
      }
    } else {
#pragma unroll
      for (int k = 0; k < W; ++k) {
        const int c = i - R + k;
        const float up = (k + 1 < W) ? band[k + 1] : kBig;
        float v = kBig;
        if (c >= 0 && c < L) {
          const float m = fminf(fminf(band[k], up), left);
          v = __fadd_rn(cell_d(qi, xw[k]), m);
        }
        band[k] = v;
        left = v;
      }
    }
  }
  return band[R];
}

// One wavefront step's cells of a lane (C band offsets): v holds the
// lane's cells of the previous step and receives this step's, d[m] is cell
// m's squared difference.  Cell 0 takes the lane below's last cell of the
// previous step as its left (a shuffle; lane 0 reads lane 31), cell m > 0
// the cell before it; the last cell takes the lane above's cell 0 of this
// step as its up (a shuffle), cell m < C - 1 the lane's own cell m + 1 of
// the previous step; diag is the lane's own cell m.  On a lane with `top`,
// cell CUT's left and the last cell's up read BIG instead (CUT = C: none).
template <int C, int CUT>
__device__ __forceinline__ void wave_cells(float (&v)[C], const float (&d)[C],
                                           int from, bool top) {
  float nv[C];
  const float left = __shfl_sync(0xffffffffu, v[C - 1], from);
  nv[0] = __fadd_rn(d[0], fminf(fminf(v[0], v[1]), left));
  float up = __shfl_down_sync(0xffffffffu, nv[0], 1);
  if (CUT < C && top) up = kBig;
#pragma unroll
  for (int m = 1; m < C; ++m) {
    const float u = m + 1 < C ? v[m + 1] : up;
    const float l = (m == CUT && top) ? kBig : nv[m - 1];
    nv[m] = __fadd_rn(d[m], fminf(fminf(v[m], u), l));
  }
#pragma unroll
  for (int m = 0; m < C; ++m) v[m] = nv[m];
}

// The wave routes of dtw_search: one pair's banded DTW as a wavefront over
// H = ceil((2r + 1) / C) lanes, lane ll of the pair holding band offsets
// k = C ll + m, m < C; at step s it forms row i = s - ll, cells m = 0 .. C
// - 1 in order.  Cell (i, k) reads (i, k - 1) (left), (i - 1, k + 1) (up)
// and (i - 1, k) (diag), so:
//   diag, and up for m < C - 1: the lane's own cells of step s - 1;
//   left, m > 0: its cell m - 1 of this step; m = 0: lane ll - 1's last
//     cell of step s - 1 (a shuffle from the lane below, which wraps lane 0
//     to lane 31);
//   up, m = C - 1: lane ll + 1's first cell of this step (a shuffle from
//     the lane above, once every lane has formed its cell 0).
// 2r + 1 is odd and C even, so the last cell of a pair's top lane lies
// outside the band: lane 0 of the next pair reads BIG or more from it, as
// every cell outside the band or the matrix is (its d is BIG).  Cell (0, 0)
// (lane r / C, cell r % C) reads a diag of 0.  Each cell is the same
// __fsub_rn, __fmul_rn, exact mins and __fadd_rn on the same operands as
// dtw_band_ref's (ref.dtw_wavefront_ref models this order), so no bit
// changes.  Returns cell (L - 1, r), formed at the last step, L - 1 + r / C,
// in lane r / C of the pair; calls after_ramp() once the steps with a row
// or column edge at the start are issued.
//
// Early abandoning: a path's cells are formed at steps that never fall and
// rise by at most one a move, from step r / C (cell (0, 0)) to the last,
// so every path has a cell of every step between, and its cost is at least
// that cell's.  Every 8 steps of the middle loop the pair's lanes take the
// least cell of the step (pair_mask: the pair's lanes); once it is cutoff
// or more for every pair of the warp, the DTW of each is cutoff or more
// and the warp stops, returning BIG.  The caller's cutoff is the
// best-so-far of the iteration, which no round applies a distance at or
// above, so no answer or count changes.
//
// RING: the pair's series is not staged whole but through a ring of W
// floats (a power of two; column c at xr[c & (W - 1)]), which the pair's
// lanes fill from xg (the series in device memory) kRingChunk columns at a
// time with 4-byte cp.async, one chunk in flight while the steps run: a
// step's lanes read at most span = (C - 1)(H - 1) + C columns from s - r
// on, so W >= span + 2 kRingChunk + 8 holds every column a block of 8
// steps reads beside the chunk in flight (ring_size), and shared memory
// stops growing with L.
template <int C, bool RING = false, typename F>
__device__ __forceinline__ float dtw_wave(const float* __restrict__ qs,
                                          float* __restrict__ xr,
                                          int L, int r, int H, int ll,
                                          int lane, bool live, float cutoff,
                                          unsigned pair_mask,
                                          F&& after_ramp,
                                          const float* __restrict__ xg =
                                              nullptr,
                                          int W = 0) {
  const int l0 = r / C, m0 = r % C;          // where offset r lives
  const int from = (lane + 31) & 31;
  const int wmask = RING ? W - 1 : -1;
  // RING: columns [0, ready) have landed, [ready, hi) are in flight
  int ready = 0, hi = 0;
  const int reach = (C - 1) * (H - 1) + C - 1 - r;   // a step's last column
  // every column that steps up to s_last read is landed (warp-uniform)
  auto ensure = [&](int s_last) {
    if constexpr (RING) {
      const int col = min(s_last + reach, L - 1);
      while (ready <= col) {
        cp_wait();
        __syncwarp();             // landed for every lane; older slots read
        ready = hi;
        if (hi < L) {
          if (live)
            for (int c = hi + ll; c < min(hi + kRingChunk, L); c += H)
              cp_async4(xr + (c & wmask), xg + c);
          asm volatile("cp.async.commit_group;" ::: "memory");
          hi += kRingChunk;
        }
      }
    }
  };
  bool ok[C];                                // offset inside the band
#pragma unroll
  for (int m = 0; m < C; ++m) ok[m] = live && C * ll + m <= 2 * r;
  float v[C];
#pragma unroll
  for (int m = 0; m < C; ++m) v[m] = kBig;
  float res = kBig;
  // steps s: 0 .. L - 1 + l0.  Below a, some lane is on row 0 or before
  // it, or reads a column below 0; from b on, some cell of a live lane may
  // lie beyond row or column L - 1, and the result forms.
  const int end = L + l0;
  const int a = min(max(H, r), end);
  const int b = max(a, min(min(L - r + 2 * r / C, L), end - 1));
  auto edge = [&](int s) {
    const int i = s - ll, c0 = s + (C - 1) * ll - r;
    const bool row = (unsigned)i < (unsigned)L;
    const float qi = row ? qs[i] : 0.f;
    const bool first = i == 0 && ll == l0;
    float d[C], nv[C];
#pragma unroll
    for (int m = 0; m < C; ++m) {
      const int c = c0 + m;
      const bool in = row && ok[m] && (unsigned)c < (unsigned)L;
      d[m] = in ? cell_d(qi, xr[c & wmask]) : kBig;
    }
    const float left = __shfl_sync(0xffffffffu, v[C - 1], from);
    nv[0] = __fadd_rn(d[0], fminf(fminf((first && m0 == 0) ? 0.f : v[0],
                                        v[1]), left));
    const float up = __shfl_down_sync(0xffffffffu, nv[0], 1);
#pragma unroll
    for (int m = 1; m < C; ++m) {
      const float diag = (first && m == m0) ? 0.f : v[m];
      const float u = m + 1 < C ? v[m + 1] : up;
      nv[m] = __fadd_rn(d[m], fminf(fminf(diag, u), nv[m - 1]));
    }
    if (i == L - 1 && ll == l0) {
#pragma unroll
      for (int m = 0; m < C; ++m)
        if (m == m0) res = nv[m];
    }
#pragma unroll
    for (int m = 0; m < C; ++m) v[m] = nv[m];
  };
  // rows 1 .. L - 1 of every lane, every cell inside the band within
  // columns 0 .. L - 1: no test a cell but the lane's band mask
  auto step = [&](int s) {
    const int i = s - ll, c0 = s + (C - 1) * ll - r;
    const float qi = qs[i];
    float d[C];
#pragma unroll
    for (int m = 0; m < C; ++m)
      d[m] = ok[m] ? cell_d(qi, xr[(c0 + m) & wmask]) : kBig;
    wave_cells<C, C>(v, d, from, false);
  };
  int s = 0;
  for (; s < a; ++s) {
    ensure(s);
    edge(s);
  }
  after_ramp();
  bool done = !live;
  while (s + 8 <= b) {
    ensure(s + 7);
#pragma unroll
    for (int u = 0; u < 8; ++u) step(s + u);
    s += 8;
    float least = v[0];                      // cells are >= 0: their bits
#pragma unroll                               // order as the floats
    for (int m = 1; m < C; ++m) least = fminf(least, v[m]);
    const unsigned bits = __reduce_min_sync(pair_mask,
                                            __float_as_uint(least));
    done = done || __uint_as_float(bits) >= cutoff;
    if (__all_sync(0xffffffffu, done)) return kBig;
  }
  for (; s < b; ++s) {
    ensure(s);
    step(s);
  }
  for (; s < end; ++s) {
    ensure(s);
    edge(s);
  }
  return res;
}

// The ring of a RING pair (see dtw_wave): the least power of two of at
// least span + 2 kRingChunk + 8 floats.
__host__ __device__ __forceinline__ int ring_size(int C, int H) {
  const int need = (C - 1) * (H - 1) + C + 2 * kRingChunk + 8;
  int w = 1;
  while (w < need) w <<= 1;
  return w;
}

// The least v over the first `width` lanes (a power of two, at most 32:
// a block of fewer than 32 threads has only those).
__device__ __forceinline__ unsigned long long warp_min_u64(
    unsigned long long v, int width = 32) {
  const unsigned mask = width >= 32 ? 0xffffffffu : (1u << width) - 1;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    if (o < width) {
      const unsigned long long w = __shfl_xor_sync(mask, v, o);
      v = w < v ? w : v;
    }
  }
  return v;
}

__device__ __forceinline__ unsigned long long pack(float d, unsigned idx) {
  return (static_cast<unsigned long long>(__float_as_uint(d)) << 32) | idx;
}

// Queries a chunk of a scan whose CTAs take (chunk, tile group) units (G
// tile groups, Q queries, at most qc a chunk, `held` CTAs at once): qc,
// or where the tile groups are fewer than the CTAs, the largest qn whose
// units the card runs in rounds of qn queries within 1/32 of the fewest (a
// chunk's rows are loaded again at each unit of another chunk).
inline int chunk_queries(long long G, int Q, int qc, long long held) {
  auto cost = [&](int k) {               // queries of the busiest CTA
    return (G * ((Q + k - 1) / k) + held - 1) / held * k;
  };
  int qn = qc;
  if (G < held) {
    long long least = cost(qc);
    for (int k = 1; k < qc; ++k) least = cost(k) < least ? cost(k) : least;
    while (32 * cost(qn) > 33 * least) --qn;
  }
  return qn;
}

// What the card holds at once of kernel `fn` at `threads` a CTA and `smem`
// bytes of dynamic shared memory (SMs x CTAs an SM), asked once a (device,
// kernel, smem), the kernel's dynamic shared memory raised to kWaveSmem
// at its first: a launch's host work is most of a small call's time.
inline int held_ctas(const void* fn, int threads, size_t smem, int& held) {
  static std::mutex mu;
  static std::map<std::tuple<int, const void*, size_t>, int> memo;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(dev, fn, smem);
  const auto it = memo.find(key);
  if (it != memo.end()) {
    held = it->second;
    return 0;
  }
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kWaveSmem);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads,
                                                      smem);
  if (e != cudaSuccess) return (int)e;
  held = memo[key] = sms * per_sm;
  return 0;
}

// ------------------------------------------------------------- kernels
// Squared LB_Keogh: out[g * N + n] for the Qg <= G queries of q (Qg, L)
// (see the top).  Lane j of a warp's task t owns series 128 t + j + 32 s,
// s < kLbSeries; V = 4 reads 4 points of a series with one 16-byte load
// (L % 4 == 0 and x 16-byte aligned), V = 1 with four 4-byte ones.  The
// envelope rows are padded to Lp = a multiple of 4 points; a padded point
// (x read as 0, lo = hi = 0) and a padded query slot (lo = hi = 0, never
// stored) add e = 0, which leaves a sum's bits as they are.
template <int G, int V>
__global__ void __launch_bounds__(kLbThreads, 1)
lb_keogh_kernel(const float* __restrict__ q, const float* __restrict__ x,
                long long N, int L, int Qg, int R, int j0, int Lc, bool acc_in,
                float* __restrict__ out) {
  constexpr int S = kLbSeries;
  extern __shared__ float4 env4[];       // (G, Lp / 2): (lo, hi, lo, hi)
  float2* env = reinterpret_cast<float2*>(env4);
  const int Lp = (Lc + 3) & ~3, row4 = Lp / 2;
  for (int e = threadIdx.x; e < G * Lp; e += blockDim.x) {
    const int g = e / Lp, j = e - g * Lp;
    float mn = 0.f, mx = 0.f;
    if (g < Qg && j < Lc) {
      const int jj = j0 + j;             // the column in the series
      const int a = jj - R < 0 ? 0 : jj - R;
      const int b = jj + R > L - 1 ? L - 1 : jj + R;
      mn = __int_as_float(0x7f800000);
      mx = -mn;
      for (int t = a; t <= b; ++t) {
        const float v = q[g * L + t];
        mn = fminf(mn, v);
        mx = fmaxf(mx, v);
      }
    }
    env[e] = make_float2(mn, mx);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long tasks = (N + 32 * S - 1) / (32 * S);
  const long long warps = (long long)gridDim.x * (blockDim.x >> 5);
  for (long long t = (long long)blockIdx.x * (blockDim.x >> 5)
                     + (threadIdx.x >> 5);
       t < tasks; t += warps) {
    const long long n0 = t * 32 * S + lane;
    const float* xs[S];
#pragma unroll
    for (int s = 0; s < S; ++s)
      xs[s] = x + min(n0 + 32 * s, N - 1) * L + j0;
    auto load = [&](float (&v)[S][4], int j) {
#pragma unroll
      for (int s = 0; s < S; ++s) {
        if constexpr (V == 4) {
          const float4 f = __ldg(reinterpret_cast<const float4*>(xs[s] + j));
          v[s][0] = f.x;
          v[s][1] = f.y;
          v[s][2] = f.z;
          v[s][3] = f.w;
        } else {
#pragma unroll
          for (int p = 0; p < 4; ++p)
            v[s][p] = j + p < Lc ? __ldg(xs[s] + j + p) : 0.f;
        }
      }
    };
    float acc[G][S];                     // a later chunk goes on from
#pragma unroll                           // the sums the last one stored
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int s = 0; s < S; ++s)
        acc[g][s] = acc_in && g < Qg && n0 + 32 * s < N
                        ? out[(long long)g * N + n0 + 32 * s] : 0.f;
    float xc[S][4], xn[S][4];
    load(xc, 0);
    for (int j = 0; j < Lp; j += 4) {
      if (j + 4 < Lp) load(xn, j + 4);
      // 2 points a pass over the queries, one 16-byte envelope load (the
      // two points' lo and hi) a query for 2 points x S series: a loop body
      // of ~1,000 instructions (4 points a pass, 2,048 of them, was slower
      // on an H100)
#pragma unroll 1
      for (int h = 0; h < 4; h += 2) {
        float xv[S][2];
#pragma unroll
        for (int s = 0; s < S; ++s) {
          xv[s][0] = h ? xc[s][2] : xc[s][0];
          xv[s][1] = h ? xc[s][3] : xc[s][1];
        }
        const float4* e4 = env4 + (j + h) / 2;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float4 a = e4[g * row4];
          const float lo[2] = {a.x, a.z}, hi[2] = {a.y, a.w};
#pragma unroll
          for (int p = 0; p < 2; ++p)
#pragma unroll
            for (int s = 0; s < S; ++s) {
              const float v = xv[s][p];
              const float e = v - fminf(fmaxf(v, lo[p]), hi[p]);
              acc[g][s] = fmaf(e, e, acc[g][s]);
            }
        }
      }
#pragma unroll
      for (int s = 0; s < S; ++s)
#pragma unroll
        for (int p = 0; p < 4; ++p) xc[s][p] = xn[s][p];
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (g < Qg) {
#pragma unroll
        for (int s = 0; s < S; ++s)
          if (n0 + 32 * s < N) out[(long long)g * N + n0 + 32 * s] = acc[g][s];
      }
    }
  }
}

// dtw_search's wave routes (see the top): the refinement of query
// blockIdx.x / kSpec of the group by a cluster of kSpec CTAs.  An iteration
// computes kSpec rounds at once: CTA u the candidates of round u whose bound
// lies below the best-so-far of the iteration's start (those of the round
// itself and perhaps more: the best-so-far only falls), its warps P = 32 /
// H pairs each (dtw_wave, C cells a lane).  After one cluster barrier, warp
// 0 of every CTA applies the kSpec rounds in order as the loop of single
// rounds does: the stop before each, the candidates below the best-so-far of the moment,
// their first minimum; so the best-so-far, the id, the rounds and the
// candidates refined are that loop's in every CTA.  Distances and bounds are
// double-buffered by iteration parity, so no CTA overwrites what another
// still reads.  Each pair's next candidate (its bound and id read during
// this iteration) is brought into L2 once the DP has begun.
//
// RING (L > 1024): each pair's series goes through a ring of ring_size(C,
// H) floats that dtw_wave fills as the front advances, in place of the
// whole row, and the query is read from device memory where L >
// kStageL, so the CTA's shared memory no longer grows with L.
template <int C, bool RING>
__global__ void __launch_bounds__(C < 16 ? 1024 : 512)
wave_kernel(const float* __restrict__ q, const float* __restrict__ x,
            long long N, int L, int r, int round_k,
            const float* __restrict__ slb,
            const long long* __restrict__ order, float* bsf_out,
            int* best_out, int* rounds_out, int* refined_out) {
  const int H = (2 * r + C) / C, P = 32 / H;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  extern __shared__ float sm[];
  const bool stage = !RING || L <= kStageL;
  const int row = RING ? ring_size(C, H) : L;    // floats a pair's row takes
  float* qsm = sm;                       // L (staged)
  float* rd = qsm + (stage ? L : 0);     // [2][round_k]: distances (BIG:
  float* rl = rd + 2 * round_k;          // not computed) and bounds
  float* xs = rl + 2 * round_k;          // (warps * P, row): the pairs' rows
  __shared__ float s_nlb[2];             // CTA 0: the next iteration's first
  __shared__ float s_bsf;                // bound
  __shared__ int s_go;
  const int g = blockIdx.x / kSpec, tid = threadIdx.x, lane = tid & 31;
  const int warp = tid >> 5, warps = blockDim.x >> 5;
  // the lane's pair in the warp (P: none) and its lane in the pair
  const int slot = lane / H, ll = lane - slot * H;
  // the lanes of the lane's pair (slot P: the lanes past the last pair)
  const unsigned pair_mask =
      ((slot + 1) * H >= 32 ? 0xffffffffu : (1u << (slot + 1) * H) - 1)
      & ~((1u << slot * H) - 1);
  float* xrow = xs + (long long)(warp * P + min(slot, P - 1)) * row;
  const float* qs = stage ? qsm : q + (long long)g * L;
  if (stage)
    for (int j = tid; j < L; j += blockDim.x) qsm[j] = q[(long long)g * L + j];
  const float* lb = slb + (long long)g * N;
  const long long* ord = order + (long long)g * N;
  const long long end = (N + round_k - 1) / round_k * round_k;
  const long long step = (long long)kSpec * round_k;
  const bool one_batch = warps * P >= round_k;
  float bsf = kBig;
  long long best = -1;
  int rounds = 0, refined = 0, par = 0;
  bool go = end > 0 && lb[0] < kBig;
  float cb = kBig;                       // one batch: this pair's candidate
  long long co = 0;                      // (bound, id), read an iteration
  bool carried = false;                  // ahead
  long long cursor = 0;
  __syncthreads();
  while (go) {
    float* my_d = rd + par * round_k;
    float* my_l = rl + par * round_k;
    for (int base = 0; base < round_k; base += warps * P) {
      const int j = base + warp * P + slot;    // the pair's candidate
      const bool mine = slot < P && j < round_k;
      const long long pos = cursor + (long long)rank * round_k + j;
      const bool real = mine && pos < N;
      float b = kBig;
      long long o = 0;
      if (carried) {
        b = cb;
        o = co;
      } else if (real) {
        b = lb[pos];
        o = ord[pos];
      }
      const bool take = b < bsf;
      const long long nxt = pos + step;        // its next iteration's
      const bool more = mine && nxt < N;
      const float nb = more ? lb[nxt] : kBig;
      const long long no = more ? ord[nxt] : 0;
      auto ahead = [&] {
        if (nb < bsf) {
          const float* nrow = x + no * L;
          for (int c = 32 * ll; c < L; c += 32 * H) prefetch_l2(nrow + c);
          if (ll == 0) prefetch_l2(nrow + L - 1);
        }
      };
      float d = kBig;
      if (__any_sync(0xffffffffu, take)) {
        if constexpr (RING) {
          d = dtw_wave<C, true>(qs, xrow, L, r, H, ll, lane, take, bsf,
                                pair_mask, ahead, x + o * L, row);
        } else {
          if (take) cp_row(xrow, x + o * L, L, ll, H);
          cp_wait();
          __syncwarp();
          d = dtw_wave<C>(qs, xrow, L, r, H, ll, lane, take, bsf, pair_mask,
                          ahead);
        }
        __syncwarp();           // the rows are read: the next batch may copy
      } else {
        ahead();
      }
      if (mine && ll == r / C) {               // the pair's result lane
        my_d[j] = take ? d : kBig;
        my_l[j] = b;
        if (rank == 0 && j == 0) s_nlb[par] = nb;
      }
      carried = one_batch;
      cb = nb;
      co = no;
    }
    cluster.sync();             // every CTA's round of the iteration is in
    if (warp == 0) {
      // the first candidate of each round, read ahead of the rounds
      float dv[kSpec], lv[kSpec];
#pragma unroll
      for (int u = 0; u < kSpec; ++u) {
        const bool in = lane < round_k;
        dv[u] = in ? cluster.map_shared_rank(rd, u)[par * round_k + lane]
                   : kBig;
        lv[u] = in ? cluster.map_shared_rank(rl, u)[par * round_k + lane]
                   : kBig;
      }
      const float nlb = cluster.map_shared_rank(s_nlb, 0)[par];
      bool on = true;
#pragma unroll
      for (int u = 0; u < kSpec; ++u) {
        const long long cu = cursor + (long long)u * round_k;
        const float first = __shfl_sync(0xffffffffu, lv[u], 0);
        if (u > 0) on = on && cu < end && first < bsf;   // the stop before
        if (on) {
          unsigned long long key = ~0ull;
          int nt = 0;
          for (int j0 = 0; j0 < round_k; j0 += 32) {
            const int j = j0 + lane;
            float dj = dv[u], lj = lv[u];
            if (j0 > 0 && j < round_k) {
              dj = cluster.map_shared_rank(rd, u)[par * round_k + j];
              lj = cluster.map_shared_rank(rl, u)[par * round_k + j];
            }
            const bool t = j < round_k && lj < bsf;
            const unsigned long long kj =
                j < round_k ? pack(t ? dj : kBig, (unsigned)j) : ~0ull;
            key = kj < key ? kj : key;
            nt += __popc(__ballot_sync(0xffffffffu, t));
          }
          key = warp_min_u64(key);
          const float dmin = __uint_as_float((unsigned)(key >> 32));
          if (dmin < bsf) {
            bsf = dmin;
            if (rank == 0 && lane == 0)
              best = ord[cu + (unsigned)(key & 0xffffffffu)];
          }
          ++rounds;
          refined += nt;
        }
      }
      // the stop before the next iteration's first round
      const long long nc = cursor + step;
      on = on && nc < end && nlb < bsf;
      if (lane == 0) {
        s_bsf = bsf;
        s_go = on;
      }
    }
    __syncthreads();
    bsf = s_bsf;
    go = s_go;
    cursor += step;
    par ^= 1;
  }
  cluster.sync();               // no CTA leaves while another reads it
  if (rank == 0 && tid == 0) {
    bsf_out[g] = bsf;
    best_out[g] = (int)best;
    rounds_out[g] = rounds;
    refined_out[g] = refined;
  }
}

// dtw_scan's band route (radius R): query blockIdx.y against series
// blockIdx.x * blockDim.x + threadIdx.x.  LONGQ: a query past kStageL
// points, read from device memory (its own instance: a query pointer to
// either memory cost the staged one 13-15 %, H100).
template <int R, bool LONGQ = false>
__global__ void scan_kernel(const float* __restrict__ q,
                            const float* __restrict__ x, long long N, int L,
                            unsigned long long* keys) {
  extern __shared__ float sm[];
  const int g = blockIdx.y, tid = threadIdx.x;
  const float* qs = sm;
  if constexpr (LONGQ) {
    qs = q + (long long)g * L;
  } else {
    for (int j = tid; j < L; j += blockDim.x) sm[j] = q[(long long)g * L + j];
    __syncthreads();
  }
  const long long n = (long long)blockIdx.x * blockDim.x + tid;
  unsigned long long key = ~0ull;
  if (n < N) key = pack(dtw_band_regs<R>(qs, x + n * L, L), (unsigned)n);
  key = warp_min_u64(key);
  if ((tid & 31) == 0 && key != ~0ull) atomicMin(keys + g, key);
}

#ifndef DTW_SCAN_WIDE_RINGS
// ------------------------------------------------------ the diag routes
// Strips of rows (see the top): a pair's matrix in strips of S = 32 K rows, K
// rows a lane (kernels/dtw.py diag_rows), each strip a warp's.  Strip s (rows
// s S ..) spans the columns lo = max(0, s S - r) .. hi = min(L - 1, s S + S -
// 1 + r).  The warp sweeps them as a skewed wavefront, steps j = lo .. hi +
// 31 in whole chunks of 32 (steps past hi read columns past the band: BIG):
// lane l is at column j - l and forms its rows i0 = s S + K l .. i0 + K - 1
// there, top to bottom, each cell from the cell above (the row before, this
// step; the lane's first row takes lane l - 1's last row of the step before,
// one shuffle), its left (the lane's own cell of the step before) and its
// diagonal (the up of the step before).  The query's K values sit in
// registers and the series' value is one 4-byte load a lane a step (L1, two
// steps ahead): no shared memory, no block barrier.  Lane 0's first row reads
// the strip above's last row, which that strip's lane 31 stored as it went:
// one 64-bit entry a column (the float's bits, the strip's tag above them) in
// its pair's row of device scratch (column c at c - lo, the strip's first
// column).  The warp reads them 32 columns at a time, a column a lane, the
// next 32 loaded while these are used, and spins until each entry it needs
// carries the tag of the strip above: one store is seen whole, so the tag is
// the flag and no fence is needed.  Each strip writes the row over the
// entries of the strip above as it goes: it stores column c at entry c - lo
// after it has read the strip above's entry there, that strip's column c -
// (its lo - the lo above) <= c, so no entry is overwritten unread (the tests
// run the hand-over in random orders of chunks), and stores no column past
// its hi: where the strip below starts at the same column (lo 0 for the
// first strips), the entries past hi are that strip's own columns, which
// it needs none of ours to store, and a late store of ours there would
// leave it a stale tag (the strip below it then waited for ever: a chunk
// whose stores pass hi takes the tested path).
//
// Strips are taken in dependency order by an atomic ticket: pairs in
// batches of `slots` (a scratch slot each), chains of strips (one warp
// running them in order; one strip a chain but in dtw_scan at a narrow
// band) chain-major within a batch, so a strip waits only on a strip
// taken earlier, by a warp that is already running, and a slot's next
// pair only on its last one (`done`, a count a slot): every wait is one
// warp's spin, so no schedule deadlocks, even where not every CTA is
// resident at once.
//
// The cells are dtw_band_ref's __fsub_rn, __fmul_rn, exact mins and
// __fadd_rn on the same operands.  A chunk of 32 steps whose cells all
// lie inside the band and the matrix (`inner`: most of a wide band) runs
// without tests; elsewhere a cell outside the band is set to BIG, and a
// row or column outside the matrix reads a poisoned value (the query's
// +kPoison, the series' -kPoison: their squared difference is infinity).
// Each cell inside so reads its neighbours inside and BIG or more
// elsewhere, cell (0, 0) a diagonal of 0, and any order of the steps gives
// the plain version's bits.  ref.dtw_strip_ref models this program: its
// steps, chunks, entries, offsets and tags.
constexpr int kDiagScanThreads = 256;     // scan_strips' CTA (8 warps)
// search_strips' CTA: 16 warps, one CTA an SM (at 1024 threads the 64
// registers a thread spilled)
constexpr int kDiagSearchThreads = 512;
constexpr unsigned kAll = 0xffffffffu;

template <bool B>
struct Flag {
  static constexpr bool value = B;
};

// Strong (relaxed, device scope) 64-bit loads and stores: served by L2,
// never a stale L1 line, and a concurrent store is seen whole or not.
__device__ __forceinline__ unsigned long long ld_strong(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ void st_strong(unsigned long long* p,
                                          unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" :: "l"(p), "l"(v));
}

// A spin that has waited kStuckClocks since `t0` (clock64: the SM's own
// clock, about 20 s at the H100's 1.98 GHz) traps: every wait is on a warp
// already running, so only a fault can wait that long, and a failed launch
// raises where a hung one would hold the card.  clock64 only counts up on
// the warp's SM; the global timer need not, and a step back would read as
// an endless wait.
constexpr long long kStuckClocks = 40ll * 1000 * 1000 * 1000;

__device__ __forceinline__ void stuck(long long t0) {
  if (clock64() - t0 > kStuckClocks) __trap();
}

// Shared-memory forms of ld_strong / st_strong (relaxed, CTA scope): a
// 64-bit entry another warp of the CTA stores is seen whole or not.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned long long ld_cta(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.cta.shared.u64 %0, [%1];" : "=l"(v)
               : "r"(smem_addr(p)));
  return v;
}

__device__ __forceinline__ void st_cta(unsigned long long* p,
                                       unsigned long long v) {
  asm volatile("st.relaxed.cta.shared.u64 [%0], %1;" :: "r"(smem_addr(p)),
               "l"(v));
}

// Every lane's entry e (read by ld(); `want` false: none needed) carries
// `tag`: spins until they do.  While waiting only the lane of the highest
// column wanted polls (the strip above stores its columns in order), the
// sleeps growing to `most` ns, so that a waiting warp costs one load a
// poll, not 32; once that entry is in, the lanes still short reload.
template <class Ld>
__device__ __forceinline__ void settle_entry(unsigned long long& e, Ld&& ld,
                                             bool want, unsigned tag,
                                             unsigned most) {
  auto in = [&] { return !want || (unsigned)(e >> 32) == tag; };
  if (__all_sync(kAll, in())) return;
  const int lane = threadIdx.x & 31;
  const int top = 31 - __clz(__ballot_sync(kAll, want));
  const long long t0 = clock64();
  unsigned nap = 32;
  for (;;) {
    __nanosleep(nap);
    nap = nap < most ? 2 * nap : most;
    stuck(t0);
    if (lane == top && !in()) e = ld();
    if (!__shfl_sync(kAll, in(), top)) continue;
    if (!in()) e = ld();
    if (__all_sync(kAll, in())) return;
  }
}

// The rows strip_dp hands on (the strip above's last row, read by the strip
// below), one type a route:
// - DevRow (the diag routes): a pair's row in device scratch, 64-bit
//   entries (tag << 32 | the float's bits), strips on any warps of any SMs;
// - CtaRow (dtw_search's spread route): the same entries in the shared
//   memory of the CTA whose warps run the pair's strips;
// - WarpRow (dtw_scan's chain route): plain floats in a warp's own slice of
//   shared memory, which only that warp writes and reads, one strip after
//   another: no tag and no wait, a __syncwarp at each strip's and chunk's
//   start (fence) ordering one lane's stores before the others' loads.
// ld(i) reads entry i, settle(e, i, want, tag) waits until e carries the
// tag, val(e) is its float, st(i, tag, v) stores v at entry i.
struct DevRow {
  using Entry = unsigned long long;
  unsigned long long* p;
  __device__ Entry ld(int i) const { return ld_strong(p + i); }
  __device__ void settle(Entry& e, int i, bool want, unsigned tag) const {
    const unsigned long long* a = p + i;
    settle_entry(e, [a] { return ld_strong(a); }, want, tag, 256);
  }
  __device__ static float val(Entry e) { return __uint_as_float((unsigned)e); }
  __device__ void st(int i, unsigned tag, float v) const {
    st_strong(p + i, (static_cast<unsigned long long>(tag) << 32)
                         | __float_as_uint(v));
  }
  __device__ static void fence() {}
};

struct CtaRow {
  using Entry = unsigned long long;
  unsigned long long* p;
  __device__ Entry ld(int i) const { return ld_cta(p + i); }
  __device__ void settle(Entry& e, int i, bool want, unsigned tag) const {
    const unsigned long long* a = p + i;
    settle_entry(e, [a] { return ld_cta(a); }, want, tag, 64);
  }
  __device__ static float val(Entry e) { return __uint_as_float((unsigned)e); }
  __device__ void st(int i, unsigned tag, float v) const {
    st_cta(p + i, (static_cast<unsigned long long>(tag) << 32)
                      | __float_as_uint(v));
  }
  __device__ static void fence() {}
};

struct WarpRow {
  using Entry = float;
  float* p;
  __device__ Entry ld(int i) const { return p[i]; }
  __device__ void settle(Entry&, int, bool, unsigned) const {}
  __device__ static float val(Entry e) { return e; }
  __device__ void st(int i, unsigned, float v) const { p[i] = v; }
  __device__ static void fence() { __syncwarp(); }
};

// The count at p (the same for every lane) reaches `want`.
__device__ __forceinline__ void await_count(const unsigned long long* p,
                                            unsigned long long want) {
  const long long t0 = clock64();
  unsigned nap = 32;
  while (!__all_sync(kAll, ld_strong(p) >= want)) {
    __nanosleep(nap);
    nap = nap < 1024 ? 2 * nap : 1024;
    stuck(t0);
  }
}

// The columns of the strip whose first row is s0: [strip_lo, strip_hi]
// (written with ternaries: nvcc's max() of such negative ints once read r
// on the card).
__device__ __forceinline__ int strip_lo(int s0, int r) {
  return s0 - r > 0 ? s0 - r : 0;
}

__device__ __forceinline__ int strip_hi(int s0, int S, int r, int L) {
  return s0 + S - 1 + r < L - 1 ? s0 + S - 1 + r : L - 1;
}

// Strip s of the pair (q, x), K rows a lane (see above), its rows handed
// on through rows of a Row type above: `in`, the strip above's last row,
// its entries tagged in_tag (in.p null for s = 0); `out`, where this
// strip's last row goes, tagged out_tag (out.p null for the pair's last
// strip).  Returns cell (L - 1, L - 1) on the lane that holds row L - 1
// (on the pair's last strip), BIG on the others.
//
// SHIFT: a cell outside the band is made BIG or more by a max with its
// mask (0 inside, BIG outside) in place of a test: along a lane the mask
// of row a at a step is that of row a - 1 at the step before (the column
// moves on by one), so the masks shift through K registers, one new a
// step, and a cell of a chunk with tests costs one instruction for the
// band where the test took three.  An inside cell reads at least one
// inside neighbour, finite and below BIG, so a neighbour outside at BIG
// or more (not BIG exactly) changes no bit.
template <int K, bool SHIFT = false, class Row>
__device__ float strip_dp(const float* __restrict__ q,
                          const float* __restrict__ x, int L, int r, int s,
                          Row in, unsigned in_tag, Row out,
                          unsigned out_tag) {
  constexpr int W = 32, S = W * K;    // lanes, rows
  const int lane = threadIdx.x & (W - 1);
  const int s0 = s * S, lo = strip_lo(s0, r), hi = strip_hi(s0, S, r, L);
  const int ilo = strip_lo(s0 - S, r), ihi = strip_hi(s0 - S, S, r, L);
  const int i0 = s0 + K * lane;
  float qv[K], v[K], mk[K];     // mk (SHIFT): each row's band mask
#pragma unroll
  for (int a = 0; a < K; ++a) {
    const float qa = __ldg(q + (i0 + a < L ? i0 + a : L - 1));
    qv[a] = i0 + a < L ? qa : kPoison;
    v[a] = kBig;
  }
  auto mask = [&](int e) {            // offset e in the band: 0, else BIG
    return (unsigned)e > (unsigned)(2 * r) ? kBig : 0.f;
  };
  const bool full = s0 + S <= L;
  const int la = L - 1 - i0;          // row L - 1's place on its lane
  float res = kBig;
  // lane 0's diagonal at its first column lo: the row above at lo - 1
  // (cell (0, 0): 0); every other lane's first cell lies outside the band
  float dprev = kBig;
  Row::fence();                       // the strip above's row is in
  if (in.p == nullptr) {
    if (lane == 0) dprev = 0.f;
  } else if (lo - 1 >= ilo && lo - 1 <= ihi) {
    typename Row::Entry e = in.ld(lo - 1 - ilo);
    in.settle(e, lo - 1 - ilo, true, in_tag);
    if (lane == 0) dprev = Row::val(e);
  }
  auto from_above = [&](int c) {
    return in.p != nullptr && c >= ilo && c <= ihi;
  };
  const int jend = hi + W - 1;        // lane W - 1's last column is hi
  typename Row::Entry nx = 0;         // the entry of column j0 + lane
  if (from_above(lo + lane)) nx = in.ld(lo + lane - ilo);
  const bool store = out.p != nullptr && lane == W - 1;
  // the step of column L - 1 on the lane of row L - 1 (-1: not this strip)
  const int jres = s0 + S >= L ? L - 1 + (L - 1 - s0) / K : -1;
  // step j (u of its chunk, xc the lane's series value): lane 0 takes its
  // up from the chunk's upc.  BAND: a cell outside the band is set to
  // BIG; RARE: columns past the matrix (poisoned), the result and the ends
  // of the stored row too
  auto step = [&](int j, int u, float upc, float xc, auto band, auto rare) {
    constexpr bool BAND = decltype(band)::value;
    constexpr bool RARE = decltype(rare)::value;
    const int c = j - lane;
    const float below = __shfl_up_sync(kAll, v[K - 1], 1);
    const float top = __shfl_sync(kAll, upc, u);
    float up = lane == 0 ? top : below;
    float diag = dprev;
    dprev = up;
    const int e = i0 + r - c;         // row i0's offset in the band, i - c + r
    if constexpr (BAND && SHIFT) {    // row a's mask: row a - 1's before
#pragma unroll
      for (int a = K - 1; a > 0; --a) mk[a] = mk[a - 1];
      mk[0] = mask(e);
    }
#pragma unroll
    for (int a = 0; a < K; ++a) {
      float nv = __fadd_rn(cell_d(qv[a], xc), fminf(fminf(diag, v[a]), up));
      if constexpr (BAND && SHIFT) {
        nv = fmaxf(nv, mk[a]);
      } else if constexpr (BAND) {
        if ((unsigned)(e + a) > (unsigned)(2 * r)) nv = kBig;
      }
      diag = v[a];
      up = nv;
      v[a] = nv;
    }
    if constexpr (RARE) {
      if (c == L - 1) {
#pragma unroll
        for (int a = 0; a < K; ++a)
          if (a == la) res = v[a];
      }
    }
    if (store && (!RARE || (c >= lo && c <= hi)))
      out.st(c - lo, out_tag, v[K - 1]);
  };
  // a chunk's W steps, whole (steps past the strip's last read columns
  // past its band: BIG), each lane's series value loaded two steps ahead
  auto chunk = [&](int j0, float upc, auto band, auto rare) {
    constexpr bool RARE = decltype(rare)::value;
    if constexpr (decltype(band)::value && SHIFT) {
      // the masks of the step before j0, which the first step shifts
      const int e = i0 + r - (j0 - 1 - lane);
#pragma unroll
      for (int a = 0; a < K; ++a) mk[a] = mask(e + a);
    }
    auto xat = [&](int j) {
      const int c = j - lane;
      if constexpr (RARE) {    // a clamped address: never read past x
        const float xc = __ldg(x + (c < 0 ? 0 : c < L ? c : L - 1));
        return (unsigned)c < (unsigned)L ? xc : -kPoison;
      } else {
        return __ldg(x + c);
      }
    };
    float xa = xat(j0), xb = xat(j0 + 1);
#pragma unroll 8
    for (int u = 0; u < W; ++u) {
      const float xc = xa;
      xa = xb;
      if (u + 2 < W) xb = xat(j0 + u + 2);
      step(j0 + u, u, upc, xc, band, rare);
    }
  };
  for (int j0 = lo; j0 <= jend; j0 += W) {
    float upc = kBig;                 // the row above at column j0 + lane
    Row::fence();                     // the chunk before's loads are done
    if (in.p != nullptr) {
      const int c = j0 + lane;
      const bool want = from_above(c);
      in.settle(nx, c - ilo, want, in_tag);
      if (want) upc = Row::val(nx);
      if (from_above(c + W)) nx = in.ld(c + W - ilo);
    }
    // the chunk's columns j0 - W + 1 .. j0 + W - 1 inside the matrix
    const bool cols = j0 >= W - 1 && j0 + W - 1 <= L - 1;
    // every cell of steps j0 .. j0 + W - 1 inside the band too: rows s0 ..
    // s0 + S - 1, offsets i - c from s0 - j0 - W + 1 to s0 + S - 1 - j0 +
    // W - 1
    const bool inner = cols && full && s0 + S + W - 2 - j0 <= r
                       && j0 + W - 1 - s0 <= r;
    // no result here, and lane W - 1's columns (j0 - W + 1 .. j0) inside
    // lo .. hi: a strip stores only its own columns, since where the strip
    // below starts at the same column, the entries past hi are that
    // strip's own, which it may store first, needing none of ours (the
    // same for every lane: the paths' shuffles name the whole warp)
    const bool plain = cols && (jres < j0 || jres > j0 + W - 1)
                       && (out.p == nullptr
                           || (j0 - (W - 1) >= lo && j0 <= hi));
    if (inner)
      chunk(j0, upc, Flag<false>(), Flag<false>());
    else if (plain)
      chunk(j0, upc, Flag<true>(), Flag<false>());
    else
      chunk(j0, upc, Flag<true>(), Flag<true>());
  }
  return res;
}

// A ticket t of a batch of `slots` pairs (of `pairs`), `chains` chains
// of strips each, chain-major within the batch: (batch b, chain h, slot
// p), pair b slots + p.
__device__ __forceinline__ void strip_ticket(unsigned long long t,
                                             long long pairs, int slots,
                                             int chains, long long& b,
                                             int& h, int& p) {
  const long long per = (long long)slots * chains;
  b = (long long)t / per;
  const long long rem = (long long)t - b * per;
  const long long in_b = pairs - b * slots < slots ? pairs - b * slots
                                                   : slots;
  h = (int)(rem / in_b);
  p = (int)(rem - h * in_b);
}

// The strips of chain h of a pair (q, x) through `row` (a Row type),
// one after another on one warp: strips h G .. h G + G - 1 of its ns,
// tags from tag0 (strip s: tag0 + s).  A strip of a chain finds the strip
// above's row whole when the warp ran that strip too.  Returns cell (L -
// 1, L - 1) on the lane of row L - 1 (the pair's last strip), BIG
// elsewhere.
template <int K, bool SHIFT = false, class Row>
__device__ float strip_chain(const float* __restrict__ q,
                             const float* __restrict__ x, int L, int r,
                             int h, int G, int ns, Row row,
                             unsigned tag0) {
  float d = kBig;
  const int end = h * G + G < ns ? h * G + G : ns;
  for (int s = h * G; s < end; ++s)
    d = strip_dp<K, SHIFT>(q, x, L, r, s, s > 0 ? row : Row{nullptr},
                           tag0 + s - 1, s + 1 < ns ? row : Row{nullptr},
                           tag0 + s);
  return d;
}

// dtw_scan's diag route: the Q N pairs (query g, series n) = pair g N + n,
// their strips in chains of G (a ticket each: one warp runs a chain's
// strips in order, kernels/dtw.py diag_scan_geometry: all of a pair's
// where the band is narrow, else 1) in one ticket space over a persistent
// grid (as many CTAs as the card holds, diag_grid).  Scratch sc: the
// ticket, `done` (slots), then each slot's row of `width` entries;
// zeroed by the wrapper.  A pair's last strip gives its distance to the
// query's 64-bit atomicMin on (d bits << 32 | series).
template <int K>
__global__ void __launch_bounds__(kDiagScanThreads, K < 8 ? 3 : 2)
scan_strips(const float* __restrict__ q, const float* __restrict__ x,
            long long N, int L, int r, long long pairs, int slots,
            int width, int G, unsigned long long* sc,
            unsigned long long* keys) {
  constexpr int S = 32 * K;
  const int ns = (L + S - 1) / S, chains = (ns + G - 1) / G;
  const int lane = threadIdx.x & 31;
  unsigned long long* ticket = sc;
  unsigned long long* done = sc + 1;
  unsigned long long* rows = done + slots;
  const unsigned long long total = (unsigned long long)pairs * chains;
  for (;;) {
    unsigned long long t = 0;
    if (lane == 0) t = atomicAdd(ticket, 1ull);
    t = __shfl_sync(kAll, t, 0);
    if (t >= total) break;
    long long b;
    int h, p;
    strip_ticket(t, pairs, slots, chains, b, h, p);
    const long long pair = b * slots + p, g = pair / N, n = pair - g * N;
    if (h == 0 && b > 0) await_count(done + p, (unsigned long long)b);
    const float d = strip_chain<K>(q + g * L, x + n * L, L, r, h, G, ns,
                                   DevRow{rows + (long long)p * width},
                                   (unsigned)(b * ns) + 1);
    if (h == chains - 1) {
      if (lane == (L - 1) % S / K) atomicMin(keys + g, pack(d, (unsigned)n));
      __syncwarp();
      if (lane == 0) st_strong(done + p, (unsigned long long)b + 1);
    }
  }
}

// dtw_search's diag route: the refinement of query blockIdx.x / (cluster
// size) of the group by a cluster of CTAs (16 where the card holds one,
// else 8: kernels/dtw.py diag_cluster).  A round: warp 0 of CTA 0 lists
// the candidates whose bound lies below the best-so-far of the round's
// start (`take`, in order), then after a cluster barrier every warp takes
// their strips by ticket (a strip a ticket: a round's few pairs need their
// strips spread over the cluster's warps; batches of `slots` pairs, each
// a scratch slot); the pair's last strip gives (d bits << 32 | its
// place in the round) to the round's 64-bit atomicMin, whose least is the
// round's first minimum, read after a second barrier.  Then, in every
// thread alike, as the loop of rounds: the best-so-far and its id, the
// rounds, the candidates refined, and the stop at the next round's first
// bound.  Scratch (a query's per_query entries, zeroed): the ticket, the
// count taken, the rounds' keys by parity, `done` (slots), the list
// (min(round_k, N)), then each slot's row of `width` entries.  Tags
// go on across the rounds (`base`: the batches of the rounds before), so
// no entry of an earlier round passes for this one's.
template <int K>
__global__ void __launch_bounds__(kDiagSearchThreads, 1)
search_strips(const float* __restrict__ q, const float* __restrict__ x,
              long long N, int L, int r, int round_k,
              const float* __restrict__ slb,
              const long long* __restrict__ order, float* bsf_out,
              int* best_out, int* rounds_out, int* refined_out,
              unsigned long long* scratch, int slots, int width,
              long long per_query) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int S = 32 * K;
  const int rank = (int)cluster.block_rank();
  const int g = blockIdx.x / (int)cluster.num_blocks();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ns = (L + S - 1) / S;
  const long long listed = N < round_k ? N : round_k;
  unsigned long long* sc = scratch + (long long)g * per_query;
  unsigned long long* ticket = sc;
  unsigned long long* taken = sc + 1;
  unsigned long long* rkey = sc + 2;
  unsigned long long* done = sc + 4;
  unsigned long long* list = done + slots;
  unsigned long long* rows = list + listed;
  const float* qg = q + (long long)g * L;
  const float* lb = slb + (long long)g * N;
  const long long* ord = order + (long long)g * N;
  const long long end = (N + round_k - 1) / round_k * round_k;
  float bsf = kBig;
  long long best = -1, base = 0;
  int rounds = 0, refined = 0, par = 0;
  bool go = end > 0 && lb[0] < kBig;
  for (long long cursor = 0; go; cursor += round_k) {
    if (rank == 0 && warp == 0) {
      const int here = (int)(N - cursor < round_k ? N - cursor : round_k);
      long long n_take = 0;
      for (int j0 = 0; j0 < here; j0 += 32) {
        const int j = j0 + lane;
        const bool take = j < here && lb[cursor + j] < bsf;
        const unsigned m = __ballot_sync(kAll, take);
        if (take)
          st_strong(list + n_take + __popc(m & ((1u << lane) - 1)),
                    (unsigned long long)j);
        n_take += __popc(m);
      }
      if (lane == 0) {
        st_strong(ticket, 0);
        st_strong(taken, (unsigned long long)n_take);
        st_strong(rkey + par, ~0ull);
      }
    }
    cluster.sync();
    const long long nt = (long long)ld_strong(taken);
    const unsigned long long total = (unsigned long long)nt * ns;
    for (;;) {
      unsigned long long t = 0;
      if (lane == 0) t = atomicAdd(ticket, 1ull);
      t = __shfl_sync(kAll, t, 0);
      if (t >= total) break;
      long long b;
      int s, p;
      strip_ticket(t, nt, slots, ns, b, s, p);
      const unsigned j = (unsigned)ld_strong(list + b * slots + p);
      if (s == 0 && b > 0)
        await_count(done + p, (unsigned long long)(base + b));
      const DevRow row{rows + (long long)p * width};
      const unsigned tag = (unsigned)((base + b) * ns + s) + 1;
      const float d = strip_dp<K>(qg, x + ord[cursor + j] * L, L, r, s,
                                  s > 0 ? row : DevRow{nullptr}, tag - 1,
                                  s + 1 < ns ? row : DevRow{nullptr}, tag);
      if (s == ns - 1) {
        if (lane == (L - 1) % S / K) atomicMin(rkey + par, pack(d, j));
        __syncwarp();
        if (lane == 0)
          st_strong(done + p, (unsigned long long)(base + b) + 1);
      }
    }
    cluster.sync();
    const unsigned long long key = ld_strong(rkey + par);
    const float dmin = __uint_as_float((unsigned)(key >> 32));
    if (dmin < bsf) {
      bsf = dmin;
      best = ord[cursor + (unsigned)(key & 0xffffffffu)];
    }
    ++rounds;
    refined += (int)nt;
    base += (nt + slots - 1) / slots;
    go = cursor + round_k < end && lb[cursor + round_k] < bsf;
    par ^= 1;
  }
  if (rank == 0 && threadIdx.x == 0) {
    bsf_out[g] = bsf;
    best_out[g] = (int)best;
    rounds_out[g] = rounds;
    refined_out[g] = refined;
  }
}

// ------------------------------------------- the chain and spread routes
// The diag routes' strips with the hand-over kept on the SM: every pair's
// strips run in one CTA, their rows in its shared memory, so no strip reads
// device scratch or waits on another SM.
//
// dtw_scan's chain route (scan_chain): throughput over many independent
// pairs.  A warp takes one pair and runs its strips in order, each strip's
// last row handed to the next through the warp's own slice of shared memory
// as plain floats (WarpRow: the warp writes the row and then reads it, no
// tag, no spin, no ticket).  Persistent CTAs take (query chunk, series tile)
// units as scan_wave_kernel does, a tile a series a warp: warp w of unit (c,
// b) runs series b warps + w against each query of chunk c in turn, so a
// series leaves device memory once a chunk (its next unit's series brought
// into L2 meanwhile), and keeps each query's least key in a register (lane
// g: query c0 + g's) until the CTA moves to another chunk: one 64-bit
// atomicMin a (warp, query) a chunk.
// scan_chain's CTA: 8 warps, two CTAs an SM at either rows a lane (3 at
// 4 rows held 80 registers and spilled; 4 rows run only where forced, r <=
// 255 being the wave and ring routes')
constexpr int kChainThreads = 256;

template <int K>
__global__ void __launch_bounds__(kChainThreads, 2)
scan_chain(const float* __restrict__ q, const float* __restrict__ x,
           long long N, int L, int r, int Q, int qc, int width,
           unsigned long long* keys) {
  constexpr int S = 32 * K;
  extern __shared__ float chain_rows[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const WarpRow row{chain_rows + warp * width};
  const int ns = (L + S - 1) / S, at = (L - 1) % S / K;
  const long long G = (N + warps - 1) / warps;
  const long long units = G * ((Q + qc - 1) / qc);
  int c0 = -1, nq = 0;                   // the chunk's first query, its size
  unsigned long long best = ~0ull;       // lane g: query c0 + g's
  long long c = blockIdx.x / G, b = blockIdx.x - c * G;   // unit c G + b
  for (long long u = blockIdx.x; u < units; u += gridDim.x) {
    if (c * qc != c0) {                  // the same for the whole CTA
      if (lane < nq && best != ~0ull) atomicMin(keys + c0 + lane, best);
      best = ~0ull;
      c0 = (int)(c * qc);
      nq = min(qc, Q - c0);
    }
    const long long n = b * warps + warp;
    long long b1 = b + gridDim.x, c1 = c;
    while (b1 >= G) {
      b1 -= G;
      ++c1;
    }
    const long long n1 = b1 * warps + warp;
    if (u + gridDim.x < units && n1 < N)   // its next series, into L2
      for (int e = 32 * lane; e < L; e += 32 * 32)
        prefetch_l2(x + n1 * L + e);
    if (n < N) {
      for (int g = 0; g < nq; ++g) {
        const float d = strip_chain<K, true>(q + (long long)(c0 + g) * L,
                                             x + n * L, L, r, 0, ns, ns,
                                             row, 1);
        const float dn = __shfl_sync(kAll, d, at);
        const unsigned long long key = pack(dn, (unsigned)n);
        if (lane == g && key < best) best = key;
      }
    }
    b = b1;
    c = c1;
  }
  if (lane < nq && best != ~0ull) atomicMin(keys + c0 + lane, best);
}

// dtw_search's spread route (search_spread): few pairs a round, so latency.
// One persistent cooperative launch (every CTA resident at once): the CTAs
// form groups of `per`, a group a query at a time (queries g = group, group
// + groups, ..).  An iteration computes `spec` rounds at once (the window
// of spec round_k candidates from the cursor), as the wave routes compute
// kSpec: every candidate of the window whose bound lies below the
// best-so-far of the iteration's start is taken, window position j by CTA j
// % per of the group.  A CTA's warps take its pairs' strips by a ticket in
// shared memory (a strip a ticket, pairs in batches of `slots`, strip-major
// within a batch, as the diag routes take theirs, so a strip waits only on
// a strip taken earlier by a running warp of its CTA), a pair's rows handed
// on in the CTA's shared memory (CtaRow: tagged entries, slot p's row for
// the batch's pair p, `done` counts in shared memory for its next pair); a
// pair's last strip writes its distance to `dist` (the query's row of the
// iteration's parity, at j).  After a barrier over the group's CTAs (a
// count in device memory: every CTA is resident, so no wait deadlocks),
// warp 0 of every CTA applies the spec rounds in order exactly as the loop
// of single rounds does (the stop before each, the candidates below the
// best-so-far of the moment, their first minimum), reading `dist` from L2,
// so the best-so-far, the id, the rounds and the candidates refined are
// that loop's in every CTA; the group's CTA 0 writes them.  Tags and done
// counts go on across iterations and queries (`base`: the batches before).
constexpr int kSpreadThreads = 512;       // 16 warps, one CTA an SM
constexpr int kSpreadSlots = 16;          // pairs in flight a CTA, at most

__device__ __forceinline__ unsigned ld_cta32(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.cta.shared.u32 %0, [%1];" : "=r"(v)
               : "r"(smem_addr(p)));
  return v;
}

__device__ __forceinline__ void group_barrier(unsigned* bar,
                                              unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(bar, 1u);
    const long long t0 = clock64();
    unsigned nap = 32, v;
    for (;;) {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v)
                   : "l"(bar) : "memory");
      if (v >= target) break;
      __nanosleep(nap);
      nap = nap < 256 ? 2 * nap : 256;
      stuck(t0);
    }
    __threadfence();
  }
  __syncthreads();
}

template <int K>
__global__ void __launch_bounds__(kSpreadThreads, 1)
search_spread(const float* __restrict__ q, const float* __restrict__ x,
              long long N, int L, int r, int round_k, int Qg, int spec,
              int per, int slots, int width, const float* __restrict__ slb,
              const long long* __restrict__ order, float* bsf_out,
              int* best_out, int* rounds_out, int* refined_out, float* dist,
              long long wdist, unsigned* bar) {
  constexpr int S = 32 * K;
  extern __shared__ unsigned long long spread_rows[];   // slots x width
  __shared__ unsigned s_done[kSpreadSlots];
  __shared__ unsigned s_ticket;
  __shared__ float s_bsf;
  __shared__ int s_go;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int groups = gridDim.x / per, grp = blockIdx.x / per;
  const int cta = blockIdx.x - grp * per;
  const int ns = (L + S - 1) / S, at = (L - 1) % S / K;
  const long long W = (long long)spec * round_k;
  const long long end = (N + round_k - 1) / round_k * round_k;
  // tags start at 1: no entry left in shared memory by an earlier kernel
  // passes for a strip's
  for (int e = threadIdx.x; e < slots * width; e += blockDim.x)
    spread_rows[e] = 0;
  if (threadIdx.x < slots) s_done[threadIdx.x] = 0;
  unsigned it = 0, base = 0;
  for (int g = grp; g < Qg; g += groups) {
    const float* qg = q + (long long)g * L;
    const float* lb = slb + (long long)g * N;
    const long long* ord = order + (long long)g * N;
    float* dg = dist + (long long)g * 2 * wdist;
    float bsf = kBig;
    long long best = -1;
    int rounds = 0, refined = 0, par = 0;
    bool go = end > 0 && lb[0] < kBig;
    for (long long cursor = 0; go; cursor += W) {
      // this CTA's window positions j = cta + per i, i < mine
      const long long here = N - cursor < W ? N - cursor : W;
      const long long mine = here > cta ? (here - cta + per - 1) / per : 0;
      const unsigned long long total = (unsigned long long)mine * ns;
      float* dj = dg + par * wdist;
      if (threadIdx.x == 0) s_ticket = 0;
      __syncthreads();
      for (;;) {
        unsigned t = 0;
        if (lane == 0) t = atomicAdd(&s_ticket, 1u);
        t = __shfl_sync(kAll, t, 0);
        if (t >= total) break;
        long long b;
        int h, p;                            // strip h of the batch's pair p
        strip_ticket(t, mine, slots, ns, b, h, p);
        const long long j = cta + (long long)per * (b * slots + p);
        const bool take = lb[cursor + j] < bsf;
        const unsigned nb = base + (unsigned)b;   // the slot's pairs before
        if (take || h == ns - 1) {
          // the slot's pair of the batch before is done with the row (a
          // pair not taken passes the slot on at its last strip; the
          // iteration's first batch finds every slot free)
          if ((h == 0 || !take) && b > 0) {
            const long long t0 = clock64();
            unsigned nap = 32;
            while (!__all_sync(kAll, ld_cta32(s_done + p) >= nb)) {
              __nanosleep(nap);
              nap = nap < 256 ? 2 * nap : 256;
              stuck(t0);
            }
            __threadfence_block();
          }
        }
        float d = kBig;
        if (take) {
          const CtaRow row{spread_rows + (long long)p * width};
          d = strip_dp<K>(qg, x + ord[cursor + j] * L, L, r, h,
                          h > 0 ? row : CtaRow{nullptr}, nb * ns + h,
                          h + 1 < ns ? row : CtaRow{nullptr}, nb * ns + h + 1);
        }
        if (h == ns - 1) {
          if (take && lane == at) dj[j] = d;
          __syncwarp();
          __threadfence_block();
          if (lane == 0)
            asm volatile("st.relaxed.cta.shared.u32 [%0], %1;"
                         :: "r"(smem_addr(s_done + p)), "r"(nb + 1)
                         : "memory");
        }
      }
      base += (unsigned)((mine + slots - 1) / slots);
      group_barrier(bar + grp, ++it * (unsigned)per);
      if (warp == 0) {
        bool on = true;
        for (int u = 0; u < spec; ++u) {
          const long long cu = cursor + (long long)u * round_k;
          if (u > 0) on = on && cu < end && lb[cu] < bsf;  // the stop before
          if (!on) break;
          unsigned long long key = ~0ull;
          int nt = 0;
          for (int j0 = 0; j0 < round_k; j0 += 32) {
            const int j = j0 + lane;
            const long long pos = cu + j;
            const bool t = j < round_k && pos < N && lb[pos] < bsf;
            const unsigned long long kj =
                t ? pack(__ldcg(dj + (pos - cursor)), (unsigned)j) : ~0ull;
            key = kj < key ? kj : key;
            nt += __popc(__ballot_sync(kAll, t));
          }
          key = warp_min_u64(key);
          const float dmin = __uint_as_float((unsigned)(key >> 32));
          if (dmin < bsf) {
            bsf = dmin;
            best = ord[cu + (unsigned)(key & 0xffffffffu)];
          }
          ++rounds;
          refined += nt;
        }
        // the stop before the next iteration's first round
        const long long nc = cursor + W;
        on = on && nc < end && lb[nc] < bsf;
        if (lane == 0) {
          s_bsf = bsf;
          s_go = on;
        }
      }
      __syncthreads();
      bsf = s_bsf;
      go = s_go;
      par ^= 1;
    }
    if (cta == 0 && threadIdx.x == 0) {
      bsf_out[g] = bsf;
      best_out[g] = (int)best;
      rounds_out[g] = rounds;
      refined_out[g] = refined;
    }
  }
}

#endif  // DTW_SCAN_WIDE_RINGS

// A wave route's pair (see the top): query row qp (qp[j]: the row of the
// lane's step j) against series window xp (xp[j + m]: the column of the
// lane's cell m at step j), both padded with values that make a cell past
// an edge infinity.  Steps j = 0 .. L - 1 are the wavefront's steps l0 ..
// L - 1 + l0; `first`: the lane of cell (0, 0), offset r = C l0 + m0.
// Returns the lane's cell m0 after the last step: cell (L - 1, r) on the
// lane `first`.  Cells from ML on of a lane with `top` lie past the band.
template <int C, int ML>
__device__ __forceinline__ float scan_pair(const float* __restrict__ qp,
                                           const float* __restrict__ xp,
                                           int L, int m0, bool first,
                                           bool top, int from) {
  float v[C], w[C];          // w[(u + m) % C]: cell m's column at step u
#pragma unroll
  for (int m = 0; m < C; ++m) v[m] = (first && m == m0) ? 0.f : kBig;
#pragma unroll
  for (int m = 0; m < C - 1; ++m) w[m] = xp[m];
  // step j = j0 + u, u < C: one new column into the window, one query value
  auto step = [&](int j0, int u) {
    w[(u + C - 1) % C] = xp[j0 + u + C - 1];
    const float qi = qp[j0 + u];
    float d[C];
#pragma unroll
    for (int m = 0; m < C; ++m) d[m] = cell_d(qi, w[(u + m) % C]);
    wave_cells<C, ML>(v, d, from, top);
  };
  int j0 = 0;
  for (; j0 + C <= L; j0 += C) {
#pragma unroll
    for (int u = 0; u < C; ++u) step(j0, u);
  }
#pragma unroll
  for (int u = 0; u < C - 1; ++u)
    if (j0 + u < L) step(j0, u);
  float res = v[0];
#pragma unroll
  for (int m = 1; m < C; ++m)
    if (m == m0) res = v[m];
  return res;
}

// dtw_scan's wave route, C cells a lane (see the top): the work is units
// u = c G + b of query chunk c (qc queries) and tile group b (G groups of
// a CTA's warps' tiles: warp w takes tile b warps + w, P series each), a
// CTA taking units blockIdx.x and on by the grid, so chunk by chunk: it
// loads a chunk's rows when its next unit is in another chunk, and keeps
// each (warp, query) least key in a register until then.  Shared
// memory: the chunk's query rows (qc, Lq), the query at offset H of a row,
// +kPoison around it; then each warp's tile: `pad` floats, then P rows of
// S floats, the series at the start of each, -kPoison elsewhere
// (kernels/dtw.py scan_geometry chooses them).
template <int C, int ML>
__global__ void __launch_bounds__(kScanWaveThreads)
scan_wave_kernel(const float* __restrict__ q, const float* __restrict__ x,
                 long long N, int L, int r, int Q, int qc, int pad, int S,
                 int Lq, bool vec, unsigned long long* keys) {
  const int H = (2 * r + C) / C, P = 32 / H, l0 = r / C, m0 = r % C;
  extern __shared__ float4 sm4[];
  float* qs = reinterpret_cast<float*>(sm4);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warps = blockDim.x >> 5, T = pad + P * S;
  float* xt = qs + qc * Lq + warp * T;               // the warp's tile
  const int slot = lane / H, ll = lane - slot * H;   // slot P: idle lanes
  const bool live = slot < P;
  const bool top = live && ll == H - 1, first = live && ll == l0;
  const int from = (lane + 31) & 31;
  for (int e = lane; e < T; e += 32) xt[e] = -kPoison;
  // the lane's window and query row, index 0 at step 0 (wavefront l0)
  const float* xp = xt + pad + min(slot, P - 1) * S + l0 + (C - 1) * ll - r;
  const long long tiles = (N + P - 1) / P;
  const long long G = (tiles + warps - 1) / warps;
  const long long units = G * ((Q + qc - 1) / qc);
  int c0 = -1, nq = 0;                   // the chunk's first query, its size
  unsigned long long best = ~0ull;       // lane g: query c0 + g's
  long long c = blockIdx.x / G, b = blockIdx.x - c * G;   // unit c G + b
  for (long long u = blockIdx.x; u < units; u += gridDim.x) {
    if (c * qc != c0) {                  // the same for the whole CTA
      if (lane < nq && best != ~0ull) atomicMin(keys + c0 + lane, best);
      best = ~0ull;
      c0 = (int)(c * qc);
      nq = min(qc, Q - c0);
      __syncthreads();                   // the last chunk's rows are read
      for (int e = tid; e < qc * Lq; e += blockDim.x) {
        const int g = e / Lq, j = e - g * Lq - H;
        qs[e] = g < nq && j >= 0 && j < L ? q[(long long)(c0 + g) * L + j]
                                          : kPoison;
      }
      __syncthreads();
    }
    const long long t = b * warps + warp;
    // the next unit, without a 64-bit division (one a unit cost 1.6 % at
    // r 25 on 8 queries, H100)
    long long b1 = b + gridDim.x, c1 = c;
    while (b1 >= G) {
      b1 -= G;
      ++c1;
    }
    if (t < tiles) {
      const long long n0 = t * P;
      const int np = (int)min((long long)P, N - n0);
      __syncwarp();                      // the last tile's rows are read
      if (vec) {
        const int row4 = L >> 2;
        for (int e = lane; e < np * row4; e += 32) {
          const int p = e / row4, c = (e - p * row4) << 2;
          cp_async16(xt + pad + p * S + c, x + (n0 + p) * L + c);
        }
      } else {
        for (int e = lane; e < np * L; e += 32) {
          const int p = e / L, c = e - p * L;
          cp_async4(xt + pad + p * S + c, x + (n0 + p) * L + c);
        }
      }
      asm volatile("cp.async.commit_group;" ::: "memory");
      const long long t1 = b1 * warps + warp;
      if (u + gridDim.x < units && t1 < tiles) {  // its tile, into L2
        const long long n1 = t1 * P;
        const long long e1 = min((long long)P, N - n1) * L;
        for (long long e = 32 * lane; e < e1; e += 32 * 32)
          prefetch_l2(x + n1 * L + e);
      }
      cp_wait();
      __syncwarp();
      const bool real = live && slot < np;
      for (int g = 0; g < nq; ++g) {
        const float d = scan_pair<C, ML>(qs + g * Lq + H + l0 - ll, xp, L, m0,
                                         first, top, from);
        unsigned long long key =
            real && ll == l0 ? pack(d, (unsigned)(n0 + slot)) : ~0ull;
        key = warp_min_u64(key);
        if (lane == g && key < best) best = key;
      }
    }
    b = b1;
    c = c1;
  }
  if (lane < nq && best != ~0ull) atomicMin(keys + c0 + lane, best);
}

// scan_pair for L > 1024 (scan_ring_kernel): the lane's columns come from
// its pair's ring xr (column c at xr[c & (W - 1)], W = ring_size(C, H)),
// which the pair's lanes (`fill`) fill kRingChunk columns at a time from
// the series xg in device memory, one chunk in flight while the steps run
// (4-byte cp.async; -kPoison for a column outside [0, L), as the staged
// tile's pads), and the query values from qg in device memory (+kPoison
// outside [0, L), as the staged rows' pads).  The cells, their order and
// the window of C registers are scan_pair's, so the bits are too.  A step
// j reads columns j + l0 - r to j + l0 - r + reach (every lane of the
// pair), so W >= span + 2 kRingChunk + 8 keeps every column a block of C
// steps reads beside the chunk in flight.
template <int C, int ML>
__device__ __forceinline__ float scan_pair_ring(
    const float* __restrict__ qg, const float* __restrict__ xg,
    float* __restrict__ xr, int W, int L, int r, int H, int ll, int m0,
    bool first, bool top, bool fill, int from) {
  const int l0 = r / C, wmask = W - 1;
  const int c_lo = l0 - r, cl = l0 + (C - 1) * ll - r;
  const int reach = (C - 1) * (H - 1) + C - 1;
  const int c_end = L - 1 + c_lo + reach;    // the last column a step reads
  int ready = c_lo, hi = c_lo;               // landed below ready, then
  auto ensure = [&](int j_last) {            // in flight below hi
    const int col = min(j_last + c_lo + reach, c_end);
    while (ready <= col) {
      cp_wait();
      __syncwarp();             // landed for every lane; older slots read
      ready = hi;
      if (hi <= c_end) {
        if (fill)
          for (int c = hi + ll; c < hi + kRingChunk; c += H) {
            if ((unsigned)c < (unsigned)L) cp_async4(xr + (c & wmask), xg + c);
            else xr[c & wmask] = -kPoison;
          }
        asm volatile("cp.async.commit_group;" ::: "memory");
        hi += kRingChunk;
      }
    }
  };
  float v[C], w[C];          // w[(u + m) % C]: cell m's column at step u
#pragma unroll
  for (int m = 0; m < C; ++m) v[m] = (first && m == m0) ? 0.f : kBig;
  ensure(0);
#pragma unroll
  for (int m = 0; m < C - 1; ++m) w[m] = xr[(cl + m) & wmask];
  auto step = [&](int j0, int u) {
    const int j = j0 + u, qj = j + l0 - ll;
    w[(u + C - 1) % C] = xr[(cl + j + C - 1) & wmask];
    const float qi = (unsigned)qj < (unsigned)L ? __ldg(qg + qj) : kPoison;
    float d[C];
#pragma unroll
    for (int m = 0; m < C; ++m) d[m] = cell_d(qi, w[(u + m) % C]);
    wave_cells<C, ML>(v, d, from, top);
  };
  int j0 = 0;
  for (; j0 + C <= L; j0 += C) {
    ensure(j0 + C - 1);
#pragma unroll
    for (int u = 0; u < C; ++u) step(j0, u);
  }
  // the last L % C steps one at a time, the window moved down by C - 1
  // moves a step (w[m]: cell m's column, as at u = 0), so that the
  // kernel holds one unrolled block of C steps where it held two (each
  // width is C / 2 instances to build); the moves, at most C - 1 steps of
  // more than 1,024, cost under 0.5 %
  ensure(L - 1);
#pragma unroll 1
  for (; j0 < L; ++j0) {
    step(j0, 0);
#pragma unroll
    for (int m = 0; m < C - 1; ++m) w[m] = w[m + 1];
  }
  float res = v[0];
#pragma unroll
  for (int m = 1; m < C; ++m)
    if (m == m0) res = v[m];
  return res;
}

// dtw_scan's wave route for L > 1024: scan_wave_kernel's units, warps,
// pairs and lanes, with each pair's series through a ring of W floats
// (scan_pair_ring) in place of the staged tile, and the queries read
// from device memory (L1 and L2 hold a chunk's rows) in place of the
// staged rows, so shared memory (warps x P x W floats) no longer grows
// with L.  A tile's series leave device memory once a query of the chunk.
template <int C, int ML>
__global__ void __launch_bounds__(kScanWaveThreads)
scan_ring_kernel(const float* __restrict__ q, const float* __restrict__ x,
                 long long N, int L, int r, int Q, int qc, int W,
                 unsigned long long* keys) {
  const int H = (2 * r + C) / C, P = 32 / H, l0 = r / C, m0 = r % C;
  extern __shared__ float4 sm4[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warps = blockDim.x >> 5;
  const int slot = lane / H, ll = lane - slot * H;   // slot P: idle lanes
  const bool live = slot < P;
  const bool top = live && ll == H - 1, first = live && ll == l0;
  const int from = (lane + 31) & 31;
  float* xr = reinterpret_cast<float*>(sm4)
              + (warp * P + min(slot, P - 1)) * W;
  const long long tiles = (N + P - 1) / P;
  const long long G = (tiles + warps - 1) / warps;
  const long long units = G * ((Q + qc - 1) / qc);
  int c0 = -1, nq = 0;
  unsigned long long best = ~0ull;       // lane g: query c0 + g's
  long long c = blockIdx.x / G, b = blockIdx.x - c * G;
  for (long long u = blockIdx.x; u < units; u += gridDim.x) {
    if (c * qc != c0) {
      if (lane < nq && best != ~0ull) atomicMin(keys + c0 + lane, best);
      best = ~0ull;
      c0 = (int)(c * qc);
      nq = min(qc, Q - c0);
    }
    const long long t = b * warps + warp;
    long long b1 = b + gridDim.x, c1 = c;
    while (b1 >= G) {
      b1 -= G;
      ++c1;
    }
    if (t < tiles) {
      const long long n0 = t * P;
      const int np = (int)min((long long)P, N - n0);
      const long long t1 = b1 * warps + warp;
      if (u + gridDim.x < units && t1 < tiles) {  // its tile, into L2
        const long long n1 = t1 * P;
        const long long e1 = min((long long)P, N - n1) * L;
        for (long long e = 32 * lane; e < e1; e += 32 * 32)
          prefetch_l2(x + n1 * L + e);
      }
      const float* xg = x + min(n0 + min(slot, P - 1), N - 1) * L;
      const bool real = live && slot < np;
      for (int g = 0; g < nq; ++g) {
        const float d = scan_pair_ring<C, ML>(
            q + (long long)(c0 + g) * L, xg, xr, W, L, r, H, ll, m0, first,
            top, live, from);
        unsigned long long key =
            real && ll == l0 ? pack(d, (unsigned)(n0 + slot)) : ~0ull;
        key = warp_min_u64(key);
        if (lane == g && key < best) best = key;
      }
    }
    b = b1;
    c = c1;
  }
  if (lane < nq && best != ~0ull) atomicMin(keys + c0 + lane, best);
}

#ifndef DTW_SCAN_WIDE_RINGS
// The diag routes at K rows a lane, the wrapper's geometry
// (kernels/dtw.py diag_scan_geometry, diag_search_geometry) checked
// against what the kernels read: `width` entries hold a strip's columns,
// min(L, 2r + 32 K), and every tag of a launch fits in
// 31 bits.
bool diag_fits(int L, int r, int K, int slots, int width,
               long long batches) {
  const int ns = (L + 32 * K - 1) / (32 * K);
  const long long cols = 2LL * r + 32 * K < L ? 2LL * r + 32 * K : L;
  return slots >= 1 && width >= cols && batches * ns < 0x7fffffffLL;
}

template <int K>
int diag_scan_launch(const float* q, const float* x, long long N, int L,
                     int r, int Q, int slots, int width, int G, int blocks,
                     unsigned long long* sc, unsigned long long* keys,
                     cudaStream_t st) {
  const long long pairs = (long long)Q * N;
  if (blocks < 1 || G < 1
      || !diag_fits(L, r, K, slots, width, (pairs + slots - 1) / slots))
    return (int)cudaErrorInvalidValue;
  scan_strips<K><<<blocks, kDiagScanThreads, 0, st>>>(
      q, x, N, L, r, pairs, slots, width, G, sc, keys);
  return (int)cudaGetLastError();
}

// Clusters of `cluster` CTAs (16: a non-portable size), one a query; a
// query's scratch is 4 + slots + min(round_k, N) + slots width entries.
template <int K>
int diag_search_launch(const float* q, const float* x, long long N, int L,
                       int r, int Qg, int round_k, int slots, int width,
                       int cluster, const float* slb, const long long* order,
                       float* bsf, int* best, int* rounds, int* refined,
                       unsigned long long* sc, cudaStream_t st) {
  const long long listed = N < round_k ? N : round_k;
  if ((cluster != 8 && cluster != 16)
      || !diag_fits(L, r, K, slots, width, N + 1))
    return (int)cudaErrorInvalidValue;
  const long long per_query = 4 + slots + listed + (long long)slots * width;
  cudaError_t e = cudaSuccess;
  if (cluster > 8)
    e = cudaFuncSetAttribute(search_strips<K>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)Qg * cluster);
  cfg.blockDim = dim3(kDiagSearchThreads);
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, search_strips<K>, q, x, N, L, r, round_k, slb,
                         order, bsf, best, rounds, refined, sc, slots, width,
                         per_query);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// dtw_scan's chain route at K rows a lane: 8 warps a CTA, each warp's row
// of `width` floats in shared memory (a strip's columns, as diag_fits
// checks), as many CTAs as the card holds at once, at most one
// a unit, the chunks taken smaller where the tile groups are few.
template <int K>
int chain_launch(const float* q, const float* x, long long N, int L, int r,
                 int Q, int width, unsigned long long* keys,
                 cudaStream_t st) {
  const int warps = kChainThreads / 32;
  const size_t smem = sizeof(float) * (size_t)warps * width;
  if (!diag_fits(L, r, K, 1, width, 1) || smem > kWaveSmem)
    return (int)cudaErrorInvalidValue;
  int held = 0;
  const int e = held_ctas((const void*)scan_chain<K>, kChainThreads, smem,
                          held);
  if (e != 0) return e;
  if (held < 1) return (int)cudaErrorInvalidConfiguration;
  const long long G = (N + warps - 1) / warps;
  const int qn = chunk_queries(G, Q, Q < 32 ? Q : 32, held);
  const long long units = G * ((Q + qn - 1) / qn);
  const unsigned grid = (unsigned)(units < held ? units : held);
  scan_chain<K><<<grid, kChainThreads, smem, st>>>(q, x, N, L, r, Q, qn,
                                                    width, keys);
  return (int)cudaGetLastError();
}

// dtw_search's spread route at K rows a lane: one cooperative launch of as
// many CTAs as the card holds at once (each `slots` rows of `width`
// entries), in groups of per = held / min(Qg, held) CTAs; dist holds each
// query's two rows of wdist >= min(spec round_k, N) floats, bar a count
// for each group (Qg of them suffice), zeroed here.  Every tag of the
// launch fits in 31 bits: a CTA's batches are at most 2 N + 1 a query of
// its group.
template <int K>
int spread_launch(const float* q, const float* x, long long N, int L, int r,
                  int Qg, int round_k, int spec, int slots, int width,
                  const float* slb, const long long* order, float* bsf,
                  int* best, int* rounds, int* refined, float* dist,
                  long long wdist, unsigned* bar, cudaStream_t st) {
  const int ns = (L + 32 * K - 1) / (32 * K);
  const size_t smem = sizeof(unsigned long long) * (size_t)slots * width;
  const long long window = (long long)spec * round_k;
  if (slots > kSpreadSlots || spec < 1
      || wdist < (window < N ? window : N) || smem > kWaveSmem
      || !diag_fits(L, r, K, slots, width, 1))
    return (int)cudaErrorInvalidValue;
  int held = 0;
  const int code = held_ctas((const void*)search_spread<K>, kSpreadThreads,
                             smem, held);
  if (code != 0) return code;
  if (held < 1) return (int)cudaErrorInvalidConfiguration;
  const int groups = Qg < held ? Qg : held, per = held / groups;
  const long long each = (Qg + groups - 1) / groups;   // queries a group
  if (!diag_fits(L, r, K, slots, width, each * (2 * N + 1) + 1))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaMemsetAsync(bar, 0, sizeof(unsigned) * groups, st);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(groups * per));
  cfg.blockDim = dim3(kSpreadThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, search_spread<K>, q, x, N, L, r, round_k, Qg,
                         spec, per, slots, width, slb, order, bsf, best,
                         rounds, refined, dist, wdist, bar);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// What the card holds at once at K rows a lane: out[0] scan_strips<K>
// CTAs (SMs x CTAs an SM), out[1] and out[2] clusters of 16 and of 8
// search_strips<K> CTAs (0: that size does not launch here).
template <int K>
int diag_held(int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, scan_strips<K>, kDiagScanThreads, 0);
  if (e != cudaSuccess) return (int)e;
  out[0] = sms * per_sm;
  for (int i = 0; i < 2; ++i) {
    const int cluster = i == 0 ? 16 : 8;
    if (cluster > 8)
      e = cudaFuncSetAttribute(search_strips<K>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = cluster;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cluster);
    cfg.blockDim = dim3(kDiagSearchThreads);
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    int n = 0;
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveClusters(&n, search_strips<K>, &cfg);
    if (e != cudaSuccess) {         // this size does not launch: 0
      cudaGetLastError();
      n = 0;
      e = cudaSuccess;
    }
    out[1 + i] = n;
  }
  return 0;
}

// One case a diag instance: K = 4 or 8 rows a lane.
#define DTW_DIAG_ROWS(F, K, ...)                                           \
  switch (K) {                                                             \
    case 4: return F<4>(__VA_ARGS__);                                      \
    case 8: return F<8>(__VA_ARGS__);                                      \
    default: return (int)cudaErrorInvalidValue;                            \
  }
#endif  // DTW_SCAN_WIDE_RINGS

// The wave routes, C cells a lane: clusters of kSpec CTAs a query,
// `threads` / 32 warps a CTA (the wrapper's band_threads), the query, the
// rounds' distances and bounds and the pairs' rows within kWaveSmem.
// RING: L > 1024, the pairs' rows through rings (wave_kernel).  At 16
// cells a lane (ring16 only) a CTA holds 512 threads at most.
template <int C, bool RING>
int wave_launch(const float* q, const float* x, long long N, int L, int r,
                int Qg, int round_k, int threads, const float* slb,
                const long long* order, float* bsf, int* best, int* rounds,
                int* refined, cudaStream_t st) {
  const int H = (2 * r + C) / C;
  if (H > 32 || round_k > kMaxRoundK || threads > (C < 16 ? 1024 : 512))
    return (int)cudaErrorInvalidValue;
  const int P = 32 / H;
  const size_t row = RING ? ring_size(C, H) : L;
  const size_t qf = !RING || L <= kStageL ? L : 0;
  const size_t smem = sizeof(float) * (qf + 4 * (size_t)round_k
                                       + (size_t)threads / 32 * P * row);
  if (smem > kWaveSmem) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      wave_kernel<C, RING>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kSpec;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)Qg * kSpec);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, wave_kernel<C, RING>, q, x, N, L, r, round_k,
                         slb, order, bsf, best, rounds, refined);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// dtw_scan's band route of radius R: the grid's y dimension takes 65,535
// queries, more go in launches of as many, each on its slice of q and keys.
template <int R>
int scan_launch(const float* q, const float* x, long long N, int L, int Q,
                int threads, unsigned long long* keys, cudaStream_t st) {
  const bool longq = L > kStageL;
  const size_t smem = sizeof(float) * (longq ? 0 : L);
  auto kernel = longq ? scan_kernel<R, true> : scan_kernel<R>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  for (int g0 = 0; g0 < Q; g0 += 65535) {
    const dim3 grid((unsigned)((N + threads - 1) / threads),
                    (unsigned)(Q - g0 < 65535 ? Q - g0 : 65535));
    kernel<<<grid, threads, smem, st>>>(q + (long long)g0 * L, x, N, L,
                                        keys + g0);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// The wave route of dtw_scan: C cells a lane, ML (the top lane's cells in
// the band) a template; the CTA's `threads` and the shared memory's layout
// from the wrapper (scan_geometry), checked here against what the kernel
// reads; as many CTAs as the card holds at once, at most one a unit, the
// chunks taken smaller where the tile groups are few (chunk_queries).
// RING (L > 1024): scan_ring_kernel, S the ring's floats (ring_size), pad
// and Lq 0.
template <int C, int ML, bool RING>
int scan_wave_launch(const float* q, const float* x, long long N, int L,
                     int r, int Q, int threads, int qc, int pad, int S,
                     int Lq, unsigned long long* keys, cudaStream_t st) {
  const int H = (2 * r + C) / C, P = 32 / H, l0 = r / C;
  const int warps = threads / 32;
  const size_t smem = sizeof(float) * ((size_t)qc * Lq
                                       + (size_t)warps * (pad + P * S));
  if (threads % 32 || warps < 1 || threads > kScanWaveThreads || qc < 1
      || qc > 32 || smem > kWaveSmem)
    return (int)cudaErrorInvalidValue;
  if (RING ? (pad || Lq || S != ring_size(C, H))
           : (pad % 4 || S % 4 || Lq % 4 || pad < r - l0
              || pad < l0 + C * H - H - r || S < L + pad || Lq < H + L + l0))
    return (int)cudaErrorInvalidValue;
  const void* fn;
  if constexpr (RING) fn = (const void*)scan_ring_kernel<C, ML>;
  else fn = (const void*)scan_wave_kernel<C, ML>;
  int ctas = 0;
  const int e = held_ctas(fn, threads, smem, ctas);
  if (e != 0) return e;
  const long long held = ctas > 0 ? ctas : 1;
  const long long G = ((N + P - 1) / P + warps - 1) / warps;
  const int qn = chunk_queries(G, Q, qc, held);
  const long long units = G * ((Q + qn - 1) / qn);
  const unsigned grid = (unsigned)(units < held ? units : held);
  if constexpr (RING) {
    scan_ring_kernel<C, ML><<<grid, threads, smem, st>>>(q, x, N, L, r, Q,
                                                        qn, S, keys);
  } else {
    const bool vec = L % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    scan_wave_kernel<C, ML><<<grid, threads,
                              smem - sizeof(float) * (size_t)(qc - qn) * Lq,
                              st>>>(q, x, N, L, r, Q, qn, pad, S, Lq, vec,
                                    keys);
  }
  return (int)cudaGetLastError();
}

// The instance of scan_wave_launch<C, ML, RING> for ml = 2r + 1 - C (H -
// 1) (odd, 1 .. C - 1: 2r + 1 is odd and C even): C / 2 instances a width.
template <int C, bool RING, int ML = 1>
int scan_wave(int ml, const float* q, const float* x, long long N, int L,
              int r, int Q, int threads, int qc, int pad, int S, int Lq,
              unsigned long long* keys, cudaStream_t st) {
  if constexpr (ML < C) {
    if (ml == ML)
      return scan_wave_launch<C, ML, RING>(q, x, N, L, r, Q, threads, qc,
                                           pad, S, Lq, keys, st);
    return scan_wave<C, RING, ML + 2>(ml, q, x, N, L, r, Q, threads, qc, pad,
                                      S, Lq, keys, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
}

// The wave route (L <= kWholeL, C = 16) or the ring route of C cells a
// lane (L > kWholeL, kernels/dtw.py scan_ring_cells) at radius r: C = 16
// here, and 18, 20, 22 or 24 in the build of dtw_ring.cu (which defines
// DTW_SCAN_WIDE_RINGS), so that nvcc compiles the two sets of instances
// at once.
int scan_wave_route(int C, const float* q, const float* x, long long N,
                    int L, int r, int Q, int threads, int qc, int pad, int S,
                    int Lq, unsigned long long* keys, cudaStream_t st) {
  const int H = (2 * r + C) / C;
  if (H > 32 || (L <= kWholeL && C != 16)) return (int)cudaErrorInvalidValue;
  const int ml = 2 * r + 1 - C * (H - 1);
#define DTW_SCAN_RING(W)                                                   \
  case W:                                                                  \
    return scan_wave<W, true>(ml, q, x, N, L, r, Q, threads, qc, pad, S, Lq, \
                              keys, st)
  switch (C) {
#ifdef DTW_SCAN_WIDE_RINGS
    DTW_SCAN_RING(18);
    DTW_SCAN_RING(20);
    DTW_SCAN_RING(22);
    DTW_SCAN_RING(24);
#else
    case 16:
      return L > kWholeL
                 ? scan_wave<16, true>(ml, q, x, N, L, r, Q, threads, qc, pad,
                                       S, Lq, keys, st)
                 : scan_wave<16, false>(ml, q, x, N, L, r, Q, threads, qc,
                                        pad, S, Lq, keys, st);
#endif
    default: return (int)cudaErrorInvalidValue;
  }
#undef DTW_SCAN_RING
}

// dtw_lb_keogh with G query slots: as many blocks as the card holds at
// once (one an SM at 256 threads of about 200 registers), each warp taking
// tasks of 32 x kLbSeries series in turn.
template <int G, int V>
int lb_launch(const float* q, const float* x, long long N, int L, int Qg,
              int r, int j0, int Lc, bool acc_in, float* out,
              cudaStream_t st) {
  const size_t smem = sizeof(float2) * G * (size_t)((Lc + 3) & ~3);
  if (smem > kWaveSmem) return (int)cudaErrorInvalidValue;
  int held = 0;
  const int e = held_ctas((const void*)lb_keogh_kernel<G, V>, kLbThreads,
                          smem, held);
  if (e != 0) return e;
  const long long tasks = (N + 32 * kLbSeries - 1) / (32 * kLbSeries);
  long long blocks = (tasks + kLbThreads / 32 - 1) / (kLbThreads / 32);
  if (blocks > (held > 0 ? held : 1)) blocks = held > 0 ? held : 1;
  lb_keogh_kernel<G, V><<<(unsigned)blocks, kLbThreads, smem, st>>>(
      q, x, N, L, Qg, r, j0, Lc, acc_in, out);
  return (int)cudaGetLastError();
}

template <int V>
int lb_slots(const float* q, const float* x, long long N, int L, int Qg,
             int r, int j0, int Lc, bool acc_in, float* out,
             cudaStream_t st) {
  switch ((Qg + 7) / 8) {
    case 1: return lb_launch<8, V>(q, x, N, L, Qg, r, j0, Lc, acc_in, out, st);
    case 2: return lb_launch<16, V>(q, x, N, L, Qg, r, j0, Lc, acc_in, out,
                                    st);
    case 3: return lb_launch<24, V>(q, x, N, L, Qg, r, j0, Lc, acc_in, out,
                                    st);
    default: return lb_launch<32, V>(q, x, N, L, Qg, r, j0, Lc, acc_in, out,
                                     st);
  }
}

// One case a band radius: dtw_scan's band route's template instances.
#define DTW_BAND_CASES(F, ...) \
  case 0: return F<0>(__VA_ARGS__);   case 1: return F<1>(__VA_ARGS__);   \
  case 2: return F<2>(__VA_ARGS__);   case 3: return F<3>(__VA_ARGS__);   \
  case 4: return F<4>(__VA_ARGS__);   case 5: return F<5>(__VA_ARGS__);   \
  case 6: return F<6>(__VA_ARGS__);   case 7: return F<7>(__VA_ARGS__);   \
  case 8: return F<8>(__VA_ARGS__);   case 9: return F<9>(__VA_ARGS__);   \
  case 10: return F<10>(__VA_ARGS__); case 11: return F<11>(__VA_ARGS__); \
  case 12: return F<12>(__VA_ARGS__); case 13: return F<13>(__VA_ARGS__); \
  case 14: return F<14>(__VA_ARGS__); case 15: return F<15>(__VA_ARGS__); \
  case 16: return F<16>(__VA_ARGS__);

}  // namespace

#ifdef DTW_SCAN_WIDE_RINGS
// dtw_scan's ring route at C = route = 18, 20, 22 or 24 cells a lane (L >
// 1,024; r <= 255), dtw_scan's arguments (`threads`, `qc` and `S` from the
// wrapper's scan_geometry; pad, Lq, the diag route's and diag unused).
extern "C" int dtw_scan_ring(const void* q, const void* x, long long N,
                             int L, int r, int Q, int route, int threads,
                             int qc, int pad, int S, int Lq, int rows,
                             int slots, int width, int chain, int blocks,
                             void* keys, void* diag, void* stream) {
  if (N == 0 || Q == 0) return 0;
  if (r < 0 || L <= kWholeL || N > 0xffffffffll)
    return (int)cudaErrorInvalidValue;
  return scan_wave_route(route, static_cast<const float*>(q),
                         static_cast<const float*>(x), N, L, r, Q, threads,
                         qc, pad, S, Lq,
                         static_cast<unsigned long long*>(keys),
                         static_cast<cudaStream_t>(stream));
}

extern "C" const char* dtw_scan_ring_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
#else
// route: 0 "vec" (L % 4 == 0 and x 16-byte aligned: a 16-byte load a
// series), 1 "scalar" (any L).  q (Qg <= 32, L), x (N, L), out (Qg, N),
// all float32.  One launch sums the columns [j0, j0 + Lc) (j0 a multiple
// of 4), onto the sums out holds where acc_in: the wrapper takes a long
// series in chunks whose 8 Qg (Lc rounded up to 4) floats of envelopes
// fit what a block may ask for (lb_plan), each chunk going on from the
// last one's sums in the same order, so the bits are one pass's.
extern "C" int dtw_lb_keogh(const void* q, const void* x, long long N, int L,
                            int Qg, int r, int route, int j0, int Lc,
                            int acc_in, void* out, void* stream) {
  if (N == 0 || Qg == 0) return 0;
  if (Qg > 32 || L < 1 || r < 0 || route < 0 || route > 1 || j0 < 0
      || j0 % 4 || Lc < 1 || j0 + Lc > L
      || (route == 0 && (L % 4 || reinterpret_cast<uintptr_t>(x) % 16)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qq = static_cast<const float*>(q);
  const float* xx = static_cast<const float*>(x);
  float* o = static_cast<float*>(out);
  return route == 0
             ? lb_slots<4>(qq, xx, N, L, Qg, r, j0, Lc, acc_in != 0, o, st)
             : lb_slots<1>(qq, xx, N, L, Qg, r, j0, Lc, acc_in != 0, o, st);
}

// The refinement of each query g < Qg: candidates order[g, :] (int64)
// with ascending bounds slb[g, :], round_k a round.  Writes bsf (squared),
// best (-1: none taken), rounds and refined, one each a query.  route: 1
// the diag route (any r and round_k: strips of `rows` rows a lane, `slots`
// pairs in flight a query, rows of `width` entries, clusters of `cluster`
// CTAs, diag: Qg queries' scratch, zeroed; kernels/dtw.py
// diag_search_geometry; `threads` unused); 2, 4 and 8 the wave routes of
// as many cells a lane (r <= 31, 63 and 127, round_k <= 1024; `threads`
// from the wrapper's band_threads), their ring forms past L 1,024, and 16
// (ring16: L > 1,024, r <= 255).  The spread route is dtw_search_spread.
extern "C" int dtw_search(const void* q, const void* x, long long N, int L,
                          int r, int Qg, int round_k, int threads, int route,
                          int rows, int slots, int width, int cluster,
                          const void* slb, const void* order, void* bsf,
                          void* best, void* rounds, void* refined,
                          void* diag, void* stream) {
  if (Qg == 0) return 0;
  const bool whole = threads >= 32 && threads <= 1024 && threads % 32 == 0;
  const bool wave = route == 2 || route == 4 || route == 8
                    || (route == 16 && L > kWholeL);
  if (r < 0 || L < 1 || round_k < 1 || (wave && round_k > kMaxRoundK)
      || !(route == 1 || wave) || (wave && !whole) || (route == 1 && !diag))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qq = static_cast<const float*>(q);
  const float* xx = static_cast<const float*>(x);
  const float* lb = static_cast<const float*>(slb);
  const long long* od = static_cast<const long long*>(order);
  float* b = static_cast<float*>(bsf);
  int* bi = static_cast<int*>(best);
  int* ro = static_cast<int*>(rounds);
  int* rf = static_cast<int*>(refined);
  const bool ring = L > kWholeL;
#define DTW_WAVE(C)                                                        \
  return ring ? wave_launch<C, true>(qq, xx, N, L, r, Qg, round_k, threads, \
                                     lb, od, b, bi, ro, rf, st)            \
              : wave_launch<C, false>(qq, xx, N, L, r, Qg, round_k,        \
                                      threads, lb, od, b, bi, ro, rf, st)
  if (route == 2) DTW_WAVE(2);
  if (route == 4) DTW_WAVE(4);
  if (route == 8) DTW_WAVE(8);
#undef DTW_WAVE
  if (route == 16)
    return wave_launch<16, true>(qq, xx, N, L, r, Qg, round_k, threads, lb,
                                 od, b, bi, ro, rf, st);
  DTW_DIAG_ROWS(diag_search_launch, rows, qq, xx, N, L, r, Qg, round_k,
                slots, width, cluster, lb, od, b, bi, ro, rf,
                static_cast<unsigned long long*>(diag), st)
}

// keys (Q,) uint64, each all ones on entry: min over series n of
// (bits of the squared DTW of query g and series n) << 32 | n.  route: 0
// the band route (r <= 16), 2 the diag route (any r: strips of `rows` rows
// a lane, `slots` pairs in flight, rows of `width` entries, chains of
// `chain` strips, `blocks` CTAs, diag: the scratch, zeroed;
// kernels/dtw.py diag_scan_geometry), 16 the wave route of as many cells a
// lane (r <= 255; `threads`, `qc`, `pad`, `S` and `Lq` from the wrapper's
// scan_geometry) and its ring form past L 1,024 (the ring route's wider
// forms are dtw_ring.cu's dtw_scan_ring).  The chain route is
// dtw_scan_chain.
extern "C" int dtw_scan(const void* q, const void* x, long long N, int L,
                        int r, int Q, int route, int threads, int qc,
                        int pad, int S, int Lq, int rows, int slots,
                        int width, int chain, int blocks, void* keys,
                        void* diag, void* stream) {
  if (N == 0 || Q == 0) return 0;
  if (r < 0 || L < 1 || N > 0xffffffffll
      || (route == 0 && (r > 16 || threads != 128))
      || (route == 2 && !diag) || !(route == 0 || route == 2 || route == 16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qq = static_cast<const float*>(q);
  const float* xx = static_cast<const float*>(x);
  unsigned long long* k = static_cast<unsigned long long*>(keys);
  if (route == 0) switch (r) {
    DTW_BAND_CASES(scan_launch, qq, xx, N, L, Q, threads, k, st)
  }
  if (route == 16)
    return scan_wave_route(16, qq, xx, N, L, r, Q, threads, qc, pad, S, Lq,
                           k, st);
  DTW_DIAG_ROWS(diag_scan_launch, rows, qq, xx, N, L, r, Q, slots, width,
                chain, blocks, static_cast<unsigned long long*>(diag), k, st)
}

// dtw_scan's chain route (see dtw_scan's keys): strips of `rows` rows a
// lane, each warp's row of `width` floats (kernels/dtw.py
// chain_scan_geometry).
extern "C" int dtw_scan_chain(const void* q, const void* x, long long N,
                              int L, int r, int Q, int rows, int width,
                              void* keys, void* stream) {
  if (N == 0 || Q == 0) return 0;
  if (r < 0 || L < 1 || N > 0xffffffffll) return (int)cudaErrorInvalidValue;
  DTW_DIAG_ROWS(chain_launch, rows, static_cast<const float*>(q),
                static_cast<const float*>(x), N, L, r, Q, width,
                static_cast<unsigned long long*>(keys),
                static_cast<cudaStream_t>(stream))
}

// dtw_search's spread route (see dtw_search's outputs): strips of `rows`
// rows a lane, `spec` rounds an iteration, `slots` pairs in flight a CTA
// with rows of `width` entries; dist (Qg, 2,
// wdist) float32 and bar (Qg,) 32-bit scratch (kernels/dtw.py
// spread_search_geometry).
extern "C" int dtw_search_spread(const void* q, const void* x, long long N,
                                 int L, int r, int Qg, int round_k, int rows,
                                 int spec, int slots, int width,
                                 const void* slb, const void* order,
                                 void* bsf, void* best, void* rounds,
                                 void* refined, void* dist, long long wdist,
                                 void* bar, void* stream) {
  if (Qg == 0) return 0;
  if (r < 0 || L < 1 || round_k < 1 || slots < 1 || !dist || !bar)
    return (int)cudaErrorInvalidValue;
  DTW_DIAG_ROWS(spread_launch, rows, static_cast<const float*>(q),
                static_cast<const float*>(x), N, L, r, Qg, round_k, spec,
                slots, width, static_cast<const float*>(slb),
                static_cast<const long long*>(order),
                static_cast<float*>(bsf), static_cast<int*>(best),
                static_cast<int*>(rounds), static_cast<int*>(refined),
                static_cast<float*>(dist), wdist,
                static_cast<unsigned*>(bar),
                static_cast<cudaStream_t>(stream))
}

extern "C" const char* dtw_scan_chain_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" const char* dtw_search_spread_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// What the card holds at once of the diag routes' kernels at `rows` rows
// a lane (out: 3 ints, see diag_held), for kernels/dtw.py's diag_grid and
// diag_cluster.
extern "C" int dtw_diag_held(int rows, void* out) {
  DTW_DIAG_ROWS(diag_held, rows, static_cast<int*>(out))
}

extern "C" const char* dtw_diag_held_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" const char* dtw_lb_keogh_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" const char* dtw_search_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" const char* dtw_scan_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
#endif  // DTW_SCAN_WIDE_RINGS
