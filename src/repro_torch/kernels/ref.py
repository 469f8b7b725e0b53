"""Plain PyTorch versions of the CUDA kernels.

Each function computes what its CUDA kernel computes, with ordinary torch
operations.  They are the CPU path of the kernel wrappers and, on the
card, the yardstick each kernel is held against.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core import isax

BIG = 1e30
NEG_INF = -1e30                 # the attention mask, finite as in repro


def summarize_ref(x: torch.Tensor, segments: int = isax.SEGMENTS,
                  bits: int = isax.SAX_BITS, znorm: bool = True
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(z-norm) -> PAA -> iSAX words.  x: (n, L) -> (n, w) f32, (n, w) i32."""
    if znorm:
        x = isax.znormalize(x)
    p = isax.paa(x.float(), segments)
    return p, isax.sax_word(p, bits).to(torch.int32)



def summarize_rows_ref(x: torch.Tensor, segments: int = isax.SEGMENTS,
                       bits: int = isax.SAX_BITS, znorm: bool = True
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                  torch.Tensor]:
    """What the build stores of each row: x (n, L) -> (series (n, L) f32,
    z-normalized if znorm; paa (n, w) f32; words (n, w) i32; |x|^2 (n,))."""
    # a new tensor either way: the index owns what it stores
    x = isax.znormalize(x.float()) if znorm else x.to(torch.float32,
                                                       copy=True)
    p = isax.paa(x, segments)
    return x, p, isax.sax_word(p, bits).to(torch.int32), (x * x).sum(-1)

def lb_distance_ref(q_paa: torch.Tensor, leaf_lo: torch.Tensor,
                    leaf_hi: torch.Tensor,
                    series_len: int = isax.SERIES_LEN) -> torch.Tensor:
    """Squared MINDIST of every query PAA against every leaf region.
    q_paa: (Q, w); leaf_lo/hi: (NL, w) -> (Q, NL) f32."""
    return isax.mindist_region_sq(q_paa[:, None, :], leaf_lo[None],
                                  leaf_hi[None], series_len)


def _bit_length_u8(x: torch.Tensor) -> torch.Tensor:
    """bit_length for uint8 values, elementwise, as int32."""
    x = x.to(torch.int32)
    return sum((x > t).to(torch.int32) for t in (0, 1, 3, 7, 15, 31, 63, 127))


def leaf_regions(lo_sym: torch.Tensor, hi_sym: torch.Tensor,
                 lo_paa: torch.Tensor, hi_paa: torch.Tensor,
                 bound: str = "prefix", bits: int = isax.SAX_BITS):
    """Per-leaf per-segment [lo, hi] region for the chosen bound."""
    if bound == "paabox":
        return lo_paa, hi_paa
    if bound == "symbox":
        lo, _ = isax.symbol_region(lo_sym, bits, bits)
        _, hi = isax.symbol_region(hi_sym, bits, bits)
        return lo, hi
    if bound == "prefix":
        # common prefix depth per segment = bits - bit_length(lo XOR hi)
        depth = bits - _bit_length_u8(torch.bitwise_xor(lo_sym, hi_sym))
        return isax.symbol_region(lo_sym, depth, bits)
    raise ValueError(f"unknown bound {bound!r}")


def leaf_stats_blocks(pw: torch.Tensor, ww: torch.Tensor,
                      vmask: torch.Tensor, *, bits: int, bound: str):
    """Per-leaf summaries from leaf-blocked sorted entries.

    pw: (n_leaves, M, w) PAA, ww: (n_leaves, M, w) symbols, vmask:
    (n_leaves, M, 1) validity.  Returns (leaf_lo, leaf_hi, leaf_valid);
    a fully padded leaf carries the empty region [+inf, +inf].
    """
    inf = torch.tensor(float("inf"), dtype=pw.dtype, device=pw.device)
    wi = ww.to(torch.int32)
    lo_paa = torch.where(vmask, pw, inf).amin(dim=1)
    hi_paa = torch.where(vmask, pw, -inf).amax(dim=1)
    lo_sym = torch.where(vmask, wi, (1 << bits) - 1).amin(dim=1)
    hi_sym = torch.where(vmask, wi, 0).amax(dim=1)
    leaf_valid = vmask[..., 0].any(dim=1)
    lo, hi = leaf_regions(lo_sym.to(torch.uint8), hi_sym.to(torch.uint8),
                          lo_paa, hi_paa, bound, bits)
    lo = torch.where(leaf_valid[:, None], lo, inf)
    hi = torch.where(leaf_valid[:, None], hi, inf)
    return lo, hi, leaf_valid


def leaf_stats_ref(paa: torch.Tensor, words: torch.Tensor,
                   order: torch.Tensor, n: int, leaf_capacity: int,
                   bits: int, bound: str, leaves: Tuple[int, int]):
    """The regions of leaves [l0, l1): `leaf_stats_blocks` over their
    sorted rows, row r < n being source row order[r] of paa and words,
    rows >= n padding (PAA +inf, the top symbol, invalid)."""
    l0, l1 = leaves
    M, w = leaf_capacity, paa.shape[1]
    g = l1 - l0
    r0 = l0 * M
    m = max(0, min(l1 * M, n) - r0)
    pw = paa.new_full((g * M, w), float("inf"))
    ww = words.new_full((g * M, w), (1 << bits) - 1)
    vm = torch.zeros((g * M,), dtype=torch.bool, device=paa.device)
    if m:
        rows = order[r0:r0 + m]
        pw[:m] = paa[rows]
        ww[:m] = words[rows]
        vm[:m] = True
    return leaf_stats_blocks(pw.reshape(g, M, w), ww.reshape(g, M, w),
                             vm.reshape(g, M, 1), bits=bits, bound=bound)


def leaf_gather_ref(order: torch.Tensor, src, out, rows: Tuple[int, int],
                    perm_src: torch.Tensor | None = None):
    """Sorted rows [r0, r1) of out = (series, paa, words, sq_norms, perm)
    from source row order[r] of src = (series, paa, words, sq_norms), in
    place; perm[r] = perm_src[order[r]], or order[r] where perm_src is
    None.  Returns out."""
    r0, r1 = rows
    idx = order[r0:r1]
    for o, s in zip(out, src):
        o[r0:r1] = s[idx]
    out[4][r0:r1] = (idx.to(torch.int32) if perm_src is None
                     else perm_src[idx])
    return out


def ed_argmin_ref(q: torch.Tensor, xs: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-query min squared Euclidean distance and its argmin.

    q: (Q, L); xs: (N, L) -> (Q,) f32 min d^2, (Q,) i32 argmin, in the
    matmul form d^2 = max(|q|^2 + |x|^2 - 2 q.x, 0) in float32.  Ties go
    to the lowest index (`torch.argmin` returns the first minimum).
    """
    q = q.float()
    xs = xs.float()
    d2 = ((q * q).sum(-1)[:, None] + (xs * xs).sum(-1)[None, :]
          - 2.0 * q @ xs.T).clamp_min(0.0)
    i = torch.argmin(d2, dim=1)
    return d2.gather(1, i[:, None])[:, 0], i.to(torch.int32)


def refine_topk_ref(q: torch.Tensor, q_sq: torch.Tensor,
                    series: torch.Tensor, sq_norms: torch.Tensor,
                    leaf_ids: torch.Tensor, alive: torch.Tensor,
                    bsf_d: torch.Tensor, bsf_e: torch.Tensor, *,
                    leaf_capacity: int, k: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One refinement round, materializing form.

    Gathers the (Q, K*M, L) member rows, computes matmul-form squared
    distances in f32, masks dead slots to BIG and folds the candidates
    into the carried (Q, k) buffer.  The fold is a stable ascending sort
    of the union [buffer, candidates], so ties go to the lower union
    index with buffer slots first, as `jax.lax.top_k` orders them.
    """
    Q = q.shape[0]
    M = leaf_capacity
    entry = (leaf_ids.to(torch.int64)[..., None] * M
             + torch.arange(M, device=q.device)).reshape(Q, -1)
    xs = series[entry].float()                               # (Q, K*M, L)
    xn = sq_norms[entry].float()
    dots = torch.einsum("qnl,ql->qn", xs, q.float())
    d2 = (q_sq[:, None] + xn - 2.0 * dots).clamp_min(0.0)
    d2 = torch.where(alive.bool().repeat_interleave(M, dim=1), d2,
                     torch.full_like(d2, BIG))
    alld = torch.cat([bsf_d, d2], dim=1)
    alle = torch.cat([bsf_e, entry.to(torch.int32)], dim=1)
    d, pos = torch.sort(alld, dim=1, stable=True)
    return d[:, :k].contiguous(), torch.gather(alle, 1, pos[:, :k])


def refine_search_ref(q: torch.Tensor, q_sq: torch.Tensor,
                      series: torch.Tensor, sq_norms: torch.Tensor,
                      order: torch.Tensor, sorted_lb: torch.Tensor, *,
                      leaf_capacity: int, k: int, round_leaves: int,
                      inv_eps: float = 1.0,
                      alive_out: torch.Tensor | None = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The whole refinement of a search: the host loop of rounds.

    order/sorted_lb: (Q, cap * K) priority queue, leaf ids ascending in
    lower bound (padding at lb = BIG).  From the empty buffer, each round
    takes the next K slots, keeps those whose lb is below the round-start
    bound, the k-th best times float32(inv_eps) (a float32 product, as
    repro's `bsf_d[:, -1] * inv_eps`; inv_eps 1.0 is the exact search),
    and folds them with `refine_topk_ref`; the loop stops once no query's
    next lb is below its bound, or the queue ends.
    -> (bsf_d, bsf_e, rounds): the (Q, k) buffer and, per query, the
    rounds in which its first slot was alive, i.e. the rounds a loop of
    its own would run.  The batch runs max(rounds) rounds.  `alive_out`,
    a (Q,) int32 tensor if given, receives each query's alive slots.
    """
    Q, K = q.shape[0], round_leaves
    scale = torch.tensor(inv_eps, dtype=torch.float32)
    bsf_d = torch.full((Q, k), BIG, dtype=torch.float32, device=q.device)
    bsf_e = torch.zeros((Q, k), dtype=torch.int32, device=q.device)
    rounds = torch.zeros(Q, dtype=torch.int32, device=q.device)
    n_alive = torch.zeros(Q, dtype=torch.int32, device=q.device)
    cursor = 0
    while cursor < order.shape[1]:
        bound = bsf_d[:, -1:] * scale
        live = sorted_lb[:, cursor] < bound[:, 0]
        if not bool(live.any()):
            break
        alive = sorted_lb[:, cursor:cursor + K] < bound
        bsf_d, bsf_e = refine_topk_ref(
            q, q_sq, series, sq_norms, order[:, cursor:cursor + K], alive,
            bsf_d, bsf_e, leaf_capacity=leaf_capacity, k=k)
        rounds += live.to(torch.int32)
        n_alive += alive.sum(1, dtype=torch.int32)
        cursor += K
    if alive_out is not None:
        alive_out.copy_(n_alive)
    return bsf_d, bsf_e, rounds


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int = 0
                        ) -> torch.Tensor:
    """Plain softmax attention.  q: (B, Hq, T, dh); k/v: (B, Hkv, S, dh)
    -> (B, Hq, T, dh) in q's dtype; query head h reads KV head
    h // (Hq // Hkv).  Scores are scaled by dh^-0.5 and masked to the
    finite NEG_INF, so a row that sees no key gets the mean of V over all
    S keys."""
    B, Hq, T, dh = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qf = q.reshape(B, Hkv, G, T, dh).float()
    s = torch.einsum("bkgtd,bksd->bkgts", qf, k.float()) * (dh ** -0.5)
    qpos = torch.arange(T, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((T, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window:
        mask &= kpos > qpos - window
    s = s.masked_fill(~mask, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgts,bksd->bkgtd", w, v.float())
    return o.reshape(B, Hq, T, dh).to(q.dtype)


# ---------------------------------------------------------------- DTW
# The plain versions of csrc/dtw.cu.  repro's DTW (src/repro/core/dtw.py)
# is plain jnp; these repeat its arithmetic cell for cell: d = (q[i] -
# x[c])^2, then d + min(diag, up, left), BIG for a cell outside the band,
# row 0 a running sum from column 0.  min is exact, so the order of the
# three makes no difference to the bits.


def dtw_envelope(q: torch.Tensor, r: int) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """Rolling min / max of q within +-r along the last axis (the
    Sakoe-Chiba envelope).  q: (..., L) -> (lower, upper) each (..., L)."""
    W = 2 * r + 1
    lo = torch.nn.functional.pad(q, (r, r), value=float("inf"))
    hi = torch.nn.functional.pad(q, (r, r), value=float("-inf"))
    return (lo.unfold(-1, W, 1).amin(dim=-1),
            hi.unfold(-1, W, 1).amax(dim=-1))


def lb_keogh_ref(q: torch.Tensor, x: torch.Tensor, r: int) -> torch.Tensor:
    """Squared LB_Keogh of each of the Qg queries q (Qg, L) against each
    of the N series x (N, L), band radius r: (Qg, N) float32.  Each
    point's excursion e outside the query's envelope (at most one of
    x - upper and lower - x is positive) adds e^2."""
    lo, hi = dtw_envelope(q, r)
    out = torch.empty((q.shape[0], x.shape[0]), dtype=torch.float32,
                      device=x.device)
    for g in range(q.shape[0]):
        e = torch.maximum(x - hi[g], lo[g] - x).clamp_min(0.0)
        out[g] = (e * e).sum(dim=-1)
    return out


def dtw_band_ref(q: torch.Tensor, x: torch.Tensor, r: int) -> torch.Tensor:
    """Squared banded-DTW distance of each pair of rows of q and x
    (broadcast against each other; (..., L) -> (...,) float32).

    Cell (i, k) of the band is column j = i - r + k.  It reads (i-1, k+1)
    (up), (i-1, k) (diag) and (i, k-1) (left), so every cell of one
    wavefront t = 2i + k depends only on the wavefronts t-1 and t-2: each
    step forms one wavefront's cells at once, each as d + min(diag, up,
    left), the cell (0, 0) as d, the others of row 0 as d + left (their
    diag and up lie outside the band: BIG).  Wavefront t keeps the cells
    of its parity of k, BIG elsewhere."""
    q, x = torch.broadcast_tensors(q, x)
    lead, L = q.shape[:-1], q.shape[-1]
    q = q.reshape(-1, L)
    x = x.reshape(-1, L)
    W = 2 * r + 1
    big = torch.full((q.shape[0], 1), BIG, dtype=torch.float32,
                     device=q.device)
    prev2 = prev1 = big.expand(-1, W).contiguous()
    for t in range(2 * (L - 1) + r + 1):
        # k of t's parity with i = (t - k) / 2 and j = (t + k) / 2 - r
        # in [0, L): one run of every other k
        k0 = max(t % 2, t - 2 * (L - 1), 2 * r - t)
        k1 = min(W - 1, t, 2 * (L - 1) + 2 * r - t)
        if (k0 - t) % 2:
            k0 += 1
        cur = big.expand(-1, W).clone()
        if k0 <= k1:
            ks = torch.arange(k0, k1 + 1, 2, device=q.device)
            i = (t - ks) // 2
            diff = q[:, i] - x[:, i - r + ks]
            d = diff * diff
            padded = torch.cat([big, prev1, big], dim=1)
            up, left = padded[:, ks + 2], padded[:, ks]
            v = d + torch.minimum(torch.minimum(prev2[:, ks], up), left)
            if t == r:                     # cell (0, 0): k = r
                v[:, (r - k0) // 2] = d[:, (r - k0) // 2]
            cur[:, ks] = v
        prev2, prev1 = prev1, cur
    return prev1[:, r].reshape(lead)


def dtw_search_ref(q: torch.Tensor, x: torch.Tensor,
                   sorted_lb: torch.Tensor, order: torch.Tensor, r: int,
                   round_k: int, max_pairs: int = 1 << 16
                   ) -> Tuple[torch.Tensor, ...]:
    """The refinement of a DTW 1-NN search (repro's `search_dtw` loop) for
    each query of q (Qg, L) over x (N, L): candidates in the order of
    `order` (Qg, N) int64, whose lower bounds `sorted_lb` (Qg, N) are
    ascending, `round_k` a round.  In a round, a candidate whose bound is
    >= the best-so-far at the round's start counts as BIG; the round's
    first minimum replaces the best-so-far when strictly smaller.  Stop
    at the padded end or when the next round's first bound is >= the
    best-so-far.  Returns (bsf (Qg,) float32 squared, best (Qg,) int32,
    -1 where no candidate was taken, rounds (Qg,) int32, refined (Qg,)
    int32: the candidates whose DTW was computed).

    The distances come from `dtw_band_ref` a chunk of rounds at a time,
    every candidate of the chunk and every query still running in one
    call (the chunk doubles while a query runs on, up to `max_pairs`
    pairs a call), and the rounds then run on the host over them; a
    candidate the rule prunes counts as BIG whatever its distance, so
    computing it changes nothing but the time."""
    Qg, N = sorted_lb.shape
    n_rounds = -(-N // round_k)
    big = np.float32(BIG)
    bsf = np.full(Qg, big, np.float32)
    best = np.full(Qg, -1, np.int64)
    rounds = np.zeros(Qg, np.int64)
    refined = np.zeros(Qg, np.int64)
    first = sorted_lb[:, 0].cpu().numpy() if N else np.zeros(Qg)
    running = [g for g in range(Qg) if n_rounds and first[g] < big]
    span = 1
    while running:
        span = max(1, min(span, max_pairs // (len(running) * round_k)))
        parts = []
        for g in running:
            a = int(rounds[g]) * round_k
            parts.append((g, a, min(N, a + span * round_k)))
        sel = torch.cat([order[g, a:b] for g, a, b in parts])
        qi = torch.cat([torch.full((b - a,), g, dtype=torch.int64,
                                   device=x.device) for g, a, b in parts])
        dist = dtw_band_ref(q[qi], x[sel], r).cpu().numpy()
        lbs = torch.cat([sorted_lb[g, a:b] for g, a, b in parts]
                        ).cpu().numpy()
        ids = sel.cpu().numpy()
        at, still = 0, []
        for g, a, b in parts:
            stopped = False
            for c in range(a, b, round_k):
                j = at + c - a
                if c > a and not lbs[j] < bsf[g]:
                    stopped = True
                    break
                e = j + min(round_k, b - c)
                take = lbs[j:e] < bsf[g]
                d = np.where(take, dist[j:e], big)
                k = int(np.argmin(d))
                if d[k] < bsf[g]:
                    bsf[g], best[g] = d[k], ids[j + k]
                rounds[g] += 1
                refined[g] += int(take.sum())
            at += b - a
            if not stopped and rounds[g] < n_rounds and np.float32(
                    sorted_lb[g, b].item()) < bsf[g]:
                still.append(g)
        running, span = still, 2 * span
    dev = x.device
    return (torch.as_tensor(bsf, device=dev),
            torch.as_tensor(best.astype(np.int32), device=dev),
            torch.as_tensor(rounds.astype(np.int32), device=dev),
            torch.as_tensor(refined.astype(np.int32), device=dev))


def dtw_scan_ref(q: torch.Tensor, x: torch.Tensor,
                 r: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Banded DTW of each query of q (Q, L) against every series of x
    (N >= 1, L): (the least squared distance (Q,) float32, its series
    (Q,) int32, the first on ties)."""
    d = torch.stack([dtw_band_ref(q[g], x, r) for g in range(q.shape[0])])
    i = torch.argmin(d, dim=1)
    return d.gather(1, i[:, None])[:, 0], i.to(torch.int32)
