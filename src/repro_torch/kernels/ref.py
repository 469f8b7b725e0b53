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


def select_merge_fold(bd: torch.Tensor, be: torch.Tensor,
                      cd: torch.Tensor, ce: torch.Tensor, k: int, *,
                      leaf_capacity: int = 1, runs: int = 1,
                      slices: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """refine_search's fold, step by step as its kernel takes it.

    bd / be: (Q, k) ascending buffer; cd / ce: (Q, n) candidates in union
    (slot, row) order.  The candidates below the k-th best are cut into
    `runs` runs as a cluster's CTAs hold them (slot j of leaf_capacity
    rows on CTA j mod runs); each run is sorted by (d, union index), -0.0
    equal to +0.0, and keeps its first k; the runs merge into one sorted
    list, of which the first k remain.  Then the merge ranks: buffer slot
    i goes to i + #{candidates below it}, the s-th candidate to s +
    #{buffer slots at or below it}, each computed as the CTA that holds
    the buffer's slice (`slices` slices of ceil(k / slices) slots) computes
    it; ranks below k are written.  The ranks are those of the rank rule
    (ties to the lower union index, buffer slots first), so the result is
    `refine_topk_ref`'s fold bit for bit, whatever runs and slices.
    """
    Q, n = cd.shape
    out_d = torch.full((Q, k), float("nan"), dtype=torch.float32)
    out_e = torch.full((Q, k), -1, dtype=torch.int32)
    u_all = torch.arange(n)
    run_of = (u_all // leaf_capacity) % runs
    S = -(-k // slices)
    for i in range(Q):
        b, e, d_all = bd[i].cpu(), be[i].cpu(), cd[i].cpu()
        ok = d_all < b[-1]
        kept = []
        for c in range(runs):
            u = ((run_of == c) & ok).nonzero()[:, 0]
            kept.append(u[torch.sort(d_all[u], stable=True).indices][:k])
        u = torch.cat(kept).sort().values
        u = u[torch.sort(d_all[u], stable=True).indices][:k]
        d = d_all[u]
        first = [b[c * S] if c * S < k else torch.tensor(float("inf"))
                 for c in range(slices)]
        for c in range(slices):
            i0, nb = c * S, max(0, min(S, k - c * S))
            bs = b[i0:i0 + nb]
            p = i0 + torch.arange(nb) + torch.searchsorted(d, bs)
            w = p < k
            out_d[i, p[w]], out_e[i, p[w]] = bs[w], e[i0:i0 + nb][w]
            mine = torch.ones(len(d), dtype=torch.bool)
            if c > 0:
                mine &= first[c] <= d
            if c + 1 < slices:
                mine &= ~(first[c + 1] <= d)
            s = mine.nonzero()[:, 0]
            p = s + i0 + torch.searchsorted(bs, d[s], right=True)
            w = p < k
            out_d[i, p[w]] = d[s[w]]
            out_e[i, p[w]] = ce[i].cpu()[u[s[w]]]
    return out_d.to(bd.device), out_e.to(bd.device)


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
    of its parity of k, BIG elsewhere.  A wavefront's cells are every
    other k of one run, whose rows i fall and columns j rise by one a
    cell: strided views of three rows of W + 2 values (BIG at both ends),
    of x and of q reversed, so a step is a few element-wise operations."""
    q, x = torch.broadcast_tensors(q, x)
    lead, L = q.shape[:-1], q.shape[-1]
    q = q.reshape(-1, L)
    x = x.reshape(-1, L)
    qr = q.flip(1)                         # qr[:, L - 1 - i] = q[:, i]
    W = 2 * r + 1
    # wavefronts t - 2, t - 1 and t, offset k at index k + 1
    rows = [torch.full((q.shape[0], W + 2), BIG, dtype=torch.float32,
                       device=q.device) for _ in range(3)]
    for t in range(2 * (L - 1) + r + 1):
        # k of t's parity with i = (t - k) / 2 and j = (t + k) / 2 - r
        # in [0, L): one run of every other k
        k0 = max(t % 2, t - 2 * (L - 1), 2 * r - t)
        k1 = min(W - 1, t, 2 * (L - 1) + 2 * r - t)
        if (k0 - t) % 2:
            k0 += 1
        prev2, prev1, cur = rows
        cur.fill_(BIG)
        if k0 <= k1:
            n = (k1 - k0) // 2 + 1
            a = L - 1 - (t - k0) // 2      # q's rows i from (t - k0) / 2 down
            j0 = (t + k0) // 2 - r         # x's columns from j0 up
            diff = qr[:, a:a + n] - x[:, j0:j0 + n]
            d = diff * diff
            ks = slice(k0 + 1, k1 + 2, 2)
            up, left = prev1[:, k0 + 2:k1 + 3:2], prev1[:, k0:k1 + 1:2]
            v = d + torch.minimum(torch.minimum(prev2[:, ks], up), left)
            if t == r:                     # cell (0, 0): k = r
                v[:, (r - k0) // 2] = d[:, (r - k0) // 2]
            cur[:, ks] = v
        rows = [prev1, cur, prev2]
    return rows[1][:, r + 1].reshape(lead)


def dtw_wavefront_ref(q: torch.Tensor, x: torch.Tensor, r: int,
                      cells: int = 2, step_least: bool = False,
                      check: bool = True):
    """`dtw_band_ref` in the order of dtw_search's wavefront routes
    (csrc/dtw.cu: dtw_wave, cells 2, and dtw_wave_wide, cells 2, 4 or 8),
    for the tests.  Lane l of a pair (l < H = ceil((2r + 1) / cells))
    holds band offsets cells * l + m, m < cells, and step s forms row s -
    l's cells in order of m: cell 0 reads lane l - 1's last cell of step
    s - 1 as its left, and the last cell reads lane l + 1's cell 0 of step
    s as its up, as the kernel's two shuffles do.  A cell outside the band
    or the matrix gets d = BIG (its value BIG or more), and cell (0, 0) a
    diag of 0.  Steps run to L - 1 + r // cells, where cell (L - 1, r)
    forms.  Asserts that each operand of a cell inside is the cell it
    should be (diag (i-1, k), up (i-1, k+1), left (i, k-1)) and was formed
    at an earlier wavefront (2i + k).  Pairs broadcast as in
    `dtw_band_ref`; returns (...,) float32, and with `step_least` also
    (..., steps) float32: each step's least cell inside the band and the
    matrix (BIG where it forms none), which the wide routes' early
    abandoning compares with the best-so-far.  The lane bookkeeping and
    its asserts stay on the CPU; the cells are formed on q's device.
    `check=False` skips the bookkeeping and its asserts (they depend on L,
    r and cells alone; the tests run them), for a long series on the
    card, where each assert is a read of the device."""
    q, x = torch.broadcast_tensors(q, x)
    lead, L = q.shape[:-1], q.shape[-1]
    q = q.reshape(-1, L).float()
    x = x.reshape(-1, L).float()
    C, B, dev = cells, q.shape[0], q.device
    H = -(-(2 * r + 1) // C)
    l0, m0 = r // C, r % C                 # where offset r lives
    ll = torch.arange(H)
    big = torch.full((B, 1), BIG, dtype=torch.float32, device=dev)

    def cell(row, k):                      # (2, H): each lane's cell
        return torch.stack([row, k])
    none = torch.tensor([[-L - r - 9], [0]])     # a lane outside the pair
    v = [big.expand(-1, H).clone() for _ in range(C)]
    at = [cell(-1 - ll, C * ll + m) for m in range(C)]
    res = big[:, 0].clone()
    least = torch.full((B, L + l0), BIG, dtype=torch.float32, device=dev)
    for s in range(L + l0):
        i, c0 = s - ll, s + (C - 1) * ll - r
        row = (i >= 0) & (i < L)
        qi = q[:, i.clamp(0, L - 1).to(dev)]
        first = (i == 0) & (ll == l0)
        nv, nat = [], []
        for m in range(C):
            k, c = C * ll + m, c0 + m
            inside = row & (k <= 2 * r) & (c >= 0) & (c < L)
            on = inside.to(dev)
            d = torch.where(on, (qi - x[:, c.clamp(0, L - 1).to(dev)]) ** 2,
                            BIG)
            diag = torch.where((first & (m == m0)).to(dev), 0.0, v[m])
            if m + 1 < C:
                up = v[m + 1]
            else:                          # lane l + 1's cell 0, this step
                up = torch.cat([nv[0][:, 1:], big], dim=1)
            if m == 0:                     # lane l - 1's last, step s - 1
                left = torch.cat([big, v[C - 1][:, :-1]], dim=1)
            else:
                left = nv[m - 1]
            if check:
                up_at = at[m + 1] if m + 1 < C else torch.cat(
                    [nat[0][:, 1:], none], dim=1)
                left_at = torch.cat([none, at[C - 1][:, :-1]], dim=1) \
                    if m == 0 else nat[m - 1]
                t = 2 * i + k
                for held, want, lanes in (
                        (at[m], cell(i - 1, k),
                         inside & ~(first & (m == m0))),
                        (up_at, cell(i - 1, k + 1), inside),
                        (left_at, cell(i, k - 1), inside & (k > 0))):
                    assert bool((held == want)[:, lanes].all()), (s, m)
                    assert bool((2 * held[0] + held[1] < t)[lanes].all()), \
                        (s, m)
                nat.append(cell(i, k))
            nv.append(d + torch.minimum(torch.minimum(diag, up), left))
            least[:, s] = torch.minimum(least[:, s], torch.where(
                on, nv[m], BIG).amin(dim=1))
        if int(i[l0]) == L - 1:
            res = nv[m0][:, l0].clone()
        v, at = nv, nat
    if step_least:
        return res.reshape(lead), least.reshape(*lead, L + l0)
    return res.reshape(lead)


class StripRow:
    """The row a pair's strips hand on (csrc/dtw.cu strip_dp), for the
    strip model: `width` entries, each a float a pair (`val`, (B, width))
    and the tag of the strip that wrote it (`tag`: the kernel's tagged
    entries; for the chain route's plain floats, the model's own record of
    the writer, which the kernel does not keep)."""

    def __init__(self, B: int, width: int):
        self.val = np.zeros((B, width), np.float32)
        self.tag = np.zeros(width, np.int64)


def dtw_strip_steps(qn, xn, r: int, rows: int, s: int, row: StripRow,
                    res, counts: dict | None = None, base: int = 0,
                    hand: str = "tag"):
    """Strip s's program (csrc/dtw.cu strip_dp) on the pairs qn, xn (B, L)
    numpy float32, a chunk at a time: a generator that yields, before the
    strip's first read of the row and before each chunk, the row's entries
    it then needs (offsets into `row`, each to carry the tag base + s, the
    strip above's), and runs once resumed; res (B,) receives cell (L - 1,
    L - 1) from the lane of row L - 1.  The strip stores its last row's
    columns at column - lo with tag base + s + 1.  `hand`: "tag" (the diag
    and spread routes: a chunk's entries are read when it starts, the
    next chunk's loaded ahead and read again there if not yet in) or "warp"
    (the chain route: one warp runs the strips in order and reads each
    entry once, the next chunk's ahead, asserting it then carries the tag:
    no entry is overwritten unread)."""
    B, L = qn.shape
    K = rows
    S = 32 * K
    strips, width = -(-L // S), row.tag.shape[0]
    big, poison = np.float32(BIG), np.float32(1e20)
    lane = np.arange(32)
    want = base + s                              # the strip above's tag

    def span(s0):
        return max(0, s0 - r), min(L - 1, s0 + S - 1 + r)
    s0 = s * S
    lo, hi = span(s0)
    ilo, ihi = span(s0 - S)
    i = s0 + K * lane[:, None] + np.arange(K)             # (32, K)
    qv = np.where(i < L, qn[:, np.minimum(i, L - 1)], poison)
    v = np.full((B, 32, K), big, np.float32)
    la = L - 1 - i[:, 0]                 # row L - 1's place on its lane

    def inr(c):
        c = np.asarray(c)
        return (s > 0) & (c >= ilo) & (c <= ihi)

    def read(c):                         # the row above at columns c
        c = np.asarray(c)
        o = np.clip(c - ilo, 0, width - 1)
        assert (row.tag[o][inr(c)] == want).all(), (s, c)
        return np.where(inr(c), row.val[:, o], big)
    dprev = np.full((B, 32), big, np.float32)
    if s == 0:
        dprev[:, 0] = 0.0
    elif ilo <= lo - 1 <= ihi:
        yield [lo - 1 - ilo]
        dprev[:, 0] = read([lo - 1])[:, 0]
    jend = hi + 31
    jres = L - 1 + (L - 1 - s0) // K if s0 + S >= L else -1
    ahead = None                         # ("warp") this chunk's row, read
    for j0 in range(lo, jend + 1, 32):
        cj = j0 + lane
        need = [int(c) - ilo for c in cj[inr(cj)]]
        if need:
            yield need
        if hand == "warp" and s > 0:
            upc = ahead if ahead is not None else read(cj)
            ahead = read(cj + 32)    # loaded ahead, used as read
        else:
            upc = read(cj)
        cols = j0 >= 31 and j0 + 31 <= L - 1
        inner = (cols and s0 + S <= L and s0 + S + 30 - j0 <= r
                 and j0 + 31 - s0 <= r)
        plain = inner or (cols and not j0 <= jres <= j0 + 31
                          and (s + 1 == strips
                               or (j0 - 31 >= lo and j0 <= hi)))
        if counts is not None:
            kind = "inner" if inner else "plain" if plain else "rare"
            counts[kind] = counts.get(kind, 0) + 1
        for u in range(32):
            c = j0 + u - lane
            if plain:
                assert c.min() >= 0 and c.max() < L
                xc = xn[:, c]
            else:
                xc = np.where((c >= 0) & (c < L),
                              xn[:, np.clip(c, 0, L - 1)], -poison)
            up = np.concatenate([upc[:, u:u + 1], v[:, :-1, K - 1]],
                                axis=1)
            diag, dprev = dprev, up
            e = i[:, 0] + r - c
            for a in range(K):
                d = qv[:, :, a] - xc
                d = d * d
                nv = d + np.minimum(np.minimum(diag, v[:, :, a]), up)
                inside = (e + a >= 0) & (e + a <= 2 * r)
                if inner:
                    assert inside.all()
                else:
                    nv = np.where(inside, nv, big)
                diag, up = v[:, :, a].copy(), nv
                v[:, :, a] = nv
            hit = (c == L - 1) & (la >= 0) & (la < K)
            assert not (plain and hit.any())
            for ln in np.nonzero(hit)[0]:
                res[:] = v[:, ln, la[ln]]
            cw = j0 + u - 31              # lane 31's column
            # a chunk without tests (plain) stores every step's column
            assert not (plain and s + 1 < strips) or lo <= cw <= hi
            if s + 1 < strips and lo <= cw <= hi:
                assert 0 <= cw - lo < width
                row.val[:, cw - lo] = v[:, 31, K - 1]
                row.tag[cw - lo] = want + 1


def dtw_strip_ref(q: torch.Tensor, x: torch.Tensor, r: int,
                  rows: int = 4, counts: dict | None = None,
                  hand: str = "tag", rng=None, row: StripRow | None = None,
                  base: int = 0) -> torch.Tensor:
    """`dtw_band_ref` in the order of the strip program of the diag, chain
    and spread routes (csrc/dtw.cu strip_dp), for the tests: K = `rows`
    rows a lane on the 32 lanes of a warp, strips of S = 32 K rows.  Strip
    s (rows s S ..) spans the columns lo = max(0, s S - r) .. hi = min(L -
    1, s S + S - 1 + r) and runs steps j = lo .. in whole chunks of 32 (j0,
    j0 + 32, .. to hi + 31, the last one past it, its cells past the band):
    at step j lane l is at column j - l and forms its rows top to bottom,
    the first from lane l - 1's last row of the step before (lane 0: the
    strip above's last row, read a chunk at a time), each row's diagonal
    the up of the step before.  A chunk whose cells all lie inside the
    band and the matrix (`inner`) is formed without tests and asserts that
    they do; elsewhere a cell outside the band is BIG and a row or column
    outside the matrix reads the kernel's poisoned values (+1e20 for the
    query, -1e20 for the series); a chunk the kernel runs without the
    column, result and store tests (`plain`) asserts that none would
    fire, and stores only columns lo .. hi.  Lane 31 stores its last row's
    columns lo .. hi into the pair's row at column - lo, each entry with
    the strip's tag (base + s + 1), over the strip above's, and nothing
    past hi (where the strip below starts at the same column, those
    entries are its own).  The strip below reads the strip above's entries
    at column - its lo, asserting every entry it reads carries that
    strip's tag: the offsets are the kernel's (dtw_strip_steps).  The
    strips run one after another (`rng` None: the diag route's chains and
    the chain route's warp, `hand` "warp" for the latter's plain floats)
    or, with `rng` (a numpy Generator), as the strips of a pair on many
    warps: each chunk of a random strip among those whose entries carry
    the tags they need (asserting that no order deadlocks).  `row`, `base`:
    a row already used, and the tags of the pairs it held before (a slot's
    next pair).  Pairs broadcast as in `dtw_band_ref`; returns (...,)
    float32; `counts`, a dict, adds up the chunks of each kind ("inner",
    "plain", "rare").  Runs on the CPU (numpy)."""
    q, x = torch.broadcast_tensors(q, x)
    lead, L = q.shape[:-1], q.shape[-1]
    qn = q.reshape(-1, L).float().cpu().numpy()
    xn = x.reshape(-1, L).float().cpu().numpy()
    B, S = qn.shape[0], 32 * rows
    strips = -(-L // S)
    if row is None:
        row = StripRow(B, min(L, 2 * r + S))
    res = np.full(B, np.float32(BIG), np.float32)
    runs = [dtw_strip_steps(qn, xn, r, rows, s, row, res, counts, base,
                            hand) for s in range(strips)]
    with np.errstate(over="ignore"):     # the poisoned cells overflow
        if rng is None:
            for s, run in enumerate(runs):
                for need in run:
                    assert (row.tag[need] == base + s).all(), (s, need)
            return torch.as_tensor(res).reshape(lead)
        wants = [next(run, None) for run in runs]   # each strip's next reads
        live = list(range(strips))
        while live:
            ready = [s for s in live if wants[s] is None
                     or (row.tag[wants[s]] == base + s).all()]
            assert ready, "no strip can go on: the hand-over deadlocks"
            s = ready[rng.integers(len(ready))]
            if wants[s] is None:
                live.remove(s)
                continue
            wants[s] = next(runs[s], None)
    return torch.as_tensor(res).reshape(lead)


def dtw_search_ref(q: torch.Tensor, x: torch.Tensor,
                   sorted_lb: torch.Tensor, order: torch.Tensor, r: int,
                   round_k: int, max_pairs: int = 1 << 16,
                   trace: list | None = None,
                   d_pairs: torch.Tensor | None = None
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
    computing it changes nothing but the time.  `d_pairs` (Qg, N): every
    pair's dtw_band_ref distance where the caller has it (series by id),
    read in place of those calls.

    `trace`, a list, receives for each query (the position in the sorted
    order where each of its rounds starts (int64), the best-so-far at
    that start (float32)), as numpy arrays: a round refines its
    candidates whose bound lies below that best-so-far."""
    Qg, N = sorted_lb.shape
    n_rounds = -(-N // round_k)
    big = np.float32(BIG)
    bsf = np.full(Qg, big, np.float32)
    best = np.full(Qg, -1, np.int64)
    rounds = np.zeros(Qg, np.int64)
    refined = np.zeros(Qg, np.int64)
    first = sorted_lb[:, 0].cpu().numpy() if N else np.zeros(Qg)
    starts = [[] for _ in range(Qg)]
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
        dist = (dtw_band_ref(q[qi], x[sel], r) if d_pairs is None
                else d_pairs[qi, sel]).cpu().numpy()
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
                starts[g].append((c, bsf[g]))
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
    if trace is not None:
        trace += [(np.array([c for c, _ in st], np.int64),
                   np.array([b for _, b in st], np.float32))
                  for st in starts]
    dev = x.device
    return (torch.as_tensor(bsf, device=dev),
            torch.as_tensor(best.astype(np.int32), device=dev),
            torch.as_tensor(rounds.astype(np.int32), device=dev),
            torch.as_tensor(refined.astype(np.int32), device=dev))


def dtw_scan_ref(q: torch.Tensor, x: torch.Tensor, r: int,
                 d_pairs: torch.Tensor | None = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Banded DTW of each query of q (Q, L) against every series of x
    (N >= 1, L): (the least squared distance (Q,) float32, its series
    (Q,) int32, the first on ties).  The queries go through dtw_band_ref
    as many at once as keep a call to 2^16 pairs (one at least): each
    pair's cells are the same operations whatever the call.  `d_pairs`
    (Q, N): those distances where the caller has them."""
    step = max(1, (1 << 16) // x.shape[0])
    d = d_pairs if d_pairs is not None else torch.cat(
        [dtw_band_ref(q[g:g + step, None], x[None], r)
         for g in range(0, q.shape[0], step)]
        or [x.new_empty((0, x.shape[0]))])
    i = torch.argmin(d, dim=1)
    return d.gather(1, i[:, None])[:, 0], i.to(torch.int32)
