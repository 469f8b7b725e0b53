#!/usr/bin/env python3
"""Drive repro_torch's kernel paths on one NVIDIA GPU.

    python3 chip_smoke.py [--series N] [--seed S] [--only dtw|dtw_wide]

`--only dtw` runs the device, build, dtw and dtw_wide phases alone
(`--only dtw_wide` the last alone), then the kernel table (their rows),
the nvidia-smi line and the device line.

Phases, each printing one JSON line:
  device     nvidia-smi's name and power limit, torch's device name;
  build      nvcc builds of the eight kernel sources under
             src/repro_torch/kernels/csrc;
  ptxas      the registers, spills and wgmma warnings ptxas reports for
             the attention instances at dh 96 and 256 (tc96 and tc256 in
             bf16, tf256 in TF32), and the registers and spills of every
             dtw_scan ring instance (16 to 24 cells a lane), of the strip
             instances (scan_strips, search_strips, scan_chain and
             search_spread at 4 and 8 rows a lane), of dtw_search's ring
             instances (search_ring, 2 to 16 cells a lane) and of
             LB_Keogh's past L 1,024 (lb_envelope, lb_long at 8, 16 and 32
             query slots), each required to spill nothing;
  kernel     each CUDA kernel against its plain PyTorch version on the card,
             at its path's shapes, with its time, the plain version's time,
             a PyTorch library call's time where one computes the same
             function, and the least time the card could take (the bound);
             then the tensor-core routes at their edges (ragged and empty
             attention rows, dh 64 and 32, a ragged scan), drawn from a
             generator of their own so that the main phase's inputs stay
             what the seed alone makes them;
             refine_topk (one round) is held at K 8, 6, 12 and 264,
             leaves of 16, 32 and 64, f32 and bf16, alive shares 0, 0.05
             (the sharded search's late rounds) and 0.5, bit for bit to the
             same round folded slot by slot and within tolerance to its
             plain version, and timed at the table's shape with half and
             a twentieth of the slots alive, and with every slot alive,
             where repro's roofline_fraction (launch/roofline.py) of the
             launch is printed beside its half-alive row;
             refine_search (the whole refinement of a search in one
             launch) is held against refine_search_ref on a real index of
             2^18 walks drawn from that generator, in f32 and bf16, and on
             2^16 walks at other leaf sizes and K (its cluster cut to 1, 2
             and 4 CTAs, and K = 264 slots a round above 256 threads);
             lb_distance's tiled route is held bit for bit to its looped
             one; the port-side kernels leaf_stats (the build's per-leaf
             regions) and leaf_gather (the builder's materialize pass) are
             held bit for bit to their plain versions, on real sorted
             summaries at three bounds and 8 and 4 bits, and through the
             IndexBuilder at 4 workers against the one-pass build at three
             bounds in float32 and bfloat16 storage, and leaf_gather's
             own device time a launch of a part (2048 rows, the
             profiler) beside that part's bound; flash_attention at every
             head width past the old set (96, 256, 40, 80, 320) and at
             B * Hq 65,600;
  grid       the kernels whose grid's y dimension takes query tiles, past
             65,535 tiles (grid_strides);
  main       FreshIndex.build over N random walks of length 256 made on the
             card (default 2^24, 16 GiB of float32), then exact 10-NN of 256
             noisy collection series (sigma 0.1, the paper's hardest Fig. 6a
             workload), held against a chunked brute-force scan; then the
             refinement of the same queries alone: each query's rounds and
             alive slots, the search's bound (the bytes of the distinct
             leaves alive for any query, over the memory rate) beside the
             bytes the queries read one by one, refine_search's time, on
             its longest query alone too, and its plain version at this
             size; the deprecated free function core.search on the same
             queries, byte-equal to FreshIndex.search;
  route      each kernel's other routes (the ones a shape takes where the
             fast route does not fit) against their plain versions:
             summarize strided at L 96 / w 16 (f32, bf16) and L 100 / w 10,
             lb_distance looped at w 32 and 10, refine_topk general at bf16
             L 100 and at k 16,000 (each bit-equal to its round folded
             slot by slot), refine_search at k 5000 (2 CTAs an SM),
             at leaves of 256 and K 64 (1 CTA an SM), at k 20,000 and bf16
             L 100 (general), ed_argmin at L 100 f32 (TMA), L 100 bf16
             and L 235 f32 (the staged loader), each beside one torch.mm
             at its shape, the staged loader bit-equal to TMA at L 256
             and L 100 and held at odd rows and bases; flash_attention's
             routes beside granite's (ATTN_ROWS: tc96, tc256, tc320,
             tc512, simt96, tf256, staged128 at dh 100 beside its TMA
             twin tc128 at dh 104 (T 1024, and on granite's heads at T
             4096), simt320, wide at dh 576, each by
             device time with SDPA's time and excess beside it); one
             table row each;
  rounds     ops.refine_topk, repro's per-round kernel API, driven through
             the global loop of rounds over the main cell's queue (the
             search before refine_search), held bit for bit against
             refine_search's buffers and rounds;
  scan       ops.ed_argmin of the same z-normalized queries over the whole
             stored collection (the exact 1-NN scan, 16 GiB read), held
             against the search's nearest neighbour;
  approx     the main cell's index searched approximately: mode="exact"
             and the EXACT rule byte-equal to the main answer; six rules
             (max_leaves 1024, eps 0.1, eps 0.5, eps 0.1 with max_leaves
             8192, pq_budget 4096, max_rounds 64), each with its search ms,
             rounds, recall@10 against the exact ids and refine_search's
             launches by route, every reported distance its id's own, and
             the refinement under the rule held to refine_search_ref (all
             queries for a capped rule, the 16 heaviest for eps alone);
             calibrate() on a cut grid (k 10, targets 0.9 and 0.99, 64
             holdout queries, eps 0 / 0.1 / 0.5 x max_leaves 64 / 1024 /
             16384), the oracle's seconds inside it, each met entry's
             holdout recall at least its target, then
             search(mode="approx", recall_target=0.9); autotune() over
             round_leaves 8 and 16, after which search is byte-equal to
             the untuned answer;
  serve      the serving engine (repro_torch.serve) over the main cell's
             index and calibration table, EngineConfig(max_batch=64,
             workers=2, linger_ms=2, warm_ks=(1, 10), cache_entries=4096,
             latency_tiers={"batch": 0.9}): warmup() captures one CUDA
             graph per bucket for k 1, k 10 and the approx tier at k 10;
             the main queries from 4 client threads in submits of 1, 3,
             8, 17 and 64 rows, every row byte-equal to the main phase's
             facade row; the same from the result cache (all hits); 64
             queries at k 1; the approx tier byte-equal to
             search(mode="approx", recall_target=0.9), with recall@10;
             no capture after warmup, every dispatched batch a replay;
             each bucket's plan.run beside the facade's search of the
             same rows; 65,536 adds with a batch in flight (answered on
             its own epoch), 1,024 deletes, winners among them, each
             followed by a stream held to the facade, no deleted id back;
             latency p50 / p99, queries/s, warmup seconds and memory;
             summarize_rows held to its plain version on the rows the
             search gives it (here the delta scan's difference rows
             after the add; the main phase holds the queries and the
             re-rank's rows);
  sharded    the main cell's index (its arrays, no copy) sharded by
             FreshIndex.shard over a mesh of 4 slots on cuda:0: 256 queries
             at k 1 and 10, sync_every 1 and 4, each search's rounds, host
             reads, ms, peak memory beside the local search's, and
             launches (lb_distance 4, refine_topk 4 a round run), ids held
             to brute force (k 10) and to the local search but at ties,
             the card's busy time and idle share over one k-10 search,
             with refine_topk's device ms a launch; the deprecated
             make_sharded_search at k 1, byte-equal to the facade's;
             the engine on it (EngineConfig(max_batch=64, sync_every=2,
             warm_ks=(10,))): submits of 1, 8, 64 rows byte-equal to the
             sharded facade, an add of 4,096 series (a mesh-wide epoch)
             found by a submit after it, a delete of 64 ids none of which
             comes back; then 2^22 walks on 2 slots saved and recovered
             by the engine onto 1 slot with a future in flight, both
             answers exact;
  checker    (after serve, on the main cell's index) the port's race
             checker: PlanCacheScenario over the real PlanCache with one
             CUDA graph captured a plan made, buckets 1 and 8, k 10, 8
             random schedules (one plan a key, every replay byte-equal to
             the facade's search of the same rows); then `python -m
             repro_torch.analysis.checker --budget 200` in a child process;
  l96        FreshIndex.build and search over 2^20 walks of length 96
             (w 16), 256 noisy queries, k 10, held to brute force: the
             summarize kernel's strided route on a search path; and the
             IndexBuilder at 4 workers, bit-equal to the one-pass build;
  lifecycle  2^22 walks of length 256: the Refresh builder, three builds
             each at 1 and 4 workers (4 chunks) with medians and each
             phase's seconds, and one at 4 with a crashing worker, each
             bit-equal to the one-pass build; 65,536 adds (half with a
             TTL), 65,536 deletes (half core, half delta), 1,024 updates,
             the TTL batch expired; searches with all of it pending and
             after compaction, held to a tombstone-aware brute force;
             compact twice, bit-equal; calibrate() on two settings, then
             save, load and reload, the search bit-equal after each and
             the calibration table equal and fresh after load; then the
             serving engine with a MaintenancePolicy: adds (half with a
             TTL) and deletes, maintain() sweeps, compact(), more
             deletes, maintain() compacts and checkpoints, every answer
             byte-equal to the facade's, the ids unchanged across each
             compaction, the policy's checkpoint loaded and answering
             the same;
  dtw        exact DTW 1-NN (core.dtw.search_dtw) over 2^22 walks of
             length 256 made on the card, 256 noisy queries (sigma 0.1),
             band r 12, round_k 32: the first 32 held to
             search_dtw_bruteforce over all 2^22 series, every distance
             to dtw_band_ref on its (query, id), lb_keogh to its plain
             version on a group, the DP bit for bit on 4,096 sampled
             pairs; LB, sort and refinement ms, rounds and candidates
             refined a query, peak memory; then the same collection and
             queries at r 25 (10 % of L: dtw_search's wave2 route), its
             pieces timed, its first two groups bit for bit against
             dtw_search_ref and its first 32 queries against the brute
             force (dtw_scan's wave16 route); the first group at r 51 and
             102 (wave4, wave8; the brute force on all 32 queries, and a
             cut search bit for bit); lb_keogh at L 1024 (2^20 series, 24
             queries, r 51) and L 100 (2^22 series, r 5) against its
             plain version; edge runs (r 0 to 255 at L 100 and 300, each
             dtw_scan route that takes the radius; N 1, N not a multiple
             of a tile or of round_k, N < round_k, 40 queries; r = L -
             1, 2L and 900 at L 16; L 1024 at r 1023; 40 and 64 queries
             over a few tiles; round_k 100, 64, 256 and 1024; the scalar
             LB at L 101), each kernel bit for bit (lb_keogh to 1e-5);
             table rows for lb_keogh (L 256, its scalar route, L 1024 and
             L 100), dtw_search (each wave route with the spread route's
             time at its shape beside it, the spread route at r 12) and
             dtw_scan (band and chain at r 12, wave16 at r 12, 25, 51
             and 102, each route's first query bit for bit against the
             plain version's; the chain route at r 25 on 8 queries
             beside wave16); then the long series (DTW_LONG: 2^16 walks of
             2,709 points at r 27 and 135, 2^14 of 8,192 at r 81, 32
             queries each): search_dtw held to search_dtw_bruteforce, each
             kernel's first query to its plain version, the ring routes'
             (ring2, ring6, ring10, the spread and diag routes' times
             beside each; the scan's ring16, ring18, ring22) rows beside
             the LB's (the envelopes, then the sums), each
             scan row with its cells a lane and busy lanes of 32 and,
             where its radius takes another width, the ring at 16 cells
             a lane beside it, bit for bit; edge runs past the old limits
             (L 1,025, round_k 2,048, 65,600 queries through the scan);
             every template instance of the scan's ring routes (C / 2 a
             width of C cells a lane) forced once at L 1,025, bit for bit
             against dtw_scan_ref;
  dtw_wide   the shapes the spread and chain routes took over (past the
             wave routes' radii and round_k 1,024): search_dtw and the
             brute force at a cell's size (DTW_WIDE_CELLS: 32 queries over
             2^16 walks of 2,709 points at r 271; the brute force at L
             1,024, r 512), held to each other, each kernel at the path's
             launch on its default route and diag, the first query bit
             for bit against the plain versions; then the sweep
             (DTW_SWEEP: 4 queries x 256 walks at L 256, r 128-255; L
             1,024, r 128-1,023; L 2,709, r 271; L 256, r 12, round_k
             2,048): every route of each kernel, bit for bit, timed;
  fidelity   build_index_host over 2^16 seismic_like series of length
             256 under RefreshExecutor, DoAllSplit, FaiBased and CasBased
             at 8 threads: every id in the forest with the one-pass
             build's word, each executor's seconds;
  attention  ops.flash_attention at granite-8b's attention widths (B 1,
             Hq 32, Hkv 8, T = S = 4096, dh 128, bf16, causal), held
             against the plain version; then at each other route's shape
             (ATTN_ROWS: Phi-3-mini's dh 96 and Gemma 7B's dh 256 on the
             tensor cores, dh 320 and 512 with O in halves, float32 at dh
             96 (FMAs), 256 (TF32) and 320 (halves), the staged route at
             dh 100 and its TMA twin at 104, the wide route at 576), its
             launches its table row's.
refine_search is held under the (1 + eps) stop (inv_eps 1 / 1.25^2) on
every route too: cta3 in the kernel phase, cta2, cta1 and general in the
route phase.
Each of main, rounds, scan, approx, sharded, serve, l96, lifecycle, dtw,
dtw_wide and attention sets every launch count to 0 before it and requires each
kernel (and route) of its path to have launched, and every kernel of
the table to have launched on some path; a graph replay passes through
no wrapper,
so the serve phase counts replays through each plan's `calls`.  The
serve phase's facade searches run before its counts are set to 0 (or
after they are read): the counts it requires are the engine's own, those
of its warm-ups and captures, then the add's publish and captures, and
the streams must leave them unchanged.  Every bound (bound_ms) is the
work count of src/repro_torch/launch/roofline.py over the H100's peaks,
and no kernel may read above BOUND_SLACK of its bound (a faster reading
means a wrong count).  Then the kernel table, the nvidia-smi line and,
last, the device line.  Any failure raises and
exits non-zero; without CUDA, or without the repository's src/ beside
this file, it exits 1 before printing a result.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

DEV = "cuda"
# repro_torch.launch.roofline, every kernel's work count and the card's
# peaks: imported by main() once src/ is known to be beside this file
rl = None
# no kernel runs faster than its bound: a reading above this share of it
# means its work count is wrong
BOUND_SLACK = 1.05
Q, K, M, L, TOPK = 256, 8, 64, 256, 10
MAIN = ("summarize", "leaf_stats", "lb_distance", "refine_search")
# granite-8b's attention (train_4k): 32 query heads, 8 KV heads of 128
GRANITE = dict(B=1, Hq=32, Hkv=8, T=4096, dh=128)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def hold_bound(what: str, bms: float, ms: float) -> None:
    """A time no shorter than its bound allows (BOUND_SLACK)."""
    require(bms / ms <= BOUND_SLACK, f"{what}: {ms} ms, {bms / ms} of its "
            f"bound {bms} ms: the work count is wrong")


def time_ms(torch, fn, reps: int = 20, warm: int = 3) -> float:
    """Mean device time of fn() over `reps` launches, after `warm`."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def device_ms(torch, fn, reps: int = 40) -> float:
    """Mean device time of fn()'s kernels a call over `reps` calls, by
    torch.profiler (CUPTI): the kernels' own time, where CUDA events
    around back-to-back calls would time the host between them."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total
               for e in prof.key_averages()) / 1e3 / reps


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


# the attention instances whose registers and spills the ptxas phase
# prints, by a piece of their mangled names: bf16 dh 96 (Phi-3-mini's
# width), bf16 dh 256 on 64-key tiles, and float32 dh 129-256 in TF32
ATTN_PTXAS = {"tc96": "flash_tc_kernelILi96ELi96E",
              "tc256": "flash_tc_kernelILi256ELi256E",
              "tf256": "flash_tf_kernel"}


def ptxas_entries(log: str) -> dict:
    """{mangled kernel name: {"registers", "spill_stores", "spill_loads",
    "warnings"}} from nvcc's -Xptxas -v output (registers: the count
    ptxas reports at the kernel's entry, before any setmaxnreg)."""
    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)'?", ln)
        if m:
            cur = out.setdefault(m.group(1), {"warnings": []})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and cur is not None:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", ln)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    for ln in log.splitlines():
        if "wgmma" in ln:
            for name, e in out.items():
                if name in ln:
                    e["warnings"].append(ln.strip())
    return out


def attention_ptxas(log: str) -> dict:
    """The ATTN_PTXAS instances' registers, spills and wgmma warnings in
    flash_attention.cu's build log; each must spill nothing."""
    entries = ptxas_entries(log)
    out = {}
    for route, piece in ATTN_PTXAS.items():
        found = [v for k, v in entries.items() if piece in k]
        require(len(found) == 1, f"ptxas: no single {route} kernel in the "
                f"build log ({sorted(entries)})")
        out[route] = found[0]
        require(found[0].get("spill_stores") == 0
                and found[0].get("spill_loads") == 0,
                f"ptxas: {route} spills: {found[0]}")
    return out


def dtw_ptxas(log: str, widths, diag_rows, search_widths) -> dict:
    """dtw_scan's ring instances (scan_ring_kernel<C, ML>: C / 2 of each
    width C of `widths`), the strip routes' (the diag routes'
    scan_strips<K> and search_strips<K>, the chain route's scan_chain<K>
    and the spread route's search_spread<K>, K of `diag_rows`), dtw_search's
    ring instances (search_ring<C>, C of `search_widths`) and LB_Keogh's
    past L 1,024 (lb_envelope, lb_long<G, V> at 8, 16 and 32 query slots,
    V 4 and 1) in dtw.cu's build log: each must spill nothing.  Returns
    each scan ring width's instances and most registers, and each other
    instance's registers."""
    found, diag = {}, {}
    for name, e in ptxas_entries(log).items():
        m = re.search(r"(search_ring|lb_long)ILi(\d+)E(?:Li(\d+)E)?|"
                      r"(lb_envelope)", name)
        if m:
            what = m[4] or (f"{m[1]}<{m[2]}>" if m[3] is None
                            else f"{m[1]}<{m[2]}, {m[3]}>")
            require(e.get("spill_stores") == 0 and e.get("spill_loads") == 0,
                    f"ptxas: {what} spills: {e}")
            diag[what] = {"registers": e.get("registers", 0),
                          "spill_bytes": 0}
        m = re.search(r"scan_ring_kernelILi(\d+)ELi(\d+)E", name)
        if m:
            require(e.get("spill_stores") == 0 and e.get("spill_loads") == 0,
                    f"ptxas: scan_ring_kernel<{m[1]}, {m[2]}> spills: {e}")
            found.setdefault(int(m[1]), []).append(e.get("registers", 0))
        m = re.search(r"(scan_strips|search_strips|scan_chain|"
                      r"search_spread)ILi(\d+)E", name)
        if m:
            require(e.get("spill_stores") == 0 and e.get("spill_loads") == 0,
                    f"ptxas: {m[1]}<{m[2]}> spills: {e}")
            diag[f"{m[1]}<{m[2]}>"] = {
                "registers": e.get("registers", 0), "spill_bytes": 0}
    counts = {c: len(v) for c, v in found.items()}
    require(counts == {c: c // 2 for c in widths},
            f"ptxas: ring instances {counts}")
    require(sorted(diag) == sorted(
        [f"{k}<{K}>" for K in diag_rows for k in (
            "scan_strips", "search_strips", "scan_chain", "search_spread")]
        + [f"search_ring<{C}>" for C in search_widths] + ["lb_envelope"]
        + [f"lb_long<{G}, {V}>" for G in (8, 16, 32) for V in (1, 4)]),
        f"ptxas: strip, search ring and LB instances {sorted(diag)}")
    return {f"ring{c}": {"instances": len(v), "registers_max": max(v),
                         "spill_bytes": 0} for c, v in sorted(found.items())
            } | diag


# ----------------------------------------------------------------- kernels
def check_summarize(torch, isax, ks, ref, gen, rows_gen, n=1 << 20):
    """summarize (the TPU kernel's interface) in f32 and bf16, and with
    its one-pass z-norm on n / 16 raw rows, against the plain version;
    then summarize_rows, what the build launches, on n raw rows drawn
    from rows_gen (so that gen's draws, and the main phase's data after
    them, stay as they were): held, timed and bounded by rows_row."""
    x = isax.znormalize(torch.randn(n, L, generator=gen, device=DEV)
                        .cumsum_(1))
    out = {}
    for name, xin in (("f32", x), ("bf16", x.to(torch.bfloat16))):
        pk, wk = ks.summarize(xin, znorm=False)
        pr, wr = ref.summarize_ref(xin, znorm=False)
        err = (pk - pr).abs().max().item()
        require(torch.allclose(pk, pr, rtol=1e-5, atol=1e-5),
                f"summarize {name}: PAA off by {err}")
        # the symbol is exact for the kernel's own PAA; against the plain
        # version it may move only where a breakpoint lies between the two
        # PAA values, i.e. by one region
        require(torch.equal(wk, isax.sax_word(pk).to(torch.int32)),
                f"summarize {name}: symbol is not searchsorted(right)")
        dw = (wk - wr).abs()
        require(int(dw.max()) <= 1, f"summarize {name}: symbol moved > 1")
        out[name] = {"max_abs_err": err, "symbols_moved": int(dw.sum())}
    out["znorm_false_ms"] = time_ms(torch, lambda: ks.summarize(
        x, znorm=False))
    out["znorm_false_bound_ms"], out["znorm_false_bound_by"] = \
        rl.summarize_work(n, L, 16).bound()
    hold_bound("summarize znorm=False", out["znorm_false_bound_ms"],
               out["znorm_false_ms"])
    del x
    # the in-kernel z-norm, in the TPU kernel's one-pass E[x^2] - mu^2
    # form: its cancellation costs digits, hence 1e-4
    raw = torch.randn(n // 16, L, generator=gen, device=DEV).cumsum_(1)
    pk, wk = ks.summarize(raw, znorm=True)
    pr, wr = ref.summarize_ref(raw, znorm=True)
    err = (pk - pr).abs().max().item()
    require(err <= 1e-4 and int((wk - wr).abs().max()) <= 1,
            f"summarize znorm: PAA off by {err}")
    out["znorm_max_abs_err"] = err
    # what the build launches: summarize_rows over blocks of 2^20 raw rows
    row = rows_row(torch, isax, ks, ref, walks(torch, rows_gen, n, L), 16,
                   "summarize_rows")
    out["rows"] = row.pop("checks")
    return {"name": "summarize", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/isax_summarize.cu",
            "replaces": "src/repro/kernels/isax_summarize.py:33",
            **row, "library_ms": None, "checks": out}


def rows_row(torch, isax, ks, ref, raw, w, what):
    """summarize_rows on raw (n, L) held by hold_rows, timed beside its
    plain version, and its bound (roofline.summarize_rows_work)."""
    n, Lx = raw.shape
    errs = hold_rows(torch, isax, ks, ref, raw, w, what)
    ms = time_ms(torch, lambda: ks.summarize_rows(raw, segments=w))
    plain = time_ms(torch, lambda: ref.summarize_rows_ref(raw, segments=w),
                    5)
    bms, by = rl.summarize_rows_work(n, Lx, w, raw.element_size()).bound()
    return {"shape": f"raw ({n}, {Lx}) {str(raw.dtype)[6:]}, w={w}, "
                     f"summarize_rows (two-pass z-norm; series, PAA, "
                     f"symbols, norms)",
            "max_abs_err": errs["series"], "ms": ms, "plain_ms": plain,
            "bound_ms": bms, "bound_by": by, "checks": errs}


def hold_rows(torch, isax, ks, ref, raw, w, what, znorm=True):
    """summarize_rows (what the build stores: the two-pass z-norm, the
    float32 series, PAA, symbols, squared norms; with znorm=False the
    search's row sums, no z-norm) against its plain version on raw; and
    a row's bits the same in a launch of all rows, of the first m =
    min(2048, n - 5) rows, of the 5 after them (the builder's parts) and
    of one row alone, and when the 5 are written in place into slices of
    larger outputs (as the build writes them)."""
    n = raw.shape[0]
    m = min(2048, n - 5)
    xk, pk, wk, sk = ks.summarize_rows(raw, segments=w, znorm=znorm)
    xr, pr, wr, sr = ref.summarize_rows_ref(raw, segments=w, znorm=znorm)
    errs = {"series": (xk - xr).abs().max().item(),
            "paa": (pk - pr).abs().max().item(),
            "sq_norms_rel": ((sk - sr).abs() / sr.clamp_min(1e-6)).max()
            .item()}
    require(errs["series"] <= 1e-5 and errs["paa"] <= 1e-5
            and errs["sq_norms_rel"] <= 1e-5, f"{what}: off by {errs}")
    require(torch.equal(wk, isax.sax_word(pk).to(torch.int32))
            and int((wk - wr).abs().max()) <= 1, f"{what}: symbols")
    for lo, hi in ((0, m), (m, m + 5), (n // 2, n // 2 + 1)):
        part = ks.summarize_rows(raw[lo:hi].contiguous(), segments=w,
                                 znorm=znorm)
        require(all(torch.equal(a, b[lo:hi]) for a, b in
                    zip(part, (xk, pk, wk, sk))),
                f"{what}: rows {lo}:{hi} alone differ from the whole")
    buf = tuple(torch.zeros((m + 5,) + t.shape[1:], dtype=t.dtype,
                            device=DEV) for t in (xk, pk, wk, sk))
    ks.summarize_rows(raw[m:m + 5].contiguous(), segments=w, znorm=znorm,
                      out=tuple(t[m:] for t in buf))
    require(all(torch.equal(a[m:], b[m:m + 5]) and not a[:m].any()
                for a, b in zip(buf, (xk, pk, wk, sk))),
            f"{what}: rows {m}:{m + 5} written in place differ")
    return errs


def hold_search_rows(torch, isax, ks, ref, queries, w, series, rows, what):
    """summarize_rows on the very rows a search gives it, held by
    hold_rows: the raw queries (z-normalized, the search's one query
    summarize), the normalized queries (znorm=False), and the direct-form
    distances' (Q * k, L) difference rows of the normalized queries and
    series[rows] (rows (Q, k); znorm=False, `core.search._row_sq`)."""
    raw = queries.float().contiguous()
    q = ks.summarize_rows(raw, segments=w)[0]
    L_ = raw.shape[1]
    diff = (q[:, None, :] - series[rows].float()).reshape(-1, L_)
    return {"queries": hold_rows(torch, isax, ks, ref, raw, w,
                                 f"{what} queries"),
            "normalized": hold_rows(torch, isax, ks, ref, q, w,
                                    f"{what} normalized queries",
                                    znorm=False),
            "differences": hold_rows(torch, isax, ks, ref,
                                     diff.contiguous(), math.gcd(L_, 16),
                                     f"{what} difference rows",
                                     znorm=False),
            "difference_rows": list(diff.shape)}


def check_lb_distance(torch, lbk, ref, gen, NL=1 << 18):
    q = torch.randn(Q, 16, generator=gen, device=DEV)
    lo = torch.randn(NL, 16, generator=gen, device=DEV) - 0.5
    hi = lo + torch.rand(NL, 16, generator=gen, device=DEV)
    lo[::20, :4] = -float("inf")           # prefix regions at depth 0
    hi[::20, 4:8] = float("inf")
    lo[7::100], hi[7::100] = float("inf"), float("inf")   # invalid leaves
    dk = lbk.lb_distance(q, lo, hi)
    dr = ref.lb_distance_ref(q, lo, hi)
    inf = torch.isinf(dr)
    require(torch.equal(torch.isinf(dk), inf), "lb_distance: inf placement")
    err = (dk[~inf] - dr[~inf]).abs().max().item()
    require(torch.allclose(dk[~inf], dr[~inf], rtol=1e-5, atol=1e-5),
            f"lb_distance: off by {err}")
    # the looped route on the same inputs, and on a ragged tile (Q and NL
    # off the tile, NL % 4 != 0: scalar stores): it adds the same terms in
    # the same order, so the tiled route's redesign kept its bits
    fn = lbk._build.entry("lb_distance", "lb_distance", lbk._ARGTYPES)
    for nq, nl in ((Q, NL), (100, 1003)):
        qs, los, his = q[:nq], lo[:nl], hi[:nl]
        tiled = lbk.lb_distance(qs, los, his)
        plain = ref.lb_distance_ref(qs, los, his)
        fin = torch.isfinite(plain)
        require(torch.equal(torch.isfinite(tiled), fin) and torch.allclose(
            tiled[fin], plain[fin], rtol=1e-5, atol=1e-5),
            f"lb_distance Q {nq} NL {nl}: off the plain version")
        looped = torch.empty_like(tiled)
        lbk._build.check("lb_distance", "lb_distance", fn(
            qs.data_ptr(), los.data_ptr(), his.data_ptr(), looped.data_ptr(),
            nq, nl, 16, L / 16, lbk._ROUTES.index("looped"),
            torch.cuda.current_stream().cuda_stream))
        require(torch.equal(tiled, looped), f"lb_distance Q {nq} NL {nl}: "
                f"the tiled and looped routes differ")
    ms = time_ms(torch, lambda: lbk.lb_distance(q, lo, hi))
    plain = time_ms(torch, lambda: ref.lb_distance_ref(q, lo, hi), 3)
    bms, by = rl.lb_distance_work(Q, NL, 16).bound()
    return {"name": "lb_distance", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/lb_distance.cu",
            "replaces": "src/repro/kernels/lb_distance.py:28",
            "shape": f"q ({Q}, 16), leaves ({NL}, 16)",
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bms, "bound_by": by, "library_ms": None,
            "checks": {"inf_leaves": int(inf[0].sum()),
                       "tiled_equals_looped": True}}


def check_leaf_stats(torch, api, isax, index, lsk, lgk, ref, gen,
                     n=1 << 24):
    """leaf_stats, the build's per-leaf regions (a port-side kernel: repro
    computes them inside its jitted build), held bit for bit against its
    plain version leaf_stats_blocks: on the key-sorted summaries of
    2^20 + 37 walks (a partial last leaf, and a leaf of padding only past
    it) at three bounds and 8 and 4 bits; then the IndexBuilder at 4
    workers, which launches leaf_stats and leaf_gather once a part, bit
    for bit equal to the one-pass build at three bounds in float32 and
    bfloat16 storage; then timed at the main build's launch, n rows read
    through a random order (the key sort's), against the plain version."""
    checks = {}
    raw = walks(torch, gen, (1 << 20) + 37, L)
    for bits in (8, 4):
        x, p, w, _ = index.summarize_rows(raw, segments=16, bits=bits,
                                          znorm=True)
        perm = index.lexsort_lanes(isax.interleaved_key(w, bits))
        nl = -(-p.shape[0] // M) + 1
        for bound in lsk.BOUNDS:
            got = (torch.empty(nl, 16, device=DEV),
                   torch.empty(nl, 16, device=DEV),
                   torch.empty(nl, dtype=torch.bool, device=DEV))
            lsk.launcher(p, w, perm, p.shape[0], leaf_capacity=M, bits=bits,
                         bound=bound, out=got)(0, nl)
            want = ref.leaf_stats_ref(p, w, perm, p.shape[0], M, bits,
                                      bound, (0, nl))
            require(all(torch.equal(a, b) for a, b in zip(got, want)),
                    f"leaf_stats {bound} {bits} bits: not bit-equal")
            require(not bool(got[2][-1]) and bool(got[2][-2]),
                    f"leaf_stats {bound}: leaf_valid")
        checks[f"bits{bits}"] = "bit-equal at prefix, symbox, paabox"
        del x, p, w, perm
    raw = raw[:1 << 18]
    for dtype in ("float32", "bfloat16"):
        for bound in lsk.BOUNDS:
            cfg = api.IndexConfig(bound=bound, dtype=dtype)
            one = api.FreshIndex.build(raw, cfg, device=DEV).index
            b = api.FreshIndex.builder(cfg, workers=4, device=DEV)
            for c in raw.chunk(4):
                b.feed(c)
            many = b.finalize().index
            require(all(torch.equal(getattr(one, f), getattr(many, f))
                        for f in one._fields),
                    f"builder {bound} {dtype}: not bit-equal to one pass")
        checks[f"builder_{dtype}"] = "bit-equal at prefix, symbox, paabox"
    del raw, one, many
    # the main build's launch: n rows through a random order
    paa = torch.randn(n, 16, generator=gen, device=DEV)
    words = isax.sax_word(paa)
    order = torch.randperm(n, generator=gen, device=DEV)
    kw = dict(leaf_capacity=M, bits=8, bound="prefix")
    got = lsk.leaf_stats(paa, words, order, n, **kw)
    want = ref.leaf_stats_ref(paa, words, order, n, M, 8, "prefix",
                              (0, n // M))
    require(all(torch.equal(a, b) for a, b in zip(got, want)),
            "leaf_stats at the main shape: not bit-equal")
    ms = time_ms(torch, lambda: lsk.leaf_stats(paa, words, order, n, **kw))
    plain = time_ms(torch, lambda: ref.leaf_stats_ref(
        paa, words, order, n, M, 8, "prefix", (0, n // M)), 3)
    bms, by = rl.leaf_stats_work(n, 16, M).bound()
    return {"name": "leaf_stats", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/leaf_stats.cu",
            "replaces": "none: a port-side kernel (src/repro/core/index.py:88 "
                        "leaf_stats_blocks runs inside repro's jitted build, "
                        "no Pallas kernel)",
            "port_side": True,
            "shape": f"{n} rows, w 16, M {M}, prefix, through a random "
                     f"order (the main build's launch)",
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain, "bound_ms": bms,
            "bound_by": by, "library_ms": None, "checks": checks}


def check_leaf_gather(torch, isax, lgk, ref, gen, n=1 << 22,
                      part=2048):
    """leaf_gather, the builder's materialize pass (a port-side kernel),
    bit for bit against the torch gathers (leaf_gather_ref): float32 rows
    of 256 (16-byte copies), bfloat16 rows of 100 (8-byte copies) with
    ids through a perm, in ranges; then timed as one materialize phase
    of the lifecycle's builds launches it, n rows of 256 float32 in
    parts of `part` rows, against the plain version's loop of parts."""
    checks = {}
    for name, Lx, dtype, with_perm in (("f32_L256", L, torch.float32, False),
                                       ("bf16_L100", 100, torch.bfloat16,
                                        True)):
        m = (1 << 18) + 5
        src = (torch.randn(m, Lx, generator=gen, device=DEV).to(dtype),
               torch.randn(m, 16, generator=gen, device=DEV))
        src += (isax.sax_word(src[1]), torch.rand(m, generator=gen,
                                                  device=DEV))
        order = torch.randperm(m, generator=gen, device=DEV)
        perm = (torch.randperm(m, generator=gen, device=DEV).to(torch.int32)
                if with_perm else None)
        outs = [(torch.zeros(m + M, Lx, dtype=dtype, device=DEV),
                 torch.zeros(m + M, 16, device=DEV),
                 torch.zeros(m + M, 16, dtype=torch.uint8, device=DEV),
                 torch.zeros(m + M, device=DEV),
                 torch.zeros(m + M, dtype=torch.int32, device=DEV))
                for _ in range(2)]
        launch = lgk.launcher(order, src, outs[0], perm)
        for r0, r1 in ((0, 2048), (2048, 2053), (2053, m)):
            launch(r0, r1)
            ref.leaf_gather_ref(order, src, outs[1], (r0, r1), perm)
        require(all(torch.equal(a, b) for a, b in zip(*outs)),
                f"leaf_gather {name}: not bit-equal to the gathers")
        checks[name] = {"route": lgk.route(Lx * src[0].element_size(),
                                           src[0].data_ptr(),
                                           outs[0][0].data_ptr())}
    del src, outs
    src = (torch.randn(n, L, generator=gen, device=DEV),
           torch.randn(n, 16, generator=gen, device=DEV))
    src += (isax.sax_word(src[1]), torch.rand(n, generator=gen, device=DEV))
    order = torch.randperm(n, generator=gen, device=DEV)
    out = (torch.empty_like(src[0]), torch.empty_like(src[1]),
           torch.empty_like(src[2]), torch.empty_like(src[3]),
           torch.empty(n, dtype=torch.int32, device=DEV))
    launch = lgk.launcher(order, src, out)
    parts = [(a, min(a + part, n)) for a in range(0, n, part)]
    ms = time_ms(torch, lambda: [launch(a, b) for a, b in parts], 3)
    plain = time_ms(torch, lambda: [ref.leaf_gather_ref(order, src, out,
                                                        (a, b))
                                    for a, b in parts], 2)
    # the same rows in one launch: the kernel's own rate, where the
    # phase's 2048 launches wait on the host
    checks["one_launch_ms"] = time_ms(torch, lambda: launch(0, n), 5)

    # the library: torch.index_select of each array over the same parts,
    # and over all rows in one call each
    def library(a, b):
        rows = order[a:b]
        for o, x in zip(out, src):
            torch.index_select(x, 0, rows, out=o[a:b])
        out[4][a:b].copy_(rows)
    library_ms = time_ms(torch, lambda: [library(a, b) for a, b in parts], 3)
    checks["library_one_call_ms"] = time_ms(torch, lambda: library(0, n), 5)
    bms, by = rl.leaf_gather_work(n, L, 16).bound()
    checks["one_launch_share_of_bound"] = bms / checks["one_launch_ms"]
    # one launch of the phase's: its own device time (the profiler) against
    # the bound of its part's rows, where the phase's events wait on the
    # host between launches
    checks["device_ms_per_launch"] = device_ms(
        torch, lambda: launch(0, part), 40)
    checks["part_bound_ms"] = rl.leaf_gather_work(part, L, 16).bound()[0]
    checks["part_share_of_bound"] = (checks["part_bound_ms"]
                                     / checks["device_ms_per_launch"])
    return {"name": "leaf_gather", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/leaf_stats.cu",
            "replaces": "none: a port-side kernel (the gathers of "
                        "src/repro/core/builder.py's materialize phase, "
                        "no Pallas kernel)",
            "port_side": True,
            "shape": f"{n} rows of {L} f32 in {len(parts)} launches of "
                     f"{part} rows (one materialize phase)",
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain, "bound_ms": bms,
            "bound_by": by, "library_ms": library_ms,
            "library_call": "torch.index_select of each array, and a copy "
                            "of the row ids, over the same parts",
            "checks": checks}


def fold_check(torch, dk, ek, dr, er, true_d, tol, what):
    """Buffers agree: distances within tol slot by slot, entries equal
    except near-ties, where the kernel's entry has the slot's distance."""
    err = (dk - dr).abs().max().item()
    require(err <= tol, f"{what}: distances off by {err} > {tol}")
    mism = ek != er
    if mism.any():
        off = (true_d(ek) - dk).abs()[mism].max().item()
        require(off <= tol, f"{what}: entry swap beyond a near-tie ({off})")
    return err, int(mism.sum())


TOPK_GRID_K = (8, 6, 12, 264)
TOPK_GRID_M = (16, 32, 64)
TOPK_SHARES = (0.0, 0.05, 0.5)  # 0.05: the sharded path's late rounds


def slot_by_slot(torch, rk, args, M_, k):
    """One round folded one slot at a time (K launches of one slot each):
    the order of a kernel that walks a row's slots in turn, whose bits and
    ties the ring route's folds in union order must keep."""
    qv, qsq, series, xn, ids, alive, bd, be = args
    for j in range(ids.shape[1]):
        bd, be = rk.refine_topk(qv, qsq, series, xn,
                                ids[:, j:j + 1].contiguous(),
                                alive[:, j:j + 1].contiguous(), bd, be,
                                leaf_capacity=M_, k=k)
    return bd, be


def refine_topk_grid(torch, isax, rk, ref, gen, Qg=32, NL=512):
    """refine_topk at K 8, 6, 12 and 264, leaves of 16, 32 and 64 rows,
    f32 and bf16: a first round (half the slots alive, into an empty
    buffer: every candidate passes), then alive shares 0, 0.05 and 0.5,
    each folding into the first round's buffer: bit for bit against the
    same round folded slot by slot, the buffer itself where no slot is
    alive, and against the plain version within fold_check's
    tolerance."""
    worst, cases = 0.0, 0
    for M_ in TOPK_GRID_M:
        x = isax.znormalize(walks(torch, gen, NL * M_, L))
        qv = isax.znormalize(walks(torch, gen, Qg, L))
        qsq = (qv * qv).sum(1)
        for name, series in (("f32", x), ("bf16", x.to(torch.bfloat16))):
            xn = (series.float() ** 2).sum(1)
            tol = 1e-5 * (qsq.max() + xn.max()).item()

            def true_d(e, series=series, xn=xn, qv=qv, qsq=qsq):
                xs = series[e.long()].float()
                return (qsq[:, None] + xn[e.long()]
                        - 2 * torch.einsum("qkl,ql->qk", xs, qv)).clamp_min(0)
            for K_ in TOPK_GRID_K:
                what = f"refine_topk {name} K {K_} M {M_}"
                require(rk.route(L, K_, M_, TOPK, series.dtype) == "ring",
                        f"{what}: route")

                def draw():
                    return draw_leaves(torch, gen, Qg, NL, K_)
                first = (qv, qsq, series, xn, draw(),
                         torch.rand(Qg, K_, generator=gen, device=DEV) < 0.5,
                         torch.full((Qg, TOPK), 1e30, device=DEV),
                         torch.zeros((Qg, TOPK), dtype=torch.int32,
                                     device=DEV))
                bd, be = None, None
                for share in ("first",) + TOPK_SHARES:
                    if share == "first":    # into the empty buffer
                        args = first
                    else:
                        alive = torch.rand(Qg, K_, generator=gen,
                                           device=DEV) < share
                        args = (qv, qsq, series, xn, draw(), alive, bd, be)
                    dk, ek = rk.refine_topk(*args, leaf_capacity=M_, k=TOPK)
                    ds, es = slot_by_slot(torch, rk, args, M_, TOPK)
                    require(torch.equal(dk, ds) and torch.equal(ek, es),
                            f"{what} alive {share}: not bit-equal to the "
                            f"round folded slot by slot")
                    require(share != 0.0 or (torch.equal(dk, bd)
                                             and torch.equal(ek, be)),
                            f"{what}: a round with no slot alive changed "
                            f"the buffer")
                    dr, er = ref.refine_topk_ref(*args, leaf_capacity=M_,
                                                 k=TOPK)
                    err, _ = fold_check(torch, dk, ek, dr, er, true_d, tol,
                                        f"{what} alive {share}")
                    worst = max(worst, err)
                    cases += 1
                    if share == "first":
                        bd, be = dk, ek
        del x, qv
    return {"cases": cases, "K": TOPK_GRID_K, "leaves": TOPK_GRID_M,
            "alive_shares": TOPK_SHARES,
            "first_round": "half alive, into an empty buffer",
            "max_abs_err": worst,
            "check": "bit-equal to the round folded slot by slot; the "
                     "plain version within tol"}


def check_refine(torch, isax, rk, ref, gen, grid_gen, NL=4096):
    x = isax.znormalize(walks(torch, gen, NL * M, L))
    qv = isax.znormalize(walks(torch, gen, Q, L))
    qsq = (qv * qv).sum(1)
    rows = {}
    for name, series in (("f32", x), ("bf16", x.to(torch.bfloat16))):
        xn = (series.float() ** 2).sum(1)
        tol = 1e-5 * (qsq.max() + xn.max()).item()

        def true_d(e, series=series, xn=xn):
            xs = series[e.long()].float()
            return (qsq[:, None] + xn[e.long()]
                    - 2 * torch.einsum("qkl,ql->qk", xs, qv)).clamp_min(0)

        bd = torch.full((Q, TOPK), 1e30, device=DEV)
        be = torch.zeros((Q, TOPK), dtype=torch.int32, device=DEV)
        errs, swaps = [], 0
        for _ in range(2):                 # round 2 folds into a carry
            ids = draw_leaves(torch, gen, Q, NL, K)
            alive = torch.rand(Q, K, generator=gen, device=DEV) < 0.5
            args = (qv, qsq, series, xn, ids, alive, bd, be)
            dk, ek = rk.refine_topk(*args, leaf_capacity=M, k=TOPK)
            dr, er = ref.refine_topk_ref(*args, leaf_capacity=M, k=TOPK)
            e, s = fold_check(torch, dk, ek, dr, er, true_d, tol,
                              f"refine {name}")
            errs.append(e)
            swaps += s
            bd, be = dr, er
        n_alive = int(alive.sum())
        # the kernel's own time: a launch is shorter than the wrapper's
        # host time, which CUDA events around calls would measure
        ms = device_ms(torch, lambda: rk.refine_topk(*args, leaf_capacity=M,
                                                     k=TOPK))
        events = time_ms(torch, lambda: rk.refine_topk(
            *args, leaf_capacity=M, k=TOPK))
        plain = time_ms(torch, lambda: ref.refine_topk_ref(
            *args, leaf_capacity=M, k=TOPK), 5)
        bms, by = rl.refine_topk_work(Q, K, M, L, TOPK, n_alive,
                                      series.element_size()).bound()
        # a late round: about 1 slot in 20 alive
        late = args[:5] + (torch.rand(Q, K, generator=grid_gen,
                                      device=DEV) < 0.05,) + args[6:]
        late_ms = device_ms(torch, lambda: rk.refine_topk(
            *late, leaf_capacity=M, k=TOPK))
        rows[name] = {"ms": ms, "events_ms": events, "plain_ms": plain,
                      "bound_ms": bms, "bound_by": by,
                      "max_abs_err": max(errs), "near_tie_swaps": swaps,
                      "tol": tol, "alive_slots": n_alive,
                      "late_round_ms": late_ms,
                      "late_round_alive_slots": int(late[5].sum())}
        if name == "f32":
            all_alive = refine_all_alive(torch, rk, ref, args, true_d, tol,
                                         ms)
    rows["grid"] = refine_topk_grid(torch, isax, rk, ref, grid_gen)
    f = rows["f32"]
    return {"name": "refine_topk", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/refine.cu",
            "replaces": "src/repro/kernels/refine.py:139",
            "shape": f"Q={Q} K={K} M={M} L={L} k={TOPK}, ~half alive, f32",
            "max_abs_err": max(f["max_abs_err"], rows["grid"]["max_abs_err"]),
            "ms": f["ms"],
            "plain_ms": f["plain_ms"], "bound_ms": f["bound_ms"],
            "bound_by": f["bound_by"], "library_ms": None,
            "all_alive": all_alive, "checks": rows}


def refine_all_alive(torch, rk, ref, args, true_d, tol, half_ms):
    """One round of the table's shape with every slot alive, folded into
    the carried buffer of args (the half-alive round's), held to its
    plain version and timed by the profiler: repro's roofline_fraction of
    it (refine_analytic counts every slot alive) beside the port's bound
    of the same launch, and the fraction refine_analytic's count would
    give the half-alive launch (half_ms), which no card can reach."""
    full = args[:5] + (torch.ones_like(args[5]),) + args[6:]
    dk, ek = rk.refine_topk(*full, leaf_capacity=M, k=TOPK)
    dr, er = ref.refine_topk_ref(*full, leaf_capacity=M, k=TOPK)
    err, swaps = fold_check(torch, dk, ek, dr, er, true_d, tol,
                            "refine all alive")
    ms = device_ms(torch, lambda: rk.refine_topk(*full, leaf_capacity=M,
                                                 k=TOPK))
    shape = dict(Q=Q, K=K, M=M, L=L, k=TOPK, dtype_bytes=4)
    frac = rl.roofline_fraction(ms / 1e3, **shape)
    require(frac <= BOUND_SLACK, f"refine all alive: roofline_fraction "
            f"{frac}, the work count is wrong")
    bms, by = rl.refine_topk_work(Q, K, M, L, TOPK, Q * K).bound()
    hold_bound("refine all alive", bms, ms)
    return {"ms": ms, "roofline_fraction": frac, "bound_ms": bms,
            "bound_by": by, "max_abs_err": err, "near_tie_swaps": swaps,
            "alive_slots": Q * K,
            "half_alive_analytic_fraction": rl.roofline_fraction(
                half_ms / 1e3, **shape)}


def refine_inputs(search, idx, queries, K=K, max_rounds=None, budget=None):
    """The refinement's inputs, as search_plan_impl makes them: prepared
    queries, their norms, and each query's priority queue of leaves (cut
    to `max_rounds` rounds and `budget` leaves)."""
    q, q_paa, q_sq = search.prepare_rows(queries, True, idx.paa.shape[1])
    lb = search.leaf_lower_bounds(idx, q_paa, idx.series.shape[1])
    cap = search._rounds_cap(idx.n_leaves, K, max_rounds, budget)
    order, sorted_lb = search._pq_order(lb, K, cap, budget)
    return q, q_sq, order, sorted_lb


def search_work(idx, order, got, K=K, k=TOPK):
    """roofline.search_work of a refinement's (d, e, rounds, alive) over
    idx's queue `order`."""
    return rl.search_work(order, got[2], got[3], M=idx.leaf_capacity,
                          L=idx.series.shape[1],
                          elem_bytes=idx.series.element_size(), K=K, k=k)


def search_tol(torch, idx, q, q_sq):
    """(tol, true_d): refine's limit, 1e-5 of the |q|^2 + |x|^2 that the
    matmul form cancels, and the matmul-form d^2 of (Q, k) entries."""
    xn = idx.sq_norms
    tol = 1e-5 * (q_sq.max() + xn[xn < 1e29].max()).item()

    def true_d(e):
        xs = idx.series[e.long()].float()
        return (q_sq[:, None] + xn[e.long()]
                - 2 * torch.einsum("qkl,ql->qk", xs, q)).clamp_min(0)
    return tol, true_d


def hold_search(torch, got, want, sorted_lb, true_d, tol, what, K=K,
                inv_eps=1.0):
    """One refinement's (d, e, rounds, alive) against another's: buffers
    as fold_check holds them; rounds equal but for a query whose stop test
    met a near-tie (the deciding lower bound within tol of the bound, the
    k-th best times inv_eps, of the side that stopped first), each
    shown."""
    (dk, ek, rk, ak), (dr, er, rr, ar) = got, want
    err, swaps = fold_check(torch, dk, ek, dr, er, true_d, tol, what)
    ties = []
    for i in (rk != rr).nonzero()[:, 0].tolist():
        first = dk if rk[i] < rr[i] else dr
        r0 = int(min(rk[i], rr[i]))
        gap = (sorted_lb[i, r0 * K] - first[i, -1] * inv_eps).abs().item()
        require(gap <= tol, f"{what}: query {i} ran {int(rk[i])} rounds, "
                f"not {int(rr[i])}, beyond a near-tie ({gap})")
        ties.append({"query": i, "rounds": [int(rk[i]), int(rr[i])],
                     "gap": gap})
    return {"max_abs_err": err, "near_tie_swaps": swaps,
            "near_tie_rounds": ties,
            "alive_slots_differ": int((ak != ar).sum())}


def run_loop(torch, rk, args, K=K, M=M, k=TOPK, inv_eps=1.0):
    """refine_search's (d, e, rounds, alive)."""
    alive = torch.zeros(args[0].shape[0], dtype=torch.int32, device=DEV)
    out = rk.refine_search(*args, leaf_capacity=M, k=k, round_leaves=K,
                           inv_eps=inv_eps, alive_out=alive)
    return out + (alive,)


def run_loop_ref(torch, ref, args, K=K, M=M, k=TOPK, inv_eps=1.0):
    alive = torch.zeros(args[0].shape[0], dtype=torch.int32, device=DEV)
    out = ref.refine_search_ref(*args, leaf_capacity=M, k=k,
                                round_leaves=K, inv_eps=inv_eps,
                                alive_out=alive)
    return out + (alive,)


def rounds_stats(rounds):
    r = rounds.float()
    return {"min": int(r.min()), "median": r.median().item(),
            "p90": r.quantile(0.9).item(), "max": int(r.max())}


def hold_loop(torch, search, rk, ref, idx, queries, K, what, k=TOPK):
    """refine_search against refine_search_ref on one index (hold_search),
    and the kernel's time, the plain version's and the bound."""
    q, q_sq, order, sorted_lb = refine_inputs(search, idx, queries, K)
    args = (q, q_sq, idx.series, idx.sq_norms, order, sorted_lb)
    M_ = idx.leaf_capacity
    got = run_loop(torch, rk, args, K, M_, k)
    ms = time_ms(torch, lambda: rk.refine_search(
        *args, leaf_capacity=M_, k=k, round_leaves=K), 3, warm=0)
    t0 = time.perf_counter()
    want = run_loop_ref(torch, ref, args, K, M_, k)
    torch.cuda.synchronize()
    plain = (time.perf_counter() - t0) * 1e3
    tol, true_d = search_tol(torch, idx, q, q_sq)
    row = hold_search(torch, got, want, sorted_lb, true_d, tol, what, K)
    work = search_work(idx, order, got, K, k)
    bms, by = work.work.bound()
    return dict(row, route=rk.route(idx.series.shape[1], K, M_, k,
                                    idx.series.dtype),
                tol=tol, rounds=rounds_stats(got[2]),
                alive_slots=int(got[3].sum()), alive_leaves=work.leaves,
                ms=ms,
                plain_ms=plain, bound_ms=bms, bound_by=by)


def hold_eps(torch, search, rk, ref, idx, queries, K_, k_, what, eps=0.25):
    """refine_search against refine_search_ref under the (1 + eps) stop,
    inv_eps = 1 / (1 + eps)^2 (hold_search, the near-ties against the
    scaled bound); with the route and each query's rounds beside the
    exact search's."""
    inv, _ = search._stop_knobs(eps, None, None)
    q, q_sq, order, sorted_lb = refine_inputs(search, idx, queries, K_)
    args = (q, q_sq, idx.series, idx.sq_norms, order, sorted_lb)
    M_ = idx.leaf_capacity
    got = run_loop(torch, rk, args, K_, M_, k_, inv)
    want = run_loop_ref(torch, ref, args, K_, M_, k_, inv)
    exact = run_loop(torch, rk, args, K_, M_, k_)[2]
    tol, true_d = search_tol(torch, idx, q, q_sq)
    row = hold_search(torch, got, want, sorted_lb, true_d, tol, what, K_,
                      inv)
    return dict(row, eps=eps, route=rk.route(idx.series.shape[1], K_, M_, k_,
                                             idx.series.dtype),
                rounds=rounds_stats(got[2]), exact_rounds=rounds_stats(exact))


def check_refine_search(torch, api, search, rk, ref, edge_gen, n=1 << 18):
    """refine_search against refine_search_ref (hold_loop) on real indexes
    of random walks and Q noisy collection queries (sigma 0.1), all drawn
    from edge_gen: n walks in f32 and bf16 storage at the main cell's
    leaves and K; then n / 4 walks at other (leaf size, K), whose
    clusters are cut to 2, 4 and 1 CTAs, and whose K = 264 takes more
    slots a round than a CTA has threads."""
    def walks(n):
        raw = torch.randn(n, L, generator=edge_gen, device=DEV).cumsum_(1)
        pick = torch.randint(0, n, (Q,), generator=edge_gen, device=DEV)
        return raw, raw[pick] + 0.1 * torch.randn(Q, L, generator=edge_gen,
                                                  device=DEV)
    raw, queries = walks(n)
    rows = {}
    for name, dtype in (("f32", "float32"), ("bf16", "bfloat16")):
        idx = api.FreshIndex.build(raw, api.IndexConfig(dtype=dtype),
                                   device=DEV).index
        rows[name] = hold_loop(torch, search, rk, ref, idx, queries, K,
                               f"refine_search {name}")
        rows[f"{name} eps 0.25"] = hold_eps(torch, search, rk, ref, idx,
                                            queries, K, TOPK,
                                            f"refine_search {name} eps")
    raw, queries = walks(n // 4)
    for m, k_ in ((16, 6), (32, 12), (64, 3), (8, 264)):
        idx = api.FreshIndex.build(raw, api.IndexConfig(leaf_capacity=m),
                                   device=DEV).index
        rows[f"M{m} K{k_}"] = hold_loop(torch, search, rk, ref, idx, queries,
                                        k_, f"refine_search M {m} K {k_}")
    f = rows["f32"]
    return {"name": "refine_search", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/refine.cu",
            "replaces": "src/repro/kernels/refine.py:139",
            "shape": f"{n} walks, Q={Q} K={K} M={M} L={L} k={TOPK}, f32",
            "max_abs_err": f["max_abs_err"], "ms": f["ms"],
            "plain_ms": f["plain_ms"], "bound_ms": f["bound_ms"],
            "bound_by": f["bound_by"], "library_ms": None, "checks": rows}


def matmul_tol(dr, qsq, xsq, rtol=1e-4):
    """What the matmul form of d^2 may differ by, from another summation
    order or from the direct form: rtol relative, plus 1e-5 of the
    |q|^2 + |x|^2 that it cancels (as refine's check holds it)."""
    return rtol * dr.abs() + 1e-5 * (qsq + xsq)


def ed_bound(n):
    """(bound ms, by) of the scan of Q queries over n candidates
    (roofline.ed_argmin_work): the 3xTF32 products at the check's
    accuracy."""
    return rl.ed_argmin_work(Q, n, L).bound()


def ed_check(torch, edk, ref, q, xin, name, tie=None):
    """The kernel's (d^2, id) against the plain version on q, xin: d^2
    within matmul_tol, ids equal but where the two d^2 nearly tie, and
    the tie (query 0 equal to rows j1 < j2) to j1.  Returns the row."""
    dk, ik = edk.ed_argmin(q, xin)
    dr, ir = ref.ed_argmin_ref(q, xin)
    qsq = (q * q).sum(1)
    xsq = (xin.float() ** 2).sum(1)
    tol = matmul_tol(dr, qsq, xsq.max())
    err = (dk - dr).abs()
    require(bool((err <= tol).all()),
            f"ed_argmin {name}: d^2 off by {err.max().item()}")
    if tie is not None:
        require(int(ik[0]) == tie, f"ed_argmin {name}: tie went to "
                f"{int(ik[0])}, not the lower index {tie}")
    mism = ik != ir     # ids differ only where the two d^2 nearly tie
    near = err <= matmul_tol(dr, qsq, xsq.max(), rtol=1e-5)
    require(bool(near[mism].all()),
            f"ed_argmin {name}: an id differs beyond a near-tie")
    return {"max_abs_err": err.max().item(),
            "max_rel_err": (err / dr.clamp_min(1e-6)).max().item(),
            "near_tie_swaps": int(mism.sum()), "tie_to": int(ik[0])}


def check_ed_argmin(torch, isax, edk, ref, gen, edge_gen, n=1 << 20):
    """Q z-normalized walks against n f32 and bf16 candidates; row j2
    duplicates row j1 < j2 and query 0 is that row, which pins the tie
    rule: the kernel must answer j1.  Then a ragged case, 100 queries
    against 2^20 + 37 candidates in both types, drawn from edge_gen."""
    x = isax.znormalize(torch.randn(n, L, generator=gen, device=DEV)
                        .cumsum_(1))
    q = isax.znormalize(torch.randn(Q, L, generator=gen, device=DEV)
                        .cumsum_(1))
    j1, j2 = n // 3, n // 2 + 1
    x[j2] = x[j1]
    rows = {}
    for name, xin in (("f32", x), ("bf16", x.to(torch.bfloat16))):
        qn = q.clone()
        qn[0] = xin[j1].float()
        rows[name] = ed_check(torch, edk, ref, qn, xin, name, tie=j1)
        if name == "f32":
            ms = time_ms(torch, lambda: edk.ed_argmin(qn, xin))
            plain = time_ms(torch, lambda: ref.ed_argmin_ref(qn, xin), 3)
            chunk = 1 << 18
            lib = time_ms(torch, lambda: [torch.mm(qn, xin[s:s + chunk].T)
                                          for s in range(0, n, chunk)], 5)
        else:
            rows[name]["ms"] = time_ms(torch, lambda: edk.ed_argmin(qn, xin))
    del x
    nr, qr = n + 37, 100
    x = isax.znormalize(torch.randn(nr, L, generator=edge_gen, device=DEV)
                        .cumsum_(1))
    q = isax.znormalize(torch.randn(qr, L, generator=edge_gen, device=DEV)
                        .cumsum_(1))
    for name, xin in (("f32", x), ("bf16", x.to(torch.bfloat16))):
        rows[f"ragged_{name}"] = ed_check(torch, edk, ref, q, xin,
                                          f"ragged {name} Q {qr} N {nr}")
    bms, by = ed_bound(n)
    return {"name": "ed_argmin", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ed_argmin.cu",
            "replaces": "src/repro/kernels/ed_argmin.py:35",
            "shape": f"q ({Q}, {L}) f32, xs ({n}, {L}) f32, one duplicated "
                     f"row",
            "max_abs_err": rows["f32"]["max_abs_err"], "ms": ms,
            "plain_ms": plain, "bound_ms": bms, "bound_by": by,
            "library_ms": lib,
            "library_call": "torch.mm(q, x.T) over chunks of 2^18 rows, "
                            "TF32 off: the product alone",
            "checks": rows}


def attention_inputs(torch, gen, B, Hq, Hkv, T, dh, dtype, S=None):
    S = T if S is None else S
    return (torch.randn(B, Hq, T, dh, generator=gen, device=DEV).to(dtype),
            torch.randn(B, Hkv, S, dh, generator=gen, device=DEV).to(dtype),
            torch.randn(B, Hkv, S, dh, generator=gen, device=DEV).to(dtype))


def sdpa(torch, q, k, v):
    """(scaled_dot_product_attention, causal, on the same inputs, as a
    function of none, how it was called): K/V heads repeated first where
    this torch has no enable_gqa."""
    F = torch.nn.functional
    try:
        F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                       enable_gqa=True)
        return (lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True)), "enable_gqa"
    except TypeError:
        G = q.shape[1] // k.shape[1]
        kr, vr = (t.repeat_interleave(G, dim=1) for t in (k, v))
        return (lambda: F.scaled_dot_product_attention(
            q, kr, vr, is_causal=True)), "repeat_interleave"


def attention_excess(torch, out, plain):
    """How far out lies beyond its limit around plain (the float32 plain
    version on the same inputs): rtol + atol 2e-5 for a float32 out; for
    a bfloat16 out, its own rounding (at most 2^-8 of the value) plus the
    same 2e-5 for the float32 sums.  Returns (max |out - plain|, the
    largest excess, <= 0 within the limit, rtol)."""
    rtol = 2 ** -8 if out.dtype == torch.bfloat16 else 2e-5
    err = (out.float() - plain).abs()
    return (err.max().item(), (err - rtol * plain.abs() - 2e-5).max().item(),
            rtol)


def attention_check(torch, out, ref, q, k, v, what, **kw):
    """out held to attention_excess <= 0.  Returns the largest
    |out - plain| and the rtol."""
    require(out.dtype == q.dtype and out.shape == q.shape
            and bool(torch.isfinite(out).all()), f"attention {what}")
    plain = ref.flash_attention_ref(q.float(), k.float(), v.float(), **kw)
    err, excess, rtol = attention_excess(torch, out, plain)
    require(excess <= 0, f"attention {what}: off by {err}, "
            f"{excess} beyond rtol {rtol} + atol 2e-5")
    return err, rtol


def staged_equal(torch, fk, gen):
    """The bf16 staged route (TMA over copies of q, k and v whose rows are
    padded to 16-byte pieces) bit-equal to the TMA route over the tensors
    themselves on the same inputs (dh a multiple of 8, where both take the
    shape) at dh 104 (tc128) and 320 (tc320, O in halves), causal and with
    a window of 200 over a ragged T = S = 1000: the copies hold every row
    whole.  Returns the check."""
    out = {}
    for dh, causal, window, T in ((104, True, 0, 1024), (320, True, 0, 1024),
                                  (104, True, 200, 1000)):
        q, k, v = attention_inputs(torch, gen, 1, 8, 2, T, dh,
                                   torch.bfloat16)
        tma = fk.route(torch.bfloat16, dh)
        a = fk.launch(q, k, v, tma, causal=causal, window=window)
        b = fk.launch(q, k, v, "staged" + tma[2:], causal=causal,
                      window=window)
        require(torch.equal(a, b), f"flash_attention dh {dh}: staged != TMA")
        out[f"dh{dh}_T{T}_window{window}"] = "bit-equal"
    return out


def check_flash(torch, fk, ref, gen, edge_gen):
    """granite-8b's attention in bf16 (causal, then window 1024), held to
    the bf16 rounding of the float32 plain version; float32 cases at 2e-5:
    causal at T 1024, causal with window 256 and with window 200 over a
    ragged T = S = 1000 (the tiles before the window are skipped), and
    rows that see no key (T 256 over S 64, window 32), which must average
    V.  Then, drawn from edge_gen, the bf16 route (the tensor cores) at
    its edges under the same bf16 limit: the ragged T = S = 1000 with
    window 200, the empty rows, and dh 64 and 32 with GQA.  SDPA's own
    excess under that limit at the granite shape is recorded, not held.
    Then every head width repro answers beyond the old set, at T 1024
    with GQA: in both dtypes dh 96 and 256 (their own instances; f32 256
    the TF32 route), 40 and 80 (padded to the next instance), 320 (O in
    two halves of columns), 100 and 36 (bf16: the staged route; f32:
    padded), 101 (odd: bf16 rows read by 2-byte loads, f32 by values), 300
    (bf16 staged halves); in bf16 102, 264 and 512 (halves), 445 and 510
    (staged halves) and 520 (the wide route), and dh 100 at T 999; in f32
    160, 200 and 255 (the TF32 route at rows that are not whole 16-byte
    pieces or not 32-column chunks: K's copy padded, V^T's rows cut), 257,
    301 and 512 (halves); the staged route at its edges (the ragged T = S
    = 1000 with window 200 and the empty rows, at dh 100 and 101, the
    TF32 route there at dh 256, and the f32 halves at dh 320 and 301); and
    B * Hq 65,600 at T 64, dh 64 (past the grid's old y dimension).  Last,
    the staged route bit-equal to TMA on the same inputs at dh 104 and
    320 (bf16)."""
    g = GRANITE
    bf16 = torch.bfloat16
    f32 = dict(B=1, Hq=8, Hkv=2, T=1024, dh=128, dtype=torch.float32)
    empty = dict(B=1, Hq=2, Hkv=2, T=256, S=64, dh=64, dtype=torch.float32)
    cases = (("granite_bf16_causal", dict(g, dtype=bf16), True, 0, gen),
             ("granite_bf16_window1024", dict(g, dtype=bf16), True, 1024,
              gen),
             ("f32_1024", f32, True, 0, gen),
             ("f32_1024_window256", f32, True, 256, gen),
             ("f32_1000_window200", dict(f32, T=1000), True, 200, gen),
             ("f32_empty_rows", empty, False, 32, gen),
             ("bf16_1000_window200", dict(f32, T=1000, dtype=bf16), True, 200,
              edge_gen),
             ("bf16_empty_rows", dict(empty, dtype=bf16), False, 32,
              edge_gen),
             ("bf16_1024_dh64", dict(f32, dh=64, dtype=bf16), True, 0,
              edge_gen),
             ("bf16_1024_dh32", dict(f32, dh=32, dtype=bf16), True, 0,
              edge_gen))
    # every head width repro answers: the instances of 96 and 256, 40 and
    # 80 padded to the next instance, 320 (O in halves), 100 / 36 / 101
    # (bf16 staged), 300 in both dtypes; bf16 102, 264, 512 (halves), 445
    # and 510 (staged halves) and 520 (the wide route); f32 257, 301, 512
    # (halves); then the staged
    # producer and the f32 halves at their edges, and more heads than the
    # grid's old y held
    both = (bf16, torch.float32)
    for dh, dtypes in ((96, both), (256, both), (40, both), (80, both),
                       (320, both), (264, (bf16,)), (512, both),
                       (100, both), (520, (bf16,)), (36, both),
                       (101, both), (102, (bf16,)), (300, both),
                       (445, (bf16,)), (510, (bf16,)),
                       (160, (torch.float32,)), (200, (torch.float32,)),
                       (255, (torch.float32,)),
                       (257, (torch.float32,)), (301, (torch.float32,))):
        for dtype in dtypes:
            name = f"{'bf16' if dtype == bf16 else 'f32'}_1024_dh{dh}"
            cases += ((name, dict(f32, dh=dh, dtype=dtype), True, 0,
                       edge_gen),)
    cases += (("bf16_999_dh100", dict(f32, T=999, dh=100, dtype=bf16), True,
               0, edge_gen),)
    for dh, dtype in ((100, bf16), (101, bf16), (256, torch.float32),
                      (320, torch.float32), (301, torch.float32)):
        tag = f"{'bf16' if dtype == bf16 else 'f32'}_dh{dh}"
        cases += ((f"{tag}_1000_window200",
                   dict(f32, T=1000, dh=dh, dtype=dtype), True, 200,
                   edge_gen),
                  (f"{tag}_empty_rows", dict(empty, dh=dh, dtype=dtype),
                   False, 32, edge_gen))
    many = dict(B=1, Hq=65600, Hkv=65600, T=64, dh=64)
    cases += (("bf16_bhq65600", dict(many, dtype=bf16), True, 0, edge_gen),
              ("f32_bhq65600", dict(many, dtype=torch.float32), True, 0,
               edge_gen))
    rows = {}
    for name, shape, causal, window, draw in cases:
        q, k, v = attention_inputs(torch, draw, **shape)
        ok = fk.flash_attention(q, k, v, causal=causal, window=window)
        err, rtol = attention_check(torch, ok, ref, q, k, v, name,
                                    causal=causal, window=window)
        rows[name] = {"max_abs_err": err, "rtol": rtol, "atol": 2e-5}
        if name == "granite_bf16_causal":
            ms = time_ms(torch, lambda: fk.flash_attention(q, k, v))
            plain = time_ms(torch, lambda: ref.flash_attention_ref(q, k, v),
                            3)
            lib_fn, how = sdpa(torch, q, k, v)
            lib = time_ms(torch, lib_fn)
            lib_err, lib_excess, _ = attention_excess(
                torch, lib_fn(), ref.flash_attention_ref(
                    q.float(), k.float(), v.float()))
            work = rl.flash_attention_work(g["B"], g["Hq"], g["Hkv"],
                                           g["T"], g["T"], g["dh"])
            bms, by = work.bound()
        del q, k, v, ok
        torch.cuda.empty_cache()
    rows["staged_equals_tma"] = staged_equal(torch, fk, edge_gen)
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:36",
            "shape": "B 1, Hq 32, Hkv 8, T = S = 4096, dh 128, bf16, causal",
            "max_abs_err": rows["granite_bf16_causal"]["max_abs_err"],
            "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
            "library_ms": lib,
            "library_call": f"scaled_dot_product_attention(is_causal=True) "
                            f"via {how}",
            "library_max_abs_err": lib_err, "library_excess": lib_excess,
            **rl.flash_attention_floors(work), "checks": rows}


# the timed attention rows of the routes beside granite's: Phi-3-mini's
# widths (dh 96: hidden 3072 over 32 heads), Gemma 7B's (dh 256), dh 320
# and 512 (O in two halves), float32 at 96 (FMAs) and 256 (the tensor
# cores in TF32), the staged route
# (bf16 rows of 200 bytes) beside its TMA twin at dh 104, at T 1024 and
# on granite-8b's heads (Hq 32, Hkv 8, T 4096), where the padded copy's
# share is that of a model, float32 halves at dh 320, and the wide route
# (past 512), each (name, shape, dtype, model)
_T1024 = dict(B=1, Hq=8, Hkv=2, T=1024)
_T4096 = dict(B=1, Hq=32, Hkv=8, T=4096)
ATTN_ROWS = (("tc96", dict(B=1, Hq=32, Hkv=32, T=4096, dh=96), "bfloat16",
              "Phi-3-mini"),
             ("tc256", dict(B=1, Hq=16, Hkv=16, T=4096, dh=256), "bfloat16",
              "Gemma 7B"),
             ("tc320", dict(_T1024, dh=320), "bfloat16", None),
             ("tc512", dict(_T1024, dh=512), "bfloat16", None),
             ("simt96", dict(_T1024, dh=96), "float32", None),
             ("tf256", dict(_T1024, dh=256), "float32", None),
             ("staged128", dict(_T1024, dh=100), "bfloat16", None),
             ("tc128_dh104", dict(_T1024, dh=104), "bfloat16", None),
             ("staged128_T4096", dict(_T4096, dh=100), "bfloat16", None),
             ("tc128_dh104_T4096", dict(_T4096, dh=104), "bfloat16", None),
             ("simt320", dict(_T1024, dh=320), "float32", None),
             ("wide", dict(_T1024, dh=576), "bfloat16", None))


def route_flash(torch, fk, ref, gen):
    """flash_attention's routes beside the granite row (ATTN_ROWS), causal:
    each held to the float32 plain version under attention_check's limit,
    timed (device time, with the CUDA events' beside it) beside its bound
    (rl.flash_attention_work at the inputs' type), the plain version's
    time and SDPA's on the same inputs, with SDPA's own excess under the
    same limit recorded, not held; the staged route's device time over
    its TMA twin's.  One table row each, named by route (its launches:
    the attention phase's run)."""
    rows = []
    for route, shape, dtype, model in ATTN_ROWS:
        dt = getattr(torch, dtype)
        require(fk.route(dt, shape["dh"]) == route.split("_")[0],
                f"flash_attention dh {shape['dh']} {dtype}: route "
                f"{fk.route(dt, shape['dh'])}")
        q, k, v = attention_inputs(torch, gen, dtype=dt, **shape)
        out = fk.flash_attention(q, k, v)
        err, rtol = attention_check(torch, out, ref, q, k, v, route)
        # device time (the profiler): at T 1024 a launch takes tens of
        # microseconds, and CUDA events around back-to-back calls time the
        # host's wrapper between them
        call = lambda: fk.flash_attention(q, k, v)  # noqa: E731
        ms, event_ms = device_ms(torch, call), time_ms(torch, call)
        plain = time_ms(torch, lambda: ref.flash_attention_ref(q, k, v), 3,
                        1)
        lib_fn, how = sdpa(torch, q, k, v)
        lib, lib_event = device_ms(torch, lib_fn), time_ms(torch, lib_fn)
        lib_err, lib_excess, _ = attention_excess(
            torch, lib_fn(), ref.flash_attention_ref(q.float(), k.float(),
                                                     v.float()))
        work = rl.flash_attention_work(shape["B"], shape["Hq"], shape["Hkv"],
                                       shape["T"], shape["T"], shape["dh"],
                                       elem_bytes=q.element_size())
        bms, by = work.bound()
        desc = (f"B {shape['B']}, Hq {shape['Hq']}, Hkv {shape['Hkv']}, "
                f"T = S = {shape['T']}, dh {shape['dh']}, {dtype}, causal"
                + (f" ({model}'s widths)" if model else ""))
        row = route_row("flash_attention", route,
                        "src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:36", desc, err,
                        ms, plain, bms, by,
                        {"plain version": f"rtol {rtol} + atol 2e-5"})
        row |= {"library_ms": lib,
                "library_call": f"scaled_dot_product_attention("
                                f"is_causal=True) via {how}",
                "library_max_abs_err": lib_err,
                "library_excess": lib_excess, "event_ms": event_ms,
                "library_event_ms": lib_event}
        rows.append(row)
        del q, k, v, out
        torch.cuda.empty_cache()
    # the staged route beside its TMA twin (dh 104, the same shape)
    named = {r["name"]: r for r in rows}
    for tail in ("", "_T4096"):
        staged = named[f"flash_attention/staged128{tail}"]
        twin = named[f"flash_attention/tc128_dh104{tail}"]
        staged["checks"]["device_ms_over_tma_twin"] = (staged["ms"]
                                                       / twin["ms"])
    return rows


# ------------------------------------------------------------------ routes
def route_row(name, route, source, replaces, shape, err, ms, plain, bms, by,
              checks):
    return {"name": f"{name}/{route}", "route": "cuda", "source": source,
            "replaces": replaces, "shape": shape, "max_abs_err": err,
            "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
            "library_ms": None, "checks": checks}


def walks(torch, gen, n, Lx):
    return torch.randn(n, Lx, generator=gen, device=DEV).cumsum_(1)


def draw_leaves(torch, gen, nq, NL, K_):
    """(nq, K_) int32 leaf ids, K_ distinct leaves of NL a row."""
    return torch.rand(nq, NL, generator=gen, device=DEV).argsort(
        1)[:, :K_].to(torch.int32).contiguous()


def route_summarize(torch, isax, ks, ref, gen, n=1 << 20):
    """The strided route (any L and w) at L 96, w 16 in f32 and bf16 and
    at L 100, w 10, at the l96 path's launch of n rows: summarize_rows by
    hold_rows (and timed in f32 at L 96, as the l96 path launches it),
    summarize against the plain version as check_summarize holds it."""
    rows = {}
    for name, Lx, w, dtype in (("L96_w16_f32", 96, 16, torch.float32),
                               ("L96_w16_bf16", 96, 16, torch.bfloat16),
                               ("L100_w10_f32", 100, 10, torch.float32)):
        raw = walks(torch, gen, n, Lx).to(dtype)
        require(ks.route(Lx, w, dtype) == "strided", f"{name}: route")
        if name == "L96_w16_f32":
            row = rows_row(torch, isax, ks, ref, raw, w, name)
            out = {"rows": row.pop("checks")}
        else:
            out = {"rows": hold_rows(torch, isax, ks, ref, raw, w, name)}
        x = isax.znormalize(raw.float()).to(dtype)
        pk, wk = ks.summarize(x, segments=w, znorm=False)
        pr, wr = ref.summarize_ref(x, segments=w, znorm=False)
        out["max_abs_err"] = (pk - pr).abs().max().item()
        require(out["max_abs_err"] <= 1e-5 and torch.equal(
            wk, isax.sax_word(pk).to(torch.int32)) and int(
            (wk - wr).abs().max()) <= 1, f"summarize {name}")
        # the kernel reads bf16 and computes in f32: the plain version on
        # the same values in f32
        pk, wk = ks.summarize(raw, segments=w, znorm=True)
        pr, wr = ref.summarize_ref(raw.float(), segments=w, znorm=True)
        out["znorm_max_abs_err"] = (pk - pr).abs().max().item()
        require(out["znorm_max_abs_err"] <= 1e-4, f"summarize {name} znorm")
        rows[name] = out
        del raw, x
    return route_row("summarize", "strided",
                     "src/repro_torch/kernels/csrc/isax_summarize.cu",
                     "src/repro/kernels/isax_summarize.py:33", row["shape"],
                     row["max_abs_err"], row["ms"], row["plain_ms"],
                     row["bound_ms"], row["bound_by"], rows)


def route_lb(torch, lbk, ref, gen, NL=1 << 16):
    """The looped route (w a runtime loop) at w 32 and w 10."""
    rows = {}
    for w in (32, 10):
        q = torch.randn(Q, w, generator=gen, device=DEV)
        lo = torch.randn(NL, w, generator=gen, device=DEV) - 0.5
        hi = lo + torch.rand(NL, w, generator=gen, device=DEV)
        lo[::20, :4] = -float("inf")
        lo[7::100], hi[7::100] = float("inf"), float("inf")
        require(lbk.route(w) == "looped", f"lb w {w}: route")
        dk = lbk.lb_distance(q, lo, hi)
        dr = ref.lb_distance_ref(q, lo, hi)
        inf = torch.isinf(dr)
        require(torch.equal(torch.isinf(dk), inf), f"lb w {w}: infs")
        err = (dk[~inf] - dr[~inf]).abs().max().item()
        require(torch.allclose(dk[~inf], dr[~inf], rtol=1e-5, atol=1e-5),
                f"lb w {w}: off by {err}")
        rows[f"w{w}"] = {"max_abs_err": err}
        if w == 32:
            ms = time_ms(torch, lambda: lbk.lb_distance(q, lo, hi))
            plain = time_ms(torch, lambda: ref.lb_distance_ref(q, lo, hi), 3)
            bms, by = rl.lb_distance_work(Q, NL, w).bound()
    return route_row("lb_distance", "looped",
                     "src/repro_torch/kernels/csrc/lb_distance.cu",
                     "src/repro/kernels/lb_distance.py:28",
                     f"q ({Q}, 32), leaves ({NL}, 32)",
                     rows["w32"]["max_abs_err"], ms, plain, bms, by, rows)


def route_refine_topk(torch, isax, rk, ref, gen, NL=2048):
    """The general route of one round: bf16 rows of 100 (200 bytes, not
    whole 16-byte pieces), and k 16,000 (buffers past shared memory);
    each bit-equal to the round folded slot by slot."""
    rows = {}
    for name, Lx, dtype, k, nq in (("bf16_L100_k10", 100, torch.bfloat16,
                                    TOPK, Q),
                                   ("f32_L256_k16000", L, torch.float32,
                                    16000, 4)):
        x = isax.znormalize(walks(torch, gen, NL * M, Lx))
        qv = isax.znormalize(walks(torch, gen, nq, Lx))
        qsq = (qv * qv).sum(1)
        series = x.to(dtype)
        xn = (series.float() ** 2).sum(1)
        tol = 1e-5 * (qsq.max() + xn.max()).item()
        require(rk.route(Lx, K, M, k, dtype) == "general", f"{name}: route")

        def true_d(e, series=series, xn=xn, qv=qv, qsq=qsq):
            xs = series[e.long()].float()
            return (qsq[:, None] + xn[e.long()]
                    - 2 * torch.einsum("qkl,ql->qk", xs, qv)).clamp_min(0)
        bd = torch.full((nq, k), 1e30, device=DEV)
        be = torch.zeros((nq, k), dtype=torch.int32, device=DEV)
        ids = draw_leaves(torch, gen, nq, NL, K)
        alive = torch.rand(nq, K, generator=gen, device=DEV) < 0.5
        alive[:, 0] = True
        args = (qv, qsq, series, xn, ids, alive, bd, be)
        dk, ek = rk.refine_topk(*args, leaf_capacity=M, k=k)
        ds, es = slot_by_slot(torch, rk, args, M, k)
        require(torch.equal(dk, ds) and torch.equal(ek, es),
                f"{name}: not bit-equal to the round folded slot by slot")
        dr, er = ref.refine_topk_ref(*args, leaf_capacity=M, k=k)
        err, swaps = fold_check(torch, dk, ek, dr, er, true_d, tol, name)
        rows[name] = {"max_abs_err": err, "near_tie_swaps": swaps,
                      "tol": tol, "slot_by_slot": "bit-equal"}
        if name == "bf16_L100_k10":
            n_alive = int(alive.sum())
            ms = device_ms(torch, lambda: rk.refine_topk(
                *args, leaf_capacity=M, k=k))
            plain = time_ms(torch, lambda: ref.refine_topk_ref(
                *args, leaf_capacity=M, k=k), 5)
            bms, by = rl.refine_topk_work(nq, K, M, Lx, k, n_alive,
                                          series.element_size()).bound()
    return route_row("refine_topk", "general",
                     "src/repro_torch/kernels/csrc/refine.cu",
                     "src/repro/kernels/refine.py:139",
                     f"Q={Q} K={K} M={M} L=100 k={TOPK}, bf16, ~half alive",
                     rows["bf16_L100_k10"]["max_abs_err"], ms, plain, bms, by,
                     rows)


def route_refine_search(torch, api, search, rk, ref, gen, n=1 << 18):
    """refine_search's other routes against refine_search_ref (hold_loop)
    on real indexes of n walks: k 5000 (shared memory for 2 CTAs an SM),
    leaves of 256 and K 64 at k 10 (1 CTA an SM), k 20,000 (the general
    route, buffers in global scratch), and bf16 rows of 100 with w 10 (the
    general route, rows not whole 16-byte pieces)."""
    raw = walks(torch, gen, n, L)
    pick = torch.randint(0, n, (Q,), generator=gen, device=DEV)
    queries = raw[pick] + 0.1 * torch.randn(Q, L, generator=gen, device=DEV)
    f32 = api.FreshIndex.build(raw, device=DEV).index
    wide = api.FreshIndex.build(raw, api.IndexConfig(leaf_capacity=256),
                                device=DEV).index
    del raw
    rows = {}
    for name, idx, K_, k_, nq, want in (
            ("k5000", f32, K, 5000, 16, "cta2"),
            ("M256_K64", wide, 64, TOPK, 64, "cta1"),
            ("k20000", f32, K, 20000, 16, "general")):
        got = rk.route(L, K_, idx.leaf_capacity, k_, idx.series.dtype)
        require(got == want, f"refine_search {name}: route {got}")
        rows[name] = hold_loop(torch, search, rk, ref, idx, queries[:nq], K_,
                               f"refine_search {name}", k_)
        rows[f"{name}_eps"] = hold_eps(torch, search, rk, ref, idx,
                                       queries[:nq], K_, k_,
                                       f"refine_search {name} eps")
        require(rows[f"{name}_eps"]["route"] == want,
                f"refine_search {name} eps: route")
    del f32, wide
    raw = walks(torch, gen, n // 4, 100)
    pick = torch.randint(0, n // 4, (64,), generator=gen, device=DEV)
    queries = raw[pick] + 0.1 * torch.randn(64, 100, generator=gen,
                                            device=DEV)
    idx = api.FreshIndex.build(raw, api.IndexConfig(segments=10,
                                                    dtype="bfloat16"),
                               device=DEV).index
    require(rk.route(100, K, M, TOPK, torch.bfloat16) == "general",
            "refine_search bf16 L 100: route")
    rows["bf16_L100"] = hold_loop(torch, search, rk, ref, idx, queries, K,
                                  "refine_search bf16 L 100")
    rows["bf16_L100_eps"] = hold_eps(torch, search, rk, ref, idx, queries, K,
                                     TOPK, "refine_search bf16 L 100 eps")
    out = []
    for name, route, shape in (
            ("k5000", "cta2", f"{n} walks, Q=16 K={K} M={M} L={L} k=5000"),
            ("M256_K64", "cta1", f"{n} walks, Q=64 K=64 M=256 L={L} k=10"),
            ("k20000", "general", f"{n} walks, Q=16 K={K} M={M} L={L} "
                                  f"k=20000")):
        r = rows[name]
        out.append(route_row("refine_search", route,
                             "src/repro_torch/kernels/csrc/refine.cu",
                             "src/repro/kernels/refine.py:139", shape,
                             r["max_abs_err"], r["ms"], r["plain_ms"],
                             r["bound_ms"], r["bound_by"],
                             rows if route == "general" else
                             {name: r, f"{name}_eps": rows[f"{name}_eps"]}))
    return out


# ed_argmin's rows beside the scan's: (L, dtype, the route it takes), q
# (Q, L) against 2^20 + 5 candidates; L 100 float32 rows are 400 bytes
# (TMA), bfloat16 ones 200 and L 235 float32 ones 940 (cp.async)
ED_ROWS = ((100, "float32", "tensor"), (100, "bfloat16", "staged"),
           (235, "float32", "staged"))


def ed_staged_equal(torch, edk, gen, n, Lx):
    """The staged loader's (d^2, id) bit-equal to TMA's on the same inputs
    (L * the element size a multiple of 16), f32 and bf16: the cp.async
    copies land where TMA's swizzle puts each value.  Returns a check."""
    q = walks(torch, gen, Q, Lx)
    x = walks(torch, gen, n, Lx)
    out = {}
    for name, xin in (("f32", x), ("bf16", x.to(torch.bfloat16))):
        a = edk.launch(q, xin, "tensor")
        b = edk.launch(q, xin, "staged")
        require(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]),
                f"ed_argmin L {Lx} {name}: staged != tensor")
        out[name] = "bit-equal"
    return {"L": Lx, "series": n, **out}


def ed_odd_bases(torch, isax, edk, ref, gen, n=(1 << 16) + 3):
    """The staged loader's other copies, each through ed_argmin against
    the plain version (ed_check): bf16 rows of odd L (2-byte loads), a
    bf16 base 2 bytes off a 4-byte boundary at even L (the same), and an
    f32 base 4 bytes off a 16-byte boundary at L 256 (which TMA cannot
    take), each with the duplicated-row tie."""
    rows = {}
    for name, Lx, dtype, off in (("bf16_L235", 235, torch.bfloat16, 0),
                                 ("bf16_L100_base2", 100, torch.bfloat16, 1),
                                 ("f32_L256_base4", 256, torch.float32, 1)):
        x = isax.znormalize(walks(torch, gen, n, Lx)).to(dtype)
        buf = torch.empty(n * Lx + off, dtype=dtype, device=DEV)
        xin = buf[off:].view(n, Lx)
        xin.copy_(x)
        j1, j2 = n // 3, n // 2 + 1
        xin[j2] = xin[j1]
        q = isax.znormalize(walks(torch, gen, Q, Lx))
        q[0] = xin[j1].float()
        require(edk.route(Lx, dtype, xin.data_ptr() % 16 == 0) == "staged",
                f"ed_argmin {name}: route")
        rows[name] = ed_check(torch, edk, ref, q, xin, name, tie=j1)
        del x, buf, xin
    return rows


def route_ed_argmin(torch, isax, edk, ref, gen, n=1 << 20):
    """ed_argmin's rows beside the scan's (ED_ROWS), each with the
    duplicated-row tie of check_ed_argmin, timed beside its plain version
    and one torch.mm(q, x.T) in float32 at the same shape (TF32 off; a
    bfloat16 x converted once, outside the timing); then the staged
    loader bit-equal to TMA at L 256 (2^16 rows) and at L 100, and its
    odd rows and bases held to the plain version (ed_odd_bases).  One
    table row each of ED_ROWS."""
    out = []
    for Lx, dtype, how in ED_ROWS:
        dt = getattr(torch, dtype)
        x = isax.znormalize(walks(torch, gen, n + 5, Lx))
        q = isax.znormalize(walks(torch, gen, Q, Lx))
        j1, j2 = n // 3, n // 2 + 1
        x[j2] = x[j1]
        xin = x.to(dt)
        require(edk.route(Lx, dt) == how, f"ed_argmin L {Lx} {dtype}: route")
        q[0] = xin[j1].float()
        checks = {"plain version": ed_check(torch, edk, ref, q, xin,
                                            f"L{Lx} {dtype}", tie=j1)}
        ms = time_ms(torch, lambda: edk.ed_argmin(q, xin), 5)
        plain = time_ms(torch, lambda: ref.ed_argmin_ref(q, xin), 3)
        xf = xin.float()
        lib = time_ms(torch, lambda: torch.mm(q, xf.T), 5)
        if how == "tensor":
            # the staged loader on the same inputs: the same bits
            b = edk.launch(q, xin, "staged")
            d, i = edk.ed_argmin(q, xin)
            require(torch.equal(b[0], d) and torch.equal(b[1], i),
                    f"ed_argmin L {Lx}: staged != tensor")
            checks["staged_equals_tensor"] = "bit-equal"
        bms, by = rl.ed_argmin_work(Q, n + 5, Lx, xin.element_size()).bound()
        name = f"{how}_L{Lx}" + ("_bf16" if dtype == "bfloat16" else "")
        row = route_row("ed_argmin", name,
                        "src/repro_torch/kernels/csrc/ed_argmin.cu",
                        "src/repro/kernels/ed_argmin.py:35",
                        f"q ({Q}, {Lx}) f32, xs ({n + 5}, {Lx}) {dtype}",
                        checks["plain version"]["max_abs_err"], ms, plain,
                        bms, by, checks)
        row |= {"library_ms": lib,
                "library_call": "torch.mm(q, x.float().T), TF32 off: the "
                                "product alone"}
        out.append(row)
        del x, xin, xf
        torch.cuda.empty_cache()
    out[0]["checks"]["staged_equals_tensor_L256"] = ed_staged_equal(
        torch, edk, gen, 1 << 16, 256)
    out[0]["checks"]["staged_odd_rows_and_bases"] = ed_odd_bases(
        torch, isax, edk, ref, gen)
    return out


def grid_strides(torch, kmods, ref, gen):
    """The kernels whose grid's y dimension takes query tiles, at more
    tiles than it holds (65,535), which go in launches of at most as many
    (each on its slice of the queries):
    lb_distance's tiled route (128 queries a tile) at 65,535 x 128 + 100
    queries over 16 leaves, its looped route (32 a tile) at 65,535 x 32 +
    100 over 64, and ed_argmin (query groups on the grid's x) at 65,535 x
    32 + 100 queries over 64 series on its staged route (L 101); each
    against its plain version in
    chunks of queries (the bounds to 1e-5, as route_lb holds them; the
    scan's distances to matmul_tol, its ids counted where they differ)."""
    lbk, edk = kmods["lb_distance"], kmods["ed_argmin"]
    out = {}
    for w, tile, NL in ((16, 128, 16), (10, 32, 64)):
        Qn = 65535 * tile + 100
        q = torch.randn(Qn, w, generator=gen, device=DEV)
        lo = torch.randn(NL, w, generator=gen, device=DEV) - 0.5
        hi = lo + torch.rand(NL, w, generator=gen, device=DEV)
        dk = lbk.lb_distance(q, lo, hi)
        err = 0.0
        for a in range(0, Qn, 1 << 20):
            dr = ref.lb_distance_ref(q[a:a + (1 << 20)], lo, hi)
            require(torch.allclose(dk[a:a + (1 << 20)], dr, rtol=1e-5,
                                   atol=1e-5),
                    f"lb_distance {lbk.route(w)}, {Qn} queries: differs")
            err = max(err, (dk[a:a + (1 << 20)] - dr).abs().max().item())
        out[f"lb_distance/{lbk.route(w)}"] = {"queries": Qn, "leaves": NL,
                                              "max_abs_err": err}
        del q, dk
    Qn, N, Lx = 65535 * 32 + 100, 64, 101
    q = torch.randn(Qn, Lx, generator=gen, device=DEV)
    xs = torch.randn(N, Lx, generator=gen, device=DEV)
    require(edk.route(Lx) == "staged", "ed_argmin L 101: route")
    dk, ik = edk.ed_argmin(q, xs)
    dr, ir = ref.ed_argmin_ref(q, xs)
    qsq, xsq = (q * q).sum(1), (xs * xs).sum(1)
    tie = ik != ir
    # an id may differ only where the two distances agree (a near-tie)
    require(bool((dk - dr).abs().le(matmul_tol(dr, qsq, xsq[ir.long()]))
                 .all()),
            f"ed_argmin staged, {Qn} queries: differs")
    out["ed_argmin/staged"] = {"queries": Qn, "series": N, "L": Lx,
                                "max_abs_err": (dk - dr).abs().max().item(),
                                "ids_differing": int(tie.sum())}
    return {"phase": "grid", **out}


# flash_attention past 65,535 blocks of query rows, each route in two
# launches: (route, dtype, dh), T = 65,535 blocks of its rows + 3 blocks,
# one head, causal, window ATTN_LONG_WINDOW
ATTN_LONG = (("wide", "bfloat16", 520), ("simt32", "float32", 32),
             ("tc32", "bfloat16", 32), ("staged32", "bfloat16", 30))
ATTN_LONG_WINDOW = 64


def attention_rows_past_the_grid(torch, fk, ref, gen):
    """flash_attention at more query blocks than the grid's y dimension
    holds (ATTN_LONG: 1,048,608 rows on the wide route at dh 520,
    4,194,432 on the FMAs, 8,388,864 on the tensor cores fed by TMA and
    by the staged producer), causal under a window of 64:
    two launches, the last 65,535 blocks first; rows at the start, on
    each side of the launches' seam and at the end, 256 each, held under
    the existing limits (attention_excess) to the plain version on the
    rows and keys they see (rows t see keys t - 63 .. t, so a slice from
    64 keys before its rows is exact)."""
    out = {}
    for name, dtype, dh in ATTN_LONG:
        dtype = getattr(torch, dtype)
        rows = fk.ROWS[name.rstrip("0123456789")]
        T = fk.MAX_QBLOCKS * rows + 3 * rows
        # two launches of the attention kernel (and the staged route's
        # padding before them)
        launches = 2 + name.startswith("staged")
        require(fk.route(dtype, dh) == name
                and fk.query_launches(T, name) == launches,
                f"flash_attention T {T} dh {dh}: route")
        q, k, v = attention_inputs(torch, gen, 1, 1, 1, T, dh, dtype)
        before = dict(fk.by_route)
        o = fk.flash_attention(q, k, v, causal=True, window=ATTN_LONG_WINDOW)
        require(fk.by_route.get(name, 0) - before.get(name, 0) == launches,
                f"flash_attention T {T}: launches")
        seam = (-(-T // rows) - fk.MAX_QBLOCKS) * rows
        err = 0.0
        for a in (0, max(0, seam - 128), T - 256):
            lo = max(0, a - ATTN_LONG_WINDOW)
            part = slice(lo, a + 256)
            plain = ref.flash_attention_ref(
                q[:, :, part].float(), k[:, :, part].float(),
                v[:, :, part].float(), causal=True,
                window=ATTN_LONG_WINDOW)[:, :, a - lo:]
            got = o[:, :, a:a + 256]
            require(bool(torch.isfinite(got).all()),
                    f"flash_attention {name} T {T}: not finite")
            e, excess, rtol = attention_excess(torch, got, plain)
            require(excess <= 0, f"flash_attention {name} T {T} rows {a}..: "
                    f"off by {e}, {excess} beyond rtol {rtol} + atol 2e-5")
            err = max(err, e)
        out[f"flash_attention/{name}_T{T}"] = {
            "T": T, "dh": dh, "dtype": str(dtype), "launches": launches,
            "seam_row": seam, "max_abs_err": err}
        del q, k, v, o
        torch.cuda.empty_cache()
    return out


def check_routes(torch, api, isax, search, kmods, ref, gen):
    """Each route a shape takes beside the main cell's, against its plain
    version; one kernel-table row each."""
    rows = [route_summarize(torch, isax, kmods["summarize"], ref, gen),
            route_lb(torch, kmods["lb_distance"], ref, gen),
            route_refine_topk(torch, isax, kmods["refine_topk"], ref, gen)]
    rows += route_refine_search(torch, api, search, kmods["refine_search"],
                                ref, gen)
    rows += route_ed_argmin(torch, isax, kmods["ed_argmin"], ref, gen)
    rows += route_flash(torch, kmods["flash_attention"], ref, gen)
    return rows


# --------------------------------------------------------------- main path
def bruteforce(torch, series, q, k, chunk=1 << 20, per_chunk=32):
    """Exact k-NN rows of `series` (stored order): matmul-form candidates
    per chunk, then direct-form distances of the candidates."""
    qsq = (q * q).sum(1)
    cand = []
    for s in range(0, series.shape[0], chunk):
        x = series[s:s + chunk].float()
        d2 = qsq[:, None] + (x * x).sum(1)[None] - 2 * q @ x.T
        cand.append(d2.topk(per_chunk, dim=1, largest=False).indices + s)
    cand = torch.cat(cand, 1)
    d = ((q[:, None, :] - series[cand].float()) ** 2).sum(-1)
    d, pos = torch.sort(d, dim=1, stable=True)
    return d[:, :k].sqrt(), torch.gather(cand, 1, pos[:, :k])


def keys_sorted(torch, isax, words) -> bool:
    """The leaf order is the interleaved-key order."""
    lanes = isax.interleaved_key(words).to(torch.int64)
    prev = torch.zeros(words.shape[0] - 1, dtype=torch.bool,
                       device=words.device)
    for i in range(lanes.shape[1] - 1, -1, -1):
        a, b = lanes[:-1, i], lanes[1:, i]
        prev = (a < b) | ((a == b) & (prev | (i == lanes.shape[1] - 1)))
    return bool(prev.all())


def profile_search(torch, index, queries, per_launch=()):
    """Device time of one search by kernel (torch.profiler over CUPTI) and
    the device's idle share against that search's own wall time; for each
    name of `per_launch`, the mean device ms a launch of the kernels whose
    name holds it."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        index.search(queries, k=TOPK)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern = {e.key: (e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.self_device_time_total > 0}
    busy = sum(ms for ms, _ in kern.values())
    top = sorted(kern.items(), key=lambda kv: -kv[1][0])[:8]
    mean = {}
    for part in per_launch:
        hits = [v for name, v in kern.items() if part in name]
        n = sum(c for _, c in hits)
        require(n > 0, f"profile: no launch of a kernel named *{part}*")
        mean[part] = {"ms_per_launch": sum(ms for ms, _ in hits) / n,
                      "launches": n}
    return {"busy_ms": busy, "wall_ms": wall_ms,
            "idle_share": 1 - busy / wall_ms if busy else None,
            "top": [{"kernel": name[:90], "ms": ms, "count": c}
                    for name, (ms, c) in top], "per_launch": mean}


def main_path(torch, api, isax, search, kmods, ref, n, gen):
    raw = torch.randn(n, L, generator=gen, device=DEV).cumsum_(1)
    pick = torch.randint(0, n, (Q,), generator=gen, device=DEV)
    queries = raw[pick] + 0.1 * torch.randn(Q, L, generator=gen, device=DEV)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in kmods.values():
        mod.launches = 0
    t0 = time.perf_counter()
    index = api.FreshIndex.build(raw, device=DEV)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    d, ids = index.search(queries, k=TOPK)
    torch.cuda.synchronize()
    search_ms = (time.perf_counter() - t0) * 1e3
    launches = {name: kmods[name].launches for name in MAIN}
    peak = torch.cuda.max_memory_allocated()

    idx = index.index
    require(all(v > 0 for v in launches.values()),
            f"a kernel was not launched on the main path: {launches}")
    # the build: a permutation of the input, normalized, in key order
    perm = idx.perm.long()
    require(torch.equal(perm.sort().values,
                        torch.arange(n, device=DEV)), "perm")
    rows = torch.randint(0, n, (4096,), generator=gen, device=DEV)
    require(torch.allclose(idx.series[rows],
                           isax.znormalize(raw[perm[rows]]),
                           rtol=1e-5, atol=1e-5), "stored series")
    require(keys_sorted(torch, isax, idx.words), "leaf order")
    del raw
    torch.cuda.empty_cache()
    # the regions leaf_stats wrote, bit for bit those of its plain version
    # over the stored leaves
    nl = idx.n_leaves
    want = ref.leaf_stats_blocks(idx.paa.reshape(nl, M, -1),
                                 idx.words.reshape(nl, M, -1),
                                 idx.valid.reshape(nl, M, 1), bits=8,
                                 bound="prefix")
    require(all(torch.equal(a, b) for a, b in zip(
        (idx.leaf_lo, idx.leaf_hi, idx.leaf_valid), want)),
        "the build's leaf regions differ from leaf_stats_blocks")
    del want

    reps = []
    for _ in range(3):
        t0 = time.perf_counter()
        index.search(queries, k=TOPK)
        torch.cuda.synchronize()
        reps.append((time.perf_counter() - t0) * 1e3)
    require(launches["refine_search"] == 1,
            f"the search launched refine_search {launches} times, not once")
    deprecated = deprecated_search(torch, search, index, queries, d, ids)
    _, _, rounds = search.search_plan_impl(idx, queries, k=TOPK)
    device = profile_search(torch, index, queries)
    loop, row, loop_ctx = refine_report(torch, search, kmods["refine_search"],
                                        ref, idx, queries, rounds)

    # the answers: finite, ascending, and the exact 10-NN by brute force
    q = isax.znormalize(queries).float()
    require(d.shape == (Q, TOPK) and bool(torch.isfinite(d).all())
            and bool((d[:, 1:] >= d[:, :-1]).all()), "result shape/order")
    db, rb = bruteforce(torch, idx.series, q, TOPK)
    ib = idx.perm[rb]
    mism = ids != ib
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(n, device=DEV)
    d_own = ((q[:, None, :] - idx.series[inv[ids.long()]].float()) ** 2
             ).sum(-1).sqrt()
    require(torch.allclose(d_own, d, rtol=1e-5, atol=1e-5),
            "reported distances are not the ids' distances")
    # summarize_rows as this search launched it: its queries and its
    # re-rank's difference rows (the answers' positions)
    rows_held = hold_search_rows(torch, isax, kmods["summarize"], ref,
                                 queries, idx.paa.shape[1], idx.series,
                                 inv[ids.long()], "main search")
    # ids equal brute force but where two distances are within 1e-5
    # relative: the sorted distance lists must agree everywhere
    require(torch.allclose(d, db, rtol=1e-5, atol=1e-5),
            f"distances differ from brute force by "
            f"{(d - db).abs().max().item()}")
    ties = int(mism.sum())
    lb = torch.rand(Q, idx.n_leaves, device=DEV)
    sort_ms = time_ms(torch, lambda: torch.sort(lb, dim=1, stable=True), 5)
    return {"phase": "main", "series": n, "leaves": idx.n_leaves,
            "queries": Q, "k": TOPK, "noise_sigma": 0.1,
            "build_s": build_s, "peak_alloc_gib": peak / 2**30,
            "search_ms": search_ms, "search_ms_repeats": reps,
            "search_ms_per_query": min(reps) / Q, "rounds": rounds,
            "launches": launches, "near_ties": ties,
            "search_rows_held": rows_held, "pq_sort_ms": sort_ms,
            "deprecated_search": deprecated,
            "device_time": device,
            "refinement": loop}, launches, (index, q, d, ids, queries), row, \
        loop_ctx


def deprecated_search(torch, search, index, queries, d, ids) -> str:
    """The deprecated free function search (core.search.search) on the
    main index's queries at k 10: it warns, and its distances and ids are
    byte-equal to the facade's."""
    import warnings
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        dd, di = search.search(index.index, queries, k=TOPK,
                               config=index.config)
    require(any(w.category is DeprecationWarning
                and "FreshIndex.search" in str(w.message) for w in seen),
            "the deprecated search did not warn")
    require(torch.equal(dd, d) and torch.equal(di, ids),
            "the deprecated search differs from FreshIndex.search")
    return "warned; byte-equal to FreshIndex.search at k 10"


def refine_report(torch, search, rk, ref, idx, queries, rounds):
    """The main cell's refinement alone, outside the counted search: each
    query's rounds and alive slots, the bound they set (search_work),
    refine_search's time, on the longest query alone too, and the plain
    version at this size, held to the kernel by hold_search.  Returns (the
    report, the kernel table's row, (the inputs, the kernel's result))."""
    q, q_sq, order, sorted_lb = refine_inputs(search, idx, queries)
    args = (q, q_sq, idx.series, idx.sq_norms, order, sorted_lb)
    got = run_loop(torch, rk, args)
    require(int(got[2].max()) == rounds,
            f"the search ran {rounds} rounds, its queries at most "
            f"{int(got[2].max())}")
    kw = dict(leaf_capacity=M, k=TOPK, round_leaves=K)
    ms = time_ms(torch, lambda: rk.refine_search(*args, **kw), 3, warm=0)
    t0 = time.perf_counter()
    want = run_loop_ref(torch, ref, args)
    torch.cuda.synchronize()
    plain = (time.perf_counter() - t0) * 1e3
    tol, true_d = search_tol(torch, idx, q, q_sq)
    held = hold_search(torch, got, want, sorted_lb, true_d, tol,
                       "refine_search main")
    work = search_work(idx, order, got)
    bms, by = work.work.bound()
    # the schedule's own cost, and the longest query alone: what no order
    # of the queries can beat
    work_ms = time_ms(torch, lambda: rk.estimated_work(*args, M, TOPK, K), 5)
    i = got[2].argmax()[None]
    one = tuple(a[i] for a in args[:2]) + args[2:4] + tuple(
        a[i] for a in args[4:])
    alone = time_ms(torch, lambda: rk.refine_search(*one, **kw), 2)
    # CTAs a query: refine.cu's kCluster (8), cut to a divisor of K
    report = {"cluster": math.gcd(8, K), "schedule_ms": work_ms,
              "longest_query_alone_ms": alone,
              "longest_query_rounds": int(got[2][i]),
              "rounds_per_query": rounds_stats(got[2]),
              "alive_slots": int(got[3].sum()),
              "alive_leaves": work.leaves, "bytes": work.work.nbytes,
              "bound_ms": bms, "ms": ms, "share_of_bound": bms / ms,
              "per_query_leaf_bytes": work.own_leaf_bytes,
              "per_query_leaf_ms_at_rate": rl.bound_ms(
                  work.own_leaf_bytes, 0)[0],
              "plain_ms": plain, "tol": tol, **held}
    row = {"name": "refine_search", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/refine.cu",
           "replaces": "src/repro/kernels/refine.py:139",
           "shape": f"main cell: {idx.series.shape[0]} series, Q={Q} K={K} "
                    f"M={M} L={L} k={TOPK}, f32",
           "max_abs_err": held["max_abs_err"], "ms": ms, "plain_ms": plain,
           "bound_ms": bms, "bound_by": by, "library_ms": None}
    return report, row, (args, got)


def rounds_phase(torch, ops, kmods, args, got):
    """ops.refine_topk, repro's per-round kernel API, driven through the
    global loop of rounds over the main cell's queue, as the search ran
    before refine_search: the same buffers and rounds bit for bit."""
    q, q_sq, series, sq_norms, order, sorted_lb = args
    for mod in kmods.values():
        mod.launches = 0
    bd = torch.full((Q, TOPK), 1e30, device=DEV)
    be = torch.zeros((Q, TOPK), dtype=torch.int32, device=DEV)
    rounds = torch.zeros(Q, dtype=torch.int32, device=DEV)
    t0 = time.perf_counter()
    cursor = 0
    while cursor < order.shape[1] and bool(
            (sorted_lb[:, cursor] < bd[:, -1]).any()):
        rounds += (sorted_lb[:, cursor] < bd[:, -1]).to(torch.int32)
        alive = (sorted_lb[:, cursor:cursor + K] < bd[:, -1:]).contiguous()
        bd, be = ops.refine_topk(q, q_sq, series, sq_norms,
                                 order[:, cursor:cursor + K].contiguous(),
                                 alive, bd, be, leaf_capacity=M, k=TOPK)
        cursor += K
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    launches = {"refine_topk": kmods["refine_topk"].launches}
    require(launches["refine_topk"] == cursor // K > 0,
            f"refine_topk launches {launches} for {cursor // K} rounds")
    require(torch.equal(bd, got[0]) and torch.equal(be, got[1])
            and torch.equal(rounds, got[2]),
            "the loop of refine_topk rounds and refine_search differ")
    return {"phase": "rounds", "rounds": cursor // K, "wall_ms": wall,
            "launches": launches}, launches


def ed_argmin_chunked(torch, ref, q, xs, chunk=1 << 20):
    """The plain version over chunks of `chunk` candidates, merged with
    the first (lowest) chunk winning a tie: what ed_argmin_ref gives over
    all of xs, without its (Q, N) matrices."""
    ds, ids = zip(*(ref.ed_argmin_ref(q, xs[s:s + chunk])
                    for s in range(0, xs.shape[0], chunk)))
    ds = torch.stack(ds, 1)
    c = torch.argmin(ds, dim=1)
    off = torch.arange(0, xs.shape[0], chunk, device=q.device)[c]
    return ds.gather(1, c[:, None])[:, 0], (
        torch.stack(ids, 1).gather(1, c[:, None])[:, 0] + off).to(torch.int32)


def scan_phase(torch, ops, kmods, ref, index, q, d, ids, search_ms):
    """The exact 1-NN scan over the whole stored collection through
    ops.ed_argmin.  Held against the search's nearest neighbour: d^2
    within matmul_tol of the search's first distance squared, and the
    same id except where the two direct-form distances lie within 1e-5
    relative (near-ties, counted).  Then, outside the counted run, held
    against the plain version at this shape and timed beside it."""
    idx = index.index
    series = idx.series
    for mod in kmods.values():
        mod.launches = 0
    reps = []
    for _ in range(3):
        t0 = time.perf_counter()
        d2, arg = ops.ed_argmin(q, series)
        torch.cuda.synchronize()
        reps.append((time.perf_counter() - t0) * 1e3)
    launches = {"ed_argmin": kmods["ed_argmin"].launches}
    require(launches["ed_argmin"] > 0, "ed_argmin was not launched")
    require(d2.shape == (Q,) and bool(torch.isfinite(d2).all()), "scan")
    qsq = (q * q).sum(1)
    s2 = d[:, 0] ** 2
    err = (d2 - s2).abs()
    require(bool((err <= matmul_tol(s2, qsq, idx.sq_norms[arg.long()]))
                 .all()), f"scan d^2 differs from the search's by "
            f"{err.max().item()}")
    mism = idx.perm[arg.long()] != ids[:, 0]
    d_scan = (q - series[arg.long()].float()).square().sum(1).sqrt()
    near = (d_scan - d[:, 0]).abs() <= 1e-5 * d[:, 0] + 1e-5
    require(bool(near[mism].all()), "scan id differs beyond a near-tie")

    dr, ir = ed_argmin_chunked(torch, ref, q, series)
    perr = (d2 - dr).abs()
    require(bool((perr <= matmul_tol(dr, qsq, idx.sq_norms.max())).all()),
            f"scan d^2 differs from the plain version by "
            f"{perr.max().item()}")
    pm = arg != ir
    near = perr <= matmul_tol(dr, qsq, idx.sq_norms.max(), rtol=1e-5)
    require(bool(near[pm].all()), "scan id differs from the plain version "
            "beyond a near-tie")
    n = series.shape[0]
    chunk = 1 << 18
    row = {"name": "ed_argmin", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/ed_argmin.cu",
           "replaces": "src/repro/kernels/ed_argmin.py:35",
           "shape": f"q ({Q}, {L}) f32, the stored series ({n}, {L}) f32",
           "max_abs_err": perr.max().item(),
           "ms": time_ms(torch, lambda: ops.ed_argmin(q, series), 10),
           "plain_ms": time_ms(torch, lambda: ed_argmin_chunked(
               torch, ref, q, series), 3),
           "library_ms": time_ms(torch, lambda: [
               torch.mm(q, series[s:s + chunk].T)
               for s in range(0, n, chunk)], 3)}
    row["bound_ms"], row["bound_by"] = ed_bound(n)
    return {"phase": "scan", "series": n, "queries": Q,
            "scan_ms": reps[0], "scan_ms_repeats": reps,
            "search_ms_best": search_ms, "d2_max_abs_err": err.max().item(),
            "near_ties": int(mism.sum()), "plain_near_ties": int(pm.sum()),
            "launches": launches, "row": row}, launches


def attention_phase(torch, ops, kmods, ref, gen):
    """granite-8b's attention through ops.flash_attention, held against
    the float32 plain version on the same inputs (attention_check)."""
    g = GRANITE
    q, k, v = attention_inputs(torch, gen, dtype=torch.bfloat16, **g)
    for mod in kmods.values():
        mod.launches = 0
    t0 = time.perf_counter()
    out = ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    launches = {"flash_attention": kmods["flash_attention"].launches}
    require(launches["flash_attention"] > 0,
            "flash_attention was not launched")
    err, _ = attention_check(torch, out, ref, q, k, v, "phase")
    del q, k, v, out
    # each other route's shape (ATTN_ROWS) through the same entry point,
    # every count at 0 first; its launches are its table row's
    routes = {}
    for route, shape, dtype, _ in ATTN_ROWS:
        q, k, v = attention_inputs(torch, gen, dtype=getattr(torch, dtype),
                                   **shape)
        fk = kmods["flash_attention"]
        reset(kmods)
        out = ops.flash_attention(q, k, v)
        torch.cuda.synchronize()
        name = f"flash_attention/{route}"
        routes[name] = fk.by_route.get(route.split("_")[0], 0)
        require(routes[name] > 0 and fk.launches == routes[name],
                f"{name} was not launched ({dict(fk.by_route)})")
        attention_check(torch, out, ref, q, k, v, f"phase {route}")
        del q, k, v, out
        torch.cuda.empty_cache()
    launches |= routes
    return {"phase": "attention", **g, "dtype": "bfloat16", "causal": True,
            "wall_ms": wall, "max_abs_err": err, "launches": launches,
            "routes": {r[0]: r[1] for r in ATTN_ROWS}}, launches


def reset(kmods) -> None:
    """Every launch count to 0, by kernel and by route."""
    for mod in kmods.values():
        mod.launches = 0
        getattr(mod, "by_route", {}).clear()


def route_counts(kmods) -> dict:
    """{"kernel/route": launches} of every route launched since reset."""
    return {f"{name}/{r}": c for name, mod in kmods.items()
            for r, c in getattr(mod, "by_route", {}).items()}


def hold_answers(torch, isax, idx, queries, d, ids, what):
    """The search's (d, ids) are exact: finite, ascending, each id's own
    distance, and the brute-force distances (ids equal but at near-ties,
    counted).  Returns the near-ties."""
    q = isax.znormalize(queries).float()
    require(d.shape == (queries.shape[0], TOPK)
            and bool(torch.isfinite(d).all())
            and bool((d[:, 1:] >= d[:, :-1]).all()), f"{what}: shape/order")
    db, rb = bruteforce(torch, idx.series, q, TOPK)
    perm = idx.perm.long()
    n = int(idx.valid.sum())
    inv = torch.empty(n, dtype=torch.long, device=DEV)
    inv[perm[idx.valid]] = torch.nonzero(idx.valid)[:, 0]
    d_own = ((q[:, None, :] - idx.series[inv[ids.long()]].float()) ** 2
             ).sum(-1).sqrt()
    require(torch.allclose(d_own, d, rtol=1e-5, atol=1e-5),
            f"{what}: reported distances are not the ids' distances")
    require(torch.allclose(d, db, rtol=1e-5, atol=1e-5),
            f"{what}: distances differ from brute force by "
            f"{(d - db).abs().max().item()}")
    return int((ids != idx.perm[rb]).sum())


# the approx phase's rules: FreshIndex.search keywords
APPROX_RULES = (("max_leaves=1024", dict(mode="approx", max_leaves=1024)),
                ("eps=0.1", dict(mode="approx", stop_eps=0.1)),
                ("eps=0.5", dict(mode="approx", stop_eps=0.5)),
                ("eps=0.1,max_leaves=8192", dict(mode="approx", stop_eps=0.1,
                                                 max_leaves=8192)),
                ("pq_budget=4096", dict(pq_budget=4096)),
                ("max_rounds=64", dict(max_rounds=64)))


def approx_rule(torch, search, kmods, ref, index, queries, q, exact_ids,
                name, kw, inv_perm):
    """One rule of the approx phase: its search (first, then the mean of 5
    warm runs), the launches by route of those runs, recall@10 against the
    exact ids, each reported distance held to its id's own (direct form,
    within search_tol), and the refinement under the rule held to
    refine_search_ref: over all queries for a rule that caps the rounds
    or leaves, over the 16 heaviest for an eps-only rule."""
    from repro_torch.quality.calibrate import recall_at_k
    rk = kmods["refine_search"]
    idx = index.index
    reset(kmods)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d, ids = index.search(queries, TOPK, **kw)
    torch.cuda.synchronize()
    first = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    for _ in range(5):
        index.search(queries, TOPK, **kw)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / 5
    by_route = route_counts(kmods)
    require(by_route.get("lb_distance/tiled", 0) == 6
            and sum(c for r, c in by_route.items()
                    if r.startswith("refine_search/")) == 6,
            f"approx {name}: launches {by_route}")
    launches = {n: kmods[n].launches for n in ("lb_distance",
                                               "refine_search")}

    inv, budget = search._stop_knobs(kw.get("stop_eps", 0.0),
                                     kw.get("max_leaves"),
                                     kw.get("pq_budget"))
    qn, q_sq, order, sorted_lb = refine_inputs(
        search, idx, queries, K, kw.get("max_rounds"), budget)
    args = (qn, q_sq, idx.series, idx.sq_norms, order, sorted_lb)
    got = run_loop(torch, rk, args, inv_eps=inv)
    tol, _ = search_tol(torch, idx, qn, q_sq)
    require(d.shape == (Q, TOPK) and bool(torch.isfinite(d).all())
            and bool((d[:, 1:] >= d[:, :-1]).all()),
            f"approx {name}: result shape/order")
    own = (q[:, None, :] - idx.series[inv_perm[ids.long()]].float()
           ).square().sum(-1)
    true_err = (own - d * d).abs().max().item()
    require(true_err <= tol, f"approx {name}: a reported distance is not "
            f"its id's ({true_err} > {tol})")
    if any(key in kw for key in ("max_leaves", "pq_budget", "max_rounds")):
        n_held, sargs, mine = Q, args, got
    else:                               # the 16 heaviest queries
        sub = got[2].argsort(descending=True, stable=True)[:16]
        n_held = 16
        sargs = (tuple(a[sub] for a in args[:2]) + args[2:4]
                 + tuple(a[sub] for a in args[4:]))
        mine = run_loop(torch, rk, sargs, inv_eps=inv)
    t0 = time.perf_counter()
    want = run_loop_ref(torch, ref, sargs, inv_eps=inv)
    torch.cuda.synchronize()
    plain = (time.perf_counter() - t0) * 1e3
    tol_s, true_d = search_tol(torch, idx, sargs[0], sargs[1])
    held = hold_search(torch, mine, want, sargs[5], true_d, tol_s,
                       f"approx {name}", K, inv)
    return {"rule": name, "inv_eps": inv, "leaf_budget": budget,
            "first_ms": first, "ms": ms,
            "rounds": rounds_stats(got[2]),
            "recall_at_10": recall_at_k(ids.cpu().numpy(),
                                        exact_ids.cpu().numpy()),
            "true_distance_err": true_err, "tol": tol,
            "by_route": by_route,
            "held": {"queries": n_held, "plain_ms": plain, **held}}, launches


def approx_path(torch, isax, search, kmods, ref, index, queries, q, d, ids):
    """The main cell's index searched approximately, calibrated and
    autotuned (the quality / autotune slice): exact search through the
    new knob path byte-equal to the main phase's answer; each rule of
    APPROX_RULES (approx_rule); calibrate() on a cut grid (the oracle
    timed inside it, its answer held to the script's brute force on the
    card, each met entry's holdout recall >= its target), then
    search(mode="approx", recall_target=0.9) on the main queries; and
    autotune() over round_leaves 8 and 16, after which search is byte-equal
    to the untuned answer."""
    from repro_torch.kernels.autotune import TuneConfig
    from repro_torch.quality import calibrate as cal
    from repro_torch.quality.stop_rules import EXACT
    idx = index.index
    rep = {"phase": "approx", "series": idx.series.shape[0], "queries": Q,
           "k": TOPK}
    launches = {}

    def count(more):
        for name, c in more.items():
            launches[name] = launches.get(name, 0) + c

    reset(kmods)
    de, ie = index.search(queries, TOPK, mode="exact")
    dp, ip, _ = index._plan(queries, TOPK, round_leaves=K, **EXACT.lower())
    require(all(torch.equal(a, b) for a, b in ((de, d), (ie, ids), (dp, d),
                                               (ip, ids))),
            "approx: exact mode differs from the main phase's answer")
    count({n: kmods[n].launches for n in ("lb_distance", "refine_search")})
    perm = idx.perm.long()
    inv_perm = torch.empty_like(perm)
    inv_perm[perm] = torch.arange(perm.shape[0], device=DEV)
    rep["rules"] = []
    for name, kw in APPROX_RULES:
        r, more = approx_rule(torch, search, kmods, ref, index, queries, q,
                              ids, name, kw, inv_perm)
        rep["rules"].append(r)
        count(more)
    del inv_perm

    # calibrate on a cut grid: fewer settings, the full collection; the
    # oracle is timed where calibrate() calls it
    oracle_runs = []
    real_oracle = cal.oracle_topk

    def timed_oracle(*a, **kw):
        t0 = time.perf_counter()
        out = real_oracle(*a, **kw)
        oracle_runs.append((time.perf_counter() - t0, out))
        return out

    reset(kmods)
    cal.oracle_topk = timed_oracle
    try:
        t0 = time.perf_counter()
        table = index.calibrate(ks=(TOPK,), targets=(0.9, 0.99),
                                n_queries=64, eps_grid=(0.0, 0.1, 0.5),
                                leaves_grid=(64, 1024, 16384), repeat=1)
        calib_s = time.perf_counter() - t0
    finally:
        cal.oracle_topk = real_oracle
    count({n: kmods[n].launches for n in ("lb_distance", "refine_search")})
    require(len(oracle_runs) == 1, "calibrate ran the oracle "
            f"{len(oracle_runs)} times")
    oracle_s, (od, oi) = oracle_runs[0]
    hq = torch.from_numpy(cal.holdout_queries(index, 64)).to(DEV)
    db, rb = bruteforce(torch, idx.series, isax.znormalize(hq).float(), TOPK)
    require(torch.allclose(torch.from_numpy(od).to(DEV), db, rtol=1e-5,
                           atol=1e-5), "the oracle's distances differ from "
            "the brute force on the card")
    entries = []
    for (k_, target), e in table.items():
        row = {"k": k_, "target": target, **e.to_dict()}
        if e.met:
            _, hi = index.search(hq, k_, mode="approx", recall_target=target)
            row["holdout_recall"] = cal.recall_at_k(hi.cpu().numpy(), oi)
            require(row["holdout_recall"] >= target,
                    f"approx: a met entry misses its target: {row}")
        entries.append(row)
    rep["calibration"] = {"entries": entries, "oracle_s": oracle_s,
                          "calibrate_s": calib_s,
                          "oracle_near_ties": int((torch.from_numpy(oi).to(
                              DEV) != idx.perm[rb]).sum()),
                          "fresh": index.is_calibration_fresh()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, ia = index.search(queries, TOPK, mode="approx", recall_target=0.9)
    torch.cuda.synchronize()
    rep["calibration"]["search_0.9"] = {
        "ms": (time.perf_counter() - t0) * 1e3,
        "recall_at_10": cal.recall_at_k(ia.cpu().numpy(), ids.cpu().numpy())}

    reset(kmods)
    t0 = time.perf_counter()
    tuned = index.autotune(candidates=(TuneConfig(),
                                       TuneConfig(round_leaves=16)),
                           k=TOPK, repeat=3)
    tune_s = time.perf_counter() - t0
    count({n: kmods[n].launches for n in ("lb_distance", "refine_search")})
    ((key, entry),) = tuned.items()
    dt, it = index.search(queries, TOPK)
    require(torch.equal(dt, d) and torch.equal(it, ids),
            "approx: tuned search differs from untuned search")
    rep["autotune"] = {"key": list(key), "winner": entry.config.to_dict(),
                       "median_ms": entry.median_ms,
                       "baseline_ms": entry.baseline_ms,
                       "candidates": entry.n_candidates,
                       "survivors": entry.n_exact, "seconds": tune_s,
                       "knobs": index.search_knobs().to_dict()}
    require(all(launches.get(n, 0) > 0 for n in ("lb_distance",
                                                  "refine_search")),
            f"approx: a kernel of the path was not launched: {launches}")
    rep["launches"] = launches
    return rep, launches


SERVE_SIZES = (1, 3, 8, 17, 64)     # rows a submit, in turn
SERVE_CLIENTS = 4


def serve_chunks(n, sizes=SERVE_SIZES):
    """(start, stop) of n rows cut into submits of `sizes` rows in turn."""
    out, s, j = [], 0, 0
    while s < n:
        m = min(sizes[j % len(sizes)], n - s)
        out.append((s, s + m))
        s, j = s + m, j + 1
    return out


def serve_stream(eng, qh, k, chunks, clients=SERVE_CLIENTS, **kw):
    """Submit the rows of qh (numpy) in `chunks` from `clients` threads,
    chunk j from thread j % clients; returns ({chunk: (d, ids)}, each
    future's latency in ms from its submit to its last row, the stream's
    wall seconds).  Every wait is bounded; a client's error is raised."""
    import threading
    out, lat, errs = {}, [], []
    lock = threading.Lock()

    def client(c):
        try:
            mine = [(j, eng.submit(qh[a:b], k=k, **kw))
                    for j, (a, b) in enumerate(chunks) if j % clients == c]
            for j, f in mine:
                r = f.result(timeout=300)
                with lock:
                    out[j] = r
                    lat.append((f.completed_at - f.submitted_at) * 1e3)
        except BaseException as e:      # raised below, on the main thread
            errs.append(e)
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    require(not any(t.is_alive() for t in threads), "serve: a client hung")
    if errs:
        raise errs[0]
    return out, lat, wall


def bad_rows(out, chunks, d_want, i_want) -> int:
    """Rows of the stream's answers whose bytes differ from the wanted
    (numpy) rows, distances and ids."""
    import numpy as np
    bad = 0
    for j, (a, b) in enumerate(chunks):
        dg, ig = (np.asarray(x).reshape(b - a, -1) for x in out[j])
        dw, iw = (x[a:b].reshape(b - a, -1) for x in (d_want, i_want))
        bad += int(((dg.view(np.int32) != dw.view(np.int32))
                    | (ig != iw)).any(1).sum())
    return bad


def stream_ids(out, chunks):
    import numpy as np
    return np.concatenate([np.asarray(out[j][1]).reshape(b - a, -1)
                           for j, (a, b) in enumerate(chunks)])


def pctl(vals):
    import numpy as np
    v = np.asarray(vals)
    return {"n": int(v.size), "p50": float(np.percentile(v, 50)),
            "p99": float(np.percentile(v, 99)), "mean": float(v.mean()),
            "max": float(v.max())}


def host(pair):
    """A (dist, ids) pair of device tensors as numpy."""
    return tuple(t.cpu().numpy() for t in pair)


SERVE_KERNELS = ("summarize", "lb_distance", "refine_search")


def counts(kmods) -> dict:
    """The serve path's kernels' launch counts now."""
    return {name: kmods[name].launches for name in SERVE_KERNELS}


def delta_topk(torch, delta_rows, queries, k, w):
    """The delta scan's picks (Q, k) as `core.search._bruteforce_topk`
    makes them over delta rows with none deleted: float64 matmul-form
    distances of the normalized queries, a stable sort."""
    from repro_torch.core.search import prepare_rows
    q = prepare_rows(queries, True, w)[0].double()
    x = delta_rows.double()
    d2 = ((q * q).sum(-1)[:, None] + (x * x).sum(-1)[None, :]
          - 2.0 * q @ x.T).clamp_min(0.0)
    return torch.sort(d2, dim=1, stable=True).indices[:, :k]


def serve_path(torch, isax, kmods, ref, index, queries, d, ids, gen):
    """The serving engine over the main cell's index (with the approx
    phase's calibration table): warmup() captures every bucket for k 1
    and 10 and the approx tier at k 10, one CUDA graph each; then the
    main queries from 4 client threads in submits of 1, 3, 8, 17 and 64
    rows, each row byte-equal to the main phase's facade row; the same
    again from the result cache; 64 queries at k 1; the approx tier
    byte-equal to search(mode="approx", recall_target=0.9); each
    bucket's plan.run against the facade's search of the same rows;
    then 65,536 adds with a batch in flight (answered on its own epoch)
    and 1,024 deletes (winners among them), each followed by a stream
    held to the facade, and no deleted id back.  The launch counts are
    the engine's: set to 0 after the facade's reference searches, read
    after warmup (each kernel of the search launched), unchanged by the
    streams; the add's and the delete's are read before the facade's
    searches after them."""
    import numpy as np
    from repro_torch.quality.calibrate import recall_at_k
    from repro_torch.serve import EngineConfig
    n = index.index.perm.shape[0]
    qh = queries.cpu().numpy()
    want = host((d, ids))
    cfg = EngineConfig(max_batch=64, workers=2, linger_ms=2.0,
                       warm_ks=(1, TOPK), cache_entries=4096,
                       latency_tiers={"batch": 0.9})
    rep = {"phase": "serve", "series": n, "queries": Q, "k": TOPK,
           "config": {"max_batch": 64, "workers": 2, "linger_ms": 2.0,
                      "warm_ks": [1, TOPK], "cache_entries": 4096,
                      "latency_tiers": {"batch": 0.9},
                      "clients": SERVE_CLIENTS,
                      "submit_rows": list(SERVE_SIZES)}}
    t_phase = time.perf_counter()
    # the facade's answers the streams are held to, before the counts
    # are set to 0: what the wrappers count from here on is the engine's
    want1 = host(index.search(queries[:64], k=1))
    wanta = host(index.search(queries, TOPK, mode="approx",
                              recall_target=0.9))
    torch.cuda.synchronize()
    alloc0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset(kmods)
    eng = index.engine(cfg)
    n_buckets = len(eng._batcher.buckets)
    try:
        t0 = time.perf_counter()
        eng.warmup()
        torch.cuda.synchronize()
        warm = eng.stats()["plan_cache"]
        # the serve path's own launches: each plan's eager warm-up and its
        # capture; every kernel of the search ran in them
        launches = counts(kmods)
        require(all(v > 0 for v in launches.values()),
                f"serve: a kernel of the path was not launched by the "
                f"warm-up: {launches}")
        rep["warmup"] = {
            "s": time.perf_counter() - t0, "captures": warm["misses"],
            "buckets": list(eng._batcher.buckets),
            "allocated_gib_before": alloc0 / 2**30,
            "allocated_gib_after": torch.cuda.memory_allocated() / 2**30,
            "reserved_gib_after": torch.cuda.memory_reserved() / 2**30,
            "peak_allocated_gib": torch.cuda.max_memory_allocated() / 2**30}
        require(warm["misses"] == warm["size"] == 3 * n_buckets
                and warm["donate"]
                and all(p.graph is not None for p in eng.plans.plans()),
                f"serve: warmup captured {warm}, not one graph for each "
                f"of {n_buckets} buckets x (k 1, k 10, approx k 10)")

        chunks = serve_chunks(Q)
        out, lat, wall = serve_stream(eng, qh, TOPK, chunks)
        bad = bad_rows(out, chunks, *want)
        require(bad == 0, f"serve: {bad} exact rows differ from the facade")
        st = eng.stats()
        rep["exact_stream"] = {
            "submits": len(chunks), "wall_s": wall, "qps": Q / wall,
            "latency_ms": pctl(lat), "engine_latency_ms": st["latency_ms"],
            "batches": st["batches"], "rows_differing": bad}

        hits0 = st["result_cache"]["hits"]
        out, lat, wall = serve_stream(eng, qh, TOPK, chunks)
        bad = bad_rows(out, chunks, *want)
        hits = eng.stats()["result_cache"]["hits"] - hits0
        require(bad == 0 and hits == Q, f"serve: the cache pass hit {hits} "
                f"of {Q} rows, {bad} differ")
        rep["cache_pass"] = {"hits": hits, "wall_s": wall, "qps": Q / wall,
                             "latency_ms": pctl(lat)}

        c64 = serve_chunks(64)
        out, lat, wall = serve_stream(eng, qh[:64], 1, c64)
        bad = bad_rows(out, c64, *want1)
        require(bad == 0, f"serve: {bad} k-1 rows differ from the facade")
        rep["k1"] = {"rows": 64, "wall_s": wall, "latency_ms": pctl(lat)}

        out, lat, wall = serve_stream(eng, qh, TOPK, chunks,
                                      priority="batch")
        bad = bad_rows(out, chunks, *wanta)
        require(bad == 0, f"serve: {bad} approx-tier rows differ from the "
                f"facade's approx search")
        tiers = eng.stats()["quality"]["tiers"]
        rep["approx_tier"] = {
            "rows": Q, "wall_s": wall, "qps": Q / wall,
            "latency_ms": pctl(lat),
            "recall_at_10": recall_at_k(stream_ids(out, chunks), want[1]),
            "tier": {t: {k: v for k, v in s_.items() if k != "latency_ms"}
                     for t, s_ in tiers.items()}}

        st = eng.stats()
        plans = eng.plans.plans()
        replays = sum(p.calls for p in plans)
        require(st["plan_cache"]["misses"] == warm["misses"],
                f"serve: a capture after warmup: {st['plan_cache']}")
        # the streams launched nothing through a wrapper: all replays
        require(counts(kmods) == launches, f"serve: the streams launched "
                f"{counts(kmods)} where the warm-up left {launches}")
        # every dispatched batch replayed its plan's graph (a helper's
        # run of a batch still running replays it again, or takes the
        # owner's result)
        require(st["batches"]["dispatched"] <= replays
                <= st["plan_cache"]["hits"]
                and all(p.graph is not None for p in plans),
                f"serve: {replays} replays for {st['plan_cache']}, "
                f"{st['batches']}")
        used = {f"{p.bucket_q}/k{p.k}/"
                f"{'exact' if p.knobs == eng._knobs else 'approx'}": p.calls
                for p in plans}
        rep["plans"] = {"replays": replays, "by_plan": used,
                        "plan_cache": st["plan_cache"]}

        # each bucket: plan.run (copy in, replay, copy out) against the
        # facade's search of the same rows, both to host arrays
        snap = eng._snapshots[eng.epoch]
        per = {}
        for b in eng._batcher.buckets:
            plan = eng.plans.get(snap, b, TOPK, eng._knobs)
            got = plan.run(qh[:b])
            fac = host(index.search(queries[:b], TOPK))
            require(got[0].tobytes() == fac[0].tobytes()
                    and got[1].tobytes() == fac[1].tobytes(),
                    f"serve: bucket {b}'s plan differs from the facade")
            r_ms, e_ms = [], []
            for _ in range(3):
                t0 = time.perf_counter()
                plan.run(qh[:b])
                r_ms.append((time.perf_counter() - t0) * 1e3)
                t0 = time.perf_counter()
                host(index.search(queries[:b], TOPK))
                e_ms.append((time.perf_counter() - t0) * 1e3)
            # the graph's device time alone: what of run() is the card's
            dev_ms = time_ms(torch, plan.graph.replay, reps=3, warm=1)
            per[b] = {"replay_ms": r_ms, "facade_ms": e_ms,
                      "saved_ms": min(e_ms) - min(r_ms),
                      "graph_device_ms": dev_ms,
                      "host_ms": min(r_ms) - dev_ms}
        rep["per_bucket"] = per

        # an add with a batch in flight, then deletes
        q_new = queries[:64] + 0.05 * torch.randn(64, L, generator=gen,
                                                  device=DEV)
        qn_h = q_new.cpu().numpy()
        pre = host(index.search(q_new, TOPK))
        extra = walks(torch, gen, 1 << 16, L)
        torch.cuda.synchronize()
        c0 = counts(kmods)
        futs = [eng.submit(qn_h[a:b], k=TOPK) for a, b in c64]
        t0 = time.perf_counter()
        eng.add(extra)
        add_s = time.perf_counter() - t0
        in_flight = sum(not f.done() for f in futs)
        out = {j: f.result(timeout=300) for j, f in enumerate(futs)}
        bad = bad_rows(out, c64, *pre)
        require(bad == 0, f"serve: {bad} rows in flight across the add "
                f"differ from the pre-add answer")
        misses0 = eng.stats()["plan_cache"]["misses"]
        out, lat, wall = serve_stream(eng, qh, TOPK, chunks)
        # the publish (the delta's summarize) and the new epoch's
        # captures, counted before the facade's search below
        add_launches = {k: v - c0[k] for k, v in counts(kmods).items()}
        require(all(v > 0 for v in add_launches.values()),
                f"serve: the add and its captures launched {add_launches}")
        post = host(index.search(queries, TOPK))
        bad = bad_rows(out, chunks, *post)
        require(bad == 0, f"serve: {bad} rows after the add differ from "
                f"the facade")
        captures = eng.stats()["plan_cache"]["misses"] - misses0
        require(captures <= n_buckets, f"serve: {captures} captures after "
                f"one publish, more than the {n_buckets} buckets")
        rep["add"] = {"rows": 1 << 16, "add_s": add_s,
                      "futures_in_flight_at_publish": in_flight,
                      "of": len(futs), "captures_after_publish": captures,
                      "launches": add_launches,
                      "delta_rows_held": hold_search_rows(
                          torch, isax, kmods["summarize"], ref, queries,
                          index.index.paa.shape[1], index.delta_rows,
                          delta_topk(torch, index.delta_rows, queries,
                                     TOPK, index.index.paa.shape[1]),
                          "serve delta scan"),
                      "wall_s": wall, "latency_ms": pctl(lat)}

        rng = np.random.default_rng(int(torch.randint(
            0, 2**31, (1,), generator=gen, device=DEV)))
        winners = np.unique(post[1][:, 0])
        fresh = n + rng.choice(1 << 16, 64, replace=False)
        rest = np.setdiff1d(rng.choice(n, 4096, replace=False), winners)
        dels = np.unique(np.concatenate([winners, fresh, rest]))[:1024]
        require(np.isin(winners, dels).sum() > 0 and len(dels) == 1024,
                "serve: the delete set")
        c0 = counts(kmods)
        t0 = time.perf_counter()
        deleted = eng.delete(dels)
        delete_s = time.perf_counter() - t0
        require(deleted == 1024, f"serve: delete() deleted {deleted}")
        out, lat, wall = serve_stream(eng, qh, TOPK, chunks)
        del_launches = {k: v - c0[k] for k, v in counts(kmods).items()}
        after = host(index.search(queries, TOPK))
        bad = bad_rows(out, chunks, *after)
        back = int(np.isin(stream_ids(out, chunks), dels).sum())
        require(bad == 0 and back == 0, f"serve: after the delete {bad} "
                f"rows differ from the facade, {back} deleted ids back")
        rep["delete"] = {"ids": 1024, "winners": int(np.isin(winners,
                                                             dels).sum()),
                         "delete_s": delete_s, "deleted_ids_back": back,
                         "launches": del_launches,
                         "wall_s": wall, "latency_ms": pctl(lat)}
        st = eng.stats()
    finally:
        eng.close()
    rep["stats"] = {k: st[k] for k in ("epoch", "completed", "qps",
                                       "latency_ms", "rounds_per_query",
                                       "plan_cache", "result_cache",
                                       "batches", "workers")}
    rep["launches"] = launches
    rep["replays"] = replays
    rep["by_route"] = route_counts(kmods)
    rep["seconds"] = time.perf_counter() - t_phase
    del eng
    return rep, launches


def l96_path(torch, api, isax, kmods, gen, n=1 << 20, Lx=96):
    """FreshIndex.build and search over n random walks of length 96 (the
    width of the Deep1B embeddings), w = 16: the summarize kernel's
    strided route, lb_distance's tiled one and refine_search's 3 CTAs an
    SM.  256 noisy collection queries, k = 10, held to brute force."""
    raw = walks(torch, gen, n, Lx)
    pick = torch.randint(0, n, (Q,), generator=gen, device=DEV)
    queries = raw[pick] + 0.1 * torch.randn(Q, Lx, generator=gen, device=DEV)
    torch.cuda.synchronize()
    reset(kmods)
    t0 = time.perf_counter()
    index = api.FreshIndex.build(raw, device=DEV)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    d, ids = index.search(queries, k=TOPK)
    torch.cuda.synchronize()
    search_ms = (time.perf_counter() - t0) * 1e3
    # the Refresh builder at 4 workers over 4 chunks: the one-pass bits
    b = api.FreshIndex.builder(workers=4, device=DEV)
    t0 = time.perf_counter()
    for c in raw.chunk(4):
        b.feed(c)
    built = b.finalize().index
    torch.cuda.synchronize()
    builder_s = time.perf_counter() - t0
    require(all(torch.equal(getattr(built, f), getattr(index.index, f))
                for f in built._fields),
            "L 96 path: the builder at 4 workers differs from one pass")
    launches = route_counts(kmods)
    for r in ("summarize/strided", "lb_distance/tiled", "refine_search/cta3",
              "leaf_stats/prefix", "leaf_gather/u16"):
        require(launches.get(r, 0) > 0, f"L 96 path: {r} not launched: "
                f"{launches}")
    del raw, built
    ties = hold_answers(torch, isax, index.index, queries, d, ids, "L 96")
    return {"phase": "l96", "series": n, "length": Lx, "segments": 16,
            "queries": Q, "k": TOPK, "build_s": build_s,
            "builder_4_workers_s": builder_s, "search_ms": search_ms,
            "near_ties": ties, "launches": launches}, launches


class LiveRows:
    """The lifecycle phase's live collection from the script's own data,
    not from the index's records: `raw` (ids 0..n-1), `extra` (ids n..,
    the adds) and `new_rows` (the updates' rows, answering as `upd`), with
    `dead` (the deleted ids, the expired TTL ids and the updated ids' old
    rows) out."""

    def __init__(self, torch, raw, extra, new_rows, upd, dead):
        n, m = raw.shape[0], extra.shape[0]
        self.torch, self.parts = torch, (raw, extra, new_rows)
        upd_t = torch.as_tensor(upd, dtype=torch.long, device=DEV)
        dead_t = torch.as_tensor(sorted(dead), dtype=torch.long, device=DEV)
        self.dead = dead_t
        # each part's ids, and whether each row is alive
        self.ids = (torch.arange(n, device=DEV),
                    n + torch.arange(m, device=DEV), upd_t)
        gone = torch.cat([dead_t, upd_t])
        self.alive = tuple(~torch.isin(i, gone) for i in self.ids[:2]) + (
            torch.ones(len(upd), dtype=torch.bool, device=DEV),)
        # id -> (part, row) for the answers
        self.part = torch.zeros(n + m, dtype=torch.long, device=DEV)
        self.part[n:] = 1
        self.part[upd_t] = 2
        self.row = torch.arange(n + m, device=DEV)
        self.row[n:] -= n
        self.row[upd_t] = torch.arange(len(upd), device=DEV)

    @property
    def n_alive(self) -> int:
        return int(sum(int(a.sum()) for a in self.alive))

    def rows_of(self, ids):
        """The raw rows that ids (any shape) answer for."""
        p, r = self.part[ids.long()], self.row[ids.long()]
        out = self.parts[0][r.clamp_max(self.parts[0].shape[0] - 1)]
        for j in (1, 2):
            src = self.parts[j][r.clamp_max(self.parts[j].shape[0] - 1)]
            out = self.torch.where((p == j)[..., None], src, out)
        return out

    def topk(self, isax, q, chunk=1 << 20, per_chunk=32):
        """Exact k-NN of the z-normalized queries q over the live rows,
        each z-normalized here (isax.znormalize): matmul-form candidates
        per chunk, then direct-form distances, ascending."""
        torch = self.torch
        qsq = (q * q).sum(1)
        cand_x, cand_i = [], []
        for x, ids, alive in zip(self.parts, self.ids, self.alive):
            for s in range(0, x.shape[0], chunk):
                xs = isax.znormalize(x[s:s + chunk].float())
                d2 = qsq[:, None] + (xs * xs).sum(1)[None] - 2 * q @ xs.T
                d2[:, ~alive[s:s + chunk]] = float("inf")
                j = d2.topk(min(per_chunk, xs.shape[0]), dim=1,
                            largest=False).indices
                cand_x.append(xs[j])
                cand_i.append(ids[s:s + chunk][j])
        xs, ids = torch.cat(cand_x, 1), torch.cat(cand_i, 1)
        d = ((q[:, None, :] - xs) ** 2).sum(-1)
        d, pos = torch.sort(d, dim=1, stable=True)
        return d[:, :TOPK].sqrt(), torch.gather(ids, 1, pos[:, :TOPK])


def hold_live(torch, isax, live, queries, d, ids, what):
    """The search's answer against the live rows (LiveRows): the same
    distances as their brute force (rtol/atol 1e-5), each id's own
    distance, no deleted id, and ids equal to the brute force's but at
    near-ties (counted)."""
    require(d.shape == (queries.shape[0], TOPK)
            and bool(torch.isfinite(d).all()) and bool((ids >= 0).all()),
            f"{what}: shape")
    require(not bool(torch.isin(ids.long(), live.dead).any()),
            f"{what}: a deleted id")
    q = isax.znormalize(queries).float()
    db, ib = live.topk(isax, q)
    require(torch.allclose(d, db, rtol=1e-5, atol=1e-5),
            f"{what}: distances differ from brute force by "
            f"{(d - db).abs().max().item()}")
    own = ((q[:, None, :] - isax.znormalize(live.rows_of(ids).float()))
           ** 2).sum(-1).sqrt()
    require(torch.allclose(own, d, rtol=1e-5, atol=1e-5),
            f"{what}: reported distances are not the ids' distances")
    return int((ids != ib).sum())


def lifecycle_engine(torch, api, ix, queries, gen, path, n_add=1 << 16,
                     Lx=L):
    """The serving engine on the lifecycle cell, with a MaintenancePolicy
    (TTL sweeps every millisecond, a compaction once a tombstone is 1.5 s
    old, a checkpoint a second): n_add adds (half with a 1 ms TTL) and
    deletes in core and delta; maintain() sweeps the TTL rows; an
    explicit compact(); more deletes; maintain() compacts and
    checkpoints.  Every answer is byte-equal to the facade's, the ids
    unchanged across each compaction, and the policy's checkpoint loads
    and answers the same."""
    import numpy as np
    from repro_torch.maintenance import FreshnessClass, MaintenancePolicy
    from repro_torch.serve import EngineConfig
    tier = FreshnessClass("smoke", sweep_interval_s=1e-3,
                          staleness_budget_s=1.5, compact_delta_rows=10**9,
                          compact_dead_frac=1.0)
    pol = MaintenancePolicy(freshness=tier, checkpoint_dir=str(path),
                            checkpoint_interval_s=1.0)
    qh = queries.cpu().numpy()
    rng = np.random.default_rng(int(torch.randint(
        0, 2**31, (1,), generator=gen, device=DEV)))
    n_core, first = ix.index.perm.shape[0], ix._next_id
    extra = walks(torch, gen, n_add, Lx)
    rep = {}

    def served(eng, what):
        got = eng.submit(qh, k=TOPK).result(timeout=300)
        want = host(ix.search(queries, k=TOPK))
        require(all(a.tobytes() == b.tobytes() for a, b in zip(got, want)),
                f"lifecycle engine, {what}: rows differ from the facade")
        return got[1]

    def timed(key, fn):
        t0 = time.perf_counter()
        out = fn()
        rep[key] = time.perf_counter() - t0
        return out

    with ix.engine(EngineConfig(max_batch=64, maintenance=pol)) as eng:
        eng.add(extra[:n_add // 2])
        eng.add(extra[n_add // 2:], ttl_s=1e-3)
        rep["deleted"] = eng.delete(np.concatenate([
            rng.choice(n_core, 4096, replace=False),
            first + rng.choice(n_add // 2, 512, replace=False)]))
        require(rep["deleted"] > 4096, "lifecycle engine: deletes")
        time.sleep(0.01)
        timed("maintain_sweep_s", eng.maintain)
        st = eng.stats()["maintenance"]
        require(st["sweeps"] == 1 and st["compacts"] == 0 and ix.n_ttl == 0,
                f"lifecycle engine: the first maintain() ran {st}")
        ids_a = served(eng, "pending")
        timed("compact_s", eng.compact)
        require(ix.n_pending == 0 and ix.n_deleted == 0,
                "lifecycle engine: compact() left rows pending")
        ids_b = served(eng, "compacted")
        require(np.array_equal(ids_a, ids_b),
                "lifecycle engine: compact() changed ids")
        rep["deleted_more"] = eng.delete(rng.choice(n_core, 1024,
                                                    replace=False))
        ids_c = served(eng, "tombstones")
        time.sleep(1.6)
        timed("maintain_compact_checkpoint_s", eng.maintain)
        st = eng.stats()
        require(st["maintenance"]["compacts"] >= 1
                and st["maintenance"]["checkpoints"] >= 1
                and st["compactions"] == 2 and ix.n_deleted == 0,
                f"lifecycle engine: the policy ran {st['maintenance']}")
        ids_d = served(eng, "policy-compacted")
        require(np.array_equal(ids_c, ids_d),
                "lifecycle engine: the policy's compaction changed ids")
        ld = timed("policy_checkpoint_load_s",
                   lambda: api.FreshIndex.load(str(path), device=DEV))
        got = host(ld.search(queries, k=TOPK))
        require(np.array_equal(got[1], ids_d) and ld.n_series == ix.n_series,
                "lifecycle engine: the policy's checkpoint answers otherwise")
        del ld
        rep["maintenance"] = st["maintenance"]
        rep["plan_cache"] = st["plan_cache"]
        rep["epoch"] = st["epoch"]
    return rep


def lifecycle_path(torch, api, isax, kmods, gen, n=1 << 22, n_add=1 << 16,
                   n_upd=1024, Lx=L):
    """The Refresh builder, the lifecycle and checkpoints at n random walks
    of length 256 with IndexConfig() defaults: three builds each at 1 and
    4 workers (4 chunks), in turns, with their medians and each phase's
    seconds, and one at 4 with one worker crashing, each bit-equal to the
    one-pass build; adds (one batch with a TTL), deletes in core and
    delta, updates, TTL expiry, with the counts they return and n_series
    held to the script's own books; searches held to a tombstone-aware
    brute force over the script's own live rows (LiveRows) before and
    after compaction, the same ids after it; save, load and reload, the
    search bit-equal after each."""
    import shutil

    import numpy as np
    from repro_torch.core.refresh import Injectors
    raw = walks(torch, gen, n, Lx)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset(kmods)
    rep = {"phase": "lifecycle", "series": n, "length": Lx}

    def timed(key, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        rep[key] = time.perf_counter() - t0
        return out

    def wall_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    def same(a, b, what):
        for f in a._fields:
            require(torch.equal(getattr(a, f), getattr(b, f)),
                    f"{what}: {f} differs")

    ix = timed("build_s", lambda: api.FreshIndex.build(raw, device=DEV))

    def chunked(builder):
        for c in raw.chunk(4):
            builder.feed(c)
        return builder.finalize()

    # three builds each at 1 worker (one feed) and at 4 (4 chunks), in
    # turns: a build moves by up to 2 x between calls, so medians
    runs = {1: [], 4: []}
    for workers in (1, 4) * 3:
        b = api.FreshIndex.builder(workers=workers, device=DEV)
        built = timed("builder_s", lambda: (b.feed(raw).finalize()
                                            if workers == 1
                                            else chunked(b)))
        same(built.index, ix.index, f"builder, {workers} worker(s)")
        runs[workers].append({"s": rep.pop("builder_s"), "phases": {
            p: r["wall_time"] for p, r in b.report()["phases"].items()}})
        del built, b
    for workers, rs in runs.items():
        key = f"builder_{workers}_worker{'s' if workers > 1 else ''}"
        rep[f"{key}_s"] = [r["s"] for r in rs]
        rep[f"{key}_median_s"] = statistics.median(r["s"] for r in rs)
        rep[f"{key}_phases_s"] = [r["phases"] for r in rs]
        rep[f"{key}_phases_median_s"] = {
            p: statistics.median(r["phases"][p] for r in rs)
            for p in rs[0]["phases"]}
    crash = api.FreshIndex.builder(
        workers=4, device=DEV, injectors=Injectors.crashing({1}, after=3))
    b4c = timed("builder_4_workers_crash_s", lambda: chunked(crash))
    same(b4c.index, ix.index, "builder, 4 workers, one crashed")
    rep["crashed_workers"] = sum(p["crashed_workers"] for p in
                                 crash.report()["phases"].values())
    require(rep["crashed_workers"] >= 1, "no worker crashed")
    del b4c, crash

    rng = np.random.default_rng(int(torch.randint(
        0, 2**31, (1,), generator=gen, device=DEV)))
    extra = walks(torch, gen, n_add, Lx)
    half = n_add // 2
    now = time.monotonic()
    timed("add_s", lambda: (ix.add(extra[:half]),
                            ix.add(extra[half:], ttl_s=1000.0)))
    # n_add deletes, half of them core ids, half delta ids
    dels = np.concatenate([rng.choice(n, half, replace=False),
                           n + rng.choice(n_add, half, replace=False)])
    rep["deleted"] = timed("delete_s", lambda: ix.delete(dels))
    require(rep["deleted"] == n_add,
            f"delete() deleted {rep['deleted']} ids, not {n_add}")
    dead = set(dels.tolist())
    upd = [int(i) for i in rng.choice(n, 4 * n_upd, replace=False)
           if int(i) not in dead][:n_upd]
    new_rows = walks(torch, gen, len(upd), Lx)
    timed("update_s", lambda: [ix.update(sid, new_rows[j])
                               for j, sid in enumerate(upd)])
    rep["expired"] = ix.expire_ttl(now=now + 2000.0)
    ttl_ids = set(range(n + half, n + n_add))
    require(rep["expired"] == len(ttl_ids - dead),
            f"expire_ttl() expired {rep['expired']} ids, not the "
            f"{len(ttl_ids - dead)} TTL ids still alive")
    live = LiveRows(torch, raw, extra, new_rows, upd, dead | ttl_ids)
    rep["n_series"] = ix.n_series
    require(rep["n_series"] == live.n_alive,
            f"n_series {rep['n_series']}, but {live.n_alive} rows live")
    rep["n_pending"] = ix.n_pending
    rep["n_deleted"] = ix.n_deleted

    # queries: noisy copies of live core rows, and of 16 updated rows
    alive_core = np.setdiff1d(np.arange(n), np.array(sorted(dead | set(upd))))
    pick = torch.as_tensor(rng.choice(alive_core, Q - 16, replace=False),
                           device=DEV)
    queries = torch.cat([raw[pick], new_rows[:16]]) + 0.1 * torch.randn(
        Q, Lx, generator=gen, device=DEV)
    # the first search also builds the masked view (search_view)
    d, ids = timed("search_pending_s", lambda: ix.search(queries, k=TOPK))
    rep["search_pending_ms"] = rep.pop("search_pending_s") * 1e3
    rep["search_pending_ms_repeats"] = [
        wall_ms(lambda: ix.search(queries, k=TOPK)) for _ in range(3)]
    rep["near_ties_pending"] = hold_live(torch, isax, live, queries, d, ids,
                                         "lifecycle, pending")
    nn_upd = ids[Q - 16:, 0].tolist()
    rep["updated_answer_stable"] = sum(a == b for a, b in
                                       zip(nn_upd, upd[:16]))
    require(rep["updated_answer_stable"] == 16,
            f"updated rows do not answer under their stable ids: {nn_upd}")

    timed("compact_s", ix.compact)
    d2, ids2 = timed("search_compacted_s", lambda: ix.search(queries,
                                                             k=TOPK))
    rep["search_compacted_ms"] = rep.pop("search_compacted_s") * 1e3
    rep["search_compacted_ms_repeats"] = [
        wall_ms(lambda: ix.search(queries, k=TOPK)) for _ in range(3)]
    rep["near_ties_compacted"] = hold_live(torch, isax, live, queries, d2,
                                           ids2, "lifecycle, compacted")
    del live, raw, extra
    torch.cuda.empty_cache()
    # the delta scan read the rows as compaction stores them (delta_rows),
    # so compaction moves no id
    require(torch.equal(ids2, ids), f"compaction changed "
            f"{int((ids2 != ids).sum())} ids")
    require(torch.allclose(d2, d, rtol=1e-5, atol=1e-5),
            "compaction moved a distance")
    rep["distance_bits_moved_by_compaction"] = int((d2 != d).sum())
    before = {f: getattr(ix.index, f).clone() for f in ix.index._fields}
    ix.compact()
    for f, a in before.items():
        require(torch.equal(a, getattr(ix.index, f)),
                f"compact twice: {f} differs")
    del before

    # a calibration table (two settings) travels with the checkpoint
    table = timed("calibrate_s", lambda: ix.calibrate(
        ks=(TOPK,), targets=(0.9,), n_queries=16, eps_grid=(0.5,),
        leaves_grid=(64, 1024), repeat=1))
    rep["calibration"] = [{"k": k_, "target": t, **e.to_dict()}
                          for (k_, t), e in table.items()]
    root = Path(__file__).resolve().parent / ".smoke_ckpt"
    try:
        path = timed("save_s", lambda: ix.save(str(root), step=1))
        rep["checkpoint_bytes"] = sum(p.stat().st_size
                                      for p in Path(path).iterdir())
        ld = timed("load_s", lambda: api.FreshIndex.load(str(root),
                                                         device=DEV))
        d3, ids3 = ld.search(queries, k=TOPK)
        require(torch.equal(d3, d2) and torch.equal(ids3, ids2),
                "search after load differs")
        require(ld.calibration.to_dict() == table.to_dict()
                and ld.is_calibration_fresh(),
                "the calibration table did not survive save and load")
        del ld
        ix.add(new_rows[:8])
        timed("reload_s", lambda: ix.reload(str(root)))
        d4, ids4 = ix.search(queries, k=TOPK)
        require(torch.equal(d4, d2) and torch.equal(ids4, ids2),
                "search after reload differs")
        rep["engine"] = lifecycle_engine(torch, api, ix, queries, gen,
                                         root / "policy")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    rep["peak_alloc_gib"] = torch.cuda.max_memory_allocated() / 2**30
    launches = route_counts(kmods)
    for r in ("summarize/lanes", "lb_distance/tiled", "refine_search/cta3",
              "leaf_stats/prefix", "leaf_gather/u16"):
        require(launches.get(r, 0) > 0, f"lifecycle: {r} not launched: "
                f"{launches}")
    launches |= {name: kmods[name].launches
                 for name in ("leaf_stats", "leaf_gather")}
    rep["launches"] = launches
    return rep, launches


SHARDS = 4                      # slots of the sharded phase's mesh
SHARD_KERNELS = ("summarize", "lb_distance", "refine_topk")


def tie_mismatches(torch, d, ids, d_want, i_want, what) -> int:
    """(d, ids), k columns, against the first k of wanted rows: the
    distances within 1e-5 (relative and absolute), the ids equal but
    where the wanted list holds two distances within 1e-5 relative at
    that slot (its neighbour may lie past column k).  Returns the slots
    whose ids differ (each such a tie)."""
    k = d.shape[1]
    require(torch.allclose(d, d_want[:, :k], rtol=1e-5, atol=1e-5),
            f"{what}: distances differ by "
            f"{(d - d_want[:, :k]).abs().max().item()}")
    mism = ids != i_want[:, :k]
    if bool(mism.any()):
        near = torch.zeros_like(i_want, dtype=torch.bool)
        close = ((d_want[:, 1:] - d_want[:, :-1]).abs()
                 <= 1e-5 * d_want[:, 1:].abs())
        near[:, 1:] |= close
        near[:, :-1] |= close
        require(bool(near[:, :k][mism].all()), f"{what}: ids differ where "
                f"no two distances lie within 1e-5")
    return int(mism.sum())


def deprecated_sharded(torch, mesh, six, queries, want) -> str:
    """The deprecated make_sharded_search at k 1, sync_every 1, over the
    sharded facade's shards: it warns, and its answer is byte-equal to
    the facade's `want` (dist, ids)."""
    import warnings
    from repro_torch.core import make_sharded_search
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        fn = make_sharded_search(mesh, k=1, sync_every=1, config=six.config)
    require(any(w.category is DeprecationWarning
                and "FreshIndex.shard" in str(w.message) for w in seen),
            "make_sharded_search did not warn")
    got = fn(six.shard_view(), queries)
    require(all(torch.equal(a, b) for a, b in zip(got, want)),
            "make_sharded_search at k 1 differs from the sharded facade")
    return "warned; byte-equal to the sharded facade at k 1"


def shard_counts(kmods) -> dict:
    return {name: kmods[name].launches for name in SHARD_KERNELS}


def sharded_path(torch, api, isax, kmods, index, queries, d, ids, gen):
    """The main cell's index (2^24 walks, the main phase's arrays, no
    copy) sharded over a mesh of 4 slots on cuda:0 through FreshIndex.
    shard: 256 queries at k 1 and 10, sync_every 1 and 4, each search's
    rounds, host reads, ms, launches (lb_distance once a shard,
    refine_topk once a shard a round), peak memory beside the local
    search's; the ids held to brute force (k 10) and to the local search,
    equal but at ties; the card's busy time over one k-10 search
    (torch.profiler), and refine_topk's device ms a launch in it.  Then the engine on the sharded index
    (EngineConfig(max_batch=64, sync_every=2, warm_ks=(10,))): submits
    of 1, 8 and 64 rows byte-equal to the sharded facade; an add of
    4,096 series (a mesh-wide epoch) and a submit that finds them; a
    delete of 64 ids, none back.  Then recovery at 2^22 walks: shard
    over 2 slots, save, recover(ckpt, mesh=<1 slot>) with a future in
    flight, both answers exact."""
    import numpy as np
    from repro_torch.runtime import make_mesh
    from repro_torch.serve import EngineConfig
    n = index.index.perm.shape[0]
    rep = {"phase": "sharded", "series": n, "queries": Q, "slots": SHARDS,
           "device": "cuda:0",
           "cards_visible": torch.cuda.device_count()}
    if torch.cuda.device_count() >= SHARDS:
        rep["note"] = (f"{torch.cuda.device_count()} cards visible; the "
                       f"slots stay on cuda:0, the card the last line "
                       f"reports")
    t_phase = time.perf_counter()
    mesh = make_mesh((SHARDS,), ("data",), [DEV + ":0"] * SHARDS)
    torch.cuda.synchronize()
    alloc0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    d_loc, _ = index.search(queries, k=TOPK)
    torch.cuda.synchronize()
    local_peak = torch.cuda.max_memory_allocated() - alloc0
    del d_loc
    # a facade of its own over the main index's arrays: shard() moves
    # nothing (the slots are the index's device) and adds no padding
    # (2^18 leaves), so the shards are views; the main index stays local
    six = api.FreshIndex(index.index, index.config)
    t0 = time.perf_counter()
    six.shard(mesh)
    rep["shard_s"] = time.perf_counter() - t0
    require(six.index.series.data_ptr() == index.index.series.data_ptr()
            and all(sh.series.device == index.device
                    for sh in six.shard_view()),
            "sharded: the shards are not views of the main index")
    rep["searches"] = {}
    launches = {name: 0 for name in SHARD_KERNELS}
    for k in (1, TOPK):
        for sync in (1, 4):
            kn = six.search_knobs()
            plan = six.sharded_plan(k, round_leaves=kn.round_leaves,
                                    sync_every=sync, max_rounds=None,
                                    pq_budget=kn.pq_budget, stop_eps=0.0,
                                    stop_leaves=None)
            c0 = (plan.rounds, plan.rounds_launched, plan.host_reads)
            torch.cuda.synchronize()
            a0 = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            reset(kmods)
            t0 = time.perf_counter()
            ds, is_ = six.search(queries, k=k, sync_every=sync)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            got = shard_counts(kmods)
            peak = torch.cuda.max_memory_allocated() - a0
            rounds, ran, reads = (b - a for a, b in zip(c0, (
                plan.rounds, plan.rounds_launched, plan.host_reads)))
            require(got["lb_distance"] == SHARDS
                    and got["refine_topk"] == SHARDS * ran > 0,
                    f"sharded k {k} sync {sync}: launches {got} for {ran} "
                    f"rounds run over {SHARDS} shards")
            for name in SHARD_KERNELS:
                launches[name] += got[name]
            if k == 1:
                ds, is_ = ds[:, None], is_[:, None]
            ties = tie_mismatches(torch, ds, is_, d, ids,
                                  f"sharded k {k} sync {sync} vs local")
            entry = {"ms": ms, "rounds": rounds, "rounds_run": ran,
                     "host_reads": reads,
                     "ms_per_round": ms / ran, "launches": got,
                     "peak_alloc_gib": peak / 2**30,
                     "peak_above_local_gib": (peak - local_peak) / 2**30,
                     "ties_vs_local": ties}
            if k == TOPK and sync == 1:
                entry["ties_vs_bruteforce"] = hold_answers(
                    torch, isax, index.index, queries, ds, is_,
                    "sharded k 10")
            if k == 1 and sync == 1:
                k1 = (ds[:, 0], is_[:, 0])
            rep["searches"][f"k{k}_sync{sync}"] = entry
    rep["local_peak_alloc_gib"] = local_peak / 2**30
    rep["deprecated_make_sharded_search"] = deprecated_sharded(
        torch, mesh, six, queries, k1)
    # where a sharded search's time goes: the card's busy time against
    # the wall (k 10, sync_every 1), outside the counted searches
    t0 = time.perf_counter()
    rep["device_time"] = profile_search(torch, six, queries,
                                        ("topk_kernel",))
    rep["device_time"]["profiling_s"] = time.perf_counter() - t0

    # the engine on the sharded index: eager sharded plans
    cfg = EngineConfig(max_batch=64, sync_every=2, warm_ks=(TOPK,))
    qh = queries.cpu().numpy()
    want = host(six.search(queries[:64], k=TOPK, sync_every=2))
    eng = six.engine(cfg)
    try:
        t0 = time.perf_counter()
        eng.warmup()
        rep["engine"] = {"warmup_s": time.perf_counter() - t0,
                         "plans": eng.stats()["plan_cache"]}
        sub = {}
        for rows in (1, 8, 64):
            t0 = time.perf_counter()
            got = eng.submit(qh[:rows], k=TOPK).result(timeout=300)
            sub[rows] = (time.perf_counter() - t0) * 1e3
            require(np.asarray(got[0]).tobytes() == want[0][:rows].tobytes()
                    and np.asarray(got[1]).tobytes()
                    == want[1][:rows].tobytes(),
                    f"sharded engine: a submit of {rows} rows differs from "
                    f"the sharded facade")
        st = eng.stats()
        require(st["plan_cache"]["misses"] == rep["engine"]["plans"][
            "misses"] and st["mesh"] == {"axes": {"data": SHARDS},
                                         "devices": SHARDS},
                f"sharded engine: {st['plan_cache']}, {st['mesh']}")
        rep["engine"]["submit_ms"] = sub
        # an add: a mesh-wide epoch, and queries next to the new series
        extra = walks(torch, gen, 4096, L)
        q_new = (extra[:8] + 0.01 * torch.randn(8, L, generator=gen,
                                                device=DEV)).cpu().numpy()
        epoch = eng.epoch
        t0 = time.perf_counter()
        eng.add(extra)
        rep["engine"]["add_s"] = time.perf_counter() - t0
        require(eng.epoch == epoch + 1, "sharded engine: add published no "
                "epoch")
        got = eng.submit(q_new, k=TOPK).result(timeout=300)
        fac = host(six.search(q_new, k=TOPK, sync_every=2))
        require(np.asarray(got[0]).tobytes() == fac[0].tobytes()
                and np.asarray(got[1]).tobytes() == fac[1].tobytes(),
                "sharded engine: the submit after the add differs from the "
                "facade")
        found = int((np.asarray(got[1])[:, 0] == n + np.arange(8)).sum())
        require(found == 8, f"sharded engine: {found} of 8 new series "
                f"found by their own queries after the add")
        # a delete of 64 ids, the winners of the first rows among them
        dels = np.unique(np.concatenate([want[1][:16, 0],
                                         n + np.arange(8)]))
        extra_ids = np.setdiff1d(np.arange(n - 256, n), dels)
        dels = np.concatenate([dels, extra_ids[:64 - len(dels)]])
        require(len(dels) == 64, "sharded engine: the delete set")
        require(eng.delete(dels) == 64, "sharded engine: delete()")
        qd = np.concatenate([qh[:16], q_new])
        got = eng.submit(qd, k=TOPK).result(timeout=300)
        fac = host(six.search(qd, k=TOPK, sync_every=2))
        back = int(np.isin(np.asarray(got[1]), dels).sum())
        require(np.asarray(got[0]).tobytes() == fac[0].tobytes()
                and np.asarray(got[1]).tobytes() == fac[1].tobytes()
                and back == 0, f"sharded engine: after the delete the "
                f"submit differs from the facade, {back} deleted ids back")
        st = eng.stats()
        rep["engine"] |= {"deleted_ids_back": back, "epoch": st["epoch"],
                          "completed": st["completed"],
                          "rounds_per_query": st["rounds_per_query"],
                          "plan_cache": st["plan_cache"],
                          "mesh": st["mesh"]}
    finally:
        eng.close()
    del eng, six
    torch.cuda.empty_cache()
    rep["recover"] = sharded_recover(torch, api, isax, gen)
    rep["launches"] = launches
    rep["seconds"] = time.perf_counter() - t_phase
    return rep, launches


def sharded_recover(torch, api, isax, gen, n=1 << 22, nq=64):
    """2^22 walks sharded over 2 slots of cuda:0, saved; the engine
    recovers onto 1 slot with a future in flight: both answers exact."""
    import shutil

    from repro_torch.runtime import make_mesh
    raw = walks(torch, gen, n, L)
    pick = torch.randint(0, n, (nq,), generator=gen, device=DEV)
    q = raw[pick] + 0.1 * torch.randn(nq, L, generator=gen, device=DEV)
    ix = api.FreshIndex.build(raw, device=DEV)
    del raw
    ix.shard(make_mesh((2,), ("data",), [DEV + ":0"] * 2))
    root = Path(__file__).resolve().parent / ".smoke_ckpt" / "sharded"
    rep = {"series": n, "queries": nq, "slots_before": 2, "slots_after": 1}
    try:
        t0 = time.perf_counter()
        ix.save(str(root))
        rep["save_s"] = time.perf_counter() - t0
        eng = ix.engine(max_batch=64, workers=1, linger_ms=1.0)
        try:
            qh = q.cpu().numpy()
            fut = eng.submit(qh, k=TOPK)
            rep["in_flight_at_recover"] = not fut.done()
            t0 = time.perf_counter()
            eng.recover(str(root), mesh=make_mesh((1,), ("data",),
                                                  [DEV + ":0"]))
            rep["recover_s"] = time.perf_counter() - t0
            old = fut.result(timeout=300)
            new = eng.submit(qh, k=TOPK).result(timeout=300)
            st = eng.stats()
            require(st["mesh"] == {"axes": {"data": 1}, "devices": 1}
                    and st["recoveries"] == 1,
                    f"sharded recover: mesh {st['mesh']}, recoveries "
                    f"{st['recoveries']}")
        finally:
            eng.close()
    finally:
        shutil.rmtree(root.parent, ignore_errors=True)
    idx = ix.index
    rep["ties"] = {}
    for what, (dg, ig) in (("in_flight", old), ("after", new)):
        dg, ig = torch.as_tensor(dg, device=DEV), torch.as_tensor(
            ig, device=DEV)
        rep["ties"][what] = hold_answers(torch, isax, idx, q, dg, ig,
                                         f"sharded recover {what}")
    return rep


# ---------------------------------------------------------------------- dtw
DTW_N, DTW_Q, DTW_R, DTW_RK, DTW_BRUTE, DTW_PAIRS = 1 << 22, 256, 12, 32, 32, 4096
# the wide-band run: r 10 % of L, its first groups held to the plain
# version, its first queries to the brute force
DTW_WIDE_R, DTW_WIDE_GROUPS, DTW_WIDE_BRUTE = 25, 2, 32
# the wider bands' runs (dtw_search's wave4, wave8: 20 % and 40 % of L) on
# the first group, its first queries held to the brute force; their table
# rows on a cut search: each query's first DTW_WIDER_CUT candidates by bound
DTW_WIDER_R, DTW_WIDER_BRUTE, DTW_WIDER_CUT = (51, 102), 32, 1 << 15
# dtw_scan's wave route is timed at each r on the brute force's queries
# (at r 12 beside the band route, which keeps r <= 16), and the chain
# route once at r 25 on DTW_OTHER_Q queries
DTW_OTHER_Q = 8
# the long-series run: (series, L, radii), 32 queries each: the UCR
# archive's HandOutlines length (2,709) over 2^16 walks (0.71 GB) at 1 %
# and 5 % bands, and 8,192 points over 2^14 (0.54 GB) at 1 %
DTW_LONG = ((1 << 16, 2709, (27, 135)), (1 << 14, 8192, (81,)))
DTW_LONG_Q = 32
# the cells a lane at which the long series' dtw_search rows count the
# cells an abandoning DP needs (their bound): each radius's width before
# the widths by radius (search_ring_cells), so that the yardstick stays
# put as the route changes; the route's own count is printed beside it
DTW_LONG_CELLS = {27: 2, 135: 16, 81: 8}
# lb_keogh at other lengths: (series, L, queries, r 5 % of L)
DTW_LB_SHAPES = ((1 << 20, 1024, 24, 51), (1 << 22, 100, 32, 5))
# pairs a dtw_band_ref call of dtw_search_ref takes on the card (its answer
# is the same at any chunk; 2^20 pairs of 256 hold ~3 GiB and take ~16x
# fewer host-driven DP sweeps than its default 2^16)
DTW_REF_PAIRS = 1 << 20
# the long-query run: past the longest query a kernel stages in shared
# memory (kernels.dtw.STAGE_L, 16,384 points), (series, L, queries, radii):
# every route of both kernels that takes each radius, bit for bit
DTW_LONGQ = (256, 16400, 4, (12, 40, 200))
# the band past a block's shared memory (r > 25,599, the diag routes'
# default): (series, L, queries, r)
DTW_DEVBAND = (3, 25700, 2, 25650)
# the full window, r = L - 1, where spread and chain are the defaults:
# (series, L, queries)
DTW_FULL = (256, 1024, 4)
# the dtw_wide phase: the shapes the spread and chain routes take (past
# the wave routes' radii at L <= 1,024, a 10 % band at HandOutlines'
# length, and round_k past 1,024), at the full window's size (DTW_FULL: 4
# queries x 256 z-normalized walks): (L, r, round_k)
DTW_SWEEP = ((256, 128, 32), (256, 192, 32), (256, 255, 32),
             (1024, 128, 32), (1024, 256, 32), (1024, 512, 32),
             (1024, 1023, 32), (2709, 271, 32), (256, 12, 2048))
# and at a cell's size: the long cell's 2^16 walks and 32 queries at a 10 %
# band of HandOutlines' 2,709 points (both kernels) and at L 1,024, r 512
# (the scan); (series, L, r, the search too), the first DTW_WIDE_PLAIN
# queries held bit for bit to the plain versions
DTW_WIDE_CELLS = ((1 << 16, 2709, 271, True), (1 << 16, 1024, 512, False))
DTW_WIDE_Q, DTW_WIDE_PLAIN = 32, 1
# dtw_scan's chain and diag routes on few pairs, where the default turns
# from diag to chain (kernels.dtw.CHAIN_PAIRS): (queries, series), L 2,709,
# r 271
DTW_FEW = ((1, 128), (2, 256), (4, 256), (8, 256))
DTW_SRC = "src/repro_torch/kernels/csrc/dtw.cu"
DTW_REPLACES = ("none: a port-side kernel (src/repro/core/dtw.py:{} {} is "
                "plain jnp, no Pallas kernel)")


def plain_scan(torch, ref, q1, x, r):
    """ref.dtw_scan_ref of one query over the collection, timed once:
    (ms, squared distance (1,), id (1,))."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d2, i = ref.dtw_scan_ref(q1, x, r)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, d2, i


def scan_layout(kd, route: str, r: int) -> dict:
    """A dtw_scan wave or ring route's lanes at radius r: its cells a lane
    and the busy lanes of a warp (H P of 32); {} for the other routes."""
    cells = {**kd.SCAN_CELLS, **kd.SCAN_RING_CELLS}.get(route)
    if cells is None:
        return {}
    H, P = kd.scan_lanes(r, cells)
    return {"cells": cells, "busy_lanes": H * P}


def scan_rows(torch, kd, ref, x, q, r, want, launches, plain=None):
    """dtw_scan's table row of its wave route at radius r on the queries
    q (nq, L): held to `want` (the brute force's distances and ids: its
    squared distances' roots, bit for bit) and, on the first query, to
    the plain version's (ref.dtw_scan_ref, bit for bit; `plain`: its
    (ms, d2, i) where the caller has it, else run here and timed once),
    then timed (the mean of 2 launches by CUDA events); the bound counts
    every band cell of every pair (the scan abandons none); launches are
    `launches`'s for the route (the path's run)."""
    nq, route = q.shape[0], "wave16"
    bms, by = rl.dtw_scan_work(nq, DTW_N, L, r).bound()
    plain_ms, pd2, pi = plain or plain_scan(torch, ref, q[:1], x, r)
    shape = (f"{nq} queries x {DTW_N} series, L {L}, r {r} (the brute "
             f"force's queries)")
    d2, i = kd.dtw_scan(q, x, r=r, route=route)
    require(torch.equal(torch.sqrt(d2), want[0]) and torch.equal(i, want[1]),
            f"dtw_scan {route} r {r}: differs from the brute force's")
    require(torch.equal(d2[:1], pd2) and torch.equal(i[:1], pi),
            f"dtw_scan {route} r {r}: differs from dtw_scan_ref")
    ms = time_ms(torch, lambda: kd.dtw_scan(q, x, r=r, route=route), 2, 0)
    row = route_row("dtw_scan", f"{route}_r{r}", DTW_SRC,
                    DTW_REPLACES.format(173, "search_dtw_bruteforce"),
                    shape, 0.0, ms, plain_ms, bms, by,
                    {"brute force's queries": "bit-equal",
                     "first query": "bit-equal to dtw_scan_ref"})
    row |= {"plain_queries": 1, **scan_layout(kd, route, r),
            "launches_on_path": launches.get(f"dtw_scan/{route}", 0)}
    return [row]


def needed_cells(torch, ref, kd, q, x, sorted_lb, order, trace, r: int,
                 round_k: int, route: str, chunk: int = 1 << 18,
                 check: bool = True) -> int:
    """The cells dtw_search's `route` needs at least: for each candidate
    that dtw_search_ref refined (its `trace`: each round's start and the
    best-so-far there; the round's candidates below it are refined), on a
    wave or ring route (an early-abandoning wavefront of
    kd.wave_cells(route) cells a lane) the cells of every step up to and
    including the first whose least cell reaches that best-so-far (all of
    them where none does: the pair may improve it), on a strip route
    (spread, diag: no abandoning) every band cell.  Each step's least cell
    comes from ref.dtw_wavefront_ref(step_least=True) on the card, `chunk`
    pairs a call.  Stopping at the first such step, against the
    best-so-far of the round's start, no kernel of these rounds forms
    fewer cells.  `check=False`: the model without its bookkeeping's
    asserts (ref.dtw_wavefront_ref), for the long series."""
    N = x.shape[0]
    cells = {**kd.WAVE_CELLS, **kd.RING_CELLS}.get(route)
    qi, sid, cut = [], [], []
    for g, (starts, bsf) in enumerate(trace):
        pos = (torch.as_tensor(starts, device=DEV)[:, None]
               + torch.arange(round_k, device=DEV))
        bs = torch.as_tensor(bsf, device=DEV)[:, None].expand_as(pos)
        take = (pos < N) & (sorted_lb[g, pos.clamp_max(N - 1)] < bs)
        qi.append(torch.full((int(take.sum()),), g, device=DEV))
        sid.append(order[g, pos[take]])
        cut.append(bs[take])
    qi, sid, cut = torch.cat(qi), torch.cat(sid), torch.cat(cut)
    if cells is None:
        return len(qi) * rl.dtw_cells(x.shape[1], r)
    cum = rl.wave_step_cells(x.shape[1], r, cells).cumsum(0).to(DEV)
    total = 0
    for a in range(0, len(qi), chunk):
        _, least = ref.dtw_wavefront_ref(q[qi[a:a + chunk]],
                                         x[sid[a:a + chunk]], r, cells,
                                         step_least=True, check=check)
        hit = least >= cut[a:a + chunk, None]
        hit[:, :r // cells] = False     # no cell yet: cell (0, 0) is the first
        stop = torch.where(hit.any(1), hit.int().argmax(1),
                           least.shape[1] - 1)
        total += int(cum[stop].sum())
    return total


def lb_launches(kd, Lx: int, groups: int = 1) -> dict:
    """lb_keogh's launches by route for `groups` groups of queries at
    length Lx: one a group to L 1,024; past it two, the envelopes and the
    sums."""
    out = {f"lb_keogh/{kd.lb_route(Lx)}": groups}
    if Lx > kd.WHOLE_L:
        out["lb_keogh/envelope"] = groups
    return out


def rel_err(torch, a, b) -> float:
    """max |a - b| / max(|b|, 1)."""
    return float(((a - b).abs() / b.abs().clamp_min(1.0)).max()) \
        if a.numel() else 0.0


def dtw_small(torch, isax, kd, ref, gen, n, Lx, nq, r, rk):
    """Collection, queries (z-normalized) and the three kernels against
    their plain versions at one small shape: lb_keogh to 1e-5 relative,
    dtw_search and dtw_scan on every route that takes the radius (after
    the clamp to L - 1: the default, spread or chain, diag) bit for bit.
    Returns the check's numbers."""
    x = isax.znormalize(walks(torch, gen, n, Lx)).contiguous()
    pick = torch.randint(0, n, (nq,), generator=gen, device=DEV)
    q = isax.znormalize(x[pick] + 0.1 * torch.randn(
        nq, Lx, generator=gen, device=DEV)).contiguous()
    lb = kd.lb_keogh(q, x, r=r)
    lb_err = rel_err(torch, lb, ref.lb_keogh_ref(q, x, r))
    require(lb_err <= 1e-5, f"lb_keogh L {Lx} r {r}: {lb_err}")
    s, o = torch.sort(lb, dim=1, stable=True)
    got = kd.dtw_search(q, x, s, o, r=r, round_k=rk)
    want = ref.dtw_search_ref(q, x, s, o, r, rk)
    require(all(torch.equal(a, b) for a, b in zip(got, want)),
            f"dtw_search N {n} L {Lx} r {r} round_k {rk}: not bit-equal")
    search_routes = kd.dp_routes(min(r, Lx - 1), Lx, rk)
    for route in search_routes[1:]:
        other = kd.dtw_search(q, x, s, o, r=r, round_k=rk, route=route)
        require(all(torch.equal(a, b) for a, b in zip(other, want)),
                f"dtw_search {route} N {n} L {Lx} r {r} round_k {rk}: not "
                f"bit-equal")
    d2r, ir = ref.dtw_scan_ref(q, x, min(r, Lx - 1))
    routes = kd.scan_routes(min(r, Lx - 1), Lx)
    for route in routes:
        d2, i = kd.dtw_scan(q, x, r=r, route=route)
        require(torch.equal(d2, d2r) and torch.equal(i, ir),
                f"dtw_scan {route} N {n} L {Lx} r {r}: not bit-equal")
    require(bool((got[0] == d2r).all()),
            f"search and scan N {n} L {Lx} r {r}: distances differ")
    return {"N": n, "L": Lx, "queries": nq, "r": r, "round_k": rk,
            "lb_rel_err": lb_err, "rounds_max": int(got[2].max()),
            "refined": int(got[3].sum()), "search": "bit-equal",
            "search_routes": list(search_routes),
            "scan": "bit-equal", "scan_routes": list(routes)}


def dtw_edges(torch, isax, kd, ref, gen):
    """The edge runs: the wave2 route at r 0, 1, 12, 15 and 16 (r + 1
    lanes a pair: 32, 16, 2, 2 and 1 pairs a warp) at L 100, and at
    round_k 100 with r 16 (more pairs than the block runs at once) and
    round_k 64 with r 0; the wave routes at each end of their radii (r
    17, 25 and 31: 2 cells a lane; 32, 40 and 63: 4; 64 and 127: 8) and
    the spread route at r 128, at L 100 (r 128 and 255: the band wider
    than the series, taken as r 99 by wave8) and L 300, N not a multiple
    of round_k; the scalar LB_Keogh
    route at L 101; N < round_k.  Every dtw_scan route that takes each
    radius runs there too (dtw_small), so the scan's wave route meets
    both ends of its radii (r 17 and 255 at L 300; at L 100, r past
    99 is 99); then N 1, 40 queries over 75 tiles and 64 over 125 (the
    scan's chunks taken smaller to fill the card), r = L - 1, 2L and 900
    at L 16, L 1024 at r 1023 (the spread route and the scan's chain and
    diag routes), and dtw_search at r 128 with round_k 256 and 1024 (the
    spread route, rounds at once).  Past the old limits: L 1,025 at r 3
    and 40 (the ring routes: every width of the search's, 2 to 16 cells a
    lane, and of the scan's, 16 to 24) and r 0 (the search's rings fill
    shared memory before 32 warps do), round_k 2,048 at L 64 (the spread
    route, a round of more than 1,024; rounds and candidates refined
    equal to dtw_search_ref's, as every run's), and 65,600 queries
    through the scan (dtw_many_queries).  Every run holds the diag routes of both
    kernels too, and the scan's chain route at every radius."""
    edges = []
    wide = [(2999, 100, 4, r, 32) for r in (17, 25, 31, 32, 63, 64, 128,
                                            255)]
    wide += [(1001, 300, 4, r, 32) for r in (0, 17, 25, 31, 32, 63, 64,
                                             127, 128, 255)]
    wide += [(1, 100, 4, 25, 32), (600, 100, 40, 25, 32),
             (1000, L, 64, 25, 32),
             (300, 16, 4, 15, 32), (300, 16, 4, 32, 32),
             (300, 16, 4, 900, 32), (64, 1024, 2, 1023, 64),
             (3000, L, 4, 128, 256), (3000, L, 4, 128, 1024)]
    for n, Lx, nq, r, rk in ((3000, 100, 8, 0, 32), (3000, 100, 8, 1, 32),
                             (3000, 100, 8, 12, 32), (3000, 100, 8, 15, 32),
                             (3000, 100, 8, 16, 32), (2000, 100, 4, 16, 100),
                             (2000, 100, 4, 0, 64), (600, 100, 4, 40, 32),
                             *wide, (1001, 101, 4, 20, 32),
                             (20, L, 4, DTW_R, 32), (1000, L, 4, DTW_R, 16),
                             (2000, 1025, 8, 3, 32), (600, 1025, 4, 40, 32),
                             (2000, 1025, 8, 0, 32),
                             (5000, 64, 8, 3, 2048)):
        edges.append(dtw_small(torch, isax, kd, ref, gen, n, Lx, nq, r,
                               rk) | {"route": kd.dp_route(min(r, Lx - 1),
                                                           Lx, rk),
                                      "lb_route": kd.lb_route(Lx)})
    require(kd.lb_route(100) == kd.lb_route(L) == "vec"
            and kd.lb_route(101) == "scalar"
            and kd.dp_route(0) == kd.dp_route(31) == "wave2"
            and kd.dp_route(32) == kd.dp_route(63) == "wave4"
            and kd.dp_route(64) == kd.dp_route(127) == "wave8"
            and kd.dp_route(128) == "spread"
            and kd.scan_route(0) == kd.scan_route(16) == "band"
            and kd.scan_route(17) == kd.scan_route(255) == "wave16"
            and kd.scan_route(256) == "chain", "dtw routes")
    ran = {r for e in edges for r in e["scan_routes"]}
    require(ran == {"band", "wave16", "chain", "diag",
                    *kd.SCAN_RING_CELLS}, f"the edge runs' scan routes {ran}")
    return edges + [dtw_many_queries(torch, kd, ref, gen)]


def dtw_ring_instances(torch, isax, kd, ref, gen, n=64, Lx=1025, nq=2):
    """Every template instance of dtw_scan's ring routes, bit for bit
    against dtw_scan_ref: a width of C cells a lane is C / 2 instances,
    one for each count of the top lane's cells inside the band, ML = 2r +
    1 - C (H - 1) (odd, 1 .. C - 1), each met at r = (C + ML - 1) / 2
    (H = 2 lanes a pair), at L 1,025 over n z-normalized walks, nq
    queries, the route forced.  Draws from its own generator (seeded from
    gen's seed, whose state it leaves as it was).  Returns the check."""
    g = torch.Generator(device=DEV).manual_seed(gen.initial_seed() + 1)
    x = isax.znormalize(walks(torch, g, n, Lx)).contiguous()
    q = isax.znormalize(x[:nq] + 0.1 * torch.randn(
        nq, Lx, generator=g, device=DEV)).contiguous()
    by_r = {}
    for C in kd.SCAN_RING_WIDTHS:
        for ml in range(1, C, 2):
            by_r.setdefault((C + ml - 1) // 2, []).append(C)
    ran = 0
    for r, widths in sorted(by_r.items()):
        want = ref.dtw_scan_ref(q, x, r)
        for C in widths:
            H, _ = kd.scan_lanes(r, C)
            require(H == 2, f"ring{C} r {r}: {H} lanes a pair")
            got = kd.dtw_scan(q, x, r=r, route=f"ring{C}")
            require(torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1]),
                    f"dtw_scan ring{C} r {r} (ML {2 * r + 1 - C}): not "
                    f"bit-equal to dtw_scan_ref")
            ran += 1
    require(ran == sum(C // 2 for C in kd.SCAN_RING_WIDTHS),
            f"ring instances: {ran} run")
    return {"N": n, "L": Lx, "queries": nq, "instances": ran,
            "radii": sorted(by_r), "scan": "bit-equal"}


def dtw_many_queries(torch, kd, ref, gen, nq=65600, n=64, Lx=16, r=3):
    """dtw_scan of more queries than a grid dimension holds (65,600 at L
    16 over 64 series) on its default (band) route, which takes them in
    two launches of at most 65,535, and its wave, chain and diag routes,
    each bit for bit against dtw_scan_ref."""
    x = walks(torch, gen, n, Lx)
    q = x[torch.randint(0, n, (nq,), generator=gen, device=DEV)] \
        + 0.1 * torch.randn(nq, Lx, generator=gen, device=DEV)
    want = ref.dtw_scan_ref(q, x, r)
    for route in kd.scan_routes(r, Lx):
        got = kd.dtw_scan(q, x, r=r, route=route)
        require(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                f"dtw_scan {route}, {nq} queries: not bit-equal")
    return {"N": n, "L": Lx, "queries": nq, "r": r,
            "scan_routes": list(kd.scan_routes(r, Lx)), "scan": "bit-equal"}


def dtw_long_queries(torch, isax, kmods, ref, gen):
    """The long-query run (DTW_LONGQ): L 16,400, past the longest query a
    kernel stages (16,384), over 256 z-normalized walks, 4 queries
    (collection series plus N(0, 0.1) noise), at r 12, 40 and 200.  At
    each radius, one dtw_band_ref call gives every pair's distance, which
    the plain versions read (ref.dtw_search_ref and ref.dtw_scan_ref,
    d_pairs): lb_keogh to 1e-5 relative; dtw_search on every route that
    takes the radius (dp_routes: the default, every ring width whose
    lanes hold the band, the query read from device memory; spread;
    diag), bit for bit at round_k 32 (8 rounds, pruned and abandoned) and
    at round_k 256 (one round: nothing pruned or abandoned, the timed
    launch, whose bound is every refined pair's cells), a table row for
    the default, spread and diag, the other ring widths' times in the
    report; dtw_scan on every route that takes the radius (band, the ring
    widths 16 to 24, chain, diag), bit for bit, then timed on one more
    launch, each wave or ring row with its cells a lane and busy lanes.
    Each route's time beside its bound; launches are this run's.  Returns
    (reports, launches, rows)."""
    kd = kmods["dtw"]
    n, Lx, nq, radii = DTW_LONGQ
    x = isax.znormalize(walks(torch, gen, n, Lx)).contiguous()
    pick = torch.randint(0, n, (nq,), generator=gen, device=DEV)
    q = isax.znormalize(x[pick] + 0.1 * torch.randn(
        nq, Lx, generator=gen, device=DEV)).contiguous()
    ev = lambda: torch.cuda.Event(enable_timing=True)  # noqa: E731

    def once(fn):                        # (fn(), its device ms)
        e = [ev(), ev()]
        e[0].record()
        out = fn()
        e[1].record()
        torch.cuda.synchronize()
        return out, e[0].elapsed_time(e[1])
    reps, launches, rows = [], {}, []
    for r in radii:
        t_run = time.perf_counter()
        tag = f"L{Lx}_r{r}"
        reset(kmods)
        lb = kd.lb_keogh(q, x, r=r)
        lb_err = rel_err(torch, lb, ref.lb_keogh_ref(q, x, r))
        require(lb_err <= 1e-5, f"lb_keogh L {Lx} r {r}: {lb_err}")
        s, o = torch.sort(lb, dim=1, stable=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dp = ref.dtw_band_ref(q[:, None], x[None], r)
        torch.cuda.synchronize()
        band_ms = (time.perf_counter() - t0) * 1e3
        plain, want = {}, {}
        for rk in (DTW_RK, n):
            t0 = time.perf_counter()
            want[rk] = ref.dtw_search_ref(q, x, s, o, r, rk, d_pairs=dp)
            torch.cuda.synchronize()
            plain[rk] = band_ms + (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        scan_want = ref.dtw_scan_ref(q, x, r, d_pairs=dp)
        torch.cuda.synchronize()
        scan_plain = band_ms + (time.perf_counter() - t0) * 1e3
        require(bool((want[DTW_RK][0] == scan_want[0]).all()),
                f"dtw L {Lx} r {r}: search and scan distances differ")
        made, checks, widths = [], {}, {}
        search_routes = kd.dp_routes(r, Lx, DTW_RK)
        for route in search_routes:
            # the last launch timed (the route's kernel loaded by then:
            # the edge runs launch each)
            for rk in (DTW_RK, n):
                got, ms = once(lambda: kd.dtw_search(
                    q, x, s, o, r=r, round_k=rk, route=route))
                require(all(torch.equal(a, b)
                            for a, b in zip(got, want[rk])),
                        f"dtw_search {route} L {Lx} r {r} round_k {rk}: "
                        f"not bit-equal to dtw_search_ref")
            checks[f"dtw_search/{route}"] = "bit-equal to dtw_search_ref"
            widths[route] = ms
            if route not in (search_routes[0], "spread", "diag"):
                continue
            n_ref, n_rounds = int(got[3].sum()), int(got[2].sum())
            bms, by = rl.dtw_search_work(n_ref * rl.dtw_cells(Lx, r), n_ref,
                                         Lx, n_rounds, rk).bound()
            made.append(route_row(
                "dtw_search", f"{route}_{tag}", DTW_SRC,
                DTW_REPLACES.format(122, "search_dtw"),
                f"{nq} queries x {n} series, L {Lx}, r {r}, round_k {rk} "
                f"({n_rounds} rounds, {n_ref} refined: none abandoned)",
                0.0, ms, plain[rk], bms, by,
                {"round_k 32 and 256": "bit-equal to dtw_search_ref"}))
        for route in kd.scan_routes(r, Lx):
            got, ms = once(lambda: kd.dtw_scan(q, x, r=r, route=route))
            require(torch.equal(got[0], scan_want[0])
                    and torch.equal(got[1], scan_want[1]),
                    f"dtw_scan {route} L {Lx} r {r}: not bit-equal to "
                    f"dtw_scan_ref")
            ms = time_ms(torch, lambda: kd.dtw_scan(q, x, r=r, route=route),
                         1, 0)
            bms, by = rl.dtw_scan_work(nq, n, Lx, r).bound()
            checks[f"dtw_scan/{route}"] = "bit-equal to dtw_scan_ref"
            made.append(route_row(
                "dtw_scan", f"{route}_{tag}", DTW_SRC,
                DTW_REPLACES.format(173, "search_dtw_bruteforce"),
                f"{nq} queries x {n} series, L {Lx}, r {r}", 0.0, ms,
                scan_plain, bms, by, {"all queries":
                                      "bit-equal to dtw_scan_ref"})
                | scan_layout(kd, route, r))
        routes = dict(kd.by_route)
        for row in made:
            kernel, rt = row["name"].split("/")
            launches[row["name"]] = routes.get(
                f"{kernel}/{rt[:-len(tag) - 1]}", 0)
        rows += made
        reps.append({"series": n, "L": Lx, "queries": nq, "r": r,
                     "lb_rel_err": lb_err, "band_ref_ms": band_ms,
                     "checks": checks, "by_route": routes,
                     "search_ms_round_k_256": widths,
                     "search_fastest": min(widths, key=widths.get),
                     "kernels": {row["name"]: {k: row[k] for k in (
                         "ms", "bound_ms", "plain_ms")}
                         | {"launches": launches[row["name"]]}
                         for row in made},
                     "seconds": time.perf_counter() - t_run})
        del lb, s, o, dp
    del x, q
    torch.cuda.empty_cache()
    return reps, launches, rows


def dtw_device_band(torch, isax, kmods, ref, gen):
    """A band past a block's shared memory (DTW_DEVBAND: L 25,700, r
    25,650, 3 walks, 2 queries), through core.dtw.search_dtw and
    search_dtw_bruteforce, every count at 0 first: both take the diag
    routes (strips of rows, each a warp's, a pair's strips on many SMs at
    once; their geometry in the report).  Holds: ids
    equal, distances equal to the brute force's; each kernel at its
    launch held to its plain version (lb_keogh to 1e-5, dtw_search and
    dtw_scan bit for bit against dtw_search_ref and dtw_scan_ref on one
    dtw_band_ref call's distances), each launch timed once, beside its
    bound (every refined pair's cells: the diag route abandons none).
    Returns (report, launches, rows)."""
    from repro_torch.core import dtw as cdtw
    kd = kmods["dtw"]
    n, Lx, nq, r = DTW_DEVBAND
    t_run = time.perf_counter()
    raw = walks(torch, gen, n, Lx)
    pick = torch.randint(0, n, (nq,), generator=gen, device=DEV)
    queries = isax.znormalize(raw[pick]) + 0.1 * torch.randn(
        nq, Lx, generator=gen, device=DEV)
    torch.cuda.synchronize()
    reset(kmods)
    t0 = time.perf_counter()
    d, ids = cdtw.search_dtw(raw, queries, r=r, round_k=DTW_RK, device=DEV)
    torch.cuda.synchronize()
    search_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    bd, bi = cdtw.search_dtw_bruteforce(raw, queries, r=r, device=DEV)
    torch.cuda.synchronize()
    brute_ms = (time.perf_counter() - t0) * 1e3
    routes = dict(kd.by_route)
    require(routes == {**lb_launches(kd, Lx), "dtw_search/diag": 1,
                       "dtw_scan/diag": 1},
            f"dtw L {Lx} r {r}: launches by route {routes}")
    require(bool(torch.isfinite(d).all()) and torch.equal(d, bd)
            and torch.equal(ids, bi),
            f"dtw L {Lx} r {r} vs brute force: {d.tolist()} {bd.tolist()}, "
            f"ids {ids.tolist()} {bi.tolist()}")
    x = isax.znormalize(raw).contiguous()
    qz = isax.znormalize(queries).contiguous()
    lb = kd.lb_keogh(qz, x, r=r)
    lb_err = rel_err(torch, lb, ref.lb_keogh_ref(qz, x, r))
    require(lb_err <= 1e-5, f"lb_keogh L {Lx} r {r}: {lb_err}")
    s, o = torch.sort(lb, dim=1, stable=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dp = ref.dtw_band_ref(qz[:, None], x[None], r)
    torch.cuda.synchronize()
    band_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    want = ref.dtw_search_ref(qz, x, s, o, r, DTW_RK, d_pairs=dp)
    torch.cuda.synchronize()
    search_plain = band_ms + (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    scan_want = ref.dtw_scan_ref(qz, x, r, d_pairs=dp)
    torch.cuda.synchronize()
    scan_plain = band_ms + (time.perf_counter() - t0) * 1e3
    e = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    e[0].record()
    got = kd.dtw_search(qz, x, s, o, r=r, round_k=DTW_RK)
    e[1].record()
    d2, i2 = kd.dtw_scan(qz, x, r=r)
    e[2].record()
    torch.cuda.synchronize()
    search_k_ms, scan_ms = e[0].elapsed_time(e[1]), e[1].elapsed_time(e[2])
    require(all(torch.equal(a, b) for a, b in zip(got, want)),
            f"dtw_search diag L {Lx} r {r}: not bit-equal to dtw_search_ref")
    require(torch.equal(d2, scan_want[0]) and torch.equal(i2, scan_want[1])
            and torch.equal(torch.sqrt(d2), bd) and torch.equal(i2, bi),
            f"dtw_scan diag L {Lx} r {r}: differs from dtw_scan_ref or the "
            f"brute force's")
    tag = f"L{Lx}_r{r}"
    n_ref, n_rounds = int(got[3].sum()), int(got[2].sum())
    cells = rl.dtw_cells(Lx, r)
    shape = f"{nq} queries x {n} series, L {Lx}, r {r}"
    rows = []
    bms, by = rl.dtw_search_work(n_ref * cells, n_ref, Lx, n_rounds,
                                 DTW_RK).bound()
    rows.append(route_row(
        "dtw_search", f"diag_{tag}", DTW_SRC,
        DTW_REPLACES.format(122, "search_dtw"),
        f"{shape}, round_k {DTW_RK}, {n_ref} refined", 0.0, search_k_ms,
        search_plain, bms, by, {"all queries": "bit-equal to "
                                "dtw_search_ref"}))
    bms, by = rl.dtw_scan_work(nq, n, Lx, r).bound()
    rows.append(route_row(
        "dtw_scan", f"diag_{tag}", DTW_SRC,
        DTW_REPLACES.format(173, "search_dtw_bruteforce"), shape, 0.0,
        scan_ms, scan_plain, bms, by,
        {"all queries": "bit-equal to dtw_scan_ref and the brute force"}))
    launches = {f"{k}/diag_{tag}": routes.get(f"{k}/diag", 0)
                for k in ("dtw_search", "dtw_scan")}
    rep = {"series": n, "L": Lx, "queries": nq, "r": r,
           "geometry": {
               "search": kd.diag_search_geometry(nq, n, Lx, r, DTW_RK),
               "scan": kd.diag_scan_geometry(nq, n, Lx, r),
               "held": kd._diag_held(x.device, kd.diag_rows(r))},
           "search_dtw_ms": search_ms, "bruteforce_ms": brute_ms,
           "band_ref_ms": band_ms, "lb_rel_err": lb_err, "by_route": routes,
           "cells_a_pair": cells, "refined": n_ref,
           "kernels": {row["name"]: {k: row[k] for k in (
               "ms", "bound_ms", "plain_ms")}
               | {"launches": launches[row["name"]]} for row in rows},
           "seconds": time.perf_counter() - t_run}
    del raw, queries, x, qz, lb, s, o, dp
    torch.cuda.empty_cache()
    return rep, launches, rows


def dtw_full_window(torch, isax, kmods, ref, gen):
    """Both kernels at the full window (DTW_FULL: 4 queries x 256
    z-normalized walks, L 1,024, r 1,023), where the spread and chain
    routes are the defaults, on the default and the diag route: each
    launch timed once by CUDA events (after one untimed) and held bit for
    bit to dtw_search_ref (round_k 32) or dtw_scan_ref on one dtw_band_ref
    call's distances, beside its bound (every refined pair's cells: no
    route abandons; the scan's every pair's).  A row each.  Draws from
    its own generator (seeded from gen's seed), whose state it leaves as
    it was.  Returns (report, launches, rows)."""
    kd = kmods["dtw"]
    n, Lx, nq = DTW_FULL
    r = Lx - 1
    t_run = time.perf_counter()
    g = torch.Generator(device=DEV).manual_seed(gen.initial_seed() + 2)
    x = isax.znormalize(walks(torch, g, n, Lx)).contiguous()
    pick = torch.randint(0, n, (nq,), generator=g, device=DEV)
    q = isax.znormalize(x[pick] + 0.1 * torch.randn(
        nq, Lx, generator=g, device=DEV)).contiguous()
    search_route = kd.dp_route(r, Lx, DTW_RK)
    scan_route = kd.scan_route(r, Lx, nq, n)
    require(search_route == "spread" and scan_route == "chain",
            "dtw full window: the spread and chain routes are not the "
            "defaults")
    s, o = torch.sort(kd.lb_keogh(q, x, r=r), dim=1, stable=True)
    torch.cuda.synchronize()
    # one dtw_band_ref call serves both plain versions: its time is in each
    t0 = time.perf_counter()
    dp = ref.dtw_band_ref(q[:, None], x[None], r)
    torch.cuda.synchronize()
    band_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    want = ref.dtw_search_ref(q, x, s, o, r, DTW_RK, d_pairs=dp)
    torch.cuda.synchronize()
    search_plain = band_ms + (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    scan_want = ref.dtw_scan_ref(q, x, r, d_pairs=dp)
    torch.cuda.synchronize()
    scan_plain = band_ms + (time.perf_counter() - t0) * 1e3

    def once(fn):                        # (fn(), its device ms)
        fn()
        e = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        e[0].record()
        out = fn()
        e[1].record()
        torch.cuda.synchronize()
        return out, e[0].elapsed_time(e[1])
    shape = f"{nq} queries x {n} series, L {Lx}, r {r}"
    before = dict(kd.by_route)
    rows, checks = [], {}
    for route in (search_route, "diag"):
        got, ms = once(lambda: kd.dtw_search(q, x, s, o, r=r, round_k=DTW_RK,
                                             route=route))
        require(all(torch.equal(a, b) for a, b in zip(got, want)),
                f"dtw_search {route} full window: not bit-equal to "
                f"dtw_search_ref")
        n_ref, n_rounds = int(got[3].sum()), int(got[2].sum())
        bms, by = rl.dtw_search_work(n_ref * rl.dtw_cells(Lx, r), n_ref, Lx,
                                     n_rounds, DTW_RK).bound()
        checks[f"dtw_search/{route}"] = "bit-equal to dtw_search_ref"
        rows.append(route_row(
            "dtw_search", f"{route}_full", DTW_SRC,
            DTW_REPLACES.format(122, "search_dtw"),
            f"{shape}, round_k {DTW_RK} ({n_rounds} rounds, {n_ref} "
            f"refined)", 0.0, ms, search_plain, bms, by,
            {"all queries": "bit-equal to dtw_search_ref"}))
    for route in (scan_route, "diag"):
        got, ms = once(lambda: kd.dtw_scan(q, x, r=r, route=route))
        require(torch.equal(got[0], scan_want[0])
                and torch.equal(got[1], scan_want[1]),
                f"dtw_scan {route} full window: not bit-equal to "
                f"dtw_scan_ref")
        bms, by = rl.dtw_scan_work(nq, n, Lx, r).bound()
        checks[f"dtw_scan/{route}"] = "bit-equal to dtw_scan_ref"
        rows.append(route_row(
            "dtw_scan", f"{route}_full", DTW_SRC,
            DTW_REPLACES.format(173, "search_dtw_bruteforce"), shape, 0.0,
            ms, scan_plain, bms, by,
            {"all queries": "bit-equal to dtw_scan_ref"}))
    after = dict(kd.by_route)
    launches = {}
    for row in rows:
        kernel, rt = row["name"].split("/")
        key = f"{kernel}/{rt[:-len('_full')]}"
        launches[row["name"]] = after.get(key, 0) - before.get(key, 0)
    rep = {"series": n, "L": Lx, "queries": nq, "r": r, "checks": checks,
           "band_ref_ms": band_ms,
           "geometry": {"search": kd.diag_search_geometry(nq, n, Lx, r,
                                                          DTW_RK),
                        "scan": kd.diag_scan_geometry(nq, n, Lx, r),
                        "spread": kd.spread_search_geometry(nq, n, Lx, r,
                                                            DTW_RK),
                        "chain": kd.chain_scan_geometry(Lx, r)},
           "kernels": {row["name"]: {k: row[k] for k in (
               "ms", "bound_ms", "plain_ms")}
               | {"launches": launches[row["name"]]} for row in rows},
           "seconds": time.perf_counter() - t_run}
    del x, q, s, o, dp
    torch.cuda.empty_cache()
    return rep, launches, rows


def dtw_wide_cell(torch, isax, kd, ref, gen, n, Lx, r, search):
    """One cell row set of the dtw_wide phase (DTW_WIDE_CELLS): n random
    walks of Lx points and DTW_WIDE_Q queries (collection series
    z-normalized, then N(0, 0.1) noise), through core.dtw.search_dtw (if
    `search`) and search_dtw_bruteforce at r, the launches by route read
    just after; ids equal to the brute force's but at ties, distances to
    1e-5.  Then each kernel at the path's launch: on its default route and
    on diag, each timed on one launch after the check, the first
    DTW_WIDE_PLAIN queries bit for bit against dtw_search_ref and
    dtw_scan_ref (one dtw_band_ref call serves both), beside its bound.
    Returns (report, the path's launches by route, rows)."""
    from repro_torch.core import dtw as cdtw
    t_run = time.perf_counter()
    raw = walks(torch, gen, n, Lx)
    pick = torch.randint(0, n, (DTW_WIDE_Q,), generator=gen, device=DEV)
    queries = isax.znormalize(raw[pick]) + 0.1 * torch.randn(
        DTW_WIDE_Q, Lx, generator=gen, device=DEV)
    torch.cuda.synchronize()
    before = dict(kd.by_route)
    rep = {"series": n, "L": Lx, "queries": DTW_WIDE_Q, "r": r}
    if search:
        t0 = time.perf_counter()
        d, ids = cdtw.search_dtw(raw, queries, r=r, round_k=DTW_RK,
                                 device=DEV)
        torch.cuda.synchronize()
        rep["search_dtw_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    bd, bi = cdtw.search_dtw_bruteforce(raw, queries, r=r, device=DEV)
    torch.cuda.synchronize()
    rep["bruteforce_ms"] = (time.perf_counter() - t0) * 1e3
    ran = {k: v - before.get(k, 0) for k, v in kd.by_route.items()
           if v != before.get(k, 0)}
    search_route = kd.dp_route(r, Lx, DTW_RK)
    scan_route = kd.scan_route(r, Lx, DTW_WIDE_Q, n)
    want_ran = {f"dtw_scan/{scan_route}": 1}
    if search:
        want_ran |= {**lb_launches(kd, Lx), f"dtw_search/{search_route}": 1}
        d_err, mism = rel_err(torch, d, bd), ids != bi
        require(bool(torch.isfinite(d).all()) and d_err <= 1e-5
                and bool(((d[mism] - bd[mism]).abs()
                          <= 1e-5 * bd[mism]).all()),
                f"dtw L {Lx} r {r} vs brute force: {d_err}, ids "
                f"{ids.tolist()} {bi.tolist()}")
        rep["ties_vs_bruteforce"] = int(mism.sum())
    require(ran == want_ran, f"dtw L {Lx} r {r} launches by route {ran}")
    rep["by_route"] = ran
    x = isax.znormalize(raw).contiguous()
    qz = isax.znormalize(queries).contiguous()
    del raw, queries
    k = DTW_WIDE_PLAIN
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dp = ref.dtw_band_ref(qz[:k, None], x[None], r)
    torch.cuda.synchronize()
    band_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    scan_want = ref.dtw_scan_ref(qz[:k], x, r, d_pairs=dp)
    torch.cuda.synchronize()
    scan_plain = band_ms + (time.perf_counter() - t0) * 1e3
    rows, tag = [], f"L{Lx}_r{r}_cell"
    shape = f"{DTW_WIDE_Q} queries x {n} series, L {Lx}, r {r}"
    checks = f"queries 0..{k - 1} bit-equal to the plain version"

    def once(fn):                        # (fn(), its device ms)
        e = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        e[0].record()
        out = fn()
        e[1].record()
        torch.cuda.synchronize()
        return out, e[0].elapsed_time(e[1])
    if search:
        s, o = torch.sort(kd.lb_keogh(qz, x, r=r), dim=1, stable=True)
        t0 = time.perf_counter()
        want = ref.dtw_search_ref(qz[:k], x, s[:k].contiguous(),
                                  o[:k].contiguous(), r, DTW_RK, d_pairs=dp)
        torch.cuda.synchronize()
        search_plain = band_ms + (time.perf_counter() - t0) * 1e3
        for route in (search_route, "diag"):
            call = lambda: kd.dtw_search(  # noqa: E731
                qz, x, s, o, r=r, round_k=DTW_RK, route=route)
            got = call()
            require(torch.equal(got[1], ids) and all(
                torch.equal(a[:k], b) for a, b in zip(got, want)),
                f"dtw_search {route} L {Lx} r {r}: differs from the search "
                f"or dtw_search_ref")
            _, ms = once(call)
            n_ref, n_rounds = int(got[3].sum()), int(got[2].sum())
            bms, by = rl.dtw_search_work(n_ref * rl.dtw_cells(Lx, r), n_ref,
                                         Lx, n_rounds, DTW_RK).bound()
            rows.append(route_row(
                "dtw_search", f"{route}_{tag}", DTW_SRC,
                DTW_REPLACES.format(122, "search_dtw"),
                f"{shape}, round_k {DTW_RK} ({n_rounds} rounds, {n_ref} "
                f"refined, {int(got[2].max())} at most)", 0.0, ms,
                search_plain, bms, by, {f"search_dtw's ids": "equal",
                                        "plain version": checks})
                | {"rounds": n_rounds, "refined": n_ref})
        del s, o
    for route in (scan_route, "diag"):
        call = lambda: kd.dtw_scan(qz, x, r=r, route=route)  # noqa: E731
        d2, i2 = call()
        require(torch.equal(torch.sqrt(d2), bd) and torch.equal(i2, bi)
                and torch.equal(d2[:k], scan_want[0])
                and torch.equal(i2[:k], scan_want[1]),
                f"dtw_scan {route} L {Lx} r {r}: differs from the brute "
                f"force's or dtw_scan_ref")
        _, ms = once(call)
        bms, by = rl.dtw_scan_work(DTW_WIDE_Q, n, Lx, r).bound()
        rows.append(route_row(
            "dtw_scan", f"{route}_{tag}", DTW_SRC,
            DTW_REPLACES.format(173, "search_dtw_bruteforce"), shape, 0.0,
            ms, scan_plain, bms, by,
            {"search_dtw_bruteforce": "equal", "plain version": checks})
            | {"share_of_bound": bms / ms})
    rep["band_ref_ms"] = band_ms
    rep["kernels"] = {row["name"]: {k: row[k] for k in (
        "ms", "bound_ms", "plain_ms")} for row in rows}
    rep["seconds"] = time.perf_counter() - t_run
    del x, qz, dp, bd, bi
    torch.cuda.empty_cache()
    return rep, ran, rows


def dtw_sweep(torch, isax, kd, ref, gen):
    """The dtw_wide phase's sweep (DTW_SWEEP, 4 queries x 256 z-normalized
    walks each): at each shape every route of each kernel that takes it
    (the default, the spread or chain route, diag), held bit for bit to
    dtw_search_ref or dtw_scan_ref on one dtw_band_ref call's distances,
    then timed (the mean of 10 launches after one), beside its bound;
    each row with its rounds and candidates refined (the search's) and
    its launches in the sweep.  Returns (reports, rows)."""
    n, _, nq = DTW_FULL
    reps, rows = [], []
    for Lx, r, rk in DTW_SWEEP:
        x = isax.znormalize(walks(torch, gen, n, Lx)).contiguous()
        pick = torch.randint(0, n, (nq,), generator=gen, device=DEV)
        q = isax.znormalize(x[pick] + 0.1 * torch.randn(
            nq, Lx, generator=gen, device=DEV)).contiguous()
        s, o = torch.sort(kd.lb_keogh(q, x, r=r), dim=1, stable=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dp = ref.dtw_band_ref(q[:, None], x[None], r)
        torch.cuda.synchronize()
        band_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        want = ref.dtw_search_ref(q, x, s, o, r, rk, d_pairs=dp)
        torch.cuda.synchronize()
        search_plain = band_ms + (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        scan_want = ref.dtw_scan_ref(q, x, r, d_pairs=dp)
        torch.cuda.synchronize()
        scan_plain = band_ms + (time.perf_counter() - t0) * 1e3
        tag = f"L{Lx}_r{r}" + (f"_rk{rk}" if rk != DTW_RK else "")
        shape = f"{nq} queries x {n} series, L {Lx}, r {r}"
        n_ref, n_rounds = int(want[3].sum()), int(want[2].sum())
        rep = {"L": Lx, "r": r, "round_k": rk, "rounds": n_rounds,
               "refined": n_ref, "band_ref_ms": band_ms, "ms": {}}
        for kernel, routes, call, held, bound, plain in (
                ("dtw_search", kd.dp_routes(r, Lx, rk),
                 lambda rt: kd.dtw_search(q, x, s, o, r=r, round_k=rk,
                                          route=rt),
                 lambda got: all(torch.equal(a, b)
                                 for a, b in zip(got, want)),
                 rl.dtw_search_work(n_ref * rl.dtw_cells(Lx, r), n_ref, Lx,
                                    n_rounds, rk), search_plain),
                ("dtw_scan", kd.scan_routes(r, Lx, nq, n),
                 lambda rt: kd.dtw_scan(q, x, r=r, route=rt),
                 lambda got: torch.equal(got[0], scan_want[0])
                 and torch.equal(got[1], scan_want[1]),
                 rl.dtw_scan_work(nq, n, Lx, r), scan_plain)):
            bms, by = bound.bound()
            for route in routes:
                if route.startswith("ring") and route != routes[0]:
                    continue                 # the ring widths: their own rows
                before = dict(kd.by_route)
                require(held(call(route)), f"{kernel} {route} {shape}, "
                        f"round_k {rk}: not bit-equal to the plain version")
                ms = time_ms(torch, lambda: call(route), 10, 0)
                key = f"{kernel}/{route}"
                row = route_row(
                    kernel, f"{route}_{tag}", DTW_SRC, DTW_REPLACES.format(
                        *((122, "search_dtw") if kernel == "dtw_search"
                          else (173, "search_dtw_bruteforce"))),
                    shape + (f", round_k {rk} ({n_rounds} rounds, {n_ref} "
                             f"refined)" if kernel == "dtw_search" else ""),
                    0.0, ms, plain, bms, by,
                    {"all queries": "bit-equal to the plain version"})
                row |= {"default": route == routes[0],
                        "sweep_launches": kd.by_route.get(key, 0)
                        - before.get(key, 0)}
                rows.append(row)
                rep["ms"][key] = ms
        for kernel in ("dtw_search", "dtw_scan"):
            mine = {k: v for k, v in rep["ms"].items()
                    if k.startswith(kernel + "/")}
            default = next(iter(mine))
            rep[f"{kernel}_default_over_fastest"] = (
                mine[default] / min(mine.values()))
        reps.append(rep)
        del x, q, s, o, dp
        torch.cuda.empty_cache()
    return reps, rows


def dtw_few_pairs(torch, isax, kd, gen, Lx=2709, r=271):
    """dtw_scan's chain and diag routes on DTW_FEW's few pairs (the first Q
    queries and N series of 256 z-normalized walks of Lx points, noisy
    collection series as queries), each held equal to the other and timed
    (the mean of 5 launches after one), beside the default route
    (scan_route by the pairs, CHAIN_PAIRS).  Returns the reports."""
    x = isax.znormalize(walks(torch, gen, 256, Lx)).contiguous()
    pick = torch.randint(0, 256, (8,), generator=gen, device=DEV)
    q = isax.znormalize(x[pick] + 0.1 * torch.randn(
        8, Lx, generator=gen, device=DEV)).contiguous()
    reps = []
    for nq, n in DTW_FEW:
        qq, xx = q[:nq].contiguous(), x[:n].contiguous()
        ms = {}
        for route in ("chain", "diag"):
            call = lambda: kd.dtw_scan(qq, xx, r=r, route=route)  # noqa
            got = call()
            if route == "chain":
                first = got
            require(torch.equal(got[0], first[0])
                    and torch.equal(got[1], first[1]),
                    f"dtw_scan {route}, {nq} x {n} pairs: chain and diag "
                    f"differ")
            ms[route] = time_ms(torch, call, 5, 0)
        reps.append({"queries": nq, "series": n, "pairs": nq * n, "L": Lx,
                     "r": r, "chain_ms": ms["chain"], "diag_ms": ms["diag"],
                     "default": kd.scan_route(r, Lx, nq, n)})
    del x, q
    torch.cuda.empty_cache()
    return reps


def dtw_wide_path(torch, isax, kmods, ref, gen):
    """The dtw_wide phase: the shapes past the wave routes' radii and
    round_k 1,024, the spread and chain routes' defaults.  Every count at
    0 first, the cells' paths (DTW_WIDE_CELLS,
    dtw_wide_cell: search_dtw and search_dtw_bruteforce, then each kernel
    at the path's launch on its default route and diag), the counts read
    after each; then the sweep (dtw_sweep: every route of each kernel at
    each DTW_SWEEP shape, bit for bit, timed) and the scan on few pairs
    (dtw_few_pairs).  Returns (report, launches, rows)."""
    kd = kmods["dtw"]
    t_phase = time.perf_counter()
    reset(kmods)
    rep, launches, rows = {"phase": "dtw_wide", "cells": []}, {}, []
    for n, Lx, r, search in DTW_WIDE_CELLS:
        cell, ran, more = dtw_wide_cell(torch, isax, kd, ref, gen, n, Lx, r,
                                        search)
        rep["cells"].append(cell)
        for row in more:
            kernel, rt = row["name"].split("/")
            launches[row["name"]] = ran.get(
                f"{kernel}/{rt[:-len(f'_L{Lx}_r{r}_cell')]}", 0)
        rows += more
    rep["sweep"], more = dtw_sweep(torch, isax, kd, ref, gen)
    rows += more
    rep["few_pairs"] = dtw_few_pairs(torch, isax, kd, gen)
    rep["rows"] = rows
    rep["seconds"] = time.perf_counter() - t_phase
    return rep, launches, rows


def dtw_wide(torch, isax, kmods, ref, x, qz):
    """The dtw phase's collection and queries at r DTW_WIDE_R (10 % of
    L), through core.dtw.search_dtw (z-normalized already, znorm=False)
    and the first DTW_WIDE_BRUTE queries through search_dtw_bruteforce;
    the launch counts are these two calls'.  Holds: ids equal to the
    brute force's but at ties, every distance its id's own, the first
    DTW_WIDE_GROUPS groups' refinement bit for bit against
    dtw_search_ref.  Then each group's pieces timed, and the table row
    of the wave route at the first group, with the spread route's time
    at the same shape and the bound of the cells an abandoning DP needs
    (needed_cells); then dtw_scan's rows at r on the brute force's
    queries (scan_rows), its default route's and the chain route's timed
    on the first DTW_OTHER_Q queries.  Returns (report, launches,
    rows)."""
    from repro_torch.core import dtw as cdtw
    kd, r = kmods["dtw"], DTW_WIDE_R
    route = kd.dp_route(r)
    torch.cuda.synchronize()
    reset(kmods)
    t0 = time.perf_counter()
    d, ids = cdtw.search_dtw(x, qz, r=r, round_k=DTW_RK, znorm=False,
                             device=DEV)
    torch.cuda.synchronize()
    search_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    bd, bi = cdtw.search_dtw_bruteforce(x, qz[:DTW_WIDE_BRUTE], r=r,
                                        znorm=False, device=DEV)
    torch.cuda.synchronize()
    brute_s = time.perf_counter() - t0
    routes = dict(kd.by_route)
    groups = DTW_Q // cdtw.GROUP
    require(routes == {f"lb_keogh/{kd.lb_route(L)}": groups,
                       f"dtw_search/{route}": groups,
                       f"dtw_scan/{kd.scan_route(r)}": 1},
            f"dtw r {r} launches by route {routes}")
    require(route == "wave2" and bool(torch.isfinite(d).all())
            and bool((ids >= 0).all()), f"dtw r {r}: an answer is missing")
    dg, ig = d[:DTW_WIDE_BRUTE], ids[:DTW_WIDE_BRUTE]
    d_err = rel_err(torch, dg, bd)
    mism = ig != bi
    require(d_err <= 1e-5 and (not bool(mism.any()) or bool(
        ((dg[mism] - bd[mism]).abs() <= 1e-5 * bd[mism]).all())),
        f"dtw r {r} vs brute force: {d_err}, ids {ig.tolist()} "
        f"{bi.tolist()}")
    own = torch.sqrt(ref.dtw_band_ref(qz, x[ids.long()], r))
    require(bool((own == d).all()), f"dtw r {r}: a distance is not its "
            f"id's own")
    ev = lambda: torch.cuda.Event(enable_timing=True)  # noqa: E731
    parts = {"lb_ms": 0.0, "sort_ms": 0.0, "refine_ms": 0.0}
    rounds, refined, plain_ms, trace = [], [], [], []
    for g in range(0, DTW_Q, cdtw.GROUP):
        qg = qz[g:g + cdtw.GROUP]
        e = [ev() for _ in range(4)]
        e[0].record()
        lbg = kd.lb_keogh(qg, x, r=r)
        e[1].record()
        s, o = torch.sort(lbg, dim=1, stable=True)
        e[2].record()
        got = kd.dtw_search(qg, x, s, o, r=r, round_k=DTW_RK)
        e[3].record()
        torch.cuda.synchronize()
        del lbg
        require(torch.equal(got[1], ids[g:g + cdtw.GROUP]),
                f"dtw r {r}: the timed group's ids differ from the search's")
        for key, a, b in (("lb_ms", 0, 1), ("sort_ms", 1, 2),
                          ("refine_ms", 2, 3)):
            parts[key] += e[a].elapsed_time(e[b])
        if g < DTW_WIDE_GROUPS * cdtw.GROUP:
            t0 = time.perf_counter()
            want = ref.dtw_search_ref(qg, x, s, o, r, DTW_RK,
                                      max_pairs=DTW_REF_PAIRS,
                                      trace=trace if g == 0 else None)
            torch.cuda.synchronize()
            plain_ms.append((time.perf_counter() - t0) * 1e3)
            require(all(torch.equal(a, b) for a, b in zip(got, want)),
                    f"dtw_search r {r}, queries {g}..: not bit-equal to "
                    f"dtw_search_ref")
        rounds += got[2].tolist()
        refined += got[3].tolist()
        if g == 0:
            first = (qg, s, o, got)
        else:
            del s, o
    qg, s, o, got = first
    ms = time_ms(torch, lambda: kd.dtw_search(qg, x, s, o, r=r,
                                              round_k=DTW_RK), 3, 1)
    t0 = time.perf_counter()
    other = kd.dtw_search(qg, x, s, o, r=r, round_k=DTW_RK, route="spread")
    torch.cuda.synchronize()
    spread_ms = (time.perf_counter() - t0) * 1e3
    require(all(torch.equal(a, b) for a, b in zip(other, got)),
            f"dtw_search r {r} spread: not bit-equal on the first group")
    n_ref = int(got[3].sum())
    cells = needed_cells(torch, ref, kd, qg, x, s, o, trace, r, DTW_RK,
                         route)
    bms, by = rl.dtw_search_work(cells, n_ref, L, int(got[2].sum()),
                                 DTW_RK).bound()
    shape = (f"{cdtw.GROUP} queries x {DTW_N} series, L {L}, r {r}, "
             f"round_k {DTW_RK}, {n_ref} refined, {int(got[2].max())} "
             f"rounds at most (the r {r} run's first group)")
    row = route_row("dtw_search", f"{route}_r{r}", DTW_SRC,
                    DTW_REPLACES.format(122, "search_dtw"), shape, 0.0, ms,
                    plain_ms[0], bms, by,
                    {"main shape": "bit-equal to dtw_search_ref",
                     "spread route": "bit-equal"})
    row["spread_ms"] = spread_ms
    row["needed_cells"] = cells
    row["all_cells"] = n_ref * rl.dtw_cells(L, r)
    rounds_t = torch.tensor(rounds, dtype=torch.float64)
    refined_t = torch.tensor(refined, dtype=torch.float64)
    rep = {"r": r, "route": route, "search_dtw_ms": search_s * 1e3,
           **parts, "bruteforce_queries": DTW_WIDE_BRUTE,
           "bruteforce_ms": brute_s * 1e3, "ties_vs_bruteforce":
           int(mism.sum()), "dist_rel_err_vs_bruteforce": d_err,
           "rounds": {"min": int(rounds_t.min()),
                      "median": float(rounds_t.median()),
                      "max": int(rounds_t.max())},
           "refined_per_query": {"min": int(refined_t.min()),
                                 "median": float(refined_t.median()),
                                 "max": int(refined_t.max())},
           "pruned_share": 1.0 - float(refined_t.mean()) / DTW_N,
           "first_group_ms": ms, "first_group_spread_ms": spread_ms,
           "spread_over_wave": spread_ms / ms, "bound_ms": bms,
           "needed_cells": cells, "all_cells": n_ref * rl.dtw_cells(L, r),
           "search_check": f"groups 0..{DTW_WIDE_GROUPS - 1} bit-equal to "
                           f"dtw_search_ref", "plain_refine_ms": plain_ms,
           "by_route": routes}
    # the table row's launches: this run's (its name carries the radius)
    launches = {row["name"]: routes.get(f"dtw_search/{route}", 0)}
    scan = scan_rows(torch, kd, ref, x, qz[:DTW_WIDE_BRUTE].contiguous(), r,
                     (bd, bi), routes)
    q8 = qz[:DTW_OTHER_Q].contiguous()
    t0 = time.perf_counter()
    cd, ci = kd.dtw_scan(q8, x, r=r, route="chain")
    torch.cuda.synchronize()
    chain_ms = (time.perf_counter() - t0) * 1e3
    require(torch.equal(torch.sqrt(cd), bd[:DTW_OTHER_Q])
            and torch.equal(ci, bi[:DTW_OTHER_Q]),
            f"dtw_scan chain r {r}: differs from the brute force's")
    q8_ms = time_ms(torch, lambda: kd.dtw_scan(q8, x, r=r), 3, 1)
    scan[0] |= {"ms_on_8_queries": q8_ms, "chain_ms_on_8_queries": chain_ms}
    rep["scan"] = {row["name"]: {k: row[k] for k in (
        "ms", "bound_ms", "plain_ms", "launches_on_path")} for row in scan}
    rep["scan"][scan[0]["name"]] |= {"ms_on_8_queries": q8_ms,
                                     "chain_ms_on_8_queries": chain_ms}
    launches |= {row["name"]: row["launches_on_path"] for row in scan}
    return rep, launches, [row] + scan


def dtw_wider(torch, kd, ref, x, qz):
    """The wave4 and wave8 routes at the dtw phase's size: the first group
    (32 queries over the 2^22 x 256 collection) at each r of DTW_WIDER_R
    (20 % and 40 % of L).  The whole group timed, each distance held to
    its id's own (dtw_band_ref) and the first DTW_WIDER_BRUTE queries' to
    the scan's over every series (dtw_scan's rows at r: scan_rows); then
    the table row on a cut
    search (each query's first DTW_WIDER_CUT candidates by bound, the
    bounds past them at BIG, so no round reads them): the wave route
    timed, the spread route once beside it, both bit for bit against
    dtw_search_ref, whose trace gives the bound of the cells an
    abandoning DP needs (needed_cells).  Returns (reports, launches,
    rows)."""
    from repro_torch.core import dtw as cdtw
    reps, rows, launches = [], [], {}
    qg = qz[:cdtw.GROUP]
    for r in DTW_WIDER_R:
        route = kd.dp_route(r)
        s, o = torch.sort(kd.lb_keogh(qg, x, r=r), dim=1, stable=True)
        full = lambda: kd.dtw_search(qg, x, s, o, r=r,  # noqa: E731
                                     round_k=DTW_RK)
        got = full()
        full_ms = time_ms(torch, full, 2, 0)
        require(all(torch.equal(a, b) for a, b in zip(full(), got)),
                f"dtw_search r {r}: launches differ")
        own = ref.dtw_band_ref(qg, x[got[1].long()], r)
        require(bool((got[1] >= 0).all()) and torch.equal(own, got[0]),
                f"dtw r {r}: a distance is not its id's own")
        before = dict(kd.by_route)
        qb = qg[:DTW_WIDER_BRUTE].contiguous()
        t0 = time.perf_counter()
        bd, bi = kd.dtw_scan(qb, x, r=r)
        torch.cuda.synchronize()
        brute_ms = (time.perf_counter() - t0) * 1e3
        require(torch.equal(bd, got[0][:DTW_WIDER_BRUTE]),
                f"dtw r {r} vs brute force: distances differ")
        ran = {k: v - before.get(k, 0) for k, v in kd.by_route.items()
               if v != before.get(k, 0)}
        require(ran == {f"dtw_scan/{kd.scan_route(r)}": 1},
                f"dtw r {r} brute force launches by route {ran}")
        scan = scan_rows(torch, kd, ref, x, qb, r, (torch.sqrt(bd), bi), ran)
        launches |= {row["name"]: row["launches_on_path"] for row in scan}
        sc = s.clone()
        sc[:, DTW_WIDER_CUT:] = ref.BIG
        cut = lambda: kd.dtw_search(qg, x, sc, o, r=r,  # noqa: E731
                                    round_k=DTW_RK)
        cgot = cut()
        ms = time_ms(torch, cut, 3, 0)
        t0 = time.perf_counter()
        other = kd.dtw_search(qg, x, sc, o, r=r, round_k=DTW_RK,
                              route="spread")
        torch.cuda.synchronize()
        spread_ms = (time.perf_counter() - t0) * 1e3
        trace = []
        t0 = time.perf_counter()
        want = ref.dtw_search_ref(qg, x, sc, o, r, DTW_RK,
                                  max_pairs=DTW_REF_PAIRS, trace=trace)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        require(all(torch.equal(a, b) for a, b in zip(cgot, want))
                and all(torch.equal(a, b) for a, b in zip(other, want)),
                f"dtw_search r {r} cut: not bit-equal to dtw_search_ref")
        n_ref = int(cgot[3].sum())
        cells = needed_cells(torch, ref, kd, qg, x, sc, o, trace, r,
                             DTW_RK, route)
        bms, by = rl.dtw_search_work(cells, n_ref, L, int(cgot[2].sum()),
                                     DTW_RK).bound()
        shape = (f"{qg.shape[0]} queries x {DTW_N} series, L {L}, r {r}, "
                 f"round_k {DTW_RK}, each query's first {DTW_WIDER_CUT} "
                 f"candidates by bound: {n_ref} refined, "
                 f"{int(cgot[2].max())} rounds at most (the first group, "
                 f"cut)")
        row = route_row("dtw_search", f"{route}_r{r}", DTW_SRC,
                        DTW_REPLACES.format(122, "search_dtw"), shape, 0.0,
                        ms, plain_ms, bms, by,
                        {"cut shape": "bit-equal to dtw_search_ref",
                         "spread route": "bit-equal"})
        row |= {"spread_ms": spread_ms, "needed_cells": cells,
                "all_cells": n_ref * rl.dtw_cells(L, r),
                "full_group_ms": full_ms}
        rows.append(row)
        rounds_t = got[2].double()
        reps.append({"r": r, "route": route, "full_group_ms": full_ms,
                     "full_rounds": {"min": int(rounds_t.min()),
                                     "median": float(rounds_t.median()),
                                     "max": int(rounds_t.max())},
                     "full_refined": int(got[3].sum()),
                     "bruteforce_queries": DTW_WIDER_BRUTE,
                     "bruteforce_ms": brute_ms,
                     "ties_vs_bruteforce": int(
                         (bi != got[1][:DTW_WIDER_BRUTE]).sum()),
                     "cut": DTW_WIDER_CUT, "cut_ms": ms,
                     "cut_spread_ms": spread_ms,
                     "spread_over_wave": spread_ms / ms,
                     "cut_plain_ms": plain_ms, "cut_refined": n_ref,
                     "cut_rounds_max": int(cgot[2].max()),
                     "bound_ms": bms, "needed_cells": cells,
                     "all_cells": n_ref * rl.dtw_cells(L, r),
                     "scan": {row["name"]: {k: row[k] for k in (
                         "ms", "bound_ms", "plain_ms", "launches_on_path")}
                         for row in scan}})
        rows += scan
        del s, o, sc, qb, bd, bi
        torch.cuda.empty_cache()
    return reps, launches, rows


def dtw_long(torch, isax, kmods, ref, gen):
    """The long-series run (DTW_LONG): for each (series, L, radii), random
    walks made from the seed and DTW_LONG_Q queries (collection series
    z-normalized, then N(0, 0.1) noise), through core.dtw.search_dtw and
    search_dtw_bruteforce at each radius, every count at 0 first (the
    launches by route are these two calls').  Holds: ids equal to the
    brute force's but at ties, distances to 1e-5; then each kernel at the
    search's launch (the group's LB, two launches: the envelopes, then the
    sums; its refinement; the brute force's scan), its first query against
    its plain version (LB to 1e-5, the scan bit for bit; the refinement,
    on a ring route at every radius here, of the whole group bit for bit,
    whose trace gives the cells an abandoning DP needs at DTW_LONG_CELLS
    cells a lane, its bound, and at the route's own width), and its time
    beside its bound: the refinement's with the spread and diag routes'
    times at the same launch beside it (each bit for bit against the same
    plain version), the scan's with its cells a lane and busy lanes, and
    the ring at 16 cells a lane beside it where the radius takes another
    width.  Returns (reports, launches, rows)."""
    from repro_torch.core import dtw as cdtw
    kd = kmods["dtw"]
    reps, launches, rows = [], {}, []
    for n, Lx, radii in DTW_LONG:
        raw = walks(torch, gen, n, Lx)
        pick = torch.randint(0, n, (DTW_LONG_Q,), generator=gen, device=DEV)
        queries = isax.znormalize(raw[pick]) + 0.1 * torch.randn(
            DTW_LONG_Q, Lx, generator=gen, device=DEV)
        x = isax.znormalize(raw).contiguous()
        qz = isax.znormalize(queries).contiguous()
        for r in radii:
            t_run = time.perf_counter()
            torch.cuda.synchronize()
            reset(kmods)
            t0 = time.perf_counter()
            d, ids = cdtw.search_dtw(raw, queries, r=r, round_k=DTW_RK,
                                     device=DEV)
            torch.cuda.synchronize()
            search_ms = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            bd, bi = cdtw.search_dtw_bruteforce(raw, queries, r=r,
                                                device=DEV)
            torch.cuda.synchronize()
            brute_ms = (time.perf_counter() - t0) * 1e3
            routes = dict(kd.by_route)
            names = {"lb_keogh": kd.lb_route(Lx),
                     "dtw_search": kd.dp_route(r, Lx, DTW_RK),
                     "dtw_scan": kd.scan_route(r, Lx)}
            require(routes == {**lb_launches(kd, Lx),
                               f"dtw_search/{names['dtw_search']}": 1,
                               f"dtw_scan/{names['dtw_scan']}": 1},
                    f"dtw L {Lx} r {r}: launches by route {routes}")
            d_err = rel_err(torch, d, bd)
            mism = ids != bi
            require(bool(torch.isfinite(d).all()) and d_err <= 1e-5
                    and (not bool(mism.any()) or bool(
                        ((d[mism] - bd[mism]).abs() <= 1e-5 * bd[mism])
                        .all())),
                    f"dtw L {Lx} r {r} vs brute force: {d_err}, ids "
                    f"{ids.tolist()} {bi.tolist()}")
            # each kernel at the search's launch, its first query held to
            # its plain version
            tag = f"L{Lx}_r{r}"
            lb = kd.lb_keogh(qz, x, r=r)
            t0 = time.perf_counter()
            lb_want = ref.lb_keogh_ref(qz[:1], x, r)
            torch.cuda.synchronize()
            lb_plain = (time.perf_counter() - t0) * 1e3
            lb_err = rel_err(torch, lb[:1], lb_want)
            require(lb_err <= 1e-5, f"lb_keogh L {Lx} r {r}: {lb_err}")
            lb_ms = time_ms(torch, lambda: kd.lb_keogh(qz, x, r=r), 3, 1)
            s, o = torch.sort(lb, dim=1, stable=True)
            del lb
            got = kd.dtw_search(qz, x, s, o, r=r, round_k=DTW_RK)
            require(torch.equal(got[1], ids),
                    f"dtw L {Lx} r {r}: the group's ids differ")
            # a ring route abandons pairs: the whole group against the
            # plain version, whose trace gives the cells it needs
            trace = []
            nq = DTW_LONG_Q
            t0 = time.perf_counter()
            want = ref.dtw_search_ref(qz, x, s, o, r, DTW_RK,
                                      max_pairs=DTW_REF_PAIRS, trace=trace)
            torch.cuda.synchronize()
            search_plain = (time.perf_counter() - t0) * 1e3
            require(all(torch.equal(a, b) for a, b in zip(got, want)),
                    f"dtw_search L {Lx} r {r}: not bit-equal to "
                    f"dtw_search_ref")
            search_k_ms = time_ms(torch, lambda: kd.dtw_search(
                qz, x, s, o, r=r, round_k=DTW_RK), 3, 1)
            # the strip routes at the same launch, held to the same plain
            # version
            beside = {}
            for route in ("spread", "diag"):
                other = kd.dtw_search(qz, x, s, o, r=r, round_k=DTW_RK,
                                      route=route)
                require(all(torch.equal(a, b) for a, b in zip(other, want)),
                        f"dtw_search {route} L {Lx} r {r}: not bit-equal "
                        f"to dtw_search_ref")
                beside[f"{route}_ms"] = time_ms(torch, lambda: kd.dtw_search(
                    qz, x, s, o, r=r, round_k=DTW_RK, route=route), 2, 0)
            n_ref, n_rounds = int(got[3].sum()), int(got[2].sum())
            cells, own = (needed_cells(torch, ref, kd, qz, x, s, o, trace, r,
                                       DTW_RK, route, check=False)
                          for route in (f"ring{DTW_LONG_CELLS[r]}",
                                        names["dtw_search"]))
            beside |= {"needed_cells": cells,
                       "route_needed_cells": own,
                       "route_bound_ms": rl.dtw_search_work(
                           own, n_ref, Lx, n_rounds, DTW_RK).bound()[0]}
            del s, o
            scan_plain, pd2, pi = plain_scan(torch, ref, qz[:1], x, r)
            e = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            e[0].record()
            d2, i2 = kd.dtw_scan(qz, x, r=r)
            e[1].record()
            torch.cuda.synchronize()
            scan_ms = e[0].elapsed_time(e[1])
            require(torch.equal(torch.sqrt(d2), bd) and torch.equal(i2, bi)
                    and torch.equal(d2[:1], pd2) and torch.equal(i2[:1], pi),
                    f"dtw_scan L {Lx} r {r}: differs from the brute force's "
                    f"or dtw_scan_ref")
            # the ring at 16 cells a lane (the layout before the widths by
            # radius) beside it, bit for bit, one launch timed
            scan_beside = {}
            if names["dtw_scan"] != "ring16":
                e[0].record()
                d16, i16 = kd.dtw_scan(qz, x, r=r, route="ring16")
                e[1].record()
                torch.cuda.synchronize()
                require(torch.equal(d16, d2) and torch.equal(i16, i2),
                        f"dtw_scan ring16 L {Lx} r {r}: differs from "
                        f"{names['dtw_scan']}")
                scan_beside = {"ring16_ms": e[0].elapsed_time(e[1]),
                               "ring16": scan_layout(kd, "ring16", r)}
                del d16, i16
            shape = (f"{DTW_LONG_Q} queries x {n} series, L {Lx}, r {r}")
            made = []
            if r == radii[0]:            # the LB's work does not depend on r
                bms, by = rl.lb_keogh_work(DTW_LONG_Q, n, Lx).bound()
                g = kd.lb_long_geometry(DTW_LONG_Q, n, Lx)
                made.append(route_row(
                    "lb_keogh", f"{names['lb_keogh']}_L{Lx}", DTW_SRC,
                    DTW_REPLACES.format(49, "lb_keogh"),
                    f"{shape} (the envelopes, then the sums at "
                    f"{g['slots']} queries a unit)", float(lb_err), lb_ms,
                    lb_plain, bms, by, {"first query": "lb_keogh_ref to "
                                        "1e-5 relative"})
                    | {"plain_queries": 1, "geometry": g})
                launches[made[-1]["name"]] = sum(lb_launches(kd, Lx).values())
            bms, by = rl.dtw_search_work(cells, n_ref, Lx, n_rounds,
                                         DTW_RK).bound()
            made.append(route_row(
                "dtw_search", f"{names['dtw_search']}_{tag}", DTW_SRC,
                DTW_REPLACES.format(122, "search_dtw"),
                f"{shape}, round_k {DTW_RK}, {n_ref} refined", 0.0,
                search_k_ms, search_plain, bms, by,
                {"plain version": f"the first {nq} queries bit-equal to "
                                  f"dtw_search_ref",
                 "spread and diag routes": "bit-equal to dtw_search_ref"})
                | {"plain_queries": nq, "bound_cells_a_lane":
                   DTW_LONG_CELLS[r]} | beside)
            bms, by = rl.dtw_scan_work(DTW_LONG_Q, n, Lx, r).bound()
            made.append(route_row(
                "dtw_scan", f"{names['dtw_scan']}_{tag}", DTW_SRC,
                DTW_REPLACES.format(173, "search_dtw_bruteforce"), shape,
                0.0, scan_ms, scan_plain, bms, by,
                {"brute force": "bit-equal", "first query":
                 "bit-equal to dtw_scan_ref"}) | {"plain_queries": 1}
                | scan_layout(kd, names["dtw_scan"], r) | scan_beside)
            for kernel in ("dtw_search", "dtw_scan"):
                launches[f"{kernel}/{names[kernel]}_{tag}"] = routes[
                    f"{kernel}/{names[kernel]}"]
            rows += made
            reps.append({"series": n, "L": Lx, "r": r,
                         "bytes": 4 * n * Lx, "queries": DTW_LONG_Q,
                         "routes": names, "search_dtw_ms": search_ms,
                         "bruteforce_ms": brute_ms,
                         "ties_vs_bruteforce": int(mism.sum()),
                         "dist_rel_err_vs_bruteforce": d_err,
                         "rounds_max": int(got[2].max()),
                         "refined": n_ref, "by_route": routes,
                         "search": beside,
                         "seconds": time.perf_counter() - t_run,
                         "kernels": {row["name"]: {
                             k: row[k] for k in ("ms", "bound_ms",
                                                 "plain_ms")}
                             | {"launches": launches[row["name"]]}
                             for row in made}})
            del got, want, d2, i2
            torch.cuda.empty_cache()
        del raw, queries, x, qz
        torch.cuda.empty_cache()
    return reps, launches, rows


def dtw_lb_lengths(torch, isax, kd, ref, gen):
    """lb_keogh at the lengths other than the path's (DTW_LB_SHAPES: L
    1024, 4 GiB, one launch of lb_group(1024) = 24 queries; L 100, 32),
    each against lb_keogh_ref to 1e-5 relative, with its time beside its
    bound.  Returns (reports, rows)."""
    reps, rows = [], []
    for n, Lx, nq, r in DTW_LB_SHAPES:
        x = isax.znormalize(walks(torch, gen, n, Lx)).contiguous()
        pick = torch.randint(0, n, (nq,), generator=gen, device=DEV)
        q = isax.znormalize(isax.znormalize(x[pick]) + 0.1 * torch.randn(
            nq, Lx, generator=gen, device=DEV)).contiguous()
        require(nq <= kd.lb_group(Lx), f"lb_keogh L {Lx}: {nq} queries "
                f"take more than one launch")
        want = ref.lb_keogh_ref(q, x, r)
        got = kd.lb_keogh(q, x, r=r)
        err = rel_err(torch, got, want)
        require(err <= 1e-5, f"lb_keogh L {Lx} vs plain: {err}")
        ms = time_ms(torch, lambda: kd.lb_keogh(q, x, r=r), 5, 1)
        plain = time_ms(torch, lambda: ref.lb_keogh_ref(q, x, r), 1, 0)
        bms, by = rl.lb_keogh_work(nq, n, Lx).bound()
        shape = (f"{nq} queries x {n} series, L {Lx}, r {r} (one launch, "
                 f"{kd.lb_route(Lx)} route)")
        rows.append(route_row(
            "lb_keogh", f"L{Lx}", DTW_SRC,
            DTW_REPLACES.format(49, "lb_keogh"), shape,
            float((got - want).abs().max()), ms, plain, bms, by,
            {f"L {Lx}": "lb_keogh to 1e-5 relative"}))
        reps.append({"L": Lx, "series": n, "queries": nq, "r": r,
                     "route": kd.lb_route(Lx), "ms": ms, "bound_ms": bms,
                     "over_bound": ms / bms, "rel_err": err})
        del x, q, want, got
        torch.cuda.empty_cache()
    return reps, rows


def dtw_draws(torch, isax, gen):
    """The dtw phase's collection (DTW_N random walks of length L) and its
    DTW_Q queries: collection series z-normalized, then N(0, 0.1) noise."""
    raw = walks(torch, gen, DTW_N, L)
    pick = torch.randint(0, DTW_N, (DTW_Q,), generator=gen, device=DEV)
    return raw, isax.znormalize(raw[pick]) + 0.1 * torch.randn(
        DTW_Q, L, generator=gen, device=DEV)


def dtw_path(torch, isax, kmods, ref, gen):
    """Exact DTW 1-NN on the card: 2^22 random walks of length 256 made
    from the seed, 256 queries (z-normalized collection series + N(0,
    0.1) noise), band r 12 (5 % of L, the UCR Suite's usual Sakoe-Chiba
    setting), round_k 32, through core.dtw.search_dtw, and the first 32
    queries through search_dtw_bruteforce over all 2^22 series; the
    launch counts are these two calls' (search_dtw is then timed again,
    warm).  Holds: ids equal to the brute
    force's but where two distances lie within 1e-5 relative, distances
    to 1e-5; every reported distance equal to dtw_band_ref on its (query,
    id); each group's refinement (bsf, id, rounds, candidates refined)
    bit for bit against dtw_search_ref; lb_keogh against lb_keogh_ref on
    the first group; the DP (through core.dtw.dtw_band) bit for bit
    against dtw_band_ref on 4,096 sampled pairs.  Then each group's LB,
    sort and refinement timed alone, the rounds and candidates refined a
    query, and the table's rows: each kernel at the path's launch, and
    its other route at the same shape.  Then the wide-band run
    (dtw_wide), the wider bands' (dtw_wider), lb_keogh at other lengths
    (dtw_lb_lengths), the long series' (dtw_long), the edge runs
    (dtw_edges), the long queries' (dtw_long_queries, past the longest
    query a kernel stages), a band past shared memory
    (dtw_device_band, the diag routes) and the full window, r = L - 1,
    on the spread, chain and diag routes (dtw_full_window)."""
    from repro_torch.core import dtw as cdtw
    kd = kmods["dtw"]
    t_phase = time.perf_counter()
    raw, queries = dtw_draws(torch, isax, gen)
    torch.cuda.synchronize()
    alloc0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset(kmods)
    t0 = time.perf_counter()
    d, ids = cdtw.search_dtw(raw, queries, r=DTW_R, round_k=DTW_RK,
                             device=DEV)
    torch.cuda.synchronize()
    search_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - alloc0
    t0 = time.perf_counter()
    bd, bi = cdtw.search_dtw_bruteforce(raw, queries[:DTW_BRUTE], r=DTW_R,
                                        device=DEV)
    torch.cuda.synchronize()
    brute_s = time.perf_counter() - t0
    routes = dict(kd.by_route)
    launches = {k: sum(c for kr, c in routes.items()
                       if kr.split("/")[0] == k)
                for k in ("lb_keogh", "dtw_search", "dtw_scan")}
    # the same search again, warm (the first call pays the allocator's
    # growth and each kernel's first load)
    t0 = time.perf_counter()
    again = cdtw.search_dtw(raw, queries, r=DTW_R, round_k=DTW_RK,
                            device=DEV)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    require(torch.equal(again[0], d) and torch.equal(again[1], ids),
            "dtw: a second search answers differently")
    del again
    groups = DTW_Q // cdtw.GROUP
    require(routes == {f"lb_keogh/{kd.lb_route(L)}": groups,
                       f"dtw_search/{kd.dp_route(DTW_R)}": groups,
                       "dtw_scan/band": 1},
            f"dtw launches by route {routes}")
    require(d.shape == (DTW_Q,) and bool(torch.isfinite(d).all())
            and bool((ids >= 0).all()), "dtw: an answer is missing")
    # exact against the brute force
    dg, ig = d[:DTW_BRUTE], ids[:DTW_BRUTE]
    d_err = rel_err(torch, dg, bd)
    mism = ig != bi
    ties = int(mism.sum())
    require(d_err <= 1e-5, f"dtw vs brute force: distances {d_err}")
    require(not ties or bool(((dg[mism] - bd[mism]).abs()
                              <= 1e-5 * bd[mism]).all()),
            "dtw vs brute force: an id differs beyond a tie")
    # every reported distance is its id's own
    x = isax.znormalize(raw).contiguous()
    del raw
    qz = isax.znormalize(queries).contiguous()
    own = torch.sqrt(ref.dtw_band_ref(qz, x[ids.long()], DTW_R))
    own_err = float((own - d).abs().max())
    require(bool((own == d).all()), f"dtw: a distance is not its id's own "
            f"({own_err})")
    # lb_keogh on the first group
    g0 = qz[:cdtw.GROUP].contiguous()
    lb = kd.lb_keogh(g0, x, r=DTW_R)
    lb_ref = ref.lb_keogh_ref(g0, x, DTW_R)
    lb_err = rel_err(torch, lb, lb_ref)
    lb_abs = float((lb - lb_ref).abs().max())
    require(lb_err <= 1e-5, f"lb_keogh vs plain: {lb_err}")
    del lb
    # the DP on sampled pairs, one dtw_band (a dtw_scan of one pair) each
    pq = torch.randint(0, DTW_Q, (DTW_PAIRS,), generator=gen, device=DEV)
    px = torch.randint(0, DTW_N, (DTW_PAIRS,), generator=gen, device=DEV)
    t0 = time.perf_counter()
    dk = torch.stack([cdtw.dtw_band(qz[a], x[b], DTW_R)
                      for a, b in zip(pq.tolist(), px.tolist())])
    pairs_s = time.perf_counter() - t0
    dr = ref.dtw_band_ref(qz[pq], x[px], DTW_R)
    require(torch.equal(dk, dr), f"DP on {DTW_PAIRS} pairs: not bit-equal "
            f"({float((dk - dr).abs().max())})")
    # the search's pieces, group by group, timed alone; each group's
    # refinement held against the plain version's
    ev = lambda: torch.cuda.Event(enable_timing=True)  # noqa: E731
    parts = {"lb_ms": 0.0, "sort_ms": 0.0, "refine_ms": 0.0}
    rounds, refined, plain_ms, trace = [], [], [], []
    for g in range(0, DTW_Q, cdtw.GROUP):
        qg = qz[g:g + cdtw.GROUP]
        e = [ev() for _ in range(4)]
        e[0].record()
        lbg = kd.lb_keogh(qg, x, r=DTW_R)
        e[1].record()
        s, o = torch.sort(lbg, dim=1, stable=True)
        e[2].record()
        got = kd.dtw_search(qg, x, s, o, r=DTW_R, round_k=DTW_RK)
        e[3].record()
        torch.cuda.synchronize()
        require(torch.equal(got[1], ids[g:g + cdtw.GROUP]),
                "dtw: the timed group's ids differ from the search's")
        for key, a, b in (("lb_ms", 0, 1), ("sort_ms", 1, 2),
                          ("refine_ms", 2, 3)):
            parts[key] += e[a].elapsed_time(e[b])
        t0 = time.perf_counter()
        want = ref.dtw_search_ref(qg, x, s, o, DTW_R, DTW_RK,
                                  max_pairs=DTW_REF_PAIRS,
                                  trace=trace if g == 0 else None)
        torch.cuda.synchronize()
        plain_ms.append((time.perf_counter() - t0) * 1e3)
        require(all(torch.equal(a, b) for a, b in zip(got, want)),
                f"dtw_search, queries {g}..: not bit-equal to "
                f"dtw_search_ref")
        rounds += got[2].tolist()
        refined += got[3].tolist()
        if g == 0:
            first = (qg, s, o, got)
        del lbg, s, o
    rounds_t = torch.tensor(rounds, dtype=torch.float64)
    refined_t = torch.tensor(refined, dtype=torch.float64)
    rep = {"phase": "dtw", "series": DTW_N, "L": L, "queries": DTW_Q,
           "r": DTW_R, "round_k": DTW_RK, "group": cdtw.GROUP,
           "search_dtw_ms": search_s * 1e3,
           "search_dtw_warm_ms": warm_s * 1e3, **parts,
           "bruteforce_queries": DTW_BRUTE, "bruteforce_ms": brute_s * 1e3,
           "rounds": {"min": int(rounds_t.min()),
                      "median": float(rounds_t.median()),
                      "max": int(rounds_t.max())},
           "refined_per_query": {"min": int(refined_t.min()),
                                 "median": float(refined_t.median()),
                                 "max": int(refined_t.max())},
           "pruned_share": 1.0 - float(refined_t.mean()) / DTW_N,
           "peak_bytes_search": peak, "ties_vs_bruteforce": ties,
           "dist_rel_err_vs_bruteforce": d_err,
           "own_distance": "bit-equal to dtw_band_ref",
           "search_check": "every group bit-equal to dtw_search_ref",
           "plain_refine_ms": plain_ms,
           "lb_rel_err": lb_err, "pairs": DTW_PAIRS,
           "pairs_check": "bit-equal to dtw_band_ref", "pairs_s": pairs_s,
           "launches": launches, "by_route": routes}
    # table rows at the main path's launches, each beside another route
    # at the same shape (held to the same plain version)
    rows = []
    shape = (f"{cdtw.GROUP} queries x {DTW_N} series, L {L}, r {DTW_R} "
             f"(one group, the search's launch)")
    plain = time_ms(torch, lambda: ref.lb_keogh_ref(g0, x, DTW_R), 1, 0)
    bms, by = rl.lb_keogh_work(cdtw.GROUP, DTW_N, L).bound()
    for route in (kd.lb_route(L), "scalar"):
        ms = time_ms(torch, lambda: kd.lb_keogh(g0, x, r=DTW_R, route=route),
                     5, 1)
        lb = kd.lb_keogh(g0, x, r=DTW_R, route=route)
        err = rel_err(torch, lb, lb_ref)
        require(err <= 1e-5, f"lb_keogh {route} vs plain: {err}")
        row = {"name": "lb_keogh", "route": "cuda", "source": DTW_SRC,
               "replaces": DTW_REPLACES.format(49, "lb_keogh"),
               "port_side": True, "shape": shape,
               "max_abs_err": float((lb - lb_ref).abs().max()), "ms": ms,
               "plain_ms": plain, "bound_ms": bms, "bound_by": by,
               "library_ms": None}
        if route == "scalar":
            row = route_row("lb_keogh", route, DTW_SRC, row["replaces"],
                            shape, row["max_abs_err"], ms, plain, bms, by,
                            {"main shape": "lb_keogh to 1e-5 relative"})
        rows.append(row)
        del lb
    del lb_ref
    qg, s, o, got = first
    n_ref = int(got[3].sum())
    main_route = kd.dp_route(DTW_R)
    cells = needed_cells(torch, ref, kd, qg, x, s, o, trace, DTW_R, DTW_RK,
                         main_route)
    rep |= {"first_group_needed_cells": cells,
            "first_group_all_cells": n_ref * rl.dtw_cells(L, DTW_R)}
    bms, by = rl.dtw_search_work(cells, n_ref, L, int(got[2].sum()),
                                 DTW_RK).bound()
    shape = (f"{cdtw.GROUP} queries x {DTW_N} series, L {L}, r {DTW_R}, "
             f"round_k {DTW_RK}, {n_ref} refined, {int(got[2].max())} "
             f"rounds at most (the first group)")
    for route in (main_route, "spread"):
        ms = time_ms(torch, lambda: kd.dtw_search(
            qg, x, s, o, r=DTW_R, round_k=DTW_RK, route=route), 3, 1)
        again = kd.dtw_search(qg, x, s, o, r=DTW_R, round_k=DTW_RK,
                              route=route)
        require(all(torch.equal(a, b) for a, b in zip(again, got)),
                f"dtw_search {route}: not bit-equal on the first group")
        row = route_row("dtw_search", route, DTW_SRC,
                        DTW_REPLACES.format(122, "search_dtw"), shape, 0.0,
                        ms, plain_ms[0], bms, by,
                        {"main shape": "bit-equal to dtw_search_ref"})
        rows.append(row if route == "spread"
                    else row | {"name": "dtw_search", "port_side": True})
    del first, qg, s, o
    torch.cuda.empty_cache()
    qb = qz[:DTW_BRUTE].contiguous()
    plain = plain_scan(torch, ref, qz[:1], x, DTW_R)
    bms, by = rl.dtw_scan_work(DTW_BRUTE, DTW_N, L, DTW_R).bound()
    shape = (f"{DTW_BRUTE} queries x {DTW_N} series, L {L}, r {DTW_R} "
             f"(the brute force's launch)")
    for route in ("band", "chain"):
        call = lambda: kd.dtw_scan(qb, x, r=DTW_R, route=route)  # noqa: E731
        if route == "band":
            ms = time_ms(torch, call, 2, 1)
            d2, i = call()
        else:                            # ~1 s a launch here: timed once
            e = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            e[0].record()
            d2, i = call()
            e[1].record()
            torch.cuda.synchronize()
            ms = e[0].elapsed_time(e[1])
        one_ms = time_ms(torch, lambda: kd.dtw_scan(qz[:1], x, r=DTW_R,
                                                    route=route), 3, 1)
        require(torch.equal(torch.sqrt(d2), bd) and torch.equal(i, bi),
                f"dtw_scan {route}: differs from the brute force's")
        require(torch.equal(d2[:1], plain[1]) and torch.equal(i[:1],
                                                              plain[2]),
                f"dtw_scan {route}: differs from dtw_scan_ref")
        row = route_row("dtw_scan", route, DTW_SRC,
                        DTW_REPLACES.format(173, "search_dtw_bruteforce"),
                        shape, 0.0, ms, plain[0], bms, by,
                        {"main shape": "equal to the brute force's answers",
                         "first query": "bit-equal to dtw_scan_ref"})
        row |= {"plain_queries": 1, "ms_on_plain_queries": one_ms}
        rows.append(row if route == "chain"
                    else row | {"name": "dtw_scan", "port_side": True})
        if route == "band":
            band_ms = ms
    # the wave route of 16 cells a lane beside the band route at r 12
    more_rows = scan_rows(torch, kd, ref, x, qb, DTW_R, (bd, bi), {}, plain)
    for row in more_rows:
        row["band_ms"] = band_ms
    rows += more_rows
    del qb
    torch.cuda.empty_cache()
    rep["wide"], more, more_rows = dtw_wide(torch, isax, kmods, ref, x, qz)
    launches = {**launches, **more}
    rows += more_rows
    rep["wider"], more, more_rows = dtw_wider(torch, kd, ref, x, qz)
    launches |= more
    rows += more_rows
    del x, qz
    torch.cuda.empty_cache()
    rep["lb_lengths"], more_rows = dtw_lb_lengths(torch, isax, kd, ref, gen)
    rows += more_rows
    rep["long"], more, more_rows = dtw_long(torch, isax, kmods, ref, gen)
    launches |= more
    rows += more_rows
    rep["edges"] = dtw_edges(torch, isax, kd, ref, gen)
    rep["ring_instances"] = dtw_ring_instances(torch, isax, kd, ref, gen)
    rep["long_queries"], more, more_rows = dtw_long_queries(
        torch, isax, kmods, ref, gen)
    launches |= more
    rows += more_rows
    rep["device_band"], more, more_rows = dtw_device_band(
        torch, isax, kmods, ref, gen)
    launches |= more
    rows += more_rows
    rep["full_window"], more, more_rows = dtw_full_window(
        torch, isax, kmods, ref, gen)
    launches |= more
    rows += more_rows
    rep["rows"] = rows
    rep["seconds"] = time.perf_counter() - t_phase
    return rep, launches, rows


# ------------------------------------------------------------------ checker
CHECKER_BUDGET, CHECKER_CLI_BUDGET = 8, 200


def checker_path(torch, index, src):
    """The port's race checker.  On the card: PlanCacheScenario over the
    main cell's index (after the serve phase's adds and deletes) with
    real captures, one CUDA graph a plan made, at buckets 1 and 8, k 10,
    3 getters of one key, one of another, a late getter of the old epoch
    and a publish dropping it, CHECKER_BUDGET random schedules: at most
    one plan made a key, every call counted, nothing of the dropped
    epoch kept, each plan's replay byte-equal to the facade's search of
    the same rows.  A capture runs while every other scheduled thread is
    parked (none makes a CUDA call), in the plan cache's own capture mode
    ("thread_local").  Then `python -m repro_torch.analysis.checker
    --budget 200` (every scenario, on the CPU) in a child process."""
    from repro_torch.analysis.checker import PlanCacheScenario, explore
    from repro_torch.analysis.schedules import RandomStrategy
    t0 = time.perf_counter()
    sc = PlanCacheScenario(name="plan_cache.card", n_getters=3, index=index,
                           buckets=(1, 8), k=TOPK)
    rep = explore(sc, RandomStrategy(seed=0), budget=CHECKER_BUDGET)
    card_s = time.perf_counter() - t0
    require(rep.ok, f"checker on the card: {rep.violations[:3]}")
    require(rep.runs == CHECKER_BUDGET, f"checker ran {rep.runs} schedules")
    t0 = time.perf_counter()
    env = {**os.environ, "PYTHONPATH": str(src)}
    cli = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.checker", "--budget",
         str(CHECKER_CLI_BUDGET)], capture_output=True, text=True, env=env,
        cwd=str(src.parent), timeout=900)
    cli_s = time.perf_counter() - t0
    lines = cli.stdout.strip().splitlines()
    total = next((ln for ln in lines if ln.startswith("total:")), "")
    require(cli.returncode == 0 and "0 scenario(s) with violations" in total,
            f"checker CLI exit {cli.returncode}: {cli.stdout[-2000:]} "
            f"{cli.stderr[-2000:]}")
    return {"phase": "checker",
            "card": {"scenario": "PlanCacheScenario", "buckets": [1, 8],
                     "k": TOPK, "getters": 3, "schedules": rep.runs,
                     "distinct": rep.distinct, "steps": rep.steps,
                     "violations": len(rep.violations),
                     "capture_mode": "thread_local", "seconds": card_s},
            "cli": {"budget": CHECKER_CLI_BUDGET, "total": total,
                    "scenarios": [ln for ln in lines if " runs=" in ln],
                    "seconds": cli_s}}


# ----------------------------------------------------------------- fidelity
FID_N, FID_THREADS = 1 << 16, 8


def fidelity_path(torch, core_index, seed, smi):
    """The host-faithful plane: build_index_host (words on the card,
    BC -> TP on the host) over 2^16 seismic_like series of length 256
    under RefreshExecutor, DoAllSplit, FaiBased and CasBased at 8
    threads.  Holds: every id in the forest, each of its entries with
    the word the one-pass build_index stores for it.  An id may sit there
    twice: BC and TP apply each element at least once, and a helper that
    re-executes a part inserts its pairs again (repro's build does the
    same); the count is reported."""
    import numpy as np
    from repro_torch.core.baselines import CasBased, DoAllSplit, FaiBased
    from repro_torch.core.refresh import RefreshExecutor
    from repro_torch.data.synthetic import seismic_like
    t_phase = time.perf_counter()
    raw = seismic_like(FID_N, L, seed=seed)
    idx = core_index.build_index(torch.as_tensor(raw, device=DEV))
    keep = idx.perm >= 0
    words = np.empty((FID_N, idx.words.shape[1]), np.uint8)
    words[idx.perm[keep].cpu().numpy()] = idx.words[keep].cpu().numpy()
    del idx
    rep = {"phase": "fidelity", "series": FID_N, "L": L,
           "threads": FID_THREADS, "leaf_capacity": 64, "nvidia_smi": smi}
    for name, ex in (("refresh", RefreshExecutor(n_threads=FID_THREADS)),
                     ("do_all_split", DoAllSplit(FID_THREADS)),
                     ("fai_based", FaiBased(FID_THREADS)),
                     ("cas_based", CasBased(FID_THREADS))):
        t0 = time.perf_counter()
        forest, _ = core_index.build_index_host(
            raw, ex, leaf_capacity=64, n_threads=FID_THREADS, device=DEV)
        secs = time.perf_counter() - t0
        entries = [e for t in forest.values() for e in t.items()]
        ids = np.array([pl for _, pl in entries])
        counts = np.bincount(ids, minlength=FID_N)
        require(len(counts) == FID_N and counts.min() >= 1,
                f"fidelity {name}: {int((counts == 0).sum())} ids missing")
        require(bool((np.stack([w for w, _ in entries])
                      == words[ids]).all()),
                f"fidelity {name}: a word differs from build_index's")
        rep[name] = {"seconds": secs, "entries": len(entries),
                     "ids_twice_or_more": int((counts > 1).sum()),
                     "subtrees": len(forest)}
    rep["seconds"] = time.perf_counter() - t_phase
    return rep


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--series", type=int, default=1 << 24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", choices=("dtw", "dtw_wide"), default=None,
                    help="run the dtw and dtw_wide phases alone, or the "
                         "dtw_wide phase")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: no repro_torch under {src}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    global rl
    from repro_torch import api
    from repro_torch.launch import roofline as rl
    from repro_torch.core import index as core_index
    from repro_torch.core import isax, search
    from repro_torch.kernels import _build, ops, ref
    # the plain versions' products in full float32, as the kernels compute
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    emit({"phase": "device", "nvidia_smi": smi,
          "torch_name": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    rep = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_s": {k: v["seconds"] for k, v in rep.items()},
          "ptxas": {k: [ln.strip() for ln in v["ptxas"].splitlines()
                        if "Used" in ln or "spill" in ln]
                    for k, v in rep.items()}})
    # (only what was built here, not cached)
    ptx = {}
    if rep["flash_attention"]["ptxas"]:
        ptx["attention"] = attention_ptxas(rep["flash_attention"]["ptxas"])
    if rep["dtw"]["ptxas"] and rep["dtw_ring"]["ptxas"]:
        ptx["dtw"] = dtw_ptxas(
            rep["dtw"]["ptxas"] + rep["dtw_ring"]["ptxas"],
            ops.WRAPPERS["dtw"].SCAN_RING_WIDTHS,
            ops.WRAPPERS["dtw"].DIAG_ROWS,
            ops.WRAPPERS["dtw"].SEARCH_RING_WIDTHS)
    if ptx:
        emit({"phase": "ptxas", **ptx})

    gen = torch.Generator(device=DEV).manual_seed(args.seed)
    # the edge cases draw from their own generator, so that the main phase
    # gets the same collection and queries whatever cases are added here
    edge_gen = torch.Generator(device=DEV).manual_seed(args.seed + 1)
    # so do the route cases and the paths added after the main one
    more_gen = torch.Generator(device=DEV).manual_seed(args.seed + 2)
    # and the per-leaf kernels' cases, and the serve phase
    leaf_gen = torch.Generator(device=DEV).manual_seed(args.seed + 3)
    serve_gen = torch.Generator(device=DEV).manual_seed(args.seed + 4)
    shard_gen = torch.Generator(device=DEV).manual_seed(args.seed + 5)
    dtw_gen = torch.Generator(device=DEV).manual_seed(args.seed + 6)
    topk_gen = torch.Generator(device=DEV).manual_seed(args.seed + 7)
    wide_gen = torch.Generator(device=DEV).manual_seed(args.seed + 9)
    kmods = dict(ops.WRAPPERS)
    if args.only:
        rows, launches = [], {}
        if args.only == "dtw":
            report, launches, rows = dtw_path(torch, isax, kmods, ref,
                                              dtw_gen)
            emit(report)
            torch.cuda.empty_cache()
        report, more, more_rows = dtw_wide_path(torch, isax, kmods, ref,
                                                wide_gen)
        emit(report)
        return finish(torch, rows + more_rows, launches | more, smi)
    rows, launches = [], {}
    for name, check, args_ in (
            ("summarize", check_summarize, (isax, kmods["summarize"],
                                            ref, gen, more_gen)),
            ("lb_distance", check_lb_distance, (kmods["lb_distance"],
                                                ref, gen)),
            ("refine_topk", check_refine, (isax, kmods["refine_topk"],
                                           ref, gen, topk_gen)),
            ("refine_search", check_refine_search, (
                api, search, kmods["refine_search"], ref, edge_gen)),
            ("ed_argmin", check_ed_argmin, (isax, kmods["ed_argmin"],
                                            ref, gen, edge_gen)),
            ("flash_attention", check_flash, (kmods["flash_attention"],
                                              ref, gen, edge_gen)),
            ("leaf_stats", check_leaf_stats, (
                api, isax, core_index, kmods["leaf_stats"],
                kmods["leaf_gather"], ref, leaf_gen)),
            ("leaf_gather", check_leaf_gather, (isax, kmods["leaf_gather"],
                                                ref, leaf_gen))):
        kmods[name].launches = 0
        r = check(torch, *args_)
        torch.cuda.empty_cache()
        rows.append(r)
        emit({"phase": "kernel", **r, "launches": kmods[name].launches,
              "result": "PASS"})
    torch.cuda.empty_cache()
    emit(grid_strides(torch, kmods, ref, more_gen))
    torch.cuda.empty_cache()
    emit({"phase": "grid", **attention_rows_past_the_grid(
        torch, kmods["flash_attention"], ref,
        torch.Generator(device=DEV).manual_seed(args.seed + 8))})
    torch.cuda.empty_cache()
    for r in check_routes(torch, api, isax, search, kmods, ref,
                          more_gen):
        torch.cuda.empty_cache()
        rows.append(r)
        emit({"phase": "route", **r, "result": "PASS"})

    report, more, (index, q, d, ids, queries), loop_row, (
        loop_args, loop_out) = main_path(torch, api, isax, search, kmods,
                                         ref, args.series, gen)
    emit(report)
    launches |= more
    rounds, more = rounds_phase(torch, ops, kmods, loop_args, loop_out)
    emit(rounds)
    launches |= more
    del loop_args, loop_out
    scan, more = scan_phase(torch, ops, kmods, ref, index, q, d, ids,
                            min(report["search_ms_repeats"]))
    emit(scan)
    launches |= more
    # the scan's own shape replaces the kernel phase's 2^20 in the
    # table, the main cell's refinement the kernel phase's 2^18
    mains = {"ed_argmin": scan["row"], "refine_search": loop_row}
    rows = [mains.get(r["name"], r) for r in rows]
    torch.cuda.empty_cache()
    report, more = approx_path(torch, isax, search, kmods, ref, index,
                               queries, q, d, ids)
    emit(report)
    launches |= {k: v for k, v in more.items() if k not in launches}
    torch.cuda.empty_cache()
    report, more = sharded_path(torch, api, isax, kmods, index, queries, d,
                                ids, shard_gen)
    emit(report)
    # refine_topk's launches in the table are this path's (the rounds
    # phase's stand in its own line)
    launches |= {"refine_topk": more["refine_topk"]}
    torch.cuda.empty_cache()
    report, more = serve_path(torch, isax, kmods, ref, index, queries, d,
                              ids, serve_gen)
    emit(report)
    launches |= {k: v for k, v in more.items() if k not in launches}
    emit(checker_path(torch, index, src))
    del index, q, d, ids, queries
    torch.cuda.empty_cache()
    report, more = l96_path(torch, api, isax, kmods, more_gen)
    emit(report)
    launches |= {k: v for k, v in more.items() if k not in launches}
    torch.cuda.empty_cache()
    report, more = lifecycle_path(torch, api, isax, kmods, more_gen)
    emit(report)
    launches |= {k: v for k, v in more.items() if k not in launches}
    torch.cuda.empty_cache()
    report, more, dtw_rows = dtw_path(torch, isax, kmods, ref, dtw_gen)
    emit(report)
    launches |= more
    rows += dtw_rows
    torch.cuda.empty_cache()
    report, more, dtw_rows = dtw_wide_path(torch, isax, kmods, ref, wide_gen)
    emit(report)
    launches |= more
    rows += dtw_rows
    torch.cuda.empty_cache()
    emit(fidelity_path(torch, core_index, args.seed, smi))
    torch.cuda.empty_cache()
    attn, more = attention_phase(torch, ops, kmods, ref, gen)
    emit(attn)
    launches |= more
    return finish(torch, rows, launches, smi)


def finish(torch, rows, launches, smi) -> int:
    """Every kernel of the table launched on some path, and none faster
    than its bound allows (hold_bound); then the kernel table, the
    nvidia-smi line and the device line."""
    missing = [r["name"] for r in rows
               if "/" not in r["name"] and not launches.get(r["name"])]
    require(not missing, f"no path launched {missing}")
    for r in rows:
        hold_bound(r["name"], r["bound_ms"], r["ms"])
    emit({"kernels": [{k: r[k] for k in (
        "name", "route", "source", "replaces")} | {
        "launches": launches.get(r["name"], 0)} | {k: r[k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")} for r in rows]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
