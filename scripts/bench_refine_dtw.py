#!/usr/bin/env python3
"""Time refine_topk, dtw_lb_keogh, dtw_search and dtw_scan of one tree's
src/ on one NVIDIA GPU, to compare two versions of the kernels in turns
in one call:

    python3 scripts/bench_refine_dtw.py [--src DIR] [--reps R] [--seed S]

`--src` imports repro_torch from another tree's src/ (a `git archive` of
another commit that has src/repro_torch/launch/roofline.py, where the
bounds come from); run it as parent, change, change, parent.  The inputs
are drawn by chip_smoke.py's own helpers, so both trees see the same.
refine_topk: Q 256 queries, leaves of 64 rows of length 256, k 10,
float32, at K 8, 16 and 264 slots a row: a first round with every slot
alive (every candidate passes the empty buffer), then rounds folding
into a buffer carried from a half-alive first round with all, half and
1 in 20 slots alive; each case the kernel's own device time over 20 x R
launches (torch.profiler), held equal to its first launch.
lb_keogh: the first group of chip_smoke.py's dtw phase (its draws, 32
queries x 2^22 series, L 256, r 12), the mean of 5 R launches by CUDA
events, the bounds held equal to the first launch's.
dtw_search: the same group at r 12 and at r 25 (chip_smoke.py's wide
run), each with its LB_Keogh and sort made once; the mean of R launches
by CUDA events, held equal to the first launch (a launch that takes
over a second is timed once: a tree without a wave route for r 25 took
a route of a thread a pair, since deleted), and the query with the most
rounds alone (beside a launch under a second).
dtw_scan: the brute force's launches, by each tree's default route, at
r 12 on the group's 32 queries and at r 25 on its first 8 (the dtw
phase's shapes before the brute forces took 32 queries), and the diag
route at r 25 on the 8, timed as dtw_search is (a launch over a second:
once), each held equal to its first launch; then small collections
(SMALL_N walks of L 256, z-normalized, 256 noisy queries, r 25: a
UCR-archive-sized scan), by the default and the diag route, the mean of
R launches each, held equal to each other, beside the scan's bound
(roofline.dtw_scan_work).
Prints one JSON line with the card's name and power limit.  Without CUDA
it exits 1 before printing a result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TOPK_K = (8, 16, 264)
TOPK_CASES = (("first_all", 1.0), ("all", 1.0), ("half", 0.5),
              ("late", 0.05))
SMALL_N, SMALL_Q = (1000, 10000), 256
# repro_torch.launch.roofline of the tree under test, imported by main()
rl = None


def refine_case(torch, isax, rk, cs, gen, reps: int) -> dict:
    Q, M, L, k, NL = cs.Q, cs.M, cs.L, cs.TOPK, 4096
    x = isax.znormalize(cs.walks(torch, gen, NL * M, L))
    qv = isax.znormalize(cs.walks(torch, gen, Q, L))
    qsq, xn = (qv * qv).sum(1), (x * x).sum(1)
    empty = (torch.full((Q, k), 1e30, device="cuda"),
             torch.zeros((Q, k), dtype=torch.int32, device="cuda"))
    out = {"shape": f"Q={Q} M={M} L={L} k={k}, f32"}
    for K in TOPK_K:
        def alive(share, K=K):
            return torch.rand(Q, K, generator=gen, device="cuda") < share
        carried = rk.refine_topk(qv, qsq, x, xn,
                                 cs.draw_leaves(torch, gen, Q, NL, K),
                                 alive(0.5), *empty, leaf_capacity=M, k=k)
        for name, share in TOPK_CASES:
            args = (qv, qsq, x, xn, cs.draw_leaves(torch, gen, Q, NL, K),
                    alive(share),
                    *(empty if name == "first_all" else carried))
            call = lambda: rk.refine_topk(*args, leaf_capacity=M, k=k)  # noqa
            want = call()
            dev = cs.device_ms(torch, call, 20 * reps)
            assert all(torch.equal(a, b) for a, b in zip(call(), want)), (
                K, name)
            out[f"K{K}_{name}"] = {"device_ms": dev,
                                   "alive_slots": int(args[5].sum())}
    return out


def dtw_case(torch, isax, kd, cs, gen, reps: int) -> dict:
    raw, queries = cs.dtw_draws(torch, isax, gen)
    x = isax.znormalize(raw).contiguous()
    del raw
    qg = isax.znormalize(queries[:32]).contiguous()
    shape = (f"{qg.shape[0]} queries x {cs.DTW_N} series, L {cs.L}, "
             f"round_k {cs.DTW_RK} (the dtw phase's first group)")
    lb = lambda: kd.lb_keogh(qg, x, r=cs.DTW_R)  # noqa: E731
    first = lb()
    out = {"lb_keogh": {"ms": cs.time_ms(torch, lb, 5 * reps, 1),
                        "bound_ms": rl.lb_keogh_work(32, cs.DTW_N,
                                                     cs.L).bound()[0],
                        "r": cs.DTW_R, "shape": shape}}
    assert torch.equal(lb(), first), "lb_keogh"
    del first
    for r in (cs.DTW_R, cs.DTW_WIDE_R):
        s, o = torch.sort(kd.lb_keogh(qg, x, r=r), dim=1, stable=True)
        call = lambda: kd.dtw_search(qg, x, s, o, r=r,  # noqa: E731
                                     round_k=cs.DTW_RK)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        want = call()
        ev[1].record()
        torch.cuda.synchronize()
        ms = ev[0].elapsed_time(ev[1])
        if ms < 1000:
            ms = cs.time_ms(torch, call, reps, 1)
        assert all(torch.equal(a, b) for a, b in zip(call(), want)), r
        out[f"dtw_search_r{r}"] = {"ms": ms, "r": r,
                                   "rounds_max": int(want[2].max()),
                                   "refined": int(want[3].sum()),
                                   "shape": shape}
        if ms < 1000:
            # the query with the most rounds, alone: its launch's share
            g = int(torch.argmax(want[2]))
            one = lambda: kd.dtw_search(  # noqa: E731
                qg[g:g + 1], x, s[g:g + 1].contiguous(),
                o[g:g + 1].contiguous(), r=r, round_k=cs.DTW_RK)
            assert all(torch.equal(a, b[g:g + 1])
                       for a, b in zip(one(), want)), (r, g)
            out[f"dtw_search_r{r}"]["slowest_alone_ms"] = cs.time_ms(
                torch, one, reps, 1)
        del s, o
    for r, nq, route in ((cs.DTW_R, 32, None), (cs.DTW_WIDE_R, 8, None),
                         (cs.DTW_WIDE_R, 8, "diag")):
        qb = qg[:nq].contiguous()
        call = lambda: kd.dtw_scan(qb, x, r=r, route=route)  # noqa: E731
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        want = call()
        ev[1].record()
        torch.cuda.synchronize()
        ms = ev[0].elapsed_time(ev[1])
        if ms < 1000:
            ms = cs.time_ms(torch, call, reps, 1)
        assert all(torch.equal(a, b) for a, b in zip(call(), want)), r
        out[f"dtw_scan_r{r}_q{nq}" + (f"_{route}" if route else "")] = {
            "ms": ms, "r": r, "queries": nq,
            "shape": f"{nq} queries x {cs.DTW_N} series, L {cs.L}"}
    del x, qg
    r = cs.DTW_WIDE_R
    for n in SMALL_N:
        xs = isax.znormalize(cs.walks(torch, gen, n, cs.L)).contiguous()
        pick = torch.randint(0, n, (SMALL_Q,), generator=gen, device="cuda")
        qs = isax.znormalize(xs[pick] + 0.1 * torch.randn(
            SMALL_Q, cs.L, generator=gen, device="cuda")).contiguous()
        got = {}
        for route in (None, "diag"):
            call = lambda: kd.dtw_scan(qs, xs, r=r, route=route)  # noqa
            want = call()
            got[route or kd.scan_route(r)] = {
                "ms": cs.time_ms(torch, call, reps, 1)}
            assert all(torch.equal(a, b) for a, b in zip(call(), want)), n
            if route is None:
                first = want
        assert all(torch.equal(a, b) for a, b in zip(want, first)), n
        out[f"dtw_scan_r{r}_n{n}"] = got | {
            "bound_ms": rl.dtw_scan_work(SMALL_Q, n, cs.L, r).bound()[0],
            "shape": f"{SMALL_Q} queries x {n} series, L {cs.L}, r {r}"}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("bench_refine_dtw: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, args.src)
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs              # its draws and timers
    global rl
    from repro_torch.launch import roofline as rl
    from repro_torch.core import isax
    from repro_torch.kernels import _build, dtw, refine
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    _build.build_all()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    rep = {"src": args.src, "card": smi,
           "refine_topk": refine_case(torch, isax, refine, cs, gen,
                                      args.reps)}
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 6)
    rep |= dtw_case(torch, isax, dtw, cs, gen, args.reps)
    print(json.dumps(rep), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
