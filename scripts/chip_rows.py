#!/usr/bin/env python3
"""Time rows of a tree's kernel table by that tree's own `chip_smoke.py`,
so that a parent commit and a change can be timed in turns in one call
on the card:

    python3 scripts/chip_rows.py TREE TAG [--groups attention,refine_search]

TREE is the root of a checkout (for a parent, `git archive` unpacked into
a gitignored directory); its `chip_smoke.py` and `src/repro_torch` are
imported, so its kernels are built from its own sources into its own
build directory.  Each group runs the `chip_smoke.py` function that makes
those table rows, checks included:

    attention      route_flash: every ATTN_ROWS row of the tree, and
                   granite-8b's row (GRANITE, bf16, causal: the kernel
                   phase's) by device time
    refine_search  route_refine_search: cta2, cta1, general
    ed_argmin      route_ed_argmin: L 100 f32 and bf16, L 235
    dtw_long       dtw_long_queries: L 16,400 at r 12, 40 and 200; then
                   (long_rows) dtw_search at that shape at round_k 256
                   on every route that takes the radius (the default,
                   every ring width, spread, diag; a ring width the
                   tree's dp_routes leaves out forced), and at the long
                   cell (DTW_LONG: 32 queries over 2^16 walks of 2,709
                   points at r 27 and 135, 2^14 of 8,192 at r 81, round_k
                   32) on the same routes, with lb_keogh's launches and
                   core.dtw.search_dtw's wall time (the median of 3); the
                   mean of 5 launches after one, rows named
                   `<kernel>/<route>_L<L>_r<r>` (`search_dtw/L<L>_r<r>`),
                   each with its route and a hash of its answers (the
                   trees' must agree)
    dtw_scan       dtw_scan on the tree's default route at the long
                   series' shapes (DTW_LONG: 32 queries over 2^16 walks
                   of 2,709 points at r 27 and 135, 2^14 of 8,192 at r
                   81) and at the dtw cell's wider bands (32 queries
                   over 2^22 walks of 256 at r 25, 51 and 102: wave16),
                   one launch timed after one; rows named by shape, each
                   with its route and a hash of its answers (the trees'
                   hashes must agree)
    dtw_band       the diag routes of dtw_search (round_k 32) and
                   dtw_scan at the device band (DTW_DEVBAND: L 25,700, r
                   25,650, their default) and at the long queries'
                   shape (DTW_LONGQ: L 16,400, r 12, 40 and 200, the
                   route forced), one launch timed after one, each with a
                   hash of its answers (the trees' must agree); rows named
                   `<kernel>/diag_L<L>_r<r>_band`
    dtw_wide       dtw_search (round_k 32, or as stated) and dtw_scan on
                   the tree's default routes at the shapes the general
                   routes took before the spread and chain routes
                   (WIDE_SWEEP: 4 queries x 256 walks at L 256, r 128,
                   192, 255; L 1,024, r 128, 256, 512, 1,023; L 2,709, r
                   271; L 256, r 12, round_k 2,048) and at a cell's size
                   (WIDE_CELLS: 32 queries x 2^16 walks at L 2,709, r 271,
                   both kernels; L 1,024, r 512, the scan), one launch
                   timed after one (a launch past 2 s timed alone), each
                   with its route and a hash of its answers (the trees'
                   must agree); rows named `<kernel>/L<L>_r<r>[_rk<k>]`
                   and `.._cell`; a launch under 100 ms timed as the
                   mean of 5 (sub-millisecond launches of a few pairs
                   vary by tens of percent one at a time)

Prints one JSON line: the tag, the card (`nvidia-smi`'s name and power
limit) and each row's ms (and the dtw_scan rows' routes and hashes).  Run
parent, change, change, parent and compare each row's medians.  Needs a
CUDA card; exits 1 without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

GROUPS = ("attention", "refine_search", "ed_argmin", "dtw_long",
          "dtw_scan", "dtw_band", "dtw_wide")
# the dtw_wide group's shapes: (series, queries, L, r, round_k, search)
WIDE_SWEEP = tuple((256, 4, L, r, k, True) for L, r, k in (
    (256, 128, 32), (256, 192, 32), (256, 255, 32), (1024, 128, 32),
    (1024, 256, 32), (1024, 512, 32), (1024, 1023, 32), (2709, 271, 32),
    (256, 12, 2048)))
WIDE_CELLS = ((1 << 16, 32, 2709, 271, 32, True),
              (1 << 16, 32, 1024, 512, 32, False))


def scan_rows(torch, cs, isax, kd, gen):
    """The dtw_scan group's rows: ({name: ms}, {name: {route, hash}})."""
    ms, detail = {}, {}
    for n, Lx, radii in (*cs.DTW_LONG, (1 << 22, 256, (25, 51, 102))):
        raw = cs.walks(torch, gen, n, Lx)
        pick = torch.randint(0, n, (32,), generator=gen, device=cs.DEV)
        noise = 0.1 * torch.randn(32, Lx, generator=gen, device=cs.DEV)
        q = isax.znormalize(isax.znormalize(raw[pick]) + noise).contiguous()
        x = isax.znormalize(raw).contiguous()
        del raw
        for r in radii:
            d2, i = kd.dtw_scan(q, x, r=r)
            name = f"dtw_scan/L{Lx}_r{r}"
            ms[name] = cs.time_ms(torch, lambda: kd.dtw_scan(q, x, r=r), 1,
                                  0)
            key = ((d2.view(torch.int32).long() << 32) | i.long()).tolist()
            detail[name] = {"route": kd.scan_route(r, Lx),
                            "hash": hex(hash(tuple(key)) & (2 ** 64 - 1))}
        del x, q
        torch.cuda.empty_cache()
    return ms, detail


def ring_names(kd, r: int) -> list:
    """The tree's ring routes of dtw_search that take radius r (at most 32
    lanes a pair: ceil((2r + 1) / cells) <= 32), narrowest first."""
    cells = sorted(kd.RING_CELLS.values())
    return [f"ring{c}" for c in cells if -(-(2 * r + 1) // c) <= 32]


def long_rows(torch, cs, isax, kd, gen):
    """The dtw_long group's route rows (see the top): ({name: ms}, {name:
    {route, hash}})."""
    from repro_torch.core import dtw as cdtw
    ms, detail = {}, {}

    def key(out):
        return hex(hash(tuple(v for a in out for v in a.tolist()))
                   & (2 ** 64 - 1))

    def search_rows(q, x, s, o, r, rk, tag):
        Lx = x.shape[1]
        routes = list(dict.fromkeys((*kd.dp_routes(r, Lx, rk),
                                     *ring_names(kd, r))))
        plain_routes = kd.dp_routes
        kd.dp_routes = lambda *a: tuple(routes)    # a ring width forced
        try:
            for route in routes:
                call = lambda: kd.dtw_search(  # noqa: E731
                    q, x, s, o, r=r, round_k=rk, route=route)
                out = call()
                name = f"dtw_search/{route}_{tag}"
                ms[name] = cs.time_ms(torch, call, 5, 0)
                detail[name] = {"route": route, "hash": key(out),
                                "default": route == routes[0]}
        finally:
            kd.dp_routes = plain_routes

    n, Lx, nq, radii = cs.DTW_LONGQ
    x = isax.znormalize(cs.walks(torch, gen, n, Lx)).contiguous()
    pick = torch.randint(0, n, (nq,), generator=gen, device=cs.DEV)
    q = isax.znormalize(x[pick] + 0.1 * torch.randn(
        nq, Lx, generator=gen, device=cs.DEV)).contiguous()
    for r in radii:
        s, o = torch.sort(kd.lb_keogh(q, x, r=r), dim=1, stable=True)
        search_rows(q, x, s, o, r, n, f"L{Lx}_r{r}_rk{n}")
        del s, o
    del q, x
    torch.cuda.empty_cache()
    for n, Lx, radii in cs.DTW_LONG:
        raw = cs.walks(torch, gen, n, Lx)
        pick = torch.randint(0, n, (cs.DTW_LONG_Q,), generator=gen,
                             device=cs.DEV)
        queries = isax.znormalize(raw[pick]) + 0.1 * torch.randn(
            cs.DTW_LONG_Q, Lx, generator=gen, device=cs.DEV)
        x = isax.znormalize(raw).contiguous()
        q = isax.znormalize(queries).contiguous()
        for r in radii:
            tag = f"L{Lx}_r{r}"
            call = lambda: kd.lb_keogh(q, x, r=r)  # noqa: E731
            lb = call()
            name = f"lb_keogh/{kd.lb_route(Lx)}_{tag}"
            ms[name] = cs.time_ms(torch, call, 3, 0)
            detail[name] = {"route": kd.lb_route(Lx),
                            "hash": key((lb.view(torch.int32).flatten(),))}
            s, o = torch.sort(lb, dim=1, stable=True)
            del lb
            search_rows(q, x, s, o, r, cs.DTW_RK, tag)
            del s, o
            walls = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = cdtw.search_dtw(raw, queries, r=r, round_k=cs.DTW_RK,
                                      device=cs.DEV)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            name = f"search_dtw/{tag}"
            ms[name] = sorted(walls)[1]
            detail[name] = {"route": kd.dp_route(r, Lx, cs.DTW_RK),
                            "hash": key(out)}
        del raw, queries, x, q
        torch.cuda.empty_cache()
    return ms, detail


def band_rows(torch, cs, isax, kd, gen):
    """The dtw_band group's rows: ({name: ms}, {name: {route, hash}})."""
    ms, detail = {}, {}
    n, Lx, nq, r = cs.DTW_DEVBAND
    raw = cs.walks(torch, gen, n, Lx)
    pick = torch.randint(0, n, (nq,), generator=gen, device=cs.DEV)
    noise = 0.1 * torch.randn(nq, Lx, generator=gen, device=cs.DEV)
    shapes = [(isax.znormalize(isax.znormalize(raw[pick]) + noise)
               .contiguous(), isax.znormalize(raw).contiguous(), (r,))]
    n, Lx, nq, radii = cs.DTW_LONGQ
    x = isax.znormalize(cs.walks(torch, gen, n, Lx)).contiguous()
    pick = torch.randint(0, n, (nq,), generator=gen, device=cs.DEV)
    q = isax.znormalize(x[pick] + 0.1 * torch.randn(
        nq, Lx, generator=gen, device=cs.DEV)).contiguous()
    shapes.append((q, x, radii))
    for q, x, radii in shapes:
        Lx = x.shape[1]
        for r in radii:
            s, o = torch.sort(kd.lb_keogh(q, x, r=r), dim=1, stable=True)
            for kernel, call in (
                    ("dtw_search", lambda: kd.dtw_search(
                        q, x, s, o, r=r, round_k=cs.DTW_RK, route="diag")),
                    ("dtw_scan", lambda: kd.dtw_scan(q, x, r=r,
                                                     route="diag"))):
                out = call()
                name = f"{kernel}/diag_L{Lx}_r{r}_band"
                ms[name] = cs.time_ms(torch, call, 1, 0)
                key = tuple(v for t in out for v in t.tolist())
                detail[name] = {"route": "diag",
                                "hash": hex(hash(key) & (2 ** 64 - 1))}
            del s, o
        del q, x
        torch.cuda.empty_cache()
    return ms, detail


def wide_rows(torch, cs, isax, kd, gen):
    """The dtw_wide group's rows: ({name: ms}, {name: {route, hash}})."""
    ms, detail = {}, {}

    def timed(call):                     # one launch after one, or alone
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        out = call()
        b.record()
        torch.cuda.synchronize()
        first = a.elapsed_time(b)
        return out, (first if first > 2000 else cs.time_ms(
            torch, call, 5 if first < 100 else 1, 0))
    for n, nq, Lx, r, rk, search in WIDE_SWEEP + WIDE_CELLS:
        raw = cs.walks(torch, gen, n, Lx)
        pick = torch.randint(0, n, (nq,), generator=gen, device=cs.DEV)
        noise = 0.1 * torch.randn(nq, Lx, generator=gen, device=cs.DEV)
        q = isax.znormalize(isax.znormalize(raw[pick]) + noise).contiguous()
        x = isax.znormalize(raw).contiguous()
        del raw
        tag = (f"L{Lx}_r{r}" + (f"_rk{rk}" if rk != 32 else "")
               + ("_cell" if n > 256 else ""))
        calls = [("dtw_scan", lambda: kd.dtw_scan(q, x, r=r))]
        if search:
            s, o = torch.sort(kd.lb_keogh(q, x, r=r), dim=1, stable=True)
            calls.insert(0, ("dtw_search", lambda: kd.dtw_search(
                q, x, s, o, r=r, round_k=rk)))
        for kernel, call in calls:
            before = dict(kd.by_route)
            out, t = timed(call)
            name = f"{kernel}/{tag}"
            ms[name] = t
            key = tuple(v for a in out for v in a.tolist())
            detail[name] = {"route": [k for k, v in kd.by_route.items()
                                      if v != before.get(k, 0)],
                            "hash": hex(hash(key) & (2 ** 64 - 1))}
        del x, q
        torch.cuda.empty_cache()
    return ms, detail


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("tree")
    ap.add_argument("tag")
    ap.add_argument("--groups", default=",".join(GROUPS))
    args = ap.parse_args()
    groups = args.groups.split(",")
    if not set(groups) <= set(GROUPS):
        ap.error(f"groups are {GROUPS}")
    tree = os.path.abspath(args.tree)
    sys.path[:0] = [tree, os.path.join(tree, "src")]
    import torch
    if not torch.cuda.is_available():
        print("chip_rows: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch import api
    from repro_torch.core import isax, search
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import roofline as rl
    if not cs.__file__.startswith(tree):
        print(f"chip_rows: {cs.__file__} is not in {tree}", file=sys.stderr)
        return 1
    cs.rl = rl
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kmods = dict(ops.WRAPPERS)

    def gen(seed):
        return torch.Generator(device=cs.DEV).manual_seed(seed)
    rows, extra = [], {}
    if "attention" in groups:
        rows += cs.route_flash(torch, kmods["flash_attention"], ref, gen(2))
    if "refine_search" in groups:
        rows += cs.route_refine_search(torch, api, search,
                                       kmods["refine_search"], ref, gen(2))
    if "ed_argmin" in groups:
        rows += cs.route_ed_argmin(torch, isax, kmods["ed_argmin"], ref,
                                   gen(2))
    if "dtw_long" in groups:
        rows += cs.dtw_long_queries(torch, isax, kmods, ref, gen(6))[2]
        ms, extra["dtw_long"] = long_rows(torch, cs, isax, kmods["dtw"],
                                          gen(6))
        rows += [{"name": n, "ms": t} for n, t in ms.items()]
    if "attention" in groups:
        q, k, v = cs.attention_inputs(torch, gen(2), dtype=torch.bfloat16,
                                      **cs.GRANITE)
        fk = kmods["flash_attention"]
        rows.append({"name": "flash_attention/granite", "ms": cs.device_ms(
            torch, lambda: fk.flash_attention(q, k, v))})
        del q, k, v
    if "dtw_scan" in groups:
        ms, extra["dtw_scan"] = scan_rows(torch, cs, isax, kmods["dtw"],
                                          gen(6))
        rows += [{"name": n, "ms": t} for n, t in ms.items()]
    if "dtw_band" in groups:
        ms, extra["dtw_band"] = band_rows(torch, cs, isax, kmods["dtw"],
                                          gen(6))
        rows += [{"name": n, "ms": t} for n, t in ms.items()]
    if "dtw_wide" in groups:
        ms, extra["dtw_wide"] = wide_rows(torch, cs, isax, kmods["dtw"],
                                          gen(6))
        rows += [{"name": n, "ms": t} for n, t in ms.items()]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"tag": args.tag, "device": smi,
                      "ms": {r["name"]: r["ms"] for r in rows}, **extra}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
