#!/usr/bin/env python3
"""refine_search's buffer layouts side by side on one NVIDIA GPU.

    python3 scripts/refine_fold_routes.py [--ks 10,512,1024,2000,5000,20000]
        [--queries 16] [--series 262144] [--leaves 64] [--round-leaves 8]

On chip_smoke.py's route-phase collection (random walks of length 256,
f32, leaves of 64 rows, K 8 a round, or as given; the queries collection
series plus N(0, 0.1) noise), each k is run on every search_kernel route
whose layout takes it (`cta<b>`: the buffer whole in each CTA;
`spread<b>`: in slices over the cluster; b CTAs an SM) and on `general`,
forced by `refine_search.launch`.  The search_kernel routes' buffers,
rounds and alive counts must be bit-equal to each other's, and at k <=
5000 to the global loop of `refine_topk` launches (chip_smoke.topk_loop);
the first of them and `general` (whose sums run in another order) are
held to `refine_search_ref` by chip_smoke.hold_search.  Each route's ms
is the mean of 3 launches after one (CUDA events).  This is where
refine_search.SPREAD_K, the k from which the buffer is spread first, and
MIN_STAGE_ROWS come from.

Prints a JSON line for each k as it is done, then one with them all,
the card (`nvidia-smi`'s name and power limit) and the registers ptxas
reports for every search_kernel and search_general instance
(chip_smoke.refine_ptxas: each must spill nothing; "built before" where
an earlier process built the library).  Needs a CUDA card; exits 1
without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ks", default="10,512,1024,2000,5000,20000")
    ap.add_argument("--queries", type=int, default=16)
    ap.add_argument("--series", type=int, default=1 << 18)
    ap.add_argument("--leaves", type=int, default=64)
    ap.add_argument("--round-leaves", type=int, default=8)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    if not torch.cuda.is_available():
        print("refine_fold_routes: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch import api
    from repro_torch.core import search
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import refine as topk
    from repro_torch.kernels import refine_search as rk
    from repro_torch.launch import roofline as rl
    cs.rl = rl
    torch.backends.cuda.matmul.allow_tf32 = False
    rep = _build.build_all()
    ptxas = (cs.refine_ptxas(rep["refine"]["ptxas"])
             if rep["refine"]["ptxas"] else "built before")
    gen = torch.Generator(device=cs.DEV).manual_seed(2)
    raw = cs.walks(torch, gen, args.series, cs.L)
    pick = torch.randint(0, args.series, (args.queries,), generator=gen,
                         device=cs.DEV)
    queries = raw[pick] + 0.1 * torch.randn(args.queries, cs.L,
                                            generator=gen, device=cs.DEV)
    idx = api.FreshIndex.build(raw, api.IndexConfig(
        leaf_capacity=args.leaves), device=cs.DEV).index
    del raw
    M, K = args.leaves, args.round_leaves
    q, q_sq, order, sorted_lb = cs.refine_inputs(search, idx, queries, K)
    inputs = (q, q_sq, idx.series, idx.sq_norms, order, sorted_lb)
    elem = idx.series.element_size()
    out = {}
    for k in (int(x) for x in args.ks.split(",")):
        kw = dict(leaf_capacity=M, k=k, round_leaves=K)
        routes = [f"{kind}{b}" for kind in ("cta", "spread")
                  for b in (3, 2, 1)
                  if rk._fits(cs.L, K, M, k, elem, b, kind == "spread")]
        routes.append("general")
        row, first = {"default": rk.route(cs.L, K, M, k, torch.float32)
                      }, None
        want = cs.run_loop_ref(torch, ref, inputs, K, M, k)
        tol, true_d = cs.search_tol(torch, idx, q, q_sq)
        for how in routes:
            alive = torch.zeros(q.shape[0], dtype=torch.int32, device=cs.DEV)
            got = rk.launch(*inputs, how, **kw, alive_out=alive) + (alive,)
            if first is None or how == "general":
                held = cs.hold_search(torch, got, want, sorted_lb, true_d,
                                      tol, f"k {k} {how}", K)
                row[f"{how}_held"] = {
                    "max_abs_err": held["max_abs_err"],
                    "near_tie_swaps": held["near_tie_swaps"]}
            if first is None:
                first = got
                if k <= 5000:
                    loop = cs.topk_loop(torch, topk, inputs, K, M, k)
                    cs.require(all(torch.equal(a, b)
                                   for a, b in zip(got, loop)),
                               f"k {k} {how}: not the refine_topk loop's")
                    row["topk_loop"] = "bit-equal"
            elif how != "general":
                cs.require(all(torch.equal(a, b) for a, b in zip(got, first)),
                           f"k {k}: {how} differs from {routes[0]}")
            ms = cs.time_ms(torch, lambda: rk.launch(*inputs, how, **kw), 3,
                            warm=1)
            row[how] = ms
        row["rounds_max"] = int(first[2].max())
        out[str(k)] = row
        print(json.dumps({"k": k, **row}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"device": smi, "ptxas": ptxas, "ks": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
