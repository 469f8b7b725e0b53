#!/usr/bin/env python3
"""The sharded search on one card and on several: same bits, and times.

    python3 scripts/bench_sharded_cards.py [--series N] [--slots D]
                                           [--seed S] [--cpu]

Builds an index of N random walks of length 256 (default 2^24) on
cuda:0 and searches 256 noisy collection queries at k 10 locally, then
through `FreshIndex.shard` on two meshes of D slots (default 4): every
slot on cuda:0, and one slot a card, cuda:0 .. cuda:D-1, where the
machine has D cards (the blocks of cards 1 .. D-1 are copies there).
Each sharded search runs at sync_every 1 and 4, twice, with its ms (host
clock, ending in a synchronize), rounds, rounds run and host reads, and
its (dist, ids) must be byte-equal across the two meshes and equal to
the local search's ids but at ties.  One JSON line a part, then each
card's name and power limit.  Exits 1 without CUDA, unless `--cpu`
runs it on CPU slots (a dry run at a small N).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

L, Q, K = 256, 256, 10


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--series", type=int, default=1 << 24)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    import torch
    if not args.cpu and not torch.cuda.is_available():
        print("bench_sharded_cards: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    from repro_torch import api
    from repro_torch.runtime import make_mesh
    dev = "cpu" if args.cpu else "cuda:0"
    sync = (lambda: None) if args.cpu else torch.cuda.synchronize
    if not args.cpu:
        from repro_torch.kernels import _build
        torch.backends.cuda.matmul.allow_tf32 = False
        _build.build_all()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    n, D = args.series, args.slots
    raw = torch.randn(n, L, generator=gen, device=dev).cumsum_(1)
    pick = torch.randint(0, n, (Q,), generator=gen, device=dev)
    queries = raw[pick] + 0.1 * torch.randn(Q, L, generator=gen, device=dev)
    index = api.FreshIndex.build(raw, device=dev)
    del raw
    d0, i0 = index.search(queries, k=K)
    sync()
    t0 = time.perf_counter()
    index.search(queries, k=K)
    sync()
    print(json.dumps({"part": "local", "series": n, "queries": Q, "k": K,
                      "ms": (time.perf_counter() - t0) * 1e3}), flush=True)

    cards = 0 if args.cpu else torch.cuda.device_count()
    meshes = {"one_card": [dev] * D}
    if args.cpu:
        meshes["cpu_again"] = [dev] * D
    elif cards >= D:
        meshes["one_slot_a_card"] = [f"cuda:{i}" for i in range(D)]
    answers = {}
    for name, slots in meshes.items():
        six = api.FreshIndex(index.index, index.config)
        t0 = time.perf_counter()
        six.shard(make_mesh((D,), ("data",), slots))
        sync()
        rep = {"part": name, "slots": slots,
               "shard_s": time.perf_counter() - t0, "searches": {}}
        kn = six.search_knobs()
        for s in (1, 4):
            plan = six.sharded_plan(K, round_leaves=kn.round_leaves,
                                    sync_every=s, max_rounds=None,
                                    pq_budget=kn.pq_budget, stop_eps=0.0,
                                    stop_leaves=None)
            runs = []
            for _ in range(2):
                c0 = (plan.rounds, plan.rounds_launched, plan.host_reads)
                t0 = time.perf_counter()
                d, i = six.search(queries, k=K, sync_every=s)
                sync()
                ms = (time.perf_counter() - t0) * 1e3
                got = [b - a for a, b in zip(c0, (
                    plan.rounds, plan.rounds_launched, plan.host_reads))]
                runs.append({"ms": ms, "rounds": got[0],
                             "rounds_run": got[1], "host_reads": got[2]})
            ties = int((i != i0).sum())
            if not torch.allclose(d, d0, rtol=1e-5, atol=1e-5):
                raise AssertionError(f"{name} sync {s}: distances differ "
                                     f"from the local search")
            key = f"sync{s}"
            if key in answers and not (torch.equal(answers[key][0], d)
                                       and torch.equal(answers[key][1], i)):
                raise AssertionError(f"{name} sync {s}: bytes differ from "
                                     f"the first mesh's")
            answers.setdefault(key, (d, i))
            rep["searches"][key] = {"runs": runs, "ties_vs_local": ties,
                                    "equal_to_first_mesh": True}
        print(json.dumps(rep), flush=True)
        del six
    if not args.cpu:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip()
        print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
