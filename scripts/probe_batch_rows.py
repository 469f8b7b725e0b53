#!/usr/bin/env python3
"""Does a query's answer depend on the batch it lies in, and does a
captured CUDA graph of the search replay the eager search's bytes?

    python3 scripts/probe_batch_rows.py [--series N] [--seed S]

On one CUDA card: builds an index of N random walks of length 256
(default 2^24), searches 256 noisy collection queries at k 10 and k 1,
and searches them again in batches of 1, 2, 4, ..., 64 rows; it counts
the rows of the first 64 queries whose bytes differ from the same rows
of the batch of 256, for two arithmetics:

  torch_sums  the query z-norm, the query norms and the direct-form
              re-rank as torch reductions (the search before the serving
              slice; on the card their order follows the shape);
  fixed_sums  `core.search.view_search_device` as it is: those sums in
              the summarize kernel's fixed order a row.

Then it captures `view_search_device` as a CUDA graph at (bucket, k) in
(1, 10), (8, 10), (64, 10), (64, 1), (4, 1), replays it on three batches
of queries, each held byte for byte to the eager call, and times both
(host clock, ending in a copy to the host); and the same with a pending
delta of 65,536 rows and 1,024 deletes, held to FreshIndex.search.  One
JSON line a part, then the card's name and power limit.  Exits 1
without CUDA.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

L, Q = 256, 256


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--series", type=int, default=1 << 24)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("probe_batch_rows: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    from repro_torch import api
    from repro_torch.core import isax, search
    from repro_torch.kernels import _build
    from repro_torch.kernels.lb_distance import lb_distance
    from repro_torch.kernels.ref import BIG
    from repro_torch.kernels.refine_search import refine_search
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    n = args.series
    raw = torch.randn(n, L, generator=gen, device=dev).cumsum_(1)
    pick = torch.randint(0, n, (Q,), generator=gen, device=dev)
    queries = raw[pick] + 0.1 * torch.randn(Q, L, generator=gen, device=dev)
    index = api.FreshIndex.build(raw, device=dev)
    del raw
    idx = index.index

    def torch_sums(q, k):
        qq = isax.znormalize(q).float()
        q_sq = (qq * qq).sum(-1)
        lb = lb_distance(isax.paa(qq, idx.paa.shape[1]).contiguous(),
                         idx.leaf_lo, idx.leaf_hi, series_len=L)
        order, slb = search._pq_order(lb, 8, search._rounds_cap(
            idx.n_leaves, 8))
        bd, be, r = refine_search(qq, q_sq, idx.series, idx.sq_norms, order,
                                  slb, leaf_capacity=idx.leaf_capacity,
                                  k=k, round_leaves=8)
        found, e = bd < BIG, be.long()
        ids = torch.where(found, idx.perm[e], torch.full_like(be, -1))
        d = torch.where(found, (qq[:, None, :] - idx.series[e].float())
                        .square().sum(-1), bd)
        rs = torch.argsort(d, dim=1, stable=True)
        return torch.gather(d, 1, rs).sqrt(), torch.gather(ids, 1, rs), r

    def fixed_sums(q, k, view=None):
        core, delta, alive, id0 = view or index.search_view()
        return search.view_search_device(
            core, None if delta is None else index.delta_rows, alive, id0,
            q, k=k, znorm=True, round_leaves=8)

    def differ(a, b):
        return int(((a[0] != b[0]).any(1) | (a[1] != b[1]).any(1)).sum())

    for k in (10, 1):
        rep = {"part": "rows", "k": k}
        for name, fn in (("torch_sums", torch_sums),
                         ("fixed_sums", fixed_sums)):
            full = fn(queries, k)
            rep[name] = {b: sum(differ(fn(queries[s:s + b], k),
                                       (full[0][s:s + b], full[1][s:s + b]))
                                for s in range(0, 64, b))
                         for b in (1, 2, 4, 8, 16, 32, 64)}
        print(json.dumps(rep), flush=True)

    def capture(fn, qbuf):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn(qbuf)
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, capture_error_mode="thread_local"):
            out = fn(qbuf)
        return g, out

    def wall_ms(fn, reps=3):
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    for b, k in ((1, 10), (8, 10), (64, 10), (64, 1), (4, 1)):
        qbuf = queries[:b].clone()
        t0 = time.perf_counter()
        g, out = capture(lambda x: fixed_sums(x, k), qbuf)
        rep = {"part": "graph", "bucket": b, "k": k,
               "capture_s": time.perf_counter() - t0, "replay_equal": []}
        for s in (0, b, 2 * b):
            qbuf.copy_(queries[s:s + b])
            g.replay()
            eager = fixed_sums(queries[s:s + b], k)
            rep["replay_equal"].append(all(torch.equal(x, y)
                                           for x, y in zip(out, eager)))

        def replay():
            qbuf.copy_(queries[:b])
            g.replay()
            [t.cpu() for t in out]
        rep["eager_ms"] = wall_ms(lambda: [t.cpu() for t in fixed_sums(
            queries[:b], k)])
        rep["replay_ms"] = wall_ms(replay)
        print(json.dumps(rep), flush=True)

    extra = torch.randn(1 << 16, L, generator=gen, device=dev).cumsum_(1)
    index.add(extra)
    index.delete(list(range(512)) + list(range(n, n + 512)))
    view = index.search_view()
    fac = index.search(queries, k=10)
    rep = {"part": "graph_with_delta", "replay_equal_facade": []}
    for b in (8, 64):
        qbuf = queries[b:2 * b].clone()
        g, out = capture(lambda x: fixed_sums(x, 10, view), qbuf)
        g.replay()
        rep["replay_equal_facade"].append(
            torch.equal(out[0], fac[0][b:2 * b])
            and torch.equal(out[1], fac[1][b:2 * b]))
    print(json.dumps(rep), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
