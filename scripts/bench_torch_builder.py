#!/usr/bin/env python3
"""Time repro_torch's IndexBuilder at 1 and 4 workers on one NVIDIA GPU.

    python3 scripts/bench_torch_builder.py [--src DIR] [--series N]
                                           [--reps R] [--seed S]

Builds N random walks of length 256 (default 2^22, the lifecycle cell of
chip_smoke.py) with `IndexConfig()` defaults, once in one pass and then
R times each (default 3) through the builder at 1 worker (one feed) and
at 4 workers (4 chunks), in turns; every build must be bit-equal to the
one-pass build.  Prints one JSON line a build (its seconds and each
phase's host seconds from `report()`) and, last, the medians.  `--src`
imports repro_torch from another tree's src/ (a `git archive` of another
commit, say), so two versions can be timed in turns in one run on one
card.  Without CUDA it exits 1 before printing a result.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--series", type=int, default=1 << 22)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("bench_torch_builder: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, args.src)
    from repro_torch import api
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    raw = torch.randn(args.series, 256, generator=gen,
                      device="cuda").cumsum_(1)
    one = api.FreshIndex.build(raw, device="cuda").index
    torch.cuda.synchronize()
    runs = {1: [], 4: []}
    for workers in (1, 4) * args.reps:
        b = api.FreshIndex.builder(workers=workers, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for c in raw.chunk(workers):
            b.feed(c)
        built = b.finalize().index
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        if not all(torch.equal(getattr(built, f), getattr(one, f))
                   for f in one._fields):
            raise AssertionError(f"the build at {workers} workers differs "
                                 f"from the one-pass build")
        phases = {p: r["wall_time"] for p, r in b.report()["phases"].items()}
        runs[workers].append((s, phases))
        print(json.dumps({"workers": workers, "s": s, "phases_s": phases}),
              flush=True)
        del built, b
    out = {"src": args.src, "series": args.series, "nvidia_smi": smi}
    for workers, rs in runs.items():
        out[f"workers_{workers}"] = {
            "median_s": statistics.median(s for s, _ in rs),
            "phases_median_s": {p: statistics.median(ph[p] for _, ph in rs)
                                for p in rs[0][1]}}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
