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

    attention      route_flash: every ATTN_ROWS row of the tree
    refine_search  route_refine_search: cta2, cta1, general
    ed_argmin      route_ed_argmin: L 100 f32 and bf16, L 235
    dtw_long       dtw_long_queries: L 16,400 at r 12, 40 and 200

Prints one JSON line: the tag, the card (`nvidia-smi`'s name and power
limit) and each row's ms.  Run parent, change, change, parent and compare
each row's medians.  Needs a CUDA card; exits 1 without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

GROUPS = ("attention", "refine_search", "ed_argmin", "dtw_long")


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
    rows = []
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
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"tag": args.tag, "device": smi,
                      "ms": {r["name"]: r["ms"] for r in rows}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
