#!/usr/bin/env python3
"""The opcode mix of each innermost loop of a kernel library's functions,
from the machine code (`cuobjdump -sass`), where a profiler's counters
are not available:

    python3 scripts/sass_loops.py [--lib dtw] [--match scan_wave_kernel]
                                  [--min-fmul 8]

Builds the port's libraries if they are missing (nvcc), then, for each
function whose mangled name contains `--match`, prints its instruction
count and, for each backward branch whose span (the branch and the code
it jumps back over) holds at least `--min-fmul` FMULs, that span's
address range, length and opcode counts.  The innermost such span of an
unrolled DP loop is its body: its cell instructions against the loads,
shuffles and selects around them.  Needs the CUDA toolkit's cuobjdump
(under $CUDA_HOME, default /usr/local/cuda); exits 1 without it.
"""

from __future__ import annotations

import argparse
import collections
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
_LINE = re.compile(r"\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?"
                   r"([A-Z][A-Z0-9_.]+)(.*)")


def loops(sass: str, match: str, min_fmul: int):
    """(function, instructions, [(start, end, length, Counter)]) for each
    function of `sass` whose name contains `match`."""
    for f in re.split(r"\n\s*Function : ", sass)[1:]:
        name = f.split("\n", 1)[0].strip()
        if match not in name:
            continue
        ins = [(int(m.group(1), 16), m.group(3).split(".")[0], m.group(4))
               for m in map(_LINE.match, f.splitlines()) if m]
        spans = []
        for at, op, rest in ins:
            t = re.search(r"0x([0-9a-f]+)", rest) if op == "BRA" else None
            if t and int(t.group(1), 16) < at:
                lo = int(t.group(1), 16)
                c = collections.Counter(o for a, o, _ in ins if lo <= a <= at)
                if c["FMUL"] >= min_fmul:
                    spans.append((lo, at, sum(c.values()), c))
        yield name, len(ins), spans


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--lib", default="dtw")
    ap.add_argument("--match", default="scan_wave_kernel")
    ap.add_argument("--min-fmul", type=int, default=8)
    args = ap.parse_args()
    tool = shutil.which("cuobjdump") or str(
        Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin"
        / "cuobjdump")
    if not Path(tool).is_file():
        print("sass_loops: no cuobjdump", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    _build.build_all()
    sass = subprocess.run([tool, "-sass", str(_build.library_path(args.lib))],
                          capture_output=True, text=True, check=True).stdout
    for name, n, spans in loops(sass, args.match, args.min_fmul):
        print(name, n)
        for lo, hi, length, c in spans:
            print(f"  loop {lo:#x}-{hi:#x} {length}",
                  dict(c.most_common(12)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
