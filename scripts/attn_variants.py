#!/usr/bin/env python3
"""Time patched variants of the bf16 attention kernel's dh-96 instance
(`tc96`) at Phi-3-mini's shape, to see what holds it back where `ncu`
does not run:

    python3 scripts/attn_variants.py [--reps R] [--turns N]

Each variant is this tree's `csrc/flash_attention.cu` with one text patch
(VARIANTS below; all but `round` touch the DK 96 instance only), built
by nvcc
with the port's flags into `kernels/build/variants/` (all at once), loaded
in place of the library, and timed by device time (torch.profiler, the
mean of R launches) at B 1, Hq = Hkv 32, T = S = 4096, dh 96, bf16,
causal, in N turns (the order reversed every other turn; the median is
printed).  The variants meant to stay right are held to the float32 plain
version under chip_smoke.py's attention limit; the others leave out work
and their outputs are wrong.  Each also prints the order, in its main
loop's machine code (cuobjdump), of the wgmma issues (H), the waits for
them (W1: the round's S, W0: its P.V) and the exponentials (M).

  source      the tree as it is
  round       P_hi rounded too (two conversions a pair, as split2 did
              before it took P's upper half; every instance)
  no_softmax  the products and loads alone: no softmax, no split of P
  no_exp      no max, exponentials or sums (the split runs on S)
  no_split    no split of P (the softmax runs)
  no_mufu     the exponentials' MUFU left out (p = its argument)
  gate        the wait for the round's P.V predicated on a warp vote over
              l, so that ptxas keeps it after the exponentials: the
              softmax then overlaps the warpgroup's own P.V

Prints one JSON line: the card's name and power limit, each variant's
ms, its error and excess where it is meant to be right, and its loop
order.  Needs a CUDA card; exits 1 without one.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPE = dict(B=1, Hq=32, Hkv=32, T=4096, dh=96)
RIGHT = ("source", "round", "gate")
_GATE = '''// wgmma_wait<0>, predicated on a warp vote that x is not below -1
// (true for a sum of exponentials, and for NaN), which ptxas cannot know
__device__ __forceinline__ void wgmma_wait0_after(float x) {
  asm volatile(
      "{\\n\\t.reg .pred q, p;\\n\\t"
      "setp.lt.f32 q, %0, 0fBF800000;\\n\\t"
      "vote.sync.all.pred p, !q, 0xffffffff;\\n\\t"
      "@p wgmma.wait_group.sync.aligned 0;\\n\\t}"
      :: "f"(x) : "memory");
}

'''
_SPLIT2 = """  hi = __byte_perm(ua, ub, 0x7632);
  const __nv_bfloat162 l = __floats2bfloat162_rn(
      a - __uint_as_float(ua & 0xffff0000u),
      b - __uint_as_float(ub & 0xffff0000u));
"""
_ROUND2 = """  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
"""
_EXP = "    auto exponentiate = [&](int tile) {\n"
_NO_EXP = _EXP + "      if (DK == 96) { moved = false; return; }\n"
_SPLIT = "      if (moved || !C::kLazy) rows.rescale(acc);\n"
_P = "    uint32_t p_hi[kBN / 16][4], p_lo[kBN / 16][4];\n"
_MUFU = ("        const float p = exp2_ftz(fmaf(s[4 * j + e], c, e < 2 ? "
         "-mn0 : -mn1));\n")
_WAIT = ("      exponentiate(tile);\n      wgmma_wait<0>();\n")
VARIANTS = {
    "source": [],
    "round": [(_SPLIT2, _ROUND2)],
    "no_softmax": [
        (_EXP, _NO_EXP),
        (_SPLIT, _SPLIT + "      if (DK == 96) return;\n"),
        (_P, _P.replace("[4], p_lo", "[4] = {}, p_lo").replace(
            "[4];", "[4] = {};"))],
    "no_exp": [(_EXP, _NO_EXP)],
    "no_split": [(_SPLIT, _SPLIT + "      if (DK == 96) return;\n"),
                 (_P, _P.replace("[4], p_lo", "[4] = {}, p_lo").replace(
                     "[4];", "[4] = {};"))],
    "no_mufu": [(_MUFU, _MUFU.replace(
        "exp2_ftz(fmaf(s[4 * j + e], c, e < 2 ? -mn0 : -mn1))",
        "fmaf(s[4 * j + e], c, e < 2 ? -mn0 : -mn1)"))],
    "gate": [("namespace tc {\n", _GATE + "namespace tc {\n"),
             (_WAIT, "      exponentiate(tile);\n      if constexpr (DK == "
                     "96) wgmma_wait0_after(rows.l0 + rows.l1);\n      "
                     "else wgmma_wait<0>();\n")],
}


def patched(src: str, patches) -> str:
    for old, new in patches:
        if src.count(old) != 1:
            raise SystemExit(f"attn_variants: patch anchor not found once: "
                             f"{old[:60]!r}")
        src = src.replace(old, new)
    return src


def loop_order(sass: str) -> str:
    """H / W1 / W0 / M runs of the tc96 instance's machine code."""
    for f in sass.split("Function : "):
        if "flash_tc_kernelILi96ELi96E" not in f.split("\n", 1)[0]:
            continue
        ev = []
        for ln in f.splitlines():
            if "HGMMA" in ln:
                ev.append("H")
            elif "WARPGROUP.DEPBAR" in ln:
                ev.append("W" + ln.split("gsb0,")[1].strip()[2])
            elif "MUFU.EX2" in ln:
                ev.append("M")
        out, i = [], 0
        while i < len(ev):
            j = i
            while j < len(ev) and ev[j] == ev[i]:
                j += 1
            out.append(ev[i] + (str(j - i) if ev[i] in "HM" else ""))
            i = j
        return " ".join(out)
    return ""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--turns", type=int, default=3)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    if not torch.cuda.is_available():
        print("attn_variants: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import _build, flash_attention as fk, ref
    torch.backends.cuda.matmul.allow_tf32 = False
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    csrc = _build.CSRC / "flash_attention.cu"
    src = csrc.read_text()
    procs, t0 = {}, time.perf_counter()
    for name, patches in VARIANTS.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(patched(src, patches))
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", str(out_dir / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    order, build_s = {}, {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(log[-3000:], file=sys.stderr)
            return 1
        build_s[name] = time.perf_counter() - t0
        tool = Path(_build.nvcc_path()).parent / "cuobjdump"
        order[name] = loop_order(subprocess.run(
            [str(tool), "-sass", str(out_dir / f"{name}.so")],
            capture_output=True, text=True).stdout)
    gen = torch.Generator(device=cs.DEV).manual_seed(2)
    q, k, v = cs.attention_inputs(torch, gen, dtype=torch.bfloat16, **SHAPE)
    plain = ref.flash_attention_ref(q.float(), k.float(), v.float())

    def use(name):
        _build._LOADED["flash_attention"] = ctypes.PyDLL(
            str(out_dir / f"{name}.so"))
        _build._ENTRIES.pop(("flash_attention", "flash_attention"), None)
    rows = {}
    for name in VARIANTS:
        use(name)
        o = fk.flash_attention(q, k, v)
        err, excess, _ = cs.attention_excess(torch, o, plain)
        rows[name] = {"ms": [], "loop": order[name]}
        if name in RIGHT:
            rows[name] |= {"max_abs_err": err, "excess": excess}
    names = list(VARIANTS)
    for turn in range(args.turns):
        for name in (names if turn % 2 == 0 else names[::-1]):
            use(name)
            rows[name]["ms"].append(cs.device_ms(
                torch, lambda: fk.flash_attention(q, k, v), args.reps))
    for r in rows.values():
        r["ms_turns"] = r["ms"]
        r["ms"] = statistics.median(r["ms"])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"device": smi, "shape": SHAPE, "build_s": build_s,
                      "variants": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
