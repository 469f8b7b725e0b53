#!/usr/bin/env python3
"""Drive repro_torch's build-and-search path on one NVIDIA GPU.

    python3 chip_smoke.py [--series N] [--seed S]

Phases, each printing one JSON line:
  device   nvidia-smi's name and power limit, torch's device name;
  build    nvcc builds of every kernel under src/repro_torch/kernels/csrc;
  kernel   each CUDA kernel against its plain PyTorch version on the card,
           at the path's shapes, with its time, the plain version's time
           and the least time the card could take (the bound);
  main     FreshIndex.build over N random walks of length 256 made on the
           card (default 2^24, 16 GiB of float32), then exact 10-NN of 256
           noisy collection series (sigma 0.1, the paper's hardest Fig. 6a
           workload), held against a chunked brute-force scan; every
           kernel's launch count over this phase must be > 0.
Then the kernel table, the nvidia-smi line and, last, the device line.
Any failure raises and exits non-zero; without CUDA, or without the
repository's src/ beside this file, it exits 1 before printing a result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

DEV = "cuda"
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (NVIDIA data sheet)
F32_FLOPS = 67e12              # H100 SXM float32 outside the tensor cores
Q, K, M, L, TOPK = 256, 8, 64, 256, 10


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound_ms(nbytes: float, flops: float):
    b, f = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return max(b, f), ("bytes" if b >= f else "operations")


def time_ms(torch, fn, reps: int = 20) -> float:
    """Mean device time of fn() over `reps` launches, after a warm-up."""
    for _ in range(3):
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


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


# ----------------------------------------------------------------- kernels
def check_summarize(torch, isax, ks, ref, gen, n=1 << 20):
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
    # the in-kernel z-norm, in the TPU kernel's one-pass E[x^2] - mu^2
    # form: its cancellation costs digits, hence 1e-4
    raw = torch.randn(n // 16, L, generator=gen, device=DEV).cumsum_(1)
    pk, wk = ks.summarize(raw, znorm=True)
    pr, wr = ref.summarize_ref(raw, znorm=True)
    err = (pk - pr).abs().max().item()
    require(err <= 1e-4 and int((wk - wr).abs().max()) <= 1,
            f"summarize znorm: PAA off by {err}")
    out["znorm_max_abs_err"] = err
    ms = time_ms(torch, lambda: ks.summarize(x, znorm=False))
    plain = time_ms(torch, lambda: ref.summarize_ref(x, znorm=False), 5)
    bms, by = bound_ms(n * L * 4 + n * 16 * 8, n * L)
    return {"name": "summarize", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/isax_summarize.cu",
            "replaces": "src/repro/kernels/isax_summarize.py:33",
            "shape": f"x ({n}, {L}) f32, w=16, bits=8, znorm=False",
            "max_abs_err": out["f32"]["max_abs_err"], "ms": ms,
            "plain_ms": plain, "bound_ms": bms, "bound_by": by,
            "library_ms": None, "checks": out}


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
    ms = time_ms(torch, lambda: lbk.lb_distance(q, lo, hi))
    plain = time_ms(torch, lambda: ref.lb_distance_ref(q, lo, hi), 3)
    bms, by = bound_ms(Q * NL * 4 + (Q + 2 * NL) * 16 * 4, Q * NL * 16 * 5)
    return {"name": "lb_distance", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/lb_distance.cu",
            "replaces": "src/repro/kernels/lb_distance.py:28",
            "shape": f"q ({Q}, 16), leaves ({NL}, 16)",
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bms, "bound_by": by, "library_ms": None,
            "checks": {"inf_leaves": int(inf[0].sum())}}


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


def check_refine(torch, isax, rk, ref, gen, NL=4096):
    x = isax.znormalize(torch.randn(NL * M, L, generator=gen, device=DEV)
                        .cumsum_(1))
    qv = isax.znormalize(torch.randn(Q, L, generator=gen, device=DEV)
                         .cumsum_(1))
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
            ids = torch.rand(Q, NL, generator=gen, device=DEV).argsort(
                1)[:, :K].to(torch.int32).contiguous()
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
        ms = time_ms(torch, lambda: rk.refine_topk(*args, leaf_capacity=M,
                                                   k=TOPK))
        plain = time_ms(torch, lambda: ref.refine_topk_ref(
            *args, leaf_capacity=M, k=TOPK), 5)
        nbytes = (n_alive * M * (L * series.element_size() + 4)
                  + Q * (L * 4 + 4 + K * 5 + TOPK * 16))
        bms, by = bound_ms(nbytes, n_alive * M * L * 2)
        rows[name] = {"ms": ms, "plain_ms": plain, "bound_ms": bms,
                      "bound_by": by, "max_abs_err": max(errs),
                      "near_tie_swaps": swaps, "tol": tol,
                      "alive_slots": n_alive}
    f = rows["f32"]
    return {"name": "refine_topk", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/refine.cu",
            "replaces": "src/repro/kernels/refine.py:139",
            "shape": f"Q={Q} K={K} M={M} L={L} k={TOPK}, ~half alive, f32",
            "max_abs_err": f["max_abs_err"], "ms": f["ms"],
            "plain_ms": f["plain_ms"], "bound_ms": f["bound_ms"],
            "bound_by": f["bound_by"], "library_ms": None,
            "checks": rows}


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


def profile_search(torch, index, queries, wall_ms):
    """Device time of one search by kernel (torch.profiler over CUPTI) and
    the device's idle share against an unprofiled search's wall time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        index.search(queries, k=TOPK)
        torch.cuda.synchronize()
    kern = {e.key: (e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.self_device_time_total > 0}
    busy = sum(ms for ms, _ in kern.values())
    top = sorted(kern.items(), key=lambda kv: -kv[1][0])[:8]
    return {"busy_ms": busy, "wall_ms": wall_ms,
            "idle_share": 1 - busy / wall_ms if busy else None,
            "top": [{"kernel": name[:90], "ms": ms, "count": c}
                    for name, (ms, c) in top]}


def main_path(torch, api, isax, search, kmods, n, gen):
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
    launches = {name: mod.launches for name, mod in kmods.items()}
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

    reps = []
    for _ in range(3):
        t0 = time.perf_counter()
        index.search(queries, k=TOPK)
        torch.cuda.synchronize()
        reps.append((time.perf_counter() - t0) * 1e3)
    _, _, rounds = search.search_plan_impl(idx, queries, k=TOPK)
    require(rounds == launches["refine_topk"],
            f"rounds {rounds} != refine launches {launches}")
    device = profile_search(torch, index, queries, min(reps))

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
            "pq_sort_ms": sort_ms, "device_time": device}, launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--series", type=int, default=1 << 24)
    ap.add_argument("--seed", type=int, default=0)
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
    from repro_torch import api
    from repro_torch.core import isax, search
    from repro_torch.kernels import (_build, isax_summarize, lb_distance,
                                     ref, refine)
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
                        if "Used" in ln] for k, v in rep.items()}})

    gen = torch.Generator(device=DEV).manual_seed(args.seed)
    kmods = {"summarize": isax_summarize, "lb_distance": lb_distance,
             "refine_topk": refine}
    rows = []
    for name, check, mods in (
            ("summarize", check_summarize, (isax, isax_summarize)),
            ("lb_distance", check_lb_distance, (lb_distance,)),
            ("refine_topk", check_refine, (isax, refine))):
        kmods[name].launches = 0
        r = check(torch, *mods, ref, gen)
        rows.append(r)
        emit({"phase": "kernel", **r, "launches": kmods[name].launches,
              "result": "PASS"})
    torch.cuda.empty_cache()

    report, launches = main_path(torch, api, isax, search, kmods,
                                 args.series, gen)
    emit(report)
    emit({"kernels": [{k: r[k] for k in (
        "name", "route", "source", "replaces")} | {
        "launches": launches[r["name"]]} | {k: r[k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")} for r in rows]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
