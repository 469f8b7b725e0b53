"""The port's roofline (repro_torch.launch.roofline) against repro's
analytic model, and each kernel's work count against the bounds the
H100 runs of chip_smoke.py printed.

repro's part: refine_analytic, roofline_fraction, device_peaks at the
default type and model_flops_for are equal on the same inputs; where
repro falls back to TPU constants for an unknown kind, the port raises.
The work counts: each `*_work` at its kernel-table row's shape gives the
bound_ms chip_smoke.py printed on an NVIDIA H100 80GB HBM3 (700 W)
before the counts moved here, to the last digit; data-dependent counts
(alive slots, leaves) are those of that run.
"""

import os
import re
import types

import pytest
import torch

from repro.launch import roofline as jrl
from repro_torch.launch import roofline as rl

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H100 = "NVIDIA H100 80GB HBM3"


@pytest.mark.parametrize("dtype_bytes", [2, 4])
@pytest.mark.parametrize("Q,K,M,L,k", [(256, 8, 64, 256, 10),
                                       (1, 1, 1, 1, 1),
                                       (16, 264, 16, 100, 5000),
                                       (64, 64, 256, 96, 10)])
def test_refine_analytic_matches_repro(Q, K, M, L, k, dtype_bytes):
    assert rl.refine_analytic(Q, K, M, L, k, dtype_bytes) == \
        jrl.refine_analytic(Q, K, M, L, k, dtype_bytes)


@pytest.mark.parametrize("kind", [H100, "cpu", "NVIDIA A100-SXM4-80GB",
                                  "Tesla V100-SXM2-16GB"])
@pytest.mark.parametrize("dtype_bytes", [2, 4])
def test_roofline_fraction_matches_repro(kind, dtype_bytes):
    shape = dict(Q=256, K=8, M=64, L=256, k=10, dtype_bytes=dtype_bytes)
    for seconds in (4.5e-5, 1e-3, 2.0):
        assert rl.roofline_fraction(seconds, kind=kind, **shape) == \
            pytest.approx(jrl.roofline_fraction(seconds, kind=kind, **shape),
                          rel=1e-12)
    with pytest.raises(ValueError, match="seconds"):
        rl.roofline_fraction(0.0, kind=kind, **shape)


@pytest.mark.parametrize("kind", [H100, "cpu", "NVIDIA A100-SXM4-80GB",
                                  "Tesla V100-SXM2-16GB"])
def test_device_peaks_match_repro_at_the_default_type(kind):
    assert rl.device_peaks(kind) == jrl.device_peaks(kind)


def test_device_peaks_by_type_and_unknown_kinds():
    assert rl.device_peaks(H100, "f32") == (67e12, 3.35e12)
    assert rl.device_peaks(H100, "tf32") == (495e12, 3.35e12)
    assert rl.device_peaks(H100, "f32_issue") == (132 * 128 * 1.98e9,
                                                  3.35e12)
    # repro falls back to its TPU constants; the port names the kind
    assert jrl.device_peaks("TPU v5e") == (jrl.PEAK_FLOPS_BF16, jrl.HBM_BW)
    with pytest.raises(ValueError, match="TPU v5e"):
        rl.device_peaks("TPU v5e")
    with pytest.raises(ValueError, match="f32_issue"):
        rl.device_peaks("NVIDIA A100-SXM4-80GB", "f32_issue")
    assert not any("tpu" in kind for kind in rl.DEVICE_PEAKS)


def test_device_peaks_of_the_live_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        rl.device_peaks()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: H100)
    assert rl.device_peaks(None, "bf16") == (989e12, 3.35e12)


class _Cfg:
    def param_counts(self):
        return {"active": 8_030_261_248, "total": 8_030_261_248}


@pytest.mark.parametrize("kind,batch,seq", [("train", 256, 4096),
                                            ("prefill", 8, 2048),
                                            ("decode", 64, 4096)])
def test_model_flops_for_matches_repro(kind, batch, seq):
    shape = types.SimpleNamespace(kind=kind, global_batch=batch,
                                  seq_len=seq)
    assert rl.model_flops_for(_Cfg(), shape) == \
        jrl.model_flops_for(_Cfg(), shape)


def test_roofline_record_matches_repro():
    kw = dict(flops=1e12, bytes_hbm=2e9, bytes_coll=0.0, t_compute=0.1,
              t_memory=0.2, t_collective=0.0, dominant="memory")
    assert rl.Roofline(**kw).as_dict() == jrl.Roofline(**kw).as_dict()


# (name, work, bound_ms and bound_by as chip_smoke.py printed them on the
# H100 before the counts moved here).  A regression check of that move,
# not ground truth: a deliberate change to a count updates this table and
# PERF.md section 6's bound together.
TABLE = [
    ("summarize", rl.summarize_rows_work(1 << 20, 256, 16),
     0.6823569194029852, "bytes"),
    ("summarize/strided", rl.summarize_rows_work(1 << 20, 96, 16),
     0.2817069850746268, "bytes"),
    ("lb_distance", rl.lb_distance_work(256, 1 << 18, 16),
     0.16047995102540558, "operations"),
    ("lb_distance/looped", rl.lb_distance_work(256, 1 << 16, 32),
     0.08023997551270279, "operations"),
    ("refine_topk", rl.refine_topk_work(256, 8, 64, 256, 10, 1033),
     0.02038134447761194, "bytes"),
    ("refine_topk bf16", rl.refine_topk_work(256, 8, 64, 256, 10, 1054, 2),
     0.010484078805970149, "bytes"),
    ("refine_topk/general", rl.refine_topk_work(256, 8, 64, 100, 10, 1149,
                                                2),
     0.004524169552238806, "bytes"),
    ("ed_argmin", rl.ed_argmin_work(256, 1 << 24, 256),
     13.327413670012122, "operations"),
    ("ed_argmin/tensor_L100", rl.ed_argmin_work(256, (1 << 20) + 5, 100),
     0.32537786181818185, "operations"),
    ("ed_argmin/staged_L100_bf16", rl.ed_argmin_work(256, (1 << 20) + 5,
                                                     100, 2),
     0.21691857454545455, "operations"),
    ("ed_argmin/staged_L235", rl.ed_argmin_work(256, (1 << 20) + 5, 235),
     0.7646379752727273, "operations"),
    ("flash_attention", rl.flash_attention_work(1, 32, 8, 4096, 4096, 128),
     0.13900152467542973, "operations"),
    ("flash_attention/tf256", rl.flash_attention_work(1, 8, 2, 1024, 1024,
                                                      256, elem_bytes=4),
     0.02605552484848485, "operations"),
    ("leaf_stats", rl.leaf_stats_work(1 << 24, 16, 64),
     0.4508094280597015, "bytes"),
    ("leaf_gather", rl.leaf_gather_work(1 << 22, 256, 16),
     2.789525167761194, "bytes"),
    ("leaf_gather part", rl.leaf_gather_work(2048, 256, 16),
     0.0013620728358208955, "bytes"),
    ("lb_keogh", rl.lb_keogh_work(32, 1 << 22, 256),
     4.108286746250383, "operations"),
    ("lb_keogh/L1024", rl.lb_keogh_work(24, 1 << 20, 1024),
     3.081215059687787, "operations"),
    ("lb_keogh/L100", rl.lb_keogh_work(32, 1 << 22, 100),
     1.6047995102540558, "operations"),
    ("dtw_scan", rl.dtw_scan_work(32, 1 << 22, 256, 12),
     125.25460177532905, "operations"),
    ("dtw_scan/wave16_r25", rl.dtw_scan_work(32, 1 << 22, 256, 25),
     248.8642840526477, "operations"),
    ("dtw_scan/wave16_r51", rl.dtw_scan_work(32, 1 << 22, 256, 51),
     475.74281481481484, "operations"),
    ("dtw_scan/wave16_r102", rl.dtw_scan_work(32, 1 << 22, 256, 102),
     841.9981830425467, "operations"),
]


@pytest.mark.parametrize("name,work,bms,by", TABLE,
                         ids=[t[0] for t in TABLE])
def test_work_counts_give_the_chip_runs_bounds(name, work, bms, by):
    assert work.bound() == (bms, by)


@pytest.mark.parametrize("work,digits,want", [
    (rl.summarize_rows_work(1 << 20, 256, 16), 3, 0.682),
    (rl.summarize_work(1 << 20, 256, 16), 3, 0.361),
    (rl.lb_distance_work(256, 1 << 18, 16), 3, 0.160),
    (rl.ed_argmin_work(256, 1 << 24, 256), 2, 13.33),
    (rl.flash_attention_work(1, 32, 8, 4096, 4096, 128), 3, 0.139),
    # float32 attention as 3xTF32 at the tf32 rate (0.064 at the FMA rate)
    (rl.flash_attention_work(1, 8, 2, 1024, 1024, 256, elem_bytes=4), 3,
     0.026),
    (rl.lb_keogh_work(32, 1 << 22, 256), 2, 4.11),
    (rl.dtw_scan_work(32, 1 << 22, 256, 25), 1, 248.9),
    (rl.leaf_stats_work(1 << 24, 16, 64), 3, 0.451),
    (rl.refine_topk_work(256, 8, 64, 100, 10, 1149, 2), 4, 0.0045),
    (rl.dtw_scan_work(256, 1000, 256, 25), 3, 0.475),
    (rl.dtw_scan_work(256, 10000, 256, 25), 2, 4.75),
])
def test_work_counts_give_the_perf_tables_bounds(work, digits, want):
    assert round(work.bound()[0], digits) == want


def test_search_work_main_cell_bound():
    """The main cell's refinement (2^24 walks, 256 queries, k 10): every
    one of its 262,144 leaves alive for some query, 1,184,424 rounds in
    all: 17.32 GB, 5.17 ms; the flops do not bind."""
    Q, width = 256, 1024
    order = torch.arange(Q * width, dtype=torch.int32).reshape(Q, width)
    alive = torch.full((Q,), width, dtype=torch.int32)
    rounds = torch.full((Q,), 1_184_424 // Q, dtype=torch.int32)
    rounds[0] += 1_184_424 % Q
    sw = rl.search_work(order, rounds, alive, M=64, L=256, elem_bytes=4,
                        K=8, k=10)
    assert sw.leaves == 1 << 18
    assert sw.work.nbytes == 17_323_064_832
    assert sw.work.bound() == (5.171064128955224, "bytes")


def test_search_work_counts_both_bytes_by_hand():
    # 2 queries, queues of 4 leaves; query 0 alive on leaves 3, 1, query 1
    # on 1, 0, 2: the union {0, 1, 2, 3}, 5 alive slots
    order = torch.tensor([[3, 1, 0, 2], [1, 0, 2, 3]])
    alive = torch.tensor([2, 3])
    rounds = torch.tensor([1, 2])
    M, L, K, k = 4, 8, 2, 3
    sw = rl.search_work(order, rounds, alive, M=M, L=L, elem_bytes=2, K=K,
                        k=k)
    leaf = M * (L * 2 + 4)                        # 4 rows of 16 B + norms
    assert sw.leaves == 4
    assert sw.work.nbytes == 4 * leaf + 3 * K * 8 + 2 * (L * 4 + 4 + k * 8)
    assert sw.own_leaf_bytes == 5 * leaf
    assert sw.work.ops == 5 * M * L * 2
    assert sw.work.peak == rl.F32_FLOPS


def test_dtw_search_work_by_hand():
    w = rl.dtw_search_work(cells=1000, refined=10, L=16, rounds=3,
                           round_k=4)
    assert w == rl.Work(4 * 10 * 16 + 12 * 3 * 4, 5000, rl.F32_ISSUE)


@pytest.mark.parametrize("L,r", [(7, 0), (16, 3), (100, 12), (100, 99),
                                 (256, 25), (30, 40)])
@pytest.mark.parametrize("cells", [2, 4, 8, 16])
def test_wavefront_steps_form_every_band_cell_once(L, r, cells):
    r = min(r, L - 1)
    steps = rl.wave_step_cells(L, r, cells)
    assert steps.shape == (L + r // cells,)
    assert int(steps.sum()) == rl.dtw_cells(L, r)


@pytest.mark.parametrize("T,S,causal,window", [(64, 64, True, 0),
                                               (100, 100, True, 20),
                                               (32, 8, False, 4),
                                               (16, 16, False, 0)])
def test_attention_pairs(T, S, causal, window):
    want = 0
    for t in range(T):
        seen = [s for s in range(S) if (not causal or s <= t)
                and (not window or s > t - window)]
        want += len(seen) or S
    assert rl.attention_pairs(T, S, causal, window) == want


def test_dtw_cells_is_the_band():
    assert rl.dtw_cells(5, 0) == 5
    assert rl.dtw_cells(5, 1) == 13
    assert rl.dtw_cells(5, 4) == 25


def test_the_chip_scripts_keep_no_peak_of_their_own():
    """chip_smoke.py and the benchmark scripts take every peak rate from
    roofline: no rate literal of the card's (e9 / e12) in their code."""
    for path in ("chip_smoke.py", "scripts/bench_refine_dtw.py"):
        with open(os.path.join(ROOT, path)) as f:
            src = f.read()
        assert not re.search(r"\d(\.\d+)?e(9|12)\b", src), path
