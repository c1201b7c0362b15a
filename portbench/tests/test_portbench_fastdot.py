"""The sharded fastdot cell at a tiny store on four CPU devices, from its own
files: correct untraced and traced, its comparison broken by every fault
planted under the timed path, the port's spans inside its own, its plain
reference against the NumPy one, and its roofline reader on a synthetic
profile."""

import time

import numpy as np
import pytest
import torch

from portbench import harness, program_spans, roofline, run
from portbench.reference import exact_topk
from portbench.reference import scores as ref
from small import SEED

from fhe_icp_tpu_torch.parallel import search

CELL = "search-fastdot-4m"
CPU = torch.device("cpu")
H100 = "NVIDIA H100 80GB HBM3"


def tiny_data():
    """The cell's files at 4 x 64 documents, the test ring and short stretches."""
    entry = harness.find(harness.manifest()["workloads"], CELL, "workload")
    cfg = harness.load_json("configs", entry["config"] + ".json")
    mix = harness.load_json("traffic", entry["traffic"] + ".json")
    cfg.update(preset="test-512", store_docs=4 * 64, docs_per_card=64)
    mix.update(enc_batch=24, warmup_requests=1, check_sample=16, profile_s=0.2)
    return cfg, mix


def run_tiny(trace=False, serve=None, devices=4):
    cfg, mix = tiny_data()
    return run.run_cell(CELL, SEED, 0.5, trace, CPU, cfg, mix, serve=serve,
                        t_process=time.perf_counter(), devices=[CPU] * devices)


@pytest.mark.parametrize("trace", [False, True])
def test_the_cell_runs_on_four_cards_from_its_files(trace):
    res = run_tiny(trace)
    assert res["correct"], res["checks"]
    assert res["device"]["count"] == 4
    assert set(res["checks"]) == {"wrong_topk_queries", "wrong_scores"}
    want = {m["name"] for m in harness.cell_metrics(harness.manifest(), CELL, trace)}
    if trace:                       # no device activity or peaks on the CPU
        assert set(res["metrics"]) == {"fastdot.operand_ms", "fastdot.shards_ms"} < want
    else:
        assert set(res["metrics"]) == want == {"search_p95_ms", "dot_products_per_s", "setup_s"}


def test_program_spans_cover_the_harness_spans():
    """`portbench.program_spans` on the cell's four cards: the port's spans
    inside the driver's, and the cell still correct."""
    cfg, mix = tiny_data()
    res = program_spans.run_cell(CELL, SEED, 0.5, CPU, cfg, mix, devices=[CPU] * 4)
    assert res["correct"], res["checks"]
    cov = res["coverage"]
    assert set(cov["fastdot.operand"]["children"]) == {"fastdot.query_operand"}
    assert set(cov["fastdot.shards"]["children"]) == {"fastdot.score", "fastdot.gather",
                                                      "fastdot.topk"}
    for c in cov.values():
        assert 0 < c["children_median_ms"] <= c["median_ms"] * 1.01, c


def test_the_store_must_match_its_cards():
    """The store's four shards on one card: refused before anything is built."""
    with pytest.raises(ValueError, match="4 shards"):
        run_tiny(devices=1)


def test_control_is_not_correct():
    driver = harness.load_module("drivers", "fastdot_search")
    res = run_tiny(serve=lambda st, req, tracer: driver.control(st, req))
    assert not res["correct"]
    assert res["checks"]["wrong_topk_queries"]["value"] > 0
    assert res["checks"]["wrong_scores"]["value"] > 0        # no scores kept


def _swap_first_ids(out):
    scores, vals, idx = out
    return scores, vals, idx[[1, 0] + list(range(2, len(idx)))]


FAULTS = {
    # A card's shard dead: its documents score 0.
    "zeroed_shard": (lambda step, s, q: step(s[:2] + [torch.zeros_like(s[2])] + s[3:], q),
                     "wrong_scores"),
    # Each card's scores put in the place of the next card's.
    "shards_shifted": (lambda step, s, q: step(s[1:] + s[:1], q), "wrong_topk_queries"),
    "swapped_id": (lambda step, s, q: _swap_first_ids(step(s, q)), "wrong_topk_queries"),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_makes_the_run_not_correct(fault, monkeypatch):
    alter, check = FAULTS[fault]
    real = search.make_sharded_fastdot_search

    def make(*a, **k):
        step = real(*a, **k)
        return lambda shards, q: alter(step, list(shards), q)
    monkeypatch.setattr(search, "make_sharded_fastdot_search", make)
    res = run_tiny()
    assert not res["correct"] and res["checks"][check]["value"] > 0, res["checks"]
    if fault != "swapped_id":
        assert res["checks"]["wrong_scores"]["value"] > 0


@pytest.mark.parametrize("seed", range(4))
def test_exact_topk_agrees_with_the_numpy_reference(seed, monkeypatch):
    monkeypatch.setattr(exact_topk, "BLOCK", 64)          # several blocks to merge
    rng = np.random.default_rng(seed)
    n, k = int(rng.integers(5, 400)), int(rng.integers(1, 12))
    docs = rng.integers(-1000, 1001, size=(n, 128)).astype(np.int32)
    q = rng.integers(-1000, 1001, size=(5, 128)).astype(np.int32)
    s = ref.scores(docs, q)
    assert np.array_equal(exact_topk.scores(docs, q, CPU).numpy(), s)
    vals, ids = exact_topk.topk(docs, q, k, CPU)
    assert np.array_equal(vals.numpy(), ref.topk_values(s, min(k, n)))
    good = [(vals[:, j].numpy(), ids[:, j].numpy()) for j in range(5)]
    answers = [good[0], None, (good[2][0] + 1, good[2][1]), (good[3][0], good[3][1][::-1]),
               good[4]]
    assert exact_topk.wrong_topk(docs, q, answers, k, CPU) == ref.wrong_topk(docs, q, answers, k)
    got = [torch.from_numpy(s[:, j]).to(torch.int32) for j in range(5)]
    got[1] = got[1].clone()
    got[1][n // 2] += 1
    got[3] = None
    assert exact_topk.wrong_scores(docs, q, got, CPU) == 1 + n


def test_int8_roofline_reads_cublas_and_fastdot_operations_alone():
    reader = harness.load_module("metrics", "fastdot.int8_roofline")
    shape = (2, 4 * 1048576, 8192, 4)
    pk = roofline.peaks(H100)
    least = roofline.bound_s(reader.product_bytes(*shape), reader.product_ops(*shape), pk)
    assert least == pytest.approx(20.55e-3, rel=1e-3)             # bytes bind: 68.9 GB
    ops = {
        # cuBLASLt's int8 GEMM as the H100's trace prints it (torch 2.11, CUDA 12.8).
        "void cutlass::Kernel2<cutlass_80_wmma_tensorop_i161616gemm_s8_forwardCompat_128x128_"
        "32x2_nn_align4>(cutlass_80_wmma_tensorop_i161616gemm_s8_forwardCompat_128x12": 3 * least,
        "fastdot_int8_kernel": 5 * least,
        "sm90_xmma_gemm_f32f32_tf32f32_f32_tn_n_tilesize128x128x32": 1.0,
        "void at::native::elementwise_kernel<128, 2, remainder_kernel_cuda": 1.0,
        "void (anonymous namespace)::pack_score_kernel<128>": 1.0,
    }
    prof = {"launches": {"k1": [], "k2": [], "fastdot_mm": [shape, shape]}, "device_ops": ops}

    def read(card=H100, profile=prof):
        return reader.read(harness.Run(CELL, card, 0.0, 1.0, [], 1, 0, profile=profile))
    assert read() == pytest.approx(100 * 2 / 8)
    assert read(card="cpu") is None
    assert read(profile=dict(prof, launches={"k1": [], "k2": []})) is None
    assert read(profile=None) is None
