"""A later cell, configuration, traffic mix and per-layer metric come in as
new files and manifest entries alone: no file of the harness changes.
That holds for a cell on one card and for one on four."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

# A driver that a four-card cell could bring: documents split over the
# cell's cards, each card scoring its own, the scores gathered on the
# first card.  Its counts record how many cards it was given.
CARDS_DRIVER = '''"""Top-k of seeded documents split over every card of the cell."""

import numpy as np
import torch

from portbench.harness import Check, sync
from portbench.traffic import generate as gen


class State:
    pass


def setup(cell):
    cfg, st = cell.config, State()
    st.cell, st.k = cell, cell.mix["top_k"]
    docs = gen.quantized_unit(gen.torch_generator(cell.seed, "docs", cell.device),
                              (cfg["store_docs"], cfg["dim"]), cfg["scale"], cell.device)
    st.docs_host = docs.cpu().numpy().astype(np.int64)
    st.shards = [part.to(d) for part, d in zip(docs.chunk(len(cell.devices)), cell.devices)]
    sync(cell.devices)
    return st


def request(st, i):
    return gen.numpy_rng(st.cell.seed, f"query-{i}").integers(-1000, 1001, st.docs_host.shape[1])


def serve(st, q, tracer):
    with tracer.span("cards.score"):
        parts = [(s.to(torch.int64) * torch.as_tensor(q, device=s.device)).sum(-1)
                 for s in st.shards]
        vals, idx = torch.topk(torch.cat([p.to(st.cell.device) for p in parts]), st.k)
    return vals.cpu().numpy(), idx.cpu().numpy()


def counts(st, answers):
    return {"queries": sum(a is not None for _, a in answers), "cards": len(st.cell.devices)}


def release(st):
    st.shards = None


def check(st, answers):
    wrong = 0
    for q, a in answers:
        ref = st.docs_host @ q
        wrong += a is None or not (np.array_equal(np.sort(ref)[::-1][:st.k], a[0])
                                   and np.array_equal(ref[a[1]], a[0]))
    return [Check("wrong_topk_queries", wrong, 0)]
'''


def copy_benchmark(tmp_path):
    """The benchmark copied into `tmp_path` beside the port, and its files' bytes."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "fhe_icp_tpu_torch").symlink_to(ROOT / "fhe_icp_tpu_torch")
    return {p.relative_to(tmp_path): p.read_bytes()
            for p in (tmp_path / "portbench").rglob("*") if p.is_file()}


def run_both(tmp_path, code):
    """`code` run in the copy; its last line of output, read as JSON."""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(tmp_path), timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1]), res.stderr


def assert_unchanged(tmp_path, before):
    after = {p.relative_to(tmp_path): p.read_bytes()
             for p in (tmp_path / "portbench").rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items() if "__pycache__" not in k.parts)


def test_a_new_cell_runs_from_added_files_alone(tmp_path):
    before = copy_benchmark(tmp_path)

    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "portbench/configs/pairwise4096.json").read_text())
    cfg.update(name="tiny512", preset="test-512", store_docs=256, reduced=["store_docs"],
               source="a small test deployment")
    (tmp_path / "portbench/configs/tiny512.json").write_text(json.dumps(cfg))
    mix = json.loads((ROOT / "portbench/traffic/closed-query-top10.json").read_text())
    mix.update(top_k=5, enc_batch=64, warmup_requests=1, check_sample=8, profile_s=0.2)
    (tmp_path / "portbench/traffic/closed-query-top5.json").write_text(json.dumps(mix))
    (tmp_path / "portbench/metrics/search.median_ms.py").write_text(
        "import numpy as np\n\n\ndef read(run):\n"
        "    return float(np.median(run.latencies_s) * 1e3)\n")
    man["configs"].append({"name": "tiny512", "source": "a small test deployment",
                           "file": "portbench/configs/tiny512.json",
                           "reduced": ["store_docs"], "why": "a test"})
    man["workloads"].append({"name": "tiny-top5", "config": "tiny512",
                             "traffic": "closed-query-top5", "chips": 1, "why": "a test"})
    for m in man["end_to_end"]:
        if m["name"] == "search_p95_ms":
            m["workloads"].append("tiny-top5")
    man["per_layer"].append({"name": "search.median_ms", "unit": "ms", "better": "lower",
                             "source": "host_clock", "layer": "host-shard search",
                             "moves": "search_p95_ms", "workloads": ["tiny-top5"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))

    code = """
import json, torch
from portbench import run
out = [run.run_cell("tiny-top5", 77, 0.5, t, torch.device("cpu")) for t in (False, True)]
print(json.dumps(out))
"""
    (plain, traced), _ = run_both(tmp_path, code)
    assert plain["correct"] and traced["correct"]
    assert set(plain["metrics"]) == {"search_p95_ms", "setup_s"}
    assert "search.median_ms" in traced["metrics"]
    assert plain["device"]["count"] == traced["device"]["count"] == 1
    assert_unchanged(tmp_path, before)


def test_a_four_card_cell_runs_from_added_files_alone(tmp_path):
    """A cell with `"chips": 4` and a driver of its own, run on four CPU
    devices: every card reaches the driver and the result's count."""
    before = copy_benchmark(tmp_path)

    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    (tmp_path / "portbench/configs/cards400.json").write_text(json.dumps(
        {"name": "cards400", "store_docs": 400, "dim": 16, "scale": 1000, "reduced": []}))
    (tmp_path / "portbench/traffic/closed-cards-top5.json").write_text(json.dumps(
        {"driver": "cards_search", "top_k": 5, "profile_s": 0.2}))
    (tmp_path / "portbench/drivers/cards_search.py").write_text(CARDS_DRIVER)
    (tmp_path / "portbench/metrics/cards.seen.py").write_text(
        "def read(run):\n    return float(run.counts[\"cards\"])\n")
    man["configs"].append({"name": "cards400", "source": "a small test deployment",
                           "file": "portbench/configs/cards400.json", "reduced": [],
                           "why": "a test"})
    man["workloads"].append({"name": "cards-top5", "config": "cards400",
                             "traffic": "closed-cards-top5", "chips": 4, "why": "a test"})
    for m in man["end_to_end"]:
        if m["name"] == "search_p95_ms":
            m["workloads"].append("cards-top5")
    man["per_layer"].append({"name": "cards.seen", "unit": "cards", "better": "higher",
                             "source": "program_counter", "layer": "device",
                             "moves": "search_p95_ms", "workloads": ["cards-top5"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))

    code = """
import json, torch
from portbench import run
cpu = torch.device("cpu")
out = [run.run_cell("cards-top5", 77, 0.5, t, cpu, devices=[cpu] * 4) for t in (False, True)]
print(json.dumps(out))
"""
    (plain, traced), stderr = run_both(tmp_path, code)
    assert plain["correct"] and traced["correct"], (plain["checks"], traced["checks"])
    assert set(plain["metrics"]) == {"search_p95_ms", "setup_s"}
    assert traced["metrics"]["cards.seen"]["value"] == 4.0
    for res in (plain, traced):
        assert res["device"]["count"] == 4 and res["device"]["memory_peak_bytes"] == 0
    assert traced["device"]["busy_s"] == 0.0                  # no CUDA events on the CPU
    assert stderr.count("[portbench] memory peak cpu: 0 B") == 8  # each card, each run
    assert_unchanged(tmp_path, before)
