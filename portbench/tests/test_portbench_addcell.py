"""A later cell, configuration, traffic mix and per-layer metric come in as
new files and manifest entries alone: no file of the harness changes."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def test_a_new_cell_runs_from_added_files_alone(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "fhe_icp_tpu_torch").symlink_to(ROOT / "fhe_icp_tpu_torch")
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "portbench").rglob("*") if p.is_file()}

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
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(tmp_path), timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    plain, traced = json.loads(res.stdout.strip().splitlines()[-1])
    assert plain["correct"] and traced["correct"]
    assert set(plain["metrics"]) == {"search_p95_ms", "setup_s"}
    assert "search.median_ms" in traced["metrics"]
    after = {p.relative_to(tmp_path): p.read_bytes()
             for p in (tmp_path / "portbench").rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items() if "__pycache__" not in k.parts)
