"""Each cell's run at a small size on the CPU, its control, and its comparison
with the timed path broken underneath: every fault makes `correct` false."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import harness, run
from small import SEED, run_small, small_data

from fhe_icp_tpu_torch.ops import runtime as port_runtime
from fhe_icp_tpu_torch.parallel import multihost

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in harness.manifest()["workloads"]]


def well_formed(res: dict, trace: bool) -> None:
    assert list(res)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert isinstance(res["attempted"], int) and res["attempted"] > 0
    assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for name, m in res["metrics"].items():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float), name
    for name, c in res["checks"].items():
        assert set(c) == {"value", "limit"}, name
    if trace:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    json.loads(json.dumps(res))


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_small_run_is_correct_and_well_formed(cell, trace):
    res = run_small(cell, trace=trace)
    well_formed(res, trace)
    assert res["correct"], res["checks"]
    man = harness.manifest()
    want = {m["name"] for m in harness.cell_metrics(man, cell, trace)}
    assert set(res["metrics"]) <= want
    if not trace:
        assert set(res["metrics"]) == want                  # every end-to-end metric
        assert all(m["value"] > 0 for m in res["metrics"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_same_seed_same_inputs(cell):
    cfg, mix = small_data(cell)
    driver = harness.load_module("drivers", mix["driver"])
    cpu = torch.device("cpu")
    reqs = []
    for _ in range(2):
        tracer = harness.Tracer(False, cpu)
        st = driver.setup(harness.Cell(cell, SEED, 0.1, False, cpu, cfg, mix, tracer))
        reqs.append([driver.request(st, i) for i in range(3)])
        driver.release(st)
    a, b = reqs
    assert repr([np.asarray(x).tolist() for x in a]) == repr([np.asarray(x).tolist() for x in b])


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    mix = harness.load_json("traffic", harness.find(harness.manifest()["workloads"], cell,
                                                    "workload")["traffic"] + ".json")
    driver = harness.load_module("drivers", mix["driver"])
    res = run_small(cell, serve=lambda st, req, tracer: driver.control(st, req))
    assert not res["correct"], res["checks"]


def _answer_altered(monkeypatch, cell):
    if cell == "search-100k":
        real = multihost.search_host_shard

        def altered(*a, **k):
            vals, idx = real(*a, **k)
            return vals, np.concatenate([idx[1:], idx[:1]])
        monkeypatch.setattr(multihost, "search_host_shard", altered)
    else:
        real = port_runtime.FheRuntime.decrypt_dot
        monkeypatch.setattr(port_runtime.FheRuntime, "decrypt_dot",
                            lambda self, ct, d: real(self, ct, d) + 1)


def _state_unchanged(monkeypatch, cell):
    if cell == "search-100k":               # the query operand never built: a zero query
        real = multihost.search_host_shard
        monkeypatch.setattr(multihost, "search_host_shard",
                            lambda ctx, mesh, docs, q, *a, **k: real(ctx, mesh, docs, q * 0,
                                                                     *a, **k))
    else:                                   # the product returns its first factor
        monkeypatch.setattr(port_runtime.FheRuntime, "mul_ct",
                            lambda self, a, b, relinearize=True: a)


def _half_left_out(monkeypatch, cell):
    """Half of the store's groups scored (the search's batch)."""
    real = multihost.search_host_shard

    def half(ctx, mesh, docs, q, d, shard, slots, n_docs, top_k=5):
        cut = [x[:, : x.shape[1] // 2 // 4 * 4] for x in docs]
        return real(ctx, mesh, cut, q, d, shard, slots, n_docs, top_k=top_k)
    monkeypatch.setattr(multihost, "search_host_shard", half)


FAULTS = {"answer_altered": _answer_altered, "state_unchanged": _state_unchanged,
          "half_left_out": _half_left_out}
# The faults each cell can have: a compare has no batch to halve, and no
# cell has an exchange between cards.
CAN_HAVE = {"search-100k": ("answer_altered", "state_unchanged", "half_left_out"),
            "compare-ring16384": ("answer_altered", "state_unchanged")}


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS for f in CAN_HAVE[c]])
def test_fault_makes_the_run_not_correct(cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch, cell)
    res = run_small(cell)
    assert not res["correct"], res["checks"]


def test_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=str(ROOT), timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.parametrize("visible,names", [(2, "AAAA"), (4, "AABA")])
def test_command_refuses_too_few_or_unlike_cards(visible, names, monkeypatch, capsys):
    """A four-card cell with two cards visible, or with one card of another
    name among its four: no result, and another exit code than 0."""
    man = harness.manifest()
    man["workloads"].append(dict(man["workloads"][0], name="four-cards", chips=4))
    monkeypatch.setattr(harness, "manifest", lambda: man)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: visible)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d: names[d.index])
    assert run.main(["--workload", "four-cards", "--seed", "1", "--seconds", "1"]) != 0
    out = capsys.readouterr()
    assert out.out == "" and "four-cards" in out.err


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell):
    """The command itself, a short window on the card (run there by
    `python -m pytest portbench/tests -m card`)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", cell,
                          "--seed", str(SEED), "--seconds", "3", "--trace", "1"],
                         capture_output=True, text=True, cwd=str(ROOT), timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    well_formed(res, True)
    assert res["correct"] and res["device"]["busy_s"] > 0
