"""The port's profiling and debug utilities against the JAX package's.

`keyswitch_footprint` equals JAX's; the data-sheet table names cards, not
TPUs, and answers None without a card; the timers, the roofline and the
trace export, with the program's spans in it, work on the CPU (no device
number is read from them here); the environment probe and the memory monitor report.
"""

import json
import logging

import numpy as np
import pytest
import torch

from fhe_icp_tpu.utils import profiling as jprof
from fhe_icp_tpu_torch.utils import debug, profiling


@pytest.mark.parametrize("n,l,n_dig,batch", [(4096, 2, 2, 1), (4096, 2, 4, 2048),
                                            (16384, 12, 12, 1), (16384, 12, 24, 3)])
def test_keyswitch_footprint_matches_jax(n, l, n_dig, batch):
    assert profiling.keyswitch_footprint(n, l, n_dig, batch) == \
        jprof.keyswitch_footprint(n, l, n_dig, batch)


def test_card_table_holds_cards_only():
    assert profiling.HBM_SPEC_GBS
    assert not any("TPU" in name for name in profiling.HBM_SPEC_GBS)
    spec = profiling.CARD_SPECS["NVIDIA H100 80GB HBM3"]
    assert (spec.hbm_gbs, spec.int8_tops, spec.nvlink_gbs) == (3350.0, 1979.0, 450.0)
    assert spec.int32_mul_tops == pytest.approx(16.75)
    assert profiling.HBM_SPEC_GBS == {k: v.hbm_gbs for k, v in profiling.CARD_SPECS.items()}
    if not torch.cuda.is_available():
        assert profiling.hbm_spec_gbs() is None and profiling.card_spec() is None


def test_timers_and_roofline_on_the_cpu():
    x = torch.arange(1 << 16, dtype=torch.int32)

    def f(a):
        return (a * 2).sum()
    m = profiling.measure(f, x, iters=4)
    assert m["ms"] > 0 and m["s"] == pytest.approx(m["ms"] / 1e3)
    r = profiling.roofline(f, x, bytes_accessed=x.numel() * 4, ops=x.numel(), items=x.numel(),
                           iters=4)
    assert r["gb_per_s"] > 0 and r["gops_per_s"] > 0 and r["items_per_s"] > 0
    step = profiling.measure_chained(lambda t: t + (x[:8] * 2).sum().to(torch.int32) * 0 + 1,
                                     c_short=2, c_long=6, reps=2, device="cpu")
    assert set(step) == {"ms", "s"}
    loop = profiling.measure_ondevice_loop(lambda t: t + f(x).to(torch.int32) * 0,
                                           k_short=2, k_long=10, reps=3, device="cpu")
    assert set(loop) == {"ms", "s", "spread"} and loop["spread"] >= 0


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "t")) as d:
        with profiling.span("test.cumsum"):
            torch.ones(64).cumsum(0)
    events = json.loads((tmp_path / "t" / "trace.json").read_text())["traceEvents"]
    assert d == str(tmp_path / "t") and events
    (mine,) = [e for e in events if e.get("cat") == "program"]
    ops = [e for e in events if e.get("name") == "aten::cumsum"]
    assert mine["name"] == "test.cumsum" and ops
    # On the profiler's timeline, above the operation it launched.
    assert all(mine["ts"] <= e["ts"] and e["ts"] + e["dur"] <= mine["ts"] + mine["dur"]
               and e["tid"] == mine["tid"] for e in ops)


def test_check_environment_reports():
    info = debug.check_environment(verbose=False)
    assert info["torch_version"] == torch.__version__ and info["numpy_version"]
    assert "ram_gb" in info and info["rss_mb"] > 0
    assert info["cuda_available"] == torch.cuda.is_available()
    assert ("nvcc_error" in info) == (info["nvcc"] is None)
    assert set(info["env"]) <= set(debug.RELEVANT_ENV)
    assert "FHE_MASTER_PASSWORD" in debug.RELEVANT_ENV and "CUDA_HOME" in debug.RELEVANT_ENV
    assert not any("jax" in k.lower() or "tpu" in k.lower() for k in debug.KNOWN_ISSUES)


def test_check_environment_hides_the_password(monkeypatch):
    monkeypatch.setenv("FHE_MASTER_PASSWORD", "secret-value")
    assert debug.check_environment(verbose=False)["env"]["FHE_MASTER_PASSWORD"] == "<set>"


def test_memory_monitor_decorator(caplog):
    @debug.memory_monitor
    def alloc():
        return np.zeros(1_000_000)

    with caplog.at_level(logging.INFO, logger="fhe_icp_tpu_torch.utils.debug"):
        assert alloc().shape == (1_000_000,)
    assert any("alloc:" in r.message and "peak=" in r.message for r in caplog.records)
