"""The program's spans and counters read in a run of each cell at a small
size on the CPU: every per-layer metric of the cell, the harness spans
covered by their child program spans, the labels of the recorder's
stretches, and the cell still correct."""

from types import SimpleNamespace

import pytest
import torch

from portbench import harness, program_spans
from small import SEED, small_data

from fhe_icp_tpu_torch.utils import profiling

CELL_METRICS = {
    "search-100k": {"search.score_ms", "search.topk_device_ms", "search.to_host_ms",
                    "search.rank_ms"},
    "compare-ring16384": {"compare.tensor_ms", "compare.ks_digits_ms", "compare.ks_inner_ms",
                          "compare.ks_div_ms", "compare.mod_switch_ms"},
}
CHILDREN = {
    "search.shard": {"search.score", "search.topk_device", "search.to_host", "search.rank"},
    "compare.mul_relin": {"ct.tensor", "ct.relinearize"},
    "compare.decode": {"ct.mod_switch"},
}


@pytest.mark.parametrize("cell", [w["name"] for w in harness.manifest()["workloads"]])
def test_small_run_reads_every_program_metric(cell):
    cfg, mix = small_data(cell)
    res = program_spans.run_cell(cell, SEED, 0.5, torch.device("cpu"), cfg, mix)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == CELL_METRICS[cell]       # no launches without a card
    assert all(v > 0 for v in res["metrics"].values()), res["metrics"]
    for name, c in res["coverage"].items():
        if name in CHILDREN:
            assert set(c["children"]) == CHILDREN[name], name
            assert 0 < c["children_median_ms"] <= c["median_ms"] * 1.01, (name, c)
    assert set(res["host_stretch"]) == {"off", "on"}
    assert res["launches"] is None and res["idle_gaps"] is None
    assert all(v["requests"] > 0 for v in res["host_stretch"].values())


class KinetoEvent:
    """A stand-in for one of the profiler's kineto events on `card`'s device
    timeline, over [start, end] ns."""

    def __init__(self, name, start, end, card):
        self._name, self._start, self._end, self._card = name, start, end, card

    def name(self):
        return self._name

    def device_type(self):
        return torch.autograd.DeviceType.CUDA

    def device_index(self):
        return self._card

    def start_ns(self):
        return self._start

    def end_ns(self):
        return self._end


@pytest.mark.parametrize("cards", [1, 2])
def test_idle_gaps_on_each_cards_timeline(cards):
    """Operations on card 0 at [0, 10] and [20, 30] µs, on the last card at
    [40, 60] and [80, 90]: on one card the gaps are those of one timeline;
    on two, each card's own gap alone, and none between the cards' turns."""
    rec = profiling.Recording(spans=[
        profiling.Span("search.shard", 0, None, 0, 100_000),
        profiling.Span("search.score", 0, 0, 5_000, 50_000),
        profiling.Span("search.rank", 0, 0, 55_000, 95_000)])
    ops = [KinetoEvent("k", s, e, c) for s, e, c in
           [(0, 10_000, 0), (20_000, 30_000, 0), (40_000, 60_000, cards - 1),
            (80_000, 90_000, cards - 1)]]
    ops.append(KinetoEvent("search.shard", 0, 100_000, 0))    # the span's mark on the card
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: ops)))
    gaps = program_spans.idle_gaps(prof, rec, {"search.shard"})
    score = 20e-6 if cards == 1 else 10e-6          # one card also idles in [30, 40]
    assert gaps == {"by_span": {"search.score": score, "search.rank": 20e-6},
                    "by_harness_span": {"search.shard": score + 20e-6},
                    "left_to_harness_share": {"search.shard": 0.0}}
