"""The program's spans and counters read in a run of each cell at a small
size on the CPU: every per-layer metric of the cell, the harness spans
covered by their child program spans, the labels of the recorder's
stretches, and the cell still correct."""

import pytest
import torch

from portbench import harness, program_spans
from small import SEED, small_data

CELL_METRICS = {
    "search-100k": {"search.score_ms", "search.topk_device_ms", "search.to_host_ms",
                    "search.rank_ms"},
    "compare-ring16384": {"compare.tensor_ms", "compare.ks_digits_ms", "compare.ks_inner_ms",
                          "compare.ks_div_ms", "compare.mod_switch_ms"},
    # ingest.gc_ms_per_doc is read where a call stores a multiple of
    # checkpoint_interval documents: 50 a call in the cell, 10 here.
    "ingest-pairwise4096": {"ingest.embed_ms_per_doc", "ingest.reduce_ms_per_doc",
                            "ingest.encrypt_ms_per_doc", "ingest.serialize_ms_per_doc",
                            "ingest.write_ms_per_doc", "ingest.index_ms_per_doc",
                            "ingest.bytes_per_doc"},
}
CHILDREN = {
    "search.shard": {"search.score", "search.topk_device", "search.to_host", "search.rank"},
    "compare.mul_relin": {"ct.tensor", "ct.relinearize"},
    "compare.decode": {"ct.mod_switch"},
    "ingest.encrypt_documents": {"ingest.embed", "ingest.reduce", "ingest.quantize",
                                 "ingest.encrypt", "store.serialize", "store.write",
                                 "store.index_flush"},
}


@pytest.mark.parametrize("cell", [w["name"] for w in harness.manifest()["workloads"]])
def test_small_run_reads_every_program_metric(cell):
    cfg, mix = small_data(cell)
    res = program_spans.run_cell(cell, SEED, 0.5, torch.device("cpu"), cfg, mix)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == CELL_METRICS[cell]       # no launches without a card
    assert all(v > 0 for v in res["metrics"].values()), res["metrics"]
    if cell == "ingest-pairwise4096":
        assert res["metrics"]["ingest.bytes_per_doc"] > 4 * 2 * 512 * 4   # the ciphertexts
    for name, c in res["coverage"].items():
        if name in CHILDREN:
            assert set(c["children"]) == CHILDREN[name], name
            assert 0 < c["children_median_ms"] <= c["median_ms"] * 1.01, (name, c)
    assert set(res["host_stretch"]) == {"off", "on"}
    assert res["launches"] is None and res["idle_gaps"] is None
    assert all(v["requests"] > 0 for v in res["host_stretch"].values())
