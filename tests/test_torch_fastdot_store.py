"""A per-document fastdot store built a chunk at a time, and the spans and
counters of a query through the sharded step, on the CPU.

A store too large to build at once is allocated as one (L, 4, B, 2N) int8
operand and each chunk's `make_doc_operand` digits are written into its
slice: that equals `make_doc_operand` of the whole batch byte for byte.
A query over four shards records its spans and counters inside a
`recording()`, every shard's product before any fold, and nothing outside
one.  Tolerance: none.
"""

import pytest
import torch

from fhe_icp_tpu_torch.ops import fastdot
from fhe_icp_tpu_torch.ops.runtime import FheRuntime
from fhe_icp_tpu_torch.parallel import search
from fhe_icp_tpu_torch.parallel.mesh import DOC_OPERAND_SPEC, make_mesh, shard
from fhe_icp_tpu_torch.utils import profiling

D, SCALE = 128, 1000
_STORES = {}


def quantized_unit(gen, shape):
    v = torch.randn(shape, generator=gen, dtype=torch.float64)
    return torch.round(v / torch.linalg.vector_norm(v, dim=-1, keepdim=True) * SCALE).to(
        torch.int32)


def store(preset, n_docs):
    """Keys, seeded documents and their ciphertexts at `preset` (built once)."""
    if (preset, n_docs) not in _STORES:
        rt = FheRuntime(preset, rlk_levels=[], device="cpu")
        rt.generate_keys(seed=3)
        gen = torch.Generator().manual_seed(n_docs)
        docs = quantized_unit(gen, (n_docs, D))
        _STORES[preset, n_docs] = rt, docs, rt.encrypt_vector(docs, seed=11)
    return _STORES[preset, n_docs]


def sharded_query(rt, cts, queries, k):
    """Every query through the step over four shards: (scores, values, ids) each."""
    mesh = make_mesh(4, device="cpu")
    shards = shard(mesh, fastdot.make_doc_operand(rt.ctx, cts.data, cts.level).digits,
                   DOC_OPERAND_SPEC)
    step = search.make_sharded_fastdot_search(rt.ctx, mesh, top_k=k)
    return [step(shards, fastdot.make_query_operand(rt.ctx, rt.keys.sk, q, D, cts.level).digits)
            for q in queries]


@pytest.mark.parametrize("chunk", [16, 25, 64, 100])
def test_chunked_operand_build_equals_the_whole(chunk):
    rt, _, cts = store("test-512", 400)
    data = cts.data[:100]
    whole = fastdot.make_doc_operand(rt.ctx, data, cts.level).digits
    out = torch.full_like(whole, 77)
    for lo in range(0, len(data), chunk):
        out[:, :, lo: lo + chunk] = fastdot.make_doc_operand(
            rt.ctx, data[lo: lo + chunk], cts.level).digits
    assert out.dtype == torch.int8 and torch.equal(out, whole)


def test_a_query_records_its_spans_and_counters():
    rt, docs, cts = store("test-512", 400)
    q = quantized_unit(torch.Generator().manual_seed(9), (2, D))
    sharded_query(rt, cts, q[:1], k=5)                    # outside a recording
    assert profiling._recorder is None
    with profiling.recording() as rec:
        (scores, _, _), = sharded_query(rt, cts, q[1:], k=5)
    assert torch.equal(scores.to(torch.int64), docs.to(torch.int64) @ q[1].to(torch.int64))
    names = [s.name for s in rec.spans]
    assert names == ["fastdot.query_operand", "fastdot.score"] + ["fastdot.product"] * 4 + [
        "fastdot.fold_decode"] * 4 + ["fastdot.gather", "fastdot.topk"]
    for s in rec.spans:
        if s.name in ("fastdot.product", "fastdot.fold_decode"):
            assert rec.spans[s.parent].name == "fastdot.score"
        else:
            assert s.parent is None, s
        assert s.start_ns <= s.end_ns
    assert rec.counters == {"fastdot.docs": len(docs),
                            "fastdot.digit_bytes": len(docs) * cts.level * 4 * 2 * rt.ctx.n}
