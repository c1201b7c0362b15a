"""The port's own spans and counters (`utils/profiling`): off unless a
recording is open, nested with parents, request ids and self times, on the
clock `torch.profiler` stamps its events with, and recorded where the work
happens on the search, compare and ingestion paths without changing a
result.  CPU only; the port alone (no JAX)."""

import contextlib
import threading
import time

import numpy as np
import pytest
import torch

from fhe_icp_tpu_torch.batch import BatchConfig, BatchProcessor
from fhe_icp_tpu_torch.models.embedder import HashingEmbedder
from fhe_icp_tpu_torch.ops import arith, pack
from fhe_icp_tpu_torch.ops import runtime as port_runtime
from fhe_icp_tpu_torch.ops.runtime import FheRuntime
from fhe_icp_tpu_torch.parallel import multihost as mh
from fhe_icp_tpu_torch.parallel.mesh import PACKED_OPERAND_SPEC, make_mesh, shard
from fhe_icp_tpu_torch.utils import profiling

KS = ["ks.digits", "ks.inner", "ks.div_special"]


def _names(rec):
    return [s.name for s in rec.spans]


def _squeeze(names):
    """Runs of one name as one entry."""
    return [n for i, n in enumerate(names) if i == 0 or names[i - 1] != n]


def test_recording_off_records_nothing():
    a, b = profiling.span("a"), profiling.span("b")
    assert a is b and isinstance(a, contextlib.nullcontext)
    with a:
        profiling.count("c", 3)
    with profiling.request(7):
        with profiling.span("x"):
            pass
    with profiling.recording() as rec:
        pass
    assert rec.spans == [] and rec.counters == {}
    assert profiling.span("a") is a                     # off again after the block


def test_nesting_gives_parents_requests_and_self_times():
    with profiling.recording() as rec:
        with profiling.span("outside"):
            pass
        for i in range(2):
            with profiling.request(i):
                with profiling.span("req"):
                    with profiling.span("child"):
                        time.sleep(0.002)
                    with profiling.span("child"):
                        with profiling.span("grandchild"):
                            time.sleep(0.001)
                    time.sleep(0.001)
    assert _names(rec) == ["outside"] + ["req", "child", "child", "grandchild"] * 2
    assert [s.request for s in rec.spans] == [None] + [0] * 4 + [1] * 4
    assert [s.parent for s in rec.spans] == [None, None, 1, 1, 3, None, 5, 5, 7]
    own = rec.self_ns()
    for i, s in enumerate(rec.spans):
        assert s.start_ns <= s.end_ns
        kids = [c for c in rec.spans if c.parent == i]
        assert own[i] == s.end_ns - s.start_ns - sum(c.end_ns - c.start_ns for c in kids)
        assert all(s.start_ns <= c.start_ns <= c.end_ns <= s.end_ns for c in kids)
    assert own[1] >= 1_000_000 and own[4] >= 1_000_000   # the sleeps outside children


def test_count_adds_and_recordings_do_not_nest():
    with profiling.recording() as rec:
        profiling.count("bytes", 5)
        profiling.count("bytes", 7)
        profiling.count("calls")
        with pytest.raises(RuntimeError):
            with profiling.recording():
                pass
    assert rec.counters == {"bytes": 12, "calls": 1}


def test_other_threads_are_not_recorded():
    def work():
        with profiling.span("elsewhere"):
            profiling.count("elsewhere")

    with profiling.recording() as rec:
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=30)
        with profiling.span("here"):
            pass
    assert not t.is_alive()
    assert _names(rec) == ["here"] and rec.counters == {}


def test_spans_share_the_profilers_clock():
    """A span around an operation contains the profiler's event of it."""
    from torch.profiler import ProfilerActivity, profile
    x = torch.arange(1 << 16, dtype=torch.float64)
    with profiling.recording() as rec, profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("cumsum"):
            x.cumsum(0)
    (s,) = rec.spans
    events = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::cumsum"]
    assert events
    assert all(s.start_ns <= e.start_ns() <= e.end_ns() <= s.end_ns for e in events)


def _search_store():
    rt = FheRuntime("test-512", rlk_levels=[], device="cpu")
    rt.generate_keys(seed=3)
    ctx, sk = rt.ctx, rt.keys.sk
    d = 128
    rng = np.random.default_rng(11)
    docs = rng.integers(-1000, 1001, size=(29, d)).astype(np.int32)
    query = rng.integers(-1000, 1001, size=(d,)).astype(np.int32)
    cts = rt.encrypt_vector(docs, seed=5)
    packed = pack.pack_ciphertexts(ctx, cts.data, d, cts.level)
    dop = pack.make_packed_doc_operand(ctx, packed, cts.level)
    qop = pack.make_packed_query_operand(ctx, sk, torch.from_numpy(query), d, cts.level)
    return ctx, dop, qop, docs, query


@pytest.mark.parametrize("n_dp", [1, 2])
def test_search_host_shard_spans(n_dp):
    ctx, dop, qop, docs, query = _search_store()
    slots, groups = pack.slots_per_ct(ctx.n, 128), dop.digits.shape[1]
    sh = mh.partition_groups(groups, 1)[0]
    mesh = make_mesh(n_dp, (n_dp, 1), device="cpu")
    digits = shard(mesh, mh.shard_slice(dop.digits, sh), PACKED_OPERAND_SPEC)

    def search():
        return mh.search_host_shard(ctx, mesh, digits, qop.digits, 128, sh, slots, len(docs),
                                    top_k=5)
    off = search()
    with profiling.recording() as rec:
        with profiling.request(0):
            on = search()
    for a, b in zip(off, on):
        np.testing.assert_array_equal(a, b)
    truth = docs.astype(np.int64) @ query.astype(np.int64)
    assert (on[0] == np.sort(truth)[::-1][:5]).all()
    assert _squeeze(_names(rec)) == ["search.score", "search.topk_device"] * n_dp + [
        "search.to_host", "search.rank"]
    assert all(s.parent is None and s.request == 0 for s in rec.spans)


@pytest.fixture(scope="module")
def mult_runtime():
    rt = FheRuntime("test-512-mult", rlk_levels=[3], device="cpu")
    rt.generate_keys(seed=1)
    return rt


@pytest.mark.parametrize("batch", [1, arith._REUSE_MIN_BATCH])
def test_mul_ct_relinearize_spans(mult_runtime, batch):
    rt = mult_runtime
    rng = np.random.default_rng(batch)
    a = rt.encrypt_vector(rng.integers(-50, 51, size=(batch, 128)), seed=2)
    b = rt.encrypt_vector(rng.integers(-50, 51, size=(batch, 128)), seed=3, rev=True)
    off = rt.mul_ct(a, b, relinearize=True)
    with profiling.recording() as rec:
        on = rt.mul_ct(a, b, relinearize=True)
    assert torch.equal(off.data, on.data) and off.level == on.level
    assert _names(rec) == ["ct.tensor", "ct.relinearize"] + KS
    relin = _names(rec).index("ct.relinearize")
    assert [s.parent for s in rec.spans] == [None, None] + [relin] * 3
    assert all(x >= 0 for x in rec.self_ns())


def test_mod_switch_span(mult_runtime):
    rt = mult_runtime
    ct = rt.encrypt_vector(np.arange(128) - 64, seed=4)
    off = rt.mod_switch(ct)
    with profiling.recording() as rec:
        on = rt.mod_switch(ct)
    assert torch.equal(off.data, on.data) and on.level == ct.level - 1
    assert _names(rec) == ["ct.mod_switch"]


def test_rekey_records_the_keyswitch_alone(mult_runtime):
    """The keyswitch's spans stand at the top level outside a relinearization."""
    rt = mult_runtime
    ksk = rt.keys.rlk[3]
    ct = rt.encrypt_vector(np.arange(128), seed=6)
    off = arith.rekey(rt.ctx, ksk, ct)
    with profiling.recording() as rec:
        on = arith.rekey(rt.ctx, ksk, ct)
    assert torch.equal(off.data, on.data)
    assert _names(rec) == KS and all(s.parent is None for s in rec.spans)


TEXTS = [
    "the quick brown fox jumps over the lazy dog",
    "a fast brown fox leaps over a lazy dog",
    "quantum computing uses superposition and entanglement",
    "encrypted search over homomorphic ciphertexts",
]


def _ingest(base, keys, record: bool):
    """A processor with a fresh store in `base` and the keys in `keys`; its
    first call (which fits the reducer) outside the recording, then a second
    call of TEXTS, with fresh randomness reseeded so that both runs draw alike."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FHE_MASTER_PASSWORD", "test-password-123")
        proc = BatchProcessor(
            config=BatchConfig(batch_size=len(TEXTS), show_progress=False,
                               checkpoint_interval=len(TEXTS), max_memory_mb=1 << 30),
            storage_dir=str(base / "docs"), key_dir=str(keys), preset="test-512-mult",
            embedder=HashingEmbedder(), validate_model=False, device="cpu")
    proc.encrypt_documents([f"fit text {i} " + " ".join(TEXTS[i % 4].split()[::-1])
                            for i in range(12)])
    port_runtime.fresh_generator(torch.device("cpu")).manual_seed(1234)
    before = {p.name for p in (base / "docs").iterdir()}
    with profiling.recording() if record else contextlib.nullcontext() as rec:
        ids = proc.encrypt_documents(TEXTS)
    new = [p for p in (base / "docs").iterdir() if p.name not in before]
    return proc, ids, rec, new


def test_encrypt_documents_spans_and_bytes(tmp_path):
    p_off, ids_off, _, _ = _ingest(tmp_path / "off", tmp_path / "keys", record=False)
    p_on, ids_on, rec, new = _ingest(tmp_path / "on", tmp_path / "keys", record=True)
    assert ids_on == ids_off
    for doc_id in ids_on:
        np.testing.assert_array_equal(p_on.storage.load(doc_id).ct_data,
                                      p_off.storage.load(doc_id).ct_data)
    names = _names(rec)
    assert names == (["ingest.embed", "ingest.reduce", "ingest.quantize", "ingest.encrypt"]
                     + ["store.serialize", "store.write"] * len(TEXTS)
                     + ["store.index_flush", "ingest.gc"])
    assert all(s.parent is None for s in rec.spans)
    index = tmp_path / "on" / "docs" / "index.json"
    written = sum(p.stat().st_size for p in new if p.suffix == ".enc")
    assert len([p for p in new if p.suffix == ".enc"]) == len(TEXTS)
    assert rec.counters == {"store.bytes_written": written + index.stat().st_size}
    p_on.config.max_memory_mb = 100             # the memory check's forced collection
    with profiling.recording() as rec:
        p_on._check_memory()
    assert _names(rec) == ["ingest.gc"]
