"""The port's BatchProcessor, as tests/test_pipeline.py holds the JAX package's.

test-512-mult (3 limbs: ct x ct compare needs the headroom), the hashing
embedder, the CPU.  Scores are checked against numpy oracles recomputed in
the clear from the texts, the store's reducer and the quantization
contract: the encrypted scores must equal them exactly.
"""

import hashlib
import json

import numpy as np
import pytest

from fhe_icp_tpu_torch.batch import BatchConfig, BatchProcessor, rekey_documents
from fhe_icp_tpu_torch.keymgr import FHEKeyManager
from fhe_icp_tpu_torch.models.embedder import HashingEmbedder
from fhe_icp_tpu_torch.ops.cipher import Ciphertext
from fhe_icp_tpu_torch.utils.quantize import prepare_embedding_for_fhe

PRESET = "test-512-mult"


@pytest.fixture(autouse=True)
def master_password(monkeypatch):
    monkeypatch.setenv("FHE_MASTER_PASSWORD", "test-password-123")


def _proc(base, target_dim=128, validate_model=False):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FHE_MASTER_PASSWORD", "test-password-123")
        return BatchProcessor(
            config=BatchConfig(batch_size=4, show_progress=False),
            storage_dir=str(base / "docs"), key_dir=str(base / "keys"),
            preset=PRESET, target_dim=target_dim, embedder=HashingEmbedder(),
            validate_model=validate_model, device="cpu")


@pytest.fixture(scope="module")
def processor(tmp_path_factory):
    return _proc(tmp_path_factory.mktemp("bp"), validate_model=True)


def _oracle(p, texts, query):
    """(docs_int, q_int) in the clear: embed, reduce, quantize."""
    red = p.reducer.transform(p.embedder.get_embeddings_batch(texts))
    docs = np.stack([prepare_embedding_for_fhe(r, p.scale)[0] for r in red]).astype(np.int64)
    q = p.reducer.transform(p.embedder.get_embedding(query))[0]
    return docs, prepare_embedding_for_fhe(q, p.scale)[0].astype(np.int64)


TEXTS = [
    "the quick brown fox jumps over the lazy dog",
    "a fast brown fox leaps over a lazy dog",
    "quantum computing uses superposition and entanglement",
    "encrypted search over homomorphic ciphertexts",
    "the lazy dog sleeps while the brown fox jumps",
]


def test_encrypt_documents(processor):
    ids = processor.encrypt_documents(TEXTS)
    assert len(ids) == len(TEXTS)
    assert ids[0] == f"doc_{hashlib.sha256(TEXTS[0].encode()).hexdigest()[:12]}"
    assert set(ids) <= set(processor.storage.list_documents())
    doc = processor.storage.load(ids[0])
    assert doc.ct_data.dtype == np.uint32 and doc.ct_data.shape == (4, 3, 512)
    assert doc.key_id == processor.key_id and doc.ct_level == 3
    # The fwd encoding decrypts to the quantized embedding.
    docs_int, _ = _oracle(processor, TEXTS[:1], "x")
    ct = doc.ciphertext(device="cpu")
    fwd = processor.runtime.decrypt(Ciphertext(ct.data[:2], 3)).numpy()
    assert (fwd[:128] == docs_int[0]).all() and not fwd[128:].any()


def test_compare_is_exact(processor):
    ids = processor.encrypt_documents(TEXTS)
    docs_int, _ = _oracle(processor, TEXTS, "x")
    for i, j in ((0, 1), (0, 2), (3, 3)):
        want = float(docs_int[i] @ docs_int[j]) / 1e6
        assert processor.compare_encrypted(ids[i], ids[j]) == want
    assert processor.compare_encrypted(ids[0], ids[1]) > processor.compare_encrypted(ids[0], ids[2])


def test_self_similarity_is_one(processor):
    ids = processor.encrypt_documents([TEXTS[0]])
    assert abs(processor.compare_encrypted(ids[0], ids[0]) - 1.0) < 0.01


def test_search_small_store_is_exact(tmp_path):
    """Below 64 documents: the ciphertext matvec path."""
    p = _proc(tmp_path)
    ids = p.encrypt_documents(TEXTS)
    query = "brown fox jumping over dogs"
    results = p.search_similar(query, top_k=3, min_similarity=-1.0)
    docs_int, q_int = _oracle(p, TEXTS, query)
    sims = (docs_int @ q_int) / 1e6
    order = np.argsort(-sims)
    assert results == [(ids[i], float(sims[i])) for i in order[:3]]
    assert results[0][0] in {ids[0], ids[1], ids[4]}
    assert p.operand_source is None
    assert p.search_similar(query, top_k=5, min_similarity=2.0) == []


def test_search_large_store_uses_arena_path(processor):
    """From 64 documents: the packed arena path, exact and cached."""
    texts = [f"document number {i} about topic {i % 7}" for i in range(70)]
    texts[0] = "the amazing brown fox chronicle"
    processor.encrypt_documents(texts, doc_ids=[f"m{i}" for i in range(70)])
    query = "amazing brown fox story"
    results = processor.search_similar(query, top_k=5, min_similarity=-1.0)
    assert results[0][0] == "m0" and len(results) == 5
    assert processor.operand_source == "arena"
    store = processor.storage
    ids = store.list_documents()
    assert json.loads((store.dir / "search.arena.ids").read_text()) == ids
    assert processor._op_cache[1] == ids and store.arena_is_current()
    all_texts = {f"doc_{hashlib.sha256(t.encode()).hexdigest()[:12]}": t for t in TEXTS}
    all_texts.update({f"m{i}": t for i, t in enumerate(texts)})
    docs_int, q_int = _oracle(processor, [all_texts[d] for d in ids], query)
    sims = (docs_int @ q_int) / 1e6
    order = np.argsort(-sims)
    want = [(ids[i], float(sims[i])) for i in order[:5]]
    assert results == want
    sig = processor._op_cache[0]
    processor.search_similar("another query", top_k=2, min_similarity=-1.0)
    assert processor._op_cache[0] == sig


def test_resume_skips_already_encrypted(processor):
    ids = [f"r{i}" for i in range(3)]
    texts = [f"resume test document {i}" for i in range(3)]
    processor.encrypt_documents(texts, doc_ids=ids)
    before = {d: processor.storage.index[d]["sha256"] for d in ids}
    again = processor.encrypt_documents(texts, doc_ids=ids, resume=True)
    assert sorted(again) == sorted(ids)
    assert {d: processor.storage.index[d]["sha256"] for d in ids} == before
    texts[1] = "resume test document 1 CHANGED"
    processor.encrypt_documents(texts, doc_ids=ids, resume=True)
    assert processor.storage.index["r1"]["sha256"] != before["r1"]
    assert processor.storage.index["r0"]["sha256"] == before["r0"]


def test_memory_stats(processor):
    stats = processor.get_memory_stats()
    assert stats["current_mb"] > 0
    assert stats["limit_mb"] == processor.config.max_memory_mb


def test_batch_config_validation():
    with pytest.raises(ValueError):
        BatchConfig(batch_size=0)
    with pytest.raises(ValueError):
        BatchConfig(max_memory_mb=10)


def test_rekey_store_searches_exactly_under_the_new_key(tmp_path):
    """Re-keying rewrites every document under the same ids: the packed
    search must not reuse the arena exported under the old key."""
    FHEKeyManager(str(tmp_path / "keys"), preset=PRESET, device="cpu").generate_keys("old")
    p = _proc(tmp_path)
    texts = [f"rotation corpus line {i} topic {i % 5}" for i in range(66)]
    p.encrypt_documents(texts, doc_ids=[f"d{i:02d}" for i in range(66)])
    query = "rotation corpus topic 3"
    before = p.search_similar(query, top_k=6, min_similarity=-1.0)
    old = p.key_id
    new = p.key_manager.rotate_keys()
    assert (old, new != old) == ("old", True)
    p.runtime, p.key_id = p.key_manager.load_keyset(new), new
    with pytest.raises(ValueError, match="rekey_store"):
        p.search_similar(query)
    assert p.rekey_store(old) == 66
    assert p.storage.load("d03").key_id == new and not p.storage.arena_is_current()
    assert p.search_similar(query, top_k=6, min_similarity=-1.0) == before
    assert p.operand_source == "arena" and p.storage.arena_is_current()
    assert rekey_documents(p.storage, p.key_manager, old, new) == 0
    docs_int, _ = _oracle(p, texts[:2], "x")
    assert p.compare_encrypted("d00", "d01") == float(docs_int[0] @ docs_int[1]) / 1e6


class TestReducerPersistence:
    def test_pca_fit_persist_and_reload(self, tmp_path):
        corpus = [f"document number {i} about topic {i % 5} with words "
                  f"{'alpha beta' * (i % 3 + 1)}" for i in range(20)]
        p1 = _proc(tmp_path, target_dim=16)
        ids = p1.encrypt_documents(corpus)
        assert len(ids) == 20
        assert p1.reducer.method == "pca"
        assert (tmp_path / "docs" / "reducer.npz").exists()
        p2 = _proc(tmp_path, target_dim=16)
        assert p2.reducer.method == "pca"
        np.testing.assert_array_equal(p2.reducer.components_, p1.reducer.components_)
        new_id = p2.encrypt_documents([corpus[0]], doc_ids=["again0"])[0]
        assert p2.compare_encrypted(ids[0], new_id) == p2.compare_encrypted(ids[0], ids[0])

    def test_small_first_corpus_falls_back_to_random(self, tmp_path):
        p = _proc(tmp_path)
        p.encrypt_documents(["one tiny document", "and a second one"])
        assert p.reducer.method == "random"
        assert (tmp_path / "docs" / "reducer.npz").exists()
