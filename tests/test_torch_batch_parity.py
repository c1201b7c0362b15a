"""One store, two packages: the JAX BatchProcessor and the port's give the
same ids and the same float scores.

A store encrypted by the JAX package's BatchProcessor (test-512-mult, the
hashing embedder, 70 documents, so that the packed arena path runs) is
searched and compared by the port's; a store encrypted by the port is
searched and compared by the JAX package.  Both read the same key
directory, reducer and files.  Tolerance: none (scores are exact integers
over scale^2).
"""

import numpy as np
import pytest

from fhe_icp_tpu import batch as jax_batch
from fhe_icp_tpu.models.embedder import HashingEmbedder as JaxHashing
from fhe_icp_tpu_torch.batch import BatchConfig, BatchProcessor
from fhe_icp_tpu_torch.models.embedder import HashingEmbedder

PRESET = "test-512-mult"
TEXTS = [f"document number {i} about topic {i % 7} and item {i % 3}" for i in range(70)]
TEXTS[0] = "the amazing brown fox chronicle"
TEXTS[1] = "a brown fox story, amazing and short"
IDS = [f"m{i:02d}" for i in range(70)]
QUERIES = ["amazing brown fox story", "document about topic 3 and item 1"]
PAIRS = [("m00", "m01"), ("m00", "m02"), ("m05", "m12"), ("m07", "m07")]


def _jax_proc(base):
    return jax_batch.BatchProcessor(
        config=jax_batch.BatchConfig(batch_size=35, show_progress=False),
        storage_dir=str(base / "docs"), key_dir=str(base / "keys"), preset=PRESET,
        target_dim=128, embedder=JaxHashing(), validate_model=False)


def _port_proc(base):
    return BatchProcessor(
        config=BatchConfig(batch_size=35, show_progress=False),
        storage_dir=str(base / "docs"), key_dir=str(base / "keys"), preset=PRESET,
        target_dim=128, embedder=HashingEmbedder(), validate_model=False, device="cpu")


def _results(proc):
    return ([proc.search_similar(q, top_k=10, min_similarity=-1.0) for q in QUERIES],
            [proc.compare_encrypted(a, b) for a, b in PAIRS])


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """{writer: (base dir, its own search and compare results)} for both packages."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FHE_MASTER_PASSWORD", "test-password-123")
        for writer, make in (("jax", _jax_proc), ("port", _port_proc)):
            base = tmp_path_factory.mktemp(writer)
            proc = make(base)
            assert proc.encrypt_documents(TEXTS, doc_ids=IDS) == IDS
            out[writer] = (base, _results(proc))
    return out


@pytest.fixture(autouse=True)
def master_password(monkeypatch):
    monkeypatch.setenv("FHE_MASTER_PASSWORD", "test-password-123")


def test_port_searches_and_compares_the_jax_store(stores):
    base, (want_search, want_compare) = stores["jax"]
    proc = _port_proc(base)
    got_search, got_compare = _results(proc)
    assert proc.operand_source == "arena"
    assert got_search == want_search
    assert got_compare == want_compare
    assert want_search[0][0][0] in ("m00", "m01")


def test_jax_searches_and_compares_the_port_store(stores):
    base, (want_search, want_compare) = stores["port"]
    got_search, got_compare = _results(_jax_proc(base))
    assert got_compare == want_compare
    assert got_search == want_search


def test_scores_are_the_clear_oracle(stores):
    """Both packages' scores equal the int64 dot products of the quantized
    embeddings over scale^2, recomputed in the clear."""
    from fhe_icp_tpu_torch.models.reduction import DimensionReducer
    from fhe_icp_tpu_torch.utils.quantize import prepare_embedding_for_fhe
    for writer in ("jax", "port"):
        base, (search, compare) = stores[writer]
        red = DimensionReducer.load(base / "docs" / "reducer.npz", device="cpu")
        emb = HashingEmbedder()

        def q(text):
            return prepare_embedding_for_fhe(red.transform(emb.get_embedding(text))[0])[0]
        docs = {i: q(t).astype(np.int64) for i, t in zip(IDS, TEXTS)}
        for (a, b), got in zip(PAIRS, compare):
            assert got == float(docs[a] @ docs[b]) / 1e6
        for query, results in zip(QUERIES, search):
            qi = q(query).astype(np.int64)
            sims = {i: float(v @ qi) / 1e6 for i, v in docs.items()}
            assert [s for _, s in results] == sorted(sims.values(), reverse=True)[:10]
            assert all(sims[i] == s for i, s in results)
