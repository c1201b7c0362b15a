"""The port's C++ arena codec and encrypted document store, against the JAX package's.

Mirrors tests/test_native.py and the storage tests of tests/test_pipeline.py
on the port, then crosses the packages: a store and an arena written by
either package read in the other, with the same CRC-32C and integrity
sweep results; and the port builds its codec under build/, leaving the
JAX package's library under native/ as it was.  Tolerance: none.
"""

import hashlib
import os
import time

import numpy as np
import pytest
import torch

from fhe_icp_tpu import native as jax_native
from fhe_icp_tpu import store as jax_store
from fhe_icp_tpu_torch import native
from fhe_icp_tpu_torch.store import EncryptedDocument, EncryptedDocumentStore

RNG = np.random.default_rng(41)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make_doc(doc_id="doc1", dim=128, level=2, n=512, meta=None, cls=EncryptedDocument):
    rng = np.random.default_rng(int(hashlib.sha256(doc_id.encode()).hexdigest()[:8], 16))
    return cls(
        doc_id=doc_id,
        content_hash=hashlib.sha256(doc_id.encode()).hexdigest(),
        timestamp=time.time(),
        ct_data=rng.integers(0, 2 ** 31, size=(4, level, n), dtype=np.int64).astype(np.uint32),
        ct_level=level, dim=dim, scale=1000, metadata=meta or {},
    )


# -- the codec (tests/test_native.py) ------------------------------------------


def test_crc32c_known_vector():
    # RFC 3720 test vector: CRC-32C of "123456789" is 0xE3069283.
    assert native.crc32c(b"123456789") == 0xE3069283


def test_arena_roundtrip(tmp_path):
    docs = RNG.integers(0, 2 ** 31, size=(7, 4, 2, 64), dtype=np.int64).astype(np.uint32)
    path = tmp_path / "a.arena"
    native.arena_write(path, docs)
    assert native.arena_info(path) == (7, 4 * 2 * 64)
    view = native.arena_mmap(path, (4, 2, 64))
    assert (np.asarray(view) == docs).all()
    assert native.arena_validate(path) == (7, None)


def test_arena_detects_corruption(tmp_path):
    docs = RNG.integers(0, 2 ** 31, size=(5, 128), dtype=np.int64).astype(np.uint32)
    path = tmp_path / "a.arena"
    native.arena_write(path, docs)
    raw = bytearray(path.read_bytes())
    raw[64 + (2 * 128 + 5) * 4] ^= 0xFF        # one byte of document 2's payload
    path.write_bytes(bytes(raw))
    assert native.arena_validate(path) == (4, 2)
    raw[3] ^= 0xFF                             # the header: a hard error
    path.write_bytes(bytes(raw))
    with pytest.raises(OSError):
        native.arena_info(path)


def test_arena_rejects_wrong_shape(tmp_path):
    docs = RNG.integers(0, 100, size=(3, 32), dtype=np.int64).astype(np.uint32)
    path = tmp_path / "a.arena"
    native.arena_write(path, docs)
    with pytest.raises(ValueError, match="words"):
        native.arena_mmap(path, (33,))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_arena_crosses_packages(tmp_path, writer):
    """An arena written by either codec reads, validates and sums the same in both."""
    docs = RNG.integers(0, 2 ** 31, size=(6, 4, 2, 32), dtype=np.int64).astype(np.uint32)
    path = tmp_path / "x.arena"
    (jax_native if writer == "jax" else native).arena_write(path, docs)
    for mod in (jax_native, native):
        assert mod.arena_info(path) == (6, 4 * 2 * 32)
        assert mod.arena_validate(path) == (6, None)
        assert (np.asarray(mod.arena_mmap(path, (4, 2, 32))) == docs).all()
    raw = path.read_bytes()
    for blob in (raw, b"", b"123456789", raw[:1001]):
        assert native.crc32c(blob, 7) == jax_native.crc32c(blob, 7)
    bad = bytearray(raw)
    bad[64 + 3 * 256 * 4 + 9] ^= 0x10
    path.write_bytes(bytes(bad))
    assert native.arena_validate(path) == jax_native.arena_validate(path) == (5, 3)


def test_port_builds_its_codec_under_build_only(monkeypatch):
    """The port never writes native/: the reference library keeps its bytes and mtime."""
    jax_native.available()          # the JAX package's own rebuild, if it is due, first
    lib = os.path.join(ROOT, "native", "libfhestore.so")
    before = (hashlib.sha256(open(lib, "rb").read()).hexdigest(), os.stat(lib).st_mtime_ns)
    listing = sorted(os.listdir(os.path.join(ROOT, "native")))
    monkeypatch.setattr(native, "_LIB", None)
    if native.LIB_PATH.exists():
        os.utime(native.LIB_PATH, (0, 0))       # older than its source: rebuilt now
    assert native.available()
    assert native.LIB_PATH.stat().st_mtime >= native.SRC.stat().st_mtime
    assert native.LIB_PATH.parent.name == "native" and native.LIB_PATH.parent.parent.name == "build"
    after = (hashlib.sha256(open(lib, "rb").read()).hexdigest(), os.stat(lib).st_mtime_ns)
    assert after == before
    assert sorted(os.listdir(os.path.join(ROOT, "native"))) == listing


# -- the store (tests/test_pipeline.py, TestEncryptedStorage) ------------------


def test_save_load_roundtrip(tmp_path):
    store = EncryptedDocumentStore(str(tmp_path / "docs"))
    doc = make_doc("a", meta={"lang": "en"})
    store.save(doc)
    back = store.load("a")
    assert back.doc_id == "a"
    assert (back.ct_data == doc.ct_data).all()
    assert back.metadata == {"lang": "en"}
    ct = back.ciphertext(device="cpu")
    assert ct.level == 2 and ct.data.dtype == torch.uint32
    assert (ct.data.numpy() == doc.ct_data).all()


def test_validation_rejects_bad_dim():
    doc = make_doc("a")
    doc.dim = 100
    with pytest.raises(ValueError, match="dim"):
        doc.validate()


def test_metadata_search(tmp_path):
    store = EncryptedDocumentStore(str(tmp_path / "docs"))
    store.save(make_doc("a", meta={"lang": "en"}))
    store.save(make_doc("b", meta={"lang": "de"}))
    store.save(make_doc("c", meta={"lang": "en"}))
    assert store.search_by_metadata(lang="en") == ["a", "c"]


def test_delete_and_stats(tmp_path):
    store = EncryptedDocumentStore(str(tmp_path / "docs"))
    store.save(make_doc("a"))
    store.save(make_doc("b"))
    assert store.delete("a") is True
    assert store.delete("a") is False
    stats = store.get_stats()
    assert stats["document_count"] == 1
    assert stats["total_size_bytes"] > 0


def test_corruption_detected(tmp_path):
    store = EncryptedDocumentStore(str(tmp_path / "docs"))
    store.save(make_doc("a"))
    store.save(make_doc("b"))
    path = store._doc_path("a")
    raw = bytearray(path.read_bytes())
    raw[100] ^= 0xFF
    path.write_bytes(bytes(raw))
    valid, invalid = store.validate_all()
    assert valid == ["b"] and invalid == ["a"]


def test_index_survives_restart(tmp_path):
    EncryptedDocumentStore(str(tmp_path / "docs")).save(make_doc("a"))
    assert EncryptedDocumentStore(str(tmp_path / "docs")).list_documents() == ["a"]


def test_store_export_load_arena(tmp_path):
    store = EncryptedDocumentStore(str(tmp_path / "docs"))
    for d in ("a", "b", "c"):
        store.save(make_doc(d))
    ids, path = store.export_arena()
    assert ids == ["a", "b", "c"]
    ids2, view = store.load_arena()
    assert ids2 == ids and view.shape[0] == 3
    assert (np.asarray(view[1]) == store.load("b").ct_data).all()


def test_arena_is_current_tracks_rewrites(tmp_path):
    """Rewriting a document under its id (as re-keying does) makes the arena
    stale although its id list still matches; an arena without a signature
    (the JAX package writes none) is never taken as current."""
    store = EncryptedDocumentStore(str(tmp_path / "docs"))
    for d in ("a", "b"):
        store.save(make_doc(d))
    assert not store.arena_is_current()
    store.export_arena()
    assert store.arena_is_current()
    doc = store.load("b")
    doc.ct_data = doc.ct_data ^ np.uint32(1)
    store.save(doc)
    assert store.load_arena()[0] == ["a", "b"] and not store.arena_is_current()
    store.export_arena()
    assert store.arena_is_current()
    store.arena_sig_path.unlink()
    assert not store.arena_is_current()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_store_crosses_packages(tmp_path, writer):
    """A store and its arena written by either package read in the other:
    the same index, the same files byte for byte, the same ciphertexts."""
    w_store, w_doc = ((jax_store.EncryptedDocumentStore, jax_store.EncryptedDocument)
                      if writer == "jax" else (EncryptedDocumentStore, EncryptedDocument))
    wdir = str(tmp_path / "docs")
    store = w_store(wdir)
    docs = [make_doc(d, meta={"i": i}, cls=w_doc) for i, d in enumerate(("a", "b", "c"))]
    for d in docs:
        store.save(d, flush=False)
    store.flush_index()
    store.export_arena()
    for reader in (jax_store.EncryptedDocumentStore(wdir), EncryptedDocumentStore(wdir)):
        assert reader.list_documents() == ["a", "b", "c"]
        assert reader.search_by_metadata(i=1) == ["b"]
        for d in docs:
            back = reader.load(d.doc_id)
            assert (back.ct_data == d.ct_data).all() and back.metadata == d.metadata
            assert back.to_bytes() == d.to_bytes()
            assert reader._doc_path(d.doc_id) == store._doc_path(d.doc_id)
        ids, view = reader.load_arena()
        assert ids == ["a", "b", "c"]
        assert (np.asarray(view) == np.stack([d.ct_data for d in docs])).all()
        assert reader.validate_all() == (["a", "b", "c"], [])
    arena = os.path.join(wdir, "search.arena")
    assert native.arena_validate(arena) == jax_native.arena_validate(arena) == (3, None)
