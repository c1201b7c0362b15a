"""Encrypted document store: real ciphertexts on disk + JSON index.

Each document is one compressed npz file (`sha256(doc_id)[:16].enc`)
holding a JSON header (format 1) and the (k, L, N) uint32 RLWE ciphertext
of its quantized embedding; `index.json` maps ids to files, sizes,
SHA-256 digests and metadata and is rewritten atomically.  No pickle.
`search.arena` (C++ codec, `native.py`) packs every ciphertext of the
store into one mmap-able file for the search path, with its id list in
`search.arena.ids`.

The format is the JAX package's: a store written by either package reads
in the other.  Files hold numpy arrays; `EncryptedDocument.ciphertext`
gives the port's Ciphertext on a device.
"""

from __future__ import annotations

import hashlib
import io
import json
import logging
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch

from .interop import ciphertext_from_array
from .ops.cipher import Ciphertext

logger = logging.getLogger(__name__)

_FORMAT_VERSION = 1


@dataclass
class EncryptedDocument:
    doc_id: str
    content_hash: str                   # SHA-256 of the source text
    timestamp: float
    ct_data: np.ndarray                 # (k, L, N) uint32 RLWE ciphertext
    ct_level: int
    dim: int                            # embedding dimension (e.g. 128)
    scale: int                          # quantization scale (1000 contract)
    model_version: str = "v1"
    key_id: str = ""
    metadata: Dict = field(default_factory=dict)

    def validate(self) -> None:
        if self.ct_data.dtype != np.uint32 or self.ct_data.ndim != 3:
            raise ValueError("ciphertext must be (k, L, N) uint32")
        if self.dim not in (16, 32, 64, 128, 256):
            raise ValueError(f"unsupported embedding dim {self.dim}")
        if len(self.content_hash) != 64:
            raise ValueError("content_hash must be SHA-256 hex")

    def ciphertext(self, device: torch.device | str = "cuda") -> Ciphertext:
        """The stored (k, L, N) ciphertext on `device` (the card by default)."""
        return ciphertext_from_array(self.ct_data, self.ct_level, device=device)

    # -- bytes round-trip (pickle-free) -------------------------------------
    def to_bytes(self) -> bytes:
        buf = io.BytesIO()
        header = {
            "format": _FORMAT_VERSION, "doc_id": self.doc_id,
            "content_hash": self.content_hash, "timestamp": self.timestamp,
            "ct_level": self.ct_level, "dim": self.dim, "scale": self.scale,
            "model_version": self.model_version, "key_id": self.key_id,
            "metadata": self.metadata,
        }
        np.savez_compressed(buf, header=np.frombuffer(
            json.dumps(header).encode(), dtype=np.uint8), ct=self.ct_data)
        return buf.getvalue()

    @classmethod
    def from_bytes(cls, raw: bytes) -> "EncryptedDocument":
        z = np.load(io.BytesIO(raw), allow_pickle=False)
        header = json.loads(bytes(z["header"]).decode())
        if header.get("format") != _FORMAT_VERSION:
            raise ValueError(f"unknown format {header.get('format')}")
        doc = cls(
            doc_id=header["doc_id"], content_hash=header["content_hash"],
            timestamp=header["timestamp"], ct_data=z["ct"],
            ct_level=header["ct_level"], dim=header["dim"],
            scale=header["scale"], model_version=header["model_version"],
            key_id=header["key_id"], metadata=header["metadata"],
        )
        doc.validate()
        return doc


class EncryptedDocumentStore:
    """Per-document .enc files + index.json."""

    def __init__(self, storage_dir: str = "./encrypted_docs"):
        self.dir = Path(storage_dir).expanduser()
        self.dir.mkdir(parents=True, exist_ok=True)
        self.index_path = self.dir / "index.json"
        self.index: Dict[str, Dict] = {}
        if self.index_path.exists():
            self.index = json.loads(self.index_path.read_text())

    def _flush_index(self) -> None:
        # Atomic: a temp file then a rename, so a crash mid-write never
        # corrupts the whole index.
        tmp = self.index_path.with_suffix(".json.tmp")
        tmp.write_text(json.dumps(self.index, indent=2))
        os.replace(tmp, self.index_path)

    def _doc_path(self, doc_id: str) -> Path:
        safe = hashlib.sha256(doc_id.encode()).hexdigest()[:16]
        return self.dir / f"{safe}.enc"

    def save(self, doc: EncryptedDocument, flush: bool = True) -> None:
        """Persist one document.  Batch writers pass flush=False and call
        flush_index() once per batch: index.json is rewritten whole on
        every flush, so per-document flushing is O(n^2) over an ingest."""
        doc.validate()
        raw = doc.to_bytes()
        path = self._doc_path(doc.doc_id)
        path.write_bytes(raw)
        self.index[doc.doc_id] = {
            "file": path.name,
            "size_bytes": len(raw),
            "sha256": hashlib.sha256(raw).hexdigest(),
            "timestamp": doc.timestamp,
            "dim": doc.dim,
            "key_id": doc.key_id,
            "metadata": doc.metadata,
        }
        if flush:
            self._flush_index()

    def flush_index(self) -> None:
        """Atomically persist the index (see save(flush=False))."""
        self._flush_index()

    def load(self, doc_id: str) -> EncryptedDocument:
        if doc_id not in self.index:
            raise KeyError(f"document {doc_id!r} not found")
        raw = self._doc_path(doc_id).read_bytes()
        entry = self.index[doc_id]
        if hashlib.sha256(raw).hexdigest() != entry["sha256"]:
            raise ValueError(f"integrity check failed for {doc_id!r}")
        return EncryptedDocument.from_bytes(raw)

    def delete(self, doc_id: str) -> bool:
        if doc_id not in self.index:
            return False
        self._doc_path(doc_id).unlink(missing_ok=True)
        del self.index[doc_id]
        self._flush_index()
        return True

    def list_documents(self) -> List[str]:
        return sorted(self.index)

    def search_by_metadata(self, **criteria) -> List[str]:
        out = []
        for doc_id, entry in self.index.items():
            md = entry.get("metadata", {})
            if all(md.get(k) == v for k, v in criteria.items()):
                out.append(doc_id)
        return sorted(out)

    def get_stats(self) -> Dict:
        sizes = [e["size_bytes"] for e in self.index.values()]
        return {
            "document_count": len(self.index),
            "total_size_bytes": int(sum(sizes)),
            "avg_size_bytes": float(np.mean(sizes)) if sizes else 0.0,
            "storage_dir": str(self.dir),
        }

    # -- packed search index (C++ arena codec, native.py) -------------------
    def content_signature(self) -> str:
        """SHA-256 over the sorted (doc_id, file SHA-256) pairs of the index:
        it changes whenever a document is added, removed or rewritten."""
        pairs = sorted((d, e["sha256"]) for d, e in self.index.items())
        return hashlib.sha256(json.dumps(pairs).encode()).hexdigest()

    @property
    def arena_sig_path(self) -> Path:
        return self.dir / "search.arena.sig"

    def export_arena(self, path=None) -> Tuple[List[str], str]:
        """Pack every document's ciphertext into one mmap-able arena file.

        Returns (doc_ids in arena order, arena path).  Beside the arena go
        its id list (`search.arena.ids`) and the store's content signature
        at export (`search.arena.sig`).  Requires the native codec.
        """
        from . import native
        doc_ids = self.list_documents()
        if not doc_ids:
            raise ValueError("empty store")
        docs = [self.load(d) for d in doc_ids]
        shapes = {d.ct_data.shape for d in docs}
        if len(shapes) > 1:
            raise ValueError(f"inhomogeneous ciphertext shapes: {shapes}")
        arena = np.stack([d.ct_data for d in docs])
        path = str(path or (self.dir / "search.arena"))
        native.arena_write(path, arena)
        (self.dir / "search.arena.ids").write_text(json.dumps(doc_ids))
        self.arena_sig_path.write_text(self.content_signature())
        return doc_ids, path

    def arena_is_current(self) -> bool:
        """Whether the arena was exported from the store as it is now.

        An arena without a signature (as the JAX package writes it) is not
        known to be current: re-keying rewrites every document under the
        same ids, so the id list alone cannot tell.
        """
        sig = self.arena_sig_path
        return sig.exists() and sig.read_text() == self.content_signature()

    def load_arena(self, path=None) -> Tuple[List[str], np.ndarray]:
        """(doc_ids, zero-copy (B, k, L, N) view) from the packed index."""
        from . import native
        path = str(path or (self.dir / "search.arena"))
        doc_ids = json.loads((self.dir / "search.arena.ids").read_text())
        sample = self.load(doc_ids[0])
        view = native.arena_mmap(path, sample.ct_data.shape)
        if len(doc_ids) != view.shape[0]:
            raise ValueError("arena/id-list length mismatch")
        return doc_ids, view

    def validate_all(self) -> Tuple[List[str], List[str]]:
        """Load + integrity-check every doc -> (valid_ids, invalid_ids)."""
        valid, invalid = [], []
        for doc_id in self.list_documents():
            try:
                self.load(doc_id)
                valid.append(doc_id)
            except Exception as e:
                logger.warning("document %r failed validation: %s", doc_id, e)
                invalid.append(doc_id)
        return valid, invalid
