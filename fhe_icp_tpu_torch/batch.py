"""BatchProcessor: embed -> reduce -> quantize -> encrypt -> store, plus
encrypted compare and search, on one device (the card by default).

`encrypt_documents` stores real RLWE ciphertexts, `compare_encrypted`
runs a ciphertext x ciphertext inner product, and `search_similar` scores
the whole store in one batched operation: below 64 documents a
ciphertext matvec, from 64 up the slot-packed search over the C++ arena
(`pack.pack_ciphertexts`, `mod_switch_to(2)`, the int8 operands and
`packed_scores`, i.e. kernels K1 and K2 on the card).

Each document is stored as TWO ciphertexts: the ascending ("fwd") and
reversed ("rev") coefficient encodings of its quantized embedding, so any
pair of documents can be compared fully under encryption (the inner
product of doc A's fwd encoding with doc B's rev encoding lands in one
coefficient of their product polynomial).

The store, keys and reducer are the JAX package's files: a store written
by either package is searched and compared by the other with the same
ids and scores.
"""

from __future__ import annotations

import gc
import hashlib
import logging
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .devices import target
from .interop import ciphertext_from_array
from .keymgr import FHEKeyManager
from .models.embedder import make_embedder
from .models.reduction import DimensionReducer
from .models.similarity import FHESimilarityModel
from .ops import arith, pack
from .ops.cipher import Ciphertext
from .store import EncryptedDocument, EncryptedDocumentStore
from .utils.profiling import span
from .utils.quantize import DEFAULT_SCALE, dequantize_score, prepare_embedding_for_fhe

logger = logging.getLogger(__name__)


@dataclass
class BatchConfig:
    batch_size: int = 10
    max_memory_mb: int = 4000
    checkpoint_interval: int = 50
    show_progress: bool = True
    force_gc: bool = True

    def __post_init__(self):
        if self.batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        if self.max_memory_mb < 100:
            raise ValueError("max_memory_mb must be >= 100")


class BatchProcessor:
    # Stores at least this large are searched through the packed arena path.
    PACKED_MIN_DOCS = 64

    def __init__(self, config: Optional[BatchConfig] = None,
                 storage_dir: str = "./encrypted_docs",
                 key_dir: str = "~/.fhe_keys",
                 preset: str = "pairwise-4096",
                 target_dim: int = 128,
                 reducer: Optional[DimensionReducer] = None,
                 embedder=None,
                 validate_model: bool = True,
                 device: torch.device | str = "cuda"):
        self.device = target(device, "BatchProcessor")
        self.config = config or BatchConfig()
        self.embedder = embedder or make_embedder(device=self.device)
        self.key_manager = FHEKeyManager(key_dir, preset=preset, device=self.device)
        self.storage = EncryptedDocumentStore(storage_dir)
        self.target_dim = target_dim
        self.scale = DEFAULT_SCALE
        self.reducer = reducer
        self.operand_source: Optional[str] = None    # "arena" or "documents"
        self._op_cache = None
        if self.reducer is None and self._reducer_path.exists():
            # Every process that opens a store must reduce with the SAME
            # projection its documents were encrypted under.
            self.reducer = DimensionReducer.load(self._reducer_path, device=self.device)
            logger.info("loaded persisted %s reducer from %s",
                        self.reducer.method, self._reducer_path)

        # Load (or create) keys and the runtime.
        if self.key_manager.get_current_key() is None:
            self.key_manager.generate_keys()
        self.runtime = self.key_manager.load_keyset()
        self.key_id = self.key_manager.get_current_key()

        self.fhe_model = FHESimilarityModel(input_dim=target_dim, preset=preset)
        self.fhe_model.train()
        self.fhe_model.compile(runtime=self.runtime)
        if validate_model:
            self._self_validate()

        try:
            import psutil
            self._proc = psutil.Process()
            self.initial_memory_mb = self._proc.memory_info().rss / 1e6
        except Exception:
            self._proc = None
            self.initial_memory_mb = 0.0

    def _self_validate(self) -> None:
        """Identical embeddings must score ~1.0 under real encryption
        (tolerance ±0.2): both encodings encrypted, the degree-2 encrypted
        dot, the exact decode."""
        rng = np.random.default_rng(0)
        e = rng.standard_normal(self.target_dim)
        q, _ = prepare_embedding_for_fhe(e, self.scale)
        rt = self.runtime
        ct_f = rt.encrypt_vector(q)
        ct_r = rt.encrypt_vector(q, rev=True)
        raw = int(rt.decrypt_dot(rt.dot_ct_ct(ct_f, ct_r, relinearize=False),
                                 self.target_dim))
        sim = dequantize_score(raw, self.scale)
        if abs(sim - 1.0) > 0.2:
            logger.warning("model self-validation: identical-pair "
                           "similarity %.4f outside 1.0±0.2", sim)
        else:
            logger.info("self-validation OK: identical-pair sim=%.4f", sim)

    # -- memory management -------------------------------------------------
    def _memory_mb(self) -> float:
        return self._proc.memory_info().rss / 1e6 if self._proc else 0.0

    def _check_memory(self) -> None:
        used = self._memory_mb()
        if used > self.config.max_memory_mb:
            logger.warning("memory %.0f MB over limit %d MB; forcing gc",
                           used, self.config.max_memory_mb)
            with span("ingest.gc"):
                gc.collect()

    # -- ingestion ---------------------------------------------------------
    # First-ingestion corpora at least target_dim large get a PCA reducer,
    # smaller ones the seeded random projection.  At most REDUCER_FIT_MAX
    # embeddings feed the fit (memory bound).
    REDUCER_FIT_MAX = 512

    @property
    def _reducer_path(self):
        return self.storage.dir / "reducer.npz"

    def _fit_reducer(self, embs: np.ndarray) -> None:
        """Fit + persist the store's reducer on the first ingested corpus.

        The fitted reducer is saved beside the store and reloaded by every
        later process.  A failed save is logged and ingestion goes on, as
        in the JAX package.
        """
        n = int(embs.shape[0])
        method = "pca" if n >= self.target_dim else "random"
        self.reducer = DimensionReducer(self.target_dim, method=method, device=self.device)
        self.reducer.fit(embs)
        detail = ""
        if n >= 3:
            sp = self.reducer.similarity_preservation(embs)
            detail = f", similarity preservation {sp:.4f}"
        try:
            self.reducer.save(self._reducer_path)
            where = f"; persisted to {self._reducer_path}"
        except OSError as e:
            where = f"; persist FAILED ({e})"
        logger.info("fitted %s reducer on %d embeddings%s%s",
                    method, n, detail, where)

    def _ensure_reducer(self, embs: np.ndarray) -> DimensionReducer:
        if self.reducer is None:
            # Query before any ingest: fit (and persist) on what is at hand.
            self._fit_reducer(embs)
        return self.reducer

    def _embed_reduce(self, texts: List[str]) -> np.ndarray:
        with span("ingest.embed"):
            embs = self.embedder.get_embeddings_batch(texts, batch_size=min(8, len(texts)))
        reducer = self._ensure_reducer(embs)
        with span("ingest.reduce"):
            return reducer.transform(embs)

    def encrypt_documents(self, texts: List[str],
                          doc_ids: Optional[List[str]] = None,
                          metadata: Optional[List[Dict]] = None,
                          resume: bool = False) -> List[str]:
        """Embed, reduce, quantize, RLWE-encrypt and store texts.

        With resume=True, documents whose id is already in the store with a
        matching content hash are skipped, so an interrupted ingestion
        restarts where it stopped.
        """
        if doc_ids is None:
            doc_ids = [f"doc_{hashlib.sha256(t.encode()).hexdigest()[:12]}" for t in texts]
        if metadata is None:
            metadata = [{} for _ in texts]
        if not len(doc_ids) == len(texts) == len(metadata):
            raise ValueError(f"{len(texts)} texts, {len(doc_ids)} ids, "
                             f"{len(metadata)} metadata entries")

        if resume:
            keep = []
            skipped = 0
            for i, doc_id in enumerate(doc_ids):
                if doc_id in self.storage.index:
                    try:
                        doc = self.storage.load(doc_id)
                        if doc.content_hash == hashlib.sha256(texts[i].encode()).hexdigest():
                            skipped += 1
                            continue
                    except Exception:
                        pass            # corrupt or missing: re-encrypt
                keep.append(i)
            if skipped:
                logger.info("resume: skipping %d already-encrypted docs", skipped)
            kept = set(keep)
            done_pre = [doc_ids[i] for i in range(len(doc_ids)) if i not in kept]
            texts = [texts[i] for i in keep]
            metadata = [metadata[i] for i in keep]
            doc_ids = [doc_ids[i] for i in keep]
            if not texts:
                return done_pre
        else:
            done_pre = []

        # First ingestion into a store: fit the reducer on the call's
        # leading corpus before any encryption (even when the store is not
        # empty but has no reducer, as in the JAX package).  The fit
        # embeddings are reduced once and reused below.
        pre_reduced: Dict[int, np.ndarray] = {}
        if self.reducer is None and texts:
            k = min(len(texts), self.REDUCER_FIT_MAX)
            with span("ingest.embed"):
                embs = self.embedder.get_embeddings_batch(texts[:k], batch_size=min(8, k))
            self._fit_reducer(embs)
            with span("ingest.reduce"):
                red = self.reducer.transform(embs)
            pre_reduced = {i: red[i] for i in range(k)}

        iterator = range(0, len(texts), self.config.batch_size)
        if self.config.show_progress:
            try:
                from tqdm import tqdm
                iterator = tqdm(list(iterator), desc="encrypt")
            except ImportError:
                pass

        done: List[str] = []
        for start in iterator:
            self._check_memory()
            batch = texts[start: start + self.config.batch_size]
            ids = doc_ids[start: start + self.config.batch_size]
            metas = metadata[start: start + self.config.batch_size]
            idxs = range(start, start + len(batch))
            missing = [i for i in idxs if i not in pre_reduced]
            if missing:
                pre_reduced.update(zip(missing, self._embed_reduce([texts[i] for i in missing])))
            reduced = np.stack([pre_reduced.pop(i) for i in idxs])
            with span("ingest.quantize"):
                quantized = np.stack([prepare_embedding_for_fhe(r, self.scale)[0]
                                      for r in reduced])
            with span("ingest.encrypt"):
                # seed=None: fresh randomness for every encryption.  Seeds from
                # doc ids would reuse (a, e) when changed content is
                # re-encrypted under the same ids (c0 - c0' = m - m' leaks).
                ct_fwd = self.runtime.encrypt_vector(quantized)
                ct_rev = self.runtime.encrypt_vector(quantized, rev=True)
                # fwd + rev stacked along the poly axis: (B, 4, L, N).
                data = torch.cat([ct_fwd.data, ct_rev.data], dim=1).cpu().numpy()
            now = time.time()
            for i, (doc_id, text, meta) in enumerate(zip(ids, batch, metas)):
                doc = EncryptedDocument(
                    doc_id=doc_id,
                    content_hash=hashlib.sha256(text.encode()).hexdigest(),
                    timestamp=now,
                    ct_data=data[i],
                    ct_level=ct_fwd.level,
                    dim=self.target_dim,
                    scale=self.scale,
                    key_id=self.key_id or "",
                    metadata=meta,
                )
                self.storage.save(doc, flush=False)
                done.append(doc_id)
            self.storage.flush_index()              # one index write a batch
            if self.config.force_gc and len(done) % self.config.checkpoint_interval == 0:
                with span("ingest.gc"):
                    gc.collect()
        logger.info("encrypted %d documents", len(done))
        return done_pre + done

    # -- key-id enforcement + homomorphic re-keying -------------------------
    def _check_key(self, doc_id: str, doc_key_id: str) -> None:
        """Hard error on a key mismatch instead of decrypting garbage:
        a wrong secret key yields random scores with no error signal."""
        if doc_key_id and self.key_id and doc_key_id != self.key_id:
            raise ValueError(
                f"document {doc_id!r} is encrypted under key "
                f"{doc_key_id!r} but the current key is {self.key_id!r}; "
                f"run rekey_store({doc_key_id!r}) to migrate it "
                f"(or `keys rotate`, which migrates automatically)")

    def rekey_store(self, old_key_id: str) -> int:
        """Re-encrypt every stored doc from old_key_id to the current key
        WITHOUT decrypting (arith.rekey keyswitch).  Returns #migrated."""
        n = rekey_documents(self.storage, self.key_manager, old_key_id, self.key_id)
        self._op_cache = None            # the packed operand is stale
        return n

    # -- encrypted compare (ct x ct) -----------------------------------------
    def _split_ct(self, doc: EncryptedDocument) -> Tuple[Ciphertext, Ciphertext]:
        ct = doc.ciphertext(self.device)
        return (Ciphertext(ct.data[:2], doc.ct_level, True),
                Ciphertext(ct.data[2:], doc.ct_level, True))

    def compare_encrypted(self, doc_id1: str, doc_id2: str) -> float:
        d1 = self.storage.load(doc_id1)
        d2 = self.storage.load(doc_id2)
        if d1.dim != d2.dim:
            raise ValueError(f"documents of dimension {d1.dim} and {d2.dim} do not compare")
        self._check_key(doc_id1, d1.key_id)
        self._check_key(doc_id2, d2.key_id)
        fwd1, _ = self._split_ct(d1)
        _, rev2 = self._split_ct(d2)
        # The degree-2 product decodes bit-identically and skips the
        # relinearization keyswitch (ops/dot.dot_ct_ct_deg2).
        score_ct = self.runtime.dot_ct_ct(fwd1, rev2, relinearize=False)
        raw = int(self.runtime.decrypt_dot(score_ct, d1.dim))
        return dequantize_score(raw, d1.scale)

    # -- encrypted search: one batched operation over the store ----------------
    def search_similar(self, query_text: str, top_k: int = 5,
                       min_similarity: float = 0.5) -> List[Tuple[str, float]]:
        doc_ids = self.storage.list_documents()
        if not doc_ids:
            return []
        q_emb = self.embedder.get_embedding(query_text)
        q_red = self._ensure_reducer(q_emb[None]).transform(q_emb)[0]
        q_int, _ = prepare_embedding_for_fhe(q_red, self.scale)

        first = self.storage.load(doc_ids[0])
        dim, level = first.dim, first.ct_level
        rt = self.runtime
        if len(doc_ids) >= self.PACKED_MIN_DOCS:
            # Slot-packed scoring (ops/pack.py) over the packed arena: S =
            # N/dim documents share one ciphertext, scored by K1.
            doc_ids, doc_op, n_docs, corr = self._search_operands(level)
            q_op = pack.make_packed_query_operand(rt.ctx, rt.keys.sk, torch.from_numpy(q_int),
                                                  dim, doc_op.level)
            raw = pack.packed_scores(rt.ctx, doc_op, q_op, corr).reshape(-1)[:n_docs]
        else:
            docs = [self.storage.load(d) for d in doc_ids]
            for d in docs:
                self._check_key(d.doc_id, d.key_id)
            batch = np.stack([d.ct_data[:2] for d in docs])          # (B, 2, L, N)
            cts = ciphertext_from_array(batch, level, device=self.device)
            raw = rt.decrypt_dot(rt.matvec(cts, q_int), dim)
        sims = raw.cpu().numpy().astype(np.int64) / float(self.scale * self.scale)
        order = np.argsort(-sims)
        return [(doc_ids[i], float(sims[i])) for i in order
                if sims[i] >= min_similarity][:top_k]

    def _search_operands(self, level: int):
        """(doc_ids, packed DocOperand, n_docs, pt_corr) for the whole store,
        cached per store-content signature.

        Read from the C++ arena, exported again unless it is current
        (`store.arena_is_current`); from per-document loads if the native
        codec fails, as in the JAX package (`operand_source` says which).
        The per-doc fwd ciphertexts are slot-packed homomorphically
        (noise-free monomial multiplies + adds) and switched down to 2
        limbs, so the operand is S = N/dim * L/2 times smaller than the
        store.  K1 takes any group count, so the operand is not padded.
        """
        ids = self.storage.list_documents()
        for doc_id in ids:
            self._check_key(doc_id, self.storage.index[doc_id].get("key_id", ""))
        sig = (tuple(ids), tuple(sorted((d, e["sha256"]) for d, e in self.storage.index.items())))
        cached = self._op_cache
        if cached is not None and cached[0] == sig:
            return cached[1], cached[2], cached[3], cached[4]
        try:
            arena_ids = None
            if self.storage.arena_is_current():
                arena_ids, view = self.storage.load_arena()
            if arena_ids != ids:
                self.storage.export_arena()
                arena_ids, view = self.storage.load_arena()
            batch = np.ascontiguousarray(view[:, :2])                # fwd ciphertexts
            self.operand_source = "arena"
        except Exception as e:
            logger.warning("arena unavailable (%s); loading documents one by one", e,
                           exc_info=True)
            arena_ids = ids
            batch = np.stack([self.storage.load(d).ct_data[:2] for d in ids])
            self.operand_source = "documents"
        ctx = self.runtime.ctx
        packed = pack.pack_ciphertexts(ctx, torch.from_numpy(batch).to(self.device),
                                       self.target_dim, level)
        ct = arith.mod_switch_to(ctx, Ciphertext(packed, level, True), min(2, level))
        doc_op = pack.make_packed_doc_operand(ctx, ct.data, ct.level, pad_groups_to=1)
        self._op_cache = (sig, arena_ids, doc_op, len(arena_ids), ct.pt_corr)
        return arena_ids, doc_op, len(arena_ids), ct.pt_corr

    # -- stats ---------------------------------------------------------------
    def get_memory_stats(self) -> Dict:
        current = self._memory_mb()
        return {
            "initial_mb": self.initial_memory_mb,
            "current_mb": current,
            "used_mb": current - self.initial_memory_mb,
            "limit_mb": self.config.max_memory_mb,
        }


def rekey_documents(storage: EncryptedDocumentStore, key_manager: FHEKeyManager,
                    old_key_id: str, new_key_id: Optional[str] = None,
                    batch_size: int = 64) -> int:
    """Homomorphically migrate every doc under old_key_id to new_key_id.

    Each stored ciphertext (fwd + rev pair) is keyswitched old_s -> new_s
    (arith.rekey) on the key manager's device: the plaintext is never
    exposed, only additive keyswitch noise is paid.  Used by `keys rotate`
    and BatchProcessor.rekey_store.  Returns the number of migrated docs.
    """
    new_key_id = new_key_id or key_manager.get_current_key()
    ids = [d for d in storage.list_documents()
           if storage.index[d].get("key_id") == old_key_id]
    if not ids:
        return 0
    ksks = key_manager.load_rekey_key(old_key_id, new_key_id)
    ctx = key_manager.load_keyset(new_key_id).ctx

    done = 0
    for start in range(0, len(ids), batch_size):
        chunk = [storage.load(d) for d in ids[start: start + batch_size]]
        by_level: Dict[int, list] = {}
        for doc in chunk:
            by_level.setdefault(doc.ct_level, []).append(doc)
        for level, group in by_level.items():
            ksk = ksks.get(level)
            if ksk is None:
                raise ValueError(f"no rekey key for level {level} (available: {sorted(ksks)})")
            data = np.stack([d.ct_data for d in group])            # (B, 2k, L, N)
            b, k2 = data.shape[:2]
            pairs = ciphertext_from_array(data.reshape(b * (k2 // 2), 2, level, ctx.n), level,
                                          device=key_manager.device)
            out = arith.rekey(ctx, ksk, pairs).data.cpu().numpy().reshape(b, k2, level, ctx.n)
            for i, doc in enumerate(group):
                doc.ct_data = out[i]
                doc.key_id = new_key_id
                storage.save(doc, flush=False)
                done += 1
        storage.flush_index()                       # one index write a batch
    logger.info("re-keyed %d documents %s -> %s", done, old_key_id, new_key_id)
    return done
