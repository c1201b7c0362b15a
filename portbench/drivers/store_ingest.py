"""Ingestion of new texts into an on-disk encrypted store.

Set-up makes a fresh key directory and store under `TMPDIR`, keys from
the seed (`FHEKeyManager.generate_keys`), a `BatchProcessor` with the
configuration's batch settings and the hashing embedder, and ingests a
first call of texts, which fits and saves the store's reducer.  Each
request is one `BatchProcessor.encrypt_documents` call of new seeded
texts: embed, reduce, quantize, encrypt both encodings, write each
document's file and the index.  The answer is the stored ids.

The reference (`reference/text.py`, `reference/bgv.py`) follows the
program from two pieces of its state, the store's fitted reducer
(`reducer.npz`) and the key set's secret key, and checks each by itself:
the reducer against the reference's own float64 PCA of the set-up's texts
(its mean, and the subspace its components span), the key by decrypting.
It embeds the sampled texts again, reduces them with the store's reducer
in float64, quantizes, and decrypts a seeded sample of the window's stored
files: both encodings must decrypt exactly to one vector and zeros beyond
it, and that vector must be the reference's.

The control (`control`) takes the program's place whole: it fits its own
reducer in bfloat16 and saves it where the store keeps its reducer, and
writes each document as a file of the store's form whose trivial
ciphertexts hold its bfloat16 vector, so that `check` judges it as it
judges the program.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import sys
import tempfile

import numpy as np

from portbench.harness import Check, sync
from portbench.reference import bgv, text
from portbench.traffic import generate as gen

from fhe_icp_tpu_torch.batch import BatchConfig, BatchProcessor
from fhe_icp_tpu_torch.keymgr import FHEKeyManager
from fhe_icp_tpu_torch.models.embedder import HashingEmbedder

PASSWORD = "portbench-master-password"
# Limits, each set between the program's readings and the control's
# (PERF.md): the reducer's mean and its subspace against the reference's
# float64 PCA of its fit texts, and the shares of coordinates that differ
# from the reference's, over the sample and in its worst document.
MEAN_GAP_LIMIT = 3e-5
SUBSPACE_GAP_LIMIT = 5e-4
MEAN_MISMATCH_LIMIT = 0.01
WORST_MISMATCH_LIMIT = 0.05


class State:
    pass


def setup(cell):
    cfg, mix, dev = cell.config, cell.mix, cell.device
    st = State()
    st.cell, st.d, st.scale = cell, cfg["target_dim"], cfg["scale"]
    st.t = cfg["plaintext_modulus"]
    st.base = tempfile.mkdtemp(prefix="portbench-ingest-")
    os.environ["FHE_MASTER_PASSWORD"] = PASSWORD
    keys, store = os.path.join(st.base, "keys"), os.path.join(st.base, "docs")
    FHEKeyManager(keys, preset=cfg["preset"], device=dev).generate_keys(
        key_id="portbench", seed=gen.stream_seed(cell.seed, "keys"))
    st.proc = BatchProcessor(config=BatchConfig(**cfg["batch_config"]), storage_dir=store,
                             key_dir=keys, preset=cfg["preset"], target_dim=st.d,
                             embedder=HashingEmbedder(), device=dev)
    st.secret = st.proc.runtime.keys.sk.s.cpu().numpy().astype(np.int64)
    st.sample_texts = gen.text_sampler(gen.vocabulary(mix["vocab_seed"], mix["vocab_size"]),
                                       mix["zipf_s"], mix["min_words"], mix["max_words"])
    st.fit_texts = st.sample_texts(gen.numpy_rng(cell.seed, "fit"), mix["fit_texts"])
    st.proc.encrypt_documents(st.fit_texts)
    sync(dev)
    return st


def request(st, i: int) -> list:
    return st.sample_texts(gen.numpy_rng(st.cell.seed, f"request-{i}"),
                           st.cell.mix["texts_per_request"])


def serve(st, texts: list, tracer) -> list:
    with tracer.span("ingest.encrypt_documents"):
        return st.proc.encrypt_documents(texts)


def counts(st, answers) -> dict:
    return {"docs_stored": sum(len(a) for _, a in answers if a is not None)}


def release(st) -> None:
    st.proc = None


def _sample(st, answers) -> list:
    """(text, answer row) of a seeded sample of the window's documents."""
    docs = [(t, a, k) for texts, a in answers if a is not None
            for k, t in enumerate(texts)]
    n = min(len(docs), st.cell.mix["check_sample"])
    pick = gen.numpy_rng(st.cell.seed, "check").choice(len(docs), n, replace=False)
    return [docs[i] for i in sorted(pick)]


def _path(st, doc_id: str) -> str:
    return os.path.join(st.base, "docs", hashlib.sha256(doc_id.encode()).hexdigest()[:16] + ".enc")


def _stored_vectors(st, sample) -> tuple:
    """Decrypt each sampled document's stored file: (vectors (n, d); documents
    missing, stored under another id or text, or whose encodings decrypt to
    anything but one vector and zeros beyond it; documents whose two
    encodings disagree; the texts of the vectors)."""
    cts, bad, kept = [], 0, []
    for txt, ids, k in sample:
        doc_id = ids[k]
        try:
            z = np.load(_path(st, doc_id), allow_pickle=False)
            header = json.loads(bytes(z["header"]).decode())
            ct = z["ct"]
        except (OSError, ValueError, KeyError):
            bad += 1                       # never stored, or unreadable
            continue
        if header.get("doc_id") != doc_id or ct.shape != (4, ct.shape[1], st.secret.size) or \
                header.get("content_hash") != hashlib.sha256(txt.encode()).hexdigest():
            bad += 1
            continue
        cts.append(ct.reshape(2, 2, *ct.shape[1:]))
        kept.append(txt)
    if not cts:
        return np.zeros((0, st.d), dtype=np.int64), bad, 0, kept
    msg = bgv.decrypt(np.stack(cts), st.secret, st.t)           # (n, 2, N)
    fwd, rev = msg[:, 0], msg[:, 1]
    bad += int((np.abs(fwd[:, st.d:]).sum(1) + np.abs(rev[:, st.d:]).sum(1) > 0).sum())
    disagree = int((fwd[:, :st.d] != rev[:, st.d - 1::-1]).any(1).sum())
    return fwd[:, :st.d], bad, disagree, kept


def _reducer_path(st) -> str:
    return os.path.join(st.base, "docs", "reducer.npz")


def check(st, answers) -> list:
    """The store's reducer against the reference's PCA, then the sampled
    stored documents against the reference's vectors of their texts."""
    try:
        z = np.load(_reducer_path(st), allow_pickle=False)
        method, mean, comps = str(z["method"]), z["mean"], z["components"]
        got, bad, disagree, texts = _stored_vectors(st, _sample(st, answers))
        emb = text.Embedder()
        gaps = text.reducer_gaps(emb.embed(st.fit_texts), mean, comps)
        share = np.ones(1)
        if texts:
            want = text.vectors(emb.embed(texts), mean, comps, st.scale)
            share = (got != want).mean(axis=1)
            print(f"[portbench] ingest check: {len(texts)} documents, largest coordinate gap "
                  f"{int(np.abs(got - want).max())}; reducer {method}, {gaps}", file=sys.stderr)
        return [Check("bad_documents", bad + (method != "pca"), 0),
                Check("encodings_disagree", disagree, 0),
                Check("reducer_mean_gap", gaps["reducer_mean_gap"], MEAN_GAP_LIMIT),
                Check("reducer_subspace_gap", gaps["reducer_subspace_gap"], SUBSPACE_GAP_LIMIT),
                Check("mean_mismatch_share", float(share.mean()), MEAN_MISMATCH_LIMIT),
                Check("worst_doc_mismatch_share", float(share.max()), WORST_MISMATCH_LIMIT)]
    finally:
        shutil.rmtree(st.base, ignore_errors=True)


def control(st, texts: list) -> list:
    """The reference in the next lower precision in the program's place: a
    reducer fitted in bfloat16 and saved as the store's, each text's vector
    reduced in bfloat16, both encodings written as the store's files."""
    if not hasattr(st, "control_reducer"):
        st.control_reducer = text.pca_bf16(text.Embedder().embed(st.fit_texts), st.d)
        np.savez(_reducer_path(st), method="pca", mean=st.control_reducer[0],
                 components=st.control_reducer[1])
        st.control_docs = 0
    vec = text.vectors_bf16(text.Embedder().embed(texts), *st.control_reducer, st.scale)
    msg = np.zeros((len(texts), 2, st.secret.size), dtype=np.int64)
    msg[:, 0, :st.d], msg[:, 1, :st.d] = vec, vec[:, ::-1]
    cts = bgv.encrypt_trivial(msg, st.cell.config["limbs"])     # (n, 2, 2, L, N)
    ids = []
    for txt, ct in zip(texts, cts):
        doc_id = f"control-{st.control_docs}"
        st.control_docs += 1
        header = {"doc_id": doc_id, "content_hash": hashlib.sha256(txt.encode()).hexdigest()}
        with open(_path(st, doc_id), "wb") as f:
            np.savez(f, header=np.frombuffer(json.dumps(header).encode(), dtype=np.uint8),
                     ct=ct.reshape(4, *ct.shape[2:]))
        ids.append(doc_id)
    return ids
