"""One-command BERT embedding-parity check of the port's embedder.

The reference's production embedder is PyTorch `bert-base-uncased` with
attention-mask-correct mean pooling over the last hidden state; the port's
is `models/embedder.BertEmbedder`, the same model on `device` (the card by
default).  With the weights on disk, one command

    python -m fhe_icp_tpu_torch.models.bert_parity

embeds the fixed sentence battery below with the port's embedder and with
the reference's path (`_torch_mean_pooled`, on the CPU), and reports:

* parity — max elementwise |port - reference| over the pooled embeddings
  < 1e-3 and pairwise-cosine-matrix agreement < 1e-5 (the same weights
  run on both sides, so a gap is a fault of the port's pooling or masking,
  or of the card's arithmetic);
* pipeline quality — PCA 768 -> 128 similarity preservation on the
  battery, beside the reference's reported 87.49 % (PCA) / 78.47 %
  (random projection).

The battery is pinned by checksum (SENTENCES_SHA256) and the report
records a fingerprint of the weight files used.  The checkpoint holds
PyTorch weights (`model.safetensors` or `pytorch_model.bin`); a directory
of injected tiny weights runs the harness where `bert-base-uncased` is not
on disk.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
from typing import List

import numpy as np
import torch

from ..devices import target

SENTENCES: List[str] = [
    "The quick brown fox jumps over the lazy dog.",
    "A fast brown fox leaps over a lazy dog.",
    "The lazy dog sleeps while the brown fox jumps.",
    "Quantum computing uses superposition and entanglement.",
    "Entanglement and superposition power quantum computers.",
    "Homomorphic encryption allows computing on encrypted data.",
    "Fully homomorphic encryption evaluates circuits over ciphertexts.",
    "The stock market fell sharply amid inflation fears.",
    "Investors sold equities as inflation worries deepened.",
    "She planted tomatoes and basil in the garden this spring.",
    "Basil and tomatoes were planted in her spring garden.",
    "The committee approved the budget after a long debate.",
    "After lengthy discussion, the panel passed the spending plan.",
    "Photosynthesis converts sunlight into chemical energy in plants.",
    "Neural networks learn hierarchical representations from data.",
    "The recipe calls for two cups of flour and one egg.",
]

SENTENCES_SHA256 = hashlib.sha256("\n".join(SENTENCES).encode()).hexdigest()


def _load(model_name: str):
    """(tokenizer, BertModel on the CPU) from a hub name or a checkpoint
    directory with PyTorch weights."""
    from transformers import AutoTokenizer, BertModel
    local_only = os.environ.get("FHE_ALLOW_DOWNLOAD") != "1"
    tok = AutoTokenizer.from_pretrained(model_name, local_files_only=local_only)
    model = BertModel.from_pretrained(model_name, local_files_only=local_only)
    return tok, model.eval()


def _torch_mean_pooled(model_name: str, texts: List[str], max_length: int = 100) -> np.ndarray:
    """The reference's path: a PyTorch forward on the CPU, dynamic padding,
    attention-mask-correct mean pooling."""
    tok, model = _load(model_name)
    enc = tok(texts, padding=True, truncation=True, max_length=max_length,
              return_tensors="pt")
    with torch.no_grad():
        out = model(**enc)
    hidden = out.last_hidden_state                      # (B, T, H)
    mask = enc["attention_mask"].unsqueeze(-1).float()
    pooled = (hidden * mask).sum(1) / mask.sum(1).clamp(min=1e-9)
    return pooled.numpy().astype(np.float32)


def _weights_fingerprint(model_name: str) -> str:
    """SHA-256 over the resolved checkpoint file(s), or "unavailable"."""
    try:
        from transformers.utils import cached_file
    except ImportError:
        return "unavailable"
    h, found = hashlib.sha256(), False
    for cand in ("model.safetensors", "pytorch_model.bin"):
        try:
            path = cached_file(model_name, cand, local_files_only=True)
        except (OSError, ValueError):
            continue
        if path:
            found = True
            with open(path, "rb") as f:
                for chunk in iter(lambda: f.read(1 << 20), b""):
                    h.update(chunk)
    return h.hexdigest() if found else "unavailable"


def _cos_matrix(x: np.ndarray) -> np.ndarray:
    n = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-9)
    return n @ n.T


def port_embedder(model_name: str, device: torch.device | str = "cuda"):
    """The port's BertEmbedder on `device` over the checkpoint's weights."""
    from .embedder import BertEmbedder
    device = target(device, "run_parity")
    tok, model = _load(model_name)
    return BertEmbedder(tokenizer=tok, model=model, device=device)


def run_parity(model_name: str = "bert-base-uncased",
               device: torch.device | str = "cuda") -> dict:
    """The parity battery: the port's embedder on `device` against the
    reference's path on the CPU.  Needs the weights on disk (or
    FHE_ALLOW_DOWNLOAD=1 on a connected machine)."""
    emb = port_embedder(model_name, device).get_embeddings_batch(SENTENCES)
    ref = _torch_mean_pooled(model_name, SENTENCES)
    return evaluate(emb, ref, fingerprint=_weights_fingerprint(model_name), device=device)


def evaluate(emb: np.ndarray, torch_emb: np.ndarray, fingerprint: str = "injected",
             device: torch.device | str = "cuda") -> dict:
    """Compare two embedding matrices of the battery: parity, and PCA
    quality with reducers fitted on `device`."""
    from .reduction import DimensionReducer

    max_abs = float(np.max(np.abs(emb - torch_emb)))
    cos_gap = float(np.max(np.abs(_cos_matrix(emb) - _cos_matrix(torch_emb))))
    dim = min(128, emb.shape[0], emb.shape[1])
    pca = DimensionReducer(dim, method="pca", device=device).fit(emb)
    rnd = DimensionReducer(dim, method="random", device=device).fit(emb)
    return {
        "sentences_sha256": SENTENCES_SHA256,
        "weights_fingerprint_sha256": fingerprint,
        "max_abs_embedding_diff": max_abs,
        "max_abs_cosine_diff": cos_gap,
        "framework_parity_ok": bool(max_abs < 1e-3 and cos_gap < 1e-5),
        "pca_dim": dim,
        "pca_similarity_preservation": round(pca.similarity_preservation(emb), 4),
        "random_similarity_preservation": round(rnd.similarity_preservation(emb), 4),
        "reference_baseline": {"pca": 0.8749, "random": 0.7847,
                               "source": "the reference's published results"},
    }


def main(argv=None) -> int:
    """Run the battery on the card; exit 0 on parity, 1 on a gap, 2 without weights."""
    model_name = (argv if argv is not None else sys.argv[1:]) or ["bert-base-uncased"]
    try:
        report = run_parity(model_name[0])
    except (OSError, ValueError, RuntimeError, ImportError) as e:
        print(json.dumps({
            "error": f"{type(e).__name__}: {e}",
            "hint": "bert-base-uncased weights not on disk, or no card; pre-populate "
                    "the HF cache (or set FHE_ALLOW_DOWNLOAD=1 on a connected machine) "
                    "and run again on a machine with CUDA",
            "sentences_sha256": SENTENCES_SHA256}))
        return 2
    print(json.dumps(report, indent=2))
    return 0 if report["framework_parity_ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
