"""Text embedders: a PyTorch BERT when weights are available, a
deterministic hashing projection otherwise.

Both offer `get_embedding(text, pooling)`, `get_embeddings_batch(texts,
batch_size)` and `compute_similarity`, with max_length truncation.

The hashing embedder maps each token to a unit Gaussian vector derived
from a BLAKE2 hash of the token (a random projection of the bag of
words), then pools.  It is deterministic, needs no downloaded weights,
preserves token-overlap similarity, and gives the same embeddings as the
JAX package's bit for bit.  Without weights on disk (no network) it is
what `make_embedder` returns.
"""

from __future__ import annotations

import hashlib
import logging
import os
import re
from typing import List

import numpy as np
import torch

from ..devices import target

logger = logging.getLogger(__name__)

_TOKEN_RE = re.compile(r"[a-z0-9]+")


class HashingEmbedder:
    """Deterministic 768-dim bag-of-words random-projection embedder."""

    dim = 768

    def __init__(self, max_length: int = 100):
        self.max_length = min(max_length, 512)
        self._cache: dict = {}

    def _token_vec(self, tok: str) -> np.ndarray:
        v = self._cache.get(tok)
        if v is None:
            seed = int.from_bytes(
                hashlib.blake2b(tok.encode(), digest_size=8).digest(), "little")
            v = np.random.default_rng(seed).standard_normal(self.dim)
            v /= np.linalg.norm(v)
            self._cache[tok] = v
        return v

    def tokenize(self, text: str) -> List[str]:
        return _TOKEN_RE.findall(text.lower())[: self.max_length]

    def get_embedding(self, text: str, pooling: str = "mean") -> np.ndarray:
        toks = self.tokenize(text)
        if not toks:
            return np.zeros(self.dim, dtype=np.float32)
        vecs = np.stack([self._token_vec(t) for t in toks])
        if pooling == "mean":
            out = vecs.mean(axis=0)
        elif pooling == "max":
            out = vecs.max(axis=0)
        elif pooling == "cls":        # no CLS token here; first-token proxy
            out = vecs[0]
        else:
            raise ValueError(f"unknown pooling {pooling!r}")
        return out.astype(np.float32)

    def get_embeddings_batch(self, texts: List[str], batch_size: int = 8,
                             pooling: str = "mean") -> np.ndarray:
        return np.stack([self.get_embedding(t, pooling) for t in texts])

    @staticmethod
    def compute_similarity(e1: np.ndarray, e2: np.ndarray) -> float:
        n1, n2 = np.linalg.norm(e1), np.linalg.norm(e2)
        if n1 == 0 or n2 == 0:
            return 0.0
        return float(np.dot(e1, e2) / (n1 * n2))


class BertEmbedder:
    """`bert-base-uncased` (PyTorch `transformers.BertModel`) on a device,
    with attention-mask-correct mean pooling, or cls / max pooling, over
    the last hidden state.

    Needs the weights on disk (FHE_ALLOW_DOWNLOAD=1 lets the hub fetch
    them) and raises at construction otherwise; a tokenizer and model can
    be injected instead.  `transformers` is imported only here.
    """

    dim = 768

    def __init__(self, model_name: str = "bert-base-uncased",
                 max_length: int = 100, tokenizer=None, model=None,
                 device: torch.device | str = "cuda"):
        self.device = target(device, "BertEmbedder")
        self.max_length = min(max_length, 512)
        if tokenizer is not None and model is not None:
            self.tokenizer = tokenizer
            self.model = model
        else:
            from transformers import AutoTokenizer, BertModel  # lazy
            # Cached weights only by default: a machine without network
            # access would otherwise spend its time in the hub's retries.
            local_only = os.environ.get("FHE_ALLOW_DOWNLOAD") != "1"
            self.tokenizer = AutoTokenizer.from_pretrained(
                model_name, local_files_only=local_only)
            self.model = BertModel.from_pretrained(model_name, local_files_only=local_only)
        self.model = self.model.to(self.device).eval()
        self.dim = int(self.model.config.hidden_size)

    def _forward(self, texts: List[str]):
        enc = self.tokenizer(texts, padding="max_length", truncation=True,
                             max_length=self.max_length, return_tensors="np")
        with torch.no_grad():
            out = self.model(
                input_ids=torch.as_tensor(enc["input_ids"], device=self.device),
                attention_mask=torch.as_tensor(enc["attention_mask"], device=self.device))
        return out.last_hidden_state.float().cpu().numpy(), enc["attention_mask"]

    def get_embedding(self, text: str, pooling: str = "mean") -> np.ndarray:
        return self.get_embeddings_batch([text], pooling=pooling)[0]

    def get_embeddings_batch(self, texts: List[str], batch_size: int = 8,
                             pooling: str = "mean") -> np.ndarray:
        outs = []
        for i in range(0, len(texts), batch_size):
            hidden, mask = self._forward(texts[i: i + batch_size])
            if pooling == "mean":
                m = mask[..., None].astype(np.float32)
                pooled = (hidden * m).sum(1) / np.maximum(m.sum(1), 1e-9)
            elif pooling == "cls":
                pooled = hidden[:, 0]
            elif pooling == "max":
                pooled = np.where(mask[..., None] > 0, hidden, -1e9).max(1)
            else:
                raise ValueError(f"unknown pooling {pooling!r}")
            outs.append(pooled)
        return np.concatenate(outs).astype(np.float32)

    compute_similarity = staticmethod(HashingEmbedder.compute_similarity)


def make_embedder(model_name: str = "bert-base-uncased", max_length: int = 100,
                  prefer_bert: bool = True, device: torch.device | str = "cuda"):
    """Best available embedder: BERT on `device` if its weights load, else hashing."""
    if prefer_bert:
        try:
            return BertEmbedder(model_name, max_length, device=device)
        except Exception as e:  # no weights / no network / no device
            logger.info("BERT weights unavailable (%s); "
                        "using deterministic hashing embedder", e)
    return HashingEmbedder(max_length)
