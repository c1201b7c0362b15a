"""fhe_icp_tpu_torch CLI: 8 subcommands, on the card.

    python -m fhe_icp_tpu_torch.cli [--storage-dir D] [--key-dir K] [--preset P] COMMAND

`keys {generate,list,rotate}`, `encrypt`, `encrypt-batch`, `compare`,
`search`, `stats`, `validate`, `estimate`: the JAX package's argument
surface and printed strings, including the score interpretation bands
(>0.9 / >0.7 / >0.5), search defaults top_k=5 and min_similarity=0.5,
and the ICP resource envelope.  `compare` and `search` run real
ciphertext arithmetic end to end.  Everything runs on the card; from
Python, `main(argv, device="cpu")` runs on the CPU instead.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time
from typing import Optional

import numpy as np
import torch

from .devices import target

logger = logging.getLogger("fhe_icp_tpu_torch.cli")

# ICP canister envelope.
ICP_MAX_MESSAGE_BYTES = 2 * 1024 * 1024
ICP_MAX_MEMORY_BYTES = 4 * 1024 * 1024 * 1024
ICP_MAX_INSTRUCTIONS = 5_000_000_000
ICP_CYCLES_PER_ENCRYPT = 1_000_000
ICP_CYCLES_PER_COMPARE = 500_000


def interpret_score(score: float) -> str:
    if score > 0.9:
        return "Very similar"
    if score > 0.7:
        return "Similar"
    if score > 0.5:
        return "Somewhat similar"
    return "Not very similar"


class FHEDocumentCLI:
    def __init__(self, storage_dir: str = "./encrypted_docs",
                 key_dir: str = "~/.fhe_keys",
                 preset: str = "pairwise-4096",
                 device: torch.device | str = "cuda"):
        self.device = target(device, "FHEDocumentCLI")
        self.storage_dir = storage_dir
        self.key_dir = key_dir
        self.preset = preset
        self._processor = None

    @property
    def processor(self):
        if self._processor is None:
            from .batch import BatchProcessor
            self._processor = BatchProcessor(
                storage_dir=self.storage_dir, key_dir=self.key_dir,
                preset=self.preset, device=self.device)
        return self._processor

    def _key_manager(self):
        from .keymgr import FHEKeyManager
        return FHEKeyManager(self.key_dir, preset=self.preset, device=self.device)

    # -- commands ----------------------------------------------------------
    def cmd_keys(self, args) -> int:
        km = self._key_manager()
        if args.action == "generate":
            key_id = km.generate_keys(args.key_id)
            print(f"Generated key: {key_id}")
        elif args.action == "list":
            for key_id in km.list_keys():
                info = km.key_info(key_id)
                cur = " (current)" if key_id == km.get_current_key() else ""
                print(f"{key_id}{cur}: {info['status']}, "
                      f"created {time.ctime(info['created_at'])}")
                print(f"    Size: {info['size_bytes'] / 1024 / 1024:.1f} MB")
        elif args.action == "rotate":
            old = km.get_current_key()
            new_id = km.rotate_keys(args.grace_days)
            print(f"Rotated to key: {new_id}")
            if old and not args.no_migrate:
                # Migrate the store homomorphically, so every stored
                # ciphertext stays usable under the NEW key.
                from .batch import rekey_documents
                from .store import EncryptedDocumentStore
                store = EncryptedDocumentStore(self.storage_dir)
                n = rekey_documents(store, km, old, new_id)
                if n:
                    print(f"Re-keyed {n} stored documents to {new_id}")
        return 0

    def cmd_encrypt(self, args) -> int:
        text = args.text
        if args.file:
            with open(args.file) as f:
                text = f.read()
        if not text:
            print("error: provide text or --file", file=sys.stderr)
            return 1
        # --tags land in metadata['tags'], then --metadata keys merge on top.
        metadata = {}
        if args.tags:
            metadata["tags"] = args.tags
        if args.metadata:
            metadata.update(json.loads(args.metadata))
        ids = self.processor.encrypt_documents(
            [text], doc_ids=[args.id] if args.id else None,
            metadata=[metadata] if metadata else None)
        print(f"Encrypted document: {ids[0]}")
        entry = self.processor.storage.index.get(ids[0], {})
        if "size_bytes" in entry:
            print(f"Size: {entry['size_bytes']} bytes")
        return 0

    def cmd_encrypt_batch(self, args) -> int:
        with open(args.file) as f:
            if args.file.endswith(".json"):
                docs = json.load(f)
                texts = [d["text"] for d in docs]
                ids = [d.get("id") for d in docs]
                ids = ids if all(ids) else None
            else:
                texts = [line.strip() for line in f if line.strip()]
                ids = None
        t0 = time.time()
        done = self.processor.encrypt_documents(texts, doc_ids=ids)
        dt = time.time() - t0
        print(f"Encrypted {len(done)} documents in {dt:.2f}s "
              f"({len(done) / max(dt, 1e-9):.1f} docs/s)")
        return 0

    def cmd_compare(self, args) -> int:
        t0 = time.time()
        score = self.processor.compare_encrypted(args.doc1, args.doc2)
        dt = time.time() - t0
        print(f"Similarity score: {score:.4f}")
        print(f"Interpretation: {interpret_score(score)}")
        print(f"(encrypted compare took {dt:.3f}s)")
        return 0

    def cmd_search(self, args) -> int:
        t0 = time.time()
        results = self.processor.search_similar(
            args.query, top_k=args.top_k, min_similarity=args.min_similarity)
        dt = time.time() - t0
        if not results:
            print("No documents above the similarity threshold.")
        for doc_id, score in results:
            print(f"{doc_id}: {score:.4f}  ({interpret_score(score)})")
        print(f"(encrypted search over store took {dt:.3f}s)")
        return 0

    def cmd_stats(self, args) -> int:
        from .store import EncryptedDocumentStore
        store = EncryptedDocumentStore(self.storage_dir)
        stats = {"keys": self._key_manager().get_stats(), "storage": store.get_stats()}
        if self._processor is not None:
            stats["memory"] = self._processor.get_memory_stats()
        print(json.dumps(stats, indent=2))
        return 0

    def cmd_validate(self, args) -> int:
        from .store import EncryptedDocumentStore
        store = EncryptedDocumentStore(self.storage_dir)
        valid, invalid = store.validate_all()
        print(f"Valid documents: {len(valid)}")
        print(f"Invalid documents: {len(invalid)}")
        for doc_id in invalid:
            print(f"  corrupt: {doc_id}")
            if args.fix:
                store.delete(doc_id)
                print(f"  deleted: {doc_id}")
        if getattr(args, "deep", False) and valid:
            # Decrypt-side noise budget per ciphertext, in level-grouped
            # chunks: one batched phase a chunk.
            from .interop import ciphertext_from_array
            from .ops.noise import noise_budget_bits_batch
            rt = self._key_manager().load_keyset()
            low = []
            chunk_size = 256
            for start in range(0, len(valid), chunk_size):
                docs = [store.load(d) for d in valid[start: start + chunk_size]]
                by_level = {}
                for doc in docs:
                    by_level.setdefault(doc.ct_level, []).append(doc)
                for level, group in by_level.items():
                    ct = ciphertext_from_array(np.stack([d.ct_data[:2] for d in group]), level,
                                               device=self.device)
                    bits = noise_budget_bits_batch(rt.ctx, rt.keys.sk, ct, coeffs_per_ct=32)
                    low.extend((d.doc_id, int(b)) for d, b in zip(group, bits) if b < 10)
            print(f"Noise check: {len(valid) - len(low)} healthy, "
                  f"{len(low)} low-budget (<10 bits)")
            for doc_id, bits in low:
                print(f"  low noise budget: {doc_id} ({bits} bits)")
            if low and not args.fix:
                return 1
        return 0 if not invalid or args.fix else 1

    def cmd_estimate(self, args) -> int:
        """ICP deployment resource estimate."""
        from .ops.params import get_params
        n = args.num_docs
        p = get_params(self.preset)
        ct_bytes = 2 * 2 * p.n_limbs * p.n * 4   # fwd+rev, 2 polys, u32
        est = {
            "documents": n,
            "preset": p.name,
            "ciphertext_bytes_per_doc": ct_bytes,
            "total_storage_mb": n * ct_bytes / 1e6,
            "encrypt_instructions": n * ICP_CYCLES_PER_ENCRYPT,
            "compare_instructions": ICP_CYCLES_PER_COMPARE,
            "fits_message_limit": ct_bytes <= ICP_MAX_MESSAGE_BYTES,
            "fits_memory_limit": n * ct_bytes <= ICP_MAX_MEMORY_BYTES,
            "fits_instruction_limit": n * ICP_CYCLES_PER_ENCRYPT <= ICP_MAX_INSTRUCTIONS,
        }
        print(json.dumps(est, indent=2))
        return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="fhe_icp_tpu_torch",
        description="GPU-native encrypted document similarity")
    p.add_argument("--storage-dir", default="./encrypted_docs")
    p.add_argument("--key-dir", default="~/.fhe_keys")
    p.add_argument("--preset", default="pairwise-4096")
    sub = p.add_subparsers(dest="command", required=True)

    keys = sub.add_parser("keys", help="key management")
    keys.add_argument("action", choices=["generate", "list", "rotate"])
    keys.add_argument("--key-id", default=None)
    keys.add_argument("--grace-days", type=int, default=7)
    keys.add_argument("--no-migrate", action="store_true",
                      help="on rotate, skip homomorphic store re-keying")

    enc = sub.add_parser("encrypt", help="encrypt one document")
    enc.add_argument("text", nargs="?", default=None)
    enc.add_argument("--file", default=None)
    enc.add_argument("--id", default=None)
    enc.add_argument("--tags", nargs="*", default=None,
                     help="document tags (stored in metadata['tags'])")
    enc.add_argument("--metadata", default=None, help="JSON object")

    encb = sub.add_parser("encrypt-batch", help="encrypt documents from file")
    encb.add_argument("file", help=".txt (one doc per line) or .json")

    cmp_ = sub.add_parser("compare", help="encrypted doc-vs-doc similarity")
    cmp_.add_argument("doc1")
    cmp_.add_argument("doc2")

    srch = sub.add_parser("search", help="encrypted top-k search")
    srch.add_argument("query")
    srch.add_argument("--top-k", type=int, default=5)
    srch.add_argument("--min-similarity", type=float, default=0.5)

    sub.add_parser("stats", help="key/storage/memory statistics")

    val = sub.add_parser("validate", help="validate stored documents")
    val.add_argument("--fix", action="store_true",
                     help="delete corrupt documents")
    val.add_argument("--deep", action="store_true",
                     help="also check each ciphertext's noise budget "
                          "(requires keys)")

    est = sub.add_parser("estimate", help="ICP deployment resource estimate")
    est.add_argument("--num-docs", type=int, default=1000)

    return p


def main(argv: Optional[list] = None, device: torch.device | str = "cuda") -> int:
    """Run one command on `device` (the card unless the caller names another)."""
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    args = build_parser().parse_args(argv)
    cli = FHEDocumentCLI(storage_dir=args.storage_dir, key_dir=args.key_dir,
                         preset=args.preset, device=device)
    handler = {
        "keys": cli.cmd_keys,
        "encrypt": cli.cmd_encrypt,
        "encrypt-batch": cli.cmd_encrypt_batch,
        "compare": cli.cmd_compare,
        "search": cli.cmd_search,
        "stats": cli.cmd_stats,
        "validate": cli.cmd_validate,
        "estimate": cli.cmd_estimate,
    }[args.command]
    try:
        return handler(args)
    except (KeyError, ValueError, FileNotFoundError, RuntimeError) as e:
        msg = e.args[0] if e.args else str(e)
        print(f"error: {msg}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
