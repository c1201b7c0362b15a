"""The port's 8-command CLI, as tests/test_pipeline.py (TestCLI) holds the JAX package's.

Commands run in process through `main(argv, device="cpu")`, on the
test-512-mult preset; their printed strings are the JAX package's.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from fhe_icp_tpu_torch.cli import build_parser, interpret_score, main
from fhe_icp_tpu_torch.store import EncryptedDocumentStore

PRESET = "test-512-mult"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def master_password(monkeypatch):
    monkeypatch.setenv("FHE_MASTER_PASSWORD", "test-password-123")


def run_cli(tmp_path, *args):
    return main(["--storage-dir", str(tmp_path / "docs"), "--key-dir", str(tmp_path / "keys"),
                 "--preset", PRESET, *args], device="cpu")


def test_keys_generate_and_list(tmp_path, capsys):
    assert run_cli(tmp_path, "keys", "generate", "--key-id", "k1") == 0
    assert run_cli(tmp_path, "keys", "list") == 0
    out = capsys.readouterr().out
    assert "Generated key: k1" in out and "k1 (current)" in out


def test_estimate(tmp_path, capsys):
    assert run_cli(tmp_path, "estimate", "--num-docs", "10") == 0
    est = json.loads(capsys.readouterr().out)
    assert est["documents"] == 10 and est["fits_memory_limit"] is True
    assert est["ciphertext_bytes_per_doc"] == 2 * 2 * 3 * 512 * 4


def test_validate_empty_store(tmp_path, capsys):
    assert run_cli(tmp_path, "validate") == 0
    assert "Valid documents: 0" in capsys.readouterr().out


def test_compare_missing_doc_clean_error(tmp_path, capsys):
    run_cli(tmp_path, "keys", "generate")
    assert run_cli(tmp_path, "compare", "nope1", "nope2") == 1
    assert "not found" in capsys.readouterr().err


def test_encrypt_tags_and_size(tmp_path, capsys):
    run_cli(tmp_path, "keys", "generate")
    rc = run_cli(tmp_path, "encrypt", "tagged document text", "--id", "tdoc",
                 "--tags", "alpha", "beta", "--metadata", '{"k": "v"}')
    assert rc == 0
    out = capsys.readouterr().out
    assert "Encrypted document: tdoc" in out
    assert "Size: " in out and " bytes" in out
    doc = EncryptedDocumentStore(str(tmp_path / "docs")).load("tdoc")
    assert doc.metadata == {"tags": ["alpha", "beta"], "k": "v"}


def test_keys_list_shows_size(tmp_path, capsys):
    run_cli(tmp_path, "keys", "generate", "--key-id", "ksz")
    capsys.readouterr()
    assert run_cli(tmp_path, "keys", "list") == 0
    out = capsys.readouterr().out
    assert "Size: " in out and " MB" in out


def test_validate_deep_batched_store(tmp_path, capsys):
    run_cli(tmp_path, "keys", "generate")
    batch = tmp_path / "docs.txt"
    batch.write_text("first document\nsecond document\nthird one\n")
    assert run_cli(tmp_path, "encrypt-batch", str(batch)) == 0
    capsys.readouterr()
    assert run_cli(tmp_path, "validate", "--deep") == 0
    assert "Noise check: 3 healthy, 0 low-budget" in capsys.readouterr().out


def test_user_path_end_to_end(tmp_path, capsys):
    """keys generate -> encrypt-batch (70 docs, the arena path) -> encrypt
    -> compare -> search -> stats -> validate --fix -> keys rotate (the
    store re-keyed) -> search again, with the same results."""
    assert run_cli(tmp_path, "keys", "generate", "--key-id", "k0") == 0
    corpus = tmp_path / "corpus.json"
    corpus.write_text(json.dumps([{"id": f"c{i}", "text": f"corpus line {i} about topic {i % 6}"}
                                  for i in range(70)]))
    assert run_cli(tmp_path, "encrypt-batch", str(corpus)) == 0
    assert "Encrypted 70 documents in" in capsys.readouterr().out
    assert run_cli(tmp_path, "encrypt", "corpus line about topic 4", "--id", "q") == 0
    assert run_cli(tmp_path, "compare", "q", "q") == 0
    out = capsys.readouterr().out
    score = float(out.split("Similarity score: ")[1].split()[0])
    assert abs(score - 1.0) < 0.01 and "Interpretation: Very similar" in out
    assert run_cli(tmp_path, "search", "corpus line about topic 4", "--top-k", "3") == 0
    first = capsys.readouterr().out.splitlines()
    assert first[0] == f"q: {score:.4f}  (Very similar)" and len(first) == 4
    assert first[-1].startswith("(encrypted search over store took")
    assert run_cli(tmp_path, "stats") == 0
    stats = json.loads(capsys.readouterr().out)
    assert stats["storage"]["document_count"] == 71 and stats["keys"]["current_key"] == "k0"
    assert run_cli(tmp_path, "keys", "rotate") == 0
    out = capsys.readouterr().out
    assert "Rotated to key: " in out and "Re-keyed 71 stored documents to" in out
    assert run_cli(tmp_path, "search", "corpus line about topic 4", "--top-k", "3") == 0
    assert capsys.readouterr().out.splitlines()[:-1] == first[:-1]
    store = EncryptedDocumentStore(str(tmp_path / "docs"))
    raw = bytearray(store._doc_path("c5").read_bytes())
    raw[200] ^= 0xFF
    store._doc_path("c5").write_bytes(bytes(raw))
    assert run_cli(tmp_path, "validate") == 1
    assert run_cli(tmp_path, "validate", "--fix") == 0
    assert "deleted: c5" in capsys.readouterr().out


def test_interpretation_bands_and_parser():
    assert [interpret_score(s) for s in (0.95, 0.8, 0.6, 0.5, -1)] == [
        "Very similar", "Similar", "Somewhat similar", "Not very similar", "Not very similar"]
    args = build_parser().parse_args(["search", "q"])
    assert (args.top_k, args.min_similarity, args.preset) == (5, 0.5, "pairwise-4096")
    assert build_parser().prog == "fhe_icp_tpu_torch"


def test_module_entry_point():
    """`python -m fhe_icp_tpu_torch.cli` runs main: its help, and on a
    machine without CUDA a clean refusal naming CUDA."""
    r = subprocess.run([sys.executable, "-m", "fhe_icp_tpu_torch.cli", "--help"], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "encrypt-batch" in r.stdout
    r = subprocess.run([sys.executable, "-m", "fhe_icp_tpu_torch.cli", "estimate"], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    if torch.cuda.is_available():
        assert r.returncode == 0
    else:
        assert r.returncode != 0 and "CUDA" in r.stderr
