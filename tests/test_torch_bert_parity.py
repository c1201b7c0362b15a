"""The port's BERT parity harness (`models/bert_parity.py`) on injected tiny weights.

As the JAX package's test does: a tiny random BERT saved as a Flax-only
checkpoint with a tokenizer over the battery's words.  The test carries
those weights into PyTorch with `transformers`' converter and saves them as
a second checkpoint for the port, which loads PyTorch weights only.  The
port's harness runs its `BertEmbedder` (on the CPU here) against the
reference's path and must report parity; its embeddings agree with the
JAX package's `FlaxBertEmbedder` on the Flax checkpoint within 1e-5;
`evaluate` flags a divergence and agrees with JAX's on the parity numbers.
"""

import re
from types import SimpleNamespace

import numpy as np
import pytest

from fhe_icp_tpu.models import bert_parity as jbp
from fhe_icp_tpu_torch.models import bert_parity

transformers = pytest.importorskip("transformers")


@pytest.fixture(scope="module")
def tiny_checkpoint(tmp_path_factory):
    d = tmp_path_factory.mktemp("tiny_bert_ckpt")
    toks = {"[PAD]": 0, "[UNK]": 1, "[CLS]": 2, "[SEP]": 3, "[MASK]": 4}
    for s in bert_parity.SENTENCES:
        for w in re.findall(r"[a-z0-9]+", s.lower()):
            toks.setdefault(w, len(toks))
    (d / "vocab.txt").write_text("\n".join(toks) + "\n")
    transformers.BertTokenizerFast(vocab_file=str(d / "vocab.txt"),
                                   do_lower_case=True).save_pretrained(str(d))
    cfg = transformers.BertConfig(vocab_size=len(toks), hidden_size=32, num_hidden_layers=2,
                                  num_attention_heads=2, intermediate_size=64,
                                  max_position_embeddings=128)
    transformers.FlaxBertModel(cfg, seed=0).save_pretrained(str(d))
    from transformers.modeling_flax_pytorch_utils import load_flax_checkpoint_in_pytorch_model
    t = tmp_path_factory.mktemp("tiny_bert_ckpt_torch")
    model = transformers.BertModel(cfg)
    load_flax_checkpoint_in_pytorch_model(model, str(d / "flax_model.msgpack"))
    model.save_pretrained(str(t))
    transformers.BertTokenizerFast.from_pretrained(str(d)).save_pretrained(str(t))
    assert not (t / "flax_model.msgpack").exists()
    return SimpleNamespace(flax=str(d), torch=str(t))


def test_battery_matches_jax():
    assert bert_parity.SENTENCES == jbp.SENTENCES
    assert bert_parity.SENTENCES_SHA256 == jbp.SENTENCES_SHA256


def test_harness_end_to_end_with_injected_weights(tiny_checkpoint):
    report = bert_parity.run_parity(tiny_checkpoint.torch, device="cpu")
    assert report["framework_parity_ok"], report
    assert report["max_abs_cosine_diff"] < 1e-5
    assert report["sentences_sha256"] == bert_parity.SENTENCES_SHA256
    assert report["weights_fingerprint_sha256"] not in ("", "unavailable")
    assert -1.0 <= report["pca_similarity_preservation"] <= 1.0
    assert -1.0 <= report["random_similarity_preservation"] <= 1.0


def test_port_embedder_matches_flax_embedder(tiny_checkpoint):
    from fhe_icp_tpu.models.embedder import FlaxBertEmbedder
    got = bert_parity.port_embedder(tiny_checkpoint.torch, "cpu").get_embeddings_batch(
        bert_parity.SENTENCES)
    want = FlaxBertEmbedder(tiny_checkpoint.flax).get_embeddings_batch(jbp.SENTENCES)
    assert got.shape == want.shape == (len(bert_parity.SENTENCES), 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        bert_parity._torch_mean_pooled(tiny_checkpoint.torch, jbp.SENTENCES),
        jbp._torch_mean_pooled(tiny_checkpoint.flax, jbp.SENTENCES), rtol=0, atol=0)


def test_evaluate_flags_divergence_as_jax_does():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((16, 64)).astype(np.float32)
    b = a + 0.1 * rng.standard_normal((16, 64)).astype(np.float32)
    report = bert_parity.evaluate(a, b, device="cpu")
    want = jbp.evaluate(a, b)
    assert not report["framework_parity_ok"] and not want["framework_parity_ok"]
    for key in ("max_abs_embedding_diff", "max_abs_cosine_diff", "pca_dim"):
        assert report[key] == want[key], key
    assert report["pca_similarity_preservation"] == pytest.approx(
        want["pca_similarity_preservation"], abs=1e-3)
    assert bert_parity.evaluate(a, a, device="cpu")["framework_parity_ok"]
