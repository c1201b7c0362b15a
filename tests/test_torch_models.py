"""The port's quantization contract, embedders and dimension reducer against the JAX package's.

* `utils.quantize`: identical integers, metadata and quantizer states.
* `HashingEmbedder`: bit-identical embeddings.
* `BertEmbedder` (PyTorch) against `FlaxBertEmbedder` on a tiny random
  config (as tests/test_embedder_flax.py builds it), the Flax weights
  carried into the torch model: atol 1e-5 in every pooling.
* `DimensionReducer`: a persisted `reducer.npz` transforms identically in
  both packages; on separated singular values the PCA components match
  per column up to sign at 1e-4.
"""

import numpy as np
import pytest
import torch

from fhe_icp_tpu.models import embedder as jax_embedder
from fhe_icp_tpu.models.reduction import DimensionReducer as JaxReducer
from fhe_icp_tpu.utils import quantize as jq
from fhe_icp_tpu_torch.models import embedder as tm
from fhe_icp_tpu_torch.models.reduction import DimensionReducer
from fhe_icp_tpu_torch.utils import quantize as tq

TEXTS = ["the quick brown fox jumps over the lazy dog",
         "A fast brown fox, leaping over 2 lazy dogs!",
         "", "quantum " * 300, "encrypted search over homomorphic ciphertexts"]


# -- quantization ----------------------------------------------------------------


@pytest.mark.parametrize("scale", [1000, 90])
def test_prepare_embedding_matches_jax(scale):
    rng = np.random.default_rng(scale)
    for e in (rng.standard_normal(128), np.zeros(16), rng.standard_normal(768) * 1e-3):
        q, meta = tq.prepare_embedding_for_fhe(e, scale)
        jqv, jmeta = jq.prepare_embedding_for_fhe(e, scale)
        assert q.dtype == np.int32 and (q == jqv).all() and meta == jmeta
    assert tq.dequantize_score(123456, scale) == jq.dequantize_score(123456, scale)
    assert tq.DEFAULT_SCALE == jq.DEFAULT_SCALE == 1000


def test_symmetric_quantizer_matches_jax():
    x = np.random.default_rng(1).standard_normal((5, 7)) * 3
    for bits in (4, 8):
        t, j = tq.SymmetricQuantizer(bits).calibrate(x), jq.SymmetricQuantizer(bits).calibrate(x)
        assert t.state() == j.state()
        assert (t.quantize(x) == j.quantize(x)).all()
        assert (t.dequantize(t.quantize(x)) == j.dequantize(j.quantize(x))).all()
        assert tq.SymmetricQuantizer.from_state(j.state()) == t


# -- embedders ---------------------------------------------------------------------


@pytest.mark.parametrize("pooling", ["mean", "max", "cls"])
def test_hashing_embedder_is_bit_identical(pooling):
    t, j = tm.HashingEmbedder(max_length=40), jax_embedder.HashingEmbedder(max_length=40)
    got = t.get_embeddings_batch(TEXTS, pooling=pooling)
    want = j.get_embeddings_batch(TEXTS, pooling=pooling)
    assert got.dtype == np.float32 and got.shape == (len(TEXTS), 768)
    assert got.tobytes() == want.tobytes()
    assert t.tokenize(TEXTS[1]) == j.tokenize(TEXTS[1])
    assert t.compute_similarity(got[0], got[1]) == j.compute_similarity(want[0], want[1])


def test_make_embedder_falls_back_to_hashing(monkeypatch):
    monkeypatch.delenv("FHE_ALLOW_DOWNLOAD", raising=False)
    emb = tm.make_embedder("no-such-model-on-this-disk", device="cpu")
    assert isinstance(emb, tm.HashingEmbedder)
    assert isinstance(tm.make_embedder(prefer_bert=False), tm.HashingEmbedder)


_VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
          "the", "cat", "sat", "on", "a", "mat", "dog", "##s", "ran"]


@pytest.fixture(scope="module")
def tiny_berts(tmp_path_factory):
    """The Flax embedder of tests/test_embedder_flax.py and the port's, same weights."""
    transformers = pytest.importorskip("transformers")
    from transformers.modeling_flax_pytorch_utils import load_flax_weights_in_pytorch_model
    vocab_file = tmp_path_factory.mktemp("vocab") / "vocab.txt"
    vocab_file.write_text("\n".join(_VOCAB) + "\n")
    tok = transformers.BertTokenizerFast(vocab_file=str(vocab_file), do_lower_case=True)
    cfg = transformers.BertConfig(
        vocab_size=len(_VOCAB), hidden_size=32, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=64, max_position_embeddings=64)
    flax_model = transformers.FlaxBertModel(cfg, seed=0)
    pt_model = load_flax_weights_in_pytorch_model(transformers.BertModel(cfg), flax_model.params)
    return (jax_embedder.FlaxBertEmbedder(max_length=16, tokenizer=tok, model=flax_model),
            tm.BertEmbedder(max_length=16, tokenizer=tok, model=pt_model, device="cpu"))


@pytest.mark.parametrize("pooling", ["mean", "cls", "max"])
def test_bert_embedder_matches_flax(tiny_berts, pooling):
    flax_emb, port_emb = tiny_berts
    texts = ["the cat sat on a mat", "dogs ran", "", "the cat sat on a mat " * 20]
    got = port_emb.get_embeddings_batch(texts, batch_size=3, pooling=pooling)
    want = flax_emb.get_embeddings_batch(texts, batch_size=3, pooling=pooling)
    assert got.shape == (4, 32) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(port_emb.get_embedding("dogs ran", pooling), want[1],
                               rtol=0, atol=1e-5)


def test_bert_embedder_mask_correct_mean(tiny_berts):
    """A short text alone and padded beside a longer one pools the same."""
    _, emb = tiny_berts
    alone = emb.get_embeddings_batch(["dogs ran"])[0]
    batched = emb.get_embeddings_batch(["dogs ran", "the cat sat on a mat the cat sat"])[0]
    np.testing.assert_allclose(alone, batched, rtol=1e-5, atol=1e-6)
    assert emb.model.training is False and emb.dim == 32


# -- dimension reduction ---------------------------------------------------------------


def _embeddings(n=160, d=96, seed=3):
    """Low-rank data plus noise: separated leading singular values."""
    rng = np.random.default_rng(seed)
    basis = rng.standard_normal((12, d))
    scales = np.linspace(12, 1, 12)[:, None]
    x = rng.standard_normal((n, 12)) @ (basis * scales) + 0.01 * rng.standard_normal((n, d))
    return x.astype(np.float32)


@pytest.mark.parametrize("method", ["pca", "svd", "random"])
def test_persisted_reducer_transforms_identically(tmp_path, method):
    x = _embeddings()
    jr = JaxReducer(8, method=method).fit(x)
    jr.save(tmp_path / "j.npz")
    port = DimensionReducer.load(tmp_path / "j.npz", device="cpu")
    assert (port.method, port.target_dim, port.random_state) == (method, 8, 42)
    assert port.transform(x).tobytes() == jr.transform(x).tobytes()
    tr = DimensionReducer(8, method=method, device="cpu").fit(x)
    tr.save(tmp_path / "t.npz")
    back = JaxReducer.load(tmp_path / "t.npz")
    assert back.transform(x).tobytes() == tr.transform(x).tobytes()
    assert (back.explained_variance_ratio_ is None) == (method == "random")


def test_pca_matches_jax_up_to_sign():
    x = _embeddings()
    jr, tr = JaxReducer(8).fit(x), DimensionReducer(8, device="cpu").fit(x)
    np.testing.assert_allclose(tr.mean_, jr.mean_, atol=1e-5)
    np.testing.assert_allclose(tr.explained_variance_ratio_, jr.explained_variance_ratio_,
                               atol=1e-5)
    for c in range(8):
        t, j = tr.components_[:, c], jr.components_[:, c]
        np.testing.assert_allclose(t * np.sign(t @ j), j, atol=1e-4, err_msg=f"column {c}")
    assert abs(tr.similarity_preservation(x) - jr.similarity_preservation(x)) < 1e-4
    assert abs(tr.reconstruction_error(x) - jr.reconstruction_error(x)) < 1e-4


def test_random_projection_is_seeded():
    x = _embeddings(n=10)
    a = DimensionReducer(8, method="random", device="cpu").fit(x)
    b = DimensionReducer(8, method="random", device="cpu").fit(x)
    assert a.components_.tobytes() == b.components_.tobytes()
    assert a.components_.shape == (96, 8) and not a.mean_.any()
    assert abs(a.components_.std() * np.sqrt(8) - 1) < 0.15
    with pytest.raises(ValueError):
        DimensionReducer(8, method="umap", device="cpu")
    with pytest.raises(RuntimeError, match="not fitted"):
        DimensionReducer(8, device="cpu").transform(x)
    assert torch.device("cpu") == a.device
