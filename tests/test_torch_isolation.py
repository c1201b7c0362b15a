"""The port stands alone: no JAX, nothing of the JAX package, card by default."""

import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "fhe_icp_tpu_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
    for p in PKG.rglob("*.py"))


def test_compare_path_modules_are_covered():
    for m in ("fhe_icp_tpu_torch.ops.galois", "fhe_icp_tpu_torch.ops.noise",
              "fhe_icp_tpu_torch.ops.arith", "fhe_icp_tpu_torch.ops.runtime"):
        assert m in MODULES


def test_user_path_modules_are_covered():
    for m in ("fhe_icp_tpu_torch.native", "fhe_icp_tpu_torch.store", "fhe_icp_tpu_torch.keymgr",
              "fhe_icp_tpu_torch.utils.quantize", "fhe_icp_tpu_torch.models.embedder",
              "fhe_icp_tpu_torch.models.reduction", "fhe_icp_tpu_torch.models.similarity",
              "fhe_icp_tpu_torch.models.poly", "fhe_icp_tpu_torch.batch",
              "fhe_icp_tpu_torch.cli"):
        assert m in MODULES


REST_OF_PACKAGE = {
    "ops.fastdot": ("DocOperand", "QueryOperand", "make_doc_operand", "make_query_operand",
                    "fold_digit_products", "scores", "center_residues", "balanced_digits"),
    "ops.ntt_mxu": ("ntt_fwd_mxu", "_tables", "_FOLD_GROUPS", "_fold_buckets"),
    "parallel.search": ("make_sharded_fastdot_search", "doc_operand_sharding",
                        "packed_operand_sharding"),
    "parallel.pipeline": ("PP_AXIS", "N_STAGES", "make_pp_mesh", "make_pipelined_scores"),
    "parallel.multihost": ("initialize", "HostShard", "partition_groups", "shard_slice",
                           "local_topk", "merge_topk", "global_topk", "search_host_shard"),
    "utils.profiling": ("trace", "measure", "measure_chained", "measure_ondevice_loop",
                        "roofline", "keyswitch_footprint", "HBM_SPEC_GBS", "hbm_spec_gbs",
                        "attainable_read_bw", "Metrics", "METRICS"),
    "utils.debug": ("KNOWN_ISSUES", "RELEVANT_ENV", "check_environment", "memory_monitor"),
    "analysis": ("alternatives", "linear_math", "quantization", "reduction"),
    "analysis.alternatives": ("FHEFriendlySimilarity", "benchmark"),
    "analysis.linear_math": ("analyze_linear_relationship", "probe_identities"),
    "analysis.quantization": ("create_similarity_dataset", "QuantizationTester", "main"),
    "analysis.reduction": ("make_corpus", "run_sweep"),
    "models.bert_parity": ("SENTENCES", "SENTENCES_SHA256", "_cos_matrix",
                           "_weights_fingerprint", "_torch_mean_pooled", "evaluate",
                           "run_parity", "main"),
}


@pytest.mark.parametrize("module", sorted(REST_OF_PACKAGE))
def test_rest_of_package_modules_are_covered(module):
    """The last JAX modules have their counterparts, with the JAX names."""
    import importlib
    assert f"fhe_icp_tpu_torch.{module}" in MODULES
    ported = importlib.import_module(f"fhe_icp_tpu_torch.{module}")
    assert [n for n in REST_OF_PACKAGE[module] if not hasattr(ported, n)] == []


def test_import_leaves_jax_out():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'fhe_icp_tpu' or m.startswith('fhe_icp_tpu.')]\n"
        "print(len(sys.modules)); assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert len(MODULES) >= 50


@pytest.mark.parametrize("path", sorted(p.relative_to(ROOT).as_posix()
                                        for p in PKG.rglob("*") if p.is_file()
                                        and p.suffix in (".py", ".cu", ".cuh")))
def test_no_reference_in_sources(path):
    text = (ROOT / path).read_text()
    assert not re.search(r"^\s*(import jax|from jax)", text, re.M)
    assert not re.search(r"fhe_icp_tpu(?!_torch)", text)
    # Flax, and transformers' Flax converter, import JAX when called.
    assert not re.search(r"flax", text, re.I)


def test_runtime_defaults_to_the_card():
    from fhe_icp_tpu_torch.ops.runtime import FheRuntime
    if torch.cuda.is_available():
        assert FheRuntime("test-512").device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            FheRuntime("test-512")
    assert FheRuntime("test-512", device="cpu").ctx.p.device.type == "cpu"


def _entry_points(tmp):
    """Each entry point that builds on a device, called with its default device."""
    import numpy as np
    from fhe_icp_tpu_torch import batch, cli, entry, interop, keymgr, store
    from fhe_icp_tpu_torch.analysis import quantization
    from fhe_icp_tpu_torch.analysis import reduction as analysis_reduction
    from fhe_icp_tpu_torch.models import bert_parity, embedder, poly, reduction, similarity
    from fhe_icp_tpu_torch.ops.context import CryptoContext
    from fhe_icp_tpu_torch.ops.ntt import build_plan
    from fhe_icp_tpu_torch.ops.params import get_params
    from fhe_icp_tpu_torch.ops.runtime import FheRuntime
    from fhe_icp_tpu_torch.parallel import multihost, pipeline
    from fhe_icp_tpu_torch.parallel.mesh import make_mesh
    from fhe_icp_tpu_torch.parallel.ntt_dist import build_dist_plan
    from fhe_icp_tpu_torch.utils import profiling
    return {
        "CryptoContext": lambda: CryptoContext(get_params("test-512")).device,
        "build_plan": lambda: build_plan(16, (12289,)).device,
        "ciphertext_from_array": lambda: interop.ciphertext_from_array(
            np.zeros((2, 2, 512), np.uint32), 2).data.device,
        "make_mesh": lambda: make_mesh(2).devices[0],
        "build_dist_plan": lambda: build_dist_plan(256, (12289,), 16).psi.device,
        "dryrun_multichip": lambda: entry.dryrun_multichip(2),
        "FheRuntime(rlk_levels)": lambda: FheRuntime("test-512", rlk_levels=[2]).device,
        "rekey_keys_from_arrays": lambda: next(iter(interop.rekey_keys_from_arrays(
            {"ksk_2": np.zeros((4, 2, 3, 512), np.uint32)}).values())).device,
        "galois_keys_from_arrays": lambda: next(iter(interop.galois_keys_from_arrays(
            {"gal_5_2": np.zeros((4, 2, 3, 512), np.uint32)}).keys.values())).device,
        "FHEKeyManager": lambda: keymgr.FHEKeyManager(str(tmp / "keys")).device,
        "DimensionReducer": lambda: reduction.DimensionReducer(8).device,
        "DimensionReducer.load": lambda: reduction.DimensionReducer.load(
            _reducer_file(tmp)).device,
        "BertEmbedder": lambda: embedder.BertEmbedder(tokenizer=object(),
                                                      model=_tiny_model()).device,
        "BatchProcessor": lambda: batch.BatchProcessor(
            storage_dir=str(tmp / "docs"), key_dir=str(tmp / "keys"),
            embedder=embedder.HashingEmbedder()).device,
        "FHEDocumentCLI": lambda: cli.FHEDocumentCLI(str(tmp / "docs")).device,
        "cli.main": lambda: cli.main(["--storage-dir", str(tmp / "docs"), "--key-dir",
                                      str(tmp / "keys"), "estimate"]) or None,
        "EncryptedDocument.ciphertext": lambda: store.EncryptedDocument(
            "d", "0" * 64, 0.0, np.zeros((4, 2, 512), np.uint32), 2, 128, 1000
        ).ciphertext().data.device,
        "FHESimilarityModel.compile": lambda: _trained(similarity.FHESimilarityModel(
            preset="test-512")).compile().runtime.device,
        "FHEPolynomialSimilarity.compile": lambda: poly.FHEPolynomialSimilarity(
            64, preset="test-512-poly").compile().runtime.device,
        "make_pp_mesh": lambda: pipeline.make_pp_mesh().devices[0],
        "make_sharded_fastdot_search": lambda: _fastdot_search_device(),
        "bert_parity.run_parity's embedder": lambda: bert_parity.port_embedder(
            _tiny_bert(tmp)).device,
        "multihost.main": lambda: multihost.main(
            ["127.0.0.1:0", "1", "0", "--store", _tiny_store(tmp), "--preset", "test-512",
             "--top-k", "2"]) and None,
        "measure_ondevice_loop": lambda: profiling.measure_ondevice_loop(
            lambda t: t + 1, 1, 2, 1) and None,
        "attainable_read_bw": lambda: profiling.attainable_read_bw(1 << 20, 1) and None,
        "analysis.run_sweep": lambda: analysis_reduction.run_sweep(
            np.eye(8, dtype=np.float32), (4,), ("pca",), None, False) and None,
        "QuantizationTester": lambda: quantization.QuantizationTester(
            8, "test-512", 1).test_bit_width(4) and None,
    }


def _fastdot_search_device():
    from fhe_icp_tpu_torch.ops.context import CryptoContext
    from fhe_icp_tpu_torch.ops.params import get_params
    from fhe_icp_tpu_torch.parallel.mesh import make_mesh
    from fhe_icp_tpu_torch.parallel.search import make_sharded_fastdot_search
    mesh = make_mesh(2)
    make_sharded_fastdot_search(CryptoContext(get_params("test-512"), device="cpu"), mesh)
    return mesh.devices[0]


def _tiny_bert(tmp):
    """A tiny random BERT checkpoint (PyTorch weights) with its tokenizer."""
    import transformers
    path = tmp / "tiny_bert"
    path.mkdir()
    (path / "vocab.txt").write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
                                               "the", "fox"]) + "\n")
    transformers.BertTokenizerFast(vocab_file=str(path / "vocab.txt")).save_pretrained(path)
    cfg = transformers.BertConfig(vocab_size=7, hidden_size=8, num_hidden_layers=1,
                                  num_attention_heads=2, intermediate_size=16)
    transformers.BertModel(cfg).save_pretrained(path)
    return str(path)


def _tiny_store(tmp):
    import numpy as np
    path = tmp / "store.npz"
    rng = np.random.default_rng(0)
    np.savez(path, docs=rng.integers(-9, 9, (8, 128)).astype(np.int32),
             queries=rng.integers(-9, 9, (1, 128)).astype(np.int32))
    return str(path)


def _reducer_file(tmp):
    import numpy as np
    from fhe_icp_tpu_torch.models.reduction import DimensionReducer
    path = tmp / "reducer.npz"
    DimensionReducer(4, device="cpu").fit(np.eye(6, dtype=np.float32)).save(path)
    return path


def _tiny_model():
    import types
    model = torch.nn.Linear(1, 1)
    model.config = types.SimpleNamespace(hidden_size=1)
    return model


def _trained(model):
    model.train(n_samples=200)
    return model


@pytest.mark.parametrize("name", ["CryptoContext", "build_plan", "ciphertext_from_array",
                                  "make_mesh", "build_dist_plan", "dryrun_multichip",
                                  "FheRuntime(rlk_levels)", "rekey_keys_from_arrays",
                                  "galois_keys_from_arrays", "FHEKeyManager", "DimensionReducer",
                                  "DimensionReducer.load", "BertEmbedder", "BatchProcessor",
                                  "FHEDocumentCLI", "cli.main", "EncryptedDocument.ciphertext",
                                  "FHESimilarityModel.compile",
                                  "FHEPolynomialSimilarity.compile", "make_pp_mesh",
                                  "make_sharded_fastdot_search",
                                  "bert_parity.run_parity's embedder", "multihost.main",
                                  "measure_ondevice_loop", "attainable_read_bw",
                                  "analysis.run_sweep", "QuantizationTester"])
def test_entry_points_default_to_the_card(name, tmp_path, monkeypatch):
    """Without CUDA the default device raises, naming CUDA; it never runs on the CPU."""
    monkeypatch.setenv("FHE_MASTER_PASSWORD", "test-password-123")
    call = _entry_points(tmp_path)[name]
    if torch.cuda.is_available():
        dev = call()
        assert dev is None or dev.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_kernel_wrappers_refuse_other_devices():
    """A wrapper takes the plain version only for CPU tensors."""
    from fhe_icp_tpu_torch.ops import ntt_cuda, pack_cuda
    from fhe_icp_tpu_torch.ops.context import CryptoContext
    from fhe_icp_tpu_torch.ops.params import get_params
    ctx = CryptoContext(get_params("test-512"), device="cpu")
    x = torch.zeros((2, ctx.n), dtype=torch.uint32, device="meta")
    with pytest.raises(ValueError):
        ntt_cuda._launch(ctx.plan, x, "ntt_fwd")
    a = torch.zeros((2, 4, 2 * ctx.n), dtype=torch.int8, device="meta")
    v = torch.zeros((2, 2 * ctx.n, 16), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError):
        pack_cuda.packed_score_residues(ctx, a, v, 2, 4)
