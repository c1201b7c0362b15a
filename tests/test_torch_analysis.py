"""The port's analysis modules against the JAX package's `analysis/`.

The numpy modules (`linear_math`, `alternatives`) give the JAX package's
numbers exactly.  `reduction.run_sweep` runs the port's DimensionReducer:
its PCA and SVD rows agree with JAX's within 1e-5 (two SVD routines), its
"random" rows only by range, because a fresh random fit draws from a CPU
`torch.Generator`, not `jax.random`.  `quantization` holds the port's
similarity model (encrypted on the CPU) to JAX's results.
"""

import numpy as np
import pytest

from fhe_icp_tpu.analysis import alternatives as jalt
from fhe_icp_tpu.analysis import linear_math as jlin
from fhe_icp_tpu.analysis import quantization as jquant
from fhe_icp_tpu.analysis import reduction as jred
from fhe_icp_tpu_torch.analysis import alternatives, linear_math, quantization, reduction


def test_concat_cannot_learn_cosine_products_can():
    r2 = linear_math.analyze_linear_relationship(n_samples=1500, dim=32)
    assert r2["product"] > 0.9999 and r2["concat"] < 0.1
    assert r2 == jlin.analyze_linear_relationship(n_samples=1500, dim=32)


def test_probe_identities():
    assert linear_math.probe_identities() == jlin.probe_identities() == {
        "identical": 1.0, "orthogonal": 0.0, "opposite": -1.0}


def test_metric_correlations(tmp_path):
    corr = alternatives.benchmark(n_pairs=300, dim=64, out_path=str(tmp_path / "m.json"))
    assert corr == jalt.benchmark(n_pairs=300, dim=64, out_path=None)
    assert corr["dot"] > 0.9999 and corr["manhattan"] > 0.95
    assert corr["approx_cosine"] > 0.99 and corr["polynomial"] > 0.95
    assert (tmp_path / "m.json").exists()


def test_similarity_metric_values():
    a, b = np.asarray([1.0, 0.0]), np.asarray([0.0, 1.0])
    s, js = alternatives.FHEFriendlySimilarity, jalt.FHEFriendlySimilarity
    assert s.cosine(a, a) == 1.0 and s.cosine(a, b) == 0.0 and s.dot(a, -a) == -1.0
    assert s.manhattan(a, a) == 1.0 and s.hamming_sign(a, a) == 1.0
    assert abs(s.approx_cosine(a, a) - 1.0) < 1e-9
    for name in ("cosine", "dot", "manhattan", "chebyshev", "hamming_sign", "polynomial",
                 "approx_cosine"):
        assert getattr(s, name)(a, b) == getattr(js, name)(a, b)


def test_reduction_sweep(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    x = reduction.make_corpus(n=128, dim=256)
    np.testing.assert_array_equal(x, jred.make_corpus(n=128, dim=256))
    results = reduction.run_sweep(corpus=x, target_dims=(32, 128),
                                  out_path=str(tmp_path / "sweep.json"), device="cpu")
    assert (tmp_path / "sweep.json").exists() and (tmp_path / "pca_reducer_128.npz").exists()
    want = jred.run_sweep(corpus=x, target_dims=(32, 128), out_path=None, save_best=False)
    assert len(results) == len(want) == 6
    for got, ref in zip(results, want):
        assert (got["method"], got["target_dim"], got["memory_saving"]) == \
            (ref["method"], ref["target_dim"], ref["memory_saving"])
        if got["method"] == "random":
            assert got["explained_variance"] is None and got["reconstruction_error"] is None
            assert -1.0 <= got["similarity_preservation"] <= 1.0
            continue
        for key in ("explained_variance", "reconstruction_error", "similarity_preservation"):
            assert got[key] == pytest.approx(ref[key], abs=1e-5), key
    pca128 = next(r for r in results if r["method"] == "pca" and r["target_dim"] == 128)
    assert pca128["similarity_preservation"] > 0.9 and pca128["explained_variance"] > 0.8


def test_similarity_dataset_matches_jax():
    x, y = quantization.create_similarity_dataset(n_samples=50, dim=16)
    jx, jy = jquant.create_similarity_dataset(n_samples=50, dim=16)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)


def test_quantization_sweep_matches_jax(tmp_path):
    """Encrypted predictions are exactly the quantized clear ones in both
    packages, so every result but the times agrees."""
    got = quantization.QuantizationTester(dim=16, preset="test-512", n_fhe_samples=3,
                                          device="cpu").run_sweep(
        bit_widths=(4, 8), out_path=str(tmp_path / "q.json"))
    want = jquant.QuantizationTester(dim=16, preset="test-512", n_fhe_samples=3).run_sweep(
        bit_widths=(4, 8), out_path=None)
    assert (tmp_path / "q.json").exists()
    for g, w in zip(got, want):
        for key in ("n_bits", "r2", "circuit_max_bits", "clear_vs_fhe_mae"):
            assert g[key] == w[key], key
        assert g["fhe_prediction_time_s"] > 0
