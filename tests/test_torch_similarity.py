"""The port's encrypted similarity models, as tests/test_model.py holds the JAX package's.

* `FHESimilarityModel`: the same `coef_`, quantizer states and files as
  the JAX model; `predict_encrypted` equals `predict_quantized_clear`
  exactly and tracks the clear path; probe identities; y = 2x exact.
* `FHEPolynomialSimilarity` on test-512-poly: the encrypted result equals
  the quantized-clear simulation bit for bit, probes, compile
  rejections, save/load across packages.
The production-preset case of tests/test_model.py is left out (slow).
"""

import numpy as np
import pytest

from fhe_icp_tpu.analysis.quantization import create_similarity_dataset
from fhe_icp_tpu.models import poly as jax_poly
from fhe_icp_tpu.models import similarity as jax_similarity
from fhe_icp_tpu_torch.models.poly import FHEPolynomialSimilarity
from fhe_icp_tpu_torch.models.similarity import FHESimilarityModel
from fhe_icp_tpu_torch.ops.params import CryptoParams
from fhe_icp_tpu_torch.ops.runtime import FheRuntime

TEST_PARAMS = CryptoParams("test-512", n=512, n_limbs=3, allow_insecure=True)


@pytest.fixture(scope="module")
def rt():
    r = FheRuntime(TEST_PARAMS, device="cpu")
    r.generate_keys(seed=0)
    return r


@pytest.fixture(scope="module")
def model(rt):
    m = FHESimilarityModel(input_dim=128, n_bits=8)
    m.train()
    m.compile(runtime=rt)
    return m


def test_y_equals_2x_exact(rt):
    """w.x with w=[2], x=[7] under encryption -> exactly 14."""
    ct = rt.encrypt_vector(np.asarray([7], dtype=np.int32), seed=1)
    score = rt.dot_ct_pt(ct, np.asarray([2], dtype=np.int32))
    assert int(rt.decrypt_dot(score, 1)) == 14


def test_model_matches_jax_training(model):
    j = jax_similarity.FHESimilarityModel(input_dim=128, n_bits=8)
    j.train()
    assert model.coef_.tobytes() == j.coef_.tobytes()
    assert model.intercept_ == j.intercept_
    assert model.metrics["r2"] == j.metrics["r2"] and model.metrics["r2"] > 0.999
    j.x_quant.calibrate(j._prepare_training_data(64)[0])
    j.w_quant.calibrate(j.coef_)
    assert model.x_quant.state() == j.x_quant.state()
    assert (model.w_int == j.w_int).all()


def test_circuit_bits_reported(model):
    assert 18 <= model.metrics["circuit_max_bits"] <= 24


def test_probe_identities(model):
    d = model.input_dim
    rng = np.random.default_rng(7)
    e = rng.standard_normal(d)
    e /= np.linalg.norm(e)
    f = rng.standard_normal(d)
    f -= (f @ e) * e
    f /= np.linalg.norm(f)
    for name, (x, want) in {"identical": (e * e, 1.0), "orthogonal": (e * f, 0.0),
                            "opposite": (e * -e, -1.0)}.items():
        got = float(model.predict_encrypted(x[None])[0])
        assert abs(got - want) < 0.05, f"{name}: {got} vs {want}"


def test_clear_vs_encrypted_agreement(model):
    x, _ = create_similarity_dataset(n_samples=8, dim=model.input_dim)
    enc = model.predict_encrypted(x)
    assert np.abs(model.predict_clear(x) - enc).max() < 0.02
    # The quantized-clear simulation is EXACTLY the encrypted result.
    assert (model.predict_quantized_clear(x) == enc).all()
    assert model.predict_encrypted(x[0]).shape == (1,)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_save_load_across_packages(tmp_path, model, rt, writer):
    path = tmp_path / "model"
    if writer == "port":
        model.save(path)
        other = jax_similarity.FHESimilarityModel.load(path)
    else:
        j = jax_similarity.FHESimilarityModel(input_dim=128, n_bits=8)
        j.train()
        j.x_quant, j.w_quant = model.x_quant, model.w_quant
        j.save(path)
        other = j
    loaded = FHESimilarityModel.load(path, runtime=rt)
    x = np.linspace(-0.05, 0.05, model.input_dim)[None]
    assert loaded.coef_.tobytes() == model.coef_.tobytes() == other.coef_.tobytes()
    assert loaded.x_quant.state() == other.x_quant.state() == model.x_quant.state()
    assert (loaded.predict_clear(x) == model.predict_clear(x)).all()
    assert (loaded.predict_quantized_clear(x) == other.predict_quantized_clear(x)).all()
    assert (loaded.predict_encrypted(x) == model.predict_quantized_clear(x)).all()


# -- the polynomial-kernel family ----------------------------------------------------


@pytest.fixture(scope="module")
def poly():
    rt5 = FheRuntime("test-512-poly", device="cpu")
    rt5.generate_keys(seed=0)
    m = FHEPolynomialSimilarity(input_dim=64, preset="test-512-poly", scale=90)
    m.compile(runtime=rt5)
    return m


def test_poly_encrypted_exactly_equals_quantized_clear(poly):
    jm = jax_poly.FHEPolynomialSimilarity(input_dim=64, preset="test-512-poly", scale=90)
    rng = np.random.default_rng(7)
    for i in range(3):
        a, b = rng.standard_normal(64), rng.standard_normal(64)
        got = poly.predict_encrypted(a, b, seed=10 + i)
        assert got == poly.predict_quantized_clear(a, b) == jm.predict_quantized_clear(a, b)
    assert poly.predict_encrypted(a, b) == poly.predict_quantized_clear(a, b)
    assert poly.metrics["rotations"] == 6


def test_poly_probe_identities(poly):
    rng = np.random.default_rng(8)
    a = rng.standard_normal(64)
    assert abs(poly.predict_encrypted(a, a, seed=20) - 1.0) < 0.02
    assert abs(poly.predict_encrypted(a, -a, seed=21) - 0.0) < 0.02
    o = rng.standard_normal(64)
    o -= (o @ a) / (a @ a) * a
    assert abs(poly.predict_encrypted(a, o, seed=22) - 0.25) < 0.03


def test_poly_tracks_clear_path(poly):
    rng = np.random.default_rng(9)
    for i in range(2):
        a, b = rng.standard_normal(64), rng.standard_normal(64)
        assert abs(poly.predict_encrypted(a, b, seed=30 + i) - poly.predict_clear(a, b)) < 0.03


def test_poly_compile_rejections():
    with pytest.raises(ValueError, match="degree=2"):
        FHEPolynomialSimilarity(degree=3)
    with pytest.raises(ValueError, match="power of two"):
        FHEPolynomialSimilarity(input_dim=100)
    rt3 = FheRuntime("test-512-mult", rlk_levels=[], device="cpu")
    rt3.generate_keys(seed=0)
    with pytest.raises(ValueError, match="needs >= 5"):
        FHEPolynomialSimilarity(input_dim=64, preset="test-512-mult", scale=90).compile(
            runtime=rt3)
    rt5 = FheRuntime("test-512-poly", rlk_levels=[], device="cpu")
    rt5.generate_keys(seed=0)
    with pytest.raises(ValueError, match="exceeds t/2"):
        FHEPolynomialSimilarity(input_dim=64, preset="test-512-poly", scale=5000).compile(
            runtime=rt5)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_poly_save_load_across_packages(poly, tmp_path, writer):
    path = tmp_path / "poly"
    if writer == "jax":
        jax_poly.FHEPolynomialSimilarity(input_dim=64, preset="test-512-poly",
                                         scale=90).save(path)
    else:
        poly.save(path)
        jm = jax_poly.FHEPolynomialSimilarity.load(path)
        assert (jm.input_dim, jm.scale, jm.preset) == (64, 90, "test-512-poly")
    m2 = FHEPolynomialSimilarity.load(path, runtime=poly.runtime)
    assert (m2.input_dim, m2.scale, m2.preset) == (poly.input_dim, poly.scale, poly.preset)
    rng = np.random.default_rng(11)
    a, b = rng.standard_normal(64), rng.standard_normal(64)
    assert m2.predict_encrypted(a, b, seed=3) == poly.predict_quantized_clear(a, b)
