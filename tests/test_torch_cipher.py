"""Port keygen, encryption and decryption bit-exact against the JAX package.

The port's deterministic cores (`keygen_with`, `encrypt_sym_with`) are fed
the JAX package's own samples (same key splits as `cipher.keygen` and
`cipher.encrypt_sym`), so keys and ciphertexts must agree bit for bit.
Keys and ciphertexts cross between the packages through `interop`.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fhe_icp_tpu.ops import cipher as jc
from fhe_icp_tpu.ops.context import CryptoContext as JaxContext
from fhe_icp_tpu.ops.params import get_params as jax_params
from fhe_icp_tpu_torch import interop
from fhe_icp_tpu_torch.ops import cipher as tc
from fhe_icp_tpu_torch.ops.context import CryptoContext
from fhe_icp_tpu_torch.ops.params import get_params


@functools.lru_cache(maxsize=None)
def _ctxs(preset):
    return JaxContext(jax_params(preset)), CryptoContext(get_params(preset), device="cpu")


@functools.lru_cache(maxsize=None)
def _jax_keys(preset, seed=0):
    jctx, _ = _ctxs(preset)
    return jax.jit(lambda k: jc.keygen(jctx, k, rlk_levels=[]))(jax.random.PRNGKey(seed))


def _arrays(ks):
    return {"s": np.asarray(ks.sk.s), "s_ntt_mont": np.asarray(ks.sk.s_ntt_mont),
            "s2_ntt_mont": np.asarray(ks.sk.s2_ntt_mont),
            "pk_b": np.asarray(ks.pk.b_ntt), "pk_a": np.asarray(ks.pk.a_ntt)}


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _messages(ctx, shape, seed, bound=1000):
    rng = np.random.default_rng(seed)
    return rng.integers(-bound, bound + 1, size=shape + (ctx.n,)).astype(np.int32)


@pytest.mark.parametrize("preset", ["test-512", "test-512-mult"])
def test_keygen_core_matches_jax(preset):
    jctx, tctx = _ctxs(preset)
    k_s, k_a, k_e, _ = jax.random.split(jax.random.PRNGKey(0), 4)
    s = jc.sample_ternary(k_s, (jctx.n,))
    a = jc.sample_uniform(jctx, k_a, (), jctx.n_limbs)
    e = jc.sample_cbd(jctx, k_e, ())
    ks = tc.keygen_with(tctx, torch.from_numpy(np.array(s)),
                        torch.from_numpy(np.array(a)), torch.from_numpy(np.array(e)))
    got = interop.keys_to_arrays(ks)
    for name, want in _arrays(_jax_keys(preset)).items():
        _eq(got[name], want)


@pytest.mark.parametrize("shape", [(), (3,)])
def test_encrypt_core_matches_jax(shape):
    jctx, tctx = _ctxs("test-512")
    jks = _jax_keys("test-512")
    key = jax.random.PRNGKey(11)
    m = _messages(jctx, shape, seed=1)
    want = jax.jit(lambda sk, k, mm: jc.encrypt_sym(jctx, sk, k, mm).data)(
        jks.sk, key, jnp.asarray(m))
    k_a, k_e = jax.random.split(key)
    a = jc.sample_uniform(jctx, k_a, shape, jctx.n_limbs)
    e = jc.sample_cbd(jctx, k_e, shape)
    tks = interop.keys_from_arrays(tctx, _arrays(jks))
    ct = tc.encrypt_sym_with(tctx, tks.sk, torch.from_numpy(np.array(a)),
                             torch.from_numpy(np.array(e)), torch.from_numpy(m))
    assert ct.level == jctx.n_limbs and ct.pt_corr == 1
    _eq(ct.data, want)


def test_cross_decryption():
    jctx, tctx = _ctxs("test-512")
    jks = _jax_keys("test-512")
    tks = interop.keys_from_arrays(tctx, _arrays(jks))
    m = _messages(jctx, (4,), seed=2, bound=jctx.t // 2 - 1)
    # JAX encrypts, the port decrypts.
    jct = jax.jit(lambda sk, k, mm: jc.encrypt_sym(jctx, sk, k, mm))(
        jks.sk, jax.random.PRNGKey(3), jnp.asarray(m))
    data, level, corr = np.asarray(jct.data), jct.level, jct.pt_corr
    tct = interop.ciphertext_from_array(data, level, corr, device="cpu")
    _eq(tc.decrypt(tctx, tks.sk, tct), m)
    # The port encrypts with its own generator, JAX decrypts.
    gen = torch.Generator().manual_seed(4)
    pct = tc.encrypt_sym(tctx, tks.sk, gen, torch.from_numpy(m))
    data, level, corr = interop.ciphertext_to_array(pct)
    back = jax.jit(lambda sk, d: jc.decrypt(jctx, sk, jc.Ciphertext(d, level, True, corr)))(
        jks.sk, jnp.asarray(data))
    _eq(back, m)


def test_port_keygen_decrypts_in_jax():
    """Keys made by the port serve the JAX package: its decrypt is exact."""
    jctx, tctx = _ctxs("test-512")
    tks = tc.keygen(tctx, torch.Generator().manual_seed(5))
    arr = interop.keys_to_arrays(tks)
    jsk = jc.SecretKey(jnp.asarray(arr["s"]), jnp.asarray(arr["s_ntt_mont"]),
                       jnp.asarray(arr["s2_ntt_mont"]))
    m = _messages(jctx, (2,), seed=6)
    pct = tc.encrypt_sym(tctx, tks.sk, torch.Generator().manual_seed(6), torch.from_numpy(m))
    got = jax.jit(lambda sk, d: jc.decrypt(jctx, sk, jc.Ciphertext(d, 2, True, 1)))(
        jsk, jnp.asarray(pct.data.numpy()))
    _eq(got, m)
    # Relinearization keys are drawn after s, a, e: the same seed keeps its sk and pk.
    with_rlk = tc.keygen(tctx, torch.Generator().manual_seed(5), rlk_levels=[2])
    assert with_rlk.rlk[2].shape == (2, 2, 3, tctx.n)
    assert torch.equal(with_rlk.sk.s_ntt_mont, tks.sk.s_ntt_mont)
    assert torch.equal(with_rlk.pk.b_ntt, tks.pk.b_ntt)


@pytest.mark.parametrize("level", [1, 2, 3])
@pytest.mark.parametrize("pt_corr", [1, 12345])
def test_rns_decode_matches_jax(level, pt_corr):
    jctx, tctx = _ctxs("test-512-mult")
    rng = np.random.default_rng(level * 10 + pt_corr % 7)
    ps = np.asarray(jctx.primes[:level], dtype=np.uint64)[:, None]
    x = (rng.integers(0, 2 ** 31, size=(3, level, jctx.n)).astype(np.uint64) % ps)
    x = x.astype(np.uint32)
    # Residues at the rounding boundary: x = q/2 and its neighbours.
    q = jctx.q_at(level)
    for i, v in enumerate((q // 2 - 1, q // 2, q // 2 + 1, 0, q - 1)):
        x[0, :, i] = [v % p for p in jctx.primes[:level]]
    want = jax.jit(lambda v: jc.rns_decode_centered(jctx, v, level, pt_corr))(jnp.asarray(x))
    _eq(tc.rns_decode_centered(tctx, torch.from_numpy(x), level, pt_corr), want)


def test_decrypt_coeff_matches_jax():
    jctx, tctx = _ctxs("test-512")
    jks = _jax_keys("test-512")
    tks = interop.keys_from_arrays(tctx, _arrays(jks))
    m = _messages(jctx, (3,), seed=7)
    jct = jax.jit(lambda sk, k, mm: jc.encrypt_sym(jctx, sk, k, mm))(
        jks.sk, jax.random.PRNGKey(8), jnp.asarray(m))
    tct = interop.ciphertext_from_array(np.asarray(jct.data), jct.level, device="cpu")
    for j in (0, 127, jctx.n - 1):
        want = jax.jit(lambda sk, d: jc.decrypt_coeff(
            jctx, sk, jc.Ciphertext(d, 2, True, 1), j))(jks.sk, jct.data)
        got = tc.decrypt_coeff(tctx, tks.sk, tct, j)
        _eq(got, want)
        _eq(got, m[:, j])
    _eq(tc.coeff_weights(tctx, 5, 2), jc.coeff_weights(jctx, 5, 2))


def test_samplers():
    _, tctx = _ctxs("test-512")
    gen = torch.Generator().manual_seed(0)
    s = tc.sample_ternary(gen, (64, tctx.n), "cpu")
    assert set(s.unique().tolist()) == {-1, 0, 1}
    assert abs(s.double().mean().item()) < 0.02
    u = tc.sample_uniform(tctx, gen, (64,), 2).to(torch.int64)
    for j, p in enumerate(tctx.primes):
        uj = u[:, j].double()
        assert u[:, j].min() >= 0 and u[:, j].max() < p
        assert abs(uj.mean().item() / p - 0.5) < 0.01
    e = tc.sample_cbd(tctx, gen, (64,)).double()
    assert e.abs().max() <= tctx.params.cbd_k
    assert abs(e.mean().item()) < 0.05
    assert abs(e.var().item() - tctx.params.cbd_k / 2) < 0.3


def test_interop_roundtrip():
    _, tctx = _ctxs("test-512")
    arr = _arrays(_jax_keys("test-512"))
    arr["rlk_2"] = np.arange(24, dtype=np.uint32).reshape(2, 3, 4)
    back = interop.keys_to_arrays(interop.keys_from_arrays(tctx, arr))
    assert sorted(back) == sorted(arr)
    for name in arr:
        _eq(back[name], arr[name])
    with pytest.raises(ValueError):
        interop.keys_from_arrays(tctx, {**arr, "pk_a": arr["pk_a"][:1]})
