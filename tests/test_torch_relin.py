"""Port keyswitching and relinearization bit-exact against the JAX package.

Keys come from the JAX package (keygen with relinearization keys at
test-512-mult, 3 limbs) and are carried to the port through `interop`; the
port's deterministic cores are fed the JAX package's own samples (its key
split sequences).  Every branch of `hybrid_keyswitch_apply` (batch 1 with
the single-polynomial squeeze, a small batch, a batch of `_REUSE_MIN_BATCH`
or more, 16-bit digits, two leading batch axes) and of `_div_special` is
reached.  Tolerance: none on uint32 data, exact on decrypted integers.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fhe_icp_tpu.ops import arith as ja
from fhe_icp_tpu.ops import cipher as jc
from fhe_icp_tpu.ops import dot as jdot
from fhe_icp_tpu.ops.context import CryptoContext as JaxContext
from fhe_icp_tpu.ops.encoding import encode_fwd as jencode_fwd
from fhe_icp_tpu.ops.encoding import encode_rev as jencode_rev
from fhe_icp_tpu.ops.modmath import mont_mul as jmont_mul
from fhe_icp_tpu.ops.params import get_params as jax_params
from fhe_icp_tpu_torch import interop
from fhe_icp_tpu_torch.ops import arith as ta
from fhe_icp_tpu_torch.ops import cipher as tc
from fhe_icp_tpu_torch.ops import dot as tdot
from fhe_icp_tpu_torch.ops.context import CryptoContext
from fhe_icp_tpu_torch.ops.params import get_params
from fhe_icp_tpu_torch.ops.runtime import FheRuntime

PRESET, D = "test-512-mult", 128


@functools.lru_cache(maxsize=None)
def _setup():
    jctx = JaxContext(jax_params(PRESET))
    tctx = CryptoContext(get_params(PRESET), device="cpu")
    jks = jax.jit(lambda k: jc.keygen(jctx, k, rlk_levels=[2, 3]))(jax.random.PRNGKey(0))
    arrays = {"s": jks.sk.s, "s_ntt_mont": jks.sk.s_ntt_mont, "s2_ntt_mont": jks.sk.s2_ntt_mont,
              "pk_b": jks.pk.b_ntt, "pk_a": jks.pk.a_ntt,
              **{f"rlk_{lv}": v for lv, v in jks.rlk.keys.items()}}
    tks = interop.keys_from_arrays(tctx, {k: np.asarray(v) for k, v in arrays.items()})
    return jctx, tctx, jks, tks


@functools.lru_cache(maxsize=None)
def _cts(batch, seed):
    """JAX encryptions of (batch, D) vectors, ascending and reversed, level 3."""
    jctx, _, jks, _ = _setup()
    rng = np.random.default_rng(seed)
    vecs = rng.integers(-1000, 1001, size=(2, batch, D)).astype(np.int32)
    enc = jax.jit(lambda sk, k, m: jc.encrypt_sym(jctx, sk, k, m).data)
    fwd = enc(jks.sk, jax.random.PRNGKey(seed), jencode_fwd(jnp.asarray(vecs[0]), jctx.n))
    rev = enc(jks.sk, jax.random.PRNGKey(seed + 1), jencode_rev(jnp.asarray(vecs[1]), jctx.n))
    return vecs, np.asarray(fwd), np.asarray(rev)


def _t(a, dtype=None):
    return torch.from_numpy(np.array(a, dtype=dtype))


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _jax_normal(jctx, x_mont, lv):
    return jmont_mul(x_mont[:lv], jnp.uint32(1), jctx.lp(lv), jctx.lpinv(lv))


@functools.lru_cache(maxsize=None)
def _jax_fine_key(l):
    """A JAX hybrid key s^2 -> s with 16-bit digits at level l."""
    jctx, _, jks, _ = _setup()
    target = jax.jit(lambda x: _jax_normal(jctx, x, l))(jks.sk.s2_ntt_mont)
    return jax.jit(lambda k, sk, tg: jc.hybrid_keyswitch_key(jctx, k, sk, tg, l, 16))(
        jax.random.PRNGKey(31), jks.sk, target)


def _hybrid_samples(jctx, key, lv, digit_bits):
    """The JAX package's samples for one hybrid key: split(key, 3) per digit."""
    d_per = 1 if digit_bits == 0 else -(-31 // digit_bits)
    primes = jctx.hybrid(lv).plan.primes
    a, e = [], []
    for _ in range(lv * d_per):
        key, ka, ke = jax.random.split(key, 3)
        a.append(np.asarray(jc.sample_uniform_primes(ka, (), primes, jctx.n)))
        e.append(np.asarray(jc.sample_cbd(jctx, ke, ())))
    return _t(np.stack(a)), _t(np.stack(e))


@pytest.mark.parametrize("digit_bits", [0, 16])
@pytest.mark.parametrize("lv", [2, 3])
def test_hybrid_keyswitch_key_core_matches_jax(lv, digit_bits):
    jctx, tctx, jks, tks = _setup()
    key = jax.random.PRNGKey(10 + lv + digit_bits)
    target = jax.jit(lambda x: _jax_normal(jctx, x, lv))(jks.sk.s2_ntt_mont)
    want = jax.jit(lambda k, sk, tg: jc.hybrid_keyswitch_key(jctx, k, sk, tg, lv, digit_bits))(
        key, jks.sk, target)
    a, e = _hybrid_samples(jctx, key, lv, digit_bits)
    got = tc.hybrid_keyswitch_key_with(tctx, tks.sk, _t(target), lv, a, e, digit_bits)
    assert got.shape == (lv * (1 if digit_bits == 0 else 2), 2, lv + 1, tctx.n)
    _eq(got, want)


@pytest.mark.parametrize("lv", [2, 3])
def test_gadget_keyswitch_key_core_matches_jax(lv):
    jctx, tctx, jks, tks = _setup()
    key = jax.random.PRNGKey(20 + lv)
    target = jax.jit(lambda x: _jax_normal(jctx, x, lv))(jks.sk.s2_ntt_mont)
    want = jax.jit(lambda k, s, tg: jc.gadget_keyswitch_key(jctx, k, s, tg, lv))(
        key, jks.sk.s_ntt_mont, target)
    a, e = [], []
    for _ in range(lv):
        key, ka, ke = jax.random.split(key, 3)
        a.append(np.asarray(jc.sample_uniform(jctx, ka, (), lv)))
        e.append(np.asarray(jc.sample_cbd(jctx, ke, ())))
    got = tc.gadget_keyswitch_key_with(tctx, tks.sk.s_ntt_mont, _t(target), lv,
                                       _t(np.stack(a)), _t(np.stack(e)))
    _eq(got, want)


def test_keygen_relinearization_keys_match_jax():
    """JAX keygen's rlk: split(key, 4)[3], then split per level, then per digit."""
    jctx, tctx, jks, tks = _setup()
    k_rlk = jax.random.split(jax.random.PRNGKey(0), 4)[3]
    for lv in (2, 3):
        k_rlk, k_lv = jax.random.split(k_rlk)
        a, e = _hybrid_samples(jctx, k_lv, lv, 0)
        got = tc.hybrid_keyswitch_key_with(tctx, tks.sk, tc.normal_form(tctx, tks.sk.s2_ntt_mont,
                                                                        lv), lv, a, e)
        _eq(got, jks.rlk.keys[lv])
        _eq(tks.rlk[lv], jks.rlk.keys[lv])


def test_port_keygen_draw_order():
    """Relinearization samples are drawn after s, a, e: sk and pk do not depend
    on rlk_levels; the default makes keys at every level >= 2."""
    _, tctx, _, _ = _setup()
    none = tc.keygen(tctx, torch.Generator().manual_seed(3), rlk_levels=[])
    full = tc.keygen(tctx, torch.Generator().manual_seed(3))
    assert none.rlk == {} and sorted(full.rlk) == [2, 3]
    assert full.rlk[3].shape == (3, 2, 4, tctx.n)
    for a, b in ((none.sk.s, full.sk.s), (none.sk.s_ntt_mont, full.sk.s_ntt_mont),
                 (none.pk.b_ntt, full.pk.b_ntt), (none.pk.a_ntt, full.pk.a_ntt)):
        assert torch.equal(a, b)


# (name, lead shape of c, digit_bits): each reaches one regime of the keyswitch.
REGIMES = [("single poly (squeeze)", (), 0), ("small batch", (4,), 0),
           ("batch >= _REUSE_MIN_BATCH", (ta._REUSE_MIN_BATCH,), 0),
           ("two leading axes", (2, 3), 0), ("16-bit digits", (3,), 16),
           ("16-bit digits, squeeze", (), 16)]


@pytest.mark.parametrize("name,lead,digit_bits", REGIMES, ids=[r[0] for r in REGIMES])
def test_hybrid_keyswitch_apply_matches_jax(name, lead, digit_bits):
    jctx, tctx, jks, tks = _setup()
    l = 3
    jkey = _jax_fine_key(l) if digit_bits else jks.rlk.keys[l]
    tkey = interop.rekey_keys_from_arrays({f"ksk_{l}": np.asarray(jkey)}, device="cpu")[l]
    rng = np.random.default_rng(len(lead) * 7 + digit_bits)
    ps = np.asarray(jctx.primes[:l], dtype=np.uint64)[:, None]
    c = (rng.integers(0, 2 ** 31, size=lead + (l, jctx.n), dtype=np.uint64) % ps).astype(np.uint32)
    w0, w1 = jax.jit(lambda k, x: ja.hybrid_keyswitch_apply(jctx, k, x, l))(jkey, jnp.asarray(c))
    d0, d1 = ta.hybrid_keyswitch_apply(tctx, tkey, _t(c), l)
    assert d0.shape == c.shape and d1.shape == c.shape
    _eq(d0, w0)
    _eq(d1, w1)
    e0, e1 = ta.keyswitch_apply(tctx, tkey, _t(c), l)
    assert torch.equal(e0, d0) and torch.equal(e1, d1)


@pytest.mark.parametrize("lead", [(3,), (2, 2)])
def test_gadget_keyswitch_apply_matches_jax(lead):
    jctx, tctx, jks, tks = _setup()
    l = 3
    target = jax.jit(lambda x: _jax_normal(jctx, x, l))(jks.sk.s2_ntt_mont)
    jkey = jax.jit(lambda k, s, tg: jc.gadget_keyswitch_key(jctx, k, s, tg, l))(
        jax.random.PRNGKey(41), jks.sk.s_ntt_mont, target)
    rng = np.random.default_rng(4)
    ps = np.asarray(jctx.primes[:l], dtype=np.uint64)[:, None]
    c = (rng.integers(0, 2 ** 31, size=lead + (l, jctx.n), dtype=np.uint64) % ps).astype(np.uint32)
    w0, w1 = jax.jit(lambda k, x: ja.gadget_keyswitch_apply(jctx, k, x, l))(jkey, jnp.asarray(c))
    tkey = _t(jkey)
    d0, d1 = ta.gadget_keyswitch_apply(tctx, tkey, _t(c), l)
    _eq(d0, w0)
    _eq(d1, w1)
    e0, _ = ta.keyswitch_apply(tctx, tkey, _t(c), l)          # dispatch by key shape
    assert torch.equal(e0, d0)


@pytest.mark.parametrize("rows", [4, ta._REUSE_MIN_BATCH + 8])
@pytest.mark.parametrize("l", [2, 3])
def test_div_special_regimes_match_jax(rows, l):
    jctx, tctx, _, _ = _setup()
    ht_j, ht_t = jctx.hybrid(l), tctx.hybrid(l)
    rng = np.random.default_rng(rows + l)
    ps = np.asarray(ht_j.plan.primes, dtype=np.uint64)[:, None]
    x = (rng.integers(0, 2 ** 31, size=(rows, l + 1, jctx.n), dtype=np.uint64) % ps)
    x = x.astype(np.uint32)
    want = jax.jit(lambda v: ja._div_special(jctx, ht_j, v, l))(jnp.asarray(x))
    _eq(ta._div_special(tctx, ht_t, _t(x), l), want)


def test_hybrid_tables_match_jax():
    jctx, tctx, _, _ = _setup()
    for l in (2, 3):
        hj, ht = jctx.hybrid(l), tctx.hybrid(l)
        assert ht.plan.primes == hj.plan.primes
        for name in ("p", "pinv", "r2", "mu", "t_mont", "t_inv_mont_sp", "sp_half", "sp_mod_pi",
                     "inv_sp_mont", "t_inv_sp_mont"):
            _eq(getattr(ht, name), getattr(hj, name))
        assert tctx.hybrid(l) is ht
    with pytest.raises(ValueError):
        tctx.hybrid(1)


@pytest.mark.parametrize("batch", [1, 3])
def test_relinearize_and_dot_ct_ct_match_jax(batch):
    jctx, tctx, jks, tks = _setup()
    vecs, fwd, rev = _cts(batch, seed=50 + batch)
    mk = functools.partial(jc.Ciphertext, level=3, is_ntt=True)
    want = jax.jit(lambda rk, a, b: jdot.dot_ct_ct(jctx, rk, mk(a), mk(b)).data)(
        jks.rlk.keys, fwd, rev)
    ta_, tb_ = (interop.ciphertext_from_array(x, 3, device="cpu") for x in (fwd, rev))
    prod = ta.mul_ct(tctx, ta_, tb_)
    relin = ta.relinearize(tctx, tks.rlk, prod)
    _eq(relin.data, want)
    _eq(tdot.dot_ct_ct(tctx, tks.rlk, ta_, tb_).data, want)
    oracle = (vecs[0].astype(np.int64) * vecs[1]).sum(-1)
    _eq(tdot.decrypt_dot(tctx, tks.sk, relin, D), oracle)
    _eq(tdot.decrypt_dot(tctx, tks.sk, tdot.dot_ct_ct_deg2(tctx, ta_, tb_), D), oracle)


def test_all_pairs_batch_regime_matches_jax():
    """The config-2 shape, fwd[:, None] x rev[None, :]: 36 products, the
    batch >= _REUSE_MIN_BATCH regime, with the matrix docs @ docs.T."""
    jctx, tctx, jks, tks = _setup()
    vecs, fwd, rev = _cts(6, seed=60)
    mk = functools.partial(jc.Ciphertext, level=3, is_ntt=True)
    want = jax.jit(lambda rk, a, b: jdot.dot_ct_ct(jctx, rk, mk(a[:, None]), mk(b[None])).data)(
        jks.rlk.keys, fwd, rev)
    a = tc.Ciphertext(_t(fwd)[:, None], 3)
    b = tc.Ciphertext(_t(rev)[None], 3)
    got = tdot.dot_ct_ct(tctx, tks.rlk, a, b)
    _eq(got.data, want)
    _eq(tdot.decrypt_dot(tctx, tks.sk, got, D), vecs[0].astype(np.int64) @ vecs[1].T)


def test_cross_decryption_of_relinearized_products():
    """Keys sampled by the port: the port relinearizes, JAX decrypts; and JAX
    relinearizes under the port's keys, the port decrypts."""
    jctx, tctx, _, _ = _setup()
    rt = FheRuntime(PRESET, device="cpu")
    rt.generate_keys(seed=7)
    arr = interop.keys_to_arrays(rt.keys)
    jsk = jc.SecretKey(*(jnp.asarray(arr[k]) for k in ("s", "s_ntt_mont", "s2_ntt_mont")))
    rng = np.random.default_rng(8)
    a, b = rng.integers(-1000, 1001, size=(2, 2, D)).astype(np.int32)
    ca, cb = rt.encrypt_vector(a, seed=1), rt.encrypt_vector(b, seed=2, rev=True)
    prod = rt.dot_ct_ct(ca, cb)
    got = jax.jit(lambda sk, d: jdot.decrypt_dot(jctx, sk, jc.Ciphertext(d, 3, True, 1), D))(
        jsk, jnp.asarray(prod.data.numpy()))
    oracle = (a.astype(np.int64) * b).sum(-1)
    _eq(got, oracle)
    rlk = {lv: jnp.asarray(arr[f"rlk_{lv}"]) for lv in (2, 3)}
    jprod = jax.jit(lambda rk, x, y: jdot.dot_ct_ct(jctx, rk, jc.Ciphertext(x, 3, True),
                                                    jc.Ciphertext(y, 3, True)).data)(
        rlk, jnp.asarray(ca.data.numpy()), jnp.asarray(cb.data.numpy()))
    _eq(jprod, prod.data)
    _eq(rt.decrypt_dot(interop.ciphertext_from_array(np.asarray(jprod), 3, device="cpu"), D),
        oracle)


@pytest.mark.parametrize("shape", [(), (2,)])
def test_encrypt_pk_core_matches_jax(shape):
    jctx, tctx, jks, tks = _setup()
    key = jax.random.PRNGKey(70)
    rng = np.random.default_rng(9)
    m = rng.integers(-1000, 1001, size=shape + (jctx.n,)).astype(np.int32)
    want = jax.jit(lambda pk, k, mm: jc.encrypt_pk(jctx, pk, k, mm).data)(jks.pk, key,
                                                                          jnp.asarray(m))
    k_u, k_e0, k_e1 = jax.random.split(key, 3)
    u = jc.sample_ternary(k_u, shape + (jctx.n,))
    e0, e1 = jc.sample_cbd(jctx, k_e0, shape), jc.sample_cbd(jctx, k_e1, shape)
    ct = tc.encrypt_pk_with(tctx, tks.pk, _t(u), _t(e0), _t(e1), _t(m))
    _eq(ct.data, want)
    _eq(tc.decrypt(tctx, tks.sk, ct), m)


def test_runtime_end_to_end():
    """FheRuntime(device="cpu"): public encryption, mul_ct with and without
    relinearization, dot_ct_ct both ways, exact against the int64 oracle."""
    rt = FheRuntime(PRESET, rlk_levels=[3], device="cpu")
    rt.generate_keys(seed=11)
    assert sorted(rt.keys.rlk) == [3]
    rng = np.random.default_rng(12)
    a, b = rng.integers(-1000, 1001, size=(2, D)).astype(np.int32)
    oracle = int(a.astype(np.int64) @ b)
    ca, cb = rt.encrypt_vector(a, seed=1), rt.encrypt_vector(b, seed=2, rev=True)
    for relin in (True, False):
        prod = rt.dot_ct_ct(ca, cb, relinearize=relin)
        assert prod.k == (2 if relin else 3)
        assert int(rt.decrypt_dot(prod, D)) == oracle
        assert int(rt.decrypt_dot(rt.mul_ct(ca, cb, relinearize=relin), D)) == oracle
    m = rng.integers(-1000, 1001, size=(2, rt.ctx.n)).astype(np.int32)
    pub = rt.encrypt_public(m)
    _eq(rt.decrypt(pub), m)
    _eq(rt.decrypt(rt.sub(rt.add(pub, pub), rt.neg(pub))), 3 * m)
    assert int(rt.decrypt_dot(rt.dot_ct_pt(ca, b), D)) == oracle
    _eq(rt.decrypt_dot(rt.matvec(rt.encrypt_vector(np.stack([a, b]), seed=3), b), D),
        np.stack([a, b]).astype(np.int64) @ b)
