"""The port's key manager, and one key directory serving both packages.

Mirrors the key tests of tests/test_pipeline.py on the port (test-512-mult,
3 limbs); then a key directory made by either package loads in the other,
each package decrypts the other's ciphertexts under it, and a re-key file
made by either package re-keys the other's ciphertexts.  Tolerance: none.
"""

import functools
import shutil
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fhe_icp_tpu import keymgr as jax_keymgr
from fhe_icp_tpu.ops import arith as ja
from fhe_icp_tpu.ops import cipher as jc
from fhe_icp_tpu_torch import interop
from fhe_icp_tpu_torch.keymgr import FHEKeyManager
from fhe_icp_tpu_torch.ops import arith as ta

PRESET = "test-512-mult"


@pytest.fixture(autouse=True)
def master_password(monkeypatch):
    monkeypatch.setenv("FHE_MASTER_PASSWORD", "test-password-123")


def _km(path):
    return FHEKeyManager(str(path), preset=PRESET, device="cpu")


def _msg(seed, shape=(2,)):
    rng = np.random.default_rng(seed)
    return rng.integers(-1000, 1001, size=shape + (512,)).astype(np.int32)


def test_generate_and_list(tmp_path):
    km = _km(tmp_path / "keys")
    assert km.generate_keys("k1", seed=7) == "k1"
    assert km.list_keys() == ["k1"]
    assert km.get_current_key() == "k1"


def test_key_files_0600(tmp_path):
    km = _km(tmp_path / "keys")
    km.generate_keys("k1", seed=7)
    for name in ("k1.sk.enc", "k1.pub", "salt.bin", "verify.token", "metadata.json"):
        assert oct((tmp_path / "keys" / name).stat().st_mode)[-3:] == "600", name


def test_load_roundtrip_decrypts(tmp_path):
    km = _km(tmp_path / "keys")
    km.generate_keys("k1", seed=7)
    rt = km.load_keyset("k1")
    assert rt.device.type == "cpu" and sorted(rt.keys.rlk) == [2, 3]
    m = np.arange(rt.ctx.n, dtype=np.int32) % 101 - 50
    assert (rt.decrypt(rt.encrypt(m, seed=3)).numpy() == m).all()


def test_wrong_password_rejected(tmp_path, monkeypatch):
    _km(tmp_path / "keys").generate_keys("k1", seed=7)
    monkeypatch.setenv("FHE_MASTER_PASSWORD", "wrong")
    with pytest.raises(ValueError, match="password"):
        _km(tmp_path / "keys").load_keyset("k1")


def test_rotation_grace(tmp_path):
    km = _km(tmp_path / "keys")
    km.generate_keys("k1", seed=7)
    new_id = km.rotate_keys(grace_period_days=3)
    assert new_id != "k1" and km.get_current_key() == new_id
    info = km.key_info("k1")
    assert info["status"] == "rotated"
    assert info["grace_until"] > time.time()
    assert info["size_bytes"] > 0


@functools.lru_cache(maxsize=None)
def _jax_rt():
    from fhe_icp_tpu.ops.runtime import FheRuntime as JaxRuntime
    return JaxRuntime(PRESET)


@functools.lru_cache(maxsize=None)
def _jax_encrypt():
    ctx = _jax_rt().ctx
    return jax.jit(lambda sk, k, m: jc.encrypt_sym(ctx, sk, k, m).data)


@functools.lru_cache(maxsize=None)
def _jax_rekey():
    ctx = _jax_rt().ctx
    return jax.jit(lambda k, d: ja.rekey(ctx, k, jc.Ciphertext(d, 3, True)).data)


@pytest.fixture(scope="module")
def jax_keys(tmp_path_factory):
    """A key directory with keys "old" (seed 1) and "new" (seed 2) made by the JAX package."""
    kdir = tmp_path_factory.mktemp("jax_keys") / "keys"
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FHE_MASTER_PASSWORD", "test-password-123")
        jkm = jax_keymgr.FHEKeyManager(str(kdir), preset=PRESET)
        jkm.generate_keys("old", seed=1)
        jkm.generate_keys("new", seed=2)
    return kdir


def _jax_load(key_dir, key_id):
    return jax_keymgr.FHEKeyManager(str(key_dir), preset=PRESET).load_keyset(
        key_id, runtime=_jax_rt())


def _jax_decrypt(rt, data, level=3):
    return np.asarray(jax.jit(lambda sk, d: jc.decrypt(
        rt.ctx, sk, jc.Ciphertext(d, level, True, 1)))(rt.keys.sk, jnp.asarray(data)))


@pytest.mark.parametrize("maker", ["jax", "port"])
def test_key_directory_serves_both_packages(tmp_path, maker, jax_keys):
    """Keys made by one package load bit-identically in the other (salt,
    verify token and Fernet files included), and each package decrypts
    the other's ciphertexts."""
    kdir = tmp_path / "keys"
    if maker == "jax":
        shutil.copytree(jax_keys, kdir)
    else:
        _km(kdir).generate_keys("old", seed=7)
    jrt = _jax_load(kdir, "old")
    trt = _km(kdir).load_keyset("old")
    jarr = {"s": jrt.keys.sk.s, "s_ntt_mont": jrt.keys.sk.s_ntt_mont,
            "s2_ntt_mont": jrt.keys.sk.s2_ntt_mont, "pk_b": jrt.keys.pk.b_ntt,
            "pk_a": jrt.keys.pk.a_ntt,
            **{f"rlk_{lv}": v for lv, v in jrt.keys.rlk.keys.items()}}
    tarr = interop.keys_to_arrays(trt.keys)
    assert sorted(jarr) == sorted(tarr)
    for name, v in jarr.items():
        np.testing.assert_array_equal(tarr[name], np.asarray(v), err_msg=name)
    m = _msg(1)
    jct = _jax_encrypt()(jrt.keys.sk, jax.random.PRNGKey(2), jnp.asarray(m))
    got = trt.decrypt(interop.ciphertext_from_array(np.asarray(jct), 3, device="cpu"))
    np.testing.assert_array_equal(got.numpy(), m)
    pct = trt.encrypt(m)
    np.testing.assert_array_equal(_jax_decrypt(jrt, pct.data.numpy()), m)
    # The same keys through the other package's product: relinearized dot.
    a, b = _msg(3, (2,))[:, :128]
    prod = trt.dot_ct_ct(trt.encrypt_vector(a), trt.encrypt_vector(b, rev=True))
    assert int(trt.decrypt_dot(prod, 128)) == int(a.astype(np.int64) @ b)


@pytest.mark.parametrize("maker", ["jax", "port"])
def test_rekey_file_serves_both_packages(tmp_path, maker, jax_keys):
    """A re-key file made by either package re-keys ciphertexts in both,
    bit-identically, and they decrypt under the new key only."""
    kdir = tmp_path / "keys"
    shutil.copytree(jax_keys, kdir)
    if maker == "jax":
        jax_keymgr.FHEKeyManager(str(kdir), preset=PRESET).make_rekey_key("old", "new")
    else:
        _km(kdir).make_rekey_key("old", "new")
    tksks = _km(kdir).load_rekey_key("old", "new")
    jksks = jax_keymgr.FHEKeyManager(str(kdir), preset=PRESET).load_rekey_key("old", "new")
    assert sorted(tksks) == sorted(jksks) == [2, 3]
    old_rt = _km(kdir).load_keyset("old")
    new_rt = _km(kdir).load_keyset("new")
    m = _msg(4, (3,))
    ct = old_rt.encrypt(m, seed=5)
    got = ta.rekey(new_rt.ctx, tksks[3], ct)
    want = np.asarray(_jax_rekey()(jksks[3], jnp.asarray(ct.data.numpy())))
    np.testing.assert_array_equal(got.data.numpy(), want)
    np.testing.assert_array_equal(new_rt.decrypt(got).numpy(), m)
    assert not (old_rt.decrypt(got).numpy() == m).all()
