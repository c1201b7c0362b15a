"""The modulus switch's and the one-coefficient decrypt's kernels
(`ops/modswitch_cuda.py`) on the CPU.

The plain versions against per-coefficient Python-integer oracles: the lift
and the tail coefficient by coefficient; `arith.mod_switch` (K2's plain
transforms around both) by the exact CRT value of every switched
coefficient; `decrypt_coeff` by the CRT value of the decrypted coefficient
of the phase.  Shapes (R, l, N) = (2, 12, 64), (7, 3, 64), (64, 3, 128) and a
row of one; k = 2 and 3; pt_corr != 1.  Then the wrappers' refusals, and the
launch path's refusal of CPU tensors.  The kernels run only on the card
(`chip_smoke.py` holds them to these plain versions there); the JAX-parity
tests of `mod_switch` and `decrypt_dot` (`test_torch_arith.py`,
`_cipher.py`, `_dot.py`, `_relin.py`) reach them through the wrappers.
"""

import functools

import numpy as np
import pytest
import torch

from fhe_icp_tpu_torch.ops import arith, cipher
from fhe_icp_tpu_torch.ops import modswitch_cuda as ms
from fhe_icp_tpu_torch.ops.cipher import Ciphertext, SecretKey
from fhe_icp_tpu_torch.ops.context import CryptoContext
from fhe_icp_tpu_torch.ops.modmath import mont_mul, to_mont
from fhe_icp_tpu_torch.ops.ntt import ntt_fwd, ntt_inv
from fhe_icp_tpu_torch.ops.params import CryptoParams

R32 = 1 << 32


@functools.lru_cache(maxsize=None)
def _ctx(n, limbs):
    return CryptoContext(CryptoParams(f"ms-{n}-{limbs}", n=n, n_limbs=limbs,
                                      allow_insecure=True), device="cpu")


def _residues(rng, ctx, shape, l):
    """Uniform canonical residues (..., l, N) over the first l primes."""
    col = np.asarray(ctx.primes[:l], dtype=np.uint64)[:, None]
    x = rng.integers(0, R32, size=tuple(shape) + (l, ctx.n), dtype=np.uint64) % col
    return torch.from_numpy(x.astype(np.uint32))


def _crt(res, primes):
    """The integer in [0, q) with the given residues, q the product of primes."""
    q, x = 1, 0
    for p in primes:
        q *= p
    for r, p in zip(res, primes):
        qh = q // p
        x += int(r) * qh * pow(qh, -1, p)
    return x % q, q


def _centered(x, m):
    x %= m
    return x - m if x > m // 2 else x


# (R, l, N): rows of a ciphertext batch (B * k), limbs before the switch, ring.
SHAPES = [(2, 12, 64), (7, 3, 64), (64, 3, 128), (1, 12, 64)]
IDS = [f"R{r}-l{l}-N{n}" for r, l, n in SHAPES]


@pytest.mark.parametrize("r,l,n", SHAPES, ids=IDS)
def test_lift_matches_per_coefficient_oracle(r, l, n):
    ctx = _ctx(n, l)
    pd, t = ctx.primes[l - 1], ctx.t
    c = _residues(np.random.default_rng(r * 100 + l), ctx, (r,), l)[:, l - 1:].contiguous()
    got = ms.lift(ctx, c, l)
    assert got.dtype == torch.uint32 and tuple(got.shape) == (r, l - 1, n)
    want = np.zeros((r, l - 1, n), dtype=np.int64)
    t_inv = pow(t, -1, pd)
    for row in range(r):
        for x in range(n):
            delta = t * _centered(int(c[row, 0, x]) * t_inv % pd, pd)
            want[row, :, x] = [delta % p for p in ctx.primes[: l - 1]]
    assert np.array_equal(got.to(torch.int64).numpy(), want)


@pytest.mark.parametrize("r,l,n", SHAPES, ids=IDS)
def test_tail_matches_per_coefficient_oracle(r, l, n):
    ctx = _ctx(n, l)
    rng = np.random.default_rng(r * 100 + l + 1)
    x, delta = _residues(rng, ctx, (r,), l), _residues(rng, ctx, (r,), l - 1)
    got = ms.tail(ctx, x, delta, l)
    assert got.dtype == torch.uint32 and tuple(got.shape) == (r, l - 1, n)
    pd = ctx.primes[l - 1]
    x64, d64 = x.to(torch.int64).numpy(), delta.to(torch.int64).numpy()
    want = np.zeros((r, l - 1, n), dtype=np.int64)
    for i, p in enumerate(ctx.primes[: l - 1]):
        want[:, i] = (x64[:, i] - d64[:, i]) % p * pow(pd, -1, p) % p
    assert np.array_equal(got.to(torch.int64).numpy(), want)


# (B, l, N) of degree-1 ciphertexts (R = 2B rows); mod_switch needs l >= 3 here
# for its headroom check (q_{l-1} >= 4 t N).
SWITCH = [(1, 12, 64), (7, 3, 64), (32, 3, 128)]


@pytest.mark.parametrize("b,l,n", SWITCH, ids=[f"B{b}-l{l}-N{n}" for b, l, n in SWITCH])
def test_mod_switch_matches_crt_oracle(b, l, n):
    """Every switched coefficient c' satisfies c' * p_d = c - delta (mod q_l)
    with delta = 0 (mod t) and |delta| <= t * p_d / 2, exactly, as integers
    after CRT; pt_corr picks up p_d."""
    ctx = _ctx(n, l)
    pd, t = ctx.primes[l - 1], ctx.t
    ct = Ciphertext(_residues(np.random.default_rng(b + l), ctx, (b, 2), l), l, True, 5)
    out = arith.mod_switch(ctx, ct)
    assert out.level == l - 1 and out.pt_corr == 5 * pd % t
    assert tuple(out.data.shape) == (b, 2, l - 1, n)
    before = ntt_inv(ctx.plan, ct.data).to(torch.int64).numpy()
    after = ntt_inv(ctx.plan, out.data).to(torch.int64).numpy()
    for idx in np.ndindex(b, 2):
        for x in range(0, n, 7):
            c, q = _crt(before[idx][:, x], ctx.primes[:l])
            c2, _ = _crt(after[idx][:, x], ctx.primes[: l - 1])
            delta = _centered(c - c2 * pd, q)
            assert delta % t == 0 and abs(delta) <= t * pd // 2


def _secret(ctx, seed):
    s = torch.from_numpy(np.random.default_rng(seed).integers(-1, 2, size=ctx.n)
                         .astype(np.int32))
    l = ctx.n_limbs
    p, pinv = ctx.lp(l), ctx.lpinv(l)
    s_m = to_mont(ntt_fwd(ctx.plan, cipher.centered_residues(ctx, s, l)), p, pinv, ctx.lr2(l))
    return SecretKey(s=s, s_ntt_mont=s_m, s2_ntt_mont=mont_mul(s_m, s_m, p, pinv))


# (B, k, l, N, coefficient j, pt_corr)
DECRYPTS = [(2, 2, 12, 64, 63, 3), (7, 3, 3, 64, 0, 1), (64, 2, 3, 128, 127, 12345),
            (1, 3, 12, 64, 17, 7), (7, 2, 3, 64, 5, 1)]


@pytest.mark.parametrize("b,k,l,n,j,pt_corr", DECRYPTS,
                         ids=[f"B{b}-k{k}-l{l}-N{n}-j{j}-pt{pc}" for b, k, l, n, j, pc in DECRYPTS])
def test_decrypt_coeff_matches_crt_oracle(b, k, l, n, j, pt_corr):
    """Coefficient j of c0 + c1 s (+ c2 s^2): its exact CRT value mod q_l,
    centered, mod t, times pt_corr, centered."""
    ctx = _ctx(n, l)
    sk = _secret(ctx, seed=b + k)
    data = _residues(np.random.default_rng(b * 10 + k), ctx, (b, k), l)
    ct = Ciphertext(data, l, True, pt_corr)
    got = cipher.decrypt_coeff(ctx, sk, ct, j)
    assert got.dtype == torch.int32 and tuple(got.shape) == (b,)
    assert torch.equal(got, ms.decrypt_coeff_ref(ctx, sk, ct, cipher.coeff_weights(ctx, j, l)))
    d64 = data.to(torch.int64).numpy()
    phase = np.zeros((b, l, n), dtype=np.int64)
    for i, p in enumerate(ctx.primes[:l]):
        r_inv = pow(R32, -1, p)
        s = sk.s_ntt_mont[i].to(torch.int64).numpy() * r_inv % p
        s2 = sk.s2_ntt_mont[i].to(torch.int64).numpy() * r_inv % p
        phase[:, i] = (d64[:, 0, i] + d64[:, 1, i] * s % p) % p
        if k == 3:
            phase[:, i] = (phase[:, i] + d64[:, 2, i] * s2 % p) % p
    coeffs = ntt_inv(ctx.plan, torch.from_numpy(phase.astype(np.uint32))).to(torch.int64)
    t = ctx.t
    for row in range(b):
        x, q = _crt(coeffs[row, :, j].numpy(), ctx.primes[:l])
        assert int(got[row]) == _centered(_centered(x, q) * pt_corr, t)


def test_decrypt_coeff_after_mod_switch_reads_the_message():
    """Encrypt, switch twice (pt_corr != 1), decrypt one coefficient: the message."""
    ctx = _ctx(64, 4)
    ks = cipher.keygen(ctx, torch.Generator().manual_seed(3), rlk_levels=[])
    m = torch.from_numpy(np.random.default_rng(4).integers(-1000, 1001, size=(3, 64))
                         .astype(np.int32))
    ct = arith.mod_switch_to(ctx, cipher.encrypt_sym(ctx, ks.sk, torch.Generator()
                                                     .manual_seed(5), m), 2)
    assert ct.pt_corr != 1
    for j in (0, 31, 63):
        assert torch.equal(cipher.decrypt_coeff(ctx, ks.sk, ct, j), m[:, j])


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------


def _meta(x):
    return torch.empty(x.shape, dtype=x.dtype, device="meta")


def _noncontig(x):
    return x.transpose(0, 1).contiguous().transpose(0, 1)


def _lift_args(case):
    ctx, l = _ctx(64, 3), 3
    c = _residues(np.random.default_rng(0), ctx, (4,), l)[:, 2:].contiguous()
    if case == "int64":
        c = c.to(torch.int64)
    elif case == "two limbs":
        c = _residues(np.random.default_rng(0), ctx, (4,), 2)
    elif case == "level 1":
        l = 1
    elif case == "level above the chain":
        l = 4
    elif case == "another device":
        c = _meta(c)
    elif case == "non-contiguous":
        c = torch.cat([c, c], dim=2)[:, :, ::2]
    return ctx, c, l


LIFT_REFUSALS = [("int64", TypeError), ("two limbs", ValueError), ("level 1", ValueError),
                 ("level above the chain", ValueError), ("another device", ValueError),
                 ("non-contiguous", ValueError)]


@pytest.mark.parametrize("case,exc", LIFT_REFUSALS, ids=[r[0] for r in LIFT_REFUSALS])
def test_lift_refuses(case, exc):
    args = _lift_args(case)
    with pytest.raises(exc):
        ms.lift(*args)
    with pytest.raises(exc):
        ms._launch_lift(*args)


def _tail_args(case):
    ctx, l = _ctx(64, 3), 3
    rng = np.random.default_rng(1)
    x, delta = _residues(rng, ctx, (4,), l), _residues(rng, ctx, (4,), l - 1)
    if case == "delta int32":
        delta = delta.to(torch.int32)
    elif case == "delta limbs":
        delta = _residues(rng, ctx, (4,), l)
    elif case == "rows batch":
        x = x[:3]
    elif case == "delta on another device":
        delta = _meta(delta)
    elif case == "rows non-contiguous":
        x = _noncontig(x)
    return ctx, x, delta, l


TAIL_REFUSALS = [("delta int32", TypeError), ("delta limbs", ValueError),
                 ("rows batch", ValueError), ("delta on another device", ValueError),
                 ("rows non-contiguous", ValueError)]


@pytest.mark.parametrize("case,exc", TAIL_REFUSALS, ids=[r[0] for r in TAIL_REFUSALS])
def test_tail_refuses(case, exc):
    args = _tail_args(case)
    with pytest.raises(exc):
        ms.tail(*args)
    with pytest.raises(exc):
        ms._launch_tail(*args)


def _decrypt_args(case):
    ctx, l = _ctx(64, 3), 3
    sk = _secret(ctx, 0)
    data = _residues(np.random.default_rng(2), ctx, (5, 2), l)
    w = cipher.coeff_weights(ctx, 3, l)
    level = l
    if case == "data int64":
        data = data.to(torch.int64)
    elif case == "k = 4":
        data = torch.cat([data, data], dim=1)
    elif case == "k = 1":
        data = data[:, :1]
    elif case == "level differs from the data":
        level = 2
    elif case == "weights of another level":
        w = cipher.coeff_weights(ctx, 3, 2)
    elif case == "weights on another device":
        w = _meta(w)
    elif case == "data non-contiguous":
        data = _noncontig(data)
    return ctx, sk, Ciphertext(data, level, True, 1), w


DECRYPT_REFUSALS = [("data int64", TypeError), ("k = 4", ValueError), ("k = 1", ValueError),
                    ("level differs from the data", ValueError),
                    ("weights of another level", ValueError),
                    ("weights on another device", ValueError),
                    ("data non-contiguous", ValueError)]


@pytest.mark.parametrize("case,exc", DECRYPT_REFUSALS, ids=[r[0] for r in DECRYPT_REFUSALS])
def test_decrypt_coeff_refuses(case, exc):
    args = _decrypt_args(case)
    with pytest.raises(exc):
        ms.decrypt_coeff(*args)
    with pytest.raises(exc):
        ms._launch_decrypt(*args)


LAUNCHES = [("lift", lambda: ms._launch_lift(*_lift_args("valid"))),
            ("tail", lambda: ms._launch_tail(*_tail_args("valid"))),
            ("decrypt_coeff", lambda: ms._launch_decrypt(*_decrypt_args("valid")))]


@pytest.mark.parametrize("name,launch", LAUNCHES, ids=[n for n, _ in LAUNCHES])
def test_launch_needs_cuda_tensors(name, launch):
    with pytest.raises(ValueError, match="CUDA"):
        launch()
