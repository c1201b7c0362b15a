"""Leveled multiplicative-depth chains on the port, as tests/test_depth.py
runs them on the JAX package.

Square -> relinearize -> modulus-switch walks one limb per multiplication;
with T_DEPTH = 2^16 + 1 each 31-bit limb absorbs one multiplication, so
the depth is n_limbs - 1.  Oracle: messages m = a + b*X^{N/2}, whose square
is the complex square (a, b) -> (a^2 - b^2, 2ab) mod t.  Every rung must
decrypt exactly with at least 1 bit of noise budget (4 bits on the
chains).  Tolerance: none.
"""

import numpy as np
import pytest

from fhe_icp_tpu_torch.ops.noise import noise_budget_bits
from fhe_icp_tpu_torch.ops.params import T_DEPTH, CryptoParams, get_params
from fhe_icp_tpu_torch.ops.runtime import FheRuntime

DEEP_TEST = CryptoParams("test-512-deep", n=512, n_limbs=6, t=T_DEPTH,
                         allow_insecure=True)


def _center(v: int, t: int) -> int:
    return ((v + t // 2) % t) - t // 2


def _oracle_square(a: int, b: int, t: int):
    """(a + b*X^{N/2})^2 = (a^2 - b^2) + 2ab*X^{N/2} in Z_t, centered."""
    return _center(a * a - b * b, t), _center(2 * a * b, t)


def _make_msg(n: int, a: int, b: int) -> np.ndarray:
    m = np.zeros(n, dtype=np.int32)
    m[0], m[n // 2] = a, b
    return m


def _check_level(rt, ct, a, b, min_budget=1):
    got = rt.decrypt(ct).numpy().astype(np.int64)
    want = _make_msg(rt.ctx.n, a, b).astype(np.int64)
    assert (got == want).all(), "depth-chain decrypt mismatch"
    budget = noise_budget_bits(rt.ctx, rt.keys.sk, ct)
    assert budget >= min_budget, f"noise budget exhausted: {budget} bits"
    return budget


def _run_chain(rt):
    """Square down the whole modulus chain; exact and healthy at each rung."""
    t = rt.ctx.t
    a, b = 123, -77
    ct = rt.encrypt(_make_msg(rt.ctx.n, a, b), seed=7)
    budgets = [_check_level(rt, ct, a, b)]
    depth = rt.ctx.n_limbs - 1
    for _ in range(depth):
        ct = rt.mul_ct(ct, ct, relinearize=True)
        a, b = _oracle_square(a, b, t)
        if ct.level > 2:                 # the last rung decrypts in place
            ct = rt.mod_switch(ct)
        budgets.append(_check_level(rt, ct, a, b))
    assert ct.level == 2
    return depth, budgets


@pytest.fixture(scope="module")
def rt_small():
    r = FheRuntime(DEEP_TEST, device="cpu")
    r.generate_keys(seed=0)
    return r


def test_depth_modulus_is_ntt_friendly():
    assert T_DEPTH == (1 << 16) + 1
    # t = 1 (mod 2N) for every supported ring (largest: N=32768 -> 2N=2^16).
    for k in range(2, 17):
        assert (T_DEPTH - 1) % (1 << k) == 0


def test_depth_chain_small_ring(rt_small):
    depth, budgets = _run_chain(rt_small)
    assert depth == 5
    # Every squaring must leave real headroom, not land at 1 bit.
    assert min(budgets) >= 4, budgets


def test_depth_chain_random_pair(rt_small):
    """Depth 2 with a second operand: pt_corr of two modulus-switched
    ciphertexts composes through mul_ct."""
    rt, t = rt_small, rt_small.ctx.t
    a1, b1, a2, b2 = 41, 250, -199, 18
    c1 = rt.mod_switch(rt.encrypt(_make_msg(rt.ctx.n, a1, b1), seed=11))
    c2 = rt.mod_switch(rt.encrypt(_make_msg(rt.ctx.n, a2, b2), seed=12))
    prod = rt.mod_switch(rt.mul_ct(c1, c2, relinearize=True))
    a = _center(a1 * a2 - b1 * b2, t)
    b = _center(a1 * b2 + a2 * b1, t)
    prod2 = rt.mul_ct(prod, prod, relinearize=True)
    aa, bb = _oracle_square(a, b, t)
    _check_level(rt, prod2, aa, bb)


@pytest.mark.slow
def test_depth_chain_deep_16384():
    """The secure deep preset: 11 multiplications at 128-bit security."""
    params = get_params("deep-16384")
    assert params.secure_128
    rt = FheRuntime(params, device="cpu")
    rt.generate_keys(seed=0)
    depth, budgets = _run_chain(rt)
    assert depth == 11
    assert min(budgets) >= 4, budgets
