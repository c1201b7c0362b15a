"""The keyswitch's digit-key inner product (`ops/keyswitch_cuda.py`) on the CPU.

The plain version against an independent per-coefficient computation of
sum_j d * k * R^-1 mod p in int64 (R = 2^32), at the shapes of each regime
of `arith.hybrid_keyswitch_apply`: a ring-16384 relinearization's 12
digits over 13 limbs, a small batch, a batch of `_REUSE_MIN_BATCH` or more
(odd), and 16-bit sub-digits (n_dig = 2l).  Then the wrapper's refusals.
The kernel itself runs only on the card (`chip_smoke.py` holds it to the
plain version there); the bit-exact tests against the JAX package
(`test_torch_relin.py`, `_rekey.py`, `_galois.py`) reach it through the
keyswitch.
"""

import numpy as np
import pytest
import torch

from fhe_icp_tpu_torch.ops import keyswitch_cuda as ks
from fhe_icp_tpu_torch.ops import primes as pr

# (B, n_dig, l, N), the key over l + 1 limbs.
SHAPES = [(1, 12, 12, 64), (3, 4, 2, 64), (33, 6, 3, 64), (2, 8, 4, 64)]


def _operands(b, n_dig, l, n, seed=0):
    ps = pr.ntt_primes(l + 1, bits=31)
    rng = np.random.default_rng(seed)
    col = np.asarray(ps, dtype=np.uint64)[:, None]
    d = rng.integers(0, 2 ** 32, size=(b, n_dig, l + 1, n), dtype=np.uint64) % col
    k = rng.integers(0, 2 ** 32, size=(n_dig, 2, l + 1, n), dtype=np.uint64) % col
    p_neg_inv = [(-pow(p, -1, 1 << 32)) % (1 << 32) for p in ps]
    t = lambda a: torch.from_numpy(np.asarray(a, dtype=np.uint64).astype(np.uint32))
    return (t(d), t(k), t(np.asarray(ps)[:, None]), t(np.asarray(p_neg_inv)[:, None]),
            ps, d.astype(np.int64), k.astype(np.int64))


def _oracle(d, k, ps):
    """sum_j (d * k mod p) * R^-1 mod p, coefficient by coefficient in int64."""
    b, n_dig, limbs, n = d.shape
    out = np.zeros((b, 2, limbs, n), dtype=np.int64)
    for i, p in enumerate(ps):
        r_inv = pow(1 << 32, -1, p)
        for c in range(2):
            for j in range(n_dig):
                prod = d[:, j, i] * k[j, c, i] % p * r_inv % p
                out[:, c, i] = (out[:, c, i] + prod) % p
    return out


@pytest.mark.parametrize("b,n_dig,l,n", SHAPES, ids=[f"B{s[0]}-dig{s[1]}-l{s[2]}" for s in SHAPES])
def test_plain_version_matches_per_coefficient_oracle(b, n_dig, l, n):
    d, k, p, pinv, ps, d64, k64 = _operands(b, n_dig, l, n, seed=b * 100 + n_dig)
    got = ks.inner_product(d, k, p, pinv)
    assert got.dtype == torch.uint32 and tuple(got.shape) == (b, 2, l + 1, n)
    assert np.array_equal(got.to(torch.int64).numpy(), _oracle(d64, k64, ps))
    assert torch.equal(got, ks.inner_product_ref(d, k, p, pinv))


def _bad(case):
    d, k, p, pinv, *_ = _operands(2, 4, 2, 64)
    if case == "digits int64":
        d = d.to(torch.int64)
    elif case == "key int32":
        k = k.to(torch.int32)
    elif case == "digits 3-d":
        d = d[0]
    elif case == "key n_dig":
        k = k[:3]
    elif case == "key limbs":
        k = k[:, :, :2].contiguous()
    elif case == "primes count":
        p = p[:2]
    elif case == "key on another device":
        k = torch.empty(k.shape, dtype=k.dtype, device="meta")
    elif case == "digits non-contiguous":
        d = d.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "key non-contiguous":
        k = k.transpose(0, 1).contiguous().transpose(0, 1)
    return d, k, p, pinv


REFUSALS = [("digits int64", TypeError), ("key int32", TypeError), ("digits 3-d", ValueError),
            ("key n_dig", ValueError), ("key limbs", ValueError), ("primes count", ValueError),
            ("key on another device", ValueError), ("digits non-contiguous", ValueError),
            ("key non-contiguous", ValueError)]


@pytest.mark.parametrize("case,exc", REFUSALS, ids=[r[0] for r in REFUSALS])
def test_wrapper_refuses(case, exc):
    args = _bad(case)
    with pytest.raises(exc):
        ks.inner_product(*args)
    with pytest.raises(exc):
        ks._launch(*args)


def test_launch_needs_cuda_tensors():
    d, k, p, pinv, *_ = _operands(1, 2, 2, 64)
    with pytest.raises(ValueError, match="CUDA"):
        ks._launch(d, k, p, pinv)
