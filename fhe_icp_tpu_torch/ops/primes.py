"""Host-side number theory for crypto parameter generation.

Everything here runs once at context-construction time with Python big
integers (exact), producing the uint32 constant tables consumed by the
kernels in `modmath.py` / `ntt.py` / `csrc/`.  A copy of the JAX
package's `ops/primes.py`, kept here so the port imports nothing of
the JAX package.
"""

from __future__ import annotations

import functools
from typing import List

_MR_BASES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin, valid for all n < 3.3e24."""
    if n < 2:
        return False
    for a in _MR_BASES:
        if n % a == 0:
            return n == a
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in _MR_BASES:
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def _factor(n: int) -> List[int]:
    fact = []
    d = 2
    while d * d <= n:
        if n % d == 0:
            fact.append(d)
            while n % d == 0:
                n //= d
        d += 1
    if n > 1:
        fact.append(n)
    return fact


def primitive_root(p: int) -> int:
    """Smallest generator of the multiplicative group of Z_p (p prime)."""
    fact = _factor(p - 1)
    for g in range(2, 1 << 20):
        if all(pow(g, (p - 1) // f, p) != 1 for f in fact):
            return g
    raise ValueError(f"no primitive root found for {p}")


@functools.lru_cache(maxsize=None)
def ntt_primes(count: int, bits: int = 31, order: int = 1 << 16,
               below: int | None = None) -> tuple:
    """`count` distinct primes p with 2^(bits-1) < p < 2^bits and p ≡ 1 (mod order).

    `order` must cover 2N for every ring size N the primes will serve
    (default 2^16 handles N up to 32768).  Search descends from 2^bits so
    the primes are as large as possible (maximal noise budget per limb);
    deterministic, so parameter sets are reproducible across hosts.
    """
    assert bits <= 31, "limbs must fit uint32 with headroom for lazy adds"
    hi = below if below is not None else (1 << bits)
    # Largest candidate ≡ 1 mod order strictly below hi.
    c = (hi - 2) // order * order + 1
    out = []
    while len(out) < count:
        if c <= (1 << (bits - 1)):
            raise ValueError("prime search range exhausted")
        if is_prime(c):
            out.append(c)
        c -= order
    return tuple(out)


def root_of_unity(p: int, order: int) -> int:
    """An element of exact multiplicative order `order` in Z_p."""
    assert (p - 1) % order == 0
    g = primitive_root(p)
    w = pow(g, (p - 1) // order, p)
    assert pow(w, order, p) == 1 and pow(w, order // 2, p) != 1
    return w


# ---------------------------------------------------------------------------
# Per-prime constant bundles for the uint32 kernels.
# ---------------------------------------------------------------------------

def mont_constants(p: int) -> dict:
    """Montgomery (R = 2^32) constants for prime p < 2^31."""
    r = 1 << 32
    return {
        "p": p,
        "p_neg_inv": (-pow(p, -1, r)) % r,   # -p^{-1} mod 2^32
        "r_mod_p": r % p,                     # to_mont(1)
        "r2_mod_p": (r * r) % p,              # to_mont multiplier
    }


def shoup(w: int, p: int) -> int:
    """Shoup precomputed companion floor(w * 2^32 / p) (requires w < p)."""
    assert 0 <= w < p
    return (w << 32) // p


def barrett_mu(p: int) -> int:
    """floor(2^32 / p) for single-word Barrett reduction x mod p, x < 2^32."""
    return (1 << 32) // p
