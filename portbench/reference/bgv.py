"""Plain BGV decryption in NumPy, written from the scheme's definition.

A stored ciphertext is (c0, c1) per RNS limb, each in the evaluation
domain: slot m holds the polynomial's value at psi^(2 bitrev(m) + 1), where
psi is a primitive 2N-th root of unity mod p, taken as g^((p-1)/2N) for
g the smallest generator of Z_p*.  The limbs are the largest `bits`-bit
primes that are 1 mod `order`.  Decryption is
m = [INTT(c0 + c1 * NTT(s))]_q mod t, centred, with s the ternary secret
key in coefficients.  Every step is exact integer arithmetic: residues are
below 2^31, so products stay below 2^62 in int64.  Imports neither JAX nor
any package of this repository.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np


def _is_prime(n: int) -> bool:
    if n < 2:
        return False
    for a in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % a == 0:
            return n == a
    d, r = n - 1, 0
    while d % 2 == 0:
        d, r = d // 2, r + 1
    for a in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
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


@functools.lru_cache(maxsize=None)
def limb_primes(count: int, bits: int = 31, order: int = 1 << 16) -> Tuple[int, ...]:
    """The `count` largest primes below 2^bits that are 1 mod `order`, descending."""
    c, out = ((1 << bits) - 2) // order * order + 1, []
    while len(out) < count:
        if _is_prime(c):
            out.append(c)
        c -= order
    return tuple(out)


def _generator(p: int) -> int:
    n, f, factors = p - 1, 2, []
    while f * f <= n:
        if n % f == 0:
            factors.append(f)
            while n % f == 0:
                n //= f
        f += 1
    if n > 1:
        factors.append(n)
    g = 2
    while any(pow(g, (p - 1) // q, p) == 1 for q in factors):
        g += 1
    return g


@functools.lru_cache(maxsize=None)
def _tables(p: int, n: int):
    psi = pow(_generator(p), (p - 1) // (2 * n), p)
    k = np.arange(n, dtype=object)
    twist = np.array([pow(psi, int(i), p) for i in k], dtype=np.int64)
    untwist = np.array([pow(psi, -int(i) % (2 * n), p) * pow(n, p - 2, p) % p for i in k],
                       dtype=np.int64)
    w = psi * psi % p
    # Stage s of the decimation-in-frequency transform has half-width
    # m = N >> (s+1) and twiddles w^(j N / 2m), j < m.
    fwd, inv = [], []
    for s in range(n.bit_length() - 1):
        m = n >> (s + 1)
        step = pow(w, n // (2 * m), p)
        tw = [1] * m
        for j in range(1, m):
            tw[j] = tw[j - 1] * step % p
        fwd.append(np.array(tw, dtype=np.int64))
        inv.append(np.array([pow(x, p - 2, p) for x in tw], dtype=np.int64))
    return twist, untwist, fwd, inv


def ntt(a: np.ndarray, p: int) -> np.ndarray:
    """(..., N) coefficients mod p -> (..., N) evaluations in bit-reversed slot order."""
    n = a.shape[-1]
    twist, _, fwd, _ = _tables(p, n)
    y = np.asarray(a, dtype=np.int64) % p * twist % p
    lead = y.shape[:-1]
    for s, tw in enumerate(fwd):
        m = n >> (s + 1)
        y = y.reshape(lead + (1 << s, 2, m))
        u, v = y[..., 0, :], y[..., 1, :]
        y = np.stack([(u + v) % p, (u - v) % p * tw % p], axis=-2)
    return y.reshape(lead + (n,))


def intt(x: np.ndarray, p: int) -> np.ndarray:
    """The inverse of `ntt`: bit-reversed evaluations -> coefficients mod p."""
    n = x.shape[-1]
    _, untwist, _, inv = _tables(p, n)
    y = np.asarray(x, dtype=np.int64) % p
    lead = y.shape[:-1]
    for s in range(len(inv) - 1, -1, -1):
        m = n >> (s + 1)
        y = y.reshape(lead + (1 << s, 2, m))
        u, t = y[..., 0, :], y[..., 1, :] * inv[s] % p
        y = np.stack([(u + t) % p, (u - t) % p], axis=-2)
    return y.reshape(lead + (n,)) * untwist % p


def decrypt(ct: np.ndarray, s: np.ndarray, t: int, bits: int = 31,
            order: int = 1 << 16) -> np.ndarray:
    """(..., 2, L, N) uint32 evaluation-domain ciphertexts under the ternary
    secret s (N,) -> (..., N) int64 messages, centred mod t."""
    ct = np.asarray(ct, dtype=np.int64)
    l, n = ct.shape[-2], ct.shape[-1]
    primes = limb_primes(l, bits, order)
    res = []
    for i, p in enumerate(primes):
        phase = (ct[..., 0, i, :] + ct[..., 1, i, :] * ntt(s, p) % p) % p
        res.append(intt(phase, p))
    # Garner's recombination, one limb at a time, in exact Python integers.
    x = res[0].astype(object)
    q = primes[0]
    for r, p in zip(res[1:], primes[1:]):
        inv = pow(q, -1, p)
        x = x + q * (((r.astype(object) - x) % p) * inv % p)
        q *= p
    x = np.where(x > q // 2, x - q, x)
    m = x % t
    return np.where(m > t // 2, m - t, m).astype(np.int64)


def encrypt_trivial(msg: np.ndarray, limbs: int, bits: int = 31,
                    order: int = 1 << 16) -> np.ndarray:
    """(..., N) int64 messages -> (..., 2, L, N) uint32 ciphertexts (c0, c1)
    = (NTT(m), 0), which `decrypt` reads as m under any secret key: how the
    control writes its answers in the store's own form.  No security."""
    msg = np.asarray(msg, dtype=np.int64)
    c0 = np.stack([ntt(msg % p, p) for p in limb_primes(limbs, bits, order)], axis=-2)
    return np.stack([c0, np.zeros_like(c0)], axis=-3).astype(np.uint32)
