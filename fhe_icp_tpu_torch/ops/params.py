"""Crypto parameter sets (ring degree, RNS modulus chain, plaintext modulus).

A copy of the JAX package's `ops/params.py` (the presets must be
identical in both packages).  Parameters are explicit, deterministic, and checked
against the homomorphic-encryption standard security table.

Design constraints baked in:
* limb primes p in (2^30, 2^31), p ≡ 1 (mod 2^16): NTT-friendly for every
  ring size up to N=32768, fit uint32 with lazy-add headroom, and are big
  enough that floor(2^56/p) fits uint32 (exact RNS decode, see context.py).
* plaintext modulus t: two tiers.  T_MODULUS (largest prime < 2^30,
  ≡ 1 mod 2^16) gives maximal integer range for presets with limb
  headroom.  The DEFAULT preset uses T_COMPACT (~2^23) instead: the
  scale-1000 quantization contract L2-normalizes before scaling, so
  every similarity score is
  bounded by ~1.1e6 — far under T_COMPACT/2 ≈ 4.26e6 — and the smaller t
  is what lets ct x ct multiplication fit a 2-limb modulus.  Both are
  ≡ 1 (mod 2^16): NTT-friendly for SIMD slot packing at every ring size.
  CALLERS MUST RESPECT THE CONTRACT: feeding unnormalized integer
  vectors into the default preset wraps mod t (this exact mistake broke
  the round-2 benchmark; see tests/test_production_preset.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import cached_property
from typing import Tuple

from . import primes as pr

# Max log2(q) for 128-bit security with ternary secret (HE standard 2018).
_MAX_LOG_Q_128 = {1024: 27, 2048: 54, 4096: 109, 8192: 218, 16384: 438, 32768: 881}

# Default plaintext modulus: largest prime < 2^30, ≡ 1 mod 2^16.
T_MODULUS = pr.ntt_primes(1, bits=30)[0]

# Compact plaintext modulus for 2-limb ct x ct parameter sets: the
# smallest prime ≡ 1 (mod 2^16) above 2^23.  The scale-1000 quantized
# similarity contract needs |score| <= ~1.1e6 (L2-normalized embeddings),
# so t/2 ≈ 4.26e6 leaves 4x
# headroom — while t^2 * e1*e2 ≈ 2^58, the dominant ct x ct noise term,
# fits the 2^62 two-limb budget (t = 2^30 needs 2^72 and CANNOT multiply
# at 2 limbs).  Still ≡ 1 mod 2N for every ring: SIMD slots keep working.
T_COMPACT = 8519681
assert T_COMPACT == 130 * 65536 + 1

# Slot-rotation plaintext modulus: the smallest prime ≡ 1 (mod 2^16)
# above 2^21.75.  MEASURED parameter floor for the slot-packed
# rotate-and-sum dot at N=4096 (benchmarks config 8): with T_COMPACT the
# post-relinearization budget is 4 bits while the d=128 prefix
# rotate-and-sum chain consumes ~4-5 (fan-in noise of summing 128 slot
# products — noise budgets measured 4 -> 3 -> 2 -> 2 -> 1 -> 1 -> 0 bits
# across the 7 rotations, wrapping at the last), so the dot is
# UNDECRYPTABLE at the default preset no matter how fine the rotation-key
# digits are.  Shrinking t by 1.24 bits buys 2.48 bits of product-noise
# budget (the dominant ct x ct term scales with t^2): measured final
# budget +2 bits, exact decode.  Decode range t/2 = 1.80e6 keeps 1.78x
# headroom over the scale-1000 contract bound (~1.01e6).  Coefficient
# packing remains the production encoding (faster AND roomier); this
# preset exists so the SIMD/rotation surface is usable at N=4096.
T_GALOIS = 3604481
assert T_GALOIS == 55 * 65536 + 1

# Depth-oriented plaintext modulus: the Fermat prime 2^16 + 1.  BGV's
# per-level noise floor after a modulus switch is ~t * sqrt(N); a ct x ct
# product squares it, so each multiplication consumes ~2*log2(t) + log2(N)
# bits of one-limb (31-bit) budget.  At t = 2^16 one 31-bit limb absorbs
# one multiplication per level, giving multiplicative depth = n_limbs - 1
# down the RNS chain — the leveled alternative to bootstrapping (which
# the similarity workload never needs; see PARITY.md §depth).  Still
# ≡ 1 (mod 2^16): SIMD slot packing works at every ring size.
T_DEPTH = 65537
assert T_DEPTH == (1 << 16) + 1


@dataclass(frozen=True)
class CryptoParams:
    """A named BGV parameter preset.

    Every preset carries one SPECIAL prime P beyond the n_limbs
    ciphertext primes: keyswitching (relinearization, Galois, re-keying)
    is HYBRID — the keyswitch keys live at modulus Q*P and the result is
    scaled back down by P, dividing the keyswitch noise by ~2^31
    (GHS/SEAL-style).  Fresh ciphertexts never use P; security is
    therefore checked against log2(Q*P), the largest modulus any RLWE
    sample under the secret actually sees.
    """

    name: str
    n: int                      # ring degree (power of two)
    n_limbs: int                # RNS limbs in a fresh ciphertext
    t: int = T_MODULUS          # plaintext modulus (prime)
    cbd_k: int = 20             # centered-binomial error param, sigma = sqrt(k/2)
    allow_insecure: bool = False

    @cached_property
    def primes(self) -> Tuple[int, ...]:
        return pr.ntt_primes(self.n_limbs, bits=31)

    @cached_property
    def special_prime(self) -> int:
        """The hybrid-keyswitch prime P (first NTT prime past the chain)."""
        return pr.ntt_primes(self.n_limbs + 1, bits=31)[self.n_limbs]

    @cached_property
    def q(self) -> int:
        out = 1
        for p in self.primes:
            out *= p
        return out

    @cached_property
    def log_q(self) -> float:
        return self.q.bit_length()

    @cached_property
    def log_qp(self) -> int:
        """log2 of the keyswitch modulus Q*P — what security is checked on."""
        return (self.q * self.special_prime).bit_length()

    @cached_property
    def secure_128(self) -> bool:
        limit = _MAX_LOG_Q_128.get(self.n, 0)
        return self.log_qp <= limit

    def __post_init__(self):
        assert self.n & (self.n - 1) == 0
        if not self.allow_insecure:
            limit = _MAX_LOG_Q_128.get(self.n, 0)
            if self.log_qp > limit:
                raise ValueError(
                    f"{self.name}: log(Q*P) = {self.log_qp} exceeds the "
                    f"128-bit security limit {limit} for N={self.n}; pass "
                    f"allow_insecure=True for test-only parameter sets"
                )


PRESETS = {
    # Test-only tiny ring: fast unit tests, NOT secure.
    "test-512": CryptoParams("test-512", n=512, n_limbs=2, allow_insecure=True),
    # Test-only with ct x ct headroom: q ~ 2^93 holds the t^2*e1*e2 noise
    # of one multiplication (2 limbs / 2^62 does not).  NOT secure.
    "test-512-mult": CryptoParams("test-512-mult", n=512, n_limbs=3,
                                  allow_insecure=True),
    # Test-only depth-2 chain (the polynomial-kernel family needs two
    # multiplications + rotations: 5 limbs measured minimum at t~2^30).
    # NOT secure.
    "test-512-poly": CryptoParams("test-512-poly", n=512, n_limbs=5,
                                  allow_insecure=True),
    # Default for the encrypted-similarity pipeline.  2 limbs + the
    # special prime: log(Q*P) = 93 <= 109 keeps 128-bit security, and
    # hybrid keyswitching + the compact plaintext modulus make ct x ct
    # compare + relinearization (and homomorphic re-keying) fit the 2^62
    # budget — fresh ciphertexts are a third smaller than the earlier
    # 3-limb variant.
    "pairwise-4096": CryptoParams("pairwise-4096", n=4096, n_limbs=2,
                                  t=T_COMPACT),
    # Slot-packed Galois rotate-and-sum at N=4096: same 128-bit-secure
    # 2-limb ring as the default, with the plaintext modulus shrunk to
    # the measured feasibility floor for the d=128 prefix chain (see
    # T_GALOIS).  Use when encrypted dots must ride SIMD slots at the
    # compact ring; the default preset's coefficient packing is faster.
    "galois-4096": CryptoParams("galois-4096", n=4096, n_limbs=2,
                                t=T_GALOIS),
    # ct x ct multiplication + relinearization headroom.
    "mult-8192": CryptoParams("mult-8192", n=8192, n_limbs=6),
    # Large-ring configuration (BASELINE.json config 4).
    "ring-16384": CryptoParams("ring-16384", n=16384, n_limbs=12),
    # Deep-circuit configuration: same 128-bit-secure 12-limb ring, but
    # with the depth-oriented plaintext modulus — supports an 11-deep
    # chain of ct x ct multiplications (relinearize + modswitch per
    # level), verified bit-exact in tests/test_depth.py.
    "deep-16384": CryptoParams("deep-16384", n=16384, n_limbs=12,
                               t=T_DEPTH),
}

DEFAULT_PRESET = "pairwise-4096"


def get_params(name: str) -> CryptoParams:
    try:
        return PRESETS[name]
    except KeyError:
        raise KeyError(f"unknown preset {name!r}; available: {sorted(PRESETS)}")
