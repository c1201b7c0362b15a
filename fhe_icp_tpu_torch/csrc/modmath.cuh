// Device-side uint32 modular arithmetic shared by the port's kernels.
//
// The same functions as the JAX package's ops/modmath.py, with the
// hardware's 32x32->64 high product (__umulhi) where the TPU had to
// build it from 16-bit digits.  Primes satisfy 2^30 < p < 2^31, so
// a + b < 2^32 for residues a, b < p.  Every function returns the
// canonical residue in [0, p) for the input ranges its comment states,
// which makes the kernels bit-identical to the plain torch versions.
#pragma once

#include <cstdint>

namespace fhe {

// (a + b) mod p for a, b in [0, p): s < 2p, and s - p wraps when s < p,
// so the unsigned minimum is the residue (one VIADDMNMX with the add).
__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b, uint32_t p) {
  const uint32_t s = a + b;
  return min(s, s - p);
}

// (a - b) mod p for a, b in [0, p): a - b wraps when a < b, a - b + p not.
__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b, uint32_t p) {
  const uint32_t d = a - b;
  return min(d, d + p);
}

// (-a) mod p for a in [0, p).
__device__ __forceinline__ uint32_t neg_mod(uint32_t a, uint32_t p) {
  return a == 0 ? 0u : p - a;
}

// a*b*2^-32 mod p (Montgomery REDC) for a*b < p*2^32.  t_lo + (m*p)_lo is
// 0 or exactly 2^32, so the carry into the high word is (t_lo != 0).
__device__ __forceinline__ uint32_t mont_mul(uint32_t a, uint32_t b, uint32_t p,
                                             uint32_t p_neg_inv) {
  uint32_t t_lo = a * b;
  uint32_t t_hi = __umulhi(a, b);
  uint32_t m = t_lo * p_neg_inv;
  uint32_t res = t_hi + __umulhi(m, p) + (t_lo != 0u);
  return res >= p ? res - p : res;
}

// a*w mod p for a constant w < p with w_sh = floor(w*2^32/p); any uint32 a.
// a*w - q*p lies in [0, 2p), so it is computed modulo 2^32 on purpose.
__device__ __forceinline__ uint32_t shoup_mul(uint32_t a, uint32_t w, uint32_t w_sh,
                                              uint32_t p) {
  const uint32_t r = a * w - __umulhi(a, w_sh) * p;
  return min(r, r - p);
}

// x mod p for any uint32 x, with mu = floor(2^32/p).
__device__ __forceinline__ uint32_t barrett_reduce(uint32_t x, uint32_t p, uint32_t mu) {
  uint32_t q = __umulhi(x, mu);
  uint32_t r = x - q * p;
  r = r >= p ? r - p : r;
  return r >= p ? r - p : r;
}

// x mod p for a signed 32-bit x (|x| < 2^31), canonical.
__device__ __forceinline__ uint32_t reduce_signed(int32_t x, uint32_t p, uint32_t mu) {
  uint32_t mag = x < 0 ? 0u - static_cast<uint32_t>(x) : static_cast<uint32_t>(x);
  uint32_t r = barrett_reduce(mag, p, mu);
  return x < 0 ? neg_mod(r, p) : r;
}

}  // namespace fhe
