// Device-side exact RNS decode: [x]_q mod t, centered, from the residues of x.
//
// The arithmetic of ops/cipher.py::rns_decode_centered, split so that each
// limb's share is computed where its residue is (one lane a limb, or one
// score's loop over limbs) and the shares are summed before one finish:
//
//   y_j   = [x_j * (q/p_j)^{-1}]_{p_j}                      (Shoup product)
//   v     = sum_j y_j * floor(2^56 / p_j)                    (Q56, < 2^61)
//   m     = sum_j [y_j]_t * (q/p_j mod t)  (mod t)           (Montgomery mod t)
//   v_hat = ((v >> 32) + 2^23) >> 24                         (round(sum y_j/p_j))
//   out   = centered((m - v_hat * (q mod t)) * pt_corr mod t)
//
// Every step is canonical, so the result equals the int64 torch version bit
// for bit.  Tables are the context's device columns (LevelTables and the
// per-limb constants); t is odd and below 2^31.
#pragma once

#include <cstdint>

#include "modmath.cuh"

namespace fhe {

struct RnsDecodeTables {
  const uint32_t* p;             // l primes
  const uint32_t* inv_qhat;      // [(q/p_j)^{-1}]_{p_j}
  const uint32_t* inv_qhat_sh;   // its Shoup companion
  const uint32_t* v_c;           // floor(2^56 / p_j)
  const uint32_t* r_t_mont;      // (q/p_j mod t), Montgomery form mod t
  const uint32_t* q_mod_t_mont;  // 1 word: (q mod t), Montgomery form mod t
  const uint32_t* t_neg_inv;     // 1 word: -t^{-1} mod 2^32
  const uint32_t* mu_t;          // 1 word: floor(2^32 / t)
  uint32_t t;
};

// Limb j's share of the decode of x_j (canonical mod p_j): v and m terms.
struct RnsDecodeShare {
  unsigned long long v;
  unsigned long long m;
};

__device__ __forceinline__ RnsDecodeShare rns_decode_share(uint32_t x, int j,
                                                           const RnsDecodeTables& d) {
  const uint32_t y = shoup_mul(x, __ldg(d.inv_qhat + j), __ldg(d.inv_qhat_sh + j), __ldg(d.p + j));
  const uint32_t yt = barrett_reduce(y, d.t, __ldg(d.mu_t));
  return {static_cast<unsigned long long>(y) * __ldg(d.v_c + j),
          mont_mul(yt, __ldg(d.r_t_mont + j), d.t, __ldg(d.t_neg_inv))};
}

// The summed shares of every limb -> centered int32 message coefficient,
// times pt_corr (given mod t).  m may be any sum of m shares (< 2^64).
__device__ __forceinline__ int32_t rns_decode_finish(unsigned long long v, unsigned long long m,
                                                     const RnsDecodeTables& d, uint32_t pt_corr) {
  const uint32_t t = d.t;
  const unsigned long long v_hat = ((v >> 32) + (1ull << 23)) >> 24;
  const uint32_t vq = mont_mul(static_cast<uint32_t>(v_hat % t), __ldg(d.q_mod_t_mont), t,
                               __ldg(d.t_neg_inv));
  uint32_t r = sub_mod(static_cast<uint32_t>(m % t), vq, t);
  r = static_cast<uint32_t>(static_cast<unsigned long long>(r) * pt_corr % t);
  return r > t / 2 ? static_cast<int32_t>(r) - static_cast<int32_t>(t) : static_cast<int32_t>(r);
}

}  // namespace fhe
