// The modulus switch's pointwise arithmetic and the one-coefficient decrypt,
// one launch each.
//
// Modulus switch (ops/arith.py::mod_switch) drops the last limb p_d of a
// degree-1 ciphertext: c' = (c - delta) / p_d with delta = c (mod p_d),
// delta = 0 (mod t), delta centered-small.  Around K2's two calls (the
// dropped limb's inverse transform, the correction's forward transform over
// the l - 1 limbs left) it takes two kernels:
//
//   lift:  u = [c_d * t^{-1}]_{p_d}; out_i = [t * centered(u)]_{p_i}
//          (R, 1, N) coefficients of the dropped limb -> (R, l - 1, N)
//   tail:  out_i = (c_i - delta_i) * p_d^{-1} mod p_i, i < l - 1
//          (R, l, N) ciphertext rows and (R, l - 1, N) NTT-domain delta
//
// The one-coefficient decrypt (ops/cipher.py::decrypt_coeff) of B rows of
// k = 2 or 3 polynomials at level l, for output coefficient j:
//
//   x_i = sum_N mont_mul(c0 + c1*s (+ c2*s^2), w_j) mod p_i   (w_j the INTT row)
//   out = centered([x]_q mod t) * pt_corr                      (rns_decode.cuh)
//
// They replace no Pallas kernel: the JAX package's ops/arith.py and
// ops/cipher.py leave this arithmetic to XLA, which fuses each chain into
// one pass.  Unfused on the card, as int64 torch ops, the two came to about
// 190 launches a compare (80 in mod_switch around K2, 111 in the decrypt).
//
// What bounds them.  Each word is read once and written once, with one to
// four Montgomery products a word, so all three are bound by bytes, and at
// a compare's sizes (R = 2, l = 12, N = 16384) by their launch: lift 1.6
// MB, tail 4.3 MB, decrypt 2.9 MB, 0.5 to 1.3 us at 3.35 TB/s.  The design:
//
// * lift and tail: one thread a 16-byte vector of 4 coefficients, grid
//   (R * N/4 vectors, l - 1 limbs), so neighbouring threads move
//   neighbouring vectors of one limb; the limb's constants are the same
//   word across the block (broadcast loads).  The lift computes u again for
//   every limb it writes: one Montgomery product on a word that L2 holds.
// * decrypt: a cluster of C blocks a row (C = 1 .. 16 from N, so that a
//   block takes up to 256 vectors of each limb and a ring-16384 row spreads
//   over 16 SMs), each block one slice of N/C coefficients of every limb,
//   one vector a thread
//   a limb, loaded four limbs at a time, its sum in 64 bits (N * p < 2^46,
//   so exact); warp shuffles and shared memory reduce a block to one
//   partial sum a limb, and the cluster's first block reads the others'
//   partials from their shared memory (DSMEM), reduces each limb mod p_i,
//   and decodes with one lane a limb.  One launch, no scratch in device
//   memory, no atomics, the same order of sums every run.
//
// Every step is the canonical residue of modmath.cuh, so each kernel equals
// its plain version in ops/modswitch_cuda.py bit for bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>
#include <climits>
#include <cstdint>

#include "modmath.cuh"
#include "rns_decode.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);
constexpr int kThreads = 256;           // lift and tail
constexpr int kDecryptThreads = 512;    // decrypt: most threads a block
constexpr int kMaxLimbs = 32;           // decrypt: one lane a limb in the decode
constexpr int kMaxCluster = 16;         // decrypt: 16 is above the portable 8
constexpr int kSlice = 256;             // decrypt: vectors of a limb a block takes
constexpr int kMaxDevices = 64;
constexpr int kGroup = 4;               // decrypt: limbs whose loads are in flight together

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

int log2_exact(int n) {
  int k = 0;
  while ((1 << k) < n) ++k;
  return (1 << k) == n ? k : -1;
}

// ---------------------------------------------------------------------------
// Modulus switch
// ---------------------------------------------------------------------------

struct LiftConst {
  uint32_t pd, pd_inv, t_inv, half;   // the dropped prime, [t^-1]_{p_d} (Montgomery), p_d / 2
  uint32_t p, pinv, mu, pd_mod, t_mont;   // limb i: p_i, -p_i^-1, Barrett mu, p_d mod p_i, t*R
};

__device__ __forceinline__ uint32_t lift1(uint32_t c, const LiftConst& k) {
  const uint32_t u = fhe::mont_mul(c, k.t_inv, k.pd, k.pd_inv);
  uint32_t w = fhe::barrett_reduce(u, k.p, k.mu);
  if (u > k.half) w = fhe::sub_mod(w, k.pd_mod, k.p);
  return fhe::mont_mul(w, k.t_mont, k.p, k.pinv);
}

// Grid (vectors / kThreads, l - 1): thread g of column i reads vector g of
// the (R, 1, N) dropped limb (row g >> log_n4) and writes limb i of that row.
__global__ void __launch_bounds__(kThreads)
modswitch_lift_kernel(const uint4* __restrict__ c, uint4* __restrict__ out,
                      const uint32_t* __restrict__ primes, const uint32_t* __restrict__ p_neg_inv,
                      const uint32_t* __restrict__ mu, const uint32_t* __restrict__ t_mont,
                      const uint32_t* __restrict__ pd_mod_pi,
                      const uint32_t* __restrict__ t_inv_mont_pd,
                      const uint32_t* __restrict__ pd_half, long long vectors, int limbs,
                      int log_n4) {
  const long long g = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (g >= vectors) return;
  const int i = blockIdx.y;
  const LiftConst k{__ldg(primes + limbs), __ldg(p_neg_inv + limbs), __ldg(t_inv_mont_pd),
                    __ldg(pd_half), __ldg(primes + i), __ldg(p_neg_inv + i), __ldg(mu + i),
                    __ldg(pd_mod_pi + i), __ldg(t_mont + i)};
  const long long r = g >> log_n4, v = g & ((1LL << log_n4) - 1);
  const uint4 x = __ldg(c + g);
  out[((r * limbs + i) << log_n4) + v] =
      make_uint4(lift1(x.x, k), lift1(x.y, k), lift1(x.z, k), lift1(x.w, k));
}

__device__ __forceinline__ uint32_t tail1(uint32_t a, uint32_t d, uint32_t p, uint32_t pinv,
                                          uint32_t inv_pd) {
  return fhe::mont_mul(fhe::sub_mod(a, d, p), inv_pd, p, pinv);
}

// Grid (vectors / kThreads, l - 1): limb i of row g >> log_n4 from the (R, l,
// N) ciphertext rows and the (R, l - 1, N) delta, into the (R, l - 1, N) out.
__global__ void __launch_bounds__(kThreads)
modswitch_tail_kernel(const uint4* __restrict__ x, const uint4* __restrict__ delta,
                      uint4* __restrict__ out, const uint32_t* __restrict__ primes,
                      const uint32_t* __restrict__ p_neg_inv,
                      const uint32_t* __restrict__ inv_pd_mont, long long vectors, int limbs,
                      int log_n4) {
  const long long g = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (g >= vectors) return;
  const int i = blockIdx.y;
  const uint32_t p = __ldg(primes + i), pinv = __ldg(p_neg_inv + i), ipd = __ldg(inv_pd_mont + i);
  const long long r = g >> log_n4, v = g & ((1LL << log_n4) - 1);
  const long long o = ((r * limbs + i) << log_n4) + v;
  const uint4 a = __ldg(x + (((r * (limbs + 1) + i) << log_n4) + v));
  const uint4 d = __ldg(delta + o);
  out[o] = make_uint4(tail1(a.x, d.x, p, pinv, ipd), tail1(a.y, d.y, p, pinv, ipd),
                      tail1(a.z, d.z, p, pinv, ipd), tail1(a.w, d.w, p, pinv, ipd));
}

// ---------------------------------------------------------------------------
// One-coefficient decrypt
// ---------------------------------------------------------------------------

struct DecryptArgs {
  const uint4* data;       // (B, k, l, N) NTT-domain ciphertexts
  const uint4* s;          // (>= l, N) s, NTT domain, Montgomery form
  const uint4* s2;         // (>= l, N) s^2, the same
  const uint4* w;          // (l, N) the INTT row of the output coefficient, Montgomery form
  const uint32_t* p_neg_inv;
  fhe::RnsDecodeTables dec;
  int32_t* out;            // (B,)
  int k, limbs, n4;
  uint32_t pt_corr;        // mod t
};

__device__ __forceinline__ uint32_t mm(uint32_t a, uint32_t b, uint32_t p, uint32_t pinv) {
  return fhe::mont_mul(a, b, p, pinv);
}

// a + b * s (mod p), lane by lane.
__device__ __forceinline__ uint4 mac(const uint4& a, const uint4& b, const uint4& s, uint32_t p,
                                     uint32_t pinv) {
  return make_uint4(fhe::add_mod(a.x, mm(b.x, s.x, p, pinv), p),
                    fhe::add_mod(a.y, mm(b.y, s.y, p, pinv), p),
                    fhe::add_mod(a.z, mm(b.z, s.z, p, pinv), p),
                    fhe::add_mod(a.w, mm(b.w, s.w, p, pinv), p));
}

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  return x;
}

// Grid B * C blocks, clusters of C along x: block b takes row b / C and
// coefficients [rank * N/C, (rank + 1) * N/C) of every limb, vector
// threadIdx.x of the slice (blockDim.x >= the slice's N/(4C) vectors).
template <int C>
__global__ void __launch_bounds__(kDecryptThreads)
decrypt_coeff_kernel(const DecryptArgs a) {
  __shared__ unsigned long long warp_part[kMaxLimbs][kDecryptThreads / 32];
  __shared__ unsigned long long limb_part[kMaxLimbs];
  const int row = blockIdx.x / C, rank = blockIdx.x % C;
  const int per = a.n4 / C;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long poly = static_cast<long long>(a.limbs) * a.n4;
  const uint4* c = a.data + static_cast<long long>(row) * a.k * poly;
  const bool active = static_cast<int>(threadIdx.x) < per;
  const int v = rank * per + static_cast<int>(threadIdx.x);
  // kGroup limbs at a time: every load of the group is issued before the
  // first is used, so a row's limbs cost ceil(l / kGroup) trips to memory.
  for (int i0 = 0; i0 < a.limbs; i0 += kGroup) {
    uint4 x0[kGroup] = {}, x1[kGroup] = {}, x2[kGroup] = {}, sv[kGroup] = {}, s2v[kGroup] = {},
          wv[kGroup] = {};
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const long long o = static_cast<long long>(i0 + u) * a.n4 + v;
      if (active && i0 + u < a.limbs) {
        x0[u] = __ldg(c + o);
        x1[u] = __ldg(c + poly + o);
        sv[u] = __ldg(a.s + o);
        wv[u] = __ldg(a.w + o);
        if (a.k == 3) {
          x2[u] = __ldg(c + 2 * poly + o);
          s2v[u] = __ldg(a.s2 + o);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int i = i0 + u;
      if (i >= a.limbs) break;
      const uint32_t p = __ldg(a.dec.p + i), pinv = __ldg(a.p_neg_inv + i);
      uint4 ph = mac(x0[u], x1[u], sv[u], p, pinv);
      if (a.k == 3) ph = mac(ph, x2[u], s2v[u], p, pinv);
      const uint4& w = wv[u];
      unsigned long long acc =
          static_cast<unsigned long long>(mm(ph.x, w.x, p, pinv)) + mm(ph.y, w.y, p, pinv) +
          mm(ph.z, w.z, p, pinv) + mm(ph.w, w.w, p, pinv);
      acc = warp_sum(active ? acc : 0);
      if (lane == 0) warp_part[i][warp] = acc;
    }
  }
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < a.limbs) {
    unsigned long long s = 0;
    for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) s += warp_part[threadIdx.x][w];
    limb_part[threadIdx.x] = s;
  }
  if constexpr (C > 1) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
  if (rank == 0 && warp == 0) {
    const fhe::RnsDecodeTables dec = a.dec;
    fhe::RnsDecodeShare sh{0, 0};
    if (lane < a.limbs) {
      unsigned long long s = limb_part[lane];
      if constexpr (C > 1) {
        cg::cluster_group cluster = cg::this_cluster();
#pragma unroll
        for (int b = 1; b < C; ++b) s += *cluster.map_shared_rank(&limb_part[lane], b);
      }
      sh = fhe::rns_decode_share(static_cast<uint32_t>(s % __ldg(dec.p + lane)), lane, dec);
    }
    const unsigned long long vs = warp_sum(sh.v), ms = warp_sum(sh.m);
    if (lane == 0) a.out[row] = fhe::rns_decode_finish(vs, ms, dec, a.pt_corr);
  }
  // The other blocks' shared memory must outlive the first block's reads.
  if constexpr (C > 1) cg::this_cluster().sync();
}

// A cluster above 8 blocks needs the kernel's leave, set once per device.
template <int C>
int allow_cluster() {
  static std::atomic<bool> set[kMaxDevices];
  if constexpr (C > 8) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev >= kMaxDevices) return kInvalid;
    if (!set[dev].load()) {
      e = cudaFuncSetAttribute(decrypt_coeff_kernel<C>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (e != cudaSuccess) return static_cast<int>(e);
      set[dev].store(true);
    }
  }
  return 0;
}

template <int C>
int launch_decrypt(const DecryptArgs& a, int batch, int threads, cudaStream_t stream) {
  const int err = allow_cluster<C>();
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(batch) * C);
  cfg.blockDim = dim3(threads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  if constexpr (C > 1) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  const cudaError_t e = cudaLaunchKernelEx(&cfg, decrypt_coeff_kernel<C>, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// (c, out, primes, p_neg_inv, mu, t_mont, pd_mod_pi, t_inv_mont_pd, pd_half,
// R, l, N, stream): c (R, 1, N) coefficients of the dropped limb p_{l-1},
// out (R, l - 1, N), both contiguous and 16-byte aligned; primes, p_neg_inv,
// mu, t_mont the context's per-limb columns (at least l words), pd_mod_pi
// l - 1 words, t_inv_mont_pd and pd_half one word.  One launch on `stream`.
int fhe_modswitch_lift(const void* c, void* out, const void* primes, const void* p_neg_inv,
                       const void* mu, const void* t_mont, const void* pd_mod_pi,
                       const void* t_inv_mont_pd, const void* pd_half, int rows, int l, int n,
                       void* stream) {
  const int log_n4 = n >= 4 ? log2_exact(n / 4) : -1;
  const long long vectors = static_cast<long long>(rows) * (n / 4);
  const long long blocks = (vectors + kThreads - 1) / kThreads;
  if (rows < 1 || l < 2 || l - 1 > 65535 || log_n4 < 0 || blocks > INT_MAX || !aligned16(c) ||
      !aligned16(out))
    return kInvalid;
  modswitch_lift_kernel<<<dim3(static_cast<unsigned>(blocks), l - 1), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(c), static_cast<uint4*>(out),
      static_cast<const uint32_t*>(primes), static_cast<const uint32_t*>(p_neg_inv),
      static_cast<const uint32_t*>(mu), static_cast<const uint32_t*>(t_mont),
      static_cast<const uint32_t*>(pd_mod_pi), static_cast<const uint32_t*>(t_inv_mont_pd),
      static_cast<const uint32_t*>(pd_half), vectors, l - 1, log_n4);
  return static_cast<int>(cudaGetLastError());
}

// (x, delta, out, primes, p_neg_inv, inv_pd_mont, R, l, N, stream): x (R, l,
// N) the ciphertext rows, delta and out (R, l - 1, N), each contiguous and
// 16-byte aligned; inv_pd_mont l - 1 words.  One launch on `stream`.
int fhe_modswitch_tail(const void* x, const void* delta, void* out, const void* primes,
                       const void* p_neg_inv, const void* inv_pd_mont, int rows, int l, int n,
                       void* stream) {
  const int log_n4 = n >= 4 ? log2_exact(n / 4) : -1;
  const long long vectors = static_cast<long long>(rows) * (n / 4);
  const long long blocks = (vectors + kThreads - 1) / kThreads;
  if (rows < 1 || l < 2 || l - 1 > 65535 || log_n4 < 0 || blocks > INT_MAX || !aligned16(x) ||
      !aligned16(delta) || !aligned16(out))
    return kInvalid;
  modswitch_tail_kernel<<<dim3(static_cast<unsigned>(blocks), l - 1), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<const uint4*>(delta), static_cast<uint4*>(out),
      static_cast<const uint32_t*>(primes), static_cast<const uint32_t*>(p_neg_inv),
      static_cast<const uint32_t*>(inv_pd_mont), vectors, l - 1, log_n4);
  return static_cast<int>(cudaGetLastError());
}

// (data, s, s2, w, primes, p_neg_inv, inv_qhat, inv_qhat_sh, v_c, r_t_mont,
// q_mod_t_mont, t_neg_inv, mu_t, out, B, k, l, N, t, pt_corr, stream): data
// (B, k, l, N), s and s2 (>= l, N), w (l, N), each contiguous and 16-byte
// aligned; the per-limb columns at least l words, the three mod-t constants
// one word; out B int32; pt_corr given mod t.  N a power of two from 4 to
// 32768, l at most 32.  One launch on `stream`.
int fhe_decrypt_coeff(const void* data, const void* s, const void* s2, const void* w,
                      const void* primes, const void* p_neg_inv, const void* inv_qhat,
                      const void* inv_qhat_sh, const void* v_c, const void* r_t_mont,
                      const void* q_mod_t_mont, const void* t_neg_inv, const void* mu_t,
                      void* out, int batch, int k, int l, int n, int t, int pt_corr,
                      void* stream) {
  const int n4 = n / 4;
  const int cluster = std::min(kMaxCluster, std::max(1, n4 / kSlice));
  const int per = n4 / cluster;
  const int threads = std::max(32, per);
  if (batch < 1 || (k != 2 && k != 3) || l < 1 || l > kMaxLimbs || n < 4 ||
      log2_exact(n4) < 0 || per > kDecryptThreads ||
      static_cast<long long>(batch) * cluster > INT_MAX || t < 2 || pt_corr < 0 ||
      pt_corr >= t || !aligned16(data) || !aligned16(s) || !aligned16(s2) || !aligned16(w))
    return kInvalid;
  const DecryptArgs a{static_cast<const uint4*>(data),
                      static_cast<const uint4*>(s),
                      static_cast<const uint4*>(s2),
                      static_cast<const uint4*>(w),
                      static_cast<const uint32_t*>(p_neg_inv),
                      {static_cast<const uint32_t*>(primes), static_cast<const uint32_t*>(inv_qhat),
                       static_cast<const uint32_t*>(inv_qhat_sh),
                       static_cast<const uint32_t*>(v_c), static_cast<const uint32_t*>(r_t_mont),
                       static_cast<const uint32_t*>(q_mod_t_mont),
                       static_cast<const uint32_t*>(t_neg_inv),
                       static_cast<const uint32_t*>(mu_t), static_cast<uint32_t>(t)},
                      static_cast<int32_t*>(out),
                      k,
                      l,
                      n4,
                      static_cast<uint32_t>(pt_corr)};
  auto st = static_cast<cudaStream_t>(stream);
  switch (cluster) {
    case 1: return launch_decrypt<1>(a, batch, threads, st);
    case 2: return launch_decrypt<2>(a, batch, threads, st);
    case 4: return launch_decrypt<4>(a, batch, threads, st);
    case 8: return launch_decrypt<8>(a, batch, threads, st);
    case 16: return launch_decrypt<16>(a, batch, threads, st);
    default: return kInvalid;
  }
}

}  // extern "C"
