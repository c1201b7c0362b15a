// The hybrid keyswitch's digit-key inner product, in one launch:
//
//   acc[b, c, i, x] = sum_j mont_mul(d[b, j, i, x], ksk[j, c, i, x]) mod p_i
//
// for the digits d (B, n_dig, L, N) of the switched polynomials in the NTT
// domain and the Montgomery key ksk (n_dig, 2, L, N), both over the
// extended chain Q_l * P (L = l + 1 limbs, limb i modulo p_i).  The output
// acc (B, 2, L, N) is what ops/arith.py::_div_special divides by P.
//
// It replaces no Pallas kernel: the JAX package's ops/arith.py leaves this
// loop of Montgomery products and modular sums to XLA, which fuses it into
// one pass.  Unfused on the card it was about 36 int64 elementwise launches
// a digit; this kernel computes the whole loop in one.
//
// What bounds it.  Each digit word is read once and multiplied by two key
// words; no word is used twice within a polynomial, so the kernel is bound
// by bytes: (B n_dig + 2 n_dig + 2 B) L N words.  At one ring-16384
// relinearization (B = 1, n_dig = 12, L = 13, N = 16384) that is 32.4 MB,
// 9.7 us at 3.35 TB/s; its 2 B n_dig L N Montgomery products and sums take
// about a fifth of that at the card's integer issue rate.  The design:
//
// * Each thread owns 4 consecutive coefficients of one limb and moves them
//   as 16-byte vectors, neighbouring threads on neighbouring vectors, so a
//   warp reads 512 contiguous bytes a load.  Both accumulators stay in
//   registers over all n_dig digits and are written once, canonical.
// * A block covers one limb (N / 4 >= its threads, or N / 4 threads): the
//   limb's prime and its Montgomery constant are loaded once a block.
// * A thread walks BT rows of the batch (BT = 1, 2 or 4, from B) and loads
//   each key vector once for all of them; blocks that share a key tile
//   have consecutive indices (the batch chunk is blockIdx.x), so they run
//   together and the key leaves device memory about once a call.  A whole
//   relinearization's key (20.4 MB at ring-16384) fits the 50 MB L2, so
//   between compares it may not leave L2 at all.
// * The launch shape follows from B, L and N alone.
//
// The products and sums are those of modmath.cuh, each canonical, so the
// result equals ops/keyswitch_cuda.py::inner_product_ref bit for bit.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "modmath.cuh"

namespace {

constexpr int kMaxThreads = 256;

__device__ __forceinline__ uint4 load(const uint4* p) { return __ldg(p); }

// acc + a * k * R^-1 (mod p), lane by lane.
__device__ __forceinline__ void mac(uint4& acc, const uint4& a, const uint4& k, uint32_t p,
                                    uint32_t p_neg_inv) {
  acc.x = fhe::add_mod(acc.x, fhe::mont_mul(a.x, k.x, p, p_neg_inv), p);
  acc.y = fhe::add_mod(acc.y, fhe::mont_mul(a.y, k.y, p, p_neg_inv), p);
  acc.z = fhe::add_mod(acc.z, fhe::mont_mul(a.z, k.z, p, p_neg_inv), p);
  acc.w = fhe::add_mod(acc.w, fhe::mont_mul(a.w, k.w, p, p_neg_inv), p);
}

// Grid (batch chunks of BT rows, L * tiles): block (x, y) takes limb
// y / tiles, vectors (y % tiles) * blockDim.x + threadIdx.x of its rows.
// Word offsets in units of 16-byte vectors, n4 = N / 4 a row:
//   d[b, j, i]: ((b * n_dig + j) * L + i) * n4
//   ksk[j, c, i]: ((2j + c) * L + i) * n4
//   acc[b, c, i]: ((2b + c) * L + i) * n4
template <int BT>
__global__ void __launch_bounds__(kMaxThreads)
keyswitch_inner_kernel(const uint4* __restrict__ d, const uint4* __restrict__ ksk,
                       const uint32_t* __restrict__ primes,
                       const uint32_t* __restrict__ p_neg_inv, uint4* __restrict__ acc,
                       int batch, int n_dig, int L, int n4) {
  __shared__ uint32_t prime[2];
  const int tiles = n4 / blockDim.x;
  const int limb = blockIdx.y / tiles;
  if (threadIdx.x == 0) {
    prime[0] = primes[limb];
    prime[1] = p_neg_inv[limb];
  }
  __syncthreads();
  const uint32_t p = prime[0], pinv = prime[1];
  const long long g = static_cast<long long>(blockIdx.y % tiles) * blockDim.x + threadIdx.x;
  const long long row = static_cast<long long>(L) * n4;    // one (L, N) polynomial
  const int b0 = blockIdx.x * BT;
  const int rows = min(BT, batch - b0);
  const uint4* dp = d + static_cast<long long>(b0) * n_dig * row + limb * n4 + g;
  const uint4* kp = ksk + limb * n4 + g;

  uint4 acc0[BT], acc1[BT];
#pragma unroll
  for (int r = 0; r < BT; ++r) acc0[r] = acc1[r] = make_uint4(0, 0, 0, 0);
#pragma unroll 4
  for (int j = 0; j < n_dig; ++j) {
    const uint4 k0 = load(kp + 2LL * j * row);
    const uint4 k1 = load(kp + (2LL * j + 1) * row);
#pragma unroll
    for (int r = 0; r < BT; ++r) {
      if (r < rows) {
        const uint4 x = load(dp + (static_cast<long long>(r) * n_dig + j) * row);
        mac(acc0[r], x, k0, p, pinv);
        mac(acc1[r], x, k1, p, pinv);
      }
    }
  }
  uint4* out = acc + 2LL * b0 * row + limb * n4 + g;
#pragma unroll
  for (int r = 0; r < BT; ++r) {
    if (r < rows) {
      out[2LL * r * row] = acc0[r];
      out[(2LL * r + 1) * row] = acc1[r];
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <int BT>
int launch(const void* d, const void* ksk, const void* primes, const void* p_neg_inv, void* acc,
           int batch, int n_dig, int L, int n4, int threads, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((batch + BT - 1) / BT),
                  static_cast<unsigned>(L * (n4 / threads)));
  keyswitch_inner_kernel<BT><<<grid, threads, 0, stream>>>(
      static_cast<const uint4*>(d), static_cast<const uint4*>(ksk),
      static_cast<const uint32_t*>(primes), static_cast<const uint32_t*>(p_neg_inv),
      static_cast<uint4*>(acc), batch, n_dig, L, n4);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// (d, ksk, primes, p_neg_inv, acc, B, n_dig, L, N, stream): d (B, n_dig, L,
// N), ksk (n_dig, 2, L, N) and acc (B, 2, L, N) contiguous uint32, each
// 16-byte aligned; primes and p_neg_inv L words.  One launch on `stream`.
// Returns a CUDA error code (cudaErrorInvalidValue for sizes or pointers
// the kernel does not take).
int fhe_keyswitch_inner(const void* d, const void* ksk, const void* primes,
                        const void* p_neg_inv, void* acc, int batch, int n_dig, int L, int n,
                        void* stream) {
  const int n4 = n / 4;
  const int threads = std::min(n4, kMaxThreads);
  if (batch < 1 || n_dig < 1 || L < 1 || n < 4 || n % 4 || n4 % threads ||
      static_cast<long long>(L) * (n4 / threads) > 65535 || !aligned16(d) || !aligned16(ksk) ||
      !aligned16(acc))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (batch == 1) return launch<1>(d, ksk, primes, p_neg_inv, acc, batch, n_dig, L, n4, threads, s);
  if (batch == 2) return launch<2>(d, ksk, primes, p_neg_inv, acc, batch, n_dig, L, n4, threads, s);
  return launch<4>(d, ksk, primes, p_neg_inv, acc, batch, n_dig, L, n4, threads, s);
}

}  // extern "C"
