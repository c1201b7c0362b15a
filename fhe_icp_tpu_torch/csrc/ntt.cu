// Fused negacyclic NTT / INTT, one thread block per polynomial row.
//
// Replaces the JAX package's Pallas kernels ops/ntt_pallas.py::_fwd_kernel
// (forward: psi twist, then decimation-in-frequency Gentleman-Sande
// butterflies, natural order in, bit-reversed order out) and ::_inv_kernel
// (decimation-in-time Cooley-Tukey, bit-reversed in, psi^-i N^-1 untwist,
// natural order out).
//
// Bound on the H100: device memory.  A transform must read and write each
// row once (8 bytes per coefficient); its N/2 log2 N Shoup butterflies are
// three 32-bit multiplies each, far under the integer rate.  So the whole
// row (N words, 64 KiB at N = 16384) stays in shared memory for the twist
// and all stages: device memory sees one read and one write per
// coefficient, and the twiddle tables (4N words per limb) stay in L2.
//
// The cyclic entries (fhe_ntt_cyclic_fwd / _inv) run the same kernels
// without the twist and untwist multiply: the size-N cyclic DIF / DIT
// stages alone, unscaled, as the JAX package's ops/ntt.py::_cyclic_fwd and
// ::_cyclic_inv compute them.  The four-step ring-sharded NTT
// (parallel/ntt_dist.py) runs its column and row transforms through them
// at N = N1 and N2 (128 at ring 16384, 16 in the smallest tests); below
// N = 64 some of the block's 32 threads idle in every stage.
//
// Layout: x is (rows, N) uint32 with rows = batch * L; row r holds limb
// r % L.  table is (L_plan, 4N): [twist | twist Shoup | stage twiddles |
// their Shoup companions], stage s at offset N - (N >> s) of the last two
// blocks.  Stage order and arithmetic are those of ops/ntt.py, so the
// output equals the plain version bit for bit.

#include <cuda_runtime.h>

#include <cstdint>

#include "modmath.cuh"

namespace {

constexpr int kThreads = 512;

template <bool kTwist>
__global__ void ntt_fwd_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
                               const uint32_t* __restrict__ table,
                               const uint32_t* __restrict__ primes, int L, int n,
                               int log_n) {
  extern __shared__ uint32_t buf[];
  const int row = blockIdx.x;
  const int limb = row % L;
  const uint32_t p = primes[limb];
  const uint32_t* psi = table + static_cast<size_t>(limb) * 4 * n;
  const uint32_t* psi_sh = psi + n;
  const uint32_t* tw = psi + 2 * n;
  const uint32_t* tw_sh = psi + 3 * n;
  const uint32_t* src = x + static_cast<size_t>(row) * n;

  for (int i = threadIdx.x; i < n; i += blockDim.x)
    buf[i] = kTwist ? fhe::shoup_mul(src[i], psi[i], psi_sh[i], p) : src[i];
  __syncthreads();

  const int half = n >> 1;
  for (int s = 0; s < log_n; ++s) {
    const int lg_m = log_n - 1 - s;  // m = N >> (s + 1)
    const int m = 1 << lg_m;
    const int off = n - (n >> s);
    for (int i = threadIdx.x; i < half; i += blockDim.x) {
      const int j = i & (m - 1);
      const int i0 = ((i >> lg_m) << (lg_m + 1)) + j;
      const uint32_t u = buf[i0], v = buf[i0 + m];
      buf[i0] = fhe::add_mod(u, v, p);
      buf[i0 + m] = fhe::shoup_mul(fhe::sub_mod(u, v, p), tw[off + j], tw_sh[off + j], p);
    }
    __syncthreads();
  }

  uint32_t* dst = y + static_cast<size_t>(row) * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = buf[i];
}

template <bool kTwist>
__global__ void ntt_inv_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
                               const uint32_t* __restrict__ table,
                               const uint32_t* __restrict__ primes, int L, int n,
                               int log_n) {
  extern __shared__ uint32_t buf[];
  const int row = blockIdx.x;
  const int limb = row % L;
  const uint32_t p = primes[limb];
  const uint32_t* ipsi = table + static_cast<size_t>(limb) * 4 * n;
  const uint32_t* ipsi_sh = ipsi + n;
  const uint32_t* tw = ipsi + 2 * n;
  const uint32_t* tw_sh = ipsi + 3 * n;
  const uint32_t* src = x + static_cast<size_t>(row) * n;

  for (int i = threadIdx.x; i < n; i += blockDim.x) buf[i] = src[i];
  __syncthreads();

  const int half = n >> 1;
  for (int s = log_n - 1; s >= 0; --s) {
    const int lg_m = log_n - 1 - s;
    const int m = 1 << lg_m;
    const int off = n - (n >> s);
    for (int i = threadIdx.x; i < half; i += blockDim.x) {
      const int j = i & (m - 1);
      const int i0 = ((i >> lg_m) << (lg_m + 1)) + j;
      const uint32_t u = buf[i0];
      const uint32_t t = fhe::shoup_mul(buf[i0 + m], tw[off + j], tw_sh[off + j], p);
      buf[i0] = fhe::add_mod(u, t, p);
      buf[i0 + m] = fhe::sub_mod(u, t, p);
    }
    __syncthreads();
  }

  uint32_t* dst = y + static_cast<size_t>(row) * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    dst[i] = kTwist ? fhe::shoup_mul(buf[i], ipsi[i], ipsi_sh[i], p) : buf[i];
}

template <typename Kernel>
int launch(Kernel kernel, const void* x, void* y, const void* table, const void* primes,
           int rows, int L, int n, int log_n, void* stream) {
  const size_t smem = static_cast<size_t>(n) * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int threads = n / 2 < kThreads ? (n / 2 > 32 ? n / 2 : 32) : kThreads;
  kernel<<<rows, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(y),
      static_cast<const uint32_t*>(table), static_cast<const uint32_t*>(primes), L, n,
      log_n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int fhe_ntt_fwd(const void* x, void* y, const void* table, const void* primes, int rows,
                int L, int n, int log_n, void* stream) {
  return launch(ntt_fwd_kernel<true>, x, y, table, primes, rows, L, n, log_n, stream);
}

int fhe_ntt_inv(const void* x, void* y, const void* table, const void* primes, int rows,
                int L, int n, int log_n, void* stream) {
  return launch(ntt_inv_kernel<true>, x, y, table, primes, rows, L, n, log_n, stream);
}

int fhe_ntt_cyclic_fwd(const void* x, void* y, const void* table, const void* primes,
                       int rows, int L, int n, int log_n, void* stream) {
  return launch(ntt_fwd_kernel<false>, x, y, table, primes, rows, L, n, log_n, stream);
}

int fhe_ntt_cyclic_inv(const void* x, void* y, const void* table, const void* primes,
                       int rows, int L, int n, int log_n, void* stream) {
  return launch(ntt_inv_kernel<false>, x, y, table, primes, rows, L, n, log_n, stream);
}

const char* fhe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
