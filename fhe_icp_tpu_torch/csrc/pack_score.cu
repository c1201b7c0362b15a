// Fused packed scoring: int8 digit product + separable digit fold.
//
// Replaces the JAX package's Pallas kernel ops/pack_pallas.py::_fold_kernel.
// Per limb: out[g, s] = sum_{i,j} W[i, j*S+s] * (sum_k A[4g+i, k] * V[j*S+s, k])
// mod p, with A the (G*4, K) int8 doc digit planes, V the (4S, K) int8
// query digit columns (transposed by the wrapper so that k is innermost)
// and W = mont(2^{8(i+j)}).  Each int32 partial is exact
// (|partial| <= 128*128*K < 2^31), reduced with a signed Barrett step and
// multiplied by its Montgomery weight; the 16 products fold with add_mod.
//
// Bound on the H100: device memory.  The doc operand (L*G*4*K bytes,
// 128 MiB at the pairwise-4096 slice with G = 2048) is read once; the
// int8 work (2 ops per multiply-add) takes about half as long at the
// tensor-core rate.  This first version uses __dp4a on the CUDA cores,
// not the tensor cores, and is compute bound for now.
//
// Design: a block owns one limb and 256/S groups; thread (g, s) keeps the
// 4x4 digit-pair partials of its (group, slot) in registers, so the whole
// fold happens in the thread and only the (L, G, S) residues reach
// device memory.  K is consumed in steps of 64 digits staged in shared
// memory (rows padded to 17 words against bank conflicts).  Groups past
// G are masked in the kernel: no padded copy of the operand is made.

#include <cuda_runtime.h>

#include <cstdint>

#include "modmath.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWords = 16;           // int32 words (4 digits each) per K step
constexpr int kPitch = kWords + 1;   // padded shared-memory row

__global__ void __launch_bounds__(kThreads)
pack_score_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ vt,
                  const uint32_t* __restrict__ w, const uint32_t* __restrict__ tab,
                  uint32_t* __restrict__ out, int G, int K, int S) {
  extern __shared__ int32_t smem[];
  const int groups = kThreads / S;   // groups per block
  const int rows = 4 * groups;       // doc digit rows per block
  const int cols = 4 * S;            // query digit columns
  int32_t* as = smem;                // rows x kPitch
  int32_t* vs = smem + rows * kPitch;  // cols x kPitch

  const int limb = blockIdx.y;
  const int g0 = blockIdx.x * groups;
  const int kw = K / 4;
  const int32_t* a_l = a + (static_cast<size_t>(limb) * 4 * G + 4 * static_cast<size_t>(g0)) * kw;
  const int32_t* v_l = vt + static_cast<size_t>(limb) * cols * kw;
  const int rows_valid = min(rows, 4 * (G - g0));
  const int gl = threadIdx.x / S;
  const int s = threadIdx.x % S;

  int32_t acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < kw; k0 += kWords) {
    for (int idx = threadIdx.x; idx < rows * kWords; idx += kThreads) {
      const int r = idx / kWords, c = idx % kWords;
      as[r * kPitch + c] = r < rows_valid ? a_l[static_cast<size_t>(r) * kw + k0 + c] : 0;
    }
    for (int idx = threadIdx.x; idx < cols * kWords; idx += kThreads) {
      const int r = idx / kWords, c = idx % kWords;
      vs[r * kPitch + c] = v_l[static_cast<size_t>(r) * kw + k0 + c];
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kWords; ++c) {
      int32_t av[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[(gl * 4 + i) * kPitch + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) vv[j] = vs[(j * S + s) * kPitch + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(av[i], vv[j], acc[i][j]);
    }
    __syncthreads();
  }

  if (g0 + gl >= G) return;
  const uint32_t p = tab[limb * 8], p_neg_inv = tab[limb * 8 + 1], mu = tab[limb * 8 + 2];
  const uint32_t* w_l = w + static_cast<size_t>(limb) * 4 * cols;
  uint32_t sum = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t r = fhe::reduce_signed(acc[i][j], p, mu);
      sum = fhe::add_mod(sum, fhe::mont_mul(r, w_l[i * cols + j * S + s], p, p_neg_inv), p);
    }
  out[(static_cast<size_t>(limb) * G + g0 + gl) * S + s] = sum;
}

}  // namespace

extern "C" int fhe_pack_score(const void* a, const void* vt, const void* w, const void* tab,
                              void* out, int L, int G, int K, int S, void* stream) {
  const int groups = kThreads / S;
  const size_t smem = static_cast<size_t>(4 * groups + 4 * S) * kPitch * sizeof(int32_t);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(pack_score_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((G + groups - 1) / groups, L);
  pack_score_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a), static_cast<const int32_t*>(vt),
      static_cast<const uint32_t*>(w), static_cast<const uint32_t*>(tab),
      static_cast<uint32_t*>(out), G, K, S);
  return static_cast<int>(cudaGetLastError());
}
