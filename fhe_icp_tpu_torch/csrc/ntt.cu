// Fused negacyclic NTT / INTT for Hopper: radix-8 register passes, rows of
// one limb sharing each twiddle load, clusters for short batches, and one
// warp per row at small N.
//
// Replaces the JAX package's Pallas kernels ops/ntt_pallas.py::_fwd_kernel
// (forward: psi twist, then decimation-in-frequency Gentleman-Sande
// butterflies, natural order in, bit-reversed order out) and ::_inv_kernel
// (decimation-in-time Cooley-Tukey, bit-reversed in, psi^-i N^-1 untwist,
// natural order out).  The cyclic entries (fhe_ntt_cyclic_fwd / _inv) are
// the same kernels without the twist and untwist: the size-N cyclic stages
// alone, unscaled, as the JAX package's ops/ntt.py::_cyclic_fwd and
// ::_cyclic_inv compute them, for the four-step ring-sharded NTT.
//
// Stage order and arithmetic are those of ops/ntt.py: every butterfly takes
// the same canonical residues and returns the same canonical residues, so
// the output equals the plain version bit for bit, whatever the grouping.
//
// What bounds it.  A transform must read and write each row once (8 bytes
// per coefficient): 0.16 ms at 3.35 TB/s for 16,384 rows x N = 4096.  Its
// N/2 log2 N Shoup butterflies take 7 or 8 integer instructions each on
// sm_90 (three multiplies; an add and its reduction fuse into one
// VIADDMNMX), time of the same order at the card's issue rate.  So both
// bound it, and the blocks resident on an SM overlap one's memory phase
// with another's passes.  Four costs stood in the way; the regimes below
// answer each:
//
// * Twiddle traffic.  Reloading a twiddle and its Shoup companion for every
//   butterfly moves 7x a row's own bytes through L2.  A block takes R rows
//   of one limb (rows r, r + L, ... of the (B, L, N) layout), loads each
//   twiddle pair once into registers and applies it to the same butterfly
//   of all R rows; the twist is loaded once per 16-byte chunk the same way.
// * Shared-memory round trips.  Each thread holds 8 coefficients of a row
//   and runs 3 stages on them in registers (a radix-8 pass): shared memory
//   is touched once per pass, ceil(log2 N / 3) times (4 at N = 4096, 5 at
//   16384) instead of once per stage.  The exchange layout is swizzled (the
//   16-byte chunk index within each 128-byte line XOR the line index mod 8)
//   so that no pass has bank conflicts: strides of 4 words and up are read
//   one word a thread, the stride-1 pass as two 16-byte vectors.  Passes are
//   ordered so that no pass has stride 2, the one the swizzle cannot serve.
// * One block per row.  A batch too short to fill the card (the per-query
//   transform of 2 rows, a 12-limb ring-16384 polynomial) spreads each row
//   over a cluster of C blocks, each holding N/C coefficients in its shared
//   memory.  The first log2 C forward stages (the last log2 C inverse ones)
//   pair coefficients of different blocks: one radix-C step reads the C
//   values at one offset of every block through distributed shared memory,
//   between two cluster barriers; the other stages run locally.
// * Small N (16 ... 256, the four-step NTT's column and row transforms):
//   one warp per row (N/E lanes, E = 2, 4 or 8 coefficients a lane, several
//   rows a warp), the row in registers, the stages that cross lanes
//   exchanged by __shfl_xor_sync, no __syncthreads at all.
//
// ops/ntt_cuda.py::launch_shape picks the regime, R, C and the block size;
// the entry points check that what they are given is one they can launch.
//
// Layout: x is (rows, N) uint32 with rows = batch * L; row r holds limb
// r % L.  table is (L_plan, 4N) per limb: [twist | twist Shoup | stage
// (twiddle, Shoup) pairs], stage s at pair offset N - (N >> s).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>
#include <cstdint>

#include "modmath.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxBlockThreads = 256;
constexpr int kWarpBlockThreads = 128;

// a * w mod p, w = (twiddle, Shoup companion), for any 32-bit a.
__device__ __forceinline__ uint32_t mul_p(uint32_t a, uint2 w, uint32_t p) {
  return fhe::shoup_mul(a, w.x, w.y, p);
}

// The integer pipes are the passes' limit, so the forward butterfly feeds
// u - v + p (< 2p) to the Shoup product unreduced: it takes any 32-bit a.
__device__ __forceinline__ void dif(uint32_t& a, uint32_t& b, uint2 w, uint32_t p) {
  const uint32_t u = a, v = b;
  a = fhe::add_mod(u, v, p);
  b = mul_p(u - v + p, w, p);
}

__device__ __forceinline__ void dit(uint32_t& a, uint32_t& b, uint2 w, uint32_t p) {
  const uint32_t u = a, t = mul_p(b, w, p);
  a = fhe::add_mod(u, t, p);
  b = fhe::sub_mod(u, t, p);
}

// Word i of a row's exchange buffer: the 16-byte chunk index inside each
// 128-byte line XOR the line index mod 8.  Keeps 4-word chunks whole.
__device__ __forceinline__ int swz(int i) { return i ^ ((i >> 3) & 28); }

struct Args {
  const uint32_t* x;
  uint32_t* y;
  const uint32_t* table;
  const uint32_t* primes;
  int rows, L, n, log_n, rows_per_block;
};

// Pair offset of stage s in the twiddle block.
__device__ __forceinline__ int stage_off(int n, int s) { return n - (n >> s); }

// ---------------------------------------------------------------------------
// Block regime: one limb's R rows (C = 1) or one row over a cluster of C.
// ---------------------------------------------------------------------------

// Twiddles of a pass of K stages at stride 2^lg_s for group offset j:
// stage h (m = 2^(lg_s + h)) needs 2^h pairs, at w[2^h - 1 + c].
template <int K>
__device__ __forceinline__ void pass_twiddles(uint2 (&w)[7], const uint2* tw, int n, int log_n,
                                              int lg_s, int j) {
#pragma unroll
  for (int h = 0; h < K; ++h) {
    const int off = stage_off(n, log_n - 1 - lg_s - h);
#pragma unroll
    for (int c = 0; c < (1 << h); ++c) w[(1 << h) - 1 + c] = tw[off + (c << lg_s) + j];
  }
}

// K stages on 8 registers: index bit h of v pairs at distance 2^h.  With K
// < 3 the registers hold 8 / 2^K independent groups.
template <bool kFwd, int K>
__device__ __forceinline__ void radix8(uint32_t (&v)[8], const uint2 (&w)[7], uint32_t p) {
#pragma unroll
  for (int q = 0; q < K; ++q) {
    const int h = kFwd ? K - 1 - q : q;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (i & (1 << h)) continue;
      const uint2 t = w[(1 << h) - 1 + (i & ((1 << h) - 1))];
      if (kFwd)
        dif(v[i], v[i | (1 << h)], t, p);
      else
        dit(v[i], v[i | (1 << h)], t, p);
    }
  }
}

// A pass at stride S = 2^lg_s >= 4 over R rows of M words in shared
// memory: group g holds words b*8S + j + i*S (b = g / S, j = g % S).
template <bool kFwd, int K>
__device__ void pass_shared(uint32_t* buf, int rows_here, int m_words, int lg_s, const uint2* tw,
                            int n, int log_n, uint32_t p) {
  for (int g = threadIdx.x; g < m_words / 8; g += blockDim.x) {
    const int j = g & ((1 << lg_s) - 1);
    const int base = ((g >> lg_s) << (lg_s + 3)) + j;
    uint2 w[7];
    pass_twiddles<K>(w, tw, n, log_n, lg_s, j);
    int a[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] = swz(base + (i << lg_s));
#pragma unroll 4
    for (int r = 0; r < rows_here; ++r) {
      uint32_t* row = buf + r * m_words;
      uint32_t v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = row[a[i]];
      radix8<kFwd, K>(v, w, p);
#pragma unroll
      for (int i = 0; i < 8; ++i) row[a[i]] = v[i];
    }
  }
}

// The stride-1 pass: 8 consecutive words a thread, as two 16-byte vectors.
// Forward: the last pass, shared memory -> device memory.  Inverse: the
// first, device memory -> shared memory.  Row r of the block is at
// src + r * stride and dst + r * stride.
template <bool kFwd, int K>
__device__ void pass_unit(uint32_t* buf, const uint32_t* src, uint32_t* dst, size_t stride,
                          int rows_here, int m_words, const uint2* tw, int n, int log_n,
                          uint32_t p) {
  uint2 w[7];
  pass_twiddles<K>(w, tw, n, log_n, 0, 0);
  for (int g = threadIdx.x; g < m_words / 8; g += blockDim.x) {
    const int a = swz(8 * g);
#pragma unroll 2
    for (int r = 0; r < rows_here; ++r) {
      uint4 lo, hi;
      if (kFwd) {
        lo = *reinterpret_cast<const uint4*>(buf + r * m_words + a);
        hi = *reinterpret_cast<const uint4*>(buf + r * m_words + (a ^ 4));
      } else {
        lo = reinterpret_cast<const uint4*>(src + r * stride)[2 * g];
        hi = reinterpret_cast<const uint4*>(src + r * stride)[2 * g + 1];
      }
      uint32_t v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      radix8<kFwd, K>(v, w, p);
      lo = make_uint4(v[0], v[1], v[2], v[3]);
      hi = make_uint4(v[4], v[5], v[6], v[7]);
      if (kFwd) {
        reinterpret_cast<uint4*>(dst + r * stride)[2 * g] = lo;
        reinterpret_cast<uint4*>(dst + r * stride)[2 * g + 1] = hi;
      } else {
        *reinterpret_cast<uint4*>(buf + r * m_words + a) = lo;
        *reinterpret_cast<uint4*>(buf + r * m_words + (a ^ 4)) = hi;
      }
    }
  }
}

// Device memory <-> shared memory in 16-byte chunks, with the (un)twist:
// the forward's first load (from src), the inverse's last store (to dst).
// One twist load per chunk serves all the block's rows; `twist` and
// `twist_sh` start at the block's first word of the row.
template <bool kLoad, bool kTwist>
__device__ void copy_rows(uint32_t* buf, const uint32_t* src, uint32_t* dst, size_t stride,
                          int rows_here, int m_words, const uint32_t* twist,
                          const uint32_t* twist_sh, uint32_t p) {
  for (int q = threadIdx.x; q < m_words / 4; q += blockDim.x) {
    uint4 t = {}, ts = {};
    if (kTwist) {
      t = reinterpret_cast<const uint4*>(twist)[q];
      ts = reinterpret_cast<const uint4*>(twist_sh)[q];
    }
    uint4* s = reinterpret_cast<uint4*>(buf + swz(4 * q));
#pragma unroll 4
    for (int r = 0; r < rows_here; ++r) {
      uint4 v = kLoad ? reinterpret_cast<const uint4*>(src + r * stride)[q]
                      : s[r * m_words / 4];
      if (kTwist) {
        v.x = mul_p(v.x, make_uint2(t.x, ts.x), p);
        v.y = mul_p(v.y, make_uint2(t.y, ts.y), p);
        v.z = mul_p(v.z, make_uint2(t.z, ts.z), p);
        v.w = mul_p(v.w, make_uint2(t.w, ts.w), p);
      }
      if (kLoad)
        s[r * m_words / 4] = v;
      else
        reinterpret_cast<uint4*>(dst + r * stride)[q] = v;
    }
  }
}

// The radix-C step across the cluster: this block's share of the offsets
// `loc`, the C values at loc of every block (element c * M + loc).
template <bool kFwd, int C>
__device__ void cross_step(uint32_t* buf, int m_words, const uint2* tw, int n, uint32_t p) {
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int kLg = C == 2 ? 1 : C == 4 ? 2 : C == 8 ? 3 : 4;
  const int per = m_words / C;
  const int first = static_cast<int>(cluster.block_rank()) * per;
  for (int t = threadIdx.x; t < per; t += blockDim.x) {
    const int loc = first + t;
    uint32_t* cell = buf + swz(loc);
    uint32_t v[C];
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = *cluster.map_shared_rank(cell, c);
#pragma unroll
    for (int q = 0; q < kLg; ++q) {
      const int h = kFwd ? kLg - 1 - q : q;  // m = M * 2^h, stage kLg - 1 - h
      const int off = stage_off(n, kLg - 1 - h);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (c & (1 << h)) continue;
        const uint2 w = tw[off + (c & ((1 << h) - 1)) * m_words + loc];
        if (kFwd)
          dif(v[c], v[c | (1 << h)], w, p);
        else
          dit(v[c], v[c | (1 << h)], w, p);
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c) *cluster.map_shared_rank(cell, c) = v[c];
  }
}

// Local stages of a block's M = 2^lg_m words: radix-8 passes, then one or
// two radix-4 passes so that the last has stride 1 and none stride 2.
__device__ __forceinline__ int radix4_passes(int lg_m) { return (3 - lg_m % 3) % 3; }

template <bool kFwd, bool kTwist, int C>
__global__ void __launch_bounds__(kMaxBlockThreads)
    ntt_block_kernel(Args a) {
  extern __shared__ uint4 smem[];
  uint32_t* buf = reinterpret_cast<uint32_t*>(smem);
  constexpr int kLgC = C == 1 ? 0 : C == 2 ? 1 : C == 4 ? 2 : C == 8 ? 3 : 4;
  const int n = a.n, m_words = n / C, lg_m = a.log_n - kLgC;

  // Rows: C = 1 takes up to R rows of one limb; C > 1 one row, a block's
  // share [c * M, (c + 1) * M) of it.
  int limb, first_row, rows_here, col = 0;
  if constexpr (C == 1) {
    const int batch = a.rows / a.L;
    limb = blockIdx.x % a.L;
    const int grp = blockIdx.x / a.L;
    first_row = grp * a.rows_per_block * a.L + limb;
    rows_here = min(a.rows_per_block, batch - grp * a.rows_per_block);
  } else {
    first_row = blockIdx.x / C;
    limb = first_row % a.L;
    rows_here = 1;
    col = static_cast<int>(cg::this_cluster().block_rank()) * m_words;
  }
  const uint32_t p = a.primes[limb];
  const uint32_t* tab = a.table + static_cast<size_t>(limb) * 4 * n;
  const uint2* tw = reinterpret_cast<const uint2*>(tab + 2 * n);

  // Row r of the block starts at in + r * stride (and out + r * stride).
  const size_t stride = static_cast<size_t>(a.L) * n;
  const uint32_t* in = a.x + static_cast<size_t>(first_row) * n + col;
  uint32_t* out = a.y + static_cast<size_t>(first_row) * n + col;

  const int n4 = radix4_passes(lg_m), n8 = (lg_m - 2 * n4) / 3;
  if (kFwd) {
    copy_rows<true, kTwist>(buf, in, out, stride, rows_here, m_words, tab + col, tab + n + col,
                            p);
    if constexpr (C > 1) {
      cg::this_cluster().sync();
      cross_step<true, C>(buf, m_words, tw, n, p);
      cg::this_cluster().sync();
    } else {
      __syncthreads();
    }
    int lg = lg_m;
    for (int i = 0; i < n8; ++i) {
      lg -= 3;
      if (lg == 0) {
        pass_unit<true, 3>(buf, in, out, stride, rows_here, m_words, tw, n, a.log_n, p);
        return;
      }
      pass_shared<true, 3>(buf, rows_here, m_words, lg, tw, n, a.log_n, p);
      __syncthreads();
    }
    for (int i = 0; i < n4; ++i) {
      lg -= 2;
      if (lg == 0) {
        pass_unit<true, 2>(buf, in, out, stride, rows_here, m_words, tw, n, a.log_n, p);
        return;
      }
      pass_shared<true, 2>(buf, rows_here, m_words, lg, tw, n, a.log_n, p);
      __syncthreads();
    }
  } else {
    int lg;
    if (n4 > 0) {
      pass_unit<false, 2>(buf, in, out, stride, rows_here, m_words, tw, n, a.log_n, p);
      lg = 2;
    } else {
      pass_unit<false, 3>(buf, in, out, stride, rows_here, m_words, tw, n, a.log_n, p);
      lg = 3;
    }
    __syncthreads();
    for (int i = 1; i < n4; ++i) {
      pass_shared<false, 2>(buf, rows_here, m_words, lg, tw, n, a.log_n, p);
      lg += 2;
      __syncthreads();
    }
    for (int i = n4 > 0 ? 0 : 1; i < n8; ++i) {
      pass_shared<false, 3>(buf, rows_here, m_words, lg, tw, n, a.log_n, p);
      lg += 3;
      __syncthreads();
    }
    if constexpr (C > 1) {
      cg::this_cluster().sync();
      cross_step<false, C>(buf, m_words, tw, n, p);
      cg::this_cluster().sync();
    }
    copy_rows<false, kTwist>(buf, in, out, stride, rows_here, m_words, tab + col, tab + n + col,
                             p);
  }
}

// ---------------------------------------------------------------------------
// Warp regime (N <= 256): N / E lanes a row, lane l holds l + (N / E) * e.
// ---------------------------------------------------------------------------

template <bool kFwd, bool kTwist, int E>
__global__ void __launch_bounds__(kWarpBlockThreads) ntt_warp_kernel(Args a) {
  constexpr int kLgE = E == 2 ? 1 : E == 4 ? 2 : 3;
  const int n = a.n, lanes = n / E;
  const int l = threadIdx.x & (lanes - 1);
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / lanes;
  const bool live = row < a.rows;  // dead lanes still shuffle
  const int limb = live ? row % a.L : 0;
  const uint32_t p = a.primes[limb];
  const uint32_t* tab = a.table + static_cast<size_t>(limb) * 4 * n;
  const uint2* tw = reinterpret_cast<const uint2*>(tab + 2 * n);
  const size_t base = static_cast<size_t>(live ? row : 0) * n;

  uint32_t v[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = l + lanes * e;
    v[e] = live ? a.x[base + i] : 0u;
    if (kFwd && kTwist) v[e] = mul_p(v[e], make_uint2(tab[i], tab[n + i]), p);
  }

  if (kFwd) {
#pragma unroll
    for (int s = 0; s < kLgE; ++s) {  // m = (E >> (s + 1)) * lanes: in registers
      const int d = E >> (s + 1), off = stage_off(n, s);
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (!(e & d)) dif(v[e], v[e + d], tw[off + l + lanes * (e & (d - 1))], p);
    }
    for (int s = kLgE; s < a.log_n; ++s) {  // m < lanes: across lanes
      const int m = n >> (s + 1);
      const bool high = l & m;
      const uint2 w = tw[stage_off(n, s) + (l & (m - 1))];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const uint32_t o = __shfl_xor_sync(0xffffffffu, v[e], m);
        v[e] = high ? mul_p(o - v[e] + p, w, p) : fhe::add_mod(v[e], o, p);
      }
    }
  } else {
    for (int s = a.log_n - 1; s >= kLgE; --s) {
      const int m = n >> (s + 1);
      const bool high = l & m;
      const uint2 w = tw[stage_off(n, s) + (l & (m - 1))];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const uint32_t mine = high ? mul_p(v[e], w, p) : v[e];
        const uint32_t o = __shfl_xor_sync(0xffffffffu, mine, m);
        v[e] = high ? fhe::sub_mod(o, mine, p) : fhe::add_mod(mine, o, p);
      }
    }
#pragma unroll
    for (int s = kLgE - 1; s >= 0; --s) {
      const int d = E >> (s + 1), off = stage_off(n, s);
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (!(e & d)) dit(v[e], v[e + d], tw[off + l + lanes * (e & (d - 1))], p);
    }
  }

  if (!live) return;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = l + lanes * e;
    if (!kFwd && kTwist) v[e] = mul_p(v[e], make_uint2(tab[i], tab[n + i]), p);
    a.y[base + i] = v[e];
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);
constexpr int kMaxDevices = 64;

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Function attributes are set once per instance and device, not per launch:
// the shared-memory limit only when a launch needs more than was set.
template <bool kFwd, bool kTwist, int C>
int set_attributes(size_t smem) {
  auto kernel = ntt_block_kernel<kFwd, kTwist, C>;
  static std::atomic<int> smem_set[kMaxDevices];
  static std::atomic<bool> cluster_set[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= kMaxDevices) return kInvalid;
  const int want = static_cast<int>(smem);
  if (want > 48 * 1024 && want > smem_set[dev].load()) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, want);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set[dev].store(want);
  }
  if (C > 8 && !cluster_set[dev].load()) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return static_cast<int>(e);
    cluster_set[dev].store(true);
  }
  return 0;
}

template <bool kFwd, bool kTwist, int C>
int launch_block(const Args& a, int threads, cudaStream_t stream) {
  auto kernel = ntt_block_kernel<kFwd, kTwist, C>;
  const int m_words = a.n / C;
  const size_t smem = static_cast<size_t>(a.rows_per_block) * m_words * sizeof(uint32_t);
  // Rows and tables move as 16-byte vectors.
  if (m_words < 32 || (C > 1 && a.rows_per_block != 1) || a.rows_per_block > 8 ||
      threads != std::min(m_words / 8, kMaxBlockThreads) || !aligned16(a.x) ||
      !aligned16(a.y) || !aligned16(a.table))
    return kInvalid;
  int err = set_attributes<kFwd, kTwist, C>(smem);
  if (err) return err;
  const int batch = a.rows / a.L;
  const int blocks = C == 1 ? a.L * ((batch + a.rows_per_block - 1) / a.rows_per_block)
                            : a.rows * C;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
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
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <bool kFwd, bool kTwist, int E>
int launch_warp(const Args& a, int threads, cudaStream_t stream) {
  const int lanes = a.n / E;
  if (lanes > 32 || threads != kWarpBlockThreads || a.rows_per_block != threads / lanes)
    return kInvalid;
  const int blocks = (a.rows + a.rows_per_block - 1) / a.rows_per_block;
  ntt_warp_kernel<kFwd, kTwist, E><<<blocks, threads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool kFwd, bool kTwist>
int launch(const void* x, void* y, const void* table, const void* primes, int rows, int L, int n,
           int log_n, int rows_per_block, int cluster, int threads, void* stream) {
  const Args a{static_cast<const uint32_t*>(x), static_cast<uint32_t*>(y),
               static_cast<const uint32_t*>(table), static_cast<const uint32_t*>(primes),
               rows, L, n, log_n, rows_per_block};
  auto s = static_cast<cudaStream_t>(stream);
  if (n != (1 << log_n) || rows <= 0 || L <= 0 || rows % L || rows_per_block < 1) return kInvalid;
  if (n <= 256) {
    if (cluster != 1) return kInvalid;
    switch (n) {
      case 16: case 32: case 64: return launch_warp<kFwd, kTwist, 2>(a, threads, s);
      case 128: return launch_warp<kFwd, kTwist, 4>(a, threads, s);
      case 256: return launch_warp<kFwd, kTwist, 8>(a, threads, s);
      default: return kInvalid;
    }
  }
  switch (cluster) {
    case 1: return launch_block<kFwd, kTwist, 1>(a, threads, s);
    case 2: return launch_block<kFwd, kTwist, 2>(a, threads, s);
    case 4: return launch_block<kFwd, kTwist, 4>(a, threads, s);
    case 8: return launch_block<kFwd, kTwist, 8>(a, threads, s);
    case 16: return launch_block<kFwd, kTwist, 16>(a, threads, s);
    default: return kInvalid;
  }
}

}  // namespace

extern "C" {

// Each entry: (x, y, table, primes, rows, L, N, log2 N, rows per block,
// cluster size, threads per block, stream), as ops/ntt_cuda.launch_shape
// chooses them.  Returns a CUDA error code (cudaErrorInvalidValue for a
// launch shape the kernels do not take).

int fhe_ntt_fwd(const void* x, void* y, const void* table, const void* primes, int rows, int L,
                int n, int log_n, int rows_per_block, int cluster, int threads, void* stream) {
  return launch<true, true>(x, y, table, primes, rows, L, n, log_n, rows_per_block, cluster,
                            threads, stream);
}

int fhe_ntt_inv(const void* x, void* y, const void* table, const void* primes, int rows, int L,
                int n, int log_n, int rows_per_block, int cluster, int threads, void* stream) {
  return launch<false, true>(x, y, table, primes, rows, L, n, log_n, rows_per_block, cluster,
                             threads, stream);
}

int fhe_ntt_cyclic_fwd(const void* x, void* y, const void* table, const void* primes, int rows,
                       int L, int n, int log_n, int rows_per_block, int cluster, int threads,
                       void* stream) {
  return launch<true, false>(x, y, table, primes, rows, L, n, log_n, rows_per_block, cluster,
                             threads, stream);
}

int fhe_ntt_cyclic_inv(const void* x, void* y, const void* table, const void* primes, int rows,
                       int L, int n, int log_n, int rows_per_block, int cluster, int threads,
                       void* stream) {
  return launch<false, false>(x, y, table, primes, rows, L, n, log_n, rows_per_block, cluster,
                              threads, stream);
}

const char* fhe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
