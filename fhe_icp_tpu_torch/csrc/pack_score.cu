// Fused packed scoring: int8 digit product on the tensor cores + separable digit fold.
//
// Replaces the JAX package's Pallas kernel ops/pack_pallas.py::_fold_kernel.
// Per limb: out[g, s] = sum_{i,j} W[i, j*S+s] * (sum_k A[4g+i, k] * V[j*S+s, k])
// mod p, with A the (G*4, K) int8 doc digit planes, V the (4S, K) int8
// query digit columns (the entry point transposes the (K, 4S) operand on
// the stream first, so that k is innermost) and W = mont(2^{8(i+j)}).  Each int32 partial is exact
// (|partial| <= 128*128*K < 2^31), reduced with a signed Barrett step and
// multiplied by its Montgomery weight; the 16 products fold with add_mod.
//
// Bound on the H100: device memory.  The doc operand (L*G*4*K bytes,
// 128 MiB at the pairwise-4096 slice with G = 2048) is read once, and the
// kernel does 2*4S = 256 int8 operations per byte of it, where the tensor
// cores need about 590 per byte to be the limit.  So the design streams A
// at the memory's rate and keeps everything else on chip.
//
// Design (one block per 128-row tile of one limb and one slice of K):
// * A producer warp issues TMA loads of the A tile (128 rows x 128 bytes of
//   K) and the V tile (BN rows x 128 bytes) into a ring of kStages stages of
//   shared memory, 128-byte swizzled, each stage guarded by a "full" and an
//   "empty" mbarrier.  Rows past the end of A (the ragged last tile) and
//   columns past 4S (BN is 4S rounded up to a wgmma width) arrive as zeros
//   from TMA, and zero digits give zero partials: no padded copy is made.
// * Two consumer warpgroups, 64 rows each, run wgmma.m64nBNk32.s32.s8.s8 on
//   every stage (both operands K-major, as 8-bit wgmma requires) and keep
//   the exact int32 partials in registers.
// * Epilogue: the partials are staged in shared memory (over the ring), and
//   each consumer thread folds whole (group, slot) outputs: reduce_signed,
//   mont_mul by the weight, add_mod.  A block tile holds 32 whole groups,
//   so only (L, G, S) u32 residues reach device memory.
// * Split K (for stores too small to fill the card) and column tiles (when
//   4S is wider than the 256 columns of one wgmma): the fold is linear mod
//   p, so each (K slice, column tile) block folds its own partial sums and
//   the last one of a row tile to finish (a counter per tile, zeroed
//   before the launch) add_mods their residues from a scratch buffer into
//   the output.  add_mod of canonical residues is exact in any order.

#include <cuda_runtime.h>

#include <cstdint>

#include "modmath.cuh"
#include "tma_sm90.cuh"
#include "wgmma_s8.cuh"

namespace {

constexpr int kBlockRows = 128;             // doc digit rows per tile: 32 whole groups
constexpr int kBlockGroups = kBlockRows / 4;
constexpr int kBlockK = fhe::kTmaBoxK;      // K bytes per stage: one swizzled 128-byte row
constexpr int kWgmmaK = 32;                 // K bytes per wgmma
constexpr int kStages = 4;
constexpr int kConsumers = 256;             // two warpgroups of 64 rows each
constexpr int kThreads = kConsumers + 32;   // and one producer warp

template <int BN>
struct Layout {
  static constexpr int kA = kBlockRows * kBlockK;   // bytes of one A stage
  static constexpr int kB = BN * kBlockK;           // bytes of one V stage
  static constexpr int kStage = kA + kB;            // multiple of 1024: swizzle atoms stay aligned
  static constexpr int kPitch = BN + 8;             // staged int32 row: conflict-free 8-byte stores
  static constexpr int kRing = kStages * kStage;
  static constexpr int kStaging = kBlockRows * kPitch * 4;
  static constexpr int kBytes = (kRing > kStaging ? kRing : kStaging) + 1024;  // + alignment
};

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
pack_score_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                  const uint32_t* __restrict__ w, const uint32_t* __restrict__ tab,
                  uint32_t* __restrict__ out, uint32_t* __restrict__ scratch,
                  int* __restrict__ counters, int G, int S, int k_tiles) {
  using Lay = Layout<BN>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ __align__(8) uint64_t empty[kStages];
  __shared__ int is_last;

  const uint32_t raw = fhe::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;     // swizzle atoms need 1024-byte alignment
  int32_t* staged = reinterpret_cast<int32_t*>(smem_raw + (base - raw));

  // blockIdx.z = split * n_ct + column tile; each of the gridDim.z blocks of
  // a row tile folds a partial sum of every output it touches.  Only the
  // 256-wide instance can have several column tiles.
  const int n_ct = BN < 256 ? 1 : (4 * S + BN - 1) / BN, parts = gridDim.z,
            splits = parts / n_ct;
  const int tile = blockIdx.x, limb = blockIdx.y, split = blockIdx.z / n_ct,
            ct = blockIdx.z % n_ct;
  const int kt0 = static_cast<int>(static_cast<long long>(split) * k_tiles / splits);
  const int nk = static_cast<int>(static_cast<long long>(split + 1) * k_tiles / splits) - kt0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      fhe::mbar_init(fhe::smem_u32(&full[s]), 1);
      fhe::mbar_init(fhe::smem_u32(&empty[s]), kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    // Producer: one thread keeps the ring full.
    if (lane == 0) {
      for (int it = 0; it < nk; ++it) {
        const int s = it % kStages;
        if (it >= kStages) fhe::mbar_wait(fhe::smem_u32(&empty[s]), ((it / kStages) - 1) & 1);
        const uint32_t a_s = base + s * Lay::kStage;
        const uint32_t bar = fhe::smem_u32(&full[s]);
        fhe::mbar_expect_tx(bar, Lay::kStage);
        fhe::tma_load_3d(a_s, &ta, bar, (kt0 + it) * kBlockK, tile * kBlockRows, limb);
        fhe::tma_load_3d(a_s + Lay::kA, &tb, bar, (kt0 + it) * kBlockK, ct * BN, limb);
      }
    }
    return;
  }

  // Consumers: warpgroup wg multiplies rows [64*wg, 64*wg + 64) of the tile.
  const int wg = warp / 4;
  int32_t acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  for (int it = 0; it < nk; ++it) {
    const int s = it % kStages;
    fhe::mbar_wait(fhe::smem_u32(&full[s]), (it / kStages) & 1);
    __syncwarp();   // wgmma is .aligned: the warp issues it together
    const uint32_t a_s = base + s * Lay::kStage + wg * 64 * kBlockK;
    const uint32_t b_s = base + s * Lay::kStage + Lay::kA;
    fhe::fence_regs(acc);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kBlockK / kWgmmaK; ++kk)
      fhe::wgmma_s8<BN>(acc, fhe::desc_sw128(a_s + kk * kWgmmaK),
                        fhe::desc_sw128(b_s + kk * kWgmmaK));
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fhe::fence_regs(acc);
    if (lane == 0) fhe::mbar_arrive(fhe::smem_u32(&empty[s]));
  }

  // Stage the partials over the ring, which both warpgroups have finished reading.
  consumers_sync();
  {
    const int r = wg * 64 + (warp % 4) * 16 + lane / 4;
    const int c = 2 * (lane % 4);
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      *reinterpret_cast<int2*>(&staged[r * Lay::kPitch + 8 * i + c]) =
          make_int2(acc[4 * i], acc[4 * i + 1]);
      *reinterpret_cast<int2*>(&staged[(r + 8) * Lay::kPitch + 8 * i + c]) =
          make_int2(acc[4 * i + 2], acc[4 * i + 3]);
    }
  }
  consumers_sync();

  // Fold: thread t owns outputs o = t, t + 256, ... of the tile's 32 x S.
  // Column tile ct holds query digits j0 .. j0 + nj - 1 of every slot: all
  // four when 4S <= BN, BN / S of them when 4S is wider than one wgmma.
  const uint32_t p = tab[limb * 8], p_neg_inv = tab[limb * 8 + 1], mu = tab[limb * 8 + 2];
  const int cols = 4 * S;
  const int nj = n_ct == 1 ? 4 : BN / S, j0 = ct * nj;
  const uint32_t* w_l = w + static_cast<size_t>(limb) * 4 * cols;
  const int n_out = kBlockGroups * S;
  const int g0 = tile * kBlockGroups;
  const int t = threadIdx.x;
  uint32_t* dst = parts == 1 ? out + static_cast<size_t>(limb) * G * S
                             : scratch + (static_cast<size_t>(blockIdx.z) * gridDim.y + limb) *
                                             gridDim.x * kBlockGroups * S;
  for (int o = t; o < n_out; o += kConsumers) {
    const int gl = o / S, s = o % S;
    uint32_t sum = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        if (jj < nj) {
          const uint32_t r =
              fhe::reduce_signed(staged[(4 * gl + i) * Lay::kPitch + jj * S + s], p, mu);
          const uint32_t wt = __ldg(&w_l[i * cols + (j0 + jj) * S + s]);
          sum = fhe::add_mod(sum, fhe::mont_mul(r, wt, p, p_neg_inv), p);
        }
      }
    if (parts > 1 || g0 + gl < G) dst[static_cast<size_t>(g0 + gl) * S + s] = sum;
  }
  if (parts == 1) return;

  // Split K or columns: the last part of this tile to finish adds them up.
  __threadfence();
  consumers_sync();
  int* count = &counters[limb * gridDim.x + tile];
  if (t == 0) is_last = atomicAdd(count, 1) == parts - 1;
  consumers_sync();
  if (!is_last) return;
  __threadfence();
  const size_t slice = static_cast<size_t>(gridDim.y) * gridDim.x * kBlockGroups * S;
  const uint32_t* mine = scratch + static_cast<size_t>(limb) * gridDim.x * kBlockGroups * S;
  for (int o = t; o < n_out; o += kConsumers) {
    const int g = g0 + o / S;
    if (g >= G) continue;
    const size_t at = static_cast<size_t>(g) * S + o % S;
    uint32_t sum = 0;
    for (int z = 0; z < parts; ++z) sum = fhe::add_mod(sum, __ldcg(&mine[z * slice + at]), p);
    out[static_cast<size_t>(limb) * G * S + at] = sum;
  }
}

// V (L, K, C) -> Vt (L, C, K), int8: the K-major layout that 8-bit wgmma
// needs for B.  A block moves 128 values of K for up to 256 columns
// (blockIdx.z picks which) of one limb through shared memory: 4-byte words
// in along C, 4-byte words out along K.
__global__ void __launch_bounds__(256)
pack_score_transpose_kernel(const uint32_t* __restrict__ v, uint32_t* __restrict__ vt, int K,
                            int C) {
  __shared__ uint32_t tile[kBlockK * (256 / 4 + 1)];
  const int k0 = blockIdx.x * kBlockK, limb = blockIdx.y, c0 = blockIdx.z * 256;
  const int cw = C / 4, bw = min(C - c0, 256) / 4, pitch = bw + 1;   // words per row
  const uint32_t* src = v + (static_cast<size_t>(limb) * K + k0) * cw + c0 / 4;
  // Every load of the thread in flight at once (at most 128 * 64 / 256 = 32).
  constexpr int kPerThread = kBlockK * (256 / 4) / 256;
  const int n = kBlockK * bw;
  uint32_t r[kPerThread];
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {
    const int i = threadIdx.x + u * 256;
    r[u] = i < n ? src[static_cast<size_t>(i / bw) * cw + i % bw] : 0u;
  }
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {
    const int i = threadIdx.x + u * 256;
    if (i < n) tile[(i / bw) * pitch + i % bw] = r[u];
  }
  __syncthreads();
  const uint8_t* bytes = reinterpret_cast<const uint8_t*>(tile);
  uint32_t* dst = vt + ((static_cast<size_t>(limb) * C + c0) * K + k0) / 4;
  for (int o = threadIdx.x; o < 4 * bw * (kBlockK / 4); o += blockDim.x) {
    const int c = o / (kBlockK / 4), k = 4 * (o % (kBlockK / 4));
    const uint8_t* col = bytes + static_cast<size_t>(k) * pitch * 4 + c;
    dst[static_cast<size_t>(c) * (K / 4) + k / 4] =
        col[0] | col[pitch * 4] << 8 | col[2 * pitch * 4] << 16 |
        static_cast<uint32_t>(col[3 * pitch * 4]) << 24;
  }
}

template <int BN>
cudaError_t launch(const void* a, const void* v, const void* w, const void* tab, void* out,
                   uint8_t* vt, int* work, int L, int G, int K, int S, int splits,
                   cudaStream_t stream) {
  fhe::EncodeTiled enc = fhe::encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  pack_score_transpose_kernel<<<dim3(K / kBlockK, L, (4 * S + 255) / 256), 256, 0, stream>>>(
      static_cast<const uint32_t*>(v), reinterpret_cast<uint32_t*>(vt), K, 4 * S);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  CUtensorMap ta, tb;
  if (!fhe::encode(enc, &ta, a, K, 4 * G, L, kBlockRows) ||
      !fhe::encode(enc, &tb, vt, K, 4 * S, L, BN))
    return cudaErrorInvalidValue;
  const int smem = Layout<BN>::kBytes;
  e = cudaFuncSetAttribute(pack_score_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e != cudaSuccess) return e;
  const int n_ct = (4 * S + BN - 1) / BN;
  const dim3 grid((4 * G + kBlockRows - 1) / kBlockRows, L, splits * n_ct);
  const size_t n_counters = static_cast<size_t>(grid.x) * L;
  if (grid.z > 1) {
    e = cudaMemsetAsync(work, 0, n_counters * sizeof(int), stream);
    if (e != cudaSuccess) return e;
  }
  pack_score_kernel<BN><<<grid, kThreads, smem, stream>>>(
      ta, tb, static_cast<const uint32_t*>(w), static_cast<const uint32_t*>(tab),
      static_cast<uint32_t*>(out), reinterpret_cast<uint32_t*>(work + n_counters), work, G, S,
      K / kBlockK);
  return cudaGetLastError();
}

}  // namespace

// a: (L, 4G, K) int8; v: (L, K, 4S) int8; w: (L, 4, 4S) u32; tab: (L, 8) u32;
// out: (L, G, S) u32.  4S is at most 256, or a multiple of 256 with S
// dividing 256 (column tiles of 256).  work holds the transposed V
// (L * 4S * K bytes), then, with P = splits * column tiles > 1, T = L *
// ceil(4G/128) tile counters (zeroed here, on the stream) and P * T * 32 * S
// residues.  Launches on `stream`.
extern "C" int fhe_pack_score(const void* a, const void* v, const void* w, const void* tab,
                              void* out, void* work, int L, int G, int K, int S, int splits,
                              void* stream) {
  if (L < 1 || G < 1 || S < 1 || S > 256 || (4 * S > 256 && 256 % S) || K < kBlockK ||
      K % kBlockK || splits < 1 || splits > K / kBlockK || reinterpret_cast<uintptr_t>(a) % 16 ||
      reinterpret_cast<uintptr_t>(v) % 4 || reinterpret_cast<uintptr_t>(work) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint8_t* vt = static_cast<uint8_t*>(work);
  int* wk = reinterpret_cast<int*>(vt + static_cast<size_t>(L) * 4 * S * K);
  cudaError_t e;
  if (4 * S <= 16)
    e = launch<16>(a, v, w, tab, out, vt, wk, L, G, K, S, splits, st);
  else if (4 * S <= 32)
    e = launch<32>(a, v, w, tab, out, vt, wk, L, G, K, S, splits, st);
  else if (4 * S <= 64)
    e = launch<64>(a, v, w, tab, out, vt, wk, L, G, K, S, splits, st);
  else if (4 * S <= 128)
    e = launch<128>(a, v, w, tab, out, vt, wk, L, G, K, S, splits, st);
  else
    e = launch<256>(a, v, w, tab, out, vt, wk, L, G, K, S, splits, st);
  return static_cast<int>(e);
}
