// fastdot's int8 digit product: a persistent stream of TMA loads into wgmma.
//
// Per limb l, for every document digit row r of A (4B rows: digit i of
// document b is row i*B + b) and each of the query's 4 digit columns j:
//
//   part[l, r, j] = sum_k A[l, r, k] * Q[l, j, k]      (exact in int32)
//
// with A the (L, 4B, 2N) int8 document digit planes of ops/fastdot.py's
// DocOperand, Q the (L, 4, 2N) int8 query digit planes of its
// QueryOperand (already K-major, as 8-bit wgmma needs B), and part the
// (L, 4, B, 4) int32 partials that fastdot.fold_decode folds mod p.  Every
// partial is bounded by 128*128*2N (2^29 at ring-16384's 2N = 32768), so
// the int32 sums are exact and equal ops/fastdot_cuda.py's plain version
// bit for bit.
//
// It replaces no Pallas kernel: the JAX package's ops/fastdot.py leaves this
// product to XLA (an int8 dot_general).  On the card it ran as
// cuBLASLt's int8 GEMM (torch._int_mm), which is tiled for wide outputs and
// read a 4-column product at about a sixth of the memory's rate.
//
// What bounds it.  Each document digit is read once and meets 4 query
// digits: 8 int8 operations a byte, or 32 at the 16-column wgmma width,
// where the tensor cores need about 590 a byte to be the limit.  So the
// kernel is bound by device memory: a 1,048,576-document shard at
// pairwise-4096 is 2 limbs x 4,194,304 rows x 8192 bytes = 68.7 GB, 20.5 ms
// at 3.35 TB/s.  The design streams A at the memory's rate:
//
// * Persistent blocks, one an SM, each walking 128-row tiles of every limb
//   in a stride of the grid (65,536 tiles at a shard: 497 at most a block).
//   One producer warp keeps a ring of kStages stages full with TMA loads,
//   running ahead across tile boundaries, so the ring never drains between
//   tiles and up to kStages x 16 KB of A is in flight an SM.  A stage
//   holds a 128-row x 128-byte A box and the query limb's 16 x 128-byte
//   box, both 128-byte swizzled, guarded by a "full" and an "empty"
//   mbarrier.
// * The query limb (32 KB at 2N = 8192) is loaded again with every stage:
//   its 4 real rows, a thirty-second of A's bytes, come from L2, where they
//   stay.  An evict-first L2 hint on A's loads changed nothing measurable
//   on the H100, so A's loads carry none.
// * Rows past the end of a limb's A (a ragged last tile) and the query's
//   rows 4..15 (the wgmma width is 16) arrive as zeros from TMA: no padded
//   copy is made, and zero digits give zero partials.
// * Two consumer warpgroups, 64 rows each, run wgmma.m64n16k32.s32.s8.s8 on
//   every stage and keep the partials in registers.  At a tile's end the
//   threads that hold columns 0..3 store them straight to device memory
//   (16 bytes a row, masked past the end), while the producer already
//   loads the next tile.
// * Byte offsets and sizes are 64-bit (a shard's A is 64 GiB); TMA's int32
//   coordinates hold a row (< 2^31) and a K offset.
//
// On an H100 SXM at 700 W a shard's product takes 21.8 ms, 94 % of its
// bound (cuBLASLt's GEMM 121.5 ms); 4 to 12 stages at 1 to 3 blocks an SM
// all read within 0.6 % of each other.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "tma_sm90.cuh"
#include "wgmma_s8.cuh"

namespace {

constexpr int kBlockRows = 128;            // A rows a tile: two warpgroups of 64
constexpr int kBlockK = fhe::kTmaBoxK;     // K bytes a stage: one swizzled 128-byte row
constexpr int kWgmmaK = 32;                // K bytes a wgmma
constexpr int kCols = 4;                   // the query's digit columns
constexpr int kBN = 16;                    // the wgmma width; query rows 4..15 are zeros
constexpr int kStages = 12;
constexpr int kConsumers = 256;            // two warpgroups
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kStageA = kBlockRows * kBlockK;
constexpr int kStageBytes = kStageA + kBN * kBlockK;  // a multiple of 1024, as swizzling needs
constexpr int kSmem = kStages * kStageBytes + 1024;   // + alignment

// ta: A as (2N, rows, L), tq: Q as (2N, 4, L), both read in 128-byte boxes.
// out: (L, rows, 4) int32 as int2 pairs.  Tile t covers rows
// [128 (t % tiles), 128 (t % tiles) + 128) of limb t / tiles.
template <int Stages>
__global__ void __launch_bounds__(kThreads, 1)
fastdot_product_kernel(const __grid_constant__ CUtensorMap ta,
                       const __grid_constant__ CUtensorMap tq, int2* __restrict__ out, int rows,
                       int tiles, int n_tiles, int k_tiles) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[Stages];
  __shared__ __align__(8) uint64_t empty[Stages];
  const uint32_t base = (fhe::smem_u32(smem_raw) + 1023u) & ~1023u;  // swizzle atoms: 1024-aligned
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < Stages; ++s) {
      fhe::mbar_init(fhe::smem_u32(&full[s]), 1);
      fhe::mbar_init(fhe::smem_u32(&empty[s]), kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    // Producer: one thread keeps the ring full, across tiles.
    if (lane == 0) {
      uint32_t it = 0;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const int limb = t / tiles, row0 = (t % tiles) * kBlockRows;
        for (int kt = 0; kt < k_tiles; ++kt, ++it) {
          const uint32_t s = it % Stages;
          if (it >= Stages) fhe::mbar_wait(fhe::smem_u32(&empty[s]), (it / Stages - 1) & 1);
          const uint32_t a_s = base + s * kStageBytes, bar = fhe::smem_u32(&full[s]);
          fhe::mbar_expect_tx(bar, kStageBytes);
          fhe::tma_load_3d(a_s, &ta, bar, kt * kBlockK, row0, limb);
          fhe::tma_load_3d(a_s + kStageA, &tq, bar, kt * kBlockK, 0, limb);
        }
      }
    }
    return;
  }

  // Consumers: warpgroup wg multiplies rows [64 wg, 64 wg + 64) of each tile.
  // Thread (warp w, lane) holds rows 16 (w % 4) + lane / 4 and 8 more of its
  // warpgroup's 64, columns 2 (lane % 4) and one more (wgmma_s8.cuh's
  // layout): lanes with lane % 4 < 2 hold the query's columns 0..3.
  const int wg = warp / 4;
  const int row = wg * 64 + (warp % 4) * 16 + lane / 4;
  uint32_t it = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int limb = t / tiles, row0 = (t % tiles) * kBlockRows;
    int32_t acc[kBN / 2];
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc[i] = 0;
    for (int kt = 0; kt < k_tiles; ++kt, ++it) {
      const uint32_t s = it % Stages;
      fhe::mbar_wait(fhe::smem_u32(&full[s]), (it / Stages) & 1);
      __syncwarp();  // wgmma is .aligned: the warp issues it together
      const uint32_t a_s = base + s * kStageBytes + wg * 64 * kBlockK;
      const uint32_t b_s = base + s * kStageBytes + kStageA;
      fhe::fence_regs(acc);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < kBlockK / kWgmmaK; ++kk)
        fhe::wgmma_s8<kBN>(acc, fhe::desc_sw128(a_s + kk * kWgmmaK),
                           fhe::desc_sw128(b_s + kk * kWgmmaK));
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      fhe::fence_regs(acc);
      if (lane == 0) fhe::mbar_arrive(fhe::smem_u32(&empty[s]));
    }
    if (lane % 4 < kCols / 2) {
      const int r = row0 + row;
      int2* o = out + (static_cast<size_t>(limb) * rows + r) * (kCols / 2) + lane % 4;
      if (r < rows) o[0] = make_int2(acc[0], acc[1]);
      if (r + 8 < rows) o[8 * (kCols / 2)] = make_int2(acc[2], acc[3]);
    }
  }
}

}  // namespace

// a: (L, 4, B, K) int8 document digit planes; q: (L, 4, K) int8 query digit
// planes; out: (L, 4, B, 4) int32 partials.  K a multiple of 128, every
// pointer 16-byte aligned, 4B + 128 rows at most INT_MAX.  Launches on
// `stream` and does not wait for it.
extern "C" int fhe_fastdot_product(const void* a, const void* q, void* out, int L, int B, int K,
                                   void* stream) {
  if (L < 1 || B < 1 || B > (INT_MAX - kBlockRows) / kCols || K < kBlockK || K % kBlockK ||
      reinterpret_cast<uintptr_t>(a) % 16 || reinterpret_cast<uintptr_t>(q) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = kCols * B;
  const long long tiles = (static_cast<long long>(rows) + kBlockRows - 1) / kBlockRows,
                  n_tiles = tiles * L;
  if (n_tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  fhe::EncodeTiled enc = fhe::encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap ta, tq;
  if (!fhe::encode(enc, &ta, a, K, rows, L, kBlockRows) ||
      !fhe::encode(enc, &tq, q, K, kCols, L, kBN))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(fastdot_product_kernel<kStages>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int grid = static_cast<int>(n_tiles < sms ? n_tiles : sms);
  fastdot_product_kernel<kStages><<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      ta, tq, static_cast<int2*>(out), rows, static_cast<int>(tiles), static_cast<int>(n_tiles),
      K / kBlockK);
  return static_cast<int>(cudaGetLastError());
}
