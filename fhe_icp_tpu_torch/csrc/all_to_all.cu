// All-to-all between the D shards of one mesh axis: chunk j of source
// shard s lands in rows [s*c, (s+1)*c) of destination shard j.
//
// Replaces the JAX package's Pallas kernel parallel/ici.py::_a2a_kernel
// (called through pallas_all_to_all), where every TPU starts D-1 remote
// DMAs, one chunk to each peer over the inter-chip links, and waits on
// per-peer send and receive semaphores.  The four-step ring-sharded NTT
// (parallel/ntt_dist.py) runs it for both of its transposes.
//
// Design: one launch per card per exchange, on the card's current stream,
// covering every source shard that lies on the card.  Grid (blocks per
// chunk, D destinations, sources on the card): block (x, j, z) copies part
// of chunk j of the card's z-th source straight into destination buffer
// out_j.  Source pointers, their shard indices and the D destination
// pointers arrive by value in one struct and are selected with constant
// indices only (a runtime index into a by-value struct copies all of it to
// every thread's stack).  When out_j lies on another card the stores go
// through the peer pointer over NVLink (the wrapper enables peer access
// once per pair); when it lies on the same card they are plain stores.
// The wrapper turns the TPU kernel's semaphores into stream events:
// each destination card records "ready" after allocating, each card's
// stream waits on the others' before its launch and records "sent" after
// it, and every card waits on the other cards' "sent" before the result is
// used.
//
// Bound on the H100: bytes.  Every element is read once and written once
// on its card at 3.35 TB/s, plus the off-card share at 450 GB/s each way
// per card over NVLink.  At the four-step NTT's sizes (96 KiB a shard at
// ring 16384, 12 limbs, 8 shards) the launch itself sets the time, so
// there is one launch per card; one thread per 16-byte unit gives that
// exchange 3 blocks per chunk, 192 blocks for the 132 SMs.
//
// Copies move 16 bytes a thread, four independent copies in flight per
// loop step, when the chunk's byte size and every base pointer are 16-byte
// aligned, and 4 bytes otherwise: a branch inside the kernel on a flag the
// entry point computes.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxShards = 16;
constexpr int kThreads = 256;
constexpr int kSms = 132;               // H100 SXM
constexpr long long kTargetBlocks = 8LL * kSms;
constexpr int kUnroll = 4;

struct Pointers {
  const uint32_t* src[kMaxShards];      // the card's sources, in shard order
  uint32_t* dst[kMaxShards];            // every destination shard
  int src_index[kMaxShards];            // shard index of src[z]
};

template <typename T>
__device__ __forceinline__ void copy_chunk(const T* __restrict__ from, T* __restrict__ to,
                                           long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (; i + (kUnroll - 1) * stride < n; i += kUnroll * stride) {
    T v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = from[i + u * stride];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) to[i + u * stride] = v[u];
  }
  for (; i < n; i += stride) to[i] = from[i];
}

__global__ void __launch_bounds__(kThreads)
all_to_all_kernel(const Pointers ptr, long long chunk, int vec16) {
  const int j = blockIdx.y, z = blockIdx.z;
  const uint32_t* x = ptr.src[0];
  uint32_t* base = ptr.dst[0];
  int s = ptr.src_index[0];
#pragma unroll
  for (int k = 1; k < kMaxShards; ++k) {
    if (k == z) {
      x = ptr.src[k];
      s = ptr.src_index[k];
    }
    if (k == j) base = ptr.dst[k];
  }
  const uint32_t* from = x + static_cast<long long>(j) * chunk;
  uint32_t* to = base + static_cast<long long>(s) * chunk;
  if (vec16)
    copy_chunk(reinterpret_cast<const uint4*>(from), reinterpret_cast<uint4*>(to), chunk / 4);
  else
    copy_chunk(from, to, chunk);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// srcs: the n_src source shards on the current card, each (n_shards * chunk)
// words, as an array of pointers; src_index: their shard indices (NULL for
// 0 .. n_src - 1); dsts: all n_shards destination buffers of the same size.
// One launch on `stream`.
int fhe_all_to_all(const uint64_t* srcs, const int* src_index, int n_src, const uint64_t* dsts,
                   int n_shards, long long chunk, void* stream) {
  if (n_shards < 1 || n_shards > kMaxShards || n_src < 1 || n_src > n_shards || chunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Pointers p{};
  bool vec16 = chunk % 4 == 0;
  for (int z = 0; z < n_src; ++z) {
    const int s = src_index ? src_index[z] : z;
    if (s < 0 || s >= n_shards) return static_cast<int>(cudaErrorInvalidValue);
    p.src[z] = reinterpret_cast<const uint32_t*>(srcs[z]);
    p.src_index[z] = s;
    vec16 = vec16 && aligned16(p.src[z]);
  }
  for (int j = 0; j < n_shards; ++j) {
    p.dst[j] = reinterpret_cast<uint32_t*>(dsts[j]);
    vec16 = vec16 && aligned16(p.dst[j]);
  }
  // One thread per copied unit up to one resident wave of blocks (8 per SM);
  // past that, each thread loops.
  const long long units = vec16 ? chunk / 4 : chunk;
  const long long chunks = static_cast<long long>(n_src) * n_shards;
  long long blocks = (units + kThreads - 1) / kThreads;
  const long long cap = kTargetBlocks / chunks > 0 ? kTargetBlocks / chunks : 1;
  if (blocks > cap) blocks = cap;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(n_shards),
                  static_cast<unsigned>(n_src));
  all_to_all_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p, chunk,
                                                                              vec16 ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

// Let kernels on card `dev` store to card `peer`.  An already enabled pair
// is not an error; a pair that cannot reach each other is.
int fhe_enable_peer_access(int dev, int peer) {
  int can = 0;
  cudaError_t e = cudaDeviceCanAccessPeer(&can, dev, peer);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!can) return static_cast<int>(cudaErrorPeerAccessUnsupported);
  int current = 0;
  e = cudaGetDevice(&current);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaSetDevice(dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaDeviceEnablePeerAccess(peer, 0);
  if (e == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();  // clear the error this call recorded
    e = cudaSuccess;
  }
  const cudaError_t restore = cudaSetDevice(current);
  return static_cast<int>(e != cudaSuccess ? e : restore);
}

}  // extern "C"
