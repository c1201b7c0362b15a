// All-to-all between the D shards of one mesh axis: chunk j of source
// shard s lands in rows [s*c, (s+1)*c) of destination shard j.
//
// Replaces the JAX package's Pallas kernel parallel/ici.py::_a2a_kernel
// (called through pallas_all_to_all), where every TPU starts D-1 remote
// DMAs, one chunk to each peer over the inter-chip links, and waits on
// per-peer send and receive semaphores.  The four-step ring-sharded NTT
// (parallel/ntt_dist.py) runs it for both of its transposes.
//
// Design: one launch per source shard, on its card's current stream, as
// the TPU kernel runs once per device.  Grid (blocks per chunk, D): block
// row j copies chunk j of x_s straight into the destination buffer out_j,
// whose pointer arrives by value in a small struct.  When out_j lies on
// another card the stores go through the peer pointer over NVLink (the
// wrapper enables peer access once per pair); when the shards share one
// card they are plain stores within it.  The wrapper turns the TPU
// kernel's semaphores into stream events: destinations record "ready"
// after allocating, each card's stream waits on them before its sources'
// launches and records "sent" after them, and every card waits on the
// other cards' "sent" before the result is used.
//
// Bound on the H100: bytes.  Every element is read once and written once
// (2 x the shard's bytes per launch) at 3.35 TB/s on one card, plus the
// off-card share at 450 GB/s each way per card over NVLink.  At the
// four-step NTT's sizes (96 KiB a shard at ring 16384, 12 limbs, 8 shards)
// the launch itself, not the bytes, sets the time.
//
// Copies move 16 bytes a thread when the chunk's byte size and every base
// pointer are 16-byte aligned, and 4 bytes otherwise: a branch inside the
// kernel on a flag the entry point computes.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxShards = 16;
constexpr int kThreads = 256;
constexpr long long kMaxBlocksPerChunk = 1024;

struct Destinations {
  uint32_t* p[kMaxShards];
};

__global__ void all_to_all_kernel(const uint32_t* __restrict__ x, Destinations dst,
                                  long long chunk, int src, int vec16) {
  const int j = blockIdx.y;
  // Pick dst.p[j] with constant indices only: indexing the by-value struct
  // with blockIdx.y would copy all of it to every thread's stack.
  uint32_t* base = dst.p[0];
#pragma unroll
  for (int k = 1; k < kMaxShards; ++k)
    if (k == j) base = dst.p[k];
  const uint32_t* from = x + static_cast<long long>(j) * chunk;
  uint32_t* to = base + static_cast<long long>(src) * chunk;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (vec16) {
    const uint4* f = reinterpret_cast<const uint4*>(from);
    uint4* t = reinterpret_cast<uint4*>(to);
    for (long long i = first; i < chunk / 4; i += stride) t[i] = f[i];
  } else {
    for (long long i = first; i < chunk; i += stride) to[i] = from[i];
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// x: source shard `src`, (n_shards * chunk) words; dsts: n_shards
// destination buffers of the same size.  Launches on `stream`.
int fhe_all_to_all(const void* x, const void* const* dsts, int n_shards, long long chunk,
                   int src, void* stream) {
  if (n_shards < 1 || n_shards > kMaxShards || src < 0 || src >= n_shards || chunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Destinations d{};
  bool vec16 = chunk % 4 == 0 && aligned16(x);
  for (int j = 0; j < n_shards; ++j) {
    d.p[j] = static_cast<uint32_t*>(const_cast<void*>(dsts[j]));
    vec16 = vec16 && aligned16(dsts[j]);
  }
  const long long units = vec16 ? chunk / 4 : chunk;
  long long blocks = (units + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocksPerChunk) blocks = kMaxBlocksPerChunk;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(n_shards));
  all_to_all_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), d, chunk, src, vec16 ? 1 : 0);
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
