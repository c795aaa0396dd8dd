// In-bucket sort of a padded [rows, cap] int64 key matrix (kernel K1 of the port).
//
// Replaces the Pallas kernel `_sort_kernel` in hyperspace_tpu/ops/pallas_sort.py
// (:107, launched by `_sort_pallas_call` :132 from `sort_padded_with_order` :159).
// Contract: each row sorted ascending (pads are INT64_MAX and sort last), plus
// `order` with sorted[b, s] == keys[b, order[b, s]]. The network sorts the pair
// (key, slot); slots are unique, so the result is exactly the STABLE argsort —
// the order numpy's stable argsort gives on the host, which lets the join's pair
// order equal the JAX package's. The TPU kernel's (hi, lo) int32 split is gone:
// Hopper compares int64 directly.
//
// What bounds it on the H100: device-memory bytes. Each element must be read
// once (8 B) and written once (8 B key + 4 B slot), and a comparison sort needs
// only n log n compares, far below the card's integer rate. A bitonic network run
// stage by stage through device memory would move every element O(log^2 cap)
// times, so the design keeps as much of the network as it can in shared memory:
//   * rows are cut into tiles of up to 16384 (key, slot) pairs (192 KiB of the
//     227 KiB a block may use); one block per tile runs every stage whose
//     stride is below the tile in shared memory;
//   * only the stages whose stride reaches across tiles (cap 32768 needs one)
//     run as passes over device memory, each followed by a shared-memory pass
//     that finishes the smaller strides of that merge.
// So a [256, 32768] matrix is read and written three times instead of once per
// stage (120 stages for cap 32768).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxTile = 16384;   // (key, slot) pairs per shared-memory tile
constexpr int kMaxThreads = 1024;
constexpr int kStepThreads = 256;

__device__ __forceinline__ bool pair_greater(int64_t ka, int32_t ia, int64_t kb, int32_t ib) {
  return ka > kb || (ka == kb && ia > ib);
}

// One compare-exchange stage (merge size k, stride j) over a shared tile of n
// pairs whose first element sits at position `base` of its row. The pair
// direction comes from the ROW position, as in the whole-row network.
__device__ __forceinline__ void tile_stage(int64_t* sk, int32_t* si, int n, int64_t base,
                                           int k, int j) {
  for (int t = threadIdx.x; t < n / 2; t += blockDim.x) {
    const int i = 2 * j * (t / j) + (t % j);
    const int l = i + j;
    const bool ascending = ((base + i) & k) == 0;
    const int64_t ka = sk[i], kb = sk[l];
    const int32_t ia = si[i], ib = si[l];
    if (pair_greater(ka, ia, kb, ib) == ascending) {
      sk[i] = kb; sk[l] = ka;
      si[i] = ib; si[l] = ia;
    }
  }
  __syncthreads();
}

// Full network up to merge size `tile` on each tile: reads the input keys,
// seeds the slot payload, writes both outputs.
__global__ void sort_tiles(const int64_t* __restrict__ keys, int64_t* __restrict__ out_keys,
                           int32_t* __restrict__ out_order, int cap, int tile) {
  extern __shared__ int64_t smem[];
  int64_t* sk = smem;
  int32_t* si = reinterpret_cast<int32_t*>(smem + tile);
  const int tiles_per_row = cap / tile;
  const int64_t row = blockIdx.x / tiles_per_row;
  const int64_t base = static_cast<int64_t>(blockIdx.x % tiles_per_row) * tile;
  const int64_t off = row * cap + base;
  for (int x = threadIdx.x; x < tile; x += blockDim.x) {
    sk[x] = keys[off + x];
    si[x] = static_cast<int32_t>(base + x);
  }
  __syncthreads();
  for (int k = 2; k <= tile; k <<= 1)
    for (int j = k >> 1; j >= 1; j >>= 1) tile_stage(sk, si, tile, base, k, j);
  for (int x = threadIdx.x; x < tile; x += blockDim.x) {
    out_keys[off + x] = sk[x];
    out_order[off + x] = si[x];
  }
}

// The strides below `tile` of merge size k (> tile), in place on the outputs.
__global__ void merge_tiles(int64_t* __restrict__ out_keys, int32_t* __restrict__ out_order,
                            int cap, int tile, int k) {
  extern __shared__ int64_t smem[];
  int64_t* sk = smem;
  int32_t* si = reinterpret_cast<int32_t*>(smem + tile);
  const int tiles_per_row = cap / tile;
  const int64_t row = blockIdx.x / tiles_per_row;
  const int64_t base = static_cast<int64_t>(blockIdx.x % tiles_per_row) * tile;
  const int64_t off = row * cap + base;
  for (int x = threadIdx.x; x < tile; x += blockDim.x) {
    sk[x] = out_keys[off + x];
    si[x] = out_order[off + x];
  }
  __syncthreads();
  for (int j = tile >> 1; j >= 1; j >>= 1) tile_stage(sk, si, tile, base, k, j);
  for (int x = threadIdx.x; x < tile; x += blockDim.x) {
    out_keys[off + x] = sk[x];
    out_order[off + x] = si[x];
  }
}

// One stage with a stride of at least a tile, over device memory.
__global__ void global_stage(int64_t* __restrict__ out_keys, int32_t* __restrict__ out_order,
                             int64_t rows, int cap, int k, int j) {
  const int64_t half = cap / 2;
  const int64_t total = rows * half;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; t < total;
       t += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t row = t / half;
    const int64_t p = t % half;
    const int64_t i = 2 * j * (p / j) + (p % j);
    const int64_t a = row * cap + i;
    const int64_t b = a + j;
    const bool ascending = (i & k) == 0;
    const int64_t ka = out_keys[a], kb = out_keys[b];
    const int32_t ia = out_order[a], ib = out_order[b];
    if (pair_greater(ka, ia, kb, ib) == ascending) {
      out_keys[a] = kb; out_keys[b] = ka;
      out_order[a] = ib; out_order[b] = ia;
    }
  }
}

}  // namespace

// keys: [rows, cap] int64, cap a power of two; out_keys/out_order: [rows, cap].
// Launches on `stream`; returns cudaGetLastError().
extern "C" int hs_bucket_sort(const void* keys, void* out_keys, void* out_order, int rows,
                              int cap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tile = cap < kMaxTile ? cap : kMaxTile;
  const size_t smem = static_cast<size_t>(tile) * (sizeof(int64_t) + sizeof(int32_t));
  int threads = tile / 2;
  if (threads < 1) threads = 1;
  if (threads > kMaxThreads) threads = kMaxThreads;
  cudaFuncSetAttribute(sort_tiles, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  cudaFuncSetAttribute(merge_tiles, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  const int blocks = rows * (cap / tile);
  auto* ok = static_cast<int64_t*>(out_keys);
  auto* oo = static_cast<int32_t*>(out_order);
  sort_tiles<<<blocks, threads, smem, s>>>(static_cast<const int64_t*>(keys), ok, oo, cap, tile);
  const int64_t pairs = static_cast<int64_t>(rows) * (cap / 2);
  int64_t step_blocks = (pairs + kStepThreads - 1) / kStepThreads;
  if (step_blocks > 65535) step_blocks = 65535;
  if (step_blocks < 1) step_blocks = 1;
  for (int k = 2 * tile; k <= cap; k <<= 1) {
    for (int j = k >> 1; j >= tile; j >>= 1)
      global_stage<<<static_cast<int>(step_blocks), kStepThreads, 0, s>>>(ok, oo, rows, cap, k, j);
    merge_tiles<<<blocks, threads, smem, s>>>(ok, oo, cap, tile, k);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* hs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
