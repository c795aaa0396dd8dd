// Bitonic network over rows of int32 keys, used by kernel K4 of the port
// (packed_sort.cu).
//
// Each row of a [rows, cap] int32 matrix (cap a power of two) is sorted
// ascending in place. The keys K4 sorts are composites whose low bits hold
// the row slot, so they are unique: any correct sort gives the stable order,
// and an unstable network is enough.
//
// The layout follows K1 (bucket_sort.cu): a row is cut into tiles of up to
// kMaxTile keys (128 KiB of the 227 KiB of shared memory a block may use). The
// caller's tile kernel sorts each tile through every stage whose stride is
// below the tile; `cross_tile_passes` then runs each larger merge as passes
// over device memory for the strides that reach across tiles, each followed by
// a shared-memory pass (`merge_tiles`) that finishes the smaller strides. The
// direction of a compare comes from the ROW position, as in the whole-row
// network, so tiles compose into one row-wide bitonic sort.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileKeys = 32768;  // int32 keys per shared-memory tile
constexpr int kTileThreads = 1024;
constexpr int kPassThreads = 256;

// One compare-exchange stage (merge size k, stride j) over a shared tile of n
// keys whose first key sits at position `base` of its row.
__device__ __forceinline__ void tile_stage(int32_t* s, int n, int64_t base, int64_t k, int j) {
  for (int t = threadIdx.x; t < n / 2; t += blockDim.x) {
    const int i = 2 * j * (t / j) + (t % j);
    const int l = i + j;
    const bool ascending = ((base + i) & k) == 0;
    const int32_t a = s[i], b = s[l];
    if ((a > b) == ascending) {
      s[i] = b;
      s[l] = a;
    }
  }
  __syncthreads();
}

// Every stage of merge sizes 2..tile over a loaded tile.
__device__ __forceinline__ void sort_tile(int32_t* s, int tile, int64_t base) {
  for (int k = 2; k <= tile; k <<= 1)
    for (int j = k >> 1; j >= 1; j >>= 1) tile_stage(s, tile, base, k, j);
}

// The strides below `tile` of merge size k (> tile), in place on `data`.
__global__ void merge_tiles(int32_t* __restrict__ data, int cap, int tile, int64_t k) {
  extern __shared__ int32_t smem[];
  const int tiles_per_row = cap / tile;
  const int64_t row = blockIdx.x / tiles_per_row;
  const int64_t base = static_cast<int64_t>(blockIdx.x % tiles_per_row) * tile;
  const int64_t off = row * cap + base;
  for (int x = threadIdx.x; x < tile; x += blockDim.x) smem[x] = data[off + x];
  __syncthreads();
  for (int j = tile >> 1; j >= 1; j >>= 1) tile_stage(smem, tile, base, k, j);
  for (int x = threadIdx.x; x < tile; x += blockDim.x) data[off + x] = smem[x];
}

// One stage with a stride of at least a tile, over device memory.
__global__ void global_stage(int32_t* __restrict__ data, int64_t rows, int64_t cap, int64_t k,
                             int64_t j) {
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
    const int32_t ka = data[a], kb = data[b];
    if ((ka > kb) == ascending) {
      data[a] = kb;
      data[b] = ka;
    }
  }
}

struct TileShape {
  int tile;      // keys per tile: min(cap, kTileKeys)
  int threads;   // threads per tile block
  int blocks;    // tile blocks over the whole matrix
  size_t smem;   // dynamic shared memory of a tile block
};

inline TileShape tile_shape(int rows, int cap) {
  TileShape t;
  t.tile = cap < kTileKeys ? cap : kTileKeys;
  t.threads = t.tile / 2 < 1 ? 1 : (t.tile / 2 > kTileThreads ? kTileThreads : t.tile / 2);
  t.blocks = rows * (cap / t.tile);
  t.smem = static_cast<size_t>(t.tile) * sizeof(int32_t);
  return t;
}

// Merges of size 2*tile .. cap, after the tile kernel sorted every tile.
inline void cross_tile_passes(int32_t* data, int rows, int cap, const TileShape& t,
                              cudaStream_t s) {
  if (t.tile == cap) return;
  cudaFuncSetAttribute(merge_tiles, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(t.smem));
  const int64_t pairs = static_cast<int64_t>(rows) * (cap / 2);
  int64_t pass_blocks = (pairs + kPassThreads - 1) / kPassThreads;
  if (pass_blocks > 65535) pass_blocks = 65535;
  if (pass_blocks < 1) pass_blocks = 1;
  for (int64_t k = 2 * static_cast<int64_t>(t.tile); k <= cap; k <<= 1) {
    for (int64_t j = k >> 1; j >= t.tile; j >>= 1)
      global_stage<<<static_cast<int>(pass_blocks), kPassThreads, 0, s>>>(data, rows, cap, k, j);
    merge_tiles<<<t.blocks, t.threads, t.smem, s>>>(data, cap, t.tile, k);
  }
}

}  // namespace
