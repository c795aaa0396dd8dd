// Composite sort of the sub-byte-key index build (kernel K3 of the port).
//
// Replaces the Pallas kernel `_sort_comp_kernel` in hyperspace_tpu/ops/pallas_sort.py
// (:256, launched from `sort_comp_padded` :261, called by
// hyperspace_tpu/ops/partition.py `pallas_packed_build_sort` :252). Contract:
// each row of a [rows, cap] int32 matrix sorted ascending. The build packs
// ((bucket << bits) | (code + 1)) << log2(cap) | row into each int32 and pads
// with the supremum (num_buckets << bits) << log2(cap); the row bits make the
// composites unique, so the ascending order IS the canonical stable
// (bucket, code, row) order of the build and index files stay identical
// whichever sort ran.
//
// What bounds it on the H100: device-memory bytes. The sort must read each
// composite once and write it once (8 bytes a key); n log n compares are far
// below the card's integer rate. A build row is much longer than shared
// memory (262,144 keys = 1 MiB for the customer table), so the network runs
// as in K1: tiles of 32768 keys sorted in shared memory, then for each larger
// merge one pass over device memory per stride that crosses tiles plus a
// shared-memory pass for the rest (bitonic_i32.cuh). At [1, 262144] that is 3
// merges, 6 device-memory passes and 3 shared-memory passes after the tile
// sort. The TPU's VMEM gate (rows of at most 32768) is gone: every power of two
// takes the kernel.

#include "bitonic_i32.cuh"

namespace {

__global__ void comp_sort_tiles(const int32_t* __restrict__ in, int32_t* __restrict__ out, int cap,
                                int tile) {
  extern __shared__ int32_t smem[];
  const int tiles_per_row = cap / tile;
  const int64_t row = blockIdx.x / tiles_per_row;
  const int64_t base = static_cast<int64_t>(blockIdx.x % tiles_per_row) * tile;
  const int64_t off = row * cap + base;
  for (int x = threadIdx.x; x < tile; x += blockDim.x) smem[x] = in[off + x];
  __syncthreads();
  sort_tile(smem, tile, base);
  for (int x = threadIdx.x; x < tile; x += blockDim.x) out[off + x] = smem[x];
}

}  // namespace

// in/out: [rows, cap] int32, cap a power of two. Launches on `stream`;
// returns cudaGetLastError().
extern "C" int hs_comp_sort(const void* in, void* out, int rows, int cap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const TileShape t = tile_shape(rows, cap);
  cudaFuncSetAttribute(comp_sort_tiles, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(t.smem));
  auto* o = static_cast<int32_t*>(out);
  comp_sort_tiles<<<t.blocks, t.threads, t.smem, s>>>(static_cast<const int32_t*>(in), o, cap,
                                                      t.tile);
  cross_tile_passes(o, rows, cap, t, s);
  return static_cast<int>(cudaGetLastError());
}
