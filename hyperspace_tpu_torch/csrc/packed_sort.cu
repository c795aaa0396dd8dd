// Sort of packed sub-byte code rows (kernel K4 of the port).
//
// Replaces the Pallas kernel `_sort_packed_kernel` in hyperspace_tpu/ops/pallas_sort.py
// (:210, launched by `_sort_packed_call` :220 from `sort_codes_packed` :243).
// Input: a [rows, cap / lpw] matrix of 32-bit words, each holding lpw = 32 / bits
// biased code lanes big-endian (lane j of a word in bits [32 - bits*(j+1),
// 32 - bits*j)); pad slots hold the top lane value 2^bits - 1. Output: per row
// the lanes sorted ascending and `order`, with sorted[b, s] == lanes[b, order[b, s]]
// and ties in slot order: exactly the stable argsort. The kernel sorts the
// composite (lane << log2(cap)) | slot, unique by its slot bits, so the
// unstable bitonic network gives the stable order.
//
// What bounds it on the H100: device-memory bytes, bits/8 bytes a slot in and
// 8 bytes a slot out (two int32 outputs). The words are unpacked straight into
// the shared-memory tile, so the flat code matrix never exists in device
// memory. A row of up to 32768 slots (the join's largest bucket class) is one
// tile and sorts in one launch; longer rows take K1's passes over device
// memory (bitonic_i32.cuh), with the composites kept in the `sorted` output
// until a last pass splits them into lanes and slots. The TPU's gates (rows of
// at most 32768 slots, tiles of 8 rows) are gone: every power of two of at
// least one word takes the kernel.

#include "bitonic_i32.cuh"

namespace {

__global__ void packed_sort_tiles(const uint32_t* __restrict__ words, int32_t* __restrict__ out_codes,
                                  int32_t* __restrict__ out_order, int cap, int tile, int bits,
                                  int log2cap, bool split) {
  extern __shared__ int32_t smem[];
  const int lpw = 32 / bits;
  const uint32_t mask = (1u << bits) - 1u;
  const int tiles_per_row = cap / tile;
  const int64_t row = blockIdx.x / tiles_per_row;
  const int64_t base = static_cast<int64_t>(blockIdx.x % tiles_per_row) * tile;
  const int64_t off = row * cap + base;
  const uint32_t* w = words + row * (cap / lpw);
  for (int x = threadIdx.x; x < tile; x += blockDim.x) {
    const int64_t slot = base + x;
    const int lane_in_word = static_cast<int>(slot % lpw);
    const uint32_t lane = (w[slot / lpw] >> (32 - bits * (lane_in_word + 1))) & mask;
    smem[x] = static_cast<int32_t>((lane << log2cap) | static_cast<uint32_t>(slot));
  }
  __syncthreads();
  sort_tile(smem, tile, base);
  const int32_t slot_mask = cap - 1;
  for (int x = threadIdx.x; x < tile; x += blockDim.x) {
    const int32_t c = smem[x];
    if (split) {
      out_codes[off + x] = c >> log2cap;
      out_order[off + x] = c & slot_mask;
    } else {
      out_codes[off + x] = c;
    }
  }
}

// Composites (held in `codes`) -> sorted lanes and slot order, in place.
__global__ void split_composites(int32_t* __restrict__ codes, int32_t* __restrict__ order,
                                 int64_t n, int log2cap, int32_t slot_mask) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int32_t c = codes[i];
    codes[i] = c >> log2cap;
    order[i] = c & slot_mask;
  }
}

}  // namespace

// words: [rows, cap / (32 / bits)] 32-bit words; out_codes/out_order: [rows, cap]
// int32. cap a power of two, (2^bits - 1) << log2(cap) < 2^31. Launches on
// `stream`; returns cudaGetLastError().
extern "C" int hs_packed_sort(const void* words, void* out_codes, void* out_order, int rows, int cap,
                              int bits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const TileShape t = tile_shape(rows, cap);
  int log2cap = 0;
  while ((1 << log2cap) < cap) ++log2cap;
  const bool one_tile = t.tile == cap;
  cudaFuncSetAttribute(packed_sort_tiles, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(t.smem));
  auto* codes = static_cast<int32_t*>(out_codes);
  auto* order = static_cast<int32_t*>(out_order);
  packed_sort_tiles<<<t.blocks, t.threads, t.smem, s>>>(static_cast<const uint32_t*>(words), codes,
                                                        order, cap, t.tile, bits, log2cap, one_tile);
  if (!one_tile) {
    cross_tile_passes(codes, rows, cap, t, s);
    const int64_t n = static_cast<int64_t>(rows) * cap;
    int64_t blocks = (n + kPassThreads - 1) / kPassThreads;
    if (blocks > 65535) blocks = 65535;
    split_composites<<<static_cast<int>(blocks), kPassThreads, 0, s>>>(codes, order, n, log2cap,
                                                                       cap - 1);
  }
  return static_cast<int>(cudaGetLastError());
}
