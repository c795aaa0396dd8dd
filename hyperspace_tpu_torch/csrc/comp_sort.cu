// Composite sort of the sub-byte-key index build (kernel K3 of the port).
//
// Replaces the Pallas kernel `_sort_comp_kernel` in hyperspace_tpu/ops/pallas_sort.py
// (:256, launched from `sort_comp_padded` :261, called by
// hyperspace_tpu/ops/partition.py `pallas_packed_build_sort` :252). Contract:
// each row of a contiguous [rows, cap] int32 matrix comes back ascending, for
// any int32 values (negatives, duplicates, equal pads). The build packs
// ((bucket << bits) | (code + 1)) << log2(cap) | row into each key and pads
// with the supremum, so its composites are unique and the ascending order is
// the canonical stable (bucket, code, row) order; the sort does not rely on
// that layout.
//
// What bounds it on the H100: device-memory bytes, 8 a key (each key read
// once and written once). The build hands K3 ONE row (262,144 keys for the
// customer table), so a network that sorts rows block by block leaves most
// of the 132 SMs idle. This is a least-significant-digit radix sort over all
// 32 bits in four stable passes of 8-bit digits (the sign bit flipped so that
// signed order holds). Each pass cuts every row into tiles of up to 2048
// keys, one 256-thread block each, so the one row of 262,144 keys is 128
// blocks, about one wave of the card.
//
// At 1 MiB the data sits in L2 and the number of launches sets the time, so
// the sort is one launch per pass (a one-sweep radix sort):
//   radix_hist   once, before the passes: every row's digit totals of all
//                four passes, from one read of the input (tile by tile);
//   radix_pass   per pass: a block takes the next tile id, ranks its keys
//                within the tile by digit (warp ballots and per-warp
//                counters, in tile order, so the pass is stable), publishes
//                the tile's digit counts and finds the counts of the tiles
//                before it in its row by decoupled look-back, then reorders
//                the tile in shared memory and writes each digit's run to
//                its place in the row.
// Tile ids are taken in launch order from a counter, so a block only ever
// waits for blocks that already run. The look-back words carry the pass in
// their flag, so one zeroed buffer serves the four passes. Passes ping-pong
// between a scratch buffer and `out`; the wrapper allocates both and the
// state, which one memset zeroes, and nothing here allocates.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // threads of every radix block
constexpr int kDigits = 256;   // 8-bit digits: one thread per digit
constexpr int kPasses = 4;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxKeysPerThread = 16;
constexpr int kMaxTileKeys = kThreads * kMaxKeysPerThread;  // 4096
constexpr int kLookBack = 4;  // look-back words a thread reads at once

__device__ __forceinline__ uint32_t digit_of(int32_t key, int shift) {
  return ((static_cast<uint32_t>(key) ^ 0x80000000u) >> shift) & (kDigits - 1);
}

// Exclusive prefix sum of one value per thread over the block (all kThreads
// threads call it); `tmp` holds kWarps ints of shared memory.
__device__ __forceinline__ int block_exclusive_scan(int v, int* tmp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) tmp[warp] = x;
  __syncthreads();
  int before = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) before += w < warp ? tmp[w] : 0;
  __syncthreads();  // tmp may be reused by the next call
  return before + x - v;
}

// The lanes of `active` whose digit equals this lane's, from 8 ballots (one
// per digit bit; cheaper than a match instruction).
__device__ __forceinline__ uint32_t digit_peers(uint32_t d, uint32_t active) {
  uint32_t peers = active;
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const uint32_t set = __ballot_sync(active, (d >> b) & 1u);
    peers &= (d >> b) & 1u ? set : ~set;
  }
  return peers;
}

// totals[(row * 4 + pass) * 256 + digit] += keys of the block's span (up to
// 2048 keys of one row) with that digit in that pass. Each warp counts into
// its own copy; a warp whose keys share a digit adds them at once, so rows
// of few distinct digits do not serialise on one counter.
__global__ void __launch_bounds__(kThreads) radix_hist(const int32_t* __restrict__ src,
                                                       int32_t* __restrict__ totals, int cap,
                                                       int span) {
  constexpr int kKeysPerThread = 8;
  __shared__ int32_t counts[kWarps][kPasses][kDigits];
  const int spans = cap / span;
  const int64_t row = blockIdx.x / spans;
  const int32_t* s = src + row * cap + static_cast<int64_t>(blockIdx.x % spans) * span;
  int32_t k[kKeysPerThread];
#pragma unroll
  for (int i = 0; i < kKeysPerThread; ++i) {
    const int x = i * kThreads + threadIdx.x;
    if (x < span) k[i] = s[x];
  }
  for (int i = threadIdx.x; i < kWarps * kPasses * kDigits; i += kThreads) (&counts[0][0][0])[i] = 0;
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const uint32_t lanes_below = (1u << (threadIdx.x & 31)) - 1u;
#pragma unroll
  for (int i = 0; i < kKeysPerThread; ++i) {
    const bool valid = i * kThreads + static_cast<int>(threadIdx.x) < span;
    const uint32_t active = __ballot_sync(0xffffffffu, valid);
    if (valid) {
#pragma unroll
      for (int p = 0; p < kPasses; ++p) {
        const uint32_t d = digit_of(k[i], 8 * p);
        if (__reduce_min_sync(active, d) == __reduce_max_sync(active, d)) {
          if ((active & lanes_below) == 0) counts[warp][p][d] += __popc(active);
        } else {
          atomicAdd(&counts[warp][p][d], 1);
        }
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kPasses * kDigits; i += kThreads) {
    int c = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) c += (&counts[w][0][0])[i];
    if (c != 0) atomicAdd(&totals[row * kPasses * kDigits + i], c);
  }
}

// Look-back words: (flag << 32) | count, flag 2 pass + 1 for the tile's own
// count and 2 pass + 2 for the inclusive count of the row up to the tile.
__device__ __forceinline__ void publish(uint64_t* w, uint32_t flag, int count) {
  *reinterpret_cast<volatile unsigned long long*>(w) =
      (static_cast<unsigned long long>(flag) << 32) | static_cast<uint32_t>(count);
}

template <int kKeysPerThread>
__global__ void __launch_bounds__(kThreads) radix_pass(const int32_t* __restrict__ src,
                                                       int32_t* __restrict__ dst,
                                                       const int32_t* __restrict__ totals,
                                                       uint64_t* __restrict__ status,
                                                       int* __restrict__ next_tile, int cap,
                                                       int tile, int pass) {
  __shared__ int32_t warp_counts[kWarps][kDigits];  // then: each warp's start within its digit
  __shared__ int32_t digit_start[kDigits];          // the digit's first position in the sorted tile
  __shared__ int32_t dst_base[kDigits];             // sorted tile position -> row-global index
  constexpr int kKeysPerWarp = 32 * kKeysPerThread;  // contiguous in the tile
  __shared__ int32_t sorted[kThreads * kKeysPerThread];
  __shared__ int tmp[kWarps];
  __shared__ int id_s;
  if (threadIdx.x == 0) id_s = atomicAdd(next_tile + pass, 1);
  for (int i = threadIdx.x; i < kWarps * kDigits; i += kThreads) (&warp_counts[0][0])[i] = 0;
  __syncthreads();
  const int id = id_s;
  const int tiles = cap / tile;
  const int row = id / tiles;
  const int t = id % tiles;
  const int shift = 8 * pass;
  const int32_t* s = src + static_cast<int64_t>(row) * cap + static_cast<int64_t>(t) * tile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // Warp w owns keys [w, w + 1) * kKeysPerWarp of the tile, 32 at a time,
  // so (warp, step, lane) is tile order and the ranks below are stable.
  int32_t k[kKeysPerThread];
  int rank[kKeysPerThread];
#pragma unroll
  for (int i = 0; i < kKeysPerThread; ++i) {
    const int x = warp * kKeysPerWarp + i * 32 + lane;
    if (x < tile) k[i] = s[x];
  }
  const uint32_t lanes_below = (1u << lane) - 1u;
#pragma unroll
  for (int i = 0; i < kKeysPerThread; ++i) {
    const bool valid = warp * kKeysPerWarp + i * 32 + lane < tile;
    const uint32_t active = __ballot_sync(0xffffffffu, valid);
    int before = 0, seen = 0;
    uint32_t peers = 0;
    if (valid) {
      const uint32_t d = digit_of(k[i], shift);
      peers = digit_peers(d, active);
      before = __popc(peers & lanes_below);
      seen = warp_counts[warp][d];
      rank[i] = seen + before;
    }
    __syncwarp();
    if (valid && before == 0) warp_counts[warp][digit_of(k[i], shift)] = seen + __popc(peers);
    __syncwarp();
  }
  __syncthreads();

  // Thread d: each warp's start within digit d and the tile's count of d.
  const int d = threadIdx.x;
  int in_tile = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = warp_counts[w][d];
    warp_counts[w][d] = in_tile;
    in_tile += c;
  }
  // Decoupled look-back over the row's earlier tiles, digit d per thread.
  const uint32_t own = 2 * pass + 1, inclusive = 2 * pass + 2;
  uint64_t* my = status + static_cast<int64_t>(id) * kDigits + d;
  int before_tile = 0;
  if (t == 0) {
    publish(my, inclusive, in_tile);
  } else {
    publish(my, own, in_tile);
    // Read kLookBack earlier words at once; add them nearest first up to the
    // first inclusive one, and read again from the first that is not ready.
    const int64_t first = static_cast<int64_t>(row) * tiles;  // tile 0 of the row is inclusive
    int64_t j = id - 1;
    for (bool done = false; !done;) {
      const auto* words = reinterpret_cast<const volatile unsigned long long*>(status);
      unsigned long long v[kLookBack];
#pragma unroll
      for (int u = 0; u < kLookBack; ++u) v[u] = j - u >= first ? words[(j - u) * kDigits + d] : 0ull;
#pragma unroll
      for (int u = 0; u < kLookBack; ++u) {
        const uint32_t flag = static_cast<uint32_t>(v[u] >> 32);
        if (done || flag < own) break;  // earlier passes' words hold lower flags
        before_tile += static_cast<int>(static_cast<uint32_t>(v[u]));
        done = flag == inclusive;
        --j;
      }
    }
    publish(my, inclusive, before_tile + in_tile);
  }
  const int start = block_exclusive_scan(in_tile, tmp);
  const int row_start = block_exclusive_scan(totals[(row * kPasses + pass) * kDigits + d], tmp);
  digit_start[d] = start;
  dst_base[d] = row * cap + row_start + before_tile - start;
  __syncthreads();

#pragma unroll
  for (int i = 0; i < kKeysPerThread; ++i) {
    if (warp * kKeysPerWarp + i * 32 + lane < tile) {
      const uint32_t dk = digit_of(k[i], shift);
      sorted[digit_start[dk] + warp_counts[warp][dk] + rank[i]] = k[i];
    }
  }
  __syncthreads();
  for (int x = threadIdx.x; x < tile; x += kThreads) {
    const int32_t key = sorted[x];
    dst[dst_base[digit_of(key, shift)] + x] = key;
  }
}

}  // namespace

// in/out/scratch: [rows, cap] int32 (cap a power of two, rows * cap < 2^31);
// tile: keys per block, a power of two of at most 4096 that divides cap
// (above 2048 a thread takes 16 keys, else 8);
// state: 8 * rows * (cap / tile) * 256 + 4 * rows * 4 * 256 + 16 bytes,
// 8-byte aligned (the look-back words, the digit totals of the four passes,
// the four tile counters), zeroed here. Launches on `stream`; returns
// cudaGetLastError() (cudaErrorInvalidValue for a tile the kernels do not take).
extern "C" int hs_comp_sort(const void* in, void* out, void* scratch, void* state, int rows, int cap,
                            int tile, void* stream) {
  if (tile < 1 || tile > kMaxTileKeys || (tile & (tile - 1)) != 0 || cap % tile != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = cap / tile;
  auto* status = static_cast<uint64_t*>(state);
  auto* totals = reinterpret_cast<int32_t*>(status + static_cast<int64_t>(rows) * tiles * kDigits);
  int* next_tile = totals + static_cast<int64_t>(rows) * kPasses * kDigits;
  const size_t state_bytes = reinterpret_cast<char*>(next_tile + kPasses) - static_cast<char*>(state);
  cudaMemsetAsync(state, 0, state_bytes, s);
  const int32_t* src = static_cast<const int32_t*>(in);
  int32_t* bufs[2] = {static_cast<int32_t*>(scratch), static_cast<int32_t*>(out)};
  const bool wide = tile > kThreads * 8;  // 16 keys a thread, else 8
  const int span = cap < kThreads * 8 ? cap : kThreads * 8;
  radix_hist<<<rows * (cap / span), kThreads, 0, s>>>(src, totals, cap, span);
  for (int pass = 0; pass < kPasses; ++pass) {
    int32_t* dst = bufs[pass & 1];
    if (wide)
      radix_pass<16><<<rows * tiles, kThreads, 0, s>>>(src, dst, totals, status, next_tile, cap, tile, pass);
    else
      radix_pass<8><<<rows * tiles, kThreads, 0, s>>>(src, dst, totals, status, next_tile, cap, tile, pass);
    src = dst;
  }
  return static_cast<int>(cudaGetLastError());
}
