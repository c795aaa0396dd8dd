// In-bucket sort of a padded [rows, cap] int64 key matrix (kernel K1 of the port).
//
// Replaces the Pallas kernel `_sort_kernel` in hyperspace_tpu/ops/pallas_sort.py
// (:107, launched by `_sort_pallas_call` :132 from `sort_padded_with_order` :159).
// Contract: each row sorted ascending (pads are INT64_MAX and sort last), plus
// `order` with sorted[b, s] == keys[b, order[b, s]], exactly the STABLE argsort:
// equal keys keep their slot order, which lets the join's pair order equal the
// JAX package's. The TPU kernel's (hi, lo) int32 split is gone: Hopper
// compares int64 directly.
//
// What bounds it on the H100: device-memory bytes. Each pair must be read once
// (8 B key) and written once (8 B key + 4 B slot), 20 B a slot, and a merge
// sort needs only n log n compares, far below the card's integer rate. The
// design is a stable merge sort, so its cost does not depend on the keys (the
// join's hot buckets are duplicate-heavy), and no compare needs the slot: on
// equal keys a merge takes from the left run.
//   * sort_tiles: a block sorts a tile of 4096 or 8192 pairs (512 or 1024
//     threads, 8 pairs a thread; the wrapper picks the tile from the row
//     length). A thread loads its 8 consecutive keys with 16-byte loads and
//     sorts them in registers by odd-even transposition (stable: it swaps
//     only strictly greater neighbours). Then log2(tile / 8) merge rounds run
//     in shared memory: each thread finds where its 8 outputs start by a
//     binary search on the merge path and merges them sequentially. A row of
//     up to a tile is finished in this one launch and written once; a tile
//     holds several short rows, and no merge crosses a row.
//   * merge_runs: rows longer than the tile take one pass over device memory
//     per doubling of the run length. A block writes 2048 outputs of one
//     merged run: one warp finds each end of its slice of the merge path in
//     device memory (32 candidates a round), the block stages the two input
//     slices in shared memory and merges them as above. Passes ping-pong
//     between the outputs and a scratch buffer from the wrapper, starting
//     where the last pass must end in the outputs.
// So a [256, 32768] matrix is read and written three times (the tile pass
// and two merge passes), and a [256, 4096] matrix once. The merge rounds in
// shared memory, not device memory, set the time: each moves every pair
// through shared memory at scattered addresses, behind the merge-path
// searches. Measured on the card, 8 pairs a thread beat 16 (more warps to
// hide the merges' dependent loads), and 8192-pair tiles beat both 4096 (an
// extra device-memory pass) and 16384 (one block an SM).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kItems = 8;             // pairs a thread sorts and merges
constexpr int kMergeThreads = 256;    // threads of a merge_runs block
constexpr int kChunk = kMergeThreads * kItems;  // outputs of a merge_runs block
constexpr int64_t kKeyMax = INT64_MAX;

// Shared-memory slot of pair i: one unused slot after every 16 pairs, so that
// threads that read or write their consecutive pairs hit distinct banks.
__device__ __forceinline__ int pad(int i) { return i + (i >> 4); }
// Slots for n pairs; the one extra is read (and ignored) by a merge whose
// second run ends the buffer.
__host__ __device__ constexpr int padded(int n) { return n + (n >> 4) + 1; }

// Stable sort of a thread's pairs by key, within segments of seg_mask + 1
// pairs (rows shorter than kItems): odd-even transposition, kItems rounds.
__device__ __forceinline__ void sort_registers(int64_t (&k)[kItems], int32_t (&s)[kItems], int seg_mask) {
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
#pragma unroll
    for (int i = r & 1; i + 1 < kItems; i += 2) {
      if (((i + 1) & seg_mask) != 0 && k[i] > k[i + 1]) {
        const int64_t tk = k[i];
        k[i] = k[i + 1];
        k[i + 1] = tk;
        const int32_t ts = s[i];
        s[i] = s[i + 1];
        s[i + 1] = ts;
      }
    }
  }
}

// The number of pairs of run A (na pairs at a0) among the first d outputs of
// the stable merge of A and B (nb pairs at b0), both in shared memory.
__device__ __forceinline__ int shared_split(const int64_t* sk, int a0, int na, int b0, int nb, int d) {
  int lo = d > nb ? d - nb : 0;
  int hi = d < na ? d : na;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (sk[pad(a0 + mid)] <= sk[pad(b0 + d - 1 - mid)]) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// kItems outputs of the stable merge of A and B, from A[i] and B[j] on.
__device__ __forceinline__ void serial_merge(const int64_t* sk, const int32_t* si, int a0, int na, int b0,
                                             int nb, int i, int j, int64_t (&k)[kItems], int32_t (&s)[kItems]) {
  int64_t ka = sk[pad(a0 + i)], kb = sk[pad(b0 + j)];
#pragma unroll
  for (int x = 0; x < kItems; ++x) {
    const bool take_a = i < na && (j >= nb || ka <= kb);
    k[x] = take_a ? ka : kb;
    s[x] = si[pad(take_a ? a0 + i : b0 + j)];
    if (take_a) ka = sk[pad(a0 + ++i)];
    else kb = sk[pad(b0 + ++j)];
  }
}

// A thread's kItems pairs at `first` (of n) into device memory.
__device__ __forceinline__ void store_items(int64_t* out_keys, int32_t* out_order, int64_t first, int64_t n,
                                            const int64_t (&k)[kItems], const int32_t (&s)[kItems]) {
  if (first + kItems <= n) {
    auto* dk = reinterpret_cast<longlong2*>(out_keys + first);
    auto* ds = reinterpret_cast<int4*>(out_order + first);
#pragma unroll
    for (int q = 0; q < kItems / 2; ++q) dk[q] = make_longlong2(k[2 * q], k[2 * q + 1]);
#pragma unroll
    for (int q = 0; q < kItems / 4; ++q) ds[q] = make_int4(s[4 * q], s[4 * q + 1], s[4 * q + 2], s[4 * q + 3]);
  } else {
#pragma unroll
    for (int x = 0; x < kItems; ++x) {
      if (first + x < n) {
        out_keys[first + x] = k[x];
        out_order[first + x] = s[x];
      }
    }
  }
}

// Every tile of kThreads * kItems pairs sorted, each row of up to a tile
// completely; n = rows * cap pairs in all.
template <int kThreads>
__global__ void __launch_bounds__(kThreads)
sort_tiles(const int64_t* __restrict__ keys, int64_t* __restrict__ out_keys, int32_t* __restrict__ out_order,
           int64_t n, int cap, bool aligned) {
  constexpr int kTile = kThreads * kItems;
  extern __shared__ int64_t smem[];
  int64_t* sk = smem;
  int32_t* si = reinterpret_cast<int32_t*>(smem + padded(kTile));
  const int t0 = threadIdx.x * kItems;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kTile + t0;
  int64_t k[kItems];
  int32_t s[kItems];
  if (aligned && first + kItems <= n) {
    const auto* src = reinterpret_cast<const longlong2*>(keys + first);
#pragma unroll
    for (int q = 0; q < kItems / 2; ++q) {
      const longlong2 v = __ldg(src + q);
      k[2 * q] = v.x;
      k[2 * q + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int x = 0; x < kItems; ++x) k[x] = first + x < n ? keys[first + x] : kKeyMax;
  }
#pragma unroll
  for (int x = 0; x < kItems; ++x) s[x] = static_cast<int32_t>((first + x) & (cap - 1));
  sort_registers(k, s, cap - 1);
  // n is a multiple of cap, so the pairs past n (a short last tile) form
  // whole runs of their own and never merge with real ones.
  const int width = cap < kTile ? cap : kTile;
  for (int w = kItems; w < width; w <<= 1) {
#pragma unroll
    for (int x = 0; x < kItems; ++x) {
      sk[pad(t0 + x)] = k[x];
      si[pad(t0 + x)] = s[x];
    }
    __syncthreads();
    const int a0 = t0 & ~(2 * w - 1);
    const int d = t0 - a0;
    const int i = shared_split(sk, a0, w, a0 + w, w, d);
    serial_merge(sk, si, a0, w, a0 + w, w, i, d - i, k, s);
    __syncthreads();
  }
  store_items(out_keys, out_order, first, n, k, s);
}

// The merge-path split at diagonal d of the runs A and B (w pairs each) in
// device memory, found by one warp: each round tests 32 evenly spaced
// candidates, so a run of 2^15 pairs takes 3 rounds of loads.
__device__ __forceinline__ int warp_split(const int64_t* A, const int64_t* B, int w, int d) {
  const int lane = threadIdx.x & 31;
  int lo = d > w ? d - w : 0;
  int hi = d < w ? d : w;
  while (lo < hi) {
    const int step = (hi - lo + 31) >> 5;
    const int m = lo + lane * step;
    const bool before = m < hi && A[m] <= B[d - 1 - m];
    const int c = __popc(__ballot_sync(0xffffffffu, before));
    if (c == 0) {
      hi = lo;
    } else {
      const int base = lo;
      lo = base + (c - 1) * step + 1;
      hi = min(hi, base + c * step);
    }
  }
  return lo;
}

// One merge pass: each pair of adjacent sorted runs of w pairs (w at least a
// tile, 2w at most a row) becomes one sorted run; a block writes kChunk
// outputs of one merged run.
__global__ void __launch_bounds__(kMergeThreads)
merge_runs(const int64_t* __restrict__ in_keys, const int32_t* __restrict__ in_order,
           int64_t* __restrict__ out_keys, int32_t* __restrict__ out_order, int w) {
  extern __shared__ int64_t smem[];
  int64_t* sk = smem;
  int32_t* si = reinterpret_cast<int32_t*>(smem + padded(kChunk));
  __shared__ int split[2];
  const int chunks = 2 * w / kChunk;
  const int64_t run = static_cast<int64_t>(blockIdx.x / chunks) * 2 * w;
  const int d0 = (blockIdx.x % chunks) * kChunk;
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const int at = warp_split(in_keys + run, in_keys + run + w, w, d0 + warp * kChunk);
    if ((threadIdx.x & 31) == 0) split[warp] = at;
  }
  __syncthreads();
  const int i0 = split[0];
  const int na = split[1] - i0;
  const int j0 = d0 - i0;
  for (int x = threadIdx.x; x < kChunk; x += kMergeThreads) {
    const int64_t src = x < na ? run + i0 + x : run + w + j0 + (x - na);
    sk[pad(x)] = in_keys[src];
    si[pad(x)] = in_order[src];
  }
  __syncthreads();
  const int d = threadIdx.x * kItems;
  const int i = shared_split(sk, 0, na, na, kChunk - na, d);
  int64_t k[kItems];
  int32_t s[kItems];
  serial_merge(sk, si, 0, na, na, kChunk - na, i, d - i, k, s);
  const int64_t first = run + d0 + d;
  store_items(out_keys, out_order, first, first + kItems, k, s);
}

template <int kThreads>
void launch_tiles(const int64_t* keys, int64_t* ok, int32_t* oo, int64_t n, int cap, bool aligned,
                  cudaStream_t s) {
  constexpr int kTile = kThreads * kItems;
  const int smem = padded(kTile) * static_cast<int>(sizeof(int64_t) + sizeof(int32_t));
  cudaFuncSetAttribute(sort_tiles<kThreads>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const int64_t blocks = (n + kTile - 1) / kTile;
  sort_tiles<kThreads><<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(keys, ok, oo, n, cap, aligned);
}

}  // namespace

// keys: [rows, cap] int64, cap a power of two, rows * cap < 2^31; out_keys /
// out_order: [rows, cap] int64 / int32. tile: 4096 or 8192 pairs. When
// cap > tile, scratch holds rows * cap int64 keys then rows * cap int32 slots;
// else it may be null. Launches on `stream`; returns cudaGetLastError(), or
// cudaErrorInvalidValue for a tile it has no kernel for.
extern "C" int hs_bucket_sort(const void* keys, void* out_keys, void* out_order, void* scratch, int rows,
                              int cap, int tile, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t n = static_cast<int64_t>(rows) * cap;
  int passes = 0;
  for (int w = tile; w < cap; w <<= 1) ++passes;
  int64_t* keys_buf[2] = {static_cast<int64_t*>(out_keys), static_cast<int64_t*>(scratch)};
  int32_t* order_buf[2] = {static_cast<int32_t*>(out_order),
                           passes ? reinterpret_cast<int32_t*>(keys_buf[1] + n) : nullptr};
  int cur = passes & 1;  // the tile pass writes here; the last merge pass lands in buffer 0
  const auto* in = static_cast<const int64_t*>(keys);
  const bool aligned = (reinterpret_cast<uintptr_t>(keys) & 15) == 0;
  switch (tile) {
    case 4096: launch_tiles<4096 / kItems>(in, keys_buf[cur], order_buf[cur], n, cap, aligned, s); break;
    case 8192: launch_tiles<8192 / kItems>(in, keys_buf[cur], order_buf[cur], n, cap, aligned, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (passes) {
    const int smem = padded(kChunk) * static_cast<int>(sizeof(int64_t) + sizeof(int32_t));
    cudaFuncSetAttribute(merge_runs, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    for (int w = tile; w < cap; w <<= 1) {
      merge_runs<<<static_cast<unsigned>(n / kChunk), kMergeThreads, smem, s>>>(
          keys_buf[cur], order_buf[cur], keys_buf[cur ^ 1], order_buf[cur ^ 1], w);
      cur ^= 1;
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* hs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
