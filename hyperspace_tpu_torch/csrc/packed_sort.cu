// Sort of packed sub-byte code rows (kernel K4 of the port).
//
// Replaces the Pallas kernel `_sort_packed_kernel` in hyperspace_tpu/ops/pallas_sort.py
// (:210, launched by `_sort_packed_call` :220 from `sort_codes_packed` :243).
// Input: a [rows, cap / lpw] matrix of 32-bit words, each holding lpw = 32 / bits
// biased code lanes big-endian (lane j of a word in bits [32 - bits*(j+1),
// 32 - bits*j)); pad slots hold the top lane value 2^bits - 1. Output: per row
// the lanes sorted ascending and `order`, with sorted[b, s] == lanes[b, order[b, s]]
// and ties in slot order: exactly the stable argsort.
//
// What bounds it on the H100: device-memory bytes, bits/8 bytes a slot in and
// 8 bytes a slot out (two int32 outputs). A lane takes one of at most 16
// values and the slots arrive in order, so the stable sort is a counting sort:
// one histogram, then one stable scatter of the slots; no slot is compared
// with another. Rows are cut into chunks of 4096 slots, one 256-thread block
// each, so that even 200 rows spread over every SM in several blocks each.
// A thread owns 16 consecutive slots of its chunk:
//   * chunk_histograms (only for rows longer than a chunk): each block counts
//     the lane values of its chunk;
//   * sort_chunks: each thread counts its slots of each value with bit
//     arithmetic on its words (no vote, no compare of one slot with another)
//     into a [value][thread] table in shared memory; one scan of the table in
//     (value, thread) order gives every thread the place of its first slot of
//     each value in the chunk's order, and with the row's chunk counts,
//     start[v], the first position of value v in the row. The block writes
//     the sorted lanes of its share of the output positions as constant runs
//     (16-byte stores, no lane read back); each thread then walks its slots
//     and puts each at its value's next place (the table column is the
//     thread's own, in a bank of its own). The chunk's order is assembled in
//     shared memory first and stored value run by value run: scattered 4-byte
//     stores to device memory would cost more than the rest.
// Designs that ranked 32 slots at a time with one warp ballot per lane bit
// (one block a row, or chunks) measured slower: the votes and shuffles, not
// the bytes, set their time.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSlotsPerThread = 16;
constexpr int kChunkSlots = kThreads * kSlotsPerThread;  // 4096
constexpr unsigned kFull = 0xffffffffu;

// A thread's slots of its chunk, as kWords words of lanes in registers (the
// 16 slots fill 2 words at 4 bits, 1 at 2 bits, half a word at 1 bit).
template <int kBits>
struct ThreadSlots {
  static constexpr int kLpw = 32 / kBits;
  static constexpr int kWords = (kSlotsPerThread * kBits + 31) / 32;
  uint32_t word[kWords];
  int first_lane;  // the lane of word[0] that holds the thread's first slot
  int n;           // slots the thread holds (fewer than 16 only in short rows)

  __device__ __forceinline__ ThreadSlots(const uint32_t* stage, int slots) {
    const int s = threadIdx.x * kSlotsPerThread;
    n = min(max(slots - s, 0), kSlotsPerThread);
    first_lane = kLpw > kSlotsPerThread ? s % kLpw : 0;  // 0 unless two threads share a word
#pragma unroll
    for (int k = 0; k < kWords; ++k) word[k] = n > k * kLpw ? stage[s / kLpw + k] : 0u;
  }
  // The value of the thread's slot i (i < n).
  __device__ __forceinline__ uint32_t value(int i) const {
    const int j = first_lane + i;
    const uint32_t w = kWords == 1 ? word[0] : word[j / kLpw];
    return (w >> (32 - kBits * (j % kLpw + 1))) & ((1u << kBits) - 1u);
  }
  // The number of the thread's slots holding value v.
  __device__ __forceinline__ int count(uint32_t v) const {
    constexpr uint32_t kRep = kFull / ((1u << kBits) - 1u);  // 1 in the low bit of every lane
    int c = 0;
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      // The thread's lanes of word k: first_lane + [k * kLpw, ...) up to n.
      const int lo = k * kLpw, m = min(max(n - lo, 0), kLpw - (k == 0 ? first_lane : 0));
      const int j0 = k == 0 ? first_lane : 0;
      const int bits = kBits * m;
      const uint32_t valid = bits == 0 ? 0u : (bits == 32 ? kFull : ((1u << bits) - 1u) << (32 - kBits * (j0 + m)));
      uint32_t z = word[k] ^ (v * kRep);  // a lane is 0 where it holds v
#pragma unroll
      for (int sh = 1; sh < kBits; sh <<= 1) z |= z >> sh;
      c += __popc(~z & kRep & valid);
    }
    return c;
  }
};

// The chunk's words into shared memory; returns the chunk's slot count.
template <int kBits>
__device__ __forceinline__ int stage_chunk(const uint32_t* words, uint32_t* stage, int cap, bool aligned) {
  constexpr int kLpw = 32 / kBits;
  const int slots = cap < kChunkSlots ? cap : kChunkSlots;
  const int n_words = slots / kLpw;
  const uint32_t* src = words + static_cast<int64_t>(blockIdx.x) * n_words;
  if (aligned && (n_words & 3) == 0) {
    for (int x = threadIdx.x; x < n_words / 4; x += kThreads)
      reinterpret_cast<uint4*>(stage)[x] = __ldg(reinterpret_cast<const uint4*>(src) + x);
  } else {
    for (int x = threadIdx.x; x < n_words; x += kThreads) stage[x] = src[x];
  }
  __syncthreads();
  return slots;
}

template <int kBits>
__global__ void __launch_bounds__(kThreads)
chunk_histograms(const uint32_t* __restrict__ words, int32_t* __restrict__ hist, int cap, bool aligned) {
  constexpr int kValues = 1 << kBits;
  __shared__ __align__(16) uint32_t stage[kChunkSlots * kBits / 32];
  __shared__ int warp_counts[kThreads / 32][kValues];
  const ThreadSlots<kBits> mine(stage, stage_chunk<kBits>(words, stage, cap, aligned));
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int v = 0; v < kValues; ++v) {
    int c = mine.count(v);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) c += __shfl_xor_sync(kFull, c, o);
    if (lane == 0) warp_counts[threadIdx.x >> 5][v] = c;
  }
  __syncthreads();
  if (threadIdx.x < kValues) {
    int sum = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) sum += warp_counts[w][threadIdx.x];
    hist[static_cast<int64_t>(blockIdx.x) * kValues + threadIdx.x] = sum;
  }
}

// codes[a, b) = v: 16-byte stores inside, single ones at the unaligned ends.
__device__ __forceinline__ void fill_run(int32_t* codes, int a, int b, int v) {
  if (a >= b) return;
  const int a4 = min((a + 3) & ~3, b), b4 = max(b & ~3, a4);
  if (static_cast<int>(threadIdx.x) < a4 - a) codes[a + threadIdx.x] = v;
  if (static_cast<int>(threadIdx.x) < b - b4) codes[b4 + threadIdx.x] = v;
  for (int q = a4 / 4 + threadIdx.x; q < b4 / 4; q += kThreads)
    reinterpret_cast<int4*>(codes)[q] = make_int4(v, v, v, v);
}

// hist: the per-chunk value counts of chunk_histograms, read only for rows of
// more than one chunk.
template <int kBits>
__global__ void __launch_bounds__(kThreads)
sort_chunks(const uint32_t* __restrict__ words, const int32_t* __restrict__ hist, int32_t* __restrict__ out_codes,
            int32_t* __restrict__ out_order, int cap, bool aligned) {
  constexpr int kValues = 1 << kBits;
  __shared__ __align__(16) uint32_t stage[kChunkSlots * kBits / 32];
  __shared__ int32_t staged_order[kChunkSlots];
  // table[v][t]: thread t's slots of value v, then where the next of them goes
  // in the chunk's staged order.
  __shared__ int table[kValues][kThreads];
  // Per value: its first position in the row and its first place in the
  // staged order (each with one more entry, the end), and the slots of the
  // value in the row's chunks before this one.
  __shared__ int start[kValues + 1], local[kValues + 1], chunk_before[kValues];
  const int slots = stage_chunk<kBits>(words, stage, cap, aligned);
  const int chunks = cap / slots;
  const int64_t row = blockIdx.x / chunks;
  const int c0 = (blockIdx.x % chunks) * slots;  // the chunk's first slot in its row
  const ThreadSlots<kBits> mine(stage, slots);
#pragma unroll
  for (int v = 0; v < kValues; ++v) table[v][threadIdx.x] = mine.count(v);
  __syncthreads();

  // Warp w scans the rows v = w, w + 8, ... of the table along the threads
  // (lane l holds threads l, l + 32, ...) and leaves the row's total.
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int v = warp; v < kValues; v += kThreads / 32) {
    int carry = 0;
#pragma unroll
    for (int q = 0; q < kThreads / 32; ++q) {
      const int c = table[v][q * 32 + lane];
      int incl = c;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += y;
      }
      table[v][q * 32 + lane] = carry + incl - c;
      carry += __shfl_sync(kFull, incl, 31);
    }
    if (lane == 0) local[v + 1] = carry;  // the value's slots in the chunk, for now
  }
  __syncthreads();
  if (threadIdx.x < kValues) {
    const int v = threadIdx.x;
    const int in_chunk = local[v + 1];
    int total = in_chunk, before = 0;
    if (chunks > 1) {
      total = 0;
      const int32_t* h = hist + row * chunks * kValues + v;
      for (int q = 0; q < chunks; ++q) {
        const int n = h[q * kValues];
        total += n;
        before += q * slots < c0 ? n : 0;
      }
    }
    chunk_before[v] = before;
    // Scans over the values, within the first kValues lanes of warp 0.
    constexpr unsigned kValueLanes = (1u << kValues) - 1u;
    int incl_total = total, incl_chunk = in_chunk;
#pragma unroll
    for (int o = 1; o < kValues; o <<= 1) {
      const int t = __shfl_up_sync(kValueLanes, incl_total, o), c = __shfl_up_sync(kValueLanes, incl_chunk, o);
      if (v >= o) incl_total += t, incl_chunk += c;
    }
    __syncwarp(kValueLanes);
    start[v + 1] = incl_total;
    local[v + 1] = incl_chunk;
    if (v == 0) start[0] = local[0] = 0;
  }
  __syncthreads();

  // The sorted lanes of the output positions [c0, c0 + slots).
  int32_t* codes = out_codes + row * cap;
#pragma unroll 1
  for (int v = 0; v < kValues; ++v) fill_run(codes, max(start[v], c0), min(start[v + 1], c0 + slots), v);

  // Each slot of the thread to its value's next place in the staged order.
  const int s = threadIdx.x * kSlotsPerThread;
#pragma unroll
  for (int i = 0; i < kSlotsPerThread; ++i) {
    if (i < mine.n) {
      const uint32_t v = mine.value(i);
      const int at = local[v] + table[v][threadIdx.x];
      table[v][threadIdx.x] += 1;
      staged_order[at] = c0 + s + i;
    }
  }
  __syncthreads();
  // Value v's slots of this chunk go to [start[v] + chunk_before[v], ...).
  int32_t* order = out_order + row * cap;
#pragma unroll 1
  for (int v = 0; v < kValues; ++v) {
    int32_t* dst = order + start[v] + chunk_before[v];
    for (int q = threadIdx.x; q < local[v + 1] - local[v]; q += kThreads) dst[q] = staged_order[local[v] + q];
  }
}

template <int kBits>
void launch(const uint32_t* words, int32_t* codes, int32_t* order, int32_t* hist, int rows, int cap,
            bool aligned, cudaStream_t s) {
  const int chunks = cap > kChunkSlots ? cap / kChunkSlots : 1;
  const unsigned blocks = static_cast<unsigned>(rows) * chunks;
  if (chunks > 1) chunk_histograms<kBits><<<blocks, kThreads, 0, s>>>(words, hist, cap, aligned);
  sort_chunks<kBits><<<blocks, kThreads, 0, s>>>(words, hist, codes, order, cap, aligned);
}

}  // namespace

// words: [rows, cap / (32 / bits)] 32-bit words; out_codes/out_order: [rows, cap]
// int32 (16-byte aligned). cap a power of two of at least one word. chunk:
// the slots a block sorts, 4096 (the wrapper's constant, checked here). When
// cap > chunk, hist holds rows * (cap / chunk) * 2^bits int32 counts; else it
// may be null. Launches on `stream`; returns cudaGetLastError(), or
// cudaErrorInvalidValue for a width or chunk it has no kernel for.
extern "C" int hs_packed_sort(const void* words, void* out_codes, void* out_order, void* hist, int rows,
                              int cap, int bits, int chunk, void* stream) {
  if (chunk != kChunkSlots) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* w = static_cast<const uint32_t*>(words);
  auto* codes = static_cast<int32_t*>(out_codes);
  auto* order = static_cast<int32_t*>(out_order);
  auto* h = static_cast<int32_t*>(hist);
  const bool aligned = (reinterpret_cast<uintptr_t>(words) & 15) == 0;
  switch (bits) {
    case 1: launch<1>(w, codes, order, h, rows, cap, aligned, s); break;
    case 2: launch<2>(w, codes, order, h, rows, cap, aligned, s); break;
    case 4: launch<4>(w, codes, order, h, rows, cap, aligned, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
