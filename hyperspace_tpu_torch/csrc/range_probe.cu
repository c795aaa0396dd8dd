// Batched range probe of padded bucket matrices (kernel K2 of the port): a
// windowed probe, one staged right-key window per tile of left slots.
//
// Replaces the Pallas kernel `_probe_kernel` in hyperspace_tpu/ops/pallas_probe.py
// (:129, launched by `_probe_pallas_call` :183 from `probe_pallas` :209).
// Contract, for each left slot s of row b: lo = #right keys < key and
// counts = #right keys == key over the VALID prefix right[b, :r_len[b]]
// (searchsorted left and right, so the clamp to r_len holds by construction);
// lo = counts = 0 on left pad slots (s >= l_len[b]) and on rows with an empty
// right side. Lengths clamp to [0, cap] in the kernel. Exact for ANY order of
// the left row; fast where it is sorted over its valid prefix, as every caller
// of the join passes it (value buckets are sorted at build time, hash buckets
// by K1). Templated on int64 (hash keys, integer values) and float64
// (value-mode floats, which arrive with -0.0 made +0.0 and NaN excluded, so a
// direct float compare is the right order).
//
// What bounds it on the H100: bytes. Each left key is read once, each right
// key of the valid prefix once, and two int32 outputs are written per slot.
// The TPU kernel counted by brute force, a [cap_l x cap_r] compare per bucket,
// because that is what its vector unit does well. A binary search per slot in
// device memory (this kernel's first design) is instead bound by chains of
// ~30 dependent 8-byte loads, each pulling a scattered 32-byte sector of a
// right row too large for shared memory (cap 32768 is 256 KiB; 256 rows
// exceed L2).
//
// The window removes those chains. One 256-thread block takes a tile of
// 256 * K consecutive left slots of one row, K keys a thread in registers
// (K from cap_r / cap_l, so that a tile's window is about 2048 right keys:
// 2 at a 4:1 ratio, 1 at 8:1; six blocks share an SM). The window [w0, w1) =
// [lower_bound(min), upper_bound(max)) of the tile's valid keys is guessed
// before any key is read: where both rows hold keys of one distribution (the
// two sides of a co-bucketed join do), the tile's share of the left row,
// [tile0, t1) of n, lies near the same share of the right row, [tile0 * m / n,
// t1 * m / n), widened by an eighth on each side. Its copy into shared memory
// (8-byte `cp.async`) starts at once, beside the left keys' loads, so a block
// waits for device memory about once. The tile's min and max then check the
// guess: it holds the window when the key before it is below the min and the
// key after it above the max. Each thread finds each of its keys in the
// stage: a binary search for its first key, then, while its keys ascend, a
// galloping search from the previous key's upper bound (the gap is the few
// right keys between two left keys). Results are offset by the guess's start.
// With sorted left rows the guesses of a row's tiles overlap only by their
// margins, so the right row is read about 1.3 times.
//
// Where the guess misses an end (an unsorted tile spans the whole row; a hot
// key's run is longer than the guess; rows of other distributions), two warps
// search the missed end of the window in device memory (32 probes a round)
// while the block counts the staged keys; the keys between the window's end
// and the guess are then staged in chunks of the stage and counted too. A
// key's counts are sums over disjoint runs of the window, so every path is
// exact for any left order. One launch per call, no allocation, no host read
// of the lengths.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTargetWindow = 2048;  // right keys a tile's window is sized for
constexpr int kMinBlocks = 6;        // blocks an SM holds (registers and stage)
constexpr int kMaxStage = 12288;     // most keys staged at once

template <typename T>
struct Limits;
template <>
struct Limits<int64_t> {
  __device__ static int64_t lowest() { return INT64_MIN; }
  __device__ static int64_t highest() { return INT64_MAX; }
};
template <>
struct Limits<double> {
  __device__ static double lowest() { return __longlong_as_double(0xfff0000000000000ULL); }
  __device__ static double highest() { return __longlong_as_double(0x7ff0000000000000ULL); }
};

// Staged key i of a window that starts `off` keys into the stage.
template <typename T>
struct Stage {
  const T* st;
  int off;
  __device__ __forceinline__ T operator[](int i) const { return st[off + i]; }
};

__device__ __forceinline__ int clamp_len(int64_t len, int cap) {
  return len < 0 ? 0 : (len > cap ? cap : static_cast<int>(len));
}

// Whether key a comes before the bound of x: a < x for a lower bound,
// a <= x for an upper bound.
template <bool kUpper, typename T>
__device__ __forceinline__ bool before(T a, T x) {
  return kUpper ? a <= x : a < x;
}

// First index in [lo, hi) whose key does not come before x; hi if none.
template <bool kUpper, typename A, typename T>
__device__ __forceinline__ int bsearch(const A& a, int lo, int hi, T x) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (before<kUpper>(a[mid], x)) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// The same, for an answer expected close to lo: steps of 1, 2, 4, ... until a
// key does not come before x, then a binary search of the last step.
template <bool kUpper, typename A, typename T>
__device__ __forceinline__ int gallop(const A& a, int lo, int hi, T x) {
  for (int step = 1; lo < hi; step <<= 1) {
    const int p = min(lo + step - 1, hi - 1);
    if (!before<kUpper>(a[p], x)) {
      hi = p;
      break;
    }
    lo = p + 1;
  }
  return bsearch<kUpper>(a, lo, hi, x);
}

// First index in [lo, hi) of the device-memory row r whose key does not
// come before x, by one warp: 32 evenly spaced probes narrow the range
// 33-fold a round; a range of at most 32 keys is probed whole.
template <bool kUpper, typename T>
__device__ int warp_search(const T* r, int lo, int hi, T x) {
  const int lane = threadIdx.x & 31;
  while (hi > lo) {  // the answer lies in [lo, hi]
    const int span = hi - lo;
    if (span <= 32) {
      const bool b = lane < span && before<kUpper>(r[lo + lane], x);
      return lo + __popc(__ballot_sync(0xffffffffu, b));
    }
    const int p = lo + static_cast<int>(static_cast<int64_t>(span) * (lane + 1) / 33);
    const int c = __popc(__ballot_sync(0xffffffffu, before<kUpper>(r[p], x)));
    const int new_lo = c == 0 ? lo : lo + static_cast<int>(static_cast<int64_t>(span) * c / 33) + 1;
    if (c < 32) hi = lo + static_cast<int>(static_cast<int64_t>(span) * (c + 1) / 33);
    lo = new_lo;
  }
  return lo;
}

// Starts copying r[a, b) into the stage (key a + i at i) with 8-byte
// `cp.async` copies, a warp's copies contiguous in device memory.
template <typename T>
__device__ __forceinline__ void stage_async(T* st, const T* r, int a, int b) {
  for (int i = threadIdx.x; i < b - a; i += kThreads) {
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(st + i));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst), "l"(r + a + i) : "memory");
  }
}

__device__ __forceinline__ void stage_wait() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// Adds to lt[k] / le[k] the staged keys (s[0, len), sorted, len > 0) below /
// at or below each valid key x[k]: a compare with the ends, else a binary
// search for a thread's first key and, while its keys ascend, a galloping
// search from the previous key's upper bound.
template <typename T, int K>
__device__ __forceinline__ void accumulate(const Stage<T>& s, int len, const T (&x)[K], int s0, int n,
                                           int (&lt)[K], int (&le)[K]) {
  const T first = s[0], last = s[len - 1];
  T px = T(0);
  int plt = 0, ple = 0;
  bool have = false;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (s0 + k >= n) continue;
    const T xk = x[k];
    int a_lt, a_le;
    if (have && xk == px) {
      a_lt = plt;
      a_le = ple;
    } else {
      if (!(first < xk)) a_lt = 0;
      else if (last < xk) a_lt = len;
      else if (have && xk > px) a_lt = gallop<false>(s, ple, len, xk);
      else a_lt = bsearch<false>(s, 0, len, xk);
      if (xk < first) a_le = 0;
      else if (!(xk < last)) a_le = len;
      else a_le = gallop<true>(s, a_lt, len, xk);
    }
    lt[k] += a_lt;
    le[k] += a_le;
    px = xk;
    plt = a_lt;
    ple = a_le;
    have = true;
  }
}

// One block: a tile of K * kThreads consecutive left slots of one row, K a
// thread. stage_cap: keys the stage holds.
template <typename T, int K>
__global__ void __launch_bounds__(kThreads, kMinBlocks) windowed_probe(
    const T* __restrict__ left, const T* __restrict__ right, const int64_t* __restrict__ l_len,
    const int64_t* __restrict__ r_len, int32_t* __restrict__ lo_out, int32_t* __restrict__ cnt_out,
    int cap_l, int cap_r, int tiles_per_row, int stage_cap) {
  extern __shared__ __align__(16) unsigned char stage_raw[];
  T* st = reinterpret_cast<T*>(stage_raw);
  __shared__ T warp_min[kWarps], warp_max[kWarps];
  __shared__ int window[2];
  constexpr int kTile = K * kThreads;

  const int64_t row = blockIdx.x / tiles_per_row;
  const int tile0 = (blockIdx.x % tiles_per_row) * kTile;
  const int s0 = tile0 + threadIdx.x * K;
  // Lengths clamp to [0, cap], as the TPU kernel's iota masks do, so the
  // host never reads them back to check.
  const int n = clamp_len(l_len[row], cap_l);
  const int m = clamp_len(r_len[row], cap_r);
  int lt[K], le[K];  // right keys below / at or below each key, from `base` on
#pragma unroll
  for (int k = 0; k < K; ++k) lt[k] = le[k] = 0;
  int base = 0;

  if (tile0 < n && m > 0) {  // uniform over the block: the barriers below are safe
    const T* r = right + row * cap_r;
    const T* l = left + row * cap_l;
    // The guessed window (the note at the head): its copy starts now, beside
    // the left keys' loads.
    const int t1 = min(tile0 + kTile, n);
    const int p0 = static_cast<int>(static_cast<int64_t>(tile0) * m / n);
    const int p1 = static_cast<int>((static_cast<int64_t>(t1) * m + n - 1) / n);
    const int margin = (p1 - p0) / 8 + 32;
    const int g0 = max(p0 - margin, 0), g1 = min(p1 + margin, m);
    const int a0 = max(g0 - 1, 0), a1 = min(g1 + 1, m);  // and the keys just outside
    const bool guessed = a1 - a0 <= stage_cap;
    if (guessed) stage_async(st, r, a0, a1);

    T x[K];
#pragma unroll
    for (int k = 0; k < K; ++k) x[k] = s0 + k < cap_l ? l[s0 + k] : T(0);
    T mn = Limits<T>::highest(), mx = Limits<T>::lowest();
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (s0 + k < n) {
        mn = x[k] < mn ? x[k] : mn;
        mx = x[k] > mx ? x[k] : mx;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const T a = __shfl_xor_sync(0xffffffffu, mn, o), b = __shfl_xor_sync(0xffffffffu, mx, o);
      mn = a < mn ? a : mn;
      mx = b > mx ? b : mx;
    }
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) {
      warp_min[warp] = mn;
      warp_max[warp] = mx;
    }
    stage_wait();
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      mn = warp_min[w] < mn ? warp_min[w] : mn;
      mx = warp_max[w] > mx ? warp_max[w] : mx;
    }
    // The guess holds the window when the key before it is below the tile's
    // min and the key after it above the tile's max: every key before g0 is
    // then below every tile key, every key from g1 on above.
    const Stage<T> staged{st, 0};
    const bool head_in = guessed && (g0 == 0 || staged[g0 - 1 - a0] < mn);
    const bool tail_in = guessed && (g1 == m || mx < staged[g1 - a0]);
    if (head_in && tail_in) {
      base = g0;
      accumulate(Stage<T>{st, g0 - a0}, g1 - g0, x, s0, n, lt, le);
    } else {
      // The exact window [w0, w1) = [lower_bound(min), upper_bound(max)):
      // two warps search, in device memory, the ends the guess missed (the
      // whole row when nothing was staged), while the block counts the
      // staged keys. The keys between the window's ends and the guess are
      // then staged in chunks of stage_cap and counted too: each key's
      // counts are sums over disjoint runs of the window.
      if (warp == 0) {
        const int w = head_in ? g0 : warp_search<false>(r, 0, guessed ? g0 : m, mn);
        if ((threadIdx.x & 31) == 0) window[0] = w;
      } else if (warp == 1) {
        const int w = tail_in ? g1 : warp_search<true>(r, guessed ? g1 : 0, m, mx);
        if ((threadIdx.x & 31) == 0) window[1] = w;
      }
      if (guessed) accumulate(Stage<T>{st, g0 - a0}, g1 - g0, x, s0, n, lt, le);
      __syncthreads();
      base = window[0];
      const int w1 = window[1];
      for (int part = 0; part < 2; ++part) {
        const int lo = part == 0 ? base : (guessed ? g1 : w1);
        const int hi = part == 0 ? (guessed ? g0 : w1) : w1;
        for (int a = lo; a < hi; a += stage_cap) {
          const int len = min(stage_cap, hi - a);
          __syncthreads();  // every thread is done with the stage
          stage_async(st, r, a, a + len);
          stage_wait();
          __syncthreads();
          accumulate(staged, len, x, s0, n, lt, le);
        }
      }
    }
  }

  int32_t* lo_p = lo_out + row * cap_l;
  int32_t* cnt_p = cnt_out + row * cap_l;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (s0 + k < cap_l) {
      const bool valid = s0 + k < n;
      lo_p[s0 + k] = valid ? base + lt[k] : 0;
      cnt_p[s0 + k] = valid ? le[k] - lt[k] : 0;
    }
  }
}

template <typename T, int K>
int run(const void* left, const void* right, const void* l_len, const void* r_len, void* lo,
        void* counts, int rows, int cap_l, int cap_r, cudaStream_t s) {
  constexpr int tl = K * kThreads;
  const int tiles = (cap_l + tl - 1) / tl;
  // The stage holds the guessed window: the tile's share of the right row
  // (tl * cap_r / cap_l keys at most), a margin of an eighth on each side,
  // and room for rows whose fill differs from the caps' ratio.
  const int64_t expect = std::min<int64_t>(static_cast<int64_t>(tl) * cap_r / cap_l + 1, cap_r);
  const int stage_cap = static_cast<int>(std::min<int64_t>(expect + expect / 2 + 96, kMaxStage));
  const size_t smem = static_cast<size_t>(stage_cap) * sizeof(T);
  auto kernel = windowed_probe<T, K>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<rows * tiles, kThreads, smem, s>>>(
      static_cast<const T*>(left), static_cast<const T*>(right), static_cast<const int64_t*>(l_len),
      static_cast<const int64_t*>(r_len), static_cast<int32_t*>(lo), static_cast<int32_t*>(counts), cap_l, cap_r,
      tiles, stage_cap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* left, const void* right, const void* l_len, const void* r_len, void* lo,
           void* counts, int rows, int cap_l, int cap_r, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // K keys a thread: the most (up to 8) whose tile keeps the expected window
  // within kTargetWindow right keys, and no more than the row holds.
  int k = 8;
  while (k > 1 && (static_cast<int64_t>(k) * kThreads * cap_r > static_cast<int64_t>(kTargetWindow) * cap_l ||
                   k * kThreads > cap_l)) {
    k >>= 1;
  }
  switch (k) {
    case 8: return run<T, 8>(left, right, l_len, r_len, lo, counts, rows, cap_l, cap_r, s);
    case 4: return run<T, 4>(left, right, l_len, r_len, lo, counts, rows, cap_l, cap_r, s);
    case 2: return run<T, 2>(left, right, l_len, r_len, lo, counts, rows, cap_l, cap_r, s);
    default: return run<T, 1>(left, right, l_len, r_len, lo, counts, rows, cap_l, cap_r, s);
  }
}

}  // namespace

// left: [rows, cap_l], right: [rows, cap_r] (each right row sorted over its
// valid prefix), l_len/r_len: [rows] int64 (the lengths the join keeps, so
// no conversion runs a call); lo/counts: [rows, cap_l] int32.
extern "C" int hs_range_probe_i64(const void* left, const void* right, const void* l_len,
                                  const void* r_len, void* lo, void* counts, int rows, int cap_l,
                                  int cap_r, void* stream) {
  return launch<int64_t>(left, right, l_len, r_len, lo, counts, rows, cap_l, cap_r, stream);
}

extern "C" int hs_range_probe_f64(const void* left, const void* right, const void* l_len,
                                  const void* r_len, void* lo, void* counts, int rows, int cap_l,
                                  int cap_r, void* stream) {
  return launch<double>(left, right, l_len, r_len, lo, counts, rows, cap_l, cap_r, stream);
}
