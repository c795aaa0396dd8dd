// Batched range probe of padded bucket matrices (kernel K2 of the port).
//
// Replaces the Pallas kernel `_probe_kernel` in hyperspace_tpu/ops/pallas_probe.py
// (:129, launched by `_probe_pallas_call` :183 from `probe_pallas` :209).
// Contract, for each left slot s of row b: lo = #right keys < key and
// hi = #right keys <= key over the VALID prefix right[b, :r_len[b]]
// (searchsorted left and right), so the clamp to r_len holds by construction;
// counts = hi - lo; lo = counts = 0 on left pad slots (s >= l_len[b]) and on
// rows with an empty right side. Templated on int64 (hash keys, integer
// values) and float64 (value-mode floats, which arrive with -0.0 made +0.0 and
// NaN excluded, so a direct float compare is the right order).
//
// What bounds it on the H100: the TPU kernel counted by brute force, a
// [cap_l x cap_r] compare per bucket, because that is what its vector unit
// does well. Here one thread owns one left slot and runs two binary searches,
// 2 * log2(r_len) dependent loads: the work is n log m compares, and the bytes
// (each key read once, two int32 outputs written) bound it. The searches are
// latency-bound chains of dependent loads, so the design keeps the right row
// close: a row of at most 48 KiB is staged in shared memory by the block
// before it searches; a larger row (cap_r 32768 is 256 KiB) is searched in
// device memory, where the top levels of every search hit the same few lines
// and stay in L2.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr size_t kStageBytes = 48 * 1024;

template <typename T>
__device__ __forceinline__ int lower_bound(const T* a, int lo, int hi, T x) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <typename T>
__device__ __forceinline__ int upper_bound(const T* a, int lo, int hi, T x) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <typename T, bool kStage>
__global__ void range_probe(const T* __restrict__ left, const T* __restrict__ right,
                            const int32_t* __restrict__ l_len, const int32_t* __restrict__ r_len,
                            int32_t* __restrict__ lo_out, int32_t* __restrict__ cnt_out,
                            int cap_l, int cap_r, int blocks_per_row) {
  extern __shared__ unsigned char stage_raw[];
  const int64_t row = blockIdx.x / blocks_per_row;
  const int slot = (blockIdx.x % blocks_per_row) * blockDim.x + threadIdx.x;
  const int m = r_len[row];
  const int n = l_len[row];
  const T* r = right + row * cap_r;
  if (kStage) {
    T* staged = reinterpret_cast<T*>(stage_raw);
    for (int x = threadIdx.x; x < m; x += blockDim.x) staged[x] = r[x];
    __syncthreads();
    r = staged;
  }
  if (slot >= cap_l) return;
  const int64_t off = row * cap_l + slot;
  if (slot >= n || m == 0) {
    lo_out[off] = 0;
    cnt_out[off] = 0;
    return;
  }
  const T x = left[off];
  const int lo = lower_bound(r, 0, m, x);
  const int hi = upper_bound(r, lo, m, x);
  lo_out[off] = lo;
  cnt_out[off] = hi - lo;
}

template <typename T>
int launch(const void* left, const void* right, const void* l_len, const void* r_len, void* lo,
           void* counts, int rows, int cap_l, int cap_r, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks_per_row = (cap_l + kThreads - 1) / kThreads;
  const int blocks = rows * blocks_per_row;
  const size_t stage = static_cast<size_t>(cap_r) * sizeof(T);
  const T* lp = static_cast<const T*>(left);
  const T* rp = static_cast<const T*>(right);
  const int32_t* ll = static_cast<const int32_t*>(l_len);
  const int32_t* rl = static_cast<const int32_t*>(r_len);
  int32_t* lo_p = static_cast<int32_t*>(lo);
  int32_t* cnt_p = static_cast<int32_t*>(counts);
  if (stage <= kStageBytes) {
    range_probe<T, true><<<blocks, kThreads, stage, s>>>(lp, rp, ll, rl, lo_p, cnt_p, cap_l,
                                                         cap_r, blocks_per_row);
  } else {
    range_probe<T, false><<<blocks, kThreads, 0, s>>>(lp, rp, ll, rl, lo_p, cnt_p, cap_l, cap_r,
                                                      blocks_per_row);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// left: [rows, cap_l], right: [rows, cap_r] (each row sorted over its valid
// prefix), l_len/r_len: [rows] int32; lo/counts: [rows, cap_l] int32.
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
