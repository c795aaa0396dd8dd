// Range probe of packed sub-byte code rows (kernel K5 of the port).
//
// Replaces the Pallas kernel `_probe_packed_kernel` in hyperspace_tpu/ops/pallas_probe.py
// (:254, launched by `_probe_packed_call` :281 from `probe_packed_pallas` :310).
// Inputs: left [rows, cap_l / lpw] and right [rows, cap_r / lpw] matrices of
// 32-bit words holding lpw = 32 / bits biased code lanes big-endian (lane j of a
// word in bits [32 - bits*(j+1), 32 - bits*j)), each row sorted over its valid
// prefix. K2's contract, lane for lane: for left slot s of row b, lo = #right
// lanes < x and hi = #right lanes <= x over right[b, :r_len[b]], so lo is
// clamped to r_len by construction; counts = hi - lo; lo = counts = 0 on left
// pad slots (s >= l_len[b]) and on rows with an empty right side. Lengths
// clamp to [0, cap] in the kernel.
//
// What bounds it on the H100: the TPU kernel compared every left lane with
// every right lane, a [cap_l x cap_r] count per row, because that is what its
// vector unit does well. Here one thread owns one left slot and runs two binary
// searches, 2 log2(r_len) dependent loads, so the work is n log m compares and
// the bytes (bits/8 per lane read, 8 bytes per left slot written) bound it.
// The right row stays packed: a row of at most 48 KiB of words (cap_r 98304 at
// 4 bits) is staged in shared memory as words and each probe extracts lane i
// from word i / lpw; a larger row is searched in device memory. The TPU's gates
// (capacity-product budget, whole-row blocks) are gone: every whole-word shape
// takes the kernel.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr size_t kStageBytes = 48 * 1024;

__device__ __forceinline__ uint32_t lane_at(const uint32_t* w, int i, int bits, int lpw) {
  return (w[i / lpw] >> (32 - bits * (i % lpw + 1))) & ((1u << bits) - 1u);
}

template <bool kStage>
__global__ void packed_probe(const uint32_t* __restrict__ left, const uint32_t* __restrict__ right,
                             const int32_t* __restrict__ l_len, const int32_t* __restrict__ r_len,
                             int32_t* __restrict__ lo_out, int32_t* __restrict__ cnt_out, int cap_l,
                             int cap_r, int bits, int blocks_per_row) {
  extern __shared__ uint32_t stage_words[];
  const int lpw = 32 / bits;
  const int64_t row = blockIdx.x / blocks_per_row;
  const int slot = (blockIdx.x % blocks_per_row) * blockDim.x + threadIdx.x;
  // Lengths clamp to [0, cap], as the TPU kernel's iota masks do, so the
  // host never reads them back to check.
  const int m = min(max(r_len[row], 0), cap_r);
  const int n = min(l_len[row], cap_l);
  const uint32_t* r = right + row * (cap_r / lpw);
  if (kStage) {
    const int used_words = (m + lpw - 1) / lpw;
    for (int x = threadIdx.x; x < used_words; x += blockDim.x) stage_words[x] = r[x];
    __syncthreads();
    r = stage_words;
  }
  if (slot >= cap_l) return;
  const int64_t off = row * cap_l + slot;
  if (slot >= n || m == 0) {
    lo_out[off] = 0;
    cnt_out[off] = 0;
    return;
  }
  const uint32_t x = lane_at(left + row * (cap_l / lpw), slot, bits, lpw);
  int a = 0, b = m;
  while (a < b) {  // lower bound
    const int mid = (a + b) >> 1;
    if (lane_at(r, mid, bits, lpw) < x) a = mid + 1; else b = mid;
  }
  const int lo = a;
  b = m;
  while (a < b) {  // upper bound, from lo
    const int mid = (a + b) >> 1;
    if (lane_at(r, mid, bits, lpw) <= x) a = mid + 1; else b = mid;
  }
  lo_out[off] = lo;
  cnt_out[off] = a - lo;
}

}  // namespace

// lw: [rows, cap_l / lpw], rw: [rows, cap_r / lpw] 32-bit words (lpw = 32 / bits);
// l_len/r_len: [rows] int32; lo/counts: [rows, cap_l] int32. Launches on
// `stream`; returns cudaGetLastError().
extern "C" int hs_packed_probe(const void* lw, const void* rw, const void* l_len, const void* r_len,
                               void* lo, void* counts, int rows, int cap_l, int cap_r, int bits,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks_per_row = (cap_l + kThreads - 1) / kThreads;
  const int blocks = rows * blocks_per_row;
  const size_t stage = static_cast<size_t>(cap_r / (32 / bits)) * sizeof(uint32_t);
  const auto* lp = static_cast<const uint32_t*>(lw);
  const auto* rp = static_cast<const uint32_t*>(rw);
  const auto* ll = static_cast<const int32_t*>(l_len);
  const auto* rl = static_cast<const int32_t*>(r_len);
  auto* lo_p = static_cast<int32_t*>(lo);
  auto* cnt_p = static_cast<int32_t*>(counts);
  if (stage <= kStageBytes) {
    packed_probe<true><<<blocks, kThreads, stage, s>>>(lp, rp, ll, rl, lo_p, cnt_p, cap_l, cap_r,
                                                      bits, blocks_per_row);
  } else {
    packed_probe<false><<<blocks, kThreads, 0, s>>>(lp, rp, ll, rl, lo_p, cnt_p, cap_l, cap_r, bits,
                                                    blocks_per_row);
  }
  return static_cast<int>(cudaGetLastError());
}
