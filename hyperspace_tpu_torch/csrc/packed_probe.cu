// Range probe of packed sub-byte code rows (kernel K5 of the port).
//
// Replaces the Pallas kernel `_probe_packed_kernel` in hyperspace_tpu/ops/pallas_probe.py
// (:254, launched by `_probe_packed_call` :281 from `probe_packed_pallas` :310).
// Inputs: left [rows, cap_l / lpw] and right [rows, cap_r / lpw] matrices of
// 32-bit words holding lpw = 32 / bits biased code lanes big-endian (lane j of a
// word in bits [32 - bits*(j+1), 32 - bits*j)), each row sorted over its valid
// prefix. K2's contract, lane for lane: for left slot s of row b, lo = #right
// lanes < x and counts = #right lanes == x over right[b, :r_len[b]]; lo =
// counts = 0 on left pad slots (s >= l_len[b]) and on rows with an empty right
// side. Lengths clamp to [0, cap] in the kernel, and arrive as int32 or int64.
//
// What bounds it on the H100: bytes, bits/8 read per lane and 8 written per
// left slot; the writes dominate. The TPU kernel compared every left lane
// with every right lane, because that is what its vector unit does well. Here
// the lanes take at most 2^bits <= 16 values and the right row is sorted, so
// lo(x) for every left lane of a row comes from one table of prefix counts,
// T[v] = lower_bound(right[b, :m], v) for v = 0 .. 2^bits (T[2^bits] = m):
// lo = T[x] and counts = T[x + 1] - T[x]. Each block takes one row and 8192
// of its left lanes. It builds the table from the packed right row in device
// memory in two rounds of loads up to m = 32768 (256 evenly spaced probes,
// then a warp a value searches the gap its bound falls in), then
// each thread unpacks 4 left lanes at a time and stores their (lo, counts)
// as 16-byte vectors, a warp's stores contiguous. The right row is never
// staged: the work is O(cap_l + 2^bits log m) a row.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlockLanes = 8192;  // left lanes per block, 4 a thread at a time

template <int bits>
__device__ __forceinline__ uint32_t lane_at(const uint32_t* w, int i) {
  constexpr int lpw = 32 / bits;
  return (__ldg(w + i / lpw) >> (32 - bits * (i % lpw + 1))) & ((1u << bits) - 1u);
}

template <typename Len>
__device__ __forceinline__ int clamp_len(Len len, int cap) {
  return len < 0 ? 0 : (len > cap ? cap : static_cast<int>(len));
}

// lower_bound(v) in [a, b] (lanes before a are below v, lanes from b on are
// not), by one warp: 32-way narrowing while the gap is wide, then the warp
// counts the lanes below v, at most 4 loads a lane.
template <int bits>
__device__ __forceinline__ int warp_bound(const uint32_t* r, int a, int b, uint32_t v, int lane) {
  while (b - a > 128) {
    const int step = (b - a + 31) / 32;
    const int q = a + lane * step;
    const int k = __popc(__ballot_sync(0xffffffffu, q < b && lane_at<bits>(r, q) < v));
    if (k == 0) return a;  // lane a is not below v
    const int last = a + (k - 1) * step;  // below v
    b = min(b, last + step);              // not below v, or past the range
    a = last + 1;
  }
  int c = 0;
  for (int i = a + lane; i < b; i += 32) c += lane_at<bits>(r, i) < v;
  return a + __reduce_add_sync(0xffffffffu, c);
}

template <int bits, typename Len>
__global__ void __launch_bounds__(kThreads) packed_probe(
    const uint32_t* __restrict__ left, const uint32_t* __restrict__ right,
    const Len* __restrict__ l_len, const Len* __restrict__ r_len, int32_t* __restrict__ lo_out,
    int32_t* __restrict__ cnt_out, int cap_l, int cap_r, int blocks_per_row) {
  constexpr int lpw = 32 / bits;
  constexpr int nv = 1 << bits;
  __shared__ int32_t probe[kThreads];
  __shared__ int32_t table[nv + 1];
  const int row = blockIdx.x / blocks_per_row;
  const int s_begin = (blockIdx.x % blocks_per_row) * kBlockLanes;
  const int s_end = min(s_begin + kBlockLanes, cap_l);
  // Lengths clamp to [0, cap], as the TPU kernel's iota masks do, so the
  // host never reads them back to check.
  const int m = clamp_len(r_len[row], cap_r);
  const int n = clamp_len(l_len[row], cap_l);
  const uint32_t* r = right + static_cast<int64_t>(row) * (cap_r / lpw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // The table, in two rounds of loads for m up to 32768. First 256 evenly
  // spaced probes of the valid right prefix (the top value past it); then for
  // each v the probes below v are a prefix of k, so lower_bound(v) lies in
  // ((k-1) step, k step] and one warp finds it in that gap.
  const int step = (m + kThreads - 1) / kThreads;
  const int q = static_cast<int>(threadIdx.x) * step;
  probe[threadIdx.x] = q < m ? static_cast<int>(lane_at<bits>(r, q)) : nv;
  if (threadIdx.x == 0) {
    table[0] = 0;  // no lane is below 0
    table[nv] = m;
  }
  __syncthreads();
  for (uint32_t v = 1 + warp; v < nv; v += kWarps) {
    int below = 0;
    for (int i = lane; i < kThreads; i += 32) below += probe[i] < static_cast<int>(v);
    const int k = __reduce_add_sync(0xffffffffu, below);
    const int t = k == 0 ? 0 : warp_bound<bits>(r, (k - 1) * step + 1, min(k * step, m), v, lane);
    if (lane == 0) table[v] = t;
  }
  __syncthreads();

  // Each thread takes 4 left lanes at a time, so a warp's 16-byte stores
  // cover 512 contiguous bytes of lo and of counts.
  const uint32_t* lw = left + static_cast<int64_t>(row) * (cap_l / lpw);
  const int64_t out_row = static_cast<int64_t>(row) * cap_l;
  constexpr uint32_t mask = (1u << bits) - 1u;
  for (int s0 = s_begin + 4 * static_cast<int>(threadIdx.x); s0 < s_end; s0 += 4 * kThreads) {
    const uint32_t word = __ldg(lw + s0 / lpw);
    const int j = s0 % lpw;  // lpw is 8, 16 or 32: the 4 lanes share a word
    int lo[4], cnt[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const uint32_t x = (word >> (32 - bits * (j + u + 1))) & mask;
      const bool valid = s0 + u < n;
      const int a = table[x];
      lo[u] = valid ? a : 0;
      cnt[u] = valid ? table[x + 1] - a : 0;
    }
    *reinterpret_cast<int4*>(lo_out + out_row + s0) = make_int4(lo[0], lo[1], lo[2], lo[3]);
    *reinterpret_cast<int4*>(cnt_out + out_row + s0) = make_int4(cnt[0], cnt[1], cnt[2], cnt[3]);
  }
}

template <int bits, typename Len>
void launch(const void* lw, const void* rw, const void* l_len, const void* r_len, void* lo,
            void* counts, int rows, int cap_l, int cap_r, cudaStream_t s) {
  const int blocks_per_row = (cap_l + kBlockLanes - 1) / kBlockLanes;
  packed_probe<bits, Len><<<rows * blocks_per_row, kThreads, 0, s>>>(
      static_cast<const uint32_t*>(lw), static_cast<const uint32_t*>(rw),
      static_cast<const Len*>(l_len), static_cast<const Len*>(r_len), static_cast<int32_t*>(lo),
      static_cast<int32_t*>(counts), cap_l, cap_r, blocks_per_row);
}

template <typename Len>
void launch_bits(int bits, const void* lw, const void* rw, const void* l_len, const void* r_len,
                 void* lo, void* counts, int rows, int cap_l, int cap_r, cudaStream_t s) {
  if (bits == 1) launch<1, Len>(lw, rw, l_len, r_len, lo, counts, rows, cap_l, cap_r, s);
  if (bits == 2) launch<2, Len>(lw, rw, l_len, r_len, lo, counts, rows, cap_l, cap_r, s);
  if (bits == 4) launch<4, Len>(lw, rw, l_len, r_len, lo, counts, rows, cap_l, cap_r, s);
}

}  // namespace

// lw: [rows, cap_l / lpw], rw: [rows, cap_r / lpw] 32-bit words (lpw = 32 / bits);
// l_len/r_len: [rows] int64 when len64 is nonzero, else int32; lo/counts:
// [rows, cap_l] int32, 16-byte aligned. Launches on `stream`; returns
// cudaGetLastError().
extern "C" int hs_packed_probe(const void* lw, const void* rw, const void* l_len, const void* r_len,
                               void* lo, void* counts, int rows, int cap_l, int cap_r, int bits,
                               int len64, void* stream) {
  if (bits != 1 && bits != 2 && bits != 4) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (len64)
    launch_bits<int64_t>(bits, lw, rw, l_len, r_len, lo, counts, rows, cap_l, cap_r, s);
  else
    launch_bits<int32_t>(bits, lw, rw, l_len, r_len, lo, counts, rows, cap_l, cap_r, s);
  return static_cast<int>(cudaGetLastError());
}
