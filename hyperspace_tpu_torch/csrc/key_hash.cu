// 64-bit join and group keys of any number of key lanes (kernel K6 of the port).
//
// Replaces no TPU kernel. The JAX package computes `key64`
// (hyperspace_tpu/ops/hashing.py :324) with jnp ops that XLA fuses into one
// program; the port's plain version (`hashing.key64_plain`) dispatches the
// same murmur3 chain as about 89 elementwise torch ops a lane, each a launch
// and a host dispatch. This kernel computes the same bits in one launch.
//
// Contract, for each row i: out[i] = (h1 << 32) | h2 as a signed int64, where
// hs (s = 1, 2, seeds 0x9747B28C and 0x85EBCA6B) is the first lane's 32-bit
// hash, then fmix32(mix_combine(hs, lane hash)) for each further lane.
// A lane's hash is, by kind:
//   int     the value widened to int64 (bool 0/1, uint8 zero-extended,
//           int8/16/32 sign-extended), hashed as two 32-bit words;
//   float   the value converted to float64 (a static_cast, the conversion
//           torch's `.to(float64)` runs, so NaN payloads come out alike),
//           with every magnitude below DBL_MIN made +0.0, hashed as the two
//           words of its bits;
//   string  table_s[code]: the dictionary's per-seed hashes, gathered.
// A word hash is fmix32(mix_combine(mix_combine(seed, low), high)). A launch
// takes up to kMaxLanes lanes; with `resume` it reads (h1, h2) back from
// out[i] and combines its lanes into them, so a call with more lanes is one
// launch per kMaxLanes lanes and needs no scratch.
//
// What bounds it on the H100: device-memory bytes, each lane read once and
// 8 bytes written a row (0.3M rows of Q3's three group keys are 7.2 MB,
// about 2 us). All mixing is native uint32 arithmetic in registers; no
// temporary reaches device memory. The lanes' kinds and dtypes are uniform
// across a launch, so the switches on them never diverge within a warp.

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLanes = 8;
constexpr int kMaxBlocks = 132 * 8;  // 8 blocks of 256 threads fill each of the 132 SMs
constexpr uint32_t kSeed1 = 0x9747B28Cu;
constexpr uint32_t kSeed2 = 0x85EBCA6Bu;

enum Kind : int32_t { kInt = 0, kFloat = 1, kString = 2 };
enum Dtype : int32_t { kI8 = 0, kI16 = 1, kI32 = 2, kI64 = 3, kU8 = 4, kBool = 5, kF32 = 6, kF64 = 7 };

// The launch's lanes, passed by value (kMaxLanes * 32 + 8 bytes of parameters).
struct Lanes {
  const void* data[kMaxLanes];
  const int64_t* table1[kMaxLanes];
  const int64_t* table2[kMaxLanes];
  int32_t kind[kMaxLanes];
  int32_t dtype[kMaxLanes];
  int32_t count;
  int32_t resume;
};

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

__device__ __forceinline__ uint32_t mix_combine(uint32_t h, uint32_t k) {
  return (h ^ fmix32(k)) * 5u + 0xE6546B64u;
}

__device__ __forceinline__ uint32_t word_hash(uint64_t bits, uint32_t seed) {
  uint32_t h = mix_combine(seed, static_cast<uint32_t>(bits));
  h = mix_combine(h, static_cast<uint32_t>(bits >> 32));
  return fmix32(h);
}

__device__ __forceinline__ int64_t int_at(const void* p, int32_t dtype, int64_t i) {
  switch (dtype) {
    case kI8: return static_cast<const int8_t*>(p)[i];
    case kI16: return static_cast<const int16_t*>(p)[i];
    case kI32: return static_cast<const int32_t*>(p)[i];
    case kU8: return static_cast<const uint8_t*>(p)[i];
    case kBool: return static_cast<const uint8_t*>(p)[i] != 0;
    default: return static_cast<const int64_t*>(p)[i];
  }
}

__device__ __forceinline__ uint64_t float_bits(const void* p, int32_t dtype, int64_t i) {
  double x;
  switch (dtype) {
    case kF32: x = static_cast<double>(static_cast<const float*>(p)[i]); break;
    case kF64: x = static_cast<const double*>(p)[i]; break;
    default: x = static_cast<double>(int_at(p, dtype, i)); break;
  }
  if (fabs(x) < DBL_MIN) x = 0.0;  // -0.0 and subnormals hash as +0.0; NaN compares false
  return static_cast<uint64_t>(__double_as_longlong(x));
}

__global__ void __launch_bounds__(kThreads) key64_kernel(const Lanes lanes, int64_t n, int64_t* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n; i += stride) {
    uint32_t h1 = 0, h2 = 0;
    if (lanes.resume) {
      const uint64_t prev = static_cast<uint64_t>(out[i]);
      h1 = static_cast<uint32_t>(prev >> 32);
      h2 = static_cast<uint32_t>(prev);
    }
#pragma unroll
    for (int l = 0; l < kMaxLanes; ++l) {
      if (l >= lanes.count) break;
      uint32_t c1, c2;
      if (lanes.kind[l] == kString) {
        const int64_t code = int_at(lanes.data[l], lanes.dtype[l], i);
        c1 = static_cast<uint32_t>(lanes.table1[l][code]);
        c2 = static_cast<uint32_t>(lanes.table2[l][code]);
      } else {
        const uint64_t bits = lanes.kind[l] == kFloat ? float_bits(lanes.data[l], lanes.dtype[l], i)
                                                      : static_cast<uint64_t>(int_at(lanes.data[l], lanes.dtype[l], i));
        c1 = word_hash(bits, kSeed1);
        c2 = word_hash(bits, kSeed2);
      }
      if (l == 0 && !lanes.resume) {
        h1 = c1;
        h2 = c2;
      } else {
        h1 = fmix32(mix_combine(h1, c1));
        h2 = fmix32(mix_combine(h2, c2));
      }
    }
    out[i] = static_cast<int64_t>((static_cast<uint64_t>(h1) << 32) | h2);
  }
}

}  // namespace

// One lane as the wrapper describes it: its data (n values of `dtype`), and
// for a string lane the two per-seed dictionary-hash tables (int64, values
// below 2^32, indexed by the codes).
struct HsLane {
  const void* data;
  const int64_t* table1;
  const int64_t* table2;
  int32_t kind;
  int32_t dtype;
};

// lanes: n_lanes (1..8) descriptors in host memory; out: [n] int64, read
// back first when `resume` is set. Launches on `stream`; returns
// cudaGetLastError() (cudaErrorInvalidValue for a lane the kernel does not
// take: an unknown kind or dtype, a string lane of float codes or without its
// tables).
extern "C" int hs_key64(const HsLane* lanes, int n_lanes, long long n, void* out, int resume, void* stream) {
  if (n_lanes < 1 || n_lanes > kMaxLanes || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  Lanes p{};
  for (int l = 0; l < n_lanes; ++l) {
    const HsLane& d = lanes[l];
    if (d.kind < kInt || d.kind > kString || d.dtype < kI8 || d.dtype > kF64 || d.data == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    if (d.kind == kString && (d.dtype == kF32 || d.dtype == kF64 || d.dtype == kBool || d.table1 == nullptr ||
                              d.table2 == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
    if (d.kind == kInt && (d.dtype == kF32 || d.dtype == kF64)) return static_cast<int>(cudaErrorInvalidValue);
    p.data[l] = d.data;
    p.table1[l] = d.table1;
    p.table2[l] = d.table2;
    p.kind[l] = d.kind;
    p.dtype[l] = d.dtype;
  }
  p.count = n_lanes;
  p.resume = resume != 0;
  if (n == 0) return static_cast<int>(cudaSuccess);
  const long long want = (n + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
  key64_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p, static_cast<int64_t>(n),
                                                                             static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The constants the wrapper (ops/cuda_hash.py) mirrors, in this order:
// kMaxLanes, the three Kind codes, the eight Dtype codes (int8, int16, int32,
// int64, uint8, bool, float32, float64) and sizeof(HsLane). Writes at most
// `cap` of them to `out` and returns how many there are.
extern "C" int hs_key64_abi(int* out, int cap) {
  const int values[] = {kMaxLanes, kInt, kFloat, kString, kI8, kI16, kI32, kI64, kU8, kBool, kF32, kF64,
                        static_cast<int>(sizeof(HsLane))};
  const int count = static_cast<int>(sizeof(values) / sizeof(values[0]));
  for (int i = 0; i < count && i < cap; ++i) out[i] = values[i];
  return count;
}
