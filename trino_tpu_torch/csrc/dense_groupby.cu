// Dense-domain group-by: exact per-(bin, lane) totals with 64-bit atomics.
//
// Replaces the Pallas kernel trino_tpu/ops/dense_groupby.py
// (dense_groupby_device, kernel body _make_kernel). That kernel binned
// rows on the TPU's matrix unit: a bf16 one-hot x 8-bit-limb product with
// an f32 accumulator, drained to int32 (hi, lo) pairs every <= 2^16 rows
// to stay exact. On Hopper exactness comes from integers instead: every
// live row adds, for each accumulator lane, its limb value (an 8-bit slice
// of a value column), its sign bit or 1 (the row count) into
//
//     lt[(bin >> 7) * lanes + lane][bin & 127]        (uint64)
//
// with atomicAdd on unsigned long long. The layout is the reference's
// (M, 128) limb-total matrix, so hi * 65536 + lo of the TPU kernel equals
// lt elementwise. No bf16 limbs, no f32 accumulator, no drain.
//
// Bound on the H100 SXM: the kernel must read ncap * (4 + 8K) bytes (int32
// bins + K int64 value columns); at 2^25 rows and K = 1 that is 403 MB,
// about 0.12 ms at 3.35 TB/s. Atomic throughput, not bandwidth, is
// expected to set the pace: one global atomic per nonzero limb of every
// live row, all landing in an (M, 128) table that fits in L2. Zero limbs
// are skipped. Privatising the table in shared memory (G * lanes * 4 B =
// 128 KB at G = 4096, 8 lanes) is the next design step.
//
// Lane descriptors (one pair per lane, copied into shared memory):
//   lane_col[l]  value column the lane reads (ignored for count/zero)
//   lane_op[l]   0..56: limb at that bit shift; 64: sign bit; 65: count;
//                66: zero (padding lane)
//
// Launch: on the caller's stream; returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kOpSign = 64;
constexpr int kOpCount = 65;

__global__ void dense_groupby_kernel(
    const int32_t* __restrict__ bins,
    const int64_t* const* __restrict__ cols,
    const int32_t* __restrict__ lane_col,
    const int32_t* __restrict__ lane_op,
    int lanes, int G, int64_t n,
    unsigned long long* __restrict__ lt) {
  extern __shared__ int32_t desc[];  // [lanes cols | lanes ops]
  for (int i = threadIdx.x; i < lanes; i += blockDim.x) {
    desc[i] = lane_col[i];
    desc[lanes + i] = lane_op[i];
  }
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += stride) {
    const int b = bins[r];
    if (b < 0 || b >= G) continue;  // dead row (filtered or padding)
    unsigned long long* cell =
        lt + ((int64_t)(b >> 7) * lanes) * 128 + (b & 127);
    int cur = -1;
    int64_t v = 0;
    for (int l = 0; l < lanes; ++l) {
      const int op = desc[lanes + l];
      unsigned long long add;
      if (op <= kOpSign) {
        const int c = desc[l];
        if (c != cur) {
          v = cols[c][r];
          cur = c;
        }
        add = op == kOpSign ? (unsigned long long)(v < 0)
                            : ((unsigned long long)v >> op) & 255ull;
      } else if (op == kOpCount) {
        add = 1ull;
      } else {
        continue;  // zero (padding) lane
      }
      if (add) atomicAdd(cell + (int64_t)l * 128, add);
    }
  }
}

}  // namespace

extern "C" int tt_dense_groupby(
    const void* bins, const void* col_ptrs, const void* lane_col,
    const void* lane_op, int lanes, int G, long long n, void* lt,
    int blocks, void* stream) {
  const int threads = 256;
  const size_t smem = 2 * (size_t)lanes * sizeof(int32_t);
  dense_groupby_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)bins, (const int64_t* const*)col_ptrs,
      (const int32_t*)lane_col, (const int32_t*)lane_op, lanes, G,
      (int64_t)n, (unsigned long long*)lt);
  return (int)cudaGetLastError();
}
