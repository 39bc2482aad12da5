// Dense hash-join build: the open-addressing table of row ids, in rounds.
//
// Replaces the Pallas kernel trino_tpu/ops/dense_join.py
// (build_table_device, kernel body _make_build_kernel). That kernel ran on
// one TPU core and inserted rows one after another: each live row wrote its
// id into the first EMPTY slot of (base + d) & (cap - 1), d < W. Every row
// depends on every earlier one, so carried over it would run on one thread.
// What the join path needs is a table whose probe gives the same join; this
// kernel computes the round table of build_table (dense_join.py), which
// parallelises over rows and equals the plain version elementwise:
//
//   round d: every live row not yet placed proposes itself for slot
//            (base + d) & (cap - 1); a slot that was vacant when the round
//            began takes the smallest proposing row id.
//
// The trap is vacancy: the reference decides it from the table as it stood
// when the round began, so no thread may read a slot another thread of the
// same round has just written. Working slots are therefore 64-bit,
// (d << 32) | row, all ones when empty, and a proposal is one atomicMin
// with no read before it: an occupant from an earlier round is smaller
// than any proposal of this round, so it is never displaced, and a vacant
// slot keeps the smallest id of the round. A row learns whether it won at
// the start of the next round (the launch boundary is the grid-wide
// barrier), so a build is W + 2 grid launches on one stream: W rounds, a
// pass that checks the last round and counts unplaced live rows (a block
// reduction, then one atomicAdd per block), and a pass that writes the
// int32 table (the low word, or INT32_MAX where the slot stayed empty).
//
// Bound on the H100 SXM: each row's slot base (4 B) and use flag (1 B) read
// once and the int32 table written once, 5n + 4 cap bytes; at the slice's
// orders build (n = 2^24, cap = 2^26) that is 352 MB, 0.105 ms at
// 3.35 TB/s. A table larger than the 50 MB L2 adds one random 32-byte
// sector per live row, and random atomics into it are expected to set the
// pace. Round d re-reads the row arrays (use, done flag, base of the rows
// still unplaced); compacting the unplaced rows after round 0 is the next
// design step.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned long long kEmpty64 = ~0ull;
constexpr int32_t kEmpty32 = 0x7fffffff;

__global__ void round_kernel(const int32_t* __restrict__ base,
                             const uint8_t* __restrict__ use, int64_t n,
                             uint32_t mask, int d, uint8_t* __restrict__ done,
                             unsigned long long* __restrict__ slots) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    if (!use[i] || done[i]) continue;
    const uint32_t b = (uint32_t)base[i];
    if (d > 0) {
      const unsigned long long mine =
          ((unsigned long long)(d - 1) << 32) | (unsigned long long)i;
      if (slots[(b + (uint32_t)(d - 1)) & mask] == mine) {
        done[i] = 1;
        continue;
      }
    }
    atomicMin(slots + ((b + (uint32_t)d) & mask),
              ((unsigned long long)d << 32) | (unsigned long long)i);
  }
}

__global__ void unplaced_kernel(const int32_t* __restrict__ base,
                                const uint8_t* __restrict__ use, int64_t n,
                                uint32_t mask, int last,
                                const uint8_t* __restrict__ done,
                                const unsigned long long* __restrict__ slots,
                                int32_t* __restrict__ unplaced) {
  __shared__ int32_t warp_sums[32];
  int32_t count = 0;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    if (!use[i] || done[i]) continue;
    const unsigned long long mine =
        ((unsigned long long)last << 32) | (unsigned long long)i;
    const uint32_t b = (uint32_t)base[i];
    if (slots[(b + (uint32_t)last) & mask] != mine) ++count;
  }
  for (int off = 16; off > 0; off >>= 1)
    count += __shfl_down_sync(0xffffffffu, count, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = count;
  __syncthreads();
  if (warp == 0) {
    count = lane < (int)(blockDim.x >> 5) ? warp_sums[lane] : 0;
    for (int off = 16; off > 0; off >>= 1)
      count += __shfl_down_sync(0xffffffffu, count, off);
    if (lane == 0 && count) atomicAdd(unplaced, count);
  }
}

__global__ void table_kernel(const unsigned long long* __restrict__ slots,
                             int64_t cap, int32_t* __restrict__ table) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; s < cap;
       s += stride) {
    const unsigned long long v = slots[s];
    table[s] = v == kEmpty64 ? kEmpty32 : (int32_t)(uint32_t)(v & 0xffffffffull);
  }
}

}  // namespace

// slots: cap uint64 scratch; done: n bytes scratch; table: cap int32 out;
// unplaced: one int32 out. Returns the first CUDA error, 0 when none.
extern "C" int tt_dense_join_build(
    const void* base, const void* use, long long n, long long cap, int window,
    void* slots, void* done, void* table, void* unplaced, int blocks,
    void* stream) {
  const int threads = 256;
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t mask = (uint32_t)(cap - 1);
  cudaError_t err;
  if ((err = cudaMemsetAsync(slots, 0xff, (size_t)cap * 8, s))) return (int)err;
  if ((err = cudaMemsetAsync(done, 0, (size_t)n, s))) return (int)err;
  if ((err = cudaMemsetAsync(unplaced, 0, sizeof(int32_t), s))) return (int)err;
  if (n > 0) {
    for (int d = 0; d < window; ++d) {
      round_kernel<<<blocks, threads, 0, s>>>(
          (const int32_t*)base, (const uint8_t*)use, (int64_t)n, mask, d,
          (uint8_t*)done, (unsigned long long*)slots);
      if ((err = cudaGetLastError())) return (int)err;
    }
    unplaced_kernel<<<blocks, threads, 0, s>>>(
        (const int32_t*)base, (const uint8_t*)use, (int64_t)n, mask,
        window - 1, (const uint8_t*)done, (const unsigned long long*)slots,
        (int32_t*)unplaced);
    if ((err = cudaGetLastError())) return (int)err;
  }
  table_kernel<<<blocks, threads, 0, s>>>(
      (const unsigned long long*)slots, (int64_t)cap, (int32_t*)table);
  return (int)cudaGetLastError();
}
