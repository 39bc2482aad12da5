// Dense-domain group-by: exact per-(bin, lane) totals, privatised in
// shared memory.
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
// the reference's (M, 128) limb-total matrix, so hi * 65536 + lo of the
// TPU kernel equals lt elementwise.
//
// Bound on the H100 SXM: bytes. The kernel must read ncap * (4 + 8K) bytes
// (int32 bins + K int64 value columns) and write lt once; at 2^25 rows and
// K = 1 that is 403 MB, about 0.12 ms at 3.35 TB/s. The adds themselves
// are a few per row.
//
// Design. One global atomic per nonzero limb of every row (the first
// port) put ~134M atomics on an L2-resident table and ran at 16x the
// bound, hot cells slowest. Here each block keeps uint32 counters for its
// cells in shared memory and touches lt only when it flushes:
//   * Only live lanes (limbs, sign lanes, the count) get counters, G per
//     lane. The live lanes are cut into slices that fit one block
//     (ops/dense_groupby.py::k1_launch_plan); blockIdx.y picks the slice,
//     and a block reads bins and only the columns its slice's lanes read.
//     The slices of one grid run together over the same rows, so the
//     re-read bins mostly come from L2.
//   * A block holds `copies` copies of its slice, one per group of warps
//     (one per warp where they fit, as at G = 128), so warps adding to the
//     same hot cell do not serialise on one word; the flush adds them.
//   * A limb is at most 255, so a uint32 counter is exact for 2^24 rows.
//     A block flushes every rows_per_flush rows it has read (<= 2^24, from
//     the wrapper) and at the end: one 64-bit atomicAdd into lt for every
//     nonzero cell, a few per cell of lt over the whole grid.
//   * Persistent blocks, about one per SM, 1024 threads each; a thread
//     reads one int4 of bins (4 rows) and the rows' values as two 16-byte
//     pairs, issued together before any add.
//   * The lane table and the column pointers are one struct passed by
//     value (__grid_constant__, read from the constant bank): no device
//     copy of descriptors per call.
//
// Lane word: lt lane (bits 0-15) | op << 16 | descriptor column << 24;
// op 0..56: limb at that bit shift; 64: sign bit; 65: count.
//
// Launch: one grid per launch group on the caller's stream; returns the
// first CUDA error (a refused launch, for too much shared memory, too).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kOpSign = 64;
constexpr int kOpCount = 65;
constexpr int kThreads = 1024;
constexpr int kMaxCols = 32;
constexpr int kMaxLanes = 704;
constexpr int kMaxSlices = 32;

// mirrored by ops/dense_groupby.py::_K1Desc
struct K1Desc {
  const int64_t* cols[kMaxCols];
  uint32_t lane[kMaxLanes];
  int32_t slice_begin[kMaxSlices + 1];
  int32_t nslices;
  int32_t max_lanes;  // shared-memory rows of one copy
  int32_t copies;
  int32_t blocks;     // blocks per slice
};

// Adds every copy of the slice's counters into lt (nonzero cells only) and
// zeroes them. Called by all threads of the block.
__device__ __forceinline__ void flush(uint32_t* sm, const K1Desc& d, int j0,
                                      int nl, int G, int L,
                                      unsigned long long* __restrict__ lt) {
  __syncthreads();
  const int cells = d.max_lanes * G;
  for (int j = 0; j < nl; ++j) {
    const int64_t row = (int64_t)(d.lane[j0 + j] & 0xffffu) * 128;
    for (int b = threadIdx.x; b < G; b += blockDim.x) {
      unsigned long long s = 0;
      for (int c = 0; c < d.copies; ++c) {
        uint32_t* p = sm + c * cells + j * G + b;
        s += *p;
        *p = 0;
      }
      if (s) atomicAdd(lt + (int64_t)(b >> 7) * L * 128 + row + (b & 127), s);
    }
  }
  __syncthreads();
}

__device__ __forceinline__ void load4(const int64_t* col, int64_t r0, int64_t n,
                                      bool full, int64_t v[4]) {
  if (full) {
    const longlong2 a = __ldg(reinterpret_cast<const longlong2*>(col + r0));
    const longlong2 b = __ldg(reinterpret_cast<const longlong2*>(col + r0) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  } else {
    for (int k = 0; k < 4; ++k) v[k] = r0 + k < n ? col[r0 + k] : 0;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
dense_groupby_kernel(const int32_t* __restrict__ bins, int64_t n, int G, int L,
                     const __grid_constant__ K1Desc d, int64_t rows_per_flush,
                     bool vec, unsigned long long* __restrict__ lt) {
  extern __shared__ uint32_t sm[];
  const int j0 = d.slice_begin[blockIdx.y];
  const int nl = d.slice_begin[blockIdx.y + 1] - j0;
  const int cells = d.max_lanes * G;
  for (int i = threadIdx.x; i < cells * d.copies; i += blockDim.x) sm[i] = 0;
  __syncthreads();
  uint32_t* mine = sm + ((threadIdx.x >> 5) % d.copies) * cells;
  // the slice's first value column, loaded beside the bins
  int first = -1;
  for (int j = 0; j < nl && first < 0; ++j)
    if (((d.lane[j0 + j] >> 16) & 255u) != kOpCount) first = d.lane[j0 + j] >> 24;

  const int64_t nquads = (n + 3) / 4;
  const int64_t ntiles = (nquads + blockDim.x - 1) / blockDim.x;
  const int64_t tiles_per_flush = rows_per_flush / (4 * (int64_t)blockDim.x);
  int64_t since = 0;
  for (int64_t t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int64_t q = t * blockDim.x + threadIdx.x;
    if (q < nquads) {
      const int64_t r0 = 4 * q;
      const bool full = vec && r0 + 4 <= n;
      int b[4];
      if (full) {
        const int4 x = __ldg(reinterpret_cast<const int4*>(bins + r0));
        b[0] = x.x; b[1] = x.y; b[2] = x.z; b[3] = x.w;
      } else {
        for (int k = 0; k < 4; ++k) b[k] = r0 + k < n ? bins[r0 + k] : G;
      }
      int cur = first;
      int64_t v[4];
      if (cur >= 0) load4(d.cols[cur], r0, n, full, v);
      unsigned live = 0;
      for (int k = 0; k < 4; ++k) live |= ((unsigned)b[k] < (unsigned)G) << k;
      if (live) {
        for (int j = 0; j < nl; ++j) {
          const uint32_t w = d.lane[j0 + j];
          const int op = (w >> 16) & 255;
          uint32_t* row = mine + j * G;
          if (op == kOpCount) {
            for (int k = 0; k < 4; ++k)
              if (live >> k & 1) atomicAdd(row + b[k], 1u);
            continue;
          }
          const int c = w >> 24;
          if (c != cur) {
            load4(d.cols[c], r0, n, full, v);
            cur = c;
          }
          for (int k = 0; k < 4; ++k) {
            if (!(live >> k & 1)) continue;
            const uint32_t add =
                op == kOpSign ? (uint32_t)(v[k] < 0)
                              : (uint32_t)((unsigned long long)v[k] >> op) & 255u;
            if (add) atomicAdd(row + b[k], add);
          }
        }
      }
    }
    if (++since == tiles_per_flush) {
      flush(sm, d, j0, nl, G, L, lt);
      since = 0;
    }
  }
  if (since) flush(sm, d, j0, nl, G, L, lt);
}

}  // namespace

// descs: host array of ngroups K1Desc (desc_bytes = sizeof(K1Desc), as a
// check of the Python mirror); lt: zeroed (M, 128) uint64 out.
extern "C" int tt_dense_groupby(const void* bins, long long n, int G, int lanes,
                                const void* descs, int ngroups, int desc_bytes,
                                long long rows_per_flush, void* lt,
                                void* stream) {
  if (desc_bytes != (int)sizeof(K1Desc) || rows_per_flush <= 0 ||
      rows_per_flush % (4 * kThreads) || G <= 0 || G % 128)
    return (int)cudaErrorInvalidValue;
  const K1Desc* ds = (const K1Desc*)descs;
  for (int g = 0; g < ngroups; ++g) {
    const K1Desc& d = ds[g];
    if (d.nslices < 1 || d.nslices > kMaxSlices || d.copies < 1 ||
        d.blocks < 1 || d.slice_begin[d.nslices] > kMaxLanes)
      return (int)cudaErrorInvalidValue;
    bool vec = (uintptr_t)bins % 16 == 0;
    for (int j = 0; j < d.slice_begin[d.nslices]; ++j) {
      if (((d.lane[j] >> 16) & 255u) == kOpCount) continue;
      vec = vec && (uintptr_t)d.cols[d.lane[j] >> 24] % 16 == 0;
    }
    const size_t smem = (size_t)d.copies * d.max_lanes * G * sizeof(uint32_t);
    cudaError_t err = cudaFuncSetAttribute(
        dense_groupby_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err) return (int)err;
    dense_groupby_kernel<<<dim3(d.blocks, d.nslices), kThreads, smem,
                           (cudaStream_t)stream>>>(
        (const int32_t*)bins, (int64_t)n, G, lanes, d, (int64_t)rows_per_flush,
        vec, (unsigned long long*)lt);
    if ((err = cudaGetLastError())) return (int)err;
  }
  return 0;
}
