// Dense hash-join build: the open-addressing table of row ids, in rounds
// over worklists of the rows still unplaced.
//
// Replaces the Pallas kernel trino_tpu/ops/dense_join.py
// (build_table_device, kernel body _make_build_kernel). That kernel ran on
// one TPU core and inserted rows one after another: each live row wrote its
// id into the first EMPTY slot of (base + d) & (cap - 1), d < W. Every row
// depends on every earlier one, so carried over it would run on one thread.
// What the join path needs is a table whose probe gives the same join; this
// kernel computes the round table of build_table_plain (dense_join.py),
// which parallelises over rows and equals it elementwise:
//
//   round d: every live row not yet placed proposes itself for slot
//            (base + d) & (cap - 1); a slot that was vacant when the round
//            began takes the smallest proposing row id.
//
// Protocol. Row ids are below 2^30 - 1 (the wrapper checks), so a proposal
// is stored tagged, row + 2^30, and a committed id plain: under signed
// order, committed ids < proposals < EMPTY (INT32_MAX). A round is a
// propose step, where every row of the round's worklist does
// atomicMin(slot, row + 2^30) with no read before it, then a commit step,
// where a row whose tagged id is still in its slot has won and stores its
// plain id, and every other row joins the next round's worklist.
// Why this is the plain version's round: at the start of round d every
// occupied slot holds a committed id, because a slot changed in round
// d - 1 holds that round's smallest proposal, which committed it. A
// committed id is below every proposal, so an occupied slot is never
// displaced, while a slot vacant when the round began (EMPTY, above every
// proposal) ends the propose step holding the smallest tagged id: the
// plain version's scatter-amin over vacant slots. Proposals of one round
// only ever lower a vacant slot, so no thread needs to read a slot another
// thread of the same round writes. In commit only the winner writes, and a
// loser compares its own tagged id with the slot, which holds the winner's
// id in either form, so the step is race-free. The rows left after round
// W - 1 are the plain version's unplaced rows.
//
// Why tagged proposals and not committed ids with the sign bit set: the
// sign bits would have to be cleared before the table is returned, by a
// pass over the table or by the placed rows again. With tagged proposals
// the last commit leaves the table final, at the cost of a row limit
// (2^30 - 1) that the executor's builds stay far below: its table holds 4
// slots a build row and stays below 2^31 slots.
//
// Where the time goes, and the design. In hash order every live row
// touches a random 32-byte sector of the table in each step, and a table
// beyond the 50 MB L2 turns each touch into DRAM traffic at a fraction of
// its streaming rate: that set the pace of this kernel's first versions
// (1.65 ms at Q-J2's build, 7.3M live rows in 2^26 slots). So:
//   * Buckets. The slots are cut into nb buckets of `span` slots (the top
//     bits of the slot). Round 0's compaction reads slot_base and use once,
//     appends the live rows to a worklist as (row, base) pairs and counts
//     them by bucket; a scan and two scatters (by 64 coarse buckets, then
//     by bucket; one global atomic a bucket and chunk) order the worklist
//     by bucket. A scatter thread holds its 16 entries in registers, so
//     it reads them once with all loads in flight together.
//   * Round 0 in shared memory. A round-0 proposal lands in its own
//     bucket, so one block takes one bucket: it sets a window of up to
//     16,384 slots to EMPTY in shared memory, proposes and commits there
//     with a __syncthreads between, and writes the window to the table.
//     Every slot is written once this way: there is no separate fill.
//   * Later rounds run over worklists of the rows still unplaced (two
//     buffers, ping-ponged; 5% of Q-J2's live rows enter round 1) on the
//     global table, all in one cooperative persistent launch: a propose
//     and a commit phase a round with a grid barrier after each, ending at
//     the first empty worklist, instead of 30 launches of which about half
//     find their worklist empty (it halved these rounds at Q-J1's second
//     build; at Q-J2's they cost the same either way). Losers are
//     appended in about the order they were read, so the bucket order
//     holds and the rows in flight touch a few MB of the table.
//   Appends take positions from block-aggregated counters (one atomicAdd
//   a block per pass), so worklists are sized on the device; a grid reads
//   its length there and exits at once when it is empty. The unplaced count
//   is the last worklist's length: no counting grid, no host read inside a
//   build.
//
// Bound on the H100 SXM: each row's slot base (4 B) and use flag (1 B) read
// once and the int32 table written once, 5n + 4 cap bytes; at Q-J2's
// orders build (n = 15M, cap = 2^26) that is 343 MB, 0.10 ms at 3.35 TB/s.
// The launches: the compaction, the scan, one or two scatters, round 0 and
// the later rounds, at most 6 on one stream.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t kEmpty = 0x7fffffff;
constexpr int32_t kProposal = 1 << 30;  // tag of a proposal
constexpr int kThreads = 256;           // rows per block pass
constexpr int kCompactThreads = 1024;
constexpr int kCompactRows = 4;
constexpr int kRound0Threads = 512;
constexpr int kMaxBuckets = 4096;
constexpr int kCoarseBits = 6;          // fine buckets per coarse bucket: 64
constexpr int kWindow = 16384;          // slots of round 0's shared window
constexpr int kPerThread = 16;          // worklist entries a scatter thread holds
constexpr int kChunk = kThreads * kPerThread;

// Position of this thread's item among the block's flagged threads, taken
// from *counter with one atomicAdd for the block. Called by every thread of
// the block (blockDim.x a multiple of 32); the result is meaningful where
// flag is set.
__device__ __forceinline__ int block_append(bool flag, int* counter) {
  __shared__ int warp_base[32];
  __shared__ int block_base;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const unsigned ballot = __ballot_sync(0xffffffffu, flag);
  if (lane == 0) warp_base[warp] = __popc(ballot);
  __syncthreads();
  if (warp == 0) {
    const int mine = lane < nwarps ? warp_base[lane] : 0;
    int incl = mine;
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += y;
    }
    const int total = __shfl_sync(0xffffffffu, incl, 31);
    if (lane < nwarps) warp_base[lane] = incl - mine;
    if (lane == 0) block_base = total ? atomicAdd(counter, total) : 0;
  }
  __syncthreads();
  return block_base + warp_base[warp] + __popc(ballot & ((1u << lane) - 1u));
}

__device__ __forceinline__ int bucket_of(int32_t base, uint32_t mask, int shift) {
  return (int)(((uint32_t)base & mask) >> shift);
}

// Round 0's read of the rows: the live ones join the unordered worklist,
// counted per bucket (block histogram, then one atomicAdd a nonzero bucket
// and block).
__global__ void __launch_bounds__(kCompactThreads)
compact_kernel(const int32_t* __restrict__ base, const uint8_t* __restrict__ use,
               int64_t n, uint32_t mask, int shift, int nb,
               int2* __restrict__ work, int* __restrict__ len,
               int* __restrict__ hist) {
  __shared__ int counts[kMaxBuckets];
  for (int i = threadIdx.x; i < nb; i += blockDim.x) counts[i] = 0;
  __syncthreads();
  // kCompactRows rows a thread a step, their loads issued together
  const int64_t step = (int64_t)blockDim.x * kCompactRows;
  for (int64_t i0 = blockIdx.x * step; i0 < n; i0 += gridDim.x * step) {
    bool live[kCompactRows];
    int32_t b[kCompactRows];
#pragma unroll
    for (int k = 0; k < kCompactRows; ++k) {
      const int64_t i = i0 + k * blockDim.x + threadIdx.x;
      live[k] = i < n && use[i];
      b[k] = i < n ? base[i] : 0;
    }
#pragma unroll
    for (int k = 0; k < kCompactRows; ++k) {
      if (live[k]) atomicAdd(counts + bucket_of(b[k], mask, shift), 1);
      const int at = block_append(live[k], len);
      if (live[k]) work[at] = make_int2((int32_t)(i0 + k * blockDim.x + threadIdx.x), b[k]);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nb; i += blockDim.x)
    if (counts[i]) atomicAdd(hist + i, counts[i]);
}

// Exclusive scan of the bucket counts: start[0..nb] (start[nb] = live rows),
// the fine scatter's cursors and the coarse scatter's (one a 64 buckets).
// One block of 1024 threads, 4 buckets each.
__global__ void scan_kernel(const int* __restrict__ hist, int nb,
                            int* __restrict__ start, int* __restrict__ cursor,
                            int* __restrict__ coarse) {
  __shared__ int warp_sums[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int kPer = kMaxBuckets / 1024;
  int v[kPer], sum = 0;
  for (int k = 0; k < kPer; ++k) {
    const int i = threadIdx.x * kPer + k;
    v[k] = i < nb ? hist[i] : 0;
    sum += v[k];
  }
  int incl = sum;
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sums[lane];
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += y;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  int at = incl - sum + (warp ? warp_sums[warp - 1] : 0);
  for (int k = 0; k < kPer; ++k) {
    const int i = threadIdx.x * kPer + k;
    if (i < nb) start[i] = cursor[i] = at;
    if (i < nb && !(i & ((1 << kCoarseBits) - 1))) coarse[i >> kCoarseBits] = at;
    at += v[k];
  }
  if (threadIdx.x == 1023) start[nb] = at;
}

// One level of ordering worklist 0 by bucket (slot >> shift, nb buckets):
// a block counts its chunk by bucket in shared memory, takes one range a
// bucket with one global atomicAdd, and places its entries in those
// ranges. By 64 coarse buckets first, so the runs a block writes are long;
// then by fine bucket over the coarse order, so the writes of the blocks
// in flight fall in a few coarse buckets' ranges and meet in L2.
__global__ void __launch_bounds__(kThreads)
scatter_kernel(const int2* __restrict__ work, const int* __restrict__ len,
               uint32_t mask, int shift, int nb, int* __restrict__ cursor,
               int2* __restrict__ out) {
  __shared__ int at[kMaxBuckets];
  const int m = *len;
  for (int c0 = blockIdx.x * kChunk; c0 < m; c0 += gridDim.x * kChunk) {
    for (int i = threadIdx.x; i < nb; i += blockDim.x) at[i] = 0;
    __syncthreads();
    int2 e[kPerThread];
    int bk[kPerThread];
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int i = c0 + k * kThreads + threadIdx.x;
      if (i < m) e[k] = work[i];
    }
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int i = c0 + k * kThreads + threadIdx.x;
      if (i < m) {
        bk[k] = bucket_of(e[k].y, mask, shift);
        atomicAdd(at + bk[k], 1);
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < nb; i += blockDim.x)
      if (at[i]) at[i] = atomicAdd(cursor + i, at[i]);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int i = c0 + k * kThreads + threadIdx.x;
      if (i < m) out[atomicAdd(at + bk[k], 1)] = e[k];
    }
    __syncthreads();
  }
}

// Round 0, one block a bucket: propose and commit in a shared-memory window
// of the bucket's slots, then write the window to the table; losers join
// worklist 1.
__global__ void __launch_bounds__(kRound0Threads)
round0_kernel(const int2* __restrict__ work, const int* __restrict__ start,
              int nb, int span, int win, uint32_t mask,
              int32_t* __restrict__ table, int2* __restrict__ next,
              int* __restrict__ next_len) {
  extern __shared__ int32_t slots[];
  for (int k = blockIdx.x; k < nb; k += gridDim.x) {
    const int r0 = start[k], r1 = start[k + 1];
    for (int64_t w0 = (int64_t)k * span; w0 < (int64_t)(k + 1) * span; w0 += win) {
      for (int s = threadIdx.x; s < win; s += blockDim.x) slots[s] = kEmpty;
      __syncthreads();
      for (int i = r0 + threadIdx.x; i < r1; i += blockDim.x) {
        const int2 e = work[i];
        const int64_t s = (int64_t)((uint32_t)e.y & mask) - w0;
        if (s >= 0 && s < win) atomicMin(slots + s, e.x + kProposal);
      }
      __syncthreads();
      for (int i0 = r0; i0 < r1; i0 += blockDim.x) {
        const int i = i0 + threadIdx.x;
        bool lose = false;
        int2 e = make_int2(0, 0);
        if (i < r1) {
          e = work[i];
          const int64_t s = (int64_t)((uint32_t)e.y & mask) - w0;
          if (s >= 0 && s < win) {
            if (slots[s] == e.x + kProposal)
              slots[s] = e.x;
            else
              lose = true;
          }
        }
        const int at = block_append(lose, next_len);
        if (lose) next[at] = e;
      }
      __syncthreads();
      for (int s = threadIdx.x; s < win; s += blockDim.x) table[w0 + s] = slots[s];
      __syncthreads();
    }
  }
}

// Rounds 1..W-1 in one cooperative launch: per round a propose phase and
// a commit phase over the worklist, each ended by a grid-wide barrier; the
// launch ends at the first empty worklist. Data written inside the launch
// (the table, the worklists, their lengths) is read through L2 (__ldcg):
// L1 is not kept coherent between SMs within one launch.
__global__ void __launch_bounds__(kThreads)
rounds_kernel(int2* wa, int2* wb, int* __restrict__ len, int window,
              uint32_t mask, int32_t* __restrict__ table) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  int2* cur = wa;
  int2* nxt = wb;
  const int stride = gridDim.x * blockDim.x;
  for (int d = 1; d < window; ++d) {
    const int m = __ldcg(len + d);
    if (m == 0) break;  // the same value in every block
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < m; i += stride) {
      const int2 e = __ldcg(cur + i);
      atomicMin(table + (((uint32_t)e.y + (uint32_t)d) & mask), e.x + kProposal);
    }
    grid.sync();
    for (int i0 = blockIdx.x * blockDim.x; i0 < m; i0 += stride) {
      const int i = i0 + threadIdx.x;
      bool lose = false;
      int2 e = make_int2(0, 0);
      if (i < m) {
        e = __ldcg(cur + i);
        const uint32_t slot = ((uint32_t)e.y + (uint32_t)d) & mask;
        if (__ldcg(table + slot) == e.x + kProposal)
          table[slot] = e.x;
        else
          lose = true;
      }
      const int at = block_append(lose, len + d + 1);
      if (lose) nxt[at] = e;
    }
    grid.sync();
    int2* t = cur;
    cur = nxt;
    nxt = t;
  }
}

}  // namespace

// Per-process launch facts, set once by tt_dense_join_build_init when the
// library loads: the SM count, the resident blocks of rounds_kernel a SM
// holds (a grid barrier needs them all resident) and round 0's dynamic
// shared memory raised to its largest window. None of these calls is made
// at launch, so a build can be captured into a CUDA graph.
static int g_sms = 0;
static int g_rounds_per_sm = 0;

extern "C" int tt_dense_join_build_init() {
  int device = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&device)) ||
      (err = cudaDeviceGetAttribute(&g_sms, cudaDevAttrMultiProcessorCount, device)) ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&g_rounds_per_sm, rounds_kernel,
                                                           kThreads, 0)) ||
      (err = cudaFuncSetAttribute(round0_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)(kWindow * sizeof(int32_t)))))
    return (int)err;
  return 0;
}

// table: cap int32 out; work: 2 * max(n, 1) int2 scratch (the two
// worklists); counts: window + 1 + 4 * 4096 int32, of which the first
// window + 1 are out: counts[d] = rows entering round d (counts[0] = live
// rows, counts[window] = unplaced live rows); the rest are the buckets'
// counts, starts and cursors. cap a power of two, n < 2^30. Returns the
// first CUDA error, 0 when none.
extern "C" int tt_dense_join_build(const void* base, const void* use, long long n,
                                   long long cap, int window, void* table,
                                   void* work, void* counts, int blocks,
                                   void* stream) {
  if (n < 0 || n >= kProposal || cap < 1 || (cap & (cap - 1)) || window < 1)
    return (int)cudaErrorInvalidValue;
  if (g_sms == 0) return (int)cudaErrorInitializationError;  // init not run
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t mask = (uint32_t)(cap - 1);
  // buckets of kWindow slots, at most kMaxBuckets; round 0 walks a wider
  // bucket in windows
  const long long nb = cap / kWindow < 1 ? 1 : (cap / kWindow > kMaxBuckets ? kMaxBuckets : cap / kWindow);
  const long long span = cap / nb;
  const int win = span < kWindow ? (int)span : kWindow;
  int shift = 0;
  while ((1ll << shift) < span) ++shift;
  const int64_t wsize = n > 0 ? n : 1;
  int2* wl[2] = {(int2*)work, (int2*)work + wsize};
  int* len = (int*)counts;
  int* hist = len + window + 1;
  int* start = hist + kMaxBuckets;
  int* cursor = start + kMaxBuckets + 1;
  int* coarse = cursor + kMaxBuckets;
  int32_t* tab = (int32_t*)table;
  cudaError_t err;
  if ((err = cudaMemsetAsync(counts, 0, (window + 1 + kMaxBuckets) * sizeof(int), s)))
    return (int)err;
  compact_kernel<<<blocks / 4 > 0 ? blocks / 4 : 1, kCompactThreads, 0, s>>>(
      (const int32_t*)base, (const uint8_t*)use, (int64_t)n, mask, shift, (int)nb,
      wl[1], len, hist);
  if ((err = cudaGetLastError())) return (int)err;
  scan_kernel<<<1, 1024, 0, s>>>(hist, (int)nb, start, cursor, coarse);
  if ((err = cudaGetLastError())) return (int)err;
  const int chunks = (int)((wsize + kChunk - 1) / kChunk);
  const int sblocks = chunks < blocks ? chunks : blocks;
  int2* cur = wl[0];
  int2* nxt = wl[1];
  if (nb > (1 << kCoarseBits)) {
    scatter_kernel<<<sblocks, kThreads, 0, s>>>(wl[1], len, mask, shift + kCoarseBits,
                                                (int)(nb >> kCoarseBits), coarse, wl[0]);
    if ((err = cudaGetLastError())) return (int)err;
    cur = wl[1];
    nxt = wl[0];
  }
  scatter_kernel<<<sblocks, kThreads, 0, s>>>(nxt, len, mask, shift, (int)nb, cursor, cur);
  if ((err = cudaGetLastError())) return (int)err;
  const size_t smem = (size_t)win * sizeof(int32_t);
  round0_kernel<<<(int)nb, kRound0Threads, smem, s>>>(
      cur, start, (int)nb, (int)span, win, mask, tab, nxt, len + 1);
  if ((err = cudaGetLastError())) return (int)err;
  if (window > 1) {
    // as many blocks as are resident at once, as a grid barrier needs
    const int resident = g_sms * g_rounds_per_sm;
    const int rblocks = resident < blocks ? resident : blocks;
    // the cooperative attribute of cudaLaunchKernelEx is what stream
    // capture records as a cooperative kernel node
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(rblocks > 0 ? rblocks : 1);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    if ((err = cudaLaunchKernelEx(&cfg, rounds_kernel, nxt, cur, len, window, mask, tab)))
      return (int)err;
  }
  return 0;
}
