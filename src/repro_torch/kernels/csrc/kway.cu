// B6: one-launch k-way merge of sorted runs, one output block per CTA.
//
// Replaces repro/kernels/kway_kernel.py:147 (_kway_kernel): there each grid
// step double-buffers async copies of the k run segments of the next output
// block into two VMEM slots (2 slots x k runs x B per lane), masks their
// tails to the sentinel tuple, and runs a block-granularity loser tree of
// pairwise merge networks, keeping the low B each round.
//
// That layout does not fit a Hopper CTA: at the pipeline's k = 57 runs, B =
// 256 and 10 arrays it is about 1.17 MB against 227 KB. But the k segments
// of one output block hold exactly B real elements in total
// (kway_kernel.py:197-201), so here they are staged contiguously into ONE
// B-wide window: CTA j reads its two columns of the cursor matrix (the
// absolute start of each run's segment for blocks j and j + 1, from the
// wrapper's merge-path ranks), scans the k counts into window offsets (one
// thread per run, a warp-shuffle block scan), and each window slot finds its
// run by a binary search over the offsets and loads from it. The window
// carries the n_cmp compare lanes and an int32 source-index lane (the
// element's position in the concatenated runs, so run index then in-run
// index); the last block's empty slots fill with the sentinel tuple and the
// index 0x7FFFFFFF. A bitonic sort of the window (B2's network, sort_window)
// puts it in order; then each slot copies every data lane from its source
// index in global memory. The compare prefix is an order-preserving
// refinement of the tuple and the index breaks the remaining ties by run,
// so the window's order is unique: the stable k-way merge, bit for bit that
// of merge_runs_kway_take, float ties included.
//
// Shared memory is (n_cmp + 1) x B x 4 B plus 2k + 33 ints — independent of
// k but for the cursors. The largest k per launch is set by the cursor
// matrix: each CTA scans its column of it with one thread per run, so k <=
// 1024 (MAX_RUNS); the wrapper raises past that.
//
// What bounds it on the H100: every data lane is read once and written once,
// so the least time is those bytes over 3.35 TB/s. The window sort's
// log2(B)(log2(B)+1)/2 steps of B/2 compares stay below the compute peak; a
// merge of the k sorted sub-segments in place of the full sort is later work.
#include "common.cuh"

#define INDEX_FILL 0x7FFFFFFFu
#define MAX_RUNS 1024

// Inclusive prefix sum of `v` over the threads of the block (blockDim.x a
// multiple of 32); `warp_sums` is 32 ints of shared memory.
__device__ int block_inclusive_scan(int v, int* warp_sums) {
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int d = 1; d < 32; d <<= 1) {
    int u = __shfl_up_sync(0xFFFFFFFFu, v, d);
    if (lane >= d) v += u;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int n_warps = blockDim.x >> 5;
    int s = lane < n_warps ? warp_sums[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      int u = __shfl_up_sync(0xFFFFFFFFu, s, d);
      if (lane >= d) s += u;
    }
    if (lane < n_warps) warp_sums[lane] = s;
  }
  __syncthreads();
  return warp > 0 ? v + warp_sums[warp - 1] : v;
}

__global__ void kway_kernel(const uint32_t* cmp, const uint32_t* data,
                            uint32_t* out, const int* cursors, int n_cmp,
                            int n_arr, uint32_t codes, int total, int n_runs,
                            int nblocks, int block) {
  extern __shared__ uint32_t smem[];
  Window w{smem, block, n_cmp + 1, codes};
  uint32_t* idx = smem + (size_t)n_cmp * block;
  int* offs = (int*)(idx + block);          // n_runs + 1 window offsets
  int* curs = offs + n_runs + 1;            // n_runs segment starts
  int* warp_sums = curs + n_runs;           // 32
  int j = blockIdx.x, t = threadIdx.x;
  int count = 0;
  if (t < n_runs) {
    const int* row = cursors + (size_t)t * (nblocks + 1);
    curs[t] = row[j];
    count = row[j + 1] - row[j];
  }
  int incl = block_inclusive_scan(count, warp_sums);
  if (t < n_runs) offs[t + 1] = incl;
  if (t == 0) offs[0] = 0;
  __syncthreads();
  int filled = offs[n_runs];
  for (int s = t; s < block; s += blockDim.x) {
    if (s < filled) {
      int lo = 0, hi = n_runs - 1;  // the last run whose offset is <= s
      while (lo < hi) {
        int mid = (lo + hi + 1) >> 1;
        if (offs[mid] <= s) lo = mid;
        else hi = mid - 1;
      }
      int src = curs[lo] + (s - offs[lo]);
      for (int l = 0; l < n_cmp; ++l)
        smem[l * block + s] = cmp[(size_t)l * total + src];
      idx[s] = (uint32_t)src;
    } else {
      for (int l = 0; l < n_cmp; ++l)
        smem[l * block + s] = sentinel_bits((codes >> (2 * l)) & 3);
      idx[s] = INDEX_FILL;
    }
  }
  __syncthreads();
  sort_window(w, block);
  for (int s = t; s < filled; s += blockDim.x) {
    size_t o = (size_t)j * block + s;
    int src = (int)idx[s];
    for (int l = 0; l < n_arr; ++l)
      out[(size_t)l * total + o] = data[(size_t)l * total + src];
  }
}

// Merge the k sorted runs concatenated in `cmp` (n_cmp, total) and `data`
// (n_arr, total) — stacked int32 lanes, `cmp` the compare lanes (the same
// memory as data when they lead the tuple) — into `out` (n_arr, total).
// `cursors` (n_runs, nblocks + 1): run r's segment for output block j
// starts at cursors[r][j] of the concatenation and ends at cursors[r][j+1].
// `codes` holds the compare lanes' codes and, at position n_cmp, the index
// lane's.
extern "C" int kway_merge_lex(const void* cmp, const void* data, void* out,
                              const void* cursors, int n_cmp, int n_arr,
                              unsigned codes, int total, int n_runs,
                              int nblocks, int block, void* stream) {
  if (nblocks == 0) return cudaSuccess;
  if (block < 32 || (block & (block - 1)) || n_cmp < 1 || n_cmp > 15 ||
      n_runs < 1 || n_runs > MAX_RUNS || (long long)nblocks * block < total)
    return cudaErrorInvalidValue;
  int threads = threads_for(block / 2);
  if (threads < n_runs) threads = (n_runs + 31) / 32 * 32;
  size_t smem = ((size_t)(n_cmp + 1) * block + 2 * n_runs + 1 + 32) *
                sizeof(uint32_t);
  cudaError_t err = allow_smem(kway_kernel, smem);
  if (err != cudaSuccess) return err;
  kway_kernel<<<nblocks, threads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)cmp, (const uint32_t*)data, (uint32_t*)out,
      (const int*)cursors, n_cmp, n_arr, codes, total, n_runs, nblocks, block);
  return cudaGetLastError();
}
