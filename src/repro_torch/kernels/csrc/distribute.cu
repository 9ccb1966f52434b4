// B3: the paper's distribute phase — per word its byte length (the bucket
// id), its stable rank inside that bucket, and the length histogram.
//
// Replaces repro/kernels/distribute_kernel.py:44 (distribute_rows_kernel).
// There the grid runs in order on one core, and the histogram block, whose
// index_map is constant (distribute_kernel.py:104-106), carries the running
// counts from one grid step to the next (the rank loop at :68-75). Blocks
// on a GPU run in no order, so the port takes a real cross-block prefix in
// three launches:
//   1. count: each block takes `tile` words; a word's rank among the earlier
//      words of its warp with the same length comes from __match_any_sync,
//      a prefix over the warps' histograms in shared memory makes it the
//      rank inside the block, and the block's histogram goes out;
//   2. scan: one block turns the (blocks, buckets) histograms into exclusive
//      offsets, one warp per bucket, and writes the totals (the counts);
//   3. offset: each word adds its block's offset for its bucket.
// The ranks are exactly the arrival-order ranks, with no atomics, so the
// bucket tensor built from them is the same on every run.
//
// Length: the position of the last non-zero byte of the big-endian packed
// word, so interior NUL bytes count (distribute_kernel.py:53-59). Rows at or
// past `n_valid` are padding: dest = num_buckets, rank 0, counted nowhere.
//
// What bounds it on the H100: the packed words are read once and dest and
// rank written once; at the paper's sizes that is microseconds of memory
// time, below the cost of the three launches.
#include "common.cuh"

#define MAX_WARPS 32
#define MAX_BUCKETS 33  // 4 * 8 lanes + 1

__global__ void distribute_count_kernel(const uint32_t* keys, int lanes, int n,
                                        int n_valid, int nb, int* dest,
                                        int* rank, int* block_hist) {
  __shared__ int warp_hist[MAX_WARPS][MAX_BUCKETS];
  int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int b = lane; b < nb; b += 32) warp_hist[warp][b] = 0;
  __syncwarp();
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int len = -1;  // past the end of the array: no bucket
  if (i < n_valid) {
    len = 0;
    const uint32_t* w = keys + i * lanes;
    for (int l = 0; l < lanes; ++l) {
      uint32_t v = w[l];
      if (v) len = 4 * l + 4 - ((__ffs((int)v) - 1) >> 3);
    }
  } else if (i < n) {
    len = nb;  // padding: the discard id
  }
  unsigned peers = __match_any_sync(0xffffffffu, len);
  int in_warp = __popc(peers & ((1u << lane) - 1u));
  if (len >= 0 && len < nb && in_warp == 0) warp_hist[warp][len] = __popc(peers);
  __syncthreads();
  int n_warps = blockDim.x >> 5;
  for (int b = threadIdx.x; b < nb; b += blockDim.x) {
    int run = 0;
    for (int v = 0; v < n_warps; ++v) {
      int c = warp_hist[v][b];
      warp_hist[v][b] = run;
      run += c;
    }
    block_hist[(size_t)blockIdx.x * nb + b] = run;
  }
  __syncthreads();
  if (i < n) {
    dest[i] = len;
    rank[i] = len < nb ? warp_hist[warp][len] + in_warp : 0;
  }
}

__global__ void distribute_scan_kernel(int* block_hist, int n_blocks, int nb,
                                       int* counts) {
  int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int n_warps = blockDim.x >> 5;
  for (int b = warp; b < nb; b += n_warps) {
    int carry = 0;
    for (int base = 0; base < n_blocks; base += 32) {
      int k = base + lane;
      int v = k < n_blocks ? block_hist[(size_t)k * nb + b] : 0;
      int inc = v;
      for (int d = 1; d < 32; d <<= 1) {
        int t = __shfl_up_sync(0xffffffffu, inc, d);
        if (lane >= d) inc += t;
      }
      if (k < n_blocks) block_hist[(size_t)k * nb + b] = carry + inc - v;
      carry += __shfl_sync(0xffffffffu, inc, 31);
    }
    if (lane == 0) counts[b] = carry;
  }
}

__global__ void distribute_offset_kernel(int n, int nb, const int* dest,
                                         int* rank, const int* block_off) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    int d = dest[i];
    if (d < nb) rank[i] += block_off[(size_t)blockIdx.x * nb + d];
  }
}

// keys: (n, lanes) packed words, row-major. Out: dest (n,), rank (n,),
// counts (nb,), nb = 4 * lanes + 1. block_hist: scratch of
// ceil(n / tile) * nb ints. tile: words per block, whole warps, <= 1024.
extern "C" int distribute_rows(const void* keys, int lanes, int n, int n_valid,
                               int nb, int tile, void* dest, void* rank,
                               void* counts, void* block_hist, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (nb != 4 * lanes + 1 || nb > MAX_BUCKETS || tile % 32 || tile < 32 ||
      tile > 32 * MAX_WARPS || n_valid > n)
    return cudaErrorInvalidValue;
  if (n == 0) {
    cudaMemsetAsync(counts, 0, (size_t)nb * sizeof(int), s);
    return cudaGetLastError();
  }
  int n_blocks = (n + tile - 1) / tile;
  distribute_count_kernel<<<n_blocks, tile, 0, s>>>(
      (const uint32_t*)keys, lanes, n, n_valid, nb, (int*)dest, (int*)rank,
      (int*)block_hist);
  int scan_threads = 32 * (nb < MAX_WARPS ? nb : MAX_WARPS);
  distribute_scan_kernel<<<1, scan_threads, 0, s>>>((int*)block_hist, n_blocks,
                                                   nb, (int*)counts);
  distribute_offset_kernel<<<n_blocks, tile, 0, s>>>(
      n, nb, (const int*)dest, (int*)rank, (const int*)block_hist);
  return cudaGetLastError();
}
