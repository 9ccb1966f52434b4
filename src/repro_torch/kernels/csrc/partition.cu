// B7: splitter partition — each key's bucket id, the count of splitters at
// or below it, and every row's bucket histogram.
//
// Replaces repro/kernels/partition_kernel.py:24 (partition_rows_kernel).
// There a block of 8 rows sits in VMEM, the splitters padded to 128 lanes;
// the id is S broadcast compare-accumulates over the block and the
// histogram S + 1 masked sums along the lanes, and the wrapper pads the
// columns to 128 and takes the padding back out of the top bucket.
//
// Here nothing is padded. A row is cut into column ranges, one CTA each.
// The CTA stages the splitters once into shared memory, where every thread
// reads the same word at once (a broadcast), and keeps a histogram of
// S + 1 bins beside them. Each thread takes four columns of its range at a
// time (coalesced loads, four compares per splitter read), counts the
// splitters at or below each key as the TPU kernel does, one compare per
// splitter, and writes the ids. The lanes of a warp with the same id add to the shared histogram
// once (__match_any_sync, the leader adds the popcount); at the end the CTA
// adds each non-zero bin to the zeroed (rows, S + 1) output with one global
// atomicAdd. Integer addition is exact and order-free, so the counts are the
// same on every run.
//
// What bounds it on the H100: S compares and adds per key against 8 bytes
// read and written per key, so past a few splitters the integer issue
// rate, not memory: at 127 splitters one key costs some 250 instructions.
// The count does not depend on the splitters' order, so a binary search
// over the splitters sorted once (duplicates kept, as upper_bound keeps
// them) gives the same ids for any splitter list in ceil(log2(S + 1))
// compares a key, under which the bytes set the bound; it is later work.
#include "common.cuh"

#define PART_THREADS 256
#define PART_ILP 4
// CTAs to aim for: two per SM of the H100's 132
#define PART_TARGET_CTAS 264

__global__ void partition_kernel(const int* x, const int* spl, int* bid,
                                 int* counts, int cols, int n_spl,
                                 int per_row, long long chunk) {
  extern __shared__ int smem[];
  int* s_spl = smem;
  int* s_hist = smem + n_spl;
  for (int i = threadIdx.x; i < n_spl; i += blockDim.x) s_spl[i] = spl[i];
  for (int i = threadIdx.x; i <= n_spl; i += blockDim.x) s_hist[i] = 0;
  __syncthreads();
  long long row = blockIdx.x / per_row;
  long long start = (blockIdx.x % per_row) * chunk;
  long long end = min(start + chunk, (long long)cols);
  const int* xr = x + row * cols;
  int* br = bid + row * cols;
  int lane = threadIdx.x & 31;
  // every thread of the block runs the same number of rounds, so each warp
  // is whole at __match_any_sync
  for (long long base = start; base < end;
       base += (long long)PART_ILP * blockDim.x) {
    int v[PART_ILP], b[PART_ILP];
#pragma unroll
    for (int k = 0; k < PART_ILP; ++k) {
      long long i = base + k * blockDim.x + threadIdx.x;
      v[k] = i < end ? xr[i] : 0;
      b[k] = 0;
    }
    for (int j = 0; j < n_spl; ++j) {
      int s = s_spl[j];
#pragma unroll
      for (int k = 0; k < PART_ILP; ++k) b[k] += v[k] >= s;
    }
#pragma unroll
    for (int k = 0; k < PART_ILP; ++k) {
      long long i = base + k * blockDim.x + threadIdx.x;
      bool valid = i < end;
      if (valid) br[i] = b[k];
      unsigned peers = __match_any_sync(0xffffffffu, valid ? b[k] : -1);
      if (valid && lane == __ffs(peers) - 1) atomicAdd(&s_hist[b[k]], __popc(peers));
    }
  }
  __syncthreads();
  int* cr = counts + row * (n_spl + 1);
  for (int i = threadIdx.x; i <= n_spl; i += blockDim.x) {
    int h = s_hist[i];
    if (h) atomicAdd(&cr[i], h);
  }
}

// Bucket ids (rows, cols) of int32 keys `x` (rows, cols) against int32
// splitters `spl` (n_spl,), and their histograms added into `counts`
// (rows, n_spl + 1), which the caller zeroes.
extern "C" int partition_rows(const void* x, const void* spl, void* bid,
                              void* counts, int rows, int cols, int n_spl,
                              void* stream) {
  if (rows == 0 || cols == 0) return cudaSuccess;
  size_t smem = (size_t)(2 * n_spl + 1) * sizeof(int);
  cudaError_t err = allow_smem(partition_kernel, smem);
  if (err != cudaSuccess) return err;
  long long min_chunk = (long long)PART_ILP * PART_THREADS;
  long long most = (cols + min_chunk - 1) / min_chunk;
  long long per_row = (PART_TARGET_CTAS + rows - 1) / rows;
  if (per_row > most) per_row = most;
  if ((long long)rows * per_row > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  long long chunk = (cols + per_row - 1) / per_row;
  partition_kernel<<<(unsigned)(rows * per_row), PART_THREADS, smem,
                     (cudaStream_t)stream>>>(
      (const int*)x, (const int*)spl, (int*)bid, (int*)counts, cols, n_spl,
      (int)per_row, chunk);
  return cudaGetLastError();
}
