// B4: merge of adjacent sorted blocks — blocksort's cross-block round.
//
// Replaces repro/kernels/merge_kernel.py:74 (merge_rows_lex_kernel, with
// _merge_network :43): each grid step merges one pair of adjacent sorted
// B-blocks in VMEM with a reflected compare-exchange (partner 2B-1-i) and
// log2(B) XOR stages, leaving the low half left and the high half right.
//
// Here one block merges one pair, in place, at any column offset `lo` of
// the row: the reference slices the odd rounds out and concatenates the
// untouched edge blocks back (blocksort.py:90-112); the port launches on the
// same tensor at lo = B and writes only the merged windows. The whole 2B
// window of every array sits in shared memory, which sets blocksort's block
// cap: 2 B x arrays x 4 B <= 227 KB, so B = 4096 at four lanes and a
// payload (160 KB). The pairs and the strict compare are those of the
// Pallas kernel, so the result is the same bit for bit.
//
// What bounds it on the H100: each window is read once and written once, so
// the least time is the bytes over 3.35 TB/s; log2(2B) steps of B compares
// stay below the compute peak. One block per pair with a barrier per step;
// staging the window with TMA and merging in registers is later work.
#include "common.cuh"

__global__ void merge_pairs_kernel(uint32_t* x, int n_arr, int rows, int ncols,
                                   int lo, int npairs, int block,
                                   uint32_t codes) {
  extern __shared__ uint32_t smem[];
  int width = 2 * block;
  Window w{smem, width, n_arr, codes};
  size_t lane_stride = (size_t)rows * ncols;
  int r = blockIdx.x / npairs, pair = blockIdx.x % npairs;
  size_t start = (size_t)r * ncols + lo + (size_t)pair * width;
  w.load(x, lane_stride, start);
  __syncthreads();
  merge_halves(w, block);
  w.store(x, lane_stride, start);
}

// Merge, in place, the `npairs` pairs of sorted `block`-wide blocks that
// start at column `lo` of every row of the stacked (n_arr, rows, ncols) lane
// tensor `x`.
extern "C" int merge_adjacent_lex(void* x, int n_arr, int rows, int ncols,
                                  int lo, int npairs, int block,
                                  unsigned codes, void* stream) {
  if (rows == 0 || npairs == 0) return cudaSuccess;
  if (block < 1 || (block & (block - 1)) ||
      lo + (long long)npairs * 2 * block > ncols)
    return cudaErrorInvalidValue;
  size_t smem = (size_t)n_arr * 2 * block * sizeof(uint32_t);
  cudaError_t err = allow_smem(merge_pairs_kernel, smem);
  if (err != cudaSuccess) return err;
  merge_pairs_kernel<<<(unsigned)rows * npairs, threads_for(block), smem,
                       (cudaStream_t)stream>>>((uint32_t*)x, n_arr, rows, ncols,
                                               lo, npairs, block, codes);
  return cudaGetLastError();
}
