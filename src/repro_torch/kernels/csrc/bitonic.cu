// B2: bitonic sorting network over every row.
//
// Replaces repro/kernels/bitonic_kernel.py:64 (bitonic_rows_lex_kernel, with
// _network :53 and _stage :34): there each stage builds the XOR partner from
// two lane rolls and a bit select, with the direction from col & 2^stage.
//
// Here one block sorts one row (cols a power of two) in place, the row's
// arrays in shared memory. Each step compare-exchanges the pairs (i, i ^ j)
// with bit j of i unset, ascending where i & 2^stage is 0 and descending
// elsewhere; a __syncthreads ends the step. The pairs, the directions and
// the strict compare are those of the Pallas kernel, so the result is the
// same bit for bit, float ties included. It is the bitonic tier (cols up to
// 1024) and blocksort's local sort (cols = the block, up to 4096 at four
// lanes and a payload: 4096 x 5 x 4 B = 80 KB, above the 48 KB default, so
// the launch opts in to more dynamic shared memory).
//
// What bounds it on the H100: each row is read once and written once, so the
// least time is its bytes over 3.35 TB/s; log2(C)(log2(C)+1)/2 steps of C/2
// compares stay below the compute peak. One block per row with a barrier per
// step; partners below 32 through __shfl_xor_sync are later work.
#include "common.cuh"

__global__ void bitonic_rows_kernel(uint32_t* x, int n_arr, int rows, int cols,
                                    uint32_t codes) {
  extern __shared__ uint32_t smem[];
  Window w{smem, cols, n_arr, codes};
  size_t lane_stride = (size_t)rows * cols;
  size_t row = (size_t)blockIdx.x * cols;
  w.load(x, lane_stride, row);
  __syncthreads();
  sort_window(w, cols);
  w.store(x, lane_stride, row);
}

// Sort each row of the stacked (n_arr, rows, cols) lane tensor `x` in place;
// cols is a power of two.
extern "C" int bitonic_rows_lex(void* x, int n_arr, int rows, int cols,
                                unsigned codes, void* stream) {
  if (rows == 0 || cols == 0) return cudaSuccess;
  if (cols & (cols - 1)) return cudaErrorInvalidValue;
  size_t smem = (size_t)n_arr * cols * sizeof(uint32_t);
  cudaError_t err = allow_smem(bitonic_rows_kernel, smem);
  if (err != cudaSuccess) return err;
  bitonic_rows_kernel<<<rows, threads_for(cols / 2), smem,
                        (cudaStream_t)stream>>>((uint32_t*)x, n_arr, rows, cols,
                                                codes);
  return cudaGetLastError();
}
