// B1: odd-even transposition sort of every row — the paper's parallel
// bubble sort.
//
// Replaces repro/kernels/oets_kernel.py:38 (oets_rows_lex_kernel): there a
// (8, C) VMEM block sorts along vector lanes, one phase being two lane rolls,
// a full-tuple compare and selects, C phases in a fori_loop.
//
// Here one block sorts one row in place. The row's arrays sit in shared
// memory (arrays x cols x 4 bytes); phase p compare-exchanges the pairs
// (i, i+1) with i = p mod 2, each thread taking some pairs, and a
// __syncthreads ends the phase. The pairs and the strict compare are those
// of the Pallas kernel, so the result is the same bit for bit, float ties
// included.
//
// What bounds it on the H100: the row is read once and written once, so the
// least time is its bytes over 3.35 TB/s; the C phases of C/2 compares are
// far below the compute peak at the main path's C = 128. In fact it is
// bounded by the phases' latency: one block per row, C barriers, and few
// rows (17 buckets) to fill 132 SMs. Keeping the row in registers and
// swapping through __shfl_sync is later work.
#include "common.cuh"

__global__ void oets_rows_kernel(uint32_t* x, int n_arr, int rows, int cols,
                                 uint32_t codes) {
  extern __shared__ uint32_t smem[];
  Window w{smem, cols, n_arr, codes};
  size_t lane_stride = (size_t)rows * cols;
  size_t row = (size_t)blockIdx.x * cols;
  w.load(x, lane_stride, row);
  __syncthreads();
  int half = cols / 2;
  for (int p = 0; p < cols; ++p) {
    int parity = p & 1;
    for (int k = threadIdx.x; k < half; k += blockDim.x) {
      int i = 2 * k + parity;
      if (i + 1 < cols) w.cmpx(i, i + 1);
    }
    __syncthreads();
  }
  w.store(x, lane_stride, row);
}

// Sort each row of the stacked (n_arr, rows, cols) lane tensor `x` in place.
extern "C" int oets_rows_lex(void* x, int n_arr, int rows, int cols,
                             unsigned codes, void* stream) {
  if (rows == 0 || cols == 0) return cudaSuccess;
  size_t smem = (size_t)n_arr * cols * sizeof(uint32_t);
  cudaError_t err = allow_smem(oets_rows_kernel, smem);
  if (err != cudaSuccess) return err;
  oets_rows_kernel<<<rows, threads_for(cols / 2), smem, (cudaStream_t)stream>>>(
      (uint32_t*)x, n_arr, rows, cols, codes);
  return cudaGetLastError();
}
