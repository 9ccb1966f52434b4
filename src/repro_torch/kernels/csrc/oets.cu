// B1: odd-even transposition sort of every row — the paper's parallel
// bubble sort.
//
// Replaces repro/kernels/oets_kernel.py:38 (oets_rows_lex_kernel): there a
// (8, C) VMEM block sorts along vector lanes, one phase being two lane rolls,
// a full-tuple compare and selects, C phases in a fori_loop.
//
// Phase p compare-exchanges the pairs (i, i + 1) with i = p mod 2 and
// i + 1 < C, C phases, with the strict compare: the pairs, the phases and
// the compare are the Pallas kernel's, so the result is the same bit for
// bit, float ties included (and, the swaps being adjacent and strict, it is
// the stable sort).
//
// What bounds it on the H100: the row is read once and written once, so the
// least time is its bytes over 3.35 TB/s; the C phases of C/2 compares are
// far below the compute peak at the main path's C = 128. What sets its time
// is the chain of C dependent phases, so the design keeps that chain short:
//  - rows of at most 128 columns (every row the OETS tier sends:
//    ops.choose_plan pads its rows to exactly 128) run one warp a row, four
//    rows a block, with no barrier and no shared memory. Lane t holds
//    columns 4t .. 4t + 3 in registers (their raw bits and, with a float
//    lane, their order keys beside them, computed once, as in network.cuh).
//    An even phase compare-exchanges (4t, 4t + 1) and (4t + 2, 4t + 3)
//    inside the thread; an odd phase (4t + 1, 4t + 2) inside it and
//    (4t + 3, 4t + 4) across lanes: lane t receives lane t + 1's first
//    element by __shfl_down_sync and lane t + 1 lane t's last by
//    __shfl_up_sync, and both evaluate the same strict compare on the same
//    operands, one keeping the smaller, the other the larger. A block's
//    last warps with no row leave as whole warps, so every shuffle stays
//    full-mask, and whether a pair lies in the row is folded into the
//    swap's predicate, so no branch sits between the shuffles (a branch
//    there cost the first design 1.8x). The compare is network.cuh's
//    borrow chain (lex_less), faster here than its paired 64-bit compare;
//  - wider rows come only from an explicit algorithm='oets' (sort_rows,
//    sort_rows_lex). They keep the kernel of the port's first slice: one
//    block a row in shared memory, each phase ended by a __syncthreads.
#include "network.cuh"

#define OETS_E 4
#define OETS_WARP_COLS (32 * OETS_E)
#define OETS_WARP_ROWS 4  // rows (warps) a block of the warp kernel

// B2's shape: keys beside the raw bits with a float lane, the borrow compare
template <int NA, bool FL>
struct OetsShape : NetShape<NA, FL> {
  static constexpr bool BORROW = true;
};

// Rows of `cols` <= OETS_WARP_COLS columns, one warp a row, in registers.
template <int NA, bool FL>
__global__ void __launch_bounds__(32 * OETS_WARP_ROWS)
oets_warp_kernel(uint32_t* x, int rows, int cols, uint32_t fmask,
                 uint32_t smask) {
  using S = OetsShape<NA, FL>;
  constexpr int E = OETS_E, NW = S::NW;
  const int row = blockIdx.x * OETS_WARP_ROWS + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  const int c0 = lane * E;  // the column of the lane's first element
  const int n = cols - c0 <= 0 ? 0 : (cols - c0 < E ? cols - c0 : E);
  const size_t stride = (size_t)rows * cols;
  const size_t at = (size_t)row * cols + (n ? c0 : 0);
  uint32_t v[NW][E];
  global_to_regs<S, E>(x, stride, at, n, v, fmask, smask);
  // the pairs (c, c + 1) that lie in the row
  const bool p01 = c0 + 1 < cols, p12 = c0 + 2 < cols, p23 = c0 + 3 < cols;
  const bool up = c0 + 4 < cols;             // (c0 + 3, c0 + 4)
  const bool down = lane > 0 && c0 < cols;  // (c0 - 1, c0)
  for (int p = 0; p < cols; p += 2) {
    cmpx_slots<S, E>(v, 0, 1, true, p01);
    cmpx_slots<S, E>(v, 2, 3, true, p23);
    if (p + 1 == cols) break;  // the same in every lane
    cmpx_slots<S, E>(v, 1, 2, true, p12);
    uint32_t next[NW], prev[NW];
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      next[w] = __shfl_down_sync(0xffffffffu, v[w][0], 1);
      prev[w] = __shfl_up_sync(0xffffffffu, v[w][E - 1], 1);
    }
    exchange<S, E>(v, E - 1, next, true, up);
    exchange<S, E>(v, 0, prev, false, down);
  }
  regs_to_global<S, E>(x, stride, at, n, v, smask);
}

// Wider rows: one block a row, the row's arrays in shared memory (arrays x
// cols x 4 bytes), phase p's pairs shared among the threads, a
// __syncthreads ending each phase.
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

template <bool FL>
static cudaError_t oets_warp_launch(uint32_t* x, int n_arr, int rows,
                                    int cols, uint32_t fmask, uint32_t smask,
                                    cudaStream_t s) {
  const int grid = (rows + OETS_WARP_ROWS - 1) / OETS_WARP_ROWS;
  const int threads = 32 * OETS_WARP_ROWS;
#define OETS_CASE(NA)                                                  \
  case NA:                                                             \
    oets_warp_kernel<NA, FL><<<grid, threads, 0, s>>>(x, rows, cols,   \
                                                      fmask, smask);   \
    break;
  switch (n_arr) {
    OETS_CASE(1) OETS_CASE(2) OETS_CASE(3) OETS_CASE(4) OETS_CASE(5)
    OETS_CASE(6) OETS_CASE(7) OETS_CASE(8)
    default:
      oets_warp_kernel<9, FL><<<grid, threads, 0, s>>>(x, rows, cols, fmask,
                                                       smask);
  }
#undef OETS_CASE
  return cudaGetLastError();
}

// Sort each row of the stacked (n_arr, rows, cols) lane tensor `x` in place.
extern "C" int oets_rows_lex(void* x, int n_arr, int rows, int cols,
                             unsigned codes, void* stream) {
  if (rows == 0 || cols == 0) return cudaSuccess;
  if (n_arr < 1 || n_arr > MAX_ARRAYS) return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  uint32_t* p = (uint32_t*)x;
  if (cols <= OETS_WARP_COLS) {
    uint32_t fmask, smask;
    lane_masks(codes, n_arr, fmask, smask);
    return fmask ? oets_warp_launch<true>(p, n_arr, rows, cols, fmask, smask, s)
                 : oets_warp_launch<false>(p, n_arr, rows, cols, fmask, smask,
                                           s);
  }
  size_t smem = (size_t)n_arr * cols * sizeof(uint32_t);
  cudaError_t err = allow_smem(oets_rows_kernel, smem);
  if (err != cudaSuccess) return err;
  oets_rows_kernel<<<rows, threads_for(cols / 2), smem, s>>>(p, n_arr, rows,
                                                             cols, codes);
  return cudaGetLastError();
}
