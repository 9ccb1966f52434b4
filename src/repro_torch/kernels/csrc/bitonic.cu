// B2: bitonic sorting network over every row.
//
// Replaces repro/kernels/bitonic_kernel.py:64 (bitonic_rows_lex_kernel, with
// _network :53 and _stage :34): there each stage builds the XOR partner from
// two lane rolls and a bit select, with the direction from col & 2^stage.
//
// Here the network is the reference's pair for pair: merge step kk = 2, 4,
// ..., cols, and in it the stages j = kk / 2, ..., 1 compare-exchange
// (i, i ^ j), ascending where i & kk is 0 and descending elsewhere, with the
// strict compare, so the result is the same bit for bit, float ties
// included. It is the bitonic tier (cols up to 1024) and blocksort's local
// sort (cols = the block, up to 4096 at four lanes: 64 KB of shared memory a
// row, opted in above the 48 KB default).
//
// What bounds it on the H100: each row is read once and written once, so the
// least time is its bytes over 3.35 TB/s; but the network has
// log2(C)(log2(C)+1)/2 stages (78 at C = 4096), each a compare and a select
// of every word of every element, integer instructions, so it is bound by
// the integer pipe, as B4 is by its instruction rate. The design is B4's
// (network.cuh), over the whole sort:
//  - each thread holds E = 4 consecutive elements (16-byte global and shared
//    accesses); stages with j < E run inside the thread, those with
//    E <= j < SPAN across a group of LANES lanes by __shfl_xor_sync, each
//    element's direction from its column; the first log2(SPAN) merge steps
//    (15 stages at SPAN = 32) run straight from device memory with no
//    barrier;
//  - stages with j >= SPAN run in shared memory, two per pass and one
//    barrier a pass: at C = 4096 and four integer lanes, 28 stages in 16
//    passes and 7 register phases, where one stage per barrier took 78;
//  - rows of at most 32 x E columns never touch shared memory: a warp holds
//    whole rows, and every stage is a shuffle or inside the thread;
//  - the compare is the borrow of a multiword subtraction (lex_less), NA + 1
//    instructions, and every thread runs the same number of chunks, so no
//    shuffle sits in code the compiler must treat as divergent.
// One block per row: a row's window is the unit of shared memory, so 204
// rows on 132 SMs leave the busiest SMs two rows; splitting a row across a
// cluster is not done.
#include "network.cuh"

// The register-only kernel, for rows of at most 32 x REG_E columns
#define BITONIC_REG_THREADS 256
#define REG_E 4

// B4's shape with the borrow compare (lex_less): the network's compares
// and selects, on the integer pipe, set the sort's time
template <int NA, bool FL>
struct BitonicShape : NetShape<NA, FL> {
  static constexpr bool BORROW = true;
};

// One block per row of `cols` > 32 x REG_E columns, the row in shared memory
// between the register phases: array a's element i at smem[a * cols + i].
template <int NA, bool FL>
__global__ void __launch_bounds__(BitonicShape<NA, FL>::MAXT)
bitonic_window_kernel(uint32_t* x, int rows, int cols, uint32_t fmask,
                      uint32_t smask) {
  using S = BitonicShape<NA, FL>;
  constexpr int E = S::E, SPAN = S::SPAN;
  extern __shared__ __align__(16) uint32_t smem[];
  const int tid = threadIdx.x, T = blockDim.x, lane = tid & 31;
  const size_t lane_stride = (size_t)rows * cols;
  const size_t start = (size_t)blockIdx.x * cols;
  // thread t takes the E elements from c E, for c = t, t + T, ...: T is a
  // power of two of at least 32 and divides cols / E, so every thread takes
  // `reps` of them and every warp is whole (a trip count the same in every
  // thread keeps the shuffles out of divergent code)
  const int reps = cols / E / T;
  // the merge steps kk <= SPAN, from device memory, in registers
  for (int r = 0; r < reps; ++r) {
    const int off = (tid + r * T) * E;
    uint32_t v[S::NW][E];
    global_to_regs<S, E>(x, lane_stride, start + off, E, v, fmask, smask);
#pragma unroll
    for (int kk = 2; kk <= SPAN; kk <<= 1)
      warp_stages<S, E, S::LANES>(v, kk, off, kk, lane, 0xffffffffu);
    regs_to_smem<S, E>(smem, cols, off, v);
  }
  // every later step: its stages j >= SPAN in shared memory, then the rest
  // in registers, the last step's results straight to device memory
  for (int kk = 2 * SPAN; kk <= cols; kk <<= 1) {
    smem_stages<S>(smem, cols, kk >> 1, kk, fmask);
    for (int r = 0; r < reps; ++r) {
      const int off = (tid + r * T) * E;
      uint32_t v[S::NW][E];
      smem_to_regs<S, E>(smem, cols, off, v, fmask);
      warp_stages<S, E, S::LANES>(v, SPAN, off, kk, lane, 0xffffffffu);
      if (kk == cols)
        regs_to_global<S, E>(x, lane_stride, start + off, E, v, smask);
      else
        regs_to_smem<S, E>(smem, cols, off, v);
    }
  }
}

// Rows of `cols` <= 32 x REG_E columns, all in registers: the rows lie end
// to end, each block takes BITONIC_REG_THREADS x REG_E consecutive elements
// of them, each thread REG_E, a warp whole rows (or, below REG_E columns, a
// thread whole rows).
template <int NA, bool FL>
__global__ void __launch_bounds__(BITONIC_REG_THREADS)
bitonic_regs_kernel(uint32_t* x, int rows, int cols, uint32_t fmask,
                    uint32_t smask) {
  using S = BitonicShape<NA, FL>;
  constexpr int E = REG_E;
  const long long total = (long long)rows * cols;
  const long long o =
      ((long long)blockIdx.x * BITONIC_REG_THREADS + threadIdx.x) * E;
  const long long left = total - o;
  // past the end a thread holds whole rows of zeros: they are not stored
  const int n = left <= 0 ? 0 : (left < E ? (int)left : E);
  const size_t base = o < total ? (size_t)o : 0;
  const int lane = threadIdx.x & 31;
  // the column of the thread's first element; the last step ascends
  // everywhere, and there i & cols would read the row's bit, so kk = 0
  const int off = (int)(o & (cols - 1));
  uint32_t v[S::NW][E];
  global_to_regs<S, E>(x, (size_t)total, base, n, v, fmask, smask);
#pragma unroll
  for (int kk = 2; kk <= 32 * E; kk <<= 1) {
    if (kk > cols) break;
    warp_stages<S, E, 32>(v, kk, off, kk == cols ? 0 : kk, lane,
                          0xffffffffu);
  }
  regs_to_global<S, E>(x, (size_t)total, base, n, v, smask);
}

template <int NA, bool FL>
static cudaError_t bitonic_launch(uint32_t* x, int rows, int cols,
                                  uint32_t fmask, uint32_t smask,
                                  cudaStream_t stream) {
  using S = BitonicShape<NA, FL>;
  static_assert(S::SPAN <= 32 * REG_E, "every wider row needs the window "
                "kernel, whose shared-memory stages reach down to SPAN");
  if (cols > 32 * REG_E) {
    size_t smem = (size_t)NA * cols * sizeof(uint32_t);
    cudaError_t err = allow_smem(bitonic_window_kernel<NA, FL>, smem);
    if (err != cudaSuccess) return err;
    int threads = cols / S::E < S::MAXT ? cols / S::E : S::MAXT;
    bitonic_window_kernel<NA, FL><<<rows, threads, smem, stream>>>(
        x, rows, cols, fmask, smask);
  } else {
    long long per = (long long)BITONIC_REG_THREADS * REG_E;
    long long grid = ((long long)rows * cols + per - 1) / per;
    if (grid > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
    bitonic_regs_kernel<NA, FL><<<(unsigned)grid, BITONIC_REG_THREADS, 0,
                                  stream>>>(x, rows, cols, fmask, smask);
  }
  return cudaGetLastError();
}

template <bool FL>
static cudaError_t bitonic_dispatch(uint32_t* p, int n_arr, int rows,
                                    int cols, uint32_t fmask, uint32_t smask,
                                    cudaStream_t s) {
#define BITONIC_CASE(NA) \
  case NA: return bitonic_launch<NA, FL>(p, rows, cols, fmask, smask, s);
  switch (n_arr) {
    BITONIC_CASE(1) BITONIC_CASE(2) BITONIC_CASE(3) BITONIC_CASE(4)
    BITONIC_CASE(5) BITONIC_CASE(6) BITONIC_CASE(7) BITONIC_CASE(8)
    default: return bitonic_launch<9, FL>(p, rows, cols, fmask, smask, s);
  }
#undef BITONIC_CASE
}

// Sort each row of the stacked (n_arr, rows, cols) lane tensor `x` in place;
// cols is a power of two.
extern "C" int bitonic_rows_lex(void* x, int n_arr, int rows, int cols,
                                unsigned codes, void* stream) {
  if (rows == 0 || cols == 0) return cudaSuccess;
  if ((cols & (cols - 1)) || n_arr < 1 || n_arr > MAX_ARRAYS)
    return cudaErrorInvalidValue;
  uint32_t fmask, smask;
  lane_masks(codes, n_arr, fmask, smask);
  uint32_t* p = (uint32_t*)x;
  cudaStream_t s = (cudaStream_t)stream;
  return fmask ? bitonic_dispatch<true>(p, n_arr, rows, cols, fmask, smask, s)
               : bitonic_dispatch<false>(p, n_arr, rows, cols, fmask, smask,
                                         s);
}
