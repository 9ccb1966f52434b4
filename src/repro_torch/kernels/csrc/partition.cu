// B7: splitter partition — each key's bucket id, the count of splitters at
// or below it, and every row's bucket histogram.
//
// Replaces repro/kernels/partition_kernel.py:24 (partition_rows_kernel).
// There a block of 8 rows sits in VMEM, the splitters padded to 128 lanes;
// the id is S broadcast compare-accumulates over the block and the
// histogram S + 1 masked sums along the lanes, and the wrapper pads the
// columns to 128 and takes the padding back out of the top bucket.
//
// What bounds it on the H100: 8 bytes a key, the key read and its id
// written, so the bytes over 3.35 TB/s; the TPU kernel's S compares a key
// would make it bound by the integer issue rate past a few splitters. The
// count of splitters at or below a key does not depend on their order, so:
//  - A one-block pre-pass sorts the S splitters into a scratch array — by
//    rank up to 256 of them, else bitonic in shared memory, padded to a
//    power of two with INT32_MAX, which sorts last — and zeroes the
//    (rows, S + 1) counts, every block of its grid helping.
//  - The partition kernel stages the sorted splitters in shared memory and
//    takes each key's id as its upper bound over them: a branch-free binary
//    search of ceil(log2(S + 1)) steps, the same for every key, so a warp
//    stays in step. Duplicated splitters count as often as they appear, as
//    in the TPU kernel's count, and no step reads past the S splitters.
//    A padding word after every 32 splitters (where it fits) puts the
//    search's reads at strides of 32 splitters or more in different banks.
//  - Nothing is padded. A row is cut into column ranges, one block each;
//    keys and ids move as 16-byte vectors where the row's range is aligned,
//    with a scalar head and tail.
//  - The histogram: per-warp sub-histograms in shared memory (as many
//    copies as fit beside the splitters), each key one shared atomicAdd;
//    this measured faster on the H100 than one histogram with the warp's
//    lanes of the same id added once (__match_any_sync and a leader's add).
//    At the end a block adds each non-zero bin to the zeroed output with
//    one global atomicAdd; integer addition is exact and order-free, so the
//    counts are the same on every run.
#include <climits>

#include "common.cuh"

#define PART_THREADS 256
// CTAs to aim for: two per SM of the H100's 132
#define PART_TARGET_CTAS 264
#define PREP_THREADS 1024
// the most splitters the pre-pass sorts by rank, one a thread, each
// counting all the others: one barrier, where the bitonic sort takes one a
// stage (on the H100 the pre-pass took 0.0016 ms against 0.0024 at 7
// splitters, 0.0031 against 0.0049 at 127; PERF.md, Findings)
#define RANK_SORT_MAX 256

// Block 0 sorts the splitters ascending (signed) into `sorted`; every block
// zeroes its share of the `n_counts` counts. Up to RANK_SORT_MAX
// splitters by rank (the splitters below each, and the equal ones before
// it: a permutation); past that a bitonic sort in shared memory.
__global__ void partition_prep_kernel(const int* spl, int* sorted, int n_spl,
                                      int* counts, long long n_counts) {
  extern __shared__ int s_sort[];
  if (blockIdx.x == 0 && n_spl > 0 && n_spl <= RANK_SORT_MAX) {
    const int t = threadIdx.x;
    int mine = 0;
    if (t < n_spl) s_sort[t] = mine = spl[t];
    __syncthreads();
    if (t < n_spl) {
      int rank = 0;
      for (int j = 0; j < n_spl; ++j) {
        int o = s_sort[j];
        rank += (o < mine) || (o == mine && j < t);
      }
      sorted[rank] = mine;
    }
  } else if (blockIdx.x == 0 && n_spl > 0) {
    int p = 1;
    while (p < n_spl) p <<= 1;
    for (int i = threadIdx.x; i < p; i += blockDim.x)
      s_sort[i] = i < n_spl ? spl[i] : INT_MAX;
    __syncthreads();
    for (int kk = 2; kk <= p; kk <<= 1) {
      for (int j = kk >> 1; j > 0; j >>= 1) {
        for (int k = threadIdx.x; k < p / 2; k += blockDim.x) {
          int i = 2 * k - (k & (j - 1));  // the k-th index with bit j unset
          int a = s_sort[i], b = s_sort[i + j];
          bool asc = (i & kk) == 0;
          if ((a > b) == asc) {
            s_sort[i] = b;
            s_sort[i + j] = a;
          }
        }
        __syncthreads();
      }
    }
    for (int i = threadIdx.x; i < n_spl; i += blockDim.x) sorted[i] = s_sort[i];
  }
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_counts; i += (long long)gridDim.x * blockDim.x)
    counts[i] = 0;
}

// one step of the binary search for the count of the `n_spl` sorted
// splitters s[] at or below `key` (their upper bound): `pos` moves up by
// `step` if the splitter `step` places on is at or below the key. No step
// reads past the splitters.
__device__ __forceinline__ int search_step(const int* s, int n_spl, int sh,
                                           int step, int pos, int key) {
  int nxt = pos + step;
  int i = (nxt < n_spl ? nxt : n_spl) - 1;
  int v = s[i + (i >> sh)];
  return (nxt <= n_spl && v <= key) ? nxt : pos;
}

// the count for one key: `top` is the largest power of two <= n_spl, 0 for
// none, so every key takes ceil(log2(n_spl + 1)) steps
__device__ __forceinline__ int count_at_or_below(const int* s, int n_spl,
                                                 int sh, int top, int key) {
  int pos = 0;
  for (int step = top; step > 0; step >>= 1)
    pos = search_step(s, n_spl, sh, step, pos, key);
  return pos;
}

// four keys at once, their steps interleaved
__device__ __forceinline__ int4 count4_at_or_below(const int* s, int n_spl,
                                                   int sh, int top, int4 k) {
  int4 pos = make_int4(0, 0, 0, 0);
  for (int step = top; step > 0; step >>= 1) {
    pos.x = search_step(s, n_spl, sh, step, pos.x, k.x);
    pos.y = search_step(s, n_spl, sh, step, pos.y, k.y);
    pos.z = search_step(s, n_spl, sh, step, pos.z, k.z);
    pos.w = search_step(s, n_spl, sh, step, pos.w, k.w);
  }
  return pos;
}

// The sorted splitters in shared memory, splitter i at i + (i >> sh): with
// sh = 5 a padding word after every 32, so the search's reads at strides of
// 32 or more splitters fall in different banks (sh = 31: no padding, where
// it would not fit). Then `n_hist` sub-histograms of S + 1 bins; warp w
// adds to copy w % n_hist.
__global__ void __launch_bounds__(PART_THREADS)
partition_kernel(const int* x, const int* sorted, int* bid, int* counts,
                 int cols, int n_spl, int top, int per_row, long long chunk,
                 int n_hist, int vec, int sh) {
  extern __shared__ int smem[];
  int* s_spl = smem;
  int* s_hist = smem + n_spl + (n_spl >> sh);
  const int bins = n_spl + 1;
  for (int i = threadIdx.x; i < n_spl; i += blockDim.x)
    s_spl[i + (i >> sh)] = sorted[i];
  for (int i = threadIdx.x; i < n_hist * bins; i += blockDim.x) s_hist[i] = 0;
  __syncthreads();
  const long long row = blockIdx.x / per_row;
  const long long start = (blockIdx.x % per_row) * chunk;
  const long long end = min(start + chunk, (long long)cols);
  const int* xr = x + row * cols;
  int* br = bid + row * cols;
  int* h = s_hist + ((threadIdx.x >> 5) % n_hist) * bins;

  // 16-byte vectors over [a0, a1), where row * cols + i is a multiple of 4;
  // empty unless both tensors are aligned
  long long a0 = end, a1 = end;
  if (vec) {
    long long g = row * cols;
    a0 = min(end, start + (4 - (g + start) % 4) % 4);
    a1 = max(a0, end - (g + end) % 4);
  }
  // the scalar head [start, a0) and tail [a1, end): fewer than 4 keys each
  // when vectors run, the whole range when they do not
  for (long long i = start + threadIdx.x; i < a0; i += blockDim.x) {
    int id = count_at_or_below(s_spl, n_spl, sh, top, xr[i]);
    br[i] = id;
    atomicAdd(&h[id], 1);
  }
  for (long long i = a1 + threadIdx.x; i < end; i += blockDim.x) {
    int id = count_at_or_below(s_spl, n_spl, sh, top, xr[i]);
    br[i] = id;
    atomicAdd(&h[id], 1);
  }
  // a 16-byte vector a thread a round
  for (long long i = a0 + 4LL * threadIdx.x; i < a1; i += 4LL * blockDim.x) {
    int4 k = *reinterpret_cast<const int4*>(xr + i);
    int4 id = count4_at_or_below(s_spl, n_spl, sh, top, k);
    *reinterpret_cast<int4*>(br + i) = id;
    atomicAdd(&h[id.x], 1);
    atomicAdd(&h[id.y], 1);
    atomicAdd(&h[id.z], 1);
    atomicAdd(&h[id.w], 1);
  }
  __syncthreads();
  int* cr = counts + row * bins;
  for (int i = threadIdx.x; i < bins; i += blockDim.x) {
    int sum = 0;
    for (int c = 0; c < n_hist; ++c) sum += s_hist[c * bins + i];
    if (sum) atomicAdd(&cr[i], sum);
  }
}

static cudaError_t partition_launch(const int* x, const int* spl, int* sorted,
                                    int* bid, int* counts, int rows, int cols,
                                    int n_spl, cudaStream_t stream) {
  if (rows == 0) return cudaSuccess;
  // the pre-pass: the sort, and the counts zeroed
  size_t prep_smem = 0;
  if (n_spl > 0) {
    int p = 1;
    while (p < n_spl) p <<= 1;
    prep_smem = (size_t)p * sizeof(int);
  }
  cudaError_t err = allow_smem(partition_prep_kernel, prep_smem);
  if (err != cudaSuccess) return err;
  long long n_counts = (long long)rows * (n_spl + 1);
  long long per_block = 4LL * PREP_THREADS;
  long long prep_blocks = (n_counts + per_block - 1) / per_block;
  if (prep_blocks > PART_TARGET_CTAS) prep_blocks = PART_TARGET_CTAS;
  partition_prep_kernel<<<(unsigned)prep_blocks, PREP_THREADS, prep_smem,
                          stream>>>(spl, sorted, n_spl, counts, n_counts);
  err = cudaGetLastError();
  if (err != cudaSuccess || cols == 0) return err;

  // the splitters padded where that leaves room for a histogram, and as
  // many sub-histograms as fit beside them, one per warp at most
  const long long words = SMEM_LIMIT / (long long)sizeof(int);
  int sh = n_spl + (n_spl >> 5) + n_spl + 1 <= words ? 5 : 31;
  long long spl_words = n_spl + (n_spl >> sh);
  long long fit = (words - spl_words) / (n_spl + 1);
  int n_hist = (int)(fit < PART_THREADS / 32 ? fit : PART_THREADS / 32);
  if (n_hist < 1) n_hist = 1;
  size_t smem =
      (size_t)(spl_words + (long long)n_hist * (n_spl + 1)) * sizeof(int);
  err = allow_smem(partition_kernel, smem);
  if (err != cudaSuccess) return err;
  int top = n_spl > 0 ? 1 : 0;
  while (top > 0 && top * 2 <= n_spl) top *= 2;
  long long min_chunk = 4LL * PART_THREADS;
  long long most = (cols + min_chunk - 1) / min_chunk;
  long long per_row = (PART_TARGET_CTAS + rows - 1) / rows;
  if (per_row > most) per_row = most;
  if ((long long)rows * per_row > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  // a multiple of 4, so the ranges of an aligned row stay aligned
  long long chunk = ((cols + per_row - 1) / per_row + 3) / 4 * 4;
  int vec = ((uintptr_t)x % 16 == 0) && ((uintptr_t)bid % 16 == 0);
  partition_kernel<<<(unsigned)(rows * per_row), PART_THREADS, smem,
                      stream>>>(x, sorted, bid, counts, cols, n_spl, top,
                                (int)per_row, chunk, n_hist, vec, sh);
  return cudaGetLastError();
}

// Bucket ids (rows, cols) of int32 keys `x` (rows, cols) against int32
// splitters `spl` (n_spl,), any order, and their histograms into `counts`
// (rows, n_spl + 1); `sorted` (n_spl,) is scratch for the sorted splitters.
// Nothing need be zeroed.
extern "C" int partition_rows(const void* x, const void* spl, void* sorted,
                              void* bid, void* counts, int rows, int cols,
                              int n_spl, void* stream) {
  return partition_launch((const int*)x, (const int*)spl, (int*)sorted,
                          (int*)bid, (int*)counts, rows, cols, n_spl,
                          (cudaStream_t)stream);
}
