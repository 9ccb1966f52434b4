// B5: merge-path combine of two sorted runs, one output block per CTA, and
// the diagonal split that cuts the runs into those blocks.
//
// Replaces repro/kernels/runmerge_kernel.py:54 (_runmerge_kernel): there each
// grid step DMAs the a- and b-segments of one output block into VMEM at
// scalar-prefetched starts, masks the tails to the sentinel tuple, runs the
// asc ++ asc merge network (merge_kernel._merge_network) on the 2B window
// with every lane of the tuple in it, and keeps the low half; the starts come
// from jnp in the same jit (runmerge_kernel.py:110-114: merge-path ranks of
// a by a binary search over b, then one searchsorted over the block bounds).
//
// The stable merge of two runs has one result under this order: the compare
// prefix (an order-preserving refinement of the tuple: equal prefix, equal
// tuple), then a before b, then run order. So any correct stable merge gives
// the bits of keypack.merge_take_packed, on any lanes, float ties included,
// and no network is needed. Here:
//  - the split (runmerge_starts_kernel) is one warp per output-block
//    boundary d = kB: the co-rank search of merge path over the stacked
//    compare lanes in device memory (a[i] <= b[d - 1 - i] while i counts),
//    33-ary, 32 probes a step, each a lex compare of every compare lane of
//    both elements loaded at once (one round trip a step, about log33(n)
//    steps: 4 at DS2's 131,072 + 98,928, where a binary search takes 18;
//    templated on 1-9 lanes), float lanes through order_bits; it writes the
//    (2, nblocks + 1) int32 starts of the torch split bit for bit, the last
//    boundary past na + nb included (b's start clamped to nb);
//  - the merge (runmerge_kernel) takes one block of B slots a CTA of B / E
//    threads, E = 2 outputs a thread up to B = 2048. The a- and b-segments
//    of the block hold exactly its outputs, so they are staged one after the
//    other into a B-wide tile of shared memory with cp.async (no register
//    round trip, every copy of a thread in flight at once, consecutive
//    threads on consecutive words): the compare lanes, turned once into
//    order keys (lane-major, key[l][p]), and every data lane (as many a pass
//    as fit in shared memory). Each thread binary-searches its own diagonal
//    in the tile and merges its E outputs, taking b only where b < a
//    strictly, and records each output's tile position; then the threads
//    copy every data lane out of the tile, consecutive threads writing
//    consecutive outputs. The data lanes' copies land while the merge runs.
//    With E = 2 the threads of a warp search and read nearly consecutive
//    keys, so the tile's reads stay nearly free of bank conflicts.
// The compare is the borrow chain of network.cuh (lex_less) for 1-9 compare
// lanes, templated on the count; 10-15 run one instance with a loop over
// the lanes. Keys are computed at load, so the merge is the same code
// whether a lane is float or not and no template on float lanes is needed.
// The staging, the compares and both co-rank searches live in
// merge_path.cuh, which the k-way split's rounds (kway.cu) share.
// Shared memory is (n_cmp + 1 + lanes a pass) x B x 4 B: 16 KB at the
// pipeline's 5 compare lanes, 10 data lanes and B = 256.
//
// What bounds it on the H100: every data lane is read once and written once
// (the compare lanes, when they lead the data lanes, are read again from
// L2), so the least time is those bytes over 3.35 TB/s; the merge's
// log2(B) + E compares a thread stay far below the compute peak. The split
// moves a few bytes a boundary and is bounded by the latency of its
// dependent loads, one round trip a step.
#include "merge_path.cuh"

// outputs a thread merges, while the block takes at most 1024 threads
#define MERGE_E 2

// starts[0][k]: how many of the first d = k * block outputs come from a;
// starts[1][k]: the rest, at most nb. One warp a boundary (warp_corank).
template <int NC>
__global__ void __launch_bounds__(SPLIT_THREADS)
runmerge_starts_kernel(const uint32_t* __restrict__ cmp_a,
                       const uint32_t* __restrict__ cmp_b, int* starts,
                       int n_cmp, uint32_t codes, int na, int nb, int nblocks,
                       int block) {
  const int lane = threadIdx.x & 31;
  const long long k = ((long long)blockIdx.x * SPLIT_THREADS + threadIdx.x) >> 5;
  if (k > nblocks) return;  // the whole warp
  const long long d = k * block;
  const long long lo =
      warp_corank<NC>(cmp_a, na, na, cmp_b, nb, nb, d, n_cmp, codes);
  if (lane == 0) {
    const long long j = d - lo;
    starts[k] = (int)lo;
    starts[nblocks + 1 + k] = (int)(j < nb ? j : nb);
  }
}

// NC: the compare-lane count, 0 for a count read at run time (10 to 15)
template <int NC>
__global__ void __launch_bounds__(1024)
runmerge_kernel(const uint32_t* cmp_a, const uint32_t* cmp_b,
                const uint32_t* data_a, const uint32_t* data_b, uint32_t* out,
                const int* starts, int n_cmp_rt, int n_arr, uint32_t codes,
                int na, int nb, int nblocks, int block, int group) {
  const int n_cmp = NC > 0 ? NC : n_cmp_rt;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* key = smem;                                // n_cmp x block
  int* src = (int*)(smem + (size_t)n_cmp * block);     // block
  uint32_t* tile = smem + (size_t)(n_cmp + 1) * block;  // group x block
  const int k = blockIdx.x, tid = threadIdx.x, T = blockDim.x;
  const int sa = starts[k], sb = starts[nblocks + 1 + k];
  // a split that is not this kernel's own never overruns the tile
  const int ca = max(0, min(starts[k + 1] - sa, block));
  const int cb = max(0, min(starts[nblocks + 2 + k] - sb, block - ca));
  const int cnt = ca + cb;
  stage(key, block, cmp_a, na, cmp_b, nb, sa, ca, sb, cb, n_cmp);
  cp_async_commit();
  int lanes = min(group, n_arr);
  stage(tile, block, data_a, na, data_b, nb, sa, ca, sb, cb, lanes);
  cp_async_commit();
  cp_async_wait<1>();  // this thread's keys have landed
  for (int p = tid; p < cnt; p += T)
    for (int l = 0; l < n_cmp; ++l)
      key[l * block + p] = order_bits(key[l * block + p], (codes >> (2 * l)) & 3);
  __syncthreads();

  // outputs [d, d + E) of the block: the co-rank of d in the tile, then E
  // steps of the merge; src[o] is output o's tile position
  const int E = block / T;
  const int d = tid * E;
  if (d < cnt) {
    int i = tile_corank<NC>(key, block, n_cmp, 0, ca, ca, cb, d);
    int j = d - i;
    for (int e = 0; e < E && d + e < cnt; ++e) {
      bool take_b =
          j < cb && (i >= ca || tile_less<NC>(key, block, n_cmp, ca + j, i));
      src[d + e] = take_b ? ca + j++ : i++;
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  const size_t total = (size_t)na + nb;
  uint32_t* o_base = out + (size_t)k * block;
  for (int first = 0; first < n_arr; first += group) {
    if (first > 0) {
      lanes = min(group, n_arr - first);
      __syncthreads();  // every read of the previous lanes is done
      stage(tile, block, data_a + (size_t)first * na, na,
            data_b + (size_t)first * nb, nb, sa, ca, sb, cb, lanes);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    }
    for (int o = tid; o < cnt; o += T) {
      const int p = src[o];
      for (int l = 0; l < lanes; ++l)
        o_base[(first + l) * total + o] = tile[l * block + p];
    }
  }
}

template <int NC>
static cudaError_t runmerge_launch(const uint32_t* cmp_a, const uint32_t* cmp_b,
                                   const uint32_t* data_a,
                                   const uint32_t* data_b, uint32_t* out,
                                   const int* starts, int n_cmp, int n_arr,
                                   uint32_t codes, int na, int nb, int nblocks,
                                   int block, int group, size_t smem,
                                   cudaStream_t stream) {
  cudaError_t err = allow_smem(runmerge_kernel<NC>, smem);
  if (err != cudaSuccess) return err;
  int threads = block / MERGE_E < 1024 ? block / MERGE_E : 1024;
  runmerge_kernel<NC><<<nblocks, threads, smem, stream>>>(
      cmp_a, cmp_b, data_a, data_b, out, starts, n_cmp, n_arr, codes, na, nb,
      nblocks, block, group);
  return cudaGetLastError();
}

// Merge the sorted runs a and b, stacked (arrays, n) int32 lanes: `cmp_*`
// (n_cmp, n) the compare lanes, `data_*` (n_arr, n) the lanes to merge (the
// same memory as cmp_* when the compare lanes lead the tuple), `out`
// (n_arr, na + nb), `starts` (2, nblocks + 1) the diagonal split.
// `codes` holds the compare lanes' codes.
extern "C" int runmerge_lex(const void* cmp_a, const void* cmp_b,
                            const void* data_a, const void* data_b, void* out,
                            const void* starts, int n_cmp, int n_arr,
                            unsigned codes, int na, int nb, int nblocks,
                            int block, void* stream) {
  if (nblocks == 0) return cudaSuccess;
  if (block < 2 * MERGE_E || (block & (block - 1)) || n_cmp < 1 ||
      n_cmp > 15 || n_arr < 1 || (long long)nblocks * block < (long long)na + nb)
    return cudaErrorInvalidValue;
  // data lanes a pass: all that fit beside the keys and positions
  long long room = SMEM_LIMIT / (4LL * block) - n_cmp - 1;
  if (room < 1) return cudaErrorInvalidValue;
  int group = n_arr < room ? n_arr : (int)room;
  size_t smem = (size_t)(n_cmp + 1 + group) * block * sizeof(uint32_t);
  const uint32_t *ca = (const uint32_t*)cmp_a, *cb = (const uint32_t*)cmp_b;
  const uint32_t *da = (const uint32_t*)data_a, *db = (const uint32_t*)data_b;
  uint32_t* o = (uint32_t*)out;
  const int* s = (const int*)starts;
  cudaStream_t st = (cudaStream_t)stream;
#define RUNMERGE_CASE(NC)                                                   \
  case NC:                                                                  \
    return runmerge_launch<NC>(ca, cb, da, db, o, s, n_cmp, n_arr, codes, na, \
                               nb, nblocks, block, group, smem, st);
  switch (n_cmp) {
    RUNMERGE_CASE(1) RUNMERGE_CASE(2) RUNMERGE_CASE(3) RUNMERGE_CASE(4)
    RUNMERGE_CASE(5) RUNMERGE_CASE(6) RUNMERGE_CASE(7) RUNMERGE_CASE(8)
    RUNMERGE_CASE(9)
    default:
      return runmerge_launch<0>(ca, cb, da, db, o, s, n_cmp, n_arr, codes, na,
                                nb, nblocks, block, group, smem, st);
  }
#undef RUNMERGE_CASE
}

// The diagonal split of sorted runs a and b for `block`-slot output blocks:
// `starts` (2, nblocks + 1) int32, from their stacked (n_cmp, n) compare
// lanes `cmp_*` and the lanes' `codes`.
extern "C" int runmerge_starts(const void* cmp_a, const void* cmp_b,
                               void* starts, int n_cmp, unsigned codes, int na,
                               int nb, int nblocks, int block, void* stream) {
  if (block < 1 || n_cmp < 1 || n_cmp > 15 || nblocks < 0)
    return cudaErrorInvalidValue;
  const int threads = SPLIT_THREADS, per = SPLIT_THREADS / 32;
  const int grid = (nblocks + 1 + per - 1) / per;
  const uint32_t *a = (const uint32_t*)cmp_a, *b = (const uint32_t*)cmp_b;
  int* s = (int*)starts;
  cudaStream_t st = (cudaStream_t)stream;
#define STARTS_CASE(NC)                                                     \
  case NC:                                                                  \
    runmerge_starts_kernel<NC><<<grid, threads, 0, st>>>(a, b, s, n_cmp,    \
                                                         codes, na, nb,     \
                                                         nblocks, block);   \
    break;
  switch (n_cmp) {
    STARTS_CASE(1) STARTS_CASE(2) STARTS_CASE(3) STARTS_CASE(4)
    STARTS_CASE(5) STARTS_CASE(6) STARTS_CASE(7) STARTS_CASE(8)
    STARTS_CASE(9)
    default:
      runmerge_starts_kernel<0><<<grid, threads, 0, st>>>(
          a, b, s, n_cmp, codes, na, nb, nblocks, block);
  }
#undef STARTS_CASE
  return cudaGetLastError();
}
