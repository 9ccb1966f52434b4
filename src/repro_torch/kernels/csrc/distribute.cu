// B3: the paper's distribute phase — per word its byte length (the bucket
// id), its stable rank inside that bucket, and the length histogram.
//
// Replaces repro/kernels/distribute_kernel.py:44 (distribute_rows_kernel).
// There the grid runs in order on one core, and the histogram block, whose
// index_map is constant (distribute_kernel.py:104-106), carries the running
// counts from one grid step to the next (the rank loop at :68-75). Blocks
// on a GPU run in no order, so the port takes the cross-block prefix in one
// launch by a decoupled look-back:
//  - each block takes a tile of 1024 W words, W a thread, its tile number
//    from an atomic ticket (not blockIdx), so a tile only ever waits on
//    tiles whose blocks are already running;
//  - a word's rank among the earlier words of its warp with the same length
//    comes from __match_any_sync; warp b scans bucket b's count over the
//    block's warps (a shuffle scan), which gives the rank inside the tile
//    and the tile's count of the bucket;
//  - the tile publishes that count (its aggregate), then walks back over the
//    tiles before it, 32 at a time, adding aggregates until it meets a tile
//    that has published its inclusive prefix, and publishes its own. The
//    walk grows with the tiles over 32, so past 64 tiles of one word a
//    thread a thread takes four (W = 4): at DS2's 230,000 words that was
//    faster, at 4,096 and 16,384 words (the run tier's chunks) one word a
//    thread was (timings of scratch variants on the H100 that the repo does
//    not keep, so their numbers are not recorded; so are the walk's one
//    tile a lane and its backoff, against wider steps and shorter sleeps);
//  - each word adds its bucket's prefix; the last tile writes the counts.
// A published value is one 64-bit word, its flag in the high half and its
// count in the low half, stored and read whole, so no fence orders the two.
// The ranks are exactly the arrival-order ranks, the same on every run.
//
// Length: the position of the last non-zero byte of the big-endian packed
// word, so interior NUL bytes count (distribute_kernel.py:53-59). Rows at or
// past `n_valid` are padding: dest = num_buckets, rank 0, counted nowhere.
//
// What bounds it on the H100: the packed words are read once and dest and
// rank written once — at DS2's 230,000 words of four lanes 5.5 MB, 1.6 us at
// 3.35 TB/s. The words of four and eight lanes load as 16-byte vectors.
#include "common.cuh"

#define DIST_THREADS 1024
#define DIST_WARPS (DIST_THREADS / 32)
#define MAX_BUCKETS 33  // 4 * 8 lanes + 1
// tiles of one word a thread up to this many, of four past it
#define DIST_SMALL_TILES 64

// a tile's published value for one bucket: flag << 32 | count
enum : unsigned { ST_NONE = 0, ST_AGGREGATE = 1, ST_PREFIX = 2 };

__device__ __forceinline__ unsigned long long ld_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(unsigned long long* p,
                                           unsigned flag, unsigned count) {
  unsigned long long v = ((unsigned long long)flag << 32) | count;
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

// The count of bucket b in every tile before `tile`, by the warp that
// handles b: lane l reads tile pred - l, waiting (bounded backoff) until it
// has published; the nearest tile with a prefix ends the walk.
__device__ __forceinline__ unsigned look_back(
    const unsigned long long* status, int nb, int b, int tile, int lane) {
  unsigned before = 0;
  for (int pred = tile - 1;; pred -= 32) {
    const int p = pred - lane;
    unsigned flag = ST_PREFIX, count = 0;  // before tile 0: a prefix of 0
    if (p >= 0) {
      const unsigned long long* w = status + (size_t)p * nb + b;
      unsigned long long v;
      for (unsigned ns = 32; ((v = ld_relaxed(w)) >> 32) == ST_NONE;) {
        __nanosleep(ns);
        if (ns < 1024) ns <<= 1;
      }
      flag = (unsigned)(v >> 32);
      count = (unsigned)v;
    }
    const unsigned prefixes = __ballot_sync(0xffffffffu, flag == ST_PREFIX);
    if (prefixes) {
      const int nearest = __ffs(prefixes) - 1;
      return before + __reduce_add_sync(0xffffffffu,
                                        lane <= nearest ? count : 0u);
    }
    before += __reduce_add_sync(0xffffffffu, count);
  }
}

// keys: (n, LANES) packed words, row-major, 16-byte aligned where VEC.
// ticket and status: zeroed scratch, status one word per (tile, bucket).
// A tile is W DIST_THREADS words; word w of a thread is word
// w DIST_THREADS + threadIdx.x of the tile, so the tile's segments of 32
// words, in order, are (w, warp).
template <int LANES, bool VEC, int W>
__global__ void __launch_bounds__(DIST_THREADS)
distribute_kernel(const uint32_t* __restrict__ keys, int n, int n_valid,
                  int nb, int n_tiles, int* dest, int* rank, int* counts,
                  unsigned* ticket, unsigned long long* status) {
  constexpr int SEGS = DIST_WARPS * W;
  __shared__ int seg_hist[SEGS][MAX_BUCKETS];
  __shared__ int tile_of_block;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) tile_of_block = (int)atomicAdd(ticket, 1u);
  for (int q = warp; q < SEGS; q += DIST_WARPS)
    for (int b = lane; b < nb; b += 32) seg_hist[q][b] = 0;
  __syncthreads();
  const int tile = tile_of_block;
  const long long first = (long long)tile * W * DIST_THREADS + threadIdx.x;
  int len[W], in_warp[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const long long i = first + w * DIST_THREADS;
    len[w] = -1;  // past the end of the array: no bucket
    if (i < n_valid) {
      uint32_t x[LANES];
      const uint32_t* p = keys + i * LANES;
      if constexpr (VEC) {
#pragma unroll
        for (int c = 0; c < LANES / 4; ++c) {
          uint4 t = reinterpret_cast<const uint4*>(p)[c];
          x[4 * c] = t.x; x[4 * c + 1] = t.y; x[4 * c + 2] = t.z;
          x[4 * c + 3] = t.w;
        }
      } else {
#pragma unroll
        for (int l = 0; l < LANES; ++l) x[l] = p[l];
      }
      len[w] = 0;
#pragma unroll
      for (int l = 0; l < LANES; ++l)
        if (x[l]) len[w] = 4 * l + 4 - ((__ffs((int)x[l]) - 1) >> 3);
    } else if (i < n) {
      len[w] = nb;  // padding: the discard id
    }
    const unsigned peers = __match_any_sync(0xffffffffu, len[w]);
    in_warp[w] = __popc(peers & ((1u << lane) - 1u));
    if (len[w] >= 0 && len[w] < nb && in_warp[w] == 0)
      seg_hist[w * DIST_WARPS + warp][len[w]] = __popc(peers);
  }
  __syncthreads();
  // warp b: bucket b over the tile's segments (lane l: segments l W to
  // l W + W - 1), then across the tiles before this one
  for (int b = warp; b < nb; b += DIST_WARPS) {
    int c[W], mine = 0;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      c[w] = seg_hist[lane * W + w][b];
      mine += c[w];
    }
    int inc = mine;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      int t = __shfl_up_sync(0xffffffffu, inc, d);
      if (lane >= d) inc += t;
    }
    const unsigned total = (unsigned)__shfl_sync(0xffffffffu, inc, 31);
    unsigned long long* own = status + (size_t)tile * nb + b;
    unsigned before = 0;
    if (tile == 0) {
      if (lane == 0) st_relaxed(own, ST_PREFIX, total);
    } else {
      if (lane == 0) st_relaxed(own, ST_AGGREGATE, total);
      before = look_back(status, nb, b, tile, lane);
      if (lane == 0) st_relaxed(own, ST_PREFIX, before + total);
    }
    if (tile == n_tiles - 1 && lane == 0) counts[b] = (int)(before + total);
    int run = (int)before + inc - mine;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      seg_hist[lane * W + w][b] = run;
      run += c[w];
    }
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const long long i = first + w * DIST_THREADS;
    if (i < n) {
      dest[i] = len[w];
      rank[i] = len[w] < nb ? seg_hist[w * DIST_WARPS + warp][len[w]] +
                                  in_warp[w]
                            : 0;
    }
  }
}

template <int LANES, bool VEC>
static void distribute_launch(const void* keys, int n, int n_valid, int nb,
                              bool wide, int n_tiles, void* dest, void* rank,
                              void* counts, void* scratch, cudaStream_t s) {
  unsigned* ticket = (unsigned*)scratch;
  unsigned long long* status = (unsigned long long*)scratch + 1;
  if (wide)
    distribute_kernel<LANES, VEC, 4><<<n_tiles, DIST_THREADS, 0, s>>>(
        (const uint32_t*)keys, n, n_valid, nb, n_tiles, (int*)dest,
        (int*)rank, (int*)counts, ticket, status);
  else
    distribute_kernel<LANES, VEC, 1><<<n_tiles, DIST_THREADS, 0, s>>>(
        (const uint32_t*)keys, n, n_valid, nb, n_tiles, (int*)dest,
        (int*)rank, (int*)counts, ticket, status);
}

// keys: (n, lanes) packed words, row-major. Out: dest (n,), rank (n,),
// counts (nb,), nb = 4 * lanes + 1. scratch: `scratch_bytes` bytes, 8-byte
// aligned, at least 8 (1 + ceil(n / DIST_THREADS) nb); it is zeroed here,
// in the same stream, before the launch.
extern "C" int distribute_rows(const void* keys, int lanes, int n, int n_valid,
                               int nb, void* dest, void* rank, void* counts,
                               void* scratch, long long scratch_bytes,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (lanes < 1 || lanes > 8 || nb != 4 * lanes + 1 || n < 0 ||
      n_valid < 0 || n_valid > n || ((uintptr_t)scratch & 7))
    return cudaErrorInvalidValue;
  cudaError_t err;
  if (n == 0) {
    err = cudaMemsetAsync(counts, 0, (size_t)nb * sizeof(int), s);
    return err != cudaSuccess ? err : cudaGetLastError();
  }
  const long long small = ((long long)n + DIST_THREADS - 1) / DIST_THREADS;
  const bool wide = small > DIST_SMALL_TILES;
  const int n_tiles = (int)(wide ? (small + 3) / 4 : small);
  const size_t need = 8 * (1 + (size_t)n_tiles * nb);
  if ((long long)need > scratch_bytes) return cudaErrorInvalidValue;
  err = cudaMemsetAsync(scratch, 0, need, s);
  if (err != cudaSuccess) return err;
  const bool vec = lanes % 4 == 0 && ((uintptr_t)keys & 15) == 0;
#define DIST_CASE(L, VEC)                                                   \
  distribute_launch<L, VEC>(keys, n, n_valid, nb, wide, n_tiles, dest,      \
                            rank, counts, scratch, s);                      \
  break;
  switch (lanes) {
    case 1: DIST_CASE(1, false)
    case 2: DIST_CASE(2, false)
    case 3: DIST_CASE(3, false)
    case 4: if (vec) { DIST_CASE(4, true) } DIST_CASE(4, false)
    case 5: DIST_CASE(5, false)
    case 6: DIST_CASE(6, false)
    case 7: DIST_CASE(7, false)
    default: if (vec) { DIST_CASE(8, true) } DIST_CASE(8, false)
  }
#undef DIST_CASE
  return cudaGetLastError();
}
