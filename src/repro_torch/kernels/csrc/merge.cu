// B4: blocksort's cross-block merge, in two designs.
//
// 1. The merge-path rounds (merge_pairs_lex; CUDA functions
//    merge_window_kernel), blocksort's: after the local sort, round k merges
//    every pair of adjacent sorted runs of width B 2^k, out of place, so a
//    row of nb blocks is sorted after ceil(log2 nb) rounds, each one launch
//    and one pass over the bucket tensor. They replace the reference's nb
//    odd-even block rounds (repro/core/blocksort.py:90, _merge_rounds),
//    which cost nb passes: at DS2 x 8's ~94 blocks a row, 7 passes for 94.
//    Every lane is a compare lane, ties take a before b, so the result is the
//    stable merge: the same bits as the network's wherever tuples are
//    distinct or bit-equal; float ties that compare equal but differ in bits
//    (-0.0 and +0.0, NaN payloads) may fall in another order.
//    What bounds it on the H100: each round reads and writes the tensor once,
//    so the least time is those bytes over 3.35 TB/s. The pieces are B5's
//    (merge_path.cuh): each CTA finds its own two diagonals by the warp
//    co-rank search in device memory (fused into the merge, so a round is
//    one launch), stages the two segments with cp.async, and merges in a
//    shared-memory tile, a thread's outputs leaving as one vector a lane.
//
// 2. The reflected network (merge_adjacent_lex; CUDA functions
//    merge_net_window_kernel, merge_net_regs_kernel): one round of block
//    pairs in place, the hand-written counterpart of the reference's
//    merge_adjacent_*_pallas. No path of the port launches it.
//
// The network replaces repro/kernels/merge_kernel.py:74
// (merge_rows_lex_kernel, with _merge_network :43): each grid step merges
// one pair of adjacent sorted B-blocks in VMEM with a reflected
// compare-exchange (partner 2B-1-i) and log2(B) XOR stages, leaving the low
// half left and the high half right.
// The port runs the same pairs with the same strict compare, so the result
// is the same bit for bit, float ties included; it merges in place at any
// column offset `lo` of the row, where the reference slices the odd rounds
// out and concatenates the untouched edge blocks back (blocksort.py:90-112).
//
// What bounds the network on the H100: each window is read once and written
// once, so the least time is the bytes over 3.35 TB/s. With one window of
// 128 KB of shared memory per SM, the load and the store do not overlap the
// network, and the network's compares and selects, not barriers, take the
// rest: the kernel is issue-bound between the load and the store. The design
// cuts the instructions and the barriers a stage costs (its pieces in
// network.cuh, which B2's sort shares):
//  - Specialised per lane count (1-9) and on whether any lane is float
//    (templates): the lane loops unroll. Integer lanes travel as their order
//    bits (U32 as is, I32 with the top bit flipped: a bijection), converted
//    once at load and once at store, so they compare as plain unsigned
//    words. Float lanes keep their raw bits, which move, and compare through
//    order_bits, which drops -0.0 and NaN payloads; in registers their keys
//    ride beside the raw bits, computed once. The lexicographic compare
//    takes two lanes at a time as one 64-bit word.
//  - The window (2 B x lanes x 4 bytes, the shared-memory cap that sets
//    blocksort's block) sits in shared memory for the stages with far
//    partners, two stages a pass on groups of four elements a thread holds
//    (one barrier a pass); the reflected stage and the first XOR stage run as
//    the window is loaded, each thread reading an element, its partner at
//    +B/2 and both mirrors with vector loads.
//  - The near stages run in registers: each thread takes E = 4 consecutive
//    elements (one 16-byte shared-memory read a lane, conflict-free), a
//    group of LANES lanes a segment; the stages with E <= j < LANES x E go
//    across the group by __shfl_xor_sync (the partner of element i is in
//    lane (i / E) ^ (j / E), the same slot), those with j < E inside the
//    thread, and the merged elements leave with 16-byte stores. At B = 4096
//    and four integer lanes: four barriers where the one-stage-per-barrier
//    network took 13.
//  - A window of at most 32 x 4 elements never touches shared memory: a warp
//    holds whole windows, the reflected stage a shuffle with lane
//    l ^ (lanes per window - 1) and the mirrored slot, or inside the thread.
#include "merge_path.cuh"

// The register-only kernel, for windows of at most 32 x REG_E elements: a
// warp holds whole windows, REG_E elements a thread.
#define MERGE_REG_THREADS 256
#define REG_E 4
static_assert(REG_E == 4, "reflect_small covers windows of 2 and 4");

// The reflected stage of windows of `tw` lanes (2 <= tw <= 32): element
// (lane, e) against (lane ^ (tw - 1), E - 1 - e). Both slots of a mirrored
// pair are read before either is written.
template <int NA, bool FL, int E>
__device__ __forceinline__ void reflect_in_warp(
    uint32_t (&v)[NetShape<NA, FL>::NW][E], int tw, int lane) {
  constexpr int NW = NetShape<NA, FL>::NW;
  bool lower = (lane & (tw >> 1)) == 0;
  int m = tw - 1;
#pragma unroll
  for (int e = 0; e < E / 2; ++e) {
    const int f = E - 1 - e;
    uint32_t pe[NW], pf[NW];  // the partner's slots f and e
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      pe[w] = __shfl_xor_sync(0xffffffffu, v[w][f], m);
      pf[w] = __shfl_xor_sync(0xffffffffu, v[w][e], m);
    }
    exchange<NetShape<NA, FL>, E>(v, e, pe, lower);
    exchange<NetShape<NA, FL>, E>(v, f, pf, lower);
  }
}

// The reflected stage of windows of W <= E elements, inside the thread.
template <int NA, bool FL, int E, int W>
__device__ __forceinline__ void reflect_in_thread(
    uint32_t (&v)[NetShape<NA, FL>::NW][E]) {
#pragma unroll
  for (int e = 0; e < E; ++e)
    if ((e & (W / 2)) == 0) cmpx_slots<NetShape<NA, FL>, E>(v, e, e ^ (W - 1));
}

template <int NA, bool FL, int E>
__device__ __forceinline__ void reflect_small(
    uint32_t (&v)[NetShape<NA, FL>::NW][E], int width) {
  if (width == 2) reflect_in_thread<NA, FL, E, 2>(v);
  else reflect_in_thread<NA, FL, E, 4>(v);
}

// reversed in place: a mirrored run read as a vector
template <int NA, int V>
__device__ __forceinline__ void reverse(uint32_t (&g)[NA][V]) {
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int q = 0; q < V / 2; ++q) {
      uint32_t t = g[a][q];
      g[a][q] = g[a][V - 1 - q];
      g[a][V - 1 - q] = t;
    }
}

// One block per pair window of 2 `block` > 32 x REG_E columns, the window in
// shared memory: array a's element i at smem[a * width + i]. Each pass over
// shared memory runs two stages of the network on groups of four elements a
// thread holds, so a barrier separates every second stage.
template <int NA, bool FL>
__global__ void __launch_bounds__(NetShape<NA, FL>::MAXT)
merge_net_window_kernel(uint32_t* x, int rows, int ncols, int lo,
                        int npairs, int block, uint32_t fmask,
                        uint32_t smask) {
  using S = NetShape<NA, FL>;
  constexpr int E = S::E, V = S::V, SPAN = S::SPAN;
  extern __shared__ __align__(16) uint32_t smem[];
  const int width = 2 * block, half = block / 2, T = blockDim.x;
  const int tid = threadIdx.x;
  const size_t lane_stride = (size_t)rows * ncols;
  const int r = blockIdx.x / npairs, pair = blockIdx.x % npairs;
  const size_t start = (size_t)r * ncols + lo + (size_t)pair * width;

  // on the way in: the reflected stage, element i against width - 1 - i,
  // and with it the first XOR stage (block / 2) when its partners lie SPAN
  // or more apart. A thread takes V elements at k, k + block / 2 and their
  // mirrors, read as vectors; without the XOR stage, k and its mirror.
  const bool fused = half >= SPAN;
  const int places = fused ? 4 : 2, span = fused ? half : block;
  for (int k = tid * V; k < span; k += T * V) {
    int at[4] = {k, k + half, width - V - k - half, width - V - k};
    if (!fused) at[1] = width - V - k;
    uint32_t g[4][NA][V];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (q >= places) break;
#pragma unroll
      for (int a = 0; a < NA; ++a)
        load_words<V>(x + a * lane_stride + start + at[q], V,
                      flip_of(smask, a), g[q][a]);
    }
    // mirrored vectors in ascending element order: place 3 (or 1) holds
    // the mirrors of place 0, place 2 those of place 1
    if (fused) {
      reverse<NA, V>(g[2]);
      reverse<NA, V>(g[3]);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        cmpx_group<S, 4, V>(g, 0, 3, v, fmask);  // k + v, its mirror
        cmpx_group<S, 4, V>(g, 1, 2, v, fmask);
        cmpx_group<S, 4, V>(g, 0, 1, v, fmask);  // XOR block / 2
        cmpx_group<S, 4, V>(g, 2, 3, v, fmask);
      }
      reverse<NA, V>(g[2]);
      reverse<NA, V>(g[3]);
    } else {
      reverse<NA, V>(g[1]);
#pragma unroll
      for (int v = 0; v < V; ++v) cmpx_group<S, 4, V>(g, 0, 1, v, fmask);
      reverse<NA, V>(g[1]);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (q >= places) break;
#pragma unroll
      for (int a = 0; a < NA; ++a)
        smem_store<V>(smem + a * width + at[q], g[q][a]);
    }
  }
  // the other XOR stages whose partners lie SPAN or more apart, two per
  // pass where both do
  smem_stages<S>(smem, width, fused ? block >> 2 : block >> 1, 0, fmask);
  // the rest in registers: thread t takes the E elements from c E, for
  // c = t, t + T, ...; LANES neighbouring threads hold a SPAN segment
  const int lane = tid & 31, chunks = width / E;
  const unsigned mask = chunks >= 32 ? 0xffffffffu : (1u << chunks) - 1;
  for (int c = tid; c < chunks; c += T) {
    const int off = c * E;
    uint32_t v[S::NW][E];
    smem_to_regs<S, E>(smem, width, off, v, fmask);
    warp_stages<S, E, S::LANES>(v, block, off, 0, lane, mask);
    regs_to_global<S, E>(x, lane_stride, start + off, E, v, smask);
  }
}

// Windows of 2 `block` <= 32 REG_E columns, all in registers: each block
// takes `MERGE_REG_THREADS` x REG_E consecutive columns of a row's merged
// range, each thread REG_E of them, a warp whole windows.
template <int NA, bool FL>
__global__ void __launch_bounds__(MERGE_REG_THREADS)
merge_net_regs_kernel(uint32_t* x, int rows, int ncols, int lo, int npairs,
                      int block, uint32_t fmask, uint32_t smask, int tiles) {
  using S = NetShape<NA, FL>;
  constexpr int E = REG_E;
  const size_t lane_stride = (size_t)rows * ncols;
  const int r = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const long long len = (long long)npairs * 2 * block;
  const long long o =
      (long long)tile * MERGE_REG_THREADS * E + (long long)threadIdx.x * E;
  const long long left = len - o;
  // past the range a thread holds whole windows of its own (or, when a
  // window is narrower than E, the range's tail): they are not stored
  const int n = left <= 0 ? 0 : (left < E ? (int)left : E);
  const size_t base = (size_t)r * ncols + lo + (o < len ? o : 0);
  const int width = 2 * block, lane = threadIdx.x & 31;
  uint32_t v[S::NW][E];
  global_to_regs<S, E>(x, lane_stride, base, n, v, fmask, smask);
  if (width <= E) reflect_small<NA, FL, E>(v, width);
  else reflect_in_warp<NA, FL, E>(v, width / E, lane);
  warp_stages<S, E, 32>(v, block, 0, 0, lane, 0xffffffffu);
  regs_to_global<S, E>(x, lane_stride, base, n, v, smask);
}

template <int NA, bool FL>
static cudaError_t merge_net_launch(uint32_t* x, int rows, int ncols, int lo,
                                    int npairs, int block, uint32_t fmask,
                                    uint32_t smask, cudaStream_t stream) {
  using S = NetShape<NA, FL>;
  static_assert(S::SPAN <= 32 * REG_E, "every wider window needs the window "
                "kernel, whose shared-memory stages reach down to SPAN");
  long long width = 2LL * block;
  if (width > 32 * REG_E) {
    size_t smem = (size_t)NA * width * sizeof(uint32_t);
    cudaError_t err = allow_smem(merge_net_window_kernel<NA, FL>, smem);
    if (err != cudaSuccess) return err;
    long long grid = (long long)rows * npairs;
    if (grid > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
    long long threads = width / S::E;
    if (threads > S::MAXT) threads = S::MAXT;
    if (threads < 32) threads = 32;
    merge_net_window_kernel<NA, FL><<<(unsigned)grid, (unsigned)threads, smem,
                                      stream>>>(x, rows, ncols, lo, npairs,
                                                block, fmask, smask);
  } else {
    long long per = (long long)MERGE_REG_THREADS * REG_E;
    long long tiles = ((long long)npairs * width + per - 1) / per;
    long long grid = (long long)rows * tiles;
    if (grid > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
    merge_net_regs_kernel<NA, FL><<<(unsigned)grid, MERGE_REG_THREADS, 0,
                                    stream>>>(x, rows, ncols, lo, npairs,
                                              block, fmask, smask, (int)tiles);
  }
  return cudaGetLastError();
}

template <bool FL>
static cudaError_t merge_net_dispatch(uint32_t* p, int n_arr, int rows,
                                      int ncols, int lo, int npairs, int block,
                                      uint32_t fmask, uint32_t smask,
                                      cudaStream_t s) {
#define MERGE_NET_CASE(NA)                                                  \
  case NA:                                                                  \
    return merge_net_launch<NA, FL>(p, rows, ncols, lo, npairs, block,      \
                                    fmask, smask, s);
  switch (n_arr) {
    MERGE_NET_CASE(1) MERGE_NET_CASE(2) MERGE_NET_CASE(3) MERGE_NET_CASE(4)
    MERGE_NET_CASE(5) MERGE_NET_CASE(6) MERGE_NET_CASE(7) MERGE_NET_CASE(8)
    default: return merge_net_launch<9, FL>(p, rows, ncols, lo, npairs, block,
                                            fmask, smask, s);
  }
#undef MERGE_NET_CASE
}

// Merge, in place, the `npairs` pairs of sorted `block`-wide blocks that
// start at column `lo` of every row of the stacked (n_arr, rows, ncols) lane
// tensor `x`.
extern "C" int merge_adjacent_lex(void* x, int n_arr, int rows, int ncols,
                                  int lo, int npairs, int block,
                                  unsigned codes, void* stream) {
  if (rows == 0 || npairs == 0) return cudaSuccess;
  if (block < 1 || (block & (block - 1)) || n_arr < 1 || n_arr > MAX_ARRAYS ||
      lo + (long long)npairs * 2 * block > ncols)
    return cudaErrorInvalidValue;
  uint32_t fmask, smask;
  lane_masks(codes, n_arr, fmask, smask);
  uint32_t* p = (uint32_t*)x;
  cudaStream_t s = (cudaStream_t)stream;
  return fmask ? merge_net_dispatch<true>(p, n_arr, rows, ncols, lo, npairs,
                                          block, fmask, smask, s)
               : merge_net_dispatch<false>(p, n_arr, rows, ncols, lo, npairs,
                                           block, fmask, smask, s);
}

// ---------------------------------------------------------------------------
// Blocksort's rounds: every pair of adjacent sorted runs merged by merge path

// A CTA takes one output tile of PAIRS_THREADS x PAIRS_E slots of one pair
// (fewer where the pair is narrower), a thread PAIRS_E consecutive outputs.
// Timed on the H100 against five other shapes (E 2, 4 or 8; 256 to 1,024
// threads) at DS2 x 8's and a chunk's bucket tensors: 4 x 512 was the
// fastest at both (PERF.md).
#define PAIRS_E 4
#define PAIRS_THREADS 512
static_assert(PAIRS_E == 1 || PAIRS_E == 2 || PAIRS_E % 4 == 0,
              "a thread's outputs leave as one store_words vector a lane");

// The compare key of element p of a tile (lane-major, lane stride
// `stride`): an integer lane's order bits (the I32 top bit flipped), a float
// lane's through order_bits.
template <int NA, bool FL>
__device__ __forceinline__ void tile_key(const uint32_t* s, int stride, int p,
                                         uint32_t fmask, uint32_t smask,
                                         uint32_t (&k)[NA]) {
#pragma unroll
  for (int l = 0; l < NA; ++l) {
    const uint32_t v = s[l * stride + p];
    if constexpr (FL)
      k[l] = ((fmask >> l) & 1u) ? order_bits(v, CODE_F32)
                                 : v ^ flip_of(smask, l);
    else
      k[l] = v ^ flip_of(smask, l);
  }
}

// Round of width `run`: in every row of the stacked (NA, rows, ncols) lane
// tensor `src`, the runs [2p run, (2p + 1) run) and [(2p + 1) run, (2p + 2)
// run) (cut at ncols) merge into the same columns of `dst`; a last run with
// no partner is copied. A CTA owns output slots [o0, o0 + tile) of one row,
// inside one pair since `tile` divides 2 `run`: warps 0 and 1 find the
// co-ranks of its first and its end diagonal in device memory
// (warp_corank), the two segments between them are staged into shared memory
// with cp.async, each thread finds its own diagonal in the tile by a binary
// search and merges PAIRS_E outputs (b only where b < a strictly), and each
// lane's outputs leave as one vector a thread.
template <int NA, bool FL>
__global__ void __launch_bounds__(PAIRS_THREADS)
merge_window_kernel(const uint32_t* __restrict__ src,
                    uint32_t* __restrict__ dst, int rows, int ncols, int run,
                    int tile, int tiles, uint32_t codes, uint32_t fmask,
                    uint32_t smask) {
  constexpr int E = PAIRS_E;
  // NA x tile raw words, then the two co-ranks: no static shared memory, so
  // the launch's dynamic size is all the block takes (allow_smem)
  extern __shared__ __align__(16) uint32_t smem[];
  long long* corank = reinterpret_cast<long long*>(smem + NA * tile);
  const int tid = threadIdx.x;
  const int r = blockIdx.x / tiles;
  const long long o0 = (long long)(blockIdx.x % tiles) * tile;
  const long long width = 2LL * run;
  const long long pair = o0 / width * width;  // the pair's first column
  const long long na = min((long long)run, ncols - pair);
  const long long nb = max(0LL, min((long long)run, ncols - pair - run));
  const long long d0 = o0 - pair, d1 = min(d0 + tile, na + nb);
  const size_t ls = (size_t)rows * ncols;
  const uint32_t* a = src + (size_t)r * ncols + pair;
  const uint32_t* b = a + na;  // read only where nb > 0
  if (tid < 64) {
    const int w = tid >> 5;
    const long long i =
        warp_corank<NA>(a, ls, na, b, ls, nb, w ? d1 : d0, NA, codes);
    if ((tid & 31) == 0) corank[w] = i;
  }
  __syncthreads();
  // runs that are not sorted give co-ranks out of order: clamped, they
  // still never read past a run or write past the tile
  const int i0 = (int)corank[0], i1 = (int)corank[1];
  const int span = (int)(d1 - d0);
  const int ca = min(max(i1 - i0, 0), span), cb = span - ca;
  stage(smem, tile, a, ls, b, ls, i0, ca, (int)(d0 - i0), cb, NA);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int cnt = ca + cb, d = tid * E;
  if (d >= cnt) return;
  // the co-rank of d in the tile, a at 0 and b at ca
  uint32_t ka[NA], kb[NA];
  int i = corank_by(
      [&](int jb, int ia) {
        tile_key<NA, FL>(smem, tile, ca + jb, fmask, smask, kb);
        tile_key<NA, FL>(smem, tile, ia, fmask, smask, ka);
        return lex_less<NA>(kb, ka);
      },
      ca, cb, d);
  int j = d - i;
  if (i < ca) tile_key<NA, FL>(smem, tile, i, fmask, smask, ka);
  if (j < cb) tile_key<NA, FL>(smem, tile, ca + j, fmask, smask, kb);
  const int n = min(E, cnt - d);
  int pos[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const bool take_b = j < cb && (i >= ca || lex_less<NA>(kb, ka));
    pos[e] = take_b ? ca + j : i;
    if (take_b) {
      if (++j < cb) tile_key<NA, FL>(smem, tile, ca + j, fmask, smask, kb);
    } else if (++i < ca) {
      tile_key<NA, FL>(smem, tile, i, fmask, smask, ka);
    }
  }
  uint32_t* out = dst + (size_t)r * ncols + pair + d0 + d;
#pragma unroll
  for (int l = 0; l < NA; ++l) {
    uint32_t w[E];
#pragma unroll
    for (int e = 0; e < E; ++e) w[e] = e < n ? smem[l * tile + pos[e]] : 0u;
    store_words<E>(out + l * ls, n, 0u, w);
  }
}

template <int NA, bool FL>
static cudaError_t pairs_launch(const uint32_t* src, uint32_t* dst, int rows,
                                int ncols, int run, uint32_t codes,
                                uint32_t fmask, uint32_t smask,
                                cudaStream_t stream) {
  const long long most = (long long)PAIRS_THREADS * PAIRS_E;
  const long long tile = 2LL * run < most ? 2LL * run : most;
  const long long tiles = (ncols + tile - 1) / tile;
  const long long grid = (long long)rows * tiles;
  if (grid > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  // two warps at least: one a co-rank search
  long long threads = (tile + PAIRS_E - 1) / PAIRS_E;
  threads = (threads + 31) / 32 * 32;
  if (threads < 64) threads = 64;
  const size_t smem =
      (size_t)NA * tile * sizeof(uint32_t) + 2 * sizeof(long long);
  cudaError_t err = allow_smem(merge_window_kernel<NA, FL>, smem);
  if (err != cudaSuccess) return err;
  merge_window_kernel<NA, FL><<<(unsigned)grid, (unsigned)threads, smem,
                                stream>>>(src, dst, rows, ncols, run,
                                          (int)tile, (int)tiles, codes, fmask,
                                          smask);
  return cudaGetLastError();
}

template <bool FL>
static cudaError_t pairs_dispatch(const uint32_t* src, uint32_t* dst,
                                  int n_arr, int rows, int ncols, int run,
                                  uint32_t codes, uint32_t fmask,
                                  uint32_t smask, cudaStream_t s) {
#define PAIRS_CASE(NA)                                                      \
  case NA:                                                                  \
    return pairs_launch<NA, FL>(src, dst, rows, ncols, run, codes, fmask,   \
                                smask, s);
  switch (n_arr) {
    PAIRS_CASE(1) PAIRS_CASE(2) PAIRS_CASE(3) PAIRS_CASE(4) PAIRS_CASE(5)
    PAIRS_CASE(6) PAIRS_CASE(7) PAIRS_CASE(8)
    default: return pairs_launch<9, FL>(src, dst, rows, ncols, run, codes,
                                        fmask, smask, s);
  }
#undef PAIRS_CASE
}

// Merge every pair of adjacent sorted `run`-wide runs of every row of the
// stacked (n_arr, rows, ncols) lane tensor `src` into `dst` (same shape, no
// overlap); a last run with no partner is copied.
extern "C" int merge_pairs_lex(const void* src, void* dst, int n_arr,
                               int rows, int ncols, int run, unsigned codes,
                               void* stream) {
  if (rows == 0 || ncols == 0) return cudaSuccess;
  if (run < 1 || (run & (run - 1)) || rows < 0 || ncols < 0 || n_arr < 1 ||
      n_arr > MAX_ARRAYS)
    return cudaErrorInvalidValue;
  uint32_t fmask, smask;
  lane_masks(codes, n_arr, fmask, smask);
  const uint32_t* s = (const uint32_t*)src;
  uint32_t* d = (uint32_t*)dst;
  cudaStream_t st = (cudaStream_t)stream;
  return fmask ? pairs_dispatch<true>(s, d, n_arr, rows, ncols, run, codes,
                                      fmask, smask, st)
               : pairs_dispatch<false>(s, d, n_arr, rows, ncols, run, codes,
                                       fmask, smask, st);
}
