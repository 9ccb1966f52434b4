// B4: merge of adjacent sorted blocks — blocksort's cross-block round.
//
// Replaces repro/kernels/merge_kernel.py:74 (merge_rows_lex_kernel, with
// _merge_network :43): each grid step merges one pair of adjacent sorted
// B-blocks in VMEM with a reflected compare-exchange (partner 2B-1-i) and
// log2(B) XOR stages, leaving the low half left and the high half right.
// The port runs the same pairs with the same strict compare, so the result
// is the same bit for bit, float ties included; it merges in place at any
// column offset `lo` of the row, where the reference slices the odd rounds
// out and concatenates the untouched edge blocks back (blocksort.py:90-112).
//
// What bounds it on the H100: each window is read once and written once, so
// the least time is the bytes over 3.35 TB/s. With one window of 128 KB of
// shared memory per SM, the load and the store do not overlap the network,
// and the network's compares and selects, not barriers, take the rest: the
// kernel is issue-bound between the load and the store. The design cuts the
// instructions and the barriers a stage costs:
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
#include "common.cuh"

// The window kernel's register phase: each thread holds E consecutive
// elements, a group of LANES lanes a segment of SPAN = LANES x E; the stages
// with partners closer than SPAN run in registers (across the group's lanes
// by shuffles, then inside each thread), the rest in shared memory, two a
// pass. V: elements per thread in each of the four places a shared-memory
// pass touches; MAXT: most threads of a window's block. Chosen from
// timings of variants of this table on the H100 that the repo does not
// keep, so their numbers are not recorded (PERF.md, Findings); what each
// choice rests on:
//  - integer lanes: groups of 8 lanes; a shuffle stage costs about as much
//    as a pass of two shared-memory stages, since every lane compares and
//    moves every word;
//  - with a float lane, whole warps: in registers the keys are computed
//    once, in shared memory at every compare;
//  - 512 threads once an element takes more than two words: at 1024 (64
//    registers a thread) the four-lane kernel spills.
template <int NA, bool FL>
struct MergeShape {
  // words an element takes in registers: its lanes' raw bits, and with a
  // float lane also every lane's compare key
  static constexpr int NW = FL ? 2 * NA : NA;
  static constexpr int K = FL ? NA : 0;  // the first key word
  static constexpr int E = 4, LANES = FL ? 32 : 8, SPAN = LANES * E;
  static constexpr int V = NA <= 4 ? 2 : 1;
  static constexpr int MAXT = NW <= 2 ? 1024 : 512;
};
// The register-only kernel, for windows of at most 32 x REG_E elements: a
// warp holds whole windows, REG_E elements a thread.
#define MERGE_REG_THREADS 256
#define REG_E 4
static_assert(REG_E == 4, "reflect_small covers windows of 2 and 4");

__host__ __device__ constexpr int log2c(int n) {
  return n <= 1 ? 0 : 1 + log2c(n / 2);
}

// the compare key of a lane: float lanes through order_bits, integer lanes
// travel as order bits already. FL: some lane is float.
template <bool FL>
__device__ __forceinline__ uint32_t key_of(uint32_t b, int a, uint32_t fmask) {
  if constexpr (FL) return ((fmask >> a) & 1u) ? order_bits(b, CODE_F32) : b;
  else return b;
}

// lexicographic x > y and x == y over NA compare keys, lane 0 most
// significant
template <int NA>
__device__ __forceinline__ void lex_cmp(const uint32_t (&x)[NA],
                                        const uint32_t (&y)[NA], bool& gt,
                                        bool& eq) {
  gt = false;
  eq = true;
  // two lanes at a time as one 64-bit word, the first the high half: the
  // same order in about two thirds of the instructions
#pragma unroll
  for (int a = 0; a + 1 < NA; a += 2) {
    uint64_t p = ((uint64_t)x[a] << 32) | x[a + 1];
    uint64_t q = ((uint64_t)y[a] << 32) | y[a + 1];
    gt = gt || (eq && p > q);
    eq = eq && p == q;
  }
  if constexpr (NA % 2) {
    gt = gt || (eq && x[NA - 1] > y[NA - 1]);
    eq = eq && x[NA - 1] == y[NA - 1];
  }
}

// --- elements in shared memory: raw bits, keys computed at each compare ---

// compare-exchange of two raw tuples held by one thread: the smaller to x
template <int NA, bool FL>
__device__ __forceinline__ void cmpx_raw(uint32_t (&x)[NA], uint32_t (&y)[NA],
                                         uint32_t fmask) {
  uint32_t p[NA], q[NA];
#pragma unroll
  for (int a = 0; a < NA; ++a) {
    p[a] = key_of<FL>(x[a], a, fmask);
    q[a] = key_of<FL>(y[a], a, fmask);
  }
  bool gt, eq;
  lex_cmp<NA>(p, q, gt, eq);
#pragma unroll
  for (int a = 0; a < NA; ++a) {
    uint32_t t = x[a];
    x[a] = gt ? y[a] : t;
    y[a] = gt ? t : y[a];
  }
}

// compare-exchange of places i and j (the smaller to i) of a thread's
// group g[place][lane][V] of shared-memory elements, slot v
template <int NA, bool FL, int P, int V>
__device__ __forceinline__ void cmpx_group(uint32_t (&g)[P][NA][V], int i,
                                           int j, int v, uint32_t fmask) {
  uint32_t x[NA], y[NA];
#pragma unroll
  for (int a = 0; a < NA; ++a) {
    x[a] = g[i][a][v];
    y[a] = g[j][a][v];
  }
  cmpx_raw<NA, FL>(x, y, fmask);
#pragma unroll
  for (int a = 0; a < NA; ++a) {
    g[i][a][v] = x[a];
    g[j][a][v] = y[a];
  }
}

// --- elements in registers: NW words, keys from word K on ---

template <int NA, bool FL, int E>
__device__ __forceinline__ void keys_of(
    uint32_t (&v)[MergeShape<NA, FL>::NW][E], int e, uint32_t (&k)[NA]) {
#pragma unroll
  for (int a = 0; a < NA; ++a) k[a] = v[MergeShape<NA, FL>::K + a][e];
}

template <int NA, bool FL, int E>
__device__ __forceinline__ void cmpx_slots(
    uint32_t (&v)[MergeShape<NA, FL>::NW][E], int e, int f) {
  constexpr int NW = MergeShape<NA, FL>::NW;
  uint32_t x[NA], y[NA];
  keys_of<NA, FL, E>(v, e, x);
  keys_of<NA, FL, E>(v, f, y);
  bool gt, eq;
  lex_cmp<NA>(x, y, gt, eq);
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    uint32_t t = v[w][e];
    v[w][e] = gt ? v[w][f] : t;
    v[w][f] = gt ? t : v[w][f];
  }
}

// slot e against the partner lane's element p: the lower element of the
// pair keeps the smaller, the upper the larger; ties never move
template <int NA, bool FL, int E>
__device__ __forceinline__ void exchange(
    uint32_t (&v)[MergeShape<NA, FL>::NW][E], int e,
    const uint32_t (&p)[MergeShape<NA, FL>::NW], bool lower) {
  constexpr int NW = MergeShape<NA, FL>::NW, K = MergeShape<NA, FL>::K;
  uint32_t x[NA], y[NA];
  keys_of<NA, FL, E>(v, e, x);
#pragma unroll
  for (int a = 0; a < NA; ++a) y[a] = p[K + a];
  bool gt, eq;
  lex_cmp<NA>(x, y, gt, eq);
  bool take = lower ? gt : !(gt || eq);
#pragma unroll
  for (int w = 0; w < NW; ++w) v[w][e] = take ? p[w] : v[w][e];
}

// The XOR stages j < min(block, LANES x E) of the merge on a group of
// LANES lanes that holds LANES x E consecutive elements, E a lane: across
// the lanes, then inside each. `mask`: the warp's lanes taking part.
template <int NA, bool FL, int E, int LANES>
__device__ __forceinline__ void warp_stages(
    uint32_t (&v)[MergeShape<NA, FL>::NW][E], int block, int lane,
    unsigned mask) {
  constexpr int NW = MergeShape<NA, FL>::NW;
#pragma unroll
  for (int s = log2c(LANES) - 1; s >= 0; --s) {
    const int m = 1 << s;
    if (m * E < block) {
      bool lower = (lane & m) == 0;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        uint32_t p[NW];
#pragma unroll
        for (int w = 0; w < NW; ++w)
          p[w] = __shfl_xor_sync(mask, v[w][e], m);
        exchange<NA, FL, E>(v, e, p, lower);
      }
    }
  }
  constexpr int LOG_E = log2c(E);
#pragma unroll
  for (int s = LOG_E - 1; s >= 0; --s) {
    const int j = 1 << s;
    if (j < block) {
#pragma unroll
      for (int e = 0; e < E; ++e)
        if ((e & j) == 0) cmpx_slots<NA, FL, E>(v, e, e | j);
    }
  }
}

// The reflected stage of windows of `tw` lanes (2 <= tw <= 32): element
// (lane, e) against (lane ^ (tw - 1), E - 1 - e). Both slots of a mirrored
// pair are read before either is written.
template <int NA, bool FL, int E>
__device__ __forceinline__ void reflect_in_warp(
    uint32_t (&v)[MergeShape<NA, FL>::NW][E], int tw, int lane) {
  constexpr int NW = MergeShape<NA, FL>::NW;
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
    exchange<NA, FL, E>(v, e, pe, lower);
    exchange<NA, FL, E>(v, f, pf, lower);
  }
}

// The reflected stage of windows of W <= E elements, inside the thread.
template <int NA, bool FL, int E, int W>
__device__ __forceinline__ void reflect_in_thread(
    uint32_t (&v)[MergeShape<NA, FL>::NW][E]) {
#pragma unroll
  for (int e = 0; e < E; ++e)
    if ((e & (W / 2)) == 0) cmpx_slots<NA, FL, E>(v, e, e ^ (W - 1));
}

template <int NA, bool FL, int E>
__device__ __forceinline__ void reflect_small(
    uint32_t (&v)[MergeShape<NA, FL>::NW][E], int width) {
  if (width == 2) reflect_in_thread<NA, FL, E, 2>(v);
  else reflect_in_thread<NA, FL, E, 4>(v);
}

// ---------------------------------------------------------------------------

__device__ __forceinline__ bool aligned(const void* p, int bytes) {
  return ((uintptr_t)p & (bytes - 1)) == 0;
}

// N consecutive words from device memory, each xor-ed with `flip` (the
// I32 lanes' top bit), with 16- or 8-byte loads where aligned; the first
// `n` are loaded, the rest are 0
template <int N>
__device__ __forceinline__ void load_words(const uint32_t* p, int n,
                                           uint32_t flip, uint32_t (&out)[N]) {
  if (n == N && N % 4 == 0 && aligned(p, 16)) {
#pragma unroll
    for (int c = 0; c < N / 4; ++c) {
      uint4 t = reinterpret_cast<const uint4*>(p)[c];
      out[4 * c] = t.x; out[4 * c + 1] = t.y;
      out[4 * c + 2] = t.z; out[4 * c + 3] = t.w;
    }
  } else if (n == N && N % 2 == 0 && aligned(p, 8)) {
#pragma unroll
    for (int c = 0; c < N / 2; ++c) {
      uint2 t = reinterpret_cast<const uint2*>(p)[c];
      out[2 * c] = t.x; out[2 * c + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) out[e] = e < n ? p[e] : 0u;
  }
#pragma unroll
  for (int e = 0; e < N; ++e) out[e] ^= flip;
}

template <int N>
__device__ __forceinline__ void store_words(uint32_t* p, int n, uint32_t flip,
                                            const uint32_t (&in)[N]) {
  uint32_t w[N];
#pragma unroll
  for (int e = 0; e < N; ++e) w[e] = in[e] ^ flip;
  if (n == N && N % 4 == 0 && aligned(p, 16)) {
#pragma unroll
    for (int c = 0; c < N / 4; ++c)
      reinterpret_cast<uint4*>(p)[c] =
          make_uint4(w[4 * c], w[4 * c + 1], w[4 * c + 2], w[4 * c + 3]);
  } else if (n == N && N % 2 == 0 && aligned(p, 8)) {
#pragma unroll
    for (int c = 0; c < N / 2; ++c)
      reinterpret_cast<uint2*>(p)[c] = make_uint2(w[2 * c], w[2 * c + 1]);
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e)
      if (e < n) p[e] = w[e];
  }
}

// N consecutive words of shared memory (N 1, 2 or a multiple of 4; p
// aligned to 2 words for N = 2, to 4 past that)
template <int N>
__device__ __forceinline__ void smem_load(const uint32_t* p,
                                          uint32_t (&out)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int c = 0; c < N / 4; ++c) {
      uint4 t = reinterpret_cast<const uint4*>(p)[c];
      out[4 * c] = t.x; out[4 * c + 1] = t.y;
      out[4 * c + 2] = t.z; out[4 * c + 3] = t.w;
    }
  } else if constexpr (N == 2) {
    uint2 t = *reinterpret_cast<const uint2*>(p);
    out[0] = t.x; out[1] = t.y;
  } else {
    static_assert(N == 1, "N: 1, 2 or a multiple of 4");
    out[0] = *p;
  }
}

template <int N>
__device__ __forceinline__ void smem_store(uint32_t* p,
                                           const uint32_t (&in)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int c = 0; c < N / 4; ++c)
      reinterpret_cast<uint4*>(p)[c] =
          make_uint4(in[4 * c], in[4 * c + 1], in[4 * c + 2], in[4 * c + 3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<uint2*>(p) = make_uint2(in[0], in[1]);
  } else {
    static_assert(N == 1, "N: 1, 2 or a multiple of 4");
    *p = in[0];
  }
}

__device__ __forceinline__ uint32_t flip_of(uint32_t smask, int a) {
  return ((smask >> a) & 1u) << 31;
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
__global__ void __launch_bounds__(MergeShape<NA, FL>::MAXT)
merge_window_kernel(uint32_t* x, int rows, int ncols, int lo, int npairs,
                    int block, uint32_t fmask, uint32_t smask) {
  using S = MergeShape<NA, FL>;
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
        cmpx_group<NA, FL, 4, V>(g, 0, 3, v, fmask);  // k + v, its mirror
        cmpx_group<NA, FL, 4, V>(g, 1, 2, v, fmask);
        cmpx_group<NA, FL, 4, V>(g, 0, 1, v, fmask);  // XOR block / 2
        cmpx_group<NA, FL, 4, V>(g, 2, 3, v, fmask);
      }
      reverse<NA, V>(g[2]);
      reverse<NA, V>(g[3]);
    } else {
      reverse<NA, V>(g[1]);
#pragma unroll
      for (int v = 0; v < V; ++v) cmpx_group<NA, FL, 4, V>(g, 0, 1, v, fmask);
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
  // pass where both do: places i, i + h, i + j, i + j + h
  for (int j = fused ? block >> 2 : block >> 1; j >= SPAN;) {
    __syncthreads();
    const bool two = (j >> 1) >= SPAN;
    const int h = two ? j >> 1 : j;  // the lowest stride of the pass
    const int lh = __ffs(h) - 1;
    const int groups = two ? half : block;
    for (int k = tid * V; k < groups; k += T * V) {
      // the k-th index with the pass's stride bits unset
      int i = two ? ((k >> lh) << (lh + 2)) | (k & (h - 1))
                  : ((k >> lh) << (lh + 1)) | (k & (h - 1));
      int at[4] = {i, i + h, i + j, i + j + h};
      if (!two) at[1] = i + j;
      uint32_t g[4][NA][V];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (q >= (two ? 4 : 2)) break;
#pragma unroll
        for (int a = 0; a < NA; ++a)
          smem_load<V>(smem + a * width + at[q], g[q][a]);
      }
#pragma unroll
      for (int v = 0; v < V; ++v) {
        if (two) {
          cmpx_group<NA, FL, 4, V>(g, 0, 2, v, fmask);  // stride j
          cmpx_group<NA, FL, 4, V>(g, 1, 3, v, fmask);
          cmpx_group<NA, FL, 4, V>(g, 0, 1, v, fmask);  // stride j / 2
          cmpx_group<NA, FL, 4, V>(g, 2, 3, v, fmask);
        } else {
          cmpx_group<NA, FL, 4, V>(g, 0, 1, v, fmask);
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (q >= (two ? 4 : 2)) break;
#pragma unroll
        for (int a = 0; a < NA; ++a)
        smem_store<V>(smem + a * width + at[q], g[q][a]);
      }
    }
    j = two ? j >> 2 : j >> 1;
  }
  __syncthreads();
  // the rest in registers: thread t takes the E elements from c E, for
  // c = t, t + T, ...; LANES neighbouring threads hold a SPAN segment
  const int lane = tid & 31, chunks = width / E;
  const unsigned mask = chunks >= 32 ? 0xffffffffu : (1u << chunks) - 1;
  for (int c = tid; c < chunks; c += T) {
    const int off = c * E;
    uint32_t v[S::NW][E];
#pragma unroll
    for (int a = 0; a < NA; ++a) {
      smem_load<E>(smem + a * width + off, v[a]);
      if constexpr (FL) {
#pragma unroll
        for (int e = 0; e < E; ++e)
          v[S::K + a][e] = key_of<FL>(v[a][e], a, fmask);
      }
    }
    warp_stages<NA, FL, E, S::LANES>(v, block, lane, mask);
#pragma unroll
    for (int a = 0; a < NA; ++a)
      store_words<E>(x + a * lane_stride + start + off, E, flip_of(smask, a),
                     v[a]);
  }
}

// Windows of 2 `block` <= 32 REG_E columns, all in registers: each block
// takes `MERGE_REG_THREADS` x REG_E consecutive columns of a row's merged
// range, each thread REG_E of them, a warp whole windows.
template <int NA, bool FL>
__global__ void __launch_bounds__(MERGE_REG_THREADS)
merge_regs_kernel(uint32_t* x, int rows, int ncols, int lo, int npairs,
                  int block, uint32_t fmask, uint32_t smask, int tiles) {
  using S = MergeShape<NA, FL>;
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
#pragma unroll
  for (int a = 0; a < NA; ++a) {
    load_words<E>(x + a * lane_stride + base, n, flip_of(smask, a), v[a]);
    if constexpr (FL) {
#pragma unroll
      for (int e = 0; e < E; ++e)
        v[S::K + a][e] = key_of<FL>(v[a][e], a, fmask);
    }
  }
  if (width <= E) reflect_small<NA, FL, E>(v, width);
  else reflect_in_warp<NA, FL, E>(v, width / E, lane);
  warp_stages<NA, FL, E, 32>(v, block, lane, 0xffffffffu);
#pragma unroll
  for (int a = 0; a < NA; ++a)
    store_words<E>(x + a * lane_stride + base, n, flip_of(smask, a), v[a]);
}

template <int NA, bool FL>
static cudaError_t merge_launch(uint32_t* x, int rows, int ncols, int lo,
                                int npairs, int block, uint32_t fmask,
                                uint32_t smask, cudaStream_t stream) {
  using S = MergeShape<NA, FL>;
  static_assert(S::SPAN <= 32 * REG_E, "every wider window needs the window "
                "kernel, whose shared-memory stages reach down to SPAN");
  long long width = 2LL * block;
  if (width > 32 * REG_E) {
    size_t smem = (size_t)NA * width * sizeof(uint32_t);
    cudaError_t err = allow_smem(merge_window_kernel<NA, FL>, smem);
    if (err != cudaSuccess) return err;
    long long grid = (long long)rows * npairs;
    if (grid > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
    long long threads = width / S::E;
    if (threads > S::MAXT) threads = S::MAXT;
    if (threads < 32) threads = 32;
    merge_window_kernel<NA, FL><<<(unsigned)grid, (unsigned)threads, smem,
                                  stream>>>(x, rows, ncols, lo, npairs, block,
                                            fmask, smask);
  } else {
    long long per = (long long)MERGE_REG_THREADS * REG_E;
    long long tiles = ((long long)npairs * width + per - 1) / per;
    long long grid = (long long)rows * tiles;
    if (grid > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
    merge_regs_kernel<NA, FL><<<(unsigned)grid, MERGE_REG_THREADS, 0,
                                stream>>>(x, rows, ncols, lo, npairs, block,
                                          fmask, smask, (int)tiles);
  }
  return cudaGetLastError();
}

template <bool FL>
static cudaError_t merge_dispatch(uint32_t* p, int n_arr, int rows, int ncols,
                                  int lo, int npairs, int block,
                                  uint32_t fmask, uint32_t smask,
                                  cudaStream_t s) {
#define MERGE_CASE(NA)                                                      \
  case NA:                                                                  \
    return merge_launch<NA, FL>(p, rows, ncols, lo, npairs, block, fmask,   \
                                smask, s);
  switch (n_arr) {
    MERGE_CASE(1) MERGE_CASE(2) MERGE_CASE(3) MERGE_CASE(4) MERGE_CASE(5)
    MERGE_CASE(6) MERGE_CASE(7) MERGE_CASE(8)
    default: return merge_launch<9, FL>(p, rows, ncols, lo, npairs, block,
                                        fmask, smask, s);
  }
#undef MERGE_CASE
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
  uint32_t fmask = 0, smask = 0;
  for (int a = 0; a < n_arr; ++a) {
    int code = (codes >> (2 * a)) & 3;
    fmask |= (uint32_t)(code == CODE_F32) << a;
    smask |= (uint32_t)(code == CODE_I32) << a;
  }
  uint32_t* p = (uint32_t*)x;
  cudaStream_t s = (cudaStream_t)stream;
  return fmask ? merge_dispatch<true>(p, n_arr, rows, ncols, lo, npairs, block,
                                      fmask, smask, s)
               : merge_dispatch<false>(p, n_arr, rows, ncols, lo, npairs,
                                       block, fmask, smask, s);
}
