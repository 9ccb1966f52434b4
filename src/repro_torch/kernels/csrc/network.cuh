// Shared pieces of the two compare-exchange networks that run from
// registers: the bitonic sort (B2, bitonic.cu) and the merge of adjacent
// sorted blocks (B4, merge.cu). The odd-even transposition sort (B1,
// oets.cu) takes their element layout and compare-exchanges (with a
// predicate for pairs outside the row), the run merge (B5, runmerge.cu)
// their lexicographic compare.
//
// Both specialise on the lane count (1-9) and on whether any lane is float
// (templates), so the lane loops unroll. Integer lanes travel as their order
// bits (U32 as is, I32 with the top bit flipped: a bijection), converted once
// at load and once at store, so they compare as plain unsigned words. Float
// lanes keep their raw bits, which move, and compare through order_bits,
// which drops -0.0 and NaN payloads; in registers their keys ride beside the
// raw bits, computed once, in shared memory only the raw bits sit (the window
// cap must not move) and the keys are computed at each compare. The
// lexicographic compare is the shape's: two lanes at a time as one 64-bit
// word (B4), or the borrow of a multiword subtraction (B2).
//
// Each thread holds E consecutive elements of a row, a group of LANES lanes
// a segment of SPAN = LANES x E: the stages with partners closer than SPAN
// run in registers (across the group's lanes by __shfl_xor_sync: the partner
// of element i is in lane (i / E) ^ (j / E), the same slot; then inside each
// thread), the rest in shared memory, two a pass on groups of four places a
// thread holds, one barrier a pass.
//
// Every compare-exchange is the reference's: the pair (i, i ^ j), the lower
// element keeping the smaller where the run is ascending and the larger where
// it is descending, with the strict compare, so ties never move and the
// result is the same bit for bit, float ties included.
#pragma once

#include "common.cuh"

// The shape of an element and of a thread's work. V: elements per thread in
// each of the four places a shared-memory pass touches; MAXT: most threads
// of a window's block. Chosen for B4 from timings of variants of this table
// on the H100 that the repo does not keep, so their numbers are not
// recorded (PERF.md, Findings); B2 takes the same table. What each choice
// rests on:
//  - integer lanes: groups of 8 lanes; a shuffle stage costs about as much
//    as a pass of two shared-memory stages, since every lane compares and
//    moves every word;
//  - with a float lane, whole warps: in registers the keys are computed
//    once, in shared memory at every compare;
//  - 512 threads once an element takes more than two words: at 1024 (64
//    registers a thread) the four-lane merge kernel spills.
template <int NA_, bool FL_>
struct NetShape {
  static constexpr int NA = NA_;
  static constexpr bool FL = FL_;
  // words an element takes in registers: its lanes' raw bits, and with a
  // float lane also every lane's compare key
  static constexpr int NW = FL ? 2 * NA : NA;
  static constexpr int K = FL ? NA : 0;  // the first key word
  static constexpr int E = 4, LANES = FL ? 32 : 8, SPAN = LANES * E;
  static constexpr int V = NA <= 4 ? 2 : 1;
  static constexpr int MAXT = NW <= 2 ? 1024 : 512;
  // the compare: 64-bit pairs of lanes (lex_cmp), or the borrow of a
  // multiword subtraction (lex_less)
  static constexpr bool BORROW = false;
};

__host__ __device__ constexpr int log2c(int n) {
  return n <= 1 ? 0 : 1 + log2c(n / 2);
}

// The kernels' lane masks from the packed codes: `fmask` the float lanes,
// `smask` the I32 lanes (whose top bit flips at load and store).
static inline void lane_masks(unsigned codes, int n_arr, uint32_t& fmask,
                              uint32_t& smask) {
  fmask = smask = 0;
  for (int a = 0; a < n_arr; ++a) {
    int code = (codes >> (2 * a)) & 3;
    fmask |= (uint32_t)(code == CODE_F32) << a;
    smask |= (uint32_t)(code == CODE_I32) << a;
  }
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

// a < b over NA unsigned words, a[0] most significant: the borrow out of
// the multiword subtraction a - b, from the last word to the first in one
// carry chain of NA + 1 instructions. PTX operand i + 1 is a's word
// NA - 1 - i, operand NA + i + 1 b's.
#define LESS_FIRST(i, j) "sub.cc.u32 t, %" #i ", %" #j ";\n\t"
#define LESS_NEXT(i, j) "subc.cc.u32 t, %" #i ", %" #j ";\n\t"
#define LESS_WORDS1(x) "r"(x[0])
#define LESS_WORDS2(x) "r"(x[1]), LESS_WORDS1(x)
#define LESS_WORDS3(x) "r"(x[2]), LESS_WORDS2(x)
#define LESS_WORDS4(x) "r"(x[3]), LESS_WORDS3(x)
#define LESS_WORDS5(x) "r"(x[4]), LESS_WORDS4(x)
#define LESS_WORDS6(x) "r"(x[5]), LESS_WORDS5(x)
#define LESS_WORDS7(x) "r"(x[6]), LESS_WORDS6(x)
#define LESS_WORDS8(x) "r"(x[7]), LESS_WORDS7(x)
#define LESS_WORDS9(x) "r"(x[8]), LESS_WORDS8(x)
#define LESS_ASM(n, chain)                                              \
  asm("{\n\t.reg .u32 t;\n\t" chain "subc.u32 %0, 0, 0;\n\t}"            \
      : "=r"(r) : LESS_WORDS##n(a), LESS_WORDS##n(b))

template <int NA>
__device__ __forceinline__ bool lex_less(const uint32_t (&a)[NA],
                                         const uint32_t (&b)[NA]) {
  static_assert(1 <= NA && NA <= MAX_ARRAYS, "1 to 9 lanes");
  if constexpr (NA == 1) return a[0] < b[0];
  uint32_t r = 0;
  if constexpr (NA == 2) LESS_ASM(2, LESS_FIRST(1, 3) LESS_NEXT(2, 4));
  if constexpr (NA == 3) LESS_ASM(3, LESS_FIRST(1, 4) LESS_NEXT(2, 5)
      LESS_NEXT(3, 6));
  if constexpr (NA == 4) LESS_ASM(4, LESS_FIRST(1, 5) LESS_NEXT(2, 6)
      LESS_NEXT(3, 7) LESS_NEXT(4, 8));
  if constexpr (NA == 5) LESS_ASM(5, LESS_FIRST(1, 6) LESS_NEXT(2, 7)
      LESS_NEXT(3, 8) LESS_NEXT(4, 9) LESS_NEXT(5, 10));
  if constexpr (NA == 6) LESS_ASM(6, LESS_FIRST(1, 7) LESS_NEXT(2, 8)
      LESS_NEXT(3, 9) LESS_NEXT(4, 10) LESS_NEXT(5, 11) LESS_NEXT(6, 12));
  if constexpr (NA == 7) LESS_ASM(7, LESS_FIRST(1, 8) LESS_NEXT(2, 9)
      LESS_NEXT(3, 10) LESS_NEXT(4, 11) LESS_NEXT(5, 12) LESS_NEXT(6, 13)
      LESS_NEXT(7, 14));
  if constexpr (NA == 8) LESS_ASM(8, LESS_FIRST(1, 9) LESS_NEXT(2, 10)
      LESS_NEXT(3, 11) LESS_NEXT(4, 12) LESS_NEXT(5, 13) LESS_NEXT(6, 14)
      LESS_NEXT(7, 15) LESS_NEXT(8, 16));
  if constexpr (NA == 9) LESS_ASM(9, LESS_FIRST(1, 10) LESS_NEXT(2, 11)
      LESS_NEXT(3, 12) LESS_NEXT(4, 13) LESS_NEXT(5, 14) LESS_NEXT(6, 15)
      LESS_NEXT(7, 16) LESS_NEXT(8, 17) LESS_NEXT(9, 18));
  return r != 0;
}

// whether the lower element x of a pair takes the upper one's, y: where the
// run is ascending when x is greater, else when it is smaller
template <class S>
__device__ __forceinline__ bool takes(const uint32_t (&x)[S::NA],
                                      const uint32_t (&y)[S::NA], bool asc) {
  if constexpr (S::BORROW) {
    return asc ? lex_less<S::NA>(y, x) : lex_less<S::NA>(x, y);
  } else {
    bool gt, eq;
    lex_cmp<S::NA>(x, y, gt, eq);
    return asc ? gt : !(gt || eq);
  }
}

// --- elements in shared memory: raw bits, keys computed at each compare ---

// compare-exchange of two raw tuples held by one thread, x the lower
// element: the smaller to x where `asc`, the larger elsewhere
template <class S>
__device__ __forceinline__ void cmpx_raw(uint32_t (&x)[S::NA],
                                         uint32_t (&y)[S::NA], uint32_t fmask,
                                         bool asc = true) {
  uint32_t p[S::NA], q[S::NA];
#pragma unroll
  for (int a = 0; a < S::NA; ++a) {
    p[a] = key_of<S::FL>(x[a], a, fmask);
    q[a] = key_of<S::FL>(y[a], a, fmask);
  }
  const bool s = takes<S>(p, q, asc);
#pragma unroll
  for (int a = 0; a < S::NA; ++a) {
    uint32_t t = x[a];
    x[a] = s ? y[a] : t;
    y[a] = s ? t : y[a];
  }
}

// compare-exchange of places i and j (i the lower) of a thread's group
// g[place][lane][V] of shared-memory elements, slot v
template <class S, int P, int V>
__device__ __forceinline__ void cmpx_group(uint32_t (&g)[P][S::NA][V], int i,
                                           int j, int v, uint32_t fmask,
                                           bool asc = true) {
  uint32_t x[S::NA], y[S::NA];
#pragma unroll
  for (int a = 0; a < S::NA; ++a) {
    x[a] = g[i][a][v];
    y[a] = g[j][a][v];
  }
  cmpx_raw<S>(x, y, fmask, asc);
#pragma unroll
  for (int a = 0; a < S::NA; ++a) {
    g[i][a][v] = x[a];
    g[j][a][v] = y[a];
  }
}

// --- elements in registers: NW words, keys from word K on ---

template <class S, int E>
__device__ __forceinline__ void keys_of(uint32_t (&v)[S::NW][E], int e,
                                        uint32_t (&k)[S::NA]) {
#pragma unroll
  for (int a = 0; a < S::NA; ++a) k[a] = v[S::K + a][e];
}

// compare-exchange of slots e and f (e the lower element) of one thread;
// `on` false leaves them (a pair outside the row), with no branch
template <class S, int E>
__device__ __forceinline__ void cmpx_slots(uint32_t (&v)[S::NW][E], int e,
                                           int f, bool asc = true,
                                           bool on = true) {
  uint32_t x[S::NA], y[S::NA];
  keys_of<S, E>(v, e, x);
  keys_of<S, E>(v, f, y);
  const bool s = takes<S>(x, y, asc) & on;
#pragma unroll
  for (int w = 0; w < S::NW; ++w) {
    uint32_t t = v[w][e];
    v[w][e] = s ? v[w][f] : t;
    v[w][f] = s ? t : v[w][f];
  }
}

// slot e against the partner lane's element p: the element that keeps the
// smaller (`keep_min`) takes p where p is smaller, the other where it is
// larger; ties never move; `on` false leaves it, with no branch
template <class S, int E>
__device__ __forceinline__ void exchange(uint32_t (&v)[S::NW][E], int e,
                                         const uint32_t (&p)[S::NW],
                                         bool keep_min, bool on = true) {
  uint32_t x[S::NA], y[S::NA];
  keys_of<S, E>(v, e, x);
#pragma unroll
  for (int a = 0; a < S::NA; ++a) y[a] = p[S::K + a];
  const bool take = takes<S>(x, y, keep_min) & on;
#pragma unroll
  for (int w = 0; w < S::NW; ++w) v[w][e] = take ? p[w] : v[w][e];
}

// The XOR stages j < min(limit, LANES x E) of one merge step on a group of
// LANES lanes that holds LANES x E consecutive elements, E a lane, the
// lane's first at column `off` of its row: across the lanes, then inside
// each. The run of element i is ascending where i & kk is 0 (kk, the merge
// step of the bitonic sort, above every stage's j; kk = 0: every run
// ascending, as the merge of two sorted blocks has it). `mask`: the warp's
// lanes taking part.
template <class S, int E, int LANES>
__device__ __forceinline__ void warp_stages(uint32_t (&v)[S::NW][E],
                                            int limit, int off, int kk,
                                            int lane, unsigned mask) {
  constexpr int NW = S::NW;
#pragma unroll
  for (int s = log2c(LANES) - 1; s >= 0; --s) {
    const int m = 1 << s;
    if (m * E < limit) {
      // a lane's E elements share the bit kk > j >= E
      bool keep_min = ((lane & m) == 0) == ((off & kk) == 0);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        uint32_t p[NW];
#pragma unroll
        for (int w = 0; w < NW; ++w)
          p[w] = __shfl_xor_sync(mask, v[w][e], m);
        exchange<S, E>(v, e, p, keep_min);
      }
    }
  }
  constexpr int LOG_E = log2c(E);
#pragma unroll
  for (int s = LOG_E - 1; s >= 0; --s) {
    const int j = 1 << s;
    if (j < limit) {
#pragma unroll
      for (int e = 0; e < E; ++e)
        if ((e & j) == 0)
          cmpx_slots<S, E>(v, e, e | j, ((off + e) & kk) == 0);
    }
  }
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

// E consecutive elements of every lane from `at` of a stacked lane tensor
// (lane stride `lane_stride`) into registers, the I32 lanes flipped into
// order bits and the float lanes' keys beside their raw bits; the first `n`
// are loaded, the rest are 0
template <class S, int E>
__device__ __forceinline__ void global_to_regs(const uint32_t* x,
                                               size_t lane_stride, size_t at,
                                               int n, uint32_t (&v)[S::NW][E],
                                               uint32_t fmask, uint32_t smask) {
#pragma unroll
  for (int a = 0; a < S::NA; ++a) {
    load_words<E>(x + a * lane_stride + at, n, flip_of(smask, a), v[a]);
    if constexpr (S::FL) {
#pragma unroll
      for (int e = 0; e < E; ++e)
        v[S::K + a][e] = key_of<S::FL>(v[a][e], a, fmask);
    }
  }
}

// the first `n` of E elements back, their raw bits
template <class S, int E>
__device__ __forceinline__ void regs_to_global(uint32_t* x, size_t lane_stride,
                                               size_t at, int n,
                                               const uint32_t (&v)[S::NW][E],
                                               uint32_t smask) {
#pragma unroll
  for (int a = 0; a < S::NA; ++a)
    store_words<E>(x + a * lane_stride + at, n, flip_of(smask, a), v[a]);
}

// E consecutive elements from `off` of a `width`-wide window in shared memory
// (raw bits, order bits for integer lanes) into registers, and back
template <class S, int E>
__device__ __forceinline__ void smem_to_regs(const uint32_t* smem, int width,
                                             int off, uint32_t (&v)[S::NW][E],
                                             uint32_t fmask) {
#pragma unroll
  for (int a = 0; a < S::NA; ++a) {
    smem_load<E>(smem + a * width + off, v[a]);
    if constexpr (S::FL) {
#pragma unroll
      for (int e = 0; e < E; ++e)
        v[S::K + a][e] = key_of<S::FL>(v[a][e], a, fmask);
    }
  }
}

template <class S, int E>
__device__ __forceinline__ void regs_to_smem(uint32_t* smem, int width,
                                             int off,
                                             const uint32_t (&v)[S::NW][E]) {
#pragma unroll
  for (int a = 0; a < S::NA; ++a) smem_store<E>(smem + a * width + off, v[a]);
}

// The XOR stages j = top, top / 2, ... down to SPAN of one merge step over a
// `width`-wide window in shared memory (array a's element i at
// smem[a * width + i]), two per pass where both lie at or above SPAN: a
// thread takes V elements at each of the places i, i + h, i + j, i + j + h
// (h = j / 2), vector reads and writes. Runs ascend where i & kk is 0, as in
// warp_stages. Each pass starts with a barrier, and one ends the stages.
template <class S>
__device__ __forceinline__ void smem_stages(uint32_t* smem, int width,
                                            int top, int kk, uint32_t fmask) {
  constexpr int NA = S::NA, V = S::V, SPAN = S::SPAN;
  const int tid = threadIdx.x, T = blockDim.x;
  for (int j = top; j >= SPAN;) {
    __syncthreads();
    const bool two = (j >> 1) >= SPAN;
    const int h = two ? j >> 1 : j;  // the lowest stride of the pass
    const int lh = __ffs(h) - 1;
    const int groups = two ? width / 4 : width / 2;
    for (int k = tid * V; k < groups; k += T * V) {
      // the k-th index with the pass's stride bits unset
      int i = two ? ((k >> lh) << (lh + 2)) | (k & (h - 1))
                  : ((k >> lh) << (lh + 1)) | (k & (h - 1));
      const bool asc = (i & kk) == 0;  // kk > j: the group's four share it
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
          cmpx_group<S, 4, V>(g, 0, 2, v, fmask, asc);  // stride j
          cmpx_group<S, 4, V>(g, 1, 3, v, fmask, asc);
          cmpx_group<S, 4, V>(g, 0, 1, v, fmask, asc);  // stride j / 2
          cmpx_group<S, 4, V>(g, 2, 3, v, fmask, asc);
        } else {
          cmpx_group<S, 4, V>(g, 0, 1, v, fmask, asc);
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
}
