// Merge-path pieces shared by the two-run merge (B5, runmerge.cu) and the
// k-way merge and its split (B6, kway.cu): cp.async staging, the
// lexicographic compare of stacked compare lanes in device memory and in a
// shared-memory tile, and the two co-rank searches (a warp over device
// memory, a thread over a tile).
//
// A run is addressed by a base pointer, a lane stride and a length, which
// need not agree: B5's runs are stacks of their own (stride = length), while
// the segments of the k-way split live inside one (lanes, total) stack
// (stride = total).
//
// The order is the compare lanes', each lane through order_bits, and on ties
// a before b: the co-rank of output d is how many of the first d outputs of
// the stable merge come from a.
#pragma once

#include "network.cuh"

// a co-rank search's threads a block: a warp a diagonal
#define SPLIT_THREADS 128

__device__ __forceinline__ void cp_async4(uint32_t* dst, const uint32_t* src) {
  unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// lexicographic x[ix] < y[iy] over stacked compare lanes in device memory
// (lane strides sx and sy), each lane in the order of its code: with NC
// lanes known, every lane of both elements is loaded at once (one round
// trip a search step); NC = 0 reads n_cmp lanes one after another
template <int NC>
__device__ __forceinline__ bool less_stacked(const uint32_t* x, long long sx,
                                             long long ix, const uint32_t* y,
                                             long long sy, long long iy,
                                             int n_cmp, uint32_t codes) {
  if constexpr (NC > 0) {
    uint32_t p[NC], q[NC];
#pragma unroll
    for (int l = 0; l < NC; ++l) {
      p[l] = x[l * sx + ix];
      q[l] = y[l * sy + iy];
    }
#pragma unroll
    for (int l = 0; l < NC; ++l) {
      int code = (codes >> (2 * l)) & 3;
      p[l] = order_bits(p[l], code);
      q[l] = order_bits(q[l], code);
    }
    return lex_less<NC>(p, q);
  } else {
    for (int l = 0; l < n_cmp; ++l) {
      int code = (codes >> (2 * l)) & 3;
      uint32_t p = order_bits(x[l * sx + ix], code);
      uint32_t q = order_bits(y[l * sy + iy], code);
      if (p != q) return p < q;
    }
    return false;
  }
}

// The co-rank of diagonal d of the merge of a[0, na) and b[0, nb) (lane
// strides sa and sb), by the whole warp, every lane returning it. i counts
// while a[i] <= b[d - 1 - i] (a before b on ties), true then false over
// the range, so each step the 32 lanes test 32 evenly spaced i at once and
// the count of trues (a prefix of the lanes) keeps the part of the range
// between the last true and the first false: a 33-ary search. A diagonal
// past na + nb gives na. NC as in less_stacked.
template <int NC>
__device__ __forceinline__ long long warp_corank(
    const uint32_t* a, long long sa, long long na, const uint32_t* b,
    long long sb, long long nb, long long d, int n_cmp, uint32_t codes) {
  const int lane = threadIdx.x & 31;
  long long hi = d < na ? d : na;
  long long lo = d - nb > 0 ? d - nb : 0;
  if (lo > hi) lo = hi;  // past the end: every a
  while (lo < hi) {
    const long long span = hi - lo;
    const bool last = span <= 32;
    // lane t's probe: lo + t in the last step, else the (t + 1)-th of 32
    // points strictly inside the range
    const long long m = last ? lo + lane : lo + (lane + 1) * span / 33;
    const bool counts =
        m < hi && !less_stacked<NC>(b, sb, d - 1 - m, a, sa, m, n_cmp, codes);
    const int c = __popc(__ballot_sync(0xffffffffu, counts));
    if (last) {
      lo += c;
      break;
    }
    const long long below = lo + (long long)c * span / 33;  // probe c - 1
    const long long above = lo + (long long)(c + 1) * span / 33;  // probe c
    if (c < 32) hi = above;
    if (c > 0) lo = below + 1;
  }
  return lo;
}

// key[p] < key[q] in a tile (lane-major keys, lane stride `stride`)
template <int NC>
__device__ __forceinline__ bool tile_less(const uint32_t* key, int stride,
                                          int n_cmp, int p, int q) {
  if constexpr (NC > 0) {
    uint32_t x[NC], y[NC];
#pragma unroll
    for (int l = 0; l < NC; ++l) {
      x[l] = key[l * stride + p];
      y[l] = key[l * stride + q];
    }
    return lex_less<NC>(x, y);
  } else {
    for (int l = 0; l < n_cmp; ++l) {
      uint32_t x = key[l * stride + p], y = key[l * stride + q];
      if (x != y) return x < y;
    }
    return false;
  }
}

// The co-rank of output d of the merge of a run a of ca elements and a run
// b of cb: a binary search for how many of the first d outputs come from a,
// b taken only where b_less_a(j, i), b[j] < a[i] strictly, holds.
template <class BLessA>
__device__ __forceinline__ int corank_by(BLessA b_less_a, int ca, int cb,
                                         int d) {
  int lo = max(0, d - cb), hi = min(d, ca);
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (b_less_a(d - 1 - mid, mid))
      hi = mid;
    else
      lo = mid + 1;
  }
  return lo;
}

// corank_by over the tile's runs a = [a0, a0 + ca) and b = [b0, b0 + cb)
template <int NC>
__device__ __forceinline__ int tile_corank(const uint32_t* key, int stride,
                                           int n_cmp, int a0, int ca, int b0,
                                           int cb, int d) {
  return corank_by(
      [&](int j, int i) {
        return tile_less<NC>(key, stride, n_cmp, b0 + j, a0 + i);
      },
      ca, cb, d);
}

// Stage `lanes` lanes of two segments into `dst` (lane-major, lane stride
// `dstride`): a's [sa, sa + ca) (lane stride `astride`) at 0, b's [sb, sb
// + cb) (lane stride `bstride`) after it.
__device__ __forceinline__ void stage(uint32_t* dst, int dstride,
                                      const uint32_t* a, size_t astride,
                                      const uint32_t* b, size_t bstride,
                                      int sa, int ca, int sb, int cb,
                                      int lanes) {
  for (int p = threadIdx.x; p < ca + cb; p += blockDim.x) {
    const bool from_a = p < ca;
    const uint32_t* src = from_a ? a + sa + p : b + sb + (p - ca);
    const size_t stride = from_a ? astride : bstride;
    for (int l = 0; l < lanes; ++l)
      cp_async4(dst + l * dstride + p, src + l * stride);
  }
}
